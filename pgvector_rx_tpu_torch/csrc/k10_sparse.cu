// K10 -- the sparse sweep: exact top-k over padded-CSR sparse rows, in two
// forms chosen by a shape rule (ops/sparse._k10_form).
//
// No Pallas ancestor: it replaces the XLA program `_exact_search_sparse`
// (pgvector_rx_tpu/graph/device.py:1313), which picks one of three
// formulations of the same function by the dimension: a densified-corpus
// matmul (dim <= 1024 P, not l1), a gather from the densified queries
// (:1481, wherever the dense queries fit, `dense_q_ok` :1339-1344), or a
// searchsorted merge join (dim unknown or > 2^20). The port takes the
// gather wherever the dense queries fit, at every dim (the matmul's
// ~6e12 FLOPs at the smoke's shape are ~37 ms even at 3xTF32 rates on
// this card, against ~6.6e9 FMAs for the gather), and a lookup elsewhere:
// - the dense-query form (`k10_dense_kernel`): the queries densified once
//   per call into device memory as Qd [dim + 1, ldq], query-minor, row dim
//   zero (pads hit it); a stored row entry (c, v) reads a contiguous run
//   of a query tile's values Qd[c, tile] in one coalesced load and does one
//   FMA per query. No search, no divergence on the query's length.
// - the lookup form (`k10_sparse_kernel`): every (row entry, query) pair
//   a binary search in the query's sorted indices in shared memory, for
//   any dimension (the dense queries do not fit or dim is unknown).
//
// What both compute, per query b over the rows whose `live` flag is set
// (rows and queries are padded CSR: P sorted indices padded with INT32_MAX,
// P values padded with 0):
// - dot = the sum over the matched pairs (a row entry whose index the
//   query holds) of qv * xv; |x|^2 and sum|x| over the row's entries,
//   |q|^2 and sum|q| over the query's;
// - l2 max(|q|^2 + |x|^2 - 2 dot, 0); ip -dot; cosine 1 - clamp(dot /
//   sqrt(|q|^2 |x|^2), -1, 1), similarity 0 when a norm is 0 (IEEE sqrt
//   and division: the build uses no fast-math flag); l1 sum|q| + sum|x| +
//   the sum over matches of |qv - xv| - |qv| - |xv|;
// - approx (l2, ip, cosine): the dot over bf16-rounded qv and xv with f32
//   sums, the norms from the f32 values (the JAX package's bf16 product of
//   the densified rows); the caller rescores the winners in f32;
// - the k smallest (d, row) pairs, -0.0 made +0.0 first so the two zeros
//   tie: one 64-bit key each, float_key(d) << 32 | row (sweep_common.cuh:
//   the order of the floats, negative distances first), so the order of a
//   list never depends on the order in which blocks or lanes offer rows.
//   A round of a k > 64 query admits only keys >= `lo`.
//
// Bound on an H100 SXM, at the smoke's shape (1,024 queries x 100,001 rows
// x P = 64, Σnnz = 6.29e6): 3 B Σnnz = 1.9e10 f32 operations (a gather or
// lookup and 2 flops of the dot per (query, stored entry)) over the f32
// rate, ~0.29 ms; the CSR rows (51 MB) take 0.015 ms at HBM rate. The
// dense form moves B Σnnz f32 values (25.8 GB) from the L2 / L1 caches:
// that traffic, not the arithmetic, is what it spends its time on.
//
// Dense-query form (sm_90a, plain CUDA, no tensor cores):
// - A block of `warps` warps owns a query tile of 32 warps columns (each
//   thread one query: one 4-byte load, 2 bytes for approx, per entry) and a
//   range of rows (a split). The grid is (splits, tiles): the blocks that
//   run together share a tile, whose Qd columns (dim x tile x 4 bytes)
//   stay in the 50 MB L2 while the split's rows stream past.
// - Every warp walks every row of the split: the rows are staged in shared
//   memory `rc` at a time with cp.async, double-buffered (the next chunk in
//   flight while this one is scored); each entry is a shared-memory
//   broadcast, then 16 entries' Qd loads in flight at once. A row stops at
//   its first pad.
// - Each thread keeps its query's sorted list of k keys in shared memory
//   and the k-th key in a register: most rows are rejected with one
//   compare; an insertion shifts the thread's own list.
// - The splits' lists merge in key_select_kernel (one warp per query).
//
// Lookup form, K9's shape:
// - A block of 8 warps owns QB <= 64 queries (their sorted indices, values,
//   norms and lengths resident in shared memory; QB chosen by the wrapper
//   from P and k) and a range of rows (a split). Warp w owns queries
//   [w * QB / 8, (w + 1) * QB / 8) and walks the whole range 32 rows at a
//   time, one row per lane: each lane reads its row's entries (16-byte
//   loads where P allows) once for all the warp's queries, stops at the
//   first pad, and looks each entry up in each query's list (~log2 P
//   dependent shared-memory reads per pair).
// - Each query keeps a sorted list of k keys in shared memory, private to
//   its warp (warp_offer_key, no block barrier in the loop).
// - A second kernel merges the splits' lists: one warp per query.
// Measured: see PERF.md (K10 rows), timed by chip_smoke.py phase 24d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int k10Warps = 8;
constexpr int k10Threads = k10Warps * 32;
constexpr int k10MaxQpw = 8;  // queries per warp (QB <= 64)
constexpr int k10MaxSmem = 200 * 1024;  // as ops/sparse._k10_qtile assumes
constexpr int kPadIndex = 0x7fffffff;

struct Args {
  const int* ci;    // [n, p] row indices
  const float* cv;  // [n, p] row values
  const uint8_t* live;  // [n]
  const int* qi;    // [b, p]
  const float* qv;  // [b, p]
  const unsigned long long* lo;  // [b] first admitted key, or null
  int n, p, b, k, qb, rows_per_split;
  unsigned long long* part;  // [b, splits, k]
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// The first position of s[0, len) (ascending) whose value is >= c.
__device__ __forceinline__ int lower_bound(const int* s, int len, int c) {
  int lo = 0, n = len;
  while (n > 0) {
    const int h = n >> 1;
    if (s[lo + h] < c) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// V row entries starting at e: indices and values.
template <int V>
struct Entries;
template <>
struct Entries<4> {
  __device__ static void load(const int* ri, const float* rv, int e, int* c,
                              float* x) {
    const int4 ci = __ldg(reinterpret_cast<const int4*>(ri + e));
    const float4 xv = __ldg(reinterpret_cast<const float4*>(rv + e));
    c[0] = ci.x;
    c[1] = ci.y;
    c[2] = ci.z;
    c[3] = ci.w;
    x[0] = xv.x;
    x[1] = xv.y;
    x[2] = xv.z;
    x[3] = xv.w;
  }
};
template <>
struct Entries<1> {
  __device__ static void load(const int* ri, const float* rv, int e, int* c,
                              float* x) {
    c[0] = __ldg(ri + e);
    x[0] = __ldg(rv + e);
  }
};

// M: 0 l2, 1 ip, 2 cosine, 3 l1 (ops/sparse.SPARSE_METRICS); APPROX: the
// dot over bf16-rounded values; V: entries per load (4: 16-byte loads).
template <int M, bool APPROX, int V>
__global__ void __launch_bounds__(k10Threads) k10_sparse_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  int* qidx = reinterpret_cast<int*>(smem);                   // [qb][p]
  float* qval = reinterpret_cast<float*>(qidx + a.qb * a.p);  // [qb][p]
  float* qsq = qval + a.qb * a.p;                             // [qb]
  float* qabs = qsq + a.qb;                                   // [qb]
  int* qlen = reinterpret_cast<int*>(qabs + a.qb);            // [qb]
  // 8-byte aligned: qb is a multiple of 8
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(qlen + a.qb);  // [qb][k]
  const int q0 = blockIdx.x * a.qb;
  const int split = blockIdx.y;
  const int r0 = split * a.rows_per_split;
  const int r1 = min(a.n, r0 + a.rows_per_split);

  for (int i = tid; i < a.qb * a.p; i += k10Threads) {
    const int j = i / a.p;
    const bool ok = q0 + j < a.b;
    const long long g = static_cast<long long>(q0) * a.p + i;
    qidx[i] = ok ? a.qi[g] : kPadIndex;
    qval[i] = ok ? a.qv[g] : 0.f;
  }
  for (int i = tid; i < a.qb * a.k; i += k10Threads) lists[i] = kEmptyKey;
  __syncthreads();
  for (int j = warp; j < a.qb; j += k10Warps) {  // one warp per query
    float s2 = 0.f, s1 = 0.f;
    int len = 0;
    for (int c = lane; c < a.p; c += 32) {
      if (qidx[j * a.p + c] != kPadIndex) {
        const float v = qval[j * a.p + c];
        s2 += v * v;
        s1 += fabsf(v);
        ++len;
      }
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) {
      s2 += __shfl_xor_sync(kFull, s2, o);
      s1 += __shfl_xor_sync(kFull, s1, o);
      len += __shfl_xor_sync(kFull, len, o);
    }
    if (lane == 0) {
      qsq[j] = s2;
      qabs[j] = s1;
      qlen[j] = len;
    }
  }
  __syncthreads();
  if (APPROX) {  // the dot's query values, after the norms took f32 ones
    for (int i = tid; i < a.qb * a.p; i += k10Threads)
      qval[i] = bf16_round(qval[i]);
    __syncthreads();
  }

  const int qpw = a.qb / k10Warps;
  const int my0 = warp * qpw;  // this warp's first query in the block
  unsigned long long lo[k10MaxQpw], thr[k10MaxQpw];
  int len[k10MaxQpw];
#pragma unroll
  for (int j = 0; j < k10MaxQpw; ++j) {
    const int qi = q0 + my0 + j;
    const bool mine = j < qpw && qi < a.b;
    lo[j] = !mine ? kEmptyKey : (a.lo != nullptr ? a.lo[qi] : 0ull);
    thr[j] = kEmptyKey;
    len[j] = j < qpw ? qlen[my0 + j] : 0;
  }

  for (int row0 = r0; row0 < r1; row0 += 32) {
    const int row = row0 + lane;
    const bool ok = row < r1 && a.live[row];
    float dot[k10MaxQpw], corr[k10MaxQpw];
#pragma unroll
    for (int j = 0; j < k10MaxQpw; ++j) dot[j] = corr[j] = 0.f;
    float csq = 0.f, cabs = 0.f;
    if (ok) {
      const int* ri = a.ci + static_cast<long long>(row) * a.p;
      const float* rv = a.cv + static_cast<long long>(row) * a.p;
      bool done = false;
      for (int e = 0; e < a.p && !done; e += V) {
        int cc[V];
        float xx[V];
        Entries<V>::load(ri, rv, e, cc, xx);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          const int c = cc[u];
          if (c == kPadIndex) {  // the row's pads fill its tail
            done = true;
            break;
          }
          const float x = xx[u];
          csq += x * x;
          if (M == 3) cabs += fabsf(x);
          const float xd = APPROX ? bf16_round(x) : x;
#pragma unroll
          for (int j = 0; j < k10MaxQpw; ++j) {
            if (j >= qpw) break;  // warp-uniform
            const int* s = qidx + (my0 + j) * a.p;
            const int pos = lower_bound(s, len[j], c);
            if (pos < len[j] && s[pos] == c) {
              const float g = qval[(my0 + j) * a.p + pos];
              dot[j] += g * xd;
              if (M == 3) corr[j] += fabsf(g - x) - fabsf(g) - fabsf(x);
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < k10MaxQpw; ++j) {
      if (j >= qpw) break;  // warp-uniform
      unsigned long long key = kEmptyKey;
      if (ok) {
        const float qs = qsq[my0 + j];
        float d;
        if (M == 0) {
          d = fmaxf(qs + csq - 2.0f * dot[j], 0.0f);
        } else if (M == 1) {
          d = -dot[j];
        } else if (M == 2) {
          const float den = sqrtf(qs * csq);
          const float sim = den > 0.0f ? __fdiv_rn(dot[j], den) : 0.0f;
          d = 1.0f - fminf(fmaxf(sim, -1.0f), 1.0f);
        } else {
          d = qabs[my0 + j] + cabs + corr[j];
        }
        d = __fadd_rn(d, 0.0f);  // -0.0 -> +0.0: the two zeros tie
        key = (static_cast<unsigned long long>(float_key(d)) << 32) |
              static_cast<unsigned>(row);
        if (key < lo[j]) key = kEmptyKey;
      }
      if (__any_sync(kFull, key < thr[j])) {
        unsigned long long* l = lists + (my0 + j) * a.k;
        warp_offer_key(l, a.k, key, lane);
        thr[j] = l[a.k - 1];
      }
    }
  }
  __syncwarp();
  for (int j = 0; j < qpw; ++j) {
    const int qi = q0 + my0 + j;
    if (qi >= a.b) break;
    const unsigned long long* l = lists + (my0 + j) * a.k;
    unsigned long long* o =
        a.part + (static_cast<long long>(qi) * gridDim.y + split) * a.k;
    for (int i = lane; i < a.k; i += 32) o[i] = l[i];
  }
}

size_t smem_bytes(int p, int qb, int k) {
  return 4 * (2 * static_cast<size_t>(qb) * p + 3 * static_cast<size_t>(qb)) +
         8 * static_cast<size_t>(qb) * k;
}

template <int M, bool APPROX, int V>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  auto kern = k10_sparse_kernel<M, APPROX, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, k10Threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int M, bool APPROX>
cudaError_t launch_v(const Args& a, bool vec, dim3 grid, size_t smem,
                     cudaStream_t st) {
  return vec ? launch<M, APPROX, 4>(a, grid, smem, st)
             : launch<M, APPROX, 1>(a, grid, smem, st);
}

// ---------------------------------------------------------------------------
// The dense-query form
// ---------------------------------------------------------------------------

constexpr int k10dMaxWarps = 8;
constexpr int kUnroll = 16;  // row entries whose Qd loads are in flight

struct DenseArgs {
  const int* ci;    // [n, p] row indices
  const float* cv;  // [n, p] row values
  const uint8_t* live;  // [n]
  const void* qd;   // [dim + 1, ldq] query values (f32, or bf16 bits when
                    // approx), query-minor; row dim and pad columns zero
  const float* qsq;   // [b] |q|^2 of the f32 values
  const float* qabs;  // [b] sum |q|
  const unsigned long long* lo;  // [b] first admitted key, or null
  int n, p, b, k, dim, ldq, rows_per_split, rc;
  unsigned long long* part;  // [b, splits, k]
};

// Qd[i] as f32: f32 storage, or bf16 bits (an exact widening: the bits are
// the f32's high half).
template <bool BF16>
__device__ __forceinline__ float qd_load(const void* q, long long i) {
  if (BF16)
    return __uint_as_float(
        static_cast<unsigned>(__ldg(static_cast<const unsigned short*>(q) + i))
        << 16);
  return __ldg(static_cast<const float*>(q) + i);
}

// Insert `key` (unique, smaller than the last) into one thread's ascending
// list l[0], l[stride], ..., l[(k - 1) stride], dropping the last.
__device__ __forceinline__ void lane_insert_key(unsigned long long* l,
                                                int stride, int k,
                                                unsigned long long key) {
  int j = k - 1;
  while (j > 0) {
    const unsigned long long prev = l[(j - 1) * stride];
    if (prev < key) break;
    l[j * stride] = prev;
    --j;
  }
  l[j * stride] = key;
}

// M: 0 l2, 1 ip, 2 cosine, 3 l1; BF16: Qd holds bf16 values and the dot
// takes bf16-rounded row values (approx); VEC: the rows' staging copies
// move 16 bytes (p % 4 == 0, 16-byte aligned rows). Each thread owns one
// query (one column of the block's tile).
template <int M, bool BF16, bool VEC>
__global__ void __launch_bounds__(k10dMaxWarps * 32)
    k10_dense_kernel(DenseArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nt = blockDim.x, tid = threadIdx.x;
  // lists[j * nt + tid]: entry j of this thread's list (consecutive
  // threads, consecutive words)
  unsigned long long* lists = reinterpret_cast<unsigned long long*>(smem);
  const int stage = a.rc * a.p;
  int* sidx = reinterpret_cast<int*>(lists + static_cast<size_t>(a.k) * nt);
  float* sval = reinterpret_cast<float*>(sidx + 2 * stage);
  const int q = blockIdx.y * nt + tid;  // this thread's query
  const int split = blockIdx.x;
  const int r0 = split * a.rows_per_split;
  const int r1 = min(a.n, r0 + a.rows_per_split);
  const int nch = (r1 - r0 + a.rc - 1) / a.rc;

  auto prefetch_chunk = [&](int ch) {
    const int rs = r0 + ch * a.rc;
    const int cnt = min(a.rc, r1 - rs) * a.p;
    const long long g0 = static_cast<long long>(rs) * a.p;
    int* di = sidx + (ch & 1) * stage;
    float* dv = sval + (ch & 1) * stage;
    if (VEC) {
      for (int i = tid * 4; i < cnt; i += nt * 4) {
        cp_async16(smem_addr(di + i), a.ci + g0 + i, 16);
        cp_async16(smem_addr(dv + i), a.cv + g0 + i, 16);
      }
    } else {
      for (int i = tid; i < cnt; i += nt) {
        cp_async4(smem_addr(di + i), a.ci + g0 + i, 4);
        cp_async4(smem_addr(dv + i), a.cv + g0 + i, 4);
      }
    }
    cp_async_commit();
  };

  const bool mine = q < a.b;
  const unsigned long long lo =
      !mine ? kEmptyKey : (a.lo != nullptr ? a.lo[q] : 0ull);
  unsigned long long thr = kEmptyKey;
  const float qs = mine ? a.qsq[q] : 0.f;
  const float qa = mine ? a.qabs[q] : 0.f;
  for (int j = 0; j < a.k; ++j) lists[j * nt + tid] = kEmptyKey;
  const long long zero_row = static_cast<long long>(a.dim) * a.ldq;

  prefetch_chunk(0);
  for (int ch = 0; ch < nch; ++ch) {
    if (ch + 1 < nch) {
      prefetch_chunk(ch + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // chunk ch is in shared memory
    const int rs = r0 + ch * a.rc;
    const int nr = min(a.rc, r1 - rs);
    const int* bi = sidx + (ch & 1) * stage;
    const float* bv = sval + (ch & 1) * stage;
    for (int r = 0; r < nr; ++r) {
      const int row = rs + r;
      if (!a.live[row]) continue;  // the same in every thread
      const int* ri = bi + r * a.p;
      const float* rv = bv + r * a.p;
      float acc = 0.f, corr = 0.f, csq = 0.f, cabs = 0.f;
      for (int e0 = 0; e0 < a.p; e0 += kUnroll) {
        int c[kUnroll];
        float x[kUnroll], g[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const bool in = e0 + u < a.p;
          c[u] = in ? ri[e0 + u] : kPadIndex;
          x[u] = in ? rv[e0 + u] : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)  // a pad reads the zero row
          g[u] = qd_load<BF16>(
              a.qd, (c[u] < a.dim ? static_cast<long long>(c[u]) * a.ldq
                                  : zero_row) + q);
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          csq += x[u] * x[u];
          acc += g[u] * (BF16 ? bf16_round(x[u]) : x[u]);
          if (M == 3) {
            cabs += fabsf(x[u]);
            corr += fabsf(g[u] - x[u]) - fabsf(g[u]) - fabsf(x[u]);
          }
        }
        if (c[kUnroll - 1] == kPadIndex) break;  // the row's pads fill its tail
      }
      float d;
      if (M == 0) {
        d = fmaxf(qs + csq - 2.0f * acc, 0.0f);
      } else if (M == 1) {
        d = -acc;
      } else if (M == 2) {
        const float den = sqrtf(qs * csq);
        const float sim = den > 0.0f ? __fdiv_rn(acc, den) : 0.0f;
        d = 1.0f - fminf(fmaxf(sim, -1.0f), 1.0f);
      } else {
        d = qa + cabs + corr;
      }
      d = __fadd_rn(d, 0.0f);  // -0.0 -> +0.0: the two zeros tie
      unsigned long long key =
          (static_cast<unsigned long long>(float_key(d)) << 32) |
          static_cast<unsigned>(row);
      if (key < lo) key = kEmptyKey;
      if (key < thr) {
        lane_insert_key(lists + tid, nt, a.k, key);
        thr = lists[(a.k - 1) * nt + tid];
      }
    }
    __syncthreads();  // the buffer is free for chunk ch + 2
  }
  if (mine) {
    unsigned long long* o =
        a.part + (static_cast<long long>(q) * gridDim.x + split) * a.k;
    for (int j = 0; j < a.k; ++j) o[j] = lists[j * nt + tid];
  }
}

size_t dense_smem_bytes(int p, int k, int warps, int rc) {
  return 8 * static_cast<size_t>(k) * warps * 32 +
         16 * static_cast<size_t>(rc) * p;
}

template <int M, bool BF16, bool VEC>
cudaError_t launch_dense3(const DenseArgs& a, dim3 grid, int threads,
                          size_t smem, cudaStream_t st) {
  auto kern = k10_dense_kernel<M, BF16, VEC>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, threads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int M, bool BF16>
cudaError_t launch_dense2(const DenseArgs& a, bool vec, dim3 grid,
                          int threads, size_t smem, cudaStream_t st) {
  return vec ? launch_dense3<M, BF16, true>(a, grid, threads, smem, st)
             : launch_dense3<M, BF16, false>(a, grid, threads, smem, st);
}

}  // namespace

extern "C" {

// K10 for b queries over n rows of p padded-CSR entries: metric 0 l2,
// 1 ip, 2 cosine, 3 l1; approx (metrics 0-2 only) rounds the dot's values
// to bf16; lo [b] or null; qb queries per block (a multiple of 8, at most
// 64); the grid is (ceil(b / qb), splits), split s covering rows
// [s * rows_per_split, +rows_per_split). part [b, splits, k] is scratch;
// out [b, k] the keys (float_key(d) << 32 | row), ascending, ~0 empty.
int pgv_k10_sparse_topk(const int* ci, const float* cv, const uint8_t* live,
                        const int* qi, const float* qv,
                        const unsigned long long* lo, int n, int p, int b,
                        int k, int metric, int approx, int qb, int splits,
                        int rows_per_split, unsigned long long* part,
                        unsigned long long* out, void* stream) {
  if (n <= 0 || p <= 0 || b <= 0 || k < 1 || k > kMaxK || qb <= 0 ||
      qb % k10Warps || qb > k10Warps * k10MaxQpw || splits <= 0 ||
      rows_per_split <= 0 || metric < 0 || metric > 3 ||
      (approx && metric == 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(p, qb, k);
  if (smem > static_cast<size_t>(k10MaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{ci, cv, live, qi, qv, lo, n, p, b, k, qb, rows_per_split, part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((b + qb - 1) / qb, splits);
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(ci) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  cudaError_t err;
  switch (metric * 2 + (approx ? 1 : 0)) {
    case 0: err = launch_v<0, false>(a, vec, grid, smem, st); break;
    case 1: err = launch_v<0, true>(a, vec, grid, smem, st); break;
    case 2: err = launch_v<1, false>(a, vec, grid, smem, st); break;
    case 3: err = launch_v<1, true>(a, vec, grid, smem, st); break;
    case 4: err = launch_v<2, false>(a, vec, grid, smem, st); break;
    case 5: err = launch_v<2, true>(a, vec, grid, smem, st); break;
    default: err = launch_v<3, false>(a, vec, grid, smem, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_key_select(part, b, splits * k, k, out, st));
}


// K10's dense-query form for b queries over n rows of p padded-CSR
// entries: qd [dim + 1, ldq] the densified queries (f32, or bf16 bits when
// approx; approx takes metrics 0-2), qsq / qabs [b] their norms from f32
// values, lo [b] or null; `warps` warps per block, one query per thread
// (ldq a multiple of the tile 32 warps); the grid is (splits, ldq / tile),
// split s covering rows [s * rows_per_split, +rows_per_split), staged rc
// rows at a time. part [b, splits, k] is scratch; out [b, k] the keys, as
// pgv_k10_sparse_topk's.
int pgv_k10_dense_topk(const int* ci, const float* cv, const uint8_t* live,
                       const void* qd, const float* qsq, const float* qabs,
                       const unsigned long long* lo, int n, int p, int b,
                       int k, int dim, int ldq, int metric, int approx,
                       int warps, int rc, int splits, int rows_per_split,
                       unsigned long long* part, unsigned long long* out,
                       void* stream) {
  const int tile = 32 * warps;
  if (n <= 0 || p <= 0 || b <= 0 || k < 1 || k > kMaxK || dim <= 0 ||
      warps < 1 || warps > k10dMaxWarps || ldq < b || ldq % tile ||
      ldq / tile > 65535 || rc <= 0 || splits <= 0 || rows_per_split <= 0 ||
      static_cast<long long>(splits) * rows_per_split < n ||
      static_cast<long long>(splits - 1) * rows_per_split >= n ||
      metric < 0 || metric > 3 || (approx && metric == 3))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = dense_smem_bytes(p, k, warps, rc);
  if (smem > static_cast<size_t>(k10MaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  DenseArgs a{ci, cv, live, qd, qsq, qabs, lo, n, p, b, k, dim, ldq,
              rows_per_split, rc, part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(splits, ldq / tile);
  const int threads = 32 * warps;
  const bool vec = p % 4 == 0 && reinterpret_cast<uintptr_t>(ci) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(cv) % 16 == 0;
  cudaError_t err;
  switch (metric * 2 + (approx ? 1 : 0)) {
    case 0: err = launch_dense2<0, false>(a, vec, grid, threads, smem, st); break;
    case 1: err = launch_dense2<0, true>(a, vec, grid, threads, smem, st); break;
    case 2: err = launch_dense2<1, false>(a, vec, grid, threads, smem, st); break;
    case 3: err = launch_dense2<1, true>(a, vec, grid, threads, smem, st); break;
    case 4: err = launch_dense2<2, false>(a, vec, grid, threads, smem, st); break;
    case 5: err = launch_dense2<2, true>(a, vec, grid, threads, smem, st); break;
    default: err = launch_dense2<3, false>(a, vec, grid, threads, smem, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_key_select(part, b, splits * k, k, out, st));
}

}  // extern "C"
