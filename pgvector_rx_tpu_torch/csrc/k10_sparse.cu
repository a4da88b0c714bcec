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
// this card, against ~6.6e9 FMAs for the gather), and elsewhere the same
// gather in a compacted space:
// - the dense-query form (`k10_dense_kernel`): the queries densified once
//   per call into device memory as Qd [dim + 1, ldq], query-minor, row dim
//   zero (pads hit it); a stored row entry (c, v) reads a contiguous run
//   of a query tile's values Qd[c, tile] in one coalesced load and does one
//   FMA per query. No search, no divergence on the query's length.
// - the lookup form (any dim, 0 = unknown): a chunk of B queries holds at
//   most B P distinct indices whatever the dim. The wrapper takes their
//   sorted union U (torch.unique over B P entries) and the queries' places
//   in it; `k10_compact_kernel` maps every stored entry's index to its
//   place in U (U if U lacks it: the zero row; pads stay pads), one search
//   per stored entry (N P of them, not B N P); then `k10_dense_kernel`
//   runs over the mapped rows with dim := |U|. A search of the query's
//   sorted indices for every (query, entry) pair would be ~6.4e9 chains
//   of ~6 dependent shared-memory reads at the smoke's shape; the mapping
//   is ~6.4e6 searches.
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
// The mapping (`k10_compact_kernel`): one thread per stored entry, a
// grid-stride loop; the union's every stride-th value (<= 8,192 of them,
// 32 KB) sits in shared memory, so an entry's search is ~13 shared-memory
// steps, then <= log2(stride) loads from one or two 32-byte sectors of
// the union in global memory. Bound: its bytes (the indices read and the
// mapped indices written, 8 N P bytes: ~0.015 ms at the smoke's shape).
// Measured: see PERF.md (K10 rows), timed by chip_smoke.py phase 24d.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int k10MaxSmem = 200 * 1024;  // as ops/sparse._K10_SMEM assumes
constexpr int kPadIndex = 0x7fffffff;

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// ---------------------------------------------------------------------------
// The lookup form's mapping
// ---------------------------------------------------------------------------

constexpr int kCompactThreads = 256;
constexpr int kCompactSample = 8192;  // the union's sampled values in smem

// out[e] = the place of ci[e] in the ascending union uni[0, u), u if uni
// lacks it, kPadIndex for a pad. samp: every stride-th value of uni (ns =
// ceil(u / stride) of them; none for an empty union); ns = 0 searches the
// whole union at once.
__global__ void __launch_bounds__(kCompactThreads)
    k10_compact_kernel(const int* ci, long long total, const int* uni, int u,
                       int stride, int ns, int* out) {
  __shared__ int samp[kCompactSample];
  for (int i = threadIdx.x; i < ns; i += kCompactThreads)
    samp[i] = uni[static_cast<long long>(i) * stride];
  __syncthreads();
  for (long long e = static_cast<long long>(blockIdx.x) * kCompactThreads +
                     threadIdx.x;
       e < total; e += static_cast<long long>(gridDim.x) * kCompactThreads) {
    const int c = __ldg(ci + e);
    int r = u;
    if (c == kPadIndex) {
      r = kPadIndex;
    } else {
      int lo = 0, m = u;  // where c lies in uni, if anywhere
      if (ns > 0) {
        // s: the number of sampled values <= c
        int s = 0, n = ns;
        while (n > 0) {
          const int h = n >> 1;
          if (samp[s + h] <= c) {
            s += h + 1;
            n -= h + 1;
          } else {
            n = h;
          }
        }
        // uni[(s - 1) stride, s stride); none below the first sample
        lo = s > 0 ? (s - 1) * stride : u;
        m = s > 0 ? min(lo + stride, u) - lo : 0;
      }
      while (m > 0) {  // the first place there whose value is >= c
        const int h = m >> 1;
        if (__ldg(uni + lo + h) < c) {
          lo += h + 1;
          m -= h + 1;
        } else {
          m = h;
        }
      }
      if (lo < u && __ldg(uni + lo) == c) r = lo;
    }
    out[e] = r;
  }
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

// The lookup form's mapping of `total` stored indices ci (padded CSR, pads
// kPadIndex) into the places of the ascending union uni [u] (u >= 0): out
// [total] holds the place, u where uni lacks the index, kPadIndex for a
// pad. `blocks`: the grid's blocks (a grid-stride loop covers the rest).
int pgv_k10_compact(const int* ci, long long total, const int* uni, int u,
                    int blocks, int* out, void* stream) {
  if (total < 0 || u < 0 || blocks <= 0 || blocks > 65535 ||
      (u > 0 && uni == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (total == 0) return 0;
  const int stride = u > kCompactSample ? (u + kCompactSample - 1) /
                                              kCompactSample
                                        : 1;
  const int ns = (u + stride - 1) / stride;
  k10_compact_kernel<<<blocks, kCompactThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(ci, total, uni, u,
                                                            stride, ns, out);
  return static_cast<int>(cudaGetLastError());
}

// K10's dense-query form for b queries over n rows of p padded-CSR
// entries: qd [dim + 1, ldq] the densified queries (f32, or bf16 bits when
// approx; approx takes metrics 0-2), qsq / qabs [b] their norms from f32
// values, lo [b] or null; `warps` warps per block, one query per thread
// (ldq a multiple of the tile 32 warps); the grid is (splits, ldq / tile),
// split s covering rows [s * rows_per_split, +rows_per_split), staged rc
// rows at a time. part [b, splits, k] is scratch; out [b, k] the keys, as
// float_key(d) << 32 | row, ascending, ~0 empty. The lookup form calls it
// with the mapped rows and dim = |U| (0 when the queries hold no entry:
// every entry then reads the zero row 0).
int pgv_k10_dense_topk(const int* ci, const float* cv, const uint8_t* live,
                       const void* qd, const float* qsq, const float* qabs,
                       const unsigned long long* lo, int n, int p, int b,
                       int k, int dim, int ldq, int metric, int approx,
                       int warps, int rc, int splits, int rows_per_split,
                       unsigned long long* part, unsigned long long* out,
                       void* stream) {
  const int tile = 32 * warps;
  if (n <= 0 || p <= 0 || b <= 0 || k < 1 || k > kMaxK || dim < 0 ||
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
