// K1's select form -- replaces the Pallas `_topk_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:34, called at :121) where
//       the tensor-core form (k1_topk.cu) is a poor fit: few queries, or
//       k past its 60 listed places.
//
// Function, per query: the k smallest scores a[x] - 2 q.x over every row,
// ties to the lower row, each score the FP32 sum of K1's rescoring
// (k1_rescore_kernel: one sequential FMA a feature, from feature 0), so a
// score equals the one the tensor-core form reports. Any k in one sweep of
// the rows; k > n pads with (inf, -1) (the wrapper). Rows are f32, f16 or
// bf16 as stored.
//
// Bound on an H100 SXM: the bytes. One query reads every row once: at
// 1,065,536 x 128-d f32 that is 545 MB, 0.164 ms at 3.35 TB/s, against
// 0.004 ms of FP32 FMAs (67 TFLOP/s). At 1,024 queries the FMAs bound it
// (2*B*N*D / 67 TFLOP/s = 4.2 ms at 1M x 128-d).
//
// Design (sm_90a): a radix select over 64-bit order keys.
// - Sweep (k1s_sweep_kernel): a block owns QG queries (1, 4 or 16) and a
//   range of rows, in tiles of 256 rows, one a thread. A tile's rows stream
//   through a 3-stage cp.async ring in 128-byte units of their stored bytes
//   (32 f32 or 64 2-byte features), padded to 144 bytes a row so that each
//   thread reads its own row 16 bytes at a time without bank conflicts; the
//   queries' unit comes with it (read by every thread: a broadcast). Each
//   thread sums its row's products in feature order, one FMA each, in
//   registers across the units. A score becomes the key
//   float_key(s + 0) << 32 | row (ops/bruteforce._order_keys with its top
//   bit flipped: unsigned keys order as the signed ones), written to a
//   per-query key buffer, and its top 9 bits counted in a shared histogram.
// - Select: the k-th key is found digit by digit (9 bits, then 11 at a
//   time). Each pass (k1s_pass_kernel) counts the next digit of the keys
//   that share the resolved prefix; the last block of a query to finish (a
//   ticket taken after a fence) scans the counts, extends the prefix and
//   resets the counts and the ticket for the next pass. Once the prefix's
//   bin holds at most ksCap keys, every later pass returns at once.
// - Compaction (k1s_collect_kernel): the keys below the prefix (all of
//   them are selected) and those inside it (at most ksCap) are appended,
//   a warp's at a time, to the selection and to a candidate list.
// - Order (k1s_finish_kernel): one block a query sorts the candidates in
//   shared memory (bitonic), appends the first k - taken to the selection
//   and, for k <= ksSortCap, sorts the keys below and writes the ordered
//   (score, row) pairs. Past ksSortCap the wrapper sorts the selected keys
//   (torch.sort); the selection stays the kernel's.
// The passes and the compaction load ksLoads keys a thread before they use
// any, over a grid of about 16 blocks an SM (the wrapper's): at many queries
// the keys stream from memory, and one load a thread in flight left them
// latency-bound. They read the keys from L2 at one query (8.5 MB at 1M
// rows).
// Measured: see PERF.md (K1 row "one query, large k"), timed by
// chip_smoke.py phases 8 and 11 and probes/k1_select.py.
//
// Rows excluded by the caller carry a >= 3e38 in `a`; they are ranked like
// any row, and the Python wrappers turn scores >= 1.5e38 into -1 / inf.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

#include "sweep_common.cuh"

namespace {

constexpr int ksThreads = 256;
constexpr int ksRows = 256;  // rows per tile: one a thread
constexpr int ksStages = 3;
constexpr int ksRowLd = kUnitBytes + kSegBytes;  // a row's unit, padded
constexpr int ksTileBytes = ksRows * ksRowLd;    // 36,864
constexpr int ksDigit0 = 9;                      // the sweep's digit
constexpr int ksBins0 = 1 << ksDigit0;
constexpr int ksDigit = 11;                      // each later digit
constexpr int ksBins = 1 << ksDigit;
constexpr int ksLoads = 4;  // keys a thread loads at once in the passes
constexpr int ksCap = 4096;       // the most keys a last bin may hold
constexpr int ksSortCap = 16384;  // the largest k the finish orders
constexpr int ksFinThreads = 1024;
constexpr int ksMaxSmem = 232448;

// A query's selection state (64 bytes; zeroed before the sweep).
struct SelState {
  unsigned long long prefix;  // the resolved top `resolved` bits
  unsigned taken;     // keys below the prefix's range: all selected
  unsigned cnt;       // keys inside the prefix's range
  unsigned resolved;  // bits resolved
  unsigned done;      // the range holds <= ksCap keys, or every bit is set
  unsigned nbelow;    // compaction cursors
  unsigned ncand;
  unsigned ticket;    // blocks of the current pass that are done
  unsigned pad[7];
};
static_assert(sizeof(SelState) == 64, "SelState is 64 bytes");

// Copy rows [0, ksRows) x bytes [c0, c0 + 128) of the rows at src (row r at
// src + r * ld; `rows` rows and `width` bytes a row valid, the rest zero)
// to dst, ksRowLd bytes a row: 16-byte segment s is row s / 8, column
// s % 8, so eight threads read 128 contiguous bytes of one row. ALIGN as
// in load_tile.
template <int ALIGN>
__device__ __forceinline__ void load_rows(uint32_t dst, const char* src,
                                          const char* safe, int rows,
                                          int ld, int width, int c0,
                                          int tid) {
#pragma unroll
  for (int s0 = 0; s0 < ksRows * 8; s0 += ksThreads) {
    const int s = s0 + tid, r = s >> 3, c = s & 7;
    const uint32_t to = dst + r * ksRowLd + c * kSegBytes;
    const int col = c0 + c * kSegBytes;
    const bool live = r < rows;
    const char* g = src + static_cast<size_t>(live ? r : 0) * ld + col;
    if (ALIGN == 16) {
      const bool ok = live && col < width;
      cp_async16(to, ok ? g : safe, ok ? 16 : 0);
    } else if (ALIGN == 4) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const bool ok = live && col + 4 * p < width;
        cp_async4(to + 4 * p, ok ? g + 4 * p : safe, ok ? 4 : 0);
      }
    } else {
      uint32_t w[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const unsigned lo =
            live && col + 4 * p < width
                ? *reinterpret_cast<const uint16_t*>(g + 4 * p)
                : 0u;
        const unsigned hi =
            live && col + 4 * p + 2 < width
                ? *reinterpret_cast<const uint16_t*>(g + 4 * p + 2)
                : 0u;
        w[p] = lo | (hi << 16);
      }
      asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(to),
                   "r"(w[0]), "r"(w[1]), "r"(w[2]), "r"(w[3])
                   : "memory");
    }
  }
}

// Two 2-byte values (the lower feature in the low half) -> two f32.
__device__ __forceinline__ float2 widen2(uint32_t w, __half) {
  return __half22float2(*reinterpret_cast<const __half2*>(&w));
}

__device__ __forceinline__ float2 widen2(uint32_t w, __nv_bfloat16) {
  return make_float2(__uint_as_float(w << 16),
                     __uint_as_float(w & 0xffff0000u));
}

// acc[g] += q_g[f] * x[f] for the four features of one 16-byte f32
// segment, in feature order.
template <int QG>
__device__ __forceinline__ void fma4(float (&acc)[QG], const float* qu,
                                     int qstride, int f, float4 x) {
#pragma unroll
  for (int g = 0; g < QG; ++g) {
    const float4 qv = *reinterpret_cast<const float4*>(qu + g * qstride + f);
    acc[g] = fmaf(qv.x, x.x, acc[g]);
    acc[g] = fmaf(qv.y, x.y, acc[g]);
    acc[g] = fmaf(qv.z, x.z, acc[g]);
    acc[g] = fmaf(qv.w, x.w, acc[g]);
  }
}

// The next unit's products of this thread's row (16-byte segments at xr)
// with the QG queries' unit at qu.
template <typename T, int QG>
__device__ __forceinline__ void unit_products(float (&acc)[QG],
                                              const unsigned char* xr,
                                              const float* qu) {
  constexpr int UF = kUnitBytes / static_cast<int>(sizeof(T));
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if constexpr (sizeof(T) == 4) {
      fma4<QG>(acc, qu, UF, 4 * j,
               *reinterpret_cast<const float4*>(xr + kSegBytes * j));
    } else {
      const uint4 w = *reinterpret_cast<const uint4*>(xr + kSegBytes * j);
      const float2 f0 = widen2(w.x, T()), f1 = widen2(w.y, T());
      const float2 f2 = widen2(w.z, T()), f3 = widen2(w.w, T());
      fma4<QG>(acc, qu, UF, 8 * j, make_float4(f0.x, f0.y, f1.x, f1.y));
      fma4<QG>(acc, qu, UF, 8 * j + 4, make_float4(f2.x, f2.y, f3.x, f3.y));
    }
  }
}

// Exclusive prefix sum of v over the block (blockDim.x a multiple of 32,
// at most 1,024); `tmp` holds 32 words of shared memory.
__device__ __forceinline__ unsigned block_excl_scan(unsigned v,
                                                    unsigned* tmp) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned x = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) tmp[warp] = x;
  __syncthreads();
  if (warp == 0) {
    const int nw = blockDim.x >> 5;
    unsigned t = lane < nw ? tmp[lane] : 0u;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned y = __shfl_up_sync(kFull, t, o);
      if (lane >= o) t += y;
    }
    if (lane < nw) tmp[lane] = t;  // inclusive warp totals
  }
  __syncthreads();
  const unsigned before = warp > 0 ? tmp[warp - 1] : 0u;
  __syncthreads();  // tmp is free again
  return before + x - v;
}

// One digit of the select, run by a whole block of ksThreads: the counts
// `h` (nb bins of the digit at `shift`, over the keys inside the current
// prefix) -> the bin of the (k_eff - taken)-th of them joins the prefix.
// Resets the counts for the next pass.
__device__ void block_find(unsigned* h, int nb, int shift, int width,
                           SelState* st, int k_eff, unsigned* tmp) {
  const int tid = threadIdx.x;
  const int per = nb / ksThreads;  // 2 or 8
  const unsigned need = static_cast<unsigned>(k_eff) - st->taken;
  unsigned loc[ksBins / ksThreads];
  unsigned sum = 0;
#pragma unroll
  for (int i = 0; i < ksBins / ksThreads; ++i) {
    loc[i] = i < per ? __ldcg(h + tid * per + i) : 0u;
    sum += loc[i];
  }
  const unsigned excl = block_excl_scan(sum, tmp);
  if (excl < need && need <= excl + sum) {
    unsigned c = excl;
#pragma unroll
    for (int i = 0; i < ksBins / ksThreads; ++i) {
      if (i < per && c < need && need <= c + loc[i]) {
        const unsigned res = st->resolved + width;
        st->prefix |= static_cast<unsigned long long>(tid * per + i) << shift;
        st->taken += c;
        st->cnt = loc[i];
        st->resolved = res;
        st->done = loc[i] <= ksCap || res == 64;
      }
      c += loc[i];
    }
  }
  for (int i = tid; i < nb; i += ksThreads) h[i] = 0u;
}

// After a block's counts reached `hist`: the last block of the pass (its
// ticket taken after a fence) -> true, and the ticket is reset.
__device__ __forceinline__ bool last_block(SelState* st, unsigned blocks,
                                           unsigned* flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned t = atomicAdd(&st->ticket, 1u);
    *flag = t == blocks - 1;
    if (*flag) st->ticket = 0u;
  }
  __syncthreads();
  const bool last = *flag != 0u;
  if (last) __threadfence();
  return last;
}

template <typename T, int ALIGN, int QG>
__global__ void __launch_bounds__(ksThreads)
    k1s_sweep_kernel(const T* __restrict__ x, const float* __restrict__ a,
                     const float* __restrict__ q, int n, int d, int b,
                     int rows_per_block, int k_eff,
                     unsigned long long* __restrict__ keys,
                     unsigned* __restrict__ hist, SelState* st) {
  constexpr int UF = kUnitBytes / static_cast<int>(sizeof(T));
  constexpr int kStage = ksTileBytes + QG * UF * 4;
  extern __shared__ __align__(16) unsigned char ks_smem[];
  unsigned* h = reinterpret_cast<unsigned*>(ks_smem + ksStages * kStage);
  __shared__ unsigned tmp[32];
  __shared__ unsigned flag;
  const int tid = threadIdx.x, lane = tid & 31;
  const int q0 = blockIdx.x * QG;
  const int r0 = blockIdx.y * rows_per_block;
  const int r1 = min(n, r0 + rows_per_block);
  const int ldx = d * static_cast<int>(sizeof(T));
  const int units = (ldx + kUnitBytes - 1) / kUnitBytes;
  const int total = (r1 - r0 + ksRows - 1) / ksRows * units;
  const char* xb = reinterpret_cast<const char*>(x);
  const uint32_t s_base = smem_addr(ks_smem);

  for (int i = tid; i < QG * ksBins0; i += ksThreads) h[i] = 0u;
  // unit v of the sweep: tile v / units, 128-byte unit v % units
  auto issue = [&](int v) {
    if (v < total) {
      const int t = v / units, u = v - t * units, sg = v % ksStages;
      const int row0 = r0 + t * ksRows;
      load_rows<ALIGN>(s_base + sg * kStage,
                       xb + static_cast<size_t>(row0) * ldx, xb, r1 - row0,
                       ldx, ldx, u * kUnitBytes, tid);
      for (int e = tid; e < QG * UF; e += ksThreads) {
        const int g = e / UF, f = u * UF + (e - g * UF);
        const bool ok = q0 + g < b && f < d;
        cp_async4(s_base + sg * kStage + ksTileBytes + 4 * e,
                  ok ? q + static_cast<size_t>(q0 + g) * d + f : q,
                  ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  float acc[QG];
  for (int v = 0; v < ksStages - 1; ++v) issue(v);
  for (int v = 0; v < total; ++v) {
    cp_async_wait<ksStages - 2>();  // this thread's copies of unit v
    __syncthreads();  // everyone's copies of v; everyone done with v - 1
    issue(v + ksStages - 1);  // into the stage of unit v - 1
    const int t = v / units, u = v - t * units, sg = v % ksStages;
    if (u == 0) {
#pragma unroll
      for (int g = 0; g < QG; ++g) acc[g] = 0.f;
    }
    unit_products<T, QG>(
        acc, ks_smem + sg * kStage + tid * ksRowLd,
        reinterpret_cast<const float*>(ks_smem + sg * kStage + ksTileBytes));
    if (u == units - 1) {  // the tile's scores are complete
      const int row = r0 + t * ksRows + tid;
      const float av = row < r1 ? __ldg(a + row) : 0.f;
#pragma unroll
      for (int g = 0; g < QG; ++g) {
        const bool ok = row < r1 && q0 + g < b;
        // + 0.0f makes -0.0 tie with +0.0
        const float s = av - 2.f * acc[g] + 0.0f;
        const unsigned long long key =
            (static_cast<unsigned long long>(float_key(s)) << 32) |
            static_cast<unsigned>(row);
        if (ok) keys[static_cast<size_t>(q0 + g) * n + row] = key;
        // the warp's keys of one bin counted by one atomic
        const int bin = ok ? static_cast<int>(key >> (64 - ksDigit0)) : -1;
        const unsigned peers = __match_any_sync(kFull, bin);
        if (ok && lane == __ffs(peers) - 1)
          atomicAdd(&h[g * ksBins0 + bin], __popc(peers));
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  for (int i = tid; i < QG * ksBins0; i += ksThreads) {
    const int g = i / ksBins0;
    if (h[i] && q0 + g < b)
      atomicAdd(hist + static_cast<size_t>(q0 + g) * ksBins + (i % ksBins0),
                h[i]);
  }
  if (!last_block(st + q0, gridDim.y, &flag)) return;
  for (int g = 0; g < QG && q0 + g < b; ++g) {
    block_find(hist + static_cast<size_t>(q0 + g) * ksBins, ksBins0,
               64 - ksDigit0, ksDigit0, st + q0 + g, k_eff, tmp);
    __syncthreads();
  }
}

// One later digit (bits [shift, shift + ksDigit)) of every query still
// selecting: block (x, y) counts keys [x per, (x + 1) per) of query y.
__global__ void __launch_bounds__(ksThreads)
    k1s_pass_kernel(const unsigned long long* __restrict__ keys, int n,
                    int per, int shift, int k_eff,
                    unsigned* __restrict__ hist, SelState* st) {
  __shared__ unsigned h[ksBins];
  __shared__ unsigned tmp[32];
  __shared__ unsigned flag;
  const int qi = blockIdx.y;
  SelState* s = st + qi;
  if (s->done) return;  // every block of the query sees the same flag
  const int tid = threadIdx.x;
  const int hi_shift = shift + ksDigit;  // < 64: the sweep resolved 9 bits
  const unsigned long long top = s->prefix >> hi_shift;
  for (int i = tid; i < ksBins; i += ksThreads) h[i] = 0u;
  __syncthreads();
  const unsigned long long* kq = keys + static_cast<size_t>(qi) * n;
  const int i0 = blockIdx.x * per;  // < n: the grid's blocks all hold keys
  const int i1 = i0 + min(per, n - i0);
  for (int base = i0 + tid; base < i1; base += ksThreads * ksLoads) {
    unsigned long long key[ksLoads];
#pragma unroll
    for (int j = 0; j < ksLoads; ++j) {  // every load issued, then used
      const int i = base + j * ksThreads;
      key[j] = i < i1 ? kq[i] : 0ull;
    }
#pragma unroll
    for (int j = 0; j < ksLoads; ++j)
      if (base + j * ksThreads < i1 && (key[j] >> hi_shift) == top)
        atomicAdd(&h[(key[j] >> shift) & (ksBins - 1)], 1u);
  }
  __syncthreads();
  unsigned* hq = hist + static_cast<size_t>(qi) * ksBins;
  for (int i = tid; i < ksBins; i += ksThreads)
    if (h[i]) atomicAdd(hq + i, h[i]);
  if (!last_block(s, gridDim.x, &flag)) return;
  block_find(hq, ksBins, shift, ksDigit, s, k_eff, tmp);
}

// Append the warp's keys that satisfy `take` to list[0, ...) at *cursor.
__device__ __forceinline__ void warp_append(bool take,
                                            unsigned long long key,
                                            unsigned long long* list,
                                            unsigned* cursor) {
  const unsigned m = __ballot_sync(kFull, take);
  if (!m) return;
  const int lane = threadIdx.x & 31;
  const int leader = __ffs(m) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(cursor, __popc(m));
  base = __shfl_sync(kFull, base, leader);
  if (take) list[base + __popc(m & ((1u << lane) - 1u))] = key;
}

// The keys below the prefix's range -> sel[0, taken) and those inside it
// -> cand[0, cnt), in no order: block (x, y) takes keys [x per, (x + 1)
// per) of query y.
__global__ void __launch_bounds__(ksThreads)
    k1s_collect_kernel(const unsigned long long* __restrict__ keys, int n,
                       int per, unsigned long long* __restrict__ sel,
                       int k, unsigned long long* __restrict__ cand,
                       SelState* st) {
  const int qi = blockIdx.y;
  SelState* s = st + qi;
  const unsigned long long lo = s->prefix;
  const int span = 64 - static_cast<int>(s->resolved);  // <= 55
  const unsigned long long top = lo >> span;
  const unsigned long long* kq = keys + static_cast<size_t>(qi) * n;
  unsigned long long* sq = sel + static_cast<size_t>(qi) * k;
  unsigned long long* cq = cand + static_cast<size_t>(qi) * ksCap;
  const int i0 = blockIdx.x * per, i1 = i0 + min(per, n - i0);
  // warp-uniform trips, every load of a trip issued before the appends
  for (int base = i0; base < i1; base += ksThreads * ksLoads) {
    unsigned long long key[ksLoads];
#pragma unroll
    for (int j = 0; j < ksLoads; ++j) {
      const int i = base + j * ksThreads + threadIdx.x;
      key[j] = i < i1 ? kq[i] : kEmptyKey;
    }
#pragma unroll
    for (int j = 0; j < ksLoads; ++j) {
      const bool ok = base + j * ksThreads + threadIdx.x < i1;
      const bool below = ok && key[j] < lo;
      warp_append(below, key[j], sq, &s->nbelow);
      warp_append(ok && !below && (key[j] >> span) == top, key[j], cq,
                  &s->ncand);
    }
  }
}

// Bitonic sort of l[0, p) ascending (p a power of two), the whole block.
__device__ void block_sort(unsigned long long* l, int p) {
  for (int size = 2; size <= p; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = threadIdx.x; i < (p >> 1); i += blockDim.x) {
        const int lo = 2 * i - (i & (stride - 1));
        const int hi = lo + stride;
        const unsigned long long x = l[lo], y = l[hi];
        if ((x > y) == ((lo & size) == 0)) {
          l[lo] = y;
          l[hi] = x;
        }
      }
      __syncthreads();
    }
  }
}

__device__ __forceinline__ int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

// One block a query: the candidates sorted, their first k_eff - taken
// appended to the selection; with `order`, the keys below sorted too and
// the k (score, row) pairs written in order, (inf, -1) past k_eff.
__global__ void __launch_bounds__(ksFinThreads)
    k1s_finish_kernel(const unsigned long long* __restrict__ cand,
                      unsigned long long* __restrict__ sel, int k,
                      int k_eff, const SelState* __restrict__ st,
                      int order, float* __restrict__ out_d,
                      int* __restrict__ out_i) {
  extern __shared__ unsigned long long fin_smem[];
  unsigned long long* A = fin_smem;          // [ksCap] candidates
  unsigned long long* B = fin_smem + ksCap;  // [pow2 >= k] keys below
  const int qi = blockIdx.x, tid = threadIdx.x;
  const int cnt = static_cast<int>(st[qi].cnt);
  const int taken = static_cast<int>(st[qi].taken);
  const int krem = k_eff - taken;
  const unsigned long long* cq = cand + static_cast<size_t>(qi) * ksCap;
  unsigned long long* sq = sel + static_cast<size_t>(qi) * k;
  const int p1 = pow2_at_least(cnt);
  for (int i = tid; i < p1; i += ksFinThreads)
    A[i] = i < cnt ? cq[i] : kEmptyKey;
  __syncthreads();
  block_sort(A, p1);
  for (int j = tid; j < krem; j += ksFinThreads) sq[taken + j] = A[j];
  if (!order) return;
  const int p2 = pow2_at_least(taken);
  for (int i = tid; i < p2; i += ksFinThreads)
    B[i] = i < taken ? sq[i] : kEmptyKey;
  __syncthreads();
  block_sort(B, p2);
  for (int j = tid; j < k; j += ksFinThreads) {
    const unsigned long long key =
        j < taken ? B[j] : (j < k_eff ? A[j - taken] : kEmptyKey);
    const bool ok = key != kEmptyKey;
    out_d[static_cast<size_t>(qi) * k + j] =
        ok ? key_float(static_cast<unsigned>(key >> 32)) : CUDART_INF_F;
    out_i[static_cast<size_t>(qi) * k + j] =
        ok ? static_cast<int>(static_cast<unsigned>(key)) : -1;
  }
}

template <typename T, int ALIGN, int QG>
cudaError_t launch_sweep(dim3 grid, cudaStream_t stream, const T* x,
                         const float* a, const float* q, int n, int d,
                         int b, int rows_per_block, int k_eff,
                         unsigned long long* keys, unsigned* hist,
                         SelState* st) {
  constexpr int UF = kUnitBytes / static_cast<int>(sizeof(T));
  constexpr int smem =
      ksStages * (ksTileBytes + QG * UF * 4) + QG * ksBins0 * 4;
  static_assert(smem <= ksMaxSmem, "k1s_sweep_kernel's shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      k1s_sweep_kernel<T, ALIGN, QG>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k1s_sweep_kernel<T, ALIGN, QG><<<grid, ksThreads, smem, stream>>>(
      x, a, q, n, d, b, rows_per_block, k_eff, keys, hist, st);
  return cudaGetLastError();
}

template <typename T, int ALIGN>
cudaError_t launch_sweep_qg(int qg, cudaStream_t stream, const T* x,
                            const float* a, const float* q, int n, int d,
                            int b, int rows_per_block, int k_eff,
                            unsigned long long* keys, unsigned* hist,
                            SelState* st) {
  const dim3 grid((b + qg - 1) / qg, (n + rows_per_block - 1) / rows_per_block);
  if (qg == 1)
    return launch_sweep<T, ALIGN, 1>(grid, stream, x, a, q, n, d, b,
                                     rows_per_block, k_eff, keys, hist, st);
  if (qg == 4)
    return launch_sweep<T, ALIGN, 4>(grid, stream, x, a, q, n, d, b,
                                     rows_per_block, k_eff, keys, hist, st);
  if (qg == 16)
    return launch_sweep<T, ALIGN, 16>(grid, stream, x, a, q, n, d, b,
                                      rows_per_block, k_eff, keys, hist, st);
  return cudaErrorInvalidValue;
}

// The sweep at the widest copies the rows allow: 16 bytes where every row
// start is 16-byte aligned, 4 where it is 4-byte aligned, else 2-byte
// loads (2-byte rows of odd width).
template <typename T>
cudaError_t launch_sweep_aligned(int qg, cudaStream_t stream, const T* x,
                                 const float* a, const float* q, int n,
                                 int d, int b, int rows_per_block, int k_eff,
                                 unsigned long long* keys, unsigned* hist,
                                 SelState* st) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  const int ldx = d * static_cast<int>(sizeof(T));
  if (ldx % 16 == 0 && p % 16 == 0)
    return launch_sweep_qg<T, 16>(qg, stream, x, a, q, n, d, b,
                                  rows_per_block, k_eff, keys, hist, st);
  if (ldx % 4 == 0 && p % 4 == 0)
    return launch_sweep_qg<T, 4>(qg, stream, x, a, q, n, d, b,
                                 rows_per_block, k_eff, keys, hist, st);
  if constexpr (sizeof(T) == 2)
    return launch_sweep_qg<T, 2>(qg, stream, x, a, q, n, d, b,
                                 rows_per_block, k_eff, keys, hist, st);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// K1's select form. base [n, d] f32 (dtype 0), f16 (1) or bf16 (2), a [n]
// f32, q [b, d] f32 -> the k_eff = min(k, n) smallest keys of each query
// in sel [b, k] (unsigned order keys: float_key(score) << 32 | row) and,
// with `order` (k <= 16,384), the k (score, row) pairs ascending in out_d /
// out_i [b, k], (inf, -1) past k_eff. Scratch: keys [b, n] u64, hist
// [b, 2,048] u32, state [b] x 64 bytes, cand [b, 4,096] u64. The sweep's
// grid is (ceil(b / qg), ceil(n / rows_per_block)), qg in {1, 4, 16},
// rows_per_block a multiple of 256; the passes' is (ceil(n / per), b).
int pgv_k1_select_topk(const void* base, int dtype, const float* a,
                       const float* q, int n, int d, int b, int k, int qg,
                       int rows_per_block, int per,
                       unsigned long long* keys, unsigned* hist, void* state,
                       unsigned long long* cand, unsigned long long* sel,
                       int order, float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n < 1 || d < 1 || b < 1 || k < 1 || b > 65535 || per < 1 ||
      rows_per_block < ksRows || rows_per_block % ksRows != 0 ||
      (order && min(k, n) > ksSortCap) || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int k_eff = min(k, n);
  SelState* s = static_cast<SelState*>(state);
  cudaError_t err = cudaMemsetAsync(
      hist, 0, static_cast<size_t>(b) * ksBins * sizeof(unsigned), st);
  if (err == cudaSuccess)
    err = cudaMemsetAsync(s, 0, static_cast<size_t>(b) * sizeof(SelState),
                          st);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dtype == 0)
    err = launch_sweep_aligned(qg, st, static_cast<const float*>(base), a, q,
                               n, d, b, rows_per_block, k_eff, keys, hist, s);
  else if (dtype == 1)
    err = launch_sweep_aligned(qg, st, static_cast<const __half*>(base), a,
                               q, n, d, b, rows_per_block, k_eff, keys, hist,
                               s);
  else
    err = launch_sweep_aligned(qg, st,
                               static_cast<const __nv_bfloat16*>(base), a, q,
                               n, d, b, rows_per_block, k_eff, keys, hist, s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pgrid((n + per - 1) / per, b);
  // the later digits: 55 bits in five passes of 11
  for (int shift = 64 - ksDigit0 - ksDigit; shift >= 0; shift -= ksDigit) {
    k1s_pass_kernel<<<pgrid, ksThreads, 0, st>>>(keys, n, per, shift, k_eff,
                                                 hist, s);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  k1s_collect_kernel<<<pgrid, ksThreads, 0, st>>>(keys, n, per, sel, k, cand,
                                                  s);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  int p2 = 1;
  while (order && p2 < k_eff) p2 <<= 1;
  const int fsmem = (ksCap + (order ? p2 : 0)) * 8;
  err = cudaFuncSetAttribute(k1s_finish_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             fsmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1s_finish_kernel<<<b, ksFinThreads, fsmem, st>>>(cand, sel, k, k_eff, s,
                                                    order, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
