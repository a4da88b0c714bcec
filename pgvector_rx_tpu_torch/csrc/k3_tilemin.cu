// K3 -- replaces the Pallas `_tilemin_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:302, called at :384).
//
// Packed tile-min bf16 sweep: bf16 operands with f32 sums over a query
// pre-scaled by 2 and a row term `a` shifted so that every live score
// a[r] - 2 q.x_r is positive; each score becomes one packed int32, its f32
// bits with the low 10 mantissa bits replaced by its column in the tn-row
// tile, and one integer min per (query, tile) keeps the tile's best score
// and its column together. Rows past n score 3e38 (the TPU wrapper's pad
// rows). Output [b, ceil(n / tn)] int32; the Python wrapper runs the top-k
// over the tiles and unpacks.
//
// Bound on an H100 SXM: the tensor cores. 2*B*N*D bf16 operations over
// 989 TFLOP/s against N*D*2 corpus bytes over 3.35 TB/s: at 1,024 queries x
// 1,000,000 rows x 128-d that is 0.265 ms of work and 0.076 ms of bytes.
//
// Design (sm_90a), K2's (k2_binned.cu) with a cheaper epilogue:
// - One block owns 128 queries (two consumer warpgroups of 64) and a
//   contiguous range of whole tiles. A tile never spans two blocks, so each
//   (query, tile) result is written once: no atomics, no second pass. The
//   grid (query tiles, splits) aims at one wave, with the query tiles of a
//   range side by side (blockIdx.x fastest), so a corpus chunk is read from
//   device memory about once and served to the others from L2.
// - The query tile is copied into shared memory once and stays there for
//   the block's whole range (for d <= 640; above that it streams beside
//   the corpus).
// - The corpus streams in 128-row chunks through a 4-stage ring of
//   128-byte-wide units with cp.async 16-byte copies (4-byte copies, or
//   synchronous loads for odd d, with the tail zero-filled) into wgmma's
//   128-byte-swizzled layout, the chunk's `a` values beside its last unit,
//   so the copies of three units are in flight while wgmma (m64 n128 k16,
//   bf16 -> f32) runs on the fourth. A 128-row chunk halves the barriers
//   and full wgmma waits per corpus row of K2's 64-row chunk.
// - The epilogue stays in registers: per accumulator cell one subtract,
//   one mask-and-or (the column) and one integer min into the running
//   minimum of the cell's query row, two rows per thread. At a tile's end
//   two shuffles reduce the four lanes that share a row and one lane
//   writes the result; no score goes through shared memory.
// Measured: see PERF.md (K3 row), timed by chip_smoke.py phase 8.
//
// k3_x2max_kernel reads the bf16 rows once for max_r ||x_r||^2, the
// corpus term of the shift (the TPU wrapper's XLA reduction,
// pallas_bruteforce.py:372-376), so the wrapper makes no f32 copy of the
// corpus. Bound: the N*D*2 bytes it reads (0.076 ms at 1M x 128-d).
//
// Rows excluded by the caller carry a >= 3e38 in `a` (kept unshifted, so
// their scores stay positive); the Python wrappers turn scores >= 1.5e38
// into -1 / inf.

#include <cuda_bf16.h>

#include "sweep_common.cuh"

namespace {

constexpr int k3Bq = 128;  // queries per block: two warpgroups of 64
constexpr int k3Bn = 128;  // corpus rows per chunk
constexpr int k3Threads = 256;
constexpr int k3Stages = 4;
constexpr int k3XBytes = k3Bn * kUnitBytes;  // corpus unit: 16 KB
constexpr int k3QBytes = k3Bq * kUnitBytes;  // query unit: 16 KB
constexpr int k3ABytes = k3Bn * 4;
constexpr int k3MaxSmem = 232448;  // an H100 block's shared-memory limit
constexpr int k3MaxTn = 1024;      // the column field has 10 bits
constexpr int kIdMask = k3MaxTn - 1;
constexpr int kNoScore = 0x7fffffff;  // above every packed score
constexpr float kPadScore = 3.0e38f;  // the TPU wrapper's pad-row score

// Shared memory: [queries: `units` resident units, or one per stage]
// [corpus ring: k3Stages units][a ring: k3Stages x k3Bn floats], plus the
// 1,024 bytes that align it.
__host__ __device__ constexpr int k3_q_bytes(bool qres, int units) {
  return (qres ? units : k3Stages) * k3QBytes;
}

__host__ __device__ constexpr int k3_smem_bytes(bool qres, int units) {
  return k3_q_bytes(qres, units) + k3Stages * (k3XBytes + k3ABytes) +
         kAtomBytes;
}

// Fold one chunk's scores into the running minima of this thread's two
// query rows. Cell 4j + 2h + e of the m64n128 accumulator is query row
// (lane / 4) + 8h of the warp's 16 and chunk column 8j + 2 (lane % 4) + e;
// `as` holds the chunk's `a` values, `cb` is the tile column of this
// thread's chunk column 2 (lane % 4), and chunk columns from `lim` on lie
// past the corpus (RAGGED only).
template <bool RAGGED>
__device__ __forceinline__ void fold_chunk(const float (&acc)[64],
                                           const float* as, int lane, int cb,
                                           int lim, int (&best)[2]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int c = 8 * j + 2 * (lane & 3);
    const float2 av = *reinterpret_cast<const float2*>(as + c);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float s = (e ? av.y : av.x) - acc[4 * j + 2 * h + e];
        if (RAGGED && c + e >= lim) s = kPadScore;
        const int p = (__float_as_int(s) & ~kIdMask) | (cb + 8 * j + e);
        best[h] = min(best[h], p);
      }
    }
  }
}

template <int ALIGN, bool QRES>
__global__ void __launch_bounds__(k3Threads, 2)
    k3_tilemin_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ q, int n, int d, int b,
                      int tn, int nc, int tiles_per_split, int units,
                      int* __restrict__ out) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;               // warpgroup: queries wg*64 .. +63
  const int wq = ((tid >> 5) & 3) * 16;  // the warp's 16 rows in them
  const int q0 = blockIdx.x * k3Bq;
  const int t0 = blockIdx.y * tiles_per_split;
  const int ntiles = min(nc, t0 + tiles_per_split) - t0;
  if (ntiles <= 0) return;  // the whole block, before any barrier
  const int cpt = tn / k3Bn;  // chunks per tile
  const int total = ntiles * cpt * units;
  const long long r0 = static_cast<long long>(t0) * tn;  // range's first row
  const int ld = d * 2;  // row bytes
  const char* xb = reinterpret_cast<const char*>(x);
  const char* qb = reinterpret_cast<const char*>(q) +
                   static_cast<size_t>(q0) * ld;

  const uint32_t s_base = smem_addr(smem);
  const uint32_t s_q = s_base;  // resident query units, or one per stage
  const uint32_t s_x = s_q + k3_q_bytes(QRES, units);
  const uint32_t s_a = s_x + k3Stages * k3XBytes;
  auto stage_x = [&](int st) { return s_x + st * k3XBytes; };
  auto stage_a = [&](int st) { return s_a + st * k3ABytes; };
  auto stage_q = [&](int st) { return s_q + st * k3QBytes; };
  // corpus rows of chunk ci that lie in the corpus (0 .. k3Bn)
  auto live_rows = [&](int ci) {
    long long left = n - (r0 + static_cast<long long>(ci) * k3Bn);
    return static_cast<int>(max(0LL, min(static_cast<long long>(k3Bn), left)));
  };

  if (QRES) {
    for (int u = 0; u < units; ++u)
      load_tile<ALIGN, k3Bq, k3Threads>(s_q + u * k3QBytes, qb, xb, b - q0,
                                        ld, ld, u * kUnitBytes, tid);
  }
  // unit v of the sweep: chunk v / units, 128-byte column unit v % units;
  // the chunk's `a` values come with its last unit
  auto issue = [&](int v) {
    if (v < total) {
      int ci = v / units, u = v - ci * units, st = v % k3Stages;
      const long long row0 = r0 + static_cast<long long>(ci) * k3Bn;
      const int rows = live_rows(ci);
      load_tile<ALIGN, k3Bn, k3Threads>(stage_x(st), xb + row0 * ld, xb, rows,
                                        ld, ld, u * kUnitBytes, tid);
      if (!QRES)
        load_tile<ALIGN, k3Bq, k3Threads>(stage_q(st), qb, xb, b - q0, ld,
                                          ld, u * kUnitBytes, tid);
      if (u == units - 1) load_vec<k3Bn>(stage_a(st), a + row0, a, rows, tid);
    }
    cp_async_commit();
  };

  float acc[64];
  int best[2] = {kNoScore, kNoScore};
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  for (int v = 0; v < k3Stages - 1; ++v) issue(v);
  for (int v = 0; v < total; ++v) {
    cp_async_wait<k3Stages - 2>();  // this thread's copies of unit v
    fence_async_smem();
    __syncthreads();  // everyone's copies of v; everyone done with v - 1
    issue(v + k3Stages - 1);        // into the stage of unit v - 1

    const int st = v % k3Stages;
    const int ci = v / units, u = v - ci * units;
    const uint32_t a_op = (QRES ? s_q + u * k3QBytes : stage_q(st)) +
                          wg * 64 * kUnitBytes;
    const uint32_t b_op = stage_x(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k16 (32 bytes) = the unit
      wgmma_bf16_m64n128k16(acc, make_desc(a_op + 32 * kk),
                            make_desc(b_op + 32 * kk),
                            (u > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's scores are complete
      const float* as = reinterpret_cast<const float*>(
          smem + (stage_a(st) - s_base));
      const int cc = ci % cpt;  // the chunk's place in its tile
      const int cb = cc * k3Bn + 2 * (lane & 3);
      const int lim = live_rows(ci);
      if (lim == k3Bn)
        fold_chunk<false>(acc, as, lane, cb, lim, best);
      else
        fold_chunk<true>(acc, as, lane, cb, lim, best);
      if (cc == cpt - 1) {  // the tile is complete: one write per row
        const size_t t = static_cast<size_t>(t0 + ci / cpt);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          int m = best[h];
          m = min(m, __shfl_xor_sync(kFull, m, 1));
          m = min(m, __shfl_xor_sync(kFull, m, 2));
          const int qi = q0 + wg * 64 + wq + (lane >> 2) + 8 * h;
          if ((lane & 3) == 0 && qi < b)
            out[static_cast<size_t>(qi) * nc + t] = m;
          best[h] = kNoScore;
        }
      }
    }
  }
  cp_async_wait<0>();
}

template <int ALIGN, bool QRES>
cudaError_t launch_k3(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                      const float* a, const __nv_bfloat16* q, int n, int d,
                      int b, int tn, int nc, int tps, int units, int* out) {
  int smem = k3_smem_bytes(QRES, units);
  cudaError_t err = cudaFuncSetAttribute(
      k3_tilemin_kernel<ALIGN, QRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k3_tilemin_kernel<ALIGN, QRES><<<grid, k3Threads, smem, st>>>(
      x, a, q, n, d, b, tn, nc, tps, units, out);
  return cudaGetLastError();
}

template <bool QRES>
cudaError_t launch_k3_aligned(int align, dim3 grid, cudaStream_t st,
                              const __nv_bfloat16* x, const float* a,
                              const __nv_bfloat16* q, int n, int d, int b,
                              int tn, int nc, int tps, int units, int* out) {
  if (align == 16)
    return launch_k3<16, QRES>(grid, st, x, a, q, n, d, b, tn, nc, tps,
                               units, out);
  if (align == 4)
    return launch_k3<4, QRES>(grid, st, x, a, q, n, d, b, tn, nc, tps, units,
                              out);
  return launch_k3<2, QRES>(grid, st, x, a, q, n, d, b, tn, nc, tps, units,
                            out);
}

// The largest copy (16, 4 or 2 bytes) that every row start of bf16 rows
// of length d from each of these pointers allows.
int row_align(int d, uintptr_t p0, uintptr_t p1) {
  const uintptr_t p = p0 | p1;
  if (d % 8 == 0 && p % 16 == 0) return 16;
  if (d % 2 == 0 && p % 4 == 0) return 4;
  return 2;
}

// ---------------------------------------------------------------------------
// k3_x2max_kernel: max over rows of the f32 sum of squares of bf16 rows
// ---------------------------------------------------------------------------

constexpr int kXThreads = 256;
constexpr int kXMaxBlocks = 1024;

// Lanes that share one row: the power of two >= the row's loads, at most
// a warp; a warp takes 32 / lanes rows at a time.
__host__ __device__ inline int lanes_per_row(int loads) {
  int p = 1;
  while (p < loads && p < 32) p <<= 1;
  return p;
}

// Sum of squares of the V bf16 values at p (bf16 -> f32 is exact: the
// bf16 bits are the f32's high half; so is each square).
template <int V>
__device__ __forceinline__ float sq_sum(const char* p) {
  if constexpr (V == 8) {
    const uint4 w = __ldg(reinterpret_cast<const uint4*>(p));
    const unsigned u[4] = {w.x, w.y, w.z, w.w};
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float lo = __uint_as_float(u[i] << 16);
      const float hi = __uint_as_float(u[i] & 0xffff0000u);
      s = fmaf(lo, lo, s);
      s = fmaf(hi, hi, s);
    }
    return s;
  } else if constexpr (V == 2) {
    const unsigned w = __ldg(reinterpret_cast<const unsigned*>(p));
    const float lo = __uint_as_float(w << 16);
    const float hi = __uint_as_float(w & 0xffff0000u);
    return fmaf(hi, hi, lo * lo);
  } else {
    const float f = __uint_as_float(
        static_cast<unsigned>(__ldg(reinterpret_cast<const unsigned short*>(p)))
        << 16);
    return f * f;
  }
}

// V bf16 values per load (8: 16-byte loads, 2: 4-byte, 1: 2-byte); each
// block folds its rows' maximum into *out (f32 bits; squares are >= 0, so
// their bits order like ints and an integer atomicMax takes the max).
template <int V>
__global__ void __launch_bounds__(kXThreads)
    k3_x2max_kernel(const __nv_bfloat16* __restrict__ x, int n, int d,
                    int* __restrict__ out) {
  __shared__ float warp_max[kXThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int loads = d / V;
  const int p = lanes_per_row(loads);
  const int rpw = 32 / p;
  const long long nw = static_cast<long long>(gridDim.x) * (kXThreads / 32);
  const char* xb = reinterpret_cast<const char*>(x);
  float best = 0.f;
  for (long long w0 = static_cast<long long>(blockIdx.x) * (kXThreads / 32) +
                      warp;
       w0 * rpw < n; w0 += nw) {
    const long long r = w0 * rpw + lane / p;
    float s = 0.f;
    if (r < n) {
      const char* row = xb + r * d * 2;
      for (int j = lane % p; j < loads; j += p) s += sq_sum<V>(row + j * V * 2);
    }
    for (int o = p >> 1; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    best = fmaxf(best, s);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    best = fmaxf(best, __shfl_xor_sync(kFull, best, o));
  if (lane == 0) warp_max[warp] = best;
  __syncthreads();
  if (threadIdx.x == 0) {
    float m = warp_max[0];
#pragma unroll
    for (int w = 1; w < kXThreads / 32; ++w) m = fmaxf(m, warp_max[w]);
    atomicMax(out, __float_as_int(m));
  }
}

template <int V>
cudaError_t launch_x2max(const __nv_bfloat16* x, int n, int d, int* out,
                         cudaStream_t st) {
  const int rows_per_block = (kXThreads / 32) * (32 / lanes_per_row(d / V));
  const int need = n / rows_per_block + (n % rows_per_block != 0);
  const int blocks = need < kXMaxBlocks ? need : kXMaxBlocks;
  k3_x2max_kernel<V><<<blocks, kXThreads, 0, st>>>(x, n, d, out);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K3. base [n, d] bf16, a [n] f32 (shifted positive; excluded rows keep a
// >= 3e38), q [b, d] bf16 pre-scaled by 2 -> out [b, nc] packed int32,
// nc = ceil(n / tn). tn % 128 == 0 and tn <= 1024 (a 10-bit column field).
// The grid is (ceil(b / 128), splits), split s covering the whole tiles
// [s * tiles_per_split, +tiles_per_split) of tn rows.
int pgv_k3_tilemin(const void* base, const float* a, const void* q, int n,
                   int d, int b, int tn, int nc, int splits,
                   int tiles_per_split, int* out, void* stream) {
  if (tn <= 0 || tn % k3Bn != 0 || tn > k3MaxTn)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int units = (2 * d + kUnitBytes - 1) / kUnitBytes;
  dim3 grid((b + k3Bq - 1) / k3Bq, splits);
  auto xb = static_cast<const __nv_bfloat16*>(base);
  auto qb = static_cast<const __nv_bfloat16*>(q);
  const int align = row_align(d, reinterpret_cast<uintptr_t>(base),
                              reinterpret_cast<uintptr_t>(q));
  cudaError_t err;
  if (k3_smem_bytes(true, units) <= k3MaxSmem)
    err = launch_k3_aligned<true>(align, grid, st, xb, a, qb, n, d, b, tn, nc,
                                  tiles_per_split, units, out);
  else
    err = launch_k3_aligned<false>(align, grid, st, xb, a, qb, n, d, b, tn,
                                   nc, tiles_per_split, units, out);
  return static_cast<int>(err);
}

// max_r sum_j base[r, j]^2 in f32 over base [n, d] bf16 -> out [1] f32.
int pgv_k3_x2max(const void* base, int n, int d, float* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, sizeof(float), st);  // 0.0f
  if (err != cudaSuccess) return static_cast<int>(err);
  auto xb = static_cast<const __nv_bfloat16*>(base);
  int* o = reinterpret_cast<int*>(out);
  const int align = row_align(d, reinterpret_cast<uintptr_t>(base), 0);
  if (align == 16) return static_cast<int>(launch_x2max<8>(xb, n, d, o, st));
  if (align == 4) return static_cast<int>(launch_x2max<2>(xb, n, d, o, st));
  return static_cast<int>(launch_x2max<1>(xb, n, d, o, st));
}

}  // extern "C"
