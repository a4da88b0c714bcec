// K2 -- replaces the Pallas `_binned_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:185, called at :259).
//
// Binned bf16 sweep: bf16 operands with f32 sums; a running per-bin minimum
// of a[r] - 2 q.x_r, where the bin of corpus row r is r mod tn (ties go to
// the lower row); then a top-k over the tn bins (select_kernel).
//
// Bound on an H100 SXM: the tensor cores. 2*B*N*D bf16 operations over
// 989 TFLOP/s against N*D*2 corpus bytes over 3.35 TB/s: at 1,024 queries x
// 1,000,000 rows x 128-d that is 0.265 ms of work and 0.078 ms of bytes.
//
// Design (sm_90a):
// - One block owns 128 queries (two consumer warpgroups of 64), one group
//   of 64 bins, and a range of corpus tiles. A chunk of the sweep is the 64
//   rows t*tn + g0 .. +63 of tile t, so an accumulator column is its bin.
// - The query tile is copied into shared memory once and stays there for
//   the block's whole range (for d > 768 it streams beside the corpus).
// - The corpus streams through a 4-stage ring of 128-byte-wide units with
//   cp.async 16-byte copies (4-byte copies, or synchronous loads for odd
//   d, with the tail zero-filled), into wgmma's 128-byte-swizzled layout,
//   so the copies of three units are in flight while wgmma (m64 n64 k16,
//   bf16 -> f32) runs on the fourth.
// - The epilogue stays in registers: each thread owns 32 fixed (query,
//   bin) cells of the accumulator layout and keeps each cell's running
//   minimum and tile across the range; nothing goes through shared memory
//   per score.
// - The grid runs the 8 query tiles of a corpus range side by side
//   (blockIdx.x fastest), so a corpus chunk is read from device memory
//   about once and served to the others from L2.
// - Blocks that cover the same bins in other corpus ranges combine once at
//   the end with an order-preserving packed 64-bit atomicMin (score key in
//   the high word, row id in the low word, so ties go to the lower row, as
//   in the TPU kernel's strict `<` over its in-order sweep).
// Measured: see PERF.md (K2 row), timed by chip_smoke.py phase 8.
//
// Rows excluded by the caller carry a >= 3e38 in `a`; they are ranked like
// any row, and the Python wrapper turns scores >= 1.5e38 into -1 / inf.

#include <cuda_bf16.h>

#include "sweep_common.cuh"

namespace {

constexpr int k2Bq = 128;  // queries per block: two warpgroups of 64
constexpr int k2Bn = 64;   // bins per block = corpus rows per chunk
constexpr int k2Threads = 256;
constexpr int k2Stages = 4;
constexpr int k2XBytes = k2Bn * kUnitBytes;  // corpus unit: 8 KB
constexpr int k2QBytes = k2Bq * kUnitBytes;  // query unit: 16 KB
constexpr int k2ABytes = k2Bn * 4;
constexpr int k2MaxSmem = 232448;  // an H100 block's shared-memory limit

// Shared memory: [queries: `units` resident units, or one per stage]
// [corpus ring: k2Stages units][a ring: k2Stages x k2Bn floats], plus the
// 1,024 bytes that align it.
__host__ __device__ constexpr int k2_q_bytes(bool qres, int units) {
  return (qres ? units : k2Stages) * k2QBytes;
}

__host__ __device__ constexpr int k2_smem_bytes(bool qres, int units) {
  return k2_q_bytes(qres, units) + k2Stages * (k2XBytes + k2ABytes) +
         kAtomBytes;
}

template <int ALIGN, bool QRES>
__global__ void __launch_bounds__(k2Threads, 2)
    k2_binmin_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ a,
                     const __nv_bfloat16* __restrict__ q, int n, int d, int b,
                     int tn, int tiles_per_split, int units,
                     unsigned long long* __restrict__ bins) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;             // warpgroup: queries wg*64 .. +63
  const int wq = ((tid >> 5) & 3) * 16;  // the warp's 16 rows in them
  const int q0 = blockIdx.x * k2Bq;
  const int g0 = blockIdx.y * k2Bn;
  const int ntiles = (n + tn - 1) / tn;
  const int t0 = blockIdx.z * tiles_per_split;
  const int nchunks = min(ntiles, t0 + tiles_per_split) - t0;
  if (nchunks <= 0) return;  // the whole block, before any barrier
  const int total = nchunks * units;
  const int ld = d * 2;  // row bytes
  const char* xb = reinterpret_cast<const char*>(x);
  const char* qb = reinterpret_cast<const char*>(q) +
                   static_cast<size_t>(q0) * ld;

  const uint32_t s_base = smem_addr(smem);
  const uint32_t s_q = s_base;  // resident query units, or one per stage
  const uint32_t s_x = s_q + k2_q_bytes(QRES, units);
  const uint32_t s_a = s_x + k2Stages * k2XBytes;
  auto stage_x = [&](int st) { return s_x + st * k2XBytes; };
  auto stage_a = [&](int st) { return s_a + st * k2ABytes; };
  auto stage_q = [&](int st) { return s_q + st * k2QBytes; };

  if (QRES) {
    for (int u = 0; u < units; ++u)
      load_tile<ALIGN, k2Bq, k2Threads>(s_q + u * k2QBytes, qb, xb, b - q0,
                                        ld, ld, u * kUnitBytes, tid);
  }
  // unit v of the sweep: chunk v / units, 128-byte column unit v % units;
  // the chunk's `a` values come with its last unit
  auto issue = [&](int v) {
    if (v < total) {
      int ci = v / units, u = v - ci * units, st = v % k2Stages;
      long long row0 = static_cast<long long>(t0 + ci) * tn + g0;
      load_tile<ALIGN, k2Bn, k2Threads>(
          stage_x(st), xb + row0 * ld, xb,
          static_cast<int>(min(static_cast<long long>(k2Bn), n - row0)), ld,
          ld, u * kUnitBytes, tid);
      if (!QRES)
        load_tile<ALIGN, k2Bq, k2Threads>(stage_q(st), qb, xb, b - q0, ld,
                                          ld, u * kUnitBytes, tid);
      if (u == units - 1)
        load_vec<k2Bn>(stage_a(st), a + row0, a,
                       static_cast<int>(min(static_cast<long long>(k2Bn),
                                            n - row0)),
                       tid);
    }
    cp_async_commit();
  };

  float acc[32], best[32];
  int best_t[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) {
    acc[i] = 0.f;
    best[i] = CUDART_INF_F;
    best_t[i] = -1;
  }

  for (int v = 0; v < k2Stages - 1; ++v) issue(v);
  for (int v = 0; v < total; ++v) {
    cp_async_wait<k2Stages - 2>();  // this thread's copies of unit v
    fence_async_smem();
    __syncthreads();  // everyone's copies of v; everyone done with v - 1
    issue(v + k2Stages - 1);        // into the stage of unit v - 1

    const int st = v % k2Stages;
    const int ci = v / units, u = v - ci * units;
    const uint32_t a_op = (QRES ? s_q + u * k2QBytes : stage_q(st)) +
                          wg * 64 * kUnitBytes;
    const uint32_t b_op = stage_x(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k16 (32 bytes) = the unit
      wgmma_bf16_m64n64k16(acc, make_desc(a_op + 32 * kk),
                           make_desc(b_op + 32 * kk),
                           (u > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's scores are complete
      const float* as = reinterpret_cast<const float*>(
          smem + (stage_a(st) - s_base));
      const int t = t0 + ci;
      const long long row0 = static_cast<long long>(t) * tn + g0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        int col = acc_col(i, lane);
        float av = row0 + col < n ? as[col] : CUDART_INF_F;
        float s = av - 2.f * acc[i];
        if (s < best[i]) {
          best[i] = s;
          best_t[i] = t;
        }
      }
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 32; ++i) {
    int qi = q0 + wg * 64 + wq + acc_row(i, lane);
    int bin = g0 + acc_col(i, lane);
    if (qi < b && best_t[i] >= 0) {
      unsigned row = static_cast<unsigned>(best_t[i] * tn + bin);
      unsigned long long p =
          (static_cast<unsigned long long>(float_key(best[i])) << 32) | row;
      atomicMin(&bins[static_cast<size_t>(qi) * tn + bin], p);
    }
  }
}

template <int ALIGN, bool QRES>
cudaError_t launch_k2(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                      const float* a, const __nv_bfloat16* q, int n, int d,
                      int b, int tn, int tiles_per_split, int units,
                      unsigned long long* bins) {
  int smem = k2_smem_bytes(QRES, units);
  cudaError_t err = cudaFuncSetAttribute(
      k2_binmin_kernel<ALIGN, QRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k2_binmin_kernel<ALIGN, QRES><<<grid, k2Threads, smem, st>>>(
      x, a, q, n, d, b, tn, tiles_per_split, units, bins);
  return cudaGetLastError();
}

template <bool QRES>
cudaError_t launch_k2_aligned(int d, dim3 grid, cudaStream_t st,
                              const __nv_bfloat16* x, const float* a,
                              const __nv_bfloat16* q, int n, int b, int tn,
                              int tps, int units, unsigned long long* bins) {
  if (d % 8 == 0)
    return launch_k2<16, QRES>(grid, st, x, a, q, n, d, b, tn, tps, units,
                               bins);
  if (d % 2 == 0)
    return launch_k2<4, QRES>(grid, st, x, a, q, n, d, b, tn, tps, units,
                              bins);
  return launch_k2<2, QRES>(grid, st, x, a, q, n, d, b, tn, tps, units, bins);
}

}  // namespace

extern "C" {

// K2. base [n, d] bf16, a [n] f32, q [b, d] bf16 -> out [b, k] (score, row)
// over the tn per-bin minima; bins is [b, tn] u64 scratch. tn % 64 == 0;
// the grid is (ceil(b / 128), tn / 64, splits), each split covering
// tiles_per_split tiles of tn rows.
int pgv_k2_binned_topk(const void* base, const float* a, const void* q, int n,
                       int d, int b, int k, int tn, int splits,
                       int tiles_per_split, unsigned long long* bins,
                       float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      cudaMemsetAsync(bins, 0xff, static_cast<size_t>(b) * tn * 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int units = (2 * d + kUnitBytes - 1) / kUnitBytes;
  dim3 grid((b + k2Bq - 1) / k2Bq, tn / k2Bn, splits);
  auto xb = static_cast<const __nv_bfloat16*>(base);
  auto qb = static_cast<const __nv_bfloat16*>(q);
  if (k2_smem_bytes(true, units) <= k2MaxSmem)
    err = launch_k2_aligned<true>(d, grid, st, xb, a, qb, n, b, tn,
                                  tiles_per_split, units, bins);
  else
    err = launch_k2_aligned<false>(d, grid, st, xb, a, qb, n, b, tn,
                                   tiles_per_split, units, bins);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_select<true>(nullptr, nullptr, bins, b, tn, k, out_d, out_i, st));
}

}  // extern "C"
