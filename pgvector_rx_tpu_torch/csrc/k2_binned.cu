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
//   the block's whole range (bf16 rows up to d = 768; every other call
//   takes the streamed form below).
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
// The streamed form (k2s_binmin_kernel) takes f16 rows at any d, rounding
// each value to bf16 as it reads it (one round to nearest even, as
// torch's .to(torch.bfloat16): the operands, bins and results of K2 over
// the cast), so a compact store's chunk needs no bf16 copy, and bf16 rows
// past d = 768, whose 128-query tile no longer fits beside the ring. Its
// time went to latency, not to streaming the queries (PERF.md): the
// resident form waits on the tensor cores and on a block barrier after
// every 64-feature unit of 1 MFLOP a block. So it doubles the unit (m64
// n128: 2.1 MFLOP, and a query load serves 128 rows), runs the next unit's
// copies and rounding while the tensor cores run this one, and ends a
// unit with one wait and one block barrier.
//
// Rows excluded by the caller carry a >= 3e38 in `a`; they are ranked like
// any row, and the Python wrapper turns scores >= 1.5e38 into -1 / inf.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

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

// Shared memory: [queries: `units` resident units][corpus ring: k2Stages
// units][a ring: k2Stages x k2Bn floats], plus the 1,024 bytes that align
// it.
__host__ __device__ constexpr int k2_smem_bytes(int units) {
  return units * k2QBytes + k2Stages * (k2XBytes + k2ABytes) + kAtomBytes;
}

template <int ALIGN>
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
  const uint32_t s_q = s_base;  // resident query units
  const uint32_t s_x = s_q + units * k2QBytes;
  const uint32_t s_a = s_x + k2Stages * k2XBytes;
  auto stage_x = [&](int st) { return s_x + st * k2XBytes; };
  auto stage_a = [&](int st) { return s_a + st * k2ABytes; };

  for (int u = 0; u < units; ++u)
    load_tile<ALIGN, k2Bq, k2Threads>(s_q + u * k2QBytes, qb, xb, b - q0, ld,
                                      ld, u * kUnitBytes, tid);
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
    const uint32_t a_op = s_q + u * k2QBytes + wg * 64 * kUnitBytes;
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

template <int ALIGN>
cudaError_t launch_k2(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                      const float* a, const __nv_bfloat16* q, int n, int d,
                      int b, int tn, int tiles_per_split, int units,
                      unsigned long long* bins) {
  int smem = k2_smem_bytes(units);
  cudaError_t err = cudaFuncSetAttribute(
      k2_binmin_kernel<ALIGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return err;
  k2_binmin_kernel<ALIGN><<<grid, k2Threads, smem, st>>>(
      x, a, q, n, d, b, tn, tiles_per_split, units, bins);
  return cudaGetLastError();
}

cudaError_t launch_k2_aligned(int d, dim3 grid, cudaStream_t st,
                              const __nv_bfloat16* x, const float* a,
                              const __nv_bfloat16* q, int n, int b, int tn,
                              int tps, int units, unsigned long long* bins) {
  if (d % 8 == 0)
    return launch_k2<16>(grid, st, x, a, q, n, d, b, tn, tps, units, bins);
  if (d % 2 == 0)
    return launch_k2<4>(grid, st, x, a, q, n, d, b, tn, tps, units, bins);
  return launch_k2<2>(grid, st, x, a, q, n, d, b, tn, tps, units, bins);
}

// ---------------------------------------------------------------------------
// The streamed form: f16 rows at any d, bf16 rows past d = 768
// ---------------------------------------------------------------------------

constexpr int ksBn = 128;  // bins per block = corpus rows per chunk: m64 n128
constexpr int ksStages = 5;
constexpr int ksXBytes = ksBn * kUnitBytes;  // corpus unit: 16 KB
// a stage: the query unit, the corpus unit and the chunk's `a` (512
// bytes, padded so every tile starts on a 1,024-byte boundary)
constexpr int ksStageBytes = k2QBytes + ksXBytes + kAtomBytes;
constexpr int ksSmemBytes = ksStages * ksStageBytes + kAtomBytes;
// tiles a block of the streamed form covers at most: a cell keeps its
// best tile in 16 bits, relative to the block's first (0xffff: none)
constexpr int ksMaxTiles = 0xffff;

// Two f16 values -> two bf16 with one round to nearest even each (f16 ->
// f32 is exact): torch's .to(torch.bfloat16) of an f16 tensor.
__device__ __forceinline__ uint32_t round2_bf16(uint32_t w) {
  const __nv_bfloat162 r = __float22bfloat162_rn(
      __half22float2(*reinterpret_cast<const __half2*>(&w)));
  return *reinterpret_cast<const uint32_t*>(&r);
}

// Round the segments of an f16 tile that this thread copied (load_tile's
// mapping) to bf16 in place.
template <int R, int T>
__device__ __forceinline__ void round_own(unsigned char* tile, int tid) {
#pragma unroll
  for (int s0 = 0; s0 < R * 8; s0 += T) {
    int r, c;
    seg_coords<R>(s0 + tid, r, c);
    uint4* p = reinterpret_cast<uint4*>(tile + seg_offset(r, c));
    uint4 w = *p;
    w.x = round2_bf16(w.x);
    w.y = round2_bf16(w.y);
    w.z = round2_bf16(w.z);
    w.w = round2_bf16(w.w);
    *p = w;
  }
}

// The streamed binned sweep over bf16 rows (ROUND = false, used as
// stored) or f16 rows (ROUND: each thread rounds the segments it copied to
// bf16 in place before the products read them). A block owns 128 queries
// (two warpgroups), 128 bins (m64 n128: a query unit in shared memory
// serves 128 rows, the resident form's 64) and a range of at most
// ksMaxTiles tiles; the queries stream beside the corpus through a 5-stage
// ring; the block issues unit v + 4's copies before unit v's products (a
// warp issuing wgmma waits for the tensor cores to take them) and rounds
// unit v + 1 while they run.
template <bool ROUND, int ALIGN>
__global__ void __launch_bounds__(k2Threads, 1)
    k2s_binmin_kernel(const void* __restrict__ x, const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ q, int n, int d,
                      int b, int tn, int tiles_per_split, int units,
                      unsigned long long* __restrict__ bins) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;               // warpgroup: queries wg*64 .. +63
  const int wq = ((tid >> 5) & 3) * 16;  // the warp's 16 rows in them
  const int q0 = blockIdx.x * k2Bq;
  const int g0 = blockIdx.y * ksBn;
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
  auto stage_q = [&](int st) { return s_base + st * ksStageBytes; };
  auto stage_x = [&](int st) { return stage_q(st) + k2QBytes; };
  auto stage_a = [&](int st) { return stage_x(st) + ksXBytes; };

  // unit v of the sweep: chunk v / units, 128-byte column unit v % units;
  // the chunk's `a` values come with its last unit
  auto issue = [&](int v) {
    if (v < total) {
      const int ci = v / units, u = v - ci * units, st = v % ksStages;
      const long long row0 = static_cast<long long>(t0 + ci) * tn + g0;
      const int rows =
          static_cast<int>(min(static_cast<long long>(ksBn), n - row0));
      load_tile<ALIGN, ksBn, k2Threads>(stage_x(st), xb + row0 * ld, xb, rows,
                                        ld, ld, u * kUnitBytes, tid);
      load_tile<ALIGN, k2Bq, k2Threads>(stage_q(st), qb, xb, b - q0, ld, ld,
                                        u * kUnitBytes, tid);
      if (u == units - 1 && tid < ksBn) {
        const bool ok = tid < rows;
        cp_async4(stage_a(st) + tid * 4, ok ? a + row0 + tid : a, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  auto round_unit = [&](int v) {
    if (ROUND && v < total)
      round_own<ksBn, k2Threads>(smem + (stage_x(v % ksStages) - s_base),
                                 tid);
  };

  float acc[64], best[64];
  // each cell's best tile, relative to t0, 16 bits a cell (cell 2j in the
  // low half of word j): with them packed the kernel takes 253 registers
  uint32_t best_t[32];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    acc[i] = 0.f;
    best[i] = CUDART_INF_F;
  }
#pragma unroll
  for (int i = 0; i < 32; ++i) best_t[i] = 0xffffffffu;

  for (int v = 0; v < ksStages - 1; ++v) issue(v);
  cp_async_wait<ksStages - 2>();  // this thread's copies of unit 0
  round_unit(0);
  fence_async_smem();
  __syncthreads();
  for (int v = 0; v < total; ++v) {
    // unit v has landed (rounded) for every thread; every wgmma of unit
    // v - 1 is done
    const int st = v % ksStages;
    const int ci = v / units, u = v - ci * units;
    issue(v + ksStages - 1);  // into the stage of unit v - 1
    const uint32_t a_op = stage_q(st) + wg * 64 * kUnitBytes;
    const uint32_t b_op = stage_x(st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k16 (32 bytes) = the unit
      wgmma_bf16_m64n128k16(acc, make_desc(a_op + 32 * kk),
                            make_desc(b_op + 32 * kk),
                            (u > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    // while the tensor cores run unit v (other stages):
    cp_async_wait<ksStages - 2>();  // this thread's copies of unit v + 1
    round_unit(v + 1);
    wgmma_wait_all();
    // after the wait: ptxas (CUDA 12.9) crashes on this fence between a
    // wgmma commit and its wait in this kernel
    fence_async_smem();

    if (u == units - 1) {  // the chunk's scores are complete
      const float* as =
          reinterpret_cast<const float*>(smem + (stage_a(st) - s_base));
      const long long row0 = static_cast<long long>(t0 + ci) * tn + g0;
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int col = acc_col(i, lane);
        const float av = row0 + col < n ? as[col] : CUDART_INF_F;
        const float s = av - 2.f * acc[i];
        if (s < best[i]) {
          best[i] = s;
          const int sh = 16 * (i & 1);
          best_t[i >> 1] = (best_t[i >> 1] & ~(0xffffu << sh)) |
                           (static_cast<uint32_t>(ci) << sh);
        }
      }
    }
    __syncthreads();  // unit v + 1 is ready; unit v's stage is free
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int qi = q0 + wg * 64 + wq + acc_row(i, lane);
    const int bin = g0 + acc_col(i, lane);
    const uint32_t rel = (best_t[i >> 1] >> (16 * (i & 1))) & 0xffffu;
    if (qi < b && rel != 0xffffu) {
      const unsigned row = static_cast<unsigned>((t0 + rel) * tn + bin);
      const unsigned long long p =
          (static_cast<unsigned long long>(float_key(best[i])) << 32) | row;
      atomicMin(&bins[static_cast<size_t>(qi) * tn + bin], p);
    }
  }
}

template <bool ROUND, int ALIGN>
cudaError_t launch_k2s(dim3 grid, cudaStream_t st, const void* x, const float* a,
                       const __nv_bfloat16* q, int n, int d, int b, int tn,
                       int tiles_per_split, int units,
                       unsigned long long* bins) {
  cudaError_t err = cudaFuncSetAttribute(
      k2s_binmin_kernel<ROUND, ALIGN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, ksSmemBytes);
  if (err != cudaSuccess) return err;
  k2s_binmin_kernel<ROUND, ALIGN><<<grid, k2Threads, ksSmemBytes, st>>>(
      x, a, q, n, d, b, tn, tiles_per_split, units, bins);
  return cudaGetLastError();
}

// 16-byte copies where every row start allows them, 4-byte ones where d is
// even, else 2-byte loads.
template <bool ROUND>
cudaError_t launch_k2s_aligned(dim3 grid, cudaStream_t st, const void* x,
                               const float* a, const __nv_bfloat16* q, int n,
                               int d, int b, int tn, int tps, int units,
                               unsigned long long* bins) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (d % 8 == 0 && p % 16 == 0)
    return launch_k2s<ROUND, 16>(grid, st, x, a, q, n, d, b, tn, tps, units,
                             bins);
  if (d % 2 == 0 && p % 4 == 0)
    return launch_k2s<ROUND, 4>(grid, st, x, a, q, n, d, b, tn, tps, units, bins);
  return launch_k2s<ROUND, 2>(grid, st, x, a, q, n, d, b, tn, tps, units, bins);
}

}  // namespace

extern "C" {

// K2. base [n, d] bf16 (dtype 2) or f16 (dtype 1, rounded to bf16 as read),
// a [n] f32, q [b, d] bf16 -> out [b, k] (score, row) over the tn per-bin
// minima; bins is [b, tn] u64 scratch. The resident form (bf16 rows whose
// query tile fits in shared memory: d <= 768) takes bins_per_block 64, the
// streamed form (every other call) 128; tn is a multiple of it. The grid
// is (ceil(b / 128), tn / bins_per_block, splits), each split covering
// tiles_per_split tiles of tn rows.
int pgv_k2_binned_topk(const void* base, int dtype, const float* a,
                       const void* q, int n, int d, int b, int k, int tn,
                       int bins_per_block, int splits, int tiles_per_split,
                       unsigned long long* bins, float* out_d, int* out_i,
                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int units = (2 * d + kUnitBytes - 1) / kUnitBytes;
  const bool resident = dtype == 2 && k2_smem_bytes(units) <= k2MaxSmem;
  if ((dtype != 1 && dtype != 2) ||
      bins_per_block != (resident ? k2Bn : ksBn) || tn % bins_per_block ||
      (!resident && tiles_per_split > ksMaxTiles))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err =
      cudaMemsetAsync(bins, 0xff, static_cast<size_t>(b) * tn * 8, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((b + k2Bq - 1) / k2Bq, tn / bins_per_block, splits);
  auto qb = static_cast<const __nv_bfloat16*>(q);
  if (resident)
    err = launch_k2_aligned(
        d, grid, st, static_cast<const __nv_bfloat16*>(base), a, qb, n, b,
        tn, tiles_per_split, units, bins);
  else if (dtype == 1)
    err = launch_k2s_aligned<true>(grid, st, base, a, qb, n, d, b, tn,
                                   tiles_per_split, units, bins);
  else
    err = launch_k2s_aligned<false>(grid, st, base, a, qb, n, d, b, tn,
                                    tiles_per_split, units, bins);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(
      launch_select<true>(nullptr, nullptr, bins, b, tn, k, out_d, out_i, st));
}

}  // extern "C"
