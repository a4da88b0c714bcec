// K7 -- the beam engine's coarse seed sweep.
//
// No Pallas ancestor: it replaces the XLA program of the JAX package's
// `_search_batch_coarse` (pgvector_rx_tpu/graph/device.py:828-869: a bf16
// dot_general into a [B, U] score matrix, the mask, lax.top_k) and of
// `_coarse_seed_one` (:732), which the port ran as torch ops (an f32 GEMM
// of the bf16-rounded operands into a [B, U] f32 matrix, torch.where,
// torch.topk).
//
// Function, per query: the S <= 8 upper slots u with the smallest ranking
// score a[u] - scale * q.x_u (l2: scale 2, a[u] the f32 sum of the bf16
// row's squares; ip and cosine: scale 1, a = 0), bf16 operands with f32
// sums; a slot whose element ids[u] is not traversable scores +inf and is
// never kept; ties go to the lower slot (lax.top_k's order). Output: the
// slots and their element ids, -1 past the finite scores.
//
// Bound on an H100 SXM: the tensor cores. 2*B*U*D bf16 operations over 989
// TFLOP/s against the U*D*2 bytes of the upper rows over 3.35 TB/s: at
// 1,024 queries x 62,494 rows x 128-d that is 0.0166 ms of work and 0.0048
// ms of bytes.
//
// Design (sm_90a), K2's bf16 tiles with K1's threshold-filtered lists:
// - One block owns 64 queries (one warpgroup) and a range of upper rows (a
//   split); the grid runs the query tiles of a split side by side
//   (blockIdx.x fastest), so a chunk of rows is read from device memory
//   about once and served to the others from L2.
// - Each 128-byte unit of the 64 queries and of a 64-row chunk streams
//   through a 4-stage cp.async ring into wgmma's 128-byte-swizzled layout
//   (the queries stream beside the rows, so any d fits); wgmma m64 n64 k16,
//   bf16 -> f32.
// - The epilogue filters by threshold with no warp-wide step: each warp
//   writes its 16 x 64 products to a tile in shared memory, and each
//   thread then takes one query's even or odd slots of the chunk (32
//   cells; the chunk's row terms staged in shared memory one chunk ahead),
//   marks the cells that beat its own list's S-th best in a bit mask (no
//   branch), and inserts them into that list, kept sorted in its
//   registers by a compare-and-select chain. A warp so runs as many
//   insert steps as its busiest lane; inserting as each cell passed, or
//   into lists that a warp shares or keeps in shared memory, cost 1.3-3.2x
//   the time at 128-d (PERF.md, probes/k7_cutout.py). A list holds 64-bit
//   keys (float_key(score) << 32 | slot): unique, so the order is (score,
//   lower slot first) whatever the order in which cells arrive. The
//   [B, U] matrix is never written.
// - k7_merge_kernel, one warp per query, takes the S best of the 2 x
//   splits lists and writes slots and ids. One query (B = 1, the beam
//   scan's seeding) spreads U over the same number of blocks, as K1
//   does.
// Measured: see PERF.md (K7 row), timed by chip_smoke.py phases 8 and 18.

#include <cuda_bf16.h>

#include "sweep_common.cuh"

namespace {

constexpr int k7Bq = 64;  // queries per block: one warpgroup
constexpr int k7Bn = 64;  // upper rows per chunk
constexpr int k7Threads = 128;
constexpr int k7Stages = 4;
constexpr int k7UnitBytes = 64 * kUnitBytes;  // a query or a row unit: 8 KB
constexpr int k7StageBytes = 2 * k7UnitBytes;

// The products' tile: k7Bq rows of k7Bn floats, padded so that the 32
// lanes of a warp reading cell 2c + h of rows r (lane = 2 r + h) hit 32
// banks.
constexpr int k7TileLd = k7Bn + 2;
constexpr int k7TileBytes = k7Bq * k7TileLd * 4;
constexpr int k7TermBytes = 2 * k7Bn * 4;  // row terms: two chunks

// The most seeds a query keeps: its lists live in registers (every caller
// of the port asks for 8 seeds or fewer).
constexpr int k7MaxSeeds = 8;

// Shared memory: [k7Stages x (query unit, row unit)][the products' tile]
// [row terms], plus the 1,024 bytes that align it.
constexpr int k7SmemBytes =
    k7Stages * k7StageBytes + k7TileBytes + k7TermBytes + kAtomBytes;

// Insert `key` into the ascending list `lst`, dropping its last: the key
// bubbles through (a compare and two selects a place, no memory).
__device__ __forceinline__ void reg_insert(
    unsigned long long (&lst)[k7MaxSeeds], unsigned long long key) {
#pragma unroll
  for (int j = 0; j < k7MaxSeeds; ++j) {
    const unsigned long long lo = lst[j] < key ? lst[j] : key;
    key = lst[j] < key ? key : lst[j];
    lst[j] = lo;
  }
}

template <int ALIGN>
__global__ void __launch_bounds__(k7Threads)
    k7_partial_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const long long* __restrict__ ids,
                      const unsigned char* __restrict__ trav,
                      const __nv_bfloat16* __restrict__ q, int n, int d,
                      int b, int s, float scale, int rows_per_split,
                      unsigned long long* __restrict__ part) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // owns queries warp*16 .. +15 of the block
  const int q0 = blockIdx.x * k7Bq;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);  // r1 > r0: the plan's splits
  const int units = (2 * d + kUnitBytes - 1) / kUnitBytes;
  const int total = (r1 - r0 + k7Bn - 1) / k7Bn * units;
  const int ld = d * 2;  // row bytes
  const char* xb = reinterpret_cast<const char*>(x);
  const char* qb =
      reinterpret_cast<const char*>(q) + static_cast<size_t>(q0) * ld;

  const uint32_t s_base = smem_addr(smem);
  float* tile = reinterpret_cast<float*>(smem + k7Stages * k7StageBytes);
  float* terms = tile + k7Bq * k7TileLd;  // [2][k7Bn]
  // this thread's list, ascending (its first s entries are the output)
  unsigned long long lst[k7MaxSeeds];
  auto stage_q = [&](int st) { return s_base + st * k7StageBytes; };
  auto stage_x = [&](int st) {
    return s_base + st * k7StageBytes + k7UnitBytes;
  };

#pragma unroll
  for (int j = 0; j < k7MaxSeeds; ++j) lst[j] = kEmptyKey;
  // unit v of the sweep: chunk v / units, 128-byte column unit v % units
  auto issue = [&](int v) {
    if (v < total) {
      const int ci = v / units, u = v - ci * units, st = v % k7Stages;
      const int row0 = r0 + ci * k7Bn;
      load_tile<ALIGN, k7Bn, k7Threads>(
          stage_x(st), xb + static_cast<size_t>(row0) * ld, xb, r1 - row0,
          ld, ld, u * kUnitBytes, tid);
      load_tile<ALIGN, k7Bq, k7Threads>(stage_q(st), qb, xb, b - q0, ld, ld,
                                        u * kUnitBytes, tid);
    }
    cp_async_commit();
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // chunk ci's row terms into terms[ci % 2]: `a`, or +inf past r1 and on
  // slots that are not traversable; staged one chunk ahead of the
  // epilogue that reads them (a block barrier starts every unit)
  auto row_terms = [&](int ci) {
    const int row = r0 + ci * k7Bn + tid;
    if (tid < k7Bn)
      terms[(ci & 1) * k7Bn + tid] =
          row < r1 && trav[__ldg(ids + row)] ? __ldg(a + row) : CUDART_INF_F;
  };
  row_terms(0);
  // the epilogue's query (a row of this warp's) and half: slots 2 c + h
  const int r = tid >> 1, h = tid & 1;

  for (int v = 0; v < k7Stages - 1; ++v) issue(v);
  for (int v = 0; v < total; ++v) {
    cp_async_wait<k7Stages - 2>();  // this thread's copies of unit v
    fence_async_smem();
    __syncthreads();  // everyone's copies of v; everyone done with v - 1
    issue(v + k7Stages - 1);        // into the stage of unit v - 1

    const int st = v % k7Stages;
    const int ci = v / units, u = v - ci * units;
    const int row0 = r0 + ci * k7Bn;
    if (u == 0 && row0 + k7Bn < r1) row_terms(ci + 1);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k16 (32 bytes) = the unit
      wgmma_bf16_m64n64k16(acc, make_desc(stage_q(st) + 32 * kk),
                           make_desc(stage_x(st) + 32 * kk),
                           (u > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's scores are complete
      // the warp's 16 rows of products to the tile (rows its own threads
      // read: no block barrier)
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        const int row = warp * 16 + acc_row(i, lane);
        *reinterpret_cast<float2*>(tile + row * k7TileLd +
                                   acc_col(i, lane)) =
            make_float2(acc[i], acc[i + 1]);
      }
      __syncwarp();
      if (q0 + r < b) {
        const float* prod = tile + r * k7TileLd + h;
        const float* term = terms + (ci & 1) * k7Bn + h;
        // a term is inf past r1 and on dead slots; inf - scale * dot stays
        // inf and never passes. + 0.0f makes -0.0 tie with +0.0.
        auto score = [&](int c) {
          return term[2 * c] - scale * prod[2 * c] + 0.0f;
        };
        // the cells whose score is at most the list's last at the chunk's
        // start (a float compare, no branch; an empty list takes every
        // finite score), then their inserts, each held to the list's last
        // key: a warp runs as many insert steps as its busiest lane, not
        // one for every cell some lane inserts
        const unsigned long long worst = lst[k7MaxSeeds - 1];
        const float thr = worst == kEmptyKey
                              ? CUDART_INF_F
                              : key_float(static_cast<unsigned>(worst >> 32));
        unsigned pass = 0;
#pragma unroll
        for (int c = 0; c < k7Bn / 2; ++c) {
          const float sc = score(c);
          pass |= static_cast<unsigned>(sc <= thr && sc < CUDART_INF_F)
                  << c;
        }
        while (pass) {
          const int c = __ffs(pass) - 1;
          pass &= pass - 1;
          const unsigned long long key =
              (static_cast<unsigned long long>(float_key(score(c))) << 32) |
              static_cast<unsigned>(row0 + 2 * c + h);
          if (key < lst[k7MaxSeeds - 1]) reg_insert(lst, key);
        }
      }
      __syncwarp();  // the tile's rows are read before the next chunk's
    }
  }
  cp_async_wait<0>();

  if (q0 + r < b) {
    unsigned long long* out =
        part + ((static_cast<size_t>(q0 + r) * gridDim.y + split) * 2 + h) * s;
#pragma unroll
    for (int j = 0; j < k7MaxSeeds; ++j)
      if (j < s) out[j] = lst[j];
  }
}

// The s best of each query's c = 2 splits s keys (part [b, c]) -> slots
// and element ids [b, s], -1 past the keys: one warp per query.
__global__ void __launch_bounds__(kSelWarps * 32)
    k7_merge_kernel(const unsigned long long* __restrict__ part, int b,
                    int c, int s, const long long* __restrict__ ids,
                    long long* __restrict__ out_slot,
                    long long* __restrict__ out_id) {
  extern __shared__ unsigned long long k7_sel_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* l = k7_sel_smem + warp * s;
  const int qi = blockIdx.x * kSelWarps + warp;
  if (qi >= b) return;  // whole warp leaves; no block-wide barrier below
  for (int j = lane; j < s; j += 32) l[j] = kEmptyKey;
  __syncwarp();
  const unsigned long long* row = part + static_cast<size_t>(qi) * c;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int j = c0 + lane;
    warp_offer_key(l, s, j < c ? row[j] : kEmptyKey, lane);
  }
  for (int j = lane; j < s; j += 32) {
    const unsigned long long key = l[j];
    const long long slot =
        key == kEmptyKey ? -1 : static_cast<long long>(key & 0xffffffffull);
    out_slot[static_cast<size_t>(qi) * s + j] = slot;
    out_id[static_cast<size_t>(qi) * s + j] = slot < 0 ? -1 : ids[slot];
  }
}

template <int ALIGN>
cudaError_t launch_k7(dim3 grid, cudaStream_t st, const __nv_bfloat16* x,
                      const float* a, const long long* ids,
                      const unsigned char* trav, const __nv_bfloat16* q,
                      int n, int d, int b, int s, float scale,
                      int rows_per_split, unsigned long long* part) {
  cudaError_t err = cudaFuncSetAttribute(
      k7_partial_kernel<ALIGN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      k7SmemBytes);
  if (err != cudaSuccess) return err;
  k7_partial_kernel<ALIGN><<<grid, k7Threads, k7SmemBytes, st>>>(
      x, a, ids, trav, q, n, d, b, s, scale, rows_per_split, part);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7. rows [n, d] bf16 (16-byte aligned), a [n] f32, ids [n] int64, trav
// [cap + 1] bool, q [b, d] bf16 -> out_slot, out_id [b, s] int64; l2 != 0
// scores a - 2 q.x, else a - q.x. part is [b, splits, 2, s] u64 scratch; the
// grid is (ceil(b / 64), splits), split i covering rows [i rows_per_split,
// min(n, (i + 1) rows_per_split)), all non-empty.
int pgv_k7_coarse_topk(const void* rows, const float* a, const long long* ids,
                       const unsigned char* trav, const void* q, int n, int d,
                       int b, int s, int l2, int splits, int rows_per_split,
                       unsigned long long* part, long long* out_slot,
                       long long* out_id, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > k7MaxSeeds || n < 1 || d < 1 || b < 1 || splits < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 grid((b + k7Bq - 1) / k7Bq, splits);
  auto x = static_cast<const __nv_bfloat16*>(rows);
  auto qb = static_cast<const __nv_bfloat16*>(q);
  const float scale = l2 ? 2.0f : 1.0f;
  cudaError_t err;
  if (d % 8 == 0)
    err = launch_k7<16>(grid, st, x, a, ids, trav, qb, n, d, b, s, scale,
                        rows_per_split, part);
  else if (d % 2 == 0)
    err = launch_k7<4>(grid, st, x, a, ids, trav, qb, n, d, b, s, scale,
                       rows_per_split, part);
  else
    err = launch_k7<2>(grid, st, x, a, ids, trav, qb, n, d, b, s, scale,
                       rows_per_split, part);
  if (err != cudaSuccess) return static_cast<int>(err);
  k7_merge_kernel<<<(b + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                    kSelWarps * s * 8, st>>>(part, b, 2 * splits * s, s,
                                             ids, out_slot, out_id);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
