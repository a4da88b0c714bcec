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
// - One block owns 128 queries (two warpgroups of 64) and a range of upper
//   rows (a split), one block an SM; the grid runs the query tiles of a
//   split side by side (blockIdx.x fastest), so a chunk of rows is read
//   from device memory about once and served to the others from L2.
// - Each 128-byte unit of the 128 queries and of a 128-row chunk streams
//   through a 4-stage cp.async ring into wgmma's 128-byte-swizzled layout
//   (the queries stream beside the rows, so any d fits); each warpgroup
//   runs wgmma m64 n128 k16, bf16 -> f32, on its 64 queries: a unit is
//   2.1 MFLOP between a wait and a block barrier (a 64 x 64 unit, 0.5
//   MFLOP, left the wait and the barrier setting the pace; PERF.md).
// - The epilogue filters by threshold with no warp-wide step: each warp
//   writes its 16 x 128 products to its warpgroup's tile in shared memory,
//   and each thread then takes one query's even or odd slots of the chunk
//   (64 cells; the chunk's row terms staged in shared memory one chunk
//   ahead),
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

constexpr int k7Bq = 128;  // queries per block: two warpgroups of 64
constexpr int k7Bn = 128;  // upper rows per chunk: m64 n128
constexpr int k7Threads = 256;
constexpr int k7Stages = 4;
constexpr int k7UnitBytes = 128 * kUnitBytes;  // a query or row unit: 16 KB
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
__global__ void __launch_bounds__(k7Threads, 1)
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
  const int wg = tid >> 7;          // warpgroup: queries wg*64 .. +63
  const int warp = (tid >> 5) & 3;  // owns the warpgroup's queries
                                    // warp*16 .. +15
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

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
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
  // the epilogue's query (a row of this warp's, in its warpgroup's tile)
  // and half: slots 2 c + h
  const int r = (tid & 127) >> 1, h = tid & 1;
  float* wtile = tile + wg * 64 * k7TileLd;

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
      wgmma_bf16_m64n128k16(
          acc, make_desc(stage_q(st) + wg * 64 * kUnitBytes + 32 * kk),
          make_desc(stage_x(st) + 32 * kk), (u > 0 || kk > 0) ? 1 : 0);
    }
    wgmma_commit();
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's scores are complete
      // the warp's 16 rows of products to the tile (rows its own threads
      // read: no block barrier)
#pragma unroll
      for (int i = 0; i < 64; i += 2) {
        const int row = warp * 16 + acc_row(i, lane);
        *reinterpret_cast<float2*>(wtile + row * k7TileLd +
                                   acc_col(i, lane)) =
            make_float2(acc[i], acc[i + 1]);
      }
      __syncwarp();
      if (q0 + wg * 64 + r < b) {
        const float* prod = wtile + r * k7TileLd + h;
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
        unsigned long long pass = 0;
#pragma unroll
        for (int c = 0; c < k7Bn / 2; ++c) {
          const float sc = score(c);
          pass |= static_cast<unsigned long long>(sc <= thr &&
                                                  sc < CUDART_INF_F)
                  << c;
        }
        while (pass) {
          const int c = __ffsll(pass) - 1;
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

  if (q0 + wg * 64 + r < b) {
    unsigned long long* out =
        part + ((static_cast<size_t>(q0 + wg * 64 + r) * gridDim.y + split) *
                    2 + h) * s;
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

// ---------------------------------------------------------------------------
// One query: the GEMV form
// ---------------------------------------------------------------------------
//
// At one query (the beam scan's seeding) the batch form's 128-query tile
// carries 127 empty ones and a second launch merges the lists. This form reads
// each row once with 16-byte loads, L lanes a row (L = d / 8 rounded up to
// a power of two, at most 32), four rows of a lane group in flight, sums
// the bf16 products in f32 (each lane its features in order, then a tree
// over the L lanes), and keeps the S best keys of its rows in the row
// group's first lane's registers; a lane group loads its rows' terms and
// element ids before their products and their traversable flags together
// after them. A warp takes its S best in registers (S rounds of a warp
// minimum over the lanes' list heads), warp 0 the block's from the warps'
// in shared memory; the last block to finish (a ticket taken after a
// fence) takes the S best of every block's S the same way, each lane
// reading its share of them from L2 eight at a time, and writes slots and
// ids, in the same launch. One wave of blocks (three an SM). The query is
// rounded to bf16 as it is staged (__float2bfloat16_rn, torch's cast).

constexpr int k7gThreads = 256;
constexpr int k7gWarps = k7gThreads / 32;
constexpr int k7gRows = 4;  // rows of a lane group in flight

// The warp's s smallest keys, each lane holding an ascending list `lst`
// (consumed): s rounds of a warp minimum over the lists' heads, the lane
// whose head it was dropping it (keys are unique). Lane j < s returns the
// j-th smallest (kEmptyKey past the keys). Registers and shuffles only.
__device__ __forceinline__ unsigned long long warp_top(
    unsigned long long (&lst)[k7MaxSeeds], int s, int lane) {
  unsigned long long mine = kEmptyKey;
  for (int r = 0; r < s; ++r) {
    unsigned long long m = lst[0];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const unsigned long long other = __shfl_xor_sync(kFull, m, o);
      m = other < m ? other : m;
    }
    if (m != kEmptyKey && lst[0] == m) {
#pragma unroll
      for (int j = 0; j < k7MaxSeeds - 1; ++j) lst[j] = lst[j + 1];
      lst[k7MaxSeeds - 1] = kEmptyKey;
    }
    if (lane == r) mine = m;
  }
  return mine;
}

// The s smallest of the keys src[0, c) (one warp): each lane keeps the
// best of its keys src[lane], src[lane + 32], ..., then warp_top. GLOBAL:
// src is other blocks' output in device memory (read through L2, eight
// loads in flight a lane), else shared memory.
template <bool GLOBAL = false>
__device__ __forceinline__ unsigned long long warp_top_of(
    const unsigned long long* src, int c, int s, int lane) {
  unsigned long long lst[k7MaxSeeds];
#pragma unroll
  for (int j = 0; j < k7MaxSeeds; ++j) lst[j] = kEmptyKey;
#pragma unroll 8
  for (int i = lane; i < c; i += 32) {
    const unsigned long long key = GLOBAL ? __ldcg(src + i) : src[i];
    if (key < lst[k7MaxSeeds - 1]) reg_insert(lst, key);
  }
  return warp_top(lst, s, lane);
}

template <int L, bool VEC>
__global__ void __launch_bounds__(k7gThreads)
    k7_gemv_kernel(const __nv_bfloat16* __restrict__ x,
                   const float* __restrict__ a,
                   const long long* __restrict__ ids,
                   const unsigned char* __restrict__ trav,
                   const float* __restrict__ q, int n, int d, int s,
                   float scale, unsigned long long* __restrict__ part,
                   unsigned* __restrict__ ticket,
                   long long* __restrict__ out_slot,
                   long long* __restrict__ out_id) {
  constexpr int kRpw = 32 / L;  // rows a warp takes at a time
  extern __shared__ __align__(16) float k7g_q[];  // the query, in bf16
  __shared__ unsigned long long wl[k7gWarps * k7MaxSeeds];
  __shared__ unsigned flag;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / L, li = lane % L;
  for (int i = tid; i < d; i += k7gThreads)
    k7g_q[i] = __bfloat162float(__float2bfloat16_rn(q[i]));
  __syncthreads();

  unsigned long long lst[k7MaxSeeds];
#pragma unroll
  for (int j = 0; j < k7MaxSeeds; ++j) lst[j] = kEmptyKey;
  const long long stride = static_cast<long long>(gridDim.x) * k7gWarps * kRpw;
  const int chunks = d / 8;  // 16-byte chunks a row (VEC: d % 8 == 0)
  for (long long base =
           (static_cast<long long>(blockIdx.x) * k7gWarps + warp) * kRpw;
       base < n; base += k7gRows * stride) {  // warp-uniform trips
    float sum[k7gRows];
    // the rows' terms and element ids before their products, so the
    // traversable flags' dependent loads are issued once an iteration
    float term[k7gRows];
    long long elem[k7gRows];
#pragma unroll
    for (int j = 0; j < k7gRows; ++j) {
      sum[j] = 0.f;
      const long long row = base + j * stride + sub;
      const bool lead = li == 0 && row < n;
      term[j] = lead ? __ldg(a + row) : CUDART_INF_F;
      elem[j] = lead ? __ldg(ids + row) : -1;
    }
    if constexpr (VEC) {
#pragma unroll 4
      for (int c = li; c < chunks; c += L) {
        uint4 w[k7gRows];
#pragma unroll
        for (int j = 0; j < k7gRows; ++j) {
          const long long row = base + j * stride + sub;
          w[j] = row < n ? __ldg(reinterpret_cast<const uint4*>(
                               x + row * d) + c)
                         : make_uint4(0u, 0u, 0u, 0u);
        }
        const float4 q0 = *reinterpret_cast<const float4*>(k7g_q + 8 * c);
        const float4 q1 =
            *reinterpret_cast<const float4*>(k7g_q + 8 * c + 4);
#pragma unroll
        for (int j = 0; j < k7gRows; ++j) {
          const float qv[8] = {q0.x, q0.y, q0.z, q0.w,
                               q1.x, q1.y, q1.z, q1.w};
          const uint32_t wv[4] = {w[j].x, w[j].y, w[j].z, w[j].w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sum[j] = fmaf(qv[2 * e], __uint_as_float(wv[e] << 16), sum[j]);
            sum[j] = fmaf(qv[2 * e + 1],
                          __uint_as_float(wv[e] & 0xffff0000u), sum[j]);
          }
        }
      }
    } else {
      for (int f = li; f < d; f += L) {
#pragma unroll
        for (int j = 0; j < k7gRows; ++j) {
          const long long row = base + j * stride + sub;
          if (row < n)
            sum[j] = fmaf(k7g_q[f], __bfloat162float(x[row * d + f]),
                          sum[j]);
        }
      }
    }
    bool live[k7gRows];
#pragma unroll
    for (int j = 0; j < k7gRows; ++j) live[j] = elem[j] >= 0 && trav[elem[j]];
#pragma unroll
    for (int j = 0; j < k7gRows; ++j) {
#pragma unroll
      for (int o = L / 2; o > 0; o >>= 1)
        sum[j] += __shfl_xor_sync(kFull, sum[j], o);
      const long long row = base + j * stride + sub;
      if (live[j]) {
        // + 0.0f makes -0.0 tie with +0.0
        const float sc = term[j] - scale * sum[j] + 0.0f;
        const unsigned long long key =
            (static_cast<unsigned long long>(float_key(sc)) << 32) |
            static_cast<unsigned>(row);
        if (key < lst[k7MaxSeeds - 1]) reg_insert(lst, key);
      }
    }
  }

  // the block's lists: each warp's S best, then warp 0's of the warps'
  unsigned long long key = warp_top(lst, s, lane);
  if (lane < k7MaxSeeds) wl[warp * k7MaxSeeds + lane] = key;
  __syncthreads();
  if (warp == 0) {
    key = warp_top_of(wl, k7gWarps * k7MaxSeeds, s, lane);
    if (lane < s) part[static_cast<size_t>(blockIdx.x) * s + lane] = key;
  }
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned t = atomicAdd(ticket, 1u);
    flag = t == gridDim.x - 1;
    if (flag) *ticket = 0u;
  }
  __syncthreads();
  if (!flag) return;
  __threadfence();
  // the last block: each warp's S best of an eighth of the blocks' lists,
  // then warp 0's of the warps'
  const int nk = static_cast<int>(gridDim.x) * s;
  const int per = (nk + k7gWarps - 1) / k7gWarps;
  const int k0 = min(nk, warp * per);
  key = warp_top_of<true>(part + k0, min(nk, k0 + per) - k0, s, lane);
  if (lane < k7MaxSeeds) wl[warp * k7MaxSeeds + lane] = key;
  __syncthreads();
  if (warp != 0) return;
  key = warp_top_of(wl, k7gWarps * k7MaxSeeds, s, lane);
  if (lane < s) {
    const long long slot =
        key == kEmptyKey ? -1 : static_cast<long long>(key & 0xffffffffull);
    out_slot[lane] = slot;
    out_id[lane] = slot < 0 ? -1 : ids[slot];
  }
}

template <int L>
cudaError_t launch_k7_gemv(int blocks, cudaStream_t st,
                           const __nv_bfloat16* x, const float* a,
                           const long long* ids, const unsigned char* trav,
                           const float* q, int n, int d, int s, float scale,
                           unsigned long long* part, unsigned* ticket,
                           long long* out_slot, long long* out_id) {
  const int smem = d * 4;
  const bool vec = d % 8 == 0;
  cudaError_t err = cudaSuccess;
  if (smem > 48 * 1024)
    err = vec ? cudaFuncSetAttribute(
                    k7_gemv_kernel<L, true>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem)
              : cudaFuncSetAttribute(
                    k7_gemv_kernel<L, false>,
                    cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  if (vec)
    k7_gemv_kernel<L, true><<<blocks, k7gThreads, smem, st>>>(
        x, a, ids, trav, q, n, d, s, scale, part, ticket, out_slot, out_id);
  else
    k7_gemv_kernel<L, false><<<blocks, k7gThreads, smem, st>>>(
        x, a, ids, trav, q, n, d, s, scale, part, ticket, out_slot, out_id);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K7 at one query. rows [n, d] bf16 (16-byte aligned), a [n] f32, ids [n]
// int64, trav [cap + 1] bool, q [d] f32 (rounded to bf16 here) -> out_slot,
// out_id [s] int64. part [blocks, s] u64 scratch; ticket one u32, zero
// before the call and again after it. lanes: 1, 2, 4, 8, 16 or 32 lanes a
// row. The query fits in 200 KB of shared memory.
int pgv_k7_coarse_one(const void* rows, const float* a, const long long* ids,
                      const unsigned char* trav, const float* q, int n,
                      int d, int s, int l2, int lanes, int blocks,
                      unsigned long long* part, unsigned* ticket,
                      long long* out_slot, long long* out_id, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s < 1 || s > k7MaxSeeds || n < 1 || d < 1 || blocks < 1 ||
      d * 4 > 200 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  auto x = static_cast<const __nv_bfloat16*>(rows);
  const float scale = l2 ? 2.0f : 1.0f;
  switch (lanes) {
    case 1:
      return static_cast<int>(launch_k7_gemv<1>(blocks, st, x, a, ids, trav,
                                                q, n, d, s, scale, part,
                                                ticket, out_slot, out_id));
    case 2:
      return static_cast<int>(launch_k7_gemv<2>(blocks, st, x, a, ids, trav,
                                                q, n, d, s, scale, part,
                                                ticket, out_slot, out_id));
    case 4:
      return static_cast<int>(launch_k7_gemv<4>(blocks, st, x, a, ids, trav,
                                                q, n, d, s, scale, part,
                                                ticket, out_slot, out_id));
    case 8:
      return static_cast<int>(launch_k7_gemv<8>(blocks, st, x, a, ids, trav,
                                                q, n, d, s, scale, part,
                                                ticket, out_slot, out_id));
    case 16:
      return static_cast<int>(launch_k7_gemv<16>(blocks, st, x, a, ids, trav,
                                                 q, n, d, s, scale, part,
                                                 ticket, out_slot, out_id));
    case 32:
      return static_cast<int>(launch_k7_gemv<32>(blocks, st, x, a, ids, trav,
                                                 q, n, d, s, scale, part,
                                                 ticket, out_slot, out_id));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// K7. rows [n, d] bf16 (16-byte aligned), a [n] f32, ids [n] int64, trav
// [cap + 1] bool, q [b, d] bf16 -> out_slot, out_id [b, s] int64; l2 != 0
// scores a - 2 q.x, else a - q.x. part is [b, splits, 2, s] u64 scratch; the
// grid is (ceil(b / 128), splits), split i covering rows [i rows_per_split,
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
