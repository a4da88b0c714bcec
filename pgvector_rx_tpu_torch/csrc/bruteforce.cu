// Hand-written Hopper (sm_90a) kernels for the brute-force sweeps of the
// serving path. Built by pgvector_rx_tpu_torch/ops/_build.py with nvcc into
// a shared library with a plain C interface (loaded with ctypes): every
// entry point takes raw device pointers and the caller's stream, launches
// on that stream, allocates nothing, and returns cudaGetLastError().
//
// K1 -- replaces the Pallas `_topk_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:34, called at :121).
//   Exact fused k-NN: score(q, x) = a[x] - 2 q.x in FP32 FMA (no TF32, so
//   ids match an exact search), a running exact top-k per query, and the
//   [B, N] score matrix never reaches device memory.
//   Bound: FP32 FMA issue -- 2*B*D flops per 4*D corpus bytes, so at a
//   1,024-query chunk the sweep sits far on the compute side of the FP32
//   roofline (measured: 17.6 TFLOP/s, 26% of the FP32 peak, at 1,024 x
//   250,001 x 128 on an H100 80GB HBM3 at 700 W).
//   Design: the TPU kernel carries its top-k across a sequential grid;
//   here blocks run in no order, so
//   the corpus is cut into `splits` row ranges, one block per (query
//   tile, split). Each block streams its range through shared memory in
//   64-row tiles (a 64x64 register-blocked SGEMM tile, 4x4 outputs per
//   thread), keeps a sorted top-k list per query in shared memory, and a
//   warp offers a tile row's 64 scores to its list: a ballot against the
//   current k-th best rejects almost every candidate after the first
//   tiles, so selection costs about two compares per score. A second
//   pass (select_kernel) merges the `splits` partial lists per query.
//
// K2 -- replaces the Pallas `_binned_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:185, called at :259).
//   bf16 operands with f32 accumulation (WMMA tensor-core tiles); keeps a
//   running per-bin minimum of a[x] - 2 q.x, where the bin of corpus row r
//   is r mod tn; then a top-k over the tn bins.
//   Bound: the per-score epilogue (one shared-memory round trip and one
//   compare-select per score), not the tensor cores (measured: 32.1
//   TFLOP/s bf16, 3% of the peak, at the same shapes, card and limit).
//   Design: each block owns one query tile, one 128-wide group of bins and
//   a range of corpus tiles; a thread owns 32 fixed (query, bin) cells of
//   the block's 64x128 score tile, so the running minima live in registers
//   across the whole range. Blocks that cover the same bins in other
//   corpus ranges combine once at the end with an order-preserving packed
//   64-bit atomicMin (score key in the high word, row id in the low word,
//   so ties go to the lower row, as in the TPU kernel's strict `<` over
//   its in-order sweep). select_kernel then takes the top-k over the bins.
//
// K3 -- replaces the Pallas `_tilemin_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:302, called at :384).
//   bf16 operands with f32 accumulation (the same WMMA tiles as K2) over a
//   query pre-scaled by 2 and a row term shifted so that every live score
//   is positive; each score becomes one packed int32, its f32 bits with the
//   low 10 mantissa bits replaced by its column in the tn-row tile, and one
//   integer min per (query, tile) keeps the tile's best score and its
//   column together. Output [b, ceil(n / tn)] int32; the wrapper runs the
//   top-k over the tiles and unpacks.
//   Bound: like K2, the per-score epilogue (a shared-memory read, a mask,
//   an OR and an integer min per score), not the tensor cores.
//   Design: the TPU kernel emits one value per grid step; here one block
//   owns a 64-query tile and one whole corpus tile, walks its tn columns
//   in 128-wide WMMA groups, keeps each query's running min in registers
//   (four threads per query, strided columns so shared-memory reads do not
//   conflict) and writes each (query, tile) result once: no atomics and no
//   second pass.
//
// Rows excluded by the caller carry a >= 3e38 in `a`; they are ranked like
// any row, and the Python wrappers turn scores >= 1.5e38 into -1 / inf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <mma.h>
#include <stdint.h>

using namespace nvcuda;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxK = 64;  // top-k lists are at most two warp-widths long

// ---------------------------------------------------------------------------
// Warp-cooperative sorted top-k list (shared memory, ascending by score)
// ---------------------------------------------------------------------------

// Insert (s, id) after every entry <= s, dropping the last entry. Called by
// all 32 lanes with the same (s, id), and only when s < d[k - 1].
__device__ __forceinline__ void warp_insert(float* d, int* ids, int k, float s,
                                            int id, int lane) {
  int p = 0;
#pragma unroll
  for (int base = 0; base < kMaxK; base += 32) {
    int j = base + lane;
    p += __popc(__ballot_sync(kFull, j < k && d[j] <= s));
  }
  float nd[2];
  int ni[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int j = r * 32 + lane;
    if (j < k) {
      if (j < p) {
        nd[r] = d[j];
        ni[r] = ids[j];
      } else if (j == p) {
        nd[r] = s;
        ni[r] = id;
      } else {
        nd[r] = d[j - 1];
        ni[r] = ids[j - 1];
      }
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    int j = r * 32 + lane;
    if (j < k) {
      d[j] = nd[r];
      ids[j] = ni[r];
    }
  }
  __syncwarp();
}

// Each lane holds one candidate (ok = false: none). Candidates that beat the
// list's current k-th best are inserted in lane order, so among equal scores
// the one offered first stays ahead.
__device__ __forceinline__ void warp_offer(float* d, int* ids, int k, float s,
                                           int id, bool ok, int lane) {
  unsigned m = __ballot_sync(kFull, ok && s < d[k - 1]);
  while (m) {
    int src = __ffs(m) - 1;
    m &= m - 1;
    float cs = __shfl_sync(kFull, s, src);
    int cid = __shfl_sync(kFull, id, src);
    if (cs < d[k - 1]) warp_insert(d, ids, k, cs, cid, lane);
  }
}

// Order-preserving float -> uint32 key (smaller float, smaller key).
__device__ __forceinline__ unsigned float_key(float s) {
  unsigned u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_float(unsigned key) {
  return __uint_as_float((key & 0x80000000u) ? (key & 0x7fffffffu) : ~key);
}

// ---------------------------------------------------------------------------
// select_kernel: one warp per query, k smallest of c candidates
// ---------------------------------------------------------------------------

constexpr int kSelWarps = 8;

// PACKED = false: candidates are (cand_d, cand_i) [b, c], id < 0 = empty.
// PACKED = true:  candidates are packed bins [b, c] (K2), all-ones = empty.
template <bool PACKED>
__global__ void __launch_bounds__(kSelWarps * 32)
    select_kernel(const float* __restrict__ cand_d,
                  const int* __restrict__ cand_i,
                  const unsigned long long* __restrict__ packed, int b, int c,
                  int k, float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float sel_smem[];
  int lane = threadIdx.x & 31;
  int warp = threadIdx.x >> 5;
  float* ld = sel_smem + warp * k;
  int* li = reinterpret_cast<int*>(sel_smem + kSelWarps * k) + warp * k;
  int qi = blockIdx.x * kSelWarps + warp;
  if (qi >= b) return;  // whole warp leaves; no block-wide barrier below
  for (int j = lane; j < k; j += 32) {
    ld[j] = CUDART_INF_F;
    li[j] = -1;
  }
  __syncwarp();
  size_t row = static_cast<size_t>(qi) * c;
  for (int c0 = 0; c0 < c; c0 += 32) {
    int j = c0 + lane;
    float s = CUDART_INF_F;
    int id = -1;
    if (j < c) {
      if (PACKED) {
        unsigned long long p = packed[row + j];
        if (p != ~0ull) {
          s = key_float(static_cast<unsigned>(p >> 32));
          id = static_cast<int>(static_cast<unsigned>(p));
        }
      } else {
        s = cand_d[row + j];
        id = cand_i[row + j];
      }
    }
    warp_offer(ld, li, k, s, id, id >= 0, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_d[static_cast<size_t>(qi) * k + j] = ld[j];
    out_i[static_cast<size_t>(qi) * k + j] = li[j];
  }
}

// ---------------------------------------------------------------------------
// K1: exact FP32 sweep, partial top-k per (query tile, corpus split)
// ---------------------------------------------------------------------------

constexpr int k1Tq = 64;  // queries per block
constexpr int k1Tn = 64;  // corpus rows per tile
constexpr int k1Dk = 16;  // feature depth per shared-memory stage
constexpr int k1Threads = 256;

__global__ void __launch_bounds__(k1Threads)
    k1_partial_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ q, int n, int d, int b, int k,
                      int rows_per_split, float* __restrict__ part_d,
                      int* __restrict__ part_i) {
  __shared__ float qs[k1Dk][k1Tq + 4];
  __shared__ float xs[k1Dk][k1Tn + 4];
  __shared__ float ss[k1Tq][k1Tn + 1];
  extern __shared__ float k1_smem[];
  float* topd = k1_smem;                                    // [k1Tq][k]
  int* topi = reinterpret_cast<int*>(k1_smem + k1Tq * k);  // [k1Tq][k]

  int tid = threadIdx.x;
  int lane = tid & 31;
  int warp = tid >> 5;
  int ty = tid / 16;  // query rows ty*4 .. ty*4+3 of the tile
  int tx = tid % 16;  // corpus cols tx*4 .. tx*4+3 of the tile
  int q0 = blockIdx.x * k1Tq;
  int split = blockIdx.y;
  int r0 = split * rows_per_split;
  int r1 = min(n, r0 + rows_per_split);

  for (int i = tid; i < k1Tq * k; i += k1Threads) {
    topd[i] = CUDART_INF_F;
    topi[i] = -1;
  }
  __syncthreads();

  for (int t0 = r0; t0 < r1; t0 += k1Tn) {
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int d0 = 0; d0 < d; d0 += k1Dk) {
      for (int e = tid; e < k1Tq * k1Dk; e += k1Threads) {
        int m = e / k1Dk, kk = e % k1Dk;
        int qi = q0 + m, dj = d0 + kk;
        qs[kk][m] = (qi < b && dj < d) ? q[static_cast<size_t>(qi) * d + dj]
                                       : 0.f;
      }
      for (int e = tid; e < k1Tn * k1Dk; e += k1Threads) {
        int m = e / k1Dk, kk = e % k1Dk;
        int ri = t0 + m, dj = d0 + kk;
        xs[kk][m] = (ri < r1 && dj < d) ? x[static_cast<size_t>(ri) * d + dj]
                                        : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < k1Dk; ++kk) {
        float qa[4], xb[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) qa[i] = qs[kk][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) xb[j] = xs[kk][tx * 4 + j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qa[i], xb[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int ri = t0 + tx * 4 + j;
      float av = ri < r1 ? a[ri] : CUDART_INF_F;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        ss[ty * 4 + i][tx * 4 + j] = av - 2.f * acc[i][j];
    }
    __syncthreads();

    // warp w offers the tile's scores of queries w*8 .. w*8+7 to their lists
    for (int r = warp * 8; r < warp * 8 + 8 && q0 + r < b; ++r) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        int col = h * 32 + lane;
        int ri = t0 + col;
        warp_offer(topd + r * k, topi + r * k, k, ss[r][col], ri, ri < r1,
                   lane);
      }
    }
    __syncthreads();
  }

  for (int e = tid; e < k1Tq * k; e += k1Threads) {
    int m = e / k, j = e % k;
    int qi = q0 + m;
    if (qi < b) {
      size_t o = (static_cast<size_t>(qi) * gridDim.y + split) * k + j;
      part_d[o] = topd[e];
      part_i[o] = topi[e];
    }
  }
}

// ---------------------------------------------------------------------------
// K2: bf16 tensor-core sweep with a running per-bin minimum
// ---------------------------------------------------------------------------

constexpr int k2Tq = 64;          // queries per block
constexpr int k2Bn = 128;         // bins (tile columns) per block
constexpr int k2Dk = 32;          // feature depth per shared-memory stage
constexpr int k2Ldk = k2Dk + 8;   // padded bf16 row stride (WMMA: mult. of 8)
constexpr int k2Lds = k2Bn + 4;   // padded f32 score-tile stride
constexpr int k2Threads = 256;    // 8 warps as 2 (rows) x 4 (cols) of 32x32
constexpr int k2Cells = k2Tq * k2Bn / k2Threads;  // 32 cells per thread
constexpr int k2StageBytes = (k2Tq + k2Bn) * k2Ldk * 2;
constexpr int k2ScoreBytes = k2Tq * k2Lds * 4;
constexpr int k2SmemBytes =
    k2StageBytes > k2ScoreBytes ? k2StageBytes : k2ScoreBytes;

__global__ void __launch_bounds__(k2Threads)
    k2_binmin_kernel(const __nv_bfloat16* __restrict__ x,
                     const float* __restrict__ a,
                     const __nv_bfloat16* __restrict__ q, int n, int d, int b,
                     int tn, int tiles_per_split,
                     unsigned long long* __restrict__ bins) {
  // operand stages and the score tile are never live at once: share bytes
  __shared__ __align__(128) unsigned char smem[k2SmemBytes];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[k2Ldk]>(smem);
  auto xs = reinterpret_cast<__nv_bfloat16(*)[k2Ldk]>(smem + k2Tq * k2Ldk * 2);
  auto ss = reinterpret_cast<float(*)[k2Lds]>(smem);

  int tid = threadIdx.x;
  int warp = tid >> 5;
  int wr = warp >> 2;  // rows wr*32 .. +32 of the score tile
  int wc = warp & 3;   // cols wc*32 .. +32
  int q0 = blockIdx.x * k2Tq;
  int g0 = blockIdx.y * k2Bn;  // first bin of this block
  int ntiles = (n + tn - 1) / tn;
  int t_begin = blockIdx.z * tiles_per_split;
  int t_end = min(ntiles, t_begin + tiles_per_split);
  // this thread's cells: row 2*e + tid/128, column tid % 128, e < 32
  int col = tid % k2Bn;
  int row_base = tid / k2Bn;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);

  float best[k2Cells];
  unsigned best_row[k2Cells];
#pragma unroll
  for (int e = 0; e < k2Cells; ++e) {
    best[e] = CUDART_INF_F;
    best_row[e] = 0xffffffffu;
  }

  for (int t = t_begin; t < t_end; ++t) {
    int row0 = t * tn + g0;  // corpus row of tile column 0
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int d0 = 0; d0 < d; d0 += k2Dk) {
      for (int e = tid; e < k2Tq * k2Dk; e += k2Threads) {
        int m = e / k2Dk, kk = e % k2Dk;
        int qi = q0 + m, dj = d0 + kk;
        qs[m][kk] = (qi < b && dj < d) ? q[static_cast<size_t>(qi) * d + dj]
                                       : zero;
      }
      for (int e = tid; e < k2Bn * k2Dk; e += k2Threads) {
        int m = e / k2Dk, kk = e % k2Dk;
        int ri = row0 + m, dj = d0 + kk;
        xs[m][kk] = (ri < n && dj < d) ? x[static_cast<size_t>(ri) * d + dj]
                                       : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < k2Dk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &qs[wr * 32 + i * 16][kk], k2Ldk);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &xs[wc * 32 + j * 16][kk], k2Ldk);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&ss[wr * 32 + i * 16][wc * 32 + j * 16],
                                acc[i][j], k2Lds, wmma::mem_row_major);
    __syncthreads();

    int row = row0 + col;
    if (row < n) {
      float av = a[row];
#pragma unroll
      for (int e = 0; e < k2Cells; ++e) {
        float s = av - 2.f * ss[2 * e + row_base][col];
        if (s < best[e]) {
          best[e] = s;
          best_row[e] = static_cast<unsigned>(row);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int e = 0; e < k2Cells; ++e) {
    int qi = q0 + 2 * e + row_base;
    if (qi < b && best_row[e] != 0xffffffffu) {
      unsigned long long p =
          (static_cast<unsigned long long>(float_key(best[e])) << 32) |
          best_row[e];
      atomicMin(&bins[static_cast<size_t>(qi) * tn + g0 + col], p);
    }
  }
}

// ---------------------------------------------------------------------------
// K3: bf16 tensor-core sweep, one packed min per (query, corpus tile)
// ---------------------------------------------------------------------------

constexpr int k3Parts = 4;                 // threads per query row
constexpr int k3Cols = k2Bn / k3Parts;     // 32 columns per thread and group
constexpr float kPadScore = 3.0e38f;       // the TPU wrapper's pad-row score

__global__ void __launch_bounds__(k2Threads)
    k3_tilemin_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ q, int n, int d,
                      int b, int tn, int nc, int* __restrict__ out) {
  __shared__ __align__(128) unsigned char smem[k2SmemBytes];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[k2Ldk]>(smem);
  auto xs = reinterpret_cast<__nv_bfloat16(*)[k2Ldk]>(smem + k2Tq * k2Ldk * 2);
  auto ss = reinterpret_cast<float(*)[k2Lds]>(smem);

  int tid = threadIdx.x;
  int warp = tid >> 5;
  int wr = warp >> 2;
  int wc = warp & 3;
  int q0 = blockIdx.y * k2Tq;
  int tile = blockIdx.x;
  int row = tid / k3Parts;   // query row of the block this thread reduces
  int part = tid % k3Parts;  // its columns: part, part + 4, part + 8, ...
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  int best = 0x7fffffff;

  for (int g0 = 0; g0 < tn; g0 += k2Bn) {
    int row0 = tile * tn + g0;  // corpus row of this group's column 0
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int d0 = 0; d0 < d; d0 += k2Dk) {
      for (int e = tid; e < k2Tq * k2Dk; e += k2Threads) {
        int m = e / k2Dk, kk = e % k2Dk;
        int qi = q0 + m, dj = d0 + kk;
        qs[m][kk] = (qi < b && dj < d) ? q[static_cast<size_t>(qi) * d + dj]
                                       : zero;
      }
      for (int e = tid; e < k2Bn * k2Dk; e += k2Threads) {
        int m = e / k2Dk, kk = e % k2Dk;
        int ri = row0 + m, dj = d0 + kk;
        xs[m][kk] = (ri < n && dj < d) ? x[static_cast<size_t>(ri) * d + dj]
                                       : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < k2Dk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &qs[wr * 32 + i * 16][kk], k2Ldk);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &xs[wc * 32 + j * 16][kk], k2Ldk);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(&ss[wr * 32 + i * 16][wc * 32 + j * 16],
                                acc[i][j], k2Lds, wmma::mem_row_major);
    __syncthreads();

#pragma unroll 8
    for (int j = 0; j < k3Cols; ++j) {
      int c = j * k3Parts + part;
      int r = row0 + c;
      float s = r < n ? a[r] - ss[row][c] : kPadScore;
      int p = (__float_as_int(s) & ~0x3ff) | (g0 + c);
      best = min(best, p);
    }
    __syncthreads();
  }

  // the four threads of a row are adjacent lanes of one warp
  best = min(best, __shfl_xor_sync(kFull, best, 1));
  best = min(best, __shfl_xor_sync(kFull, best, 2));
  int qi = q0 + row;
  if (part == 0 && qi < b) out[static_cast<size_t>(qi) * nc + tile] = best;
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points
// ---------------------------------------------------------------------------

extern "C" {

// K1. base [n, d] f32, a [n] f32, q [b, d] f32 -> out [b, k] (score, row),
// ascending; part_* are [b, splits, k] scratch. 1 <= k <= 64.
int pgv_k1_surrogate_topk(const float* base, const float* a, const float* q,
                          int n, int d, int b, int k, int splits,
                          int rows_per_split, float* part_d, int* part_i,
                          float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  size_t dyn = static_cast<size_t>(k1Tq) * k * 8;
  cudaFuncSetAttribute(k1_partial_kernel,
                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                       static_cast<int>(dyn));
  dim3 grid((b + k1Tq - 1) / k1Tq, splits);
  k1_partial_kernel<<<grid, k1Threads, dyn, st>>>(
      base, a, q, n, d, b, k, rows_per_split, part_d, part_i);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<false><<<(b + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                         kSelWarps * k * 8, st>>>(part_d, part_i, nullptr, b,
                                                  splits * k, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// K2. base [n, d] bf16, a [n] f32, q [b, d] bf16 -> out [b, k] (score, row)
// over the tn per-bin minima; bins is [b, tn] u64 scratch. tn % 128 == 0.
int pgv_k2_binned_topk(const void* base, const float* a, const void* q, int n,
                       int d, int b, int k, int tn, int splits,
                       int tiles_per_split, unsigned long long* bins,
                       float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(bins, 0xff, static_cast<size_t>(b) * tn * 8, st);
  dim3 grid((b + k2Tq - 1) / k2Tq, tn / k2Bn, splits);
  k2_binmin_kernel<<<grid, k2Threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(base), a,
      static_cast<const __nv_bfloat16*>(q), n, d, b, tn, tiles_per_split,
      bins);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  select_kernel<true><<<(b + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                        kSelWarps * k * 8, st>>>(nullptr, nullptr, bins, b,
                                                 tn, k, out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

// K3. base [n, d] bf16, a [n] f32 (shifted positive; excluded rows keep a
// >= 3e38), q [b, d] bf16 pre-scaled by 2 -> out [b, nc] packed int32,
// nc = ceil(n / tn). tn % 128 == 0 and tn <= 1024 (a 10-bit column field).
int pgv_k3_tilemin(const void* base, const float* a, const void* q, int n,
                   int d, int b, int tn, int nc, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nc, (b + k2Tq - 1) / k2Tq);
  k3_tilemin_kernel<<<grid, k2Threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(base), a,
      static_cast<const __nv_bfloat16*>(q), n, d, b, tn, nc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
