// K3 -- the tile-min sweep of the serving path, hand-written for Hopper
// (sm_90a). K1 and K2 live in k1_topk.cu and k2_binned.cu; all three share
// sweep_common.cuh. Built by pgvector_rx_tpu_torch/ops/_build.py with nvcc,
// one object per source compiled side by side, into a shared library with
// a plain C interface (loaded with ctypes): every entry point takes raw
// device pointers and the caller's stream, launches on that stream,
// allocates nothing, and returns cudaGetLastError().
//
// K3 -- replaces the Pallas `_tilemin_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:302, called at :384).
//   bf16 operands with f32 accumulation (WMMA tiles, 16x16x16) over a
//   query pre-scaled by 2 and a row term shifted so that every live score
//   is positive; each score becomes one packed int32, its f32 bits with the
//   low 10 mantissa bits replaced by its column in the tn-row tile, and one
//   integer min per (query, tile) keeps the tile's best score and its
//   column together. Output [b, ceil(n / tn)] int32; the wrapper runs the
//   top-k over the tiles and unpacks.
//   Bound: the per-score epilogue (a shared-memory read, a mask,
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
#include <mma.h>

#include "sweep_common.cuh"

using namespace nvcuda;

namespace {

constexpr int k3Tq = 64;          // queries per block
constexpr int k3Bn = 128;         // tile columns per WMMA group
constexpr int k3Dk = 32;          // feature depth per shared-memory stage
constexpr int k3Ldk = k3Dk + 8;   // padded bf16 row stride (WMMA: mult. of 8)
constexpr int k3Lds = k3Bn + 4;   // padded f32 score-tile stride
constexpr int k3Threads = 256;    // 8 warps as 2 (rows) x 4 (cols) of 32x32
constexpr int k3StageBytes = (k3Tq + k3Bn) * k3Ldk * 2;
constexpr int k3ScoreBytes = k3Tq * k3Lds * 4;
constexpr int k3SmemBytes =
    k3StageBytes > k3ScoreBytes ? k3StageBytes : k3ScoreBytes;

constexpr int k3Parts = 4;                 // threads per query row
constexpr int k3Cols = k3Bn / k3Parts;     // 32 columns per thread and group
constexpr float kPadScore = 3.0e38f;       // the TPU wrapper's pad-row score

__global__ void __launch_bounds__(k3Threads)
    k3_tilemin_kernel(const __nv_bfloat16* __restrict__ x,
                      const float* __restrict__ a,
                      const __nv_bfloat16* __restrict__ q, int n, int d,
                      int b, int tn, int nc, int* __restrict__ out) {
  __shared__ __align__(128) unsigned char smem[k3SmemBytes];
  auto qs = reinterpret_cast<__nv_bfloat16(*)[k3Ldk]>(smem);
  auto xs = reinterpret_cast<__nv_bfloat16(*)[k3Ldk]>(smem + k3Tq * k3Ldk * 2);
  auto ss = reinterpret_cast<float(*)[k3Lds]>(smem);

  int tid = threadIdx.x;
  int warp = tid >> 5;
  int wr = warp >> 2;
  int wc = warp & 3;
  int q0 = blockIdx.y * k3Tq;
  int tile = blockIdx.x;
  int row = tid / k3Parts;   // query row of the block this thread reduces
  int part = tid % k3Parts;  // its columns: part, part + 4, part + 8, ...
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  int best = 0x7fffffff;

  for (int g0 = 0; g0 < tn; g0 += k3Bn) {
    int row0 = tile * tn + g0;  // corpus row of this group's column 0
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int d0 = 0; d0 < d; d0 += k3Dk) {
      for (int e = tid; e < k3Tq * k3Dk; e += k3Threads) {
        int m = e / k3Dk, kk = e % k3Dk;
        int qi = q0 + m, dj = d0 + kk;
        qs[m][kk] = (qi < b && dj < d) ? q[static_cast<size_t>(qi) * d + dj]
                                       : zero;
      }
      for (int e = tid; e < k3Bn * k3Dk; e += k3Threads) {
        int m = e / k3Dk, kk = e % k3Dk;
        int ri = row0 + m, dj = d0 + kk;
        xs[m][kk] = (ri < n && dj < d) ? x[static_cast<size_t>(ri) * d + dj]
                                       : zero;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < k3Dk; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                       wmma::row_major>
            fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                       wmma::col_major>
            fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &qs[wr * 32 + i * 16][kk], k3Ldk);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], &xs[wc * 32 + j * 16][kk], k3Ldk);
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
                                acc[i][j], k3Lds, wmma::mem_row_major);
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

extern "C" {

// K3. base [n, d] bf16, a [n] f32 (shifted positive; excluded rows keep a
// >= 3e38), q [b, d] bf16 pre-scaled by 2 -> out [b, nc] packed int32,
// nc = ceil(n / tn). tn % 128 == 0 and tn <= 1024 (a 10-bit column field).
int pgv_k3_tilemin(const void* base, const float* a, const void* q, int n,
                   int d, int b, int tn, int nc, int* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(nc, (b + k3Tq - 1) / k3Tq);
  k3_tilemin_kernel<<<grid, k3Threads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(base), a,
      static_cast<const __nv_bfloat16*>(q), n, d, b, tn, nc, out);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
