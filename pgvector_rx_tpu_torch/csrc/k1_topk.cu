// K1 -- replaces the Pallas `_topk_kernel`
//       (pgvector_rx_tpu/ops/pallas_bruteforce.py:34, called at :121).
//
// Exact fused k-NN: score(q, x) = a[x] - 2 q.x at FP32 accuracy, a running
// exact top-k per query, and the [B, N] score matrix never reaches device
// memory.
//
// Bound on an H100 SXM: the tensor cores' TF32 rate. FP32 accuracy from
// tf32 products takes three of them per FP32 product ("3xTF32": every
// operand v splits into big = tf32(v) and small = tf32(v - big), and
// big.big + big.small + small.big is summed in f32; the dropped
// small.small term is ~2^-22 of the product), so 3 * 2*B*N*D operations
// over 495 TFLOP/s: at 1,024 queries x 1,000,000 rows x 128-d that is
// 1.59 ms, against 0.154 ms for the 516 MB of corpus and 3.91 ms for the
// same sweep on the FP32 FMA units (67 TFLOP/s).
//
// Design (sm_90a):
// - One block owns 64 queries (one consumer warpgroup) and a range of
//   corpus rows (a split); the grid runs the query tiles of a split side by
//   side (blockIdx.x fastest) so a corpus chunk is read from device memory
//   about once and served to the others from L2.
// - The queries' big and small halves (split by the wrapper) are copied
//   into shared memory once and stay there for the whole range (for
//   d > 352 at k = 10, d > 288 at k = 64, they stream beside the corpus).
// - The corpus streams in 64-row chunks through a 3-stage ring of
//   128-byte-wide units with cp.async 16-byte copies (4-byte copies when
//   d % 4 != 0, the tail zero-filled) into wgmma's 128-byte-swizzled
//   layout; each thread splits the segments it copied into big (in place)
//   and small halves, for unit v + 1 while the tensor cores run unit v, and
//   wgmma (m64 n64 k8, tf32 -> f32) runs the three products on a unit.
// - The epilogue filters by threshold: each thread compares its 32
//   accumulator cells with its two queries' current kl-th best (read from
//   shared memory into registers); a ballot hands the few cells that beat
//   it to the warp, which inserts them into the query's sorted list with
//   warp_insert. A warp's 16 queries are its own, so no block barrier is
//   needed, and after the first chunks almost nothing passes.
// - The lists hold kl = k + 4 candidates. A second pass (select_kernel)
//   takes the best kl of the `splits` lists per query, and a third
//   (k1_rescore_kernel) rescores those kl exactly with the sequential FP32
//   FMAs of a scalar sweep and keeps the best k: the tensor cores truncate
//   their running sums, so 3xTF32 scores drift ~1e-6 of q.x from FP32; the
//   rescoring returns FP32 scores, and the 4 spare places keep a true
//   top-k row whose approximate score fell just behind.
// Measured: see PERF.md (K1 row), timed by chip_smoke.py phase 8.
//
// Rows excluded by the caller carry a >= 3e38 in `a`; they are ranked like
// any row, and the Python wrappers turn scores >= 1.5e38 into -1 / inf.

#include "sweep_common.cuh"

namespace {

constexpr int k1Bq = 64;  // queries per block: one warpgroup
constexpr int k1Bn = 64;  // corpus rows per chunk
constexpr int k1Threads = 128;
constexpr int k1Stages = 3;
constexpr int k1Spare = 4;  // list places beyond k, for the rescoring
constexpr int k1XBytes = k1Bn * kUnitBytes;  // corpus unit: 8 KB
constexpr int k1QBytes = k1Bq * kUnitBytes;  // one query half's unit: 8 KB
constexpr int k1MaxSmem = 232448;  // an H100 block's shared-memory limit

// Shared memory: [query halves: big units then small units (resident), or
// a big and a small unit per stage][corpus ring: k1Stages units][small
// halves of two corpus units][top-k lists: k1Bq x kl scores, then ids],
// plus the 1,024 bytes that align it.
__host__ __device__ constexpr int k1_q_bytes(bool qres, int units) {
  return 2 * (qres ? units : k1Stages) * k1QBytes;
}

__host__ __device__ constexpr int k1_smem_bytes(bool qres, int units,
                                                int kl) {
  return k1_q_bytes(qres, units) + (k1Stages + 2) * k1XBytes +
         k1Bq * kl * 8 + kAtomBytes;
}

// Split the segments of a corpus unit that this thread copied into big
// (in place) and small (into `small`) tf32 halves.
__device__ __forceinline__ void split_own_segments(unsigned char* x,
                                                   unsigned char* small,
                                                   int tid) {
#pragma unroll
  for (int s0 = 0; s0 < k1Bn * 8; s0 += k1Threads) {
    int r, c;
    seg_coords<k1Bn>(s0 + tid, r, c);
    int off = seg_offset(r, c);
    float4 v = *reinterpret_cast<float4*>(x + off);
    float4 big = make_float4(to_tf32(v.x), to_tf32(v.y), to_tf32(v.z),
                             to_tf32(v.w));
    float4 sm = make_float4(to_tf32(v.x - big.x), to_tf32(v.y - big.y),
                            to_tf32(v.z - big.z), to_tf32(v.w - big.w));
    *reinterpret_cast<float4*>(x + off) = big;
    *reinterpret_cast<float4*>(small + off) = sm;
  }
}

template <int ALIGN, bool QRES>
__global__ void __launch_bounds__(k1Threads)
    k1_partial_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ q,
                      const float* __restrict__ q_big,
                      const float* __restrict__ q_small, int n, int d, int b,
                      int kl, int rows_per_split, int units,
                      float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;  // owns queries warp*16 .. +15 of the block
  const int q0 = blockIdx.x * k1Bq;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int nchunks = r1 > r0 ? (r1 - r0 + k1Bn - 1) / k1Bn : 0;
  const int total = nchunks * units;
  const int ld = d * 4;  // row bytes
  const char* xb = reinterpret_cast<const char*>(x);
  const char* qbb = reinterpret_cast<const char*>(q_big) +
                    static_cast<size_t>(q0) * ld;
  const char* qsb = reinterpret_cast<const char*>(q_small) +
                    static_cast<size_t>(q0) * ld;

  const uint32_t s_base = smem_addr(smem);
  const int x_off = k1_q_bytes(QRES, units);
  const int small_off = x_off + k1Stages * k1XBytes;
  const int list_off = small_off + 2 * k1XBytes;
  float* topd = reinterpret_cast<float*>(smem + list_off);  // [k1Bq][kl]
  int* topi = reinterpret_cast<int*>(topd + k1Bq * kl);     // [k1Bq][kl]
  // query half h (0 big, 1 small) of unit u, or of the stage's unit
  auto q_unit = [&](int h, int u, int st) {
    return s_base + (QRES ? (h * units + u) : (2 * st + h)) * k1QBytes;
  };

  for (int i = tid; i < k1Bq * kl; i += k1Threads) {
    topd[i] = CUDART_INF_F;
    topi[i] = -1;
  }
  if (QRES) {
    for (int u = 0; u < units; ++u) {
      load_tile<ALIGN, k1Bq, k1Threads>(q_unit(0, u, 0), qbb, xb, b - q0, ld,
                                        ld, u * kUnitBytes, tid);
      load_tile<ALIGN, k1Bq, k1Threads>(q_unit(1, u, 0), qsb, xb, b - q0, ld,
                                        ld, u * kUnitBytes, tid);
    }
  }
  auto issue = [&](int v) {
    if (v < total) {
      int ci = v / units, u = v - ci * units, st = v % k1Stages;
      int row0 = r0 + ci * k1Bn;
      load_tile<ALIGN, k1Bn, k1Threads>(
          s_base + x_off + st * k1XBytes, xb + static_cast<size_t>(row0) * ld,
          xb, r1 - row0, ld, ld, u * kUnitBytes, tid);
      if (!QRES) {
        load_tile<ALIGN, k1Bq, k1Threads>(q_unit(0, u, st), qbb, xb, b - q0,
                                          ld, ld, u * kUnitBytes, tid);
        load_tile<ALIGN, k1Bq, k1Threads>(q_unit(1, u, st), qsb, xb, b - q0,
                                          ld, ld, u * kUnitBytes, tid);
      }
    }
    cp_async_commit();
  };
  // unit v's corpus segments that this thread copied -> big (in place)
  // and small (into small buffer v % 2) halves, once they have landed
  auto split_unit = [&](int v) {
    if (v < total)
      split_own_segments(smem + x_off + (v % k1Stages) * k1XBytes,
                         smem + small_off + (v & 1) * k1XBytes, tid);
  };

  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  // this thread's two queries (rows lane/4 and lane/4 + 8 of its warp)
  const int qa = warp * 16 + (lane >> 2);
  float thr[2];
  // `a` of the chunk's 16 columns this thread holds (acc_col(i) for
  // i = 4 g + c), loaded at the chunk's first unit, used at its last
  float av[16];

  for (int v = 0; v < k1Stages - 1; ++v) issue(v);
  cp_async_wait<k1Stages - 2>();  // this thread's copies of unit 0
  split_unit(0);
  fence_async_smem();
  __syncthreads();
  for (int v = 0; v < total; ++v) {
    // unit v is split by every thread; every wgmma of unit v - 1 is done
    const int st = v % k1Stages;
    const int ci = v / units, u = v - ci * units;
    issue(v + k1Stages - 1);  // into the stage of unit v - 1

    if (u == 0) {
      const int row0 = r0 + ci * k1Bn;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const int row = row0 + acc_col(4 * (j >> 1) + (j & 1), lane);
        av[j] = row < r1 ? __ldg(a + row) : CUDART_INF_F;
      }
    }
    const uint32_t xo = s_base + x_off + st * k1XBytes;
    const uint32_t so = s_base + small_off + (v & 1) * k1XBytes;
    const uint32_t qo_big = q_unit(0, u, st), qo_small = q_unit(1, u, st);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k8 (32 bytes) = the unit
      const uint64_t qbig = make_desc(qo_big + 32 * kk);
      const uint64_t qsml = make_desc(qo_small + 32 * kk);
      const uint64_t xbig = make_desc(xo + 32 * kk);
      const uint64_t xsml = make_desc(so + 32 * kk);
      // the small products first, then the big one
      wgmma_tf32_m64n64k8(acc, qsml, xbig, (u > 0 || kk > 0) ? 1 : 0);
      wgmma_tf32_m64n64k8(acc, qbig, xsml, 1);
      wgmma_tf32_m64n64k8(acc, qbig, xbig, 1);
    }
    wgmma_commit();
    // while the tensor cores run unit v: split unit v + 1 (other buffers)
    cp_async_wait<k1Stages - 2>();  // this thread's copies of unit v + 1
    split_unit(v + 1);
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's scores are complete
      const int row0 = r0 + ci * k1Bn;
      thr[0] = topd[qa * kl + kl - 1];
      thr[1] = topd[(qa + 8) * kl + kl - 1];
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int h = (i >> 1) & 1;
        const int row = row0 + acc_col(i, lane);
        // av is inf past r1; inf - 2 acc stays inf and never passes
        float s = av[2 * (i >> 2) + (i & 1)] - 2.f * acc[i];
        unsigned m = __ballot_sync(kFull, s < thr[h]);
        if (m) {
          do {
            int src = __ffs(m) - 1;
            m &= m - 1;
            float cs = __shfl_sync(kFull, s, src);
            int cid = __shfl_sync(kFull, row, src);
            int cq = warp * 16 + (src >> 2) + 8 * h;
            if (cs < topd[cq * kl + kl - 1])
              warp_insert(topd + cq * kl, topi + cq * kl, kl, cs, cid, lane);
          } while (m);
          thr[0] = topd[qa * kl + kl - 1];
          thr[1] = topd[(qa + 8) * kl + kl - 1];
        }
      }
    }
    fence_async_smem();
    __syncthreads();
  }
  cp_async_wait<0>();

  __syncthreads();
  for (int e = tid; e < k1Bq * kl; e += k1Threads) {
    const int m = e / kl, j = e % kl;
    const int qi = q0 + m;
    if (qi < b) {
      const size_t o = (static_cast<size_t>(qi) * gridDim.y + split) * kl + j;
      part_d[o] = topd[e];
      part_i[o] = topi[e];
    }
  }
}

// The exact FP32 rescoring: one warp per query takes its kl selected
// candidates, recomputes each score with the sequential FP32 FMAs of a
// scalar sweep, and keeps the best k.
__global__ void __launch_bounds__(kSelWarps * 32)
    k1_rescore_kernel(const float* __restrict__ x, const float* __restrict__ a,
                      const float* __restrict__ q, int d, int b, int kl,
                      const int* __restrict__ sel_i, int k,
                      float* __restrict__ out_d, int* __restrict__ out_i) {
  extern __shared__ float rs_smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* ld = rs_smem + warp * k;
  int* li = reinterpret_cast<int*>(rs_smem + kSelWarps * k) + warp * k;
  const int qi = blockIdx.x * kSelWarps + warp;
  if (qi >= b) return;  // whole warp leaves; no block-wide barrier below
  for (int j = lane; j < k; j += 32) {
    ld[j] = CUDART_INF_F;
    li[j] = -1;
  }
  __syncwarp();
  const float* qr = q + static_cast<size_t>(qi) * d;
  for (int c0 = 0; c0 < kl; c0 += 32) {
    const int j = c0 + lane;
    float s = CUDART_INF_F;
    int id = -1;
    if (j < kl) {
      id = sel_i[static_cast<size_t>(qi) * kl + j];
      if (id >= 0) {
        const float* xr = x + static_cast<size_t>(id) * d;
        float dot = 0.f;
#pragma unroll 8
        for (int f = 0; f < d; ++f) dot = fmaf(__ldg(qr + f), __ldg(xr + f), dot);
        s = __ldg(a + id) - 2.f * dot;
      }
    }
    warp_offer(ld, li, k, s, id, id >= 0, lane);
  }
  for (int j = lane; j < k; j += 32) {
    out_d[static_cast<size_t>(qi) * k + j] = ld[j];
    out_i[static_cast<size_t>(qi) * k + j] = li[j];
  }
}

template <int ALIGN, bool QRES>
cudaError_t launch_k1(dim3 grid, cudaStream_t st, const float* x,
                      const float* a, const float* q, const float* qb,
                      const float* qs, int n, int d, int b, int kl,
                      int rows_per_split, int units, float* part_d,
                      int* part_i) {
  int smem = k1_smem_bytes(QRES, units, kl);
  cudaError_t err = cudaFuncSetAttribute(
      k1_partial_kernel<ALIGN, QRES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k1_partial_kernel<ALIGN, QRES><<<grid, k1Threads, smem, st>>>(
      x, a, q, qb, qs, n, d, b, kl, rows_per_split, units, part_d, part_i);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1. base [n, d] f32, a [n] f32, q [b, d] f32 and its tf32 halves q_big,
// q_small -> out [b, k] (score, row), ascending; part_* are
// [b, splits, kl] and sel_* [b, kl] scratch, kl = min(64, k + 4).
// 1 <= k <= 64. The grid is
// (ceil(b / 64), splits), split s covering rows [s * rows_per_split,
// +rows_per_split).
int pgv_k1_surrogate_topk(const float* base, const float* a, const float* q,
                          const float* q_big, const float* q_small, int n,
                          int d, int b, int k, int kl, int splits,
                          int rows_per_split, float* part_d, int* part_i,
                          float* sel_d, int* sel_i, float* out_d, int* out_i,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kl != min(kMaxK, k + k1Spare)) return static_cast<int>(cudaErrorInvalidValue);
  const int units = (4 * d + kUnitBytes - 1) / kUnitBytes;
  dim3 grid((b + k1Bq - 1) / k1Bq, splits);
  const bool qres = k1_smem_bytes(true, units, kl) <= k1MaxSmem;
  const bool vec = d % 4 == 0;
  cudaError_t err;
  if (qres && vec)
    err = launch_k1<16, true>(grid, st, base, a, q, q_big, q_small, n, d, b,
                              kl, rows_per_split, units, part_d, part_i);
  else if (qres)
    err = launch_k1<4, true>(grid, st, base, a, q, q_big, q_small, n, d, b,
                             kl, rows_per_split, units, part_d, part_i);
  else if (vec)
    err = launch_k1<16, false>(grid, st, base, a, q, q_big, q_small, n, d, b,
                               kl, rows_per_split, units, part_d, part_i);
  else
    err = launch_k1<4, false>(grid, st, base, a, q, q_big, q_small, n, d, b,
                              kl, rows_per_split, units, part_d, part_i);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_select<false>(part_d, part_i, nullptr, b, splits * kl, kl,
                             sel_d, sel_i, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  k1_rescore_kernel<<<(b + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                      kSelWarps * k * 8, st>>>(base, a, q, d, b, kl, sel_i, k,
                                               out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
