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
// Compact rows (f16 or bf16: a halfvec store, a 2-byte serve store) are
// read as stored, with no f32 copy of them in device memory. A tf32 holds
// every f16 and bf16 value exactly, so their small half is 0 and two
// products (q_small . x, then q_big . x) give the same sums as the f32
// route's three: at 1,024 queries x 262,144 rows x 1,024-d the bound is
// 2 * 2*B*N*D / 495 TFLOP/s = 2.22 ms against 0.16 ms for the rows. At
// that width the queries' halves (512 KB a 64-query tile) cannot stay in
// shared memory and stream beside the corpus. Streaming is not what held
// the f32 form there (PERF.md: per operation its streamed form is faster
// than its resident one); latency is: a full wait on the tensor
// cores and a block barrier after every 32-feature unit of 0.8 MFLOP. So
// the 2-byte mode (k1c_partial_kernel) makes the unit five times larger:
// - One block owns 128 queries (two consumer warpgroups of 64) and a range
//   of rows in 256-row chunks: each warpgroup runs m64 n256 k8 products,
//   so a unit is 4.2 MFLOP and a query unit in shared memory serves 256
//   rows (the f32 form: 64).
// - A unit's 2-byte rows (16 KB) and both query halves (2 x 16 KB) arrive
//   by cp.async in a 3-stage ring; each thread widens the row segments it
//   copied itself to f32 in wgmma's swizzled layout (two 32 KB buffers),
//   so no barrier sits between copy and widening. Unit v + 2's copies are
//   issued before unit v's products (a warp issuing wgmma waits for the
//   tensor cores to take them); unit v + 1 is widened while they run;
//   then one wait and one block barrier end the unit.
// - The epilogue is the f32 form's threshold filter over 128 cells a
//   thread, the chunk's `a` staged in shared memory.
// The products alone take 2.4 ms at that shape; the copies, widening and
// epilogue, which do not overlap them fully, take the rest (PERF.md).
// The rescoring reads the 2-byte rows too: the same FP32 FMAs over the
// same values as the f32 route's.
//
// Rows excluded by the caller carry a >= 3e38 in `a`; they are ranked like
// any row, and the Python wrappers turn scores >= 1.5e38 into -1 / inf.

#include <cuda_bf16.h>
#include <cuda_fp16.h>

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
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__half v) { return __half2float(v); }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__global__ void __launch_bounds__(kSelWarps * 32)
    k1_rescore_kernel(const T* __restrict__ x, const float* __restrict__ a,
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
        const T* xr = x + static_cast<size_t>(id) * d;
        float dot = 0.f;
#pragma unroll 8
        for (int f = 0; f < d; ++f)
          dot = fmaf(__ldg(qr + f), to_f32(__ldg(xr + f)), dot);
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

// ---------------------------------------------------------------------------
// The compact-row mode (f16 / bf16 rows read as stored)
// ---------------------------------------------------------------------------

constexpr int kcBq = 128;  // queries per block: two consumer warpgroups
constexpr int kcBn = 256;  // corpus rows per chunk: m64 n256
constexpr int kcThreads = 256;
constexpr int kcRowBytes = 64;                    // a row's unit as stored
constexpr int kcRawBytes = kcBn * kcRowBytes;     // 16 KB
constexpr int kcXBytes = kcBn * kUnitBytes;       // widened to f32: 32 KB
constexpr int kcQBytes = kcBq * kUnitBytes;       // one query half: 16 KB
constexpr int kcABytes = kcBn * 4;                // the chunk's `a`

// Shared memory: [query ring: `stages` x (big, small) units][two f32 corpus
// units][2-byte corpus ring: stages - 1 units][`a` ring: stages x kcBn
// floats][top-k lists: kcBq x kl scores, then ids], plus the 1,024 bytes
// that align it. The corpus ring needs one slot fewer than the query ring:
// a unit's 2-byte rows are widened one iteration before its products run.
// Three stages hold kl up to 31 (k <= 27); past that, two.
__host__ __device__ constexpr int kc_smem_bytes(int stages, int kl) {
  return stages * (2 * kcQBytes + kcABytes) + (stages - 1) * kcRawBytes +
         2 * kcXBytes + kcBq * kl * 8 + kAtomBytes;
}

// Copy rows [0, kcBn) x bytes [c0, c0 + 64) of the 2-byte rows at src (row r
// at src + r * ld; `rows` rows and `width` bytes per row valid, the rest
// zero) to dst, 64 bytes a row, unswizzled: 16-byte segment s is row s / 4,
// column s % 4, so each warp reads 64 contiguous bytes of 8 rows. ALIGN as
// in load_tile.
template <int ALIGN>
__device__ __forceinline__ void load_rows2(uint32_t dst, const char* src,
                                           const char* safe, int rows,
                                           int ld, int width, int c0,
                                           int tid) {
#pragma unroll
  for (int s0 = 0; s0 < kcBn * 4; s0 += kcThreads) {
    const int s = s0 + tid, r = s >> 2;
    const uint32_t to = dst + s * kSegBytes;
    const int col = c0 + (s & 3) * kSegBytes;
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
        const unsigned lo = live && col + 4 * p < width
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

// The segments of a 2-byte unit that this thread copied (load_rows2's
// mapping) -> f32 in wgmma's swizzled layout at xf: 2-byte segment c of row
// r (8 features) becomes f32 segments 2c and 2c + 1.
template <typename T>
__device__ __forceinline__ void widen_own(const unsigned char* raw,
                                          unsigned char* xf, int tid) {
#pragma unroll
  for (int s0 = 0; s0 < kcBn * 4; s0 += kcThreads) {
    const int s = s0 + tid, r = s >> 2, c = s & 3;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + s * kSegBytes);
    const float2 f0 = widen2(w.x, T()), f1 = widen2(w.y, T());
    const float2 f2 = widen2(w.z, T()), f3 = widen2(w.w, T());
    *reinterpret_cast<float4*>(xf + seg_offset(r, 2 * c)) =
        make_float4(f0.x, f0.y, f1.x, f1.y);
    *reinterpret_cast<float4*>(xf + seg_offset(r, 2 * c + 1)) =
        make_float4(f2.x, f2.y, f3.x, f3.y);
  }
}

template <typename T, int ALIGN>
__global__ void __launch_bounds__(kcThreads, 1)
    k1c_partial_kernel(const T* __restrict__ x, const float* __restrict__ a,
                       const float* __restrict__ q_big,
                       const float* __restrict__ q_small, int n, int d,
                       int b, int kl, int rows_per_split, int units,
                       int stages, float* __restrict__ part_d,
                       int* __restrict__ part_i) {
  constexpr int QALIGN = ALIGN == 16 ? 16 : 4;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int wg = tid >> 7;    // warpgroup: the block's queries wg*64 .. +63
  const int warp = tid >> 5;  // owns the block's queries warp*16 .. +15
  const int q0 = blockIdx.x * kcBq;
  const int split = blockIdx.y;
  const int r0 = split * rows_per_split;
  const int r1 = min(n, r0 + rows_per_split);
  const int nchunks = r1 > r0 ? (r1 - r0 + kcBn - 1) / kcBn : 0;
  const int total = nchunks * units;
  const int ldx = d * 2, ldq = d * 4;  // row bytes
  const char* xb = reinterpret_cast<const char*>(x);
  const char* qbb = reinterpret_cast<const char*>(q_big) +
                    static_cast<size_t>(q0) * ldq;
  const char* qsb = reinterpret_cast<const char*>(q_small) +
                    static_cast<size_t>(q0) * ldq;

  const uint32_t s_base = smem_addr(smem);
  const int xf_off = stages * 2 * kcQBytes;
  const int raw_off = xf_off + 2 * kcXBytes;
  const int a_off = raw_off + (stages - 1) * kcRawBytes;
  const int list_off = a_off + stages * kcABytes;
  float* topd = reinterpret_cast<float*>(smem + list_off);  // [kcBq][kl]
  int* topi = reinterpret_cast<int*>(topd + kcBq * kl);     // [kcBq][kl]

  for (int i = tid; i < kcBq * kl; i += kcThreads) {
    topd[i] = CUDART_INF_F;
    topi[i] = -1;
  }
  // unit v of the sweep: chunk v / units, 32-feature unit v % units; the
  // chunk's `a` comes with its last unit
  auto issue = [&](int v) {
    if (v < total) {
      const int ci = v / units, u = v - ci * units, st = v % stages;
      const int row0 = r0 + ci * kcBn;
      load_rows2<ALIGN>(s_base + raw_off + (v % (stages - 1)) * kcRawBytes,
                        xb + static_cast<size_t>(row0) * ldx, xb, r1 - row0,
                        ldx, ldx, u * kcRowBytes, tid);
      load_tile<QALIGN, kcBq, kcThreads>(s_base + 2 * st * kcQBytes, qbb, xb,
                                         b - q0, ldq, ldq, u * kUnitBytes,
                                         tid);
      load_tile<QALIGN, kcBq, kcThreads>(s_base + (2 * st + 1) * kcQBytes,
                                         qsb, xb, b - q0, ldq, ldq,
                                         u * kUnitBytes, tid);
      if (u == units - 1) {
        const bool ok = row0 + tid < r1;
        cp_async4(s_base + a_off + st * kcABytes + tid * 4,
                  ok ? a + row0 + tid : a, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };
  // this thread's copies of unit v (issued stages - 2 groups before the
  // newest) have landed
  auto wait_unit = [&]() {
    if (stages == 3)
      cp_async_wait<1>();
    else
      cp_async_wait<0>();
  };
  auto widen = [&](int v) {
    if (v < total)
      widen_own<T>(smem + raw_off + (v % (stages - 1)) * kcRawBytes,
                   smem + xf_off + (v & 1) * kcXBytes, tid);
  };

  float acc[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) acc[i] = 0.f;
  // this thread's two queries (rows lane/4 and lane/4 + 8 of its warp)
  const int qa = warp * 16 + (lane >> 2);

  for (int v = 0; v < stages - 1; ++v) issue(v);
  wait_unit();  // unit 0
  widen(0);
  fence_async_smem();
  __syncthreads();
  for (int v = 0; v < total; ++v) {
    // unit v is widened and its query halves landed, for every thread;
    // every wgmma of unit v - 1 is done
    const int st = v % stages;
    const int ci = v / units, u = v - ci * units;
    const uint32_t xo = s_base + xf_off + (v & 1) * kcXBytes;
    const uint32_t qbo = s_base + 2 * st * kcQBytes + wg * 64 * kUnitBytes;
    const uint32_t qso = qbo + kcQBytes;
    issue(v + stages - 1);  // into unit v - 1's stage
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k8 (32 bytes) = the unit
      const uint64_t xd = make_desc(xo + 32 * kk);
      // the small product first, then the big one (the f32 form's order;
      // the corpus's small half is 0)
      wgmma_tf32_m64n256k8(acc, make_desc(qso + 32 * kk), xd,
                           (u > 0 || kk > 0) ? 1 : 0);
      wgmma_tf32_m64n256k8(acc, make_desc(qbo + 32 * kk), xd, 1);
    }
    wgmma_commit();
    // while the tensor cores run unit v (other buffers):
    wait_unit();            // this thread's copies of unit v + 1
    widen(v + 1);           // into unit v - 1's f32 buffer
    fence_async_smem();
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's scores are complete
      const int row0 = r0 + ci * kcBn;
      const float* as =
          reinterpret_cast<const float*>(smem + a_off + st * kcABytes);
      float thr[2] = {topd[qa * kl + kl - 1], topd[(qa + 8) * kl + kl - 1]};
      // 16 groups of 8 cells in a loop that is not unrolled: a group reads
      // acc[0 .. 7], then the accumulator shifts down by 8 (it restarts at
      // the next chunk), so the insertion code is inlined 8 times, not
      // 128 (unrolled over the 128 cells, the epilogue took 2.2 of 6.2 ms;
      // rolled, 1.4: PERF.md). A group none of whose cells passes
      // in the warp (after the first chunks, nearly all) costs one vote.
#pragma unroll 1
      for (int g = 0; g < 16; ++g) {
        float sv[8];
        bool any = false;
#pragma unroll
        for (int j = 0; j < 8; ++j) {  // cell 8 g + j
          const int col = 16 * g + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
          // rows past r1 never pass
          sv[j] = (row0 + col < r1 ? as[col] : CUDART_INF_F) - 2.f * acc[j];
          any |= sv[j] < thr[(j >> 1) & 1];
        }
        if (__any_sync(kFull, any)) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const int h = (j >> 1) & 1;
            const int row =
                row0 + 16 * g + 8 * (j >> 2) + 2 * (lane & 3) + (j & 1);
            unsigned m = __ballot_sync(kFull, sv[j] < thr[h]);
            if (m) {
              do {
                const int src = __ffs(m) - 1;
                m &= m - 1;
                const float cs = __shfl_sync(kFull, sv[j], src);
                const int cid = __shfl_sync(kFull, row, src);
                const int cq = warp * 16 + (src >> 2) + 8 * h;
                if (cs < topd[cq * kl + kl - 1])
                  warp_insert(topd + cq * kl, topi + cq * kl, kl, cs, cid,
                              lane);
              } while (m);
              thr[0] = topd[qa * kl + kl - 1];
              thr[1] = topd[(qa + 8) * kl + kl - 1];
            }
          }
        }
#pragma unroll
        for (int i = 0; i < 120; ++i) acc[i] = acc[i + 8];
      }
    }
    __syncthreads();  // unit v + 1 is ready; unit v's buffers are free
  }
  cp_async_wait<0>();

  __syncthreads();
  for (int e = tid; e < kcBq * kl; e += kcThreads) {
    const int m = e / kl, j = e % kl;
    const int qi = q0 + m;
    if (qi < b) {
      const size_t o = (static_cast<size_t>(qi) * gridDim.y + split) * kl + j;
      part_d[o] = topd[e];
      part_i[o] = topi[e];
    }
  }
}

template <typename T, int ALIGN>
cudaError_t launch_k1c(dim3 grid, cudaStream_t st, const T* x, const float* a,
                       const float* qb, const float* qs, int n, int d, int b,
                       int kl, int rows_per_split, int units, int stages,
                       float* part_d, int* part_i) {
  const int smem = kc_smem_bytes(stages, kl);
  cudaError_t err = cudaFuncSetAttribute(
      k1c_partial_kernel<T, ALIGN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  k1c_partial_kernel<T, ALIGN><<<grid, kcThreads, smem, st>>>(
      x, a, qb, qs, n, d, b, kl, rows_per_split, units, stages, part_d,
      part_i);
  return cudaGetLastError();
}

// The partial sweep over 2-byte rows: 16-byte copies where every row start
// allows them, 4-byte ones where d is even, else 2-byte loads.
template <typename T>
cudaError_t launch_k1c_aligned(dim3 grid, cudaStream_t st, const T* x,
                               const float* a, const float* qb,
                               const float* qs, int n, int d, int b, int kl,
                               int rows_per_split, int units, int stages,
                               float* part_d, int* part_i) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(x);
  if (d % 8 == 0 && p % 16 == 0)
    return launch_k1c<T, 16>(grid, st, x, a, qb, qs, n, d, b, kl,
                             rows_per_split, units, stages, part_d, part_i);
  if (d % 2 == 0 && p % 4 == 0)
    return launch_k1c<T, 4>(grid, st, x, a, qb, qs, n, d, b, kl,
                            rows_per_split, units, stages, part_d, part_i);
  return launch_k1c<T, 2>(grid, st, x, a, qb, qs, n, d, b, kl,
                          rows_per_split, units, stages, part_d, part_i);
}

}  // namespace

extern "C" {

// K1. base [n, d] f32 (dtype 0), f16 (1) or bf16 (2), a [n] f32, q [b, d]
// f32 and its tf32 halves q_big, q_small -> out [b, k] (score, row),
// ascending; part_* are [b, splits, kl] and sel_* [b, kl] scratch,
// kl = min(64, k + 4). 1 <= k <= 64. The grid is (ceil(b / 64), splits)
// for f32 rows, (ceil(b / 128), splits) for 2-byte rows, split s covering
// rows [s * rows_per_split, +rows_per_split) (a multiple of 64, or of 256
// for 2-byte rows).
int pgv_k1_surrogate_topk(const void* base, int dtype, const float* a,
                          const float* q, const float* q_big,
                          const float* q_small, int n, int d, int b, int k,
                          int kl, int splits, int rows_per_split,
                          float* part_d, int* part_i, float* sel_d,
                          int* sel_i, float* out_d, int* out_i,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kl != min(kMaxK, k + k1Spare) || dtype < 0 || dtype > 2)
    return static_cast<int>(cudaErrorInvalidValue);
  const int units = (4 * d + kUnitBytes - 1) / kUnitBytes;
  cudaError_t err;
  if (dtype == 0) {
    const float* x = static_cast<const float*>(base);
    dim3 grid((b + k1Bq - 1) / k1Bq, splits);
    const bool qres = k1_smem_bytes(true, units, kl) <= k1MaxSmem;
    const bool vec = d % 4 == 0;
    if (qres && vec)
      err = launch_k1<16, true>(grid, st, x, a, q, q_big, q_small, n, d, b,
                                kl, rows_per_split, units, part_d, part_i);
    else if (qres)
      err = launch_k1<4, true>(grid, st, x, a, q, q_big, q_small, n, d, b,
                               kl, rows_per_split, units, part_d, part_i);
    else if (vec)
      err = launch_k1<16, false>(grid, st, x, a, q, q_big, q_small, n, d, b,
                                 kl, rows_per_split, units, part_d, part_i);
    else
      err = launch_k1<4, false>(grid, st, x, a, q, q_big, q_small, n, d, b,
                                kl, rows_per_split, units, part_d, part_i);
  } else {
    if (rows_per_split % kcBn != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    dim3 grid((b + kcBq - 1) / kcBq, splits);
    const int stages = kc_smem_bytes(3, kl) <= k1MaxSmem ? 3 : 2;
    if (dtype == 1)
      err = launch_k1c_aligned(grid, st, static_cast<const __half*>(base), a,
                               q_big, q_small, n, d, b, kl, rows_per_split,
                               units, stages, part_d, part_i);
    else
      err = launch_k1c_aligned(grid, st,
                               static_cast<const __nv_bfloat16*>(base), a,
                               q_big, q_small, n, d, b, kl, rows_per_split,
                               units, stages, part_d, part_i);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  err = launch_select<false>(part_d, part_i, nullptr, b, splits * kl, kl,
                             sel_d, sel_i, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 rs_grid((b + kSelWarps - 1) / kSelWarps);
  const int rs_smem = kSelWarps * k * 8;
  if (dtype == 0)
    k1_rescore_kernel<<<rs_grid, kSelWarps * 32, rs_smem, st>>>(
        static_cast<const float*>(base), a, q, d, b, kl, sel_i, k, out_d,
        out_i);
  else if (dtype == 1)
    k1_rescore_kernel<<<rs_grid, kSelWarps * 32, rs_smem, st>>>(
        static_cast<const __half*>(base), a, q, d, b, kl, sel_i, k, out_d,
        out_i);
  else
    k1_rescore_kernel<<<rs_grid, kSelWarps * 32, rs_smem, st>>>(
        static_cast<const __nv_bfloat16*>(base), a, q, d, b, kl, sel_i, k,
        out_d, out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
