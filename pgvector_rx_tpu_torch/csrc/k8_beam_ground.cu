// K8 -- the device build's beam-descent ground, one thread block per row
// being inserted.
//
// No Pallas ancestor: it replaces the XLA program of the JAX package's
// `DeviceBuilder._beam_ground_candidates`
// (pgvector_rx_tpu/graph/device_build.py:1052-1274, a fori_loop of sorts
// or rank merges, vmapped over the batch), which the port ran as ~30
// torch launches a step over [B, W + E * L] tensors
// (graph/device_build._beam_ground_plain, its plain version). The whole
// walk of a batch is one launch.
//
// What it computes, per row b of the batch (graph/device_build.py's
// `_beam_ground_plain`, step for step):
// - A beam of W = ef_construction entries: packed keys id * 2 + (1 -
//   expanded) (-2 empty) and f32 distances, seeded by the caller (torch
//   ops: the upper seeds, the entry; sorted for the rank merge).
// - `steps` fixed trips, with no early exit (the reference has none).
//   Each marks the E best unexpanded entries expanded (lower slot first on
//   ties), gathers the L = 2m layer-0 neighbours of each (E * L new
//   entries in (entry, column) order, the missing ones empty), keeps the
//   live ones (`alive`) and scores their bf16 rows against the f32 query
//   in f32: l2 sum (x - q)^2, ip -sum x q, cosine 1 - clamp(sum x q),
//   l1 sum |x - q|, jacbits 2h / (sum q + sum x + h) with h the l2 sum
//   (1 where the denominator is 0).
// - Then one of three merges, each the first W of a total order over the
//   W + E * L entries (beam first, then the new ones):
//   0 sort with dedup: an empty key, and every copy of an id after the
//     first in (key, position) order (so the expanded copy wins), go to
//     +inf; order (distance, key, position) -- two stable sorts, by key
//     then by distance;
//   1 sort without dedup: order (distance, position) -- one stable sort;
//     an id may sit in the beam twice, and after the last step the beam
//     takes merge 0's dedup and order once;
//   2 rank: a new entry whose id a beam entry or an earlier new entry
//     holds (key >= 0) goes to +inf; order (distance, position): beam
//     entries precede new ones at equal distance and the beam stays
//     sorted, as `_rank_merge`'s scatter of ranks rebuilds it.
// - Output: the W distances and ids, -1 where the distance is infinite or
//   the key empty.
//
// Bound on an H100 SXM: the bytes it gathers. Every step reads, for each
// of the E expanded entries, its L neighbour ids (4 bytes), their live
// flags (1 byte) and the bf16 rows of the live ones (d * 2 bytes), scored
// with a multiply-add per value (f32): at 1,024 rows x 16 steps x 4 x 32
// neighbours x 768-d, 3.2 GB and 0.97 ms against 0.05 ms of FMA work.
//
// Design (sm_90a, plain CUDA, no tensor cores), K4's walk simplified:
// - 128 threads per block; the beam and the merge's W + E * L entries
//   live in shared memory (~2 KB at W = 64, E * L = 128), so the whole
//   batch is resident at once. The f32 query is read from global memory
//   (one row a block, kept in L1), so its width bounds nothing.
// - Scoring: each warp scores 4 rows at once (their loads in flight
//   together), 16-byte loads of 8 bf16 values where the rows allow it,
//   scalar loads otherwise; a shuffle reduction per row.
// - Selection, dedup and merge by ranks from pairwise comparisons in
//   shared memory ((W + E L)^2 per step, ~37k at the defaults): every
//   entry counts the entries before it in the merge's order and writes
//   itself to that place when it is below W; no sort. The orders are
//   strict (position breaks every tie), so the places are a permutation.
// Measured: see PERF.md (K8 row), timed by chip_smoke.py phases 18 and 27.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int k8Threads = 128;
constexpr int k8Warps = k8Threads / 32;
constexpr int k8RowsPerWarp = 4;  // rows a warp scores with loads in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int k8MaxSmem = 232448;  // a block's dynamic shared memory limit

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// Shared memory in 4-byte words: the beam (distances [W], keys [W]), the
// merge's entries (distances [W + N], keys [W + N]), the selected beam
// places [max(E, 1)] and the query's sum (jacbits); the wrapper
// (graph/device_build._k8_smem_bytes) computes the same and refuses what
// exceeds a block's.
__host__ __device__ inline size_t k8_smem_bytes(int w, int e, int n) {
  return 4 * (2 * static_cast<size_t>(w) + 2 * (w + n) + (e > 0 ? e : 1)
              + 1);
}

// V consecutive bf16 values of a row, and V consecutive f32 values of the
// query, starting at element c * V, as f32.
template <int V>
struct Load;
template <>
struct Load<1> {
  __device__ static void run(const __nv_bfloat16* row, int c, float* out) {
    out[0] = __bfloat162float(row[c]);
  }
  __device__ static void query(const float* q, int c, float* out) {
    out[0] = __ldg(q + c);
  }
};
template <>
struct Load<8> {
  __device__ static void query(const float* q, int c, float* out) {
    const float4* p = reinterpret_cast<const float4*>(q) + 2 * c;
    const float4 a = __ldg(p), b = __ldg(p + 1);
    out[0] = a.x; out[1] = a.y; out[2] = a.z; out[3] = a.w;
    out[4] = b.x; out[5] = b.y; out[6] = b.z; out[7] = b.w;
  }
  __device__ static void run(const __nv_bfloat16* row, int c, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + c);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};

// Metric codes as graph/device_build.py passes them: 0 l2 (squared), 1 ip
// (-dot), 2 cosine (1 - clamp(dot)), 3 l1, 4 jacbits ({0,1} rows).
template <int M>
__device__ __forceinline__ float term(float x, float q) {
  if (M == 0 || M == 4) {
    const float t = x - q;
    return t * t;
  }
  if (M == 3) return fabsf(x - q);
  return x * q;
}

template <int M>
__device__ __forceinline__ float finish(float acc, float xsum, float qsum) {
  if (M == 1) return -acc;
  if (M == 2) return 1.0f - fminf(fmaxf(acc, -1.0f), 1.0f);
  if (M == 4) {
    const float denom = qsum + xsum + acc;
    return denom > 0.0f ? 2.0f * acc / denom : 1.0f;
  }
  return acc;
}

// out[j] = distance from the query qg (global memory) to the row of key keys[j] (its id
// keys[j] >> 1, at most cap) for the j < count with keys[j] >= 0, +inf for
// the others. Each warp takes k8RowsPerWarp rows at a time; the lanes
// stride over the row's V-wide chunks.
template <int V, int M>
__device__ void score_rows(const __nv_bfloat16* rows, long long stride,
                           int d, int cap, const float* qg, float qsum,
                           const int* keys, float* out, int count, int warp,
                           int lane) {
  const int nchunks = d / V;
  for (int base = warp * k8RowsPerWarp; base < count;
       base += k8Warps * k8RowsPerWarp) {
    float acc[k8RowsPerWarp], xs[k8RowsPerWarp];
    const __nv_bfloat16* rp[k8RowsPerWarp];
    bool use[k8RowsPerWarp];
#pragma unroll
    for (int r = 0; r < k8RowsPerWarp; ++r) {
      const int j = base + r;
      use[r] = j < count && keys[j] >= 0;
      rp[r] = rows + (use[r] ? static_cast<long long>(min(keys[j] >> 1, cap))
                                   * stride
                             : 0LL);
      acc[r] = 0.f;
      xs[r] = 0.f;
    }
    for (int c = lane; c < nchunks; c += 32) {
      float qv[V];
      Load<V>::query(qg, c, qv);
#pragma unroll
      for (int r = 0; r < k8RowsPerWarp; ++r) {
        if (!use[r]) continue;  // warp-uniform
        float x[V];
        Load<V>::run(rp[r], c, x);
#pragma unroll
        for (int e = 0; e < V; ++e) {
          acc[r] += term<M>(x[e], qv[e]);
          if (M == 4) xs[r] += x[e];
        }
      }
    }
#pragma unroll
    for (int r = 0; r < k8RowsPerWarp; ++r) {
      float s = acc[r], sx = xs[r];
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        s += __shfl_xor_sync(kFull, s, o);
        if (M == 4) sx += __shfl_xor_sync(kFull, sx, o);
      }
      if (lane == 0 && base + r < count)
        out[base + r] = use[r] ? finish<M>(s, sx, qsum) : inf_f();
    }
  }
}

// Entries [0, m) of (cd, ck): an empty key, and a key whose id an entry
// earlier in (key, position) order holds, go to +inf (merge 0's dedup).
__device__ __forceinline__ void dedup_by_key(float* cd, const int* ck, int m,
                                             int tid) {
  for (int i = tid; i < m; i += k8Threads) {
    const int ki = ck[i];
    bool dead = ki < 0;
    for (int j = 0; j < m && !dead; ++j) {
      const int kj = ck[j];
      dead = (kj >> 1) == (ki >> 1) && (kj < ki || (kj == ki && j < i));
    }
    if (dead) cd[i] = inf_f();
  }
}

// The first w of entries [0, m) of (cd, ck) in (distance, key, position)
// order (BY_KEY) or (distance, position) order -> (bd, bk).
template <bool BY_KEY>
__device__ __forceinline__ void rank_into(const float* cd, const int* ck,
                                          int m, float* bd, int* bk, int w,
                                          int tid) {
  for (int i = tid; i < m; i += k8Threads) {
    const float di = cd[i];
    const int ki = ck[i];
    int r = 0;
    for (int j = 0; j < m && r < w; ++j) {
      const float dj = cd[j];
      const bool tie_first =
          BY_KEY ? (ck[j] < ki || (ck[j] == ki && j < i)) : j < i;
      r += dj < di || (dj == di && tie_first);
    }
    if (r < w) {
      bd[r] = di;
      bk[r] = ki;
    }
  }
}

template <int V, int M>
__global__ void __launch_bounds__(k8Threads)
    k8_beam_ground_kernel(const __nv_bfloat16* __restrict__ rows,
                          long long stride, int d,
                          const int* __restrict__ nbrs, int lm0,
                          const unsigned char* __restrict__ alive, int cap,
                          const float* __restrict__ q,
                          const float* __restrict__ init_d,
                          const int* __restrict__ init_key, int W, int E,
                          int steps, int merge, float* __restrict__ out_d,
                          long long* __restrict__ out_ids) {
  extern __shared__ float k8_smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row_b = blockIdx.x;
  const int N = E * lm0, m = W + N;
  const float* qg = q + static_cast<size_t>(row_b) * d;
  float* bd = k8_smem;
  int* bk = reinterpret_cast<int*>(bd + W);
  float* cd = reinterpret_cast<float*>(bk + W);
  int* ck = reinterpret_cast<int*>(cd + m);
  int* sel = ck + m;
  float* qsum = reinterpret_cast<float*>(sel + (E > 0 ? E : 1));

  for (int w = tid; w < W; w += k8Threads) {
    bd[w] = init_d[static_cast<size_t>(row_b) * W + w];
    bk[w] = init_key[static_cast<size_t>(row_b) * W + w];
  }
  __syncthreads();
  if (M == 4 && warp == 0) {  // {0,1} values: the sum is exact in any order
    float s = 0.f;
    for (int i = lane; i < d; i += 32) s += __ldg(qg + i);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) *qsum = s;
  }

  for (int step = 0; step < steps; ++step) {
    // the E best unexpanded entries, lower places first on ties
    for (int r = tid; r < E; r += k8Threads) sel[r] = -1;
    __syncthreads();
    for (int w = tid; w < W; w += k8Threads) {
      const int kw = bk[w];
      const float dw = bd[w];
      if (kw >= 0 && (kw & 1) && dw < inf_f()) {
        int r = 0;
        for (int v = 0; v < W && r < E; ++v) {
          const int kv = bk[v];
          const float dv = bd[v];
          r += kv >= 0 && (kv & 1) && (dv < dw || (dv == dw && v < w));
        }
        if (r < E) sel[r] = w;
      }
    }
    __syncthreads();
    // their layer-0 neighbours, in (entry, column) order: live ones keep
    // their key, the others are empty
    for (int n = tid; n < N; n += k8Threads) {
      const int w = sel[n / lm0];
      const int u = w >= 0 ? bk[w] >> 1 : -1;
      const int nb =
          u >= 0 ? nbrs[static_cast<long long>(min(u, cap)) * lm0 + n % lm0]
                 : -1;
      const bool ok = nb >= 0 && alive[min(nb, cap)];
      ck[W + n] = ok ? nb * 2 + 1 : -2;
    }
    __syncthreads();
    for (int r = tid; r < E; r += k8Threads)
      if (sel[r] >= 0) bk[sel[r]] &= ~1;  // marked expanded
    __syncthreads();
    for (int w = tid; w < W; w += k8Threads) {
      cd[w] = bd[w];
      ck[w] = bk[w];
    }
    score_rows<V, M>(rows, stride, d, cap, qg, M == 4 ? *qsum : 0.f, ck + W,
                     cd + W, N, warp, lane);
    __syncthreads();
    if (merge == 0) {
      dedup_by_key(cd, ck, m, tid);
    } else if (merge == 2) {
      // a new entry whose id is held by a beam entry or an earlier new one
      for (int i = W + tid; i < m; i += k8Threads) {
        const int ki = ck[i];
        if (ki < 0) continue;
        for (int j = 0; j < i; ++j) {
          const int kj = ck[j];
          if (kj >= 0 && (kj >> 1) == (ki >> 1)) {
            cd[i] = inf_f();
            break;
          }
        }
      }
    }
    __syncthreads();
    if (merge == 0)
      rank_into<true>(cd, ck, m, bd, bk, W, tid);
    else
      rank_into<false>(cd, ck, m, bd, bk, W, tid);
    __syncthreads();
  }
  if (merge == 1) {  // the one dedup after the walk
    for (int w = tid; w < W; w += k8Threads) {
      cd[w] = bd[w];
      ck[w] = bk[w];
    }
    __syncthreads();
    dedup_by_key(cd, ck, W, tid);
    __syncthreads();
    rank_into<true>(cd, ck, W, bd, bk, W, tid);
    __syncthreads();
  }
  for (int w = tid; w < W; w += k8Threads) {
    const float dw = bd[w];
    const int kw = bk[w];
    out_d[static_cast<size_t>(row_b) * W + w] = dw;
    out_ids[static_cast<size_t>(row_b) * W + w] =
        dw < inf_f() && kw >= 0 ? kw >> 1 : -1;
  }
}

template <int V, int M>
cudaError_t launch_k8(int b, size_t smem, cudaStream_t st,
                      const __nv_bfloat16* rows, long long stride, int d,
                      const int* nbrs, int lm0, const unsigned char* alive,
                      int cap, const float* q, const float* bd,
                      const int* bkey, int W, int E, int steps, int merge,
                      float* out_d, long long* out_ids) {
  cudaError_t err = cudaFuncSetAttribute(
      k8_beam_ground_kernel<V, M>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  k8_beam_ground_kernel<V, M><<<b, k8Threads, smem, st>>>(
      rows, stride, d, nbrs, lm0, alive, cap, q, bd, bkey, W, E, steps,
      merge, out_d, out_ids);
  return cudaGetLastError();
}

template <int V>
cudaError_t launch_k8_metric(int metric, int b, size_t smem, cudaStream_t st,
                             const __nv_bfloat16* rows, long long stride,
                             int d, const int* nbrs, int lm0,
                             const unsigned char* alive, int cap,
                             const float* q, const float* bd,
                             const int* bkey, int W, int E, int steps,
                             int merge, float* out_d, long long* out_ids) {
#define PGV_K8_CASE(M)                                                      \
  case M:                                                                   \
    return launch_k8<V, M>(b, smem, st, rows, stride, d, nbrs, lm0, alive,  \
                           cap, q, bd, bkey, W, E, steps, merge, out_d,     \
                           out_ids);
  switch (metric) {
    PGV_K8_CASE(0)
    PGV_K8_CASE(1)
    PGV_K8_CASE(2)
    PGV_K8_CASE(3)
    PGV_K8_CASE(4)
    default:
      return cudaErrorInvalidValue;
  }
#undef PGV_K8_CASE
}

}  // namespace

extern "C" {

// K8. rows [cap + 1, d] bf16 (row stride `stride` values), nbrs [cap + 1,
// lm0] int32, alive [cap + 1] bool, q [b, d] f32, bd / bkey [b, W] the
// seeded beam (f32 distances, int32 keys) -> out_d [b, W] f32, out_ids
// [b, W] int64. metric: 0 l2, 1 ip, 2 cosine, 3 l1, 4 jacbits; merge: 0
// sort with dedup, 1 sort without, 2 rank.
int pgv_k8_beam_ground(const void* rows, long long stride, int d,
                       const int* nbrs, int lm0, const unsigned char* alive,
                       int cap, const float* q, const float* bd,
                       const int* bkey, int b, int W, int E, int steps,
                       int metric, int merge, float* out_d,
                       long long* out_ids, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = k8_smem_bytes(W, E, E * lm0);
  if (b < 1 || W < 1 || E < 0 || E > W || lm0 < 1 || d < 1 || steps < 0 ||
      merge < 0 || merge > 2 || smem > static_cast<size_t>(k8MaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  auto x = static_cast<const __nv_bfloat16*>(rows);
  const bool vec = d % 8 == 0 && stride % 8 == 0 &&
                   reinterpret_cast<uintptr_t>(rows) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(q) % 16 == 0;
  return static_cast<int>(
      vec ? launch_k8_metric<8>(metric, b, smem, st, x, stride, d, nbrs, lm0,
                                alive, cap, q, bd, bkey, W, E, steps, merge,
                                out_d, out_ids)
          : launch_k8_metric<1>(metric, b, smem, st, x, stride, d, nbrs, lm0,
                                alive, cap, q, bd, bkey, W, E, steps, merge,
                                out_d, out_ids));
}

}  // extern "C"
