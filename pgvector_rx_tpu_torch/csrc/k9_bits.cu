// K9 -- the bit sweep: exact top-k by hamming or jaccard over packed words.
//
// No Pallas ancestor: it replaces the XLA program `_exact_search_bits`
// (pgvector_rx_tpu/graph/device.py:1155), which unpacks each corpus chunk
// to bf16 {0,1} columns for an MXU product at 32 queries or more and takes
// XOR / AND plus population_count on the words below that.
//
// What it computes, per query b over the rows whose `live` flag is set:
// - hamming: d = popcount(q ^ x);
// - jaccard: ab = popcount(q & x), union = popq + popx - ab (f32),
//   d = ab == 0 ? 1 : 1 - ab / union, with IEEE division (the build uses
//   no fast-math flag), so d is bit-equal to the JAX package's f32 value;
//   popx comes precomputed per row (`pop`), popq is counted per block;
// - the k smallest (d, row) pairs in that total order: each pair is one
//   64-bit key, d's f32 bits (d >= 0) above the row, so the order of the
//   list never depends on the order in which blocks or lanes offer rows
//   (the JAX order: lax.top_k per chunk keeps the lower index first, and
//   the chunks merge by a stable sort). A round of a k > 64 query admits
//   only keys >= `lo` (the key after the previous round's last).
//
// Bound on an H100 SXM, at the smoke's shape (1,024 queries x 1M rows x
// 256 bits, 8 words): the pairs are 8.4e9 words. On the integer units
// that is one XOR / AND, one population count and one add per word; the
// population count issues at 16 per clock per SM, so ~2 ms at 1.98 GHz.
// The same count as an int8 tensor-core product of unpacked {0,1} rows is
// 2 * 1,024 * 1M * 256 = 5.4e11 operations, 0.27 ms at 1,979 TOP/s; the
// bytes (32 MB of words) take 0.01 ms. So the bound is the int8 product
// (operations), and this simple population-count kernel is far from it
// by design: the redesign (an int8 wgmma form) is a later PR's work.
//
// Design (sm_90a, plain CUDA, no tensor cores):
// - A block of 8 warps owns QB <= 64 queries (their words and popcounts
//   resident in shared memory; QB chosen by the wrapper from the words
//   per row and k) and a range of rows (a split). Warp w owns queries
//   [w * QB / 8, (w + 1) * QB / 8) and walks the whole range 32 rows at a
//   time, one row per lane: each lane loads its row's words (16-byte loads
//   where the words allow) once for all the warp's queries, which read
//   their words from shared memory as broadcasts. The 8 warps read the
//   same rows, served by L1 after the first.
// - Each query keeps a sorted list of k keys in shared memory, private to
//   its warp: a ballot finds the lanes whose key beats the list's last,
//   and the warp inserts them one by one (no block barrier in the loop).
// - A second kernel merges the splits' lists: one warp per query.
// Measured: see PERF.md (K9 row), timed by chip_smoke.py phase 21.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int k9Warps = 8;
constexpr int k9Threads = k9Warps * 32;
constexpr int k9MaxQpw = 8;  // queries per warp (QB <= 64)
constexpr int k9MaxSmem = 200 * 1024;  // as ops/bits._k9_qtile assumes

template <int V>
struct Words;
template <>
struct Words<4> {
  using T = uint4;
  __device__ static uint4 load(const unsigned* p) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  }
};
template <>
struct Words<1> {
  using T = unsigned;
  __device__ static unsigned load(const unsigned* p) { return __ldg(p); }
};

__device__ __forceinline__ int pop_op(int metric_and, unsigned q,
                                      unsigned x) {
  return __popc(metric_and ? (q & x) : (q ^ x));
}
__device__ __forceinline__ int pop_op(int metric_and, uint4 q, uint4 x) {
  return pop_op(metric_and, q.x, x.x) + pop_op(metric_and, q.y, x.y) +
         pop_op(metric_and, q.z, x.z) + pop_op(metric_and, q.w, x.w);
}

struct Args {
  const unsigned* words;  // [n, w]
  const float* pop;       // [n] row popcounts (jaccard) or null
  const uint8_t* live;    // [n]
  const unsigned* q;      // [b, w]
  const unsigned long long* lo;  // [b] first admitted key, or null
  int n, w, b, k, qb, rows_per_split;
  unsigned long long* part;  // [b, splits, k]
};

// JACC: 0 hamming, 1 jaccard; V: words per load (4: 16-byte loads).
template <int JACC, int V>
__global__ void __launch_bounds__(k9Threads) k9_bits_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wp = (a.w + 3) & ~3;  // words per query row in shared memory
  unsigned* qs = reinterpret_cast<unsigned*>(smem);            // [qb][wp]
  float* qpop = reinterpret_cast<float*>(qs + a.qb * wp);      // [qb]
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(qpop + a.qb + (a.qb & 1));  // [qb][k]
  const int q0 = blockIdx.x * a.qb;
  const int split = blockIdx.y;
  const int r0 = split * a.rows_per_split;
  const int r1 = min(a.n, r0 + a.rows_per_split);

  for (int i = tid; i < a.qb * wp; i += k9Threads) {
    const int j = i / wp, c = i - j * wp;
    qs[i] = (q0 + j < a.b && c < a.w)
                ? a.q[static_cast<long long>(q0 + j) * a.w + c]
                : 0u;
  }
  for (int i = tid; i < a.qb * a.k; i += k9Threads) lists[i] = kEmptyKey;
  __syncthreads();
  for (int j = warp; j < a.qb; j += k9Warps) {  // popq, one warp per query
    int s = 0;
    for (int c = lane; c < a.w; c += 32) s += __popc(qs[j * wp + c]);
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    if (lane == 0) qpop[j] = static_cast<float>(s);
  }
  __syncthreads();

  const int qpw = a.qb / k9Warps;
  const int my0 = warp * qpw;  // this warp's first query in the block
  unsigned long long lo[k9MaxQpw], thr[k9MaxQpw];
  float qp[k9MaxQpw];
#pragma unroll
  for (int j = 0; j < k9MaxQpw; ++j) {
    const int qi = q0 + my0 + j;
    const bool mine = j < qpw && qi < a.b;
    lo[j] = !mine ? kEmptyKey : (a.lo != nullptr ? a.lo[qi] : 0ull);
    thr[j] = kEmptyKey;
    qp[j] = j < qpw ? qpop[my0 + j] : 0.f;
  }
  const int nv = a.w / V;

  for (int row0 = r0; row0 < r1; row0 += 32) {
    const int row = row0 + lane;
    const bool ok = row < r1 && a.live[row];
    int acc[k9MaxQpw];
#pragma unroll
    for (int j = 0; j < k9MaxQpw; ++j) acc[j] = 0;
    if (ok) {
      const unsigned* xr = a.words + static_cast<long long>(row) * a.w;
      for (int c = 0; c < nv; ++c) {
        using T = typename Words<V>::T;
        const T x = Words<V>::load(xr + c * V);
#pragma unroll
        for (int j = 0; j < k9MaxQpw; ++j) {
          if (j < qpw) {
            const T qv =
                *reinterpret_cast<const T*>(qs + (my0 + j) * wp + c * V);
            acc[j] += pop_op(JACC, qv, x);
          }
        }
      }
    }
    const float px = (JACC && ok) ? __ldg(a.pop + row) : 0.f;
#pragma unroll
    for (int j = 0; j < k9MaxQpw; ++j) {
      if (j >= qpw) break;  // warp-uniform
      unsigned long long key = kEmptyKey;
      if (ok) {
        float d;
        if (JACC) {
          const float ab = static_cast<float>(acc[j]);
          const float uni = qp[j] + px - ab;
          d = acc[j] == 0 ? 1.0f : 1.0f - __fdiv_rn(ab, uni);
        } else {
          d = static_cast<float>(acc[j]);
        }
        key = (static_cast<unsigned long long>(__float_as_uint(d)) << 32) |
              static_cast<unsigned>(row);
        if (key < lo[j]) key = kEmptyKey;
      }
      if (__any_sync(kFull, key < thr[j])) {
        unsigned long long* l = lists + (my0 + j) * a.k;
        warp_offer_key(l, a.k, key, lane);
        thr[j] = l[a.k - 1];
      }
    }
  }
  __syncwarp();
  for (int j = 0; j < qpw; ++j) {
    const int qi = q0 + my0 + j;
    if (qi >= a.b) break;
    const unsigned long long* l = lists + (my0 + j) * a.k;
    unsigned long long* o =
        a.part + (static_cast<long long>(qi) * gridDim.y + split) * a.k;
    for (int i = lane; i < a.k; i += 32) o[i] = l[i];
  }
}

size_t smem_bytes(int w, int qb, int k) {
  const size_t wp = (static_cast<size_t>(w) + 3) & ~static_cast<size_t>(3);
  return 4 * (qb * wp + qb + (qb & 1)) + 8 * static_cast<size_t>(qb) * k;
}

template <int JACC, int V>
cudaError_t launch(const Args& a, dim3 grid, size_t smem, cudaStream_t st) {
  auto kern = k9_bits_kernel<JACC, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<grid, k9Threads, smem, st>>>(a);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K9 for b queries over n rows of w words: metric 0 hamming, 1 jaccard
// (pop [n] required); lo [b] or null; qb queries per block (a multiple of
// 8, at most 64); the grid is (ceil(b / qb), splits), split s covering
// rows [s * rows_per_split, +rows_per_split). part [b, splits, k] is
// scratch; out [b, k] the keys (d bits << 32 | row), ascending, ~0 empty.
int pgv_k9_bits_topk(const unsigned* words, const float* pop,
                     const uint8_t* live, const unsigned* q,
                     const unsigned long long* lo, int n, int w, int b, int k,
                     int metric, int qb, int splits, int rows_per_split,
                     unsigned long long* part, unsigned long long* out,
                     void* stream) {
  if (n <= 0 || w <= 0 || b <= 0 || k < 1 || k > kMaxK || qb <= 0 ||
      qb % k9Warps || qb > k9Warps * k9MaxQpw || splits <= 0 ||
      rows_per_split <= 0 || metric < 0 || metric > 1 ||
      (metric == 1 && pop == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(w, qb, k);
  if (smem > static_cast<size_t>(k9MaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{words, pop, live, q, lo, n, w, b, k, qb, rows_per_split, part};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((b + qb - 1) / qb, splits);
  const bool vec = w % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  cudaError_t err;
  if (metric == 1)
    err = vec ? launch<1, 4>(a, grid, smem, st) : launch<1, 1>(a, grid, smem, st);
  else
    err = vec ? launch<0, 4>(a, grid, smem, st) : launch<0, 1>(a, grid, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_key_select(part, b, splits * k, k, out, st));
}

}  // extern "C"
