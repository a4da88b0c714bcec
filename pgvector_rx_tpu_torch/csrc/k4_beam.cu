// K4 / K5 -- the layer-0 best-first beam walk, one thread block per query.
//
// No Pallas ancestor: it replaces two XLA `lax.while_loop` programs of the
// JAX package, `_ground_beam_seeds` (pgvector_rx_tpu/graph/device.py:446,
// the beam engine: K4, "serving mode") and `_beam_scan_segment` (:574, one
// segment of the resumable beam scan: K5, "scan mode"). In torch each step
// of the walk would be ~20 small kernel launches; here the whole walk is
// one launch.
//
// What it computes, per query b (the JAX semantics at the defaults:
// one expansion per step, in-beam dedup, f32 ranking):
// - A beam of width W (K4: W = ef; K5: the scan's internal width), kept
//   sorted by (distance, key), key = id * 2 + (1 - expanded), an invalid
//   slot (inf, -2). The seeds are sorted into it at the start; K5 admits
//   only traversable, not-excluded seeds and sends the seeds past W to
//   the spill.
// - Each step takes the nearest unexpanded beam member (the first one in
//   the beam's order), marks it expanded, scores its <= L = 2M layer-0
//   neighbours that are live (`trav`) and, in K5, not excluded (`excl`),
//   and merges them into the beam. A neighbour whose id is already in the
//   beam, or earlier in the same neighbour list, keeps its key with an
//   infinite distance (the JAX dedup: the expanded copy wins). The first
//   W of the merged (W + L) entries form the new beam; in K5 the other L
//   (the evicted tail) merge into a spill buffer of the SP nearest.
// - The walk stops when the nearest unexpanded member is farther than the
//   furthest member (or none is left), or after max_steps steps.
// - Output: the raw beam [W] and spill [SP], both sorted by (distance,
//   key), the step count and the number of rows scored (the live, not
//   excluded neighbours whose rows the walk read: its bound's bytes). The wrapper (ops/beam.py) converts keys to
//   ids and, in K5, folds the W - ef leftover into the spill and dedups it:
//   a few [B, <= W + SP] sorts per segment, shared with the plain version.
//
// Bound on an H100 SXM: the bytes it gathers. Every step reads the L ids
// of one neighbour list and the rows of its live neighbours (a -1 pad, a
// dead or an excluded neighbour costs no row), so the walk moves
// sum(steps) * L * 4 + scored * (d * 4 + 1) bytes for f32 rows, `scored`
// being the rows it read (returned per query). A single walk is a chain of dependent steps (ids -> flags ->
// rows -> merge), so it is latency-bound; throughput comes from many
// queries (blocks) in flight.
//
// Packed-word mode (the bit kind, serving only): rows are [cap + 1, W]
// 32-bit words and the query is W words; hamming = popcount(q ^ x),
// jaccard = ab == 0 ? 1 : 1 - ab / (popq + popx - ab) with ab =
// popcount(q & x), popq counted once per query and popx from the gathered
// words (IEEE division: the JAX package's f32 values). The bound counts the
// gathered words the same way: scored * (W * 4 + 1) bytes.
//
// Sparse-row mode (the sparse kind, serving only): rows are padded CSR,
// `values` [cap + 1, P] int32 indices (sorted, INT32_MAX pads) and
// `values2` [cap + 1, P] f32 values; the query is its P indices followed
// by the bits of its P values (2P words). Each scored row's entries are
// looked up in the query's sorted indices (a binary search in shared
// memory): dot over the matches, |x|^2 and sum|x| over the row, |q|^2,
// sum|q| and the query's length once per query; l2 max(|q|^2 + |x|^2 -
// 2 dot, 0), ip -dot, cosine 1 - clamp(dot / sqrt(|q|^2 |x|^2)) (0
// similarity at a zero norm), l1 sum|q| + sum|x| + sum over matches of
// |qv - xv| - |qv| - |xv| (ops/sparse.py, the JAX package's
// _sparse_dist). The bound counts scored * (P * 8 + 1) bytes.
//
// Design (sm_90a, plain CUDA, no tensor cores):
// - 128 threads per block; the query, the double-buffered beam and spill,
//   the neighbour list and the merge scratch live in shared memory
//   (~12 KB at W = 160, SP = 320, d = 128), so many blocks fit on an SM.
// - Scoring: each warp scores 4 neighbour rows at once (their loads in
//   flight together), 16-byte loads when the rows allow it (aligned base
//   and row stride, d a multiple of 4 f32 / 8 f16 or bf16 values), scalar
//   loads otherwise (odd d, a view offset by one element); a shuffle
//   reduction per row. Rows may be f32, f16 or bf16; sums are f32. Word
//   rows are short (8 words at 256 bits), so a warp splits into groups of
//   the fewest lanes (a power of two) that cover a row's 16-byte chunks,
//   and scores 32 / group rows at once.
// - Merging: the new entries are rank-sorted (L^2 comparisons, L <= 256),
//   then every entry finds its merged position with one binary search in
//   the other sorted list (merge path), so beam and spill stay sorted with
//   no full sort per step. Ties in (distance, key) keep beam before new
//   and spill before tail, as the JAX package's stable sorts do.
// Measured: see PERF.md (K4 / K5 rows), timed by chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows a warp scores with loads in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory limit

struct WalkArgs {
  const void* values;     // [>= cap + 1, d] rows, row stride `stride`
  const void* values2;    // sparse rows: their [>= cap + 1, d] f32 values
  long long stride;       // elements between consecutive rows
  const int* nbrs;        // [cap + 1, L] layer-0 ids (-1 pad)
  const uint8_t* trav;    // [cap + 1] live rows
  const uint8_t* excl;    // [b, cap + 1] excluded rows (scan mode) or null
  long long excl_stride;  // elements between the queries' masks
  const float* q;         // [b, d]
  const int* seed_ids;    // [b, S] (-1 = unused)
  const float* seed_d;    // [b, S]
  float* beam_d;          // [b, W]
  int* beam_key;          // [b, W]
  float* spill_d;         // [b, SP]
  int* spill_key;         // [b, SP]
  int* steps;             // [b]
  int* scored;            // [b] rows scored
  int d, qd, L, cap, metric, S, W, SP, max_steps, scan;  // qd: query words
};

// The sparse-row mode's row type (indices in `values`, values in
// `values2`).
struct SparseRow {};
constexpr int kPadIndex = 0x7fffffff;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The walk's total order: by distance, then by key.
__device__ __forceinline__ bool before(float da, int ka, float db, int kb) {
  return da < db || (da == db && ka < kb);
}

template <typename T>
__device__ __forceinline__ float to_f(T x);
template <>
__device__ __forceinline__ float to_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float to_f<__half>(__half x) {
  return __half2float(x);
}
template <>
__device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

// V consecutive values of a row, starting at element c * V, as f32.
template <typename T, int V>
struct Load;
template <typename T>
struct Load<T, 1> {
  __device__ static void run(const T* row, int c, float* out) {
    out[0] = to_f(row[c]);
  }
};
template <>
struct Load<float, 4> {
  __device__ static void run(const float* row, int c, float* out) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(row) + c);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
};
template <>
struct Load<__half, 8> {
  __device__ static void run(const __half* row, int c, float* out) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(row) + c);
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
};
template <>
struct Load<__nv_bfloat16, 8> {
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

// Metric codes as ops/beam.py passes them: 0 l2 (squared), 1 ip (-dot),
// 2 cosine (1 - clamp(dot)), 3 l1; on word rows 4 hamming, 5 jaccard.
template <int M>
__device__ __forceinline__ float term(float x, float q) {
  if (M == 0) {
    const float t = x - q;
    return t * t;
  }
  if (M == 3) return fabsf(x - q);
  return x * q;
}

template <int M>
__device__ __forceinline__ float finish(float acc) {
  if (M == 1) return -acc;
  if (M == 2) return 1.0f - fminf(fmaxf(acc, -1.0f), 1.0f);
  return acc;
}

// out[j] = distance from the query (qs, in shared memory) to row ids[j]
// for the valid j < L, +inf for the others. Each warp takes kRowsPerWarp
// rows at a time; the lanes stride over the row's V-wide chunks.
template <typename T, int V, int M>
__device__ void score_rows(const WalkArgs& a, const float* qs, const int* ids,
                           const uint8_t* valid, float* out, int warp,
                           int lane) {
  const T* values = static_cast<const T*>(a.values);
  const int nchunks = a.d / V;
  for (int base = warp * kRowsPerWarp; base < a.L;
       base += kWarps * kRowsPerWarp) {
    float acc[kRowsPerWarp];
    const T* rows[kRowsPerWarp];
    bool use[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = base + r;
      use[r] = j < a.L && valid[j];
      rows[r] = values + (use[r] ? static_cast<long long>(ids[j]) * a.stride
                                 : 0LL);
      acc[r] = 0.0f;
    }
    for (int c = lane; c < nchunks; c += 32) {
      float qv[V];
#pragma unroll
      for (int e = 0; e < V; ++e) qv[e] = qs[c * V + e];
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (!use[r]) continue;  // warp-uniform
        float x[V];
        Load<T, V>::run(rows[r], c, x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r] += term<M>(x[e], qv[e]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      float s = acc[r];
#pragma unroll
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0 && base + r < a.L) out[base + r] = use[r] ? finish<M>(s)
                                                              : inf_f();
    }
  }
}

template <int V>
struct WordChunk;
template <>
struct WordChunk<4> {
  using T = uint4;
  __device__ static int pop(uint4 v) {
    return __popc(v.x) + __popc(v.y) + __popc(v.z) + __popc(v.w);
  }
  __device__ static uint4 op(uint4 a, uint4 b, bool both) {
    return both ? make_uint4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w)
                : make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
  }
};
template <>
struct WordChunk<1> {
  using T = unsigned;
  __device__ static int pop(unsigned v) { return __popc(v); }
  __device__ static unsigned op(unsigned a, unsigned b, bool both) {
    return both ? (a & b) : (a ^ b);
  }
};

// The packed-word mode's scoring: out[j] = hamming (JACC = 0) or jaccard
// (JACC = 1) from the query words qs to row ids[j], +inf where not valid.
// A warp works in groups of `lpr` lanes, one row per group; a group's
// lanes stride over the row's V-word chunks.
template <int V, int JACC>
__device__ void score_words(const WalkArgs& a, const unsigned* qs,
                            float qpop, const int* ids, const uint8_t* valid,
                            float* out, int warp, int lane) {
  using C = WordChunk<V>;
  using T = typename C::T;
  const unsigned* words = static_cast<const unsigned*>(a.values);
  const int nchunks = a.d / V;
  int lpr = 1;
  while (lpr < nchunks && lpr < 32) lpr <<= 1;
  const int rpw = 32 / lpr;
  const int sub = lane / lpr, sl = lane % lpr;
  for (int base = warp * rpw; base < a.L; base += kWarps * rpw) {
    const int j = base + sub;
    const bool use = j < a.L && valid[j];
    int c1 = 0, c2 = 0;  // popcount(q op x), popcount(x)
    if (use) {
      const T* row = reinterpret_cast<const T*>(
          words + static_cast<long long>(ids[j]) * a.stride);
      const T* q = reinterpret_cast<const T*>(qs);
      for (int c = sl; c < nchunks; c += lpr) {
        const T x = __ldg(row + c);
        c1 += C::pop(C::op(q[c], x, JACC));
        if (JACC) c2 += C::pop(x);
      }
    }
    for (int o = lpr >> 1; o; o >>= 1) {
      c1 += __shfl_xor_sync(kFull, c1, o);
      if (JACC) c2 += __shfl_xor_sync(kFull, c2, o);
    }
    if (sl == 0 && j < a.L) {
      float dist = inf_f();
      if (use) {
        if (JACC) {
          const float ab = static_cast<float>(c1);
          dist = c1 == 0
                     ? 1.0f
                     : 1.0f - __fdiv_rn(ab, qpop + static_cast<float>(c2) - ab);
        } else {
          dist = static_cast<float>(c1);
        }
      }
      out[j] = dist;
    }
  }
}

// The first position of s[0, len) (ascending) whose value is >= c.
__device__ __forceinline__ int lower_bound(const int* s, int len, int c) {
  int lo = 0, n = len;
  while (n > 0) {
    const int h = n >> 1;
    if (s[lo + h] < c) {
      lo += h + 1;
      n -= h + 1;
    } else {
      n = h;
    }
  }
  return lo;
}

// Per-query terms of the sparse-row mode, computed once per block.
struct SparseQuery {
  int len;      // entries before the first pad
  float sq;     // |q|^2
  float abs1;   // sum |q|
};

// The sparse-row mode's scoring: out[j] = the distance (metric M, codes
// 0-3) from the query (sorted indices qidx, values qval, in shared memory)
// to padded-CSR row ids[j], +inf where not valid. Each warp takes
// kRowsPerWarp rows at a time; the lanes stride over a row's entries and
// look each up in the query's indices; a shuffle reduction per row.
template <int M>
__device__ void score_sparse(const WalkArgs& a, const int* qidx,
                             const float* qval, const SparseQuery& sq,
                             const int* ids, const uint8_t* valid, float* out,
                             int warp, int lane) {
  const int* ind = static_cast<const int*>(a.values);
  const float* val = static_cast<const float*>(a.values2);
  for (int base = warp * kRowsPerWarp; base < a.L;
       base += kWarps * kRowsPerWarp) {
    float dot[kRowsPerWarp], csq[kRowsPerWarp], cabs[kRowsPerWarp],
        corr[kRowsPerWarp];
    long long off[kRowsPerWarp];
    bool use[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = base + r;
      use[r] = j < a.L && valid[j];
      off[r] = use[r] ? static_cast<long long>(ids[j]) * a.stride : 0LL;
      dot[r] = csq[r] = cabs[r] = corr[r] = 0.0f;
    }
    for (int e = lane; e < a.d; e += 32) {
#pragma unroll
      for (int r = 0; r < kRowsPerWarp; ++r) {
        if (!use[r]) continue;  // warp-uniform
        const int c = __ldg(ind + off[r] + e);
        if (c == kPadIndex) continue;
        const float x = __ldg(val + off[r] + e);
        csq[r] += x * x;
        if (M == 3) cabs[r] += fabsf(x);
        const int pos = lower_bound(qidx, sq.len, c);
        if (pos < sq.len && qidx[pos] == c) {
          const float g = qval[pos];
          dot[r] += g * x;
          if (M == 3) corr[r] += fabsf(g - x) - fabsf(g) - fabsf(x);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        dot[r] += __shfl_xor_sync(kFull, dot[r], o);
        csq[r] += __shfl_xor_sync(kFull, csq[r], o);
        if (M == 3) {
          cabs[r] += __shfl_xor_sync(kFull, cabs[r], o);
          corr[r] += __shfl_xor_sync(kFull, corr[r], o);
        }
      }
      if (lane == 0 && base + r < a.L) {
        float dist = inf_f();
        if (use[r]) {
          if (M == 0) {
            dist = fmaxf(sq.sq + csq[r] - 2.0f * dot[r], 0.0f);
          } else if (M == 1) {
            dist = -dot[r];
          } else if (M == 2) {
            const float den = sqrtf(sq.sq * csq[r]);
            const float sim = den > 0.0f ? __fdiv_rn(dot[r], den) : 0.0f;
            dist = 1.0f - fminf(fmaxf(sim, -1.0f), 1.0f);
          } else {
            dist = sq.abs1 + cabs[r] + corr[r];
          }
        }
        out[base + r] = dist;
      }
    }
  }
}

// Number of entries of the sorted list (ld, lk)[0, n) that come before
// (d, k) -- strictly (`strict`) or also when equal.
__device__ __forceinline__ int count_before(const float* ld, const int* lk,
                                            int n, float d, int k,
                                            bool strict) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    const bool b = strict ? before(ld[mid], lk[mid], d, k)
                          : !before(d, k, ld[mid], lk[mid]);
    if (b)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

size_t smem_bytes(int qd, int L, int S, int W, int SP) {
  const size_t dpad = (static_cast<size_t>(qd) + 3) & ~static_cast<size_t>(3);
  // q; beam x2 (d, key); new raw, new sorted, tail (d, key); spill x2;
  // seeds (d, key); neighbour ids and dup flags; neighbour live flags
  return 4 * (dpad + 4 * static_cast<size_t>(W) + 6 * L + 4 * SP + 2 * S +
              2 * L) +
         L;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) beam_walk_kernel(WalkArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps];
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, SP = a.SP, L = a.L, S = a.S;
  const float inf = inf_f();

  float* qs = reinterpret_cast<float*>(smem);
  float* bd = qs + ((a.qd + 3) & ~3);  // beam distances, 2 buffers of W
  int* bk = reinterpret_cast<int*>(bd + 2 * W);
  float* nd = reinterpret_cast<float*>(bk + 2 * W);  // new, in list order
  int* nk = reinterpret_cast<int*>(nd + L);
  float* sd = reinterpret_cast<float*>(nk + L);  // new, sorted
  int* sk = reinterpret_cast<int*>(sd + L);
  float* td = reinterpret_cast<float*>(sk + L);  // evicted tail, sorted
  int* tk = reinterpret_cast<int*>(td + L);
  float* pd = reinterpret_cast<float*>(tk + L);  // spill, 2 buffers of SP
  int* pk = reinterpret_cast<int*>(pd + 2 * SP);
  float* xd = reinterpret_cast<float*>(pk + 2 * SP);  // seeds
  int* xk = reinterpret_cast<int*>(xd + S);
  int* nid = xk + S;  // neighbour ids
  int* dup = nid + L;  // neighbour already in the beam / the list
  uint8_t* nvalid = reinterpret_cast<uint8_t*>(dup + L);

  const uint8_t* excl =
      a.excl != nullptr ? a.excl + static_cast<long long>(b) * a.excl_stride
                        : nullptr;
  // the query's bits, as they are (f32 values, packed words, or sparse
  // indices then value bits)
  const int* qg = reinterpret_cast<const int*>(a.q) +
                  static_cast<long long>(b) * a.qd;
  for (int i = tid; i < a.qd; i += kThreads)
    reinterpret_cast<int*>(qs)[i] = qg[i];
  constexpr bool kWords = std::is_same<T, unsigned>::value;
  constexpr bool kSparse = std::is_same<T, SparseRow>::value;
  const int* qidx = reinterpret_cast<const int*>(qs);  // sparse: [d]
  const float* qval = qs + a.d;                          // sparse: [d]
  __shared__ SparseQuery sq;
  if (kSparse) {
    __syncthreads();
    if (warp == 0) {
      float s2 = 0.0f, s1 = 0.0f;
      int len = 0;
      for (int i = lane; i < a.d; i += 32) {
        if (qidx[i] != kPadIndex) {
          s2 += qval[i] * qval[i];
          s1 += fabsf(qval[i]);
          ++len;
        }
      }
#pragma unroll
      for (int o = 16; o; o >>= 1) {
        s2 += __shfl_xor_sync(kFull, s2, o);
        s1 += __shfl_xor_sync(kFull, s1, o);
        len += __shfl_xor_sync(kFull, len, o);
      }
      if (lane == 0) sq = SparseQuery{len, s2, s1};
    }
  }
  __shared__ float qpop;  // the query's popcount (jaccard)
  if (kWords) {
    __syncthreads();
    if (warp == 0) {
      int s = 0;
      for (int i = lane; i < a.d; i += 32)
        s += __popc(reinterpret_cast<const unsigned*>(qs)[i]);
      s = __reduce_add_sync(kFull, s);
      if (lane == 0) qpop = static_cast<float>(s);
    }
  }

  // ---- seeds: admit, dedup by id, sort into the beam (and the spill)
  const long long s0 = static_cast<long long>(b) * S;
  for (int i = tid; i < S; i += kThreads) {
    const int id = a.seed_ids[s0 + i];
    bool ok = id >= 0;
    if (ok && a.scan) {
      const int s = min(id, a.cap);
      ok = a.trav[s] && !excl[s];
    }
    xd[i] = ok ? a.seed_d[s0 + i] : inf;
    xk[i] = ok ? 2 * id + 1 : -2;
  }
  __syncthreads();
  for (int i = tid; i < S; i += kThreads) {
    bool again = false;
    for (int j = 0; j < i && !again; ++j) again = xk[i] >= 0 && xk[j] == xk[i];
    if (again) xd[i] = inf;  // a repeated seed: only its first copy lives
  }
  __syncthreads();
  for (int i = tid; i < S; i += kThreads) {
    int r = 0;
    for (int j = 0; j < S; ++j)
      r += before(xd[j], xk[j], xd[i], xk[i]) ||
           (j < i && xd[j] == xd[i] && xk[j] == xk[i]);
    if (r < W) {
      bd[r] = xd[i];
      bk[r] = xk[i];
    } else if (r - W < SP) {
      pd[r - W] = xd[i];
      pk[r - W] = xk[i];
    }
  }
  for (int r = S + tid; r < W; r += kThreads) {
    bd[r] = inf;
    bk[r] = -2;
  }
  for (int r = max(S - W, 0) + tid; r < SP; r += kThreads) {
    pd[r] = inf;
    pk[r] = -2;
  }
  __syncthreads();

  int cur = 0, steps = 0, scored = 0;
  while (true) {
    float* cbd = bd + cur * W;
    int* cbk = bk + cur * W;
    float* obd = bd + (cur ^ 1) * W;
    int* obk = bk + (cur ^ 1) * W;

    // the nearest unexpanded member: the first in the beam's order
    int local = INT_MAX;
    for (int i = tid; i < W; i += kThreads)
      if ((cbk[i] & 1) && cbd[i] < inf) local = min(local, i);
    local = __reduce_min_sync(kFull, local);
    if (lane == 0) red[warp] = local;
    __syncthreads();
    int pos = red[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) pos = min(pos, red[w]);
    if (pos == INT_MAX || steps >= a.max_steps || !(cbd[pos] <= cbd[W - 1]))
      break;  // the same decision in every thread
    const int u = min(cbk[pos] >> 1, a.cap);  // the sentinel row at worst

    for (int j0 = 0; j0 < L; j0 += kThreads) {  // the same trips in every
      const int j = j0 + tid;                      // thread
      bool ok = false;
      if (j < L) {
        const int v = a.nbrs[static_cast<long long>(u) * L + j];
        ok = v >= 0;
        if (ok) {
          const int s = min(v, a.cap);
          ok = a.trav[s] && !(excl != nullptr && excl[s]);
        }
        nid[j] = v;
        nvalid[j] = ok;
        nk[j] = ok ? 2 * v + 1 : -2;
        dup[j] = 0;
      }
      scored += __syncthreads_count(ok);
    }
    if (tid == 0) cbk[pos] &= ~1;  // expanded; read again after a barrier

    if constexpr (kWords) {
      const unsigned* qw = reinterpret_cast<const unsigned*>(qs);
      if (a.metric == 5)
        score_words<V, 1>(a, qw, qpop, nid, nvalid, nd, warp, lane);
      else
        score_words<V, 0>(a, qw, qpop, nid, nvalid, nd, warp, lane);
    } else if constexpr (kSparse) {
      switch (a.metric) {
        case 0: score_sparse<0>(a, qidx, qval, sq, nid, nvalid, nd, warp, lane); break;
        case 1: score_sparse<1>(a, qidx, qval, sq, nid, nvalid, nd, warp, lane); break;
        case 2: score_sparse<2>(a, qidx, qval, sq, nid, nvalid, nd, warp, lane); break;
        default: score_sparse<3>(a, qidx, qval, sq, nid, nvalid, nd, warp, lane); break;
      }
    } else {
      switch (a.metric) {
        case 0: score_rows<T, V, 0>(a, qs, nid, nvalid, nd, warp, lane); break;
        case 1: score_rows<T, V, 1>(a, qs, nid, nvalid, nd, warp, lane); break;
        case 2: score_rows<T, V, 2>(a, qs, nid, nvalid, nd, warp, lane); break;
        default: score_rows<T, V, 3>(a, qs, nid, nvalid, nd, warp, lane); break;
      }
    }
    __syncthreads();

    // dedup: a neighbour whose id is in the beam, or earlier in the list
    for (int i = tid; i < W; i += kThreads) {
      const int k = cbk[i];
      if (k < 0) continue;
      for (int j = 0; j < L; ++j)
        if (nk[j] >= 0 && (nk[j] >> 1) == (k >> 1)) dup[j] = 1;
    }
    for (int j = tid; j < L; j += kThreads) {
      if (nk[j] < 0) continue;
      for (int i = 0; i < j; ++i)
        if (nk[i] == nk[j]) dup[j] = 1;
    }
    __syncthreads();

    // rank-sort the new entries
    for (int j = tid; j < L; j += kThreads) {
      const float dj = dup[j] ? inf : nd[j];
      const int kj = nk[j];
      int r = 0;
      for (int i = 0; i < L; ++i) {
        const float di = dup[i] ? inf : nd[i];
        r += before(di, nk[i], dj, kj) || (i < j && di == dj && nk[i] == kj);
      }
      sd[r] = dj;
      sk[r] = kj;
    }
    __syncthreads();

    // merge beam (W) and new (L): the first W are the next beam, the rest
    // the evicted tail
    for (int i = tid; i < W; i += kThreads) {
      const int r = i + count_before(sd, sk, L, cbd[i], cbk[i], true);
      if (r < W) {
        obd[r] = cbd[i];
        obk[r] = cbk[i];
      } else {
        td[r - W] = cbd[i];
        tk[r - W] = cbk[i];
      }
    }
    for (int j = tid; j < L; j += kThreads) {
      const int r = j + count_before(cbd, cbk, W, sd[j], sk[j], false);
      if (r < W) {
        obd[r] = sd[j];
        obk[r] = sk[j];
      } else {
        td[r - W] = sd[j];
        tk[r - W] = sk[j];
      }
    }
    if (SP > 0) {
      __syncthreads();
      // merge spill (SP) and tail (L), keep the SP nearest
      const float* cpd = pd + cur * SP;
      const int* cpk = pk + cur * SP;
      float* opd = pd + (cur ^ 1) * SP;
      int* opk = pk + (cur ^ 1) * SP;
      for (int i = tid; i < SP; i += kThreads) {
        const int r = i + count_before(td, tk, L, cpd[i], cpk[i], true);
        if (r < SP) {
          opd[r] = cpd[i];
          opk[r] = cpk[i];
        }
      }
      for (int j = tid; j < L; j += kThreads) {
        const int r = j + count_before(cpd, cpk, SP, td[j], tk[j], false);
        if (r < SP) {
          opd[r] = td[j];
          opk[r] = tk[j];
        }
      }
    }
    __syncthreads();
    cur ^= 1;
    ++steps;
  }

  const float* cbd = bd + cur * W;
  const int* cbk = bk + cur * W;
  const long long ob = static_cast<long long>(b) * W;
  for (int i = tid; i < W; i += kThreads) {
    a.beam_d[ob + i] = cbd[i];
    a.beam_key[ob + i] = cbk[i];
  }
  const long long os = static_cast<long long>(b) * SP;
  for (int i = tid; i < SP; i += kThreads) {
    a.spill_d[os + i] = pd[cur * SP + i];
    a.spill_key[os + i] = pk[cur * SP + i];
  }
  if (tid == 0) {
    a.steps[b] = steps;
    a.scored[b] = scored;
  }
}

template <typename T, int V>
cudaError_t launch(const WalkArgs& a, int b, size_t smem,
                   cudaStream_t stream) {
  auto kern = beam_walk_kernel<T, V>;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<b, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The vector width a row allows: 16-byte loads need a 16-byte aligned
// base, a row stride of whole 16-byte units and d a multiple of the unit.
template <typename T>
cudaError_t dispatch(const WalkArgs& a, int b, size_t smem,
                     cudaStream_t stream) {
  constexpr int V = std::is_same<T, unsigned>::value ? 4 : 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a.values) % 16 == 0 &&
                   (a.stride * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   a.d % V == 0;
  return vec ? launch<T, V>(a, b, smem, stream)
             : launch<T, 1>(a, b, smem, stream);
}

}  // namespace

extern "C" {

// The beam walk for b queries, one block each. dtype: 0 f32, 1 f16, 2 bf16
// rows with metric 0 l2, 1 ip, 2 cosine, 3 l1; 3 packed 32-bit words (d
// words per row and per query) with metric 4 hamming, 5 jaccard, serving
// mode only; 4 padded-CSR rows (d int32 indices in `values`, d f32 values
// in `values2`, the query d indices then d value bits: qd = 2d) with
// metric 0-3, serving mode only. qd: the query's 32-bit words (d, or 2d
// for sparse rows). scan = 0 (K4): S <= W, excl
// null, SP = 0; scan = 1 (K5): excl [b, cap + 1] (row `excl_stride`), the
// seeds past W go to the spill. Outputs as WalkArgs lists them.
int pgv_k4_beam_walk(const void* values, const void* values2, int dtype,
                     long long stride, int d, int qd,
                     const int* nbrs, int L, const uint8_t* trav,
                     const uint8_t* excl, long long excl_stride, int cap,
                     int metric, const float* q, const int* seed_ids,
                     const float* seed_d, int b, int S, int W, int SP,
                     int max_steps, int scan, float* beam_d, int* beam_key,
                     float* spill_d, int* spill_key, int* steps, int* scored,
                     void* stream) {
  const bool words = dtype == 3, sparse = dtype == 4;
  if (b <= 0 || d <= 0 || L <= 0 || S < 0 || W <= 0 || SP < 0 ||
      (!scan && (S > W || SP != 0)) || (scan && excl == nullptr) ||
      metric < 0 || metric > 5 || words != (metric >= 4) ||
      ((words || sparse) && scan) || qd != (sparse ? 2 * d : d) ||
      sparse != (values2 != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = smem_bytes(qd, L, S, W, SP);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{values, values2, stride, nbrs, trav, excl, excl_stride, q,
             seed_ids, seed_d, beam_d, beam_key, spill_d, spill_key, steps,
             scored, d, qd, L, cap, metric, S, W, SP, max_steps, scan};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0)
    err = dispatch<float>(a, b, smem, st);
  else if (dtype == 1)
    err = dispatch<__half>(a, b, smem, st);
  else if (dtype == 2)
    err = dispatch<__nv_bfloat16>(a, b, smem, st);
  else if (dtype == 3)
    err = dispatch<unsigned>(a, b, smem, st);
  else if (dtype == 4)
    err = launch<SparseRow, 1>(a, b, smem, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

}  // extern "C"
