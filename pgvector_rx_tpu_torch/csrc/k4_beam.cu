// K4 / K5 -- the layer-0 best-first beam walk, one thread block per query.
//
// No Pallas ancestor: it replaces two XLA `lax.while_loop` programs of the
// JAX package, `_ground_beam_seeds` (pgvector_rx_tpu/graph/device.py:446,
// the beam engine: K4, `beam_walk_kernel` in serving mode) and
// `_beam_scan_segment` (:574, one segment of the resumable beam scan: K5,
// `beam_scan_kernel`). In torch each step of the walk would be ~20 small
// kernel launches; here the whole walk is one launch.
//
// What the walk computes, per query b (the JAX semantics at the defaults:
// one expansion per step, in-beam dedup, f32 ranking; the variants, JAX's
// PGV_BEAM_EXPAND, PGV_BEAM_VISITED_MAX and PGV_BEAM_BF16, are modes of the
// same kernels, described at beam_walk_kernel, the word walk and
// beam_scan_kernel):
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
//
// K4 (`beam_walk_kernel`): outputs the raw beam [W] sorted by (distance,
// key), the step count and the number of rows scored (the live, not
// excluded neighbours whose rows the walk read: its bound's bytes); the
// wrapper (ops/beam.py) converts keys to ids.
//
// K5 (`beam_scan_kernel`, below): the segment and its finish in one launch
// (the emitted top ef, the spill with the width - ef leftover merged in,
// deduplicated by id and cleared of the emitted ids, and, on request, the
// emitted ids marked in the exclusion mask), one small report for the
// host. It keeps only finite entries (an entry JAX keeps at an infinite
// distance changes no output) and is built for one query's latency: see
// its comment.
//
// Bound on an H100 SXM: the bytes it gathers. Every step reads the L ids
// of one neighbour list and the rows of its live neighbours (a -1 pad, a
// dead or an excluded neighbour costs no row), so the walk moves
// sum(steps) * L * 4 + scored * (d * 4 + 1) bytes for f32 rows, `scored`
// being the rows it read (returned per query); the visited bitmap is the
// walk's own scratch (a set of ids, in shared memory while it fits) and
// adds none; ranking in bf16,
// rows of d * 2 bytes plus the f32 re-score of the final beam (W rows).
// A single walk is a chain of
// dependent steps (ids -> flags -> rows -> merge), so it is also bound by
// latency: steps x the dependent round trip (ids -> rows, ~0.3 us on an
// H100 with K5's flags on chip; probes/k5_profile.py); throughput comes
// from many queries (blocks) in flight.
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
// K4's design (sm_90a, plain CUDA, no tensor cores):
// - 128 threads per block; the query, the double-buffered beam, the
//   neighbour list and the merge scratch live in shared memory (~3.5 KB at
//   W = 40, d = 128), so many blocks fit on an SM.
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
//   the other sorted list (merge path), so the beam stays sorted with no
//   full sort per step. Ties in (distance, key) keep beam before new, as
//   the JAX package's stable sort does.
// Measured: see PERF.md (K4 / K5 rows), timed by chip_smoke.py.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

// The library compiles this file four times, side by side (ops/_build.py):
// PGV_K4_PART=1 holds the bf16 ranking's kernels and their launches, 2 the
// other walks' modes (beam_walk_var_kernel), 3 the word walk's modes
// (word_walk_modes_kernel), 0 the rest, whose dispatch reaches the others
// through pgv_k4_rank_walk, pgv_k4_rank_scan, pgv_k4_var_walk and
// pgv_k4_word_walk; without the macro (the probes' builds) it is one unit
// with all.
#if !defined(PGV_K4_PART) || PGV_K4_PART == 0
#define PGV_K4_BASE
#endif
#if !defined(PGV_K4_PART) || PGV_K4_PART == 1
#define PGV_K4_RANKED
#endif
#if !defined(PGV_K4_PART) || PGV_K4_PART == 2
#define PGV_K4_MODES
#endif
#if !defined(PGV_K4_PART) || PGV_K4_PART == 3
#define PGV_K4_WORDS
#endif
// args: the WalkArgs / ScanArgs below; stream: a cudaStream_t
int pgv_k4_rank_walk(const void* args, int b, size_t smem, void* stream);
// dtype: the row type's code (pgv_k4_beam_walk's); v: its chunk width
int pgv_k4_var_walk(const void* args, int dtype, int v, int b, size_t smem,
                    void* stream);
int pgv_k4_rank_scan(const void* args, int metric, int b, size_t smem,
                     void* stream);
// v: the word rows' chunk width (4 or 1)
int pgv_k4_word_walk(const void* args, int v, int b, void* stream);

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerWarp = 4;  // rows a warp scores with loads in flight
constexpr unsigned kFull = 0xffffffffu;
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory limit

// The timing probes (probes/k5_profile.py, probes/k4_words_profile.py)
// build this file with -DPGV_K5_PROFILE: thread 0 of every block (K5's
// scan blocks, K4's walk blocks) then adds the SM clocks it spends in each
// phase of the walk to a device buffer (pgv_k5_profile). Slots: the
// phases below, then steps, clocks of the whole block, its globaltimer
// nanoseconds and the blocks counted.
enum K5Phase {
  kPhSelect, kPhIds, kPhFlags, kPhRows, kPhDedup, kPhSort, kPhBeamMerge,
  kPhSpillMerge, kPhStart, kPhFinish, kPhSteps, kPhClocks, kPhNs,
  kPhBlocks, kPhSlots
};
#ifdef PGV_K5_PROFILE
__device__ unsigned long long* g_k5_prof;
__device__ __forceinline__ unsigned long long k5_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define K5_PROF_BEGIN                                                  \
  unsigned long long k5_acc[kPhSlots] = {}, k5_t0 = clock64(),        \
                     k5_t = k5_t0, k5_n0 = k5_ns();
#define K5_MARK(ph)                                                    \
  do {                                                                 \
    if (threadIdx.x == 0) {                                            \
      const unsigned long long t_ = clock64();                         \
      k5_acc[ph] += t_ - k5_t;                                         \
      k5_t = t_;                                                       \
    }                                                                  \
  } while (0)
#define K5_PROF_END(steps)                                             \
  do {                                                                 \
    if (threadIdx.x == 0 && g_k5_prof != nullptr) {                    \
      k5_acc[kPhSteps] = (steps);                                      \
      k5_acc[kPhClocks] = clock64() - k5_t0;                           \
      k5_acc[kPhNs] = k5_ns() - k5_n0;                                 \
      k5_acc[kPhBlocks] = 1;                                           \
      for (int i_ = 0; i_ < kPhSlots; ++i_)                            \
        atomicAdd(g_k5_prof + i_, k5_acc[i_]);                         \
    }                                                                  \
  } while (0)
#else
#define K5_PROF_BEGIN
#define K5_MARK(ph) \
  do {              \
  } while (0)
#define K5_PROF_END(steps) \
  do {                     \
  } while (0)
#endif

struct WalkArgs {
  const void* values;     // [>= cap + 1, d] rows, row stride `stride`
  const void* values2;    // sparse rows: their [>= cap + 1, d] f32 values
  long long stride;       // elements between consecutive rows
  const int* nbrs;        // [cap + 1, L] layer-0 ids (-1 pad)
  const uint8_t* trav;    // [cap + 1] live rows
  const float* q;         // [b, d]
  const int* seed_ids;    // [b, S] (-1 = unused)
  const float* seed_d;    // [b, S]
  float* beam_d;          // [b, W]
  int* beam_key;          // [b, W]
  int* steps;             // [b]
  int* scored;            // [b] rows scored
  int d, qd, L, cap, metric, S, W, max_steps;  // qd: query words
  // The greedy upper-layer descent in the launch (upper_slot != null):
  // upper_slot [cap + 1] (-1: no upper row), upper [U, ustride] the upper
  // layers' neighbour ids (layer l's m at (l - 1) m, -1 pad), the entry
  // and its level; the walk is then seeded by where each query lands
  // (seed_ids / seed_d unread, S = 1), and land [b, 4] receives the
  // landing id, its distance's bits, the rows the descent scored and its
  // moves.
  const int* upper_slot;
  const int* upper;
  long long ustride;
  int m, entry, entry_level;
  int* land;
  // The beam's variants (JAX's PGV_BEAM_*): E members expanded a step;
  // vis [b, vwords] zeroed visited bitmaps, left zero by the walk (null:
  // the in-beam dedup); with
  // `exact` given (bf16 ranking), `values` are the bf16 rows that rank and
  // `exact` [>= cap + 1, d] the f32 rows (row stride exact_stride) the
  // surviving beam is re-scored from.
  int E;
  unsigned* vis;
  int vwords;
  const void* exact;
  long long exact_stride;
};

// The most new entries a step takes (E * L): the rank sort and the merges
// are sized for it (ops/beam.MAX_NEW).
constexpr int kMaxNew = 256;

// The sparse-row mode's row type (indices in `values`, values in
// `values2`).
struct SparseRow {};
constexpr int kPadIndex = 0x7fffffff;

__device__ __forceinline__ float inf_f() { return __int_as_float(0x7f800000); }

// The walk's total order: by distance, then by key.
__device__ __forceinline__ bool before(float da, int ka, float db, int kb) {
  return da < db || (da == db && ka < kb);
}

// The same order as one 64-bit key (k >= 0): the float's order-preserving
// bits (-0.0 made +0.0 first, as `before` ties them), then k.
__device__ __forceinline__ unsigned long long rank_key(float d, int k) {
  unsigned u = __float_as_uint(__fadd_rn(d, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(k);
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
  __device__ static void unpack_words(const uint4& v, float* out) {
    const __half2* h = reinterpret_cast<const __half2*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void run(const __half* row, int c, float* out) {
    unpack_words(__ldg(reinterpret_cast<const uint4*>(row) + c), out);
  }
};
template <>
struct Load<__nv_bfloat16, 8> {
  __device__ static void unpack_words(const uint4& v, float* out) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      out[2 * i] = f.x;
      out[2 * i + 1] = f.y;
    }
  }
  __device__ static void run(const __nv_bfloat16* row, int c, float* out) {
    unpack_words(__ldg(reinterpret_cast<const uint4*>(row) + c), out);
  }
};

// The same V values as Load's, in two halves: `raw` loads them as stored
// (one 16-byte vector where V > 1), `unpack` makes them f32. A loop that
// keeps many loads in flight holds 4 registers a load, whatever the type.
template <typename T, int V>
struct Raw;
template <typename T>
struct Raw<T, 1> {
  using type = T;
  __device__ static type load(const T* row, int c) { return row[c]; }
  __device__ static void unpack(const type& r, float* out) {
    out[0] = to_f(r);
  }
};
template <>
struct Raw<float, 4> {
  using type = float4;
  __device__ static type load(const float* row, int c) {
    return __ldg(reinterpret_cast<const float4*>(row) + c);
  }
  __device__ static void unpack(const type& r, float* out) {
    out[0] = r.x;
    out[1] = r.y;
    out[2] = r.z;
    out[3] = r.w;
  }
};
template <typename T>
struct Raw16 {  // 8 f16 or bf16 values
  using type = uint4;
  __device__ static type load(const T* row, int c) {
    return __ldg(reinterpret_cast<const uint4*>(row) + c);
  }
  __device__ static void unpack(const type& r, float* out) {
    Load<T, 8>::unpack_words(r, out);
  }
};
template <>
struct Raw<__half, 8> : Raw16<__half> {};
template <>
struct Raw<__nv_bfloat16, 8> : Raw16<__nv_bfloat16> {};

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

// out[j] = distance from the query (qs, in shared memory) to row ids[j] of
// `values` (row stride `stride`, d values) for the valid j < count, +inf
// for the others. Each of the group's NW warps takes kRowsPerWarp rows
// at a time; the lanes stride over the row's V-wide chunks.
template <typename T, int V, int M, int NW>
__device__ void score_rows(const T* values, long long stride, int d,
                           const float* qs, const int* ids,
                           const uint8_t* valid, float* out, int count,
                           int warp, int lane) {
  const int nchunks = d / V;
  for (int base = warp * kRowsPerWarp; base < count;
       base += NW * kRowsPerWarp) {
    float acc[kRowsPerWarp];
    const T* rows[kRowsPerWarp];
    bool use[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = base + r;
      use[r] = j < count && valid[j];
      rows[r] = values + (use[r] ? static_cast<long long>(ids[j]) * stride
                                 : 0LL);
      acc[r] = 0;
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
      if (lane == 0 && base + r < count)
        out[base + r] = use[r] ? finish<M>(s) : inf_f();
    }
  }
}

// ---- The bf16 ranking (JAX's PGV_BEAM_BF16, _dist_ids_rank: the bf16
// rows against the query rounded to bf16). Its terms: l2 the f32 square
// t * t of t = bf16(x - q), ip and cosine the product bf16(x * q), each
// the exact result rounded once to bf16 (RN). sm_90's packed bf16
// instructions make two terms at once from the raw 32-bit words of a row
// and of the query (kept as bf16 in shared memory), so a term costs no
// conversion instruction. A term has an 8-bit significand (l2: 16 bits, so
// t * t is exact in f32 for |t| >= 2^-63), and the terms are summed
// exactly and the sum rounded once to f32: each f32 term enters the sum as
// an f64 of 2^-896 times its value (the f32 bits moved into the f64's
// place, two integer instructions: no conversion), the f64 sums are exact
// while the terms' bits span less than the f64 significand's 53, and the
// one f32 rounding is of the sum times 2^896. So any lane and tree order
// gives the same f32 (ops/beam.rank_dists, the plain version, sums the
// same f32 terms in f64 in another order).
//
// Lanes: a row is read in chunks that keep all 32 lanes busy (rank_width:
// 16-byte chunks of 8 values from d = 256 up, 8-byte chunks of 4 below, so
// a 128-d row takes every lane once; scalar values where the rows or d
// allow neither); R rows' loads in flight per warp, and a transposed
// reduction leaves lane l with row l / (32 / R)'s sum.

__device__ __forceinline__ unsigned bf16x2_sub(unsigned a, unsigned b) {
  unsigned r;
  asm("sub.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

__device__ __forceinline__ unsigned bf16x2_mul(unsigned a, unsigned b) {
  unsigned r;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
  return r;
}

// The two bf16 ranking values of the pairs x and q (l2: differences; ip,
// cosine: products), as packed bf16.
template <int M>
__device__ __forceinline__ unsigned rank_pair(unsigned x, unsigned q) {
  return M == 0 ? bf16x2_sub(x, q) : bf16x2_mul(x, q);
}

#ifdef PGV_RANK_F32_SUMS
// probes/k4_compare.py --rank's timing build: the same terms summed in f32
// (another function: its sums depend on the order)
using RankAcc = float;
__device__ __forceinline__ void rank_add(RankAcc& acc, float t) { acc += t; }
__device__ __forceinline__ float rank_sum(RankAcc s) { return s; }
#else
using RankAcc = double;
// acc += t * 2^-896, exactly (the f32 bits of t shifted into an f64's)
__device__ __forceinline__ void rank_add(RankAcc& acc, float t) {
  const unsigned w = __float_as_uint(t);
  acc += __hiloint2double(
      static_cast<int>((w & 0x80000000u) | ((w & 0x7fffffffu) >> 3)),
      static_cast<int>(w << 29));
}
__device__ __forceinline__ float rank_sum(RankAcc s) {
  return static_cast<float>(s * 0x1p896);
}
#endif

// acc += the terms of the packed ranking values p (low half first)
template <int M>
__device__ __forceinline__ void rank_terms(RankAcc& acc, unsigned p,
                                           bool both) {
  const float lo = __uint_as_float(p << 16);
  rank_add(acc, M == 0 ? lo * lo : lo);
  if (both) {
    const float hi = __uint_as_float(p & 0xffff0000u);
    rank_add(acc, M == 0 ? hi * hi : hi);
  }
}

// A row's V values at chunk c, as stored (V = 8: one 16-byte load, V = 4:
// one 8-byte load), and the query's from shared memory.
template <int V>
struct RankChunk;
template <>
struct RankChunk<8> {
  using type = uint4;
  __device__ static type row(const __nv_bfloat16* r, int c) {
    return __ldg(reinterpret_cast<const uint4*>(r) + c);
  }
  __device__ static type query(const __nv_bfloat16* q, int c) {
    return reinterpret_cast<const uint4*>(q)[c];
  }
  template <int M>
  __device__ static void add(RankAcc& acc, const type& x, const type& q) {
    rank_terms<M>(acc, rank_pair<M>(x.x, q.x), true);
    rank_terms<M>(acc, rank_pair<M>(x.y, q.y), true);
    rank_terms<M>(acc, rank_pair<M>(x.z, q.z), true);
    rank_terms<M>(acc, rank_pair<M>(x.w, q.w), true);
  }
};
template <>
struct RankChunk<4> {
  using type = uint2;
  __device__ static type row(const __nv_bfloat16* r, int c) {
    return __ldg(reinterpret_cast<const uint2*>(r) + c);
  }
  __device__ static type query(const __nv_bfloat16* q, int c) {
    return reinterpret_cast<const uint2*>(q)[c];
  }
  template <int M>
  __device__ static void add(RankAcc& acc, const type& x, const type& q) {
    rank_terms<M>(acc, rank_pair<M>(x.x, q.x), true);
    rank_terms<M>(acc, rank_pair<M>(x.y, q.y), true);
  }
};
template <>
struct RankChunk<1> {
  using type = unsigned;
  __device__ static type row(const __nv_bfloat16* r, int c) {
    return __ldg(reinterpret_cast<const unsigned short*>(r) + c);
  }
  __device__ static type query(const __nv_bfloat16* q, int c) {
    return reinterpret_cast<const unsigned short*>(q)[c];
  }
  template <int M>
  __device__ static void add(RankAcc& acc, type x, type q) {
    rank_terms<M>(acc, rank_pair<M>(x, q), false);
  }
};

// Sums a[0, R) of each lane over the warp, transposed: each exchange halves
// the values a lane holds, so lane l ends with the sum of a[l / (32 / R)]
// (R = 8: 9 exchanges, not 40).
template <int R, typename Acc>
__device__ __forceinline__ Acc transposed_sum(Acc (&a)[R], int lane) {
  int o = 16;
#pragma unroll
  for (int n = R; n > 1; n >>= 1, o >>= 1) {
    const bool up = lane & o;
#pragma unroll
    for (int i = 0; i < n / 2; ++i)
      a[i] = (up ? a[i + n / 2] : a[i]) +
             __shfl_xor_sync(kFull, up ? a[i] : a[i + n / 2], o);
  }
  Acc s = a[0];
#pragma unroll
  for (; o; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

// The bf16 ranking distances' sums of R rows (R = 8 or 16; lanes r < R
// hold the ids in v, okm bit r: row r valid) against the query qb (bf16,
// shared memory): lane l returns row l / (32 / R)'s sum.
template <int R, int V, int M>
__device__ __forceinline__ float score_rank(const __nv_bfloat16* values,
                                            long long stride, int d,
                                            const __nv_bfloat16* qb, int v,
                                            unsigned okm, int lane) {
  using C = RankChunk<V>;
  RankAcc acc[R];
  const __nv_bfloat16* rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int id = __shfl_sync(kFull, v, r);
    rows[r] = values + (((okm >> r) & 1u) ? static_cast<long long>(id) *
                                                stride
                                          : 0LL);
    acc[r] = 0;
  }
  const int nchunks = d / V;
  for (int c = lane; c < nchunks; c += 32) {
    const typename C::type qv = C::query(qb, c);
    typename C::type x[R];  // the R loads in flight
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((okm >> r) & 1u) x[r] = C::row(rows[r], c);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((okm >> r) & 1u) C::template add<M>(acc[r], x[r], qv);
  }
  return rank_sum(transposed_sum<R>(acc, lane));
}

// K4's bf16 ranking: out[j] = the ranking distance to row ids[j] for the
// valid j < count, +inf for the others; each of the NW warps scores 8 rows
// at a time (a step's 32 neighbours: one round trip per warp).
template <int V, int M, int NW>
__device__ void score_rows_rank(const __nv_bfloat16* values, long long stride,
                                int d, const __nv_bfloat16* qb,
                                const int* ids, const uint8_t* valid,
                                float* out, int count, int warp, int lane) {
  for (int base = warp * 8; base < count; base += NW * 8) {
    const int j = base + lane;
    const bool ok = lane < 8 && j < count && valid[j];
    const unsigned okm = __ballot_sync(kFull, ok);
    const float sum = score_rank<8, V, M>(values, stride, d, qb,
                                          ok ? ids[j] : 0, okm, lane);
    const int r = lane >> 2;  // the row whose sum this lane holds
    if ((lane & 3) == 0 && base + r < count)
      out[base + r] = ((okm >> r) & 1u) ? finish<M>(sum) : inf_f();
  }
}

// The bf16 rows' chunk width V (values a lane loads at once): 16-byte
// loads (V = 8) where a row has at least 32 of them, so every lane works,
// else 8-byte loads (V = 4), each needing the rows aligned to it (base and
// stride) and d a multiple of V; 1 otherwise. The f32 rows the beam is
// re-scored from take 16-byte loads where V > 1, so they must allow them.
inline int rank_width(const void* values, long long stride, int d,
                      const void* exact, long long exact_stride) {
  const uintptr_t v = reinterpret_cast<uintptr_t>(values);
  if (reinterpret_cast<uintptr_t>(exact) % 16 != 0 || exact_stride % 4 != 0)
    return 1;
  if (v % 16 == 0 && stride % 8 == 0 && d % 8 == 0 && d >= 8 * 32) return 8;
  return v % 8 == 0 && stride % 4 == 0 && d % 4 == 0 ? 4 : 1;
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
// (JACC = 1) from the query words qs to row ids[j] (j < count), +inf where
// not valid. A warp works in groups of `lpr` lanes, one row per group; a
// group's lanes stride over the row's V-word chunks.
template <int V, int JACC, int NW>
__device__ void score_words(const WalkArgs& a, const unsigned* qs,
                            float qpop, const int* ids, const uint8_t* valid,
                            float* out, int count, int warp, int lane) {
  using C = WordChunk<V>;
  using T = typename C::T;
  const unsigned* words = static_cast<const unsigned*>(a.values);
  const int nchunks = a.d / V;
  int lpr = 1;
  while (lpr < nchunks && lpr < 32) lpr <<= 1;
  const int rpw = 32 / lpr;
  const int sub = lane / lpr, sl = lane % lpr;
  for (int base = warp * rpw; base < count; base += NW * rpw) {
    const int j = base + sub;
    const bool use = j < count && valid[j];
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
    if (sl == 0 && j < count) {
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
// to padded-CSR row ids[j] (j < count), +inf where not valid. Each of the
// group's NW warps takes kRowsPerWarp rows at a time; the lanes stride over
// the row's entries and look each up in the query's indices; a shuffle
// reduction per row.
template <int M, int NW>
__device__ void score_sparse(const WalkArgs& a, const int* qidx,
                             const float* qval, const SparseQuery& sq,
                             const int* ids, const uint8_t* valid, float* out,
                             int count, int warp, int lane) {
  const int* ind = static_cast<const int*>(a.values);
  const float* val = static_cast<const float*>(a.values2);
  for (int base = warp * kRowsPerWarp; base < count;
       base += NW * kRowsPerWarp) {
    float dot[kRowsPerWarp], csq[kRowsPerWarp], cabs[kRowsPerWarp],
        corr[kRowsPerWarp];
    long long off[kRowsPerWarp];
    bool use[kRowsPerWarp];
#pragma unroll
    for (int r = 0; r < kRowsPerWarp; ++r) {
      const int j = base + r;
      use[r] = j < count && valid[j];
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
      if (lane == 0 && base + r < count) {
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

// The greedy descent through the upper layers, for one query (JAX's
// _greedy_descent, pgvector_rx_tpu/graph/device.py:386, as its
// _search_batch and _search_one_sparse run it from the entry): at each
// layer entry_level .. 1, the current node's m neighbours at that layer
// are scored where valid ((nbr >= 0) & (slot >= 0) & trav[min(nbr, cap)];
// +inf otherwise), and the query moves to the first slot of their minimum
// while it is strictly nearer. The entry's own distance is scored as it
// is (no flags), as JAX scores it.
//
// It runs on a group of threads (a block, or one warp): `score(count)`
// scores nid[0, count) by their nvalid flags into nd (the walk's own
// row-distance code; `score0` the entry's, exact where the walk ranks in
// bf16, as JAX scores it), `sync()` is the group's barrier, `rank` / `size` a
// thread's place in the group and its width; the group's first warp picks
// the minimum (bc: the group's broadcast slots). Every thread returns the
// landing (cur, cur_d), the rows the descent scored and its moves.
template <class Score0, class Score, class Sync>
__device__ void greedy_descent(const WalkArgs& a, int* nid, uint8_t* nvalid,
                               float* nd, int* bc, Score0 score0, Score score,
                               Sync sync, int rank, int size, int& cur,
                               float& cur_d, int& rows, int& moves) {
  if (rank == 0) {
    nid[0] = a.entry;
    nvalid[0] = 1;
  }
  sync();
  score0(1);
  sync();
  cur = a.entry;
  cur_d = nd[0];
  rows = 1;
  moves = 0;
  for (int layer = a.entry_level; layer >= 1; --layer) {
    const long long off = static_cast<long long>(layer - 1) * a.m;
    while (true) {
      const int slot = a.upper_slot[cur];
      for (int j = rank; j < a.m; j += size) {
        const int v = slot >= 0 ? a.upper[slot * a.ustride + off + j] : -1;
        nid[j] = v;
        nvalid[j] = v >= 0 && a.trav[min(v, a.cap)];
      }
      sync();
      score(a.m);
      sync();
      if (rank < 32) {  // the first minimum: strict <, lowest slot first
        float bd = inf_f();
        int bj = 0, cnt = 0;
        for (int j0 = 0; j0 < a.m; j0 += 32) {
          const int j = j0 + rank;
          const bool in = j < a.m;
          cnt += __popc(__ballot_sync(kFull, in && nvalid[j]));
          if (in && nd[j] < bd) {
            bd = nd[j];
            bj = j;
          }
        }
#pragma unroll
        for (int o = 16; o; o >>= 1) {
          const float od = __shfl_xor_sync(kFull, bd, o);
          const int oj = __shfl_xor_sync(kFull, bj, o);
          if (od < bd || (od == bd && oj < bj)) {
            bd = od;
            bj = oj;
          }
        }
        if (rank == 0) {
          bc[0] = bj;
          bc[1] = __float_as_int(bd);
          bc[2] = cnt;
        }
      }
      sync();
      const int bj = bc[0];
      const float bd = __int_as_float(bc[1]);
      rows += bc[2];
      if (!(bd < cur_d)) break;  // the same decision in every thread
      cur = nid[bj];
      cur_d = bd;
      ++moves;
      sync();  // every thread has read nid and bc before they change
    }
  }
}

// Open-addressing sets of ids (>= 0) in shared memory: 2^bits slots, -1
// empty, -2 an erased id (probing goes on past it), linear probing from a
// multiplicative hash.
__device__ __forceinline__ unsigned set_home(int id, int bits) {
  return (static_cast<unsigned>(id) * 2654435761u) >> (32 - bits);
}

// Insert id (any thread, concurrently); returns its slot. An id must not
// be inserted while it sits past an erased slot of its chain (the walk's
// set inserts only ids it lacks; the other sets erase nothing).
__device__ __forceinline__ int set_insert(int* tbl, int bits, int id) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned s = set_home(id, bits);; s = (s + 1u) & mask) {
    int v = tbl[s];
    while (v < 0) {  // free: claim it, or look again at what took it
      const int prev = atomicCAS(tbl + s, v, id);
      if (prev == v) return static_cast<int>(s);
      v = prev;
    }
    if (v == id) return static_cast<int>(s);
  }
}

// The slot of id, or -1 if the set lacks it.
__device__ __forceinline__ int set_find(const int* tbl, int bits, int id) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned s = set_home(id, bits);; s = (s + 1u) & mask) {
    const int v = tbl[s];
    if (v == id) return static_cast<int>(s);
    if (v == -1) return -1;
  }
}

// Insert id into a set that erases nothing (any thread, concurrently);
// true for exactly one of the threads that insert the same id: the one
// whose insert claimed its slot, which goes to *slot.
__device__ __forceinline__ bool set_claim(int* tbl, int bits, int id,
                                          int* slot) {
  const unsigned mask = (1u << bits) - 1u;
  for (unsigned s = set_home(id, bits);; s = (s + 1u) & mask) {
    int v = tbl[s];
    if (v == -1) {
      v = atomicCAS(tbl + s, -1, id);
      if (v == -1) {
        *slot = static_cast<int>(s);
        return true;
      }
    }
    if (v == id) return false;
  }
}

// The sums of R rows (the lanes r < R hold the ids in v; `okm` bit r: row r
// is valid) of `values` (row stride `stride`, d values) against the query
// qs: lane l returns row l / (32 / R)'s sum. Each lane's R loads are in
// flight together and kept as stored (4 registers a 16-byte load, whatever
// the type).
template <int R, typename T, int V, int M>
__device__ __forceinline__ float score_raw(const T* values, long long stride,
                                           int d, const float* qs, int v,
                                           unsigned okm, int lane) {
  float acc[R];
  const T* rows[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int id = __shfl_sync(kFull, v, r);
    rows[r] = values + (((okm >> r) & 1u) ? static_cast<long long>(id) *
                                                stride
                                          : 0LL);
    acc[r] = 0;
  }
  const int nchunks = d / V;
  for (int c = lane; c < nchunks; c += 32) {
    float qv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) qv[e] = qs[c * V + e];
    typename Raw<T, V>::type raw[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((okm >> r) & 1u) raw[r] = Raw<T, V>::load(rows[r], c);
#pragma unroll
    for (int r = 0; r < R; ++r)
      if ((okm >> r) & 1u) {
        float x[V];
        Raw<T, V>::unpack(raw[r], x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r] += term<M>(x[e], qv[e]);
      }
  }
  return transposed_sum<R>(acc, lane);
}

// The walk's order (distance, key) as one 64-bit key for any key k >= -2
// (an invalid slot's -2 included): the float's order-preserving bits (-0.0
// made +0.0, as `before` ties them), then k + 2.
__device__ __forceinline__ unsigned long long walk_key(float d, int k) {
  unsigned u = __float_as_uint(__fadd_rn(d, 0.0f));
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (static_cast<unsigned long long>(u) << 32) |
         static_cast<unsigned>(k + 2);
}

// log2 of the slots of the block walk's id sets (VAR): at least twice the
// n ids one holds, >= 64.
__host__ __device__ inline int var_set_bits(int n) {
  int bits = 6;
  while ((1 << bits) < 2 * n) ++bits;
  return bits;
}

// The expanded members a bitmap walk records for its clear once its ids
// go to the global bitmap (past this, it clears its whole bitmap instead).
constexpr int kRecMax = 256;
// A VAR walk's shared memory budget, so that 8 blocks (1,024 queries on
// 132 SMs) fit an SM: its visited set takes what the rest leaves, 1,024 to
// 4,096 slots.
constexpr size_t kVarBudget = 27648;
__host__ __device__ inline int var_rec_len(int max_steps, int E) {
  const long long n = static_cast<long long>(max_steps) * E;
  return n < kRecMax ? static_cast<int>(n) : kRecMax;
}

__host__ __device__ inline size_t smem_bytes(int qd, int L, int S, int W,
                                             int E, bool rank) {
  const size_t dpad = (static_cast<size_t>(qd) + 3) & ~static_cast<size_t>(3);
  const size_t nl = static_cast<size_t>(E) * L;
  // q (and its bf16 rounding when ranking in bf16); beam x2 (d, key); new
  // raw, new sorted (d, key); seeds (d, key); neighbour ids and dup flags;
  // neighbour live flags
  return 4 * (dpad * (rank ? 2 : 1) + 4 * static_cast<size_t>(W) + 4 * nl +
              2 * S + 2 * nl) +
         nl;
}

// The block walk's VAR scoring over dense rows: the F compacted ids cid,
// 8 rows a warp (32 a block) with their loads in flight together;
// nd[c] = the distance, nkey[c] = its rank key if it comes before lastkey
// (the beam's last entry's), else ~0 (it cannot enter the beam). RANK:
// the bf16 ranking's exact sums (score_rank) against qb.
template <typename T, int V, int M, bool RANK>
__device__ void var_score_rows(const WalkArgs& a, const float* qs,
                               const __nv_bfloat16* qb, const int* cid,
                               int F, float* nd, unsigned long long* nkey,
                               unsigned long long lastkey, int warp,
                               int lane) {
  const T* vals = static_cast<const T*>(a.values);
  for (int g0 = warp * 8; g0 < F; g0 += kWarps * 8) {
    const int c = g0 + (lane & 7);
    const bool ok = lane < 8 && c < F;
    const int v = ok ? cid[c] : 0;
    const unsigned okm = __ballot_sync(kFull, ok);
    float sum;
    if constexpr (RANK)
      sum = score_rank<8, V, M>(vals, a.stride, a.d, qb, v, okm, lane);
    else
      sum = score_raw<8, T, V, M>(vals, a.stride, a.d, qs, v, okm, lane);
    const int r = lane >> 2;  // the row whose sum this lane holds
    const int vr = __shfl_sync(kFull, v, r);
    if ((lane & 3) == 0 && g0 + r < F) {
      const float dd = finish<M>(sum);
      const unsigned long long kk = walk_key(dd, 2 * vr + 1);
      nd[g0 + r] = dd;
      nkey[g0 + r] = kk < lastkey ? kk : ~0ull;
    }
  }
}

// Where the block walk's VAR arrays start (after smem_bytes', 16-byte
// aligned), and their bytes: the candidates' 64-bit rank keys (E L + 2),
// the next members and the beam's first E unexpanded members (E each), the
// step's id set (E > 1), and the beam's two id sets (no bitmap) or the
// recorded members (the bitmap's clear).
__host__ __device__ inline size_t var_smem_offset(int qd, int L, int S,
                                                  int W, int E, bool rank) {
  return (smem_bytes(qd, L, S, W, E, rank) + 15) & ~static_cast<size_t>(15);
}

__host__ __device__ inline size_t var_smem_bytes(int L, int W, int E,
                                                 bool vis, int max_steps) {
  const size_t nl = static_cast<size_t>(E) * L;
  const size_t step_set = E > 1 ? size_t{1} << var_set_bits(E * L) : 0;
  const size_t beam_sets = vis ? 0 : size_t{2} << var_set_bits(W);
  return 8 * (nl + 2) +
         4 * (2 * static_cast<size_t>(E) + step_set + beam_sets +
              (vis ? var_rec_len(max_steps, E) : 0));
}

// log2 of the slots of a bitmap walk's visited set in shared memory, which
// follows the `before` bytes of the rest: the most (4,096 at most, 1,024
// at least) that keep the block within kVarBudget.
__host__ __device__ inline int var_vis_bits(size_t before) {
  int bits = 12;
  while (bits > 10 && before + (size_t{4} << bits) > kVarBudget) --bits;
  return bits;
}

// The block walk, for one query (block): its kernels, beam_walk_kernel and
// the bf16 ranking's beam_walk_rank_kernel, are below. DESC: the greedy
// descent seeds the walk (upper_slot given); a separate instantiation, so
// that the seeded walk (the dense beam engine's) keeps the registers and
// the code it had without it. RANK: the bf16 ranking (T is bf16; the beam
// is re-scored from `exact` at the end). VAR: E and the visited bitmap are
// read from the arguments; without it E = 1 and no bitmap, at compile
// time, so the default walk keeps its registers.
//
// The variants, as JAX's _ground_beam_seeds runs them:
// - E > 1: a step pops the first E unexpanded members of the beam's order
//   (lax.top_k: the E nearest, lower slot first at equal distance), marks
//   them expanded and takes their E L neighbours in that order; a repeat
//   of an id earlier among them is masked (the first copy kept), and the
//   merge takes E L new entries (E L <= kMaxNew).
// - vis: a neighbour whose bit is set is masked, every neighbour id >= 0
//   then sets its bit (live or not; the seeds' at the start), and the
//   in-beam dedup is skipped (with E = 1 a repeat within one list stays,
//   as in JAX). A walk sees ~1,000-1,500 ids at ef = 40, but could see
//   S + max_steps E L (24,584 at E = 4): the ids go to a visited set in
//   shared memory (what kVarBudget leaves, 1,024-4,096 slots) while it is
//   at most half full, then to a global bitmap, one per query ((cap + 1) /
//   32 words), whose word a test then reads beside the live flag (no
//   dependent round trip). The caller hands the global bitmap zeroed and
//   gets it back zeroed: once a walk uses it, it records the members it
//   expands (at most kRecMax) and, before it ends, stores 0 to the word of
//   every id it set there (their neighbours', its seeds' if they went
//   there), or clears its whole bitmap past kRecMax; no launch pays a
//   (cap + 1) / 8-byte clear a query.
// - RANK: new candidates are ranked over the bf16 rows against the query
//   rounded to bf16 (score_rows_rank: 8 rows a warp, every lane busy, the
//   exact sums of the bf16 ranking's terms), the descent too but for the
//   entry; the surviving beam's entries with an id are re-scored in f32
//   at the end (16-byte loads; the wrapper sorts by (distance, id)).
//
// VAR's step (E > 1 or the bitmap) is laid out for its latency, over every
// warp, as K5's E > 1 step is (beam_scan_kernel):
// - the E L ids of the step were loaded during the last merge (two a
//   thread);
// - each id's flags (live; past the visited set, the bitmap's word) load
//   together; the step's first copy of an id is claimed in a shared-memory
//   step set (E > 1: every copy has the same row, distance and key, so
//   which one goes on does not matter), and those are the rows scored
//   (the bitmap: those not in the visited set either); without the bitmap,
//   an id already in the beam (the beam's own id set, kept by the merge)
//   needs no row: its copy sits at (inf, key). Only the fresh ids are
//   compacted and their rows loaded, 8 a warp at once (var_score_rows);
// - an entry that cannot come before the beam's last entry cannot enter
//   the beam and is not ranked; the others are ranked by every thread at
//   once, counting the 64-bit (distance, key) keys below its own
//   (walk_key). While the beam's last entry is at an infinite distance,
//   the copies and masked entries that come before it are ranked too (as
//   (inf, key) and (inf, -2)), so the raw beam is the plain walk's;
// - the next step's E members are found before the merge by a merge path
//   of the beam's first E unexpanded members and the ranked entries, so
//   their ids load while the merge runs. Five block barriers a step.
// The default walk (E = 1, no bitmap) keeps its own step below.
template <typename T, int V, bool DESC, bool RANK, bool VAR,
          bool VIS = false>
__device__ __forceinline__ void beam_walk(const WalkArgs& a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps];
  __shared__ int s_nsel;
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, L = a.L, S = a.S, E = VAR ? a.E : 1, NL = E * L;
  const float inf = inf_f();
  const int qpad = (a.qd + 3) & ~3;

  float* qs = reinterpret_cast<float*>(smem);
  // RANK: the query rounded to bf16, after the f32 one
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(qs + qpad);
  float* bd = qs + (RANK ? 2 : 1) * qpad;  // beam distances, 2 buffers of W
  int* bk = reinterpret_cast<int*>(bd + 2 * W);
  float* nd = reinterpret_cast<float*>(bk + 2 * W);  // new, in list order
  int* nk = reinterpret_cast<int*>(nd + NL);
  float* sd = reinterpret_cast<float*>(nk + NL);  // new, sorted
  int* sk = reinterpret_cast<int*>(sd + NL);
  float* xd = reinterpret_cast<float*>(sk + NL);  // seeds
  int* xk = reinterpret_cast<int*>(xd + S);
  int* nid = xk + S;  // neighbour ids
  int* dup = nid + NL;  // neighbour already in the beam / the list
  uint8_t* nvalid = reinterpret_cast<uint8_t*>(dup + NL);
  unsigned* vis =
      VIS ? a.vis + static_cast<long long>(b) * a.vwords : nullptr;

  // the query's bits, as they are (f32 values, packed words, or sparse
  // indices then value bits)
  const int* qg = reinterpret_cast<const int*>(a.q) +
                  static_cast<long long>(b) * a.qd;
  for (int i = tid; i < a.qd; i += kThreads) {
    reinterpret_cast<int*>(qs)[i] = qg[i];
    if (RANK) qb[i] = __float2bfloat16_rn(__int_as_float(qg[i]));
  }
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

  // nd[j] = the distance to row nid[j], j < count (+inf where !nvalid[j]):
  // the walk's ranking distance
  auto score = [&](int count) {
    if constexpr (kWords) {
      const unsigned* qw = reinterpret_cast<const unsigned*>(qs);
      if (a.metric == 5)
        score_words<V, 1, kWarps>(a, qw, qpop, nid, nvalid, nd, count, warp,
                                  lane);
      else
        score_words<V, 0, kWarps>(a, qw, qpop, nid, nvalid, nd, count, warp,
                                  lane);
    } else if constexpr (kSparse) {
      switch (a.metric) {
        case 0: score_sparse<0, kWarps>(a, qidx, qval, sq, nid, nvalid, nd, count, warp, lane); break;
        case 1: score_sparse<1, kWarps>(a, qidx, qval, sq, nid, nvalid, nd, count, warp, lane); break;
        case 2: score_sparse<2, kWarps>(a, qidx, qval, sq, nid, nvalid, nd, count, warp, lane); break;
        default: score_sparse<3, kWarps>(a, qidx, qval, sq, nid, nvalid, nd, count, warp, lane); break;
      }
    } else if constexpr (RANK) {
      const T* v = static_cast<const T*>(a.values);
      switch (a.metric) {
        case 0: score_rows_rank<V, 0, kWarps>(v, a.stride, a.d, qb, nid, nvalid, nd, count, warp, lane); break;
        case 1: score_rows_rank<V, 1, kWarps>(v, a.stride, a.d, qb, nid, nvalid, nd, count, warp, lane); break;
        default: score_rows_rank<V, 2, kWarps>(v, a.stride, a.d, qb, nid, nvalid, nd, count, warp, lane); break;
      }
    } else {
      const T* v = static_cast<const T*>(a.values);
      switch (a.metric) {
        case 0: score_rows<T, V, 0, kWarps>(v, a.stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
        case 1: score_rows<T, V, 1, kWarps>(v, a.stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
        case 2: score_rows<T, V, 2, kWarps>(v, a.stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
        default: score_rows<T, V, 3, kWarps>(v, a.stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
      }
    }
  };
  // the exact f32 distances (RANK: the entry's, and the final re-score;
  // 16-byte loads where the bf16 rows take vector loads: rank_width)
  auto score_exact = [&](int count) {
    if constexpr (RANK) {
      constexpr int VE = V > 1 ? 4 : 1;
      const float* v = static_cast<const float*>(a.exact);
      switch (a.metric) {
        case 0: score_rows<float, VE, 0, kWarps>(v, a.exact_stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
        case 1: score_rows<float, VE, 1, kWarps>(v, a.exact_stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
        default: score_rows<float, VE, 2, kWarps>(v, a.exact_stride, a.d, qs, nid, nvalid, nd, count, warp, lane); break;
      }
    } else {
      score(count);
    }
  };
  K5_PROF_BEGIN

  // ---- the greedy descent (DESC): the walk's one seed
  int land_id = -1;
  float land_d = inf;
  if constexpr (DESC) {
    __shared__ int bc[3];
    int rows = 0, moves = 0;
    if (a.entry >= 0)
      greedy_descent(a, nid, nvalid, nd, bc, score_exact, score,
                     [] { __syncthreads(); }, tid, kThreads, land_id, land_d,
                     rows, moves);
    if (tid == 0) {
      int* o = a.land + 4LL * b;
      o[0] = land_id;
      o[1] = __float_as_int(land_d);
      o[2] = rows;
      o[3] = moves;
    }
  }

  // ---- seeds: dedup by id, sort into the beam
  const long long s0 = static_cast<long long>(b) * S;
  for (int i = tid; i < S; i += kThreads) {
    const int id = DESC ? land_id : a.seed_ids[s0 + i];
    const bool ok = id >= 0;
    xd[i] = ok ? (DESC ? land_d : a.seed_d[s0 + i]) : inf;
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
    bd[r] = xd[i];  // r < S <= W
    bk[r] = xk[i];
  }
  for (int r = S + tid; r < W; r += kThreads) {
    bd[r] = inf;
    bk[r] = -2;
  }
  __syncthreads();

  K5_MARK(kPhStart);
  int cur = 0, steps = 0, scored = 0;
  if constexpr (VAR) {
    // ---- the modes' step (E > 1, the visited bitmap); see above
    __shared__ int red5[kWarps][5], kept2[kWarps][2];
    __shared__ int s_scored;
    unsigned char* xr = smem + var_smem_offset(a.qd, L, S, W, E, RANK);
    unsigned long long* nkey = reinterpret_cast<unsigned long long*>(xr);
    int* vsel = reinterpret_cast<int*>(nkey + NL + 2);  // the members
    int* au = vsel + E;  // the beam's first E unexpanded members
    const int bits_s = var_set_bits(NL), bits_b = var_set_bits(W);
    int* fk = au + E;  // the step's id set (E > 1)
    int* tb = fk + (E > 1 ? 1 << bits_s : 0);  // the beam's, x2 (no bitmap)
    int* rec = tb;  // the expanded members' rows (bitmap)
    const int tbl_b = 1 << bits_b;
    const int rlen = var_rec_len(a.max_steps, E);
    // the bitmap's ids go to a visited set in shared memory while it is at
    // most half full (nv: at most the ids it holds), then to the global
    // bitmap (ovf); a test reads both
    const size_t vs_at = var_smem_offset(a.qd, L, S, W, E, RANK) +
                         var_smem_bytes(L, W, E, true, a.max_steps);
    const int bits_v = var_vis_bits(vs_at);
    int* vt = reinterpret_cast<int*>(smem + vs_at);
    const int cap_v = 1 << (bits_v - 1);
    bool ovf = VIS && W > cap_v;
    const bool seeds_global = ovf;
    int nv = W;  // the ids the set holds, at most
    const unsigned lt = (1u << lane) - 1u;
    int* cid = nid;  // the step's fresh ids, compacted
    if (E > 1)
      for (int i = tid; i < (1 << bits_s); i += kThreads) fk[i] = -1;
    if (!VIS)
      for (int i = tid; i < 2 * tbl_b; i += kThreads) tb[i] = -1;
    else
      for (int i = tid; i < (1 << bits_v); i += kThreads) vt[i] = -1;
    if (tid == 0) s_scored = 0;
    __syncthreads();
    for (int i = tid; i < W; i += kThreads) {  // the seeds' ids
      const int id = bk[i] >> 1;
      if (bk[i] < 0) continue;
      if (!VIS)
        set_insert(tb, bits_b, id);
      else if (ovf)
        atomicOr(vis + (id >> 5), 1u << (id & 31));
      else
        set_insert(vt, bits_v, id);
    }
    if (warp == 0) {  // the first members: the seeds' beam's first E
      int got = 0;
      for (int base = 0; base < W && got < E; base += 32) {
        const int i = base + lane;
        const unsigned mk =
            __ballot_sync(kFull, i < W && (bk[i] & 1) && bd[i] < inf);
        const int r = got + __popc(mk & lt);
        if (((mk >> lane) & 1u) && r < E) vsel[r] = i;
        got = min(E, got + __popc(mk));
      }
      if (lane == 0) s_nsel = got;
    }
    __syncthreads();
    int nsel = s_nsel;
    bool go = nsel > 0 && a.max_steps > 0 && bd[vsel[0]] <= bd[W - 1];
    // thread t loads the ids of new entries j = t + 128 s (s = 0, 1; E L
    // <= 256): slot jo[s] of member jm[s] (INT_MAX past E L)
    int jm[2], jo[2], pid[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = tid + s * kThreads;
      jm[s] = j < NL ? j / L : INT_MAX;
      jo[s] = j < NL ? j - jm[s] * L : 0;
      pid[s] = go && jm[s] < nsel
                   ? a.nbrs[static_cast<long long>(
                                min(bk[vsel[jm[s]]] >> 1, a.cap)) * L +
                            jo[s]]
                   : -1;
    }
    int nrec = 0, scored_w = 0;
    K5_MARK(kPhStart);
    while (go) {
      float* cbd = bd + cur * W;
      int* cbk = bk + cur * W;
      float* obd = bd + (cur ^ 1) * W;
      int* obk = bk + (cur ^ 1) * W;
      int* tcur = tb + cur * tbl_b;
      int* tnext = tb + (cur ^ 1) * tbl_b;
      // the same decision in every thread: the step's ids could fill the
      // set past half
      if (VIS && !ovf) ovf = nv + NL > cap_v;
      if (tid < nsel) {  // expanded; read after the next barrier
        const int k = cbk[vsel[tid]];
        if (ovf && nrec + tid < rlen) rec[nrec + tid] = min(k >> 1, a.cap);
        cbk[vsel[tid]] = k & ~1;
      }
      if (ovf) nrec += nsel;
      // (A) each prefetched id's flags: live, not visited (bitmap), the
      // step's first copy (E > 1: claimed in the step set); those are the
      // rows scored. Fresh: not in the beam too (no bitmap: the beam's id
      // set), so only their rows load. While the beam's last entry is at
      // an infinite distance (it has room), an entry that needs no row
      // (an in-beam copy at (inf, key), a masked one at (inf, -2)) may
      // still enter before it: such an extra is ranked too.
      const bool loose = !(cbd[W - 1] < inf);
      const int lastk = loose ? cbk[W - 1] : -2;  // a member is finite
      bool fresh[2], extra[2], live[2];
      int xkey[2], slot[2] = {-1, -1};
      unsigned bf[2], bx[2], word[2], nids = 0;
#pragma unroll
      for (int s = 0; s < 2; ++s) {  // both ids' flags load at once
        const int v = pid[s];
        live[s] = v >= 0 && a.trav[min(v, a.cap)];
        word[s] = ovf && v >= 0 ? __ldcg(vis + (v >> 5)) : 0u;
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int v = pid[s];
        bool ok = live[s] && !((word[s] >> (v & 31)) & 1u);
        if (VIS && ok) ok = set_find(vt, bits_v, v) < 0;
        if (E > 1 && ok) ok = set_claim(fk, bits_s, v, &slot[s]);
        scored_w += __popc(__ballot_sync(kFull, ok));
        const bool copy =
            ok && !VIS && set_find(tcur, bits_b, v) >= 0;
        fresh[s] = ok && !copy;
        xkey[s] = copy ? 2 * v + 1 : -2;
        extra[s] = loose && jm[s] < E && !fresh[s] && xkey[s] < lastk;
        bf[s] = __ballot_sync(kFull, fresh[s]);
        bx[s] = __ballot_sync(kFull, extra[s]);
        nids += __popc(__ballot_sync(kFull, v >= 0));
      }
      if (lane == 0) {
        red5[warp][0] = __popc(bf[0]);
        red5[warp][1] = __popc(bf[1]);
        red5[warp][2] = __popc(bx[0]);
        red5[warp][3] = __popc(bx[1]);
        red5[warp][4] = nids;
      }
      __syncthreads();
      // compaction: the fresh ids into cid [0, F) in slot order, the
      // extras' keys after them
      int tot[5] = {0, 0, 0, 0, 0}, off[4] = {0, 0, 0, 0};
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          off[i] += w < warp ? red5[w][i] : 0;
          tot[i] += red5[w][i];
        }
        tot[4] += red5[w][4];
      }
      if (!ovf) nv += tot[4];
      const int F = tot[0] + tot[1], C = F + tot[2] + tot[3];
      off[1] += tot[0];
      off[2] += F;
      off[3] += F + tot[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        if (fresh[s]) {
          const int c = off[s] + __popc(bf[s] & lt);
          cid[c] = pid[s];
          if constexpr (kWords || kSparse) nvalid[c] = 1;
        }
        if (extra[s]) {
          const int c = off[2 + s] + __popc(bx[s] & lt);
          nd[c] = inf;
          nkey[c] = walk_key(inf, xkey[s]);
        }
        if (slot[s] >= 0) fk[slot[s]] = -1;  // every claim is made
        // the bitmap: every id of the step sets its bit, after every test
        if (VIS && pid[s] >= 0) {
          if (ovf)
            atomicOr(vis + (pid[s] >> 5), 1u << (pid[s] & 31));
          else
            set_insert(vt, bits_v, pid[s]);
        }
      }
      if (!VIS)
        for (int i = tid; i < tbl_b; i += kThreads) tnext[i] = -1;
      if (tid == 0) nkey[C] = ~0ull;  // the pair read past an odd C
      __syncthreads();
      K5_MARK(kPhFlags);

      // (B) the fresh rows scored; an entry that cannot come before the
      // beam's last is not ranked
      const unsigned long long lastkey = walk_key(cbd[W - 1], cbk[W - 1]);
      if constexpr (kWords || kSparse) {
        score(F);
        __syncthreads();
        for (int c = tid; c < F; c += kThreads) {
          const unsigned long long kk = walk_key(nd[c], 2 * cid[c] + 1);
          nkey[c] = kk < lastkey ? kk : ~0ull;
        }
      } else if constexpr (RANK) {
        switch (a.metric) {
          case 0: var_score_rows<T, V, 0, true>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
          case 1: var_score_rows<T, V, 1, true>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
          default: var_score_rows<T, V, 2, true>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
        }
      } else {
        switch (a.metric) {
          case 0: var_score_rows<T, V, 0, false>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
          case 1: var_score_rows<T, V, 1, false>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
          case 2: var_score_rows<T, V, 2, false>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
          default: var_score_rows<T, V, 3, false>(a, qs, qb, cid, F, nd, nkey, lastkey, warp, lane); break;
        }
      }
      __syncthreads();
      K5_MARK(kPhRows);

      // (C) the ranked entries placed by every thread (each counts the
      // keys below its own, two a load; equal keys, the copies of one id,
      // by their places); warp 3 also lists the beam's first E unexpanded
      // members (au, in the beam's order)
      int kept_w = 0, kfin_w = 0;
      const ulonglong2* kp = reinterpret_cast<const ulonglong2*>(nkey);
      for (int base = 0; base < C; base += kThreads) {
        const int j = base + tid;
        const unsigned long long kj = j < C ? nkey[j] : ~0ull;
        const bool keep = kj != ~0ull;
        if (keep) {
          int r = 0;
#pragma unroll 4
          for (int i = 0; i < (C + 1) >> 1; ++i) {
            const ulonglong2 x = kp[i];
            r += (x.x < kj) + (x.y < kj) + ((x.x == kj) & (2 * i < j)) +
                 ((x.y == kj) & (2 * i + 1 < j));
          }
          sd[r] = nd[j];
          sk[r] = static_cast<int>(static_cast<unsigned>(kj)) - 2;
        }
        kept_w += __popc(__ballot_sync(kFull, keep));
        kfin_w += __popc(__ballot_sync(kFull, keep && nd[j] < inf));
      }
      if (warp == kWarps - 1) {
        int got = 0;
        for (int base = 0; base < W && got < E; base += 32) {
          const int i = base + lane;
          const unsigned mk =
              __ballot_sync(kFull, i < W && (cbk[i] & 1) && cbd[i] < inf);
          const int r = got + __popc(mk & lt);
          if (((mk >> lane) & 1u) && r < E) au[r] = i;
          got = min(E, got + __popc(mk));
        }
        if (lane == 0) s_nsel = got;
      }
      if (lane == 0) {
        kept2[warp][0] = kept_w;
        kept2[warp][1] = kfin_w;
      }
      __syncthreads();
      K5_MARK(kPhSort);
      int nn = 0, nnf = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        nn += kept2[w][0];
        nnf += kept2[w][1];
      }

      // (D) the next step's members, in every warp alike: lane l takes the
      // t-th (t = t0 + l, t < E, 32 at a time) of the merge of the beam's
      // unexpanded members (au) and the finite ranked entries (sd), beam
      // first among equals (the merge's order), and its place in the
      // merged beam; those inside the first W are the first E unexpanded
      // members there. Their neighbour ids load while the merge runs.
      const int na = s_nsel;
      int um[2] = {0, 0};  // the row of member jm[s]
      nsel = 0;
      for (int t0 = 0; t0 < E; t0 += 32) {
        const int t = t0 + lane;
        int ck = INT_MAX, cpos = INT_MAX;
        if (t < E && t < na + nnf) {
          int lo = max(0, t - nnf), hi = min(t, na);
          while (lo < hi) {  // the members of au among the first t
            const int mid = (lo + hi) >> 1;
            const int ia = au[mid], jb = t - 1 - mid;
            if (!before(sd[jb], sk[jb], cbd[ia], cbk[ia]))
              lo = mid + 1;
            else
              hi = mid;
          }
          const int y = t - lo;  // and of sd
          const bool from_beam =
              lo < na && (y >= nnf || !before(sd[y], sk[y], cbd[au[lo]],
                                              cbk[au[lo]]));
          if (from_beam) {
            ck = cbk[au[lo]];
            cpos = au[lo] + y;
          } else {
            ck = sk[y];
            cpos = y + count_before(cbd, cbk, W, sd[y], ck, false);
          }
        }
        const bool in = cpos < W;  // a prefix of the t
        const int got = __popc(__ballot_sync(kFull, in));
        nsel += got;
        if (warp == 0 && in) vsel[t] = cpos;  // read after the merge
        const int us = in ? min(ck >> 1, a.cap) : 0;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int x = __shfl_sync(kFull, us, jm[s] & 31);
          if (jm[s] >= t0 && jm[s] - t0 < 32) um[s] = x;
        }
        if (got < 32) break;  // the rest lie past the merged beam or E
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
        pid[s] = jm[s] < nsel
                     ? a.nbrs[static_cast<long long>(um[s]) * L + jo[s]]
                     : -1;
      K5_MARK(kPhSelect);

      // (E) the ranked entries merged into the beam (beam first among
      // equals); without the bitmap, the next beam's ids enter its set
      for (int i = tid; i < W + nn; i += kThreads) {
        const bool from_beam = i < W;
        const int j = from_beam ? i : i - W;
        const float d = from_beam ? cbd[j] : sd[j];
        const int k = from_beam ? cbk[j] : sk[j];
        const int r = j + (from_beam ? count_before(sd, sk, nn, d, k, true)
                                     : count_before(cbd, cbk, W, d, k, false));
        if (r < W) {
          obd[r] = d;
          obk[r] = k;
          if (!VIS && k >= 0) set_insert(tnext, bits_b, k >> 1);
        }
      }
      __syncthreads();
      K5_MARK(kPhBeamMerge);
      cur ^= 1;
      ++steps;
      go = nsel > 0 && steps < a.max_steps && obd[vsel[0]] <= obd[W - 1];
    }
    if (lane == 0) atomicAdd(&s_scored, scored_w);
    if (ovf) {  // leave the global bitmap zero: clear what was set there
      __threadfence();
      __syncthreads();
      if (nrec <= rlen) {
#pragma unroll 4
        for (int i = tid; i < nrec * L; i += kThreads) {
          const int v = a.nbrs[static_cast<long long>(rec[i / L]) * L +
                               i % L];
          if (v >= 0) vis[v >> 5] = 0u;
        }
        if (seeds_global)
          for (int i = tid; i < S; i += kThreads) {
            const int id = DESC ? land_id : a.seed_ids[s0 + i];
            if (id >= 0) vis[id >> 5] = 0u;
          }
      } else {
        for (int i = tid; i < a.vwords; i += kThreads) vis[i] = 0u;
      }
    }
    __syncthreads();
    scored = s_scored;
  } else {
    while (true) {
      float* cbd = bd + cur * W;
      int* cbk = bk + cur * W;
      float* obd = bd + (cur ^ 1) * W;
      int* obk = bk + (cur ^ 1) * W;

      // the member to expand: the first unexpanded in the beam's order
      int local = INT_MAX;
      for (int i = tid; i < W; i += kThreads)
        if ((cbk[i] & 1) && cbd[i] < inf) local = min(local, i);
      local = __reduce_min_sync(kFull, local);
      if (lane == 0) red[warp] = local;
      __syncthreads();
      int pos = red[0];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) pos = min(pos, red[w]);
      if (pos == INT_MAX || steps >= a.max_steps ||
          !(cbd[pos] <= cbd[W - 1]))
        break;  // the same decision in every thread
      const int u = min(cbk[pos] >> 1, a.cap);  // the sentinel row at worst
      K5_MARK(kPhSelect);

      for (int j0 = 0; j0 < L; j0 += kThreads) {  // the same trips in every
        const int j = j0 + tid;                      // thread
        const int v = j < L ? a.nbrs[static_cast<long long>(u) * L + j] : -1;
        const bool ok = v >= 0 && a.trav[min(v, a.cap)];
        if (j < L) {
          nid[j] = v;
          nvalid[j] = ok;
          nk[j] = ok ? 2 * v + 1 : -2;
          dup[j] = 0;
        }
        scored += __syncthreads_count(ok);
      }
      if (tid == 0) cbk[pos] &= ~1;  // expanded; read again after a barrier
      K5_MARK(kPhFlags);

      score(L);
      __syncthreads();
      K5_MARK(kPhRows);

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
      K5_MARK(kPhDedup);

      // rank-sort the new entries
      for (int j = tid; j < L; j += kThreads) {
        const float dj = dup[j] ? inf : nd[j];
        const int kj = nk[j];
        int r = 0;
        for (int i = 0; i < L; ++i) {
          const float di = dup[i] ? inf : nd[i];
          r += before(di, nk[i], dj, kj) ||
               (i < j && di == dj && nk[i] == kj);
        }
        sd[r] = dj;
        sk[r] = kj;
      }
      __syncthreads();
      K5_MARK(kPhSort);

      // merge beam (W) and new (L): the first W are the next beam
      for (int i = tid; i < W; i += kThreads) {
        const int r = i + count_before(sd, sk, L, cbd[i], cbk[i], true);
        if (r < W) {
          obd[r] = cbd[i];
          obk[r] = cbk[i];
        }
      }
      for (int j = tid; j < L; j += kThreads) {
        const int r = j + count_before(cbd, cbk, W, sd[j], sk[j], false);
        if (r < W) {
          obd[r] = sd[j];
          obk[r] = sk[j];
        }
      }
      __syncthreads();
      K5_MARK(kPhBeamMerge);
      cur ^= 1;
      ++steps;
    }
  }

  float* fbd = bd + cur * W;
  const int* fbk = bk + cur * W;
  if constexpr (RANK) {  // the surviving beam's exact distances
    for (int base = 0; base < W; base += NL) {
      const int cnt = min(NL, W - base);
      for (int j = tid; j < cnt; j += kThreads) {
        const int k = fbk[base + j];
        nid[j] = k >= 0 ? min(k >> 1, a.cap) : 0;
        nvalid[j] = k >= 0;
      }
      __syncthreads();
      score_exact(cnt);
      __syncthreads();
      for (int j = tid; j < cnt; j += kThreads) fbd[base + j] = nd[j];
      __syncthreads();
    }
  }
  const long long ob = static_cast<long long>(b) * W;
  for (int i = tid; i < W; i += kThreads) {
    a.beam_d[ob + i] = fbd[i];
    a.beam_key[ob + i] = fbk[i];
  }
  if (tid == 0) {
    a.steps[b] = steps;
    a.scored[b] = scored;
  }
  K5_MARK(kPhFinish);
  K5_PROF_END(steps);
}

template <typename T, int V, bool DESC, bool VAR>
__global__ void __launch_bounds__(kThreads) beam_walk_kernel(WalkArgs a) {
  beam_walk<T, V, DESC, false, VAR>(a);
}

// The modes' walks (E > 1 or the bitmap: VIS), held to 64 registers a
// thread as the bf16 ranking's walk is: 8 blocks then fit an SM, so 1,024
// queries run in one wave on 132 SMs (at 128 registers, 4 blocks an SM,
// they ran in two; the sparse rows' bitmap walk took 80 and two waves,
// 1.5x the time). The bitmap's walk is an instantiation of its own, so
// the E > 1 walk holds none of its registers.
template <typename T, int V, bool DESC, bool VIS>
__global__ void __launch_bounds__(kThreads, 8)
    beam_walk_var_kernel(WalkArgs a) {
  beam_walk<T, V, DESC, false, true, VIS>(a);
}

// The bf16 ranking's walk, held to 64 registers a thread: 8 blocks (1,024
// threads) then fit an SM, so a launch of 1,024 queries runs in one wave
// on 132 SMs (at 72-117 registers it ran in two, ~1.6x the time).
template <int V, bool DESC, bool VAR>
__global__ void __launch_bounds__(kThreads, 8)
    beam_walk_rank_kernel(WalkArgs a) {
  beam_walk<__nv_bfloat16, V, DESC, true, VAR>(a);
}

// ... and in its modes
template <int V, bool DESC, bool VIS>
__global__ void __launch_bounds__(kThreads, 8)
    beam_walk_rank_var_kernel(WalkArgs a) {
  beam_walk<__nv_bfloat16, V, DESC, true, true, VIS>(a);
}

cudaError_t launch_kernel(void (*kern)(WalkArgs), const WalkArgs& a, int b,
                          size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<b, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The modes' kernel for the launch's descent and bitmap.
template <typename T, int V, bool RANK>
void (*var_kernel(const WalkArgs& a))(WalkArgs) {
  const bool desc = a.upper_slot != nullptr, vis = a.vis != nullptr;
  if constexpr (RANK)
    return desc ? (vis ? beam_walk_rank_var_kernel<V, true, true>
                       : beam_walk_rank_var_kernel<V, true, false>)
                : (vis ? beam_walk_rank_var_kernel<V, false, true>
                       : beam_walk_rank_var_kernel<V, false, false>);
  else
    return desc ? (vis ? beam_walk_var_kernel<T, V, true, true>
                       : beam_walk_var_kernel<T, V, true, false>)
                : (vis ? beam_walk_var_kernel<T, V, false, true>
                       : beam_walk_var_kernel<T, V, false, false>);
}

// The row type's code (pgv_k4_beam_walk's dtype).
template <typename T>
constexpr int walk_dtype() {
  return std::is_same<T, float>::value            ? 0
         : std::is_same<T, __half>::value         ? 1
         : std::is_same<T, __nv_bfloat16>::value  ? 2
         : std::is_same<T, unsigned>::value       ? 3
                                                  : 4;
}

// VAR = false where E = 1 and no bitmap: the default walk and the bf16
// ranking's each have their own instantiation for it; the modes run
// beam_walk_var_kernel (another unit of the library, pgv_k4_var_walk) and
// beam_walk_rank_var_kernel.
template <typename T, int V, bool RANK>
cudaError_t launch(const WalkArgs& a, int b, size_t smem,
                   cudaStream_t stream) {
  const bool desc = a.upper_slot != nullptr;
  if (a.E != 1 || a.vis != nullptr) {
    if constexpr (RANK)
      return launch_kernel(var_kernel<T, V, true>(a), a, b, smem, stream);
    else
      return static_cast<cudaError_t>(
          pgv_k4_var_walk(&a, walk_dtype<T>(), V, b, smem, stream));
  }
  void (*kern)(WalkArgs);
  if constexpr (RANK)
    kern = desc ? beam_walk_rank_kernel<V, true, false>
                : beam_walk_rank_kernel<V, false, false>;
  else
    kern = desc ? beam_walk_kernel<T, V, true, false>
                : beam_walk_kernel<T, V, false, false>;
  return launch_kernel(kern, a, b, smem, stream);
}


// ---------------------------------------------------------------------------
// K4's packed-word mode, one warp per query
// ---------------------------------------------------------------------------
//
// Rows of 8-32 words are short: a step's rows are one 16-byte load per
// lane, so what bounds the block form's step is its bookkeeping (block
// barriers and shared-memory round trips between four warps). Here one
// warp walks one query, and a block holds kwQueries queries (warps) that
// share nothing but the block:
// - the beam (W <= 64) lives in registers, entry i in lane i % 32's slot
//   i / 32, sorted by (distance, key); a mirror in the warp's shared
//   memory serves the dedup's id test and the merge's scatter;
// - a step: the nearest unexpanded member by two ballots; lane j loads
//   neighbour j's id, its flag and its row words (the row's load does not
//   wait for the flag: ids -> (flags, rows) is the step's one dependent
//   round trip after the ids), in lane groups that cover a row's 16-byte
//   chunks, all rows' loads in flight together; the id test against the
//   beam's mirror and __match_any_sync for repeats in the list; a bitonic
//   sort of the L new entries across the lanes; the merge by binary
//   searches (shuffles over the new entries, the mirror over the beam)
//   and one scatter into the mirror; __syncwarp only;
// - the same order, dedup and stopping rules as the block form, so the
//   raw outputs are the same.
// Shapes: W <= 64, L <= 32, at most 32 words per row, S <= 32 seeds, m <=
// 32 (kwFits); the block form takes the rest.
//
// The variants (E > 1, the visited bitmap) run word_walk_modes_kernel,
// below.

constexpr int kwQueries = 4;   // queries (warps) per block
constexpr int kwMaxW = 64, kwMaxL = 32, kwMaxWords = 32;

struct WarpState {
  alignas(16) unsigned q[kwMaxWords];
  int nid[kwMaxL];
  float nd[kwMaxL];
  uint8_t nvalid[kwMaxL];
  float bd[kwMaxW];  // the beam's mirror (keys past W stay -2)
  alignas(16) int bk[kwMaxW];
  int bc[3];
  int sel_u[kwMaxW];  // the rows of the members a step expands
};

__host__ __device__ inline bool kw_fits(int words, int W, int L, int S,
                                        int m, bool desc) {
  return words <= kwMaxWords && W <= kwMaxW && L <= kwMaxL && S <= 32 &&
         (!desc || m <= 32);
}

// A word row's distance from c1 = popcount(q op x) and c2 = popcount(x):
// hamming c1, or jaccard from ab = c1 (IEEE division: the JAX package's
// f32 values).
template <int JACC>
__device__ __forceinline__ float word_dist(int c1, int c2, float qpop) {
  if (!JACC) return static_cast<float>(c1);
  const float ab = static_cast<float>(c1);
  return c1 == 0 ? 1.0f
                 : 1.0f - __fdiv_rn(ab, qpop + static_cast<float>(c2) - ab);
}

// Lane j's distance to neighbour row v_j (ok_j: valid; +inf otherwise):
// hamming (JACC = 0) or jaccard (JACC = 1) from the query words qs. The
// rows go `lpr` lanes to a row (the fewest, a power of two, that cover its
// V-word chunks: one chunk a lane), 32 / lpr rows a pass; every pass's
// load is issued before any is used. Rows with v_j >= 0 are read whatever
// their flag, so the loads need not wait for the flags.
template <int V, int JACC>
__device__ __forceinline__ float warp_score_words(const WalkArgs& a,
                                                  const unsigned* qs,
                                                  float qpop, int v, bool ok,
                                                  int lane) {
  using C = WordChunk<V>;
  using T = typename C::T;
  constexpr int kMaxPass = kwMaxWords / V;  // lpr <= 32 / V
  const unsigned* words = static_cast<const unsigned*>(a.values);
  const int nchunks = a.d / V;
  int lpr = 1;
  while (lpr < nchunks) lpr <<= 1;
  const int rpw = 32 / lpr, passes = lpr;
  const int sub = lane / lpr, sl = lane % lpr;
  const bool mine = sl < nchunks;
  T x[kMaxPass];
#pragma unroll
  for (int p = 0; p < kMaxPass; ++p) {
    if (p < passes) {
      const int vj = __shfl_sync(kFull, v, p * rpw + sub);
      x[p] = T{};
      if (vj >= 0 && mine)
        x[p] = __ldg(reinterpret_cast<const T*>(
                         words + static_cast<long long>(min(vj, a.cap)) *
                                     a.stride) +
                     sl);
    }
  }
  const T q = mine ? reinterpret_cast<const T*>(qs)[sl] : T{};
  float dist = inf_f();
#pragma unroll
  for (int p = 0; p < kMaxPass; ++p) {
    if (p < passes) {
      int c1 = C::pop(C::op(q, x[p], JACC));
      int c2 = JACC ? C::pop(x[p]) : 0;
      for (int o = lpr >> 1; o; o >>= 1) {
        c1 += __shfl_xor_sync(kFull, c1, o);
        if (JACC) c2 += __shfl_xor_sync(kFull, c2, o);
      }
      const float dp = word_dist<JACC>(c1, c2, qpop);
      // row p * rpw + s is in group s: lane j takes group j % rpw of pass
      // j / rpw
      const float got = __shfl_sync(kFull, dp, (lane % rpw) * lpr);
      if (p == lane / rpw) dist = got;
    }
  }
  return ok ? dist : inf_f();
}

// Ascending bitonic sort of one (d, k) pair per lane across the warp.
__device__ __forceinline__ void warp_sort(float& d, int& k, int lane) {
#pragma unroll
  for (int k2 = 2; k2 <= 32; k2 <<= 1) {
#pragma unroll
    for (int j2 = k2 >> 1; j2 > 0; j2 >>= 1) {
      const float od = __shfl_xor_sync(kFull, d, j2);
      const int ok = __shfl_xor_sync(kFull, k, j2);
      const bool up = (lane & k2) == 0, low = (lane & j2) == 0;
      // the lower lane of an ascending pair keeps the smaller
      const bool take = (low == up) ? before(od, ok, d, k)
                                    : before(d, k, od, ok);
      if (take) {
        d = od;
        k = ok;
      }
    }
  }
}

// The query's words into ws.q; returns their popcount (jaccard's).
__device__ __forceinline__ float word_query(const WalkArgs& a, WarpState& ws,
                                            int b, int lane) {
  const unsigned* qg = reinterpret_cast<const unsigned*>(a.q) +
                       static_cast<long long>(b) * a.qd;
  int qp = 0;
  for (int i = lane; i < a.d; i += 32) {
    ws.q[i] = qg[i];
    qp += __popc(qg[i]);
  }
  const float qpop = static_cast<float>(__reduce_add_sync(kFull, qp));
  __syncwarp();
  return qpop;
}

// The walk's seeds, the descent's landing (upper_slot given: the landing
// goes to a.land) or the given ones, deduped by id (a repeated seed: only
// its first copy lives) and sorted into the beam: (d0, k0) / (d1, k1) and
// the mirror. Returns whether this lane holds a live seed, its id in sid.
template <int V, int JACC>
__device__ __forceinline__ bool word_seeds(const WalkArgs& a, WarpState& ws,
                                           int b, int lane, float qpop,
                                           int& sid, float& d0, int& k0,
                                           float& d1, int& k1) {
  const float inf = inf_f();
  const unsigned lt = (1u << lane) - 1u;
  const int W = a.W;
  sid = -1;
  float sdist = inf;
  int S = a.S;
  if (a.upper_slot != nullptr) {
    S = 1;
    int rows = 0, moves = 0;
    if (a.entry >= 0) {
      auto score = [&](int count) {
        const int v = lane < count ? ws.nid[lane] : -1;
        const float d = warp_score_words<V, JACC>(
            a, ws.q, qpop, v, lane < count && ws.nvalid[lane], lane);
        if (lane < count) ws.nd[lane] = d;
      };
      greedy_descent(a, ws.nid, ws.nvalid, ws.nd, ws.bc, score, score,
                     [] { __syncwarp(); }, lane, 32, sid, sdist, rows,
                     moves);
    }
    if (lane == 0) {
      int* o = a.land + 4LL * b;
      o[0] = sid;
      o[1] = __float_as_int(sdist);
      o[2] = rows;
      o[3] = moves;
    }
  } else if (lane < S) {
    sid = a.seed_ids[static_cast<long long>(b) * S + lane];
    sdist = a.seed_d[static_cast<long long>(b) * S + lane];
  }
  const bool sok = lane < S && sid >= 0;
  d0 = sok ? sdist : inf;
  k0 = sok ? 2 * sid + 1 : -2;
  const unsigned same = __match_any_sync(kFull, sok ? sid : -1 - lane);
  if (sok && (same & lt)) d0 = inf;
  if (lane >= S) k0 = INT_MAX;  // pads sort last
  warp_sort(d0, k0, lane);
  if (lane >= S) {
    d0 = inf;
    k0 = -2;
  }
  d1 = inf;
  k1 = -2;
  if (lane < W) {
    ws.bd[lane] = d0;
    ws.bk[lane] = k0;
  }
  if (lane >= W) ws.bk[lane] = -2;
  ws.bk[32 + lane] = -2;
  if (32 + lane < W) ws.bd[32 + lane] = d1;
  __syncwarp();
  return sok;
}

// Merges the sorted new entries (nd, nk) of lanes < cnt (the others pads
// that sort last) into the beam, registers and mirror: the first W of the
// two are the next beam, the beam first among equals.
__device__ __forceinline__ void warp_merge(WarpState& ws, float nd, int nk,
                                           int cnt, int W, int lane,
                                           float& d0, int& k0, float& d1,
                                           int& k1) {
  int ra = lane, rb = 32 + lane;  // ranks of the beam's entries
  {
    int ca = 0, cb = 0;  // new entries strictly before each
#pragma unroll
    for (int st = 16; st; st >>= 1) {
      const float e0 = __shfl_sync(kFull, nd, ca + st - 1);
      const int f0 = __shfl_sync(kFull, nk, ca + st - 1);
      const float e1 = __shfl_sync(kFull, nd, cb + st - 1);
      const int f1 = __shfl_sync(kFull, nk, cb + st - 1);
      if (before(e0, f0, d0, k0)) ca += st;
      if (before(e1, f1, d1, k1)) cb += st;
    }
    const float e0 = __shfl_sync(kFull, nd, ca);
    const float e1 = __shfl_sync(kFull, nd, cb);
    const int f0 = __shfl_sync(kFull, nk, ca);
    const int f1 = __shfl_sync(kFull, nk, cb);
    ca += ca == 31 && before(e0, f0, d0, k0);
    cb += cb == 31 && before(e1, f1, d1, k1);
    ra += ca;
    rb += cb;
  }
  int rn = lane;  // rank of the new entry: lane + beam entries <= it
  if (lane < cnt) {
    int lo = 0, n = W;
    while (n > 0) {
      const int h = n >> 1;
      if (!before(nd, nk, ws.bd[lo + h], ws.bk[lo + h])) {
        lo += h + 1;
        n -= h + 1;
      } else {
        n = h;
      }
    }
    rn += lo;
  }
  __syncwarp();  // every read of the mirror is done
  if (lane < W && ra < W) {
    ws.bd[ra] = d0;
    ws.bk[ra] = k0;
  }
  if (32 + lane < W && rb < W) {
    ws.bd[rb] = d1;
    ws.bk[rb] = k1;
  }
  if (lane < cnt && rn < W) {
    ws.bd[rn] = nd;
    ws.bk[rn] = nk;
  }
  __syncwarp();
  if (lane < W) {
    d0 = ws.bd[lane];
    k0 = ws.bk[lane];
  }
  if (32 + lane < W) {
    d1 = ws.bd[32 + lane];
    k1 = ws.bk[32 + lane];
  }
}

// The step's members: the first E unexpanded in the beam's order (JAX's
// top_k: the nearest, lower slot first), their rows into ws.sel_u and
// marked expanded (registers and mirror); returns how many, 0 where the
// walk stops (none left, max_steps taken, or the nearest farther than the
// beam's last, whose distance goes to dlast).
__device__ __forceinline__ int word_select(const WalkArgs& a, WarpState& ws,
                                           int E, int steps, int lane,
                                           float& d0, int& k0, float& d1,
                                           int& k1, float& dlast) {
  const float inf = inf_f();
  const unsigned lt = (1u << lane) - 1u;
  const int W = a.W;
  const unsigned m0 = __ballot_sync(kFull, lane < W && (k0 & 1) && d0 < inf);
  const unsigned m1 =
      __ballot_sync(kFull, 32 + lane < W && (k1 & 1) && d1 < inf);
  if (!(m0 | m1) || steps >= a.max_steps) return 0;
  const int pos = m0 ? __ffs(m0) - 1 : 32 + __ffs(m1) - 1;
  const float dpos = __shfl_sync(kFull, pos < 32 ? d0 : d1, pos & 31);
  dlast = __shfl_sync(kFull, W > 32 ? d1 : d0, (W - 1) & 31);
  if (!(dpos <= dlast)) return 0;
  const int c0 = __popc(m0);
  const int r0 = __popc(m0 & lt), r1 = c0 + __popc(m1 & lt);
  if (((m0 >> lane) & 1u) && r0 < E) {
    ws.sel_u[r0] = min(k0 >> 1, a.cap);  // the sentinel row at worst
    k0 &= ~1;
    ws.bk[lane] = k0;
  }
  if (((m1 >> lane) & 1u) && r1 < E) {
    ws.sel_u[r1] = min(k1 >> 1, a.cap);
    k1 &= ~1;
    ws.bk[32 + lane] = k1;
  }
  __syncwarp();
  return min(E, c0 + __popc(m1));
}

// The raw beam, steps and rows scored of query b.
__device__ __forceinline__ void word_outputs(const WalkArgs& a, int b, int W,
                                             int lane, float d0, int k0,
                                             float d1, int k1, int steps,
                                             int scored) {
  const long long ob = static_cast<long long>(b) * W;
  if (lane < W) {
    a.beam_d[ob + lane] = d0;
    a.beam_key[ob + lane] = k0;
  }
  if (32 + lane < W) {
    a.beam_d[ob + 32 + lane] = d1;
    a.beam_key[ob + 32 + lane] = k1;
  }
  if (lane == 0) {
    a.steps[b] = steps;
    a.scored[b] = scored;
  }
}

template <int V, int JACC>
__global__ void __launch_bounds__(kwQueries * 32)
    word_walk_kernel(WalkArgs a, int nq) {
  __shared__ WarpState states[kwQueries];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kwQueries + warp;
  if (b >= nq) return;  // the whole warp; no block barrier below
  WarpState& ws = states[warp];
  const int W = a.W, L = a.L;
  const float inf = inf_f();
  const unsigned lt = (1u << lane) - 1u;  // the lanes below this one
  const float qpop = word_query(a, ws, b, lane);
  K5_PROF_BEGIN
  float d0, d1;
  int k0, k1, sid;
  word_seeds<V, JACC>(a, ws, b, lane, qpop, sid, d0, k0, d1, k1);
  K5_MARK(kPhStart);

  int steps = 0, scored = 0;
  while (true) {
    float dlast;
    if (word_select(a, ws, 1, steps, lane, d0, k0, d1, k1, dlast) == 0)
      break;
    K5_MARK(kPhSelect);

    // neighbour j of the member: its id, flag and distance in lane j
    const int v = lane < L ? __ldg(a.nbrs +
                                   static_cast<long long>(ws.sel_u[0]) * L +
                                   lane)
                           : -1;
    const bool ok = v >= 0 && a.trav[min(v, a.cap)];
    const unsigned rep = __match_any_sync(kFull, v >= 0 ? v : -1 - lane);
    // the rows' loads go out with the flags' (nothing waits for ok first)
    const float dv = warp_score_words<V, JACC>(a, ws.q, qpop, v, ok, lane);
    scored += __popc(__ballot_sync(kFull, ok));
    K5_MARK(kPhRows);

    // dedup: an id in the beam (any copy), or earlier in the list; the
    // mirror's keys four at a time, every load in flight together
    bool dup = false;
#pragma unroll
    for (int i = 0; i < kwMaxW; i += 4) {
      if (i < W) {  // the same in every lane
        const int4 kb = *reinterpret_cast<const int4*>(ws.bk + i);
        dup |= (kb.x >= 0 && (kb.x >> 1) == v) |
               (kb.y >= 0 && (kb.y >> 1) == v) |
               (kb.z >= 0 && (kb.z >> 1) == v) |
               (kb.w >= 0 && (kb.w >> 1) == v);
      }
    }
    dup = dup && ok;
    dup |= ok && (rep & lt);
    float nd = ok && !dup ? dv : inf;
    int nk = ok ? 2 * v + 1 : -2;
    if (lane >= L) nk = INT_MAX;  // pads sort last
    K5_MARK(kPhDedup);
    warp_sort(nd, nk, lane);
    K5_MARK(kPhSort);

    // merge beam (W) and new (L): the first W are the next beam
    warp_merge(ws, nd, nk, L, W, lane, d0, k0, d1, k1);
    K5_MARK(kPhBeamMerge);
    ++steps;
  }
  word_outputs(a, b, W, lane, d0, k0, d1, k1, steps, scored);
  K5_MARK(kPhFinish);
  K5_PROF_END(steps);
}

template <int V, int JACC>
cudaError_t launch_word_walk(const WalkArgs& a, int b, cudaStream_t stream) {
  word_walk_kernel<V, JACC>
      <<<(b + kwQueries - 1) / kwQueries, kwQueries * 32, 0, stream>>>(a, b);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The word walk's modes: E > 1 and the visited bitmap, one warp per query
// ---------------------------------------------------------------------------
//
// The default word walk's step is three dependent round trips (ids ->
// flags and rows), ~4.3 us under load against a 0.27 us hop; its first
// modes ran that chain, a 32-lane sort and a merge once per member (E
// times a step, ~18.8 us at E = 4), tested each id's bitmap word after its
// flag (a third trip) and cleared every query's bitmap after the launch
// (~128 MB at 1,024 queries over 1M rows). Here a step of either mode is
// two trips, one sort and one merge:
// - the step's E L new entries sit NS = E L / 32 (rounded up to a power of
//   two) to a lane, entry t = 32 s + lane in slot s (neighbour t % L of
//   member t / L); their ids load at once, then every entry's live flag
//   (past the visited set its bitmap word), while the tests on chip run:
//   the step's first copy of an id (E > 1: __match_any_sync within a slot,
//   the step's earlier slots in shared memory, no atomics; any copy would
//   do, they share one row, distance and key), not in the visited set,
//   not in the beam (no bitmap: the beam's mirror; its copy keeps its key
//   at an infinite distance and needs no row);
// - the rows of the ids that pass are compacted and load with every load
//   of a round in flight (warp_score_list); the visited set takes the
//   step's ids while they fly (its atomics off the step's path);
// - each entry is then the plain walk's (distance, key); only one that
//   comes before the beam's last (walk_key order, the beam first among
//   equals) can enter, so those are compacted and merged: one bitonic sort
//   and one merge (warp_merge) per 32 of them, which keeps the first W of
//   the union as the plain walk's sort does (one round but for the first
//   steps, none once nothing enters);
// - the bitmap (VIS): a visited set of the warp's own in shared memory
//   (2^kwVisBits slots) takes the ids while it is at most half full; then
//   the global bitmap, one per query, whose word a test reads beside the
//   live flag and which every id of a step then sets (atomicOr, after
//   every test). The caller hands the bitmap zeroed and gets it back
//   zeroed: once a walk uses it, it records the members it expands (at
//   most kRecMax) and, before it ends, stores 0 to the word of every id
//   their lists hold, or clears its whole bitmap past kRecMax; no launch
//   clears (cap + 1) / 8 bytes a query. (The global bitmap from the first
//   step, its words read with every flag and cleared at the end, took
//   the bitmap walk 0.2819 ms against the set's 0.2177; claiming the
//   step's first copies in shared-memory sets took E = 4 0.3207 ms
//   against 0.1597 without atomics: PERF.md §6.)
// The same order, masks and stopping rules as the plain walk: with E = 1
// and the bitmap a repeat within one list stays (both copies scored), as
// in JAX.

// log2 of the slots of a warp's visited set (16 KB; 2 blocks, 8 queries,
// an SM: 1,056 queries in one wave on 132 SMs)
constexpr int kwVisBits = 12;

struct WarpModes : WarpState {
  int sid[kMaxNew];   // the step's ids, in entry order (E > 1)
  int cid[kMaxNew];   // the rows' ids, then the candidates' keys
  float cd[kMaxNew];  // their distances, then the candidates'
  int rec[kRecMax];   // the members whose lists went to the bitmap
};

// The distances of rows ids[0, count) to the query (hamming or jaccard, as
// warp_score_words) into out[0, count): `lpr` lanes a row, rounds of
// kwMaxWords / V passes of 32 / lpr rows, every load of a round issued
// before any is used; `meanwhile()` runs once, while the first round's
// loads are in flight.
template <int V, int JACC, class Meanwhile>
__device__ __forceinline__ void warp_score_list(const WalkArgs& a,
                                                const unsigned* qs,
                                                float qpop, const int* ids,
                                                float* out, int count,
                                                int lane,
                                                Meanwhile meanwhile) {
  using C = WordChunk<V>;
  using T = typename C::T;
  constexpr int kPass = kwMaxWords / V;
  const unsigned* words = static_cast<const unsigned*>(a.values);
  const int nchunks = a.d / V;
  int lpr = 1;
  while (lpr < nchunks) lpr <<= 1;
  const int rpw = 32 / lpr;
  const int sub = lane / lpr, sl = lane % lpr;
  const bool mine = sl < nchunks;
  const T q = mine ? reinterpret_cast<const T*>(qs)[sl] : T{};
  bool done = false;
  for (int base = 0; base < count; base += kPass * rpw) {
    T x[kPass];
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      const int j = base + p * rpw + sub;
      x[p] = T{};
      if (j < count && mine)
        x[p] = __ldg(reinterpret_cast<const T*>(
                         words + static_cast<long long>(min(ids[j], a.cap)) *
                                     a.stride) +
                     sl);
    }
    if (!done) {
      meanwhile();
      done = true;
    }
#pragma unroll
    for (int p = 0; p < kPass; ++p) {
      if (base + p * rpw < count) {  // the same in every lane
        int c1 = C::pop(C::op(q, x[p], JACC));
        int c2 = JACC ? C::pop(x[p]) : 0;
        for (int o = lpr >> 1; o; o >>= 1) {
          c1 += __shfl_xor_sync(kFull, c1, o);
          if (JACC) c2 += __shfl_xor_sync(kFull, c2, o);
        }
        const int j = base + p * rpw + sub;
        if (sl == 0 && j < count) out[j] = word_dist<JACC>(c1, c2, qpop);
      }
    }
  }
  if (!done) meanwhile();
}

template <int V, int JACC, int NS, bool VIS>
__global__ void __launch_bounds__(kwQueries * 32)
    word_walk_modes_kernel(WalkArgs a, int nq) {
  __shared__ WarpModes states[kwQueries];
  extern __shared__ int4 vsets[];  // VIS: each warp's visited set
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * kwQueries + warp;
  if (b >= nq) return;  // the whole warp; no block barrier below
  WarpModes& ws = states[warp];
  const int W = a.W, L = a.L, E = a.E, NL = E * L;
  const float inf = inf_f();
  const unsigned lt = (1u << lane) - 1u;
  const float qpop = word_query(a, ws, b, lane);
  K5_PROF_BEGIN
  float d0, d1;
  int k0, k1, sid;
  const bool sok =
      word_seeds<V, JACC>(a, ws, b, lane, qpop, sid, d0, k0, d1, k1);

  int* vt = reinterpret_cast<int*>(vsets + (warp << (kwVisBits - 2)));
  unsigned* vis = VIS ? a.vis + static_cast<long long>(b) * a.vwords
                      : nullptr;
  constexpr int kCapV = 1 << (kwVisBits - 1);  // the set's ids, at most
  int nv = 0;  // the ids the set holds, at most
  bool ovf = false;  // past the set: the global bitmap
  if constexpr (VIS) {
    for (int i = lane; i < (1 << (kwVisBits - 2)); i += 32)
      vsets[(warp << (kwVisBits - 2)) + i] = make_int4(-1, -1, -1, -1);
    __syncwarp();
    if (sok) set_insert(vt, kwVisBits, sid);  // W <= 64 seeds fit
    nv = __popc(__ballot_sync(kFull, sok));
  }
  int tj[NS];  // slot s: (member << 8) | neighbour, -1 past E L
#pragma unroll
  for (int s = 0; s < NS; ++s) {
    const int t = 32 * s + lane;
    tj[s] = t < NL ? ((t / L) << 8) | (t % L) : -1;
  }
  __syncwarp();
  K5_MARK(kPhStart);

  const int rlen = VIS ? var_rec_len(a.max_steps, E) : 0;
  int steps = 0, scored = 0, nrec = 0;
  while (true) {
    float dlast;
    const int nsel = word_select(a, ws, E, steps, lane, d0, k0, d1, k1,
                                 dlast);
    if (nsel == 0) break;
    // only a new entry before the beam's last (as marked) can enter
    const unsigned long long lastkey = walk_key(
        dlast, __shfl_sync(kFull, W > 32 ? k1 : k0, (W - 1) & 31));
    if (VIS && !ovf) ovf = nv + NL > kCapV;  // the step could fill it
    if (VIS && ovf) {
      for (int e = lane; e < nsel; e += 32)
        if (nrec + e < rlen) ws.rec[nrec + e] = ws.sel_u[e];
      nrec += nsel;
    }
    K5_MARK(kPhSelect);

    // (A) the step's ids at once, then their flags (past the set their
    // bitmap words) in flight while the tests on chip run
    int v[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
      v[s] = tj[s] >= 0 && (tj[s] >> 8) < nsel
                 ? __ldg(a.nbrs +
                         static_cast<long long>(ws.sel_u[tj[s] >> 8]) * L +
                         (tj[s] & 255))
                 : -1;
    uint8_t tv[NS];
    unsigned gw[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      tv[s] = v[s] >= 0 ? __ldg(a.trav + min(v[s], a.cap)) : 0;
      gw[s] = VIS && ovf && v[s] >= 0 ? __ldcg(vis + (v[s] >> 5)) : 0u;
      if (E > 1 && s + 1 < NS) ws.sid[32 * s + lane] = v[s];
    }
    // first: the step's first copy of an id not in the visited set; fresh:
    // also not in the beam (no bitmap), so its row loads
    unsigned first = 0, fresh;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      bool f = v[s] >= 0;
      if (E > 1) {
        const unsigned same = __match_any_sync(kFull, f ? v[s] : -1 - lane);
        f = f && !(same & lt);
      }
      if (VIS && f) f = set_find(vt, kwVisBits, v[s]) < 0;
      first |= static_cast<unsigned>(f) << s;
    }
    if (E > 1 && NS > 1) {  // a copy in an earlier slot: masked
      __syncwarp();
#pragma unroll
      for (int s0 = 0; s0 + 1 < NS; ++s0) {
        if (32 * (s0 + 1) < NL) {  // the same in every lane
#pragma unroll
          for (int i = 0; i < 32; i += 4) {
            const int4 e4 =
                *reinterpret_cast<const int4*>(ws.sid + 32 * s0 + i);
#pragma unroll
            for (int s = s0 + 1; s < NS; ++s) {
              const int x = v[s];
              first &= ~(static_cast<unsigned>(
                             (e4.x == x) | (e4.y == x) | (e4.z == x) |
                             (e4.w == x))
                         << s);
            }
          }
        }
      }
    }
    fresh = first;
    if (!VIS) {  // an id in the beam (any copy) needs no row
      unsigned inb = 0;
#pragma unroll
      for (int i = 0; i < kwMaxW; i += 4) {
        if (i < W) {  // the same in every lane
          const int4 kb = *reinterpret_cast<const int4*>(ws.bk + i);
#pragma unroll
          for (int s = 0; s < NS; ++s) {
            const int x = v[s];
            inb |= static_cast<unsigned>(
                       (kb.x >= 0 && (kb.x >> 1) == x) |
                       (kb.y >= 0 && (kb.y >> 1) == x) |
                       (kb.z >= 0 && (kb.z >> 1) == x) |
                       (kb.w >= 0 && (kb.w >> 1) == x))
                   << s;
          }
        }
      }
      fresh &= ~inb;
    }
    int F = 0, ci[NS];  // the rows to load, compacted
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool n = (fresh >> s) & 1u;
      const unsigned bal = __ballot_sync(kFull, n);
      ci[s] = F + __popc(bal & lt);
      if (n) ws.cid[ci[s]] = v[s];
      F += __popc(bal);
    }
    __syncwarp();
    K5_MARK(kPhIds);

    // (B) their distances; meanwhile the visited set takes the step's ids
    warp_score_list<V, JACC>(a, ws.q, qpop, ws.cid, ws.cd, F, lane, [&] {
      if (VIS && !ovf) {
#pragma unroll
        for (int s = 0; s < NS; ++s) {
          const bool f = (first >> s) & 1u;
          if (f) set_insert(vt, kwVisBits, v[s]);
          nv += __popc(__ballot_sync(kFull, f));
        }
      }
    });
    __syncwarp();
    K5_MARK(kPhRows);

    // (C) each entry as the plain walk has it, and the rows scored; those
    // that can enter the beam are compacted
    float ed[NS];
    int ek[NS];
    unsigned cand = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const int x = v[s];
      bool ok = ((first >> s) & 1u) && tv[s];
      if (VIS) ok = ok && !((gw[s] >> (x & 31)) & 1u);
      scored += __popc(__ballot_sync(kFull, ok));
      ed[s] = ok && ((fresh >> s) & 1u) ? ws.cd[ci[s]] : inf;
      ek[s] = ok ? 2 * x + 1 : -2;
      cand |= static_cast<unsigned>(tj[s] >= 0 &&
                                    walk_key(ed[s], ek[s]) < lastkey)
              << s;
    }
    __syncwarp();  // cd is read, and every bitmap word tested
    int C = 0;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      const bool c = (cand >> s) & 1u;
      const unsigned bal = __ballot_sync(kFull, c);
      if (c) {
        const int j = C + __popc(bal & lt);
        ws.cd[j] = ed[s];
        ws.cid[j] = ek[s];
      }
      C += __popc(bal);
      // past the set, every id of the step sets its bit, after every test
      if (VIS && ovf && v[s] >= 0)
        atomicOr(vis + (v[s] >> 5), 1u << (v[s] & 31));
    }
    __syncwarp();
    K5_MARK(kPhDedup);

    // (D) one sort and one merge a round of 32 candidates
    for (int base = 0; base < C; base += 32) {
      const int j = base + lane;
      float nd = j < C ? ws.cd[j] : inf;
      int nk = j < C ? ws.cid[j] : INT_MAX;  // pads sort last
      warp_sort(nd, nk, lane);
      K5_MARK(kPhSort);
      warp_merge(ws, nd, nk, min(32, C - base), W, lane, d0, k0, d1, k1);
      K5_MARK(kPhBeamMerge);
    }
    ++steps;
  }
  if (VIS && ovf) {  // leave the bitmap zero: clear what was set there
    __threadfence();
    __syncwarp();
    if (nrec <= rlen) {
#pragma unroll 4
      for (int i = lane; i < nrec * L; i += 32) {
        const int x = __ldg(a.nbrs +
                            static_cast<long long>(ws.rec[i / L]) * L +
                            i % L);
        if (x >= 0) vis[x >> 5] = 0u;
      }
    } else {
      for (int i = lane; i < a.vwords; i += 32) vis[i] = 0u;
    }
  }
  word_outputs(a, b, W, lane, d0, k0, d1, k1, steps, scored);
  K5_MARK(kPhFinish);
  K5_PROF_END(steps);
}

// The modes' kernel for E L new entries a step and the bitmap.
template <int V, int JACC, bool VIS>
void (*word_modes_by_size(int nl))(WalkArgs, int) {
  return nl <= 32   ? word_walk_modes_kernel<V, JACC, 1, VIS>
         : nl <= 64  ? word_walk_modes_kernel<V, JACC, 2, VIS>
         : nl <= 128 ? word_walk_modes_kernel<V, JACC, 4, VIS>
                     : word_walk_modes_kernel<V, JACC, 8, VIS>;
}

template <int V, int JACC>
void (*word_modes_kernel(const WalkArgs& a))(WalkArgs, int) {
  const int nl = a.E * a.L;
  return a.vis != nullptr ? word_modes_by_size<V, JACC, true>(nl)
                          : word_modes_by_size<V, JACC, false>(nl);
}

// The vector width a row allows: 16-byte loads need a 16-byte aligned
// base, a row stride of whole 16-byte units and d a multiple of the unit.
// Word rows take the warp forms where they fit (kw_fits), else the block
// form; their modes run in another unit of the library (pgv_k4_word_walk).
template <typename T>
cudaError_t dispatch(const WalkArgs& a, int b, size_t smem,
                     cudaStream_t stream) {
  constexpr int V = std::is_same<T, unsigned>::value ? 4 : 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a.values) % 16 == 0 &&
                   (a.stride * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   a.d % V == 0;
#ifndef PGV_K4_WORDS_BLOCK  // probes/k4_words_profile.py's block-form build
  if constexpr (std::is_same<T, unsigned>::value) {
    if (kw_fits(a.d, a.W, a.L, a.S, a.m, a.upper_slot != nullptr)) {
      if (a.E != 1 || a.vis != nullptr)
        return static_cast<cudaError_t>(
            pgv_k4_word_walk(&a, vec ? 4 : 1, b, stream));
      return a.metric == 5 ? (vec ? launch_word_walk<4, 1>(a, b, stream)
                                  : launch_word_walk<1, 1>(a, b, stream))
                           : (vec ? launch_word_walk<4, 0>(a, b, stream)
                                  : launch_word_walk<1, 0>(a, b, stream));
    }
  }
#endif
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.exact != nullptr)
      return static_cast<cudaError_t>(pgv_k4_rank_walk(&a, b, smem, stream));
  }
  return vec ? launch<T, V, false>(a, b, smem, stream)
             : launch<T, 1, false>(a, b, smem, stream);
}

// ---------------------------------------------------------------------------
// K5: the scan segment, built for one query's latency
// ---------------------------------------------------------------------------

struct ScanArgs {
  const void* values;     // [>= cap + 1, d] rows, row stride `stride`
  long long stride;       // elements between consecutive rows
  const int* nbrs;        // [cap + 1, L] layer-0 ids (-1 pad)
  const uint8_t* trav;    // [cap + 1] live rows
  uint8_t* excl;          // [b, cap + 1] excluded rows (row `excl_stride`)
  long long excl_stride;
  unsigned* allowed;      // [b, words] bits of trav & !excl, or null
  const float* q;         // [b, d]
  const int* seed_ids;    // [b, S] (-1 = unused)
  const float* seed_d;    // [b, S]
  int* report;            // [b, 2 ef + 3]
  float* spill_d;         // [b, SP]
  int* spill_ids;         // [b, SP]
  int d, L, cap, words, S, W, ef, SP, max_steps, mark;
  int E;                  // members expanded a step
  const void* exact;      // bf16 ranking: the f32 rows (or null)
  long long exact_stride;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(a),
               "l"(src)
               : "memory");
}

// log2 of the slots of K5's id sets: at least twice the most ids one
// holds (the beam's W, the seeds' S, the finish's SP + W - ef; the beam's
// set holds up to W + NL within a step of NL new entries), >= 64.
__host__ __device__ inline int imax(int x, int y) { return x > y ? x : y; }

__host__ __device__ int scan_set_bits(int W, int S, int mm, int NL) {
  const int most = imax(imax(W, W + NL), imax(S, mm));
  int bits = 6;
  while ((1 << bits) < 2 * most) ++bits;
  return bits;
}

// The seeds' sort buffer: a power of two >= S.
__host__ __device__ int scan_sort_len(int S) {
  int n = 1;
  while (n < S) n <<= 1;
  return n;
}

// Entries of the seeds' / finish's buffer: the seeds' sort, or the
// leftover (W - ef) followed by its merge with the spill (SP + W - ef);
// when ranking in bf16 also the re-scored beam's sort (a power of two
// >= W).
__host__ __device__ int scan_buf_len(int S, int W, int ef, int SP,
                                     bool rank) {
  return imax(imax(scan_sort_len(S), SP + 2 * (W - ef)),
              rank ? scan_sort_len(W) : 0);
}

// The spill's pool: a power of two >= 2 SP, SP + NL and 64 (NL = E L the
// new entries of a step; SP + 4 NL at E > 1, whose steps evict E times as
// many), so that it takes many steps' evicted entries between two sorts.
__host__ __device__ int scan_pool_len(int SP, int NL, int E) {
  return scan_sort_len(imax(64, imax(2 * SP, SP + (E > 1 ? 4 : 1) * NL)));
}

size_t scan_smem_bytes(int words, int d, int L, int S, int W, int ef,
                       int SP, int E, bool rank) {
  const size_t dpad = (static_cast<size_t>(d) + 3) & ~static_cast<size_t>(3);
  const size_t x = scan_buf_len(S, W, ef, SP, rank);
  const size_t nl = static_cast<size_t>(E) * L;
  const size_t tbl = static_cast<size_t>(1)
                     << scan_set_bits(W, S, SP + W - ef, static_cast<int>(nl));
  // bitmap; q (and its bf16 rounding); beam x2; the spill's pool; new raw
  // and kept; the beam's id set; the seeds' / finish's id set and first
  // indices; the seeds' sort buffer, then the finish's merged spill; for
  // E > 1 the members a step expands, the beam's first E unexpanded
  // members, the step's compacted rows to score and their rank keys
  return 4 * (static_cast<size_t>(words) + dpad * (rank ? 2 : 1) +
              4 * static_cast<size_t>(W) +
              2 * static_cast<size_t>(
                      scan_pool_len(SP, static_cast<int>(nl), E)) +
              4 * nl + 3 * tbl + 2 * x +
              (E > 1 ? 2 * E + nl + 2 * (nl + 2) : 0));
}

// The sums of 8 rows ids[r] of `values` (row stride `stride`, d values;
// the lanes r < 8 hold the ids; `okm` bit r: row r is valid) against the
// query qs: lane l returns row (l >> 2) & 7's sum. Each lane's loads of
// the 8 rows are in flight together.
template <typename T, int V, int M>
__device__ __forceinline__ float score8(const T* values, long long stride,
                                        int d, const float* qs, int v,
                                        unsigned okm, int lane) {
  float acc[8];
  const T* rows[8];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int id = __shfl_sync(kFull, v, r);
    rows[r] = values + (((okm >> r) & 1u) ? static_cast<long long>(id) *
                                                stride
                                          : 0LL);
    acc[r] = 0;
  }
  const int nchunks = d / V;
  for (int c = lane; c < nchunks; c += 32) {
    float qv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) qv[e] = qs[c * V + e];
    float x[8][V];
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if ((okm >> r) & 1u) Load<T, V>::run(rows[r], c, x[r]);
#pragma unroll
    for (int r = 0; r < 8; ++r)
      if ((okm >> r) & 1u)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r] += term<M>(x[r][e], qv[e]);
  }
  // a transposed reduction: each exchange halves the values a lane holds,
  // so lane l ends with row (l >> 2) & 7's sum (9 shuffles, not 40)
  float v4[4], v2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v4[i] = (b4 ? acc[i + 4] : acc[i]) +
            __shfl_xor_sync(kFull, b4 ? acc[i] : acc[i + 4], 16);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v2[i] = (b3 ? v4[i + 2] : v4[i]) +
            __shfl_xor_sync(kFull, b3 ? v4[i] : v4[i + 2], 8);
  float v1 = (b2 ? v2[1] : v2[0]) +
           __shfl_xor_sync(kFull, b2 ? v2[0] : v2[1], 4);
  v1 += __shfl_xor_sync(kFull, v1, 2);
  v1 += __shfl_xor_sync(kFull, v1, 1);
  return v1;
}

// score8 for 16 rows (the lanes r < 16 hold the ids; `okm` bit r: row r
// is valid): lane l returns row (l >> 1) & 15's sum. K5's E > 1 step
// scores its new entries 16 rows a warp at once: 64 rows' loads in flight
// per block, twice score8's. It is score_raw<16> written out: through
// score_raw (transposed_sum) the step ran 5-7% slower.
template <typename T, int V, int M>
__device__ __forceinline__ float score16(const T* values, long long stride,
                                         int d, const float* qs, int v,
                                         unsigned okm, int lane) {
  float acc[16];
  const T* rows[16];
#pragma unroll
  for (int r = 0; r < 16; ++r) {
    const int id = __shfl_sync(kFull, v, r);
    rows[r] = values + (((okm >> r) & 1u) ? static_cast<long long>(id) *
                                                stride
                                          : 0LL);
    acc[r] = 0;
  }
  const int nchunks = d / V;
  for (int c = lane; c < nchunks; c += 32) {
    float qv[V];
#pragma unroll
    for (int e = 0; e < V; ++e) qv[e] = qs[c * V + e];
    typename Raw<T, V>::type raw[16];  // the 16 loads in flight
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if ((okm >> r) & 1u) raw[r] = Raw<T, V>::load(rows[r], c);
#pragma unroll
    for (int r = 0; r < 16; ++r)
      if ((okm >> r) & 1u) {
        float x[V];
        Raw<T, V>::unpack(raw[r], x);
#pragma unroll
        for (int e = 0; e < V; ++e) acc[r] += term<M>(x[e], qv[e]);
      }
  }
  // score8's transposed reduction, one level deeper
  float v8[8], v4[4], v2[2];
  const bool b4 = lane & 16, b3 = lane & 8, b2 = lane & 4, b1 = lane & 2;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    v8[i] = (b4 ? acc[i + 8] : acc[i]) +
            __shfl_xor_sync(kFull, b4 ? acc[i] : acc[i + 8], 16);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v4[i] = (b3 ? v8[i + 4] : v8[i]) +
            __shfl_xor_sync(kFull, b3 ? v8[i] : v8[i + 4], 8);
#pragma unroll
  for (int i = 0; i < 2; ++i)
    v2[i] = (b2 ? v4[i + 2] : v4[i]) +
            __shfl_xor_sync(kFull, b2 ? v4[i] : v4[i + 2], 4);
  float v1 = (b1 ? v2[1] : v2[0]) +
           __shfl_xor_sync(kFull, b1 ? v2[0] : v2[1], 2);
  v1 += __shfl_xor_sync(kFull, v1, 1);
  return v1;
}

// Sort (d, k) [n] (n a power of two) by (distance, key) in place: a
// bitonic sort by every thread of the block, a barrier per stage.
__device__ __forceinline__ void block_sort(float* d, int* k, int n, int tid) {
  for (int k2 = 2; k2 <= n; k2 <<= 1) {
    for (int j2 = k2 >> 1; j2 > 0; j2 >>= 1) {
      for (int i = tid; i < n / 2; i += kThreads) {
        const int lo = (i / j2) * 2 * j2 + i % j2, hi = lo + j2;
        if (before(d[hi], k[hi], d[lo], k[lo]) == ((lo & k2) == 0)) {
          const float t = d[lo];
          d[lo] = d[hi];
          d[hi] = t;
          const int tk = k[lo];
          k[lo] = k[hi];
          k[hi] = tk;
        }
      }
      __syncthreads();
    }
  }
}

// Sort the spill's pool [pc of pn] and keep its SP nearest (the padding
// sorts last). Once SP are kept, the SP-th is (tau_d, tau_k): an entry
// evicted later that is not nearer can never be among the SP nearest.
__device__ __forceinline__ int pool_trim(float* d, int* k, int pc, int pn,
                                         int SP, float& tau_d, int& tau_k,
                                         int tid) {
  for (int i = pc + tid; i < pn; i += kThreads) {
    d[i] = inf_f();
    k[i] = INT_MAX;
  }
  __syncthreads();
  block_sort(d, k, pn, tid);
  if (pc >= SP && SP > 0) {
    tau_d = d[SP - 1];
    tau_k = k[SP - 1];
  }
  return min(pc, SP);
}

// Merge the sorted lists A [na] and B [nb] into O [na + nb] (A before B
// among equals, the JAX concatenation's order). Every thread of the block
// calls it.
__device__ __forceinline__ void merge_lists(const float* ad, const int* ak,
                                            int na, const float* bd_,
                                            const int* bk_, int nb, float* od,
                                            int* ok, int tid) {
  for (int i = tid; i < na + nb; i += kThreads) {
    const bool from_a = i < na;
    const int j = from_a ? i : i - na;
    const float d = from_a ? ad[j] : bd_[j];
    const int k = from_a ? ak[j] : bk_[j];
    const int r = j + (from_a ? count_before(bd_, bk_, nb, d, k, true)
                              : count_before(ad, ak, na, d, k, false));
    od[r] = d;
    ok[r] = k;
  }
}

// A step's merge: the beam (cbd, cbk) [nb] and the kept new entries (sd,
// sk) [nn] (sorted; no id in both) into (obd, obk), the first W kept. An
// evicted entry nearer than (tau_d, tau_k) joins the spill's pool at
// atomicAdd(pool_n); the id set follows the beam (the new entries that
// stay enter, the beam entries that leave are erased and counted in
// `erased`); the next member's new place goes to npos. Every thread of the
// block calls it.
__device__ __forceinline__ void merge_step(
    const float* cbd, const int* cbk, int nb, const float* sd, const int* sk,
    int nn, float* obd, int* obk, int W, float* pd, int* pk, int* pool_n,
    float tau_d, int tau_k, int* set, int bits, int* erased, float nx_d,
    int nx_k, int* npos, int tid) {
  for (int i = tid; i < nb + nn; i += kThreads) {
    const bool from_beam = i < nb;
    const int j = from_beam ? i : i - nb;
    const float d = from_beam ? cbd[j] : sd[j];
    const int k = from_beam ? cbk[j] : sk[j];
    const int r = j + (from_beam ? count_before(sd, sk, nn, d, k, true)
                                 : count_before(cbd, cbk, nb, d, k, false));
    if (r < W) {
      obd[r] = d;
      obk[r] = k;
      if (!from_beam) set_insert(set, bits, k >> 1);
    } else {
      if (from_beam) {
        set[set_find(set, bits, k >> 1)] = -2;
        atomicAdd(erased, 1);
      }
      if (before(d, k, tau_d, tau_k)) {
        const int p = atomicAdd(pool_n, 1);
        pd[p] = d;
        pk[p] = k;
      }
    }
    if (k == nx_k && d == nx_d) *npos = r;
  }
}

// One segment of the resumable beam scan for query b (one block): K4's
// walk in the JAX order of _beam_scan_segment, built for one query's
// latency. Only finite entries are kept: an entry JAX keeps at an infinite
// distance (a duplicate, an invalid slot) changes no output (it sorts
// after every finite one, so it never displaces one, and its id is then
// also in the beam at a finite distance), so the beam holds its nb
// nearest finite entries.
// - The flags: `allowed` (bits of trav & !excl for this query) is staged in
//   shared memory at the start, so admitting a neighbour reads no global
//   memory (the global flags otherwise).
// - The rows: the L neighbours' rows load at once, 8 per warp.
// - The dedup: the beam's ids are kept in an id set (the merge inserts
//   the entries that enter and erases those that leave; rebuilt when the
//   erased slots fill it), so a new entry is one lookup; duplicates within
//   the list by __match_any_sync; warp 0 ranks the kept entries by
//   shuffles while the other warps find the beam's first unexpanded
//   member.
// - The ids: the next member to expand is the nearer of that member and
//   the nearest kept entry, known before the merge, so its neighbour ids
//   load while the merge runs.
// - The spill: JAX keeps the SP nearest of the spill and each step's
//   evicted tail, which is the SP nearest of everything evicted; the
//   evicted entries are appended to a pool, sorted and cut to SP only
//   when it fills and at the end, and once SP are kept an entry no nearer
//   than the SP-th is not appended. Three block barriers a step.
// Then the segment's finish (ops/beam._scan_finish): the top ef emitted
// (-1 ids at infinite distances), the width - ef leftover merged into the
// spill, the spill deduplicated by id (nearest copy) and cleared of the
// emitted ids, and, with `mark`, the emitted ids set in `excl` and cleared
// in `allowed`.
//
// The variants, as JAX's _beam_scan_segment runs them (no visited bitmap:
// the segment has none):
// - E > 1: a step expands the first E unexpanded members of the beam's
//   order, scores their E L neighbours (a repeat of an id in the step is
//   dropped, as every non-finite entry is) and merges them, the evicted
//   tail of E L entries joining the spill's pool. The step is laid out for
//   its latency as E = 1's is, over every warp:
//   * the E L ids of the step were loaded during the last merge (E L <=
//     256: two per thread);
//   * each id that may be walked is claimed in a step set (one copy of a
//     repeat goes on: every copy has the same row, distance and key), the
//     claimed ones count as scored (JAX's mask), and those not in the beam
//     are compacted (two barriers), so only their rows load: 16 rows a
//     warp at once (score16), one round trip for 64 rows;
//   * every thread ranks its entries by counting the 64-bit (distance,
//     key) keys below its own, two a shared-memory load (one pass, one
//     barrier), while warp 3 lists the beam's first E unexpanded members;
//     an entry after the full beam's last and the spill pool's cut can
//     enter neither, and is not ranked;
//   * the next step's members are the first E of the merge of that list
//     and the ranked entries, found before the merge by a merge path
//     (each warp alike, 32 members at a time: lane l takes the (t0 + l)-th
//     and its place in the merged beam; inside the first W, it stays a
//     member), so their E L ids load while the merge runs. Five block
//     barriers a step; the spill's pool is SP + 4 E L wide, so its sorts
//     come E times less often.
//   E > 1 is an instantiation of its own (MULTI): the E = 1 kernels, the
//   default's and bf16 ranking's, hold none of this step's code.
// - RANK: new candidates are ranked over the bf16 rows (score_rank: every
//   lane busy, the exact sums of the bf16 ranking's terms; V is
//   rank_width's chunk); after
//   the walk the beam is re-scored in f32 from `exact` and sorted again
//   before the finish, so the emitted top ef and the leftover carry exact
//   distances while the spill keeps its ranking ones.
template <typename T, int V, int M, bool RANK, bool MULTI>
__global__ void __launch_bounds__(kThreads) beam_scan_kernel(ScanArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int red[kWarps], red2[kWarps];
  __shared__ int s_npos, s_nn, s_ck, s_scored, s_pc, s_erased, s_nsel;
  __shared__ float s_cd;
  K5_PROF_BEGIN
  const int b = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int W = a.W, SP = a.SP, L = a.L, S = a.S, ef = a.ef;
  const int E = MULTI ? a.E : 1, NL = E * L;
  const int mm = SP + W - ef;
  const int s2 = scan_sort_len(S);
  const int pn = scan_pool_len(SP, NL, E);
  const int xn = scan_buf_len(S, W, ef, SP, RANK);
  const int bits = scan_set_bits(W, S, mm, NL);
  const int tbl = 1 << bits;
  const int nch = (L + 31) / 32;  // E = 1: warp 0's chunks of new entries
  const float inf = inf_f();
  const bool use_bm = a.allowed != nullptr;
  const int qpad = (a.d + 3) & ~3;

  unsigned* bm = reinterpret_cast<unsigned*>(smem);
  // E > 1: the step's rank keys (16-byte aligned: words is a multiple of 4)
  unsigned long long* nkey =
      reinterpret_cast<unsigned long long*>(bm + (use_bm ? a.words : 0));
  float* qs = reinterpret_cast<float*>(nkey + (E > 1 ? NL + 2 : 0));
  // RANK: the query rounded to bf16, after the f32 one
  __nv_bfloat16* qb = reinterpret_cast<__nv_bfloat16*>(qs + qpad);
  float* bd = qs + (RANK ? 2 : 1) * qpad;  // beam, 2 buffers of W
  int* bk = reinterpret_cast<int*>(bd + 2 * W);
  float* pd = reinterpret_cast<float*>(bk + 2 * W);  // the spill's pool
  int* pk = reinterpret_cast<int*>(pd + pn);
  float* nd = reinterpret_cast<float*>(pk + pn);  // new, list order
  int* nk = reinterpret_cast<int*>(nd + NL);
  float* sd = reinterpret_cast<float*>(nk + NL);  // new, kept and sorted
  int* sk = reinterpret_cast<int*>(sd + NL);
  int* hs = sk + NL;  // the beam's id set
  int* fk = hs + tbl;  // the seeds' / finish's id set
  int* fm = fk + tbl;  // its first index per id
  float* xd = reinterpret_cast<float*>(fm + tbl);  // seeds, then the finish
  int* xk = reinterpret_cast<int*>(xd + xn);
  int* sel = xk + xn;  // E > 1: the members a step expands (their places)
  int* au = sel + (E > 1 ? E : 0);  // the beam's first E unexpanded members
  int* cid = au + (E > 1 ? E : 0);  // the step's rows to score, compacted

  unsigned* gbm =
      use_bm ? a.allowed + static_cast<long long>(b) * a.words : nullptr;
  uint8_t* excl = a.excl + static_cast<long long>(b) * a.excl_stride;
  if (use_bm) {
    for (int i = tid * 4; i < a.words; i += kThreads * 4)
      cp_async16(bm + i, gbm + i);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  }
  const float* qg = a.q + static_cast<long long>(b) * a.d;
  for (int i = tid; i < a.d; i += kThreads) {
    qs[i] = qg[i];
    if (RANK) qb[i] = __float2bfloat16_rn(qg[i]);
  }
  for (int i = tid; i < tbl; i += kThreads) {
    hs[i] = -1;
    fk[i] = -1;
    fm[i] = INT_MAX;
  }
  if (tid == 0) s_scored = 0;
  if (use_bm) asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
  // row v (0 <= v <= cap) may be walked: live and not excluded
  auto allowed = [&](int v) -> bool {
    return use_bm ? ((bm[v >> 5] >> (v & 31)) & 1u) != 0
                  : (a.trav[v] && !excl[v]);
  };

  // ---- seeds: the admitted ones sorted by (distance, key), the first
  // copy of an id kept; the first W fill the beam, the next SP the spill
  const long long s0 = static_cast<long long>(b) * S;
  for (int i = tid; i < s2; i += kThreads) {
    const int id = i < S ? a.seed_ids[s0 + i] : -1;
    const float d = i < S ? a.seed_d[s0 + i] : inf;
    const bool ok = id >= 0 && d < inf && allowed(min(id, a.cap));
    xd[i] = ok ? d : inf;
    xk[i] = ok ? 2 * id + 1 : INT_MAX;
  }
  __syncthreads();
  block_sort(xd, xk, s2, tid);
  for (int i = tid; i < s2; i += kThreads)
    if (xk[i] != INT_MAX) atomicMin(fm + set_insert(fk, bits, xk[i] >> 1), i);
  __syncthreads();
  int nb = 0, pc = 0;
  {
    int kept = 0;
    for (int base = 0; base < s2; base += kThreads) {
      const int i = base + tid;
      const bool keep = i < s2 && xk[i] != INT_MAX &&
                        fm[set_find(fk, bits, xk[i] >> 1)] == i;
      const unsigned bal = __ballot_sync(kFull, keep);
      if (lane == 0) red[warp] = __popc(bal);
      __syncthreads();
      int r = kept + __popc(bal & ((1u << lane) - 1u)), total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        r += w < warp ? red[w] : 0;
        total += red[w];
      }
      if (keep && r < W) {
        bd[r] = xd[i];
        bk[r] = xk[i];
        set_insert(hs, bits, xk[i] >> 1);
      } else if (keep && r - W < SP) {
        pd[r - W] = xd[i];
        pk[r - W] = xk[i];
      }
      kept += total;
      __syncthreads();
    }
    nb = min(kept, W);
    pc = min(max(kept - W, 0), SP);
  }

  // ---- the walk; the first member to expand is the nearest seed
  int cur = 0, steps = 0, scored_w = 0, pos = 0, erased = 0;
  float tau_d = inf;  // the pool's cut, once it has one
  int tau_k = INT_MAX;
  bool go = nb > 0 && a.max_steps > 0 &&
            bd[0] <= (nb == W ? bd[W - 1] : inf);
  int u = go ? min(bk[0] >> 1, a.cap) : 0;
  const int jp = warp * 8 + (lane & 7);  // the id this lane prefetches
  int my_id = !MULTI && go && jp < L
                  ? a.nbrs[static_cast<long long>(u) * L + jp]
                  : -1;
  int nsel = 1;
  // E > 1: lane l of warp w prefetches the ids of new entries j =
  // ((l >> 4) + 2 s) * 64 + 16 w + (l & 15), s = 0, 1 (E L <= 256): slot
  // jo[s] of member jm[s] (INT_MAX past E L)
  int pid[2] = {-1, -1}, jm[2] = {INT_MAX, INT_MAX}, jo[2] = {0, 0};
  if constexpr (MULTI) {  // the first members: the nearest seeds
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int j = (((lane >> 4) + 2 * s) << 6) + (warp << 4) + (lane & 15);
      jm[s] = j < NL ? j / L : INT_MAX;
      jo[s] = j < NL ? j - jm[s] * L : 0;
    }
    nsel = min(E, nb);
    for (int i = tid; i < nsel; i += kThreads) sel[i] = i;
    for (int i = tid; i < tbl; i += kThreads) fk[i] = -1;  // the step's set
#pragma unroll
    for (int s = 0; s < 2; ++s)
      pid[s] = go && jm[s] < nsel
                   ? a.nbrs[static_cast<long long>(min(bk[jm[s]] >> 1,
                                                       a.cap)) * L + jo[s]]
                   : -1;
    __syncthreads();
  }
  K5_MARK(kPhStart);

  while (go) {
    float* cbd = bd + cur * W;
    int* cbk = bk + cur * W;
    if constexpr (!MULTI) {
      if (tid == 0) cbk[pos] &= ~1;  // expanded; read after the next barrier
    } else if (tid < nsel) {
      cbk[sel[tid]] &= ~1;
    }
    if (tid == 0) {
      s_cd = inf;
      s_ck = INT_MAX;
    }
    // (A) the id set rebuilt once erased slots fill a quarter of it; the
    // expanded member's neighbours scored: warp w takes rows [8w, 8w + 8),
    // then every 32nd group of 8
    if (4 * (nb + erased) > 3 * tbl ||
        (MULTI && 4 * (nb + erased + min(NL, W)) > 3 * tbl)) {
      for (int i = tid; i < tbl; i += kThreads) hs[i] = -1;
      __syncthreads();
      for (int i = tid; i < nb; i += kThreads) set_insert(hs, bits, cbk[i] >> 1);
      erased = 0;
      if constexpr (MULTI) __syncthreads();  // the E > 1 step reads it now
    }
#ifdef PGV_K5_PROFILE
    __syncthreads_or((MULTI ? pid[0] : my_id) == INT_MIN);  // the
    // prefetched ids have arrived
    K5_MARK(kPhIds);
#endif
    int nn;  // the kept new entries, sorted in (sd, sk)
    float nx_d = inf;  // E = 1: the next member, known before the merge
    int nx_k = INT_MAX;
    bool has_next = false;
    int un = 0;
    if constexpr (!MULTI) {
      for (int g0 = warp * 8; g0 < L; g0 += kWarps * 8) {
        const int j = g0 + (lane & 7);
        const int v =
            g0 == warp * 8
                ? my_id
                : (j < L ? a.nbrs[static_cast<long long>(u) * L + j] : -1);
        const bool ok = lane < 8 && j < L && v >= 0 && allowed(min(v, a.cap));
        const unsigned okm = __ballot_sync(kFull, ok);
        K5_MARK(kPhFlags);
        scored_w += __popc(okm);
        float sum;
        if constexpr (RANK)
          sum = score_rank<8, V, M>(static_cast<const T*>(a.values),
                                    a.stride, a.d, qb, v, okm, lane);
        else
          sum = score8<T, V, M>(static_cast<const T*>(a.values), a.stride,
                                a.d, qs, v, okm, lane);
        const int r = lane >> 2;  // the row whose sum this lane holds
        const int vr = __shfl_sync(kFull, v, r);
        if ((lane & 3) == 0 && g0 + r < L) {
          const bool okr = (okm >> r) & 1u;
          nd[g0 + r] = okr ? finish<M>(sum) : inf;
          nk[g0 + r] = okr ? 2 * vr + 1 : -2;
        }
      }
      __syncthreads();
      K5_MARK(kPhRows);

      // (B) warp 0: the new entries that are finite and no duplicate (of
      // the beam, or of one earlier in the list), ranked; the other warps:
      // the beam's first unexpanded member
      if (warp == 0) {
        // lane l holds entries l, 32 + l, ... (chunks; one at L <= 32)
        float d_[8];
        int k_[8];
        unsigned kb[8];
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          const int j = c * 32 + lane;
          d_[c] = j < L ? nd[j] : inf;
          k_[c] = j < L ? nk[j] : -2;
          bool keep = k_[c] >= 0 && d_[c] < inf;
          const unsigned same = __match_any_sync(kFull, k_[c]);
          bool rep = (same & ((1u << lane) - 1u)) != 0;
#pragma unroll 1
          for (int c2 = 0; c2 < c; ++c2)
            for (int i = 0; i < 32; ++i)
              if (__shfl_sync(kFull, k_[c2], i) == k_[c]) rep = true;
          if (rep) keep = false;
          if (keep && set_find(hs, bits, k_[c] >> 1) >= 0) keep = false;
          kb[c] = __ballot_sync(kFull, keep);
        }
        K5_MARK(kPhDedup);
        int nk_ = 0;
#pragma unroll 1
        for (int c = 0; c < nch; ++c) {
          const float dc = d_[c];
          const int kc = k_[c];
          int r = 0;
#pragma unroll 1
          for (int c2 = 0; c2 < nch; ++c2) {
            const float dc2 = d_[c2];
            const int kc2 = k_[c2];
            const unsigned kb2 = kb[c2];
#pragma unroll
            for (int i = 0; i < 32; ++i) {
              const float di = __shfl_sync(kFull, dc2, i);
              const int ki = __shfl_sync(kFull, kc2, i);
              r += ((kb2 >> i) & 1u) && before(di, ki, dc, kc);
            }
          }
          if ((kb[c] >> lane) & 1u) {
            sd[r] = dc;
            sk[r] = kc;
            if (r == 0) {
              s_cd = dc;
              s_ck = kc;
            }
          }
          nk_ += __popc(kb[c]);
        }
        if (lane == 0) s_nn = nk_;
        K5_MARK(kPhSort);
      } else {
        if (tid == 32) {  // read by every thread after the merge
          s_npos = INT_MAX;
          s_pc = pc;
          s_erased = 0;
        }
        int local = INT_MAX;
        for (int i = tid - 32; i < nb; i += kThreads - 32)
          if (cbk[i] & 1) local = min(local, i);
        local = __reduce_min_sync(kFull, local);
        if (lane == 0) red[warp] = local;
      }
      __syncthreads();

      // (C) the next member to expand, in every thread alike: the nearer of
      // the beam's first unexpanded member and the nearest kept entry; its
      // neighbour ids load now
      int bc = INT_MAX;
#pragma unroll
      for (int w = 1; w < kWarps; ++w) bc = min(bc, red[w]);
      nn = s_nn;
      nx_d = s_cd;
      nx_k = s_ck;
      if (bc != INT_MAX && before(cbd[bc], cbk[bc], nx_d, nx_k)) {
        nx_d = cbd[bc];
        nx_k = cbk[bc];
      }
      has_next = nx_d < inf;
      un = has_next ? min(nx_k >> 1, a.cap) : 0;
      if (has_next && jp < L)
        my_id = a.nbrs[static_cast<long long>(un) * L + jp];
      K5_MARK(kPhSelect);
    } else {
      // (A') E > 1: each prefetched id that may be walked is claimed in the
      // step's set (its one copy that goes on: JAX's batch dedup keeps the
      // first, and every copy has the same row, distance and key); the
      // claimed ones are the rows scored, and those not in the beam are
      // compacted into cid for scoring
      bool need[2];
      int slot[2];
      unsigned bal[2];
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const int v = pid[s];
        slot[s] = -1;
        bool first = false, fresh = false;
        if (v >= 0 && allowed(min(v, a.cap))) {
          first = set_claim(fk, bits, v, &slot[s]);
          fresh = first && set_find(hs, bits, v) < 0;
        }
        scored_w += __popc(__ballot_sync(kFull, first));
        need[s] = fresh;
        bal[s] = __ballot_sync(kFull, fresh);
      }
      if (lane == 0) {
        red[warp] = __popc(bal[0]);
        red2[warp] = __popc(bal[1]);
      }
      if (tid == 32) {  // read by every thread after the merge
        s_pc = pc;
        s_erased = 0;
      }
      __syncthreads();
      int S = 0, off0 = 0, off1 = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        off0 += w < warp ? red[w] : 0;
        off1 += w < warp ? red2[w] : 0;
        S += red[w];
      }
      off1 += S;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) S += red2[w];
      const unsigned lt = (1u << lane) - 1u;
      if (need[0]) cid[off0 + __popc(bal[0] & lt)] = pid[0];
      if (need[1]) cid[off1 + __popc(bal[1] & lt)] = pid[1];
#pragma unroll
      for (int s = 0; s < 2; ++s)
        if (slot[s] >= 0) fk[slot[s]] = -1;  // every claim is made
      __syncthreads();
      K5_MARK(kPhDedup);
      // the S compacted rows scored, 16 a warp at once
      for (int g0 = warp * 16; g0 < S; g0 += kWarps * 16) {
        const int c = g0 + (lane & 15);
        const int v = lane < 16 && c < S ? cid[c] : -1;
        const unsigned okm = __ballot_sync(kFull, lane < 16 && c < S);
        float sum;
        if constexpr (RANK)
          sum = score_rank<16, V, M>(static_cast<const T*>(a.values),
                                     a.stride, a.d, qb, v, okm, lane);
        else
          sum = score16<T, V, M>(static_cast<const T*>(a.values), a.stride,
                                 a.d, qs, v, okm, lane);
        const int r = lane >> 1;  // the row whose sum this lane holds
        const int vr = __shfl_sync(kFull, v, r);
        if ((lane & 1) == 0 && g0 + r < S) {
          const float dd = finish<M>(sum);
          const int kk = 2 * vr + 1;
          // one after the full beam's last and the pool's cut enters
          // neither the beam nor the spill: it is not ranked
          const bool drop = !(dd < inf) ||
                            (nb == W && !before(dd, kk, cbd[W - 1],
                                                cbk[W - 1]) &&
                             !before(dd, kk, tau_d, tau_k));
          nd[g0 + r] = dd;
          nkey[g0 + r] = drop ? ~0ull : rank_key(dd, kk);
        }
      }
      if (tid == 0) nkey[S] = ~0ull;  // the pair read past an odd S
      __syncthreads();
      K5_MARK(kPhRows);
      // (B') the ranked ones placed by every thread (each counts the keys
      // below its own, two a load); warp 3 finds the beam's first E
      // unexpanded members (au, in the beam's order)
      int kept = 0;
      const ulonglong2* kp = reinterpret_cast<const ulonglong2*>(nkey);
      for (int base = 0; base < S; base += kThreads) {
        const int j = base + tid;
        const unsigned long long kj = j < S ? nkey[j] : ~0ull;
        if (kj != ~0ull) {
          int r = 0;
#pragma unroll 4
          for (int i = 0; i < (S + 1) >> 1; ++i) {
            const ulonglong2 x = kp[i];
            r += (x.x < kj) + (x.y < kj);
          }
          sd[r] = nd[j];
          sk[r] = static_cast<int>(kj & 0xffffffffu);
        }
        kept += __popc(__ballot_sync(kFull, kj != ~0ull));
      }
      if (warp == kWarps - 1) {
        int got = 0;
        for (int base = 0; base < nb && got < E; base += 32) {
          const int i = base + lane;
          const unsigned mk = __ballot_sync(kFull, i < nb && (cbk[i] & 1));
          const int r = got + __popc(mk & lt);
          if (((mk >> lane) & 1u) && r < E) au[r] = i;
          got = min(E, got + __popc(mk));
        }
        if (lane == 0) s_nsel = got;
      }
      if (lane == 0) red2[warp] = kept;  // its last reader passed 2 barriers
      __syncthreads();
      K5_MARK(kPhSort);
      nn = red2[0] + red2[1] + red2[2] + red2[3];
      // (C') the next step's members, in every warp alike: lane l takes
      // the t-th (t = t0 + l, t < E, 32 at a time) of the merge of the
      // beam's unexpanded members (au) and the kept entries (sd), beam
      // first among equals (merge_step's order), and its place in the
      // merged beam; those inside the first W are the first E unexpanded
      // members there. Their neighbour ids load now.
      const int na = s_nsel, nb2 = min(W, nb + nn);
      int um[2] = {0, 0};  // the row of member jm[s]
      nsel = 0;
      for (int t0 = 0; t0 < E; t0 += 32) {
        const int t = t0 + lane;
        int ck = INT_MAX, cpos = INT_MAX;
        if (t < E && t < na + nn) {
          int lo = max(0, t - nn), hi = min(t, na);
          while (lo < hi) {  // the members of au among the first t
            const int mid = (lo + hi) >> 1;
            const int ia = au[mid], jb = t - 1 - mid;
            if (!before(sd[jb], sk[jb], cbd[ia], cbk[ia]))
              lo = mid + 1;
            else
              hi = mid;
          }
          const int y = t - lo;  // and of sd
          const bool from_beam =
              lo < na && (y >= nn || !before(sd[y], sk[y], cbd[au[lo]],
                                             cbk[au[lo]]));
          if (from_beam) {
            ck = cbk[au[lo]];
            cpos = au[lo] + y;
          } else {
            ck = sk[y];
            cpos = y + count_before(cbd, cbk, nb, sd[y], ck, false);
          }
        }
        const bool in = cpos < nb2;  // a prefix of the t
        const int got = __popc(__ballot_sync(kFull, in));
        nsel += got;
        if (warp == 0 && in) sel[t] = cpos;  // read after the merge
        const int us = in ? min(ck >> 1, a.cap) : 0;
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          const int x = __shfl_sync(kFull, us, jm[s] & 31);
          if (jm[s] >= t0 && jm[s] - t0 < 32) um[s] = x;
        }
        if (got < 32) break;  // the rest lie past the merged beam or E
      }
#pragma unroll
      for (int s = 0; s < 2; ++s)
        pid[s] = jm[s] < nsel
                     ? a.nbrs[static_cast<long long>(um[s]) * L + jo[s]]
                     : -1;
      K5_MARK(kPhSelect);
    }

    // (D) the kept entries merged into the beam, the evicted nearer than
    // the pool's cut appended to it (cut to the SP nearest first if it
    // could overflow)
    const int nb2 = min(W, nb + nn);
    if (pc + nb + nn - nb2 > pn) {
      pc = pool_trim(pd, pk, pc, pn, SP, tau_d, tau_k, tid);
      if (tid == 0) s_pc = pc;
      __syncthreads();
      K5_MARK(kPhSpillMerge);
    }
    merge_step(cbd, cbk, nb, sd, sk, nn, bd + (cur ^ 1) * W,
               bk + (cur ^ 1) * W, W, pd, pk, &s_pc, tau_d, tau_k, hs, bits,
               &s_erased, nx_d, nx_k, &s_npos, tid);
    __syncthreads();
    K5_MARK(kPhBeamMerge);
    pc = s_pc;
    erased += s_erased;
    nb = nb2;
    cur ^= 1;
    ++steps;
    // (E) JAX's loop condition on the merged beam: its first unexpanded
    // member is the next one, if that stayed in the beam (E > 1: the first
    // E unexpanded members, placed before the merge)
    const float* obd = bd + cur * W;
    if constexpr (!MULTI) {
      pos = s_npos;
      go = has_next && pos < nb && steps < a.max_steps &&
           obd[pos] <= (nb == W ? obd[W - 1] : inf);
      u = un;
    } else {
      pos = nsel > 0 ? sel[0] : 0;
      go = nsel > 0 && steps < a.max_steps &&
           obd[pos] <= (nb == W ? obd[W - 1] : inf);
    }
  }
  // the spill, sorted
  const int ns = pool_trim(pd, pk, pc, pn, SP, tau_d, tau_k, tid);
  K5_MARK(kPhSpillMerge);
  if constexpr (RANK) {  // the beam's exact distances, sorted again
    float* rbd = bd + cur * W;
    int* rbk = bk + cur * W;
    const int w2 = scan_sort_len(W);
    for (int g0 = warp * 8; g0 < nb; g0 += kWarps * 8) {
      const int j = g0 + (lane & 7);
      const int v = j < nb ? min(rbk[j] >> 1, a.cap) : 0;
      const unsigned okm = __ballot_sync(kFull, lane < 8 && j < nb);
      const float sum = score8<float, (V > 1 ? 4 : 1), M>(
          static_cast<const float*>(a.exact), a.exact_stride, a.d, qs, v,
          okm, lane);
      const int r = lane >> 2;
      if ((lane & 3) == 0 && g0 + r < nb) {
        xd[g0 + r] = finish<M>(sum);
        xk[g0 + r] = rbk[g0 + r];
      }
    }
    for (int i = nb + tid; i < w2; i += kThreads) {
      xd[i] = inf;
      xk[i] = INT_MAX;
    }
    __syncthreads();
    block_sort(xd, xk, w2, tid);
    for (int i = tid; i < nb; i += kThreads) {
      rbd[i] = xd[i];
      rbk[i] = xk[i];
    }
    __syncthreads();
  }

  // ---- the segment's finish (ops/beam._scan_finish)
  if (lane == 0) atomicAdd(&s_scored, scored_w);
  const float* cbd = bd + cur * W;
  const int* cbk = bk + cur * W;
  int* rep = a.report + static_cast<long long>(b) * (2 * ef + 3);
  // the beam is sorted by (distance, key): by (distance, id) too, as no
  // id is in it twice
  for (int i = tid; i < ef; i += kThreads) {
    rep[i] = __float_as_int(i < nb ? cbd[i] : inf);
    rep[ef + i] = i < nb ? cbk[i] >> 1 : -1;
  }
  // the leftover and the spill, as still-unexpanded keys, merged (spill
  // first among equals, the JAX concatenation's order)
  const int left = max(nb - ef, 0);
  for (int i = tid; i < ns; i += kThreads) pk[i] |= 1;
  for (int i = tid; i < left; i += kThreads) {
    xd[i] = cbd[ef + i];  // the seeds' buffer is free
    xk[i] = cbk[ef + i] | 1;
  }
  for (int i = tid; i < tbl; i += kThreads) {
    fk[i] = -1;
    fm[i] = INT_MAX;
  }
  __syncthreads();
  float* ed = xd + left;  // the merged list, after the leftover
  int* ek = xk + left;
  const int ne = ns + left;
  merge_lists(pd, pk, ns, xd, xk, left, ed, ek, tid);
  for (int i = tid; i < min(ef, nb); i += kThreads)  // emitted: never kept
    atomicMin(fm + set_insert(fk, bits, cbk[i] >> 1), -1);
  __syncthreads();
  for (int i = tid; i < ne; i += kThreads)
    atomicMin(fm + set_insert(fk, bits, ek[i] >> 1), i);
  __syncthreads();
  // keep the first copy of each id that was not emitted; write in order
  float* out_d = a.spill_d + static_cast<long long>(b) * SP;
  int* out_i = a.spill_ids + static_cast<long long>(b) * SP;
  int kept = 0;
  for (int base = 0; base < ne; base += kThreads) {
    const int i = base + tid;
    const bool keep = i < ne && fm[set_find(fk, bits, ek[i] >> 1)] == i;
    const unsigned bal = __ballot_sync(kFull, keep);
    if (lane == 0) red[warp] = __popc(bal);
    __syncthreads();
    int r = kept + __popc(bal & ((1u << lane) - 1u)), total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      r += w < warp ? red[w] : 0;
      total += red[w];
    }
    if (keep && r < SP) {
      out_d[r] = ed[i];
      out_i[r] = ek[i] >> 1;
    }
    kept += total;
    __syncthreads();
  }
  for (int r = min(kept, SP) + tid; r < SP; r += kThreads) {
    out_d[r] = inf;
    out_i[r] = -1;
  }
  if (a.mark) {  // the emitted ids leave the walk's rows for good
    for (int i = tid; i < min(ef, nb); i += kThreads) {
      const int v = min(cbk[i] >> 1, a.cap);
      excl[v] = 1;
      if (use_bm) atomicAnd(gbm + (v >> 5), ~(1u << (v & 31)));
    }
  }
  if (tid == 0) {
    rep[2 * ef] = steps;
    rep[2 * ef + 1] = s_scored;
    rep[2 * ef + 2] = min(kept, SP);
  }
  K5_MARK(kPhFinish);
  K5_PROF_END(steps);
}

// K5's instantiation for a metric, ranking as it sums (f32 sums over the
// stored rows); MULTI: E > 1 (the default walk, E = 1, is compiled
// without the E > 1 step, and the other way round).
template <typename T, int V, bool MULTI>
void (*scan_kernel(int metric))(ScanArgs) {
  switch (metric) {
    case 0: return beam_scan_kernel<T, V, 0, false, MULTI>;
    case 1: return beam_scan_kernel<T, V, 1, false, MULTI>;
    case 2: return beam_scan_kernel<T, V, 2, false, MULTI>;
    default: return beam_scan_kernel<T, V, 3, false, MULTI>;
  }
}

// The bf16 ranking's (bf16 rows with their f32 copy; l2, ip, cosine; V:
// rank_width's chunk).
template <int V, bool MULTI>
void (*rank_scan_kernel(int metric))(ScanArgs) {
  using T = __nv_bfloat16;
  return metric == 0   ? beam_scan_kernel<T, V, 0, true, MULTI>
         : metric == 1 ? beam_scan_kernel<T, V, 1, true, MULTI>
                       : beam_scan_kernel<T, V, 2, true, MULTI>;
}

cudaError_t launch_scan(void (*kern)(ScanArgs), const ScanArgs& a, int b,
                        size_t smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kern<<<b, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_scan(const ScanArgs& a, int metric, int b, size_t smem,
                          cudaStream_t stream) {
  const bool multi = a.E > 1;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (a.exact != nullptr)  // the entry takes it on bf16 rows only
      return static_cast<cudaError_t>(
          pgv_k4_rank_scan(&a, metric, b, smem, stream));
  }
  constexpr int V = 16 / sizeof(T);
  const bool vec = reinterpret_cast<uintptr_t>(a.values) % 16 == 0 &&
                   (a.stride * static_cast<long long>(sizeof(T))) % 16 == 0 &&
                   a.d % V == 0;
  return launch_scan(
      vec ? (multi ? scan_kernel<T, V, true>(metric)
                   : scan_kernel<T, V, false>(metric))
          : (multi ? scan_kernel<T, 1, true>(metric)
                   : scan_kernel<T, 1, false>(metric)),
      a, b, smem, stream);
}

}  // namespace

#ifdef PGV_K4_RANKED
// The bf16 ranking's launches, at rank_width's chunk: K4's walk, K5's
// segment.
int pgv_k4_rank_walk(const void* args, int b, size_t smem, void* stream) {
  using T = __nv_bfloat16;
  const WalkArgs& a = *static_cast<const WalkArgs*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rank_width(a.values, a.stride, a.d, a.exact, a.exact_stride)) {
    case 8: return static_cast<int>(launch<T, 8, true>(a, b, smem, st));
    case 4: return static_cast<int>(launch<T, 4, true>(a, b, smem, st));
    default: return static_cast<int>(launch<T, 1, true>(a, b, smem, st));
  }
}

int pgv_k4_rank_scan(const void* args, int metric, int b, size_t smem,
                     void* stream) {
  const ScanArgs& a = *static_cast<const ScanArgs*>(args);
  const bool multi = a.E > 1;
  void (*kern)(ScanArgs);
  switch (rank_width(a.values, a.stride, a.d, a.exact, a.exact_stride)) {
    case 8:
      kern = multi ? rank_scan_kernel<8, true>(metric)
                   : rank_scan_kernel<8, false>(metric);
      break;
    case 4:
      kern = multi ? rank_scan_kernel<4, true>(metric)
                   : rank_scan_kernel<4, false>(metric);
      break;
    default:
      kern = multi ? rank_scan_kernel<1, true>(metric)
                   : rank_scan_kernel<1, false>(metric);
  }
  return static_cast<int>(
      launch_scan(kern, a, b, smem, static_cast<cudaStream_t>(stream)));
}
#endif

#ifdef PGV_K4_MODES
// The modes' walks (beam_walk_var_kernel) at the row type and chunk width
// pgv_k4_beam_walk's dispatch chose.
int pgv_k4_var_walk(const void* args, int dtype, int v, int b, size_t smem,
                    void* stream) {
  const WalkArgs& a = *static_cast<const WalkArgs*>(args);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  void (*kern)(WalkArgs);
  switch (dtype) {
    case 0: kern = v == 4 ? var_kernel<float, 4, false>(a) : var_kernel<float, 1, false>(a); break;
    case 1: kern = v == 8 ? var_kernel<__half, 8, false>(a) : var_kernel<__half, 1, false>(a); break;
    case 2: kern = v == 8 ? var_kernel<__nv_bfloat16, 8, false>(a) : var_kernel<__nv_bfloat16, 1, false>(a); break;
    case 3: kern = v == 4 ? var_kernel<unsigned, 4, false>(a) : var_kernel<unsigned, 1, false>(a); break;
    default: kern = var_kernel<SparseRow, 1, false>(a);
  }
  return static_cast<int>(launch_kernel(kern, a, b, smem, st));
}
#endif

#ifdef PGV_K4_WORDS
// The word walk's modes (word_walk_modes_kernel) at the chunk width
// pgv_k4_beam_walk's dispatch chose; the bitmap's walks hold their visited
// sets in dynamic shared memory.
int pgv_k4_word_walk(const void* args, int v, int b, void* stream) {
  const WalkArgs& a = *static_cast<const WalkArgs*>(args);
  void (*kern)(WalkArgs, int) =
      v == 4 ? (a.metric == 5 ? word_modes_kernel<4, 1>(a)
                              : word_modes_kernel<4, 0>(a))
             : (a.metric == 5 ? word_modes_kernel<1, 1>(a)
                              : word_modes_kernel<1, 0>(a));
  const size_t smem =
      a.vis != nullptr ? kwQueries * (size_t{4} << kwVisBits) : 0;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<(b + kwQueries - 1) / kwQueries, kwQueries * 32, smem,
         static_cast<cudaStream_t>(stream)>>>(a, b);
  return static_cast<int>(cudaGetLastError());
}
#endif

#ifdef PGV_K4_BASE
extern "C" {

// The beam walk for b queries, one block each. dtype: 0 f32, 1 f16, 2 bf16
// rows with metric 0 l2, 1 ip, 2 cosine, 3 l1; 3 packed 32-bit words (d
// words per row and per query) with metric 4 hamming, 5 jaccard, serving
// mode only; 4 padded-CSR rows (d int32 indices in `values`, d f32 values
// in `values2`, the query d indices then d value bits: qd = 2d) with
// metric 0-3, serving mode only. qd: the query's 32-bit words (d, or 2d
// for sparse rows). S <= W seeds per query. Outputs as WalkArgs lists
// them.
//
// With upper_slot given, each query first descends the upper layers from
// `entry` (level entry_level; -1: an empty graph, no seed) as WalkArgs
// says, and the walk starts where it lands (S must be 1; seed_ids and
// seed_d are not read); land [b, 4] receives the landing.
//
// The variants (WalkArgs): E >= 1 members a step (E <= W, E L <=
// kMaxNew); vis [b, vwords] zeroed bitmaps (vwords >= (cap + 32) / 32),
// left zero on return, or null; exact (dtype 2, metric 0-2 only) the f32
// rows the bf16-ranked beam is re-scored from, or null.
int pgv_k4_beam_walk(const void* values, const void* values2, int dtype,
                     long long stride, int d, int qd,
                     const int* nbrs, int L, const uint8_t* trav, int cap,
                     int metric, const float* q, const int* seed_ids,
                     const float* seed_d, int b, int S, int W,
                     int max_steps, float* beam_d, int* beam_key,
                     int* steps, int* scored, const int* upper_slot,
                     const int* upper, long long ustride, int m, int entry,
                     int entry_level, int* land, int E, unsigned* vis,
                     int vwords, const void* exact, long long exact_stride,
                     void* stream) {
  const bool words = dtype == 3, sparse = dtype == 4;
  const bool desc = upper_slot != nullptr;
  if (b <= 0 || d <= 0 || L <= 0 || S < 0 || W <= 0 || S > W ||
      metric < 0 || metric > 5 || words != (metric >= 4) ||
      qd != (sparse ? 2 * d : d) || sparse != (values2 != nullptr) ||
      (desc && (S != 1 || upper == nullptr || land == nullptr || m < 1 ||
                m > L || entry > cap || ustride < static_cast<long long>(
                                                      entry_level) * m)) ||
      E < 1 || E > W || static_cast<long long>(E) * L > kMaxNew ||
      (vis != nullptr && vwords * 32LL < cap + 1LL) ||
      (exact != nullptr && (dtype != 2 || metric > 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const bool rank = exact != nullptr;
  size_t smem = smem_bytes(qd, L, S, W, E, rank);
  if (E != 1 || vis != nullptr) {
    smem = var_smem_offset(qd, L, S, W, E, rank) +
           var_smem_bytes(L, W, E, vis != nullptr, max_steps);
    if (vis != nullptr) smem += size_t{4} << var_vis_bits(smem);
  }
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  WalkArgs a{values, values2, stride, nbrs, trav, q, seed_ids, seed_d,
             beam_d, beam_key, steps, scored, d, qd, L, cap, metric, S, W,
             max_steps, upper_slot, upper, ustride, m, entry, entry_level,
             land, E, vis, vwords, exact, exact_stride};
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
    err = launch<SparseRow, 1, false>(a, b, smem, st);
  else
    err = cudaErrorInvalidValue;
  return static_cast<int>(err);
}

// K5: one scan segment for b queries, one block each, over dense rows
// (dtype 0 f32, 1 f16, 2 bf16; metric 0 l2, 1 ip, 2 cosine, 3 l1) at
// internal width W >= ef with a spill of SP: seeds [b, S] (int32 ids, -1
// unused), excl [b, cap + 1] (row excl_stride); allowed [b, words] (words
// a multiple of 4, the bits of trav & !excl) or null to read the flags
// from global memory. Writes report [b, 2 ef + 3] (the ef emitted
// distances' bits, their ids, steps, rows scored, spill entries kept),
// spill_d / spill_ids [b, SP]; with mark, sets the emitted ids in excl and
// clears them in allowed. E >= 1 members a step (E <= W, E L <= kMaxNew);
// exact (dtype 2, metric 0-2 only): the f32 rows of the bf16 ranking's
// re-score, or null.
int pgv_k5_beam_scan(const void* values, int dtype, long long stride, int d,
                     const int* nbrs, int L, const uint8_t* trav,
                     uint8_t* excl, long long excl_stride, unsigned* allowed,
                     int words, int cap, int metric, const float* q,
                     const int* seed_ids, const float* seed_d, int b, int S,
                     int W, int ef, int SP, int max_steps, int mark,
                     int* report, float* spill_d, int* spill_ids, int E,
                     const void* exact, long long exact_stride,
                     void* stream) {
  if (b <= 0 || d <= 0 || L <= 0 || S < 0 || ef <= 0 || W < ef || SP < 0 ||
      metric < 0 || metric > 3 || excl == nullptr || cap < 0 ||
      (allowed != nullptr && (words % 4 || words * 32LL < cap + 1LL)) ||
      E < 1 || E > W || static_cast<long long>(E) * L > kMaxNew ||
      (exact != nullptr && (dtype != 2 || metric > 2)))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = scan_smem_bytes(allowed != nullptr ? words : 0, d, L,
                                      S, W, ef, SP, E, exact != nullptr);
  if (smem > static_cast<size_t>(kMaxSmem))
    return static_cast<int>(cudaErrorInvalidValue);
  ScanArgs a{values, stride, nbrs, trav, excl, excl_stride, allowed, q,
             seed_ids, seed_d, report, spill_d, spill_ids, d, L, cap, words,
             S, W, ef, SP, max_steps, mark, E, exact, exact_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return static_cast<int>(dispatch_scan<float>(a, metric, b, smem, st));
  if (dtype == 1) return static_cast<int>(dispatch_scan<__half>(a, metric, b, smem, st));
  if (dtype == 2)
    return static_cast<int>(dispatch_scan<__nv_bfloat16>(a, metric, b, smem, st));
  return static_cast<int>(cudaErrorInvalidValue);
}

#ifdef PGV_K5_PROFILE
// The timing probe's buffer of kPhSlots counters (null: off).
int pgv_k5_profile(unsigned long long* buf) {
  return static_cast<int>(cudaMemcpyToSymbol(g_k5_prof, &buf, sizeof(buf)));
}
#endif

}  // extern "C"
#endif
