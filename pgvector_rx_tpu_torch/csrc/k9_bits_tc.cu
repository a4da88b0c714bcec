// K9, the tensor-core form -- the bit sweep at 32 queries or more: exact
// top-k by hamming or jaccard, popcount(q AND x) taken as an int8 product.
//
// No Pallas ancestor: it replaces the MXU branch of the XLA program
// `_exact_search_bits` (pgvector_rx_tpu/graph/device.py:1155, the branch
// `mxu = B >= 32` at :1214), which unpacks each corpus chunk to bf16 {0,1}
// columns and takes one f32-accumulated product against the unpacked
// queries. Below 32 queries the JAX package takes XOR / AND plus
// population_count on the words, and so does the port (k9_bits.cu): the
// wrapper's rule is ops/bits._k9_form.
//
// What it computes, per query b over the rows whose `live` flag is set
// (the same values, the same keys as k9_bits.cu):
// - ab = popcount(q & x), exact: the u8 x u8 -> s32 product of the {0,1}
//   bytes of q and x;
// - hamming d = popq + popx - 2 ab; jaccard d = ab == 0 ? 1 : 1 - ab /
//   (popq + popx - ab), with IEEE division (f32 operands that are exact
//   integers, so d is bit-equal to the JAX package's f32 value); popx is
//   counted from the words the kernel expands (as JAX recounts each
//   chunk's), popq once per block;
// - the k smallest (d, row) pairs as 64-bit keys (d's f32 bits << 32 |
//   row), so the list's order never depends on block timing; a round of a
//   k > 64 query admits only keys >= `lo`.
//
// Bound on an H100 SXM, at the smoke's shape (1,024 queries x 1M rows x
// 256 bits): the product is 2 * 1,024 * 1M * 256 = 5.4e11 int8 operations,
// 0.27 ms at 1,979 TOP/s; the 32 MB of words take 0.01 ms. So it is bound
// by operations. What stands between it and the tensor cores is the
// integer work around them: expanding each packed bit to a byte (the
// operands wgmma takes) and turning each of the B x N sums into a key.
//
// Design (sm_90a, one warpgroup per block):
// - A block owns 64 queries (wgmma's m64) and a range of rows (a split);
//   the grid runs the query tiles of a split side by side (blockIdx.x
//   fastest) so a chunk of words is read from device memory about once.
// - The queries are expanded once per block into {0,1} bytes in wgmma's
//   128-byte-swizzled K-major layout (both operands must be K-major for
//   8-bit types) and stay resident; when 64 rows of them do not fit
//   beside the ring (thousands of bits), each unit of them is expanded
//   beside the corpus's instead.
// - The corpus streams packed, 128-row chunks in units of 128 bits (16
//   bytes a row, one eighth of K2's bf16 rows) through a 3-stage cp.async
//   ring. Thread t copies row t's 16 bytes of unit v + 2 and expands row
//   t of unit v + 1 (its own copy: no barrier between copy and expansion)
//   into the second of two byte tiles while the tensor cores run unit v
//   (wgmma m64 n128 k32, u8 x u8 -> s32, four per unit), as K1 splits its
//   tf32 halves. Words past w are zero-filled: they add nothing to ab.
// - The epilogue filters by threshold, as K1's does: each thread turns
//   its 64 accumulator cells into distances in registers (hamming in
//   integers, the rows' popcounts from shared memory) and tests each
//   against its query's threshold with no branch, into a mask; only the
//   cells where some lane of the warp may pass are then taken, in a
//   compact loop, tested exactly, and a ballot hands the survivors to
//   warp_insert_key. (A ballot, a branch and the inserts inlined at each
//   of the 64 cells made the epilogue 3.1 of the kernel's 3.9 ms on an
//   H100: probes/k9_cutout.py.) A warp's 16
//   queries are its own, so the lists need no block barrier; no rescore is
//   needed, the sums are exact.
// - A query's threshold is the lesser of its list's k-th key and a shared
//   one: each split's k-th key, once its list is full, goes to atomicMin
//   on a per-query key in device memory at a chunk's end, read back for
//   the next chunk. Every
//   split's k-th key bounds the global k-th from above, so the filter
//   drops nothing of the top k, while each split stops inserting rows the
//   other splits have already beaten (~90 inserts per query and split
//   without it).
// - A second kernel merges the splits' lists (launch_key_select).
// Measured: see PERF.md (K9 rows), timed by chip_smoke.py phase 21.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweep_common.cuh"

namespace {

constexpr int tcQ = 64;        // queries per block: wgmma's m64
constexpr int tcN = 128;       // corpus rows per chunk: wgmma's n128
constexpr int tcThreads = 128;  // one warpgroup; thread t owns chunk row t
constexpr int tcStages = 3;    // packed ring
constexpr int tcWordsPerUnit = 4;  // 128 bits = 128 bytes once expanded
constexpr int tcQUnit = tcQ * kUnitBytes;  // 8 KB
constexpr int tcXUnit = tcN * kUnitBytes;  // 16 KB
constexpr int tcPacked = tcN * kSegBytes;  // 2 KB: a unit's packed words
constexpr int tcMaxSmem = 232448;
constexpr int tcResidentMax = 112 * 1024;  // keep >= 2 blocks per SM
constexpr int tcBlocksPerSm = 3;  // the registers' bound (170 a thread)

// Shared memory: [query tiles: `units` resident, or 2][corpus tiles: 2]
// [packed ring][popx: 2 x tcN int][popq: tcQ int][lists: tcQ x k keys],
// plus the 1,024 bytes that align it.
__host__ __device__ constexpr int tc_q_bytes(bool qres, int units) {
  return (qres ? units : 2) * tcQUnit;
}

__host__ __device__ constexpr int tc_smem_bytes(bool qres, int units, int k) {
  return tc_q_bytes(qres, units) + 2 * tcXUnit + tcStages * tcPacked +
         2 * tcN * 4 + tcQ * 4 + tcQ * k * 8 + kAtomBytes;
}

// Four {0,1} bytes from the low 4 bits of x (bit i -> byte i).
__device__ __forceinline__ unsigned spread4(unsigned x) {
  return ((x & 0xFu) * 0x00204081u) & 0x01010101u;
}

// Word j (0..3) of row r's unit -> its 32 features as {0,1} bytes, in the
// swizzled tile at `tile`: segments 2j and 2j + 1 of the row. Words are
// MSB-first (ops/bits.pack_bits): feature t of the word is bit 31 - t.
__device__ __forceinline__ void expand_word(unsigned char* tile, int r, int j,
                                            unsigned word) {
  const unsigned rv = __brev(word);  // bit t = feature t
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const unsigned x = rv >> (16 * h);
    const uint4 o = make_uint4(spread4(x), spread4(x >> 4), spread4(x >> 8),
                               spread4(x >> 12));
    *reinterpret_cast<uint4*>(tile + seg_offset(r, 2 * j + h)) = o;
  }
}

#define PGV_IACC64(d)                                                       \
  "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3]), "+r"(d[4]), "+r"(d[5]),   \
      "+r"(d[6]), "+r"(d[7]), "+r"(d[8]), "+r"(d[9]), "+r"(d[10]),          \
      "+r"(d[11]), "+r"(d[12]), "+r"(d[13]), "+r"(d[14]), "+r"(d[15]),      \
      "+r"(d[16]), "+r"(d[17]), "+r"(d[18]), "+r"(d[19]), "+r"(d[20]),      \
      "+r"(d[21]), "+r"(d[22]), "+r"(d[23]), "+r"(d[24]), "+r"(d[25]),      \
      "+r"(d[26]), "+r"(d[27]), "+r"(d[28]), "+r"(d[29]), "+r"(d[30]),      \
      "+r"(d[31]), "+r"(d[32]), "+r"(d[33]), "+r"(d[34]), "+r"(d[35]),      \
      "+r"(d[36]), "+r"(d[37]), "+r"(d[38]), "+r"(d[39]), "+r"(d[40]),      \
      "+r"(d[41]), "+r"(d[42]), "+r"(d[43]), "+r"(d[44]), "+r"(d[45]),      \
      "+r"(d[46]), "+r"(d[47]), "+r"(d[48]), "+r"(d[49]), "+r"(d[50]),      \
      "+r"(d[51]), "+r"(d[52]), "+r"(d[53]), "+r"(d[54]), "+r"(d[55]),      \
      "+r"(d[56]), "+r"(d[57]), "+r"(d[58]), "+r"(d[59]), "+r"(d[60]),      \
      "+r"(d[61]), "+r"(d[62]), "+r"(d[63])

// D[64 x 128] (+)= A[64 x 32] . B[128 x 32]^T, u8 operands, s32 sums
// (exact); the accumulator layout is the f32 one (acc_row / acc_col).
__device__ __forceinline__ void wgmma_u8_m64n128k32(int (&d)[64], uint64_t da,
                                                    uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.u8.u8 " PGV_REGS64
      ", %64, %65, p;\n}\n"
      : PGV_IACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

struct TcArgs {
  const unsigned* words;         // [n, w]
  const uint8_t* live;           // [n]
  const unsigned* q;             // [b, w]
  const unsigned long long* lo;  // [b] first admitted key, or null
  int n, w, b, k, rows_per_split, units;
  unsigned long long* part;      // [b, splits, k]
  unsigned long long* shared;    // [b] the least k-th key of any split
};

// A key's distance as the epilogue compares it: hamming as the integer
// distance, jaccard as its f32 bits; the empty key's ~0u stays ~0u.
template <int JACC>
__device__ __forceinline__ unsigned key_dist(unsigned long long key) {
  const unsigned hi = static_cast<unsigned>(key >> 32);
  if (JACC || hi == 0xFFFFFFFFu) return hi;
  return static_cast<unsigned>(__uint_as_float(hi));
}

// A thread's thresholds, for its two queries (rows lane / 4 and lane / 4
// + 8 of its warp): the lesser of the list's k-th key and the shared key
// `sk`, as (distance, row); a padding query (past b) admits nothing.
struct Thr {
  unsigned d[2], r[2];
};

template <int JACC>
__device__ __forceinline__ Thr load_thr(const unsigned long long* lists,
                                        int k, int qa, int live_q,
                                        const unsigned long long (&sk)[2]) {
  Thr t;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const bool in = h < live_q;
    const unsigned long long key =
        in ? min(lists[(qa + 8 * h) * k + k - 1], sk[h]) : 0ull;
    t.d[h] = in ? key_dist<JACC>(key) : 0u;
    t.r[h] = in ? static_cast<unsigned>(key) : 0u;
  }
  return t;
}

template <int JACC, bool VEC, bool QRES, bool LO>
__global__ void __launch_bounds__(tcThreads, tcBlocksPerSm)
    k9_tc_kernel(TcArgs a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  unsigned char* smem = aligned_smem(smem_raw);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * tcQ;
  const int split = blockIdx.y;
  const int r0 = split * a.rows_per_split;
  const int r1 = min(a.n, r0 + a.rows_per_split);
  const int units = a.units;
  const int nchunks = r1 > r0 ? (r1 - r0 + tcN - 1) / tcN : 0;
  const int total = nchunks * units;

  unsigned char* qt = smem;
  unsigned char* xt = qt + tc_q_bytes(QRES, units);
  unsigned char* packed = xt + 2 * tcXUnit;
  int* popx = reinterpret_cast<int*>(packed + tcStages * tcPacked);  // [2][tcN]
  int* popq = popx + 2 * tcN;                                       // [tcQ]
  unsigned long long* lists =
      reinterpret_cast<unsigned long long*>(popq + tcQ);  // [tcQ][k]
  const uint32_t packed_s = smem_addr(packed);

  for (int i = tid; i < tcQ * a.k; i += tcThreads) lists[i] = kEmptyKey;
  if (tid < tcQ) {
    int s = 0;
    if (q0 + tid < a.b) {
      const unsigned* qr = a.q + static_cast<long long>(q0 + tid) * a.w;
      for (int c = 0; c < a.w; ++c) s += __popc(__ldg(qr + c));
    }
    popq[tid] = s;
  }
  // query word c of tile row r (zero past the queries and past w)
  auto qword = [&](int r, int c) -> unsigned {
    return (q0 + r < a.b && c < a.w)
               ? __ldg(a.q + static_cast<long long>(q0 + r) * a.w + c)
               : 0u;
  };
  if (QRES) {
    const int wpr = units * tcWordsPerUnit;
    for (int e = tid; e < tcQ * wpr; e += tcThreads) {
      const int r = e / wpr, c = e - r * wpr;
      expand_word(qt + (c / tcWordsPerUnit) * tcQUnit, r, c % tcWordsPerUnit,
                  qword(r, c));
    }
  }

  // unit v's packed words of chunk row `tid` -> ring stage v % tcStages
  auto issue = [&](int v) {
    if (v < total) {
      const int ci = v / units, u = v - ci * units;
      const int row = r0 + ci * tcN + tid;
      const bool ok = row < r1;
      const unsigned* src =
          a.words + static_cast<long long>(ok ? row : 0) * a.w +
          u * tcWordsPerUnit;
      const uint32_t dst = packed_s + (v % tcStages) * tcPacked + tid * 16;
      if (VEC) {
        cp_async16(dst, ok ? src : a.words, ok ? 16 : 0);
      } else {
#pragma unroll
        for (int p = 0; p < tcWordsPerUnit; ++p) {
          const bool in = ok && u * tcWordsPerUnit + p < a.w;
          cp_async4(dst + 4 * p, in ? src + p : a.words, in ? 4 : 0);
        }
      }
    }
    cp_async_commit();
  };
  // unit v: this thread's row of packed words -> bytes in corpus tile v & 1
  // (its popcount added to the row's; stored at the chunk's last unit);
  // streamed queries: this thread's two words of each of its query row's
  // unit -> query tile v & 1
  int rowpop = 0;
  auto expand = [&](int v) {
    if (v >= total) return;
    const int ci = v / units, u = v - ci * units;
    const uint4 wv = *reinterpret_cast<const uint4*>(
        packed + (v % tcStages) * tcPacked + tid * 16);
    unsigned char* tile = xt + (v & 1) * tcXUnit;
    expand_word(tile, tid, 0, wv.x);
    expand_word(tile, tid, 1, wv.y);
    expand_word(tile, tid, 2, wv.z);
    expand_word(tile, tid, 3, wv.w);
    rowpop += __popc(wv.x) + __popc(wv.y) + __popc(wv.z) + __popc(wv.w);
    if (u == units - 1) {
      const int row = r0 + ci * tcN + tid;
      popx[(ci & 1) * tcN + tid] = (row < r1 && a.live[row]) ? rowpop : -1;
      rowpop = 0;
    }
    if (!QRES) {
      const int r = tid >> 1, j0 = (tid & 1) * 2;
      unsigned char* qtile = qt + (v & 1) * tcQUnit;
#pragma unroll
      for (int p = 0; p < 2; ++p)
        expand_word(qtile, r, j0 + p,
                    qword(r, u * tcWordsPerUnit + j0 + p));
    }
  };

  int acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0;
  // this thread's two queries: rows lane / 4 and lane / 4 + 8 of its warp
  const int qa = warp * 16 + (lane >> 2);
  const int live_q = (q0 + qa < a.b) + (q0 + qa + 8 < a.b);
  unsigned lo_d[2], lo_r[2];
  int qp[2];
  Thr thr;
  for (int v = 0; v < tcStages - 1; ++v) issue(v);
  cp_async_wait<tcStages - 2>();  // this thread's copies of unit 0
  expand(0);
  fence_async_smem();
  __syncthreads();  // tiles, lists and popq are in place
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    qp[h] = popq[qa + 8 * h];
    const int qi = q0 + qa + 8 * h;
    const unsigned long long l =
        !LO ? 0ull : (qi < a.b ? a.lo[qi] : kEmptyKey);
    lo_d[h] = key_dist<JACC>(l);
    lo_r[h] = static_cast<unsigned>(l);
  }
  // the shared keys of this thread's queries: read one chunk ahead (the
  // load's latency hides behind a unit), offered back at a chunk's end
  unsigned long long* gq = a.shared + q0 + qa;
  unsigned long long sk[2], sk_next[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    sk[h] = sk_next[h] = h < live_q ? __ldcg(gq + 8 * h) : kEmptyKey;
  thr = load_thr<JACC>(lists, a.k, qa, live_q, sk);

  for (int v = 0; v < total; ++v) {
    // unit v is expanded by every thread; every wgmma of unit v - 1 is done
    const int ci = v / units, u = v - ci * units;
    issue(v + tcStages - 1);
    const uint32_t qo = smem_addr(qt + (QRES ? u : (v & 1)) * tcQUnit);
    const uint32_t xo = smem_addr(xt + (v & 1) * tcXUnit);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)  // 4 x k32 (32 bytes) = the unit
      wgmma_u8_m64n128k32(acc, make_desc(qo + 32 * kk),
                          make_desc(xo + 32 * kk), (u > 0 || kk > 0) ? 1 : 0);
    wgmma_commit();
    // while the tensor cores run unit v: expand unit v + 1 (other tiles)
    cp_async_wait<tcStages - 2>();  // this thread's copies of unit v + 1
    expand(v + 1);
    wgmma_wait_all();

    if (u == units - 1) {  // the chunk's sums are complete
      // this thread's columns 8 g + 2 (lane % 4) + e: their rows and the
      // rows' popcounts (px, -1: dead, or past the split)
      const unsigned rowb = r0 + ci * tcN + 2 * (lane & 3);
      const int* px = popx + (ci & 1) * tcN + 2 * (lane & 3);
#pragma unroll
      for (int h = 0; h < 2; ++h) sk[h] = sk_next[h];
      thr = load_thr<JACC>(lists, a.k, qa, live_q, sk);
      // 1. which cells may pass, without a branch: hamming exactly;
      // jaccard from a fast division, with a margin above its error
      // (< 4e-7: __fdividef's 2 ulp below 1, and the subtraction's)
      float thr_f[2];
#pragma unroll
      for (int h = 0; h < 2; ++h)
        thr_f[h] = thr.d[h] == 0xFFFFFFFFu ? CUDART_INF_F
                                          : __uint_as_float(thr.d[h]);
      unsigned may[2] = {0u, 0u};
#pragma unroll
      for (int i = 0; i < 64; ++i) {
        const int h = (i >> 1) & 1;
        const int p = px[8 * (i >> 2) + (i & 1)];
        const unsigned row = rowb + 8 * (i >> 2) + (i & 1);
        bool m;
        if (JACC) {
          const float d =
              acc[i] == 0 ? 1.0f
                          : 1.0f - __fdividef(static_cast<float>(acc[i]),
                                              static_cast<float>(
                                                  qp[h] + p - acc[i]));
          m = (p >= 0) & (d - 1e-6f <= thr_f[h]);
        } else {
          const unsigned dk = static_cast<unsigned>(qp[h] + p - 2 * acc[i]);
          m = (p >= 0) &
              ((dk < thr.d[h]) | ((dk == thr.d[h]) & (row < thr.r[h])));
        }
        may[i >> 5] |= static_cast<unsigned>(m) << (i & 31);
      }
      // 2. the cells where some lane may pass, in order (a compact loop:
      // unrolled 64 times, this part overflowed the instruction cache): the
      // exact test against the current thresholds, a ballot, the inserts
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        unsigned wm = __reduce_or_sync(kFull, may[half]);
        while (wm) {
          const int j = __ffs(wm) - 1;
          wm &= wm - 1;
          int ab = 0;  // acc[32 half + j], by selects (no local memory)
#pragma unroll
          for (int c = 0; c < 32; ++c) ab = j == c ? acc[32 * half + c] : ab;
          const int i = 32 * half + j;
          const bool h = (i >> 1) & 1;  // selects, not indices: no local
          const int qph = h ? qp[1] : qp[0];  // memory
          const unsigned td = h ? thr.d[1] : thr.d[0];
          const unsigned tr = h ? thr.r[1] : thr.r[0];
          const int p = px[8 * (i >> 2) + (i & 1)];
          const unsigned row = rowb + 8 * (i >> 2) + (i & 1);
          unsigned dk;
          if (JACC) {
            const float d =
                ab == 0 ? 1.0f
                        : 1.0f - __fdiv_rn(static_cast<float>(ab),
                                           static_cast<float>(qph + p - ab));
            dk = __float_as_uint(d);
          } else {
            dk = static_cast<unsigned>(qph + p - 2 * ab);
          }
          bool pass = p >= 0 && (dk < td || (dk == td && row < tr));
          if (LO) {
            const unsigned ld = h ? lo_d[1] : lo_d[0];
            const unsigned lr = h ? lo_r[1] : lo_r[0];
            pass = pass && (dk > ld || (dk == ld && row >= lr));
          }
          unsigned m = __ballot_sync(kFull, pass);
          if (m) {  // the survivors go in one by one
            const unsigned long long key =
                (static_cast<unsigned long long>(
                     JACC ? dk : __float_as_uint(static_cast<float>(dk)))
                 << 32) |
                row;
            const int qbase = warp * 16 + (h ? 8 : 0);
            do {
              const int src = __ffs(m) - 1;
              m &= m - 1;
              const unsigned long long ck = __shfl_sync(kFull, key, src);
              unsigned long long* l = lists + (qbase + (src >> 2)) * a.k;
              if (ck < l[a.k - 1]) warp_insert_key(l, a.k, ck, lane);
            } while (m);
            thr = load_thr<JACC>(lists, a.k, qa, live_q, sk);
          }
        }
      }
      // offer the lists' k-th keys to the shared ones (a list that is not
      // full offers the empty key, which changes nothing); read them back
      // for the next chunk
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        if (h < live_q) {
          const unsigned long long t = lists[(qa + 8 * h) * a.k + a.k - 1];
          if ((lane & 3) == 0 && t < sk[h]) atomicMin(gq + 8 * h, t);
          sk_next[h] = __ldcg(gq + 8 * h);
        }
      }
    }
    fence_async_smem();
    __syncthreads();
  }
  cp_async_wait<0>();

  __syncwarp();  // a warp writes its own 16 queries' lists
  for (int e = lane; e < 16 * a.k; e += 32) {
    const int ql = warp * 16 + e / a.k, j = e % a.k;
    const int qi = q0 + ql;
    if (qi < a.b)
      a.part[(static_cast<long long>(qi) * gridDim.y + split) * a.k + j] =
          lists[ql * a.k + j];
  }
}

template <int JACC, bool VEC, bool QRES, bool LO>
cudaError_t launch_tc(const TcArgs& a, dim3 grid, int smem, cudaStream_t st) {
  auto kern = k9_tc_kernel<JACC, VEC, QRES, LO>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  kern<<<grid, tcThreads, smem, st>>>(a);
  return cudaGetLastError();
}

template <int JACC, bool VEC, bool QRES>
cudaError_t launch_lo(const TcArgs& a, dim3 grid, int smem, cudaStream_t st) {
  return a.lo != nullptr ? launch_tc<JACC, VEC, QRES, true>(a, grid, smem, st)
                         : launch_tc<JACC, VEC, QRES, false>(a, grid, smem, st);
}

template <int JACC, bool VEC>
cudaError_t launch_res(const TcArgs& a, dim3 grid, bool qres, int smem,
                       cudaStream_t st) {
  return qres ? launch_lo<JACC, VEC, true>(a, grid, smem, st)
              : launch_lo<JACC, VEC, false>(a, grid, smem, st);
}

}  // namespace

extern "C" {

// Shared memory of a K9 tensor-core block for w words per row and lists of
// k (what ops/bits._k9_tc_smem mirrors), and whether the queries stay
// resident.
int pgv_k9_tc_smem(int w, int k, int* resident) {
  const int units = (w + tcWordsPerUnit - 1) / tcWordsPerUnit;
  const bool qres = tc_smem_bytes(true, units, k) <= tcResidentMax;
  if (resident != nullptr) *resident = qres;
  return tc_smem_bytes(qres, units, k);
}

// K9's tensor-core form for b queries over n rows of w words: metric 0
// hamming, 1 jaccard; lo [b] or null. The grid is (ceil(b / 64), splits),
// split s covering rows [s * rows_per_split, +rows_per_split),
// rows_per_split a multiple of 128. part [b, splits, k] is scratch,
// shared [b] too (all ones at the launch); out [b, k] the keys (d bits <<
// 32 | row), ascending, ~0 empty.
int pgv_k9_bits_tc_topk(const unsigned* words, const uint8_t* live,
                        const unsigned* q, const unsigned long long* lo, int n,
                        int w, int b, int k, int metric, int splits,
                        int rows_per_split, unsigned long long* part,
                        unsigned long long* shared, unsigned long long* out,
                        void* stream) {
  if (n <= 0 || w <= 0 || b <= 0 || k < 1 || k > kMaxK || splits <= 0 ||
      splits > 65535 || rows_per_split <= 0 || rows_per_split % tcN ||
      metric < 0 || metric > 1 || shared == nullptr ||
      static_cast<long long>(splits) * rows_per_split < n)
    return static_cast<int>(cudaErrorInvalidValue);
  int qres = 0;
  const int smem = pgv_k9_tc_smem(w, k, &qres);
  if (smem > tcMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  TcArgs a{words, live, q, lo, n, w, b, k, rows_per_split,
           (w + tcWordsPerUnit - 1) / tcWordsPerUnit, part, shared};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid((b + tcQ - 1) / tcQ, splits);
  const bool vec =
      w % 4 == 0 && reinterpret_cast<uintptr_t>(words) % 16 == 0;
  cudaError_t err;
  if (metric == 1)
    err = vec ? launch_res<1, true>(a, grid, qres, smem, st)
              : launch_res<1, false>(a, grid, qres, smem, st);
  else
    err = vec ? launch_res<0, true>(a, grid, qres, smem, st)
              : launch_res<0, false>(a, grid, qres, smem, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(launch_key_select(part, b, splits * k, k, out, st));
}

}  // extern "C"
