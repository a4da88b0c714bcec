// Device helpers shared by the sweep kernels (k1_topk.cu, k2_binned.cu,
// k3_tilemin.cu, k9_bits.cu, k10_sparse.cu): the warp-cooperative sorted
// top-k lists (of (score, id) pairs, or of 64-bit keys), the final top-k
// selection kernels, asynchronous copies (cp.async) into
// the swizzled shared-memory layout that Hopper's wgmma reads, and the
// wgmma instructions the sweeps issue. Everything is in an anonymous
// namespace: each translation unit keeps its own copy.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

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
// Warp-cooperative sorted list of unique 64-bit keys (K9, K10): a key holds
// a distance above a row, so the list's order never depends on the order
// in which rows are offered
// ---------------------------------------------------------------------------

constexpr unsigned long long kEmptyKey = ~0ull;

// Insert `key` (unique, smaller than l[k - 1]) into the ascending list
// l[0, k), dropping the last; called by all 32 lanes with the same key.
__device__ __forceinline__ void warp_insert_key(unsigned long long* l, int k,
                                                unsigned long long key,
                                                int lane) {
  int p = 0;
#pragma unroll
  for (int base = 0; base < kMaxK; base += 32) {
    const int j = base + lane;
    p += __popc(__ballot_sync(kFull, j < k && l[j] < key));
  }
  unsigned long long nv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r * 32 + lane;
    if (j < k) nv[r] = j < p ? l[j] : (j == p ? key : l[j - 1]);
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int j = r * 32 + lane;
    if (j < k) l[j] = nv[r];
  }
  __syncwarp();
}

// Each lane offers one key (kEmptyKey: none); those below the list's last
// enter it.
__device__ __forceinline__ void warp_offer_key(unsigned long long* l, int k,
                                               unsigned long long key,
                                               int lane) {
  unsigned m = __ballot_sync(kFull, key < l[k - 1]);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const unsigned long long ck = __shfl_sync(kFull, key, src);
    if (ck < l[k - 1]) warp_insert_key(l, k, ck, lane);
  }
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

template <bool PACKED>
cudaError_t launch_select(const float* cand_d, const int* cand_i,
                          const unsigned long long* packed, int b, int c,
                          int k, float* out_d, int* out_i, cudaStream_t st) {
  select_kernel<PACKED><<<(b + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                          kSelWarps * k * 8, st>>>(cand_d, cand_i, packed, b,
                                                   c, k, out_d, out_i);
  return cudaGetLastError();
}

// The k smallest of each query's c keys (part [b, c]) -> out [b, k],
// ascending, kEmptyKey past the keys: one warp per query (K9, K10).
__global__ void __launch_bounds__(kSelWarps * 32)
    key_select_kernel(const unsigned long long* __restrict__ part, int b,
                      int c, int k, unsigned long long* __restrict__ out) {
  extern __shared__ unsigned long long key_sel_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  unsigned long long* l = key_sel_smem + warp * k;
  const int qi = blockIdx.x * kSelWarps + warp;
  if (qi >= b) return;  // whole warp leaves; no block-wide barrier below
  for (int j = lane; j < k; j += 32) l[j] = kEmptyKey;
  __syncwarp();
  const unsigned long long* row = part + static_cast<long long>(qi) * c;
  for (int c0 = 0; c0 < c; c0 += 32) {
    const int j = c0 + lane;
    warp_offer_key(l, k, j < c ? row[j] : kEmptyKey, lane);
  }
  for (int j = lane; j < k; j += 32)
    out[static_cast<long long>(qi) * k + j] = l[j];
}

inline cudaError_t launch_key_select(const unsigned long long* part, int b,
                                     int c, int k, unsigned long long* out,
                                     cudaStream_t st) {
  key_select_kernel<<<(b + kSelWarps - 1) / kSelWarps, kSelWarps * 32,
                      kSelWarps * k * 8, st>>>(part, b, c, k, out);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Asynchronous copies into the wgmma 128-byte-swizzled layout
// ---------------------------------------------------------------------------
//
// A tile of R rows x 128 bytes (one pipeline unit of every row: 64 bf16 or
// 32 f32 of its features) is kept row after row, 128 bytes each, with the
// 16-byte segment j of row r stored at segment j ^ (r % 8): wgmma's K-major
// layout with the 128-byte swizzle (eight rows form a 1,024-byte atom, the
// descriptor's stride byte offset). Tiles start on 1,024-byte boundaries.
// The swizzle spreads the segments that the tensor cores read together,
// and those that a quarter warp copies, over all 32 banks.

constexpr int kUnitBytes = 128;  // bytes of each row per pipeline unit
constexpr int kSegBytes = 16;
constexpr int kAtomBytes = 1024;  // 8 rows x 128 bytes

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes, `bytes` of them read from src and the rest zero-filled.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Generic-proxy writes to shared memory (cp.async, st.shared) visible to
// the async proxy that wgmma reads through.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Row and column segment of segment s (0 <= s < R*8) of a tile: each
// warp's 32 segments cover 8 rows x 4 column segments, so a warp reads 64
// contiguous bytes of each of 8 rows from device memory, and each quarter
// warp writes 8 different rows (distinct banks after the swizzle).
template <int R>
__device__ __forceinline__ void seg_coords(int s, int& r, int& c) {
  int lane = s & 31, wi = s >> 5;
  r = (wi % (R / 8)) * 8 + (lane & 7);
  c = (wi / (R / 8)) * 4 + (lane >> 3);
}

// Byte offset of segment c of row r in the swizzled tile.
__device__ __forceinline__ int seg_offset(int r, int c) {
  return r * kUnitBytes + ((c ^ (r & 7)) * kSegBytes);
}

// Copy rows [0, R) x bytes [c0, c0 + 128) of a row-major matrix (row r at
// src + r * ld; `rows` rows and `width` bytes per row are valid) into the
// swizzled layout at dst; everything outside is zero. ALIGN is the
// largest copy that every row start allows: 16 (ld % 16 == 0), 4 (ld % 4
// == 0), or 2 (bf16 rows of odd length: synchronous loads). `safe` is any
// valid device address, given to copies that read nothing.
template <int ALIGN, int R, int T>
__device__ __forceinline__ void load_tile(uint32_t dst, const char* src,
                                          const char* safe, int rows, int ld,
                                          int width, int c0, int tid) {
  constexpr int kSegs = R * 8;
#pragma unroll
  for (int s0 = 0; s0 < kSegs; s0 += T) {
    int s = s0 + tid;
    if (kSegs % T != 0 && s >= kSegs) break;
    int r, c;
    seg_coords<R>(s, r, c);
    uint32_t to = dst + seg_offset(r, c);
    int col = c0 + c * kSegBytes;
    bool live = r < rows;
    const char* g = src + static_cast<size_t>(live ? r : 0) * ld + col;
    if (ALIGN == 16) {
      bool ok = live && col < width;
      cp_async16(to, ok ? g : safe, ok ? 16 : 0);
    } else if (ALIGN == 4) {
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        bool ok = live && col + 4 * p < width;
        cp_async4(to + 4 * p, ok ? g + 4 * p : safe, ok ? 4 : 0);
      }
    } else {
      uint32_t w[4];
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        unsigned lo = live && col + 4 * p < width
                          ? *reinterpret_cast<const uint16_t*>(g + 4 * p)
                          : 0u;
        unsigned hi = live && col + 4 * p + 2 < width
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

// Copy v[0, R) (R floats, `nv` of them valid, the rest zero) to dst.
template <int R>
__device__ __forceinline__ void load_vec(uint32_t dst, const float* v,
                                         const float* safe, int nv, int tid) {
  if (tid < R / 4) {
    int cnt = min(max(nv - tid * 4, 0), 4);
    cp_async16(dst + tid * 16, cnt > 0 ? v + tid * 4 : safe, cnt * 4);
  }
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// Matrix descriptor of a K-major operand in the swizzled layout above:
// start address (a tile's base plus 32 bytes per k-step inside the
// 128-byte row), stride byte offset 1,024 (the next 8 rows), layout type
// 1 (128-byte swizzle); the leading byte offset is unused by this layout.
__device__ __forceinline__ uint64_t make_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(kAtomBytes >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// The dynamic shared memory of a kernel, rounded up to a 1,024-byte
// boundary (the launch asks for kAtomBytes more than it uses).
__device__ __forceinline__ unsigned char* aligned_smem(unsigned char* raw) {
  uint32_t a = smem_addr(raw);
  return raw + ((kAtomBytes - (a & (kAtomBytes - 1))) & (kAtomBytes - 1));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

#define PGV_ACC32(d)                                                        \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),   \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),          \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),      \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),      \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),      \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),      \
      "+f"(d[31])

#define PGV_REGS32                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// D[64 x 64] (+)= A[64 x 16] . B[64 x 16]^T, bf16 operands, f32 sums; the
// sum restarts when accumulate == 0.
__device__ __forceinline__ void wgmma_bf16_m64n64k16(float (&d)[32],
                                                     uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PGV_REGS32
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PGV_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define PGV_ACC64(d)                                                        \
  PGV_ACC32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),         \
      "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),      \
      "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),      \
      "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),      \
      "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),      \
      "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),      \
      "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

#define PGV_REGS64                                                          \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63}"

// D[64 x 128] (+)= A[64 x 16] . B[128 x 16]^T, bf16 operands, f32 sums;
// the accumulator layout extends acc_row / acc_col to i < 64.
__device__ __forceinline__ void wgmma_bf16_m64n128k16(float (&d)[64],
                                                      uint64_t da,
                                                      uint64_t db,
                                                      int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PGV_REGS64
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PGV_ACC64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] . B[64 x 8]^T, tf32 operands (the low 13
// mantissa bits of each f32 are ignored), f32 sums.
__device__ __forceinline__ void wgmma_tf32_m64n64k8(float (&d)[32],
                                                    uint64_t da, uint64_t db,
                                                    int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 " PGV_REGS32
      ", %32, %33, p, 1, 1;\n}\n"
      : PGV_ACC32(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

#define PGV_ACC128(d)                                                       \
  PGV_ACC64(d), "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),         \
      "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]), "+f"(d[72]),      \
      "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]),      \
      "+f"(d[78]), "+f"(d[79]), "+f"(d[80]), "+f"(d[81]), "+f"(d[82]),      \
      "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),      \
      "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]),      \
      "+f"(d[93]), "+f"(d[94]), "+f"(d[95]), "+f"(d[96]), "+f"(d[97]),      \
      "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),   \
      "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), \
      "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), \
      "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), \
      "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), \
      "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])

#define PGV_REGS128                                                         \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, "  \
  "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, "  \
  "%58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, "  \
  "%72, %73, %74, %75, %76, %77, %78, %79, %80, %81, %82, %83, %84, %85, "  \
  "%86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "  \
  "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, "      \
  "%111, %112, %113, %114, %115, %116, %117, %118, %119, %120, %121, "      \
  "%122, %123, %124, %125, %126, %127}"

// D[64 x 256] (+)= A[64 x 8] . B[256 x 8]^T, tf32 operands, f32 sums; the
// accumulator layout extends acc_row / acc_col to i < 128.
__device__ __forceinline__ void wgmma_tf32_m64n256k8(float (&d)[128],
                                                     uint64_t da, uint64_t db,
                                                     int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 " PGV_REGS128
      ", %128, %129, p, 1, 1;\n}\n"
      : PGV_ACC128(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// Accumulator cell i (0 <= i < N / 2) of an m64nN wgmma lies at row
// acc_row(i) of the warp's 16 rows (warp w of the warpgroup owns rows
// 16w .. 16w + 15) and column acc_col(i).
__device__ __forceinline__ int acc_row(int i, int lane) {
  return (lane >> 2) + 8 * ((i >> 1) & 1);
}

__device__ __forceinline__ int acc_col(int i, int lane) {
  return 8 * (i >> 2) + 2 * (lane & 3) + (i & 1);
}

// Round to the nearest tf32 (kept in f32 with the low 13 bits zero).
__device__ __forceinline__ float to_tf32(float v) {
  uint32_t u;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(u) : "f"(v));
  return __uint_as_float(u);
}

}  // namespace
