"""Timing experiment: K9's tensor-core form with parts cut out.

    python -m pgvector_rx_tpu_torch.probes.k9_cutout [--rows N]

Needs one NVIDIA Hopper card and ``nvcc``. Each variant is a patched copy
of ``csrc/k9_bits_tc.cu``, built side by side into its own library under
``pgvector_rx_tpu_torch/_build/k9_cutout/`` and called through the same C
entry point at 1,024 queries x N rows (default 1,000,000) x 256 bits, k =
10, hamming, on ``chip_smoke.py`` phase 21's data (sign bits of
``make_dataset(N, 256, 1024, seed=7, intrinsic=24)``); the variants run in
turns, twice, and each prints its mean time over 10 launches (CUDA
events) and whether its keys equal the plain version's (only "as built"
must):

- as built;
- no epilogue (a chunk's sums fold into one register, no list is kept);
- mask only (the epilogue's branch-free test of every cell, then
  nothing);
- no wgmma (the products are skipped; the sums stay 0);
- no expansion (the corpus words are copied and counted but never
  expanded to bytes: the tensor cores read stale tiles);
- no corpus copies (only the first units are copied);
- max shared carveout (the launch asks for the largest shared-memory
  share of the SM's L1 first).

Then "as built" at 1, 2 and 3 blocks per SM (the grid's splits), beside
the blocks per SM the occupancy calculator allows; and a counted copy of
"as built": per warp and chunk, the epilogue's cells that some lane may
pass, the candidates offered to the lists, and the inserts.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import numpy as np
import torch

from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.ops import bits
from pgvector_rx_tpu_torch.ops import bruteforce as bf

B, K = 1024, 10

_EPILOGUE = "    if (u == units - 1) {  // the chunk's sums are complete"
_WGMMA = """    for (int kk = 0; kk < 4; ++kk)  // 4 x k32 (32 bytes) = the unit
      wgmma_u8_m64n128k32(acc, make_desc(qo + 32 * kk),
                          make_desc(xo + 32 * kk), (u > 0 || kk > 0) ? 1 : 0);"""
_EXPAND = """    expand_word(tile, tid, 0, wv.x);
    expand_word(tile, tid, 1, wv.y);
    expand_word(tile, tid, 2, wv.z);
    expand_word(tile, tid, 3, wv.w);"""
_COPY = "    if (v < total) {\n      const int ci = v / units, u = v - ci * units;\n      const int row ="


def _patched(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"k9_bits_tc.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """Variant name -> patched source of ``csrc/k9_bits_tc.cu``."""
    fold = ("    if (u == units - 1) {\n      int f = 0;\n"
            "#pragma unroll\n      for (int i = 0; i < 64; ++i) f ^= acc[i];\n"
            "      if (f == 0x12345) lists[tid] = f;\n    }\n"
            "    if (false) {")
    return {
        "as built": src + _OCCUPANCY,
        "no epilogue": _patched(src, (_EPILOGUE, fold)),
        "mask only": _patched(src, (
            "        unsigned wm = __reduce_or_sync(kFull, may[half]);",
            "        unsigned wm = __reduce_or_sync(kFull, may[half]) == "
            "0x12345678u;")),
        "no wgmma": _patched(src, (
            _WGMMA, "    for (int kk = 0; kk < 1; ++kk)\n"
                    "      acc[kk] += static_cast<int>(qo ^ xo);")),
        "no expansion": _patched(src, (_EXPAND, "")),
        "no corpus copies": _patched(src, (
            _COPY, _COPY.replace("v < total", "v < total && v < tcStages - 1"))),
        "counted": _patched(src, *_COUNTS) + _COUNT_API,
        "max shared carveout": _patched(src, (
            "  if (err != cudaSuccess) return err;\n  kern<<<",
            "  if (err != cudaSuccess) return err;\n"
            "  err = cudaFuncSetAttribute(\n"
            "      kern, cudaFuncAttributePreferredSharedMemoryCarveout,\n"
            "      cudaSharedmemCarveoutMaxShared);\n"
            "  if (err != cudaSuccess) return err;\n  kern<<<")),
    }


_COUNTS = (
    ("namespace {\n\nconstexpr int tcQ",
     "namespace {\n__device__ unsigned long long g_k9_count[4];\n\n"
     "constexpr int tcQ"),
    ("          const int j = __ffs(wm) - 1;",
     "          const int j = __ffs(wm) - 1;\n"
     "          if (lane == 0) atomicAdd(g_k9_count + 0, 1ull);"),
    ("              if (ck < l[a.k - 1]) warp_insert_key(l, a.k, ck, lane);",
     "              if (lane == 0) atomicAdd(g_k9_count + 1, 1ull);\n"
     "              if (ck < l[a.k - 1]) {\n"
     "                if (lane == 0) atomicAdd(g_k9_count + 2, 1ull);\n"
     "                warp_insert_key(l, a.k, ck, lane);\n              }"),
    ("      const unsigned rowb = r0 + ci * tcN + 2 * (lane & 3);",
     "      const unsigned rowb = r0 + ci * tcN + 2 * (lane & 3);\n"
     "      if (lane == 0) atomicAdd(g_k9_count + 3, 1ull);"),
)
_COUNT_API = """
extern "C" int pgv_k9_counts(unsigned long long* out, int reset) {
  if (reset) {
    unsigned long long z[4] = {0, 0, 0, 0};
    return static_cast<int>(cudaMemcpyToSymbol(g_k9_count, z, sizeof(z)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_k9_count,
                                               4 * sizeof(*out)));
}
"""

_OCCUPANCY = """
extern "C" int pgv_k9_tc_occupancy(int w, int k, int* blocks) {
  int qres = 0;
  const int smem = pgv_k9_tc_smem(w, k, &qres);
  auto kern = k9_tc_kernel<0, true, true, false>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kern, tcThreads, smem));
}
"""


def _build_all(srcs: dict) -> dict:
    out = _build.BUILD_DIR / "k9_cutout"
    out.mkdir(parents=True, exist_ok=True)
    paths, cmds = {}, []
    for i, (name, text) in enumerate(srcs.items()):
        cu, so = out / f"v{i}.cu", out / f"v{i}.so"
        cu.write_text(text)
        paths[name] = so
        cmds.append([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                     str(_build._CSRC), "-o", str(so), str(cu)])
    _build._run_all(cmds)
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("pgv_k9_bits_tc_topk", "pgv_k9_tc_smem"):
            getattr(lib, fn).argtypes = _build._SIGNATURES[fn]
            getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k9_cutout needs a CUDA GPU; none is visible")
    from pgvector_rx_tpu_torch.data import make_dataset

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = _build_all(variants((_build._CSRC / "k9_bits_tc.cu").read_text()))
    dense, dq = make_dataset(args.rows, 256, B, seed=7, intrinsic=24)
    words = bits.as_words(bits.pack_bits((dense > 0).astype(np.uint8)),
                          "cuda")
    q = bits.as_words(bits.pack_bits((dq > 0).astype(np.uint8)), "cuda")
    del dense, dq
    n, w = words.shape
    live = torch.ones(n, dtype=torch.bool, device="cuda")
    want = bf._order_keys(*bits._bits_topk_plain(words, None, live, q, K,
                                                 "hamming"))
    lib0 = _build.lib()
    try:
        for turn in range(2):
            for name, lib in libs.items():
                _build._lib = lib

                def run():
                    return bits._bits_topk_cuda(words, None, live, q, K,
                                                "hamming", form="k9_bits_tc")

                t = _ms(run)
                same = torch.equal(bf._order_keys(*run()), want)
                print(f"turn {turn} {name}: {t:.4f} ms, keys equal to plain: "
                      f"{same}", flush=True)
        lib = libs["counted"]
        cnt = (ctypes.c_ulonglong * 4)()
        lib.pgv_k9_counts.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _build.check(lib.pgv_k9_counts(cnt, 1), "counts")
        _build._lib = lib
        bits._bits_topk_cuda(words, None, live, q, K, "hamming",
                             form="k9_bits_tc")
        torch.cuda.synchronize()
        _build.check(lib.pgv_k9_counts(cnt, 0), "counts")
        may, offered, inserted, chunks = (int(x) for x in cnt)
        print(f"per warp and chunk ({chunks} warp-chunks): {may / chunks:.3f} "
              f"cells some lane may pass, {offered / chunks:.3f} candidates "
              f"offered, {inserted / chunks:.3f} inserted; per query: "
              f"{inserted / B:.1f} inserts", flush=True)
        lib = libs["as built"]
        occ = ctypes.c_int()
        lib.pgv_k9_tc_occupancy.argtypes = [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p]
        _build.check(lib.pgv_k9_tc_occupancy(w, K, ctypes.byref(occ)),
                     "occupancy")
        print(f"occupancy: {occ.value} blocks per SM", flush=True)
        sms = torch.cuda.get_device_properties(0).multi_processor_count
        stream = torch.cuda.current_stream().cuda_stream
        for per_sm in (1, 2, 3):
            _, splits, rows = bits._k9_tc_plan(n, B, per_sm * sms)
            part = torch.empty((B, splits, K), dtype=torch.int64,
                               device="cuda")
            out = torch.empty((B, K), dtype=torch.int64, device="cuda")
            shared = torch.empty(B, dtype=torch.int64, device="cuda")

            def run():
                shared.fill_(-1)
                _build.check(lib.pgv_k9_bits_tc_topk(
                    words.data_ptr(), live.data_ptr(), q.data_ptr(), None, n,
                    w, B, K, 0, splits, rows, part.data_ptr(),
                    shared.data_ptr(), out.data_ptr(), stream), "k9_tc")

            print(f"as built at {per_sm} blocks per SM ({splits} splits): "
                  f"{_ms(run):.4f} ms", flush=True)
    finally:
        _build._lib = lib0


if __name__ == "__main__":
    main()
