"""Timing experiment: K7 (the coarse seed sweep) with parts cut out, at
other grids, and with and without its Python wrapper.

    python -m pgvector_rx_tpu_torch.probes.k7_cutout [--dims 128,768]

Needs one NVIDIA Hopper card and ``nvcc``. Each variant is a patched copy
of ``csrc/k7_coarse.cu``, built side by side into its own library under
``pgvector_rx_tpu_torch/_build/k7_cutout/`` and called through the same C
entry point on 62,494 random upper rows (the main path's count; 15% not
traversable) and 1,024 random queries, S = 8 (seed 0). The variants run
in turns, twice, and each prints its mean device time over 20 launches
(CUDA events) and the share of queries whose seeds equal the plain
version's (only "as built" and the other grids must compute the right
thing):

- as built, at the wrapper's grid (one block an SM) and at grids of 2
  and 4 blocks an SM;
- no epilogue (a chunk's scores fold into one register, no list insert);
- no row terms (the chunk's ``a`` and traversable flags are not loaded);
- no wgmma (the products are skipped; the scores stay the row terms);
- the same library through the Python wrapper (``ops/bruteforce.
  _coarse_cuda``), at 1,024 queries and at one query (the one-query form;
  ``probes/k1_select.py`` times its C entry and its kernel alone).
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.ops import bruteforce as bf

U, B, S = 62_494, 1024, 8

_EPILOGUE = "    if (u == units - 1) {  // the chunk's scores are complete"
_AV = ("          row < r1 && trav[__ldg(ids + row)] ? __ldg(a + row) : "
       "CUDART_INF_F;")
_WGMMA = """      wgmma_bf16_m64n128k16(
          acc, make_desc(stage_q(st) + wg * 64 * kUnitBytes + 32 * kk),
          make_desc(stage_x(st) + 32 * kk), (u > 0 || kk > 0) ? 1 : 0);"""


def _patched(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"k7_coarse.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """Variant name -> patched source of ``csrc/k7_coarse.cu``."""
    return {
        "as built": src,
        "no epilogue": _patched(src, (
            _EPILOGUE,
            "    if (u == units - 1 && acc[0] == 1.2345f) lst[0] = 0;\n"
            "    if (false) {")),
        "no row terms": _patched(src, (
            _AV, "          row < r1 ? 0.f : CUDART_INF_F;")),
        "no wgmma": _patched(src, (
            _WGMMA, "      acc[kk] += static_cast<float>(kk);")),
    }


def _build_all(srcs: dict) -> dict:
    out = _build.BUILD_DIR / "k7_cutout"
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
        lib.pgv_k7_coarse_topk.argtypes = _build._SIGNATURES[
            "pgv_k7_coarse_topk"]
        lib.pgv_k7_coarse_topk.restype = ctypes.c_int
        libs[name] = lib
    return libs


def _ms(fn, iters: int = 20) -> float:
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


def _run_dim(libs: dict, d: int) -> None:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn(U, d, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(B, d, device=dev, generator=g)
    ids = torch.arange(U, device=dev)
    trav = torch.rand(U + 1, device=dev, generator=g) < 0.85
    rf = rows.float()
    a = (rf * rf).sum(1).contiguous()
    qb = q.to(torch.bfloat16).contiguous()
    want, _ = bf._coarse_plain(rows, a, ids, trav, q, S, True)
    stream = torch.cuda.current_stream().cuda_stream
    sm = bf._sm_count(dev)

    def call(lib, nq, per_sm):
        _, splits, rps = bf._k1_plan(U, nq, per_sm * sm, bf._K7_QTILE,
                                     bf._K7_CHUNK)
        part = torch.empty((nq, splits, 2, S), dtype=torch.int64,
                           device=dev)
        slot = torch.empty((nq, S), dtype=torch.int64, device=dev)
        out = torch.empty((nq, S), dtype=torch.int64, device=dev)

        def run():
            rc = lib.pgv_k7_coarse_topk(
                rows.data_ptr(), a.data_ptr(), ids.data_ptr(),
                trav.data_ptr(), qb.data_ptr(), U, d, nq, S, 1, splits, rps,
                part.data_ptr(), slot.data_ptr(), out.data_ptr(), stream)
            _build.check(rc, "pgv_k7_coarse_topk")
        return run, slot

    arms = {f"{name}, 1 block an SM": (lib, B, 1)
            for name, lib in libs.items()}
    arms["as built, 2 blocks an SM"] = (libs["as built"], B, 2)
    arms["as built, 4 blocks an SM"] = (libs["as built"], B, 4)
    for turn in range(2):
        for name, (lib, nq, per_sm) in arms.items():
            run, slot = call(lib, nq, per_sm)
            t = _ms(run)
            same = float((torch.sort(slot, 1).values == torch.sort(
                want[:nq], 1).values).all(1).float().mean())
            print(f"d={d} turn {turn} {name}: {t:.4f} ms, seeds equal to "
                  f"plain on {same:.4f} of queries", flush=True)
        for nq in (B, 1):
            t = _ms(lambda: bf._coarse_cuda(rows, a, ids, trav, q[:nq], S,
                                            True))
            print(f"d={d} turn {turn} the wrapper at {nq} queries: "
                  f"{t:.4f} ms", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("k7_cutout needs a CUDA GPU; none is visible")
    ap = argparse.ArgumentParser()
    ap.add_argument("--dims", default="128,768")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = _build_all(variants((_build._CSRC / "k7_coarse.cu").read_text()))
    # the wrapper runs on the "as built" copy: no build of the whole library
    _build.lib = lambda: libs["as built"]
    for d in map(int, args.dims.split(",")):
        _run_dim(libs, d)


if __name__ == "__main__":
    main()
