"""Timing experiment: K3's sweep kernel with parts cut out.

    python -m pgvector_rx_tpu_torch.probes.k3_cutout

Needs one NVIDIA Hopper card and ``nvcc``. Each variant is a patched copy
of ``csrc/k3_tilemin.cu``, built side by side into its own library under
``pgvector_rx_tpu_torch/_build/k3_cutout/`` and called through the same C
entry point at 1,024 queries x 1,000,000 rows x 128-d, tn=1,024 (random
data, seed 0); the variants run in turns, twice, and each prints its mean
time over 20 launches (CUDA events) and the share of its packed output
equal to the plain version's (only "as built" and "wgmma in flight" must
compute the right thing):

- as built;
- no epilogue (a chunk's scores fold into nothing but one register);
- no wgmma (the products are skipped; the scores stay 0);
- no corpus copies (only the first units are copied; later units reuse
  stale shared memory);
- wgmma in flight (one wgmma group kept in flight across the block
  barrier except at a chunk's end, with copies two units ahead instead of
  three).
"""

from __future__ import annotations

import ctypes
import subprocess

import torch

from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.ops import bruteforce as bf

N, D, B, TN = 1_000_000, 128, 1024, 1024

_FOLD = """      if (lim == k3Bn)
        fold_chunk<false>(acc, as, lane, cb, lim, best);
      else
        fold_chunk<true>(acc, as, lane, cb, lim, best);"""
_WGMMA = """#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {  // 4 x k16 (32 bytes) = the unit
      wgmma_bf16_m64n128k16(acc, make_desc(a_op + 32 * kk),
                            make_desc(b_op + 32 * kk),
                            (u > 0 || kk > 0) ? 1 : 0);
    }"""
_COPY = "    if (v < total) {\n      int ci = v / units,"
_IN_FLIGHT = (
    ("for (int v = 0; v < k3Stages - 1; ++v) issue(v);",
     "for (int v = 0; v < k3Stages - 2; ++v) issue(v);"),
    ("cp_async_wait<k3Stages - 2>();", "cp_async_wait<k3Stages - 3>();"),
    ("issue(v + k3Stages - 1);", "issue(v + k3Stages - 2);"),
    ("    wgmma_commit();\n    wgmma_wait_all();",
     "    wgmma_commit();\n    if (u == units - 1) wgmma_wait_all();\n"
     "    else asm volatile(\"wgmma.wait_group.sync.aligned 1;\\n\" ::: "
     "\"memory\");"),
)


def _patched(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"k3_tilemin.cu no longer holds {old!r}")
        src = src.replace(old, new)
    return src


def variants(src: str) -> dict:
    """Variant name -> patched source of ``csrc/k3_tilemin.cu``."""
    return {
        "as built": src,
        "no epilogue": _patched(src, (
            _FOLD, "      best[0] = min(best[0], __float_as_int(acc[0]) | cb"
                   " | lim);")),
        "no wgmma": _patched(src, (
            _WGMMA, "    acc[0] += static_cast<float>(a_op ^ b_op);")),
        "no corpus copies": _patched(src, (
            _COPY, _COPY.replace("v < total", "v < total && v < k3Stages - 1"))),
        "wgmma in flight": _patched(src, *_IN_FLIGHT),
    }


def _build_all(srcs: dict) -> dict:
    out = _build.BUILD_DIR / "k3_cutout"
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
        lib.pgv_k3_tilemin.argtypes = _build._SIGNATURES["pgv_k3_tilemin"]
        lib.pgv_k3_tilemin.restype = ctypes.c_int
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


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("k3_cutout needs a CUDA GPU; none is visible")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    libs = _build_all(variants((_build._CSRC / "k3_tilemin.cu").read_text()))
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn(N, D, device="cuda", generator=g)
    q = torch.randn(B, D, device="cuda", generator=g)
    a = (x * x).sum(1)
    xb = x.to(torch.bfloat16)
    del x
    q2x, av, _ = bf._tilemin_prepare(xb, a, q)
    nc = -(-N // TN)
    _, splits, tps = bf._k3_plan(N, B, TN, bf._block_target(xb.device))
    want = bf._tilemin_packed_plain(xb, av, q2x, TN)
    stream = torch.cuda.current_stream().cuda_stream
    for turn in range(2):
        for name, lib in libs.items():
            out = torch.empty((B, nc), dtype=torch.int32, device="cuda")

            def run():
                rc = lib.pgv_k3_tilemin(
                    xb.data_ptr(), av.data_ptr(), q2x.data_ptr(), N, D, B, TN,
                    nc, splits, tps, out.data_ptr(), stream)
                _build.check(rc, name)

            t = _ms(run)
            same = float((out == want).float().mean())
            print(f"turn {turn} {name}: {t:.4f} ms, packed equal to plain "
                  f"{same:.4f}", flush=True)


if __name__ == "__main__":
    main()
