"""Timing experiment: two versions of ``csrc/k4_beam.cu`` on the main
path's walk, in turns on one card.

    python -m pgvector_rx_tpu_torch.probes.k4_compare OTHER_K4_BEAM_CU
        [--rows N] [--turns T]

Needs one NVIDIA Hopper card and ``nvcc``. Builds this checkout's
``csrc/k4_beam.cu`` and the other file (e.g. the parent commit's, from
``git show PARENT:pgvector_rx_tpu_torch/csrc/k4_beam.cu``) side by side
under ``pgvector_rx_tpu_torch/_build/k4_compare/`` (``-Xptxas -v``: each
build's registers for the dense f32 walk are printed), builds the smoke's
main graph on the card (``make_dataset(N, 128, 1024, seed=0)``, l2, m=16,
ef_construction=64, the device build; default N = 1,000,000) and times
the dense serving walk (K4 from the coarse seeds, 1,024 queries, ef=40)
with each library in turns (other, this, this, other, ...), the mean of
10 launches (CUDA events) per turn. Both must return the same beams.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from pathlib import Path

import torch

from pgvector_rx_tpu_torch.ops import _build

_SIG = _build._SIGNATURES["pgv_k4_beam_walk"]


def _version(text: str) -> int:
    """The walk entry's version: 1 before the descent joined its launch (22
    arguments and the stream), 2 before the beam's variants did (29 and the
    stream), 3 this one."""
    if "unsigned* vis" in text:
        return 3
    return 2 if "int entry_level" in text else 1


def _lib(src: Path, tag: str):
    out = _build.BUILD_DIR / "k4_compare"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib_{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
           "-I", str(_build._CSRC), "-o", str(so), str(src)]
    p = subprocess.run(cmd, capture_output=True, text=True, check=True)
    # the seeded dense f32 walk (the descent's and the bf16 ranking's
    # instantiations apart)
    regs = re.findall(r"beam_walk_kernelIfLi4E(?:Lb0E)*E.*?\n.*?\n.*?Used "
                      r"(\d+) registers", p.stderr)
    lib = ctypes.CDLL(str(so))
    version = _version(src.read_text())
    fn = lib.pgv_k4_beam_walk
    fn.argtypes = {1: _SIG[:22], 2: _SIG[:29], 3: _SIG[:-1]}[version] + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, version, regs


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path)
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--turns", type=int, default=4)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("k4_compare needs a CUDA GPU; none is visible")
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch.graph import device as dm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    libs = {"other": _lib(args.other, "other"),
            "this": _lib(_build._CSRC / "k4_beam.cu", "this")}
    print(json.dumps({t: {"entry_version": v[1], "registers": v[2]}
                      for t, v in libs.items()}), flush=True)
    dev = torch.device("cuda")
    data, queries = make_dataset(args.rows, 128, 1024, seed=0)
    index = HnswIndex.build(torch.from_numpy(data).to(dev), metric="l2",
                            params=IndexParams(m=16, ef_construction=64),
                            method="device", host_graph=False, device=dev,
                            seed=1)
    g = index.device_graph()
    q = torch.from_numpy(queries).to(dev)
    ids, rows = dm._coarse_upper(g)
    s_ids, s_d = dm._coarse_seeds(g, q, ids, rows, 8)
    s_ids = s_ids.to(torch.int32).contiguous()
    s_d = s_d.float().contiguous()
    B, S, W, L = q.shape[0], s_ids.shape[1], 40, g.neighbors0.shape[1]
    outs = {t: (torch.empty((B, W), device=dev),
                torch.empty((B, W), dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev)) for t in libs}
    stream = torch.cuda.current_stream().cuda_stream

    def run(tag):
        lib, version, _ = libs[tag]
        bd, bk, st, sc = outs[tag]
        a = [g.values.data_ptr(), None, 0, g.values.stride(0), 128, 128,
             g.neighbors0.data_ptr(), L, g.traversable.data_ptr(), g.cap, 0,
             q.data_ptr(), s_ids.data_ptr(), s_d.data_ptr(), B, S, W,
             4 * W + 32, bd.data_ptr(), bk.data_ptr(), st.data_ptr(),
             sc.data_ptr()]
        if version >= 2:  # no descent
            a += [None, None, 0, 0, -1, 0, None]
        if version >= 3:  # the default walk: E = 1, no bitmap, f32 ranking
            a += [1, None, 0, None, 0]
        _build.check(lib.pgv_k4_beam_walk(*a, stream), tag)

    def ms(tag, iters=10):
        run(tag)
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        for _ in range(iters):
            run(tag)
        e1.record()
        torch.cuda.synchronize()
        return e0.elapsed_time(e1) / iters

    times = {t: [] for t in libs}
    for turn in range(args.turns):
        order = ("other", "this") if turn % 2 == 0 else ("this", "other")
        for tag in order:
            times[tag].append(ms(tag))
    same = all(torch.equal(a, b) for a, b in zip(outs["other"], outs["this"]))
    print(json.dumps({"ms": times, "beams_equal": same}), flush=True)


if __name__ == "__main__":
    main()
