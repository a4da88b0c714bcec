"""Timing experiment: two versions of ``csrc/k4_beam.cu`` on the main
path's walk and scan segment, in turns on one card.

    python -m pgvector_rx_tpu_torch.probes.k4_compare OTHER_K4_BEAM_CU
        [--rows N] [--turns T] [--expand 1,4]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --multi-at-one
        [--rows N] [--turns T] [--expand 1]

``--multi-at-one``: the other version is this checkout's file with K5's
E > 1 step (its MULTI instantiation) run at every E, E = 1 included
(the dispatch and the shared-memory layouts that test E > 1 test E >= 1),
so ``--expand 1`` times that step at E = 1 against the default's own.

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
Then K5 (``pgv_k5_beam_scan``, both versions' entry as it stands since
the beam's variants joined it) at each E of ``--expand``: the first
query's first segment (nothing excluded, internal width 160, spill 200,
the staged bitmap, 8 coarse seeds: ``chip_smoke.py``'s K5 timing), timed
the same way, and then with bf16 ranking at E = 1; its reports are
printed equal or not (E > 1 sums rows in another order in the two
versions). Each build's K5 instantiations are printed with their
registers and spill bytes (``-Xptxas -v``).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
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


def _lib_k5(lib, version):
    """Bind ``pgv_k5_beam_scan`` where the file has the variants' entry."""
    if version < 3:
        return None
    fn = lib.pgv_k5_beam_scan
    fn.argtypes = _build._SIGNATURES["pgv_k5_beam_scan"]
    fn.restype = ctypes.c_int
    return fn


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
    # K5's instantiations: (registers, spill store bytes, spill load bytes)
    scan = {m.group(1): [int(m.group(4)), int(m.group(2)), int(m.group(3))]
            for m in re.finditer(
                r"Function properties for \S*beam_scan_kernel(\S*)\n\s*\d+ "
                r"bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                r"spill loads\n.*?Used (\d+) registers", p.stderr)}
    lib = ctypes.CDLL(str(so))
    version = _version(src.read_text())
    fn = lib.pgv_k4_beam_walk
    fn.argtypes = {1: _SIG[:22], 2: _SIG[:29], 3: _SIG[:-1]}[version] + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, version, regs, scan


def _multi_at_one(text: str) -> str:
    """``k4_beam.cu`` with K5's MULTI instantiation dispatched at every E."""
    out = text.replace("E > 1 ?", "E >= 1 ?")
    if "a.E >= 1 ? scan_kernel<T, V, true>" not in out:
        raise RuntimeError("K5's dispatch on E was not found")
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--multi-at-one", action="store_true")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--expand", default="1,4",
                    help="comma-separated E values for K5")
    args = ap.parse_args()
    if (args.other is None) == (not args.multi_at_one):
        ap.error("give OTHER_K4_BEAM_CU or --multi-at-one")
    if not torch.cuda.is_available():
        raise RuntimeError("k4_compare needs a CUDA GPU; none is visible")
    if args.multi_at_one:
        args.other = _build.BUILD_DIR / "k4_compare" / "k4_beam_multi.cu"
        args.other.parent.mkdir(parents=True, exist_ok=True)
        args.other.write_text(_multi_at_one(
            (_build._CSRC / "k4_beam.cu").read_text()))
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch.graph import device as dm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    with ThreadPoolExecutor(2) as ex:  # the two builds side by side
        futs = {"other": ex.submit(_lib, args.other, "other"),
                "this": ex.submit(_lib, _build._CSRC / "k4_beam.cu", "this")}
        libs = {t: f.result() for t, f in futs.items()}
    print(json.dumps({t: {"entry_version": v[1], "registers": v[2]}
                      for t, v in libs.items()}), flush=True)
    print(json.dumps({"k5_registers_spill_st_ld": {t: v[3]
                                                   for t, v in libs.items()}}),
          flush=True)
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
        lib, version = libs[tag][:2]
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
    _scan_turns(args, libs, g, q, dm, stream)


def _scan_turns(args, libs, g, q, dm, stream):
    """K5 with each library in turns at each E, on one query's segment."""
    from pgvector_rx_tpu_torch.ops import beam

    fns = {t: _lib_k5(v[0], v[1]) for t, v in libs.items()}
    if None in fns.values():
        print(json.dumps({"k5": "an entry without the variants"}), flush=True)
        return
    dev = q.device
    ef, W = 40, 160
    spill = max(2 * ef, 64) + W - ef
    excl = torch.zeros((1, g.cap + 1), dtype=torch.bool, device=dev)
    upper = dm._coarse_upper(g)
    s_ids, s_d = dm._coarse_seed_one(g, q[0], upper[0], upper[1], 8)
    pad = spill - s_ids.shape[0]
    seeds = (torch.nn.functional.pad(s_ids.to(torch.int32), (0, pad),
                                     value=-1)[None].contiguous(),
             torch.nn.functional.pad(s_d.float(), (0, pad),
                                     value=float("inf"))[None].contiguous())
    q1 = q[:1].contiguous()
    L = g.neighbors0.shape[1]
    rank_rows = getattr(g, "values_bf16", None)
    modes = [(int(e), False) for e in args.expand.split(",")]
    if rank_rows is not None:
        modes.append((1, True))  # bf16 ranking, E = 1
    for expand, rank in modes:
        allowed = beam.allowed_bits(g.traversable, excl)
        words = allowed.shape[1]
        outs = {t: (torch.empty((1, 2 * ef + 3), dtype=torch.int32,
                                device=dev),
                    torch.empty((1, spill), device=dev),
                    torch.empty((1, spill), dtype=torch.int32, device=dev))
                for t in libs}

        def run(tag):
            rep, sp_d, sp_i = outs[tag]
            vals = rank_rows if rank else g.values
            _build.check(fns[tag](
                vals.data_ptr(), 2 if rank else 0, vals.stride(0), 128,
                g.neighbors0.data_ptr(), L, g.traversable.data_ptr(),
                excl.data_ptr(), excl.stride(0), allowed.data_ptr(), words,
                g.cap, 0, q1.data_ptr(), seeds[0].data_ptr(),
                seeds[1].data_ptr(), 1, spill, W, ef, spill, 4 * W + 32, 0,
                rep.data_ptr(), sp_d.data_ptr(), sp_i.data_ptr(), expand,
                g.values.data_ptr() if rank else None,
                g.values.stride(0) if rank else 0, stream), tag)

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
        steps = {t: int(outs[t][0][0, 2 * ef]) for t in libs}
        same = all(torch.equal(a, b)
                   for a, b in zip(outs["other"], outs["this"]))
        print(json.dumps({"k5_expand": expand, "rank": rank, "ms": times,
                          "steps": steps,
                          "us_per_step": {t: [m / steps[t] * 1e3
                                              for m in times[t]]
                                          for t in libs},
                          "reports_equal": same}), flush=True)


if __name__ == "__main__":
    main()
