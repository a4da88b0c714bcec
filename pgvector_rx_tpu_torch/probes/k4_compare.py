"""Timing experiment: two versions of ``csrc/k4_beam.cu`` on the main
path's walk and scan segment, in turns on one card.

    python -m pgvector_rx_tpu_torch.probes.k4_compare OTHER_K4_BEAM_CU
        [--rows N] [--turns T] [--expand 1,4] [--rank] [--dims 128,768]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --multi-at-one
        [--rows N] [--turns T] [--expand 1]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --uncapped --rank
        [--dims 128,768] [--expand 1]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --split

``--multi-at-one``: the other version is this checkout's file with K5's
E > 1 step (its MULTI instantiation) run at every E, E = 1 included
(the dispatch and the shared-memory layouts that test E > 1 test E >= 1),
so ``--expand 1`` times that step at E = 1 against the default's own.
``--uncapped``: the other version is this checkout's file with the bf16
walk's kernel (``beam_walk_rank_kernel``) left without its minimum of 8
blocks an SM (``__launch_bounds__(128)``), so ``--rank`` times the
register cap's effect (each build's registers are printed).
``--split``: the other version is this checkout's file built with
``--split-compile=0`` (nvcc's parallel optimization of one unit), so the
turns and the SASS check show what it does to the kernels.

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

``--rank``: the bf16 ranking (``PGV_BEAM_BF16``) beside the f32 walk, at
each width of ``--dims`` (128: the graph above, l2; 768: phase 18's
configuration, ``make_dataset(N, 768, 1024, seed=0)`` cosine with
normalized queries, built on the card). A third library joins the turns:
this file built with ``-DPGV_RANK_F32_SUMS`` (``this_f32sums``: the same
bf16 terms summed in f32, so the cost of the exact f64 sums shows apart).
Per width and library, in turns: K4's f32 walk, K4's bf16 walk, and the
bf16 walk at 0 steps (the seeds sorted and the beam re-scored from the f32
rows: the re-score's share); then K5's segment at each E of ``--expand``
in f32 and in bf16, with microseconds per step. Each bf16 result is
printed beside the other versions' (ids equal per query, the largest
distance difference), and each walk's steps per query.

Every run also compares the builds' machine code (``cuobjdump -sass``):
each kernel of the other file that does not rank in bf16 must have the
same SASS in this one, and in the kernel library as ``ops/_build.py``
builds it (printed: how many do, and which differ).
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

from pgvector_rx_tpu_torch.ops import _build

_SIG = _build._SIGNATURES["pgv_k4_beam_walk"]
_METRIC = {"l2": 0, "ip": 1, "cosine": 2}


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


def _lib(src: Path, tag: str, flags=()):
    """Build ``src`` (with nvcc ``flags`` beside the library's) and bind its
    entries."""
    out = _build.BUILD_DIR / "k4_compare"
    out.mkdir(parents=True, exist_ok=True)
    so = out / f"lib_{tag}.so"
    cmd = [_build._nvcc(), *_build.NVCC_FLAGS, *flags, "-Xptxas", "-v",
           "-shared", "-I", str(_build._CSRC), "-o", str(so), str(src)]
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
    # K4's bf16 ranking walks (its own kernel; before it, T = bf16, RANK = 1)
    rank = {m.group(1): [int(m.group(4)), int(m.group(2)), int(m.group(3))]
            for m in re.finditer(
                r"Function properties for \S*?(beam_walk_rank_kernel\S*|beam_"
                r"walk_kernelI13__nv_bfloat16\S*Lb1ELb1EEEv\S*)\n\s*\d+ bytes"
                r" stack frame, (\d+) bytes "
                r"spill stores, (\d+) bytes spill loads\n.*?Used (\d+) "
                r"registers", p.stderr)}
    lib = ctypes.CDLL(str(so))
    version = _version(src.read_text())
    fn = lib.pgv_k4_beam_walk
    fn.argtypes = {1: _SIG[:22], 2: _SIG[:29], 3: _SIG[:-1]}[version] + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, version, regs, scan, rank


#: demangled template arguments, as ``cu++filt`` prints them
_B, _I = r"(?:\(bool\)[01]|true|false)", r"(?:\(int\))?\d+"
_T, _F = r"(?:\(bool\)1|true)", r"(?:\(bool\)0|false)"
#: the bf16 ranking's kernels: K4's own, the walk's RANK = true
#: instantiations of files before it had one, and K5's RANK = true ones
_RANKED = re.compile(rf"beam_walk_rank_kernel|beam_walk_kernel<[^,]+, {_I}, "
                     rf"{_B}, {_T}, {_B}>|beam_scan_kernel<[^,]+, {_I}, "
                     rf"{_I}, {_T}, {_B}>")
_OLD_WALK = re.compile(rf"beam_walk_kernel<([^,]+), ({_I}), ({_B}), {_F}, "
                       rf"({_B})>")


def _sass(so: Path) -> dict:
    """{kernel (demangled, namespace dropped): hash of its SASS}, from
    ``cuobjdump -sass`` and ``cu++filt``."""
    bin_dir = Path(_build._nvcc()).parent
    out = subprocess.run([str(bin_dir / "cuobjdump"), "-sass", str(so)],
                         capture_output=True, text=True, check=True).stdout
    bodies, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            bodies[name] = []
        elif name is not None:
            bodies[name].append(line.strip())
    names = list(bodies)
    plain = subprocess.run([str(bin_dir / "cu++filt")], input="\n".join(names),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    return {p.split("::", 1)[-1]: hashlib.sha1(
                "\n".join(bodies[n]).encode()).hexdigest()
            for n, p in zip(names, plain)}


def _same_default_code(other: dict, this: dict) -> dict:
    """Every kernel of the other build that does not rank in bf16, found in
    this one with the same SASS (a walk kernel named without the RANK =
    false argument it had before the bf16 ranking got a kernel of its
    own)."""
    differ, missing, same = [], [], 0
    for name, h in other.items():
        if _RANKED.search(name):
            continue
        new = _OLD_WALK.sub(r"beam_walk_kernel<\1, \2, \3, \4>", name)
        key = new if new in this else name
        if key not in this:
            missing.append(name)
        elif this[key] != h:
            differ.append(name)
        else:
            same += 1
    return {"kernels_not_ranking_in_bf16": same + len(differ) + len(missing),
            "same_sass": same, "differ": differ, "missing": missing}


def _uncapped(text: str) -> str:
    """``k4_beam.cu`` with the bf16 walk's kernel free of its 64-register
    cap."""
    old = "__launch_bounds__(kThreads, 8)\n    beam_walk_rank_kernel"
    if old not in text:
        raise RuntimeError("the bf16 walk's launch bounds were not found")
    return text.replace(old, "__launch_bounds__(kThreads)\n    "
                             "beam_walk_rank_kernel")


def _multi_at_one(text: str) -> str:
    """``k4_beam.cu`` with K5's MULTI instantiation dispatched at every E."""
    out = text.replace("const bool multi = a.E > 1;",
                       "const bool multi = a.E >= 1;")
    if "const bool multi = a.E >= 1;" not in out:
        raise RuntimeError("K5's dispatch on E was not found")
    return out


def _turns(tags, fn, turns):
    """fn(tag) -> ms for each tag in turns (the order reversed every other
    turn) -> {tag: [ms per turn]}."""
    times = {t: [] for t in tags}
    for turn in range(turns):
        for tag in (tags if turn % 2 == 0 else tags[::-1]):
            times[tag].append(fn(tag))
    return times


def _event_ms(run, iters=10):
    run()
    torch.cuda.synchronize()
    e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    e0.record()
    for _ in range(iters):
        run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / iters


def _graph(dim, rows, dev):
    """The width's graph and queries: 128-d l2 (the main path's), 768-d
    cosine (phase 18's, queries normalized)."""
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_dataset

    metric = "l2" if dim == 128 else "cosine"
    data, queries = make_dataset(rows, dim, 1024, seed=0)
    x = torch.from_numpy(data).to(dev)
    del data
    index = HnswIndex.build(x, metric=metric,
                            params=IndexParams(m=16, ef_construction=64),
                            method="device", host_graph=False, device=dev,
                            seed=1)
    del x
    q = torch.from_numpy(queries).to(dev)
    if metric == "cosine":
        q = (q / q.norm(dim=1, keepdim=True)).contiguous()
    return index, index.device_graph(), q, metric


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--multi-at-one", action="store_true")
    ap.add_argument("--uncapped", action="store_true")
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--expand", default="1,4",
                    help="comma-separated E values for K5")
    ap.add_argument("--rank", action="store_true",
                    help="the bf16 ranking beside the f32 walk at --dims")
    ap.add_argument("--dims", default="128,768",
                    help="widths of --rank (128 l2, 768 cosine)")
    args = ap.parse_args()
    derived = {"multi_at_one": _multi_at_one, "uncapped": _uncapped,
               "split": lambda text: text}
    picked = [k for k in derived if getattr(args, k)]
    if (args.other is None) == (not picked) or len(picked) > 1:
        ap.error("give OTHER_K4_BEAM_CU, --multi-at-one or --uncapped")
    if not torch.cuda.is_available():
        raise RuntimeError("k4_compare needs a CUDA GPU; none is visible")
    if picked:
        args.other = _build.BUILD_DIR / "k4_compare" / f"k4_{picked[0]}.cu"
        args.other.parent.mkdir(parents=True, exist_ok=True)
        args.other.write_text(derived[picked[0]](
            (_build._CSRC / "k4_beam.cu").read_text()))
    from pgvector_rx_tpu_torch.graph import device as dm

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    this = _build._CSRC / "k4_beam.cu"
    builds = {"other": (args.other,
                        ("--split-compile=0",) if args.split else ()),
              "this": (this, ())}
    if args.rank:
        builds["this_f32sums"] = (this, ("-DPGV_RANK_F32_SUMS",))
    with ThreadPoolExecutor(len(builds)) as ex:  # the builds side by side
        futs = {t: ex.submit(_lib, src, t, flags)
                for t, (src, flags) in builds.items()}
        libs = {t: f.result() for t, f in futs.items()}
    print(json.dumps({t: {"entry_version": v[1], "registers": v[2]}
                      for t, v in libs.items()}), flush=True)
    print(json.dumps({"k5_registers_spill_st_ld": {t: v[3]
                                                   for t, v in libs.items()}}),
          flush=True)
    print(json.dumps({"k4_bf16_registers_spill_st_ld": {
        t: v[4] for t, v in libs.items()}}), flush=True)
    dev = torch.device("cuda")
    if not args.rank:
        _, g, q, _ = _graph(128, args.rows, dev)
        _walk_turns(args, libs, g, q, dm, "l2", ranks=(False,))
        _scan_turns(args, libs, g, q, dm, "l2", [
            *((int(e), False) for e in args.expand.split(",")), (1, True)])
    else:
        _rank_turns(args, libs, dev, dm)
    out = _build.BUILD_DIR / "k4_compare"
    other = _sass(out / "lib_other.so")
    print(json.dumps({"default_kernels_vs_other": _same_default_code(
        other, _sass(out / "lib_this.so"))}), flush=True)
    # the kernel library as it ships (k4_beam.cu in its two units)
    print(json.dumps({"library_default_kernels_vs_other": _same_default_code(
        other, _sass(_build.library_path()))}), flush=True)


def _rank_turns(args, libs, dev, dm):
    """``--rank``: at each width, K4 and K5 in f32 and in bf16."""
    for dim in (int(x) for x in args.dims.split(",")):
        index, g, q, metric = _graph(dim, args.rows, dev)
        print(json.dumps({"dim": dim, "metric": metric, "rows": g.cap}),
              flush=True)
        _walk_turns(args, libs, g, q, dm, metric, ranks=(False, True))
        es = [int(e) for e in args.expand.split(",")]
        _scan_turns(args, libs, g, q, dm, metric,
                    [(e, r) for e in es for r in (False, True)])
        del index, g, q
        torch.cuda.empty_cache()


def _walk_turns(args, libs, g, q, dm, metric, ranks):
    """K4 from the coarse seeds (1,024 queries, ef = 40) with each library
    in turns: the f32 walk, and with ``True`` in ranks the bf16 walk and
    the bf16 walk at 0 steps (its re-score)."""
    dev = q.device
    upper = dm._coarse_upper(g)
    s_ids, s_d = dm._coarse_seeds(g, q, upper[0], upper[1], 8)
    s_ids = s_ids.to(torch.int32).contiguous()
    s_d = s_d.float().contiguous()
    d = q.shape[1]
    B, S, W, L = q.shape[0], s_ids.shape[1], 40, g.neighbors0.shape[1]
    for rank in ranks:
        for max_steps in ((4 * W + 32, 0) if rank else (4 * W + 32,)):
            outs = {t: (torch.empty((B, W), device=dev),
                        torch.empty((B, W), dtype=torch.int32, device=dev),
                        torch.empty(B, dtype=torch.int32, device=dev),
                        torch.empty(B, dtype=torch.int32, device=dev))
                    for t in libs}

            def run(tag, rank=rank, max_steps=max_steps, outs=outs):
                lib, version = libs[tag][:2]
                bd, bk, st, sc = outs[tag]
                vals = g.values_bf16 if rank else g.values
                a = [vals.data_ptr(), None, 2 if rank else 0, vals.stride(0),
                     d, d, g.neighbors0.data_ptr(), L,
                     g.traversable.data_ptr(), g.cap, _METRIC[metric],
                     q.data_ptr(), s_ids.data_ptr(), s_d.data_ptr(), B, S, W,
                     max_steps, bd.data_ptr(), bk.data_ptr(), st.data_ptr(),
                     sc.data_ptr()]
                if version >= 2:  # no descent
                    a += [None, None, 0, 0, -1, 0, None]
                if version >= 3:  # E = 1, no bitmap
                    a += [1, None, 0, g.values.data_ptr() if rank else None,
                          g.values.stride(0) if rank else 0]
                _build.check(lib.pgv_k4_beam_walk(
                    *a, torch.cuda.current_stream().cuda_stream), tag)

            usable = [t for t in libs if not rank or libs[t][1] >= 3]
            times = _turns(usable, lambda t: _event_ms(lambda: run(t)),
                           args.turns)
            ref = outs["other"] if "other" in usable else outs[usable[0]]
            cmp = {}
            for t in usable:
                ids_eq = (outs[t][1] == ref[1]).all(1).float().mean().item()
                fin = torch.isfinite(ref[0]) & (outs[t][1] == ref[1])
                cmp[t] = {"ids_equal": ids_eq,
                          "max_dist_diff": float((outs[t][0] - ref[0])[fin]
                                                 .abs().max()) if fin.any()
                          else 0.0,
                          "steps_mean": outs[t][2].float().mean().item(),
                          "scored_mean": outs[t][3].float().mean().item()}
            print(json.dumps({"k4": "bf16" if rank else "f32",
                              "max_steps": max_steps, "ms": times,
                              "ms_mean": {t: sum(v) / len(v)
                                          for t, v in times.items()},
                              "vs_other": cmp}), flush=True)


def _scan_turns(args, libs, g, q, dm, metric, modes):
    """K5 with each library in turns at each (E, bf16) of ``modes``, on one
    query's segment."""
    from pgvector_rx_tpu_torch.ops import beam

    fns = {t: _lib_k5(v[0], v[1]) for t, v in libs.items()}
    fns = {t: f for t, f in fns.items() if f is not None}
    if not fns:
        print(json.dumps({"k5": "an entry without the variants"}), flush=True)
        return
    dev = q.device
    d = q.shape[1]
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
    stream = torch.cuda.current_stream().cuda_stream
    for expand, rank in modes:
        if rank and rank_rows is None:
            continue
        allowed = beam.allowed_bits(g.traversable, excl)
        words = allowed.shape[1]
        outs = {t: (torch.empty((1, 2 * ef + 3), dtype=torch.int32,
                                device=dev),
                    torch.empty((1, spill), device=dev),
                    torch.empty((1, spill), dtype=torch.int32, device=dev))
                for t in fns}

        def run(tag, rank=rank, expand=expand, outs=outs, allowed=allowed,
                words=words):
            rep, sp_d, sp_i = outs[tag]
            vals = rank_rows if rank else g.values
            _build.check(fns[tag](
                vals.data_ptr(), 2 if rank else 0, vals.stride(0), d,
                g.neighbors0.data_ptr(), L, g.traversable.data_ptr(),
                excl.data_ptr(), excl.stride(0), allowed.data_ptr(), words,
                g.cap, _METRIC[metric], q1.data_ptr(), seeds[0].data_ptr(),
                seeds[1].data_ptr(), 1, spill, W, ef, spill, 4 * W + 32, 0,
                rep.data_ptr(), sp_d.data_ptr(), sp_i.data_ptr(), expand,
                g.values.data_ptr() if rank else None,
                g.values.stride(0) if rank else 0, stream), tag)

        tags = list(fns)
        times = _turns(tags, lambda t: _event_ms(lambda: run(t)), args.turns)
        steps = {t: int(outs[t][0][0, 2 * ef]) for t in tags}
        ref = outs[tags[0]]
        same = {t: all(torch.equal(a, b) for a, b in zip(ref, outs[t]))
                for t in tags}
        print(json.dumps({"k5_expand": expand, "rank": rank, "ms": times,
                          "steps": steps,
                          "us_per_step": {t: [m / steps[t] * 1e3
                                              for m in times[t]]
                                          for t in tags},
                          "us_per_step_mean": {
                              t: sum(times[t]) / len(times[t]) / steps[t]
                              * 1e3 for t in tags},
                          "reports_equal_to_" + tags[0]: same}), flush=True)


if __name__ == "__main__":
    main()
