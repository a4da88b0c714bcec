"""Timing experiment: two versions of ``csrc/k4_beam.cu`` on the main
path's walk and scan segment, in turns on one card.

    python -m pgvector_rx_tpu_torch.probes.k4_compare OTHER_K4_BEAM_CU
        [--rows N] [--turns T] [--expand 1,4] [--rank] [--dims 128,768]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --multi-at-one
        [--rows N] [--turns T] [--expand 1]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --uncapped --rank
        [--dims 128,768] [--expand 1]
    python -m pgvector_rx_tpu_torch.probes.k4_compare --split
    python -m pgvector_rx_tpu_torch.probes.k4_compare OTHER_K4_BEAM_CU --modes
        [--turns T] [--sparse-rows N] [--also K4_BEAM_CU]

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

``--modes``: K4's block-walk modes on phase 25's graph (``chip_smoke.py``:
``make_dataset(1,065,536, 128, 16,384, seed=0)``, the first 1,000,000 rows
built on the card, the last 65,536 inserted; its first 1,024 queries from
the coarse seeds, ef = 40, ``max_steps = 4 ef + 32``) with each library in
turns: E = 1 (the default walk), E = 2, 4 and 8 (``PGV_BEAM_EXPAND``), the
visited bitmap (``PGV_BEAM_VISITED_MAX``), E = 4 with the bitmap, E = 4
with bf16 ranking, the default walk with the greedy descent in its launch
(``descent``: no seeds, as ``graph/device.beam_search_arrays`` serves a
shard), and the sparse-row walk without and with the bitmap
(the descent in its launch) over ``make_sparse_dataset(--sparse-rows,
30,000, 1,024, 64, seed=9)`` built by the native engine (default 20,000
rows, cut from the smoke's 100,000 for the probe's time; built in a
thread beside the rest).
The bitmap: a library whose walk leaves bits set in it (the parent's: its
wrapper zeroes [B, (cap + 1) / 32] words per call) gets it zeroed before
each launch, timed apart (``clear_ms``) and outside the launch's events;
one that leaves it zero is handed it once and checked zero after. Each
mode prints the ms per launch in turns, the outputs (raw beams, steps,
rows scored) equal to the other library's or not, and steps and rows
scored per query; each build prints every walk kernel's registers, spills
and the blocks an SM holds by registers (128 threads a block; the
shared memory, a few KB a block, does not bind) and the waves that 1,024
queries take on 132 SMs. The kernel library as ``ops/_build.py`` builds
it (``k4_beam.cu`` in its units) takes its turn as ``library``: its
machine code can differ from the one-file build's. ``--also FILE`` adds
another version to the turns (e.g. this file with one walk kernel's
register cap changed).

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
    walks = _walk_props(p.stderr)
    lib = ctypes.CDLL(str(so))
    version = _version(src.read_text())
    fn = lib.pgv_k4_beam_walk
    fn.argtypes = {1: _SIG[:22], 2: _SIG[:29], 3: _SIG[:-1]}[version] + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, version, regs, scan, rank, walks


def _walk_props(stderr: str) -> dict:
    """{walk kernel (demangled): registers, spill store and load bytes,
    static shared memory, blocks an SM holds by registers at 128 threads
    a block, waves of 1,024 queries on 132 SMs} from ``-Xptxas -v``."""
    found = re.findall(
        r"Function properties for (\S*beam_walk\S*)\n\s*\d+ bytes stack "
        r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n[^\n]*?"
        r"Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", stderr)
    if not found:
        return {}
    bin_dir = Path(_build._nvcc()).parent
    names = subprocess.run([str(bin_dir / "cu++filt")],
                           input="\n".join(f[0] for f in found),
                           capture_output=True, text=True,
                           check=True).stdout.splitlines()
    out = {}
    for name, (_, st, ld, regs, smem) in zip(names, found):
        # registers are allocated per warp in units of 256 (8 a thread)
        warp_regs = -(-int(regs) // 8) * 8 * 32
        blocks = min(16, (65536 // warp_regs) // 4)
        out[name.split("::", 1)[-1]] = dict(
            registers=int(regs), spill_st=int(st), spill_ld=int(ld),
            static_smem=int(smem or 0), blocks_per_sm=blocks,
            waves_1024=-(-1024 // (132 * blocks)))
    return out


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
    ap.add_argument("--modes", action="store_true",
                    help="K4's block-walk modes on phase 25's graph")
    ap.add_argument("--sparse-rows", type=int, default=20_000,
                    help="rows of --modes' sparse graph")
    ap.add_argument("--also", type=Path,
                    help="a third k4_beam.cu in the turns (tag 'also')")
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
    if args.also is not None:
        builds["also"] = (args.also, ())
    sparse = None
    with ThreadPoolExecutor(len(builds) + 2) as ex:  # side by side
        futs = {t: ex.submit(_lib, src, t, flags)
                for t, (src, flags) in builds.items()}
        if args.modes:  # the kernel library and the sparse graph too
            main_lib = ex.submit(_build.lib)
            sparse = ex.submit(_sparse_graph, args.sparse_rows)
            main_lib.result()
        libs = {t: f.result() for t, f in futs.items()}
    if args.modes:  # the kernel library as it ships, in the turns too
        libs["library"] = (_build.lib(), 3, {}, {}, {}, {})
    if args.modes:
        print(json.dumps({"walk_kernels": {t: v[5] for t, v in libs.items()}}),
              flush=True)
    print(json.dumps({t: {"entry_version": v[1], "registers": v[2]}
                      for t, v in libs.items()}), flush=True)
    print(json.dumps({"k5_registers_spill_st_ld": {t: v[3]
                                                   for t, v in libs.items()}}),
          flush=True)
    print(json.dumps({"k4_bf16_registers_spill_st_ld": {
        t: v[4] for t, v in libs.items()}}), flush=True)
    dev = torch.device("cuda")
    if args.modes:
        _modes_turns(args, libs, dev, dm, sparse)
    elif not args.rank:
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


#: --modes: name -> (E, visited bitmap, bf16 ranking)
MODES = {"expand1": (1, False, False), "expand2": (2, False, False),
         "expand4": (4, False, False), "expand8": (8, False, False),
         "visited": (1, True, False), "expand4_visited": (4, True, False),
         "expand4_bf16": (4, False, True)}


def _phase25_graph(dev):
    """Phase 25's graph (the smoke's main path grown by its inserts) and
    its first 1,024 queries."""
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_dataset

    data, queries = make_dataset(1_065_536, 128, 16_384, seed=0)
    x = torch.from_numpy(data).to(dev)
    del data
    index = HnswIndex.build(x[:1_000_000], metric="l2",
                            params=IndexParams(m=16, ef_construction=64),
                            method="device", host_graph=False, device=dev,
                            seed=1)
    index.insert_bulk(x[1_000_000:])
    del x
    return index, index.device_graph(), torch.from_numpy(
        queries[:1024]).to(dev)


def _sparse_graph(rows):
    """The sparse configuration's rows (``make_sparse_dataset(rows,
    30,000, 1,024, 64, seed=9)``) built by the native engine on the host
    -> (index on the card, its 1,024 queries)."""
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_sparse_dataset

    data, queries = make_sparse_dataset(rows, 30_000, 1024, 64, seed=9)
    index = HnswIndex.build(data, metric="l2",
                            params=IndexParams(m=16, ef_construction=64),
                            seed=1, device="cuda")
    return index, queries


def walk_entry_args(g, q, metric, seeds, W, max_steps, outs, *, expand=1,
                    vis=None, rank=False, descent=False, land=None):
    """``pgv_k4_beam_walk``'s arguments (without the stream) for the walk
    over graph ``g`` (dense rows, or the sparse pair with ``q`` the
    kernel's query rows) as ``ops/beam._launch_walk`` passes them: seeds
    (ids [B, S] int32, distances), outputs (beam_d, beam_key, steps,
    scored), ``vis`` the bitmap [B, words] or None, ``rank`` the bf16
    rows ranking, ``descent`` the greedy descent in the launch (its
    landing into ``land`` [B, 4])."""
    from pgvector_rx_tpu_torch.ops import beam

    if isinstance(g.rows, tuple):
        values, values2 = g.rows
        dtype, d, qd = 4, values.shape[1], 2 * values.shape[1]
    else:
        values = g.values_bf16 if rank else g.values
        values2, d = None, g.values.shape[1]
        dtype, qd = beam._DTYPE_CODES[values.dtype], d
    bd, bk, st, sc = outs
    B, S = seeds[0].shape
    upper = (None, None, 0, 0, -1, 0)
    if descent:
        upper = (g.upper_slot.data_ptr(), g.upper_neighbors.data_ptr(),
                 g.upper_neighbors.stride(0), g.m, g.entry, g.entry_level)
    return [values.data_ptr(),
            values2.data_ptr() if values2 is not None else None, dtype,
            values.stride(0), d, qd, g.neighbors0.data_ptr(),
            g.neighbors0.shape[1], g.traversable.data_ptr(), g.cap,
            beam._METRIC_CODES[metric], q.data_ptr(), seeds[0].data_ptr(),
            seeds[1].data_ptr(), B, S, W, max_steps, bd.data_ptr(),
            bk.data_ptr(), st.data_ptr(), sc.data_ptr(), *upper,
            land.data_ptr() if land is not None else None, expand,
            vis.data_ptr() if vis is not None else None,
            vis.shape[1] if vis is not None else 0,
            g.values.data_ptr() if rank else None,
            g.values.stride(0) if rank else 0]


def _modes_turns(args, libs, dev, dm, sparse):
    """``--modes``: each mode with each library in turns."""
    from pgvector_rx_tpu_torch.ops import beam

    index, g, q = _phase25_graph(dev)
    print(json.dumps({"graph_rows": g.cap, "capacity": g.capacity}),
          flush=True)
    B, W, L = q.shape[0], 40, g.neighbors0.shape[1]
    max_steps = 4 * W + 32
    upper = dm._coarse_upper(g)
    s_ids, s_d = dm._coarse_seeds(g, q, upper[0], upper[1], 8)
    seeds = (s_ids.to(torch.int32).contiguous(), s_d.float().contiguous())
    cases = {n: (g, q, "l2", seeds, False, m) for n, m in MODES.items()}
    # the default walk with the greedy descent in its launch (the sharded
    # beam's form): no seeds
    cases["descent"] = (g, q, "l2", (
        torch.full((B, 1), -1, dtype=torch.int32, device=dev),
        torch.zeros((B, 1), device=dev)), True, (1, False, False))
    sp_index, sp_queries = sparse.result()
    sg = sp_index.device_graph()
    qi, qv = dm.prepare_queries(sp_index, sp_queries, dev)
    sq = torch.cat([qi, qv.view(torch.int32)], dim=1).contiguous()
    sp_seeds = (torch.full((sq.shape[0], 1), -1, dtype=torch.int32,
                           device=dev),
                torch.zeros((sq.shape[0], 1), device=dev))
    print(json.dumps({"sparse_rows": sg.cap, "budget": sq.shape[1] // 2}),
          flush=True)
    cases["sparse"] = (sg, sq, "l2", sp_seeds, True, (1, False, False))
    cases["sparse_visited"] = (sg, sq, "l2", sp_seeds, True, (1, True, False))
    stream = torch.cuda.current_stream().cuda_stream
    for name, (gg, qq, metric, sds, desc, (E, vis, rank)) in cases.items():
        nq = qq.shape[0]
        words = beam.visited_words(gg.cap)
        outs = {t: (torch.empty((nq, W), device=dev),
                    torch.empty((nq, W), dtype=torch.int32, device=dev),
                    torch.empty(nq, dtype=torch.int32, device=dev),
                    torch.empty(nq, dtype=torch.int32, device=dev))
                for t in libs}
        bitmap = (torch.zeros((nq, words), dtype=torch.int32, device=dev)
                  if vis else None)
        land = (torch.empty((nq, 4), dtype=torch.int32, device=dev)
                if desc else None)

        def launch(tag):
            a = walk_entry_args(gg, qq, metric, sds, W, max_steps,
                                outs[tag], expand=E, vis=bitmap, rank=rank,
                                descent=desc, land=land)
            _build.check(libs[tag][0].pgv_k4_beam_walk(*a, stream), tag)

        # does the library's walk leave bits set in the bitmap?
        dirty = {}
        for tag in libs:
            if vis:
                bitmap.zero_()
                launch(tag)
                dirty[tag] = bool(bitmap.any())
            else:
                dirty[tag] = False
        clear_ms = (_event_ms(lambda: bitmap.zero_()) if vis else 0.0)

        def timed(tag):
            if not dirty[tag]:
                if vis:
                    bitmap.zero_()
                return _event_ms(lambda: launch(tag))
            e = [torch.cuda.Event(enable_timing=True) for _ in range(20)]
            bitmap.zero_()
            launch(tag)  # the warm-up
            total = 0.0
            for i in range(10):
                bitmap.zero_()
                e[2 * i].record()
                launch(tag)
                e[2 * i + 1].record()
            torch.cuda.synchronize()
            for i in range(10):
                total += e[2 * i].elapsed_time(e[2 * i + 1])
            return total / 10

        times = _turns(list(libs), timed, args.turns)
        for tag in libs:  # the outputs of one clean launch each
            if vis:
                bitmap.zero_()
            launch(tag)
        left_zero = (not bool(bitmap.any())) if vis else None
        ref = outs["other"]
        cmp = {t: {"equal_to_other": all(torch.equal(a, b) for a, b in
                                         zip(outs[t], ref)),
                   "steps_mean": outs[t][2].float().mean().item(),
                   "scored_mean": outs[t][3].float().mean().item()}
               for t in libs}
        print(json.dumps({"mode": name, "expand": E, "visited": vis,
                          "bf16": rank, "queries": nq, "ms": times,
                          "ms_mean": {t: sum(v) / len(v)
                                      for t, v in times.items()},
                          "leaves_bitmap_set": dirty if vis else None,
                          "clear_ms": clear_ms if vis else None,
                          "bitmap_zero_after_this": left_zero,
                          "vs_other": cmp}), flush=True)
    del index, g


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
