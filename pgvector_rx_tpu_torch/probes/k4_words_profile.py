"""Timing probe: where a step of K4's packed-word mode (the bit beam's
walk) spends its time, in its warp form and in the block form it
replaces, and the card's dependent round trip over word rows; with
``--modes``, the word walk's modes against another version of
``k4_beam.cu`` in turns.

    python -m pgvector_rx_tpu_torch.probes.k4_words_profile [--rows N]
        [--queries N]
    python -m pgvector_rx_tpu_torch.probes.k4_words_profile OTHER_K4_BEAM_CU
        --modes [--rows N] [--queries N] [--turns T] [--also K4_BEAM_CU]

Needs one NVIDIA Hopper card and ``nvcc``. Both forms build phase 21's
bit graph of ``chip_smoke.py`` on the card: sign bits of
``make_dataset(N, 256, 4096, seed=7, intrinsic=24)`` (default N =
1,000,000), hamming, m=16, ef_construction=64, the device build, and walk
its first Q queries (default 1,024) at ef=40, ``max_steps = 4 ef + 32``,
the greedy descent in the launch (``ops/beam.descent_walk``, the bit
beam's launch).

Without ``--modes``:

1. Builds ``csrc/k4_beam.cu`` twice with ``-DPGV_K5_PROFILE`` into
   ``pgvector_rx_tpu_torch/_build/k4w_modes/``, the second time also
   with ``-DPGV_K4_WORDS_BLOCK`` (word rows then always take the block
   form: 128 threads a query, block barriers): thread 0 of every block
   adds the SM clocks of each phase of a step to a device buffer
   (``K5_MARK``; in the warp form that is the first of a block's four
   queries).
2. Runs the walk with each library, twice, and checks that both forms
   give the same beams. Prints per run the clocks and microseconds per
   step of each phase, steps per query, and the launch's milliseconds
   (CUDA events).

``OTHER --modes`` (e.g. the parent commit's file, from ``git show
PARENT:pgvector_rx_tpu_torch/csrc/k4_beam.cu``):

1. Builds OTHER and this checkout's file the way ``ops/_build.py`` builds
   the library (one ``nvcc`` per ``PGV_K4_PART`` unit, ``-Xptxas -v``),
   and both again in one piece with ``-DPGV_K5_PROFILE``, all side by
   side, under ``pgvector_rx_tpu_torch/_build/k4w_modes/``.
2. Each mode of the word walk: the default (E = 1), E = 2, 4 and 8
   (``PGV_BEAM_EXPAND``), the visited bitmap (``PGV_BEAM_VISITED_MAX``)
   and E = 4 with it, each library's raw entry called as
   ``ops/beam._launch_walk`` calls it (the bitmap handed zeroed once and
   required zero after every launch: a version that clears it in its
   entry pays the clear inside the launch). Both versions must return the
   same landings, raw beams, steps and rows scored. Prints the ms a launch
   in turns (other, this, this, other, ...; the mean of 10 launches each,
   CUDA events; ``--also FILE``: a third version in the turns, built the
   same way, e.g. this file with one part of a design changed), steps and rows scored per query (mean and the largest),
   and per version one profiled launch's split of a step in microseconds
   (thread 0 of a block: its first query): ``select`` the members; in
   the first form ``rows`` holds each list's ids, repeat scan, flags,
   bits and rows, ``dedup`` the in-beam test, ``sort`` and
   ``beam_merge`` each list's sort and merge; in the redesign ``ids``
   holds the step's ids and their tests on chip (the step's repeats, the
   visited set, the beam's ids), ``rows`` the flags and the fresh rows
   (the distances), ``dedup`` the candidates' compaction, ``sort`` and
   ``beam_merge`` the one sort and merge a step (in rounds of 32
   candidates).
3. Prints each build's word-walk kernels with their registers, spill
   bytes and static shared memory, and compares the machine code
   (``cuobjdump -sass``) of the default word walk (E = 1, no bitmap) in
   the two builds.

Both forms end with a pointer chase over the word rows
(``probes/k5_profile.py``'s kernel: each hop loads a row's L neighbour
ids, then one neighbour's 32-byte row): the dependent round trip a step
cannot avoid. Prints nanoseconds per hop.

Each result is one JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import re
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.probes.k5_profile import (_PHASES, _SLOTS,
                                                     _chase_library)

#: --modes: name -> (E, visited bitmap)
MODES = {"default": (1, False), "expand2": (2, False),
         "expand4": (4, False), "expand8": (8, False),
         "visited": (1, True), "expand4_visited": (4, True)}
EF = 40


def _bind(so: Path, profiled: bool):
    handle = ctypes.CDLL(str(so))
    fn = handle.pgv_k4_beam_walk
    fn.argtypes = _build._SIGNATURES["pgv_k4_beam_walk"]
    fn.restype = ctypes.c_int
    if profiled:
        handle.pgv_k5_profile.argtypes = [ctypes.c_void_p]
        handle.pgv_k5_profile.restype = ctypes.c_int
    return handle


def _unit_libraries(sources: dict):
    """{tag: (k4_beam.cu, extra nvcc flags)} -> {tag: (bound library, its
    .so, ptxas's report)}: each file built in the library's units
    (``PGV_K4_PART`` 0-3; a file without a part's code compiles it empty),
    a profiled one (-DPGV_K5_PROFILE) in one piece, so that all its walks
    share the one profile buffer; every unit of every tag side by side,
    then linked per tag."""
    out_dir = _build.BUILD_DIR / "k4w_modes"
    out_dir.mkdir(parents=True, exist_ok=True)
    units = {t: [()] if "-DPGV_K5_PROFILE" in flags
             else [(f"-DPGV_K4_PART={p}",) for p in range(4)]
             for t, (_, flags) in sources.items()}
    jobs = [(t, out_dir / f"{t}.{i}.o",
             [_build._nvcc(), *_build.NVCC_FLAGS, *flags, *part, "-Xptxas",
              "-v", "-c", "-o", str(out_dir / f"{t}.{i}.o"), str(src)])
            for t, (src, flags) in sources.items()
            for i, part in enumerate(units[t])]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _, _, c in jobs]
    errs = {t: "" for t in sources}
    for (t, _, cmd), p in zip(jobs, procs):
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        errs[t] += err
    out = {}
    for t, (_, flags) in sources.items():
        so = out_dir / f"lib_{t}.so"
        _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                          "-o", str(so),
                          *(str(o) for tt, o, _ in jobs if tt == t)]])
        out[t] = (_bind(so, "-DPGV_K5_PROFILE" in flags), so, errs[t])
    return out


def _word_kernels(ptxas: str) -> dict:
    """{word-walk kernel (demangled): registers, spill store and load
    bytes, static shared memory} from ``-Xptxas -v``."""
    found = re.findall(
        r"Function properties for (\S*word_walk\S*)\n\s*\d+ bytes stack "
        r"frame, (\d+) bytes spill stores, (\d+) bytes spill loads\n[^\n]*?"
        r"Used (\d+) registers(?:[^\n]*?(\d+) bytes smem)?", ptxas)
    if not found:
        return {}
    names = _demangle([f[0] for f in found])
    return {n: dict(registers=int(r), spill_st=int(st), spill_ld=int(ld),
                    static_smem=int(sm or 0))
            for n, (_, st, ld, r, sm) in zip(names, found)}


def _demangle(names):
    bin_dir = Path(_build._nvcc()).parent
    return [n.split("::", 1)[-1] for n in subprocess.run(
        [str(bin_dir / "cu++filt")], input="\n".join(names),
        capture_output=True, text=True, check=True).stdout.splitlines()]


def _default_word_sass(so: Path) -> dict:
    """{the default word walk's kernels (demangled, the template's mode
    argument dropped): hash of their SASS}."""
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
    found = {}
    for raw, plain in zip(bodies, _demangle(list(bodies))):
        # the first form's word_walk_kernel<V, JACC, false> is the
        # redesign's word_walk_kernel<V, JACC>
        m = re.fullmatch(r"word_walk_kernel<([^,]+), ([^,>]+)(, "
                         r"(?:false|\(bool\)0))?>\(.*", plain)
        if m:
            found[f"word_walk_kernel<{m.group(1)}, {m.group(2)}>"] = \
                hashlib.sha1("\n".join(bodies[raw]).encode()).hexdigest()
    return found


def _bit_graph(rows: int, queries: int, dev):
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch.ops import bits

    dense, dq = make_dataset(rows, 256, 4096, seed=7, intrinsic=24)
    xbits, qbits = (dense > 0).astype(np.uint8), (dq > 0).astype(np.uint8)
    del dense, dq
    t0 = time.time()
    index = HnswIndex.build(xbits, metric="hamming",
                            params=IndexParams(m=16, ef_construction=64),
                            method="device", host_graph=False, device=dev,
                            seed=1)
    g = index.device_graph()
    torch.cuda.synchronize()
    print(json.dumps({"graph_rows": g.cap, "entry_level": g.entry_level,
                      "build_s": time.time() - t0}), flush=True)
    return index, g, bits.as_words(bits.pack_bits(qbits[:queries]), dev)


def _split(c) -> dict:
    steps, clocks, ns, blocks = (int(x) for x in c[len(_PHASES):])
    ns_per_clock = ns / clocks
    return dict(
        queries_profiled=blocks, steps_per_query=steps / blocks,
        us_per_step=ns / steps / 1e3, sm_ghz=clocks / ns,
        split={ph: {"clocks_per_step": c[i] / steps,
                    "us_per_step": c[i] * ns_per_clock / steps / 1e3}
               for i, ph in enumerate(_PHASES)
               if ph not in ("start", "finish", "spill_merge", "flags")},
        us_per_query_start=c[_PHASES.index("start")] * ns_per_clock
        / blocks / 1e3,
        us_per_query_finish=c[_PHASES.index("finish")] * ns_per_clock
        / blocks / 1e3)


def _chase(g, dev) -> None:
    chase_lib = _chase_library()
    out = torch.zeros(2, dtype=torch.int64, device=dev)
    per = []
    for start in np.random.default_rng(3).integers(0, g.cap, 8):
        rc = chase_lib.pgv_chase(g.neighbors0.data_ptr(),
                                 g.words.view(torch.float32).data_ptr(),
                                 g.neighbors0.shape[1], g.words.shape[1],
                                 g.cap, 4096, int(start), 1, out.data_ptr())
        if rc != 0:
            raise RuntimeError(f"the chase kernel failed ({rc})")
        torch.cuda.synchronize()
        per.append(int(out[0]) / 4096)
    print(json.dumps({"chase": "ids -> 32-byte word row", "ns_per_hop": per,
                      "ns_per_hop_median": float(np.median(per))}),
          flush=True)


def _forms(args, dev) -> None:
    """The warp form against the block form (no ``--modes``)."""
    from pgvector_rx_tpu_torch.ops import beam

    this, prof = _build._CSRC / "k4_beam.cu", ("-DPGV_K5_PROFILE",)
    libs = {t: v[0] for t, v in _unit_libraries({
        "warp": (this, prof),
        "block": (this, (*prof, "-DPGV_K4_WORDS_BLOCK"))}).items()}
    index, g, qw = _bit_graph(args.rows, args.queries, dev)

    def walk():
        return beam.descent_walk(g.words, g.neighbors0, g.traversable,
                                 g.upper_slot, g.upper_neighbors, g.m,
                                 g.entry, g.entry_level, "hamming", qw, EF,
                                 4 * EF + 32)

    lib0 = _build.lib()
    buf = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
    outs = {}
    try:
        for form, lib in libs.items():
            _build._lib = lib
            for run in range(2):
                buf.zero_()
                lib.pgv_k5_profile(buf.data_ptr())
                e0, e1 = (torch.cuda.Event(enable_timing=True)
                          for _ in range(2))
                e0.record()
                out = walk()
                e1.record()
                torch.cuda.synchronize()
                lib.pgv_k5_profile(None)
                outs[form] = [t.cpu() for t in out]
                print(json.dumps({"form": form, "run": run,
                                  **_split(buf.cpu().numpy()),
                                  "launch_ms": e0.elapsed_time(e1)}),
                      flush=True)
    finally:
        _build._lib = lib0
    same = all(torch.equal(a, b) for a, b in zip(outs["warp"],
                                                   outs["block"]))
    print(json.dumps({"forms_equal": same}), flush=True)
    if not same:
        raise RuntimeError("the warp and block forms disagree")
    _chase(g, dev)
    del index


def _modes(args, dev) -> None:
    """``OTHER --modes``: each mode of the word walk, both versions in
    turns, their outputs equal; each version's split of a step."""
    from pgvector_rx_tpu_torch.ops import beam
    from pgvector_rx_tpu_torch.probes.k4_compare import _event_ms, _turns

    this = _build._CSRC / "k4_beam.cu"
    prof = ("-DPGV_K5_PROFILE",)
    sources = {"other": (args.other, ()), "this": (this, ()),
               "other_prof": (args.other, prof), "this_prof": (this, prof)}
    if args.also is not None:
        sources["also"] = (args.also, ())
    timed = [t for t in sources if not t.endswith("_prof")]
    with ThreadPoolExecutor(2) as ex:  # the kernel library alongside
        main_lib = ex.submit(_build.lib)
        libs = _unit_libraries(sources)
        main_lib.result()
    print(json.dumps({"word_walk_kernels": {
        t: _word_kernels(libs[t][2]) for t in timed}}), flush=True)
    sass = {t: _default_word_sass(libs[t][1]) for t in ("other", "this")}
    differ = sorted(k for k in sass["other"]
                    if sass["this"].get(k) != sass["other"][k])
    print(json.dumps({"default_word_walk_sass": {
        "kernels": sorted(sass["other"]), "same": not differ,
        "differ": differ}}), flush=True)

    index, g, qw = _bit_graph(args.rows, args.queries, dev)
    B, L = qw.shape[0], g.neighbors0.shape[1]
    max_steps = 4 * EF + 32
    seeds = (torch.full((B, 1), -1, dtype=torch.int32, device=dev),
             torch.zeros((B, 1), device=dev))
    bitmap = torch.zeros((B, beam.visited_words(g.cap)), dtype=torch.int32,
                         device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    buf = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)

    def new_outs():
        return (torch.empty((B, EF), device=dev),
                torch.empty((B, EF), dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty(B, dtype=torch.int32, device=dev),
                torch.empty((B, 4), dtype=torch.int32, device=dev))

    for name, (E, vis) in MODES.items():
        outs = {t: new_outs() for t in libs}

        def launch(tag, E=E, vis=vis, outs=outs):
            bd, bk, st, sc, land = outs[tag]
            rc = libs[tag][0].pgv_k4_beam_walk(
                g.words.data_ptr(), None, 3, g.words.stride(0),
                g.words.shape[1], g.words.shape[1], g.neighbors0.data_ptr(),
                L, g.traversable.data_ptr(), g.cap,
                beam._METRIC_CODES["hamming"], qw.data_ptr(),
                seeds[0].data_ptr(), seeds[1].data_ptr(), B, 1, EF,
                max_steps, bd.data_ptr(), bk.data_ptr(), st.data_ptr(),
                sc.data_ptr(), g.upper_slot.data_ptr(),
                g.upper_neighbors.data_ptr(), g.upper_neighbors.stride(0),
                g.m, g.entry, g.entry_level, land.data_ptr(), E,
                bitmap.data_ptr() if vis else None,
                bitmap.shape[1] if vis else 0, None, 0, stream)
            _build.check(rc, tag)

        for tag in libs:  # one launch each: outputs, the bitmap left zero
            launch(tag)
            torch.cuda.synchronize()
            if vis and bool(bitmap.any()):
                raise RuntimeError(f"{name}: {tag} leaves bits set")
        ref = [t.cpu() for t in outs["other"]]
        for tag in libs:
            if not all(torch.equal(a.cpu(), b)
                       for a, b in zip(outs[tag], ref)):
                raise RuntimeError(f"{name}: {tag}'s outputs differ from "
                                   "the other version's")
        times = _turns(timed, lambda t: _event_ms(lambda: launch(t)),
                       args.turns)
        splits = {}
        for tag in ("other_prof", "this_prof"):
            buf.zero_()
            libs[tag][0].pgv_k5_profile(buf.data_ptr())
            launch(tag)
            torch.cuda.synchronize()
            libs[tag][0].pgv_k5_profile(None)
            splits[tag.split("_")[0]] = _split(buf.cpu().numpy())
        st, sc = ref[2].float(), ref[3].float()
        land = ref[4]
        iters = land[:, 3].float() + g.entry_level
        print(json.dumps({
            "mode": name, "expand": E, "visited": vis, "queries": B,
            "ms": times, "ms_mean": {t: sum(v) / len(v)
                                     for t, v in times.items()},
            "outputs_equal": True, "steps_mean": st.mean().item(),
            "steps_max": st.max().item(), "scored_mean": sc.mean().item(),
            "descent_iters_max": iters.max().item(),
            "steps_plus_descent_max": (st + iters).max().item(),
            "split": splits}), flush=True)
    _chase(g, dev)
    del index


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", type=Path, nargs="?")
    ap.add_argument("--modes", action="store_true",
                    help="the word walk's modes against OTHER in turns")
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--also", type=Path,
                    help="a third k4_beam.cu in --modes' turns")
    args = ap.parse_args()
    if args.modes != (args.other is not None):
        ap.error("--modes takes OTHER_K4_BEAM_CU, and only it")
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    (_modes if args.modes else _forms)(args, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
