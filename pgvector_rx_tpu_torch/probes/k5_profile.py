"""Timing probe: where a step of K5 (the scan segment) spends its time, and
the card's dependent round trip.

    python -m pgvector_rx_tpu_torch.probes.k5_profile [--rows N] [--queries N]
        [--expand 1,4] [--rank] [--other K4_BEAM_CU]
    python -m pgvector_rx_tpu_torch.probes.k5_profile --walk
        [--other K4_BEAM_CU]

Needs one NVIDIA Hopper card and ``nvcc``.

1. Builds the kernel library a second time with ``-DPGV_K5_PROFILE`` into
   ``pgvector_rx_tpu_torch/_build/k5_profile/``: thread 0 of every scan
   block then adds the SM clocks of each phase of a step to a device
   buffer (``csrc/k4_beam.cu``, ``K5_MARK``); a block barrier of its own
   waits for the prefetched neighbour ids, so the ids time apart.
2. Builds the smoke's main graph on the card: ``N`` rows (default
   1,065,536) of ``make_dataset(N, 128, 64, seed=0)``, l2, m=16,
   ef_construction=64, the device build.
3. Replays the 0.2%-selective beam scans of ``chip_smoke.py`` phase 11 (64
   queries, filter ``eid % 500 == 0``, strict order, LIMIT 20, ef_search
   40: internal width 160, spill 200, the coarse seeds): each query runs
   the segments its ``DeviceBeamScan`` needs, fed its own spill and
   marks, twice, at each E of ``--expand`` (``PGV_BEAM_EXPAND``: the E
   nearest unexpanded members a step; the segments are the ones the real
   scan needs at that E). Prints per run the clocks and microseconds per
   step of each phase (clocks scaled by the blocks' own globaltimer;
   "spill_merge" is the spill pool's occasional sorts, "ids" the barrier
   that waits for the prefetched ids; at E > 1 "dedup" is the step set
   and the compaction, "sort" the rank by every thread, "select" the
   next members and their ids), steps per segment, and the kernel's
   microseconds per segment. ``--rank``: at each E the same segments
   replayed again with the bf16 ranking (``PGV_BEAM_BF16``: the graph's
   bf16 rows rank, its f32 rows re-score the beam at the end, which
   "finish" then holds), so a bf16 step's split prints beside the f32
   step's ("rank" in each line). ``--other``: another version of
   ``k4_beam.cu`` (e.g. the parent commit's) is built the same way and
   replays the same segments after this checkout's ("version" in each
   line: "this" or "other").
4. A pointer chase (the kernel below, one warp, 4,096 hops from each of 8
   random rows): each hop loads a row's L neighbour ids, then one
   neighbour's row, and takes the next row from that row's data: the
   dependent round trip (ids -> rows) a step of the walk cannot avoid once
   its flags are on chip. Also the ids alone. Prints nanoseconds per hop.

``--walk``: K4's step split in place of steps 2-4: phase 25's graph and
1,024 queries (``k4_compare._phase25_graph``), the coarse seeds (8), ef =
40, ``max_steps = 4 ef + 32``, one launch of the profiled walk (the raw
entry, as ``ops/beam._launch_walk`` calls it) at E = 1, E = 4, the visited
bitmap and E = 4 with the bitmap (the bitmap zeroed before the launch),
twice each, per version. Prints per run the clocks and microseconds a step
spends in each phase thread 0 of a block marks (``select``: the members
and, in the redesigned modes, the next step's ids; ``flags``: the ids'
flags, the step set and the compaction; ``rows``; ``dedup``: the in-beam
dedup of the first form; ``sort``; ``beam_merge``), the steps and rows
scored per query and the microseconds of a block (a query) from start to
end, which 8 blocks on an SM share.

Each result is one JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import threading
import time
from pathlib import Path

import numpy as np
import torch

from pgvector_rx_tpu_torch.ops import _build

_PHASES = ("select", "ids", "flags", "rows", "dedup", "sort", "beam_merge",
           "spill_merge", "start", "finish")
_SLOTS = len(_PHASES) + 4  # steps, clocks, ns, blocks

_CHASE = r"""
#include <cuda_runtime.h>
__global__ void chase(const int* nbrs, const float* vals, int L, int d,
                      int cap, int hops, int start, int rows,
                      unsigned long long* out) {
  const int lane = threadIdx.x;
  int u = start;
  unsigned long long n0, n1;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n0));
  for (int h = 0; h < hops; ++h) {
    const int v = lane < L ? nbrs[(long long)u * L + lane] : -1;
    const unsigned ok = __ballot_sync(~0u, v >= 0 && v < cap);
    // the first valid neighbour, or the last one every other hop
    const int pick = ok ? ((h & 1) ? 31 - __clz(ok) : __ffs(ok) - 1) : 0;
    int nx = __shfl_sync(~0u, v, pick);
    if (!ok) nx = (u + 7919) % cap;
    if (rows) {
      float s = 0.f;
      for (int c = lane; c < d / 4; c += 32) {
        const float4 r = reinterpret_cast<const float4*>(
            vals + (long long)nx * d)[c];
        s += r.x + r.y + r.z + r.w;
      }
      for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(~0u, s, o);
      nx ^= __float_as_int(s) == 0x7fc00001;  // the next row waits for it
    }
    u = nx;
  }
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(n1));
  if (lane == 0) {
    out[0] = n1 - n0;
    out[1] = u;
  }
}
extern "C" int pgv_chase(const int* nbrs, const float* vals, int L, int d,
                         int cap, int hops, int start, int rows,
                         unsigned long long* out) {
  chase<<<1, 32>>>(nbrs, vals, L, d, cap, hops, start, rows, out);
  return static_cast<int>(cudaGetLastError());
}
"""


def _profiled_libraries(sources):
    """Each {tag: k4_beam.cu path} built with -DPGV_K5_PROFILE (side by
    side), its entry points bound like ``_build.lib()``'s, plus
    ``pgv_k5_profile``. The replay calls no other kernel while one stands
    in for the library."""
    out_dir = _build.BUILD_DIR / "k5_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs = {t: out_dir / f"libpgv_k5_profile_{t}.so" for t in sources}
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-DPGV_K5_PROFILE",
                      "-shared", "-o", str(libs[t]), str(src)]
                     for t, src in sources.items()])
    handles = {}
    for t, lib in libs.items():
        handle = ctypes.CDLL(str(lib))
        for name in ("pgv_k4_beam_walk", "pgv_k5_beam_scan"):
            fn = getattr(handle, name)
            fn.argtypes = _build._SIGNATURES[name]
            fn.restype = ctypes.c_int
        handle.pgv_k5_profile.argtypes = [ctypes.c_void_p]
        handle.pgv_k5_profile.restype = ctypes.c_int
        handles[t] = handle
    return handles


def _chase_library():
    out_dir = _build.BUILD_DIR / "k5_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    src = out_dir / "chase.cu"
    src.write_text(_CHASE)
    lib = out_dir / "libchase.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                      str(lib), str(src)]])
    handle = ctypes.CDLL(str(lib))
    handle.pgv_chase.argtypes = [ctypes.c_void_p, ctypes.c_void_p] + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    handle.pgv_chase.restype = ctypes.c_int
    return handle


def _segments(index, g, q, mask, dm, beam, SearchParams, DeviceBeamScan):
    """Segments the real scan of query ``q`` needs (LIMIT 20, strict)."""
    p = SearchParams(ef_search=40, iterative_scan="strict_order")
    scan = index.scan(q, p, method="beam", filter_mask=mask)
    assert isinstance(scan, DeviceBeamScan)
    scan.take(20)
    return scan.scan_stats.resumes + 1


def _replay(g, q, nseg, dm, beam, expand, rank):
    """One query's segments, each fed the previous one's spill and marks
    (DeviceBeamScan's state); ranking over the bf16 rows with ``rank``."""
    ef, width = 40, 160
    spill = max(2 * ef, 64) + width - ef
    upper = dm._coarse_upper(g)
    s_ids, s_d = dm._coarse_seed_one(g, q, upper[0], upper[1], 8)
    pad = spill - s_ids.shape[0]
    seeds = (torch.nn.functional.pad(s_ids.to(torch.int32), (0, pad),
                                     value=-1)[None],
             torch.nn.functional.pad(s_d.float(), (0, pad),
                                     value=float("inf"))[None])
    excl = torch.zeros((1, g.cap + 1), dtype=torch.bool, device=g.device)
    allowed = beam.allowed_bits(g.traversable, excl)
    args = (g.values, g.neighbors0, g.traversable)
    for _ in range(nseg):
        _, sp_d, sp_ids = beam.scan_segment(
            *args, excl, "l2", q[None], *seeds, ef, width, spill,
            4 * width + 32, allowed=allowed, mark=True, expand=expand,
            rank=g.values_bf16 if rank else None)
        seeds = (sp_ids, sp_d)


def _profile_expand(expand, index, g, q_dev, mask, prof_libs, args, dm,
                    beam, SearchParams, DeviceBeamScan):
    """Steps 3's replay and print at one E (``PGV_BEAM_EXPAND`` set for the
    segment count, restored after), f32 ranking and, with ``--rank``, bf16
    ranking over the same segments."""
    dev = q_dev.device
    old = os.environ.get("PGV_BEAM_EXPAND")
    os.environ["PGV_BEAM_EXPAND"] = str(expand)
    try:
        nseg = [_segments(index, g, q_dev[i], mask, dm, beam, SearchParams,
                          DeviceBeamScan) for i in range(args.queries)]

        lib0 = _build.lib()
        buf = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
        runs = []
        try:
            for tag, prof_lib in prof_libs.items():
                _build._lib = prof_lib
                for rank in (False, True) if args.rank else (False,):
                    for run in range(2):
                        buf.zero_()
                        prof_lib.pgv_k5_profile(buf.data_ptr())
                        torch.cuda.synchronize()
                        t0 = time.time()
                        for i in range(args.queries):
                            _replay(g, q_dev[i], nseg[i], dm, beam, expand,
                                    rank)
                        torch.cuda.synchronize()
                        wall = time.time() - t0
                        prof_lib.pgv_k5_profile(None)
                        runs.append((tag, rank, run,
                                     buf.cpu().numpy().copy(), wall))
        finally:
            _build._lib = lib0
        for tag, rank, run, c, wall in runs:
            steps, clocks, ns, blocks = (int(x) for x in c[len(_PHASES):])
            ns_per_clock = ns / clocks
            split = {ph: {"clocks_per_step": c[i] / steps,
                          "us_per_step": c[i] * ns_per_clock / steps / 1e3}
                     for i, ph in enumerate(_PHASES) if ph not in
                     ("start", "finish")}
            per_seg = {ph: c[i] * ns_per_clock / blocks / 1e3
                       for i, ph in enumerate(_PHASES)
                       if ph in ("start", "finish")}
            print(json.dumps({
                "version": tag, "expand": expand, "rank": rank, "run": run,
                "segments": blocks,
                "steps": steps,
                "steps_per_segment": steps / blocks,
                "kernel_us_per_segment": ns / blocks / 1e3,
                "us_per_step": ns / steps / 1e3,
                "sm_ghz": clocks / ns, "split": split,
                "us_per_segment_outside_steps": per_seg,
                "host_wall_ms_per_segment": wall / blocks * 1e3}),
                flush=True)
    finally:
        if old is None:
            os.environ.pop("PGV_BEAM_EXPAND", None)
        else:
            os.environ["PGV_BEAM_EXPAND"] = old


#: --walk's modes: name -> (E, visited bitmap)
_WALK_MODES = {"expand1": (1, False), "expand4": (4, False),
               "visited": (1, True), "expand4_visited": (4, True)}


def _profile_walk(prof_libs, dev):
    """``--walk``: K4's phase split per mode and version."""
    from pgvector_rx_tpu_torch.graph import device as dm
    from pgvector_rx_tpu_torch.ops import beam
    from pgvector_rx_tpu_torch.probes import k4_compare

    t0 = time.time()
    index, g, q = k4_compare._phase25_graph(dev)
    print(json.dumps({"graph_rows": g.cap, "build_s": time.time() - t0}),
          flush=True)
    B, W = q.shape[0], 40
    upper = dm._coarse_upper(g)
    s_ids, s_d = dm._coarse_seeds(g, q, upper[0], upper[1], 8)
    seeds = (s_ids.to(torch.int32).contiguous(), s_d.float().contiguous())
    outs = (torch.empty((B, W), device=dev),
            torch.empty((B, W), dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev),
            torch.empty(B, dtype=torch.int32, device=dev))
    bitmap = torch.zeros((B, beam.visited_words(g.cap)), dtype=torch.int32,
                         device=dev)
    buf = torch.zeros(_SLOTS, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    for name, (E, vis) in _WALK_MODES.items():
        for tag, lib in prof_libs.items():
            for run in range(2):
                bitmap.zero_()
                buf.zero_()
                lib.pgv_k5_profile(buf.data_ptr())
                torch.cuda.synchronize()
                a = k4_compare.walk_entry_args(
                    g, q, "l2", seeds, W, 4 * W + 32, outs, expand=E,
                    vis=bitmap if vis else None)
                _build.check(lib.pgv_k4_beam_walk(*a, stream), tag)
                torch.cuda.synchronize()
                lib.pgv_k5_profile(None)
                c = buf.cpu().numpy()
                steps, clocks, ns, blocks = (int(x)
                                             for x in c[len(_PHASES):])
                ns_per_clock = ns / clocks
                split = {ph: {"clocks_per_step": c[i] / steps,
                              "us_per_step": c[i] * ns_per_clock / steps
                              / 1e3}
                         for i, ph in enumerate(_PHASES)
                         if ph in ("select", "flags", "rows", "dedup",
                                   "sort", "beam_merge")}
                print(json.dumps({
                    "walk": name, "version": tag, "run": run,
                    "expand": E, "visited": vis, "blocks": blocks,
                    "steps_per_query": steps / blocks,
                    "scored_per_query": outs[3].float().mean().item(),
                    "us_per_block": ns / blocks / 1e3,
                    "us_per_step": ns / steps / 1e3,
                    "start_us_per_block": c[_PHASES.index("start")]
                    * ns_per_clock / blocks / 1e3,
                    "finish_us_per_block": c[_PHASES.index("finish")]
                    * ns_per_clock / blocks / 1e3,
                    "sm_ghz": clocks / ns, "split": split}), flush=True)
    del index, g


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_065_536)
    ap.add_argument("--queries", type=int, default=64)
    ap.add_argument("--expand", default="1",
                    help="comma-separated E values (PGV_BEAM_EXPAND)")
    ap.add_argument("--rank", action="store_true",
                    help="also the same segments with bf16 ranking")
    ap.add_argument("--other", type=Path,
                    help="another k4_beam.cu replaying the same segments")
    ap.add_argument("--walk", action="store_true",
                    help="K4's step split on phase 25's graph instead")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams, SearchParams
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch.graph import device as dm
    from pgvector_rx_tpu_torch.index.scan import DeviceBeamScan
    from pgvector_rx_tpu_torch.ops import beam

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    # the kernel library and its profiled copy build side by side
    main_build = threading.Thread(target=_build.lib)
    main_build.start()
    sources = {"this": _build._CSRC / "k4_beam.cu"}
    if args.other is not None:
        sources["other"] = args.other
    prof_libs = _profiled_libraries(sources)
    if args.walk:
        main_build.join()
        _profile_walk(prof_libs, dev)
        return 0
    chase_lib = _chase_library()
    main_build.join()
    data, queries = make_dataset(args.rows, 128, args.queries, seed=0)
    t0 = time.time()
    index = HnswIndex.build(torch.from_numpy(data).to(dev), metric="l2",
                            params=IndexParams(m=16, ef_construction=64),
                            method="device", host_graph=False, device=dev,
                            seed=1)
    g = index.device_graph()
    torch.cuda.synchronize()
    print(json.dumps({"graph_rows": g.cap,
                      "build_s": time.time() - t0}), flush=True)
    mask = (np.arange(g.cap) % 500) == 0
    q_dev = torch.from_numpy(queries).to(dev)
    for expand in (int(e) for e in args.expand.split(",")):
        _profile_expand(expand, index, g, q_dev, mask, prof_libs, args, dm,
                        beam, SearchParams, DeviceBeamScan)

    out = torch.zeros(2, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(3)
    for rows in (0, 1):
        per = []
        for start in rng.integers(0, g.cap, 8):
            rc = chase_lib.pgv_chase(g.neighbors0.data_ptr(),
                                     g.values.data_ptr(),
                                     g.neighbors0.shape[1],
                                     g.values.shape[1], g.cap, 4096,
                                     int(start), rows, out.data_ptr())
            if rc != 0:
                raise RuntimeError(f"the chase kernel failed ({rc})")
            torch.cuda.synchronize()
            per.append(int(out[0]) / 4096)
        print(json.dumps({"chase": "ids -> row" if rows else "ids",
                          "ns_per_hop": per,
                          "ns_per_hop_median": float(np.median(per))}),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
