"""Timing probe: where a step of K4's packed-word mode (the bit beam's
walk) spends its time, in its warp form and in the block form it
replaces, and the card's dependent round trip over word rows.

    python -m pgvector_rx_tpu_torch.probes.k4_words_profile [--rows N]
        [--queries N]

Needs one NVIDIA Hopper card and ``nvcc``.

1. Builds ``csrc/k4_beam.cu`` twice with ``-DPGV_K5_PROFILE`` into
   ``pgvector_rx_tpu_torch/_build/k4w_profile/``, the second time also
   with ``-DPGV_K4_WORDS_BLOCK`` (word rows then always take the block
   form: 128 threads a query, block barriers): thread 0 of every block
   adds the SM clocks of each phase of a step to a device buffer
   (``K5_MARK``; in the warp form that is the first of a block's four
   queries).
2. Builds ``chip_smoke.py`` phase 21's bit graph on the card: sign bits of
   ``make_dataset(N, 256, Q, seed=7, intrinsic=24)`` (default N =
   1,000,000, Q = 1,024), hamming, m=16, ef_construction=64, the device
   build.
3. Runs the bit beam's launch (``ops/beam.descent_walk``: the greedy
   descent, then the walk at ef=40) over the Q queries with each library,
   twice, and checks that both forms give the same beams. Prints per run
   the clocks and microseconds per step of each phase ("start": the query,
   the descent and the seeds; "flags": the neighbour ids and flags of the
   block form; "rows": its scoring, and in the warp form ids, flags and
   rows together), steps per query, and the launch's milliseconds
   (CUDA events).
4. A pointer chase over the word rows (``probes/k5_profile.py``'s kernel:
   each hop loads a row's L neighbour ids, then one neighbour's 32-byte
   row): the dependent round trip a step cannot avoid. Prints nanoseconds
   per hop.

Each result is one JSON line; the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import time

import numpy as np
import torch

from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.probes.k5_profile import (_PHASES, _SLOTS,
                                                     _chase_library)


def _profiled_library(block: bool):
    """``csrc/k4_beam.cu`` built with -DPGV_K5_PROFILE (``block``: and
    -DPGV_K4_WORDS_BLOCK), its walk entry bound like ``_build.lib()``'s,
    plus ``pgv_k5_profile``."""
    out_dir = _build.BUILD_DIR / "k4w_profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    name = "block" if block else "warp"
    lib = out_dir / f"libpgv_k4w_{name}.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-DPGV_K5_PROFILE",
                      *(["-DPGV_K4_WORDS_BLOCK"] if block else []),
                      "-shared", "-o", str(lib),
                      str(_build._CSRC / "k4_beam.cu")]])
    handle = ctypes.CDLL(str(lib))
    fn = handle.pgv_k4_beam_walk
    fn.argtypes = _build._SIGNATURES["pgv_k4_beam_walk"]
    fn.restype = ctypes.c_int
    handle.pgv_k5_profile.argtypes = [ctypes.c_void_p]
    handle.pgv_k5_profile.restype = ctypes.c_int
    return handle


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=1024)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch.ops import beam, bits

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    libs = {"warp": _profiled_library(False),
            "block": _profiled_library(True)}
    chase_lib = _chase_library()
    dense, dq = make_dataset(args.rows, 256, args.queries, seed=7,
                             intrinsic=24)
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
    qw = bits.as_words(bits.pack_bits(qbits), dev)

    def walk():
        return beam.descent_walk(g.words, g.neighbors0, g.traversable,
                                 g.upper_slot, g.upper_neighbors, g.m,
                                 g.entry, g.entry_level, "hamming", qw, 40,
                                 4 * 40 + 32)

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
                c = buf.cpu().numpy()
                steps, clocks, ns, blocks = (int(x)
                                             for x in c[len(_PHASES):])
                ns_per_clock = ns / clocks
                split = {ph: {"clocks_per_step": c[i] / steps,
                              "us_per_step": c[i] * ns_per_clock / steps
                              / 1e3}
                         for i, ph in enumerate(_PHASES)
                         if ph not in ("start", "finish")}
                print(json.dumps({
                    "form": form, "run": run, "queries_profiled": blocks,
                    "steps_per_query": steps / blocks,
                    "us_per_step": ns / steps / 1e3,
                    "sm_ghz": clocks / ns, "split": split,
                    "us_per_query_start": c[_PHASES.index("start")]
                    * ns_per_clock / blocks / 1e3,
                    "us_per_query_finish": c[_PHASES.index("finish")]
                    * ns_per_clock / blocks / 1e3,
                    "launch_ms": e0.elapsed_time(e1)}), flush=True)
    finally:
        _build._lib = lib0
    same = all(torch.equal(a, b) for a, b in zip(outs["warp"],
                                                   outs["block"]))
    print(json.dumps({"forms_equal": same}), flush=True)
    if not same:
        raise RuntimeError("the warp and block forms disagree")

    out = torch.zeros(2, dtype=torch.int64, device=dev)
    rng = np.random.default_rng(3)
    per = []
    for start in rng.integers(0, g.cap, 8):
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
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
