"""Timing experiment: the native engine's sparse build with and without
its pair memo.

    python -m pgvector_rx_tpu_torch.probes.sparse_build [--rows N]

Runs on the host CPU (no card). Builds ``make_sparse_dataset(N, 30000,
64, 64, seed=9)`` (the sparse configuration's data, cut to N rows) with
the port's native engine (``csrc/hnswcore.cpp``) and with a patched copy
of its source whose neighbour-list pruning scores every pair afresh (the
memo cut out; built under ``pgvector_rx_tpu_torch/_build/probe_nomemo/``),
l2, m=16, ef_construction=64, seed 1. Prints each build's seconds and
rows/s, and whether the two graphs are equal (every layer's ids and
distances, the entry).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path

from pgvector_rx_tpu_torch import HnswIndex, IndexParams, native
from pgvector_rx_tpu_torch.data import make_sparse_dataset

_MEMO = "if (h->pair_dist(e.idx, r.idx) <= e.d) {"
_NO_MEMO = "if (h->dist(h->row(e.idx), h->row(r.idx)) <= e.d) {"


def _build(rows):
    native._lib, native._tried = None, False  # load the engine anew
    t0 = time.time()
    idx = HnswIndex.build(rows, metric="l2",
                          params=IndexParams(m=16, ef_construction=64),
                          seed=1, method="native", device="cpu")
    return idx, time.time() - t0


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=10_000)
    n = ap.parse_args().rows
    rows, _ = make_sparse_dataset(n, 30_000, 64, 64, seed=9)
    source = native._SOURCE
    src = source.read_text()
    if src.count(_MEMO) != 1:
        raise RuntimeError("the pruning's memoized call was not found")
    out_dir = source.parents[1] / "_build" / "probe_nomemo"
    out_dir.mkdir(parents=True, exist_ok=True)
    plain = out_dir / "hnswcore.cpp"
    plain.write_text(src.replace(_MEMO, _NO_MEMO))
    built = {}
    try:
        for label, path in (("memo", source), ("no memo", plain)):
            native._SOURCE = Path(path)
            built[label] = _build(rows)
            print(f"{label}: {n} rows in {built[label][1]:.3f} s, "
                  f"{n / built[label][1]:.1f} rows/s", flush=True)
    finally:
        native._SOURCE = source
        native._lib, native._tried = None, False
    a, b = built["memo"][0], built["no memo"][0]
    same = a.entry == b.entry and all(
        x.level == y.level and x.neighbors == y.neighbors
        for x, y in zip(a.elements, b.elements))
    print(f"graphs equal (ids and distances of every layer): {same}")


if __name__ == "__main__":
    main()
