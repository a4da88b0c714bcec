"""The port runs without JAX: a fresh interpreter imports it, builds a
native index and a device-built index on the CPU, serves all three
engines, searches, scans, inserts, runs the tile-min sweep, saves and
loads a checkpoint, builds and searches an l1 index, builds, serves and
saves a bit index of each metric, builds, searches and saves a sparse
index, builds and searches a 2-shard sharded index, runs the flat index
(bit and sparse rows), the cost model,
the operator-class facade and the distance ops, and neither
JAX nor the JAX package (``pgvector_rx_tpu``) nor its benchmark
(``bench``) ever enters ``sys.modules``. A subprocess, because the test harness
(tests/conftest.py) imports JAX into this one."""

import os
import subprocess
import sys
from pathlib import Path

_SCRIPT = r"""
import sys
import numpy as np
import torch

torch.set_num_threads(1)
from pgvector_rx_tpu_torch import HnswIndex, SearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as device_mod

data, queries = make_dataset(2000, 16, 32, seed=0, n_clusters=20)
idx = HnswIndex.build(data, metric="l2", method="native", host_graph=False,
                      seed=1, device="cpu")
_, gt = device_mod.serve_topk(idx, queries, 10, engine="exact")
for engine in ("approx", "beam"):
    _, ids = device_mod.serve_topk(idx, queries, 10, engine=engine)
    rec = np.mean([len(set(ids[b]) & set(gt[b])) / 10 for b in range(32)])
    assert rec >= 0.9, (engine, rec)
for method in ("exact", "approx", "device"):
    d, tids = idx.search(queries, 10, SearchParams(ef_search=40),
                         method=method)
    assert tids.shape == (32, 10) and np.isfinite(d).all()
dev = HnswIndex.build(torch.from_numpy(data), metric="l2", seed=1,
                      host_graph=False, device="cpu")
_, ids = device_mod.serve_topk(dev, queries, 10, engine="beam")
rec = np.mean([len(set(ids[b]) & set(gt[b])) / 10 for b in range(32)])
assert rec >= 0.9, ("device build", rec)
scan = dev.scan(queries[0], SearchParams(ef_search=20,
                                         iterative_scan="relaxed_order"),
                method="beam")
assert len(scan.take(30)) == 30
assert dev.insert_bulk(queries[:8]) == 8
from pgvector_rx_tpu_torch.ops import bruteforce as bf
g = dev.device_graph()
_, k3 = bf.tilemin_sweep_topk(g.values_bf16, g.x2, torch.from_numpy(queries),
                              10, "l2", tn=128)
assert k3.shape == (32, 10) and (k3 >= 0).all()
import os, tempfile
with tempfile.TemporaryDirectory() as tmp:
    dev.save(os.path.join(tmp, "ck"))
    back = HnswIndex.load(os.path.join(tmp, "ck"), device="cpu")
    assert back.num_tuples == dev.num_tuples
l1 = HnswIndex.build(data[:600], metric="l1", method="device",
                     host_graph=False, device="cpu")
_, ids = l1.search(queries, 5, method="exact")
assert (ids >= 0).all()
from pgvector_rx_tpu_torch.index.access_method import create_index_for_opclass
from pgvector_rx_tpu_torch.index.cost import should_use_index
from pgvector_rx_tpu_torch.index.flat import FlatIndex
from pgvector_rx_tpu_torch.ops import bits, distances
bitrows = (data[:600] > 0).astype(np.uint8)
bq = (queries > 0).astype(np.uint8)
for metric in ("hamming", "jaccard"):
    bidx = HnswIndex.build(bitrows, metric=metric, method="device",
                           host_graph=False, device="cpu")
    for engine in ("exact", "approx", "beam"):
        _, ids = device_mod.serve_topk(bidx, bits.pack_bits(bq), 5,
                                       engine=engine)
        assert (ids >= 0).all(), engine
    _, ftids = FlatIndex.build(bitrows, metric=metric, kind="bit",
                               device="cpu").search(bq, 5)
    assert (ftids >= 0).all()
    with tempfile.TemporaryDirectory() as tmp:
        bidx.save(os.path.join(tmp, "bit"))
        assert HnswIndex.load(os.path.join(tmp, "bit"),
                              device="cpu").num_tuples == 600
from pgvector_rx_tpu_torch.data import make_sparse_dataset
srows, sq = make_sparse_dataset(400, 500, 8, 12, seed=9)
sidx = HnswIndex.build(srows, metric="ip", seed=1, device="cpu")
for method in ("exact", "approx", "device"):
    _, ids = sidx.search(sq, 5, method=method)
    assert (ids >= 0).all(), method
_, ftids = FlatIndex.build(srows, metric="l1", kind="sparse",
                           device="cpu").search(sq, 5)
assert (ftids >= 0).all()
with tempfile.TemporaryDirectory() as tmp:
    sidx.save(os.path.join(tmp, "sparse"))
    assert HnswIndex.load(os.path.join(tmp, "sparse"),
                          device="cpu").num_tuples == 400
from pgvector_rx_tpu_torch.parallel import ShardedHnswIndex
from pgvector_rx_tpu_torch.utils import trace
sh = ShardedHnswIndex.build(data[:600], n_shards=2, method="native",
                            devices=["cpu", "cpu"])
for engine in ("exact", "beam"):
    with trace(None):
        _, ids = sh.search(queries, 5, SearchParams(ef_search=40),
                           engine=engine)
    assert (ids >= 0).all(), engine
fam = create_index_for_opclass("vector_cosine_ops", 16, device="cpu")
fam.add_batch(data[:100])
assert not should_use_index(fam, True, 40)
assert fam.search(queries[:2], 3, method="exact")[1].shape == (2, 3)
assert distances.pairwise("l2", torch.from_numpy(data[:5]),
                          torch.from_numpy(queries[:2])).shape == (2, 5)
assert "jax" not in sys.modules, sorted(m for m in sys.modules if "jax" in m)
foreign = sorted(m for m in sys.modules if m == "bench"
                 or m == "pgvector_rx_tpu" or m.startswith("pgvector_rx_tpu."))
assert not foreign, foreign
print("NO_JAX_OK")
"""


def test_port_never_imports_jax():
    root = Path(__file__).resolve().parents[1]
    env = dict(os.environ)
    env["PYTHONPATH"] = str(root) + os.pathsep + env.get("PYTHONPATH", "")
    res = subprocess.run(
        [sys.executable, "-c", _SCRIPT], cwd=root, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert res.returncode == 0, res.stderr[-4000:]
    assert "NO_JAX_OK" in res.stdout
