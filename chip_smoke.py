"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's serving path end to end on ``cuda:0`` and fails (exit
code != 0) on any phase that does not hold:

1. print the card and its power limit, build the CUDA kernels from
   ``pgvector_rx_tpu_torch/csrc``;
2. make a 250,000 x 128-d SIFT-like corpus and 16,384 queries
   (``bench.make_dataset``, seed 0);
3. build an l2 HNSW index (m=16, ef_construction=64) with the native C++
   engine into a serving-only torch index on the card;
4. hold each kernel against its plain-torch version at the main path's
   shapes (1,024 queries x every row, k=10) and time both; the K2 check
   must also reject a control whose sums are rounded to bf16;
5. ground truth: K1 ``l2_topk`` over all queries in chunks of 1,024,
   checked against float64 numpy on 64 queries;
6. ``serve_topk`` with the exact, approx and beam (ef=40) engines: one
   warm call and one timed call each, recall@10 and qps;
7. ``HnswIndex.search`` with exact / approx / device, held against
   ``serve_topk`` after the element -> heap-tid mapping.

Kernel launch counts are reset just before phase 5 and read after phase
7: every kernel of the path must have run. The last two lines of output
are one JSON object per kernel list and the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS, DIM, N_QUERIES, K, CHUNK = 250_000, 128, 16_384, 10, 1024
EF = 40


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"--- phase {self.name}")
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name}: {time.time() - self.t0:.3f} s")
        return False


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` (CUDA events), after one warm call."""
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


def tie_aware_mismatch(ids_a, d_a, ids_b, d_b, tol) -> int:
    """Rows whose id sets differ other than by ties at the k-th distance:
    every id in one set and not the other must lie within ``tol`` of the
    other side's k-th distance."""
    bad = 0
    for r in range(ids_a.shape[0]):
        sa, sb = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        if sa == sb:
            continue
        kth_a, kth_b = d_a[r, -1], d_b[r, -1]
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        tie = all(abs(da[i] - kth_b) <= tol[r] for i in sa - sb) and all(
            abs(db[i] - kth_a) <= tol[r] for i in sb - sa
        )
        bad += not tie
    return bad


def binned_bf16_sums(vb, a, qb, k, tn):
    """Control for the K2 check: the binned sweep with every dot product
    rounded to bf16 (a kernel that lost its f32 accumulation)."""
    b, n = qb.shape[0], vb.shape[0]
    s = a[None, :] - 2.0 * (qb @ vb.T).float()  # bf16 GEMM output
    s = torch.nn.functional.pad(s, (0, (-n) % tn), value=float("inf"))
    mn, tile = s.view(b, -1, tn).min(dim=1)
    ids = tile * tn + torch.arange(tn, device=s.device)[None, :]
    sd, slot = torch.topk(mn, k, dim=1, largest=False, sorted=True)
    return sd, torch.gather(ids, 1, slot).to(torch.int32)


def k2_agreement(d, ids, p_d, p_ids, q2max) -> tuple[float, bool]:
    """(max abs error, agrees) of K2-style squared-l2 results ``(d, ids)``
    against the plain binned version: distances must lie within rtol 1e-2
    and within ``1e-5 |d| + 2e-5 max(q2)`` (K1's scale, twice its atol for
    the tensor cores' summation order), and id sets may differ only at
    ties within that tolerance."""
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    tol = 1e-5 * np.abs(p_d) + 2e-5 * q2max
    err = np.abs(d - p_d)
    ok = (bool((err <= tol).all())
          and np.allclose(d, p_d, rtol=1e-2, atol=0.0)
          and not tie_aware_mismatch(ids, d, p_ids, p_d, tol.max(axis=1)))
    return float(err.max()), ok


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; none is visible")
    import bench
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams, SearchParams
    from pgvector_rx_tpu_torch.graph import device as device_mod
    from pgvector_rx_tpu_torch.ops import _build
    from pgvector_rx_tpu_torch.ops import bruteforce as bf

    dev = torch.device("cuda:0")
    kernels = {}

    with Phase("1 card + kernel build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn={torch.backends.cudnn.allow_tf32}")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise RuntimeError("TF32 must stay off in the port")
        log(f"kernel library: {_build.build()}")
        _build.lib()

    with Phase("2 data"):
        data, queries = bench.make_dataset(N_ROWS, DIM, N_QUERIES, seed=0)
        log(f"corpus {data.shape}, queries {queries.shape}")

    with Phase("3 native build"):
        index = HnswIndex.build(
            data, metric="l2", params=IndexParams(m=16, ef_construction=64),
            method="native", host_graph=False, seed=1, device="cuda",
        )
        g = index.device_graph()
        log(f"graph: cap={g.cap} entry={g.entry} level={g.entry_level} "
            f"upper rows={g.upper_neighbors.shape[0]} on {g.device}")
        if g.device.type != "cuda" or g.cap != N_ROWS:
            raise RuntimeError("the graph is not on the card at full size")

    q_dev = torch.from_numpy(queries).to(dev)
    with Phase("4 kernels vs plain"):
        q1 = q_dev[:CHUNK].contiguous()
        live = g.traversable & (g.tid_count > 0)
        a = (g.x2 + torch.where(live, 0.0, bf._NEG_BIG)).contiguous()
        q2max = float((q1 * q1).sum(1).max())

        k1_d, k1_i = bf._surrogate_topk_cuda(g.values, a, q1, K)
        p1_d, p1_i = bf._surrogate_topk_plain(g.values, a, q1, K)
        torch.cuda.synchronize()
        k1_d, p1_d = k1_d.cpu().numpy(), p1_d.cpu().numpy()
        k1_i, p1_i = k1_i.cpu().numpy(), p1_i.cpu().numpy()
        tol = 1e-5 * np.abs(p1_d).max(axis=1) + 1e-5 * q2max
        err1 = float(np.abs(k1_d - p1_d).max())
        if not np.allclose(k1_d, p1_d, rtol=1e-5, atol=1e-5 * q2max):
            raise RuntimeError(f"K1 distances disagree (max abs err {err1})")
        if tie_aware_mismatch(k1_i, k1_d, p1_i, p1_d, tol):
            raise RuntimeError("K1 id sets disagree beyond ties")
        kernels["k1_topk"] = dict(
            name="k1_topk", route="cuda",
            source="pgvector_rx_tpu_torch/csrc/bruteforce.cu",
            replaces="pgvector_rx_tpu/ops/pallas_bruteforce.py:34",
            max_abs_err=err1,
            ms=cuda_ms(lambda: bf._surrogate_topk_cuda(g.values, a, q1, K)),
            plain_ms=cuda_ms(
                lambda: bf._surrogate_topk_plain(g.values, a, q1, K)),
        )

        vb = g.values_bf16
        qb = q1.to(torch.bfloat16)
        q2 = (q1 * q1).sum(1, keepdim=True)
        # order distances: squared l2 restored from the surrogate scores
        k2_d, k2_i = bf._binned_cuda(vb, a, qb, K, 1024)
        p2_d, p2_i = bf._binned_plain(vb, a, q1, K, 1024)
        c2_d, c2_i = binned_bf16_sums(vb, a, qb, K, 1024)
        torch.cuda.synchronize()
        p2_d, p2_i = (p2_d + q2).cpu().numpy(), p2_i.cpu().numpy()
        err2, ok2 = k2_agreement(k2_d + q2, k2_i, p2_d, p2_i, q2max)
        ctl2, ctl_ok = k2_agreement(c2_d + q2, c2_i, p2_d, p2_i, q2max)
        log(f"K2 max abs err {err2} ({err2 / q2max:.3e} of max q2 "
            f"{q2max}); control with bf16-rounded sums: {ctl2} "
            f"({ctl2 / q2max:.3e} of max q2)")
        if not ok2:
            raise RuntimeError(f"K2 disagrees with its plain version "
                               f"(max abs err {err2})")
        if ctl_ok:
            raise RuntimeError("the K2 check passes bf16-rounded sums: "
                               "too loose to catch a wrong kernel")
        kernels["k2_binned"] = dict(
            name="k2_binned", route="cuda",
            source="pgvector_rx_tpu_torch/csrc/bruteforce.cu",
            replaces="pgvector_rx_tpu/ops/pallas_bruteforce.py:185",
            max_abs_err=err2,
            ms=cuda_ms(lambda: bf._binned_cuda(vb, a, qb, K, 1024)),
            plain_ms=cuda_ms(lambda: bf._binned_plain(vb, a, q1, K, 1024)),
        )
        for kr in kernels.values():
            log(f"{kr['name']}: kernel {kr['ms']:.4f} ms, plain "
                f"{kr['plain_ms']:.4f} ms, max abs err {kr['max_abs_err']}")

    # ---- the main path: ground truth, engines, search --------------------
    bf.reset_launches()
    with Phase("5 ground truth (K1 l2_topk)"):
        base = torch.from_numpy(data).to(dev)
        gt = torch.cat([
            bf.l2_topk(base, q_dev[s : s + CHUNK], K)[1]
            for s in range(0, N_QUERIES, CHUNK)
        ]).cpu().numpy()
        del base
        q64, x64 = queries[:64].astype(np.float64), data.astype(np.float64)
        ref = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
               - 2.0 * q64 @ x64.T)  # [64, N] squared l2 in float64
        del x64
        ref_d = np.sort(ref, axis=1)[:, :K]
        gt_d = np.take_along_axis(ref, gt[:64].astype(np.int64), axis=1)
        if gt.shape != (N_QUERIES, K) or (gt < 0).any():
            raise RuntimeError("ground truth has the wrong shape or holes")
        if not np.allclose(np.sort(gt_d, axis=1), ref_d, rtol=1e-5,
                           atol=1e-4):
            raise RuntimeError("ground truth disagrees with float64 numpy")
        log(f"gt {gt.shape}, float64 check on 64 queries ok")

    # serve_topk returns element ids; ground truth is in corpus rows = tids
    emit_tid = g.emit_tid.cpu().numpy()

    def recall(ids):
        tids = np.where(ids >= 0, emit_tid[np.maximum(ids, 0)], -1)
        return float(np.mean([len(set(tids[b]) & set(gt[b])) / K
                              for b in range(N_QUERIES)]))

    results = {}
    floors = {"exact": 0.999, "approx": 0.98, "beam": 0.95}
    for engine, kname in (("exact", "k1_topk"), ("approx", "k2_binned"),
                          ("beam", None)):
        with Phase(f"6 serve_topk {engine}"):
            before = dict(bf.LAUNCHES)
            device_mod.serve_topk(index, q_dev, K, engine=engine, ef=EF)
            t0 = time.time()
            d, ids = device_mod.serve_topk(index, q_dev, K, engine=engine,
                                           ef=EF)
            dt = time.time() - t0
            rec = recall(ids)
            results[engine] = (d, ids)
            log(f"{engine}: recall@10={rec:.4f} qps={N_QUERIES / dt:.1f} "
                f"({dt:.4f} s for {N_QUERIES} queries)")
            if d.shape != (N_QUERIES, K) or not np.isfinite(d).all():
                raise RuntimeError(f"{engine}: non-finite or misshapen output")
            if rec < floors[engine]:
                raise RuntimeError(f"{engine}: recall {rec} < {floors[engine]}")
            if kname and bf.LAUNCHES[kname] <= before[kname]:
                raise RuntimeError(f"{engine}: kernel {kname} did not launch")

    with Phase("7 index.search vs serve_topk"):
        q64 = queries[:64]
        for method, engine in (("exact", "exact"), ("approx", "approx"),
                               ("device", "beam")):
            sd, stids = index.search(q64, K, SearchParams(ef_search=EF),
                                     method=method)
            d, ids = results[engine]
            tids = np.where(ids[:64] >= 0, emit_tid[np.maximum(ids[:64], 0)],
                            -1)
            tol = 1e-4 * np.abs(d[:64]).max(axis=1) + 1e-4
            bad = tie_aware_mismatch(stids, sd.astype(np.float64) ** 2, tids,
                                     d[:64].astype(np.float64), tol)
            log(f"search({method}): {bad} of 64 rows differ from serve_topk")
            if bad > (1 if engine == "beam" else 0):
                raise RuntimeError(f"search({method}) disagrees with "
                                   "serve_topk")

    if any(m == "jax" or m.startswith("jax.") for m in sys.modules):
        raise RuntimeError("the port's path imported JAX")
    launches = dict(bf.LAUNCHES)
    for name, kr in kernels.items():
        kr["launches"] = launches[name]
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the main path")
    log(json.dumps({"kernels": [kernels["k1_topk"], kernels["k2_binned"]]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
