"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port end to end on ``cuda:0`` and fails (exit code != 0) on any
phase that does not hold. Two paths, each driven with the kernel launch
counts set to 0 just before it and read just after:

**Device-build path** (the main path, 1,000,000 x 128-d):

1. print the card and its power limit, build the CUDA kernels from
   ``pgvector_rx_tpu_torch/csrc``;
2. make a 1,000,000 x 128-d SIFT-like corpus and 16,384 queries
   (``pgvector_rx_tpu_torch.data.make_dataset``, seed 0) and put the
   corpus on the card;
3. build an l2 HNSW index (m=16, ef_construction=64) from the CUDA tensor
   with the port's batched device build, serving-only; print build
   seconds and rows/s; check the graph's invariants on the card;
4. ground truth: K1 ``l2_topk`` over all queries in chunks of 1,024,
   checked against float64 numpy on 64 queries;
5. ``serve_topk`` with the exact, approx and beam (ef=40) engines: one
   warm call and one timed call each, recall@10 and qps against floors;
6. the tile-min probe's A/B over all queries in 1,024-query chunks: K3 at
   tn=1024 then the f32 rescore, K2 at tn=1024, the approx engine;
7. ``HnswIndex.search`` with exact / approx / device, held against
   ``serve_topk`` after the element -> heap-tid mapping.

Then, outside the counted paths:

8. hold each kernel (K1, K2, K3 and K3's shift reduction) against its
   plain-torch version at the main path's shapes (1,024 queries x every
   row, k=10) and time both, beside the plain ``torch.matmul`` that makes
   the same [1,024, N] scores (the product alone, not the same function);
   the K1 check must reject a control whose operands are truncated to
   TF32, the K2 check a control whose sums are rounded to bf16, the K3
   check a control that ORs the column into uncleared score bits. K3 is
   timed end to end (``ms``) and its sweep kernel alone (``kernel_ms``).
   Each kernel's bound is computed from the shapes and the card's
   published peaks (``PEAKS``).

**Native path** (9-12, the first 100,000 rows): the native C++ host build
into a serving-only torch index, its own K1 ground truth, and phases 5 and
7 on it.

Every kernel must have run on the device-build path, and K1 and K2 on the
native path. The last two lines of output are one JSON object per kernel
list and the device line.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

N_ROWS, DIM, N_QUERIES, K, CHUNK = 1_000_000, 128, 16_384, 10, 1024
N_NATIVE = 100_000
DEVICE = "cuda:0"
EF = 40
M, EF_CONSTRUCTION = 16, 64
FLOORS = {"exact": 0.999, "approx": 0.98, "beam": 0.95}
K3_FLOOR = 0.90
CSRC = "pgvector_rx_tpu_torch/csrc/"
PALLAS = "pgvector_rx_tpu/ops/pallas_bruteforce.py"
#: published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12}


def bound(ops: float, peak: str, nbytes: float) -> dict:
    """The least time the card could take: the larger of ``ops`` over the
    ``peak`` rate and ``nbytes`` (each input read once, each output
    written once) over the memory rate."""
    t_ops = ops / PEAKS[peak] * 1e3
    t_bytes = nbytes / PEAKS["bytes"] * 1e3
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_peak=(f"{peak} {PEAKS[peak] / 1e12:g} TFLOP/s"
                            if t_ops >= t_bytes else "3.35 TB/s"))


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


def tf32_truncated(t):
    """``t`` with the low 13 mantissa bits cleared: TF32 operands."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def k1_agreement(d, ids, p_d, p_ids, q2max) -> tuple[float, bool]:
    """(max abs error, agrees) of K1-style surrogate scores ``(d, ids)``
    against the plain FP32 sweep: rtol 1e-5 with atol ``1e-5 max(q2)``,
    and id sets may differ only at ties within that tolerance."""
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    tol = 1e-5 * np.abs(p_d).max(axis=1) + 1e-5 * q2max
    err = float(np.abs(d - p_d).max())
    ok = (np.allclose(d, p_d, rtol=1e-5, atol=1e-5 * q2max)
          and not tie_aware_mismatch(ids, d, p_ids, p_d, tol))
    return err, ok


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


def tilemin_no_clear(bf, vb, a, q, k, tn):
    """Control for the K3 check: the tile-min sweep ORing the column into
    the score bits WITHOUT clearing the low 10 bits (its ids are corrupt)."""
    q2x, av, shift = bf._tilemin_prepare(vb, a, q)
    n = vb.shape[0]
    x = torch.nn.functional.pad(vb.float(), (0, 0, 0, (-n) % tn))
    av = torch.nn.functional.pad(av, (0, (-n) % tn), value=bf._NEG_BIG)
    s = av[None, :] - q2x.float() @ x.T
    col = torch.arange(s.shape[1], device=s.device, dtype=torch.int32) % tn
    packed = (s.view(torch.int32) | col[None, :]).view(q.shape[0], -1, tn)
    return bf._tilemin_unpack(packed.amin(dim=2), shift, n, k, tn)


def k3_agreement(bf, d, ids, p_d, p_ids, vb, a, q, q2, q2max):
    """(max abs error, agrees) of K3's squared-l2 results ``(d, ids)``
    against the plain tile-min version ``(p_d, p_ids)``: every returned
    distance lies within one 13-bit packing quantum of the shifted score
    plus K2's summation tolerance, ``(|d| + shift) 2^-13 + 1e-5 |d| +
    2e-5 max(q2)``, both of the plain result at the same rank and of the
    returned id's own bf16 score; id sets may differ only at ties within
    that tolerance."""
    _, _, shift = bf._tilemin_prepare(vb, a, q)
    q2x = (2.0 * q.float()).to(torch.bfloat16).float()
    safe = ids.clamp(min=0).long()
    own = a[safe] - (vb[safe].float() * q2x[:, None, :]).sum(-1) + q2
    d, ids, own = d.cpu().numpy(), ids.cpu().numpy(), own.cpu().numpy()
    fin = p_ids >= 0  # fewer tiles than k leave (inf, -1) pads
    tol = np.where(fin, (np.abs(p_d) + float(shift)) * 2.0 ** -13
                   + 1e-5 * np.abs(p_d) + 2e-5 * q2max, 0.0)
    with np.errstate(invalid="ignore"):  # inf - inf on the pads
        err = np.abs(np.where(fin, d - p_d, 0.0))
        own_err = np.abs(np.where(fin, d - own, 0.0))
    ok = (bool(((ids >= 0) == fin).all()) and bool((err <= tol).all())
          and bool((own_err <= tol).all())
          and not tie_aware_mismatch(ids, d, p_ids, p_d, tol.max(axis=1)))
    return float(err.max()), ok


def check_graph(g, m: int, n: int) -> None:
    """Invariants of a built graph, on its device: layer-0 degree <= 2m
    and upper degree <= m, every live row linked, no self-edges, no edge
    to a dead row or to a row below the layer, the entry alive at the
    maximum level, cap = n."""
    if g.cap != n:
        raise RuntimeError(f"graph cap {g.cap}, want {n}")
    nb0, alive, levels = g.neighbors0.long(), g.traversable, g.levels.long()
    if nb0.shape[1] != 2 * m or g.upper_neighbors.shape[1] % m:
        raise RuntimeError("adjacency widths are not 2m / m per layer")
    ids = torch.arange(nb0.shape[0], device=nb0.device)[:, None]
    live = nb0[alive]
    ok = live >= 0
    if bool((live == ids[alive]).any()):
        raise RuntimeError("self-edge at layer 0")
    if not bool(alive[live[ok]].all()) or bool((nb0[~alive] >= 0).any()):
        raise RuntimeError("layer-0 edge from or to a dead row")
    if int(ok.sum(1).min()) < 1:
        raise RuntimeError("a live row has no layer-0 neighbour")
    lmax = g.upper_neighbors.shape[1] // m
    up_el = torch.nonzero(alive & (levels >= 1)).flatten()
    rows = g.upper_neighbors[g.upper_slot[up_el].long()].long()
    rows = rows.view(-1, lmax, m)
    lc = torch.arange(1, lmax + 1, device=rows.device)[None, :, None]
    used = lc <= levels[up_el][:, None, None]
    r_ok = rows >= 0
    if bool((r_ok & ~used).any()):
        raise RuntimeError("upper edges above an element's level")
    tgt = rows.clamp(min=0)
    bad = r_ok & (~alive[tgt] | (levels[tgt] < lc) | (tgt == up_el[:, None,
                                                                  None]))
    if bool(bad.any()):
        raise RuntimeError("upper edge to a dead, self or lower-level row")
    top = int(levels[alive].max())
    if not bool(alive[g.entry]) or int(levels[g.entry]) != top \
            or g.entry_level != top:
        raise RuntimeError("the entry is not at the maximum level")
    log(f"graph invariants hold: cap={g.cap}, {int(alive.sum())} live rows, "
        f"mean layer-0 degree {float(ok.sum(1).float().mean()):.2f}, "
        f"{up_el.numel()} upper rows, entry {g.entry} at level {top}")


def ground_truth(bf, base_np, queries_np, q_dev):
    """K1 top-k over every query, checked against float64 numpy."""
    dev = q_dev.device
    base = torch.from_numpy(base_np).to(dev)
    gt = torch.cat([
        bf.l2_topk(base, q_dev[s : s + CHUNK], K)[1]
        for s in range(0, q_dev.shape[0], CHUNK)
    ]).cpu().numpy()
    del base
    q64, x64 = queries_np[:64].astype(np.float64), base_np.astype(np.float64)
    ref = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
           - 2.0 * q64 @ x64.T)  # [64, N] squared l2 in float64
    del x64
    ref_d = np.sort(np.partition(ref, K, axis=1)[:, :K], axis=1)
    gt_d = np.take_along_axis(ref, gt[:64].astype(np.int64), axis=1)
    if gt.shape != (q_dev.shape[0], K) or (gt < 0).any():
        raise RuntimeError("ground truth has the wrong shape or holes")
    if not np.allclose(np.sort(gt_d, axis=1), ref_d, rtol=1e-5, atol=1e-4):
        raise RuntimeError("ground truth disagrees with float64 numpy")
    log(f"gt {gt.shape}, float64 check on 64 queries ok")
    return gt


def recall_of(emit_tid, gt):
    """recall@K of element ids against ground-truth corpus rows (= tids)."""
    def recall(ids):
        tids = np.where(ids >= 0, emit_tid[np.maximum(ids, 0)], -1)
        return float(np.mean([len(set(tids[b]) & set(gt[b])) / K
                              for b in range(gt.shape[0])]))
    return recall


def serve_engines(index, q_dev, recall, bf, device_mod, tag):
    results = {}
    for engine, kname in (("exact", "k1_topk"), ("approx", "k2_binned"),
                          ("beam", None)):
        with Phase(f"{tag} serve_topk {engine}"):
            before = dict(bf.LAUNCHES)
            device_mod.serve_topk(index, q_dev, K, engine=engine, ef=EF)
            torch.cuda.synchronize()
            t0 = time.time()
            d, ids = device_mod.serve_topk(index, q_dev, K, engine=engine,
                                           ef=EF)
            dt = time.time() - t0
            rec = recall(ids)
            results[engine] = (d, ids)
            log(f"{tag} {engine}: recall@10={rec:.4f} "
                f"qps={q_dev.shape[0] / dt:.1f} ({dt:.4f} s for "
                f"{q_dev.shape[0]} queries)")
            if d.shape != (q_dev.shape[0], K) or not np.isfinite(d).all():
                raise RuntimeError(f"{engine}: non-finite or misshapen output")
            if rec < FLOORS[engine]:
                raise RuntimeError(f"{engine}: recall {rec} < {FLOORS[engine]}")
            if kname and bf.LAUNCHES[kname] <= before[kname]:
                raise RuntimeError(f"{engine}: kernel {kname} did not launch")
    return results


def search_vs_serve(index, queries_np, results, emit_tid, SearchParams, tag):
    with Phase(f"{tag} index.search vs serve_topk"):
        q64 = queries_np[:64]
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
            log(f"{tag} search({method}): {bad} of 64 rows differ from "
                "serve_topk")
            if bad > (1 if engine == "beam" else 0):
                raise RuntimeError(f"search({method}) disagrees with "
                                   "serve_topk")


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; none is visible")
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams, SearchParams
    from pgvector_rx_tpu_torch.graph import device as device_mod
    from pgvector_rx_tpu_torch.ops import _build
    from pgvector_rx_tpu_torch.ops import bruteforce as bf

    dev = torch.device(DEVICE)
    kernels = {}
    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)

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
        data, queries = make_dataset(N_ROWS, DIM, N_QUERIES, seed=0)
        x_dev = torch.from_numpy(data).to(dev)
        q_dev = torch.from_numpy(queries).to(dev)
        log(f"corpus {data.shape} on {x_dev.device}, queries {queries.shape}")

    # ---- device-build path ------------------------------------------------
    bf.reset_launches()
    with Phase("3 device build"):
        torch.cuda.synchronize()
        t0 = time.time()
        index = HnswIndex.build(x_dev, metric="l2", params=params,
                                method="device", host_graph=False,
                                device=dev, seed=1)
        torch.cuda.synchronize()
        dt = time.time() - t0
        log(f"device build: {dt:.3f} s, {N_ROWS / dt:.1f} rows/s "
            f"(peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB)")
        g = index.device_graph()
        if g.device.type != dev.type:
            raise RuntimeError("the graph is not on the card")
        check_graph(g, M, N_ROWS)
    live = g.traversable & (g.tid_count > 0)
    a = (g.x2 + torch.where(live, 0.0, bf._NEG_BIG)).contiguous()
    vb = g.values_bf16

    with Phase("4 ground truth (K1 l2_topk)"):
        gt = ground_truth(bf, data, queries, q_dev)
    emit_tid = g.emit_tid.cpu().numpy()
    recall = recall_of(emit_tid, gt)
    results = serve_engines(index, q_dev, recall, bf, device_mod, "5")

    with Phase("6 tile-min probe A/B"):
        def sweep(fn):
            out = [fn(q_dev[s : s + CHUNK]) for s in range(0, N_QUERIES,
                                                            CHUNK)]
            return torch.cat(out).cpu().numpy()

        arms = {
            "k3 tn=1024 + rescore": lambda qc: device_mod._rescore_true(
                g, qc, *bf.tilemin_sweep_topk(vb, a, qc, K, "l2",
                                              tn=1024))[1],
            "k2 tn=1024": lambda qc: bf.binned_sweep_topk(
                vb, a, qc, K, "l2", tn=1024)[1],
            "approx engine": lambda qc: torch.from_numpy(
                device_mod.serve_topk(index, qc, K, engine="approx")[1]),
        }
        ab = {}
        for label, fn in arms.items():
            sweep(fn)  # warm
            torch.cuda.synchronize()
            t0 = time.time()
            ids = sweep(fn)
            dt = time.time() - t0
            ab[label] = (recall(ids), N_QUERIES / dt)
            log(f"A/B {label}: recall@10={ab[label][0]:.4f} "
                f"qps={ab[label][1]:.1f}")
        if ab["k3 tn=1024 + rescore"][0] < K3_FLOOR:
            raise RuntimeError(f"K3 arm recall below {K3_FLOOR}")

    search_vs_serve(index, queries, results, emit_tid, SearchParams, "7")
    main_launches = dict(bf.LAUNCHES)
    log(f"device-build path launches: {main_launches}")
    for name, n_launch in main_launches.items():
        if n_launch <= 0:
            raise RuntimeError(f"kernel {name} never ran on the main path")

    with Phase("8 kernels vs plain"):
        q1 = q_dev[:CHUNK].contiguous()
        q2max = float((q1 * q1).sum(1).max())
        q2 = (q1 * q1).sum(1, keepdim=True)

        x32 = g.values
        k1_d, k1_i = bf._surrogate_topk_cuda(x32, a, q1, K)
        p1_d, p1_i = bf._surrogate_topk_plain(x32, a, q1, K)
        c1_d, c1_i = bf._surrogate_topk_plain(tf32_truncated(x32), a,
                                              tf32_truncated(q1), K)
        torch.cuda.synchronize()
        p1_d, p1_i = p1_d.cpu().numpy(), p1_i.cpu().numpy()
        err1, ok1 = k1_agreement(k1_d, k1_i, p1_d, p1_i, q2max)
        ctl1, ctl1_ok = k1_agreement(c1_d, c1_i, p1_d, p1_i, q2max)
        log(f"K1 max abs err {err1} ({err1 / q2max:.3e} of max q2); control "
            f"with TF32-truncated operands: {ctl1} ({ctl1 / q2max:.3e})")
        if not ok1:
            raise RuntimeError(f"K1 disagrees with its plain version "
                               f"(max abs err {err1})")
        if ctl1_ok:
            raise RuntimeError("the K1 check passes TF32 operands: too loose "
                               "for a 3xTF32 kernel")
        del c1_d, c1_i
        n_rows, b1 = x32.shape[0], q1.shape[0]
        out_bytes = b1 * K * 8
        kernels["k1_topk"] = dict(
            name="k1_topk", route="cuda", source=CSRC + "k1_topk.cu",
            replaces=f"{PALLAS}:34", max_abs_err=err1,
            ms=cuda_ms(lambda: bf._surrogate_topk_cuda(x32, a, q1, K)),
            plain_ms=cuda_ms(lambda: bf._surrogate_topk_plain(x32, a, q1, K)),
            **bound(3 * 2.0 * b1 * n_rows * DIM, "tf32",
                    (n_rows * DIM + n_rows + b1 * DIM) * 4 + out_bytes),
            library_ms=None,
            matmul_ms=cuda_ms(lambda: q1 @ x32.T),
            matmul_of="q @ x.T alone in f32 (the product, not the function)",
        )

        qb = q1.to(torch.bfloat16)
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
        bf16_bytes = (n_rows * DIM + b1 * DIM) * 2 + n_rows * 4
        kernels["k2_binned"] = dict(
            name="k2_binned", route="cuda", source=CSRC + "k2_binned.cu",
            replaces=f"{PALLAS}:185", max_abs_err=err2,
            ms=cuda_ms(lambda: bf._binned_cuda(vb, a, qb, K, 1024)),
            plain_ms=cuda_ms(lambda: bf._binned_plain(vb, a, q1, K, 1024)),
            **bound(2.0 * b1 * n_rows * DIM, "bf16", bf16_bytes + out_bytes),
            library_ms=None,
            matmul_ms=cuda_ms(lambda: qb @ vb.T),
            matmul_of="q @ x.T alone in bf16 (the product, not the function)",
        )

        k3_d, k3_i = bf._tilemin_cuda(vb, a, q1, K, 1024)
        p3_d, p3_i = bf._tilemin_plain(vb, a, q1, K, 1024)
        c3_d, c3_i = tilemin_no_clear(bf, vb, a, q1, K, 1024)
        torch.cuda.synchronize()
        p3_d, p3_i = (p3_d + q2).cpu().numpy(), p3_i.cpu().numpy()
        err3, ok3 = k3_agreement(bf, k3_d + q2, k3_i, p3_d, p3_i, vb, a, q1,
                                 q2, q2max)
        ctl3, ctl3_ok = k3_agreement(bf, c3_d + q2, c3_i, p3_d, p3_i, vb, a,
                                     q1, q2, q2max)
        same3 = float((k3_i.cpu().numpy() == p3_i).mean())
        log(f"K3 max abs err {err3} ({same3:.4f} of ids equal by rank); "
            f"control without the low-bit clear: max abs err {ctl3}, "
            f"{float((c3_i.cpu().numpy() == p3_i).mean()):.4f} of ids equal")
        if not ok3:
            raise RuntimeError(f"K3 disagrees with its plain version "
                               f"(max abs err {err3})")
        if ctl3_ok:
            raise RuntimeError("the K3 check passes uncleared packing: too "
                               "loose to catch a wrong kernel")
        q2x, av3, _ = bf._tilemin_prepare(vb, a, q1)
        kernels["k3_tilemin"] = dict(
            name="k3_tilemin", route="cuda", source=CSRC + "k3_tilemin.cu",
            replaces=f"{PALLAS}:302", max_abs_err=err3,
            ms=cuda_ms(lambda: bf._tilemin_cuda(vb, a, q1, K, 1024)),
            kernel_ms=cuda_ms(
                lambda: bf._tilemin_packed_cuda(vb, av3, q2x, 1024)),
            plain_ms=cuda_ms(lambda: bf._tilemin_plain(vb, a, q1, K, 1024)),
            **bound(2.0 * b1 * n_rows * DIM, "bf16",
                    bf16_bytes + b1 * -(-n_rows // 1024) * 4),
            library_ms=None,
            matmul_ms=kernels["k2_binned"]["matmul_ms"],
            matmul_of="q @ x.T alone in bf16 (the product, not the function)",
        )

        # K3's shift: the largest f32 sum of squares of the bf16 rows. Two
        # sums of DIM positive terms in any orders differ by at most
        # 2 DIM 2^-24 of the sum.
        x2k = float(bf._row_sq_max_cuda(vb))
        x2p = float(bf._row_sq_max_plain(vb))
        err4 = abs(x2k - x2p)
        log(f"K3 shift reduction: {x2k} vs plain {x2p}, abs err {err4} "
            f"(tolerance {2 * DIM * 2.0 ** -24 * x2p})")
        if err4 > 2 * DIM * 2.0 ** -24 * x2p:
            raise RuntimeError("the shift reduction disagrees with its plain "
                               f"version (abs err {err4})")
        kernels["k3_x2max"] = dict(
            name="k3_x2max", route="cuda", source=CSRC + "k3_tilemin.cu",
            replaces=f"{PALLAS}:372 (the XLA reduction beside the kernel)",
            max_abs_err=err4,
            ms=cuda_ms(lambda: bf._row_sq_max_cuda(vb)),
            plain_ms=cuda_ms(lambda: bf._row_sq_max_plain(vb)),
            **bound(2.0 * n_rows * DIM, "f32", n_rows * DIM * 2 + 4),
            library_ms=None,
            matmul_ms=None, matmul_of=None,
        )
        for kr in kernels.values():
            kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
            log(f"{kr['name']}: kernel {kr['ms']:.4f} ms, plain "
                f"{kr['plain_ms']:.4f} ms, product alone {kr['matmul_ms']} "
                f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}, "
                f"{kr['bound_peak']}), share {kr['share_of_bound']:.4f}, "
                f"max abs err {kr['max_abs_err']}")
        k3 = kernels["k3_tilemin"]
        log(f"k3_tilemin sweep kernel alone: {k3['kernel_ms']:.4f} ms, share "
            f"of bound {k3['bound_ms'] / k3['kernel_ms']:.4f}")

    for name in kernels:
        kernels[name]["launches"] = main_launches[name]
    del index, g, x_dev, vb, a
    torch.cuda.empty_cache()

    # ---- native path (first N_NATIVE rows) ---------------------------------
    bf.reset_launches()
    with Phase("9 native build"):
        nat = HnswIndex.build(
            data[:N_NATIVE], metric="l2", params=params, method="native",
            host_graph=False, seed=1,  # no device named: the card
        )
        gn = nat.device_graph()
        log(f"graph: cap={gn.cap} entry={gn.entry} level={gn.entry_level} "
            f"upper rows={gn.upper_neighbors.shape[0]} on {gn.device}")
        if gn.device.type != dev.type or gn.cap != N_NATIVE:
            raise RuntimeError("the native graph is not on the card at size")
    with Phase("10 ground truth (K1 l2_topk)"):
        gt_n = ground_truth(bf, data[:N_NATIVE], queries, q_dev)
    emit_n = gn.emit_tid.cpu().numpy()
    res_n = serve_engines(nat, q_dev, recall_of(emit_n, gt_n), bf,
                          device_mod, "11")
    search_vs_serve(nat, queries, res_n, emit_n, SearchParams, "12")
    for name in ("k1_topk", "k2_binned"):
        if bf.LAUNCHES[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the native path")
    log(f"native path launches: {dict(bf.LAUNCHES)}")

    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pgvector_rx_tpu", "bench")]
    if foreign:
        raise RuntimeError(f"the port's path imported {sorted(foreign)[:5]}")
    log(json.dumps({"kernels": [kernels[k] for k in
                                ("k1_topk", "k2_binned", "k3_tilemin",
                                 "k3_x2max")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
