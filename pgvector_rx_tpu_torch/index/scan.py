"""Batch search of the PyTorch port: ``search`` of
``pgvector_rx_tpu/index/scan.py`` with the torch device engines. The host
path is the shared reference scan (``HnswScan``)."""

from __future__ import annotations

import numpy as np
import torch

from pgvector_rx_tpu.config import SearchParams
from pgvector_rx_tpu.index.scan import HnswScan, _is_single_query
from pgvector_rx_tpu.utils.stats import ScanStats


def search(index, queries, k: int, params: SearchParams, method: str = "auto",
           filter_mask=None):
    """Batch k-NN. Returns (distances [B,k] operator-domain, ids [B,k]).

    method="host" walks the reference scan path per query;
    method="device" runs the batched beam over the device graph;
    "exact" / "approx" the exact FP32 / binned bf16 sweeps (dense only);
    "auto" uses the device for dense batches >= 32 queries or serving-only
    indexes, and lets the device layer choose exact vs beam.

    ``filter_mask``: optional bool array over element ids. Device
    exact/approx engines pre-filter inside the sweep; the host path
    filters at emission under the iterative-scan budget.
    """
    if isinstance(queries, torch.Tensor):
        # staged query batch: passed through untouched
        single = queries.ndim == 1
        qlist = queries[None] if single else queries
    else:
        single = _is_single_query(index, queries)
        qlist = [queries] if single else list(queries)

    engine = {
        "device": "beam",
        "exact": "exact",
        "approx": "approx",
        "auto": "auto",
    }.get(method)
    use_device = method in ("device", "exact", "approx") or (
        method == "auto"
        and (
            (index.kind == "dense" and (len(qlist) >= 32 or index.serving_only))
            or (index.kind != "dense" and index.serving_only)
        )
    )
    if use_device:
        from ..graph import device as device_mod

        dists, ids = device_mod.search(
            index, qlist, k, params, engine=engine, filter_mask=filter_mask
        )
        # order-distance -> operator-distance (l2: sqrt; others same)
        if index.metric == "l2":
            dists = np.where(
                np.isfinite(dists), np.sqrt(np.maximum(dists, 0.0)), dists
            )
    else:
        if isinstance(queries, torch.Tensor):
            qlist = list(qlist.cpu().numpy())
        B = len(qlist)
        dists = np.full((B, k), np.inf, dtype=np.float64)
        ids = np.full((B, k), -1, dtype=np.int64)
        agg = ScanStats()
        for b, q in enumerate(qlist):
            scan = HnswScan(index, q, params, filter_mask=filter_mask)
            # HnswScan already emits operator-domain distances
            for j, (tid, d) in enumerate(scan.take(k)):
                dists[b, j] = d
                ids[b, j] = tid
            agg.merge(scan.scan_stats)
        index.last_scan_stats = agg
    if single:
        return dists[0], ids[0]
    return dists, ids
