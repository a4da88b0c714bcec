"""Native (C++) build into a serving-only torch index.

The counterpart of ``native_bulk_build_serving`` in
``pgvector_rx_tpu/native/__init__.py``: the shared framework-free C++
engine (``NativeGraph``) builds the HNSW graph on the host, exports the
flat serving arrays in one call, and the last step puts them on the
index's device as a torch ``DeviceGraph`` (dense kinds).
"""

from __future__ import annotations

import numpy as np
import torch

from pgvector_rx_tpu.constants import hnsw_get_layer_m
from pgvector_rx_tpu.native import NativeGraph

from .graph.device import DeviceGraph, _serve_dtype_for, _serve_value_arrays
from .graph.device_build import _prepare_dense_bulk


def native_bulk_build_serving(index, data, ids) -> None:
    """Native C++ build -> serving-only index on ``index.device``: the
    graph goes from the C++ arena to flat tensors in one export call, with
    no per-element Python objects (dense kind)."""
    if index.kind != "dense":
        raise NotImplementedError(
            "the torch serving-only native build supports the dense kind"
        )
    m = index.params.m
    store_dtype = index.dtype or np.float32
    rows, kept = _prepare_dense_bulk(index, data, ids)
    if index.dtype is not None and index.dtype != np.float32:
        # score the f16-STORED value (reload-equivalence)
        rows = rows.astype(index.dtype).astype(np.float32)
    n = len(rows)
    if n == 0:
        return
    levels = index.random_levels(n)
    ng = NativeGraph(index.dim, m, index.params.ef_construction, index.metric)
    ng.bulk_insert(rows, levels, kept)

    flat = ng.export_flat(hnsw_get_layer_m(m, 0), m)
    n_el = flat["n"]
    tid_off = flat["tid_off"]
    tid_flat = flat["tid_flat"]
    # slot -> first heap tid (int64-exact) -> input row, vectorized
    first_tid = tid_flat[tid_off[:n_el]]
    order = np.argsort(kept, kind="stable")
    row_idx = order[np.searchsorted(kept[order], first_tid)]
    index.store.bulk_load(rows[row_idx].astype(store_dtype))

    # heap TID lists (multi-TID duplicate emission, <= 10 per element)
    counts = flat["tid_count"][:n_el]
    flat_list = tid_flat.tolist()
    offs = tid_off.tolist()
    index.heap_tids = [
        flat_list[offs[i] : offs[i] + int(counts[i])] for i in range(n_el)
    ]

    vals = np.zeros((n_el + 1, index.dim), dtype=np.float32)
    vals[:n_el] = rows[row_idx]
    device = index.device
    value_arrays = _serve_value_arrays(
        torch.from_numpy(vals).to(device), _serve_dtype_for(index)
    )
    entry = ng.entry
    index.entry = entry if entry >= 0 else None
    index.serving_only = True
    index._device = DeviceGraph.from_numpy(
        {**flat, **value_arrays}, kind=index.kind, metric=index.metric,
        cap=n_el, m=m, entry=entry,
        entry_level=int(flat["levels"][entry]) if entry >= 0 else -1,
        device=device,
    )
