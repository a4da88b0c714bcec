"""HnswIndex of the PyTorch port.

A subclass of ``pgvector_rx_tpu.index.hnsw.HnswIndex`` that keeps the
host-side semantics (validation, host graph, native C++ engine, vacuum,
persistence of the host graph) and overrides only the device seams: the
index lives on an explicit torch ``device``, ``build`` routes the device
build and the serving-only native build into a torch ``DeviceGraph``, and
``device_graph`` / ``search`` use the port's engines. The seams whose
torch engines are not ported yet (``insert_bulk``, ``scan``, ``load``)
raise instead of reaching the JAX package's.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from pgvector_rx_tpu import native as _native
from pgvector_rx_tpu.config import IndexParams, SearchParams
from pgvector_rx_tpu.index import hnsw as _base

_ROADMAP_OFF_PATH = "ROADMAP queue 1, item 13"
_ROADMAP_KIND = {"bit": "ROADMAP queue 1, item 14",
                 "sparse": "ROADMAP queue 1, item 15"}


class HnswIndex(_base.HnswIndex):
    """An HNSW index whose device graph and engines are torch, on
    ``device`` ("cpu", "cuda", "cuda:1", ...)."""

    def __init__(self, dim: int, metric: str = "l2", kind: str = "dense",
                 params: IndexParams | None = None, dtype=np.float32,
                 seed: int = 0, _skip_dim_check: bool = False,
                 device="cpu"):
        super().__init__(dim, metric=metric, kind=kind, params=params,
                         dtype=dtype, seed=seed,
                         _skip_dim_check=_skip_dim_check)
        self.device = torch.device(device)

    @classmethod
    def build(
        cls,
        data,
        metric: str = "l2",
        params: IndexParams | None = None,
        ids: Optional[Sequence[int]] = None,
        dtype=np.float32,
        seed: int = 0,
        method: str = "auto",
        host_graph: bool = True,
        consume_input: bool = False,
        device="cpu",
    ) -> "HnswIndex":
        """Build an index (ambuild analog) on ``device``.

        ``data``: an [N, D] array, or a torch tensor already on ``device``
        (device-resident input; it takes the device build).
        ``method``: "device" (the batched device build, dense kind),
        "native" (C++ engine), "host" (sequential reference path) or
        "auto" (the JAX package's rule: the device build for dense
        corpora of 20,000 rows or more). ``host_graph=False`` with
        "device" or "native": serving-only index whose graph goes straight
        to a torch DeviceGraph on ``device``.
        """
        if consume_input:
            raise NotImplementedError(
                "consume_input is not ported to torch yet "
                f"({_ROADMAP_OFF_PATH})"
            )
        tensor_in = isinstance(data, torch.Tensor)
        kind = (
            "bit" if metric in _base.BIT_METRICS
            else "dense" if tensor_in
            else "sparse" if _base._is_sparse_data(data) else "dense"
        )
        n = int(data.shape[0]) if tensor_in else len(data)
        dim = (int(data.shape[1]) if tensor_in
               else None if kind == "sparse" else np.asarray(data).shape[1])
        if tensor_in:
            if method not in ("device", "auto"):
                raise ValueError(
                    "device-resident build input requires method='device'"
                )
            method = "device"
        if method == "auto":
            if kind == "dense" and n >= 20000:
                method = "device"
            elif kind == "bit" and n >= 20000 and n * dim * 4 <= (6 << 30):
                raise NotImplementedError(
                    "the bit kind's device build (the JAX package's 'auto' "
                    f"choice here) is not ported ({_ROADMAP_KIND['bit']})"
                )
            else:
                method = "native" if _native.available() else "host"
        if method == "device" and kind != "dense":
            raise NotImplementedError(
                f"the device build of the {kind} kind is not ported "
                f"({_ROADMAP_KIND[kind]})"
            )
        if method == "device" or (method == "native" and not host_graph):
            if kind != "dense":
                raise NotImplementedError(
                    "serving-only torch builds support the dense kind"
                )
            idx = cls(dim, metric=metric, kind=kind, params=params,
                      dtype=dtype, seed=seed, device=device)
            ids = ids if ids is not None else range(n)
            if method == "device":
                from ..graph import device_build

                device_build.bulk_build(idx, data, ids, host_graph=host_graph)
            else:
                from .. import native as native_port

                native_port.native_bulk_build_serving(idx, np.asarray(data),
                                                      ids)
            return idx
        idx = super().build(data, metric=metric, params=params, ids=ids,
                            dtype=dtype, seed=seed, method=method,
                            host_graph=host_graph)
        idx.device = torch.device(device)
        return idx

    def search(self, queries, k: int, params: SearchParams | None = None,
               method: str = "auto", filter_mask=None):
        """k-NN search -> (distances [B,k], heap ids [B,k]), operator-domain
        distances (l2 = true euclidean), padded with inf / -1. ``method``:
        "host", "device" (beam), "exact", "approx" or "auto"."""
        from . import scan

        return scan.search(
            self, queries, k, params or SearchParams(), method=method,
            filter_mask=filter_mask,
        )

    def insert_bulk(self, values, tids: Optional[Sequence[int]] = None):
        raise NotImplementedError(
            "batched device insert is not ported to torch yet "
            "(ROADMAP queue 1, item 9)"
        )

    def scan(self, query, params: SearchParams | None = None,
             method: str = "auto", filter_mask=None):
        raise NotImplementedError(
            "resumable scans are not ported to torch yet "
            "(ROADMAP queue 1, item 10)"
        )

    @classmethod
    def load(cls, path, serving: bool = False):
        raise NotImplementedError(
            "loading checkpoints into torch is not ported yet "
            "(ROADMAP queue 1, item 12)"
        )

    def device_graph(self):
        """Flat-tensor device graph on ``self.device`` (built lazily,
        cached)."""
        if self._device is None:
            from ..graph.device import DeviceGraph

            self._device = DeviceGraph.from_index(self)
        return self._device
