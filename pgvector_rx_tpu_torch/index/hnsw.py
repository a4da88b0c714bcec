"""HnswIndex of the PyTorch port.

A subclass of ``pgvector_rx_tpu.index.hnsw.HnswIndex`` that keeps the
host-side semantics (validation, host graph, native C++ engine, vacuum,
persistence of the host graph) and overrides only the device seams: the
index lives on an explicit torch ``device``, ``build`` routes the
serving-only native build into a torch ``DeviceGraph``, and
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

_DEVICE_BUILD_TODO = (
    "the device build is not ported to torch yet (ROADMAP queue 1, item 7); "
    "use method='native' or method='host'"
)


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
        """Build an index from host data (ambuild analog).

        ``method``: "native" (C++ engine), "host" (sequential reference
        path) or "auto" (the JAX package's rule; where that rule picks the
        device build, this raises). ``host_graph=False`` with "native":
        serving-only index whose graph goes straight from the C++ arena to
        a torch DeviceGraph on ``device``.
        """
        if isinstance(data, torch.Tensor):
            raise NotImplementedError(
                "device-resident (torch.Tensor) build input needs the "
                + _DEVICE_BUILD_TODO
            )
        if consume_input:
            raise NotImplementedError("consume_input needs the "
                                      + _DEVICE_BUILD_TODO)
        kind = (
            "bit" if metric in _base.BIT_METRICS
            else "sparse" if _base._is_sparse_data(data) else "dense"
        )
        n = len(data)
        if method == "auto":
            if kind in ("dense", "bit") and n >= 20000:
                # the JAX package's "auto" picks its device build here
                # (bit: when the unpacked rows fit; the port has neither)
                raise NotImplementedError(_DEVICE_BUILD_TODO)
            method = "native" if _native.available() else "host"
        if method == "device":
            raise NotImplementedError(_DEVICE_BUILD_TODO)
        if method == "native" and not host_graph:
            from .. import native as native_port

            if kind != "dense":
                raise NotImplementedError(
                    "serving-only torch builds support the dense kind"
                )
            arr = np.asarray(data)
            idx = cls(arr.shape[1], metric=metric, kind=kind, params=params,
                      dtype=dtype, seed=seed, device=device)
            native_port.native_bulk_build_serving(
                idx, arr, ids if ids is not None else range(n)
            )
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
