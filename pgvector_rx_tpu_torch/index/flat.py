"""FlatIndex of the PyTorch port: exact brute-force search (the seqscan
analog), the counterpart of ``pgvector_rx_tpu/index/flat.py``.

The reference has no flat index type, but every pgvector workload relies
on the planner falling back to a sequential scan with exact ordering; here
it is both the ground-truth oracle and the planner's alternative when
:func:`pgvector_rx_tpu_torch.index.cost.should_use_index` says no. The rows
live on the host (as in the JAX package); ``search`` runs on the port's
own sweeps on ``device`` (None: the card):

- l2 / ip / cosine: K1 (``ops/bruteforce.l2_topk`` / ``ip_topk`` /
  ``cosine_topk``; cosine over rows normalised with ``max(norm, 1e-30)``);
- l1: the l1 sweep (``graph/device.l1_sweep_topk``);
- hamming / jaccard: K9 (``ops/bits.bits_topk``);
- sparse (l2, ip, cosine, l1): K10 (``ops/sparse.sparse_topk``) over the
  rows and queries padded to the most non-zeros seen (the JAX package's
  budget), cosine over the raw values (the distance divides by both
  norms).

Ties come back lower row first, as ``lax.top_k`` orders them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import SearchParams


class FlatIndex:
    """Exact k-NN over dense, bit or sparse rows."""

    def __init__(self, kind: str, metric: str, dim: int, device=None):
        from .hnsw import resolve_device

        self.device = resolve_device(device)
        self.kind = kind
        self.metric = metric
        self.dim = dim
        self._rows = []
        self._tids = []

    @classmethod
    def build(cls, data, metric: str = "l2", ids=None, kind: str = "dense",
              device=None):
        data_arr = data if not isinstance(data, np.ndarray) else np.asarray(data)
        n = len(data_arr)
        idx = cls(kind, metric,
                  np.asarray(data_arr[0]).shape[-1] if kind != "sparse" else 0,
                  device=device)
        if ids is None:
            ids = range(n)
        for row, tid in zip(data_arr, ids):
            idx.insert(row, int(tid))
        return idx

    def insert(self, row, tid: int) -> None:
        # sparse rows stay SparseVec / (indices, values) pairs
        self._rows.append(row if self.kind == "sparse" else np.asarray(row))
        self._tids.append(tid)

    def delete(self, tids) -> int:
        dead = set(int(t) for t in tids)
        keep = [(r, t) for r, t in zip(self._rows, self._tids) if t not in dead]
        removed = len(self._rows) - len(keep)
        self._rows = [r for r, _ in keep]
        self._tids = [t for _, t in keep]
        return removed

    @property
    def num_tuples(self) -> int:
        return len(self._rows)

    def _sweep(self, q, kk: int):
        """(order distances [B, kk] f32, positions [B, kk] int64) of the
        kk nearest rows, on the index's device (``q``: a query matrix, or
        the sparse kind's list of queries)."""
        from ..graph.device import l1_sweep_topk
        from ..ops import bits, bruteforce, sparse

        dev = self.device
        if self.kind == "sparse":
            def nnz(v):
                return len(v.indices if hasattr(v, "indices") else v[0])

            budget = max(1, max(map(nnz, self._rows)), max(map(nnz, q)))
            bi, bv = sparse.pad_rows(self._rows, budget, dev)
            qi, qv = sparse.pad_rows(q, budget, dev)
            live = torch.ones(bi.shape[0], dtype=torch.bool, device=dev)
            return sparse.sparse_topk(bi, bv, live, qi, qv, kk, self.metric)
        if self.kind == "bit":
            words = bits.as_words(bits.pack_bits(np.stack(self._rows)), dev)
            qw = bits.as_words(bits.pack_bits(q.astype(np.uint8)), dev)
            live = torch.ones(words.shape[0], dtype=torch.bool, device=dev)
            return bits.bits_topk(words, bits.row_popcount(words), live, qw,
                                  kk, self.metric)
        base = np.stack(self._rows).astype(np.float32)
        qq = q.astype(np.float32)
        if self.metric == "cosine":
            base = base / np.maximum(np.linalg.norm(base, axis=1,
                                                    keepdims=True), 1e-30)
            qq = qq / np.maximum(np.linalg.norm(qq, axis=1, keepdims=True),
                                 1e-30)
        x = torch.from_numpy(np.ascontiguousarray(base)).to(dev)
        qt = torch.from_numpy(np.ascontiguousarray(qq)).to(dev)
        if self.metric == "l1":
            return l1_sweep_topk(x, torch.zeros(x.shape[0], device=dev), qt,
                                 kk)
        topk = {"l2": bruteforce.l2_topk, "ip": bruteforce.ip_topk,
                "cosine": bruteforce.cosine_topk}.get(self.metric)
        if topk is None:
            raise ValueError(f"unknown dense metric: {self.metric}")
        d, pos = topk(x, qt, kk)
        return d, pos.long()

    def search(self, queries, k: int, params: SearchParams | None = None):
        """Exact top-k: (operator distances [B,k], tids [B,k])."""
        if self.kind == "sparse":
            from ..types.sparsevec import SparseVec

            single = isinstance(queries, (SparseVec, tuple))
            q = [queries] if single else list(queries)
            B = len(q)
        else:
            single = (
                np.asarray(queries, dtype=object).ndim == 1
                if self.kind != "dense"
                else np.asarray(queries).ndim == 1
            )
            q = np.atleast_2d(
                np.asarray(queries,
                           dtype=np.float32 if self.kind == "dense" else None)
            )
            B = q.shape[0]
        n = self.num_tuples
        if n == 0:
            out_d = np.full((B, k), np.inf)
            out_i = np.full((B, k), -1, dtype=np.int64)
            return (out_d[0], out_i[0]) if single else (out_d, out_i)

        kk = min(k, n)
        d, pos = self._sweep(q, kk)
        dists = d.cpu().numpy().astype(np.float64)
        if self.metric == "l2":
            dists = np.sqrt(np.maximum(dists, 0.0))
        tid_arr = np.asarray(self._tids, dtype=np.int64)
        ids = tid_arr[pos.cpu().numpy()]
        if kk < k:
            pad_d = np.full((B, k - kk), np.inf)
            pad_i = np.full((B, k - kk), -1, dtype=np.int64)
            dists = np.concatenate([dists, pad_d], axis=1)
            ids = np.concatenate([ids, pad_i], axis=1)
        if single:
            return dists[0], ids[0]
        return dists, ids
