"""Dense batched distances of the PyTorch port: the counterpart of
``pgvector_rx_tpu/ops/distances.py``, as plain torch functions.

Metric names follow the HNSW opclass "order distance" (proc-1) semantics
(reference vector.rs:839-865):

- ``l2``      -> squared L2 (vector_l2_squared_distance)
- ``ip``      -> negative inner product (vector_negative_inner_product)
- ``cosine``  -> 1 - dot(a_hat, b_hat) on pre-normalized vectors, clamped
- ``l1``      -> L1

Ordering by these equals ordering by the user-facing operators
(<->, <#>, <=>, <+>); :func:`order_to_operator_distance` converts for
display. Hamming / Jaccard live in :mod:`.bits`.

The products are f32 with TF32 off (``torch.matmul`` with the port's
default ``allow_tf32=False``), as the JAX package's ``Precision.HIGHEST``
asks; l1 reduces its direct differences with ``torch.cdist(p=1)``.
"""

from __future__ import annotations

import torch

DENSE_METRICS = ("l2", "ip", "cosine", "l1")


def pairwise(metric: str, base, queries):
    """All-pairs order-distances: base [N, D], queries [B, D] -> [B, N]."""
    q = queries.float()
    x = base.float()
    if metric == "l1":
        return torch.cdist(q, x, p=1)
    qx = q @ x.T
    if metric == "l2":
        # ||q||^2 - 2 q.x + ||x||^2, never negative
        q2 = (q * q).sum(dim=-1, keepdim=True)
        x2 = (x * x).sum(dim=-1)[None, :]
        return torch.clamp(q2 - 2.0 * qx + x2, min=0.0)
    if metric == "ip":
        return -qx
    if metric == "cosine":
        return 1.0 - torch.clamp(qx, -1.0, 1.0)
    raise ValueError(f"unknown dense metric: {metric}")


def gathered(metric: str, vectors, ids, queries, base_norms2=None):
    """Distances from each query b [B, D] to its own candidate rows ids[b]
    [B, K] of ``vectors`` [N, D] -> [B, K] (invalid ids are clamped; the
    caller masks them). ``base_norms2`` is accepted for API stability: l2
    keeps the difference form, which avoids the matmul expansion's
    cancellation."""
    del base_norms2
    cand = vectors[ids.clamp(min=0).long()].float()  # [B, K, D]
    q = queries.float()[:, None, :]
    if metric == "l2":
        d = cand - q
        return (d * d).sum(dim=-1)
    if metric == "l1":
        return (cand - q).abs().sum(dim=-1)
    dots = (cand * q).sum(dim=-1)
    if metric == "ip":
        return -dots
    if metric == "cosine":
        return 1.0 - torch.clamp(dots, -1.0, 1.0)
    raise ValueError(f"unknown dense metric: {metric}")


def order_to_operator_distance(metric: str, d):
    """Order-distance (proc-1) -> the user-facing operator value. l2: sqrt
    (vector.rs:584-594); others are identical."""
    if metric == "l2":
        return torch.sqrt(d)
    return d


def operator_to_order_distance(metric: str, d):
    if metric == "l2":
        return d * d
    return d


def normalize_rows(x):
    """L2-normalize rows; zero rows stay zero (vector.rs:688-711)."""
    x32 = x.float()
    n = torch.sqrt((x32 * x32).sum(dim=-1, keepdim=True))
    return torch.where(n > 0.0, x32 / torch.where(n > 0.0, n, 1.0),
                       0.0).to(x.dtype)


def row_norms(x):
    x32 = x.float()
    return torch.sqrt((x32 * x32).sum(dim=-1))
