"""Synthetic data of the port: copies of ``bench.make_dataset`` (the JAX
system's benchmark corpus) and of ``bench_suite.run_sparse``'s sparse
generator, so the port's smoke and tests make the same data without
importing the JAX package's benchmarks."""

from __future__ import annotations

import numpy as np


def make_dataset(n, d, n_q, seed=0, n_clusters=1000, intrinsic=16):
    """SIFT-like synthetic corpus + queries -> (data [n, d] f32,
    queries [n_q, d] f32).

    Low intrinsic dimensionality (points near a random ``intrinsic``-dim
    linear manifold, like SIFT's ~12-16) and overlapping cluster
    structure (latent centers at ~1.4x the cluster radius). Queries are
    latent-space perturbations of database points.
    """
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((intrinsic, d)).astype(np.float32)
    proj /= np.sqrt(intrinsic)
    centers_z = rng.standard_normal((n_clusters, intrinsic)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    z = centers_z[assign] + rng.standard_normal((n, intrinsic)).astype(
        np.float32
    )
    data = z @ proj
    data += 0.05 * rng.standard_normal((n, d)).astype(np.float32)

    qrng = np.random.default_rng(seed + 99)
    qsel = qrng.integers(0, n, size=n_q)
    qz = z[qsel] + 0.3 * qrng.standard_normal((n_q, intrinsic)).astype(
        np.float32
    )
    queries = qz @ proj + 0.05 * qrng.standard_normal((n_q, d)).astype(
        np.float32
    )
    return data.astype(np.float32), queries.astype(np.float32)


def make_sparse_dataset(n, dim, n_q, nnz, seed=9):
    """BM25/SPLADE-like sparse rows -> (rows [n] SparseVec, queries: the
    first ``n_q`` rows).

    ``bench_suite.run_sparse``'s generator: ``nnz`` draws per row from a
    power-law index popularity (exponent 0.7), kept unique and sorted;
    values U[0.1, 1.1) in f32."""
    from .types import SparseVec

    rng = np.random.default_rng(seed)
    pop = (1.0 / np.arange(1, dim + 1)) ** 0.7
    pop /= pop.sum()
    rows = []
    for _ in range(n):
        ii = np.unique(rng.choice(dim, size=nnz, p=pop)).astype(np.int32)
        rows.append(
            SparseVec(dim, ii, rng.random(len(ii)).astype(np.float32) + 0.1)
        )
    return rows, rows[:n_q]
