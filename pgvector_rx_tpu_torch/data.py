"""Synthetic data of the port: a copy of ``bench.make_dataset`` (the JAX
system's benchmark corpus), so the port's smoke and tests make the same
arrays without importing the JAX package's benchmark."""

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
