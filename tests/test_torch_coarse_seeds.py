"""The beam engine's coarse seed sweep (kernel K7's plain version,
``ops/bruteforce._coarse_plain``, behind ``graph/device._coarse_seeds``)
against the JAX package's ``_search_batch_coarse`` steps: its
``_exact_scores(..., approx=True)``, the traversable mask and
``lax.top_k``, at U < 16,384 upper rows (where JAX takes the exact top-k),
on the same graph in both packages (a JAX native build carried into the
port).

Cases: l2, ip and cosine on f32 stores with non-traversable upper rows;
the seed count clipped by U and by ef; one query (``_coarse_seed_one``);
an f16 store (halfvec) whose upper rows round once to bf16 in the port's
cache, as JAX's cast does at every sweep. Ids are equal but for ties at
the S-th score (float64 scores of the bf16 operands), seed distances to
rtol 1e-5 (f32 sums in another order).

The card's cases (K7 and K8 against their plain versions) are in
tests/test_torch_seed_ground_cuda.py, which imports no JAX.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.ops import bruteforce as tbf

torch.set_num_threads(1)

N, DIM, NQ, S = 3000, 32, 24, 8
RTOL = 1e-5  # f32 sums in another order in the two packages
_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
           "traversable", "emit_tid", "tid_count", "values", "x2",
           "values_bf16")


@functools.lru_cache(maxsize=None)
def _pair(metric, f16=False):
    """(JAX index, port index serving its graph, queries), 3,000 x 32-d;
    ``f16``: a halfvec store."""
    data, queries = make_dataset(N, DIM, NQ, seed=5, n_clusters=50)
    if metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    kw = dict(dtype=np.float16) if f16 else {}
    j = JaxIndex.build(data, metric=metric, method="native",
                       host_graph=False, seed=1, **kw)
    jg = j.device_graph()
    t = TorchIndex(j.dim, metric=j.metric, device="cpu",
                   params=TIndexParams(m=j.params.m,
                                       ef_construction=j.params.ef_construction))
    t.serving_only = True
    t.entry = j.entry
    t.heap_tids = list(j.heap_tids)
    t._device = tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in _FIELDS
         if getattr(jg, f) is not None},
        kind=jg.kind, metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device="cpu")
    return j, t, queries


def _dead_upper(jg, tg, seed=0):
    """Both graphs with a fifth of the upper rows not traversable."""
    ids, _, _, count = tdev.upper_row_arrays(tg)
    rng = np.random.default_rng(seed)
    trav = np.asarray(jg.traversable).copy()
    trav[ids.numpy()[rng.random(count) < 0.2]] = False
    return (dataclasses.replace(jg, traversable=jnp.asarray(trav)),
            dataclasses.replace(tg, traversable=torch.from_numpy(trav)))


def _jax_seeds(jg, q, s):
    """JAX's coarse seeding steps (``_search_batch_coarse``, U < 16,384):
    (seed ids [B, s], bf16 order scores [B, U] in float64)."""
    ids, rows, count = jdev.upper_row_arrays(jg)
    rows = rows.astype(jnp.bfloat16)
    if jg.metric == "l2":
        rf = rows.astype(jnp.float32)
        a = jnp.sum(rf * rf, axis=1)
    else:
        a = jnp.zeros((rows.shape[0],), jnp.float32)
    scores = jdev._exact_scores(jg, jnp.asarray(q), rows, a, approx=True)
    valid = (ids < jg.cap) & jg.traversable[jnp.clip(ids, 0, jg.cap)]
    scores = jnp.where(valid[None, :], scores, jnp.inf)
    neg, slots = jax.lax.top_k(-scores, s)
    seed_ids = jnp.where(jnp.isfinite(-neg), ids[slots], -1)
    return np.asarray(seed_ids), np.asarray(scores)[:, :count], count


def _f64_scores(tg, q):
    """[B, U] float64 order scores of the bf16 operands, inf on dead rows:
    the scores both packages round to f32."""
    ids, rows, _, _ = tdev.upper_row_arrays(tg)
    r = rows.float().double().numpy()
    qb = torch.from_numpy(q).to(torch.bfloat16).double().numpy()
    dots = qb @ r.T
    sc = ((r * r).sum(1)[None] - 2 * dots if tg.metric == "l2" else -dots)
    sc[:, ~tg.traversable[ids].numpy()] = np.inf
    return sc


def _same_but_ties(got, want, sc, ids):
    """Per query: the same seed ids, but where an id's float64 score ties
    (to 1e-5 of the scale) the s-th score."""
    col = {int(e): c for c, e in enumerate(ids.tolist())}
    for b in range(got.shape[0]):
        fin_w = want[b] >= 0
        assert ((got[b] >= 0) == fin_w).all(), b
        if (got[b] == want[b]).all():
            continue
        kth = sc[b, col[int(want[b][fin_w][-1])]]
        tol = 1e-5 * max(1.0, abs(kth))
        for e in set(got[b].tolist()) ^ set(want[b].tolist()):
            assert abs(sc[b, col[e]] - kth) <= tol, (b, e)


@pytest.mark.parametrize("f16", [False, True])
def test_upper_rows_are_the_jax_bf16_cast(f16):
    j, t, _ = _pair("l2", f16)
    jids, jrows, jcount = jdev.upper_row_arrays(j.device_graph())
    tg = t.device_graph()
    ids, rows, a, count = tdev.upper_row_arrays(tg)
    assert count == jcount and rows.dtype == torch.bfloat16
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids)[:count])
    want = np.asarray(jrows.astype(jnp.bfloat16).astype(jnp.float32))
    np.testing.assert_array_equal(rows.float().numpy(), want[:count])
    assert tdev.upper_row_arrays(tg)[2] is a  # cached with the rows
    np.testing.assert_allclose(a.numpy(), (want[:count] ** 2).sum(1),
                               rtol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_coarse_plain_matches_jax(metric):
    j, t, q = _pair(metric)
    jg, tg = _dead_upper(j.device_graph(), t.device_graph())
    want, _, count = _jax_seeds(jg, q, S)
    assert count < 16384
    ids, rows, a, _ = tdev.upper_row_arrays(tg)
    qt = torch.from_numpy(q)
    slots, got = tbf.coarse_topk(rows, a, ids, tg.traversable, qt, S,
                                 metric == "l2")
    assert got.dtype == slots.dtype == torch.int64
    assert torch.equal(torch.where(slots >= 0, ids[slots.clamp(min=0)], -1),
                       got)
    assert not tg.traversable[got[got >= 0]].logical_not().any()
    _same_but_ties(got.numpy(), want, _f64_scores(tg, q), ids)
    # the seeds and their exact f32 distances, as JAX's _dist_ids gives them
    s_ids, s_d = tdev._coarse_seeds(tg, qt, ids, rows, S)
    assert torch.equal(s_ids, got)
    jd = np.asarray(jax.vmap(lambda qq, ii: jdev._dist_ids(
        jg, qq, jnp.clip(ii, 0, jg.cap)))(jnp.asarray(q),
                                          jnp.asarray(s_ids.numpy())))
    fin = s_ids.numpy() >= 0
    np.testing.assert_allclose(s_d.numpy()[fin], jd[fin], rtol=RTOL,
                               atol=1e-6)
    assert np.isinf(s_d.numpy()[~fin]).all()


def test_seed_count_clipped_by_the_upper_rows():
    """Twelve upper rows and 16 seeds asked: S = min(16, U) = 12, every
    traversable row nearest first, then -1 (JAX's top_k over the same
    rows)."""
    j, t, q = _pair("l2")
    jg, tg = _dead_upper(j.device_graph(), t.device_graph(), seed=1)
    ids, rows, a, _ = tdev.upper_row_arrays(tg)
    ids, rows, a = ids[:12], rows[:12], a[:12]
    s = min(16, rows.shape[0])
    slots, got = tbf.coarse_topk(rows, a, ids, tg.traversable,
                                 torch.from_numpy(q), s, True)
    live = int(tg.traversable[ids].sum())
    assert 0 < live < s
    assert (got[:, :live] >= 0).all() and (got[:, live:] == -1).all()
    assert (slots[:, live:] == -1).all()
    rj = jnp.asarray(rows.float().numpy()).astype(jnp.bfloat16)
    rf = rj.astype(jnp.float32)
    scores = jdev._exact_scores(jg, jnp.asarray(q), rj,
                                jnp.sum(rf * rf, axis=1), approx=True)
    valid = jg.traversable[jnp.asarray(ids.numpy())]
    scores = jnp.where(valid[None, :], scores, jnp.inf)
    neg, slot_j = jax.lax.top_k(-scores, s)
    want = np.where(np.isfinite(-np.asarray(neg)), ids.numpy()[slot_j], -1)
    _same_but_ties(got.numpy(), want, _f64_scores(tg, q)[:, :12], ids)


def test_seed_count_clipped_by_ef():
    """``_search_batch_coarse`` at ef = 4 < n_seeds keeps 4 seeds, and its
    walk returns JAX's beam (same graph, same seeds)."""
    j, t, q = _pair("l2")
    jg, tg = j.device_graph(), t.device_graph()
    jids, jrows, _ = jdev.upper_row_arrays(jg)
    ids, rows, _, _ = tdev.upper_row_arrays(tg)
    ef, steps = 4, 32
    jd, ji, _ = jdev._search_batch_coarse(jg, jnp.asarray(q[:8]), jids,
                                          jrows, ef, steps, 1)
    td, ti, _ = tdev._search_batch_coarse(tg, torch.from_numpy(q[:8]), ids,
                                          rows, ef, steps, 1)
    assert ti.shape == (8, ef)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL,
                               atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_one_query(metric):
    """B = 1 (``_coarse_seed_one``, the beam scan's seeding)."""
    j, t, q = _pair(metric)
    jg, tg = _dead_upper(j.device_graph(), t.device_graph(), seed=2)
    jids, jrows, _ = jdev.upper_row_arrays(jg)
    ids, rows, _, _ = tdev.upper_row_arrays(tg)
    sc = _f64_scores(tg, q)
    for b in range(4):
        ti, td = tdev._coarse_seed_one(tg, torch.from_numpy(q[b]), ids, rows,
                                       S)
        ji, jd = jdev._coarse_seed_one(jg, jnp.asarray(q[b]), jids, jrows,
                                       n_seeds=S)
        assert ti.shape == (S,)
        _same_but_ties(ti.numpy()[None], np.asarray(ji)[None], sc[b : b + 1],
                       ids)
        same = ti.numpy() == np.asarray(ji)
        np.testing.assert_allclose(td.numpy()[same], np.asarray(jd)[same],
                                   rtol=RTOL, atol=1e-6)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_f16_store(metric):
    j, t, q = _pair(metric, f16=True)
    jg, tg = j.device_graph(), t.device_graph()
    assert tg.values.dtype == torch.float16 and tg.values_bf16 is None
    want, _, _ = _jax_seeds(jg, q, S)
    ids, rows, _, _ = tdev.upper_row_arrays(tg)
    qt = torch.from_numpy(q)
    s_ids, s_d = tdev._coarse_seeds(tg, qt, ids, rows, S)
    _same_but_ties(s_ids.numpy(), want, _f64_scores(tg, q), ids)
    jd = np.asarray(jax.vmap(lambda qq, ii: jdev._dist_ids(
        jg, qq, jnp.clip(ii, 0, jg.cap)))(jnp.asarray(q),
                                          jnp.asarray(s_ids.numpy())))
    np.testing.assert_allclose(s_d.numpy(), jd, rtol=RTOL, atol=1e-6)


def test_kernels_refuse_cpu_tensors():
    """The CUDA entries take CUDA tensors only: a CPU tensor reaches the
    plain versions through the wrappers, never the kernels."""
    j, t, q = _pair("l2")
    tg = t.device_graph()
    ids, rows, a, _ = tdev.upper_row_arrays(tg)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbf._coarse_cuda(rows, a, ids, tg.traversable, torch.from_numpy(q),
                         S, True)
