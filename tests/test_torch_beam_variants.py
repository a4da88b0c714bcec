"""The beam engine's variants in the port against the JAX package's:
``PGV_BEAM_EXPAND`` (E nearest unexpanded members a step),
``PGV_BEAM_VISITED_MAX`` (a per-query visited bitmap in place of the in-beam
dedup) and ``PGV_BEAM_BF16`` (bf16 ranking, the beam re-scored in f32).

- On the very same graph (the JAX index's DeviceGraph carried into the
  port), ``serve_topk``, ``_search_batch`` / ``_search_batch_coarse``
  (their steps too) and ``search`` give JAX's results for each variant, by
  coarse and by descent seeding: per-query id sets equal on >= 0.99 of the
  queries, recall@10 within 0.005, distances within rtol 1e-5 where the
  sets agree (sums run in another order in the two packages, so a near tie
  may rank differently).
- The bit kind (expand, visited: the word walk) and the sparse kind
  (visited: the sparse-row walk) give JAX's ids, ties aware.
- ``DeviceBeamScan`` (expand, bf16) streams JAX's tuples.
- The switches are read as in JAX (the bitmap from the graph's capacity,
  the JAX package's padded ``cap``); an invalid expansion is refused.
- The bf16 ranking's distances (``ops/beam.rank_dists``) are JAX's terms
  summed exactly: each term equal to JAX's, each sum within an ulp of
  JAX's f32 sum, the same f32 in any order; on rows whose differences and
  products straddle bf16 rounding boundaries they differ from terms left
  unrounded, and so does the walk.
- Tests marked ``cuda`` hold each mode of K4 (the block walk, the descent
  in its launch, the word walk, the sparse rows) and of K5 against its
  plain version on the card, each check rejecting a control (the plain
  walk at E = 1, with the in-beam dedup, ranking in f32, ranking by terms
  left unrounded).
"""

import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams as JSearchParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu.index.scan import DeviceBeamScan as JBeamScan
from pgvector_rx_tpu_torch.config import SearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.index.scan import DeviceBeamScan
from pgvector_rx_tpu_torch.ops import beam as tbeam
from pgvector_rx_tpu_torch.ops import bits as tbits

from test_torch_bit_index import _carry as _carry_bits
from test_torch_bit_index import _jax_native
from test_torch_engines import _carry
from test_torch_scan import _kernel_case, _seeds, _upper_case

torch.set_num_threads(1)

N, DIM, NQ, K, EF = 3000, 32, 128, 10, 40
#: name -> (PGV_BEAM_EXPAND, visited bitmap, bf16 ranking)
VARIANTS = {
    "expand2": (2, False, False),
    "expand4": (4, False, False),
    "visited": (1, True, False),
    "bf16": (1, False, True),
    "expand4_visited": (4, True, False),
    "expand4_bf16": (4, False, True),
}


def _set(monkeypatch, expand, visited, bf16):
    """The variant in both packages: the expansion from the environment
    (read at every call), the two import-time switches on the modules."""
    monkeypatch.setenv("PGV_BEAM_EXPAND", str(expand))
    for mod in (jdev, tdev):
        monkeypatch.setattr(mod, "_VISITED_MAX_ROWS",
                            1 << 30 if visited else 0)
        monkeypatch.setattr(mod, "_BEAM_BF16", bf16)


#: K5's widest step: E L = 8 x 32 = 256 new entries (the kernels' limit),
#: far more than a scan's spill takes, so every step overflows it
SCAN_VARIANTS = {**VARIANTS, "expand8": (8, False, False)}


@pytest.fixture
def variant(request, monkeypatch):
    """Sets the variant ``request.param``; JAX's traces read the import-time
    switches, so its caches are cleared before and after."""
    jax.clear_caches()
    _set(monkeypatch, *SCAN_VARIANTS[request.param])
    yield SCAN_VARIANTS[request.param]
    jax.clear_caches()


def _pair(metric):
    data, queries = make_dataset(N, DIM, NQ, seed=5, n_clusters=50)
    j = JaxIndex.build(data, metric=metric, method="native",
                       host_graph=False, seed=1)
    return j, _carry(j), queries


@pytest.fixture(scope="module")
def pair():
    """(JAX index, port index on its graph, queries), 3,000 x 32-d l2."""
    return _pair("l2")


@pytest.fixture(scope="module")
def pair_ip():
    return _pair("ip")


def _recall(ids, ref):
    return float(np.mean([len(set(ids[b]) & set(ref[b])) / K
                          for b in range(len(ref))]))


def _hold(ti, td, ji, jd, ref=None):
    """Per-query id sets equal on >= 0.99 of the queries, recall within
    0.005, distances within rtol 1e-5 where the sets agree."""
    same = np.array([set(ti[r].tolist()) == set(ji[r].tolist())
                     for r in range(len(ji))])
    assert same.mean() >= 0.99, same.mean()
    if ref is not None:
        assert abs(_recall(ti, ref) - _recall(ji, ref)) <= 0.005
    fin = np.isfinite(jd) & same[:, None]
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-5)


def _exact_dists(t, ids, q):
    rows = t.device_graph().values.float().numpy()[ids]
    dots = (rows * q[:, None, :]).sum(-1)
    if t.metric == "l2":
        return ((rows - q[:, None, :]) ** 2).sum(-1)
    return -dots


@pytest.mark.parametrize("seed_mode", ["coarse", "descent"])
@pytest.mark.parametrize("variant", list(VARIANTS), indirect=True)
def test_serve_topk_matches_jax(pair, variant, seed_mode, monkeypatch):
    j, t, q = pair
    if seed_mode == "descent":
        monkeypatch.setenv("PGV_BEAM_SEED", "descent")
    assert (tdev._coarse_upper(t.device_graph()) is None) == (
        seed_mode == "descent")
    ref = np.asarray(jdev.serve_topk(j, jnp.asarray(q), K, engine="exact",
                                     chunk=NQ)[1])
    jd, ji = jdev.serve_topk(j, jnp.asarray(q), K, engine="beam", chunk=NQ)
    td, ti = tdev.serve_topk(t, q, K, engine="beam", chunk=64)
    _hold(ti, td, np.asarray(ji), np.asarray(jd), ref)
    if variant[2]:  # bf16 ranking returns exact f32 distances
        np.testing.assert_allclose(td, _exact_dists(t, ti, q), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("variant", ["expand4", "bf16", "expand4_bf16"],
                         indirect=True)
def test_serve_topk_ip_matches_jax(pair_ip, variant):
    """Inner product: the bf16 ranking's other term (the product rounded
    to bf16), coarse seeded."""
    j, t, q = pair_ip
    ref = np.asarray(jdev.serve_topk(j, jnp.asarray(q), K, engine="exact",
                                     chunk=NQ)[1])
    jd, ji = jdev.serve_topk(j, jnp.asarray(q), K, engine="beam", chunk=NQ)
    td, ti = tdev.serve_topk(t, q, K, engine="beam", chunk=64)
    _hold(ti, td, np.asarray(ji), np.asarray(jd), ref)
    if variant[2]:
        np.testing.assert_allclose(td, _exact_dists(t, ti, q), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("variant", list(VARIANTS), indirect=True)
def test_walk_steps_match_jax(pair, variant):
    """Both seedings' walks (``_search_batch_coarse``, ``_search_batch``)
    give JAX's ef-wide beams and steps (on >= 0.99 of the queries; ranking
    in bf16, whose coarse sums tie often and break their ties by an ulp of
    JAX's f32 sum, the beam's top k and steps on >= 0.97); and the plain
    walk in the mode differs from the default walk from the same seeds
    (the control: the variant really ran)."""
    j, t, q = pair
    jg, tg = j.device_graph(), t.device_graph()
    steps = 4 * EF + 32
    E, _, bf16 = variant
    upper_j, upper_t = jdev._coarse_upper(jg), tdev._coarse_upper(tg)
    qt = torch.from_numpy(q)
    runs = {
        "coarse": (
            lambda: jdev._search_batch_coarse(jg, jnp.asarray(q), *upper_j,
                                              EF, steps, E),
            lambda: tdev._search_batch_coarse(tg, qt, *upper_t, EF, steps,
                                              E)),
        "descent": (
            lambda: jdev._search_batch(jg, jnp.asarray(q), EF,
                                       jg.entry_level, steps, E),
            lambda: tdev._search_batch(tg, qt, EF, tg.entry_level, steps,
                                       E)),
    }
    cut = K if bf16 else EF
    for name, (jrun, trun) in runs.items():
        jd, ji, js = (np.asarray(x) for x in jrun())
        td, ti, ts = (x.numpy() for x in trun())
        _hold(ti[:, :cut], td[:, :cut], ji[:, :cut], jd[:, :cut])
        assert np.mean(ts == js) >= (0.97 if bf16 else 0.99), name
    s_ids, s_d = tdev._coarse_seeds(tg, qt, *upper_t, 8)
    walk = (tg.values, tg.neighbors0, tg.traversable, None, tg.metric, qt,
            s_ids.to(torch.int32), s_d, EF, 0, steps, False)
    mode = tbeam._walk_plain(*walk, expand=E, **tdev._walk_modes(tg))
    base = tbeam._walk_plain(*walk)
    assert any(not torch.equal(a, b) for a, b in zip(mode, base))


@pytest.mark.parametrize("variant", list(VARIANTS), indirect=True)
def test_search_matches_jax(pair, variant):
    j, t, q = pair
    jd, ji = j.search(q[:32], K, JSearchParams(ef_search=EF),
                      method="device")
    td, ti = t.search(q[:32], K, SearchParams(ef_search=EF), method="device")
    _hold(ti, td, ji, jd)


def _tie_aware_same(ids_a, d_a, ids_b, d_b):
    """Equal distances at every rank; the ids below each row's k-th
    distance equal as sets (integer distances tie as a rule)."""
    np.testing.assert_array_equal(d_a, d_b)
    for r in range(d_a.shape[0]):
        inner = d_a[r] < d_a[r, -1]
        assert set(ids_a[r][inner]) == set(ids_b[r][inner]), r


@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
@pytest.mark.parametrize("variant", ["expand4", "visited"], indirect=True)
def test_bit_walk_matches_jax(metric, variant):
    """The bit kind's word walk: ``serve_topk`` and ``search`` give JAX's
    distances at every rank and its ids but for ties."""
    j, _, q = _jax_native(metric)
    t = _carry_bits(j)
    qw = tbits.pack_bits(q)
    jd, ji = jdev.serve_topk(j, jnp.asarray(qw), K, engine="beam", chunk=8)
    td, ti = tdev.serve_topk(t, qw, K, engine="beam")
    _tie_aware_same(ti, td, np.asarray(ji), np.asarray(jd))
    jd, jt = j.search(q, K, JSearchParams(ef_search=EF), method="device")
    td, tt = t.search(q, K, SearchParams(ef_search=EF), method="device")
    _tie_aware_same(tt, td, jt, jd)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("variant", ["visited"], indirect=True)
def test_sparse_walk_matches_jax(metric, variant, tmp_path):
    """The sparse kind walks with the visited bitmap (it takes no
    expansion, as in JAX): ``search`` gives JAX's ids but for ties."""
    from test_torch_sparse_index import (_data, _equal_but_ties, _jax_index,
                                         _jax_rows, _order, _scale)

    from pgvector_rx_tpu_torch import HnswIndex

    j = _jax_index(metric)
    j.save(tmp_path / "ck")
    t = HnswIndex.load(tmp_path / "ck", device="cpu")
    rows, queries = _data()
    jd, ji = j.search(_jax_rows(queries), K, JSearchParams(ef_search=EF),
                      method="device")
    td, ti = t.search(queries, K, SearchParams(ef_search=EF), method="device")
    _equal_but_ties(ti, _order(metric, td), ji, _order(metric, jd),
                    1e-5 * _scale(metric, rows))


@pytest.mark.parametrize("variant", ["expand4", "bf16", "expand8"],
                         indirect=True)
def test_beam_scan_matches_jax(pair, variant):
    """``DeviceBeamScan`` (K5's plain version on the CPU) streams JAX's
    first 60 tuples in both orders, ids but for near ties; its distance
    count is steps x E x L, as JAX counts it. At E = 8 (L = 32: E L = 256,
    the kernels' limit) each step's evicted tail overflows the spill (124
    wide at ef_search 20)."""
    j, t, q = pair
    for mode in ("relaxed_order", "strict_order"):
        for b in range(3):
            js = JBeamScan(j, q[b], JSearchParams(ef_search=20,
                                                  iterative_scan=mode))
            ts = DeviceBeamScan(t, q[b], SearchParams(ef_search=20,
                                                      iterative_scan=mode))
            jo, to = js.take(60), ts.take(60)
            assert len(to) == len(jo)
            jt, jdist = np.array([x[0] for x in jo]), np.array(
                [x[1] for x in jo])
            tt, tdist = np.array([x[0] for x in to]), np.array(
                [x[1] for x in to])
            np.testing.assert_allclose(tdist, jdist, rtol=1e-5, atol=1e-5)
            assert len(set(tt.tolist()) ^ set(jt.tolist())) <= 2
            assert ts.scan_stats.distances_computed == (
                ts.scan_stats.beam_steps * variant[0]
                * t.device_graph().neighbors0.shape[1])
            assert js.scan_stats.beam_steps == ts.scan_stats.beam_steps


def test_visited_bitmap_follows_the_capacity(pair, monkeypatch):
    """The bitmap applies where the graph's capacity (the JAX package's
    padded ``cap`` of a device-built graph) + 1 is at most
    ``_VISITED_MAX_ROWS``, not its row count."""
    _, t, _ = pair
    g = t.device_graph()
    fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
    grown = tdev.DeviceGraph(**{**fields, "capacity": 2 * g.cap})
    monkeypatch.setattr(tdev, "_VISITED_MAX_ROWS", g.cap + 1)
    assert tdev._walk_modes(g)["visited"]
    assert not tdev._walk_modes(grown)["visited"]
    monkeypatch.setattr(tdev, "_VISITED_MAX_ROWS", 2 * g.cap + 1)
    assert tdev._walk_modes(grown)["visited"]
    # bf16 ranking needs the f32 store's bf16 copy and a metric but l1
    monkeypatch.setattr(tdev, "_BEAM_BF16", True)
    assert tdev._walk_modes(g)["rank"] is g.values_bf16
    compact = tdev.DeviceGraph(**{**fields, "values_bf16": None})
    assert tdev._walk_modes(compact)["rank"] is None


@pytest.mark.parametrize("expand", ["0", "-1"])
def test_invalid_expansion_is_refused(pair, monkeypatch, expand):
    """E < 1 is refused by ``serve_topk``, ``search`` and ``DeviceBeamScan``
    (JAX refuses E < 0; E = 0 there walks without ever expanding); E past
    the beam's width is refused as JAX's ``lax.top_k`` refuses it."""
    _, t, q = pair
    monkeypatch.setenv("PGV_BEAM_EXPAND", expand)
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        tdev.serve_topk(t, q[:4], K, engine="beam")
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        t.search(q[:4], K, SearchParams(ef_search=EF), method="device")
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        DeviceBeamScan(t, q[0], SearchParams(ef_search=EF))
    monkeypatch.setenv("PGV_BEAM_EXPAND", "64")
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        tdev.serve_topk(t, q[:4], K, engine="beam", ef=EF)


def test_expand_limit_on_the_card_only():
    """E L <= 256 new entries a step bounds the kernels; the plain walk
    takes any E up to the width."""
    tbeam.check_expand(8, 40, 32, card=True)
    tbeam.check_expand(9, 40, 32, card=False)
    with pytest.raises(ValueError, match="256"):
        tbeam.check_expand(9, 40, 32, card=True)


def _unrounded_rank_dists(values_bf16, metric, q, ids):
    """The control of the bf16 ranking: its terms over the same bf16 rows
    and query, left unrounded (the difference or product in f32)."""
    cand = values_bf16[ids.clamp(0, values_bf16.shape[0] - 1).long()].float()
    qb = q[:, None, :].to(torch.bfloat16).float()
    if metric == "l2":
        t = (cand - qb).double()
        return (t * t).sum(dim=-1).float()
    dots = (cand * qb).double().sum(dim=-1).float()
    return -dots if metric == "ip" else 1.0 - dots.clamp(-1.0, 1.0)


def _rank_case(device, d, metric, n=4000, b=256, seed=4):
    """Random normal rows and queries (unit rows and queries for cosine),
    independent of each other, so most differences and products need more
    than bf16's 8 bits: (f32 rows [n + 1, d], their bf16 copy, neighbors0
    [n + 1, 32] random ids, live flags (the sentinel row n dead), queries
    [b, d], seeds [b, 8] and their f32 distances, rng)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n + 1, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        x /= np.linalg.norm(x, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    vals = torch.from_numpy(x).to(device)
    nb = torch.from_numpy(rng.integers(0, n, (n + 1, 32)).astype(
        np.int32)).to(device)
    trav = torch.ones(n + 1, dtype=torch.bool, device=device)
    trav[n] = False
    qt = torch.from_numpy(q).to(device)
    ids, sd = _seeds(vals, qt, rng, 8, n, metric, live=trav)
    return vals, vals.to(torch.bfloat16), nb, trav, qt, ids, sd, rng


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_rank_dists_matches_jax(metric, monkeypatch):
    """``rank_dists`` against the JAX package's ``_dist_ids_rank`` on the
    same rows, query and ids (clamped alike): every term equal to JAX's
    f32 term, every distance within one f32 ulp of JAX's f32 sum (the port
    sums the terms exactly, JAX in f32), and the same f32 with the
    coordinates permuted (an exact sum has no order)."""
    rng = np.random.default_rng(7)
    n, b, w = 300, 16, 24
    rows = rng.standard_normal((n + 1, DIM)).astype(np.float32)
    q = rng.standard_normal((b, DIM)).astype(np.float32)
    ids = rng.integers(-1, n + 2, (b, w)).astype(np.int32)
    monkeypatch.setattr(jdev, "_BEAM_BF16", True)
    vj = jnp.asarray(rows).astype(jnp.bfloat16)
    g = SimpleNamespace(kind="dense", values_bf16=vj, metric=metric, cap=n)
    jd = np.asarray(jdev._dist_ids_rank(g, jnp.asarray(q)[:, None, :],
                                        jnp.asarray(ids)))
    vt = torch.from_numpy(rows).to(torch.bfloat16)
    qt, it = torch.from_numpy(q), torch.from_numpy(ids)
    td = tbeam.rank_dists(vt, metric, qt, it).numpy()
    safe = np.clip(ids, 0, n)
    cj, qj = vj[safe], jnp.asarray(q).astype(jnp.bfloat16)[:, None, :]
    ct = vt[torch.from_numpy(safe).long()].float()
    qb = qt.to(torch.bfloat16).float()[:, None, :]
    if metric == "l2":
        jt = np.asarray((cj - qj).astype(jnp.float32)) ** 2
        tt = (ct - qb).to(torch.bfloat16).float() ** 2
    else:
        jt = np.asarray((cj * qj).astype(jnp.float32))
        tt = (ct * qb).to(torch.bfloat16).float()
    np.testing.assert_array_equal(tt.numpy(), jt)
    np.testing.assert_array_max_ulp(td, jd, maxulp=1)
    perm = torch.from_numpy(rng.permutation(DIM))
    np.testing.assert_array_equal(
        tbeam.rank_dists(vt[:, perm], metric, qt[:, perm], it).numpy(), td)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_rank_dists_rounds_each_term(metric, monkeypatch):
    """On the card tests' rows (``_rank_case``) the ranking distances
    differ from the ones whose terms skip the bf16 rounding, and so does
    the plain walk ranking by them on most queries: a kernel that stopped
    rounding its terms cannot pass the card checks."""
    vals, rank, nb, trav, q, ids, sd, _ = _rank_case("cpu", 128, metric,
                                                     b=64)
    nbrs = nb[:64].long()
    moved = (tbeam.rank_dists(rank, metric, q, nbrs)
             != _unrounded_rank_dists(rank, metric, q, nbrs))
    assert moved.float().mean() >= 0.99, moved.float().mean()
    args = (vals, nb, trav, None, metric, q, ids, sd, 40, 0, 192, False)
    p = tbeam._walk_plain(*args, rank=rank)
    monkeypatch.setattr(tbeam, "rank_dists", _unrounded_rank_dists)
    c = tbeam._walk_plain(*args, rank=rank)
    differ = (p[1] != c[1]).any(1) | (p[4] != c[4]) | (p[5] != c[5])
    assert differ.float().mean() >= 0.5, differ.float().mean()


# ---------------------------------------------------------------------------
# each mode of K4 and K5 against its plain version, on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


#: name -> (_walk_plain's mode arguments, its control's)
MODES = {
    "expand4": (dict(expand=4), dict()),
    "visited": (dict(visited=True), dict()),
    "expand4_visited": (dict(expand=4, visited=True), dict(visited=True)),
}


def _raw(out):
    return [t.cpu().numpy() for t in out]


#: the block walk's cases beyond the three modes at _kernel_case's shape:
#: name -> (mode, control, case: _kernel_case's settings, d = 64 unless
#: given, and the calls, each a slice of the queries and a stream index
#: (None: the current stream))
K4_CASES = {
    "expand2_l32": (dict(expand=2), {}, dict(m=16)),
    "expand8_l32": (dict(expand=8), {}, dict(m=16)),
    "expand8_l32_visited": (dict(expand=8, visited=True),
                            dict(visited=True), dict(m=16)),
    "expand4_f16": (dict(expand=4), {}, dict(dtype=torch.float16)),
    "visited_bf16": (dict(visited=True), {}, dict(dtype=torch.bfloat16)),
    "expand4_visited_d98": (dict(expand=4, visited=True),
                            dict(visited=True), dict(d=98)),
    "expand4_ip": (dict(expand=4), {}, dict(metric="ip")),
    "visited_cosine": (dict(visited=True), {}, dict(metric="cosine")),
    "expand4_waves": (dict(expand=4), {}, dict(nq=1100)),
    "visited_waves": (dict(visited=True), {}, dict(nq=1100)),
    "visited_past_2e20": (dict(visited=True), {}, dict(n=1_100_000, d=8)),
    "expand4_visited_past_2e20": (dict(expand=4, visited=True),
                                  dict(visited=True),
                                  dict(n=1_100_000, d=8)),
    "visited_twice": (dict(visited=True), {},
                      dict(calls=((slice(0, 12), None),
                                  (slice(12, 24), None)))),
    "expand4_visited_streams": (dict(expand=4, visited=True),
                                dict(visited=True),
                                dict(calls=((slice(0, 12), 0),
                                            (slice(12, 24), 1)))),
    "visited_wide_beam": (dict(visited=True), {}, dict(ef=1200)),
    "expand4_visited_wide_beam": (dict(expand=4, visited=True),
                                  dict(visited=True), dict(ef=1200)),
}


def _upper_for(rng, n, device):
    """``_upper_case``'s upper layers over the first min(n, 2000) rows,
    its slots padded to the n + 1 rows."""
    slot, upper, entry, level = _upper_case(rng, min(n, 2000), 8, device)
    pad = torch.full((n + 1 - slot.shape[0],), -1, dtype=slot.dtype,
                     device=device)
    return torch.cat([slot, pad]), upper, entry, level


@pytest.mark.cuda
@pytest.mark.parametrize(
    "mode,descent", [(m, d) for d in (False, True) for m in MODES]
    + [(c, d) for c in K4_CASES for d in (False, True)])
def test_k4_modes_match_plain(cuda, mode, descent):
    """Rows on the grid (every distance exact): K4 in the mode equals its
    plain version, raw state, steps and rows scored (the descent in the
    launch: its landings and the sorted outputs); the control (the plain
    walk without the mode) differs. The cases: E = 4, the bitmap and both
    (_kernel_case's graph); E = 2 and 8 at L = 32 (E L = 256, the limit);
    f16 and bf16 rows; d = 98 (scalar loads); ip and cosine; 1,100
    queries (more than one wave of blocks); the bitmap past 2^20 rows;
    two bitmap calls in a row on other queries and calls on two streams
    at once (a bitmap scratch left dirty, or shared by two calls in
    flight, would show); a beam of 1,200 (wider than the visited set in
    shared memory takes: the walk's ids go to the global bitmap from the
    start; E = 8 at L = 32 fills the set within a walk); the bitmap
    scratch is zero after every call."""
    from contextlib import nullcontext

    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    kw, ctl, case = (MODES[mode] + ({},)) if mode in MODES else K4_CASES[mode]
    case = dict(case)
    calls = case.pop("calls", ((slice(None), None),))
    ef = case.pop("ef", 40)
    metric = case.get("metric", "l2")
    vals, nb, trav, q, rng = _kernel_case(cuda, **{"d": 64, **case})
    n = vals.shape[0] - 1
    upper = _upper_for(rng, n, cuda) if descent else None
    seeds = None if descent else _seeds(vals, q, rng, 8, n, metric,
                                        live=trav)
    streams = [torch.cuda.Stream(cuda) for _ in range(2)]
    for s in streams:  # the inputs are ready before the calls start
        s.wait_stream(torch.cuda.current_stream(cuda))
    before = tbf.LAUNCHES["k4_beam"]
    outs = []
    for sl, si in calls:
        with (torch.cuda.stream(streams[si]) if si is not None
              else nullcontext()):
            if descent:
                outs.append(tbeam.descent_walk(
                    vals, nb, trav, *upper[:2], 8, *upper[2:], metric, q[sl],
                    ef, 192, **kw))
            else:
                outs.append(tbeam.beam_walk(
                    vals, nb, trav, metric, q[sl], seeds[0][sl],
                    seeds[1][sl], ef, 192, **kw))
    torch.cuda.synchronize()
    assert tbf.LAUNCHES["k4_beam"] == before + len(calls)
    for buf in tbeam._VISITED_SCRATCH.values():
        assert not bool(buf.any())
    if kw.get("visited") and len(calls) > 1 and calls[1][1] is not None:
        keys = {(s.device, s.cuda_stream) for s in streams}
        assert keys <= set(tbeam._VISITED_SCRATCH)
    for (sl, _), out in zip(calls, outs):
        if descent:
            li, ld = tbeam.descent_plain(vals, trav, *upper[:2], 8, metric,
                                         q[sl], *upper[2:])
            assert torch.equal(out[3], li) and torch.equal(out[4], ld)
            ids, sd = li[:, None].to(torch.int32), ld[:, None].float()
        else:
            ids, sd = seeds[0][sl], seeds[1][sl]
        args = (vals, nb, trav, None, metric, q[sl], ids, sd, ef, 0, 192,
                False)
        p_raw = tbeam._walk_plain(*args, **kw)
        for k, p in zip(_raw(out[:3]), _raw(tbeam._serve_finish(*p_raw))):
            np.testing.assert_array_equal(k, p)
        if not descent:
            for k, p in zip(_raw(tbeam._walk_cuda(*args, **kw)),
                            _raw(p_raw)):
                np.testing.assert_array_equal(k, p)
        c_raw = _raw(tbeam._walk_plain(*args, **ctl))
        assert any((a != b).any() for a, b in zip(_raw(p_raw), c_raw))


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("d", [128, 768, 96, 98])
@pytest.mark.parametrize("expand,descent", [(1, False), (4, False),
                                            (1, True)])
def test_k4_bf16_ranking_matches_plain(cuda, expand, descent, d, metric,
                                       monkeypatch):
    """Random rows (bf16 rounding bites in every term): K4 ranking in bf16
    at d = 128, 768 and 96 (8-byte chunks of 4 values) and 98 (scalar
    values: no multiple of 4), each metric, from seeds or with the descent
    in its launch. The ranking sums are exact, so the walk is the plain
    version's query by query: the raw beam's keys, the steps and the rows
    scored equal (the descent: the landings and the ids), the re-scored
    f32 distances within rtol 1e-5 (summed in another order). The
    controls differ: the plain walk ranking in f32, and the one whose
    terms skip the bf16 rounding."""
    vals, rank, nb, trav, q, ids, sd, rng = _rank_case(cuda, d, metric)
    args = (vals, nb, trav, None, metric, q, ids, sd, 40, 0, 192, False)
    if descent:
        upper = _upper_case(rng, vals.shape[0] - 1, 8, cuda)
        out = tbeam.descent_walk(vals, nb, trav, *upper[:2], 8, *upper[2:],
                                 metric, q, 40, 192, rank=rank)
        li, ld = tbeam.descent_plain(vals, trav, *upper[:2], 8, metric, q,
                                     *upper[2:], rank=rank)
        np.testing.assert_array_equal(out[3].cpu(), li.cpu())
        np.testing.assert_allclose(out[4].cpu(), ld.cpu(), rtol=1e-5,
                                   atol=1e-6)
        args = (*args[:6], li[:, None].to(torch.int32), ld[:, None].float(),
                *args[8:])
        p = _raw(tbeam._serve_finish(*tbeam._walk_plain(*args, rank=rank)))
        k = _raw(out[:3])
        np.testing.assert_array_equal(k[2], p[2])
        same = (k[1] == p[1]).all(1)
        assert same.mean() >= 0.99, same.mean()
        np.testing.assert_allclose(k[0][same], p[0][same], rtol=1e-5,
                                   atol=1e-5)
        p_raw = tbeam._walk_plain(*args, rank=rank)
    else:
        k = _raw(tbeam._walk_cuda(*args, expand=expand, rank=rank))
        p_raw = tbeam._walk_plain(*args, expand=expand, rank=rank)
        p = _raw(p_raw)
        for i in (1, 4, 5):  # keys, steps, rows scored
            np.testing.assert_array_equal(k[i], p[i])
        np.testing.assert_allclose(k[0], p[0], rtol=1e-5, atol=1e-5)
    p_raw = _raw(p_raw)
    c32 = _raw(tbeam._walk_plain(*args, expand=1 if descent else expand))
    monkeypatch.setattr(tbeam, "rank_dists", _unrounded_rank_dists)
    cun = _raw(tbeam._walk_plain(*args, expand=1 if descent else expand,
                                 rank=rank))
    for c in (c32, cun):
        assert any((c[i] != p_raw[i]).any() for i in (1, 4, 5))


#: the word walk's cases beyond the three modes at _word_case's shape (8
#: words a row, L = 16, 2,000 rows): name -> (mode, control, _word_case's
#: w, m and n, the beam's width ef, the calls in a row on the current
#: stream)
WORD_CASES = {
    "expand2_l32": (dict(expand=2), {}, dict(m=16)),
    "expand8_l32": (dict(expand=8), {}, dict(m=16)),
    "expand8_l32_visited": (dict(expand=8, visited=True),
                            dict(visited=True), dict(m=16)),
    "expand4_w3": (dict(expand=4), {}, dict(w=3)),
    "expand4_visited_w3": (dict(expand=4, visited=True), dict(visited=True),
                           dict(w=3)),
    "expand4_w32": (dict(expand=4), {}, dict(w=32)),
    "visited_w32": (dict(visited=True), {}, dict(w=32)),
    "visited_twice": (dict(visited=True), {}, dict(calls=2)),
    "visited_past_the_set": (dict(visited=True), {},
                             dict(m=16, ef=64, n=20_000)),
    "expand4_visited_past_the_set": (dict(expand=4, visited=True),
                                     dict(visited=True),
                                     dict(m=16, ef=64, n=20_000)),
    "expand8_l32_visited_twice": (dict(expand=8, visited=True),
                                  dict(visited=True),
                                  dict(m=16, ef=64, n=20_000, calls=2)),
    "expand4_wide_beam": (dict(expand=4), {}, dict(ef=80)),
    "visited_wide_beam": (dict(visited=True), {}, dict(ef=80)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["hamming", "jaccard"])
@pytest.mark.parametrize("mode", list(MODES) + list(WORD_CASES))
def test_k4_word_walk_modes_match_plain(cuda, metric, mode):
    """The word walk (one warp a query) in each mode equals the plain walk
    from the same landing, ties included; the control differs. The cases:
    E = 4, the bitmap and both (_word_case's graph); E = 2 and 8 at L = 32
    (E L = 256, the limit); 3 words a row (scalar loads) and 32 (the most
    the warp form takes); two calls in a row on one stream's bitmap
    scratch, each equal to the plain walk; walks over 20,000 rows at L =
    32 and a beam of 64 that see more ids than the visited set in shared
    memory holds (2,048: at E = 1 two thirds of the queries, at E = 4 and
    8 all), so the global bitmap takes the rest and each walk clears its
    words; a beam of 80 (wider than the warp form takes: the block form's
    walk). The bitmap scratch is zero after every call."""
    from test_torch_bits import _word_case

    kw, ctl, case = (MODES[mode] + ({},)) if mode in MODES \
        else WORD_CASES[mode]
    case = dict(case)
    calls, ef = case.pop("calls", 1), case.pop("ef", 40)
    words, nb, trav, q, rng = _word_case(cuda, case.pop("w", 8), **case)
    upper = _upper_case(rng, words.shape[0] - 1, 8, cuda)
    outs = []
    for _ in range(calls):
        outs.append(tbeam.descent_walk(words, nb, trav, *upper[:2], 8,
                                       *upper[2:], metric, q, ef, 192, **kw))
        torch.cuda.synchronize()
        for buf in tbeam._VISITED_SCRATCH.values():
            assert not bool(buf.any())
    li, ld = tbeam.descent_plain(words, trav, *upper[:2], 8, metric, q,
                                 *upper[2:])
    walk = (words, nb, trav, None, metric, q, li[:, None].to(torch.int32),
            ld[:, None].float(), ef, 0, 192, False)
    p = _raw(tbeam._serve_finish(*tbeam._walk_plain(*walk, **kw)))
    for out in outs:
        for a, b in zip(_raw(out[:3]), p):
            np.testing.assert_array_equal(a, b)
    c = _raw(tbeam._serve_finish(*tbeam._walk_plain(*walk, **ctl)))
    assert any((a != b).any() for a, b in zip(p, c))


@pytest.mark.cuda
def test_k4_sparse_rows_visited_match_plain(cuda):
    """The sparse-row walk with the visited bitmap (values on a grid of
    sixteenths, so both versions round alike) equals its plain version,
    the descent in the launch; the control (the in-beam dedup) differs."""
    from pgvector_rx_tpu_torch import HnswIndex
    from pgvector_rx_tpu_torch.data import make_sparse_dataset
    from pgvector_rx_tpu_torch.types import SparseVec

    rows, qs = make_sparse_dataset(2000, 3000, 64, 32, seed=9)
    rows, qs = ([SparseVec(r.dim, r.indices, np.round(r.values * 16) / 16)
                 for r in part] for part in (rows, qs))
    idx = HnswIndex.build(rows, metric="l2", seed=1, device=cuda)
    g = idx.device_graph()
    q = tbeam._queries(tdev.prepare_queries(idx, qs, cuda), "l2")
    upper = (g.upper_slot, g.upper_neighbors, g.m, g.entry, g.entry_level)
    out = tbeam.descent_walk(g.rows, g.neighbors0, g.traversable, *upper[:2],
                             *upper[2:], "l2", q, 40, 192, visited=True)
    li, ld = tbeam.descent_plain(g.rows, g.traversable, *upper[:2],
                                 upper[2], "l2", q, *upper[3:])
    walk = (g.rows, g.neighbors0, g.traversable, None, "l2", q,
            li[:, None].to(torch.int32), ld[:, None].float(), 40, 0, 192,
            False)
    p_raw = tbeam._walk_plain(*walk, visited=True)
    for a, b in zip(_raw(out[:3]), _raw(tbeam._serve_finish(*p_raw))):
        np.testing.assert_array_equal(a, b)
    c_raw = tbeam._walk_plain(*walk)
    assert not torch.equal(c_raw[5], p_raw[5])


#: K5's cases: (E, bf16 ranking, m, d, metric)
K5_CASES = [(4, False, 8, 32, "l2"), (8, False, 16, 32, "l2"),
            (2, False, 16, 32, "l2"), (40, False, 2, 32, "l2"),
            *((e, True, 8, d, mt) for e in (1, 4) for d in (32, 128, 768, 98)
              for mt in ("l2", "ip", "cosine"))]


@pytest.mark.cuda
@pytest.mark.parametrize("expand,rank,m,d,metric", K5_CASES)
def test_k5_modes_match_plain(cuda, expand, rank, m, d, metric):
    """K5 with E = 2, 4, 8 and 40 (E = 8 at L = 32: E L = 256, the limit;
    its evicted tails overflow the 100-wide spill every step; E = 40 at
    L = 4: more members a step than a warp has lanes) and with bf16
    ranking (E = 1 and 4; d = 128, 768, 32 in 8-byte chunks, 98 in scalar
    values; l2, ip, cosine) over 3 fed segments against its plain
    version: on the grid every distance is exact in f32 and in bf16, so
    the reports (steps and rows scored included), spills and marks are
    equal; the control (the plain segment at E = 1) differs where E > 1."""
    ef = 12
    width, spill = 4 * ef, 64 + 3 * ef
    vals, nb, trav, q, rng = _kernel_case(cuda, d, torch.float32, n=2000,
                                          m=m, seed=5, metric=metric)
    r = vals.to(torch.bfloat16) if rank else None
    ids, sd = _seeds(vals, q, rng, spill, 2000, metric, live=trav)
    ek = torch.zeros((q.shape[0], 2001), dtype=torch.bool, device=cuda)
    ep, ec = ek.clone(), ek.clone()
    allowed = tbeam.allowed_bits(trav, ek)
    fk = fp = fc = (ids, sd)
    differs = False
    for _ in range(3):
        kr, kd, ki = tbeam.scan_segment(vals, nb, trav, ek, metric, q, *fk,
                                        ef, width, spill, 4 * width + 32,
                                        allowed=allowed, mark=True,
                                        expand=expand, rank=r)
        pr, pdd, pi = tbeam._scan_plain(vals, nb, trav, ep, metric, q, *fp,
                                        ef, width, spill, 4 * width + 32,
                                        True, expand, r)
        cr, cd, ci = tbeam._scan_plain(vals, nb, trav, ec, metric, q, *fc,
                                       ef, width, spill, 4 * width + 32, True)
        for a, b in zip(_raw((kr, kd, ki, ek)), _raw((pr, pdd, pi, ep))):
            np.testing.assert_array_equal(a, b)
        differs |= not torch.equal(cr, pr)
        fk, fp, fc = (ki, kd), (pi, pdd), (ci, cd)
    assert differs or not expand > 1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("expand", [1, 4])
def test_k5_bf16_ranking_rounds_each_term(cuda, expand, metric, monkeypatch):
    """K5 ranking in bf16 on ``_rank_case``'s random rows (128-d), where
    the bf16 rounding of each difference or product bites: its walk is
    the plain segment's (the ranking sums are exact), so steps and rows
    scored are equal query by query and the emitted ids and distances
    (re-scored in f32, summed in another order) agree within rtol 1e-5;
    the plain segment whose terms skip the rounding differs."""
    vals, rank, nb, trav, q, _, _, rng = _rank_case(cuda, 128, metric, b=32)
    ef, width = 12, 48
    spill = 64 + width - ef
    ids, sd = _seeds(vals, q, rng, spill, vals.shape[0] - 1, metric,
                     live=trav)
    excl = torch.zeros((q.shape[0], vals.shape[0]), dtype=torch.bool,
                       device=cuda)
    seg = (ids, sd, ef, width, spill, 4 * width + 32)
    kr = tbeam.scan_segment(vals, nb, trav, excl, metric, q, *seg,
                            allowed=tbeam.allowed_bits(trav, excl),
                            expand=expand, rank=rank)[0].cpu().numpy()
    plain = (vals, nb, trav, excl, metric, q, *seg, False, expand, rank)
    pr = tbeam._scan_plain(*plain)[0].cpu().numpy()
    np.testing.assert_array_equal(kr[:, 2 * ef:2 * ef + 2],
                                  pr[:, 2 * ef:2 * ef + 2])
    same = (kr[:, ef:2 * ef] == pr[:, ef:2 * ef]).all(1)
    assert same.mean() >= 0.9, same.mean()
    np.testing.assert_allclose(kr[same, :ef].view(np.float32),
                               pr[same, :ef].view(np.float32), rtol=1e-5,
                               atol=1e-5)
    monkeypatch.setattr(tbeam, "rank_dists", _unrounded_rank_dists)
    cr = tbeam._scan_plain(*plain)[0].cpu().numpy()
    assert (cr[:, 2 * ef:2 * ef + 2] != pr[:, 2 * ef:2 * ef + 2]).any()
