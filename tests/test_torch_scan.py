"""The port's resumable scans against the JAX package's.

- The scan segment (``graph/device._beam_scan_segment``), the seeders and
  the first 200 tuples of ``DeviceBeamScan`` / ``DeviceScan`` run on the
  very same graph in both packages: the JAX index's DeviceGraph is
  carried into the port with ``DeviceGraph.from_numpy``.
- The cases of tests/test_beam_scan.py run on the port's own device build.
- Tests marked ``cuda`` hold the walk kernel (K4 serving mode, K5 scan
  mode) against its plain version on the card.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import SearchParams
from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import SearchParams as TSearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device as tdev
from pgvector_rx_tpu_torch.index.scan import (DeviceBeamScan, DeviceScan,
                                              HnswScan)
from pgvector_rx_tpu_torch.ops import beam as tbeam

from test_filter import filtered_gt
from test_index import brute_force, recall_at_k
from test_torch_engines import _carry

torch.set_num_threads(1)

N, DIM = 3000, 32
RTOL = 1e-5  # f32 sums in another order in the two packages


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pair():
    """(JAX index, port index on its graph, queries), 3,000 x 32-d."""
    data, queries = make_dataset(N, DIM, 16, seed=5, n_clusters=50)
    j = JaxIndex.build(data, metric="l2", method="native", host_graph=False,
                       seed=1)
    return j, _carry(j), queries


def _same_except_ties(ids_a, d_a, ids_b, d_b):
    """Two lists sorted by distance hold the same ids except where their
    distances tie (within RTOL): distances agree position by position, and
    an id that differs sits within the tied run of its distance."""
    fa, fb = np.isfinite(d_a), np.isfinite(d_b)
    assert (fa == fb).all()
    np.testing.assert_allclose(d_a[fa], d_b[fb], rtol=RTOL, atol=1e-6)
    for i in np.nonzero(ids_a != ids_b)[0]:
        if not fa[i]:
            continue
        tied = np.abs(d_b - d_a[i]) <= RTOL * abs(d_a[i]) + 1e-6
        tail = np.abs(d_b[fb][-1] - d_a[i]) <= RTOL * abs(d_a[i]) + 1e-6
        assert ids_a[i] in set(ids_b[tied].tolist()) or tail, (i, ids_a[i])


def _jax_graph(j, traversable=None):
    jg = j.device_graph()
    if traversable is not None:
        jg = dataclasses.replace(jg, traversable=jnp.asarray(traversable))
    return jg


def _port_graph(jg):
    fields = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
              "traversable", "emit_tid", "tid_count", "values", "x2",
              "values_bf16")
    return tdev.DeviceGraph.from_numpy(
        {f: np.asarray(getattr(jg, f)) for f in fields}, kind=jg.kind,
        metric=jg.metric, cap=jg.cap, m=jg.m, entry=jg.entry,
        entry_level=jg.entry_level, device="cpu")


# ---------------------------------------------------------------------------
# the segment and the seeders against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ef,overflow,dead", [(12, False, False),
                                              (40, False, True),
                                              (12, True, True)])
def test_scan_segment_matches_jax(pair, ef, overflow, dead):
    """Same graph, seeds and exclusion mask: the plain segment gives JAX's
    beam and spill. ``overflow``: more seeds than the internal width (the
    excess goes straight to the spill); ``dead``: 10% of rows not
    traversable."""
    j, _, queries = pair
    rng = np.random.default_rng(ef + 7 * overflow + 3 * dead)
    trav = np.asarray(j.device_graph().traversable).copy()
    if dead:
        trav[:N][rng.random(N) < 0.1] = False
    jg = _jax_graph(j, trav)
    tg = _port_graph(jg)
    width, spill = 4 * ef, max(2 * ef, 64) + 3 * ef
    excluded = np.zeros(jg.cap + 1, bool)
    excluded[rng.choice(N, 60, replace=False)] = True
    data = np.asarray(jg.values)[:N]
    for q in queries[:4]:
        d_all = ((data - q) ** 2).sum(1)
        order = np.argsort(d_all)
        S = width + 30 if overflow else spill
        n_real = S if overflow else 8
        seed_ids = np.full(S, -1, np.int32)
        seed_ids[:n_real] = order[5 : 5 + n_real]
        seed_d = np.where(seed_ids >= 0, d_all[np.maximum(seed_ids, 0)],
                          np.inf).astype(np.float32)
        jout = jdev._beam_scan_segment(
            jg, jnp.asarray(q), jnp.asarray(seed_ids), jnp.asarray(seed_d),
            jnp.asarray(excluded), ef, spill, 4 * width + 32, 1, width)
        tout = tdev._beam_scan_segment(
            tg, torch.from_numpy(q), torch.from_numpy(seed_ids),
            torch.from_numpy(seed_d), torch.from_numpy(excluded), ef, spill,
            4 * width + 32, width)
        jb_d, jb_i, js_d, js_i, jst = (np.asarray(x) for x in jout)
        tb_d, tb_i, ts_d, ts_i, tst = (x.numpy() for x in tout)
        assert int(tst) == int(jst)
        _same_except_ties(tb_i, tb_d, jb_i, jb_d)
        _same_except_ties(ts_i, ts_d, js_i, js_d)
        emitted = set(tb_i[tb_i >= 0].tolist())
        assert not emitted & set(ts_i[ts_i >= 0].tolist())
        assert not (excluded[tb_i[tb_i >= 0]]).any()
        assert trav[tb_i[tb_i >= 0]].all() and trav[ts_i[ts_i >= 0]].all()
        live = ts_i[ts_i >= 0]
        assert len(set(live.tolist())) == len(live)


def test_mark_excluded_in_place_and_pad_row():
    ex = torch.zeros(11, dtype=torch.bool)
    out = tdev._mark_excluded(ex, torch.tensor([3, -1, 7]))
    assert out is ex
    assert ex.nonzero().flatten().tolist() == [3, 7, 10]  # -1 -> pad row
    jex = jdev._mark_excluded(jnp.zeros(11, bool), jnp.asarray([3, -1, 7]))
    np.testing.assert_array_equal(np.asarray(jex), ex.numpy())


def test_k5_bitmap_rule():
    """K5 stages a query's allowed-row bitmap where its (cap + 1) bits fit
    a block beside the segment's state (the kernel's shared-memory
    arithmetic, mirrored): the smoke's 1,065,536-row graph at ef 40 (width
    160, spill 200, L 32, 128-d) fits, 1,900,000 rows do not; the words
    are whole 16-byte copies covering every row."""
    ef, w, sp = 40, 160, 200
    assert tbeam.k5_bitmap_fits(1_065_536, 128, 32, sp, w, ef, sp)
    assert not tbeam.k5_bitmap_fits(1_900_000, 128, 32, sp, w, ef, sp)
    for cap in (0, 126, 127, 128, 1_065_536):
        words = tbeam._k5_words(cap)
        assert words % 4 == 0 and words * 32 >= cap + 1 > (words - 4) * 32
    limit = max(c for c in range(1_000_000, 1_900_000, 1024)
                if tbeam.k5_bitmap_fits(c, 128, 32, sp, w, ef, sp))
    assert tbeam._k5_smem(tbeam._k5_words(limit), 128, 32, sp, w, ef, sp) \
        <= tbeam._K5_MAX_SMEM < tbeam._k5_smem(
            tbeam._k5_words(limit + 1024), 128, 32, sp, w, ef, sp)


def test_allowed_bits_and_the_plain_segment_report():
    """The staged bitmap holds traversable & ~excluded bit for bit; the
    plain K5 (``scan_segment``) reports what ``beam_scan_segment`` returns,
    and ``mark`` sets exactly the emitted ids in the mask."""
    rng = np.random.default_rng(70)
    trav = torch.from_numpy(rng.random(301) > 0.1)
    excl = torch.from_numpy(rng.random((3, 301)) < 0.2)
    bits = tbeam.allowed_bits(trav, excl)
    assert bits.shape == (3, tbeam._k5_words(300)) and bits.dtype == torch.int32
    v = np.arange(301)
    words = bits.numpy().view(np.uint32)
    got = (words[:, v >> 5] >> (v & 31)) & 1
    np.testing.assert_array_equal(got.astype(bool),
                                  (trav[None] & ~excl).numpy())
    assert not (words[:, 301 >> 5] >> (301 & 31)).any()  # none past the rows
    assert not words[:, (301 >> 5) + 1 :].any()
    n, d, ef = 500, 8, 6
    vals = torch.from_numpy(rng.random((n + 1, d)).astype(np.float32))
    nb = torch.from_numpy(rng.integers(0, n, (n + 1, 8)).astype(np.int32))
    tr = torch.ones(n + 1, dtype=torch.bool)
    tr[n] = False
    q = torch.from_numpy(rng.random((2, d)).astype(np.float32))
    seeds = torch.from_numpy(rng.choice(n, (2, 30)).astype(np.int32))
    sd = tbeam.row_dists(vals, "l2", q, seeds)
    ex = torch.zeros((2, n + 1), dtype=torch.bool)
    args = (vals, nb, tr, ex, "l2", q, seeds, sd, ef, 4 * ef, 40, 200)
    b_d, b_i, s_d, s_i, st = tbeam.beam_scan_segment(*args)
    assert not ex.any()
    report, s_d2, s_i2 = tbeam.scan_segment(*args, mark=True)
    assert torch.equal(report[:, :ef].view(torch.float32), b_d)
    assert torch.equal(report[:, ef : 2 * ef], b_i)
    assert torch.equal(report[:, 2 * ef], st) and bool((st > 0).all())
    assert torch.equal(report[:, 2 * ef + 2], (s_i >= 0).sum(1).int())
    assert torch.equal(s_d2, s_d) and torch.equal(s_i2, s_i)
    want = torch.zeros_like(ex)
    want.scatter_(1, b_i.long().clamp(min=0), True)
    assert torch.equal(ex[:, :n], want[:, :n])
    with pytest.raises(ValueError, match="CUDA only"):
        tbeam.scan_segment(*args, allowed=tbeam.allowed_bits(tr, ex))
    # the staging rule stages nothing for CPU tensors
    assert tbeam.staged_bitmap(vals, nb, tr, ex, 30, 4 * ef, ef, 200) is None


def test_seeders_match_jax(pair):
    j, t, queries = pair
    jg, tg = j.device_graph(), t.device_graph()
    jup, tup = jdev._coarse_upper(jg), tdev._coarse_upper(tg)
    assert jup is not None and tup is not None
    for q in queries[:6]:
        ji, jd = jdev._coarse_seed_one(jg, jnp.asarray(q), jup[0], jup[1],
                                       n_seeds=8)
        ti, td = tdev._coarse_seed_one(tg, torch.from_numpy(q), tup[0],
                                       tup[1], n_seeds=8)
        ji, jd, ti, td = np.asarray(ji), np.asarray(jd), ti.numpy(), td.numpy()
        order_j, order_t = np.argsort(jd, kind="stable"), np.argsort(
            td, kind="stable")
        _same_except_ties(ti[order_t], td[order_t], ji[order_j], jd[order_j])
        ji, jd = jdev._descent_seed_one(jg, jnp.asarray(q), jg.entry_level)
        ti, td = tdev._descent_seed_one(tg, torch.from_numpy(q),
                                        tg.entry_level)
        assert ti.shape == (1,) and int(ti[0]) == int(np.asarray(ji)[0])
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=RTOL)


def _stream_matches(got, want):
    """Two scan streams of (tid, distance): the same distances position by
    position, and a differing tid only as a swap inside a tie."""
    assert len(got) == len(want)
    gd = np.array([d for _, d in got])
    wd = np.array([d for _, d in want])
    np.testing.assert_allclose(gd, wd, rtol=RTOL, atol=1e-6)
    gt = [t for t, _ in got]
    wt = [t for t, _ in want]
    for i, (a, b) in enumerate(zip(gt, wt)):
        if a != b:
            near = [wt[k] for k in range(len(wt))
                    if abs(wd[k] - gd[i]) <= RTOL * abs(gd[i]) + 1e-6]
            assert a in near, (i, a, b)


@pytest.mark.parametrize("mode,env", [
    ("strict_order", {}), ("relaxed_order", {}),
    ("strict_order", {"PGV_STRICT_BUFFER": "0"}),
    ("relaxed_order", {"PGV_BEAM_SCAN_WIDTH_MULT": "2"})])
def test_beam_scan_stream_matches_jax(pair, mode, env, monkeypatch):
    """Both packages read PGV_STRICT_BUFFER (the strict reorder window; 0
    drops regressions) and PGV_BEAM_SCAN_WIDTH_MULT (the internal width)
    alike."""
    for var, val in env.items():
        monkeypatch.setenv(var, val)
    j, t, queries = pair
    for q in queries[:2]:
        js = j.scan(q, SearchParams(ef_search=20, iterative_scan=mode),
                    method="beam")
        ts = t.scan(q, TSearchParams(ef_search=20, iterative_scan=mode),
                    method="beam")
        assert isinstance(ts, DeviceBeamScan)
        _stream_matches(ts.take(200), js.take(200))
        assert ts.scan_stats.resumes == js.scan_stats.resumes


def test_prefetch_keeps_the_stream(pair):
    """A segment launched ahead by prefetch() is read before any other:
    the stream is the same as without it."""
    _, t, queries = pair
    p = TSearchParams(ef_search=16, iterative_scan="relaxed_order")
    a = t.scan(queries[3], p, method="beam")
    b = t.scan(queries[3], p, method="beam")
    out = []
    while len(out) < 100:
        b.prefetch()
        out.extend(b.take(10))
    assert out[:100] == a.take(100)


def test_device_scan_stream_matches_jax(pair):
    j, t, queries = pair
    for q in queries[:2]:
        js = j.scan(q, SearchParams(ef_search=20), method="device")
        ts = t.scan(q, TSearchParams(ef_search=20), method="device")
        assert isinstance(ts, DeviceScan)
        _stream_matches(ts.take(200), js.take(200))


# ---------------------------------------------------------------------------
# tests/test_beam_scan.py, on the port's own device build
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def corpus():
    rng = np.random.default_rng(51)
    data = rng.random((3000, 12)).astype(np.float32)
    idx = TorchIndex.build(data, metric="l2", method="device", seed=52,
                           device="cpu")
    return idx, data


class TestDeviceBeamScan:
    def test_head_matches_beam_search(self, corpus):
        idx, data = corpus
        q = data[17] + 0.003
        head = idx.scan(q, TSearchParams(ef_search=40), method="beam").take(10)
        assert head[0][0] == 17
        dists = [d for _, d in head]
        assert dists == sorted(dists)
        gt = brute_force(data, q[None], "l2", 10)
        got = np.array([[t for t, _ in head]])
        assert recall_at_k(got, gt, 10) >= 0.9

    def test_resume_digs_past_ef(self, corpus):
        idx, data = corpus
        q = data[99]
        params = TSearchParams(ef_search=16, iterative_scan="relaxed_order")
        scan = idx.scan(q, params, method="beam")
        out = scan.take(200)
        assert len(out) == 200
        assert scan.scan_stats.resumes >= 1
        tids = {t for t, _ in out}
        assert len(tids) == 200  # exactly-once emission
        gt = brute_force(data, q[None], "l2", 100)[0]
        assert len(tids & set(gt.tolist())) / 100 >= 0.95

    def test_exhausts_everything(self):
        rng = np.random.default_rng(53)
        data = rng.random((600, 8)).astype(np.float32)
        idx = TorchIndex.build(data, metric="l2", method="device", seed=54,
                               device="cpu")
        params = TSearchParams(ef_search=24, iterative_scan="relaxed_order",
                               max_scan_tuples=100_000)
        items = idx.scan(data[5], params, method="beam").take(10**6)
        tids = [t for t, _ in items]
        assert len(set(tids)) == len(tids)
        # reachability-bounded completeness (the reference tolerates
        # 3/1000 stranded elements, t/016:70)
        assert len(items) >= 0.995 * idx.num_tuples

    def test_strict_order_monotone(self, corpus):
        idx, data = corpus
        params = TSearchParams(ef_search=12, iterative_scan="strict_order")
        out = idx.scan(data[7], params, method="beam").take(60)
        d = [dd for _, dd in out]
        assert all(b >= a - 1e-12 for a, b in zip(d, d[1:]))

    def test_filtered_iterative_recall(self, corpus):
        """044 analog: selective filter + relaxed iterative scan."""
        idx, data = corpus
        rng = np.random.default_rng(55)
        queries = data[rng.integers(0, len(data), 20)] + 0.002
        mask = (np.arange(len(data)) % 10) == 0
        k = 5
        params = TSearchParams(ef_search=40, iterative_scan="relaxed_order")
        got = np.full((20, k), -1, dtype=np.int64)
        for b, q in enumerate(queries):
            scan = idx.scan(q, params, method="beam", filter_mask=mask)
            for jj, (tid, _) in enumerate(scan.take(k)):
                got[b, jj] = tid
        gt = filtered_gt(data, queries, "l2", k, mask)
        assert recall_at_k(got, gt, k) >= 0.99
        assert all(mask[t] for row in got for t in row if t >= 0)

    def test_budget_accuracy_beam(self, corpus):
        """043 analog: the tuple budget is AM-side."""
        idx, data = corpus
        mask = (np.arange(len(data)) % 500) == 0
        params = TSearchParams(ef_search=10, iterative_scan="relaxed_order",
                               max_scan_tuples=100)
        out = idx.scan(data[0], params, method="beam",
                       filter_mask=mask).take(50)
        assert len(out) <= int(mask.sum())
        assert all(mask[t] for t, _ in out)

    def test_serving_only_auto_dispatch(self, monkeypatch):
        rng = np.random.default_rng(56)
        data = rng.random((800, 8)).astype(np.float32)
        idx = TorchIndex.build(data, metric="l2", method="device",
                               host_graph=False, seed=57, device="cpu")
        assert isinstance(idx.scan(data[3], TSearchParams(ef_search=20)),
                          DeviceScan)
        monkeypatch.setattr(tdev, "EXACT_ENGINE_MAX_ROWS", 100)
        scan = idx.scan(data[3], TSearchParams(ef_search=20))
        assert isinstance(scan, DeviceBeamScan)
        assert scan.take(5)[0][0] == 3

    def test_duplicate_tid_emission(self):
        rng = np.random.default_rng(58)
        data = rng.random((300, 8)).astype(np.float32)
        data[50:56] = data[42]  # 7 identical rows inc. the original
        idx = TorchIndex.build(data, metric="l2", method="device", seed=59,
                               device="cpu")
        out = idx.scan(data[42], TSearchParams(ef_search=20),
                       method="beam").take(7)
        assert {t for t, d in out if d < 1e-6} == {42, 50, 51, 52, 53, 54, 55}


@pytest.mark.parametrize("host_graph", [True, False])
def test_device_scan_streams_every_tuple(host_graph):
    """DeviceScan counts the tuples from the device graph's TID counts:
    with duplicate rows folded into one element's TIDs, and after an
    insert, it streams every tuple once and then stops."""
    rng = np.random.default_rng(60)
    data = rng.random((400, 8)).astype(np.float32)
    data[50:56] = data[42]
    idx = TorchIndex.build(data, metric="l2", method="device", seed=61,
                           host_graph=host_graph, device="cpu")
    idx.insert_bulk(np.concatenate([data[:3], rng.random((40, 8))]).astype(
        np.float32))
    assert int(idx.device_graph().tid_count.sum()) == idx.num_tuples == 443
    params = TSearchParams(ef_search=16, max_scan_tuples=10**6)
    out = idx.scan(data[42], params, method="device").take(10**6)
    assert sorted(t for t, _ in out) == list(range(443))
    assert {t for t, d in out[:7]} == {42, 50, 51, 52, 53, 54, 55}


def test_scan_dispatch(corpus, monkeypatch):
    """host / device / beam / auto, and what DeviceScan refuses."""
    idx, data = corpus
    p = TSearchParams(ef_search=20)
    assert isinstance(idx.scan(data[0], p), HnswScan)  # host graph exists
    assert isinstance(idx.scan(data[0], p, method="host"), HnswScan)
    assert isinstance(idx.scan(data[0], p, method="device"), DeviceScan)
    assert isinstance(idx.scan(data[0], p, method="beam"), DeviceBeamScan)
    with pytest.raises(ValueError, match="filter_mask"):
        idx.scan(data[0], p, method="device", filter_mask=np.ones(3000, bool))
    # the beam variants run (tests/test_torch_beam_variants.py); an invalid
    # expansion is refused
    monkeypatch.setenv("PGV_BEAM_EXPAND", "4")
    assert isinstance(idx.scan(data[0], p, method="beam"), DeviceBeamScan)
    monkeypatch.setenv("PGV_BEAM_EXPAND", "0")
    with pytest.raises(ValueError, match="PGV_BEAM_EXPAND"):
        idx.scan(data[0], p, method="beam")


# ---------------------------------------------------------------------------
# the walk kernel against its plain version, on the card
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_scans_on_the_card_match_the_cpu(pair, cuda):
    """The same carried graph on the card: DeviceScan (K1's select form,
    one query a block) and DeviceBeamScan (K5) stream what the CPU
    versions stream."""
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    j, t, queries = pair
    tc = _carry(j, device=cuda)
    before = dict(tbf.LAUNCHES)
    for q in queries[:2]:
        for method, mode in (("device", "relaxed_order"),
                             ("beam", "strict_order"),
                             ("beam", "relaxed_order")):
            p = TSearchParams(ef_search=20, iterative_scan=mode)
            _stream_matches(tc.scan(q, p, method=method).take(200),
                            t.scan(q, p, method=method).take(200))
    assert tbf.LAUNCHES["k1_select"] > before["k1_select"]
    assert tbf.LAUNCHES["k5_beam_scan"] > before["k5_beam_scan"]


def _kernel_case(cuda, d, dtype=torch.float32, offset=False, n=2000, m=8,
                 seed=0, metric="l2", nq=24):
    """Random graph tensors on the card: values [n+1, d] (``offset``: a
    view starting one element into its allocation), neighbors0 [n+1, 2m]
    with -1 and pad (n) ids, 10% dead rows, the sentinel row n dead, and
    ``nq`` queries.

    Rows and queries lie on a grid of sixteenths (small for cosine, so
    its clamp rarely bites), exact in f16 and bf16: every distance is then
    exact in f32 in any summation order, so the kernel and the plain walk
    must agree exactly, exact ties (which the grid makes common) broken by
    id in both."""
    rng = np.random.default_rng(seed)
    lim = 2 if metric == "cosine" else 8
    x = (rng.integers(-lim, lim + 1, (n + 1, d + int(offset)))
         / 16.0).astype(np.float32)
    vals = torch.from_numpy(x).to(cuda, dtype)
    vals = vals[:, 1:] if offset else vals
    nb = rng.integers(0, n, (n + 1, 2 * m)).astype(np.int32)
    nb[rng.random(nb.shape) < 0.05] = -1
    nb[rng.random(nb.shape) < 0.02] = n
    nb[n] = -1
    trav = rng.random(n + 1) >= 0.1
    trav[n] = False
    q = (rng.integers(-lim, lim + 1, (nq, d)) / 16.0).astype(np.float32)
    return (vals, torch.from_numpy(nb).to(cuda), torch.from_numpy(trav).to(cuda),
            torch.from_numpy(q).to(cuda), rng)


def _seeds(vals, q, rng, S, n, metric="l2", live=None):
    """S distinct random seed ids per query (the last two unused, -1),
    from the rows ``live`` allows when given (serving mode admits every
    seed, as its coarse seeds are live by construction), sorted by
    (distance, id): the kernel sorts its seeds, the plain serving walk
    takes them in the given order, which at a tie could expand another
    seed first."""
    pool = np.arange(n) if live is None else np.flatnonzero(
        live.cpu().numpy()[:n])
    ids = np.stack([rng.choice(pool, S, replace=False)
                    for _ in range(q.shape[0])]).astype(np.int32)
    ids = torch.from_numpy(ids).to(q.device)
    ids[:, -2:] = -1
    d = tbeam.row_dists(vals, metric, q, ids)
    d = torch.where(ids >= 0, d, float("inf"))
    perm = tbeam.lexsort2(d, ids)
    return torch.gather(ids, 1, perm), torch.gather(d, 1, perm)


def _upper_case(rng, n, m, device, top=3):
    """Random upper layers over rows 0 .. n - 1 for the descent: a quarter
    of the rows at level >= 1 (geometric levels up to ``top``), each
    layer's m ids drawn from the rows at or above it (10% -1 pads), row 0
    the entry at level ``top``. -> (upper_slot [n + 1], upper_neighbors
    [U, top * m], entry, entry_level) on ``device``."""
    lv = np.minimum(rng.geometric(0.75, n) - 1, top)
    lv[0] = top
    up = np.flatnonzero(lv >= 1)
    slot = np.full(n + 1, -1, np.int32)
    slot[up] = np.arange(len(up))
    upper = np.full((len(up), top * m), -1, np.int32)
    for r, i in enumerate(up):
        for layer in range(1, lv[i] + 1):
            pool = np.flatnonzero(lv >= layer)
            c = rng.choice(pool, min(m, len(pool)), replace=False)
            c[rng.random(len(c)) < 0.1] = -1
            upper[r, (layer - 1) * m : (layer - 1) * m + len(c)] = c
    return (torch.from_numpy(slot).to(device),
            torch.from_numpy(upper).to(device), 0, top)


def assert_descent_walk_matches_plain(values, nb, trav, upper, m, metric, q,
                                      ef=40, max_steps=192):
    """K4 with the descent in its launch against ``descent_plain`` and the
    plain walk from where it lands: the landing ids and distances equal,
    the beams (distances, ids, steps) equal; one launch; the check must
    reject the plain walk cut to ef / 4 steps. Returns the moves."""
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    name = "k4_beam_sparse" if isinstance(values, tuple) else "k4_beam"
    before = tbf.LAUNCHES[name]
    out = tbeam.descent_walk(values, nb, trav, *upper[:2], m, *upper[2:],
                             metric, q, ef, max_steps)
    assert tbf.LAUNCHES[name] == before + 1
    qq = tbeam._queries(q, metric)
    li, ld = tbeam.descent_plain(values, trav, *upper[:2], m, metric, qq,
                                 *upper[2:])
    assert torch.equal(out[3], li) and torch.equal(out[4], ld)
    walk = (values, nb, trav, None, metric, qq, li[:, None].to(torch.int32),
            ld[:, None].float())
    plain = tbeam._serve_finish(*tbeam._walk_plain(
        *walk, width=ef, spill=0, max_steps=max_steps, scan=False))
    _assert_same(out[:3], plain)
    cut = tbeam._serve_finish(*tbeam._walk_plain(
        *walk, width=ef, spill=0, max_steps=ef // 4, scan=False))
    assert not torch.equal(out[1], cut[1])
    return int((li != upper[2]).sum())


def _assert_same(kernel, plain):
    """Every output of the two walks equal, element by element."""
    for k, p in zip(kernel, plain):
        np.testing.assert_array_equal(k.cpu().numpy(), p.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,metric", [
    (128, torch.float32, "l2"), (20, torch.float32, "l1"),
    (24, torch.float16, "cosine"), (13, torch.float32, "ip")])
def test_walk_kernel_descends_in_its_launch(cuda, d, dtype, metric):
    """Dense rows (the grid keeps every distance exact): the descent in
    K4's launch lands where the plain descent lands, and the walk from
    there equals the plain walk."""
    vals, nb, trav, q, rng = _kernel_case(cuda, d, dtype, metric=metric)
    upper = _upper_case(rng, 2000, 8, cuda)
    assert assert_descent_walk_matches_plain(vals, nb, trav, upper, 8,
                                             metric, q) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("d,dtype,offset,metric", [
    (128, torch.float32, False, "l2"), (3, torch.float32, False, "l2"),
    (13, torch.float32, True, "ip"), (16, torch.bfloat16, True, "l2"),
    (24, torch.float16, False, "cosine"), (20, torch.float32, False, "l1")])
def test_walk_kernel_serving_matches_plain(cuda, d, dtype, offset, metric):
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    vals, nb, trav, q, rng = _kernel_case(cuda, d, dtype, offset,
                                          metric=metric)
    ids, sd = _seeds(vals, q, rng, 8, 2000, metric, live=trav)
    before = tbf.LAUNCHES["k4_beam"]
    out = tbeam.beam_walk(vals, nb, trav, metric, q, ids, sd, 40, 192)
    assert tbf.LAUNCHES["k4_beam"] == before + 1
    args = (vals, nb, trav, None, metric, q, ids, sd, 40, 0, 192, False)
    k_raw = tbeam._walk_cuda(*args)
    p_raw = tbeam._walk_plain(*args)
    _assert_same(out, tbeam._serve_finish(*p_raw))
    _assert_same(k_raw, p_raw)  # raw state, steps and rows scored
    assert int(p_raw[4].min()) > 1
    ki = out[1].cpu().numpy()
    assert trav.cpu().numpy()[ki[ki >= 0]].all()


@pytest.mark.cuda
@pytest.mark.parametrize("d,offset,overflow", [(32, False, False),
                                               (7, True, True)])
def test_walk_kernel_scan_matches_plain(cuda, d, offset, overflow):
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    n, ef = 2000, 12
    width, spill = 4 * ef, 64 + 3 * ef
    vals, nb, trav, q, rng = _kernel_case(cuda, d, torch.float32, offset,
                                          n=n, seed=3)
    S = width + 20 if overflow else spill
    ids, sd = _seeds(vals, q, rng, S, n)
    excl = torch.from_numpy(rng.random((q.shape[0], n + 1)) < 0.05).to(cuda)
    before = tbf.LAUNCHES["k5_beam_scan"]
    k = tbeam.beam_scan_segment(vals, nb, trav, excl, "l2", q, ids, sd, ef,
                                width, spill, 4 * width + 32)
    assert tbf.LAUNCHES["k5_beam_scan"] == before + 1
    pr, p_d, p_i = tbeam._scan_plain(vals, nb, trav, excl, "l2", q, ids, sd,
                                     ef, width, spill, 4 * width + 32, False)
    p = (pr[:, :ef].view(torch.float32), pr[:, ef : 2 * ef], p_d, p_i,
         pr[:, 2 * ef])
    _assert_same(k, p)
    # the walk kernel serves only: a scan segment is K5's
    with pytest.raises(ValueError, match="serves only"):
        tbeam._walk_cuda(vals, nb, trav, excl, "l2", q, ids, sd, width,
                         spill, 4 * width + 32, True)
    k = [x.cpu().numpy() for x in k]
    ex = excl.cpu().numpy()
    for r in range(q.shape[0]):
        b = k[1][r][k[1][r] >= 0]
        s = k[3][r][k[3][r] >= 0]
        assert not ex[r, b].any() and not ex[r, s].any()
        assert not set(b.tolist()) & set(s.tolist())
        assert len(set(s.tolist())) == len(s)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bitmap", [(2000, True), (1_900_000, False)])
def test_k5_fed_segments_match_plain(cuda, n, bitmap):
    """K5 against its plain version (``_walk_plain`` + ``_scan_finish``)
    over 4 segments, each fed the previous one's spill and marks: the
    report (emitted distances and ids, steps, rows scored, spill count),
    the spill and the exclusion masks equal, and the staged bitmap stays
    equal to traversable & ~excluded. With the bitmap staged (2,000 rows)
    and without it (1,900,000 rows, above K5's rule)."""
    from pgvector_rx_tpu_torch.ops import bruteforce as tbf

    ef = 12
    width, spill = 4 * ef, 64 + 3 * ef
    vals, nb, trav, q, rng = _kernel_case(cuda, 16, torch.float32, False,
                                          n=n, seed=9)
    ids, sd = _seeds(vals, q, rng, spill, n, live=trav)
    assert tbeam.k5_bitmap_fits(n, 16, nb.shape[1], spill, width, ef,
                                spill) == bitmap
    ek = torch.from_numpy(rng.random((q.shape[0], n + 1)) < 0.02).to(cuda)
    ep = ek.clone()
    allowed = tbeam.allowed_bits(trav, ek) if bitmap else None
    feed_k = feed_p = (ids, sd)
    before = tbf.LAUNCHES["k5_beam_scan"]
    for seg in range(4):
        kr, kd, ki = tbeam.scan_segment(vals, nb, trav, ek, "l2", q, *feed_k,
                                        ef, width, spill, 4 * width + 32,
                                        allowed=allowed, mark=True)
        pr, pdd, pi = tbeam._scan_plain(vals, nb, trav, ep, "l2", q,
                                        *feed_p, ef, width, spill,
                                        4 * width + 32, True)
        _assert_same((kr, kd, ki, ek), (pr, pdd, pi, ep))
        assert int(pr[:, 2 * ef].min()) > 0, seg
        if bitmap:
            assert torch.equal(allowed, tbeam.allowed_bits(trav, ek))
        feed_k, feed_p = (ki, kd), (pi, pdd)
    assert tbf.LAUNCHES["k5_beam_scan"] == before + 4
