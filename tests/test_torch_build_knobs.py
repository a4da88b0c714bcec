"""The JAX package's PGV_BUILD_* knobs in the port's device build
(pgvector_rx_tpu_torch/graph/device_build.py), unit by unit, and
``consume_input``.

Each knob the port reads is held to the JAX function it changes, on the
same numpy inputs: RobustPrune's alpha in ``_select_neighbors_parallel``
(through each package's ``_candidates_to_selection``), the beam ground's
rank merge, steps, expansions and dedup in ``_beam_ground_candidates``,
the batch width in the build's and the insert's schedules; and JAX's
``ValueError``s. ``PGV_BUILD_SEED_CQ`` must change no graph (the port's
top-k is exact). ``consume_input`` ports tests/test_device_input.py's
pair on ``device="cpu"``. Whole builds under a knob are in
tests/test_torch_build_knob_graphs_*.py.

The JAX package reads most knobs when it traces, so every JAX call under a
knob runs between two ``jax.clear_caches()``; the port reads them per
build.
"""

import contextlib
import functools
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.config import IndexParams
from pgvector_rx_tpu.graph import device_build as jdb
from pgvector_rx_tpu.index.hnsw import HnswIndex as JaxIndex
from pgvector_rx_tpu_torch import HnswIndex as TorchIndex
from pgvector_rx_tpu_torch.config import IndexParams as TIndexParams
from pgvector_rx_tpu_torch.config import SearchParams as TSearchParams
from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.graph import device_build as tdb

torch.set_num_threads(1)

M, EFC = 8, 32
_GRAPH_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
                 "traversable", "emit_tid", "tid_count", "values")


@contextlib.contextmanager
def _knobs(**env):
    """``PGV_BUILD_<NAME>=value`` for each keyword, with JAX's traces
    cleared on the way in and out."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in env.items():
            mp.setenv("PGV_BUILD_" + k.upper(), str(v))
        jax.clear_caches()
        try:
            yield
        finally:
            jax.clear_caches()


def _graph(idx):
    g = idx.device_graph()
    return {f: getattr(g, f) for f in _GRAPH_FIELDS}


def _assert_same_graph(a, b):
    ga, gb = _graph(a), _graph(b)
    for f in ga:
        assert torch.equal(ga[f], gb[f]), f


# ---------------------------------------------------------------------------
# the settings: every name the JAX package reads has a class
# ---------------------------------------------------------------------------


def test_every_jax_build_knob_is_read_ignored_or_refused():
    """Each ``PGV_BUILD_*`` name in the JAX package's sources falls in one
    class: read into ``BuildSettings``, accepted as a no-op, or refused."""
    root = pathlib.Path(jdb.__file__).parents[1]
    names = set()
    for path in root.rglob("*.py"):
        names |= set(re.findall(r"PGV_BUILD_[A-Z0-9_]*[A-Z0-9]",
                                path.read_text()))
    read = {"PGV_BUILD_" + f.name.upper()
            for f in tdb.dataclasses.fields(tdb.BuildSettings)}
    noop, refused = set(tdb._BUILD_ENV_NOOP), set(tdb._BUILD_ENV_REFUSED)
    assert not (read & noop) and not (read & refused) and not (noop & refused)
    assert names == read | noop | refused


def test_settings_read_as_jax_reads_them(monkeypatch):
    assert tdb.BuildSettings.from_env({}) == tdb.BuildSettings()
    monkeypatch.setattr(tdb, "_DESCENT_MIN_WIDTH", 4096)
    s = tdb.BuildSettings.from_env({
        "PGV_BUILD_ALPHA": "1.2", "PGV_BUILD_IVF_HOP": "32",
        "PGV_BUILD_BEAM_DEDUP": "no", "PGV_BUILD_BEAM_MERGE": "rank",
        "PGV_BUILD_SEED_CQ": "", "PGV_BUILD_STREAM": "0"})
    assert (s.descent_min, s.alpha, s.ivf_hop, s.beam_dedup, s.beam_merge,
            s.seed_cq) == (4096, 1.2, 32, True, "rank", 0)
    assert not tdb.BuildSettings.from_env({"PGV_BUILD_BEAM_DEDUP": "0"}
                                          ).beam_dedup
    with pytest.raises(ValueError):
        tdb.BuildSettings.from_env({"PGV_BUILD_IVF_CAP": "many"})
    with pytest.raises(ValueError, match="BATCH"):
        tdb.BuildSettings.from_env({"PGV_BUILD_BATCH": "-1"})


def test_knob_toggles_between_builds_in_one_process():
    """The port reads its knobs per build: a knob set between two builds in
    one process changes the second graph, with no cache to clear, and
    unsetting it gives the first graph back."""
    data, _ = make_dataset(1500, 16, 1, seed=41, n_clusters=20)

    def build():
        return TorchIndex.build(data, metric="l2",
                                params=TIndexParams(m=M, ef_construction=EFC),
                                method="device", seed=2, host_graph=False,
                                device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 512)
        a = build()
        mp.setenv("PGV_BUILD_IVF_HOP", "0")
        b = build()
        mp.delenv("PGV_BUILD_IVF_HOP")
        c = build()
    assert not torch.equal(_graph(a)["neighbors0"], _graph(b)["neighbors0"])
    _assert_same_graph(a, c)


# ---------------------------------------------------------------------------
# RobustPrune's alpha
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "cosine", "ip"])
def test_alpha_selection_matches_jax(metric):
    """``PGV_BUILD_ALPHA=1.2`` (and ``_UPPER=1.3``): the same alpha in the
    order domain (squared for l2, none for ip) and the same Algorithm-4
    selection over the same candidates: ids equal, distances to rtol
    1e-5; for l2 and cosine the selection differs from alpha 1's."""
    data, queries = make_dataset(600, 24, 64, seed=43, n_clusters=12)
    if metric == "cosine":
        data /= np.linalg.norm(data, axis=1, keepdims=True)
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    levels = np.zeros(600, np.int32)
    with _knobs(alpha=1.2, alpha_upper=1.3):
        jb = jdb.DeviceBuilder(metric, data, levels, M, EFC, batch_max=64)
        tb = tdb.DeviceBuilder(metric, torch.from_numpy(data), levels, M,
                               EFC, batch_max=64)
        want = {"l2": (1.44, 1.69), "cosine": (1.2, 1.3), "ip": (1.0, 1.0)}
        np.testing.assert_allclose((tb.alpha_eff, tb.alpha_upper),
                                   want[metric], rtol=1e-12)
        assert (tb.alpha_eff, tb.alpha_upper) == (jb.alpha_eff,
                                                  jb.alpha_upper)
        q = torch.from_numpy(queries)
        d = tb._score_all(q, tb.data.vectors[:600], tb.data.x2[:600])
        cand_d, cand_i = torch.topk(d, EFC, dim=1, largest=False)
        jd, ji = jb._candidates_to_selection(
            jb.data, jnp.asarray(cand_d.numpy()),
            jnp.asarray(cand_i.numpy().astype(np.int32)))
        td, ti = tb._candidates_to_selection(tb.data, cand_d, cand_i)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5)
    _, ti1 = tb._candidates_to_selection(tb.data, cand_d, cand_i, 1.0)
    assert torch.equal(ti1, ti) == (metric == "ip")


# ---------------------------------------------------------------------------
# the beam ground's knobs and the rank merge
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _ground_case(metric):
    """A port-built graph (1,536 rows; 512-d cosine or 16-d l1) loaded into
    a JAX and a port builder, and each query's 16 nearest level >= 1 rows
    as seeds, as tests/test_torch_beam_ground.py's unit case sets them up."""
    dim = 512 if metric == "cosine" else 16
    n = 1536
    data, queries = make_dataset(n, dim, 64, seed=45, n_clusters=24)
    if metric == "cosine":
        queries /= np.linalg.norm(queries, axis=1, keepdims=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 512)
        t = TorchIndex.build(data, metric=metric,
                             params=TIndexParams(m=M, ef_construction=EFC),
                             method="device", seed=3, host_graph=False,
                             device="cpu")
    g = t.device_graph()
    rows = g.values[:n].numpy().astype(np.float32)
    levels = g.levels[:n].numpy()
    jb = jdb.DeviceBuilder(metric, rows, levels, M, EFC, batch_max=64)
    tb = tdb.DeviceBuilder(metric, torch.from_numpy(rows), levels, M, EFC,
                           batch_max=64)
    assert jb.cap == tb.cap
    nb0 = np.full((tb.cap + 1, 2 * M), -1, np.int32)
    nb0[:n] = g.neighbors0[:n].numpy()
    alive = np.zeros(tb.cap + 1, bool)
    alive[:n] = g.traversable[:n].numpy()
    tb.arrays.nb0_ids.copy_(torch.from_numpy(nb0))
    tb.arrays.alive.copy_(torch.from_numpy(alive))
    tb.arrays.entry = torch.tensor(g.entry, dtype=torch.int64)
    qr = torch.from_numpy(queries.astype(np.float32))
    ups = np.nonzero(levels >= 1)[0]
    seed_ids = ups[np.argsort(tb._dist_point_rows(
        qr, torch.from_numpy(rows[ups])[None].expand(64, -1, -1)).numpy(),
        axis=1, kind="stable")[:, :16]]
    seed_d = tb._dist_point_rows(qr, torch.from_numpy(rows[seed_ids])).numpy()
    return jb, tb, nb0, alive, g.entry, qr, seed_d, seed_ids


def _both_grounds(metric, steps, expand, dedup, merge):
    jb, tb, nb0, alive, entry, qr, seed_d, seed_ids = _ground_case(metric)
    jd, ji = jb._beam_ground_candidates(
        jb.data, jnp.asarray(nb0), jnp.asarray(alive), jnp.int32(entry),
        jnp.asarray(qr.numpy()), jnp.asarray(seed_d),
        jnp.asarray(seed_ids, np.int32), steps, expand, dedup, merge)
    td, ti = tb._beam_ground_candidates(
        tb.data, tb.arrays, qr, torch.from_numpy(seed_d),
        torch.from_numpy(seed_ids).long(), steps=steps, expand=expand,
        dedup=dedup, merge=merge)
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize("metric", ["cosine", "l1"])
@pytest.mark.parametrize("steps,expand,dedup,merge",
                         [(16, 4, True, "rank"), (20, 2, True, "sort"),
                          (16, 4, False, "sort")],
                         ids=["rank", "steps20_expand2", "no_dedup"])
def test_beam_ground_settings_match_jax(metric, steps, expand, dedup, merge):
    """``_beam_ground_candidates`` under each setting against JAX's on the
    same graph, seeds and entry: ids equal but for ties at the k-th
    distance, distances to rtol 1e-5."""
    jd, ji, td, ti = _both_grounds(metric, steps, expand, dedup, merge)
    assert ti.shape == ji.shape == (64, EFC)
    fin = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(td), fin)
    np.testing.assert_allclose(td[fin], jd[fin], rtol=1e-5, atol=1e-6)
    for r in range(64):
        f = fin[r]
        sa, sb = set(ti[r][f].tolist()), set(ji[r][f].tolist())
        kth = jd[r][f][-1]
        tol = 1e-5 * abs(kth) + 1e-6
        ta = dict(zip(ti[r][f].tolist(), td[r][f].tolist()))
        tj = dict(zip(ji[r][f].tolist(), jd[r][f].tolist()))
        assert all(abs(ta[i] - kth) <= tol for i in sa - sb), r
        assert all(abs(tj[i] - kth) <= tol for i in sb - sa), r
        assert len(set(ti[r][f].tolist())) == int(f.sum())  # no repeats


def test_jax_beam_merge_errors(monkeypatch):
    """JAX's two ``ValueError``s: an unknown merge, and the rank merge
    without the per-step dedup; the port raises them where a build would
    run the beam ground, and so does JAX's batch step past the ramp."""
    jb, tb, *_ = _ground_case("l1")
    rows = tb.data.vectors[: tb.n]
    levels = tb.data.levels[: tb.n].numpy()
    for env, match in (({"beam_merge": "heap"}, "must be 'sort' or 'rank'"),
                       ({"beam_merge": "rank", "beam_dedup": 0},
                        "incompatible")):
        with _knobs(**env):
            with pytest.raises(ValueError, match=match):
                tdb.DeviceBuilder("l1", rows, levels, M, EFC, batch_max=64)
            with pytest.raises(ValueError, match=match):
                jb._score_select_step(jb.data, jb.arrays, 600, 8, 0)
        with pytest.raises(ValueError, match=match):
            tb._beam_ground_candidates(
                tb.data, tb.arrays, rows[:2], torch.zeros(2, 1),
                torch.zeros(2, 1, dtype=torch.int64),
                merge=env["beam_merge"], dedup=bool(env.get("beam_dedup", 1)))
        # the IVF ground never reads them, in either package
        with _knobs(**env):
            assert tdb.DeviceBuilder("l2", torch.zeros(16, 8),
                                     np.zeros(16, np.int32), 4, 16,
                                     batch_max=64).ivf


# ---------------------------------------------------------------------------
# SEED_CQ and BATCH
# ---------------------------------------------------------------------------


def test_seed_cq_changes_no_graph():
    """``PGV_BUILD_SEED_CQ=64`` at a batch width of 256 chunks the merged
    upper sweep in 4 and builds the default graph row for row (the port's
    top-k is exact); a value that does not divide the width warns and
    falls back to the width, as JAX's does."""
    data, _ = make_dataset(2000, 16, 1, seed=47, n_clusters=20)

    def build(**env):
        with _knobs(batch=256, **env):
            return TorchIndex.build(
                data, metric="l2", params=TIndexParams(m=M, ef_construction=EFC),
                method="device", seed=4, host_graph=False, device="cpu")

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 512)
        _assert_same_graph(build(), build(seed_cq=64))
    with _knobs(seed_cq=100):
        with pytest.warns(UserWarning, match="SEED_CQ=100 is not a positive"):
            b = tdb.DeviceBuilder("l2", torch.zeros(300, 8),
                                  np.zeros(300, np.int32), 4, 16,
                                  batch_max=256)
    assert b.seed_cq == 256


class _Stop(Exception):
    pass


def _schedules(monkeypatch, mod, stop: bool):
    """Record each run_all's (batch width, schedule) of ``mod``'s builder;
    ``stop``: end the call there (JAX's batches need not compile)."""
    seen = []
    real = mod.DeviceBuilder.run_all

    def spy(self, schedule):
        seen.append((self.batch_max, list(schedule)))
        if stop:
            raise _Stop
        return real(self, schedule)

    monkeypatch.setattr(mod.DeviceBuilder, "run_all", spy)
    return seen


def test_batch_knob_sets_both_schedules_as_jax(monkeypatch):
    """``PGV_BUILD_BATCH=128`` gives the build's and ``insert_bulk``'s batch
    width and schedule exactly as JAX's."""
    data, _ = make_dataset(1300, 8, 1, seed=49, n_clusters=10)
    tseen = _schedules(monkeypatch, tdb, stop=False)
    jseen = _schedules(monkeypatch, jdb, stop=True)
    with _knobs(batch=128):
        t = TorchIndex.build(data[:1000], metric="l2", method="device",
                             params=TIndexParams(m=M, ef_construction=EFC),
                             seed=5, host_graph=False, device="cpu")
        with pytest.raises(_Stop):
            JaxIndex.build(data[:1000], metric="l2", method="device",
                           params=IndexParams(m=M, ef_construction=EFC),
                           seed=5, host_graph=False)
        j = JaxIndex.build(data[:1000], metric="l2", method="native",
                           params=IndexParams(m=M, ef_construction=EFC),
                           seed=5, host_graph=False)
        assert t.insert_bulk(data[1000:]) == 300
        with pytest.raises(_Stop):
            j.insert_bulk(data[1000:])
    assert tseen == jseen
    assert [w for w, _ in tseen] == [128, 128]
    assert tseen[1][1][:3] == [(1000, 64), (1064, 128), (1192, 108)]


# ---------------------------------------------------------------------------
# consume_input (tests/test_device_input.py:152-191)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("metric", ["l2", "cosine"])
def test_consume_input_frees_and_serves(tmp_path, metric):
    """``consume_input=True`` releases the caller's tensor (after prepare's
    copy for cosine, after the builder's for l2), builds the graph the
    same build without it builds, and the index serves, inserts and saves;
    its store is the builder's buffer sliced to n."""
    rng = np.random.default_rng(31)
    data = rng.standard_normal((2000, 12)).astype(np.float32)
    dev = torch.from_numpy(data).clone()
    idx = TorchIndex.build(dev, metric=metric, seed=9, host_graph=False,
                           consume_input=True, device="cpu")
    assert dev.numel() == 0 and dev.untyped_storage().nbytes() == 0
    ref = TorchIndex.build(torch.from_numpy(data), metric=metric, seed=9,
                           host_graph=False, device="cpu")
    _assert_same_graph(idx, ref)
    q = data[:16] + 0.01 * rng.standard_normal((16, 12)).astype(np.float32)
    _, gt = ref.search(q, 5, method="exact")
    _, ids = idx.search(q, 5, TSearchParams(ef_search=64), method="device")
    recall = np.mean([len(set(ids[i]) & set(gt[i])) / 5 for i in range(16)])
    assert recall >= 0.95
    want = data if metric == "l2" else (
        data / np.linalg.norm(data, axis=1, keepdims=True))
    assert idx.store.rows.shape == (2000, 12)
    np.testing.assert_allclose(idx.store.rows[7], want[7], rtol=1e-6)
    more = rng.standard_normal((100, 12)).astype(np.float32)
    assert idx.insert_bulk(torch.from_numpy(more)) == 100
    idx.save(tmp_path / "ck")
    back = TorchIndex.load(tmp_path / "ck", device="cpu")
    assert back.num_tuples == 2100
    np.testing.assert_array_equal(back.search(q, 5, method="exact")[1],
                                  idx.search(q, 5, method="exact")[1])


def test_consume_input_requires_serving_only_device():
    rng = np.random.default_rng(32)
    data = rng.standard_normal((100, 8)).astype(np.float32)
    t = torch.from_numpy(data).clone()
    with pytest.raises(ValueError, match="host_graph=False"):
        TorchIndex.build(t, metric="l2", host_graph=True, consume_input=True,
                         device="cpu")
    with pytest.raises(ValueError, match="host_graph=False"):
        TorchIndex.build(data, metric="l2", method="device", host_graph=False,
                         consume_input=True, device="cpu")
    # a tensor whose storage the build cannot release whole
    for other in (torch.from_numpy(data), t[:50]):
        with pytest.raises(ValueError, match="owns its whole storage"):
            TorchIndex.build(other, metric="l2", host_graph=False,
                             consume_input=True, device="cpu")
    assert t.numel() == 800  # nothing was released


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _card_recall(idx, ref, queries):
    """Beam recall@10 at ef=40 of ``idx`` against ``ref``'s exact top-10."""
    from pgvector_rx_tpu_torch.graph import device as tdev

    _, gt = tdev.serve_topk(ref, queries, 10, engine="exact")
    _, ids = tdev.serve_topk(idx, queries, 10, engine="beam", ef=40)
    return float(np.mean([len(set(ids[b]) & set(gt[b])) / 10
                          for b in range(len(queries))]))


@pytest.mark.cuda
@pytest.mark.parametrize("knobs", [{"ivf_hop": 32},
                                   {"ground": "beam", "beam_merge": "rank"}],
                         ids=["hop32", "rank"])
def test_card_build_under_a_knob(cuda, knobs):
    """IVF hop 32 and the beam ground's rank merge on the card (20,000 x
    32-d l2, the ramp ending at 4,096 rows): the graph's invariants, beam
    recall >= 0.95 and within 0.01 of the same build on the CPU."""
    from test_torch_device_build import _check_invariants

    data, queries = make_dataset(20000, 32, 200, seed=28)
    params = TIndexParams(m=8, ef_construction=32)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdb, "_DESCENT_MIN_WIDTH", 4096)
        with _knobs(**knobs):
            t = TorchIndex.build(torch.from_numpy(data).to(cuda), metric="l2",
                                 params=params, seed=3, host_graph=False,
                                 device=cuda)
            c = TorchIndex.build(data, metric="l2", params=params,
                                 method="device", seed=3, host_graph=False,
                                 device="cpu")
    g = t.device_graph()
    assert g.device.type == "cuda"
    _check_invariants(g, 8, 20000)
    r_card, r_cpu = _card_recall(t, c, queries), _card_recall(c, c, queries)
    assert r_card >= 0.95 and abs(r_card - r_cpu) <= 0.01, (r_card, r_cpu)


@pytest.mark.cuda
def test_card_consume_input_releases_the_corpus(cuda):
    """``consume_input`` on the card: the caller's CUDA storage goes back to
    the allocator during the build (the build's peak above what was
    allocated before it is lower by about the corpus' bytes), and the index
    serves."""
    from test_torch_device_build import _check_invariants

    data, queries = make_dataset(20000, 32, 200, seed=29)
    params = TIndexParams(m=8, ef_construction=32)
    peaks = []
    for consume in (False, True):
        x = torch.from_numpy(data).to(cuda)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(cuda)
        torch.cuda.reset_peak_memory_stats(cuda)
        idx = TorchIndex.build(x, metric="l2", params=params, seed=3,
                               host_graph=False, device=cuda,
                               consume_input=consume)
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated(cuda) - base)
        assert (x.numel() == 0) == consume
        del x
        _check_invariants(idx.device_graph(), 8, 20000)
        assert _card_recall(idx, idx, queries) >= 0.95
        del idx
    assert peaks[0] - peaks[1] >= 0.9 * data.nbytes, peaks
