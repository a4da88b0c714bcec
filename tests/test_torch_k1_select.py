"""K1's select form (``csrc/k1_select.cu``, wrapper
``ops/bruteforce._select_topk_cuda``): its plan on the CPU, and on the card
the kernel against its plain version (``_surrogate_topk_plain``).

Imports no JAX: the card cases run on a machine without it. The select
form's scores are the FP32 sums of K1's rescoring (one FMA a feature, in
feature order); the plain version's come from a matrix product, so the two
agree to 1e-5 of the largest |q|^2 and their id lists differ only by rows
whose scores tie at the k-th within that tolerance. On a grid of sixteenths
every sum is exact, so there the ids are equal, ties to the lower row.
"""

import numpy as np
import pytest
import torch

from pgvector_rx_tpu_torch.ops import bruteforce as tbf

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# the plan (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("b", [1, 2, 3, 17, 64, 65, 1024, 4096])
def test_select_plan_covers_every_query_once(b):
    """Chunks are consecutive and cover each query once, each within the
    key budget (a one-query chunk where a query's keys alone exceed it),
    at most 65,535 queries a chunk; the sweep's grid covers every row and
    the passes' every key, for every chunk size."""
    for n in (1, 255, 4097, 1_065_536, 40_000_000):
        for budget in (tbf._K1S_BUDGET, 1 << 20, 8):
            chunks = tbf._k1s_plan(n, b, budget)
            assert chunks[0][0] == 0 and chunks[-1][1] == b
            assert all(c1 == n1 for (_, c1), (n1, _) in
                       zip(chunks, chunks[1:]))
            for c0, c1 in chunks:
                assert 1 <= c1 - c0 <= 65535
                assert (c1 - c0) * n * 8 <= budget or c1 - c0 == 1
            for c0, c1 in chunks:
                qg, rows, per = tbf._k1s_grid(n, c1 - c0, 264)
                assert qg in (1, 4, 16) and rows % tbf._K1S_ROWS == 0
                assert per % tbf._K1S_ROWS == 0
                sweep = -(-n // rows)
                assert (sweep - 1) * rows < n <= sweep * rows <= 2**31
                assert sweep <= 65535
                passes = -(-n // per)
                assert (passes - 1) * per < n <= passes * per


@pytest.mark.parametrize("dtype,k,want", [
    (torch.float32, 1, 32), (torch.float32, 39, 32), (torch.float32, 40, 128),
    (torch.float32, 60, 128), (torch.float16, 10, 32), (torch.float16, 40, 64),
    (torch.bfloat16, 39, 32), (torch.bfloat16, 60, 64),
    (torch.float64, 10, 32)])
def test_select_crossover_by_k_and_row_width(dtype, k, want):
    """The most queries the select form takes below k = 61: the measured
    crossovers, the smaller one between measured k; rows of a dtype the
    kernels refuse route as f32 (to a wrapper that raises)."""
    assert tbf._k1s_max_b(k, dtype) == want


def test_select_routing_on_the_cpu():
    """CPU tensors always take the plain version, at any k."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((300, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    a = (x * x).sum(1)
    before = dict(tbf.LAUNCHES)
    d, i = tbf._surrogate_topk(x, a, q, 400)
    assert tbf.LAUNCHES == before
    assert d.shape == (2, 400) and (i[:, 300:] == -1).all()
    assert torch.isinf(d[:, 300:]).all()
    pd, pi = tbf._surrogate_topk_plain(x, a, q, 300)
    assert torch.equal(i[:, :300], pi) and torch.equal(d[:, :300], pd)


# ---------------------------------------------------------------------------
# the kernel against its plain version (card)
# ---------------------------------------------------------------------------


def _same_except_ties(kd, ki, pd, pi, atol):
    """Scores equal within atol rank by rank; an id in one list and not
    the other ties the k-th score within atol."""
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    fin = np.isfinite(pd)
    assert (np.isfinite(kd) == fin).all()
    np.testing.assert_allclose(kd[fin], pd[fin], rtol=1e-5, atol=atol)
    assert ((ki < 0) == ~fin).all()
    for r in range(ki.shape[0]):
        f = fin[r]
        if not f.any():
            continue
        kth = pd[r][f].max()
        for i in set(pi[r][f].tolist()) ^ set(ki[r][f].tolist()):
            row_d = np.concatenate([pd[r][pi[r] == i], kd[r][ki[r] == i]])
            assert (np.abs(row_d - kth) <= atol).all(), (r, i)


def _inputs(dev, n, d, b, dtype, seed, excluded=True):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(n, d, generator=g).to(dtype)
    q = torch.randn(b, d, generator=g)
    a = (x.float() * x.float()).sum(1)
    if excluded:
        a[::7] += tbf._NEG_BIG
    return x.to(dev), a.to(dev), q.to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k,dtype", [
    (20000, 128, 1, 10, torch.float32),
    (20000, 128, 3, 61, torch.float32),
    (20000, 128, 64, 65, torch.float32),
    (20000, 128, 1, 160, torch.float32),
    (20000, 128, 3, 640, torch.float32),
    (6000, 128, 1, 2560, torch.float32),
    (3000, 33, 2, 3000, torch.float32),
    (300, 16, 2, 500, torch.float32),
    (40000, 16, 1, 20000, torch.float32),
    (70000, 8, 17, 5, torch.float32),
    (20000, 100, 64, 100, torch.float16),
    (20000, 100, 5, 100, torch.bfloat16),
    (2001, 7, 3, 50, torch.float16),
    (1024, 1024, 2, 64, torch.bfloat16),
])
def test_select_matches_plain(cuda, n, d, b, k, dtype):
    """At the smoke's k and B, k = n, k > n (padded), k past the kernel's
    own ordering (torch.sort of its selection), 17 queries over two sweep
    groups, f16 / bf16 rows (odd widths: 2-byte loads); every seventh row
    excluded."""
    x, a, q = _inputs(cuda, n, d, b, dtype, n + k)
    before = tbf.LAUNCHES["k1_select"]
    kd, ki = tbf._invalid_to_sentinel(*tbf._select_topk_cuda(x, a, q, k))
    assert tbf.LAUNCHES["k1_select"] == before + 1
    pd, pi = tbf._invalid_to_sentinel(*tbf._surrogate_topk_plain(x, a, q, k))
    torch.cuda.synchronize()
    q2max = float((q * q).sum(1).max())
    _same_except_ties(kd, ki, pd, pi, 1e-5 * q2max)
    ki = ki.cpu().numpy()
    assert (ki[ki >= 0] % 7 != 0).all()  # excluded rows never returned
    kd = np.nan_to_num(kd.cpu().numpy(), posinf=np.finfo(np.float32).max)
    assert (np.diff(kd, axis=1) >= 0).all()  # ascending, the tail inf


@pytest.mark.cuda
@pytest.mark.parametrize("k", [10, 200, 3000])
def test_select_ties_go_to_the_lower_row(cuda, k):
    """Values on a grid of sixteenths in [-1, 1): every product and sum is
    exact in f32, so scores tie often and every order of the sums gives
    the same numbers; the kernel must return the (score, row) order of
    all the keys, ties to the lower row."""
    g = torch.Generator().manual_seed(k)
    n, d, b = 5000, 8, 3
    x = torch.randint(-16, 16, (n, d), generator=g).float() / 16
    q = torch.randint(-16, 16, (b, d), generator=g).float() / 16
    a = (x * x).sum(1)
    kd, ki = tbf._select_topk_cuda(x.to(cuda), a.to(cuda), q.to(cuda), k)
    s = a[None, :] - 2.0 * (q @ x.T)
    keys = tbf._order_keys(s, torch.arange(n)[None, :].expand(b, -1))
    rd, ri = tbf._from_order_keys(torch.sort(keys, dim=1).values[:, :k])
    assert len(torch.unique(s[0])) < n // 2  # the grid makes many ties
    assert torch.equal(kd.cpu(), rd) and torch.equal(ki.cpu().long(), ri)


@pytest.mark.cuda
def test_select_scores_equal_the_tensor_core_form(cuda):
    """The select form's scores are K1's rescored ones bit for bit."""
    x, a, q = _inputs(cuda, 30000, 96, 64, torch.float32, 5)
    sd, si = tbf._select_topk_cuda(x, a, q, 10)
    td, ti = tbf._surrogate_topk_cuda(x, a, q, 10)
    torch.cuda.synchronize()
    same = si == ti
    assert same.float().mean() > 0.99
    assert torch.equal(sd[same], td[same])


@pytest.mark.cuda
def test_select_chunks_of_queries(cuda, monkeypatch):
    """A key budget of five queries' keys: 13 queries run in three
    chunks, one launch each, with the one-chunk call's result."""
    x, a, q = _inputs(cuda, 9000, 32, 13, torch.float32, 9)
    d1, i1 = tbf._select_topk_cuda(x, a, q, 300)
    monkeypatch.setattr(tbf, "_K1S_BUDGET", 5 * 9000 * 8)
    before = tbf.LAUNCHES["k1_select"]
    d3, i3 = tbf._select_topk_cuda(x, a, q, 300)
    assert tbf.LAUNCHES["k1_select"] == before + 3
    assert torch.equal(d1, d3) and torch.equal(i1, i3)


@pytest.mark.cuda
@pytest.mark.parametrize("b,k,form", [
    (1, 10, "k1_select"),
    (tbf._k1s_max_b(10, torch.float32), 10, "k1_select"),
    (tbf._k1s_max_b(10, torch.float32) + 1, 10, "k1_topk"),
    (tbf._k1s_max_b(60, torch.float32), 60, "k1_select"),
    (tbf._k1s_max_b(60, torch.float32) + 1, 60, "k1_topk"),
    (64, 61, "k1_select"),
    (1024, 10, "k1_topk")])
def test_surrogate_topk_routes_by_b_and_k(cuda, b, k, form):
    """The select form past k = 60 at any B and at B <= _k1s_max_b(k); the
    tensor-core form at larger B and k <= 60. One launch either way."""
    x, a, q = _inputs(cuda, 5000, 16, b, torch.float32, b)
    before = dict(tbf.LAUNCHES)
    tbf._surrogate_topk(x, a, q, k)
    torch.cuda.synchronize()
    moved = {n: v - before[n] for n, v in tbf.LAUNCHES.items()
             if v != before[n]}
    assert moved == {form: 1}


@pytest.mark.parametrize("k", [300, 350, 400])
def test_plain_version_merges_its_blocks_at_any_k(monkeypatch, k):
    """The plain version sweeps in blocks of ``_PLAIN_CHUNK`` rows; at k at
    or past the row count its merge must still order the blocks' lists
    (it returned them block after block, each sorted, when k >= n)."""
    monkeypatch.setattr(tbf, "_PLAIN_CHUNK", 100)
    rng = np.random.default_rng(k)
    x = torch.from_numpy(rng.standard_normal((350, 8)).astype(np.float32))
    q = torch.from_numpy(rng.standard_normal((2, 8)).astype(np.float32))
    a = (x * x).sum(1)
    d, i = tbf._surrogate_topk_plain(x, a, q, k)
    full = a[None, :] - 2.0 * (q @ x.T)
    want, _ = torch.sort(full, dim=1)
    kk = min(k, 350)
    assert torch.equal(d[:, :kk], want[:, :kk])
    assert torch.equal(torch.gather(full, 1, i[:, :kk].long()), d[:, :kk])
    assert (i[:, kk:] == -1).all() and torch.isinf(d[:, kk:]).all()
