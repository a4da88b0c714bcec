"""K1 and K2 over compact (f16 / bf16) rows read as stored
(pgvector_rx_tpu_torch/ops/bruteforce.py, csrc/k1_topk.cu's 2-byte mode,
csrc/k2_binned.cu's streamed form).

The CPU parity of compact stores with the JAX package is in
tests/test_torch_serve_dtype.py; this file imports no JAX. On the CPU the
plain versions over f16 / bf16 rows equal the same calls over the cast
rows, bit for bit, and the grids of the new forms cover every row once.
Tests marked ``cuda`` hold, on the card, K1's 2-byte mode to K1 over the
f32 cast of the same rows (the old route: ids and scores but for ties)
and to the plain version, K2 over f16 rows to K2 over their bf16 cast and
to the plain version, at d = 1,024, 768, 100 and 37, over a chunk view
that starts at an odd row, with penalised rows, k = 1, 10, 60 and 64 (64
in rounds) and fewer rows than k; and they show that the engines hand
the stored chunks to the kernels, with no copy.
"""

import numpy as np
import pytest
import torch

from pgvector_rx_tpu_torch.ops import bruteforce as tbf

torch.set_num_threads(1)

COMPACT = [torch.float16, torch.bfloat16]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _rows(n, d, b, dtype, seed=0, start=3):
    """(a view of n stored rows starting at row ``start`` of a larger
    store, the l2 row term of the stored values with every 7th row
    penalised, f32 queries)."""
    rng = np.random.default_rng(seed)
    store = torch.from_numpy(
        rng.standard_normal((n + start + 2, d)).astype(np.float32)).to(dtype)
    x = store[start : start + n]
    xf = x.float()
    a = (xf * xf).sum(1)
    a[::7] += tbf._NEG_BIG
    q = torch.from_numpy(rng.standard_normal((b, d)).astype(np.float32))
    return x, a, q


# ---------------------------------------------------------------------------
# CPU: the plain versions read compact rows as their cast
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", COMPACT)
def test_plain_sweeps_over_compact_rows_equal_the_cast(dtype):
    x, a, q = _rows(600, 37, 5, dtype)
    for k in (1, 10):
        got = tbf._surrogate_topk_plain(x, a, q, k)
        want = tbf._surrogate_topk_plain(x.float(), a, q, k)
        for g, w in zip(got, want):
            assert torch.equal(g, w)
        got = tbf._binned_plain(x, a, q, k, 128)
        want = tbf._binned_plain(x.to(torch.bfloat16), a, q, k, 128)
        for g, w in zip(got, want):
            assert torch.equal(g, w)


@pytest.mark.parametrize("n,b", [(1, 1), (255, 1), (257, 129), (5000, 200),
                                 (262_144, 1024), (999_999, 7)])
@pytest.mark.parametrize("target", [1, 132])
def test_k1_two_byte_plan_covers_every_row_once(n, b, target):
    qtiles, splits, rows = tbf._k1_plan(n, b, target, tbf._K1C_QTILE,
                                        tbf._K1C_CHUNK)
    assert qtiles * tbf._K1C_QTILE >= b > (qtiles - 1) * tbf._K1C_QTILE
    assert rows % tbf._K1C_CHUNK == 0 and 1 <= splits <= 65535
    assert qtiles * splits <= max(target, qtiles)
    cover = np.zeros(n, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        assert hi > lo
        cover[lo:hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("n,tn", [(40, 128), (262_144, 1024), (5000, 256)])
def test_k2_streamed_plan_covers_every_bin_once(n, tn):
    qtiles, groups, splits, tps = tbf._k2_plan(n, 1024, tn, 132,
                                               tbf._K2S_BINS)
    assert groups * tbf._K2S_BINS == tn
    assert qtiles * groups * splits <= max(132, qtiles * groups)
    ntiles = -(-n // tn)
    cover = np.zeros(ntiles, np.int64)
    for s in range(splits):
        t0, t1 = s * tps, min(ntiles, (s + 1) * tps)
        assert t1 > t0
        cover[t0:t1] += 1
    assert (cover == 1).all()


def test_k2_form_by_row_type_and_width():
    assert tbf._k2_bins_per_block(768, torch.bfloat16) == tbf._K2_BINS
    assert tbf._k2_bins_per_block(776, torch.bfloat16) == tbf._K2S_BINS
    assert tbf._k2_bins_per_block(37, torch.float16) == tbf._K2S_BINS


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


def _tie_equal(ids_a, d_a, ids_b, d_b, tol):
    """Per query, the two results hold the same rows at the same scores
    (within ``tol``), but for rows that tie within ``tol`` with the other
    side's k-th score."""
    np.testing.assert_allclose(d_a, d_b, rtol=0, atol=tol)
    for r in range(ids_a.shape[0]):
        sa, sb = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        for i in sa - sb:
            assert abs(da[i] - d_b[r, -1]) <= tol, (r, i)
        for i in sb - sa:
            assert abs(db[i] - d_a[r, -1]) <= tol, (r, i)


def _np(t):
    return t.cpu().numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", COMPACT)
@pytest.mark.parametrize("d,k", [(1024, 10), (768, 10), (100, 10), (37, 10),
                                 (1024, 1), (100, 60), (37, 64)])
def test_k1_two_byte_mode_equals_the_cast_route(cuda, dtype, d, k):
    """K1 over the stored rows returns the f32 route's ids and scores (the
    same FP32 rescoring of the same values) but for ties, and the plain
    version's within K1's tolerance; penalised rows never surface."""
    x, a, q = _rows(5000, d, 200, dtype, seed=d + k)
    x, a, q = x.to(cuda), a.to(cuda), q.to(cuda)
    # k = 64 is past the tensor-core form's 60: the select form
    form = "k1_select" if k > tbf._K1_TC_MAX_K else "k1_topk"
    before = tbf.LAUNCHES[form]
    sd, si = tbf._surrogate_topk(x, a, q, k)
    assert tbf.LAUNCHES[form] > before
    cd, ci = tbf._surrogate_topk(x.float(), a, q, k)
    pd, pi = tbf._invalid_to_sentinel(*tbf._surrogate_topk_plain(
        x.cpu(), a.cpu(), q.cpu(), k))
    scale = float((q * q).sum(1).max())
    _tie_equal(_np(si), _np(sd), _np(ci), _np(cd), 1e-6 * scale)
    _tie_equal(_np(si), _np(sd), pi.numpy(), pd.numpy(), 1e-5 * scale)
    assert not (_np(si) % 7 == 0).any()
    assert (_np(si) >= 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", COMPACT)
def test_k1_two_byte_mode_with_fewer_rows_than_k(cuda, dtype):
    x, a, q = _rows(40, 100, 130, dtype)
    x, a, q = x.to(cuda), a.to(cuda), q.to(cuda)
    sd, si = tbf._surrogate_topk(x, a, q, 60)
    cd, ci = tbf._surrogate_topk(x.float(), a, q, 60)
    assert torch.equal(si, ci)
    assert torch.equal(sd, cd)
    live = 40 - len(range(0, 40, 7))
    assert (si[:, :live] >= 0).all() and (si[:, live:] == -1).all()


def _k2(x, a, q, k, tn):
    return tbf._binned_cuda(x, a, q.to(torch.bfloat16), k, tn)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", COMPACT)
@pytest.mark.parametrize("d,k,tn", [(1024, 10, 1024), (768, 10, 256),
                                    (100, 60, 256), (37, 64, 128)])
def test_k2_over_compact_rows(cuda, dtype, d, k, tn):
    """K2 over f16 rows equals K2 over their bf16 cast but for ties; over
    either store it equals the plain version within K2's tolerance (f32
    sums of bf16 products in another order)."""
    x, a, q = _rows(5000, d, 200, dtype, seed=d)
    x, a, q = x.to(cuda), a.to(cuda), q.to(cuda)
    before = tbf.LAUNCHES["k2_binned"]
    sd, si = _k2(x, a, q, k, tn)
    assert tbf.LAUNCHES["k2_binned"] == before + 1
    scale = float((q * q).sum(1).max())
    if dtype == torch.float16:
        cd, ci = _k2(x.to(torch.bfloat16), a, q, k, tn)
        _tie_equal(_np(si), _np(sd), _np(ci), _np(cd), 2e-5 * scale)
    pd, pi = tbf._binned_plain(x.cpu(), a.cpu(), q.cpu(), k, tn)
    _tie_equal(_np(si), _np(sd), pi.numpy(), pd.numpy(), 2e-5 * scale)
    assert not ((_np(si) % 7 == 0) & (_np(sd) < 1e38)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", COMPACT)
def test_k2_with_fewer_rows_than_k(cuda, dtype):
    x, a, q = _rows(40, 37, 130, dtype)
    x, a, q = x.to(cuda), a.to(cuda), q.to(cuda)
    sd, si = tbf._invalid_to_sentinel(*_k2(x, a, q, 60, 128))
    pd, pi = tbf._invalid_to_sentinel(*tbf._binned_plain(
        x.cpu(), a.cpu(), q.cpu(), 60, 128))
    assert torch.equal(si.cpu(), pi)
    live = 40 - len(range(0, 40, 7))
    assert (si[:, :live] >= 0).all() and (si[:, live:] == -1).all()


@pytest.mark.cuda
def test_sweeps_refuse_other_row_types(cuda):
    x = torch.randn(300, 16, device=cuda)
    a = (x * x).sum(1)
    q = torch.randn(4, 16, device=cuda)
    with pytest.raises(ValueError, match="float32, float16 or bfloat16"):
        tbf._surrogate_topk_cuda(x.double(), a, q, 5)
    with pytest.raises(ValueError, match="bfloat16 or float16"):
        tbf._binned_cuda(x, a, q.to(torch.bfloat16), 5, 128)
    with pytest.raises(ValueError, match="bfloat16"):
        tbf._binned_cuda(x.half(), a, q.half(), 5, 128)


@pytest.mark.cuda
@pytest.mark.parametrize("store", ["f16", "bf16"])
@pytest.mark.parametrize("approx", [False, True])
def test_engines_hand_the_stored_chunks_to_the_kernels(cuda, store, approx,
                                                       monkeypatch):
    """On a compact store the exact and approx engines give K1 / K2 views
    of the stored array, one per chunk: no copy of a chunk is made."""
    from pgvector_rx_tpu_torch import HnswIndex
    from pgvector_rx_tpu_torch.graph import device as tdev

    rng = np.random.default_rng(2)
    data = rng.standard_normal((3000, 40)).astype(np.float32)
    monkeypatch.setenv("PGV_SERVE_DTYPE", store)
    g = HnswIndex.build(data, metric="l2", method="native", host_graph=False,
                        seed=1, device=cuda).device_graph()
    lo = g.values.data_ptr()
    hi = lo + g.values.numel() * g.values.element_size()
    seen = []
    # K1 in whichever form the routing picks (16 queries: the select form)
    names = (("_binned_cuda",) if approx
             else ("_surrogate_topk_cuda", "_select_topk_cuda"))
    for name in names:
        def spy(base, *args, _kernel=getattr(tbf, name)):
            seen.append((base.dtype, base.data_ptr()))
            return _kernel(base, *args)

        monkeypatch.setattr(tbf, name, spy)
    monkeypatch.setattr(tdev, "_EXACT_SWEEP_CHUNK", 1024)
    q = torch.from_numpy(rng.standard_normal((16, 40)).astype(np.float32))
    d, ids = tdev._exact_search_batch(g, q.to(cuda), 10, approx=approx)
    assert len(seen) == -(-g.values.shape[0] // 1024)
    assert all(dt == g.values.dtype and lo <= p < hi for dt, p in seen)
    assert (ids >= 0).all() and torch.isfinite(d).all()
