"""The port's brute-force sweeps (pgvector_rx_tpu_torch/ops/bruteforce.py)
against the JAX package's Pallas kernels (interpret mode on the CPU).

CPU tests hold the plain-torch versions against JAX; tests marked
``cuda`` hold the CUDA kernels against the plain versions on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.ops import pallas_bruteforce as jbf
from pgvector_rx_tpu_torch.ops import bruteforce as tbf

torch.set_num_threads(1)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _same_sets_except_ties(ids_a, d_a, ids_b, d_b, atol):
    """Per row, ids in one set and not the other must tie (within atol)
    with the k-th distance."""
    for r in range(ids_a.shape[0]):
        sa, sb = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        for i in sa - sb:
            assert abs(da[i] - d_b[r, -1]) <= atol, (r, i)
        for i in sb - sa:
            assert abs(db[i] - d_a[r, -1]) <= atol, (r, i)


def _data(rng, n, d, b, metric):
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    return base, q


# ---------------------------------------------------------------------------
# K1 plain vs the Pallas _topk_kernel
# ---------------------------------------------------------------------------

_TOPK = {
    "l2": (jbf.l2_topk, tbf.l2_topk),
    "ip": (jbf.ip_topk, tbf.ip_topk),
    "cosine": (jbf.cosine_topk, tbf.cosine_topk),
}


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n,d,b,k", [(600, 16, 12, 5), (257, 24, 3, 10)])
def test_exact_topk_matches_jax(rng, metric, n, d, b, k):
    base, q = _data(rng, n, d, b, metric)
    jfn, tfn = _TOPK[metric]
    jd, ji = jfn(jnp.asarray(base), jnp.asarray(q), k, tb=8, tn=128,
                 interpret=True)
    td, ti = tfn(torch.from_numpy(base), torch.from_numpy(q), k)
    jd, ji = np.asarray(jd), np.asarray(ji)
    td, ti = td.numpy(), ti.numpy()
    assert ti.dtype == np.int32 and ((ti >= 0) & (ti < n)).all()
    _same_sets_except_ties(ti, td, ji, jd, atol=1e-4)
    np.testing.assert_allclose(td, jd, atol=1e-4)
    assert (np.diff(td, axis=1) >= 0).all()


def test_exact_topk_fewer_rows_than_k(rng):
    base, q = _data(rng, 3, 8, 2, "l2")
    d, i = tbf.l2_topk(torch.from_numpy(base), torch.from_numpy(q), 5)
    assert (i[:, :3] >= 0).all() and (i[:, 3:] == -1).all()
    assert torch.isinf(d[:, 3:]).all()


def test_surrogate_penalty_rows_never_returned(rng):
    base, q = _data(rng, 200, 16, 4, "l2")
    live = rng.random(200) < 0.5
    a = (base ** 2).sum(1) + np.where(live, 0.0, tbf._NEG_BIG)
    sd, si = tbf._surrogate_topk(torch.from_numpy(base),
                                 torch.from_numpy(a.astype(np.float32)),
                                 torch.from_numpy(q), 8)
    si = si.numpy()
    assert (si >= 0).all() and live[si].all()
    # all-dead corpus: every slot comes back empty
    dead = np.full(200, tbf._NEG_BIG, np.float32)
    sd, si = tbf._surrogate_topk(torch.from_numpy(base),
                                 torch.from_numpy(dead),
                                 torch.from_numpy(q), 8)
    assert (si == -1).all() and torch.isinf(sd).all()


# ---------------------------------------------------------------------------
# K2 plain vs the Pallas _binned_kernel
# ---------------------------------------------------------------------------


def _binned_both(base, a, q, k, metric, tn):
    jd, ji = jbf.binned_sweep_topk(
        jnp.asarray(base), jnp.asarray(a), jnp.asarray(q), k, metric,
        tb=16, tn=tn, interpret=True,
    )
    td, ti = tbf.binned_sweep_topk(
        torch.from_numpy(base).to(torch.bfloat16), torch.from_numpy(a),
        torch.from_numpy(q), k, metric, tn=tn,
    )
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("n,tn", [(200, 256), (1000, 256)])
def test_binned_matches_jax(rng, metric, n, tn):
    """Single tile (every row its own bin: exact selection) and multi-tile
    (bin collisions): the same binned algorithm must pick the same ids."""
    base, q = _data(rng, n, 24, 6, metric)
    a = ((base ** 2).sum(1) if metric == "l2"
         else np.zeros(n)).astype(np.float32)
    jd, ji, td, ti = _binned_both(base, a, q, 5, metric, tn)
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=2e-2, atol=1e-5)
    assert (np.diff(td, axis=1) >= -1e-6).all()


def test_binned_mask_excludes_rows(rng):
    base, q = _data(rng, 200, 16, 4, "l2")
    live = rng.random(200) < 0.5
    a = ((base ** 2).sum(1) + np.where(live, 0.0, tbf._NEG_BIG)).astype(
        np.float32)
    jd, ji, td, ti = _binned_both(base, a, q, 5, "l2", 256)
    assert (ti >= 0).all() and live[ti].all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td, jd, rtol=2e-2)


def test_binned_k_exceeding_live_rows_pads_invalid(rng):
    base, q = _data(rng, 50, 8, 2, "l2")
    a = (base ** 2).sum(1).astype(np.float32)
    a[3:] = tbf._NEG_BIG  # only 3 live rows
    jd, ji, td, ti = _binned_both(base, a, q, 5, "l2", 256)
    assert ((ti[:, 3:] == -1) & np.isinf(td[:, 3:])).all()
    assert (ti[:, :3] >= 0).all() and (ti[:, :3] < 3).all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td[:, :3], jd[:, :3], rtol=2e-2)


def test_binned_plain_is_binned_not_exact(rng):
    """Two rows in one bin keep only the nearer: the plain version is the
    binned algorithm itself, not an exact top-k."""
    base = np.zeros((256, 4), np.float32)
    base[:, 0] = np.arange(256, dtype=np.float32) + 10.0
    base[0, 0], base[128, 0] = 0.0, 0.5  # rows 0 and 128 share bin 0
    q = np.zeros((1, 4), np.float32)
    a = (base ** 2).sum(1).astype(np.float32)
    d, i = tbf.binned_sweep_topk(torch.from_numpy(base).to(torch.bfloat16),
                                 torch.from_numpy(a), torch.from_numpy(q), 2,
                                 "l2", tn=128)
    assert i[0, 0] == 0 and i[0, 1] != 128


# ---------------------------------------------------------------------------
# Dispatch: plain only for CPU tensors, kernels or errors otherwise
# ---------------------------------------------------------------------------


def test_cpu_tensors_take_plain_path(rng):
    base, q = _data(rng, 300, 16, 4, "l2")
    before = dict(tbf.LAUNCHES)
    tbf.l2_topk(torch.from_numpy(base), torch.from_numpy(q), 5)
    tbf.binned_sweep_topk(torch.from_numpy(base).to(torch.bfloat16),
                          torch.from_numpy((base ** 2).sum(1)),
                          torch.from_numpy(q), 5, "l2", tn=128)
    assert tbf.LAUNCHES == before


def test_kernel_entry_refuses_cpu_tensors(rng):
    """The CUDA entry points never run a CPU tensor (no silent fallback)."""
    base, q = _data(rng, 64, 8, 2, "l2")
    x = torch.from_numpy(base)
    a = (x * x).sum(1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbf._surrogate_topk_cuda(x, a, torch.from_numpy(q), 4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbf._binned_cuda(x.to(torch.bfloat16), a,
                         torch.from_numpy(q).to(torch.bfloat16), 4, 128)


# ---------------------------------------------------------------------------
# On the card: kernels against their plain versions
# ---------------------------------------------------------------------------


# ---------------------------------------------------------------------------
# K1 / K2 grid planners and K1's tf32 split (CPU)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,b", [(1, 1), (63, 1), (64, 130), (65, 64),
                                 (5000, 1025), (1_000_000, 1024),
                                 (999_999, 7)])
@pytest.mark.parametrize("target", [1, 264, 1056])
def test_k1_plan_covers_every_row_once(n, b, target):
    qtiles, splits, rows = tbf._k1_plan(n, b, target)
    assert qtiles * tbf._K1_QTILE >= b > (qtiles - 1) * tbf._K1_QTILE
    assert rows % 64 == 0 and 1 <= splits <= 65535
    assert qtiles * splits <= max(target, qtiles)
    cover = np.zeros(n, np.int64)
    for s in range(splits):
        lo, hi = s * rows, min(n, (s + 1) * rows)
        assert hi > lo  # no empty split
        cover[lo:hi] += 1
    assert (cover == 1).all()


@pytest.mark.parametrize("n,b,tn", [(1, 1, 128), (40, 1, 1024),
                                    (1000, 130, 256), (30000, 1024, 1024),
                                    (1_000_000, 1024, 1024),
                                    (1_000_001, 3, 128)])
@pytest.mark.parametrize("target", [1, 264, 1056])
def test_k2_plan_covers_every_row_once(n, b, tn, target):
    qtiles, groups, splits, tps = tbf._k2_plan(n, b, tn, target)
    assert qtiles * tbf._K2_QTILE >= b > (qtiles - 1) * tbf._K2_QTILE
    assert groups * tbf._K2_BINS == tn and 1 <= splits <= 65535
    assert qtiles * groups * splits <= max(target, qtiles * groups)
    ntiles = -(-n // tn)
    cover = np.zeros(ntiles * tn, np.int64)
    for s in range(splits):
        t0, t1 = s * tps, min(ntiles, (s + 1) * tps)
        assert t1 > t0  # no empty split
        for g in range(groups):
            for t in range(t0, t1):  # chunk rows t*tn + 64g .. +63
                cover[t * tn + 64 * g : t * tn + 64 * g + 64] += 1
    assert (cover[:n] == 1).all()


def test_tf32_split_keeps_fp32_accuracy():
    """K1's arithmetic: big has the low 13 mantissa bits clear, and
    big.big + big.small + small.big (each product exact in f32) holds the
    FP32 product's accuracy, where tf32 alone does not."""
    rng = np.random.default_rng(3)
    q = torch.from_numpy(rng.standard_normal((64, 128)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((500, 128)).astype(np.float32))
    qb, qs = tbf._tf32_split(q)
    xb, xs = tbf._tf32_split(x)
    for big, small, v in ((qb, qs, q), (xb, xs, x)):
        assert ((big.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((small.view(torch.int32) & 0x1FFF) == 0).all()
        assert ((big + small - v).abs() <= 2.0 ** -21 * v.abs()).all()
    ref = q.double() @ x.double().T
    three = qs @ xb.T + qb @ xs.T + qb @ xb.T
    one = qb @ xb.T
    scale = q.abs().double() @ x.abs().double().T
    assert ((three.double() - ref).abs() <= 1e-6 * scale).all()
    assert ((one.double() - ref).abs() > 1e-5 * scale).any()


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k", [(257, 8, 3, 4), (5000, 100, 130, 64),
                                     (20000, 128, 1024, 10),
                                     (40, 16, 1, 10), (3000, 33, 5, 64),
                                     (2000, 400, 70, 10)])
def test_k1_kernel_matches_plain(cuda, n, d, b, k):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, d, generator=g).to(cuda)
    q = torch.randn(b, d, generator=g).to(cuda)
    a = (x * x).sum(1)
    a[::7] += tbf._NEG_BIG
    before = dict(tbf.LAUNCHES)
    kd, ki = tbf._surrogate_topk(x, a, q, k)
    # one launch: the select form past k = 60 or at few queries
    form = ("k1_select" if k > tbf._K1_TC_MAX_K
            or b <= tbf._k1s_max_b(k, x.dtype) else "k1_topk")
    assert {n: v - before[n] for n, v in tbf.LAUNCHES.items()
            if v != before[n]} == {form: 1}
    pd, pi = tbf._invalid_to_sentinel(*tbf._surrogate_topk_plain(x, a, q, k))
    torch.cuda.synchronize()
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    q2max = float((q * q).sum(1).max())
    np.testing.assert_allclose(kd, pd, rtol=1e-5, atol=1e-5 * q2max)
    _same_sets_except_ties(ki, kd, pi, pd, atol=1e-5 * q2max)
    assert (ki % 7 != 0).all()  # penalised rows never returned


def _tf32_tie_pair(lo: float):
    """Two f32 values one ulp apart above ``lo`` that the 3xTF32 split
    cannot tell apart: (x_a, x_b) with x_a > x_b but big + small of
    ``_tf32_split`` equal (the split drops the lowest bit of x_b)."""
    u = np.arange(1 << 14, dtype=np.int64) + int(np.float32(lo).view(np.int32))
    vals = torch.from_numpy(u.astype(np.int32)).view(torch.float32)
    big, small = tbf._tf32_split(vals)
    approx = (big.double() + small.double()).numpy()
    tie = np.nonzero(approx[1:] == approx[:-1])[0]
    assert len(tie), "no 3xTF32 tie in the range"
    i = int(tie[0])
    return float(vals[i + 1]), float(vals[i])


def test_tf32_tie_pair_exists():
    """The data of the 3b card test: one ulp apart, equal after the tf32
    split (CPU arithmetic of the split)."""
    x_a, x_b = _tf32_tie_pair(98304.0)
    assert x_a > x_b and x_a - x_b == np.spacing(np.float32(x_b))
    big, small = tbf._tf32_split(torch.tensor([x_a, x_b]))
    s = big.double() + small.double()
    assert s[0] == s[1]


@pytest.mark.cuda
def test_k1_top64_holds_a_near_tie_at_ranks_64_65(cuda):
    """Fault 3b: at k = 64 one K1 call keeps no spare place, so its exact
    rescoring cannot bring back a true rank-64 row whose 3xTF32 score ties
    rank 65. The query is a unit axis, so every FP32 and float64 score is
    exact; the kernel's tf32 split makes the pair at ranks 64 / 65, one
    ulp (7.8e-3 at |x| ~ 1e5, far above the 1e-5 q2max tie tolerance)
    apart, equal. Rank 65 sits in the first 64-row split and rank 64 in
    the second, so the kernel's merge, which keeps the first of equal
    scores, would keep rank 65. Every other row is 10 apart."""
    d, n = 64, 1000
    x_a, x_b = _tf32_tie_pair(98304.0)
    g = torch.Generator().manual_seed(65)
    x0 = torch.cat([  # x_a, x_b lie in [98304, 98432)
        99000.0 + 10.0 * torch.arange(63, dtype=torch.float32),
        97000.0 - 10.0 * torch.arange(n - 65, dtype=torch.float32),
    ])[torch.randperm(n - 2, generator=g)]
    x = torch.randn(n, d, generator=g)
    x[:, 0] = torch.cat([torch.tensor([x_b]), x0[:63], torch.tensor([x_a]),
                         x0[63:]])
    q = torch.zeros(1, d)
    q[0, 0] = 1.0
    ref = -(x.double() @ q.double().T)[:, 0]  # ip order distances, exact
    order = torch.argsort(ref)
    assert float(ref[order[64]] - ref[order[63]]) > 1e-5  # not a tie
    kd, ki = tbf.ip_topk(x.to(cuda), q.to(cuda), 64)
    ki = ki.cpu()[0].long()
    assert set(ki.tolist()) == set(order[:64].tolist())
    np.testing.assert_array_equal(kd.cpu()[0].double().numpy(),
                                  ref[ki].numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("n,d,b,k,tn", [(50, 8, 2, 10, 256),
                                        (1000, 24, 6, 5, 256),
                                        (30000, 128, 1024, 10, 1024),
                                        (3000, 100, 130, 10, 256),
                                        (3000, 33, 1, 10, 128),
                                        (40, 16, 1, 10, 1024),
                                        (5000, 64, 20, 64, 1024),
                                        (1500, 1000, 3, 10, 128)])
def test_k2_kernel_matches_plain(cuda, n, d, b, k, tn):
    g = torch.Generator().manual_seed(n)
    x = torch.randn(n, d, generator=g).to(cuda)
    q = torch.randn(b, d, generator=g).to(cuda)
    a = (x * x).sum(1)
    a[::5] += tbf._NEG_BIG
    xb = x.to(torch.bfloat16)
    before = tbf.LAUNCHES["k2_binned"]
    kd, ki = tbf.binned_sweep_topk(xb, a, q, k, "l2", tn=tn)
    assert tbf.LAUNCHES["k2_binned"] == before + 1
    pd, pi = tbf.binned_sweep_topk(xb.cpu(), a.cpu(), q.cpu(), k, "l2", tn=tn)
    kd, ki = kd.cpu().numpy(), ki.cpu().numpy()
    pd, pi = pd.numpy(), pi.numpy()
    np.testing.assert_array_equal(np.isinf(kd), np.isinf(pd))
    fin = np.isfinite(pd)
    np.testing.assert_allclose(kd[fin], pd[fin], rtol=1e-2)
    # bf16 products are exact in f32: only the summation order differs,
    # so K1's scale holds, with twice its atol for the tensor cores
    q2max = float((q * q).sum(1).max())
    np.testing.assert_allclose(kd[fin], pd[fin], rtol=1e-5, atol=2e-5 * q2max)
    _same_sets_except_ties(ki, kd, pi, pd, atol=2e-5 * q2max)
    assert (ki[ki >= 0] % 5 != 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tn", [128, 1024])
def test_k2_ties_go_to_the_lower_row(cuda, tn):
    """Rows that tie exactly in one bin (the same row repeated every tn
    rows, within one block's range and across the grid's splits) keep the
    lowest row."""
    g = torch.Generator().manual_seed(tn)
    n, d = 40 * tn + 17, 64
    x = torch.randn(n, d, generator=g)
    x[tn::tn] = x[0]  # every tn-th row repeats row 0, in bin 0
    q = x[:130].clone()  # 130 queries: splits of more than one tile
    q[1:] += 0.01 * torch.randn(129, d, generator=g)
    a = (x * x).sum(1)
    _, ki = tbf.binned_sweep_topk(x.to(cuda).to(torch.bfloat16), a.to(cuda),
                                  q.to(cuda), 10, "l2", tn=tn)
    ki = ki.cpu().numpy()
    assert ki[0, 0] == 0, ki[0]
    assert not np.isin(ki, np.arange(tn, n, tn)).any()


@pytest.mark.cuda
def test_kernels_refuse_what_they_do_not_take(cuda):
    x = torch.randn(300, 16, device=cuda)
    q = torch.randn(4, 16, device=cuda)
    a = (x * x).sum(1)
    with pytest.raises(ValueError, match="float32"):
        tbf._surrogate_topk(x.double(), a, q, 5)
    with pytest.raises(ValueError, match="contiguous"):
        tbf._surrogate_topk(x.t().contiguous().t(), a, q, 5)
    with pytest.raises(ValueError, match="k must be"):
        tbf._surrogate_topk_cuda(x, a, q, 65)
    # past k = 64 the wrapper runs the kernel in rounds: the plain top-65
    d, i = tbf._surrogate_topk(x, a, q, 65)
    pd, pi = tbf._surrogate_topk(x.cpu(), a.cpu(), q.cpu(), 65)
    np.testing.assert_allclose(d.cpu().numpy(), pd.numpy(), rtol=1e-5,
                               atol=1e-4)
    assert (i.cpu() == pi).float().mean() >= 0.99
    with pytest.raises(ValueError, match="shape mismatch"):
        tbf._surrogate_topk(x, a[:10], q, 5)
    with pytest.raises(ValueError, match="bfloat16"):
        tbf.binned_sweep_topk(x, a, q, 5, "l2", tn=128)
    with pytest.raises(ValueError, match="multiple of 128"):
        tbf.binned_sweep_topk(x.to(torch.bfloat16), a, q, 5, "l2", tn=100)
