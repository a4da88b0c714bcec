"""K3, the packed tile-min sweep (pgvector_rx_tpu_torch/ops/bruteforce.py
``tilemin_sweep_topk``), against the JAX package's Pallas
``_tilemin_kernel`` in interpret mode on the CPU; on the card, the CUDA
kernel against its plain version, with a control that must be rejected.
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


def _data(rng, n, d, b, metric):
    base = rng.standard_normal((n, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        base /= np.linalg.norm(base, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    a = ((base ** 2).sum(1) if metric == "l2"
         else np.zeros(n)).astype(np.float32)
    return base, a, q


def _both(base, a, q, k, metric, tn):
    jd, ji = jbf.tilemin_sweep_topk(
        jnp.asarray(base), jnp.asarray(a), jnp.asarray(q), k, metric,
        tb=16, tn=tn, interpret=True,
    )
    td, ti = tbf.tilemin_sweep_topk(
        torch.from_numpy(base).to(torch.bfloat16), torch.from_numpy(a),
        torch.from_numpy(q), k, metric, tn=tn,
    )
    return np.asarray(jd), np.asarray(ji), td.numpy(), ti.numpy()


def _quantum(base, q, metric):
    """One packing quantum of the shifted scores, in distance units: the
    packed value keeps 13 mantissa bits of a score below 2 * shift."""
    x2 = (base.astype(np.float32) ** 2).sum(1).max()
    shift = x2 + (q ** 2).sum(1).max() + 1.0
    scale = 1.0 if metric == "l2" else 0.5  # ip/cosine halve the score
    return scale * 2.0 * shift * 2.0 ** -13


def _tie_mismatch(ti, td, ji, jd, atol) -> int:
    """Rows whose id sets differ other than by ties at the k-th distance:
    every id in one set and not the other lies within ``atol`` of the
    other side's k-th distance."""
    bad = 0
    for r in range(ti.shape[0]):
        st, sj = set(ti[r].tolist()), set(ji[r].tolist())
        dt = dict(zip(ti[r].tolist(), td[r].tolist()))
        dj = dict(zip(ji[r].tolist(), jd[r].tolist()))
        bad += not (all(abs(dt[i] - jd[r, -1]) <= atol for i in st - sj)
                    and all(abs(dj[i] - td[r, -1]) <= atol for i in sj - st))
    return bad


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_plain_matches_jax_interpret(rng, metric):
    """Same operands, same packing: distances agree to one packing
    quantum plus 1e-5 relative, ids agree except at ties."""
    base, a, q = _data(rng, 2000, 24, 6, metric)
    jd, ji, td, ti = _both(base, a, q, 5, metric, 128)
    assert ti.dtype == np.int32 and ((ti >= 0) & (ti < 2000)).all()
    atol = _quantum(base, q, metric)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=atol)
    assert not _tie_mismatch(ti, td, ji, jd, atol + 1e-5 * np.abs(jd).max())
    assert (np.diff(td, axis=1) >= 0).all()


def test_one_winner_per_tile(rng):
    """Two rows of one tile: only the nearer survives, ids stay clean."""
    base = np.zeros((256, 4), np.float32)
    base[:, 0] = np.arange(256, dtype=np.float32) + 10.0
    base[0, 0], base[5, 0] = 0.0, 0.5  # rows 0 and 5 share tile 0
    q = np.zeros((1, 4), np.float32)
    a = (base ** 2).sum(1).astype(np.float32)
    jd, ji, td, ti = _both(base, a, q, 2, "l2", 128)
    assert ti[0, 0] == 0 and ti[0, 1] == 128
    np.testing.assert_array_equal(ti, ji)


def test_masked_rows_and_k_beyond_tiles(rng):
    """Excluded rows never come back; k > N/tn pads with (inf, -1)."""
    base, a, q = _data(rng, 512, 16, 3, "l2")
    live = rng.random(512) < 0.5
    a = a + np.where(live, 0.0, tbf._NEG_BIG).astype(np.float32)
    jd, ji, td, ti = _both(base, a, q, 8, "l2", 128)
    valid = ti >= 0
    assert valid[:, :4].all() and live[ti[valid]].all()
    assert ((ti[:, 4:] == -1) & np.isinf(td[:, 4:])).all()
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_allclose(td[valid], jd[valid], rtol=1e-5,
                               atol=_quantum(base, q, "l2"))


def test_ragged_last_tile_pads_never_returned(rng):
    base, a, q = _data(rng, 300, 8, 4, "l2")
    jd, ji, td, ti = _both(base, a, q, 3, "l2", 128)  # 3 tiles, last ragged
    assert ((ti >= 0) & (ti < 300)).all()
    np.testing.assert_array_equal(ti, ji)


def test_tn_above_1024_raises(rng):
    """The id field has 10 bits: the port refuses tn > 1024 (the TPU
    wrapper would take 2048 and drop the column's top bit)."""
    base, a, q = _data(rng, 4096, 8, 2, "l2")
    args = (torch.from_numpy(base).to(torch.bfloat16), torch.from_numpy(a),
            torch.from_numpy(q), 5, "l2")
    with pytest.raises(ValueError, match="at most 1024"):
        tbf.tilemin_sweep_topk(*args, tn=2048)
    with pytest.raises(ValueError, match="multiple of 128"):
        tbf.tilemin_sweep_topk(*args, tn=100)


@pytest.mark.parametrize("n,tn", [(100, 1024),        # n < tn: one tile
                                  (4096, 1024),       # a multiple of tn
                                  (5000, 1024),       # a ragged last tile
                                  (300, 128),         # more splits than tiles
                                  (1_000_000, 1024)])  # the smoke's shape
@pytest.mark.parametrize("b", [1, 127, 128, 1024])
@pytest.mark.parametrize("target", [1, 264])
def test_k3_plan_covers_every_tile_once(n, tn, b, target):
    qtiles, splits, tps = tbf._k3_plan(n, b, tn, target)
    assert qtiles * tbf._K3_QTILE >= b > (qtiles - 1) * tbf._K3_QTILE
    assert 1 <= splits <= 65535
    assert qtiles * splits <= max(target, qtiles)
    ntiles = -(-n // tn)
    cover = np.zeros(ntiles, np.int64)
    for s in range(splits):
        t0, t1 = s * tps, min(ntiles, (s + 1) * tps)
        assert t1 > t0  # no empty split
        cover[t0:t1] += 1
    assert (cover == 1).all()


def test_row_sq_max_plain_is_the_f32_row_norm_max(rng):
    """The shift's corpus term: the largest f32 sum of squares of the bf16
    rows, within f32 summation error of float64 numpy."""
    base = rng.standard_normal((700, 100)).astype(np.float32)
    base[123] *= 3.0
    xb = torch.from_numpy(base).to(torch.bfloat16)
    ref = (xb.double().numpy() ** 2).sum(1).max()
    got = float(tbf._row_sq_max(xb))
    assert abs(got - ref) <= 2 * 100 * 2.0 ** -24 * ref
    assert int(torch.argmax((xb.float() ** 2).sum(1))) == 123


def test_cpu_takes_plain_and_kernel_refuses_cpu(rng):
    base, a, q = _data(rng, 300, 16, 4, "l2")
    xb = torch.from_numpy(base).to(torch.bfloat16)
    before = dict(tbf.LAUNCHES)
    tbf.tilemin_sweep_topk(xb, torch.from_numpy(a), torch.from_numpy(q), 5,
                           "l2", tn=128)
    assert tbf.LAUNCHES == before
    q2x, av, _ = tbf._tilemin_prepare(xb, torch.from_numpy(a),
                                      torch.from_numpy(q))
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbf._tilemin_packed_cuda(xb, av, q2x, 128)
    with pytest.raises(ValueError, match="CUDA tensor"):
        tbf._row_sq_max_cuda(xb)


# ---------------------------------------------------------------------------
# On the card: K3 against its plain version, and a control
# ---------------------------------------------------------------------------


def _packed_no_clear(base_bf16, av, q2x, tn):
    """Control: ORs the column into the score bits WITHOUT clearing the
    low 10 bits first (the ids it decodes are corrupt)."""
    n = base_bf16.shape[0]
    x = torch.nn.functional.pad(base_bf16.float(), (0, 0, 0, (-n) % tn))
    av = torch.nn.functional.pad(av, (0, (-n) % tn), value=tbf._NEG_BIG)
    s = av[None, :] - q2x.float() @ x.T
    col = torch.arange(s.shape[1], device=s.device, dtype=torch.int32) % tn
    return (s.view(torch.int32) | col[None, :]).view(s.shape[0], -1,
                                                      tn).amin(dim=2)


def _held_to_scores(sd, si, base_bf16, a, queries, shift, q2max):
    """Every returned (score, id) must lie within one packing quantum plus
    K2's summation tolerance of that id's own bf16 score."""
    qf = (2.0 * queries.float()).to(torch.bfloat16).float()
    rows = base_bf16[si.clamp(min=0).long()].float()
    true = a[si.clamp(min=0).long()] - (rows * qf[:, None, :]).sum(-1)
    tol = (true.abs() + shift) * 2.0 ** -13 + 1e-5 * true.abs() + 2e-5 * q2max
    return bool(((sd - true).abs() <= tol)[si >= 0].all())


def _k3_mismatch(sd, si, pd, pi, base_bf16, a, queries, shift, q2max):
    """'' when K3-style results (sd, si) agree with the plain version's
    (pd, pi): the same slots filled, every returned score within one
    packing quantum plus K2's summation tolerance of its id's own bf16
    score and of the plain score at its rank, and ids equal except at ties
    within that tolerance; otherwise what differs."""
    if not _held_to_scores(sd, si, base_bf16, a, queries, shift, q2max):
        return "a returned score is not its id's own"
    sd, si, pd, pi = (t.cpu().numpy() for t in (sd, si, pd, pi))
    if not np.array_equal(si >= 0, pi >= 0):
        return "other slots are filled"
    fin = pi >= 0
    tol = (np.abs(pd[fin]) + shift) * 2.0 ** -13 + 2e-5 * q2max
    if not (np.abs(sd[fin] - pd[fin]) <= tol).all():
        return "a score differs from the plain one at its rank"
    if _tie_mismatch(si, sd, pi, pd, float(tol.max()) if tol.size else 0.0):
        return "ids differ beyond ties"
    return ""


def test_score_check_rejects_the_no_clear_control(rng):
    """The check the card tests apply holds the plain version and rejects
    packing without the low-bit clear (CPU, plain tensors)."""
    base, a, q = _data(rng, 4000, 32, 16, "l2")
    xb = torch.from_numpy(base).to(torch.bfloat16)
    at, qt = torch.from_numpy(a), torch.from_numpy(q)
    q2x, av, shift = tbf._tilemin_prepare(xb, at, qt)
    q2max = float((qt * qt).sum(1).max())
    pd, pi = tbf._tilemin_plain(xb, at, qt, 10, 128)
    assert _held_to_scores(pd, pi, xb, at, qt, float(shift), q2max)
    assert not _k3_mismatch(pd, pi, pd, pi, xb, at, qt, float(shift), q2max)
    cd, ci = tbf._tilemin_unpack(_packed_no_clear(xb, av, q2x, 128), shift,
                                 4000, 10, 128)
    assert not _held_to_scores(cd, ci, xb, at, qt, float(shift), q2max)
    assert _k3_mismatch(cd, ci, pd, pi, xb, at, qt, float(shift), q2max)


def _misaligned(t):
    """A contiguous copy of ``t`` whose data starts 2 bytes past an
    allocation's start (odd-address bf16 rows: the kernels' 2-byte copy
    path whatever d is)."""
    flat = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = flat[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 24, 100, 127, 128, 800])
@pytest.mark.parametrize("n,b,tn", [(300, 3, 128), (1023, 70, 512),
                                    (1023, 129, 128), (300, 1024, 1024),
                                    (40000, 129, 512), (40000, 1024, 1024)])
def test_k3_kernel_matches_plain(cuda, n, d, b, tn):
    """Alignment paths (d % 8, d % 2, odd d), queries streamed beside the
    corpus (d = 800), ragged last tiles and chunks, partial query tiles."""
    k = 10
    g = torch.Generator().manual_seed(n * 1000 + d)
    x = torch.randn(n, d, generator=g).to(cuda)
    q = torch.randn(b, d, generator=g).to(cuda)
    a = (x * x).sum(1)
    a[::9] += tbf._NEG_BIG
    xb = x.to(torch.bfloat16)
    before = tbf.LAUNCHES["k3_tilemin"]
    kd, ki = tbf._tilemin_cuda(xb, a, q, k, tn)
    assert tbf.LAUNCHES["k3_tilemin"] == before + 1
    pd, pi = tbf._tilemin_plain(xb, a, q, k, tn)
    q2x, av, shift = tbf._tilemin_prepare(xb, a, q)
    q2max = float((q * q).sum(1).max())
    assert _held_to_scores(pd, pi, xb, a, q, float(shift), q2max)
    args = (xb, a, q, float(shift), q2max)
    assert not _k3_mismatch(kd, ki, pd, pi, *args)
    assert (ki[ki >= 0] % 9 != 0).all()

    c_packed = _packed_no_clear(xb, av, q2x, tn)
    cd, ci = tbf._tilemin_unpack(c_packed, shift, n, k, tn)
    assert _k3_mismatch(cd, ci, pd, pi, *args)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [8, 128, 127])
def test_k3_packed_matches_plain_from_misaligned_rows(cuda, d):
    """Rows that start 2 bytes off an allocation take the 2-byte copies;
    the packed tile minima still match the plain version's to one packing
    quantum of the shifted score plus the summation order."""
    g = torch.Generator().manual_seed(d)
    x = torch.randn(3000, d, generator=g).to(cuda)
    q = torch.randn(200, d, generator=g).to(cuda)
    xb = _misaligned(x.to(torch.bfloat16))
    q2x, av, shift = tbf._tilemin_prepare(xb, (x * x).sum(1), q)
    got = tbf._tilemin_packed_cuda(xb, av, _misaligned(q2x), 256)
    want = tbf._tilemin_packed_plain(xb, av, q2x, 256)
    gs = (got & ~tbf._ID_MASK).view(torch.float32)
    ws = (want & ~tbf._ID_MASK).view(torch.float32)
    q2max = float((q * q).sum(1).max())
    tol = (ws.abs() + float(shift)) * 2.0 ** -13 + 2e-5 * q2max
    assert ((gs - ws).abs() <= tol).all()
    assert (got == want).float().mean() > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("n,d", [(1, 8), (1000, 100), (40000, 127),
                                 (40000, 128), (5000, 800)])
def test_k3_shift_on_the_card_matches_plain(cuda, n, d):
    """The card's shift (k3_x2max_kernel, no f32 copy of the corpus) is
    the plain ``_tilemin_prepare`` shift up to f32 summation order: d
    positive terms differ by at most 2 d 2^-24 of the sum in any two
    orders. Misaligned rows take its 2-byte loads."""
    g = torch.Generator().manual_seed(n + d)
    x = torch.randn(n, d, generator=g).to(cuda)
    x[n // 2] *= 4.0
    q = torch.randn(50, d, generator=g).to(cuda)
    a = (x * x).sum(1)
    xb = x.to(torch.bfloat16)
    tol = 2 * d * 2.0 ** -24
    plain = tbf._row_sq_max_plain(xb)
    for rows in (xb, _misaligned(xb)):
        before = tbf.LAUNCHES["k3_x2max"]
        got = tbf._row_sq_max(rows)
        assert tbf.LAUNCHES["k3_x2max"] == before + 1
        assert got.shape == () and got.dtype == torch.float32
        assert abs(float(got) - float(plain)) <= tol * float(plain)
    _, av_k, shift_k = tbf._tilemin_prepare(xb, a, q)
    _, av_p, shift_p = tbf._tilemin_prepare(xb, a, q, plain)
    tol += 2.0 ** -22  # plus the rounding of the sums that carry it
    assert abs(float(shift_k) - float(shift_p)) <= tol * float(shift_p)
    torch.testing.assert_close(av_k, av_p, rtol=tol, atol=0.0)


@pytest.mark.cuda
def test_k3_refuses_what_it_does_not_take(cuda):
    x = torch.randn(300, 16, device=cuda)
    q = torch.randn(4, 16, device=cuda)
    a = (x * x).sum(1)
    with pytest.raises(ValueError, match="bfloat16"):
        tbf.tilemin_sweep_topk(x, a, q, 5, "l2", tn=128)
    with pytest.raises(ValueError, match="at most 1024"):
        tbf.tilemin_sweep_topk(x.to(torch.bfloat16), a, q, 5, "l2", tn=2048)
