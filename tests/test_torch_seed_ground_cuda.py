"""Kernels K7 (the beam engine's coarse seed sweep, ``csrc/k7_coarse.cu``)
and K8 (the device build's beam ground, ``csrc/k8_beam_ground.cu``)
against their plain versions on the card, on the same CUDA tensors. This
file imports no JAX: the plain versions are held to the JAX package by
tests/test_torch_coarse_seeds.py and tests/test_torch_beam_ground.py.

K7: 20,000 random upper rows of 40,000 elements (15% not traversable),
128-, 768- and 1,024-d, l2 / ip / cosine, at 1 and 1,024 queries: the
same seeds but for ties at the 8th score (float64 scores of the bf16
operands within 1e-5 of the scale: the kernel's tensor-core sums run in
another order than the plain f32 GEMM's).

K8: a random layer 0 (20,000 rows, 32 neighbours each, a tenth missing,
5% of the rows dead) and 256 rows walked from 4 random seeds and the
entry, in the three merges, five metric forms and E = 1 and 4: ids equal
but for ties and distances to rtol 1e-5 (atol 1e-6) on every row whose
walk's first difference from the plain one is not a tie (f32 sums in
another order can swap two near-equal candidates and so steer a walk;
walked again for 1, 2, ... steps, such a row must part from the plain
walk at a tie), and ids and distances exactly equal for jacbits, whose distances
are exact.
Each case must also reject the plain walk cut to half its steps. Then
64,000-d {0,1} rows (the bit kind's widest, as hamming-as-l2 and
jacbits walks see them; the query stays in global memory, so its width
bounds nothing): exactly equal.

Run on the card: ``python -m pytest tests/test_torch_seed_ground_cuda.py
-q`` (the CPU run skips them).
"""

import numpy as np
import pytest
import torch

from pgvector_rx_tpu_torch.graph import device_build as tdb
from pgvector_rx_tpu_torch.ops import bruteforce as tbf

S = 8
K8_ROWS, K8_B, K8_W, K8_L, K8_SEEDS, K8_STEPS = 20_000, 256, 32, 32, 4, 12
#: K8's cases: metric -> row width (33: the scalar-load path)
K8_DIMS = {"l2": 128, "ip": 768, "cosine": 1024, "l1": 33, "jacbits": 256}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _k7_inputs(dev, d, b, metric, u=20_000, cap=40_000, seed=0):
    rng = np.random.default_rng(seed)
    rows = rng.standard_normal((u, d)).astype(np.float32)
    q = rng.standard_normal((b, d)).astype(np.float32)
    if metric == "cosine":
        rows /= np.linalg.norm(rows, axis=1, keepdims=True)
        q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = torch.from_numpy(rows).to(dev).to(torch.bfloat16)
    ids = torch.from_numpy(np.sort(rng.choice(cap, u, replace=False))).to(dev)
    trav = torch.from_numpy(rng.random(cap + 1) < 0.85).to(dev)
    rf = rows.float()
    a = ((rf * rf).sum(1) if metric == "l2"
         else torch.zeros(u, device=dev))
    return rows, a.contiguous(), ids, trav, torch.from_numpy(q).to(dev)


def _k7_scores(rows, a, ids, trav, q, l2):
    """[B, U] float64 scores of the bf16 operands, inf on dead rows."""
    dots = q.to(torch.bfloat16).double() @ rows.double().T
    sc = a.double()[None] - (2 * dots if l2 else dots)
    return torch.where(trav[ids][None], sc, float("inf")).cpu().numpy()


def _k7_same_but_ties(slots_k, slots_p, sc):
    """Per query: the same finite count and slots, but where a slot's
    score ties the 8th (to 1e-5 of the scale); the scores, sorted, equal
    position by position to that tolerance."""
    for b in range(sc.shape[0]):
        fk, fp = slots_k[b] >= 0, slots_p[b] >= 0
        assert (fk == fp).all(), b
        sk, sp = sc[b, slots_k[b][fk]], sc[b, slots_p[b][fp]]
        tol = 1e-5 * max(1.0, float(np.abs(sp).max()))
        assert (np.abs(np.sort(sk) - np.sort(sp)) <= tol).all(), b
        for e in set(slots_k[b][fk].tolist()) ^ set(slots_p[b][fp].tolist()):
            assert abs(sc[b, e] - sp[-1]) <= tol, (b, e)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
@pytest.mark.parametrize("b", [1, 1024])
@pytest.mark.parametrize("d", [128, 768, 1024])
def test_k7_equals_plain(cuda, d, b, metric):
    rows, a, ids, trav, q = _k7_inputs(cuda, d, b, metric)
    l2 = metric == "l2"
    form = "k7_coarse_one" if b == 1 else "k7_coarse"
    before = tbf.LAUNCHES[form]
    slots_k, ids_k = tbf.coarse_topk(rows, a, ids, trav, q, S, l2)
    assert tbf.LAUNCHES[form] == before + 1
    slots_p, ids_p = tbf._coarse_plain(rows, a, ids, trav, q, S, l2)
    torch.cuda.synchronize()
    assert torch.equal(torch.where(slots_k >= 0, ids[slots_k.clamp(min=0)],
                                   -1), ids_k)
    assert not (~trav[ids_k[ids_k >= 0]]).any()
    sc = _k7_scores(rows, a, ids, trav, q, l2)
    _k7_same_but_ties(slots_k.cpu().numpy(), slots_p.cpu().numpy(), sc)
    # the scores are held tight enough to reject a wrong seed: the plain
    # 9th-best in place of the 8th fails the check
    if b == 1024:
        slots9, _ = tbf._coarse_plain(rows, a, ids, trav, q, S + 1, l2)
        wrong = torch.cat([slots9[:, : S - 1], slots9[:, S:]], 1)
        with pytest.raises(AssertionError):
            _k7_same_but_ties(wrong.cpu().numpy(), slots_p.cpu().numpy(), sc)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [33, 128, 768, 1024])
def test_k7_one_query_form(cuda, d):
    """The one-query form (one launch, its lists merged by the last block)
    at 16-byte loads, or 2-byte ones at d = 33: 40 queries in turn (its
    scratch and ticket are reused), three and eight seeds, then fewer
    live rows than seeds."""
    rows, a, ids, trav, q = _k7_inputs(cuda, d, 40, "l2", seed=d)
    sc = _k7_scores(rows, a, ids, trav, q, True)
    for s in (3, S):
        before = tbf.LAUNCHES["k7_coarse_one"]
        got = [tbf.coarse_topk(rows, a, ids, trav, q[i : i + 1], s, True)[0]
               for i in range(q.shape[0])]
        assert tbf.LAUNCHES["k7_coarse_one"] == before + q.shape[0]
        want, _ = tbf._coarse_plain(rows, a, ids, trav, q, s, True)
        _k7_same_but_ties(torch.cat(got).cpu().numpy(), want.cpu().numpy(),
                          sc)
    trav[:] = False
    trav[ids[-3:]] = True
    _, got = tbf.coarse_topk(rows, a, ids, trav, q[:1], S, True)
    assert set(got[0, :3].tolist()) == set(ids[-3:].tolist())
    assert (got[0, 3:] == -1).all()


@pytest.mark.cuda
def test_k7_fewer_seeds_and_its_limit(cuda):
    """Three seeds (fewer than the 8 a thread's list holds), and more than
    8 refused."""
    rows, a, ids, trav, q = _k7_inputs(cuda, 256, 300, "l2", seed=1)
    slots_k, _ = tbf.coarse_topk(rows, a, ids, trav, q, 3, True)
    slots_p, _ = tbf._coarse_plain(rows, a, ids, trav, q, 3, True)
    _k7_same_but_ties(slots_k.cpu().numpy(), slots_p.cpu().numpy(),
                      _k7_scores(rows, a, ids, trav, q, True))
    with pytest.raises(ValueError, match="1 to 8 seeds"):
        tbf.coarse_topk(rows, a, ids, trav, q, 9, True)


@pytest.mark.cuda
def test_k7_dead_rows_and_few_rows(cuda):
    """Fewer live rows than seeds: the live ones, then -1; every row dead:
    all -1."""
    rows, a, ids, trav, q = _k7_inputs(cuda, 128, 5, "l2", u=40, cap=80)
    trav[:] = False
    trav[ids[:3]] = True
    slots, got = tbf.coarse_topk(rows, a, ids, trav, q, S, True)
    assert (got[:, :3] >= 0).all() and (got[:, 3:] == -1).all()
    assert set(got[0, :3].tolist()) == set(ids[:3].tolist())
    trav[:] = False
    slots, got = tbf.coarse_topk(rows, a, ids, trav, q, S, True)
    assert (got == -1).all() and (slots == -1).all()


def _k8_inputs(dev, metric, merge, seed=0, d=None, n=K8_ROWS, B=K8_B,
               L=K8_L, bits=False):
    """(arguments of the walk after ``expand``, minus steps/expand/merge):
    rows, neighbour lists, live flags, cap, metric, query rows and the
    seeded beam, as ``DeviceBuilder._beam_ground_candidates`` seeds it.
    ``bits``: {0,1} rows (always for jacbits)."""
    d, W = d or K8_DIMS[metric], K8_W
    rng = np.random.default_rng(seed)
    if metric == "jacbits" or bits:
        vec = (rng.random((n + 1, d)) < 0.3).astype(np.float32)
    else:
        vec = rng.standard_normal((n + 1, d)).astype(np.float32)
        if metric in ("cosine", "ip"):
            vec /= np.linalg.norm(vec, axis=1, keepdims=True)
    vec[n] = 0
    nb = rng.integers(0, n, (n + 1, L)).astype(np.int32)
    nb[rng.random(nb.shape) < 0.1] = -1
    nb[n] = -1
    alive = rng.random(n + 1) < 0.95
    alive[n] = False
    vec_t = torch.from_numpy(vec).to(dev)
    rows = vec_t.to(torch.bfloat16)
    q = vec_t[torch.from_numpy(rng.choice(n, B)).to(dev)].contiguous()
    entry = n // 2
    seeds = rng.integers(0, n, (B, K8_SEEDS))
    seeds[rng.random(seeds.shape) < 0.1] = -1
    seeds = torch.from_numpy(seeds).to(dev)
    all_s = torch.cat([seeds, torch.full((B, 1), entry, device=dev)], 1)
    bkey = torch.full((B, W), -2, dtype=torch.int64, device=dev)
    bd = torch.full((B, W), float("inf"), device=dev)
    sd = tdb._point_row_dists(metric, q, vec_t[all_s.clamp(min=0)])
    bkey[:, : K8_SEEDS + 1] = torch.where(all_s >= 0, all_s * 2 + 1, -2)
    bd[:, : K8_SEEDS + 1] = torch.where(all_s >= 0, sd, float("inf"))
    if merge == "rank":
        dup = (seeds == entry).any(1)
        bd[:, K8_SEEDS] = torch.where(dup, float("inf"), bd[:, K8_SEEDS])
        bkey[:, K8_SEEDS] = torch.where(dup, -2, bkey[:, K8_SEEDS])
        bd, o = torch.sort(bd, dim=1, stable=True)
        bkey = torch.gather(bkey, 1, o)
    return (rows, torch.from_numpy(nb).to(dev), torch.from_numpy(alive).to(dev),
            n, metric, q, bd.contiguous(), bkey)


def _k8_agree(dk, ik, dp, ip_):
    """Rows whose ids are equal but for ties at the last finite distance,
    with distances equal position by position to rtol 1e-5, atol 1e-6."""
    ok = np.zeros(dk.shape[0], bool)
    for r in range(dk.shape[0]):
        fk, fp = np.isfinite(dk[r]), np.isfinite(dp[r])
        if (fk != fp).any() or not np.allclose(dk[r][fk], dp[r][fp],
                                               rtol=1e-5, atol=1e-6):
            continue
        if (ik[r] == ip_[r]).all():
            ok[r] = True
            continue
        last = dp[r][fp][-1] if fp.any() else 0.0
        tol = 1e-5 * abs(last) + 1e-6
        where = dict(zip(ik[r].tolist(), dk[r].tolist()))
        where.update(zip(ip_[r].tolist(), dp[r].tolist()))
        diff = set(ik[r][fk].tolist()) ^ set(ip_[r][fp].tolist())
        ok[r] = all(abs(where[e] - last) <= tol for e in diff)
    return ok


def _first_difference_is_a_tie(args, kw, rows):
    """For the batch rows ``rows`` (their walks differ beyond ties after
    the last step): whether each walk's first difference from the plain
    one is a tie. Both walks run 1, 2, ... steps over the same batch; at
    the first step whose ids differ in any place, the beams must still
    agree but for ties (``_k8_agree``): a near tie, summed in another
    order, steered the walk. A walk that parts from identical beams is a
    fault."""
    first = np.zeros(len(rows), int)
    tie = np.zeros(len(rows), bool)
    for s in range(1, K8_STEPS + 1):
        dk, ik = tdb._beam_ground_cuda(*args, steps=s, **kw)
        dp, ip_ = tdb._beam_ground_plain(*args, steps=s, **kw)
        dk, ik, dp, ip_ = (t.cpu().numpy()[rows] for t in (dk, ik, dp, ip_))
        new = (first == 0) & (ik != ip_).any(1)
        tie[new] = _k8_agree(dk, ik, dp, ip_)[new]
        first[new] = s
    return tie


@pytest.mark.cuda
@pytest.mark.parametrize("expand", [1, 4])
@pytest.mark.parametrize("merge", ["sort", "nodedup", "rank"])
@pytest.mark.parametrize("metric", list(K8_DIMS))
def test_k8_equals_plain(cuda, metric, merge, expand):
    args = _k8_inputs(cuda, metric, merge)
    mode = ("rank" if merge == "rank" else "sort", merge != "nodedup")
    kw = dict(expand=expand, dedup=mode[1], merge=mode[0])
    before = tbf.LAUNCHES["k8_beam_ground"]
    dk, ik = tdb._beam_ground_cuda(*args, steps=K8_STEPS, **kw)
    assert tbf.LAUNCHES["k8_beam_ground"] == before + 1
    dp, ip_ = tdb._beam_ground_plain(*args, steps=K8_STEPS, **kw)
    dc, ic = tdb._beam_ground_plain(*args, steps=K8_STEPS // 2, **kw)
    torch.cuda.synchronize()
    dk, ik, dp, ip_, dc, ic = (t.cpu().numpy() for t in (dk, ik, dp, ip_,
                                                         dc, ic))
    assert ik.dtype == np.int64 and dk.shape == (K8_B, K8_W)
    assert (np.isfinite(dk) == (ik >= 0)).all()
    ok = _k8_agree(dk, ik, dp, ip_)
    if metric == "jacbits":  # exact distances: the same walk
        np.testing.assert_array_equal(ik, ip_)
        np.testing.assert_array_equal(dk, dp)
    bad = np.flatnonzero(~ok)
    # a row may part only where its walk's first difference is a tie
    tie = _first_difference_is_a_tie(args, kw, bad) if bad.size else ok[:0]
    assert tie.all(), (metric, merge, expand, bad, tie)
    # the check rejects a walk of half the steps
    assert _k8_agree(dc, ic, dp, ip_).mean() < 0.99
    if merge != "nodedup":  # each id at most once
        for r in range(K8_B):
            live = ik[r][ik[r] >= 0]
            assert len(set(live.tolist())) == len(live), r


@pytest.mark.cuda
@pytest.mark.parametrize("merge", ["sort", "rank"])
@pytest.mark.parametrize("metric", ["l2", "jacbits"])
def test_k8_at_64000_bits(cuda, metric, merge):
    """{0,1} rows 64,000 wide (``HNSW_MAX_DIM_BIT``): integer distances,
    summed exactly in any order, so the same walk as the plain one."""
    args = _k8_inputs(cuda, metric, merge, d=64_000, n=2_000, B=16, L=16,
                      bits=True)
    kw = dict(expand=4, dedup=True, merge=merge)
    dk, ik = tdb._beam_ground_cuda(*args, steps=8, **kw)
    dp, ip_ = tdb._beam_ground_plain(*args, steps=8, **kw)
    torch.cuda.synchronize()
    assert (ik >= 0).any()
    assert torch.equal(ik, ip_) and torch.equal(dk, dp)


@pytest.mark.cuda
def test_k8_refuses_what_shared_memory_cannot_hold(cuda):
    """W + E * 2m entries past a block's shared memory (W = 32, E = 8,
    2m = 8,192); the query's width is no limit."""
    d, n, b, w, lm0 = 16, 10, 2, K8_W, 8192
    args = (torch.zeros((n + 1, d), dtype=torch.bfloat16, device=cuda),
            torch.full((n + 1, lm0), -1, dtype=torch.int32, device=cuda),
            torch.zeros(n + 1, dtype=torch.bool, device=cuda), n, "l2",
            torch.zeros((b, d), device=cuda),
            torch.full((b, w), float("inf"), device=cuda),
            torch.full((b, w), -2, dtype=torch.int64, device=cuda))
    with pytest.raises(ValueError, match="shared memory"):
        tdb._beam_ground_cuda(*args, steps=1, expand=8, dedup=True,
                              merge="sort")


def test_k8_refuses_cpu_tensors():
    """The CUDA entry takes CUDA tensors only; the wrapper's dispatch
    (``DeviceBuilder._beam_ground_candidates``) sends CPU tensors to the
    plain version."""
    args = _k8_inputs(torch.device("cpu"), "l2", "sort")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tdb._beam_ground_cuda(*args, steps=1, expand=1, dedup=True,
                              merge="sort")
    d, ids = tdb._beam_ground_plain(*args, steps=2, expand=1, dedup=True,
                                    merge="sort")
    assert d.shape == ids.shape == (K8_B, K8_W)
