"""The port's packed-bit ops (pgvector_rx_tpu_torch/ops/bits.py) against the
JAX package's (pgvector_rx_tpu/ops/bits.py and ``_exact_search_bits``), on
the same numpy inputs.

- ``pack_bits`` / ``unpack_bits`` give the JAX package's arrays; the
  popcount equals numpy's ``unpackbits(...).sum()``;
- ``pairwise`` / ``gathered`` / ``unpack_words_bf16`` equal JAX's exactly
  (popcounts are integers, jaccard one f32 division);
- K9's plain versions (``_bits_topk_plain``, the popcount form, and
  ``_bits_topk_plain_mm``, the tensor-core form's) equal
  ``_exact_search_bits`` at B = 8 (JAX's popcount form) and B = 48 (its
  unpack + matmul form), both metrics, with dead rows and a row mask:
  equal distances and equal ids, tie order included; k = 100 through the
  kernel's rounds; the two plain versions give the same keys at 2 and 9
  words per row; ``_k9_form`` is JAX's ``B >= 32`` rule.
Card-only (``cuda``): both forms of K9 and the walk kernel's packed-word
mode (with the greedy descent in its launch) against their plain
versions.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pgvector_rx_tpu.graph import device as jdev
from pgvector_rx_tpu.ops import bits as jbits
from pgvector_rx_tpu_torch.ops import beam as tbeam
from pgvector_rx_tpu_torch.ops import bits as tbits
from pgvector_rx_tpu_torch.ops import bruteforce as tbf

torch.set_num_threads(1)

METRICS = ("hamming", "jaccard")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def _bits(rng, n, nbits, p=0.3):
    return (rng.random((n, nbits)) < p).astype(np.uint8)


@pytest.mark.parametrize("nbits", [1, 72, 100, 256])
def test_pack_and_unpack_give_the_jax_arrays(nbits):
    b = _bits(np.random.default_rng(nbits), 9, nbits, 0.5)
    w = tbits.pack_bits(b)
    np.testing.assert_array_equal(w, jbits.pack_bits(b))
    assert w.dtype == np.uint32
    np.testing.assert_array_equal(tbits.unpack_bits(w, nbits),
                                  jbits.unpack_bits(w, nbits))
    np.testing.assert_array_equal(tbits.unpack_bits(w, nbits), b)
    packed = np.packbits(b, axis=1)
    np.testing.assert_array_equal(tbits.bytes_to_words(packed, nbits), w)


def test_popcount_matches_unpackbits():
    rng = np.random.default_rng(3)
    x = rng.integers(-2**31, 2**31, size=4096, dtype=np.int64).astype(
        np.int32)
    x[:4] = [0, -1, -2**31, 2**31 - 1]
    ref = np.unpackbits(x.view(np.uint8).reshape(-1, 4), axis=1).sum(1)
    np.testing.assert_array_equal(tbits.popcount(torch.from_numpy(x)).numpy(),
                                  ref)
    words = x.reshape(-1, 8)
    np.testing.assert_array_equal(
        tbits.row_popcount(torch.from_numpy(words)).numpy(),
        ref.reshape(-1, 8).sum(1).astype(np.float32))


def test_as_words_keeps_the_bits():
    w = np.array([[0, 1, 0x80000000, 0xFFFFFFFF]], dtype=np.uint32)
    t = tbits.as_words(w)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), w)
    assert torch.equal(tbits.as_words(t), t)
    with pytest.raises(ValueError, match="32-bit"):
        tbits.as_words(np.zeros((1, 2), np.uint8))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nbits", [72, 256])
def test_pairwise_and_gathered_equal_jax(metric, nbits):
    rng = np.random.default_rng(nbits)
    bw = jbits.pack_bits(_bits(rng, 60, nbits))
    qw = jbits.pack_bits(_bits(rng, 7, nbits))
    bw[5] = 0  # a zero row: jaccard 1.0 to everything
    got = tbits.pairwise(metric, tbits.as_words(bw), tbits.as_words(qw))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(jbits.pairwise(metric, bw, qw)))
    ids = rng.integers(0, 60, size=(7, 9)).astype(np.int32)
    jg = np.asarray(jbits.gathered(metric, bw, ids, qw))
    tg = tbits.gathered(metric, tbits.as_words(bw), torch.from_numpy(ids),
                        tbits.as_words(qw))
    np.testing.assert_array_equal(tg.numpy(), jg)
    pop = tbits.row_popcount(tbits.as_words(bw))
    tg2 = tbits.gathered(metric, tbits.as_words(bw), torch.from_numpy(ids),
                         tbits.as_words(qw), base_pop=pop)
    np.testing.assert_array_equal(tg2.numpy(), jg)
    # the walk's row distances are the same function
    np.testing.assert_array_equal(
        tbeam.row_dists(tbits.as_words(bw), metric, tbits.as_words(qw),
                        torch.from_numpy(ids)).numpy(), jg)


def test_unpack_words_bf16_equals_jax():
    bw = jbits.pack_bits(_bits(np.random.default_rng(5), 11, 72, 0.5))
    ref = np.asarray(jbits.unpack_words_bf16(jnp.asarray(bw))).astype(
        np.float32)
    got = tbits.unpack_words_bf16(tbits.as_words(bw))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), ref)


def test_prepare_rows_equals_prepare_value():
    from pgvector_rx_tpu_torch import HnswIndex

    rng = np.random.default_rng(8)
    for nbits in (13, 64):
        idx = HnswIndex(nbits, metric="hamming", kind="bit", device="cpu")
        for data in (_bits(rng, 40, nbits),
                     rng.integers(0, 3, (40, nbits)),
                     (rng.random((40, nbits)) < 0.5)):
            got = tbits.prepare_rows(data, nbits)
            ref = np.stack([idx.prepare_value(v) for v in data])
            np.testing.assert_array_equal(got, ref)
        packed = np.packbits(_bits(rng, 5, nbits), axis=1)
        np.testing.assert_array_equal(
            tbits.prepare_rows(packed, nbits),
            np.stack([idx.prepare_value(v) for v in packed]))
        with pytest.raises(ValueError, match="dimensions"):
            tbits.prepare_rows(_bits(rng, 3, nbits + 1), nbits)


# ---------------------------------------------------------------------------
# K9's plain version against _exact_search_bits
# ---------------------------------------------------------------------------

_N, _NBITS = 1500, 72


def _graph(metric, seed=11, nbits=_NBITS):
    """A JAX bit DeviceGraph (no edges: the sweep reads rows and flags
    only) with dead rows, untupled rows and heavy ties (few set bits)."""
    rng = np.random.default_rng(seed)
    bits = _bits(rng, _N, nbits, 0.08)
    bits[7] = bits[3]  # an exact duplicate
    bits[9] = 0  # a zero row
    words = np.zeros((_N + 1, -(-nbits // 32)), np.uint32)
    words[:_N] = jbits.pack_bits(bits)
    trav = rng.random(_N + 1) > 0.05
    trav[_N] = False
    tid = np.ones(_N + 1, np.int32)
    tid[rng.random(_N + 1) < 0.02] = 0
    g = jdev.DeviceGraph(
        kind="bit", metric=metric, cap=_N, m=8, entry=0, entry_level=0,
        neighbors0=jnp.full((_N + 1, 16), -1, jnp.int32),
        upper_neighbors=jnp.full((1, 8), -1, jnp.int32),
        upper_slot=jnp.full(_N + 1, -1, jnp.int32),
        levels=jnp.zeros(_N + 1, jnp.int32),
        traversable=jnp.asarray(trav), emit_tid=jnp.arange(_N + 1,
                                                           dtype=jnp.int32),
        tid_count=jnp.asarray(tid), words=jnp.asarray(words))
    return g, words, trav & (tid > 0), rng


def _port_sweep(words, live, q, k, metric, mask=None):
    w = tbits.as_words(words)
    lv = torch.from_numpy(live if mask is None else live & mask)
    return tbits._bits_topk_plain(w, tbits.row_popcount(w), lv,
                                  tbits.as_words(q), k, metric)


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("b", [8, 48])
@pytest.mark.parametrize("masked", [False, True])
def test_k9_plain_equals_exact_search_bits(metric, b, masked):
    g, words, live, rng = _graph(metric)
    q = words[rng.integers(0, _N, b)]  # rows of the corpus: exact ties
    q[1] = 0
    mask = rng.random(_N + 1) < 0.6 if masked else None
    jd, ji = jdev._exact_search_bits(
        g, jnp.asarray(q), 10,
        row_mask=None if mask is None else jnp.asarray(mask))
    td, ti = _port_sweep(words, live, q, 10, metric, mask)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))


@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nbits", [64, 288])
@pytest.mark.parametrize("masked", [False, True])
def test_k9_plain_mm_equals_plain_and_jax_mxu(metric, nbits, masked):
    """The tensor-core form's plain version (JAX's MXU branch) against the
    popcount form's, key for key, and against ``_exact_search_bits`` at
    B = 48 (JAX's MXU branch): 2 and 9 words per row (not a multiple of
    4), dead rows, a row mask, k = 10 and k = 100 (the kernel's rounds)."""
    g, words, live, rng = _graph(metric, seed=nbits, nbits=nbits)
    q = words[rng.integers(0, _N, 48)]
    q[1] = 0
    mask = rng.random(_N + 1) < 0.6 if masked else None
    lv = torch.from_numpy(live if mask is None else live & mask)
    w, qw = tbits.as_words(words), tbits.as_words(q)
    for k in (10, 100):
        md, mi = tbits._bits_topk_plain_mm(w, None, lv, qw, k, metric)
        pd, pi = tbits._bits_topk_plain(w, tbits.row_popcount(w), lv, qw, k,
                                        metric)
        assert torch.equal(tbf._order_keys(md, mi), tbf._order_keys(pd, pi))
        jd, ji = jdev._exact_search_bits(
            g, jnp.asarray(q), k,
            row_mask=None if mask is None else jnp.asarray(mask))
        np.testing.assert_array_equal(md.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(mi.numpy(), np.asarray(ji))
    # bits_topk on the CPU takes the form's plain version at B = 48
    bd, bi = tbits.bits_topk(w, tbits.row_popcount(w), lv, qw, 10, metric)
    md, mi = tbits._bits_topk_plain_mm(w, None, lv, qw, 10, metric)
    assert torch.equal(bd, md) and torch.equal(bi, mi)


@pytest.mark.parametrize("b", [1, 31, 32, 4096])
def test_k9_form_is_the_jax_rule(b):
    """``_k9_form`` picks the tensor-core form exactly where JAX's
    ``_exact_search_bits`` takes its matmul (``mxu = B >= 32``), read from
    the traced program: a ``dot_general`` appears at those B only."""
    import jax

    g, words, _, _ = _graph("hamming", seed=3)
    jaxpr = jax.make_jaxpr(lambda q: jdev._exact_search_bits(g, q, 10))(
        jax.ShapeDtypeStruct((b, words.shape[1]), jnp.uint32))
    mxu = "dot_general" in str(jaxpr)
    assert mxu == (b >= 32)
    assert tbits._k9_form(b) == ("k9_bits_tc" if mxu else "k9_bits")


@pytest.mark.parametrize("metric", METRICS)
def test_k9_plain_blocks_and_the_tail(metric, monkeypatch):
    """Blocks smaller than the corpus merge to the same keys; fewer live
    rows than k leave (inf, -1) past them."""
    g, words, live, rng = _graph(metric, seed=2)
    q = words[:5]
    d1, i1 = _port_sweep(words, live, q, 30, metric)
    monkeypatch.setattr(tbits, "_PLAIN_ELEMS", 5 * 3 * 97)
    d2, i2 = _port_sweep(words, live, q, 30, metric)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    few = np.zeros_like(live)
    few[[4, 40, 400]] = True
    d, i = _port_sweep(words, few, q, 6, metric)
    assert set(i[:, :3].flatten().tolist()) <= {4, 40, 400}
    assert (i[:, 3:] == -1).all() and torch.isinf(d[:, 3:]).all()


@pytest.mark.parametrize("metric", METRICS)
def test_k100_in_rounds_equals_jax(metric):
    """k = 100: the plain version at once, and the kernel's round loop
    (``_in_rounds``, fed by a round that takes the kr smallest keys at or
    after ``lo`` from the plain keys) both equal JAX's top-100."""
    g, words, live, rng = _graph(metric, seed=4)
    q = words[rng.integers(0, _N, 6)]
    jd, ji = jdev._exact_search_bits(g, jnp.asarray(q), 100)
    td, ti = _port_sweep(words, live, q, 100, metric)
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))

    ad, ai = _port_sweep(words, live, q, _N + 1, metric)
    all_keys = tbf._order_keys(ad, ai)
    all_keys = torch.where(ai >= 0, all_keys, -1)
    calls = []

    def one_round(kr, lo):
        calls.append(kr)
        ok = (all_keys >= 0) if lo is None else (
            (all_keys >= lo[:, None]) & (lo >= 0)[:, None])
        keys = torch.where(ok, all_keys, torch.iinfo(torch.int64).max)
        keys = torch.sort(keys, dim=1).values[:, :kr]
        return torch.where(keys == torch.iinfo(torch.int64).max, -1, keys)

    rd, ri = tbf._from_order_keys(tbits._in_rounds(one_round, 100))
    assert calls == [64, 36]
    np.testing.assert_array_equal(rd.numpy(), np.asarray(jd))
    np.testing.assert_array_equal(ri.numpy(), np.asarray(ji))


def test_bits_topk_takes_the_plain_version_on_the_cpu():
    g, words, live, rng = _graph("hamming", seed=6)
    w = tbits.as_words(words)
    before = dict(tbf.LAUNCHES)
    d, i = tbits.bits_topk(w, None, torch.from_numpy(live),
                           tbits.as_words(words[:3]), 5, "hamming")
    assert tbf.LAUNCHES == before
    assert (d[:, 0].numpy()[live[:3]] == 0).all()
    with pytest.raises(ValueError, match="unknown bit metric"):
        tbits.bits_topk(w, None, torch.from_numpy(live), w[:1], 5, "l2")


# ---------------------------------------------------------------------------
# card-only: the kernels against their plain versions
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("nbits,n,b,k", [
    (256, 20_000, 100, 10), (72, 5_000, 33, 64), (256, 3_000, 7, 150),
    (3000, 2_000, 20, 10), (64_000, 300, 9, 5), (32, 50, 70, 64)])
def test_k9_kernel_matches_plain(cuda, metric, nbits, n, b, k):
    """Equal distances and ids, tie order included (few set bits make
    ties common); W = 3 words takes the scalar loads, 2,000 words the
    smallest query tile; k = 150 runs three rounds, and k past the live
    rows leaves (inf, -1)."""
    rng = np.random.default_rng(nbits + n)
    words = tbits.as_words(tbits.pack_bits(_bits(rng, n, nbits, 0.05)), cuda)
    live = torch.from_numpy(rng.random(n) > 0.1).to(cuda)
    q = tbits.as_words(tbits.pack_bits(_bits(rng, b, nbits, 0.05)), cuda)
    pop = tbits.row_popcount(words)
    form = tbits._k9_form(b)
    before = tbf.LAUNCHES[form]
    kd, ki = tbits.bits_topk(words, pop, live, q, k, metric)
    assert tbf.LAUNCHES[form] == before + -(-k // 64)
    pd, pi = tbits._bits_topk_plain(words, pop, live, q, k, metric)
    np.testing.assert_array_equal(kd.cpu().numpy(), pd.cpu().numpy())
    np.testing.assert_array_equal(ki.cpu().numpy(), pi.cpu().numpy())


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("w,n,b,k", [
    (1, 1_000, 32, 1), (2, 5_001, 33, 10), (8, 20_000, 1024, 10),
    (9, 3_001, 64, 64), (32, 2_500, 100, 100), (8, 130, 40, 64),
    (64, 777, 33, 10)])
def test_k9_tensor_form_matches_plain(cuda, metric, w, n, b, k):
    """The tensor-core form against both plain versions, key for key (few
    set bits: ties everywhere), and a control that orders ties by the
    higher row must not pass: w = 1, 2, 9 words take 4-byte copies, 64
    words stream the queries beside the corpus; n not a multiple of the
    128-row chunk, 10% dead rows, k = 100 in two rounds."""
    rng = np.random.default_rng(w * 7 + n)
    words = tbits.as_words(tbits.pack_bits(_bits(rng, n, 32 * w, 0.05)), cuda)
    live = torch.from_numpy(rng.random(n) > 0.1).to(cuda)
    q = tbits.as_words(tbits.pack_bits(_bits(rng, b, 32 * w, 0.05)), cuda)
    pop = tbits.row_popcount(words)
    assert tbits._k9_form(b) == "k9_bits_tc"
    before = dict(tbf.LAUNCHES)
    kd, ki = tbits.bits_topk(words, pop, live, q, k, metric)
    torch.cuda.synchronize()
    assert tbf.LAUNCHES["k9_bits_tc"] == before["k9_bits_tc"] + -(-k // 64)
    assert tbf.LAUNCHES["k9_bits"] == before["k9_bits"]
    keys = tbf._order_keys(kd, ki)
    for plain in (tbits._bits_topk_plain, tbits._bits_topk_plain_mm):
        pd, pi = plain(words, pop, live, q, k, metric)
        assert torch.equal(keys, tbf._order_keys(pd, pi)), plain.__name__
    cd, ci = tbits._bits_topk_plain(words.flip(0), pop.flip(0), live.flip(0),
                                    q, k, metric)
    ci = torch.where(ci >= 0, n - 1 - ci, -1)
    assert not torch.equal(keys, tbf._order_keys(cd, ci))


@pytest.mark.cuda
def test_k9_refuses_what_it_does_not_take(cuda):
    w = torch.zeros((10, 8), dtype=torch.int32, device=cuda)
    live = torch.ones(10, dtype=torch.bool, device=cuda)
    with pytest.raises(ValueError, match="queries"):
        tbits.bits_topk(w, None, live, w[:2].float(), 5, "hamming")
    with pytest.raises(ValueError, match="pop"):
        tbits.bits_topk(w, None, live, w[:2], 5, "jaccard")
    with pytest.raises(ValueError, match="shape mismatch"):
        tbits.bits_topk(w, None, live, w[:2, :4].contiguous(), 5, "hamming")


def _word_case(cuda, w, n=2000, m=8, seed=0):
    """Random graph tensors on the card with packed-word rows: few set
    bits (ties everywhere), -1 and pad (n) neighbour ids, 10% dead rows,
    the sentinel row n dead."""
    rng = np.random.default_rng(seed)
    words = tbits.as_words(tbits.pack_bits(_bits(rng, n + 1, 32 * w, 0.1)),
                           cuda)
    nb = rng.integers(0, n, (n + 1, 2 * m)).astype(np.int32)
    nb[rng.random(nb.shape) < 0.05] = -1
    nb[rng.random(nb.shape) < 0.02] = n
    nb[n] = -1
    trav = rng.random(n + 1) >= 0.1
    trav[n] = False
    q = tbits.as_words(tbits.pack_bits(_bits(rng, 24, 32 * w, 0.1)), cuda)
    return words, torch.from_numpy(nb).to(cuda), \
        torch.from_numpy(trav).to(cuda), q, rng


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("w", [8, 3, 32, 40])
def test_walk_kernel_word_mode_descends_in_its_launch(cuda, metric, w):
    """Packed words (the warp form at 3, 8 and 32 words, the block form at
    40): the descent in K4's launch lands where the plain descent lands
    (the same id and distance), and the walk from there equals the plain
    walk; the check rejects the walk cut to ef / 4 steps."""
    from test_torch_scan import _upper_case, assert_descent_walk_matches_plain

    words, nb, trav, q, rng = _word_case(cuda, w)
    upper = _upper_case(rng, 2000, 8, cuda)
    assert assert_descent_walk_matches_plain(words, nb, trav, upper, 8,
                                             metric, q) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("metric", METRICS)
@pytest.mark.parametrize("w", [8, 3, 40])
def test_walk_kernel_word_mode_matches_plain(cuda, metric, w):
    """The walk's packed-word mode against the plain walk: every output
    equal (distances are exact, and both order ties by key), steps and
    rows scored included."""
    words, nb, trav, q, rng = _word_case(cuda, w)
    pool = np.flatnonzero(trav.cpu().numpy()[:2000])
    ids = torch.from_numpy(np.stack([rng.choice(pool, 8, replace=False)
                                     for _ in range(24)]).astype(np.int32))
    ids = ids.to(cuda)
    ids[:, -2:] = -1
    d = tbeam.row_dists(words, metric, q, ids)
    d = torch.where(ids >= 0, d, float("inf"))
    perm = tbeam.lexsort2(d, ids)
    ids, d = torch.gather(ids, 1, perm), torch.gather(d, 1, perm)
    before = tbf.LAUNCHES["k4_beam"]
    out = tbeam.beam_walk(words, nb, trav, metric, q, ids, d, 40, 192)
    assert tbf.LAUNCHES["k4_beam"] == before + 1
    args = (words, nb, trav, None, metric, q, ids, d, 40, 0, 192, False)
    k_raw = tbeam._walk_cuda(*args)
    p_raw = tbeam._walk_plain(*args)
    for a, b in zip(out, tbeam._serve_finish(*p_raw)):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    for a, b in zip(k_raw, p_raw):
        np.testing.assert_array_equal(a.cpu().numpy(), b.cpu().numpy())
    assert int(p_raw[4].min()) > 1
    with pytest.raises(ValueError, match="scan mode"):
        tbeam.beam_scan_segment(words, nb, trav, torch.zeros_like(
            trav)[None].expand(24, -1).contiguous(), metric, q, ids, d, 40,
            40, 8, 192)
