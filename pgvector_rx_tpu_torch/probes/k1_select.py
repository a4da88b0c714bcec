"""Timing of K1 at one query and any k (``DeviceScan``'s shape), at many
queries and k = 100, and of K7 at one query and in 1,024-query chunks.

    python -m pgvector_rx_tpu_torch.probes.k1_select [--b-large 1024]
    PYTHONPATH=DIR python pgvector_rx_tpu_torch/probes/k1_select.py

The second form times another checkout's package (``DIR`` holds its
``pgvector_rx_tpu_torch``, e.g. ``git archive PARENT | tar -x -C DIR``):
the probe calls only what every version of the port has
(``_surrogate_topk``, its plain version, ``coarse_topk``), plus K1's two
forms side by side where ``_select_topk_cuda`` exists.

Needs one NVIDIA Hopper card and ``nvcc``. Where the whole kernel library
is not built yet, it builds only the sources it times (``k1_topk.cu``,
``k1_select.cu`` where present, ``k7_coarse.cu``) into
``pgvector_rx_tpu_torch/_build/``. Data: ``make_dataset(1,065,536,
128, 1,024, seed=0)``, the rows of the smoke's grown graph (phase 11),
every row live (``a`` = the squared row norms). Every figure is the mean
device time of 10 calls after a warm one (CUDA events around the calls,
so a call's host time counts where it exceeds its kernels'):

- K1 through ``_surrogate_topk`` at one query, k = 10, 40, 60, 160, 640,
  2,560 (``DeviceScan``'s blocks are 40-2,560), its launches per call,
  its plain version, and the library composition ``a - 2 (q @ x.T)`` then
  ``torch.topk(k, dim=1, largest=False)``; bound: the larger of the rows
  and ``a`` once over 3.35 TB/s and the product's 3xTF32 operations
  (three TF32 products, as K1's tensor-core form computes it) over 495
  TFLOP/s;
- K1 at ``--b-large`` queries and k = 100 (the parent's rounds: one
  query at a time, two sweeps each), the same three;
- where the select form exists: both forms at k in ``--forms-k`` (10, 40,
  60) and B = 1 ... 256, over these rows and over a compact store's
  chunk (262,144 x 1,024-d random f16 rows): the crossover that routes
  small B to the select form; the select form at ``--b-large`` x k = 100
  under key budgets of 64-512 MiB and with the passes' former grid, ms
  and peak memory above the inputs, and the routed call's peak at 32 x
  10 and ``--b-large`` x 100; with ``--k1s-other FILE``, the select form
  against FILE's (another ``k1_select.cu`` with the same C entry, run
  with one pass block a sweep block) in turns at 1 x 2,560 and
  ``--b-large`` x 100;
- K7 (``coarse_topk``) on 62,494 random upper rows (15% not
  traversable), S = 8, at 128-d and 768-d, one query and 1,024 queries,
  through its wrapper; at one query also its C entry alone and the kernel
  alone (20 calls in a CUDA graph, replayed); with ``--k7-other FILE``,
  its batch form against FILE's (another ``k7_coarse.cu``) in turns
  (``--skip-k7`` leaves K7 out).

The last line is one JSON object with every figure.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.ops import bruteforce as bf

N, D = 1_065_536, 128
KS = (10, 40, 60, 160, 640, 2560)
U7, B7, S7 = 62_494, 1024, 8
PEAK_BYTES, PEAK_TF32 = 3.35e12, 495e12
#: the key budgets timed at ``--b-large`` queries x k = 100 (MiB)
BUDGETS = (64, 128, 256, 512)


def _only(names) -> None:
    """Build just these sources (those this checkout has) and bind just
    their entry points."""
    keep = [u for u in _build._UNITS if u[0].name in names
            and u[0].exists()]
    _build._UNITS = tuple(keep)
    _build._SOURCES = tuple(u[0] for u in keep)
    prefixes = tuple(f"pgv_{n.split('_')[0]}_" for n in names)
    _build._SIGNATURES = {k: v for k, v in _build._SIGNATURES.items()
                          if k.startswith(prefixes)}


def ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def launches(fn) -> dict:
    before = dict(bf.LAUNCHES)
    fn()
    torch.cuda.synchronize()
    return {k: v - before.get(k, 0) for k, v in bf.LAUNCHES.items()
            if v != before.get(k, 0)}


def agree(kd, ki, pd, pi, tol) -> int:
    """Queries whose kernel list differs from the plain one other than
    by a distance within ``tol`` (ties and rounding at the cut)."""
    kd, ki, pd, pi = (t.cpu().numpy() for t in (kd, ki, pd, pi))
    bad = 0
    for r in range(kd.shape[0]):
        fin = np.isfinite(pd[r])
        if not np.allclose(kd[r][fin], pd[r][fin], rtol=1e-5, atol=tol):
            bad += 1
            continue
        cut = pd[r][fin].max() if fin.any() else np.inf
        inner = pd[r] < cut - tol
        if set(pi[r][inner]) - set(ki[r]):
            bad += 1
    return bad


def k1_figures(x, a, q, k: int) -> dict:
    b = q.shape[0]
    run = lambda: bf._surrogate_topk(x, a, q, k)  # noqa: E731
    out = dict(b=b, k=k, launches=launches(run), ms=ms(run))
    out["plain_ms"] = ms(lambda: bf._surrogate_topk_plain(x, a, q, k))
    out["library_ms"] = ms(lambda: torch.topk(
        a[None] - 2.0 * (q @ x.T), k, dim=1, largest=False))
    nbytes = x.numel() * 4 + a.numel() * 4 + q.numel() * 4 + b * k * 8
    # the f32 product as K1's tensor-core form computes it: 3xTF32
    out["bound_ms"] = max(nbytes / PEAK_BYTES,
                          3 * 2.0 * b * x.numel() / PEAK_TF32) * 1e3
    kd, ki = bf._surrogate_topk(x, a, q, k)
    pd, pi = bf._invalid_to_sentinel(*bf._surrogate_topk_plain(x, a, q, k))
    q2max = float((q * q).sum(1).max())
    out["queries_off_plain"] = agree(kd, ki, pd, pi, 1e-5 * q2max)
    return out


def k7_figures(d: int) -> list:
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(0)
    rows = torch.randn(U7, d, device=dev, generator=g).to(torch.bfloat16)
    q = torch.randn(B7, d, device=dev, generator=g)
    ids = torch.arange(U7, device=dev)
    trav = torch.rand(U7 + 1, device=dev, generator=g) < 0.85
    rf = rows.float()
    a = (rf * rf).sum(1).contiguous()
    res = []
    for nq in (1, B7):
        qq = q[:nq].contiguous()
        run = lambda: bf.coarse_topk(rows, a, ids, trav, qq, S7, True)  # noqa
        want, _ = bf._coarse_plain(rows, a, ids, trav, qq, S7, True)
        got, _ = run()
        same = float((torch.sort(got, 1).values == torch.sort(
            want, 1).values).all(1).float().mean())
        nbytes = U7 * d * 2 + U7 * 4 + U7 * 8 + nq * d * 2
        extra = {}
        if nq == 1 and hasattr(bf, "_coarse_one_cuda"):
            extra = k7_one_split(rows, a, ids, trav, qq)
        res.append(dict(d=d, b=nq, ms=ms(run), launches=launches(run),
                        **extra,
                        plain_ms=ms(lambda: bf._coarse_plain(
                            rows, a, ids, trav, qq, S7, True)),
                        bound_ms=max(nbytes / PEAK_BYTES,
                                     2.0 * nq * U7 * d / 989e12) * 1e3,
                        seeds_equal=same))
    return res


def k7_one_split(rows, a, ids, trav, q) -> dict:
    """K7's one-query form: its C entry called alone (arguments made once),
    and the kernel alone (20 calls captured in a CUDA graph, replayed)."""
    dev = rows.device
    n, d = rows.shape
    lanes, blocks = bf._k7_one_grid(n, d, 3 * bf._sm_count(dev))
    part = torch.empty(blocks * S7, dtype=torch.int64, device=dev)
    ticket = torch.zeros(1, dtype=torch.int32, device=dev)
    out = torch.empty((2, S7), dtype=torch.int64, device=dev)
    lib = _build.lib()

    def entry():
        _build.check(lib.pgv_k7_coarse_one(
            rows.data_ptr(), a.data_ptr(), ids.data_ptr(), trav.data_ptr(),
            q.data_ptr(), n, d, S7, 1, lanes, blocks, part.data_ptr(),
            ticket.data_ptr(), out.data_ptr(), out[1].data_ptr(),
            torch._C._cuda_getCurrentRawStream(dev.index)),
            "pgv_k7_coarse_one")

    c_ms = ms(entry)
    # host time a call: the wrapper, and the C entry alone (no sync inside)
    host = {}
    for name, fn in (("wrapper_host_us", lambda: bf.coarse_topk(
            rows, a, ids, trav, q, S7, True)), ("c_entry_host_us", entry)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(200):
            fn()
        host[name] = (time.perf_counter() - t0) / 200 * 1e6
        torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(20):
            entry()
    return dict(c_entry_ms=c_ms, kernel_ms=ms(graph.replay) / 20,
                lanes=lanes, blocks=blocks, **host)


def k7_turns(other: str, dims) -> list:
    """K7's batch form at 1,024 queries against another ``k7_coarse.cu``
    (e.g. the parent's, whose blocks are 64 queries x 64-row chunks at two
    blocks an SM), each at its own grid, in turns: other, this, this,
    other; the seeds of both checked against the plain version."""
    import ctypes

    out_dir = _build.BUILD_DIR / "k1_select_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "k7_other.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                      str(_build._CSRC), "-o", str(so), other]])
    libs = {"other": ctypes.CDLL(str(so)), "this": _build.lib()}
    fn = libs["other"].pgv_k7_coarse_topk
    fn.argtypes = _build._SIGNATURES["pgv_k7_coarse_topk"]
    fn.restype = ctypes.c_int
    plans = {"other": (64, 64, 2), "this": (bf._K7_QTILE, bf._K7_CHUNK, 1)}
    res = []
    for d in dims:
        dev = torch.device("cuda")
        g = torch.Generator(device=dev).manual_seed(0)
        rows = torch.randn(U7, d, device=dev, generator=g).to(torch.bfloat16)
        q = torch.randn(B7, d, device=dev, generator=g)
        ids = torch.arange(U7, device=dev)
        trav = torch.rand(U7 + 1, device=dev, generator=g) < 0.85
        rf = rows.float()
        a = (rf * rf).sum(1).contiguous()
        qb = q.to(torch.bfloat16).contiguous()
        want, _ = bf._coarse_plain(rows, a, ids, trav, q, S7, True)
        runs = {}
        for name, (qt, ch, per_sm) in plans.items():
            _, splits, rps = bf._k1_plan(U7, B7, per_sm * bf._sm_count(dev),
                                         qt, ch)
            part = torch.empty((B7, splits, 2, S7), dtype=torch.int64,
                               device=dev)
            slot = torch.empty((B7, S7), dtype=torch.int64, device=dev)
            oid = torch.empty((B7, S7), dtype=torch.int64, device=dev)
            lib = libs[name]

            def run(lib=lib, splits=splits, rps=rps, part=part, slot=slot,
                    oid=oid):
                _build.check(lib.pgv_k7_coarse_topk(
                    rows.data_ptr(), a.data_ptr(), ids.data_ptr(),
                    trav.data_ptr(), qb.data_ptr(), U7, d, B7, S7, 1, splits,
                    rps, part.data_ptr(), slot.data_ptr(), oid.data_ptr(),
                    torch.cuda.current_stream().cuda_stream), name)
                return slot
            runs[name] = run
        times = {"other": [], "this": []}
        for name in ("other", "this", "this", "other"):
            times[name].append(ms(runs[name]))
        same = {n: float((torch.sort(r(), 1).values == torch.sort(
            want, 1).values).all(1).float().mean()) for n, r in runs.items()}
        res.append(dict(d=d, b=B7, times=times, seeds_equal=same))
        print(f"K7 turns d={d}: {res[-1]}", flush=True)
    return res


def forms(x, a, q, ks, bs) -> list:
    """K1's two forms side by side, each through its wrapper, at k in
    ``ks`` and B in ``bs`` (the crossover that routes small B to the
    select form)."""
    res = []
    for k in ks:
        for b in bs:
            qb = q[:b].contiguous()
            f = dict(dtype=str(x.dtype), n=x.shape[0], d=x.shape[1], b=b,
                     k=k,
                     tc_ms=ms(lambda: bf._surrogate_topk_cuda(x, a, qb, k)),
                     select_ms=ms(lambda: bf._select_topk_cuda(x, a, qb,
                                                               k)))
            res.append(f)
            print(f"K1 forms: {f}", flush=True)
    return res


def peak_mib(fn) -> float:
    """Device memory a call allocates above what was allocated before it,
    at its peak (MiB)."""
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    fn()
    torch.cuda.synchronize()
    return (torch.cuda.max_memory_allocated() - base) / 2**20


def budgets(x, a, q, k: int) -> list:
    """The select form at q's queries and k under each key budget in
    ``BUDGETS``, and under the largest with the passes' former grid (one
    pass block a sweep block, ``_K1S_PASS_SPREAD`` = 1): ms and peak
    memory above the inputs."""
    res = []
    keep = bf._K1S_BUDGET, bf._K1S_PASS_SPREAD
    try:
        for mib, spread in [(m, keep[1]) for m in BUDGETS] + [
                (BUDGETS[-1], 1)]:
            bf._K1S_BUDGET, bf._K1S_PASS_SPREAD = mib << 20, spread
            run = lambda: bf._select_topk_cuda(x, a, q, k)  # noqa: E731
            r = dict(b=q.shape[0], k=k, budget_mib=mib, pass_spread=spread,
                     chunks=len(bf._k1s_plan(x.shape[0], q.shape[0])),
                     peak_mib=peak_mib(run), ms=ms(run, 3))
            res.append(r)
            print(f"K1 select by budget: {r}", flush=True)
    finally:
        bf._K1S_BUDGET, bf._K1S_PASS_SPREAD = keep
    for b, kk in ((32, 10), (q.shape[0], k)):
        qq = q[:b].contiguous()
        r = dict(b=b, k=kk, routed_peak_mib=peak_mib(
            lambda: bf._surrogate_topk(x, a, qq, kk)),
            routed_launches=launches(lambda: bf._surrogate_topk(x, a, qq,
                                                                kk)))
        res.append(r)
        print(f"K1 routed peak: {r}", flush=True)
    return res


def k1s_turns(other: str, x, a, q, cases) -> list:
    """K1's select form against another ``k1_select.cu`` with the same C
    entry (e.g. the parent's, with its passes' grid: ``_K1S_PASS_SPREAD``
    = 1), both through this wrapper, in turns: other, this, this, other;
    both lists checked against the plain version."""
    import ctypes

    out_dir = _build.BUILD_DIR / "k1_select_probe"
    out_dir.mkdir(parents=True, exist_ok=True)
    so = out_dir / "k1s_other.so"
    _build._run_all([[_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                      str(_build._CSRC), "-o", str(so), other]])
    olib = ctypes.CDLL(str(so))
    fn = olib.pgv_k1_select_topk
    fn.argtypes = _build._SIGNATURES["pgv_k1_select_topk"]
    fn.restype = ctypes.c_int
    this_lib, spread = _build.lib, bf._K1S_PASS_SPREAD
    res = []
    for b, k in cases:
        qb = q[:b].contiguous()
        pd, pi = bf._invalid_to_sentinel(*bf._surrogate_topk_plain(x, a, qb,
                                                                   k))
        q2max = float((qb * qb).sum(1).max())
        times, off = {"other": [], "this": []}, {}
        for name in ("other", "this", "this", "other"):
            try:
                if name == "other":
                    _build.lib, bf._K1S_PASS_SPREAD = (lambda: olib), 1
                kd, ki = bf._invalid_to_sentinel(*bf._select_topk_cuda(
                    x, a, qb, k))
                off[name] = agree(kd, ki, pd, pi, 1e-5 * q2max)
                times[name].append(ms(lambda: bf._select_topk_cuda(
                    x, a, qb, k), 3 if b > 1 else 10))
            finally:
                _build.lib, bf._K1S_PASS_SPREAD = this_lib, spread
        res.append(dict(b=b, k=k, times=times, queries_off_plain=off))
        print(f"K1 select turns: {res[-1]}", flush=True)
    return res


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("k1_select needs a CUDA GPU; none is visible")
    ap = argparse.ArgumentParser()
    ap.add_argument("--b-large", type=int, default=1024)
    ap.add_argument("--dims", default="128,768")
    ap.add_argument("--k7-other", default=None,
                    help="another k7_coarse.cu to time in turns with this")
    ap.add_argument("--k1s-other", default=None,
                    help="another k1_select.cu to time in turns with this")
    ap.add_argument("--forms-k", default="10,40,60",
                    help="the k at which both K1 forms are timed by B")
    ap.add_argument("--skip-k7", action="store_true")
    args = ap.parse_args()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    if not _build.library_path().exists():  # else the smoke built them all
        _only(("k1_topk.cu", "k1_select.cu", "k7_coarse.cu"))
    _build.lib()
    torch.backends.cuda.matmul.allow_tf32 = False
    data, queries = make_dataset(N, D, 1024, seed=0)
    dev = torch.device("cuda")
    x = torch.from_numpy(data).to(dev)
    q = torch.from_numpy(queries).to(dev)
    del data
    a = (x * x).sum(1).contiguous()
    out = {"device": smi, "one_query": [], "large": None, "forms": [],
           "k7": []}
    for k in KS:
        r = k1_figures(x, a, q[:1].contiguous(), k)
        out["one_query"].append(r)
        print(f"K1 one query k={k}: {r}", flush=True)
    r = k1_figures(x, a, q[: args.b_large].contiguous(), 100)
    out["large"] = r
    print(f"K1 {args.b_large} queries k=100: {r}", flush=True)
    if hasattr(bf, "_select_topk_cuda"):
        bs = (1, 2, 4, 8, 16, 32, 64, 128, 256)
        ks = tuple(map(int, args.forms_k.split(",")))
        out["forms"] = forms(x, a, q, ks, bs)
        out["budgets"] = budgets(x, a, q[: args.b_large].contiguous(), 100)
        if args.k1s_other:
            out["k1s_turns"] = k1s_turns(args.k1s_other, x, a, q,
                                         ((1, 2560), (args.b_large, 100)))
        del x, a
        # a compact store's chunk: 262,144 x 1,024-d f16 (phase 26's)
        g = torch.Generator(device=dev).manual_seed(1)
        x16 = torch.randn(1 << 18, 1024, device=dev, generator=g).half()
        a16 = (x16.float() ** 2).sum(1)
        q16 = torch.randn(256, 1024, device=dev, generator=g)
        out["forms"] += forms(x16, a16, q16, ks, bs)
        del x16, a16, q16
    else:
        del x, a
    del q
    for d in ([] if args.skip_k7 else map(int, args.dims.split(","))):
        for r in k7_figures(d):
            out["k7"].append(r)
            print(f"K7: {r}", flush=True)
    if args.k7_other:
        out["k7_turns"] = k7_turns(args.k7_other,
                                   map(int, args.dims.split(",")))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
