"""Timing experiment: K1 and K2 over a compact (f16 / bf16) store's chunk.

    python -m pgvector_rx_tpu_torch.probes.k12_compact --split
    python -m pgvector_rx_tpu_torch.probes.k12_compact --parent DIR
    python -m pgvector_rx_tpu_torch.probes.k12_compact --cutout
    python -m pgvector_rx_tpu_torch.probes.k12_compact --variants FILE...

Needs one NVIDIA Hopper card and ``nvcc``. The shape is the halfvec
path's chunk (``chip_smoke.py`` phase 26): 1,024 queries x 262,144 rows x
1,024-d, k = 10, tn = 1,024, rows and queries from ``make_dataset(262,144,
1,024, 1,024, seed=6, intrinsic=32)`` stored as f16 (and as bf16). Every
time is the mean of 10 launches after a warm one (CUDA events).

``--split`` (where the old route's time goes; patched copies of a
``csrc/`` directory, ``--src``, the package's by default, built side by
side under ``pgvector_rx_tpu_torch/_build/k12_compact/``):

- K1 and K2 as built, each with and without the cast of the chunk that the
  old route made first (``.float()`` for K1, ``.to(torch.bfloat16)`` for
  K2 on the f16 store);
- K1 with its ``qbig . xsml`` product cut out (zeros on these rows: a
  tf32 holds every f16 or bf16 value, so the corpus's small half is 0);
- the cost of streaming the queries: K1 at d = 352 (its last width with
  the query tile resident at k = 10) against d = 384 (its first streamed
  width), K2 at d = 768 against d = 832, the same rows and queries cut to
  the width, each as ms per TFLOP of its products (3 tf32 products for
  K1, 1 bf16 product for K2).

``--parent DIR`` (the redesign against the old route, in turns, 3 turns):
``DIR`` holds the parent's ``csrc/`` (e.g. ``git archive PARENT
pgvector_rx_tpu_torch/csrc``); its library is built beside this
checkout's. Each store (f16, bf16) times the old route (the cast plus the
parent's kernel) and the new mode (the kernel over the stored rows), K1
and K2, and checks that the two return the same ids but for ties. Then a
``cuobjdump -sass`` comparison: each kernel of the parent's K1 / K2 units
whose machine code this checkout keeps (matched by code, since the
rescoring is now a template): the f32-row K1, the rescoring, the
selections and the resident bf16 K2 of the main path and phase 18 must be
among them; the parent's streamed bf16 K2 is replaced.

``--cutout`` (where the 2-byte mode's time goes): patched copies of this
checkout's ``csrc/k1_topk.cu`` timed on the f16 chunk in turns, twice:
as built; without the widening (the f32 buffers keep stale rows); without
the copies after the first units; without the epilogue; without the
wgmma (the products skipped); the products alone (no copies, widening or
epilogue), with and without the block barrier that ends each unit.

``--variants FILE...`` (other forms of the 2-byte modes): each file is a
whole ``k1_topk.cu`` (its name starting with ``k1``) or ``k2_binned.cu``
(``k2``), built beside this checkout's and timed against it in turns,
twice, on the f16 chunk, with the share of ids equal to this checkout's.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from pgvector_rx_tpu_torch.data import make_dataset
from pgvector_rx_tpu_torch.ops import _build
from pgvector_rx_tpu_torch.ops import bruteforce as bf

N, D, B, K, TN = 262_144, 1024, 1024, 10, 1024
OUT = _build.BUILD_DIR / "k12_compact"
_XSML = "      wgmma_tf32_m64n64k8(acc, qbig, xsml, 1);\n"


def _ms(fn, iters: int = 10) -> float:
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


def _compile(jobs: dict) -> dict:
    """name -> (source text, include directory) built side by side into
    shared libraries under OUT (ptxas's register and spill report of each
    printed); returns name -> loaded CDLL."""
    OUT.mkdir(parents=True, exist_ok=True)
    paths, procs = {}, []
    # a name of its own for each build: dlopen returns a library already
    # loaded from the same path
    tag = len(list(OUT.glob("*.so")))
    for i, (name, (text, inc)) in enumerate(jobs.items()):
        cu, so = OUT / f"v{tag + i}.cu", OUT / f"v{tag + i}.so"
        cu.write_text(text)
        paths[name] = so
        procs.append(subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-Xptxas", "-v", "-shared",
             "-I", str(inc), "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    t0 = time.time()
    for name, p in zip(jobs, procs):
        _, err = p.communicate()
        print(f"built {name} in {time.time() - t0:.1f} s", flush=True)
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        fn = None
        for line in err.splitlines():
            m = re.search(r"Compiling entry function '(\S+)'", line)
            if m:
                fn = m.group(1)
            elif fn and ("k1c_" in fn or "k2s_" in fn) and (
                    "registers" in line or "spill" in line
                    or "wgmma" in line):
                print(f"ptxas {name} {fn}: {line.strip()}", flush=True)
            elif "wgmma" in line and "serialized" in line:
                print(f"ptxas {name}: {line.strip()}", flush=True)
    libs = {}
    for name, so in paths.items():
        lib = ctypes.CDLL(str(so))
        for fn in ("pgv_k1_surrogate_topk", "pgv_k2_binned_topk"):
            if hasattr(lib, fn):
                getattr(lib, fn).restype = ctypes.c_int
        libs[name] = lib
    return libs


def _k1_call(lib, x, a, q, new=False):
    """K1 through ``lib``'s entry: the parent's signature (f32 rows), or
    this checkout's (``new``: the row dtype's code after ``base``)."""
    n, d = x.shape
    b = q.shape[0]
    if x.dtype == torch.float32:
        _, splits, rps = bf._k1_plan(n, b, bf._block_target(x.device))
    else:
        _, splits, rps = bf._k1_plan(n, b, bf._sm_count(x.device),
                                     bf._K1C_QTILE, bf._K1C_CHUNK)
    kl = min(64, K + 4)
    qb, qs = bf._tf32_split(q)
    dev = x.device
    part_d = torch.empty((b, splits, kl), device=dev)
    part_i = torch.empty((b, splits, kl), dtype=torch.int32, device=dev)
    sel_d = torch.empty((b, kl), device=dev)
    sel_i = torch.empty((b, kl), dtype=torch.int32, device=dev)
    out_d = torch.empty((b, K), device=dev)
    out_i = torch.empty((b, K), dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    extra = (I(bf._ROW_CODE[x.dtype]),) if new else ()
    args = [P(x.data_ptr()), *extra, P(a.data_ptr()), P(q.data_ptr()),
            P(qb.data_ptr()), P(qs.data_ptr()), I(n), I(d), I(b), I(K),
            I(kl), I(splits), I(rps), P(part_d.data_ptr()),
            P(part_i.data_ptr()), P(sel_d.data_ptr()), P(sel_i.data_ptr()),
            P(out_d.data_ptr()), P(out_i.data_ptr()),
            P(torch.cuda.current_stream().cuda_stream)]
    _build.check(lib.pgv_k1_surrogate_topk(*args), "pgv_k1_surrogate_topk")
    return out_d, out_i


def _k2_call(lib, xb, a, qb, new=False):
    """K2 through ``lib``'s entry: the parent's signature (bf16 rows), or
    this checkout's (``new``: the row dtype's code and the bins per
    block)."""
    n, d = xb.shape
    b = qb.shape[0]
    dev = xb.device
    if new:
        bpb = bf._k2_bins_per_block(d, xb.dtype)
        target = (bf._block_target(dev) if bpb == bf._K2_BINS
                  else bf._sm_count(dev))
    else:
        bpb, target = bf._K2_BINS, bf._block_target(dev)
    _, _, splits, tps = bf._k2_plan(n, b, TN, target, bpb)
    bins = torch.empty((b, TN), dtype=torch.int64, device=dev)
    out_d = torch.empty((b, K), device=dev)
    out_i = torch.empty((b, K), dtype=torch.int32, device=dev)
    P, I = ctypes.c_void_p, ctypes.c_int
    head = ((P(xb.data_ptr()), I(bf._ROW_CODE[xb.dtype]), P(a.data_ptr()),
             P(qb.data_ptr()), I(n), I(d), I(b), I(K), I(TN), I(bpb))
            if new else (P(xb.data_ptr()), P(a.data_ptr()), P(qb.data_ptr()),
                         I(n), I(d), I(b), I(K), I(TN)))
    _build.check(lib.pgv_k2_binned_topk(
        *head, I(splits), I(tps), P(bins.data_ptr()),
        P(out_d.data_ptr()), P(out_i.data_ptr()),
        P(torch.cuda.current_stream().cuda_stream)), "pgv_k2_binned_topk")
    return out_d, out_i


def _data():
    data, queries = make_dataset(N, D, B, seed=6, intrinsic=32)
    x16 = torch.from_numpy(data).cuda().half()
    q = torch.from_numpy(queries).cuda()
    a = torch.zeros(N, device="cuda")  # ip: the row term is 0
    return x16, q, a


def split(src: Path) -> None:
    k1 = (src / "k1_topk.cu").read_text()
    if k1.count(_XSML) != 1:
        raise RuntimeError("k1_topk.cu no longer holds the qbig . xsml line")
    libs = _compile({
        "k1": (k1, src), "k1 no xsml": (k1.replace(_XSML, ""), src),
        "k2": ((src / "k2_binned.cu").read_text(), src)})
    x16, q, a = _data()
    x32 = x16.float()
    xb = x16.to(torch.bfloat16)
    qb = q.to(torch.bfloat16)
    want = _k1_call(libs["k1"], x32, a, q)[1]
    same = float((_k1_call(libs["k1 no xsml"], x32, a, q)[1] == want)
                 .float().mean())
    print(f"K1 without qbig . xsml: ids equal by rank {same:.4f}")
    for turn in range(2):
        t = {
            "K1 cast + kernel": _ms(lambda: _k1_call(libs["k1"], x16.float(),
                                                     a, q)),
            "K1 kernel": _ms(lambda: _k1_call(libs["k1"], x32, a, q)),
            "K1 kernel, no qbig . xsml": _ms(
                lambda: _k1_call(libs["k1 no xsml"], x32, a, q)),
            "K2 cast + kernel (f16 store)": _ms(
                lambda: _k2_call(libs["k2"], x16.to(torch.bfloat16), a, qb)),
            "K2 kernel": _ms(lambda: _k2_call(libs["k2"], xb, a, qb)),
            "f32 cast alone": _ms(lambda: x16.float()),
            "bf16 cast alone": _ms(lambda: x16.to(torch.bfloat16)),
        }
        for w in (352, 384):
            xw, qw = x32[:, :w].contiguous(), q[:, :w].contiguous()
            ms = _ms(lambda: _k1_call(libs["k1"], xw, a, qw))
            t[f"K1 at d = {w}"] = ms
            t[f"K1 at d = {w}, ms per TFLOP"] = ms / (3 * 2.0 * B * N * w
                                                      / 1e12)
        for w in (768, 832):
            xw, qw = xb[:, :w].contiguous(), qb[:, :w].contiguous()
            ms = _ms(lambda: _k2_call(libs["k2"], xw, a, qw))
            t[f"K2 at d = {w}"] = ms
            t[f"K2 at d = {w}, ms per TFLOP"] = ms / (2.0 * B * N * w / 1e12)
        for name, ms in t.items():
            print(f"turn {turn} {name}: {ms:.4f}", flush=True)


_WIDEN = "    widen(v + 1);           // into unit v - 1's f32 buffer\n"
_COPY = ("    if (v < total) {\n      const int ci = v / units, u = v - ci * "
         "units, st = v % stages;")
_EPI = "    if (u == units - 1) {  // the chunk's scores are complete\n"
_MMA = ("      wgmma_tf32_m64n256k8(acc, make_desc(qso + 32 * kk), xd,\n"
        "                           (u > 0 || kk > 0) ? 1 : 0);\n"
        "      wgmma_tf32_m64n256k8(acc, make_desc(qbo + 32 * kk), xd, 1);\n")
_BAR = ("    __syncthreads();  // unit v + 1 is ready; unit v's buffers are "
        "free\n")


def _patched(src: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) < 1:
            raise RuntimeError(f"k1_topk.cu no longer holds {old!r}")
        # the 2-byte mode's copy of a line shared with the f32 form
        at = src.rindex(old)
        src = src[:at] + new + src[at + len(old):]
    return src


def cutout() -> None:
    src = (_build._CSRC / "k1_topk.cu").read_text()
    copies = (_COPY, _COPY.replace("v < total", "v < total && v < stages - 1"))
    widen = (_WIDEN, "")
    epi = (_EPI, _EPI.replace("u == units - 1", "u == units - 1 && acc[0] == "
                              "-12345.f"))
    alone = (copies, widen, epi)
    variants = {
        "as built": src,
        "no widening": _patched(src, widen),
        "no copies": _patched(src, copies),
        "no epilogue": _patched(src, epi),
        "no wgmma": _patched(src, (_MMA, "      acc[kk] += __uint_as_float("
                                         "qso ^ static_cast<uint32_t>(xd));"
                                         "\n")),
        "products alone": _patched(src, *alone),
        "products alone, no barrier": _patched(src, *alone, (_BAR, "")),
    }
    libs = _compile({k: (v, _build._CSRC) for k, v in variants.items()})
    x16, q, a = _data()
    want = _k1_call(libs["as built"], x16, a, q, True)[1]
    for turn in range(2):
        for name, lib in libs.items():
            ms = _ms(lambda: _k1_call(lib, x16, a, q, True))
            same = float((_k1_call(lib, x16, a, q, True)[1] == want)
                         .float().mean())
            print(f"turn {turn} {name}: {ms:.4f} ms, ids equal to as built "
                  f"{same:.4f}", flush=True)


def variants(files) -> None:
    jobs = {"k1 as built": ((_build._CSRC / "k1_topk.cu").read_text(),
                            _build._CSRC),
            "k2 as built": ((_build._CSRC / "k2_binned.cu").read_text(),
                            _build._CSRC)}
    for f in files:
        jobs[f"{f.name[:2]} {f.stem}"] = (f.read_text(), _build._CSRC)
    libs = _compile(jobs)
    x16, q, a = _data()
    qb = q.to(torch.bfloat16)
    calls = {"k1": lambda lib: _k1_call(lib, x16, a, q, True),
             "k2": lambda lib: _k2_call(lib, x16, a, qb, True)}
    want = {k: calls[k](libs[f"{k} as built"])[1] for k in calls}
    for turn in range(2):
        for name, lib in libs.items():
            call = calls[name[:2]]
            ms = _ms(lambda: call(lib))
            same = float((call(lib)[1] == want[name[:2]]).float().mean())
            print(f"turn {turn} {name}: {ms:.4f} ms, ids equal to as built "
                  f"{same:.4f}", flush=True)


def _sass(so: Path) -> dict:
    """Kernel name -> its SASS lines (addresses and comments cut) in the
    library ``so``."""
    text = subprocess.run(["cuobjdump", "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = re.match(r"\s*Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
        elif name and re.match(r"\s*/\*[0-9a-f]{4}\*/", line):
            out[name].append(re.sub(r"/\*[^*]*\*/", "", line).strip())
    return out


def compare(parent: Path) -> None:
    here = _build._CSRC
    jobs = {}
    for tag, src in (("parent", parent), ("this", here)):
        for f in ("k1_topk.cu", "k2_binned.cu"):
            jobs[f"{tag} {f}"] = ((src / f).read_text(), src)
    libs = _compile(jobs)
    x16, q, a = _data()
    qb = q.to(torch.bfloat16)
    xbf = x16.to(torch.bfloat16)
    k1p, k2p = libs["parent k1_topk.cu"], libs["parent k2_binned.cu"]
    k1n, k2n = libs["this k1_topk.cu"], libs["this k2_binned.cu"]
    for store, xs in (("f16", x16), ("bf16", xbf)):
        old1 = _k1_call(k1p, xs.float(), a, q)
        new1 = _k1_call(k1n, xs, a, q, True)
        same1 = float((old1[1] == new1[1]).float().mean())
        err1 = float((old1[0] - new1[0]).abs().max())
        old2 = _k2_call(k2p, xs.to(torch.bfloat16), a, qb)
        new2 = _k2_call(k2n, xs, a, qb, True)
        same2 = float((old2[1] == new2[1]).float().mean())
        print(f"{store} store: K1 ids equal by rank {same1:.4f} (max score "
              f"diff {err1}); K2 ids equal by rank {same2:.4f}", flush=True)
        for turn in range(3):
            t = {
                "K1 old route (cast + parent K1)": _ms(
                    lambda: _k1_call(k1p, xs.float(), a, q)),
                "K1 new mode": _ms(lambda: _k1_call(k1n, xs, a, q, True)),
                "K2 old route (cast + parent K2)": _ms(
                    lambda: _k2_call(k2p, xs.to(torch.bfloat16), a, qb)),
                "K2 new mode": _ms(lambda: _k2_call(k2n, xs, a, qb, True)),
            }
            print(f"{store} turn {turn}: " + ", ".join(
                f"{k} {v:.4f} ms" for k, v in t.items()), flush=True)
    sass = {tag: {} for tag in ("parent", "this")}
    for name, lib in libs.items():
        sass[name.split()[0]].update(_sass(Path(lib._name)))
    # a kernel may be renamed (the rescoring is a template now): match by
    # its machine code
    bodies = {tuple(body) for body in sass["this"].values()}
    same = [n for n, body in sass["parent"].items() if tuple(body) in bodies]
    print(f"SASS: {len(same)} of {len(sass['parent'])} parent kernels have "
          "the same machine code in this checkout", flush=True)
    for n in sass["parent"]:
        if n not in same:
            print(f"  changed or gone: {n}", flush=True)


def main() -> None:
    if not torch.cuda.is_available():
        raise RuntimeError("k12_compact needs a CUDA GPU; none is visible")
    ap = argparse.ArgumentParser()
    ap.add_argument("--split", action="store_true")
    ap.add_argument("--src", type=Path, default=_build._CSRC)
    ap.add_argument("--parent", type=Path)
    ap.add_argument("--cutout", action="store_true")
    ap.add_argument("--variants", type=Path, nargs="*", default=[])
    args = ap.parse_args()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    torch.manual_seed(0)
    np.random.seed(0)
    if args.split:
        split(args.src)
    if args.parent is not None:
        compare(args.parent)
    if args.cutout:
        cutout()
    if args.variants:
        variants(args.variants)


if __name__ == "__main__":
    main()
