"""Timing probe: K10's two forms and the dense-query form's tile, against
the library's composed call, at the smoke's sparse shape.

    python -m pgvector_rx_tpu_torch.probes.k10_forms [--rows N]
        [--other-sparse OTHER_SPARSE_PY]

Needs one NVIDIA Hopper card and ``nvcc``. The data is ``chip_smoke.py``
phase 24's: ``make_sparse_dataset(N, 30,000, 1,024, 64, seed=9)`` (default
N = 100,000; the first 1,024 rows are the queries), padded to P = the
largest row, a dead sentinel row appended as in the graph. For l2, k = 10:

- the dense-query form at each block size (warps, one query per thread)
  and size of the staged rows, its default the one
  ``ops/sparse._k10_dense_plan`` picks, each held to
  the plain version (the same gather) and timed (CUDA events, mean of 10
  launches after one warm-up, the densified queries made once outside);
- the lookup form (``_lookup_topk_cuda``: the queries' union, the rows
  mapped into it by ``k10_compact``, the dense-query kernel at dim = |U|)
  at dim 0 and on the same rows with their indices spread into
  [0, 10^9) by an increasing injective map (dim 10^9: the same keys), and
  its mapping kernel alone (``compact_rows``), in turns with the same
  kernel built without its shared-memory sample of the union (this
  checkout's ``csrc/k10_sparse.cu`` with ns = 0: one search over the union
  in global memory), beside ``torch.searchsorted``;
- ``torch.sparse.mm`` of the CSR corpus and the densified queries alone,
  and composed with the l2 epilogue and ``torch.topk`` (the same
  function);
- the whole wrapper (``sparse_topk`` with dim, the densification
  included) in l2, ip, cosine, l1 and approx.

With ``--other-sparse``, another version of ``ops/sparse.py`` (e.g. the
parent commit's, from ``git show``) is loaded beside this one and its
``_lookup_topk_cuda`` timed against this one's in turns (6 each, other
first), keys compared.

The forms run in turns (dense, lookup, lookup at 10^9, library, ...,
library, lookup at 10^9, lookup, dense). Each result is one JSON line;
the card's name and power limit come first.
"""

from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
from pathlib import Path

import numpy as np
import torch

DIM, NQ, NNZ, K = 30_000, 1024, 64, 10
#: (warps per block, bytes of staged rows)
TILES = ((4, 4096), (4, 2048), (4, 8192), (8, 4096), (2, 4096), (2, 2048))


def cuda_ms(fn, iters: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def _one_level_compact():
    """``pgv_k10_compact`` of this checkout's ``csrc/k10_sparse.cu`` built
    with no sample of the union (ns = 0)."""
    from pgvector_rx_tpu_torch.ops import _build

    src = (_build._CSRC / "k10_sparse.cu").read_text()
    old = "const int ns = (u + stride - 1) / stride;"
    if old not in src:
        raise RuntimeError("the mapping's sample size was not found")
    out = _build.BUILD_DIR / "k10_forms"
    out.mkdir(parents=True, exist_ok=True)
    cu, so = out / "k10_one_level.cu", out / "lib_one_level.so"
    cu.write_text(src.replace(old, "const int ns = 0;"))
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-I",
                    str(_build._CSRC), "-o", str(so), str(cu)], check=True,
                   capture_output=True, text=True)
    fn = ctypes.CDLL(str(so)).pgv_k10_compact
    fn.argtypes = _build._SIGNATURES["pgv_k10_compact"]
    fn.restype = ctypes.c_int
    return fn


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rows", type=int, default=100_000)
    ap.add_argument("--other-sparse", type=Path)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("the probe needs a CUDA card")
    from pgvector_rx_tpu_torch.data import make_sparse_dataset
    from pgvector_rx_tpu_torch.ops import _build
    from pgvector_rx_tpu_torch.ops import bruteforce as bf
    from pgvector_rx_tpu_torch.ops import sparse

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(json.dumps({"card": smi}), flush=True)
    dev = torch.device("cuda")
    rows, queries = make_sparse_dataset(args.rows, DIM, NQ, NNZ, seed=9)
    p = max(len(r.indices) for r in rows)
    ci, cv = sparse.pad_rows(rows, p, dev)
    ci = torch.cat([ci, torch.full((1, p), sparse.PAD_INDEX, dtype=ci.dtype,
                                   device=dev)])
    cv = torch.cat([cv, torch.zeros((1, p), device=dev)])
    n = ci.shape[0]
    live = torch.ones(n, dtype=torch.bool, device=dev)
    live[-1] = False
    qi, qv = sparse.pad_rows(queries, p, dev)
    b = qi.shape[0]
    nnz = (ci != sparse.PAD_INDEX).sum().item()
    print(json.dumps({"rows": n, "queries": b, "P": p, "nnz": nnz}),
          flush=True)

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    ldq = -(-b // 256) * 256
    qd = sparse.densify_queries_t(qi, qv, DIM, ldq)
    q_sq, q_abs = (t.contiguous() for t in sparse._query_norms(qv))
    pd, pi = sparse._sparse_topk_plain(ci, cv, live, qi, qv, K, "l2", False,
                                       DIM)
    tol = (1e-5 * (q_sq + (cv * cv).sum(1).max())).cpu().numpy()

    def keys_to(keys):
        signed = torch.where(keys == -1, keys,
                             keys ^ torch.iinfo(torch.int64).min)
        return bf._from_order_keys(signed)

    def dense(warps, stage):
        plan = sparse._k10_dense_plan(n, b, p, K, sms, warps, stage)
        plan = (plan[0], ldq, *plan[2:])
        return lambda: sparse._dense_round_cuda(ci, cv, live, qd, q_sq,
                                                q_abs, b, K, "l2", False,
                                                DIM, plan, None)

    big = 10**9
    table = np.append(np.sort(np.random.default_rng(9).choice(
        big - 1, size=DIM - 1, replace=False)), big - 1)
    table_t = torch.from_numpy(table.astype(np.int32)).to(dev)

    def spread(t):
        pad = t == sparse.PAD_INDEX
        return torch.where(pad, t, table_t[torch.where(pad, 0, t).long()])

    bci, bqi = spread(ci), spread(qi)

    def lookup():
        return sparse._lookup_topk_cuda(ci, cv, live, qi, qv, K, "l2", False,
                                        sms)

    def lookup_big():
        return sparse._lookup_topk_cuda(bci, cv, live, bqi, qv, K, "l2",
                                        False, sms)

    uni, _ = sparse.compact_union(qi)
    mapped = torch.empty_like(ci)

    rowptr = torch.zeros(n + 1, dtype=torch.int64, device=dev)
    mask = ci != sparse.PAD_INDEX
    rowptr[1:] = mask.sum(1).cumsum(0)
    csr = torch.sparse_csr_tensor(rowptr, ci[mask].long(), cv[mask],
                                  size=(n, DIM))
    qdt = qd[:DIM, :b].contiguous()
    x2 = (cv * cv).sum(1)

    def library_dots():
        return torch.sparse.mm(csr, qdt)

    def library():
        d = torch.sparse.mm(csr, qdt).mul_(-2.0).add_(x2[:, None]).add_(
            q_sq[None]).clamp_(min=0.0)
        d.masked_fill_(~live[:, None], float("inf"))
        return torch.topk(d, K, dim=0, largest=False)

    def agree(d, i):
        """(max abs err of the distances, share of ids equal by rank,
        every distance within 1e-5 of |q|^2 + max |x|^2)."""
        err = (d - pd).abs().max().item()
        return err, (i == pi).float().mean().item(), bool(
            ((d - pd).abs().cpu().numpy() <= tol[:, None]).all())

    checks = {}
    for tile in TILES:
        d, i = keys_to(dense(*tile)())
        checks["dense %dx32/%d" % tile] = agree(d, i)
    checks["lookup"] = agree(*keys_to(lookup()))
    checks["lookup_1e9_equal"] = bool(torch.equal(lookup(), lookup_big()))
    one_fn = _one_level_compact()
    mapped1 = torch.empty_like(ci)
    blocks = max(1, min(-(-ci.numel() // 256),
                        4 * sparse._block_target(dev)))

    def one_level():
        _build.check(one_fn(ci.data_ptr(), ci.numel(), uni.data_ptr(),
                            uni.shape[0], blocks, mapped1.data_ptr(),
                            torch.cuda.current_stream().cuda_stream),
                     "pgv_k10_compact (one level)")
        return mapped1

    want_map = sparse._compact_rows_plain(ci, uni)
    checks["compact_equal"] = bool(torch.equal(
        sparse.compact_rows(ci, uni, out=mapped), want_map))
    checks["compact_one_level_equal"] = bool(torch.equal(one_level(),
                                                         want_map))
    ld, li = library()
    checks["library"] = agree(ld.T.contiguous(), li.T.contiguous())
    print(json.dumps({"agree_with_plain": checks}), flush=True)

    default = sparse._k10_dense_plan(n, b, p, K, sms)[0]
    arms = {"dense %dx32/%d" % tile: dense(*tile) for tile in TILES}
    arms["lookup"] = lookup
    arms["lookup_1e9"] = lookup_big
    arms["library_dots"] = library_dots
    arms["library_composed"] = library
    order = list(arms) + list(reversed(arms))
    ms = {name: [] for name in arms}
    for name in order:
        ms[name].append(cuda_ms(arms[name]))
    print(json.dumps({"ms": ms, "default_tile": default,
                      "bound_ms": 3.0 * b * nnz / 67e12 * 1e3}), flush=True)
    maps = {"compact_ms": lambda: sparse.compact_rows(ci, uni, out=mapped),
            "compact_one_level_ms": one_level}
    turns = {name: [] for name in maps}
    for name in [*maps, *reversed(list(maps))] * 2:
        turns[name].append(cuda_ms(maps[name]))
    print(json.dumps({
        "union": int(uni.shape[0]),
        "compact_turns_ms": turns,
        "compact_plain_ms": cuda_ms(
            lambda: sparse._compact_rows_plain(ci, uni)),
        "searchsorted_ms": cuda_ms(lambda: torch.searchsorted(uni, ci)),
        "compact_bound_ms": 8.0 * ci.numel() / 3.35e12 * 1e3}), flush=True)
    whole = {}
    for metric, approx in (("l2", False), ("ip", False), ("cosine", False),
                           ("l1", False), ("l2", True)):
        whole[f"{metric}{' approx' if approx else ''}"] = cuda_ms(
            lambda: sparse.sparse_topk(ci, cv, live, qi, qv, K, metric,
                                       approx, dim=DIM))
    print(json.dumps({"wrapper_ms": whole,
                      "plain_ms": cuda_ms(lambda: sparse._sparse_topk_plain(
                          ci, cv, live, qi, qv, K, "l2", False, DIM), 2)}),
          flush=True)
    if args.other_sparse is not None:
        spec = importlib.util.spec_from_file_location(
            "pgvector_rx_tpu_torch.ops.sparse_other", args.other_sparse)
        other = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(other)
        versions = {"other": other, "this": sparse}
        turns = {t: [] for t in versions}
        for tag in ("other", "this", "this", "other") * 3:
            turns[tag].append(cuda_ms(
                lambda m=versions[tag]: m._lookup_topk_cuda(
                    ci, cv, live, qi, qv, K, "l2", False, sms)))
        print(json.dumps({"lookup_vs_other_ms": turns, "keys_equal": bool(
            torch.equal(other._lookup_topk_cuda(ci, cv, live, qi, qv, K,
                                                "l2", False, sms),
                        lookup()))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
