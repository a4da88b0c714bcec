"""Chip smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port end to end on ``cuda:0`` and fails (exit code != 0) on any
phase that does not hold. Two paths, each driven with the kernel launch
counts set to 0 just before it and read just after:

**Device-build path** (the main path, 1,000,000 x 128-d):

1. print the card and its power limit, build the CUDA kernels from
   ``pgvector_rx_tpu_torch/csrc``;
2. make a 1,065,536 x 128-d SIFT-like corpus and 16,384 queries
   (``pgvector_rx_tpu_torch.data.make_dataset``, seed 0) and put the
   corpus on the card;
3. build an l2 HNSW index (m=16, ef_construction=64) from the first
   1,000,000 rows as a CUDA tensor with the port's batched device build,
   serving-only; print build seconds and rows/s; check the graph's
   invariants on the card;
4. ground truth: K1 ``l2_topk`` over all queries in chunks of 1,024,
   checked against float64 numpy on 64 queries;
5. ``serve_topk`` with the exact, approx and beam (ef=40: K7's coarse
   seeds, then the walk kernel K4) engines: one warm call and one timed
   call each, recall@10 and qps against floors, the timed call's peak
   device memory;
6. the tile-min probe's A/B over all queries in 1,024-query chunks: K3 at
   tn=1024 then the f32 rescore, K2 at tn=1024, the approx engine;
7. ``HnswIndex.search`` with exact / approx / device, held against
   ``serve_topk`` after the element -> heap-tid mapping.

Then, outside the counted paths:

8. hold each sweep kernel (K1, K2, K3 and K3's shift reduction) against
   its plain-torch version at the main path's shapes (1,024 queries x
   every row, k=10) and time both, beside the plain ``torch.matmul`` that
   makes the same [1,024, N] scores (the product alone, not the same
   function) and the same function composed of PyTorch calls per
   65,536-row block (the library yardstick: K1 f32 ``torch.mm`` + ``a`` +
   ``torch.topk``; K2 bf16 ``torch.mm``, the per-bin ``torch.min``, then
   ``torch.topk``; K3 bf16 ``torch.mm`` and the per-tile minimum, beside
   its sweep kernel alone); the K1 check must reject a control whose
   operands are
   truncated to TF32, the K2 check a control whose sums are rounded to
   bf16, the K3 check a control that ORs the column into uncleared score
   bits. K3 is timed end to end (``ms``) and its sweep kernel alone
   (``kernel_ms``). Each kernel's bound is computed from the shapes and
   the card's published peaks (``PEAKS``). Then K7, the beam engine's
   coarse seed sweep, over phase 3's upper rows at 1,024 queries and at
   one, held to its plain version (the same 8 seeds but for ties of their
   float64 scores; the check must reject the plain top-9 with its 8th
   seed dropped) and timed beside the route it replaces, its plain
   version (the f32 product of the bf16-rounded operands, the mask,
   ``torch.topk``, each also timed alone). K1's select form is held to its
   plain version on the same rows at B = 1, 3 and 64.

**Insert-and-scan path** (9-12, on the index of phase 3):

9. ``insert_bulk`` the last 65,536 rows from a CUDA tensor; seconds,
   rows/s, peak memory; the grown graph's invariants (cap 1,065,536);
10. K1 ground truth over the grown corpus, the three engines against the
    same floors, and each of 1,024 inserted rows among its own beam
    top-10 (>= 0.99);
11. scans: ``scan(method="auto")`` is ``DeviceScan`` (below the 4M
    cutover): its first 100 tuples of 64 queries, and K1's top-160 (its
    second block's path: K1's select form), equal the float64 exact order
    but for ties, a check that must reject the select form's 161st row in
    place of its 160th; K1's top-64 holds a 3xTF32 near tie at ranks 64 /
    65 (fault 3b: one tensor-core call would keep no spare place there);
    the latency of each exact block (40 to 2,560 rows, one select launch
    each); K7's one-query form held to its plain version on the beam
    scans' first 64 seedings (captured), rejecting the 9th seed for the
    8th, and timed through its wrapper;
    ``scan(method="beam")`` (the scan kernel K5) for 64
    queries under the filters ``eid % 50 == 0`` and ``eid % 500 == 0``,
    strict and relaxed order, LIMIT 20, ef_search=40: recall against the
    tie-aware filtered exact set, p50/p99 ms to the 20th row (the 0.2%
    p50s beside those of K5's form before its redesign, ``EARLIER_P50``),
    segments per scan, against floors, and, from CUDA events around every
    K5 launch of the same scans, the kernel's share of each scan's wall
    time;
12. the tests/t/044 contract at its own size on the card: 50,000 uniform
    3-d rows (built serving-only, the graph of tests/test_iterative_50k.py),
    20 queries, l2 and cosine, both orders, both filters, LIMIT 20, ef 40,
    recall >= 0.99.

Then, outside the counted paths:

13. the walk kernel against its plain version on the grown graph: serving
    mode (K4) for 1,024 queries at ef=40 from the coarse seeds (ids equal
    but for ties and equal steps on >= 0.99 of queries, recall@10 within
    0.002; the check must reject a control, the plain walk cut to ef / 4
    steps), and K5 for 32 queries over 3 segments, each fed its own spill
    and marks (beam and spill equal but for ties on every segment; the
    check must reject the plain segment cut to ef / 4 steps); each timed
    beside its bound, the bytes its steps gather: every step's neighbour
    ids and the rows it scores (the kernel counts them); K5 per segment
    and its microseconds per step; first, K1's select form against its
    plain version on the grown graph (B = 1, 3, 64 x k = 10 to every row,
    1,024 x 100, f16 rows with every seventh excluded; a control) and
    timed at DeviceScan's shape (one query, k = 10 to 2,560) beside its
    plain version, the library composition and the tensor-core form; the
    exact engine's peak memory above the graph at 1,024 x 100 and 32 x 10,
    where the select form serves it, held to a bound (one query chunk's
    keys, ``_K1S_BUDGET``, and 64 MiB).

**Native path** (14-17, the first 100,000 rows): the native C++ host build
into a serving-only torch index, its own K1 ground truth, and phases 5
and 7 on it.

**768-d cosine path** (18, BASELINE's first secondary configuration,
``bench_suite.py``): a 1,000,000 x 768-d corpus (``make_dataset``, seed 0)
built on the card with the beam-descent ground from a CUDA tensor (build
seconds, rows/s, peak memory, device time of the candidate step, the walk
(K8) and the commit), its invariants, K1 ground truth checked against
float64 on 64 queries, and the three engines against the same floors;
then K8 on the build's 600th batch (its inputs kept by ``K8Capture``)
against its plain version in the sort, no-dedup and rank merges (ids
equal but for ties, distances to rtol 1e-5, on every row; each must
reject the plain walk cut to a quarter of its steps), timed beside
its bound (the rows that batch scores) and the build's span per batch (a
``{"k8": ...}`` line); K1, K2, K4, K7 and K1's select form at d = 768
against their plain versions, with ms, bound and share, and K4 ranking in bf16 (the rows'
bf16 copy) against its plain version on 64 queries, timed at 1,024 in
turns with the f32 walk.

**l1 path** (19, the first 262,144 rows of phase 2's corpus, cut from 1M
for the run's time): the device build (l1 takes the beam ground), the
exact engine against a float64 l1 top-10 on the card for 1,024 queries,
the beam engine's recall at ef=40, and the l1 sweep (torch ops, queued as
kernel K11) timed per 1,024 queries beside its bound.

**Persistence** (20): the grown serving-only index of phase 9 saved, its
checkpoint loaded with ``serving=True`` on the card, and every engine's
ids held to the ones before the save; a 20,000-row host-graph index with
an append log, inserts and deletes, reloaded with replay, and its
``search`` ids held to the live index's. Save and load seconds and the
checkpoint's bytes are printed.

**Bit path** (21, BASELINE's bit(256) configuration, ``bench_suite.py``):
sign bits of a 1,000,000 x 256-d corpus (``make_dataset``, seed 7,
intrinsic 24) built serving-only on the card with hamming (the device
build on unpacked rows, the beam ground; build seconds, rows/s, peak
memory, device time of the beam ground and the commit), its invariants,
K9 ground truth for 4,096 queries equal to numpy popcounts on 64 of them
in (distance, id) order, ``serve_topk`` exact / approx / beam (ef=40, the
walk's packed-word mode) with tie-aware recall@10 (a returned row counts
if its distance is at most the 10th true one) against floors (1.0, 1.0,
0.93), and ``search`` held to ``serve_topk`` (8 queries too: K9's
popcount form, JAX's B < 32; 64 and more take its int8 tensor-core form).
Then both forms of K9 (the tensor-core form at 1,024 queries, the
popcount form at 8 and at 1,024) against both plain versions (equal, tie
order included; the check must reject a control whose ties put the higher
id first) and against JAX's MXU form written in PyTorch (unpack to bf16,
``torch.mm``, the formula, chunked ``torch.topk``: the library yardstick),
timed beside their bounds; ``torch.cdist(p=0)`` must give K9's top-1.
Then the bit beam's launch (the greedy descent in K4's launch, then the
walk's packed-word mode) against the torch descent and the plain walk
(the same landing ids and distances; the walks tie-aware equal; it must
reject the plain walk cut to ef / 4 steps), with the split of the torch
descent feeding the walk kernel beside the one launch.

**Jaccard path** (22, the first 262,144 bit rows, cut for the run's
time): the device build, the exact engine against numpy jaccard on 1,024
queries (f32 distances equal, ids equal but for ties), beam recall, and
both forms of K9's jaccard mode against the plain versions, timed.

**Flat index and operator classes** (23): ``FlatIndex`` over the first
100,000 rows of the main corpus (l2) and of the bit corpus (hamming)
equals K1 / K9 over the same rows; each dense and bit operator class makes
an index on the card with no device named, whose exact top-1 is the numpy
nearest row and whose beam answers.

**Sparse path** (24, BASELINE's "sparsevec CSR l2, 100k x 30k-d",
``bench_suite.py:7``, generator ``:222-241``, at its own size): the data
(``make_sparse_dataset``, seed 9) and the native build of its 100,000
rows (``HnswIndex.build``, m=16, ef_construction=64, seed 1: single-
threaded, minutes) run in a CPU subprocess (``--sparse-build``) started
after phase 1, beside the card phases; phase 24 loads its checkpoint onto
the card (no device named) and checks the graph (cap 100,000, the
padded-CSR rows on the card at the store's P, in row order); K10 ground
truth for the first 1,024 rows as queries (its dense-query form), held
to a float64 scipy CSR product on 64 of them; ``index.search`` exact
(floor 0.999), approx (0.98) and beam (ef=40, no floor at 30k-d: recall
printed), and ``FlatIndex`` over the 100,000 rows (K10's lookup form:
the flat index knows no dim; its mapping kernel ``k10_compact`` runs
there too), equal to that form's top-10; the beam's
launch (the greedy descent in K4's launch, then the walk's sparse-row
mode) against the torch descent and the plain walk from where it lands
(must reject the plain walk cut to ef / 4 steps), with the split of the
torch descent feeding the walk kernel beside the one launch; both forms of
K10 against their plain version in l2, ip, cosine, l1 and approx mode
(must reject the plain sweep with bf16-rounded values and one whose ip
keys are raw f32 bits); the lookup form on the same rows and queries
with their indices spread into [0, 10^9) by an increasing injective map
(dim 10^9) equal to its dim-0 keys, and its ids equal to the dense
form's but for ties; the mapping kernel equal to its plain version (must
reject a union short of one value); the forms timed in turns with
``torch.sparse.mm`` composed with the l2 epilogue and ``torch.topk``
(the same function) and, at dim 10^9, with ``torch.sparse.mm`` of the
CSR rows and the CSR queries (or the error it raises), beside the bound;
t/028 at its own size (10,000 x 3-d sparse rows, 20 queries,
k=20, four metrics) against its floors; an index of each sparse operator
class (500 rows, filled by the native bulk load); the t/028 l2 index
saved and loaded, every engine's ids unchanged.

**The beam's variants** (25, its own path, on the grown graph of phase 9,
the bit graph of phase 21 and the sparse graph of phase 24): ``serve_topk``
beam (ef=40, 16,384 queries) with E = 2, E = 4, the visited bitmap
(``_VISITED_MAX_ROWS`` above the graph's capacity + 1), E = 4 with the
bitmap, bf16 ranking and E = 4 with bf16, each beside the default in the
same run (recall >= 0.95; qps from the median of 5 timed calls); the 0.2% filtered scans (16 queries, strict
and relaxed) with E = 4 and bf16 beside the default; K4 in each mode (E
= 4, the bitmap, both, bf16) against its plain version at 1,024 queries,
each check rejecting a control (the plain walk at E = 1, with the in-beam
dedup, with the bitmap at E = 1, ranking in f32; bf16 also the plain
walk whose ranking terms skip the bf16 rounding of the difference or
product), each mode's bound counting no bitmap words (the first form's,
with a word read per id and the per-call clear, printed once beside the
bitmap's); K5
with E = 2, 4 and 8 and with bf16 over 3 fed segments against its plain
segment (beams and spills equal but for ties, steps and rows scored
equal query by query; bf16 must reject the unrounded terms too), and
timed per step at E = 1, 2, 4 and 8 in turns beside its byte bound and
its latency bound (steps times the dependent round trip that phase 13
measures with ``probes/k5_profile.py``'s pointer chase); the bit graph's
word walk with
E = 4 and the bitmap (tie-aware recall) and the sparse graph's walk with
the bitmap, each against its plain version; every mode timed beside its
byte bound.

**Halfvec path** (26, BASELINE's halfvec(1024) inner-product
configuration, ``bench_suite.py:141-170``, uncut): 1,000,000 x 1,024-d
(``make_dataset``, seed 6, intrinsic 32) built on the card with an f16
store (build s, rows/s), K1 ground truth over the f16 store in chunks held
to float64 on 64 queries (the build's beam ground: device seconds,
batches, K8's launches), exact / approx / beam over 4,096 queries (floors
1.0 / 0.98 / 0.80) with each call's peak device memory above the graph
(below ``HV_PEAK``: K1 and K2 read the stored rows, no chunk is cast, and
K7 writes no [B, U] score matrix), the same engines over the rows staged as a bf16 store,
and K1's 2-byte mode and K2's streamed form on a stored chunk of each
store against their plain versions and the parent's route (the chunk's
cast, then the kernel; K1's check must reject the f16 rows rounded to
bf16), timed in turns beside that route and beside their library
yardsticks (phase 8's ``k1_library`` / ``k2_library`` over the cast
chunk; a ``{"d1024": ...}`` line).

**The build knobs** (27, run after phase 18): the JAX package's
``PGV_BUILD_*`` knobs in the port's device build, each arm built
serving-only on the card (m=16, ef_construction=64, seed 1) with build
seconds, rows/s, peak device memory above what was allocated before it
and beam recall@10 at ef=40 against ``FLOORS["beam"]``: ``IVF_HOP=32``
at the main path's 1,000,000 x 128-d l2 (a fresh CUDA copy of phase 2's
rows, phase 4's ground truth, beside phase 3's build and recall);
``ALPHA=1.2`` beside the default at 262,144 x 128-d l2 (the first rows,
cut for the run's time; mean layer-0 out-degree of both); and at
262,144 x 768-d cosine (phase 18's first rows, the beam ground) the
default sort merge, ``BEAM_MERGE=rank`` (each beam ground's device span
per batch, K8 after the seeds' torch ops, beside its bound, a
``{"k8_builds": ...}`` line) and the sort merge with ``consume_input=True``, whose caller's tensor must hold no
storage after the build (its peak printed beside the sort build's).

**The sharded configuration** (28, its own path, run last): BASELINE's
fifth configuration (``configs/sharded_100m.py``: 128-d f32 l2 in
round-robin shards, the relaxed iterative scan with ``max_scan_tuples``
500) cut from 8 shards x 12,500,000 rows on a TPU v5e-8 to 4 shards x
262,144 rows on one card (the four-card layout; about a quarter of the
main path's rows a shard, since the smoke passed 1,000 s at 4 x 1M and
1,150 s at 4 x 524,288 on a slower host): ``make_dataset(1,114,112,
128, 16,384, seed=11)`` on the card,
``ShardedHnswIndex.build`` from the CUDA tensor (the device build, serving-
only, every shard on ``cuda:0``; build seconds per shard and in all, rows/s,
peak memory), each shard's invariants and device; K1 ground truth over all
1,048,576 rows (float64 on 64 queries); the sharded exact engine equal to it but
for ties, the sharded beam's recall@10 (floor ``FLOORS["beam"]``), both
timed over 16,384 queries with the merge's share of a search's wall time
(CUDA events); the sharded beam on 256 queries equal but for ties (on
>= 0.99 of them) to the same merge over each shard's plain descent and
walk (must reject the plain walk cut to ef / 4 steps); the filtered exact search (``tid % 50``) equal to
K1 over the kept rows; ``insert_bulk`` of the last 65,536 rows (shards
within one tuple, each of 1,024 inserted rows among its own beam top-10);
``ShardedScan`` (relaxed, ``max_scan_tuples`` 500) for 64 queries: 500
tuples in distance order, the first 20 equal to K1's exact top-20 of the
grown corpus but for ties, ms to the 20th row, and K1's select form
against its plain version on the first shard's rows (3 x 500); a 4 x 65,536-row sharded
build with ``PGV_BUILD_TIMING`` and ``GROUP_STATS`` (its lines and tuples,
the same graphs as without), saved and loaded with ids unchanged; one
shard's ``search`` with ``PGV_SCAN_STATS`` (the steps K4 reports); and
``dryrun_multichip(4)``.

Each path's kernels must have run on it: K1-K3, K3's shift reduction, K4
and K7 on the device-build path, K1 (both forms), K2, K4, K5 and K7
(both forms) on the insert-and-scan path, K1, K2, K4 and K7 on the native path and, with K8,
on the 768-d path, K4 and K8 on the l1 path, both forms of K9, K4 (word
mode) and K8 on the bit path, K9's tensor-core form, K4 and K8 on the
jaccard path, K8, K1, K2, K4 and K7 on the halfvec path, K1, K9's tensor-core form
and K4 in phase 23, both forms of K10, its mapping and K4 (sparse mode)
on the sparse path; on the sharded path, each counted around its own call
with every count set to 0 just before it: K1 in the exact search and
the filtered search, K1's select form in ``ShardedScan``, K4 in the beam
search. The last two
lines of output are one JSON object per
kernel list and the device line.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

N_ROWS, DIM, N_QUERIES, K, CHUNK = 1_000_000, 128, 16_384, 10, 1024
N_INSERT = 65_536
N_NATIVE = 100_000
DEVICE = "cuda:0"
EF = 40
M, EF_CONSTRUCTION = 16, 64
FLOORS = {"exact": 0.999, "approx": 0.98, "beam": 0.95}
K3_FLOOR = 0.90
#: inserted rows found among their own beam top-10
SELF_FLOOR = 0.99
#: beam-scan recall floors at 1M by (order, filter modulus), below the JAX
#: package's 4M figures (strict 0.903 / 0.747, relaxed 0.928 at 0.2%)
SCAN_Q, SCAN_LIMIT = 64, 20
SCAN_FLOORS = {("strict_order", 50): 0.85, ("strict_order", 500): 0.70,
               ("relaxed_order", 50): 0.90, ("relaxed_order", 500): 0.90}
#: the 0.2% beam scans' p50 ms with K5's form before its redesign (the
#: walk kernel's scan mode and a torch finish; PERF.md, NVIDIA H100 80GB
#: HBM3 at 700 W), printed beside this run's
EARLIER_P50 = {"strict_order": 651.985, "relaxed_order": 520.864}
#: the tests/t/044 contract: rows, queries, recall floor
C044_N, C044_Q, C044_FLOOR = 50_000, 20, 0.99
#: the 768-d cosine path, the l1 path and the logged host-graph index
N768, D768 = 1_000_000, 768
N_L1 = 262_144
#: phase 27: the rows of its alpha arm (128-d l2) and of its 768-d cosine
#: arm (cut from 1M for the run's time), and each arm's build knobs
N27 = 262_144
KNOB_ARMS = {"hop32": {"PGV_BUILD_IVF_HOP": "32"},
             "alpha1.2": {"PGV_BUILD_ALPHA": "1.2"},
             "rank": {"PGV_BUILD_BEAM_MERGE": "rank"}}
N_LOG = 20_000
CSRC = "pgvector_rx_tpu_torch/csrc/"
PALLAS = "pgvector_rx_tpu/ops/pallas_bruteforce.py"
JAX_DEVICE = "pgvector_rx_tpu/graph/device.py"
#: published dense peaks of one H100 SXM at 700 W (NVIDIA's data sheet)
PEAKS = {"bytes": 3.35e12, "bf16": 989e12, "tf32": 495e12, "f32": 67e12,
         "int8": 1979e12}
#: the bit path: BASELINE's bit(256) configuration (bench_suite.py:180-185)
#: at 1M (hamming) and its first 262,144 rows (jaccard, cut for the run's
#: time); the flat index's rows; the rows of each operator class's index
N_BIT, NBITS, N_BIT_Q = 1_000_000, 256, 4_096
#: a few queries at once (K9's popcount form: JAX's B < 32)
N_FEW_Q = 8
N_JAC = 262_144
N_FLAT, N_OPCLASS = 100_000, 500
BIT_FLOORS = {"exact": 1.0, "approx": 1.0, "beam": 0.93}
#: population counts per clock per SM on sm_90 (the CUDA programming
#: guide's arithmetic-instruction throughput table) and the H100 SXM's
#: published boost clock: the popcount form of K9's bound
POPC_PER_CLK_SM, BOOST_HZ = 16, 1.98e9
#: the sparse path (24): BASELINE's fourth configuration, "sparsevec CSR
#: l2, 100k x 30k-d" (bench_suite.py:7, its generator :222-241): rows,
#: dimension, draws per row, queries (the first rows), seed
N_SP, DIM_SP, NNZ_SP, N_SP_Q, SEED_SP = 100_000, 30_000, 64, 1024, 9
SPARSE_FLOORS = {"exact": 0.999, "approx": 0.98}
#: tests/t/028 at its own size (tests/test_full_scale.py:156-190): rows,
#: queries, k, and its floors (VECTOR_THRESH)
T028_N, T028_Q, T028_K = 10_000, 20, 20
T028_FLOORS = {"l2": 0.99, "cosine": 0.99, "l1": 0.99, "ip": 0.97}
#: phase 25's filtered scans per variant (the first queries of phase 11's)
VARIANT_SCAN_Q = 16
#: phase 25's timed serve_topk calls per beam mode (qps from their median)
SERVE_CALLS = 5
#: the halfvec path (26): BASELINE's third configuration, halfvec(1024)
#: inner product at 1M with an f16 store (bench_suite.py:141-170), and its
#: recall floors (beam: printed, failing below 0.80)
N_HV, D_HV, N_HV_Q = 1_000_000, 1024, 4096
HV_FLOORS = {"exact": 1.0, "approx": 0.98, "beam": 0.80}
#: the same rows in a bf16 store, held to the f16 store's ground truth:
#: bf16 rounds away what ranks near neighbours (the JAX package's bf16
#: opt-in test holds its exact engine to 0.95)
HV_BF16_FLOORS = {"exact": 0.95, "approx": 0.95, "beam": 0.80}
#: the halfvec calls' peak device memory above the graph: K1 and K2 read the
#: stored rows, so the exact call holds about a 1,024-query chunk's tf32
#: halves, K1's lists and the row terms (~40 MiB) and the approx call also
#: the rescore's [1,024, 10, 1,024] gather in f16 and f32 and its products
#: (~130 MiB); the parent's cast of one chunk alone was 1 GiB (f32) or 512
#: MiB (bf16); the beam call holds K7's seeds and K4's beams (its [1,024,
#: 62,500] f32 score matrix before K7 took 738.0 MiB)
HV_PEAK = {"exact": 128 << 20, "approx": 256 << 20, "beam": 256 << 20}
#: the sharded configuration (28): BASELINE config 5 (configs/sharded_100m.py)
#: cut to this many shards of this many rows on one card (262,144, not the
#: main path's 1M, since the whole smoke passed 1,000 s with 1M and 1,150 s
#: with 524,288 on a slower host), its data seed;
#: the rows per shard of its checkpoint round trip, the scan's queries and
#: tuple budget (config 5's ``max_scan_tuples``), the queries of its
#: walk-vs-plain check and the filter modulus of its filtered search
S28, N28, SEED28 = 4, 262_144, 11
N28_CKPT, SCAN28_Q, SCAN28_MAX, WALK28_Q, FILTER28 = 65_536, 64, 500, 256, 50
#: the graph tensors two builds must hold equal
GRAPH_FIELDS = ("neighbors0", "upper_neighbors", "upper_slot", "levels",
                "traversable", "emit_tid", "tid_count", "values")


def bound(ops: float, peak: str, nbytes: float) -> dict:
    """The least time the card could take: the larger of ``ops`` over the
    ``peak`` rate and ``nbytes`` (each input read once, each output
    written once) over the memory rate."""
    t_ops = ops / PEAKS[peak] * 1e3
    t_bytes = nbytes / PEAKS["bytes"] * 1e3
    unit = "TOP/s" if peak == "int8" else "TFLOP/s"
    return dict(bound_ms=max(t_ops, t_bytes),
                bound_by="operations" if t_ops >= t_bytes else "bytes",
                bound_peak=(f"{peak} {PEAKS[peak] / 1e12:g} {unit}"
                            if t_ops >= t_bytes else "3.35 TB/s"))


def log(msg: str) -> None:
    print(msg, flush=True)


class Phase:
    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        log(f"--- phase {self.name}")
        self.t0 = time.time()
        return self

    def __exit__(self, *exc):
        if exc[0] is None:
            log(f"phase {self.name}: {time.time() - self.t0:.3f} s")
        return False


def cuda_ms(fn, iters: int = 10) -> float:
    """Mean device time of ``fn`` (CUDA events), after one warm call."""
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


def tie_aware_mismatch(ids_a, d_a, ids_b, d_b, tol) -> int:
    """Rows whose id sets differ other than by ties at the k-th distance:
    every id in one set and not the other must lie within ``tol`` of the
    other side's k-th distance."""
    bad = 0
    for r in range(ids_a.shape[0]):
        sa, sb = set(ids_a[r].tolist()), set(ids_b[r].tolist())
        if sa == sb:
            continue
        kth_a, kth_b = d_a[r, -1], d_b[r, -1]
        da = dict(zip(ids_a[r].tolist(), d_a[r].tolist()))
        db = dict(zip(ids_b[r].tolist(), d_b[r].tolist()))
        tie = all(abs(da[i] - kth_b) <= tol[r] for i in sa - sb) and all(
            abs(db[i] - kth_a) <= tol[r] for i in sb - sa
        )
        bad += not tie
    return bad


def tf32_truncated(t):
    """``t`` with the low 13 mantissa bits cleared: TF32 operands."""
    return (t.contiguous().view(torch.int32) & ~0x1FFF).view(torch.float32)


def k1_agreement(d, ids, p_d, p_ids, q2max) -> tuple[float, bool]:
    """(max abs error, agrees) of K1-style surrogate scores ``(d, ids)``
    against the plain FP32 sweep: rtol 1e-5 with atol ``1e-5 max(q2)``,
    and id sets may differ only at ties within that tolerance."""
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    tol = 1e-5 * np.abs(p_d).max(axis=1) + 1e-5 * q2max
    err = float(np.abs(d - p_d).max())
    ok = (np.allclose(d, p_d, rtol=1e-5, atol=1e-5 * q2max)
          and not tie_aware_mismatch(ids, d, p_ids, p_d, tol))
    return err, ok


def binned_bf16_sums(vb, a, qb, k, tn):
    """Control for the K2 check: the binned sweep with every dot product
    rounded to bf16 (a kernel that lost its f32 accumulation)."""
    b, n = qb.shape[0], vb.shape[0]
    s = a[None, :] - 2.0 * (qb @ vb.T).float()  # bf16 GEMM output
    s = torch.nn.functional.pad(s, (0, (-n) % tn), value=float("inf"))
    mn, tile = s.view(b, -1, tn).min(dim=1)
    ids = tile * tn + torch.arange(tn, device=s.device)[None, :]
    sd, slot = torch.topk(mn, k, dim=1, largest=False, sorted=True)
    return sd, torch.gather(ids, 1, slot).to(torch.int32)


def k2_agreement(d, ids, p_d, p_ids, q2max) -> tuple[float, bool]:
    """(max abs error, agrees) of K2-style squared-l2 results ``(d, ids)``
    against the plain binned version: distances must lie within rtol 1e-2
    and within ``1e-5 |d| + 2e-5 max(q2)`` (K1's scale, twice its atol for
    the tensor cores' summation order), and id sets may differ only at
    ties within that tolerance."""
    d, ids = d.cpu().numpy(), ids.cpu().numpy()
    tol = 1e-5 * np.abs(p_d) + 2e-5 * q2max
    err = np.abs(d - p_d)
    ok = (bool((err <= tol).all())
          and np.allclose(d, p_d, rtol=1e-2, atol=0.0)
          and not tie_aware_mismatch(ids, d, p_ids, p_d, tol.max(axis=1)))
    return float(err.max()), ok


def tilemin_no_clear(bf, vb, a, q, k, tn):
    """Control for the K3 check: the tile-min sweep ORing the column into
    the score bits WITHOUT clearing the low 10 bits (its ids are corrupt)."""
    q2x, av, shift = bf._tilemin_prepare(vb, a, q)
    n = vb.shape[0]
    x = torch.nn.functional.pad(vb.float(), (0, 0, 0, (-n) % tn))
    av = torch.nn.functional.pad(av, (0, (-n) % tn), value=bf._NEG_BIG)
    s = av[None, :] - q2x.float() @ x.T
    col = torch.arange(s.shape[1], device=s.device, dtype=torch.int32) % tn
    packed = (s.view(torch.int32) | col[None, :]).view(q.shape[0], -1, tn)
    return bf._tilemin_unpack(packed.amin(dim=2), shift, n, k, tn)


def k3_agreement(bf, d, ids, p_d, p_ids, vb, a, q, q2, q2max):
    """(max abs error, agrees) of K3's squared-l2 results ``(d, ids)``
    against the plain tile-min version ``(p_d, p_ids)``: every returned
    distance lies within one 13-bit packing quantum of the shifted score
    plus K2's summation tolerance, ``(|d| + shift) 2^-13 + 1e-5 |d| +
    2e-5 max(q2)``, both of the plain result at the same rank and of the
    returned id's own bf16 score; id sets may differ only at ties within
    that tolerance."""
    _, _, shift = bf._tilemin_prepare(vb, a, q)
    q2x = (2.0 * q.float()).to(torch.bfloat16).float()
    safe = ids.clamp(min=0).long()
    own = a[safe] - (vb[safe].float() * q2x[:, None, :]).sum(-1) + q2
    d, ids, own = d.cpu().numpy(), ids.cpu().numpy(), own.cpu().numpy()
    fin = p_ids >= 0  # fewer tiles than k leave (inf, -1) pads
    tol = np.where(fin, (np.abs(p_d) + float(shift)) * 2.0 ** -13
                   + 1e-5 * np.abs(p_d) + 2e-5 * q2max, 0.0)
    with np.errstate(invalid="ignore"):  # inf - inf on the pads
        err = np.abs(np.where(fin, d - p_d, 0.0))
        own_err = np.abs(np.where(fin, d - own, 0.0))
    ok = (bool(((ids >= 0) == fin).all()) and bool((err <= tol).all())
          and bool((own_err <= tol).all())
          and not tie_aware_mismatch(ids, d, p_ids, p_d, tol.max(axis=1)))
    return float(err.max()), ok


#: rows per block of the composed library calls (bounds their [B, rows]
#: scores)
LIB_ROWS = 65_536


def k1_library(x, a, q, k):
    """K1's function from PyTorch calls: per block of rows an f32
    ``torch.mm`` (TF32 off), ``a - 2 q.x`` and ``torch.topk``, merged."""
    best_d = best_i = None
    for s in range(0, x.shape[0], LIB_ROWS):
        xs = x[s : s + LIB_ROWS]
        sc = a[None, s : s + LIB_ROWS] - 2.0 * torch.mm(q, xs.T)
        d, i = torch.topk(sc, k, dim=1, largest=False)
        if best_d is not None:
            d, i = torch.cat([best_d, d], 1), torch.cat([best_i, i + s], 1)
            d, j = torch.topk(d, k, dim=1, largest=False)
            i = torch.gather(i, 1, j)
        best_d, best_i = d, i
    return best_d, best_i


def k2_library(vb, a, qb, k, tn):
    """K2's function from PyTorch calls: per block of rows a bf16
    ``torch.mm`` (bf16 out), ``a - 2 q.x`` in f32 and each bin's (row mod
    tn) minimum (``torch.min``), kept across blocks; then ``torch.topk``
    over the bins."""
    b = qb.shape[0]
    best = torch.full((b, tn), float("inf"), device=qb.device)
    rows = torch.zeros((b, tn), dtype=torch.int64, device=qb.device)
    col = torch.arange(tn, device=qb.device)
    for s in range(0, vb.shape[0], LIB_ROWS):
        sc = lib_tiles(vb, a, qb, s, tn)
        m, j = torch.min(sc, dim=1)
        take = m < best
        best = torch.where(take, m, best)
        rows = torch.where(take, s + j * tn + col, rows)
    d, c = torch.topk(best, k, dim=1, largest=False)
    return d, torch.gather(rows, 1, c)


def k3_library(vb, a, qb, tn):
    """K3's sweep from PyTorch calls: per block of rows a bf16
    ``torch.mm``, ``a - 2 q.x`` in f32 and each tile's minimum with its
    column (``torch.min`` over tn-row tiles)."""
    return [torch.min(lib_tiles(vb, a, qb, s, tn), dim=2)
            for s in range(0, vb.shape[0], LIB_ROWS)]


def lib_tiles(vb, a, qb, s, tn):
    """The f32 scores ``a - 2 q.x`` of rows [s, s + LIB_ROWS) from a bf16
    ``torch.mm``, as [B, tiles, tn] (a short last tile padded with +inf)."""
    sc = a[None, s : s + LIB_ROWS] - 2.0 * torch.mm(
        qb, vb[s : s + LIB_ROWS].T).float()
    sc = torch.nn.functional.pad(sc, (0, -sc.shape[1] % tn),
                                 value=float("inf"))
    return sc.view(sc.shape[0], -1, tn)


def check_graph(g, m: int, n: int) -> None:
    """Invariants of a built graph, on its device: layer-0 degree <= 2m
    and upper degree <= m, every live row linked, no self-edges, no edge
    to a dead row or to a row below the layer, the entry alive at the
    maximum level, cap = n."""
    if g.cap != n:
        raise RuntimeError(f"graph cap {g.cap}, want {n}")
    nb0, alive, levels = g.neighbors0.long(), g.traversable, g.levels.long()
    if nb0.shape[1] != 2 * m or g.upper_neighbors.shape[1] % m:
        raise RuntimeError("adjacency widths are not 2m / m per layer")
    ids = torch.arange(nb0.shape[0], device=nb0.device)[:, None]
    live = nb0[alive]
    ok = live >= 0
    if bool((live == ids[alive]).any()):
        raise RuntimeError("self-edge at layer 0")
    if not bool(alive[live[ok]].all()) or bool((nb0[~alive] >= 0).any()):
        raise RuntimeError("layer-0 edge from or to a dead row")
    if int(ok.sum(1).min()) < 1:
        raise RuntimeError("a live row has no layer-0 neighbour")
    lmax = g.upper_neighbors.shape[1] // m
    up_el = torch.nonzero(alive & (levels >= 1)).flatten()
    rows = g.upper_neighbors[g.upper_slot[up_el].long()].long()
    rows = rows.view(-1, lmax, m)
    lc = torch.arange(1, lmax + 1, device=rows.device)[None, :, None]
    used = lc <= levels[up_el][:, None, None]
    r_ok = rows >= 0
    if bool((r_ok & ~used).any()):
        raise RuntimeError("upper edges above an element's level")
    tgt = rows.clamp(min=0)
    bad = r_ok & (~alive[tgt] | (levels[tgt] < lc) | (tgt == up_el[:, None,
                                                                  None]))
    if bool(bad.any()):
        raise RuntimeError("upper edge to a dead, self or lower-level row")
    top = int(levels[alive].max())
    if not bool(alive[g.entry]) or int(levels[g.entry]) != top \
            or g.entry_level != top:
        raise RuntimeError("the entry is not at the maximum level")
    log(f"graph invariants hold: cap={g.cap}, {int(alive.sum())} live rows, "
        f"mean layer-0 degree {float(ok.sum(1).float().mean()):.2f}, "
        f"{up_el.numel()} upper rows, entry {g.entry} at level {top}")


def ground_truth(bf, base_np, queries_np, q_dev):
    """K1 top-k over every query, checked against float64 numpy."""
    dev = q_dev.device
    base = torch.from_numpy(base_np).to(dev)
    gt = torch.cat([
        bf.l2_topk(base, q_dev[s : s + CHUNK], K)[1]
        for s in range(0, q_dev.shape[0], CHUNK)
    ]).cpu().numpy()
    del base
    q64, x64 = queries_np[:64].astype(np.float64), base_np.astype(np.float64)
    ref = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
           - 2.0 * q64 @ x64.T)  # [64, N] squared l2 in float64
    del x64
    ref_d = np.sort(np.partition(ref, K, axis=1)[:, :K], axis=1)
    gt_d = np.take_along_axis(ref, gt[:64].astype(np.int64), axis=1)
    if gt.shape != (q_dev.shape[0], K) or (gt < 0).any():
        raise RuntimeError("ground truth has the wrong shape or holes")
    if not np.allclose(np.sort(gt_d, axis=1), ref_d, rtol=1e-5, atol=1e-4):
        raise RuntimeError("ground truth disagrees with float64 numpy")
    log(f"gt {gt.shape}, float64 check on 64 queries ok")
    return gt


def recall_of(emit_tid, gt):
    """recall@K of element ids against ground-truth corpus rows (= tids)."""
    def recall(ids):
        tids = np.where(ids >= 0, emit_tid[np.maximum(ids, 0)], -1)
        return float(np.mean([len(set(tids[b]) & set(gt[b])) / K
                              for b in range(gt.shape[0])]))
    return recall


def timed_serve(device_mod, index, q, engine, ef=EF, calls=1):
    """(dists, ids, seconds) of a timed ``serve_topk`` after a warm call:
    the median of ``calls`` timed calls."""
    device_mod.serve_topk(index, q, K, engine=engine, ef=ef)
    torch.cuda.synchronize()
    times = []
    for _ in range(calls):
        t0 = time.time()
        d, ids = device_mod.serve_topk(index, q, K, engine=engine, ef=ef)
        times.append(time.time() - t0)
    return d, ids, float(np.median(times))


def serve_engines(index, q_dev, recall, bf, device_mod, tag):
    """The three engines over ``q_dev``: recall@10, qps and the timed
    call's peak device memory above what was allocated before it; each
    engine's kernels must launch (the beam: K7's coarse seeds, then K4)."""
    results = {}
    for engine, knames in (("exact", ("k1_topk",)),
                           ("approx", ("k2_binned",)),
                           ("beam", ("k7_coarse", "k4_beam"))):
        with Phase(f"{tag} serve_topk {engine}"):
            before = dict(bf.LAUNCHES)
            dev = q_dev.device
            device_mod.serve_topk(index, q_dev, K, engine=engine, ef=EF)
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated(dev)
            torch.cuda.reset_peak_memory_stats(dev)
            t0 = time.time()
            d, ids = device_mod.serve_topk(index, q_dev, K, engine=engine,
                                           ef=EF)
            dt = time.time() - t0
            peak = torch.cuda.max_memory_allocated(dev) - base
            rec = recall(ids)
            results[engine] = (d, ids)
            log(f"{tag} {engine}: recall@10={rec:.4f} "
                f"qps={q_dev.shape[0] / dt:.1f} ({dt:.4f} s for "
                f"{q_dev.shape[0]} queries); peak device memory above the "
                f"allocation before the call {peak / 2**20:.1f} MiB")
            if d.shape != (q_dev.shape[0], K) or not np.isfinite(d).all():
                raise RuntimeError(f"{engine}: non-finite or misshapen output")
            if rec < FLOORS[engine]:
                raise RuntimeError(f"{engine}: recall {rec} < {FLOORS[engine]}")
            for kname in knames:
                if bf.LAUNCHES[kname] <= before[kname]:
                    raise RuntimeError(f"{engine}: kernel {kname} did not "
                                       "launch")
    return results


def search_vs_serve(index, queries_np, results, emit_tid, SearchParams, tag):
    with Phase(f"{tag} index.search vs serve_topk"):
        q64 = queries_np[:64]
        for method, engine in (("exact", "exact"), ("approx", "approx"),
                               ("device", "beam")):
            sd, stids = index.search(q64, K, SearchParams(ef_search=EF),
                                     method=method)
            d, ids = results[engine]
            tids = np.where(ids[:64] >= 0, emit_tid[np.maximum(ids[:64], 0)],
                            -1)
            tol = 1e-4 * np.abs(d[:64]).max(axis=1) + 1e-4
            bad = tie_aware_mismatch(stids, sd.astype(np.float64) ** 2, tids,
                                     d[:64].astype(np.float64), tol)
            log(f"{tag} search({method}): {bad} of 64 rows differ from "
                "serve_topk")
            if bad > (1 if engine == "beam" else 0):
                raise RuntimeError(f"search({method}) disagrees with "
                                   "serve_topk")


def walk_agreement(ids_a, d_a, ids_b, d_b, rtol=1e-5):
    """Per row of two walks' sorted outputs: the same ids, or the same
    finite slots with distances equal position by position (``rtol``) and
    id sets that differ only at ties of the cut (``tie_aware_mismatch``).
    Returns (agreeing rows [rows] bool, max abs err over equal rows)."""
    ok = np.zeros(ids_a.shape[0], bool)
    err = 0.0
    for r in range(ids_a.shape[0]):
        fa, fb = np.isfinite(d_a[r]), np.isfinite(d_b[r])
        if (fa != fb).any():
            continue
        da, db = d_a[r][fa], d_b[r][fb]
        if (ids_a[r] == ids_b[r]).all():
            ok[r] = True
            if fa.any():
                err = max(err, float(np.abs(da - db).max()))
            continue
        tol = rtol * np.abs(db) + 1e-6
        ok[r] = bool((np.abs(da - db) <= tol).all()) and (
            not fa.any() or not tie_aware_mismatch(
                ids_a[r][fa][None], da[None], ids_b[r][fb][None], db[None],
                [tol.max()]))
    return ok, err


def insert_rows(index, x_new, n_total):
    """Phase 9: insert_bulk from a CUDA tensor, timed; the grown graph's
    invariants."""
    with Phase("9 insert_bulk"):
        dev = x_new.device
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        added = index.insert_bulk(x_new)
        torch.cuda.synchronize()
        dt = time.time() - t0
        log(f"insert_bulk: {x_new.shape[0]} rows in {dt:.3f} s, "
            f"{x_new.shape[0] / dt:.1f} rows/s, peak device memory "
            f"{torch.cuda.max_memory_allocated(dev) / 2**30:.2f} GiB, "
            f"{added} elements added")
        if added != x_new.shape[0]:
            raise RuntimeError(f"insert_bulk added {added} elements")
        g = index.device_graph()
        check_graph(g, M, n_total)
    return g


def inserted_self_recall(index, x_dev, device_mod, n0):
    """Each of 1,024 inserted rows as a query must find itself (tid = row)
    among its beam top-10."""
    _, ids = device_mod.serve_topk(index, x_dev[n0 : n0 + CHUNK], K,
                                   engine="beam", ef=EF)
    emit = index.device_graph().emit_tid.cpu().numpy()
    tids = np.where(ids >= 0, emit[np.maximum(ids, 0)], -1)
    hit = float(np.mean([(n0 + r) in set(tids[r].tolist())
                         for r in range(CHUNK)]))
    log(f"inserted rows found among their own beam top-10: {hit:.4f}")
    if hit < SELF_FLOOR:
        raise RuntimeError(f"inserted-row self recall {hit} < {SELF_FLOOR}")


def select_boundary_control(bf, x, a, q, k):
    """Control for the select form's checks: its top k + 1 with the k-th
    dropped, the (k + 1)-th in its place (a select whose last digit lands
    one key late)."""
    d, i = bf._select_topk_cuda(x, a, q, k + 1)
    return (torch.cat([d[:, : k - 1], d[:, k:]], 1),
            torch.cat([i[:, : k - 1], i[:, k:]], 1))


def select_agreement(kd, ki, pd, pi, q2max):
    """The select form's (kd, ki) against its plain version's (pd, pi),
    [B, k] on the card with (inf, -1) empty -> (max abs err, ok): the same
    empty slots; scores rank by rank within 1e-5 |d| + 1e-5 max(q2) (K1's
    scale); an id in one list and not the other ties the other list's
    k-th score within that tolerance."""
    fin = torch.isfinite(pd)
    if not (torch.equal(fin, torch.isfinite(kd)) and torch.equal(fin, pi >= 0)
            and torch.equal(fin, ki >= 0)):
        return float("inf"), False
    tol = 1e-5 * q2max
    diff = (kd - pd).abs()[fin]
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= 1e-5 * pd.abs()[fin] + tol).all())
    if not fin.any():
        return err, ok
    b = pd.shape[0]
    row = torch.arange(b, device=pd.device)[:, None]
    span = int(max(ki.max(), pi.max())) + 1
    key_k = (row * span + ki.long())[fin]
    key_p = (row * span + pi.long())[fin]
    kth_p = torch.where(fin, pd, -float("inf")).max(1).values
    kth_k = torch.where(fin, kd, -float("inf")).max(1).values
    rows_f = row.expand_as(pd)[fin]
    out_k = ~torch.isin(key_k, key_p)
    out_p = ~torch.isin(key_p, key_k)
    ok &= bool(((kd[fin] - kth_p[rows_f]).abs()[out_k] <= tol).all())
    ok &= bool(((pd[fin] - kth_k[rows_f]).abs()[out_p] <= tol).all())
    return err, ok


def select_vs_plain(bf, x, a, q, k, tag):
    """Hold the select form to its plain version on (x, a, q) at k: one
    launch a query chunk; raises on disagreement. -> max abs err."""
    before = bf.LAUNCHES["k1_select"]
    kd, ki = bf._invalid_to_sentinel(*bf._select_topk_cuda(x, a, q, k))
    launched = bf.LAUNCHES["k1_select"] - before
    pd, pi = bf._invalid_to_sentinel(*bf._surrogate_topk_plain(x, a, q, k))
    q2max = float((q * q).sum(1).max())
    err, ok = select_agreement(kd, ki, pd, pi, q2max)
    chunks = len(bf._k1s_plan(x.shape[0], q.shape[0]))
    if not ok or launched != chunks:
        raise RuntimeError(f"{tag}: K1's select form at {q.shape[0]} x k = "
                           f"{k} ({x.dtype}) disagrees with its plain version"
                           f" (max abs err {err}, {launched} launches for "
                           f"{chunks} chunks)")
    return err


def exact_order_mismatch(d, ids, ref_d, ref_i, q2max):
    """Rows of squared-l2 lists ``(d, ids)`` [B, k] that differ from the
    float64 exact order ``(ref_d, ref_i)``: a distance off its rank's by
    more than ``1e-5 |d| + 1e-5 max(q2)`` (K1's scale), or an id set that
    differs other than by ties at the k-th distance."""
    tol = 1e-5 * np.abs(ref_d) + 1e-5 * q2max
    off = (np.abs(d - ref_d) > tol).any(axis=1)
    return int(off.sum()) + tie_aware_mismatch(ids[~off], d[~off],
                                               ref_i[~off], ref_d[~off],
                                               tol[~off].max(axis=1))


def device_scan_check(index, g, q_dev, bf, SearchParams, DeviceScan):
    """scan(method="auto") on the grown serving-only index is DeviceScan.
    Held against the float64 exact order of every row on the card (no
    kernel in the reference): its first 100 tuples, and K1's top-160 (the
    path of its second block, ``l2_topk`` at k = 160: the select form, one
    launch a query chunk). The check must reject a control: the select
    form's top 161 with its 160th dropped. Then each exact block's latency
    (40, 160, 640, 2,560 rows), one select launch each."""
    n_take, k_round = 100, 4 * EF
    q = q_dev[:SCAN_Q].contiguous()
    emit = g.emit_tid.cpu().numpy()
    x = g.values[: g.cap].contiguous()
    x64, q64 = x.double(), q.double()
    ref = ((q64 * q64).sum(1)[:, None] + (x64 * x64).sum(1)[None, :]
           - 2.0 * q64 @ x64.T)
    del x64
    ref_d, ref_i = torch.topk(ref, k_round, dim=1, largest=False)
    del ref
    ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
    ref_t = np.where(ref_i >= 0, emit[np.maximum(ref_i, 0)], -1)
    q2 = (q * q).sum(1, keepdim=True)
    q2max = float(q2.max())

    before = bf.LAUNCHES["k1_select"]
    k1_d, k1_i = bf.l2_topk(x, q, k_round)
    launched = bf.LAUNCHES["k1_select"] - before
    a = (x * x).sum(1)
    c_d, c_i = select_boundary_control(bf, x, a, q, k_round)
    torch.cuda.synchronize()
    bad_k1 = exact_order_mismatch(k1_d.cpu().numpy(), k1_i.cpu().numpy(),
                                  ref_d, ref_i, q2max)
    bad_ctl = exact_order_mismatch((c_d + q2).cpu().numpy(),
                                   c_i.cpu().numpy(), ref_d, ref_i, q2max)
    chunks = len(bf._k1s_plan(x.shape[0], SCAN_Q))
    log(f"K1 top-{k_round} (the select form, {launched} launches for "
        f"{chunks} query chunks): {bad_k1} of {SCAN_Q} rows differ from the "
        f"float64 exact order; control (its 161st for its 160th): {bad_ctl} "
        "rows differ")
    if bad_k1 or launched != chunks:
        raise RuntimeError("K1's select form disagrees with the exact order")
    if not bad_ctl:
        raise RuntimeError("the exact-order check passes a select that "
                           "returns the 161st row for the 160th")

    bad = 0
    for b in range(SCAN_Q):
        scan = index.scan(q[b], SearchParams(ef_search=EF), method="auto")
        if not isinstance(scan, DeviceScan):
            raise RuntimeError(f"scan(auto) is {type(scan).__name__}")
        out = scan.take(n_take)
        tids = np.array([[t for t, _ in out]])
        d2 = np.array([[x for _, x in out]]) ** 2
        if tids.shape[1] != n_take or (np.diff(d2[0]) < 0).any():
            raise RuntimeError("DeviceScan stream is short or out of order")
        bad += exact_order_mismatch(d2, tids, ref_d[b : b + 1, :n_take],
                                    ref_t[b : b + 1, :n_take], q2max)
    log(f"DeviceScan: {SCAN_Q} queries x {n_take} tuples, {bad} streams "
        "differ from the float64 exact order other than at ties")
    if bad:
        raise RuntimeError("DeviceScan disagrees with the exact order")

    # each block re-sweeps every row, in one launch of K1's select form
    ms = {EF * 4 ** i: [] for i in range(4)}
    launches = {}
    for b in range(8):
        scan = index.scan(q[b], SearchParams(ef_search=EF), method="auto")
        done = 0
        for block in ms:
            before = dict(bf.LAUNCHES)
            torch.cuda.synchronize()
            t0 = time.time()
            done += len(scan.take(block - done))
            torch.cuda.synchronize()
            ms[block].append((time.time() - t0) * 1e3)
            launches[block] = {n: v - before[n] for n, v in
                               bf.LAUNCHES.items() if v != before[n]}
    log("DeviceScan ms per exact block (mean of 8 queries; launches): "
        + ", ".join(f"{blk} rows {np.mean(t):.3f} ms ({launches[blk]})"
                    for blk, t in ms.items()))
    if any(c != {"k1_select": 1} for c in launches.values()):
        raise RuntimeError(f"a DeviceScan block is not one select launch: "
                           f"{launches}")
    return {blk: float(np.mean(t)) for blk, t in ms.items()}


LIBRARY_TOPK = "a - 2 (q @ x.T), torch.topk(dim=1)"


def library_topk(x, a, q, k):
    """The library composition of K1's function: one product and
    ``torch.topk`` along each query's row."""
    return torch.topk(a[None] - 2.0 * (q @ x.T), k, dim=1, largest=False)


def select_bound(n, dim, b, k):
    """K1's bound at b queries x n rows x dim f32 and k: the rows, ``a``
    and the queries read once and the lists written, or the f32 product as
    three TF32 products (as K1's tensor-core form computes it)."""
    return bound(3 * 2.0 * b * n * dim, "tf32",
                 (n * dim + n + b * dim) * 4 + b * k * 8)


def k1_select_check(bf, g, q_dev, dim=DIM):
    """K1's select form on the grown graph's rows (phase 13): held to its
    plain version at B = 1, 3, 64 and k = 10, 60, 61, 65, 160, 640, 2,560
    and N (every row), at 1,024 queries x k = 100, and on the rows stored
    as f16 with every seventh row excluded (B = 3, k = 640; B = 64, k =
    100); the check must reject a control (the top 161 with its 160th
    dropped). Timed at one query (DeviceScan's shape) for each of its
    blocks' k beside the plain version and the library composition (one
    product ``a - 2 q @ x.T``, ``torch.topk`` along each query), and at
    1,024 x 100. Returns its kernels row (headline: one query, k =
    2,560)."""
    x = g.values[: g.cap].contiguous()
    n = x.shape[0]
    a = (x * x).sum(1).contiguous()
    errs = {}
    for b in (1, 3, 64):
        q = q_dev[:b].contiguous()
        for k in (10, 60, 61, 65, 160, 640, 2560, n):
            errs[(b, k)] = select_vs_plain(bf, x, a, q, k, "13")
    q64 = q_dev[:64].contiguous()
    c_d, c_i = bf._invalid_to_sentinel(
        *select_boundary_control(bf, x, a, q64, 160))
    p_d, p_i = bf._invalid_to_sentinel(
        *bf._surrogate_topk_plain(x, a, q64, 160))
    _, ctl_ok = select_agreement(c_d, c_i, p_d, p_i,
                                 float((q64 * q64).sum(1).max()))
    if ctl_ok:
        raise RuntimeError("the select form's check passes the 161st row "
                           "for the 160th")
    qb = q_dev[:CHUNK].contiguous()
    errs[(CHUNK, 100)] = select_vs_plain(bf, x, a, qb, 100, "13")
    x16 = x.half()
    a16 = (x16.float() ** 2).sum(1)
    a16[::7] += bf._NEG_BIG
    for b, k in ((3, 640), (64, 100)):
        errs[("f16", b, k)] = select_vs_plain(bf, x16, a16.contiguous(),
                                              q_dev[:b].contiguous(), k, "13")
    del x16, a16
    log(f"13 K1's select form equals its plain version but for ties at "
        f"{len(errs)} (B, k) points (max abs err {max(errs.values())}); the "
        f"control (161st for 160th) is rejected")
    q1 = q_dev[:1].contiguous()
    by_k = {}
    for k in (10, 40, 60, 160, 640, 2560):
        by_k[k] = dict(
            ms=cuda_ms(lambda: bf._select_topk_cuda(x, a, q1, k)),
            plain_ms=cuda_ms(lambda: bf._surrogate_topk_plain(x, a, q1, k)),
            library_ms=cuda_ms(lambda: library_topk(x, a, q1, k)),
            tc_ms=(cuda_ms(lambda: bf._surrogate_topk_cuda(x, a, q1, k))
                   if k <= bf._MAX_K else None))
    large = dict(
        b=CHUNK, k=100,
        ms=cuda_ms(lambda: bf._select_topk_cuda(x, a, qb, 100), 3),
        plain_ms=cuda_ms(lambda: bf._surrogate_topk_plain(x, a, qb, 100), 3),
        library_ms=cuda_ms(lambda: library_topk(x, a, qb, 100), 3),
        bound=select_bound(n, dim, CHUNK, 100))
    head = by_k[2560]
    row = dict(
        name="k1_select", route="cuda", source=CSRC + "k1_select.cu",
        replaces=f"{PALLAS}:34 (one query or k > 60)",
        max_abs_err=max(errs.values()), ms=head["ms"],
        plain_ms=head["plain_ms"], library_ms=head["library_ms"],
        library_of="one query, k = 2,560: a - 2 (q @ x.T) in f32 (TF32 off), "
                   "torch.topk(dim=1, largest=False)",
        shape="one query x 1,065,536 rows x 128-d f32, k = 2,560",
        by_k=by_k, at_1024_x_100=large, **select_bound(n, dim, 1, 2560))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log("13 K1 at one query (DeviceScan's shape), ms by k (select / plain "
        "/ library / tensor-core form): " + ", ".join(
            f"k={k} {v['ms']:.4f} / {v['plain_ms']:.4f} / "
            f"{v['library_ms']:.4f} / {v['tc_ms']}" for k, v in by_k.items())
        + f"; bound {row['bound_ms']:.4f} ms ({row['bound_by']}); 1,024 x "
        f"100: {large['ms']:.4f} ms (plain {large['plain_ms']:.4f}, library "
        f"{large['library_ms']:.4f}, bound {large['bound']['bound_ms']:.4f})")
    return row


def select_peak_bound(bf, n, b):
    """The most device memory an exact call of b queries over n f32 rows
    may hold above the graph where K1's select form runs it: the keys of
    one query chunk (``_K1S_BUDGET``, or one query's), and 64 MiB for the
    chunk's counts, candidates and selection and the call's [b, k]
    lists."""
    return min(b * n * 8, max(bf._K1S_BUDGET, n * 8)) + (64 << 20)


def exact_select_peak(index, device_mod, bf, g, q_dev):
    """The exact engine (``serve_topk``) on the grown index where K1's
    select form serves it: 1,024 queries x k = 100 and 32 x 10. Each
    call's peak device memory above the allocation before it (the graph's)
    must stay within ``select_peak_bound``; each must launch the select
    form. -> {"B x k": MiB}."""
    dev = q_dev.device
    out = {}
    for b, k in ((CHUNK, 100), (32, K)):
        q = q_dev[:b].contiguous()
        device_mod.serve_topk(index, q, k, engine="exact")
        torch.cuda.synchronize()
        before = bf.LAUNCHES["k1_select"]
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        d, _ = device_mod.serve_topk(index, q, k, engine="exact")
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) - base
        cap = select_peak_bound(bf, g.cap, b)
        out[f"{b} x {k}"] = peak / 2**20
        log(f"13 exact engine at {b} x k = {k}: peak device memory above the "
            f"graph {peak / 2**20:.1f} MiB (bound {cap / 2**20:.1f} MiB), "
            f"{bf.LAUNCHES['k1_select'] - before} select launches")
        if bf.LAUNCHES["k1_select"] == before:
            raise RuntimeError(f"the exact engine at {b} x {k} did not run "
                               "K1's select form")
        if peak > cap or d.shape != (b, k) or not np.isfinite(d).all():
            raise RuntimeError(f"the exact engine at {b} x {k}: {peak} bytes "
                               f"above the graph (bound {cap}) or bad output")
    return out


class K7OneCapture:
    """Keeps the inputs of the first ``keep`` calls of K7's one-query form
    (``ops/bruteforce._coarse_one_cuda``): the beam scans' seedings."""

    def __init__(self, bf, keep=64):
        self.bf, self.keep, self.calls = bf, keep, []

    def __enter__(self):
        self.orig = orig = self.bf._coarse_one_cuda

        def wrapped(rows, a, ids, trav, query, s, l2):
            if len(self.calls) < self.keep:
                self.calls.append((rows, a, ids, trav, query.clone(), s, l2))
            return orig(rows, a, ids, trav, query, s, l2)
        self.bf._coarse_one_cuda = wrapped
        return self

    def __exit__(self, *exc):
        self.bf._coarse_one_cuda = self.orig
        return False


def k7_one_check(bf, calls, dim=DIM):
    """K7's one-query form on the beam scans' captured seedings: each
    call's seeds equal its plain version's but for ties (the check must
    reject the plain top-9 with its 8th seed dropped), timed through the
    wrapper (CUDA events over 10 calls: host time counts where it exceeds
    the kernel's) beside the plain version. Returns its kernels row."""
    if not calls:
        raise RuntimeError("no one-query K7 call was captured")
    rows, a, ids, trav, _, s, l2 = calls[0]
    q = torch.cat([c[4].reshape(1, -1) for c in calls])
    live = trav[ids]
    got = torch.cat([bf.coarse_topk(rows, a, ids, trav, q[i : i + 1], s, l2)[0]
                     for i in range(q.shape[0])])
    want, _ = bf._coarse_plain(rows, a, ids, trav, q, s, l2)
    s9, _ = bf._coarse_plain(rows, a, ids, trav, q, s + 1, l2)
    ctl = torch.cat([s9[:, : s - 1], s9[:, s:]], 1)
    ok, err = coarse_agreement(rows, a, live, q, got, want, l2)
    ok_c, _ = coarse_agreement(rows, a, live, q, ctl, want, l2)
    log(f"11 K7's one-query form on {q.shape[0]} captured seedings: "
        f"{ok.mean():.4f} equal to the plain version but for ties, max abs "
        f"err {err}; control with the 9th seed for the 8th: {ok_c.mean():.4f}")
    if not ok.all():
        raise RuntimeError("K7's one-query form disagrees with its plain "
                           "version")
    if ok_c.all():
        raise RuntimeError("the one-query K7 check passes a wrong seed")
    q1 = q[:1]
    U = rows.shape[0]
    row = dict(
        name="k7_coarse_one", route="cuda", source=CSRC + "k7_coarse.cu",
        replaces=f"{JAX_DEVICE}:732 (_coarse_seed_one, XLA; the port's "
                 "torch route)",
        max_abs_err=err,
        ms=cuda_ms(lambda: bf.coarse_topk(rows, a, ids, trav, q1, s, l2)),
        plain_ms=cuda_ms(lambda: bf._coarse_plain(rows, a, ids, trav, q1, s,
                                                  l2)),
        upper_rows=U,
        **bound(2.0 * U * dim, "bf16",
                U * dim * 2 + U * (4 + 8 + 1) + dim * 4 + s * 16))
    row["library_ms"] = row["plain_ms"]
    row["library_of"] = ("the route it replaces (its plain version): the f32 "
                         "product of the bf16-rounded operands, the mask, "
                         "torch.topk")
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"11 k7_coarse_one: {row['ms']:.4f} ms a call with its wrapper, "
        f"plain {row['plain_ms']:.4f}, bound {row['bound_ms']:.4f} "
        f"({row['bound_by']}), share {row['share_of_bound']:.4f}")
    return row


def filtered_expected(vals, q, rows, limit):
    """The tie-aware filtered exact sets (tests/t/044:99-104): every row of
    ``rows`` at a distance <= the limit-th nearest filtered distance
    (float64 on the card)."""
    sub = vals[rows].double()
    qd = q.double()
    dist = ((qd * qd).sum(1)[:, None] + (sub * sub).sum(1)[None, :]
            - 2.0 * qd @ sub.T)
    kth = dist.sort(dim=1).values[:, limit - 1]
    keep = dist <= kth[:, None] + 1e-9 * kth.abs()[:, None] + 1e-9
    rows_h = rows.cpu().numpy()
    return [set(rows_h[k].tolist()) for k in keep.cpu().numpy()]


def scan_recall(index, queries, mask, expected, mode, SearchParams,
                limit=SCAN_LIMIT, events=None):
    """(recall, ms to the limit-th row per scan, segments per scan, K5's
    (device ms, launches) per scan) of beam scans under ``mask``.
    ``events``: the list into which a wrapped ``scan_segment`` puts the
    (start, end) CUDA events of each launch (None: not read)."""
    params = SearchParams(ef_search=EF, iterative_scan=mode)
    correct, lat, segs, kern = 0, [], [], []
    for b in range(len(queries)):
        if events is not None:
            events.clear()
        torch.cuda.synchronize()
        t0 = time.time()
        scan = index.scan(queries[b], params, method="beam",
                          filter_mask=mask)
        got = scan.take(limit)
        lat.append((time.time() - t0) * 1e3)
        segs.append(scan.scan_stats.resumes + 1)
        if events is not None:
            torch.cuda.synchronize()
            kern.append((sum(a.elapsed_time(z) for a, z in events),
                         len(events)))
        if not all(mask[t] for t, _ in got):
            raise RuntimeError("a beam scan emitted a filtered-out row")
        correct += sum(1 for t, _ in got if t in expected[b])
    return (correct / (len(queries) * limit), np.array(lat), np.array(segs),
            np.array(kern))


def beam_scan_check(index, g, q_dev, SearchParams, DeviceBeamScan, beam):
    """Beam scans on the grown index at 2% and 0.2% selectivity, strict
    and relaxed order, against SCAN_FLOORS, with CUDA events around every
    K5 launch for the kernel's share of each scan's wall time (one run of
    the scans: the launches counted are the main path's own)."""
    q = q_dev[:SCAN_Q].contiguous()
    eids = torch.arange(g.cap, device=q.device)
    if not isinstance(index.scan(q[0], SearchParams(), method="beam"),
                      DeviceBeamScan):
        raise RuntimeError("scan(method='beam') is not DeviceBeamScan")
    if bool((g.tid_count[: g.cap] != 1).any()):
        raise RuntimeError("the grown corpus folded duplicates: element ids "
                           "are not tids")
    launch = beam.scan_segment
    events = []

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = launch(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    beam.scan_segment = timed
    try:
        for c in (50, 500):
            rows = torch.nonzero(eids % c == 0).flatten()
            mask = (eids % c == 0).cpu().numpy()
            expected = filtered_expected(g.values, q, rows, SCAN_LIMIT)
            for mode in ("strict_order", "relaxed_order"):
                rec, lat, segs, kern = scan_recall(
                    index, q, mask, expected, mode, SearchParams,
                    events=events)
                log(f"beam scan {mode} eid % {c} == 0 ({100 / c:g}%): "
                    f"recall {rec:.4f}, ms to the {SCAN_LIMIT}th row p50 "
                    f"{np.percentile(lat, 50):.3f} p99 "
                    f"{np.percentile(lat, 99):.3f}, segments per scan mean "
                    f"{segs.mean():.2f} max {segs.max()}")
                if rec < SCAN_FLOORS[(mode, c)]:
                    raise RuntimeError(f"beam scan recall {rec} < "
                                       f"{SCAN_FLOORS[(mode, c)]}")
                kern_ms, n_launch = kern[:, 0], kern[:, 1]
                share = kern_ms / lat
                log(f"  K5's share of each scan's wall time mean "
                    f"{np.mean(share):.4f} p50 {np.percentile(share, 50):.4f} "
                    f"min {np.min(share):.4f}; per launch wall "
                    f"{np.mean(lat / n_launch):.4f} ms, kernel "
                    f"{np.mean(kern_ms / n_launch):.4f} ms (events around "
                    f"each launch)")
                if c == 500:
                    log(f"  beside K5's form before its redesign: p50 "
                        f"{np.percentile(lat, 50):.3f} ms against "
                        f"{EARLIER_P50[mode]} ms")
    finally:
        beam.scan_segment = launch


def contract_044(HnswIndex, SearchParams, dev):
    """tests/t/044 at its own size: 50,000 uniform 3-d rows (the data and
    seed of tests/test_iterative_50k.py, built serving-only on the card),
    20 queries, filters i % 50 and i % 500, LIMIT 20, ef 40, both orders,
    l2 and cosine: recall >= 0.99."""
    rng = np.random.default_rng(44)
    data = rng.random((C044_N, 3)).astype(np.float32)
    queries = rng.random((C044_Q, 3)).astype(np.float32)
    for metric in ("l2", "cosine"):
        idx = HnswIndex.build(data, metric=metric, method="device", seed=45,
                              host_graph=False, device=dev)
        for c in (50, 500):
            mask = (np.arange(C044_N) % c) == 0
            rows = np.flatnonzero(mask)
            d = data[rows].astype(np.float64)
            q = queries.astype(np.float64)
            if metric == "l2":
                dist = np.sqrt(((q[:, None, :] - d[None]) ** 2).sum(-1))
            else:
                dn = d / np.linalg.norm(d, axis=1, keepdims=True)
                qn = q / np.linalg.norm(q, axis=1, keepdims=True)
                dist = 1.0 - qn @ dn.T
            kth = np.sort(dist, axis=1)[:, SCAN_LIMIT - 1]
            expected = [set(rows[dist[b] <= kth[b] + 1e-9].tolist())
                        for b in range(C044_Q)]
            for mode in ("strict_order", "relaxed_order"):
                rec, lat, segs, _ = scan_recall(idx, queries, mask,
                                                expected, mode, SearchParams)
                log(f"044 {metric} i % {c} {mode}: recall {rec:.4f}, ms p50 "
                    f"{np.percentile(lat, 50):.3f}, segments mean "
                    f"{segs.mean():.2f}")
                if rec < C044_FLOOR:
                    raise RuntimeError(f"044 {metric} c={c} {mode}: recall "
                                       f"{rec} < {C044_FLOOR}")
        del idx


def walk_gather_bytes(steps, scored, L, flags, dim=DIM):
    """The bytes a walk must read from the graph: each step's L neighbour
    ids (4 bytes), and for each row it scores the f32 row and its
    ``flags`` one-byte flags (live; in scan mode also excluded). The flags
    of a pad, dead or excluded neighbour are left out: a bound that counts
    less stays a bound."""
    return steps * L * 4 + scored * (dim * 4 + flags)


def walk_vs_plain(g, q_dev, gt, emit, device_mod, beam, kernels):
    """Phase 13: K4 and K5 against their plain versions on the grown
    graph, timed beside their bounds."""
    q1 = q_dev[:CHUNK].contiguous()
    L = g.neighbors0.shape[1]
    upper = device_mod._coarse_upper(g)
    s_ids, s_d = device_mod._coarse_seeds(g, q1, upper[0], upper[1], 8)
    s_ids = s_ids.to(torch.int32).contiguous()
    graph = (g.values, g.neighbors0, g.traversable)
    max_steps = 4 * EF + 32

    def serve(walk, steps=max_steps):
        raw = walk(*graph, None, "l2", q1, s_ids, s_d, width=EF, spill=0,
                   max_steps=steps, scan=False)
        return [t.cpu().numpy() for t in (*beam._serve_finish(*raw), raw[5])]

    def recall(ids):
        tids = np.where(ids >= 0, emit[np.maximum(ids, 0)], -1)[:, :K]
        return float(np.mean([len(set(tids[b]) & set(gt[b])) / K
                              for b in range(CHUNK)]))

    kd, ki, ks, kn = serve(beam._walk_cuda)
    pd, pi, ps, pn = serve(beam._walk_plain)
    cd, ci, cs, cn = serve(beam._walk_plain, EF // 4)

    def verdict(d, ids, st, n):
        ok, err = walk_agreement(ids, d, pi, pd)
        rec_gap = abs(recall(ids) - recall(pi))
        same_st = float(np.mean((st == ps) & (n == pn)))
        passed = ok.mean() >= 0.99 and same_st >= 0.99 and rec_gap <= 0.002
        return ok.mean(), same_st, rec_gap, err, passed

    k_same, k_steps, k_gap, k_err, k_ok = verdict(kd, ki, ks, kn)
    c_same, c_steps, c_gap, _, c_ok = verdict(cd, ci, cs, cn)
    log(f"K4 vs plain: {k_same:.4f} of queries equal but for ties, "
        f"{k_steps:.4f} equal steps and rows scored, recall@10 "
        f"{recall(ki):.4f} vs {recall(pi):.4f}, max abs err {k_err}; control "
        f"(plain cut to {EF // 4} steps): {c_same:.4f} equal, {c_steps:.4f} "
        f"steps, recall gap {c_gap:.4f}")
    if not k_ok:
        raise RuntimeError("K4 disagrees with its plain version")
    if c_ok:
        raise RuntimeError("the K4 check passes a walk cut to ef / 4 steps")
    steps_total, scored_total = float(ks.sum()), float(kn.sum())
    log(f"K4 rows scored: {scored_total / steps_total:.2f} per step of "
        f"{L} slots ({scored_total / CHUNK:.1f} per query)")
    walk_bytes = walk_gather_bytes(steps_total, scored_total, L, 1) + CHUNK * (
        DIM * 4 + s_ids.shape[1] * 8 + EF * 8 + 8)
    kernels["k4_beam"] = dict(
        name="k4_beam", route="cuda", source=CSRC + "k4_beam.cu",
        replaces=f"{JAX_DEVICE}:446 (_ground_beam_seeds, an XLA while-loop)",
        max_abs_err=k_err,
        ms=cuda_ms(lambda: beam._walk_cuda(
            *graph, None, "l2", q1, s_ids, s_d, width=EF, spill=0,
            max_steps=max_steps, scan=False)),
        plain_ms=cuda_ms(lambda: beam._walk_plain(
            *graph, None, "l2", q1, s_ids, s_d, width=EF, spill=0,
            max_steps=max_steps, scan=False), iters=2),
        **bound(scored_total * 3.0 * DIM, "f32", walk_bytes),
        library_ms=None, matmul_ms=None, matmul_of=None,
        steps_mean=steps_total / CHUNK, scored_mean=scored_total / CHUNK,
    )

    # K5: 32 queries, 3 segments, each form fed its own spill and marks
    nq, W = 32, 4 * EF
    spill = max(2 * EF, 64) + (W - EF)
    steps_w = 4 * W + 32
    q32 = q1[:nq].contiguous()
    seed0 = (torch.nn.functional.pad(s_ids[:nq], (0, spill - 8), value=-1),
             torch.nn.functional.pad(s_d[:nq], (0, spill - 8),
                                     value=float("inf")))

    def fed(run, n_seg=3):
        """``run(excl, allowed, seeds)`` -> (report, spill_d, spill_ids),
        3 segments, each fed the previous one's spill and marks."""
        excl = torch.zeros((nq, g.cap + 1), dtype=torch.bool,
                           device=q1.device)
        allowed = beam.allowed_bits(g.traversable, excl)
        seeds, out = seed0, []
        for _ in range(n_seg):
            rep, sp_d, sp_i = run(excl, allowed, seeds)
            out.append([t.cpu().numpy() for t in (rep, sp_d, sp_i)])
            seeds = (sp_i, sp_d)
        return out

    def kernel5(excl, allowed, seeds, ef=EF):
        return beam.scan_segment(*graph, excl, "l2", q32, *seeds, ef, W,
                                 spill, steps_w, allowed=allowed, mark=True)

    def plain5(excl, allowed, seeds, max_steps=steps_w):
        return beam._scan_plain(*graph, excl, "l2", q32,
                                seeds[0].to(torch.int32).contiguous(),
                                seeds[1].contiguous(), EF, W, spill,
                                max_steps, True)

    def seg_agreement(k, p):
        """(queries whose beam and spill agree but for ties, max abs
        err, steps equal)."""
        kb_d, kb_i = k[0][:, :EF].view(np.float32), k[0][:, EF:2 * EF]
        pb_d, pb_i = p[0][:, :EF].view(np.float32), p[0][:, EF:2 * EF]
        ok_b, e1 = walk_agreement(kb_i, kb_d, pb_i, pb_d)
        ok_s, e2 = walk_agreement(k[2], k[1], p[2], p[1])
        return ok_b & ok_s, max(e1, e2), k[0][:, 2 * EF] == p[0][:, 2 * EF]

    k5_runs, p5_runs = fed(kernel5), fed(plain5)
    c5_runs = fed(lambda e, a, s_: plain5(e, a, s_, EF // 4))
    bad, err5 = 0, 0.0
    for seg, (k, p, c) in enumerate(zip(k5_runs, p5_runs, c5_runs)):
        ok, e, same_steps = seg_agreement(k, p)
        ok_c, _, _ = seg_agreement(c, p)
        bad += int((~ok).sum())
        err5 = max(err5, e)
        log(f"K5 segment {seg}: {int(ok.sum())}/{nq} beams and spills equal "
            f"but for ties, {int(same_steps.sum())}/{nq} equal steps (kernel "
            f"{k[0][:, 2 * EF].sum()}, plain {p[0][:, 2 * EF].sum()}), rows "
            f"scored kernel {k[0][:, 2 * EF + 1].sum()} plain "
            f"{p[0][:, 2 * EF + 1].sum()}; control (plain cut to {EF // 4} "
            f"steps): {int(ok_c.sum())}/{nq} equal")
        if ok_c.mean() >= 0.99:
            raise RuntimeError("the K5 check passes a walk cut to ef / 4 "
                               "steps")
    if bad:
        raise RuntimeError(f"K5 disagrees with its plain version on {bad} "
                           "(query, segment) pairs")
    # timed at the main path's shape: one query (the first segment of
    # query 0) per launch, the staged bitmap as DeviceBeamScan stages it
    excl0 = torch.zeros((1, g.cap + 1), dtype=torch.bool, device=q1.device)
    allowed0 = beam.allowed_bits(g.traversable, excl0)
    one = (*graph, excl0, "l2", q32[:1], seed0[0][:1].to(torch.int32),
           seed0[1][:1])
    rep1 = beam.scan_segment(*one, EF, W, spill, steps_w,
                             allowed=allowed0)[0]
    steps1, scored1 = float(rep1[0, 2 * EF]), float(rep1[0, 2 * EF + 1])
    log(f"K5 rows scored: {scored1 / steps1:.2f} per step of {L} slots, "
        f"{steps1:.0f} steps in the timed segment")
    seg_bytes = walk_gather_bytes(steps1, scored1, L, 2) + (
        DIM * 4 + spill * 8 + (W + spill) * 8 + 8)

    ms5 = cuda_ms(lambda: beam.scan_segment(*one, EF, W, spill, steps_w,
                                            allowed=allowed0))
    log(f"K5 per segment: {ms5:.4f} ms, {ms5 / steps1 * 1e3:.3f} us per "
        f"step")
    # K5's latency bound is steps times a step's dependent round trip
    round_trip_us = dependent_round_trip_us(g, g.values)
    kernels["k5_beam_scan"] = dict(
        name="k5_beam_scan", route="cuda", source=CSRC + "k4_beam.cu",
        replaces=f"{JAX_DEVICE}:574 (_beam_scan_segment, an XLA "
                 "while-loop)",
        max_abs_err=err5, ms=ms5,
        plain_ms=cuda_ms(lambda: beam._scan_plain(
            *one, EF, W, spill, steps_w, False), iters=2),
        **bound(scored1 * 3.0 * DIM, "f32", seg_bytes),
        library_ms=None, matmul_ms=None, matmul_of=None,
        steps_mean=steps1, scored_mean=scored1,
        us_per_step=ms5 / steps1 * 1e3,
        round_trip_us=round_trip_us,
        latency_bound_ms=steps1 * round_trip_us / 1e3,
    )


def dependent_round_trip_us(g, rows) -> float:
    """A step's dependent round trip (a row's neighbour ids, then one
    neighbour's row of ``rows``, f32 values or packed words): the pointer
    chase of probes/k5_profile.py, 4,096 hops from each of 8 rows, the
    median in microseconds."""
    from pgvector_rx_tpu_torch.probes.k5_profile import _chase_library

    chase, hop = _chase_library(), torch.zeros(2, dtype=torch.int64,
                                               device=g.device)
    per_hop = []
    for start in np.random.default_rng(3).integers(0, g.cap, 8):
        rc = chase.pgv_chase(g.neighbors0.data_ptr(),
                             rows.view(torch.float32).data_ptr(),
                             g.neighbors0.shape[1], rows.shape[1], g.cap,
                             4096, int(start), 1, hop.data_ptr())
        if rc != 0:
            raise RuntimeError(f"the chase kernel failed ({rc})")
        torch.cuda.synchronize()
        per_hop.append(int(hop[0]) / 4096)
    us = float(np.median(per_hop)) / 1e3
    log(f"dependent round trip (ids -> a row of {rows.shape[1]} 32-bit "
        f"values): {us * 1e3:.1f} ns (median of 8 chases of 4,096 hops: "
        f"{per_hop})")
    return us


def word_latency_bound(kr, steps, land, entry_level, round_trip_us):
    """Adds a word walk's latency bound to its row ``kr``: the largest
    query's steps and descent iterations (its moves and one final look a
    layer), each two dependent round trips (ids, then flags and rows)."""
    chain = (steps.long() + land[:, 3].long() + entry_level).max()
    kr["round_trip_us"] = round_trip_us
    kr["latency_bound_ms"] = float(chain) * 2 * round_trip_us / 1e3
    kr["latency_share"] = kr["latency_bound_ms"] / kr["ms"]
    log(f"{kr['name']}: latency bound {kr['latency_bound_ms']:.4f} ms "
        f"({int(chain)} dependent steps x 2 trips x {round_trip_us * 1e3:.1f}"
        f" ns), share {kr['latency_share']:.4f}")


def tf32_tie_pair(bf, lo: float):
    """Two f32 values one ulp apart above ``lo`` (x_a > x_b) that K1's
    3xTF32 split (big + small of ``_tf32_split``) cannot tell apart."""
    u = np.arange(1 << 14, dtype=np.int64) + int(np.float32(lo).view(np.int32))
    vals = torch.from_numpy(u.astype(np.int32)).view(torch.float32)
    big, small = bf._tf32_split(vals)
    approx = (big.double() + small.double()).numpy()
    i = int(np.nonzero(approx[1:] == approx[:-1])[0][0])
    return float(vals[i + 1]), float(vals[i])


def k1_near_tie_check(bf, dev) -> None:
    """Fault 3b: K1's top-64 of a unit-axis query over rows whose ranks 64
    and 65 are one ulp apart (7.8e-3 at |x| ~ 1e5) and equal after the
    tf32 split, rank 65 in the first 64-row split. Every score is exact in
    FP32 and float64, so the wrapper (K1's select form past k = 60: every
    row's FP32 score) must return the float64 set; the control, one call of
    the tensor-core form at k = 64 (no spare place, the path before fault
    3b's repair), is reported."""
    n, d = 1000, 64
    x_a, x_b = tf32_tie_pair(bf, 98304.0)
    g = torch.Generator().manual_seed(65)
    x0 = torch.cat([
        99000.0 + 10.0 * torch.arange(63, dtype=torch.float32),
        97000.0 - 10.0 * torch.arange(n - 65, dtype=torch.float32),
    ])[torch.randperm(n - 2, generator=g)]
    x = torch.randn(n, d, generator=g)
    x[:, 0] = torch.cat([torch.tensor([x_b]), x0[:63], torch.tensor([x_a]),
                         x0[63:]])
    q = torch.zeros(1, d)
    q[0, 0] = 1.0
    ref = torch.argsort(-(x.double() @ q.double().T)[:, 0])[:64]
    want = set(ref.tolist())
    xc, qc = x.to(dev), q.to(dev)
    _, ki = bf.ip_topk(xc, qc, 64)
    _, ci = bf._surrogate_topk_cuda(xc, torch.zeros(n, device=dev), qc, 64)
    got, ctl = set(ki.cpu()[0].tolist()), set(ci.cpu()[0].tolist())
    log(f"K1 top-64 near tie at ranks 64/65 (fault 3b): the wrapper's set "
        f"{'equals' if got == want else 'differs from'} the float64 set; the "
        f"control (one call at k = 64, no spare place) "
        f"{'equals' if ctl == want else 'differs from'} it "
        f"(rank 64 {'kept' if 64 in ctl else 'lost'}, rank 65 "
        f"{'kept' if 0 in ctl else 'dropped'})")
    if got != want:
        raise RuntimeError("K1's top-64 loses the near tie at ranks 64/65")


class SectionTimer:
    """Device time of some ``DeviceBuilder`` steps during a build: each
    wrapped method records a CUDA event pair on the current stream around
    its launches; the pairs are read after the build's final sync, so the
    build itself makes no extra sync. A section's time is its span on the
    device's timeline, idle gaps between its launches included."""

    def __init__(self, cls, names):
        self.cls, self.names = cls, names
        self.pairs = {n: [] for n in names}

    def __enter__(self):
        self.orig = {n: getattr(self.cls, n) for n in self.names}
        for n in self.names:
            def wrapped(obj, *a, _f=self.orig[n], _n=n, **kw):
                s = torch.cuda.Event(enable_timing=True)
                e = torch.cuda.Event(enable_timing=True)
                s.record()
                out = _f(obj, *a, **kw)
                e.record()
                self.pairs[_n].append((s, e))
                return out
            setattr(self.cls, n, wrapped)
        return self

    def __exit__(self, *exc):
        for n, f in self.orig.items():
            setattr(self.cls, n, f)
        return False

    def seconds(self) -> dict:
        torch.cuda.synchronize()
        return {n: sum(s.elapsed_time(e) for s, e in p) / 1e3
                for n, p in self.pairs.items()}


def timed_build(HnswIndex, db, x, metric, params, dev, n, tag,
                consume_input=False, out=None):
    """A serving-only device build from ``x`` (a CUDA tensor; a numpy 0/1
    array for the bit kind): seconds, rows/s, peak memory, the device time
    of the candidate step (the beam ground inside it) and of the commit;
    then the graph's invariants. Returns (index, graph, the beam ground's
    (device seconds, batches)); ``out["s"]``, where given, takes the build
    seconds."""
    with Phase(f"{tag} device build, {n:,} x {x.shape[1]}-d {metric}"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        steps = ("_score_select_step", "_beam_ground_candidates",
                 "_commit_all_step")
        with SectionTimer(db.DeviceBuilder, steps) as st:
            t0 = time.time()
            idx = HnswIndex.build(x, metric=metric, params=params,
                                  method="device", host_graph=False,
                                  device=dev, seed=1,
                                  consume_input=consume_input)
            torch.cuda.synchronize()
            dt = time.time() - t0
        if out is not None:
            out["s"] = dt
        sec = st.seconds()
        log(f"{tag} device build: {dt:.3f} s, {n / dt:.1f} rows/s, peak "
            f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f" GiB; device time: candidates and selection "
            f"{sec['_score_select_step']:.3f} s (of which the beam ground "
            f"{sec['_beam_ground_candidates']:.3f} s in "
            f"{len(st.pairs['_beam_ground_candidates'])} batches), commit "
            f"{sec['_commit_all_step']:.3f} s")
        g = idx.device_graph()
        check_graph(g, M, n)
    return idx, g, (sec["_beam_ground_candidates"],
                    len(st.pairs["_beam_ground_candidates"]))


def coarse_scores(rows, a, live, q, slots, l2):
    """[B, S] float64 scores of the bf16 operands of K7's function at
    ``slots`` (-1: none), inf where none or not live."""
    s = slots.clamp(min=0)
    dots = (rows[s].double() * q.to(torch.bfloat16).double()[:, None, :]
            ).sum(-1)
    sc = a.double()[s] - (2.0 * dots if l2 else dots)
    return torch.where((slots >= 0) & live[s], sc, float("inf"))


def coarse_agreement(rows, a, live, q, slots_k, slots_p, l2):
    """Per query of two seed lists (the kernel's, the plain version's):
    the same finite count, the float64 scores of their slots equal in
    sorted order to 1e-5 of the scale, and slots that differ only where
    their score ties the S-th. Returns (agreeing queries [B] bool, max abs
    difference of the sorted scores)."""
    sk = coarse_scores(rows, a, live, q, slots_k, l2).cpu().numpy()
    sp = coarse_scores(rows, a, live, q, slots_p, l2).cpu().numpy()
    ik, ip_ = slots_k.cpu().numpy(), slots_p.cpu().numpy()
    ok = np.zeros(sk.shape[0], bool)
    err = 0.0
    for b in range(sk.shape[0]):
        fk, fp = np.isfinite(sk[b]), np.isfinite(sp[b])
        if fk.sum() != fp.sum():
            continue
        a_s, p_s = np.sort(sk[b][fk]), np.sort(sp[b][fp])
        if not fp.any():
            ok[b] = True
            continue
        tol = 1e-5 * max(1.0, float(np.abs(p_s).max()))
        diff = np.abs(a_s - p_s)
        err = max(err, float(diff.max()))
        sc = dict(zip(ik[b].tolist(), sk[b].tolist()))
        sc.update(zip(ip_[b].tolist(), sp[b].tolist()))
        odd = set(ik[b][fk].tolist()) ^ set(ip_[b][fp].tolist())
        ok[b] = bool((diff <= tol).all()) and all(
            abs(sc[e] - p_s[-1]) <= tol for e in odd)
    return ok, err


def k7_check(bf, device_mod, g, q1, name, dim):
    """K7 against its plain version over graph ``g``'s upper rows for the
    queries ``q1`` (1,024) and for one query (the beam scan's seeding),
    S = 8: the same seeds on every query but for ties (the check must
    reject the plain top-9 with its 8th seed dropped); timed beside the
    route it replaces (the plain version: the f32 product of the rounded
    operands, the mask, ``torch.topk``, each also alone), at 1,024 queries
    and at one, and its bound. Returns its kernels row."""
    ids, rows, a, _ = device_mod.upper_row_arrays(g)
    trav, live = g.traversable, g.traversable[ids]
    l2, S = g.metric == "l2", 8
    args = (rows, a, ids, trav)
    sk, ik = bf._coarse_cuda(*args, q1, S, l2)
    sp, _ = bf._coarse_plain(*args, q1, S, l2)
    s9, _ = bf._coarse_plain(*args, q1, S + 1, l2)
    ctl = torch.cat([s9[:, : S - 1], s9[:, S:]], 1)
    ok, err = coarse_agreement(rows, a, live, q1, sk, sp, l2)
    ok_c, _ = coarse_agreement(rows, a, live, q1, ctl, sp, l2)
    ok1, _ = coarse_agreement(rows, a, live, q1[:1],
                              bf._coarse_cuda(*args, q1[:1], S, l2)[0],
                              bf._coarse_plain(*args, q1[:1], S, l2)[0], l2)
    if not torch.equal(torch.where(sk >= 0, ids[sk.clamp(min=0)], -1), ik):
        raise RuntimeError(f"{name}: seed ids are not the slots' elements")
    log(f"{name}: {ok.mean():.4f} of {q1.shape[0]} queries equal to the "
        f"plain version but for ties (one query: {bool(ok1.all())}), max "
        f"abs err {err}; control with the 9th seed for the 8th: "
        f"{ok_c.mean():.4f}")
    if not ok.all() or not ok1.all():
        raise RuntimeError(f"{name} disagrees with its plain version")
    if ok_c.all():
        raise RuntimeError(f"the {name} check passes a wrong seed")
    qb = q1.to(torch.bfloat16).float()
    dots = qb @ rows.float().T
    scores = torch.where(live[None, :], a[None, :] - (
        2.0 * dots if l2 else dots), float("inf"))
    split = dict(
        product_ms=cuda_ms(lambda: q1.to(torch.bfloat16).float()
                           @ rows.to(torch.bfloat16).float().T),
        mask_ms=cuda_ms(lambda: torch.where(
            trav[ids][None, :], a[None, :] - (2.0 * dots if l2 else dots),
            float("inf"))),
        topk_ms=cuda_ms(lambda: torch.topk(scores, S, dim=1, largest=False,
                                           sorted=True)))
    del dots, scores
    U, B = rows.shape[0], q1.shape[0]
    plain_ms = cuda_ms(lambda: bf._coarse_plain(*args, q1, S, l2))
    row = dict(
        name=name, route="cuda", source=CSRC + "k7_coarse.cu",
        replaces=f"{JAX_DEVICE}:828 (_search_batch_coarse's sweep, mask "
                 "and top_k, XLA; the port's torch route)",
        max_abs_err=err,
        ms=cuda_ms(lambda: bf._coarse_cuda(*args, q1, S, l2)),
        one_query_ms=cuda_ms(lambda: bf._coarse_cuda(*args, q1[:1], S, l2)),
        one_query_plain_ms=cuda_ms(
            lambda: bf._coarse_plain(*args, q1[:1], S, l2)),
        plain_ms=plain_ms, library_ms=plain_ms,
        library_of="the route it replaces (its plain version): the f32 "
                   "product of the bf16-rounded operands, a - 2 q.x, the "
                   "mask, torch.topk",
        route_split=split, upper_rows=U,
        **bound(2.0 * B * U * dim, "bf16",
                U * dim * 2 + U * (4 + 8 + 1) + B * dim * 2 + B * S * 16))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"{name}: kernel {row['ms']:.4f} ms (one query "
        f"{row['one_query_ms']:.4f}), the route {plain_ms:.4f} ms (product "
        f"{split['product_ms']:.4f}, mask {split['mask_ms']:.4f}, topk "
        f"{split['topk_ms']:.4f}; one query "
        f"{row['one_query_plain_ms']:.4f}), bound {row['bound_ms']:.4f} ms "
        f"({row['bound_by']}), share {row['share_of_bound']:.4f}, "
        f"{U:,} upper rows")
    return row


class K8Capture:
    """Keeps the inputs of the ``at``-th call of
    ``DeviceBuilder._beam_ground_candidates`` in a build (the layer-0
    tables cloned: the batch's commit changes them), for K8's check
    against its plain version at the main path's shapes."""

    def __init__(self, db, at):
        self.cls, self.at, self.n, self.args = db.DeviceBuilder, at, 0, None

    def __enter__(self):
        self.orig = orig = self.cls._beam_ground_candidates

        def wrapped(obj, data, arrays, q_rows, seed_d, seed_ids, *a, **kw):
            self.n += 1
            if self.n == self.at:
                self.args = (obj, data, dataclasses.replace(
                    arrays, nb0_ids=arrays.nb0_ids.clone(),
                    alive=arrays.alive.clone(), entry=arrays.entry.clone()),
                    q_rows.clone(), seed_d.clone(), seed_ids.clone())
            return orig(obj, data, arrays, q_rows, seed_d, seed_ids, *a, **kw)
        self.cls._beam_ground_candidates = wrapped
        return self

    def __exit__(self, *exc):
        self.cls._beam_ground_candidates = self.orig
        return False


#: K8's time per 1,024-row batch at 768-d before this kernel (the torch
#: ops' device span in phase 18's build; PERF.md, NVIDIA H100 80GB HBM3 at
#: 700 W)
K8_EARLIER_MS = 22.7234


def k8_check(db, cap, ground_s, batches):
    """K8 against its plain version on a batch captured from a build
    (``K8Capture``), in its three merges: ids equal but for ties and
    distances to rtol 1e-5 on every row (each check must reject the plain
    walk cut to a quarter of its steps even at 0.99 of the rows); each timed beside its
    bound, counted from the rows this batch's walk scores. Returns the
    rows (the sort merge's first, with the build's span per batch)."""
    b, data, arrays, q, sd, sids = cap.args
    st = b.settings
    steps, E = st.beam_steps or 16, st.beam_expand
    B, dim = q.shape
    W, L = b.efc, arrays.nb0_ids.shape[1]
    rows = []
    for tag, dedup, merge in (("sort", True, "sort"),
                              ("nodedup", False, "sort"),
                              ("rank", True, "rank")):
        bd, bkey = b._beam_ground_seeds(data, arrays, q, sd, sids, merge)
        args = (data.vectors_bf16, arrays.nb0_ids, arrays.alive, b.cap,
                b.metric, q, bd, bkey)
        kw = dict(expand=E, dedup=dedup, merge=merge)
        dk, ik = db._beam_ground_cuda(*args, steps, **kw)
        scored = []
        dp, ip_ = db._beam_ground_plain(*args, steps, scored=scored, **kw)
        dc, ic = db._beam_ground_plain(*args, steps // 4, **kw)
        dk, ik, dp, ip_, dc, ic = (t.cpu().numpy() for t in
                                   (dk, ik, dp, ip_, dc, ic))
        ok, err = walk_agreement(ik, dk, ip_, dp)
        ok_c, _ = walk_agreement(ic, dc, ip_, dp)
        n_scored = float(sum(int(t) for t in scored))
        name = "k8_beam_ground" + ("" if tag == "sort" else f"_{tag}")
        log(f"{name}: {ok.mean():.4f} of {B} rows equal to the plain walk "
            f"but for ties (max abs err {err}); control cut to "
            f"{steps // 4} steps {ok_c.mean():.4f}; "
            f"{n_scored / B:.1f} rows scored a row")
        if not ok.all():
            raise RuntimeError(f"{name} disagrees with its plain version")
        if ok_c.mean() >= 0.99:
            raise RuntimeError(f"the {name} check passes a walk cut short")
        nbytes = (B * steps * E * L * 5 + n_scored * dim * 2
                  + B * (dim * 4 + W * 8 + W * 12))
        row = dict(
            name=name, route="cuda", source=CSRC + "k8_beam_ground.cu",
            replaces="pgvector_rx_tpu/graph/device_build.py:1052 (the beam "
                     f"ground's {tag} walk, XLA; the port's torch ops)",
            max_abs_err=err,
            ms=cuda_ms(lambda: db._beam_ground_cuda(*args, steps, **kw)),
            plain_ms=cuda_ms(lambda: db._beam_ground_plain(*args, steps,
                                                           **kw), 3),
            library_ms=None, scored_per_row=n_scored / B,
            **bound(2.0 * n_scored * dim, "f32", nbytes))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        if tag == "sort":
            row["span_ms_per_batch"] = ground_s / batches * 1e3
        log(f"{name}: kernel {row['ms']:.4f} ms a {B}-row batch, plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({row['bound_by']}), share {row['share_of_bound']:.4f}"
            + (f"; the build's span {row['span_ms_per_batch']:.4f} ms a "
               f"batch over {batches} batches (the torch ops before this "
               f"kernel: {K8_EARLIER_MS} ms, PERF.md)"
               if tag == "sort" else ""))
        rows.append(row)
    return rows


def kernel_row(name, err, ms, plain_ms, bnd):
    row = dict(name=name, max_abs_err=err, ms=ms, plain_ms=plain_ms, **bnd)
    row["share_of_bound"] = row["bound_ms"] / ms
    log(f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
        f"{row['bound_ms']:.4f} ms ({row['bound_by']}, {row['bound_peak']}), "
        f"share {row['share_of_bound']:.4f}, max abs err {err}")
    return row


def k8_row(db, ground_s, batches, b=CHUNK, dim=D768, name="k8_beam_ground"):
    """The beam ground of a 768-d build (the seeds in torch ops, then K8):
    its device span per batch beside the bound of one b-row batch, worked
    out from ``DeviceBuilder._beam_ground_candidates`` at the default
    settings (either merge does the same gathers and scores): each of 16
    steps gathers, for each of the ``beam_expand`` expanded entries, its
    2m layer-0 ids (4 bytes), their live flags (1 byte) and their bf16
    rows (every slot: the most a batch can read; ``k8_check`` counts the
    rows a captured batch scores), and scores them in f32 (a multiply-add
    per value); each query reads its f32 row once and writes
    ef_construction (distance, id) pairs."""
    st = db.BuildSettings()
    slots = b * (st.beam_steps or 16) * st.beam_expand * 2 * M
    nbytes = slots * (4 + 1 + dim * 2) + b * (dim * 4 + EF_CONSTRUCTION * 12)
    row = dict(
        name=name, route="cuda",
        source=CSRC + "k8_beam_ground.cu (after the seeds' torch ops, "
               "DeviceBuilder._beam_ground_seeds)",
        replaces="pgvector_rx_tpu/graph/device_build.py:1052 (the beam "
                 "ground, XLA)",
        launches=batches, ms=ground_s / batches * 1e3,
        ms_of="device span per batch (CUDA events, idle gaps included)",
        library_ms=None, **bound(2.0 * slots * dim, "f32", nbytes))
    row["share_of_bound"] = row["bound_ms"] / row["ms"]
    log(f"{name}: {row['ms']:.4f} ms per batch (span), bound of a "
        f"{b}-row batch {row['bound_ms']:.4f} ms ({row['bound_by']}, "
        f"{nbytes:,} bytes), share {row['share_of_bound']:.4f}")
    return row


def cosine_768(HnswIndex, IndexParams, make_dataset, device_mod, db, bf,
               beam, dev, kernels):
    """Phase 18: BASELINE's 768-d cosine configuration at 1,000,000 rows,
    full width, on the card; then K8 on a batch of its build (the 600th),
    K1, K2, K4, K7 and K1's select form at d = 768 against their plain
    versions; K8's sort merge goes to ``kernels``. Returns phase 27's 768-d rows (a copy of
    the first ``N27``, raw) and the normalized queries."""
    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)
    with Phase("18 data, 1,000,000 x 768-d"):
        data, queries = make_dataset(N768, D768, N_QUERIES, seed=0)
        x = torch.from_numpy(data).to(dev)
        del data
        qn = torch.from_numpy(queries).to(dev)
        qn = (qn / qn.norm(dim=1, keepdim=True)).contiguous()
    bf.reset_launches()
    with K8Capture(db, at=600) as cap:
        idx, g, (ground_s, ground_batches) = timed_build(
            HnswIndex, db, x, "cosine", params, dev, N768, "18")
    x27 = x[:N27].clone()
    del x
    torch.cuda.empty_cache()
    with Phase("18 ground truth (K1 cosine_topk)"):
        xv = g.values[:N768]
        gt = torch.cat([bf.cosine_topk(xv, qn[s : s + CHUNK], K)[1]
                        for s in range(0, N_QUERIES, CHUNK)]).cpu().numpy()
        ref = 1.0 - qn[:64].double() @ xv.double().T
        ref_d = torch.topk(ref, K, dim=1, largest=False).values.cpu().numpy()
        gt_d = np.sort(torch.gather(ref, 1, torch.from_numpy(gt[:64]).to(
            dev).long()).cpu().numpy(), axis=1)
        del ref
        if (gt < 0).any() or not np.allclose(gt_d, ref_d, rtol=1e-5,
                                             atol=1e-5):
            raise RuntimeError("768-d ground truth disagrees with float64")
        log(f"gt {gt.shape}, float64 check on 64 queries ok")
    emit = g.emit_tid.cpu().numpy()
    serve_engines(idx, qn, recall_of(emit, emit[gt]), bf, device_mod, "18")
    launches = dict(bf.LAUNCHES)
    log(f"768-d path launches: {launches}")
    for name in ("k1_topk", "k2_binned", "k4_beam", "k7_coarse",
                 "k8_beam_ground"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the 768-d path")

    with Phase("18 K8 vs plain on a batch of the build"):
        k8 = k8_check(db, cap, ground_s, ground_batches)
        cap.args = None
        torch.cuda.empty_cache()
        kernels["k8_beam_ground"] = dict(
            k8[0], launches=launches["k8_beam_ground"])
    rows = []
    with Phase("18 kernels vs plain at d = 768"):
        q1 = qn[:CHUNK].contiguous()
        live = g.traversable & (g.tid_count > 0)
        a = torch.where(live, 0.0, bf._NEG_BIG).contiguous()
        x32, vb = g.values, g.values_bf16
        n_rows, b1 = x32.shape[0], q1.shape[0]
        out_bytes = b1 * K * 8
        k1_d, k1_i = bf._surrogate_topk_cuda(x32, a, q1, K)
        p1_d, p1_i = bf._surrogate_topk_plain(x32, a, q1, K)
        err1, ok1 = k1_agreement(k1_d, k1_i, p1_d.cpu().numpy(),
                                 p1_i.cpu().numpy(), 1.0)
        if not ok1:
            raise RuntimeError(f"K1 at d = 768 disagrees with its plain "
                               f"version (max abs err {err1})")
        rows.append(kernel_row(
            "k1_topk", err1,
            cuda_ms(lambda: bf._surrogate_topk_cuda(x32, a, q1, K)),
            cuda_ms(lambda: bf._surrogate_topk_plain(x32, a, q1, K), 3),
            bound(3 * 2.0 * b1 * n_rows * D768, "tf32",
                  (n_rows * D768 + n_rows + b1 * D768) * 4 + out_bytes)))
        qb = q1.to(torch.bfloat16)
        k2_d, k2_i = bf._binned_cuda(vb, a, qb, K, 1024)
        p2_d, p2_i = bf._binned_plain(vb, a, q1, K, 1024)
        err2, ok2 = k2_agreement(k2_d, k2_i, p2_d.cpu().numpy(),
                                 p2_i.cpu().numpy(), 1.0)
        if not ok2:
            raise RuntimeError(f"K2 at d = 768 disagrees with its plain "
                               f"version (max abs err {err2})")
        rows.append(kernel_row(
            "k2_binned", err2,
            cuda_ms(lambda: bf._binned_cuda(vb, a, qb, K, 1024)),
            cuda_ms(lambda: bf._binned_plain(vb, a, q1, K, 1024), 3),
            bound(2.0 * b1 * n_rows * D768, "bf16",
                  (n_rows * D768 + b1 * D768) * 2 + n_rows * 4 + out_bytes)))
        upper = device_mod._coarse_upper(g)
        s_ids, s_d = device_mod._coarse_seeds(g, q1, upper[0], upper[1], 8)
        s_ids = s_ids.to(torch.int32).contiguous()
        walk = (g.values, g.neighbors0, g.traversable, None, "cosine", q1,
                s_ids, s_d)
        kw = dict(width=EF, spill=0, max_steps=4 * EF + 32, scan=False)
        raw_k = beam._walk_cuda(*walk, **kw)
        raw_p = beam._walk_plain(*walk, **kw)
        kd, ki, _ = (t.cpu().numpy() for t in beam._serve_finish(*raw_k))
        pd, pi, _ = (t.cpu().numpy() for t in beam._serve_finish(*raw_p))
        ok4, err4 = walk_agreement(ki, kd, pi, pd)
        steps = float(raw_k[4].sum())
        scored = float(raw_k[5].sum())
        log(f"K4 at d = 768: {ok4.mean():.4f} of queries equal but for ties, "
            f"{steps / CHUNK:.1f} steps and {scored / CHUNK:.1f} rows scored "
            "per query")
        if ok4.mean() < 0.99:
            raise RuntimeError("K4 at d = 768 disagrees with its plain version")
        rows.append(kernel_row(
            "k4_beam", err4, cuda_ms(lambda: beam._walk_cuda(*walk, **kw)),
            cuda_ms(lambda: beam._walk_plain(*walk, **kw), 2),
            bound(scored * 3.0 * D768, "f32",
                  walk_gather_bytes(steps, scored, g.neighbors0.shape[1], 1,
                                    D768)
                  + CHUNK * (D768 * 4 + s_ids.shape[1] * 8 + EF * 8 + 8))))
        rows.append(k4_bf16_768(g, walk, kw, beam))
        rows.append(k7_check(bf, device_mod, g, q1, "k7_coarse", D768))
        err = select_vs_plain(bf, x32, a, qn[:3].contiguous(), 100, "18")
        rows.append(kernel_row(
            "k1_select", err,
            cuda_ms(lambda: bf._select_topk_cuda(x32, a, qn[:1], 100)),
            cuda_ms(lambda: bf._surrogate_topk_plain(x32, a, qn[:1], 100)),
            select_bound(n_rows, D768, 1, 100)))
        rows[-1]["library_ms"] = cuda_ms(
            lambda: library_topk(x32, a, qn[:1], 100))
        log(f"k1_select at d = 768, one query, k = 100: library "
            f"({LIBRARY_TOPK}) {rows[-1]['library_ms']:.4f} ms")
    log(json.dumps({"d768": rows}))
    log(json.dumps({"k8": k8}))
    del idx, g, xv
    torch.cuda.empty_cache()
    return x27, qn


def k4_bf16_768(g, walk, kw, beam):
    """K4 ranking in bf16 (the rows' bf16 copy) at d = 768: held to its
    plain version on 64 queries (ids equal but for ties, steps and rows
    scored equal query by query), timed at 1,024 in turns with the f32
    walk (f32, bf16, bf16, f32)."""
    rk = dict(rank=g.values_bf16)
    w64 = (*walk[:5], *(t[:64] for t in walk[5:]))
    raw_k = beam._walk_cuda(*w64, **kw, **rk)
    raw_p = beam._walk_plain(*w64, **kw, **rk)
    kd, ki, _ = (t.cpu().numpy() for t in beam._serve_finish(*raw_k))
    pd, pi, _ = (t.cpu().numpy() for t in beam._serve_finish(*raw_p))
    ok, err = walk_agreement(ki, kd, pi, pd)
    same = float(((raw_k[4] == raw_p[4]) & (raw_k[5] == raw_p[5]))
                 .float().mean())
    log(f"K4 bf16 at d = 768 vs plain (64 queries): {ok.mean():.4f} equal "
        f"but for ties, {same:.4f} equal steps and rows scored")
    if ok.mean() < 0.99 or same < 0.99:
        raise RuntimeError("K4 bf16 at d = 768 disagrees with its plain "
                           "version")
    full = beam._walk_cuda(*walk, **kw, **rk)
    steps, scored = float(full[4].sum()), float(full[5].sum())
    turns = {"f32": [], "bf16": []}
    for name in ("f32", "bf16", "bf16", "f32"):
        mode = rk if name == "bf16" else {}
        turns[name].append(cuda_ms(lambda: beam._walk_cuda(*walk, **kw,
                                                           **mode)))
    ms = float(np.mean(turns["bf16"]))
    row = kernel_row(
        "k4_beam_bf16", err, ms,
        cuda_ms(lambda: beam._walk_plain(*walk, **kw, **rk), 2),
        bound(scored * 3.0 * D768, "f32",
              mode_bytes(steps, scored, g.neighbors0.shape[1], CHUNK,
                         row_bytes=D768 * 2, rank_rows=EF,
                         seeds=walk[6].shape[1], d=D768)))
    row.update(f32_walk_ms_in_turns=float(np.mean(turns["f32"])),
               turns_ms=turns, steps_mean=steps / CHUNK,
               scored_mean=scored / CHUNK, steps_scored_equal=same)
    log(f"K4 at d = 768 in turns: bf16 {ms:.4f} ms, f32 "
        f"{row['f32_walk_ms_in_turns']:.4f} ms ({turns})")
    return row


class build_env:
    """``PGV_BUILD_*`` knobs set for the builds inside the block, as a user
    sets them (the port reads them per build), and restored after it."""

    def __init__(self, knobs: dict):
        self.knobs = knobs

    def __enter__(self):
        self.saved = {k: os.environ.get(k) for k in self.knobs}
        os.environ.update(self.knobs)
        return self

    def __exit__(self, *exc):
        for k, v in self.saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        return False


def knob_build(HnswIndex, db, x, metric, dev, n, tag, arm=None,
               consume_input=False, out=None):
    """One phase-27 build (``timed_build``, its knobs ``KNOB_ARMS[arm]``):
    (index, graph, the beam ground's (seconds, batches), peak device memory
    above what was allocated before it, in GiB); ``out["s"]``, where given,
    takes the build seconds."""
    from pgvector_rx_tpu_torch import IndexParams

    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    with build_env(KNOB_ARMS[arm] if arm else {}):
        idx, g, ground = timed_build(HnswIndex, db, x, metric, params, dev, n,
                                     tag, consume_input=consume_input,
                                     out=out)
    peak = (torch.cuda.max_memory_allocated(dev) - base) / 2**30
    log(f"{tag}: peak device memory {peak:.3f} GiB above the "
        f"{base / 2**30:.3f} GiB allocated before the build")
    return idx, g, ground, peak


def beam_recall(device_mod, index, q, recall, tag):
    """recall@10 of ``serve_topk`` beam at ef=40, against the floor."""
    d, ids, dt = timed_serve(device_mod, index, q, "beam")
    rec = recall(ids)
    log(f"{tag} beam: recall@10={rec:.4f} qps={q.shape[0] / dt:.1f}")
    if d.shape != (q.shape[0], K) or not np.isfinite(d).all():
        raise RuntimeError(f"{tag}: non-finite or misshapen beam output")
    if rec < FLOORS["beam"]:
        raise RuntimeError(f"{tag}: beam recall {rec} < {FLOORS['beam']}")
    return rec


def mean_degree(g, n):
    live = g.traversable[:n]
    return float((g.neighbors0[:n][live] >= 0).sum(1).float().mean())


def build_knobs(HnswIndex, device_mod, db, bf, data, queries, q_dev, gt,
                main_build, x27, q768, dev):
    """Phase 27: the JAX package's build knobs in the port's device build,
    each arm built serving-only on the card (m=16, ef_construction=64,
    seed 1) with build s, rows/s, peak memory and beam recall@10 at ef=40
    (floor ``FLOORS["beam"]``). ``main_build``: phase 3's seconds, peak
    GiB and beam recall, printed beside arm 1."""
    # arm 1: IVF hop 32 at the main path's size, beside phase 3's build
    x = torch.from_numpy(data[:N_ROWS]).to(dev)
    hop = {}
    idx, g, _, peak = knob_build(HnswIndex, db, x, "l2", dev, N_ROWS,
                                 "27 hop32", "hop32", out=hop)
    del x
    rec = beam_recall(device_mod, idx, q_dev,
                      recall_of(g.emit_tid.cpu().numpy(), gt), "27 hop32")
    log(f"27 hop32 against phase 3's default build: beam recall {rec:.4f} "
        f"against {main_build['recall']:.4f}, build {hop['s']:.3f} s against "
        f"{main_build['s']:.3f}, peak {peak:.3f} GiB above the allocation "
        f"before the build against {main_build['above']:.3f}")
    del idx, g
    torch.cuda.empty_cache()

    # arm 2: RobustPrune's alpha at N27 rows, beside the default
    with Phase("27 ground truth at 262,144 x 128-d"):
        gt27 = ground_truth(bf, data[:N27], queries, q_dev)
    x = torch.from_numpy(data[:N27]).to(dev)
    for arm in (None, "alpha1.2"):
        tag = f"27 {arm or 'default'} at {N27:,}"
        idx, g, _, _ = knob_build(HnswIndex, db, x, "l2", dev, N27, tag, arm)
        rec = beam_recall(device_mod, idx, q_dev,
                          recall_of(g.emit_tid.cpu().numpy(), gt27), tag)
        log(f"{tag}: mean layer-0 out-degree {mean_degree(g, N27):.3f}, "
            f"beam recall {rec:.4f}")
        del idx, g
    del x
    torch.cuda.empty_cache()

    # arm 3: the 768-d beam ground, the sort merge, the rank merge, and
    # the sort merge consuming its input
    rows, peaks = [], {}
    for arm, consume in ((None, False), ("rank", False), (None, True)):
        tag = "consume_input" if consume else arm or "sort"
        nbytes = x27.untyped_storage().nbytes()
        idx, g, (ground_s, batches), peaks[tag] = knob_build(
            HnswIndex, db, x27, "cosine", dev, N27, f"27 {tag}", arm,
            consume_input=consume)
        if arm is None and not consume:
            with Phase("27 ground truth at 262,144 x 768-d (K1 cosine_topk)"):
                gt768 = torch.cat([
                    bf.cosine_topk(g.values[:N27], q768[s : s + CHUNK], K)[1]
                    for s in range(0, N_QUERIES, CHUNK)]).cpu().numpy()
        beam_recall(device_mod, idx, q768,
                    recall_of(g.emit_tid.cpu().numpy(), gt768),
                    f"27 768-d {tag}")
        if consume:
            left = x27.untyped_storage().nbytes()
            log(f"27 consume_input: the caller's tensor holds {left} bytes "
                f"of its {nbytes:,} (shape {tuple(x27.shape)}); peak "
                f"{peaks[tag]:.3f} GiB against the sort build's "
                f"{peaks['sort']:.3f} (drop {peaks['sort'] - peaks[tag]:.3f} "
                f"GiB, one corpus copy {nbytes / 2**30:.3f})")
            if left or x27.numel():
                raise RuntimeError("consume_input left the caller's storage")
        else:
            rows.append(k8_row(db, ground_s, batches,
                               name=f"k8_beam_ground_{tag}_{N27}"))
        del idx, g
        torch.cuda.empty_cache()
    log(json.dumps({"k8_builds": rows}))


def l1_path(HnswIndex, IndexParams, device_mod, db, bf, data, q_dev, dev):
    """Phase 19: an l1 index of the first N_L1 rows of the 128-d corpus,
    built on the card (the beam ground), its exact engine against a
    float64 l1 top-10 on the card, the beam engine's recall, and the l1
    sweep timed beside its bound."""
    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)
    log(f"cut: the l1 path builds the first {N_L1:,} of the 1,000,000 "
        "rows (the run's time); the descent still builds three quarters")
    x = torch.from_numpy(data[:N_L1]).to(dev)
    bf.reset_launches()
    idx, g, _ = timed_build(HnswIndex, db, x, "l1", params, dev, N_L1, "19")
    sweep = device_mod.l1_sweep_topk
    calls = [0]

    def counted(*a, **kw):
        calls[0] += 1
        return sweep(*a, **kw)

    q1 = q_dev[:CHUNK].contiguous()
    with Phase("19 l1 engines"):
        device_mod.l1_sweep_topk = counted
        try:
            d, ids = device_mod.serve_topk(idx, q1, K, engine="exact")
            _, ids_b = device_mod.serve_topk(idx, q1, K, engine="beam", ef=EF)
        finally:
            device_mod.l1_sweep_topk = sweep
        ref = torch.cdist(q1.double(), x.double(), p=1)
        ref_d, ref_i = torch.topk(ref, K, dim=1, largest=False)
        del ref
        ref_d, ref_i = ref_d.cpu().numpy(), ref_i.cpu().numpy()
        emit = g.emit_tid.cpu().numpy()
        tids = np.where(ids >= 0, emit[np.maximum(ids, 0)], -1)
        tol = 1e-5 * np.abs(ref_d).max(axis=1) + 1e-4
        bad = tie_aware_mismatch(tids, d.astype(np.float64), ref_i, ref_d,
                                 tol)
        rec = recall_of(emit, ref_i)(ids_b)
        log(f"l1 exact engine: {bad} of {CHUNK} rows differ from the float64 "
            f"l1 top-{K} other than at ties, max abs distance err "
            f"{float(np.abs(d - ref_d).max())}; beam engine (ef={EF}) recall@10 "
            f"{rec:.4f}; l1 sweep calls {calls[0]}; launches {dict(bf.LAUNCHES)}")
        if bad or not np.allclose(d, ref_d, rtol=1e-5, atol=1e-4):
            raise RuntimeError("the l1 exact engine disagrees with float64")
        if (bf.LAUNCHES["k4_beam"] <= 0 or not calls[0]
                or bf.LAUNCHES["k8_beam_ground"] <= 0):
            raise RuntimeError("the l1 path did not run K4, K8 (its build's "
                               "beam ground) and the l1 sweep")
        a = torch.where(g.traversable & (g.tid_count > 0), 0.0,
                        float("inf"))
        n_rows = g.values.shape[0]
        row = dict(
            name="k11_l1_sweep", route="torch ops",
            source="pgvector_rx_tpu_torch/graph/device.py (l1_sweep_topk)",
            replaces=f"{JAX_DEVICE}:1093 (the chunked l1 sweep, XLA)",
            launches=calls[0],
            ms=cuda_ms(lambda: sweep(g.values, a, q1, K), 3),
            library_ms=cuda_ms(lambda: torch.cdist(q1, g.values, p=1), 3),
            library_of="torch.cdist(p=1) alone (the scores, not the top-k)",
            **bound(3.0 * CHUNK * n_rows * DIM, "f32",
                    (n_rows * DIM + CHUNK * DIM + n_rows) * 4
                    + CHUNK * K * 8))
        row["share_of_bound"] = row["bound_ms"] / row["ms"]
        log(json.dumps({"torch_ops": [row]}))
    del idx, g, x
    torch.cuda.empty_cache()


def persistence(index, q_dev, HnswIndex, IndexParams, SearchParams,
                device_mod, data, dev):
    """Phase 20: the grown serving-only index saved and loaded back on the
    card, every engine's ids unchanged; a 20,000-row host-graph index with
    an append log reloaded with replay, its search ids unchanged."""
    q = q_dev[:4 * CHUNK].contiguous()
    engines = ("exact", "approx", "beam")
    with Phase("20 save and load the grown index"), \
            tempfile.TemporaryDirectory() as tmp:
        before = {e: device_mod.serve_topk(index, q, K, engine=e, ef=EF)[1]
                  for e in engines}
        ck = Path(tmp) / "grown"
        t0 = time.time()
        index.save(ck)
        t_save = time.time() - t0
        nbytes = sum(f.stat().st_size for f in ck.iterdir())
        t0 = time.time()
        back = HnswIndex.load(ck, serving=True, device=dev)
        torch.cuda.synchronize()
        t_load = time.time() - t0
        diff = {e: int((device_mod.serve_topk(back, q, K, engine=e,
                                              ef=EF)[1] != before[e])
                       .any(axis=1).sum()) for e in engines}
        log(f"checkpoint of {back.device_graph().cap:,} rows: save "
            f"{t_save:.3f} s, load {t_load:.3f} s, {nbytes:,} bytes; rows "
            f"whose ids changed per engine: {diff}")
        if any(diff.values()) or back.device_graph().device != dev:
            raise RuntimeError("the reloaded index answers differently")
        del back
    log(f"cut: the logged host-graph index holds {N_LOG:,} rows (a Python "
        "host graph; its inserts replay one by one)")
    with Phase("20 host graph with an append log, reloaded with replay"), \
            tempfile.TemporaryDirectory() as tmp:
        idx = HnswIndex.build(data[:N_LOG], metric="l2",
                              params=IndexParams(m=M, ef_construction=EF_CONSTRUCTION),
                              method="device", host_graph=True, device=dev,
                              seed=1)
        ck = Path(tmp) / "host"
        idx.save(ck)
        idx.enable_log(ck / "log.jsonl")
        for i in range(50):
            idx.insert(data[N_LOG + i], N_LOG + i)
        idx.delete(range(0, 200, 10))
        t0 = time.time()
        back = HnswIndex.load(ck, device=dev)
        t_load = time.time() - t0
        idx._log.close()
        qh = q_dev[:64].cpu().numpy()
        bad = {}
        for method in ("exact", "device", "host"):
            qm = qh[:8] if method == "host" else qh
            _, a_ids = idx.search(qm, K, SearchParams(ef_search=EF),
                                  method=method)
            _, b_ids = back.search(qm, K, SearchParams(ef_search=EF),
                                   method=method)
            bad[method] = int((a_ids != b_ids).any(axis=1).sum())
        log(f"logged host graph: {back.num_tuples} tuples after replay "
            f"(live index {idx.num_tuples}), load with replay {t_load:.3f} s;"
            f" rows whose search ids differ: {bad}")
        if any(bad.values()) or back.num_tuples != idx.num_tuples:
            raise RuntimeError("the replayed index answers differently")


def np_bit_topk(qbits, xbits, live, metric, k, chunk=64):
    """The exact (distance, row) top-k by numpy popcounts, independent of
    the port: popcount(q & x) as the product of the {0,1} rows (integer
    sums below 2^24, exact in f32 in any order), the rows' popcounts as
    their sums; hamming = |q| + |x| - 2 |q & x|, jaccard the JAX
    package's f32 formula. Rows whose ``live`` flag is clear are left out.
    -> (d [B, k] f32, rows [B, k] int64)."""
    x = xbits.astype(np.float32)
    xpop = x.sum(1)[None, :]
    one = np.float32(1.0)
    rows = np.arange(x.shape[0], dtype=np.int64)[None, :]
    out_d, out_i = [], []
    for s in range(0, qbits.shape[0], chunk):
        q = qbits[s : s + chunk].astype(np.float32)
        ab = q @ x.T
        qpop = q.sum(1)[:, None]
        if metric == "hamming":
            d = qpop + xpop - np.float32(2.0) * ab
        else:
            union = qpop + xpop - ab
            d = np.where(ab == 0, one,
                         one - ab / np.where(union > 0, union, one))
        keys = (d.astype(np.float32).view(np.int32).astype(np.int64) << 32) \
            | rows
        keys[:, ~live] = np.iinfo(np.int64).max
        top = np.sort(np.partition(keys, k - 1, axis=1)[:, :k], axis=1)
        out_d.append((top >> 32).astype(np.int32).view(np.float32))
        out_i.append(top & 0xFFFFFFFF)
    return np.concatenate(out_d), np.concatenate(out_i)


def bit_recall(bits_mod, g, qw, ids, kth):
    """Tie-aware recall@K: the share of returned rows whose true distance
    (from the graph's words) is at most the query's K-th true distance
    ``kth`` [B]; a missing row (-1) is a miss."""
    t = torch.from_numpy(ids).to(qw.device)
    d = bits_mod.gathered(g.metric, g.words, t, qw, base_pop=g.x2)
    return float(((t >= 0) & (d <= kth[:, None])).float().mean())


def tie_equal_rows(ids_a, d_a, ids_b, d_b):
    """Per row of two sorted lists: the same distance at every rank, and
    the same id wherever that distance is unique in the row (integer bit
    distances tie as a rule)."""
    ok = (d_a == d_b).all(axis=1)
    for r in np.flatnonzero(ok):
        vals, counts = np.unique(d_a[r], return_counts=True)
        uniq = np.isin(d_a[r], vals[counts == 1])
        ok[r] = bool((ids_a[r][uniq] == ids_b[r][uniq]).all())
    return ok


def bits_library(bits_mod, bf, words, live, q, k, metric):
    """K9's function from PyTorch calls, JAX's MXU form: per block of rows
    the rows and queries unpacked to bf16 {0,1}, ``torch.mm`` (its bf16
    sums of 0/1 products are exact up to 256 bits), hamming ``popq + popx
    - 2 ab`` or jaccard, dead rows at +inf, ``torch.topk`` over (distance,
    row) keys, merged."""
    qb = bits_mod.unpack_words_bf16(q)
    qpop = bits_mod.row_popcount(q)[:, None]
    best = torch.empty((q.shape[0], 0), dtype=torch.int64, device=q.device)
    for s in range(0, words.shape[0], LIB_ROWS):
        x = words[s : s + LIB_ROWS]
        ab = torch.mm(qb, bits_mod.unpack_words_bf16(x).T).float()
        xpop = bits_mod.row_popcount(x)[None, :]
        if metric == "hamming":
            d = qpop + xpop - 2.0 * ab
        else:
            d = bits_mod._from_counts(metric, ab, qpop, xpop)
        d = torch.where(live[None, s : s + LIB_ROWS], d, float("inf"))
        rows = torch.arange(s, s + x.shape[0], device=q.device)
        keys = torch.cat([best, bf._order_keys(d, rows.expand(q.shape[0],
                                                              -1))], 1)
        best = torch.topk(keys, min(k, keys.shape[1]), dim=1, largest=False,
                          sorted=True).values
    return bf._from_order_keys(best)


def walk_vs_plain_descent(g, q, metric, device_mod, beam, kernels, name,
                          launches, replaces, ops_per_row, peak, row_words,
                          exact):
    """The beam's launch (``ops/beam.descent_walk``: the greedy descent,
    then the walk) on the card against its plain version
    (``descent_plain`` + ``_walk_plain``) and against the torch descent
    feeding the walk kernel: the same landings (ids; distances exactly for
    bit rows, within 1e-5 relative for float sums), the walks equal but for
    ties (``exact``: tie-aware by distance, bit rows), a control cut to
    ef / 4 steps that must fail; each timed, with the descent's share of
    the torch-descent path. Adds the kernel's row to ``kernels``."""
    steps_max = 4 * EF + 32
    B = (q[0] if isinstance(q, tuple) else q).shape[0]
    qq = beam._queries(q, metric)
    upper = (g.upper_slot, g.upper_neighbors, g.m, g.entry, g.entry_level)
    seeds = torch.full((B, 1), -1, dtype=torch.int32, device=g.device)
    zeros = torch.zeros((B, 1), device=g.device)

    def launch():
        return beam._launch_walk(g.rows, g.neighbors0, g.traversable, metric,
                                 qq, seeds, zeros, EF, steps_max, upper)

    def torch_descent():
        return device_mod._descent_seeds(g, q, g.entry_level)

    def walk_from(s_ids, s_d, cut=steps_max):
        return beam._walk_plain(g.rows, g.neighbors0, g.traversable, None,
                                metric, qq, s_ids.to(torch.int32), s_d,
                                width=EF, spill=0, max_steps=cut, scan=False)

    def finish(raw):
        return [t.cpu().numpy() for t in beam._serve_finish(*raw)]

    raw_k, land = launch()
    s_ids, s_d = torch_descent()
    same_id = float((land[:, 0].long() == s_ids[:, 0]).float().mean())
    ld = land[:, 1].contiguous().view(torch.float32)
    derr = float(((ld - s_d[:, 0]).abs()
                  / s_d[:, 0].abs().clamp(min=1e-30)).max())
    (kd, ki, ks), (pd, pi, ps) = finish(raw_k), finish(walk_from(s_ids, s_d))
    cd, ci, _ = finish(walk_from(s_ids, s_d, EF // 4))
    tk = device_mod._ground_beam_seeds(g, q, s_ids, s_d, EF, steps_max)
    td, ti = (t.cpu().numpy() for t in tk[:2])
    if exact:
        ok = tie_equal_rows(ki, kd, pi, pd).mean()
        okc = tie_equal_rows(ci, cd, pi, pd).mean()
        okt = float((ti == ki).all(axis=1).mean())
    else:
        ok, err = walk_agreement(ki, kd, pi, pd)
        okc, _ = walk_agreement(ci, cd, pi, pd)
        ok, okc = ok.mean(), okc.mean()
        okt = float(walk_agreement(ti, td, ki, kd)[0].mean())
    log(f"{name}: descent in the launch vs torch: {same_id:.4f} of landings "
        f"the same id (max rel distance err {derr:.3e}); the walk vs plain: "
        f"{ok:.4f} of queries equal but for ties "
        f"({float((ki == pi).all(axis=1).mean()):.4f} every id), "
        f"{float((ks == ps).mean()):.4f} equal steps; vs the walk kernel "
        f"from the torch descent {okt:.4f}; control (plain cut to "
        f"{EF // 4} steps): {okc:.4f}")
    if same_id < (1.0 if exact else 0.99) or (exact and derr > 0):
        raise RuntimeError(f"{name}: the descent in the launch lands "
                           "elsewhere than the torch descent")
    if ok < 0.99 or okt < 0.99:
        raise RuntimeError(f"{name} disagrees with the plain walk")
    if okc >= 0.99:
        raise RuntimeError(f"the {name} check passes a walk cut to ef / 4 "
                           "steps")
    steps, scored = float(raw_k[4].sum()), float(raw_k[5].sum())
    d_rows, moves = float(land[:, 2].sum()), float(land[:, 3].sum())
    # the descent reads, per iteration, a node's upper slot and m ids; it
    # scores the entry and the valid neighbours (d_rows)
    iters = moves + B * g.entry_level
    nbytes = (walk_gather_bytes(steps, scored, g.neighbors0.shape[1], 1,
                                row_words)
              + iters * (4 + 4 * g.m) + d_rows * (row_words * 4 + 1)
              + B * (row_words * 4 + EF * 8 + 8))
    ms_launch = cuda_ms(launch)
    ms_desc = cuda_ms(torch_descent, 3)
    ms_walk = cuda_ms(lambda: beam._walk_cuda(
        g.rows, g.neighbors0, g.traversable, None, metric, qq,
        s_ids.to(torch.int32), s_d, width=EF, spill=0, max_steps=steps_max,
        scan=False))
    fin = np.isfinite(pd)
    kernels[name] = dict(
        name=name, route="cuda", source=CSRC + "k4_beam.cu",
        replaces=replaces, queries=B,
        max_abs_err=float(np.abs(kd[fin] - pd[fin]).max()),
        ms=ms_launch,
        ms_of="one launch: the greedy descent and the walk",
        walk_ms=ms_walk, torch_descent_ms=ms_desc,
        plain_ms=cuda_ms(lambda: walk_from(*torch_descent()), 1),
        **bound(ops_per_row * (scored + d_rows), peak, nbytes),
        library_ms=None, steps_mean=steps / B, scored_mean=scored / B,
        descent_rows_mean=d_rows / B, descent_moves_mean=moves / B,
        launches=launches)
    kr = kernels[name]
    kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
    if g.words is not None:
        word_latency_bound(kr, raw_k[4], land, g.entry_level,
                           dependent_round_trip_us(g, g.words))
    share = ms_desc / (ms_desc + ms_walk)
    log(f"{name} at {B} queries: one launch (descent + walk) "
        f"{ms_launch:.4f} ms; the torch descent {ms_desc:.4f} ms + the walk "
        f"kernel {ms_walk:.4f} ms (the descent {share:.4f} of that path); "
        f"plain {kr['plain_ms']:.4f} ms; bound "
        f"{kr['bound_ms']:.4f} ms ({kr['bound_by']}, {kr['bound_peak']}), "
        f"share {kr['share_of_bound']:.4f}; {kr['steps_mean']:.1f} steps, "
        f"{kr['scored_mean']:.1f} rows scored, descent "
        f"{kr['descent_rows_mean']:.1f} rows and "
        f"{kr['descent_moves_mean']:.1f} moves per query")


def bit_path(HnswIndex, IndexParams, SearchParams, make_dataset, device_mod,
             db, bf, bits_mod, beam, dev, kernels):
    """Phase 21: BASELINE's bit(256) hamming configuration at 1,000,000
    rows built on the card; K9 ground truth against numpy; the three
    engines and ``search``; then K9 and the walk's packed-word mode
    against their plain versions. Returns the bits and packed queries."""
    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)
    with Phase("21 data, sign bits of 1,000,000 x 256-d"):
        dense, dq = make_dataset(N_BIT, NBITS, N_BIT_Q, seed=7, intrinsic=24)
        xbits, qbits = (dense > 0).astype(np.uint8), (dq > 0).astype(np.uint8)
        del dense, dq
        qw = bits_mod.as_words(bits_mod.pack_bits(qbits), dev)
    bf.reset_launches()
    idx, g, _ = timed_build(HnswIndex, db, xbits, "hamming", params, dev,
                            N_BIT, "21")
    if g.words is None or g.values is not None or g.words.device != dev:
        raise RuntimeError("the bit graph holds no packed words on the card")
    live = g.traversable & (g.tid_count > 0)
    with Phase("21 ground truth (K9)"):
        gt = [bits_mod.bits_topk(g.words, g.x2, live, qw[s : s + CHUNK], K,
                                 "hamming")
              for s in range(0, N_BIT_Q, CHUNK)]
        gt_d = torch.cat([d for d, _ in gt])
        gt_i = torch.cat([i for _, i in gt]).cpu().numpy()
        ref_d, ref_i = np_bit_topk(qbits[:64], xbits,
                                   live[:N_BIT].cpu().numpy(), "hamming", K)
        same = (np.array_equal(gt_d[:64].cpu().numpy(), ref_d)
                and np.array_equal(gt_i[:64], ref_i))
        log(f"K9 ground truth {gt_i.shape}: 64 queries "
            f"{'equal' if same else 'differ from'} the numpy popcounts in "
            f"(distance, id) order; {int(live.sum())} live rows")
        if not same or (gt_i < 0).any():
            raise RuntimeError("K9 ground truth disagrees with numpy")
    kth = gt_d[:, -1]
    served = {}
    for engine, kname in (("exact", "k9_bits_tc"), ("approx", "k9_bits_tc"),
                          ("beam", "k4_beam")):
        with Phase(f"21 serve_topk {engine}"):
            before = bf.LAUNCHES[kname]
            d, ids, dt = timed_serve(device_mod, idx, qw, engine)
            rec = bit_recall(bits_mod, g, qw, ids, kth)
            served[engine] = (d, ids)
            log(f"21 {engine}: tie-aware recall@10={rec:.4f} "
                f"qps={N_BIT_Q / dt:.1f} ({dt:.4f} s for {N_BIT_Q} queries)")
            if d.shape != (N_BIT_Q, K) or not np.isfinite(d).all():
                raise RuntimeError(f"{engine}: non-finite or misshapen output")
            if rec < BIT_FLOORS[engine]:
                raise RuntimeError(f"bit {engine}: recall {rec} < "
                                   f"{BIT_FLOORS[engine]}")
            if bf.LAUNCHES[kname] <= before:
                raise RuntimeError(f"{engine}: kernel {kname} did not launch")
    if not np.array_equal(served["exact"][1], gt_i):
        raise RuntimeError("the exact engine is not K9's top-10")
    with Phase("21 index.search on bit rows"):
        emit = g.emit_tid.cpu().numpy()
        tid_count = g.tid_count.cpu().numpy()
        for method, engine in (("exact", "exact"), ("approx", "approx"),
                               ("device", "beam")):
            sd, stids = idx.search(qbits[:64], K, SearchParams(ef_search=EF),
                                   method=method)
            d, ids = served[engine]
            # an element holding folded duplicates emits each of its tids
            one = (tid_count[ids[:64]] == 1).all(axis=1)
            same = ((sd == d[:64].astype(np.float64)).all(axis=1)
                    & (stids == emit[ids[:64]]).all(axis=1))
            log(f"21 search({method}): {int((one & ~same).sum())} of "
                f"{int(one.sum())} bit queries without folded duplicates "
                "differ from serve_topk")
            if (one & ~same).any() or not one.sum():
                raise RuntimeError(f"bit search({method}) disagrees with "
                                   "serve_topk")
            if method == "exact":
                # a few queries (K9's popcount form, B < 32) answer alike
                sd8, st8 = idx.search(qbits[:N_FEW_Q], K,
                                      SearchParams(ef_search=EF),
                                      method=method)
                if not (np.array_equal(sd8, sd[:N_FEW_Q])
                        and np.array_equal(st8, stids[:N_FEW_Q])):
                    raise RuntimeError(f"bit search of {N_FEW_Q} queries "
                                       "disagrees with the batch of 64")
    launches = dict(bf.LAUNCHES)
    log(f"bit path launches: {launches}")
    for name in ("k9_bits", "k9_bits_tc", "k4_beam", "k8_beam_ground"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the bit path")

    with Phase("21 K9's two forms vs plain"):
        q1 = qw[:CHUNK].contiguous()
        words, n1, w = g.words, g.words.shape[0], g.words.shape[1]
        keys = bf._order_keys
        forms = {}
        for form, qq in (("k9_bits_tc", q1), ("k9_bits", q1),
                         ("k9_bits", qw[:N_FEW_Q].contiguous())):
            kd, ki = bits_mod._bits_topk_cuda(words, g.x2, live, qq, K,
                                              "hamming", form=form)
            got = keys(kd, ki)
            # both plain versions, and a control whose ties put the higher
            # row first
            ok = all(torch.equal(got, keys(*p(words, g.x2, live, qq, K,
                                              "hamming")))
                     for p in (bits_mod._bits_topk_plain,
                               bits_mod._bits_topk_plain_mm))
            cd, ci = bits_mod._bits_topk_plain(words.flip(0), None,
                                               live.flip(0), qq, K,
                                               "hamming")
            ctl = torch.equal(got, keys(cd, torch.where(ci >= 0,
                                                        n1 - 1 - ci, -1)))
            lib = keys(*bits_library(bits_mod, bf, words, live, qq, K,
                                     "hamming"))
            tied = float((kd[:, 1:] == kd[:, :-1]).any(dim=1).float().mean())
            log(f"K9 {form} at {qq.shape[0]} queries vs both plain "
                f"versions: {'equal' if ok else 'differ'} (distances and "
                f"ids, tie order included; {tied:.4f} of rows hold a tie); "
                f"control (ties higher id first): "
                f"{'equal' if ctl else 'differs'}; the library call "
                f"{'equals' if torch.equal(lib, got) else 'differs from'} "
                "it")
            if not ok or not torch.equal(lib, got):
                raise RuntimeError(f"K9 {form} disagrees with its plain "
                                   "version or the library call")
            if ctl:
                raise RuntimeError("the K9 check passes a reversed tie order")
            forms[(form, qq.shape[0])] = (qq, kd)
        # the check's old yardstick: cdist(p=0) computes the scores only
        qf = bits_mod.unpack_words_bf16(q1).float()
        xf = bits_mod.unpack_words_bf16(words).float()
        lib_min = torch.where(live[None, :], torch.cdist(qf, xf, p=0),
                              float("inf")).min(dim=1).values
        if not torch.equal(lib_min, forms[("k9_bits_tc", CHUNK)][1][:, 0]):
            raise RuntimeError("torch.cdist(p=0) disagrees with K9's top-1")
        del lib_min, xf, qf
        sms = torch.cuda.get_device_properties(dev).multi_processor_count

        def k9_row(form, b):
            qq = forms[(form, b)][0]
            pairs = float(b) * n1
            plain = (bits_mod._bits_topk_plain_mm if form == "k9_bits_tc"
                     else bits_mod._bits_topk_plain)
            return dict(
                name=form, route="cuda", source=CSRC + form + ".cu",
                replaces=f"{JAX_DEVICE}:1155 (_exact_search_bits, an XLA "
                         "program: its "
                         + ("unpack + matmul form, B >= 32)"
                            if form == "k9_bits_tc"
                            else "popcount form, B < 32)"),
                queries=b, max_abs_err=0.0,
                ms=cuda_ms(lambda: bits_mod._bits_topk_cuda(
                    words, g.x2, live, qq, K, "hamming", form=form)),
                plain_ms=cuda_ms(lambda: plain(words, g.x2, live, qq, K,
                                               "hamming"), 2),
                **bound(2.0 * pairs * NBITS, "int8",
                        n1 * (w * 4 + 1) + b * (w * 4 + K * 12)),
                library_ms=cuda_ms(lambda: bits_library(
                    bits_mod, bf, words, live, qq, K, "hamming"), 2),
                library_of="JAX's MXU form in torch: per 65,536-row block "
                           "unpack to bf16, torch.mm, popq + popx - 2 ab, "
                           "torch.topk; merged",
                popcount_bound_ms=pairs * w / (POPC_PER_CLK_SM * sms
                                               * BOOST_HZ) * 1e3,
                launches=launches[form])

        kernels["k9_bits_tc"] = k9_row("k9_bits_tc", CHUNK)
        kernels["k9_bits"] = k9_row("k9_bits", N_FEW_Q)
        kernels["k9_bits"]["ms_at_1024"] = cuda_ms(
            lambda: bits_mod._bits_topk_cuda(words, g.x2, live, q1, K,
                                             "hamming", form="k9_bits"))
        for name in ("k9_bits_tc", "k9_bits"):
            kr = kernels[name]
            kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
            log(f"{name} at {kr['queries']} queries: kernel {kr['ms']:.4f} "
                f"ms, plain {kr['plain_ms']:.4f} ms, library "
                f"{kr['library_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms "
                f"({kr['bound_by']}, {kr['bound_peak']}), share "
                f"{kr['share_of_bound']:.4f}; popcount-rate bound "
                f"{kr['popcount_bound_ms']:.4f} ms")
        log(f"k9_bits (the popcount form) at {CHUNK} queries: "
            f"{kernels['k9_bits']['ms_at_1024']:.4f} ms")

    with Phase("21 the bit beam: the descent in K4's launch vs plain"):
        walk_vs_plain_descent(g, q1, "hamming", device_mod, beam, kernels,
                              "k4_beam_words", launches["k4_beam"],
                              f"{JAX_DEVICE}:767 (_search_batch over packed "
                              "bit rows: the greedy descent, then "
                              "_ground_beam_seeds; XLA)",
                              NBITS * 2.0, "int8", w, exact=True)
    bit_variants(idx, g, qw, kth, bits_mod, device_mod, beam, bf, kernels)
    del idx, g, live, words
    torch.cuda.empty_cache()
    return xbits, qbits, qw


def jaccard_path(HnswIndex, IndexParams, device_mod, db, bf, bits_mod,
                 xbits, qbits, qw, dev, kernels):
    """Phase 22: jaccard over the first N_JAC bit rows built on the card:
    the exact engine against numpy on 1,024 queries, beam recall, and K9's
    jaccard mode against its plain version, timed."""
    log(f"cut: the jaccard path builds the first {N_JAC:,} of the 1,000,000 "
        "bit rows (the run's time)")
    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)
    bf.reset_launches()
    idx, g, _ = timed_build(HnswIndex, db, xbits[:N_JAC], "jaccard", params,
                            dev, N_JAC, "22")
    live = g.traversable & (g.tid_count > 0)
    with Phase("22 jaccard engines"):
        d, ids = device_mod.serve_topk(idx, qw, K, engine="exact")
        ref_d, ref_i = np_bit_topk(qbits[:CHUNK], xbits[:N_JAC],
                                   live[:N_JAC].cpu().numpy(), "jaccard", K,
                                   chunk=128)
        same_d = np.array_equal(d[:CHUNK], ref_d)
        ok = tie_equal_rows(ids[:CHUNK], d[:CHUNK], ref_i, ref_d).mean()
        log(f"jaccard exact engine vs numpy on {CHUNK} queries: distances "
            f"{'equal' if same_d else 'differ'} in f32, {ok:.4f} of rows "
            f"with equal ids but for ties "
            f"({float((ids[:CHUNK] == ref_i).all(axis=1).mean()):.4f} every "
            "id)")
        if not same_d or ok < 1.0:
            raise RuntimeError("the jaccard exact engine disagrees with numpy")
        kth = torch.from_numpy(d[:, -1]).to(dev)
        device_mod.serve_topk(idx, qw, K, engine="beam", ef=EF)
        torch.cuda.synchronize()
        t0 = time.time()
        _, ids_b = device_mod.serve_topk(idx, qw, K, engine="beam", ef=EF)
        dt = time.time() - t0
        rec = bit_recall(bits_mod, g, qw, ids_b, kth)
        launches = dict(bf.LAUNCHES)
        log(f"22 beam (ef={EF}): tie-aware recall@10={rec:.4f} "
            f"qps={N_BIT_Q / dt:.1f}; launches {launches}")
        if rec < BIT_FLOORS["beam"]:
            raise RuntimeError(f"jaccard beam recall {rec} < "
                               f"{BIT_FLOORS['beam']}")
        for name in ("k9_bits_tc", "k4_beam", "k8_beam_ground"):
            if launches[name] <= 0:
                raise RuntimeError(f"kernel {name} never ran on the jaccard "
                                   "path")
    with Phase("22 K9 jaccard vs plain, both forms"):
        q1 = qw[:CHUNK].contiguous()
        n1, w = g.words.shape
        keys = bf._order_keys
        args = (g.words, g.x2, live, q1, K, "jaccard")
        want = keys(*bits_mod._bits_topk_plain(*args))
        if not torch.equal(want, keys(*bits_mod._bits_topk_plain_mm(*args))):
            raise RuntimeError("K9's two plain versions disagree on jaccard")
        for form in ("k9_bits_tc", "k9_bits"):
            got = keys(*bits_mod._bits_topk_cuda(*args, form=form))
            if not torch.equal(got, want):
                raise RuntimeError(f"K9 {form}'s jaccard mode disagrees "
                                   "with its plain version")
            k9 = kernels[form]
            k9["jaccard_rows"] = n1
            k9["jaccard_ms_at_1024"] = cuda_ms(
                lambda: bits_mod._bits_topk_cuda(*args, form=form))
            log(f"K9 {form} jaccard at {n1:,} rows, {CHUNK} queries: equal "
                f"to plain; kernel {k9['jaccard_ms_at_1024']:.4f} ms")
        k9 = kernels["k9_bits_tc"]
        k9["jaccard_plain_ms"] = cuda_ms(
            lambda: bits_mod._bits_topk_plain_mm(*args), 2)
        k9["jaccard_library_ms"] = cuda_ms(lambda: bits_library(
            bits_mod, bf, g.words, live, q1, K, "jaccard"), 2)
        k9["jaccard_bound_ms"] = bound(
            2.0 * CHUNK * n1 * NBITS, "int8",
            n1 * (w * 4 + 1) + CHUNK * (w * 4 + K * 12))["bound_ms"]
        log(f"K9 jaccard: plain {k9['jaccard_plain_ms']:.4f} ms, library "
            f"{k9['jaccard_library_ms']:.4f} ms, bound "
            f"{k9['jaccard_bound_ms']:.4f} ms")
    del idx, g, live
    torch.cuda.empty_cache()


def np_order_dists(oc, q, rows):
    """float64 order distances [B, N] of an operator class's metric from
    queries ``q`` to the stored ``rows`` (dense rows rounded to the
    class's dtype; bit rows 0/1)."""
    if oc.kind == "bit":
        a, b = q[:, None, :].astype(bool), rows[None, :, :].astype(bool)
        if oc.metric == "hamming":
            return (a != b).sum(-1).astype(np.float64)
        inter, union = (a & b).sum(-1), (a | b).sum(-1)
        return np.where(inter == 0, 1.0, 1.0 - inter / np.maximum(union, 1))
    x = rows.astype(oc.dtype).astype(np.float64)
    qq = q.astype(np.float64)
    if oc.metric == "l2":
        return ((qq[:, None, :] - x[None]) ** 2).sum(-1)
    if oc.metric == "l1":
        return np.abs(qq[:, None, :] - x[None]).sum(-1)
    if oc.metric == "ip":
        return -(qq @ x.T)
    qn = qq / np.linalg.norm(qq, axis=1, keepdims=True)
    return 1.0 - qn @ (x / np.linalg.norm(x, axis=1, keepdims=True)).T


def flat_and_facade(data, queries, q_dev, xbits, qbits, qw, bf, bits_mod,
                    SearchParams, dev):
    """Phase 23: ``FlatIndex`` over the first N_FLAT rows of the main
    corpus (l2) and of the bit corpus (hamming) equals K1 / K9 over the
    same rows; each dense and bit operator class makes an index on the
    card (no device named) whose exact search finds each query's nearest
    row and whose beam answers."""
    from pgvector_rx_tpu_torch.index.access_method import (
        OPERATOR_CLASSES, create_index_for_opclass)
    from pgvector_rx_tpu_torch.index.flat import FlatIndex

    bf.reset_launches()
    with Phase(f"23 flat index over {N_FLAT:,} rows"):
        fl = FlatIndex.build(data[:N_FLAT], metric="l2")
        fd, fi = fl.search(queries[:CHUNK], K)
        kd, ki = bf.l2_topk(torch.from_numpy(data[:N_FLAT]).to(dev),
                            q_dev[:CHUNK], K)
        kd = np.sqrt(np.maximum(kd.cpu().numpy().astype(np.float64), 0.0))
        ok_l2 = np.array_equal(fi, ki.cpu().numpy()) and np.array_equal(fd,
                                                                         kd)
        fb = FlatIndex.build(xbits[:N_FLAT], metric="hamming", kind="bit")
        bd, bi = fb.search(qbits[:CHUNK], K)
        words = bits_mod.as_words(bits_mod.pack_bits(xbits[:N_FLAT]), dev)
        k9d, k9i = bits_mod.bits_topk(
            words, None, torch.ones(N_FLAT, dtype=torch.bool, device=dev),
            qw[:CHUNK], K, "hamming")
        ok_bit = (np.array_equal(bi, k9i.cpu().numpy())
                  and np.array_equal(bd, k9d.cpu().numpy().astype(np.float64)))
        log(f"FlatIndex on {fl.device} / {fb.device}: l2 "
            f"{'equals' if ok_l2 else 'differs from'} K1, hamming "
            f"{'equals' if ok_bit else 'differs from'} K9 ({CHUNK} queries)")
        if fl.device.type != dev.type or not (ok_l2 and ok_bit):
            raise RuntimeError("FlatIndex disagrees with K1 / K9")
    with Phase(f"23 operator classes, {N_OPCLASS} rows each"):
        for name, oc in OPERATOR_CLASSES.items():
            if oc.kind == "sparse":
                continue
            rows = (xbits if oc.kind == "bit" else data)[:N_OPCLASS]
            q = (qbits if oc.kind == "bit" else queries)[:64]
            idx = create_index_for_opclass(name, rows.shape[1])
            idx.add_batch(rows)
            _, tids = idx.search(q, K, method="exact")
            _, tids_b = idx.search(q, K, SearchParams(ef_search=EF),
                                   method="device")
            ref = np_order_dists(oc, q, rows)
            got = ref[np.arange(64), tids[:, 0]]
            ok = (idx.device.type == dev.type and (tids >= 0).all()
                  and (tids_b >= 0).all()
                  and np.allclose(got, ref.min(axis=1), rtol=1e-3, atol=1e-3))
            log(f"{name}: index on {idx.device}, exact top-1 "
                f"{'is' if ok else 'is not'} the numpy nearest on 64 queries")
            if not ok:
                raise RuntimeError(f"the {name} index does not answer")
    launches = dict(bf.LAUNCHES)
    log(f"flat and facade launches: {launches}")
    for name in ("k1_topk", "k9_bits_tc", "k4_beam"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran in phase 23")


def sparse_build_child(out_dir: str) -> int:
    """The sparse path's set-up, run as ``python3 chip_smoke.py
    --sparse-build DIR`` in a CPU subprocess that ``main`` starts beside
    the card phases (the single-threaded native build of 100,000 sparse
    rows takes minutes): the data (``make_sparse_dataset``), the build
    ``HnswIndex.build(rows, metric="l2", params, seed=1)`` (method auto:
    the native engine), its checkpoint and the padded rows into DIR, and
    one JSON line of seconds."""
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams, native
    from pgvector_rx_tpu_torch.data import make_sparse_dataset
    from pgvector_rx_tpu_torch.ops import sparse as sparse_mod

    t0 = time.time()
    rows, _ = make_sparse_dataset(N_SP, DIM_SP, N_SP_Q, NNZ_SP, seed=SEED_SP)
    gen_s = time.time() - t0
    if not native.available():
        raise RuntimeError(f"the native engine does not build: "
                           f"{native._error}")
    t0 = time.time()
    idx = HnswIndex.build(rows, metric="l2",
                          params=IndexParams(m=M,
                                             ef_construction=EF_CONSTRUCTION),
                          seed=1, device="cpu")  # a CPU process: no card
    build_s = time.time() - t0
    t0 = time.time()
    idx.save(Path(out_dir) / "sparse")
    save_s = time.time() - t0
    ind, val = sparse_mod.pad_rows(rows, idx.store.budget, "cpu")
    np.savez(Path(out_dir) / "rows.npz", indices=ind.numpy(),
             values=val.numpy())
    print(json.dumps(dict(gen_s=gen_s, build_s=build_s, save_s=save_s,
                          elements=len(idx.elements),
                          budget=idx.store.budget)), flush=True)
    return 0


def start_sparse_build():
    """Start the sparse path's build subprocess (``sparse_build_child``)
    into a fresh temporary directory -> (process, directory). It dies with
    the smoke (SIGKILL from the kernel if the smoke is killed; stopped at
    exit otherwise), and the directory goes at exit."""
    import atexit
    import shutil

    tmp = tempfile.mkdtemp(prefix="pgv_sparse_")

    def die_with_parent():
        import ctypes
        import signal

        ctypes.CDLL("libc.so.6").prctl(1, signal.SIGKILL)  # PR_SET_PDEATHSIG

    with open(Path(tmp) / "child.out", "w") as out, \
            open(Path(tmp) / "child.err", "w") as err:
        child = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--sparse-build",
             tmp], stdout=out, stderr=err, preexec_fn=die_with_parent)

    def stop():
        if child.poll() is None:
            child.kill()
            child.wait()
        shutil.rmtree(tmp, ignore_errors=True)

    atexit.register(stop)
    return child, tmp


def np_sparse_topk(csr, x2, live, qrows, k):
    """The exact l2 (distance, row) top-k in float64 by scipy's CSR product,
    independent of the port: |q|^2 + |x|^2 - 2 q.x over every row, rows
    whose ``live`` flag is clear left out -> (d [B, k] f64, rows [B, k])."""
    q = csr[qrows]
    dots = (q @ csr.T).toarray()  # [B, N] f64
    d = np.maximum(x2[qrows][:, None] + x2[None, :] - 2.0 * dots, 0.0)
    d[:, ~live] = np.inf
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return np.take_along_axis(d, order, axis=1), order


def sweep_agreement(kd, ki, pd, pi, tol):
    """Two sorted top-k lists per query: distances within ``tol`` [B] at
    every rank and ids equal but for ties (``tie_aware_mismatch``) ->
    (agree, max abs err)."""
    kd, ki, pd, pi = (t.cpu().numpy() if torch.is_tensor(t) else t
                      for t in (kd, ki, pd, pi))
    fin = np.isfinite(pd)
    if (fin != np.isfinite(kd)).any():
        return False, float("inf")
    err = float(np.abs(kd[fin] - pd[fin]).max()) if fin.any() else 0.0
    close = bool((np.abs(np.where(fin, kd - pd, 0.0))
                  <= np.asarray(tol)[:, None]).all())
    return close and not tie_aware_mismatch(ki, kd, pi, pd, tol), err


def t028_data(rng):
    """tests/t/028's rows and queries: vector(3) rows (random() * random()
    coordinates) cast to sparsevec, zero coordinates dropped; uniform
    queries -> (dense rows, dense queries, sparse rows, sparse queries)."""
    dense = (rng.random((T028_N, 3)) * rng.random((T028_N, 3))).astype(
        np.float32)
    qdense = rng.random((T028_Q, 3)).astype(np.float32)

    def sv(x):
        nz = np.nonzero(x)[0].astype(np.int32)
        return nz, x[nz]

    return dense, qdense, [sv(x) for x in dense], [sv(q) for q in qdense]


def np_dense_order(metric, q, x):
    """float64 order distances [B, N] of dense rows (tests/test_index.py's
    brute_force)."""
    q, x = q.astype(np.float64), x.astype(np.float64)
    if metric == "l2":
        return ((q[:, None, :] - x[None]) ** 2).sum(-1)
    if metric == "l1":
        return np.abs(q[:, None, :] - x[None]).sum(-1)
    if metric == "ip":
        return -(q @ x.T)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    return 1.0 - qn @ (x / np.linalg.norm(x, axis=1, keepdims=True)).T


def set_recall(ids, gt, k):
    """recall@k of returned ids against ground-truth id lists."""
    return float(np.mean([len(set(ids[b][ids[b] >= 0]) & set(gt[b][:k])) / k
                          for b in range(len(gt))]))


def sparse_path(child, tmp, HnswIndex, SearchParams, device_mod, beam, bf,
                dev, kernels):
    """Phase 24: BASELINE's sparse configuration (100,000 x 30,000-d, 64
    power-law draws per row, l2) built natively (in the subprocess started
    at phase 1), loaded onto the card; K10 ground truth against scipy in
    float64; the exact, approx and beam engines through ``index.search``;
    the beam's walk (K4's sparse-row mode) against the plain walk; K10
    against its plain version in four metrics and approx mode; t/028 at
    its own size; ``FlatIndex`` and the four sparse operator classes; a
    checkpoint round trip."""
    import scipy.sparse

    from pgvector_rx_tpu_torch import native
    from pgvector_rx_tpu_torch.index.access_method import (
        OPERATOR_CLASSES, create_index_for_opclass)
    from pgvector_rx_tpu_torch.index.flat import FlatIndex
    from pgvector_rx_tpu_torch.ops import sparse as sparse_mod

    with Phase("24a sparse build (CPU subprocess) and load onto the card"):
        t0 = time.time()
        rc = child.wait(timeout=1000)
        if rc != 0:
            raise RuntimeError("the sparse build failed:\n" + (
                Path(tmp) / "child.err").read_text()[-4000:])
        info = json.loads((Path(tmp) / "child.out").read_text().strip()
                          .splitlines()[-1])
        log(f"sparse data {N_SP:,} x {DIM_SP:,}-d ({NNZ_SP} draws per row, "
            f"seed {SEED_SP}): {info['gen_s']:.3f} s; native build "
            f"{info['build_s']:.3f} s, {N_SP / info['build_s']:.1f} rows/s; "
            f"checkpoint {info['save_s']:.3f} s; waited {time.time() - t0:.3f}"
            " s for the subprocess")
        bf.reset_launches()
        t0 = time.time()
        idx = HnswIndex.load(Path(tmp) / "sparse")  # no device named: card
        g = idx.device_graph()
        torch.cuda.synchronize()
        z = np.load(Path(tmp) / "rows.npz")
        ind, val = z["indices"], z["values"]
        P = idx.store.budget
        log(f"loaded and on the card in {time.time() - t0:.3f} s: cap="
            f"{g.cap} P={P} entry={g.entry} level={g.entry_level} upper rows="
            f"{g.upper_neighbors.shape[0]}")
        if (g.kind != "sparse" or g.cap != N_SP or info["elements"] != N_SP
                or g.sp_indices.device != dev or g.sp_values.device != dev
                or tuple(g.sp_indices.shape) != (N_SP + 1, P)
                or tuple(g.sp_values.shape) != (N_SP + 1, P)
                or ind.shape != (N_SP, P)
                or not np.array_equal(idx.store.indices[:N_SP], ind)
                or not np.array_equal(idx.store.values[:N_SP], val)):
            raise RuntimeError("the sparse graph is not on the card at size, "
                               "in row order")
        nnz = (ind != sparse_mod.PAD_INDEX).sum(1)
        rows = [(ind[i, :nnz[i]], val[i, :nnz[i]]) for i in range(N_SP)]
        queries = rows[:N_SP_Q]
        log(f"non-zeros per row: mean {nnz.mean():.2f}, max {nnz.max()}")
    live = g.traversable & (g.tid_count > 0)
    live_np = live[:N_SP].cpu().numpy()
    qi, qv = device_mod.prepare_queries(idx, queries, dev)

    with Phase("24b ground truth (K10) against scipy float64"):
        gt_d, gt_i = sparse_mod.sparse_topk(g.sp_indices, g.sp_values, live,
                                            qi, qv, K, "l2", dim=DIM_SP)
        rowptr = np.concatenate([[0], np.cumsum(nnz)])
        mask = ind != sparse_mod.PAD_INDEX
        csr = scipy.sparse.csr_matrix(
            (val[mask].astype(np.float64), ind[mask], rowptr),
            shape=(N_SP, DIM_SP))
        x2 = np.asarray(csr.multiply(csr).sum(1)).ravel()
        ref_d, ref_i = np_sparse_topk(csr, x2, live_np, np.arange(64), K)
        tol64 = 1e-5 * (x2[:64] + x2.max())
        ok, err = sweep_agreement(gt_d[:64].double(), gt_i[:64], ref_d,
                                  ref_i, tol64)
        log(f"K10 ground truth {tuple(gt_i.shape)}: 64 queries "
            f"{'agree with' if ok else 'differ from'} scipy float64 (ids "
            f"equal but for ties, distances within 1e-5 (|q|^2 + max|x|^2); "
            f"max abs err {err})")
        if not ok or (gt_i < 0).any():
            raise RuntimeError("K10 ground truth disagrees with float64")
    emit = g.emit_tid.cpu().numpy()
    gt_t = emit[gt_i.cpu().numpy()]
    params = SearchParams(ef_search=EF)
    recall = {}
    for method in ("exact", "approx", "device"):
        with Phase(f"24c index.search {method}"):
            idx.search(queries, K, params, method=method)  # warm
            torch.cuda.synchronize()
            t0 = time.time()
            d, ids = idx.search(queries, K, params, method=method)
            dt = time.time() - t0
            recall[method] = rec = set_recall(ids, gt_t, K)
            floor = SPARSE_FLOORS.get(method)
            log(f"24 {method}: recall@10={rec:.4f} qps={N_SP_Q / dt:.1f} "
                f"({dt:.4f} s for {N_SP_Q} queries; floor {floor})")
            if d.shape != (N_SP_Q, K) or not np.isfinite(d).all():
                raise RuntimeError(f"{method}: non-finite or misshapen output")
            if floor is not None and rec < floor:
                raise RuntimeError(f"sparse {method}: recall {rec} < {floor}")
    with Phase(f"24c FlatIndex over {N_SP:,} sparse rows"):
        fl = FlatIndex.build(rows, metric="l2", kind="sparse")
        fd, fi = fl.search(queries, K)  # no dim: K10's lookup form
        on_card = fl.device.type == dev.type
        del fl
    launches = dict(bf.LAUNCHES)
    log(f"sparse path launches: {launches}")
    for name in ("k10_sparse", "k10_sparse_lookup", "k10_compact",
                 "k4_beam_sparse"):
        if launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the sparse path")
    # the flat index holds K10's lookup form over the same rows exactly
    lk_d, lk_i = sparse_mod.sparse_topk(g.sp_indices, g.sp_values, live, qi,
                                        qv, K, "l2")
    want_d = np.sqrt(np.maximum(lk_d.cpu().numpy().astype(np.float64), 0.0))
    ok = (on_card and np.array_equal(fi, emit[lk_i.cpu().numpy()])
          and np.array_equal(fd, want_d))
    log(f"FlatIndex: {'equals' if ok else 'differs from'} K10's lookup form "
        f"({N_SP_Q} queries)")
    if not ok:
        raise RuntimeError("the sparse FlatIndex disagrees with K10")

    with Phase("24c the sparse beam: the descent in K4's launch vs plain"):
        walk_vs_plain_descent(g, (qi, qv), "l2", device_mod, beam, kernels,
                              "k4_beam_sparse", launches["k4_beam_sparse"],
                              f"{JAX_DEVICE}:1861 (_search_one_sparse: the "
                              "greedy descent, then _ground_beam over sparse "
                              "rows; XLA)",
                              3.0 * float(nnz.mean()), "f32", 2 * P,
                              exact=False)
    sparse_visited(idx, g, queries, (qi, qv), device_mod, beam, bf, kernels,
                   lambda ids: set_recall(ids, gt_t, K), float(nnz.mean()))

    with Phase("24d K10's two forms vs plain, four metrics and approx"):
        ci, cv = g.sp_indices, g.sp_values
        q2 = (qv * qv).sum(1)
        qa = qv.abs().sum(1)
        xmax = float((cv * cv).sum(1).max())
        amax = float(cv.abs().sum(1).max())
        tols = {"l2": 1e-5 * (q2 + xmax), "ip": 1e-5 * (q2 + xmax),
                "cosine": torch.full_like(q2, 1e-5),
                "l1": 1e-5 * (qa + amax)}
        # the dense-query form (dim known, the dense queries fit) and the
        # lookup form (dim unknown), on the same inputs
        forms = {"k10_sparse": DIM_SP, "k10_sparse_lookup": 0}
        if (sparse_mod._k10_form(DIM_SP, N_SP_Q) != "dense"
                or sparse_mod._k10_form(0, N_SP_Q) != "lookup"):
            raise RuntimeError("K10's shape rule picks another form")

        def k10(metric="l2", approx=False, form="k10_sparse"):
            return sparse_mod._sparse_topk_cuda(ci, cv, live, qi, qv, K,
                                                metric, approx, forms[form])

        def plain10(metric="l2", approx=False, ci=ci, cv=cv, qv=qv,
                    form="k10_sparse"):
            return sparse_mod._sparse_topk_plain(ci, cv, live, qi, qv, K,
                                                 metric, approx, forms[form])

        errs = {form: {} for form in forms}
        for metric, approx in (("l2", False), ("ip", False),
                               ("cosine", False), ("l1", False),
                               ("l2", True)):
            tol = tols[metric].cpu().numpy()
            tag = f"{metric}{' approx' if approx else ''}"
            for form in forms:
                want = plain10(metric, approx, form=form)
                ok, err = sweep_agreement(*k10(metric, approx, form), *want,
                                          tol)
                errs[form][tag] = err
                log(f"{form} {tag} vs plain at {N_SP_Q} queries x "
                    f"{N_SP + 1:,} rows: {'agree' if ok else 'DIFFER'} (max "
                    f"abs err {err})")
                if not ok:
                    raise RuntimeError(f"{form} {tag} disagrees with its "
                                       "plain version")
        tol = tols["l2"].cpu().numpy()
        c1, _ = sweep_agreement(*plain10("l2", False, cv=cv.bfloat16().float(),
                                         qv=qv.bfloat16().float()),
                                *plain10("l2"), tol)
        order_keys, from_keys = sparse_mod._order_keys, sparse_mod._from_order_keys
        try:  # the plain sweep on raw f32 bits as its keys
            sparse_mod._order_keys = lambda d, r: (
                ((d + 0.0).view(torch.int32).long() << 32) | r)
            sparse_mod._from_order_keys = lambda k: (
                torch.where(k < 0, float("inf"), (k >> 32).to(torch.int32)
                            .view(torch.float32)),
                torch.where(k < 0, -1, k & 0xFFFFFFFF))
            raw_ip = plain10("ip")
        finally:
            sparse_mod._order_keys, sparse_mod._from_order_keys = (
                order_keys, from_keys)
        c2, _ = sweep_agreement(*raw_ip, *plain10("ip"),
                                tols["ip"].cpu().numpy())
        log(f"controls: bf16-rounded values {'PASS' if c1 else 'rejected'}; "
            f"ip keys from raw f32 bits {'PASS' if c2 else 'rejected'}")
        if c1 or c2:
            raise RuntimeError("the K10 check passes a control: too loose")
        entries = float(nnz.sum())
        csr_t = torch.sparse_csr_tensor(
            torch.from_numpy(rowptr).to(dev), torch.from_numpy(
                ind[mask].astype(np.int64)).to(dev),
            torch.from_numpy(val[mask]).to(dev), size=(N_SP, DIM_SP))
        qd = sparse_mod.densify_queries(qi, qv, DIM_SP)[:, :DIM_SP]
        qdt = qd.T.contiguous()
        lib_dots = torch.sparse.mm(csr_t, qdt)  # [N, B]: the scores alone
        want = torch.from_numpy((csr @ csr[:8].T).toarray()).to(dev)
        if not torch.allclose(lib_dots[:, :8].double(), want, rtol=1e-5,
                              atol=1e-4):
            raise RuntimeError("torch.sparse.mm disagrees with scipy")
        del lib_dots
        x2 = (cv[:N_SP] * cv[:N_SP]).sum(1)
        dead = ~live[:N_SP]

        def library():  # the same function: the dots, l2, top-k
            d = torch.sparse.mm(csr_t, qdt).mul_(-2.0).add_(
                x2[:, None]).add_(q2[None]).clamp_(min=0.0)
            return torch.topk(d.masked_fill_(dead[:, None], float("inf")),
                              K, dim=0, largest=False)

        ld, li = library()
        ok_lib, _ = sweep_agreement(ld.T, li.T, *plain10(), tol)
        log(f"the composed library call (sparse.mm, l2, topk) "
            f"{'agrees with' if ok_lib else 'differs from'} the plain "
            "version")
        # the lookup form at its own domain: the same rows and queries with
        # their indices spread into [0, 10^9) by an increasing injective map
        big = 10**9
        table = np.append(np.sort(np.random.default_rng(SEED_SP).choice(
            big - 1, size=DIM_SP - 1, replace=False)), big - 1)
        table_t = torch.from_numpy(table.astype(np.int32)).to(dev)

        def spread(t):
            pad = t == sparse_mod.PAD_INDEX
            return torch.where(pad, t, table_t[torch.where(pad, 0, t).long()])

        bci, bqi = spread(ci), spread(qi)
        if sparse_mod._k10_form(big, N_SP_Q) != "lookup":
            raise RuntimeError("K10's shape rule does not take the lookup "
                               "form at dim 10^9")

        def k10_big(metric="l2", approx=False):
            return sparse_mod._sparse_topk_cuda(ci=bci, cv=cv, live=live,
                                                qi=bqi, qv=qv, k=K,
                                                metric=metric, approx=approx,
                                                dim=big)

        big_equal = {}
        for metric, approx in (("l2", False), ("ip", False),
                               ("cosine", False), ("l1", False),
                               ("l2", True)):
            tag = f"{metric}{' approx' if approx else ''}"
            (ad, ai), (bd, bi) = k10(metric, approx, "k10_sparse_lookup"), \
                k10_big(metric, approx)
            big_equal[tag] = bool(torch.equal(ai, bi) and torch.equal(ad, bd))
            dd, di = k10(metric, approx)
            ok, err = sweep_agreement(ad, ai, dd, di,
                                      tols[metric].cpu().numpy())
            same = float((ai == di).all(1).float().mean())
            log(f"k10_sparse_lookup {tag}: at dim 10^9 (spread) "
                f"{'equal to' if big_equal[tag] else 'DIFFERS from'} dim 0, "
                f"key for key; vs the dense form at {DIM_SP:,}-d "
                f"{'ids equal but for ties' if ok else 'DIFFER'} (max abs "
                f"err {err}; queries with every id equal {same:.4f})")
            if not big_equal[tag] or not ok:
                raise RuntimeError(f"the lookup form {tag} disagrees across "
                                   "dims or with the dense form")

        # the mapping kernel against its plain version, on this call's union
        uni, _ = sparse_mod.compact_union(qi)
        mapped = torch.empty_like(ci)
        cm = sparse_mod.compact_rows(ci, uni, out=mapped)
        cp = sparse_mod._compact_rows_plain(ci, uni)
        short = uni[torch.arange(uni.shape[0], device=dev)
                    != uni.shape[0] // 2]
        c_ok = bool(torch.equal(cm, cp))
        c_ctrl = bool(torch.equal(sparse_mod._compact_rows_plain(ci, short),
                                  cp))
        log(f"k10_compact (|U| = {uni.shape[0]:,} of {DIM_SP:,}): "
            f"{'equal to' if c_ok else 'DIFFERS from'} its plain version; "
            f"control (a union short of one value) "
            f"{'PASS' if c_ctrl else 'rejected'}")
        if not c_ok or c_ctrl:
            raise RuntimeError("the lookup form's mapping disagrees with its "
                               "plain version, or the check is too loose")

        # the library at the lookup form's domain: CSR rows times CSR queries
        # at dim 10^9 (the dense queries cannot be formed there)
        lib_big_err, lib_big_once_ms = None, None
        try:
            bmask = bci != sparse_mod.PAD_INDEX
            qmask = bqi != sparse_mod.PAD_INDEX
            csr_big = torch.sparse_csr_tensor(
                torch.from_numpy(rowptr).to(dev), bci[:N_SP][bmask[:N_SP]]
                .long(), cv[:N_SP][bmask[:N_SP]], size=(N_SP, big))
            qptr = torch.zeros(N_SP_Q + 1, dtype=torch.int64, device=dev)
            qptr[1:] = qmask.sum(1).cumsum(0)
            q_csc = torch.sparse_csr_tensor(
                qptr, bqi[qmask].long(), qv[qmask],
                size=(N_SP_Q, big)).t()

            def library_big():
                dots = torch.sparse.mm(csr_big, q_csc).to_dense()
                d = dots.mul_(-2.0).add_(x2[:, None]).add_(q2[None]).clamp_(
                    min=0.0)
                return torch.topk(d.masked_fill_(dead[:, None], float("inf")),
                                  K, dim=0, largest=False)

            torch.cuda.synchronize()
            t0 = time.time()
            lb_d, lb_i = library_big()
            torch.cuda.synchronize()
            first_s = time.time() - t0
            ok_lb, _ = sweep_agreement(lb_d.T, lb_i.T, *plain10(), tol)
            log(f"the composed library call at dim 10^9 (sparse.mm of CSR "
                f"rows and CSR queries, l2, topk) "
                f"{'agrees with' if ok_lb else 'differs from'} the plain "
                f"version; its first call {first_s:.3f} s")
            lib_big_once_ms = first_s * 1e3
            if first_s > 5.0:  # too slow to time in turns: that call's time
                lib_big_err = "timed once on the host clock"
                library_big = None
        except (RuntimeError, NotImplementedError, TypeError) as e:
            library_big = None
            lib_big_err = f"{type(e).__name__}: {str(e).splitlines()[0][:200]}"
            log(f"torch.sparse.mm at dim 10^9 raised: {lib_big_err}")

        arms = {"k10_sparse": lambda: k10(),
                "k10_sparse_lookup": lambda: k10(form="k10_sparse_lookup"),
                "k10_sparse_lookup_1e9": lambda: k10_big(),
                "library": library}
        if library_big is not None:
            arms["library_1e9"] = library_big
        turns = {name: [] for name in arms}
        for name in [*arms, *reversed(list(arms))]:
            turns[name].append(cuda_ms(arms[name], 3 if name.startswith(
                "library") else 10))
        log(f"K10 in turns (ms): {turns}; torch.sparse.mm alone "
            f"{cuda_ms(lambda: torch.sparse.mm(csr_t, qdt), 3):.4f} ms")
        plain_ms = cuda_ms(plain10, 2)
        plain_lookup_ms = cuda_ms(lambda: sparse_mod._sparse_topk_plain(
            ci, cv, live, qi, qv, K, "l2"), 2)
        for form in forms:
            lookup = not forms[form]
            kernels[form] = dict(
                name=form, route="cuda", source=CSRC + "k10_sparse.cu",
                replaces=f"{JAX_DEVICE}:1313 (_exact_search_sparse, an XLA "
                         "program: " + ("its dense-query gather, :1481)"
                                        if not lookup else
                                        "its searchsorted merge join, :1486)"),
                max_abs_err=errs[form]["l2"], max_abs_err_by_mode=errs[form],
                ms=float(np.mean(turns[form])),
                plain_ms=plain_lookup_ms if lookup else plain_ms,
                **bound(3.0 * N_SP_Q * entries, "f32",
                        entries * 8 + (N_SP + 1) + N_SP_Q * (P * 8 + K * 12)),
                library_ms=float(np.mean(turns["library"])),
                library_of="torch.sparse.mm of the CSR corpus and the "
                           "densified queries, the l2 epilogue and "
                           "torch.topk (the same function)",
                approx_ms=cuda_ms(lambda: k10("l2", True, form)),
                launches=launches[form])
        lk = kernels["k10_sparse_lookup"]
        lk.update(
            dim_1e9_ms=float(np.mean(turns["k10_sparse_lookup_1e9"])),
            dim_1e9_equal=big_equal,
            dim_1e9_library_ms=(float(np.mean(turns["library_1e9"]))
                                if library_big is not None
                                else lib_big_once_ms),
            dim_1e9_library_error=lib_big_err,
            dim_1e9_library_of="torch.sparse.mm of the CSR rows and the CSR "
                               "queries at dim 10^9, to_dense, the l2 "
                               "epilogue and torch.topk")
        # the mapping: its bytes (the indices read and written, the union)
        searchsorted_ms = cuda_ms(lambda: torch.searchsorted(uni, ci))
        kernels["k10_compact"] = dict(
            name="k10_compact", route="cuda", source=CSRC + "k10_sparse.cu",
            replaces=f"{JAX_DEVICE}:1486 (_exact_search_sparse's searchsorted "
                     "merge join, pgvector_rx_tpu/ops/sparse.py:189 pairwise: "
                     "the search of each stored index, once per stored entry "
                     "here)",
            max_abs_err=0.0 if c_ok else float("nan"),
            ms=cuda_ms(lambda: sparse_mod.compact_rows(ci, uni, out=mapped)),
            plain_ms=cuda_ms(lambda: sparse_mod._compact_rows_plain(ci, uni)),
            **bound(0.0, "f32", 8.0 * ci.numel() + 4.0 * uni.shape[0]),
            library_ms=None, searchsorted_ms=searchsorted_ms,
            union=int(uni.shape[0]), launches=launches["k10_compact"])
        del csr_t, qd, qdt, bci, bqi, mapped
        for name in ("k10_sparse", "k10_sparse_lookup", "k10_compact",
                     "k4_beam_sparse"):
            kr = kernels[name]
            kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
            log(f"{name}: kernel {kr['ms']:.4f} ms, plain "
                f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']} ms, "
                f"bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}, "
                f"{kr['bound_peak']}), share {kr['share_of_bound']:.4f}")
        log(f"k10_sparse_lookup at dim 10^9: {lk['dim_1e9_ms']:.4f} ms; "
            f"the library there {lk['dim_1e9_library_ms']} ms "
            f"({lib_big_err or 'ran'}); torch.searchsorted alone "
            f"{searchsorted_ms:.4f} ms")

    t028 = {}
    with Phase(f"24e t/028 at {T028_N:,} x 3-d sparse, k={T028_K}"):
        rng = np.random.default_rng(107)
        dense, qdense, rows3, q3 = t028_data(rng)
        for metric in ("l2", "cosine", "ip", "l1"):
            t0 = time.time()
            ti = HnswIndex.build(rows3, metric=metric, seed=108)  # the card
            gt3 = np.argsort(np_dense_order(metric, qdense, dense), axis=1,
                             kind="stable")[:, :T028_K]
            recs = {}
            for method in ("exact", "device"):
                _, ids = ti.search(q3, T028_K, params, method=method)
                recs[method] = set_recall(ids, gt3, T028_K)
            log(f"t/028 {metric}: build {time.time() - t0:.3f} s, recall@20 "
                f"exact {recs['exact']:.4f}, beam {recs['device']:.4f} "
                f"(floor {T028_FLOORS[metric]}) on {ti.device}")
            if (ti.device.type != dev.type
                    or min(recs.values()) < T028_FLOORS[metric]):
                raise RuntimeError(f"t/028 {metric} below its floor")
            t028[metric] = ti

    with Phase("24f the sparse operator classes"):
        xd = csr[:N_OPCLASS].toarray()
        qd64 = csr[:64].toarray()
        for name, oc in OPERATOR_CLASSES.items():
            if oc.kind != "sparse":
                continue
            oi = create_index_for_opclass(name, DIM_SP)  # no device: card
            # the native bulk load (the host insert path takes ~100 s for
            # 500 such rows)
            native.native_bulk_build(oi, rows[:N_OPCLASS], range(N_OPCLASS))
            _, tids = oi.search(queries[:64], K, method="exact")
            _, tids_b = oi.search(queries[:64], K, params, method="device")
            if oc.metric == "l1":
                ref = np.stack([np.abs(qq - xd).sum(1) for qq in qd64])
            else:
                ref = np_dense_order(oc.metric, qd64, xd)
            got = ref[np.arange(64), tids[:, 0]]
            ok = (oi.device.type == dev.type and (tids >= 0).all()
                  and (tids_b >= 0).all()
                  and np.allclose(got, ref.min(axis=1), rtol=1e-4, atol=1e-4))
            log(f"{name}: index on {oi.device}, exact top-1 "
                f"{'is' if ok else 'is not'} the float64 nearest of "
                f"{N_OPCLASS} rows on 64 queries; the beam answers")
            if not ok:
                raise RuntimeError(f"the {name} index does not answer")

    with Phase("24g t/028 l2 checkpoint round trip"), \
            tempfile.TemporaryDirectory() as ck_dir:
        ti = t028["l2"]
        methods = ("exact", "approx", "device")
        before = {m: ti.search(q3, T028_K, params, method=m)[1]
                  for m in methods}
        ti.save(Path(ck_dir) / "t028")
        back = HnswIndex.load(Path(ck_dir) / "t028")
        diff = {m: int((back.search(q3, T028_K, params, method=m)[1]
                        != before[m]).any(axis=1).sum()) for m in methods}
        log(f"reloaded on {back.device}: rows whose ids changed per engine: "
            f"{diff}")
        if any(diff.values()) or back.device.type != dev.type:
            raise RuntimeError("the reloaded sparse index answers "
                               "differently")
    log(f"sparse path recall@10: {recall}")


class BeamMode:
    """The beam's variant as a user sets it: ``PGV_BEAM_EXPAND`` in the
    environment (read at every call) and the two switches the port reads
    at import (``_VISITED_MAX_ROWS``, ``_BEAM_BF16``) on its module;
    restored on exit."""

    def __init__(self, device_mod, expand=1, visited_max=0, bf16=False):
        self.dm, self.mode = device_mod, (expand, visited_max, bf16)

    def __enter__(self):
        self.saved = (os.environ.get("PGV_BEAM_EXPAND"),
                      self.dm._VISITED_MAX_ROWS, self.dm._BEAM_BF16)
        os.environ["PGV_BEAM_EXPAND"] = str(self.mode[0])
        self.dm._VISITED_MAX_ROWS, self.dm._BEAM_BF16 = self.mode[1:]
        return self

    def __exit__(self, *exc):
        env = self.saved[0]
        if env is None:
            os.environ.pop("PGV_BEAM_EXPAND", None)
        else:
            os.environ["PGV_BEAM_EXPAND"] = env
        self.dm._VISITED_MAX_ROWS, self.dm._BEAM_BF16 = self.saved[1:]
        return False


def mode_verdict(k, p, c, recall, exact=False):
    """K4 in a mode against its plain version and a control, each the
    walk's sorted outputs with its rows scored (dists, ids, steps, scored,
    numpy): (queries equal but for ties, queries whose steps and rows
    scored are equal, the recall gap, max abs err, passed) for the kernel
    and for the control. ``exact``: integer distances, ties by distance."""
    def one(x):
        if exact:
            ok, err = tie_equal_rows(x[1], x[0], p[1], p[0]), 0.0
        else:
            ok, err = walk_agreement(x[1], x[0], p[1], p[0])
        same_st = float(np.mean((x[2] == p[2]) & (x[3] == p[3])))
        gap = abs(recall(x[1]) - recall(p[1])) if recall else 0.0
        passed = ok.mean() >= 0.99 and same_st >= 0.99 and gap <= 0.002
        return float(ok.mean()), same_st, gap, err, passed
    return one(k), one(c)


def mode_bytes(steps, scored, L, B, *, expand=1, row_bytes, rank_rows=0,
               seeds=8, d=DIM):
    """A mode's walk bytes, what its function needs whatever the design:
    each step's E L neighbour ids; each scored row and its live flag; each
    query's f32 row, its seeds, its ef outputs and, ranking in bf16, the
    f32 rows of its re-scored beam (``rank_rows``). The visited bitmap is
    the walk's own scratch (a set of ids), so none of its words count."""
    return (steps * expand * L * 4 + scored * (row_bytes + 1)
            + B * (d * 4 + seeds * 8 + EF * 8 + 8 + rank_rows * d * 4))


def unrounded_rank_dists(values_bf16, metric, q, ids):
    """The bf16 ranking's control: its terms over the same bf16 rows and
    query, the difference or product left unrounded (f32), summed exactly
    (``ops/beam.rank_dists`` rounds each to bf16 first)."""
    cand = values_bf16[ids.clamp(0, values_bf16.shape[0] - 1).long()].float()
    qb = q[:, None, :].to(torch.bfloat16).float()
    if metric == "l2":
        t = (cand - qb).double()
        return (t * t).sum(dim=-1).float()
    dots = (cand * qb).double().sum(dim=-1).float()
    return -dots if metric == "ip" else 1.0 - dots.clamp(-1.0, 1.0)


@contextlib.contextmanager
def terms_unrounded(beam):
    """The plain walks inside rank by ``unrounded_rank_dists``."""
    saved = beam.rank_dists
    beam.rank_dists = unrounded_rank_dists
    try:
        yield
    finally:
        beam.rank_dists = saved


def beam_variants(index, g, q_dev, emit, gt, device_mod, beam, bf, kernels,
                  SearchParams):
    """Phase 25: the beam's variants on the grown graph, through
    ``serve_topk`` and the scans as a user sets them (its own path: the
    counts set to 0 before and read after); then K4 in each mode and K5
    with E = 4 and with bf16 against their plain versions, timed beside
    their bounds."""
    recall = recall_of(emit, gt)
    vis_max = g.capacity + 2
    log(f"25 graph capacity {g.capacity:,} (rows {g.cap:,}); visited "
        f"bitmap mode with _VISITED_MAX_ROWS = {vis_max:,} > capacity + 1 = "
        f"{g.capacity + 1:,}")
    modes = {"default": BeamMode(device_mod),
             "expand2": BeamMode(device_mod, expand=2),
             "expand4": BeamMode(device_mod, expand=4),
             "visited": BeamMode(device_mod, visited_max=vis_max),
             "expand4_visited": BeamMode(device_mod, expand=4,
                                         visited_max=vis_max),
             "bf16": BeamMode(device_mod, bf16=True),
             "expand4_bf16": BeamMode(device_mod, expand=4, bf16=True)}
    served, launches = {}, {}
    bf.reset_launches()
    for name, mode in modes.items():
        with Phase(f"25 serve_topk beam, {name}"), mode:
            before = bf.LAUNCHES["k4_beam"]
            d, ids, dt = timed_serve(device_mod, index, q_dev, "beam",
                                     calls=SERVE_CALLS)
            launches[name] = bf.LAUNCHES["k4_beam"] - before
            rec = recall(ids)
            served[name] = (rec, N_QUERIES / dt)
            log(f"25 beam {name}: recall@10={rec:.4f} "
                f"qps={N_QUERIES / dt:.1f} ({dt:.4f} s for {N_QUERIES} "
                f"queries, the median of {SERVE_CALLS} calls; default "
                f"{served['default'][0]:.4f} at {served['default'][1]:.1f} "
                "qps in this run), "
                f"{launches[name]} K4 launches")
            if d.shape != (N_QUERIES, K) or not np.isfinite(d).all():
                raise RuntimeError(f"beam {name}: non-finite or misshapen "
                                   "output")
            if rec < FLOORS["beam"]:
                raise RuntimeError(f"beam {name}: recall {rec} < "
                                   f"{FLOORS['beam']}")
            if launches[name] <= 0:
                raise RuntimeError(f"beam {name}: K4 did not launch")

    # K5's modes: the 0.2% filtered scans, strict and relaxed, beside the
    # default on the same queries
    q_scan = q_dev[:VARIANT_SCAN_Q].contiguous()
    eids = torch.arange(g.cap, device=q_dev.device)
    rows = torch.nonzero(eids % 500 == 0).flatten()
    mask = (eids % 500 == 0).cpu().numpy()
    expected = filtered_expected(g.values, q_scan, rows, SCAN_LIMIT)
    scans = {}
    for name in ("default", "expand4", "bf16"):
        with Phase(f"25 beam scans at 0.2%, {name}"), modes[name]:
            before = bf.LAUNCHES["k5_beam_scan"]
            for order in ("strict_order", "relaxed_order"):
                rec, lat, segs, _ = scan_recall(index, q_scan, mask,
                                                expected, order,
                                                SearchParams)
                scans[(name, order)] = (rec, float(np.percentile(lat, 50)))
                log(f"25 beam scan {name} {order} eid % 500 == 0: recall "
                    f"{rec:.4f}, ms to the {SCAN_LIMIT}th row p50 "
                    f"{scans[(name, order)][1]:.3f} (default "
                    f"{scans[('default', order)][0]:.4f}, p50 "
                    f"{scans[('default', order)][1]:.3f} ms), segments mean "
                    f"{segs.mean():.2f}")
                if rec < SCAN_FLOORS[(order, 500)] - 0.1:
                    raise RuntimeError(f"beam scan {name} {order}: recall "
                                       f"{rec}")
            launches["k5_" + name] = bf.LAUNCHES["k5_beam_scan"] - before
            if launches["k5_" + name] <= 0:
                raise RuntimeError(f"beam scan {name}: K5 did not launch")
    log(f"25 launches: {launches}")

    # K4 in each mode against its plain version and a control, at 1,024
    # queries from the coarse seeds
    q1 = q_dev[:CHUNK].contiguous()
    L = g.neighbors0.shape[1]
    upper = device_mod._coarse_upper(g)
    s_ids, s_d = device_mod._coarse_seeds(g, q1, upper[0], upper[1], 8)
    s_ids = s_ids.to(torch.int32).contiguous()
    walk = (g.values, g.neighbors0, g.traversable, None, "l2", q1, s_ids, s_d)
    kw = dict(width=EF, spill=0, max_steps=4 * EF + 32, scan=False)
    words = beam.visited_words(g.cap)

    def recall1(ids):
        return recall_of(emit, gt[:CHUNK])(ids[:, :K])

    def finished(raw):
        return [t.cpu().numpy() for t in (*beam._serve_finish(*raw), raw[5])]

    no_control = contextlib.nullcontext
    checks = {  # row -> (mode, [(control, its label, its context)], of)
        "k4_beam_expand4": (dict(expand=4), [({}, "the plain walk at E = 1",
                                              no_control)], "expand4"),
        "k4_beam_visited": (dict(visited=True), [
            ({}, "the plain walk with the in-beam dedup", no_control)],
            "visited"),
        "k4_beam_expand4_visited": (dict(expand=4, visited=True), [
            (dict(visited=True), "the plain walk with the bitmap at E = 1",
             no_control)], "expand4_visited"),
        "k4_beam_bf16": (dict(rank=g.values_bf16), [
            ({}, "the plain walk ranking in f32", no_control),
            (dict(rank=g.values_bf16), "the plain walk whose ranking terms "
             "skip the bf16 rounding", lambda: terms_unrounded(beam))],
            "bf16"),
    }
    with Phase("25 K4's modes vs plain"):
        for name, (mk, controls, of) in checks.items():
            raw_k = beam._walk_cuda(*walk, **kw, **mk)
            k = finished(raw_k)
            p = finished(beam._walk_plain(*walk, **kw, **mk))
            steps, scored = float(raw_k[4].sum()), float(raw_k[5].sum())
            for ck, label, ctx in controls:
                with ctx():
                    c = finished(beam._walk_plain(*walk, **kw, **ck))
                (k_ok, k_st, k_gap, k_err, k_pass), (c_ok, c_st, c_gap, _,
                                                     c_pass) = mode_verdict(
                    k, p, c, recall1)
                log(f"25 {name} vs plain: {k_ok:.4f} of queries equal but "
                    f"for ties, {k_st:.4f} equal steps and rows scored, "
                    f"recall@10 {recall1(k[1]):.4f} vs {recall1(p[1]):.4f}, "
                    f"max abs err {k_err}; control ({label}): {c_ok:.4f} "
                    f"equal, {c_st:.4f} steps, recall gap {c_gap:.4f}; "
                    f"{steps / CHUNK:.1f} steps and {scored / CHUNK:.1f} rows "
                    "scored per query")
                if not k_pass:
                    raise RuntimeError(f"{name} disagrees with its plain "
                                       "version")
                if c_pass:
                    raise RuntimeError(f"the {name} check passes {label}")
            nbytes = mode_bytes(
                steps, scored, L, CHUNK, expand=mk.get("expand", 1),
                row_bytes=DIM * (2 if "rank" in mk else 4),
                rank_rows=EF if "rank" in mk else 0)
            if mk.get("visited"):  # the first form's bound, once
                first = (nbytes + steps * mk.get("expand", 1) * L * 4
                         + CHUNK * words * 4)
                log(f"25 {name}: the bound (ids, rows, each query's input "
                    f"and output) {nbytes / PEAKS['bytes'] * 1e3:.4f} ms; "
                    f"the first form's (also a bitmap word read per id and "
                    f"each query's {words:,} words cleared per launch) "
                    f"{first / PEAKS['bytes'] * 1e3:.4f} ms")
            kernels[name] = dict(
                name=name, route="cuda", source=CSRC + "k4_beam.cu",
                replaces=f"{JAX_DEVICE}:446 (_ground_beam_seeds, an XLA "
                         f"while-loop; the {of} variant)",
                max_abs_err=k_err,
                ms=cuda_ms(lambda: beam._walk_cuda(*walk, **kw, **mk)),
                plain_ms=cuda_ms(lambda: beam._walk_plain(*walk, **kw, **mk),
                                 iters=1),
                **bound(scored * 3.0 * DIM, "f32", nbytes),
                library_ms=None, steps_mean=steps / CHUNK,
                scored_mean=scored / CHUNK, launches=launches[of])

    # K5 with E = 4 and with bf16 ranking against its plain segment: 32
    # queries, 3 segments, each form fed its own spill and marks
    nq, W = 32, 4 * EF
    spill = max(2 * EF, 64) + (W - EF)
    steps_w = 4 * W + 32
    q32 = q1[:nq].contiguous()
    seed0 = (torch.nn.functional.pad(s_ids[:nq], (0, spill - 8), value=-1),
             torch.nn.functional.pad(s_d[:nq], (0, spill - 8),
                                     value=float("inf")))
    graph = (g.values, g.neighbors0, g.traversable)
    with Phase("25 K5's modes vs plain"):
        for name, mk, of in (("k5_beam_scan_expand4", dict(expand=4),
                              "k5_expand4"),
                             ("k5_beam_scan_expand2", dict(expand=2), None),
                             ("k5_beam_scan_expand8", dict(expand=8), None),
                             ("k5_beam_scan_bf16",
                              dict(rank=g.values_bf16), "k5_bf16")):
            def kernel5(excl, allowed, seeds):
                return beam.scan_segment(*graph, excl, "l2", q32, *seeds, EF,
                                         W, spill, steps_w, allowed=allowed,
                                         mark=True, **mk)

            def plain5(excl, allowed, seeds):
                return beam._scan_plain(
                    *graph, excl, "l2", q32,
                    seeds[0].to(torch.int32).contiguous(),
                    seeds[1].contiguous(), EF, W, spill, steps_w, True,
                    mk.get("expand", 1), mk.get("rank"))

            rank = "rank" in mk

            def fed(run):  # 3 segments, each fed the last one's spill
                excl = torch.zeros((nq, g.cap + 1), dtype=torch.bool,
                                   device=q1.device)
                allowed = beam.staged_bitmap(*graph, excl, spill, W, EF,
                                             spill, mk.get("expand", 1),
                                             rank)
                seeds, out = seed0, []
                for _ in range(3):
                    rep, sp_d, sp_i = run(excl, allowed, seeds)
                    out.append([t.cpu().numpy() for t in (rep, sp_d, sp_i)])
                    seeds = (sp_i, sp_d)
                return out

            def agree(ks, ps, who):
                """(query-segment pairs that differ, max abs err, share of
                queries with equal steps and rows scored)."""
                bad, err, same = 0, 0.0, []
                for seg, (k, p) in enumerate(zip(ks, ps)):
                    kb_d, kb_i = (k[0][:, :EF].view(np.float32),
                                  k[0][:, EF:2 * EF])
                    pb_d, pb_i = (p[0][:, :EF].view(np.float32),
                                  p[0][:, EF:2 * EF])
                    ok_b, e1 = walk_agreement(kb_i, kb_d, pb_i, pb_d)
                    ok_s, e2 = walk_agreement(k[2], k[1], p[2], p[1])
                    ok = ok_b & ok_s
                    bad += int((~ok).sum())
                    err = max(err, e1, e2)
                    # steps and rows scored, query by query
                    same.append((k[0][:, 2 * EF:2 * EF + 2]
                                 == p[0][:, 2 * EF:2 * EF + 2]).all(1))
                    log(f"25 {name} segment {seg}, {who}: {int(ok.sum())}/"
                        f"{nq} beams and spills equal but for ties, "
                        f"{int(same[-1].sum())}/{nq} equal steps and rows "
                        f"scored (steps {who} {k[0][:, 2 * EF].sum()} plain "
                        f"{p[0][:, 2 * EF].sum()}, rows scored {who} "
                        f"{k[0][:, 2 * EF + 1].sum()} plain "
                        f"{p[0][:, 2 * EF + 1].sum()})")
                return bad, err, float(np.mean(same))

            runs = [fed(kernel5), fed(plain5)]
            bad, err5, same_sc = agree(*runs, "kernel")
            if bad or same_sc < 0.99:
                raise RuntimeError(f"{name} disagrees with its plain version "
                                   f"on {bad} (query, segment) pairs; steps "
                                   f"and rows scored equal on {same_sc:.4f}")
            if rank:  # the control: terms that skip the bf16 rounding
                with terms_unrounded(beam):
                    ctl = fed(plain5)
                c_bad, _, c_same = agree(ctl, runs[1], "control")
                if not c_bad and c_same >= 0.99:
                    raise RuntimeError(f"the {name} check passes the plain "
                                       "segment whose ranking terms skip "
                                       "the bf16 rounding")
            excl0 = torch.zeros((1, g.cap + 1), dtype=torch.bool,
                                device=q1.device)
            allowed0 = beam.staged_bitmap(*graph, excl0, spill, W, EF, spill,
                                          mk.get("expand", 1), rank)
            one = (*graph, excl0, "l2", q32[:1], seed0[0][:1].to(torch.int32),
                   seed0[1][:1])
            rep1 = beam.scan_segment(*one, EF, W, spill, steps_w,
                                     allowed=allowed0, **mk)[0]
            steps1, scored1 = float(rep1[0, 2 * EF]), float(rep1[0, 2 * EF + 1])
            ms5 = cuda_ms(lambda: beam.scan_segment(
                *one, EF, W, spill, steps_w, allowed=allowed0, **mk))
            nbytes = mode_bytes(steps1, scored1, L, 1,
                                expand=mk.get("expand", 1),
                                row_bytes=DIM * (2 if rank else 4) + 1,
                                rank_rows=W if rank else 0, seeds=spill
                                ) + (W + spill) * 8
            kernels[name] = dict(
                name=name, route="cuda", source=CSRC + "k4_beam.cu",
                replaces=f"{JAX_DEVICE}:574 (_beam_scan_segment, an XLA "
                         "while-loop; the "
                         + (f"E = {mk['expand']}" if not rank
                            else "bf16 ranking")
                         + " variant)",
                max_abs_err=err5, ms=ms5,
                plain_ms=cuda_ms(lambda: beam._scan_plain(
                    *one, EF, W, spill, steps_w, False, mk.get("expand", 1),
                    mk.get("rank")), iters=1),
                **bound(scored1 * 3.0 * DIM, "f32", nbytes),
                latency_bound_ms=steps1 * kernels["k5_beam_scan"][
                    "round_trip_us"] / 1e3,
                library_ms=None, steps_mean=steps1, scored_mean=scored1,
                us_per_step=ms5 / steps1 * 1e3,
                steps_scored_equal=same_sc,
                launches=launches[of] if of else None)
            log(f"25 {name} per segment: {ms5:.4f} ms, "
                f"{ms5 / steps1 * 1e3:.3f} us per step, {steps1:.0f} steps")
    # K5 per step at each E beside the default, in turns, on the timed
    # segment of phase 13 (one query, nothing excluded, the staged bitmap)
    with Phase("25 K5 per step by E, in turns"):
        bms = {e: beam.staged_bitmap(*graph, excl0, spill, W, EF, spill, e)
               for e in (1, 2, 4, 8)}
        seg = {e: (lambda e=e: beam.scan_segment(
            *one, EF, W, spill, steps_w, allowed=bms[e], expand=e))
            for e in bms}
        st = {e: float(seg[e]()[0][0, 2 * EF]) for e in seg}
        turns5 = {e: [] for e in seg}
        for e in [*seg, *reversed(list(seg))]:
            turns5[e].append(cuda_ms(seg[e]))
        per_step = {e: float(np.mean(turns5[e])) / st[e] * 1e3 for e in seg}
        log(f"25 K5 in turns (ms per segment): {turns5}; steps {st}; us per "
            f"step {per_step}")
        kernels["k5_beam_scan_expand4"].update(
            ms_by_expand={e: float(np.mean(turns5[e])) for e in seg},
            steps_by_expand=st, us_per_step_by_expand=per_step,
            # E = 2 and 8 held to the plain version like E = 4 (the same
            # kernel's mode: the kernels line keeps one entry for it)
            other_expand={e: {k: kernels[f"k5_beam_scan_expand{e}"][k]
                              for k in ("ms", "plain_ms", "max_abs_err",
                                        "bound_ms", "latency_bound_ms",
                                        "steps_mean", "scored_mean",
                                        "us_per_step", "steps_scored_equal")}
                          for e in (2, 8)})
    for name in ("k4_beam_expand4", "k4_beam_visited",
                 "k4_beam_expand4_visited", "k4_beam_bf16",
                 "k5_beam_scan_expand4", "k5_beam_scan_expand2",
                 "k5_beam_scan_expand8", "k5_beam_scan_bf16"):
        kr = kernels[name]
        kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
        log(f"{name}: kernel {kr['ms']:.4f} ms, plain {kr['plain_ms']:.4f} "
            f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}, "
            f"{kr['bound_peak']}), share {kr['share_of_bound']:.4f}, "
            f"{kr['launches']} launches")


def descent_mode_check(g, q, metric, beam, device_mod, kernels, name,
                       mode, control, label, launches, replaces, exact,
                       row_bytes, ops_per_row, peak):
    """A mode of the walk's launch (the descent in K4's launch, then the
    walk: packed words or sparse rows) against the plain walk in the same
    mode from the torch descent's landing, and a control (the plain walk
    in ``control``); timed beside its bound. Adds the kernel's row."""
    steps_max = 4 * EF + 32
    B = (q[0] if isinstance(q, tuple) else q).shape[0]
    qq = beam._queries(q, metric)
    upper = (g.upper_slot, g.upper_neighbors, g.m, g.entry, g.entry_level)
    seeds = torch.full((B, 1), -1, dtype=torch.int32, device=g.device)
    zeros = torch.zeros((B, 1), device=g.device)

    def launch():
        return beam._launch_walk(g.rows, g.neighbors0, g.traversable, metric,
                                 qq, seeds, zeros, EF, steps_max, upper,
                                 **mode)

    s_ids, s_d = device_mod._descent_seeds(g, q, g.entry_level)

    def plain(**kw):
        raw = beam._walk_plain(g.rows, g.neighbors0, g.traversable, None,
                               metric, qq, s_ids.to(torch.int32), s_d,
                               width=EF, spill=0, max_steps=steps_max,
                               scan=False, **kw)
        return [t.cpu().numpy() for t in (*beam._serve_finish(*raw), raw[5])]

    raw_k, land = launch()
    if not torch.equal(land[:, 0].long(), s_ids[:, 0]):
        raise RuntimeError(f"{name}: the descent lands elsewhere")
    k = [t.cpu().numpy() for t in (*beam._serve_finish(*raw_k), raw_k[5])]
    p = plain(**mode)
    (k_ok, k_st, _, _, k_pass), (c_ok, c_st, _, _, c_pass) = mode_verdict(
        k, p, plain(**control), None, exact=exact)
    log(f"{name} vs plain: {k_ok:.4f} of queries equal but for ties, "
        f"{k_st:.4f} equal steps and rows scored; control ({label}): "
        f"{c_ok:.4f} equal, {c_st:.4f} steps")
    if not k_pass:
        raise RuntimeError(f"{name} disagrees with its plain version")
    if c_pass:
        raise RuntimeError(f"the {name} check passes {label}")
    steps, scored = float(raw_k[4].sum()), float(raw_k[5].sum())
    d_rows, moves = float(land[:, 2].sum()), float(land[:, 3].sum())
    iters = moves + B * g.entry_level
    nbytes = (mode_bytes(steps, scored, g.neighbors0.shape[1], B,
                         expand=mode.get("expand", 1), row_bytes=row_bytes,
                         seeds=0, d=0)
              + iters * (4 + 4 * g.m) + d_rows * (row_bytes + 1)
              + B * row_bytes)
    fin = np.isfinite(p[0])
    kernels[name] = dict(
        name=name, route="cuda", source=CSRC + "k4_beam.cu",
        replaces=replaces, queries=B,
        max_abs_err=float(np.abs(k[0][fin] - p[0][fin]).max()),
        ms=cuda_ms(launch), ms_of="one launch: the greedy descent and the "
                                  "walk",
        plain_ms=cuda_ms(lambda: plain(**mode), 1),
        **bound(ops_per_row * (scored + d_rows), peak, nbytes),
        library_ms=None, steps_mean=steps / B, scored_mean=scored / B,
        launches=launches)
    kr = kernels[name]
    kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
    if g.words is not None:
        word_latency_bound(kr, raw_k[4], land, g.entry_level,
                           kernels["k4_beam_words"]["round_trip_us"])
    log(f"{name} at {B} queries: {kr['ms']:.4f} ms, plain "
        f"{kr['plain_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms "
        f"({kr['bound_by']}, {kr['bound_peak']}), share "
        f"{kr['share_of_bound']:.4f}, {kr['steps_mean']:.1f} steps and "
        f"{kr['scored_mean']:.1f} rows scored per query, {launches} "
        "launches")


def bit_variants(idx, g, qw, kth, bits_mod, device_mod, beam, bf, kernels):
    """Phase 25 on the bit graph of phase 21: ``serve_topk`` beam by
    default, with E = 4, with the visited bitmap and with both through the
    word walk (tie-aware recall; qps the median of ``SERVE_CALLS`` calls),
    then each mode of the word walk against its plain version."""
    vis_max = g.capacity + 2
    launches, served = {}, {}
    bf.reset_launches()
    for name, mode in (("default", BeamMode(device_mod)),
                       ("expand4", BeamMode(device_mod, expand=4)),
                       ("visited", BeamMode(device_mod,
                                            visited_max=vis_max)),
                       ("expand4_visited", BeamMode(
                           device_mod, expand=4, visited_max=vis_max))):
        with Phase(f"25 bit serve_topk beam, {name}"), mode:
            before = bf.LAUNCHES["k4_beam"]
            d, ids, dt = timed_serve(device_mod, idx, qw, "beam",
                                     calls=SERVE_CALLS)
            launches[name] = bf.LAUNCHES["k4_beam"] - before
            rec = bit_recall(bits_mod, g, qw, ids, kth)
            served[name] = (rec, N_BIT_Q / dt)
            log(f"25 bit beam {name}: tie-aware recall@10={rec:.4f} "
                f"qps={N_BIT_Q / dt:.1f} (the median of {SERVE_CALLS} "
                f"calls; default {served['default'][1]:.1f} qps in this "
                f"run), {launches[name]} K4 launches")
            if not np.isfinite(d).all() or rec < BIT_FLOORS["beam"]:
                raise RuntimeError(f"bit beam {name}: recall {rec}")
            if launches[name] <= 0:
                raise RuntimeError(f"bit beam {name}: K4 did not launch")
    log("25 bit beam served qps: " + json.dumps(
        {n: round(v[1], 1) for n, v in served.items()}))
    q1 = qw[:CHUNK].contiguous()
    w = g.words.shape[1]
    with Phase("25 the word walk's modes vs plain"):
        for name, mode, control, label, of in (
                ("k4_words_expand4", dict(expand=4), {}, "the plain walk "
                 "at E = 1", "expand4"),
                ("k4_words_visited", dict(visited=True), {}, "the plain "
                 "walk with the in-beam dedup", "visited"),
                ("k4_words_expand4_visited", dict(expand=4, visited=True),
                 dict(visited=True), "the plain walk with the bitmap at "
                 "E = 1", "expand4_visited")):
            descent_mode_check(
                g, q1, "hamming", beam, device_mod, kernels, name, mode,
                control, label, launches[of],
                f"{JAX_DEVICE}:767 (_search_batch over packed bit rows; the "
                f"{of} variant; XLA)", True, w * 4, NBITS * 2.0, "int8")


def sparse_visited(idx, g, queries, qt, device_mod, beam, bf, kernels,
                   recall, nnz_mean):
    """Phase 25 on the sparse graph of phase 24: ``search`` with the
    visited bitmap through the sparse-row walk (recall against K10's
    ground truth), then that mode against its plain version."""
    from pgvector_rx_tpu_torch import SearchParams

    vis_max = g.capacity + 2
    bf.reset_launches()
    with Phase("25 sparse search, visited"), BeamMode(
            device_mod, visited_max=vis_max):
        _, ids = idx.search(queries, K, SearchParams(ef_search=EF),
                            method="device")
        n = bf.LAUNCHES["k4_beam_sparse"]
        log(f"25 sparse beam visited: recall@10={recall(ids):.4f}, {n} K4 "
            "launches")
        if n <= 0:
            raise RuntimeError("sparse visited: K4 did not launch")
    with Phase("25 the sparse-row walk's visited mode vs plain"):
        descent_mode_check(
            g, qt, "l2", beam, device_mod, kernels, "k4_sparse_visited",
            dict(visited=True), {}, "the plain walk with the in-beam dedup",
            n, f"{JAX_DEVICE}:1861 (_search_one_sparse; the visited "
               "variant; XLA)", False, g.sp_indices.shape[1] * 8,
            3.0 * nnz_mean, "f32")


def halfvec_path(HnswIndex, IndexParams, make_dataset, device_mod, bf, dev,
                 kernels):
    """Phase 26: BASELINE's halfvec(1024) inner-product configuration at
    1,000,000 rows (bench_suite.py:141-170), uncut: built on the card with
    an f16 store (the beam-descent ground), K1 ground truth over the f16
    store in chunks held to float64, the three engines over 4,096 queries
    with the exact call's peak memory above the graph, the same engines
    over a bf16 store of the same rows (``PGV_SERVE_DTYPE=bf16``), and K1
    and K2 at d = 1,024 against their plain versions."""
    from pgvector_rx_tpu_torch.graph import device_build as db

    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)
    with Phase("26 data, 1,000,000 x 1,024-d"):
        data, queries = make_dataset(N_HV, D_HV, N_HV_Q, seed=6,
                                     intrinsic=32)
        x = torch.from_numpy(data).to(dev)
        del data
        q = torch.from_numpy(queries).to(dev)
    with Phase(f"26 device build, {N_HV:,} x {D_HV}-d ip, f16 store"):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        bf.reset_launches()
        with SectionTimer(db.DeviceBuilder,
                          ("_beam_ground_candidates",)) as st:
            t0 = time.time()
            idx = HnswIndex.build(x, metric="ip", params=params,
                                  method="device", dtype=np.float16,
                                  host_graph=False, device=dev, seed=1)
            torch.cuda.synchronize()
            dt = time.time() - t0
        g = idx.device_graph()
        ground_s = st.seconds()["_beam_ground_candidates"]
        log(f"26 device build: {dt:.3f} s, {N_HV / dt:.1f} rows/s, peak "
            f"device memory {torch.cuda.max_memory_allocated(dev) / 2**30:.2f}"
            f" GiB; store {g.values.dtype}, {g.values.numel() * 2 / 2**30:.2f}"
            f" GiB; the beam ground {ground_s:.3f} s of device time in "
            f"{len(st.pairs['_beam_ground_candidates'])} batches (K8 "
            f"launches {bf.LAUNCHES['k8_beam_ground']})")
        if bf.LAUNCHES["k8_beam_ground"] <= 0:
            raise RuntimeError("kernel k8_beam_ground never ran in the "
                               "halfvec build")
        if g.values.dtype != torch.float16 or g.values_bf16 is not None:
            raise RuntimeError("the halfvec graph is not one f16 array")
        check_graph(g, M, N_HV)
    del x
    torch.cuda.empty_cache()
    live = g.traversable & (g.tid_count > 0)
    pen = torch.where(live, 0.0, bf._NEG_BIG).contiguous()
    ch = device_mod._EXACT_SWEEP_CHUNK
    with Phase("26 ground truth (K1 over the f16 store, in chunks)"):
        keys = []
        for s in range(0, g.values.shape[0], ch):
            xc = g.values[s : s + ch].float()
            part = [bf._surrogate_topk(xc, pen[s : s + ch],
                                       q[b : b + CHUNK], K)
                    for b in range(0, N_HV_Q, CHUNK)]
            sd = torch.cat([p[0] for p in part])
            si = torch.cat([p[1] for p in part]).long()
            keys.append(bf._order_keys(torch.where(si >= 0, sd, float("inf")),
                                       torch.where(si >= 0, si + s,
                                                   (1 << 31) - 1)))
            del xc
        gt_d, gt = bf._from_order_keys(torch.topk(
            torch.cat(keys, 1), K, dim=1, largest=False).values)
        gt = gt.cpu().numpy()
        stored = g.values[:N_HV].double()
        ref = -(q[:64].double() @ stored.T)
        ref_d = torch.topk(ref, K, dim=1, largest=False).values.cpu().numpy()
        got_d = np.sort(torch.gather(ref, 1, torch.from_numpy(gt[:64]).to(
            dev)).cpu().numpy(), axis=1)
        del ref, stored
        if (gt < 0).any() or not np.allclose(got_d, ref_d, rtol=1e-5,
                                             atol=1e-4):
            raise RuntimeError("halfvec ground truth disagrees with float64")
        log(f"gt {gt.shape}, float64 check over the stored f16 values on 64 "
            "queries ok")
    emit = g.emit_tid.cpu().numpy()

    def recall(ids):
        tids = np.where(ids >= 0, emit[np.maximum(ids, 0)], -1)
        return float(np.mean([len(set(tids[b]) & set(emit[gt[b]])) / K
                              for b in range(N_HV_Q)]))

    def engines(tag, graph_bytes, floors):
        bf.reset_launches()
        out = {}
        for engine, kname in (("exact", "k1_topk"), ("approx", "k2_binned"),
                              ("beam", "k4_beam")):
            with Phase(f"26 serve_topk {engine}, {tag}"):
                device_mod.serve_topk(idx, q, K, engine=engine, ef=EF)
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated(dev)
                torch.cuda.reset_peak_memory_stats(dev)
                t0 = time.time()
                d, ids = device_mod.serve_topk(idx, q, K, engine=engine,
                                               ef=EF)
                dt = time.time() - t0
                peak = torch.cuda.max_memory_allocated(dev) - base
                rec = recall(ids)
                out[engine] = (rec, N_HV_Q / dt, peak)
                log(f"26 {tag} {engine}: recall@10={rec:.4f} "
                    f"qps={N_HV_Q / dt:.1f} ({dt:.4f} s for {N_HV_Q} "
                    f"queries); peak device memory above the graph "
                    f"({graph_bytes / 2**30:.2f} GiB resident) "
                    f"{peak / 2**20:.1f} MiB")
                if d.shape != (N_HV_Q, K) or not np.isfinite(d).all():
                    raise RuntimeError(f"{engine}: non-finite output")
                if rec < floors[engine]:
                    raise RuntimeError(f"halfvec {tag} {engine}: recall "
                                       f"{rec} < {floors[engine]}")
                if engine in HV_PEAK and peak > HV_PEAK[engine]:
                    raise RuntimeError(
                        f"the {engine} call took {peak / 2**20:.1f} MiB above"
                        f" the graph (bound {HV_PEAK[engine] >> 20} MiB): a "
                        "copy of the rows?")
        out["launches"] = dict(bf.LAUNCHES)
        log(f"26 {tag} launches: {out['launches']}")
        for name in ("k1_topk", "k2_binned", "k4_beam", "k7_coarse"):
            if bf.LAUNCHES[name] <= 0:
                raise RuntimeError(f"kernel {name} never ran on the "
                                   f"halfvec path ({tag})")
        return out

    hv_launches = engines("f16 store", g.values.numel() * 2,
                          HV_FLOORS)["launches"]
    # the same rows served from a bf16 store, as PGV_SERVE_DTYPE=bf16 stages
    # them
    os.environ["PGV_SERVE_DTYPE"] = "bf16"
    try:
        fields = {f.name: getattr(g, f.name) for f in dataclasses.fields(g)}
        fields.update(device_mod._serve_value_arrays(
            g.values.float(), device_mod._serve_dtype_for(idx)))
        g16 = g
        idx._device = g = device_mod.DeviceGraph(**fields)
        torch.cuda.empty_cache()
        if g.values.dtype != torch.bfloat16:
            raise RuntimeError("PGV_SERVE_DTYPE=bf16 staged no bf16 store")
        engines("bf16 store", g.values.numel() * 2, HV_BF16_FLOORS)
    finally:
        del os.environ["PGV_SERVE_DTYPE"]

    with Phase("26 K1 and K2 at d = 1,024 over the stored rows"):
        rows = compact_kernels(bf, g16.values[:ch], g.values[:ch],
                               pen[:ch].contiguous(), q[:CHUNK].contiguous(),
                               hv_launches)
        for r in rows:
            kernels[r["name"]] = r
    log(json.dumps({"d1024": rows}))
    del idx, g, g16, q
    torch.cuda.empty_cache()


def in_turns(fns: dict, turns: int = 2) -> dict:
    """Mean device ms of each function, timed in turns (a b b a ...)."""
    names = list(fns)
    times = {n: [] for n in names}
    for t in range(turns):
        for n in (names if t % 2 == 0 else names[::-1]):
            times[n].append(cuda_ms(fns[n]))
    return {n: sum(v) / len(v) for n, v in times.items()}


def compact_kernels(bf, x16, xbf, a, q1, launches):
    """K1's 2-byte mode and K2's streamed form on the halfvec chunk (the
    stored f16 rows ``x16`` and their bf16 store ``xbf``, 262,144 x 1,024,
    1,024 queries): each held to its plain version and to the parent's
    route (the cast of the chunk, then the kernel over it: K1 over f32
    rows, K2 over bf16 rows), which must also reject a control (K1 over
    the f16 rows rounded to bf16); each timed in turns beside that route,
    its time including the cast, against its bound (K1: two tf32 products,
    K2: one bf16 product), its plain version and its library yardstick
    (phase 8's, over the cast chunk, the cast included). Returns the two
    kernel rows."""
    n_rows, b1 = x16.shape[0], q1.shape[0]
    q2max = float((q1 * q1).sum(1).max())
    out_bytes = b1 * K * 8
    qb = q1.to(torch.bfloat16)
    res = {}
    for store, xs in (("f16", x16), ("bf16", xbf)):
        k_d, k_i = bf._surrogate_topk_cuda(xs, a, q1, K)
        p_d, p_i = bf._surrogate_topk_plain(xs, a, q1, K)
        c_d, c_i = bf._surrogate_topk_cuda(xs.float(), a, q1, K)
        p_d, p_i = p_d.cpu().numpy(), p_i.cpu().numpy()
        err, ok = k1_agreement(k_d, k_i, p_d, p_i, q2max)
        _, ok_route = k1_agreement(k_d, k_i, c_d.cpu().numpy(),
                                   c_i.cpu().numpy(), q2max)
        same = float((k_i == c_i).float().mean())
        log(f"K1 2-byte mode, {store} store: max abs err {err} against "
            f"plain; ids equal to the cast route's by rank {same:.4f}")
        if not ok or not ok_route:
            raise RuntimeError(f"K1 over the {store} store disagrees with "
                               f"its plain version or the cast route")
        if store == "f16":
            r_d, r_i = bf._surrogate_topk_cuda(xs.to(torch.bfloat16), a, q1,
                                               K)
            ctl, ctl_ok = k1_agreement(r_d, r_i, p_d, p_i, q2max)
            log(f"control, K1 over the f16 rows rounded to bf16: max abs "
                f"err {ctl}")
            if ctl_ok:
                raise RuntimeError("the K1 check passes bf16-rounded rows: "
                                   "too loose to tell the rows apart")
        t = in_turns({
            "new": lambda: bf._surrogate_topk_cuda(xs, a, q1, K),
            "cast route": lambda: bf._surrogate_topk_cuda(xs.float(), a, q1,
                                                          K)})
        res[f"k1 {store}"] = (err, same, t)
    for store, xs in (("f16", x16), ("bf16", xbf)):
        k_d, k_i = bf._binned_cuda(xs, a, qb, K, 1024)
        p_d, p_i = bf._binned_plain(xs, a, q1, K, 1024)
        c_d, c_i = bf._binned_cuda(xs.to(torch.bfloat16), a, qb, K, 1024)
        p_d, p_i = p_d.cpu().numpy(), p_i.cpu().numpy()
        err, ok = k2_agreement(k_d, k_i, p_d, p_i, q2max)
        _, ok_route = k2_agreement(k_d, k_i, c_d.cpu().numpy(),
                                   c_i.cpu().numpy(), q2max)
        same = float((k_i == c_i).float().mean())
        log(f"K2 streamed form, {store} store: max abs err {err} against "
            f"plain; ids equal to the cast route's by rank {same:.4f}")
        if not ok or not ok_route:
            raise RuntimeError(f"K2 over the {store} store disagrees with "
                               f"its plain version or the cast route")
        t = in_turns({
            "new": lambda: bf._binned_cuda(xs, a, qb, K, 1024),
            "cast route": lambda: bf._binned_cuda(xs.to(torch.bfloat16), a,
                                                  qb, K, 1024)})
        res[f"k2 {store}"] = (err, same, t)
    in_bytes = n_rows * D_HV * 2 + n_rows * 4
    rows = []
    for name, kname, kind, ops, peak, q_bytes, lib, plain in (
            ("k1_topk_2byte", "k1_topk", "k1", 2 * 2.0 * b1 * n_rows * D_HV,
             "tf32", b1 * D_HV * 4,
             lambda: k1_library(x16.float(), a, q1, K),
             lambda: bf._surrogate_topk_plain(x16, a, q1, K)),
            ("k2_binned_f16", "k2_binned", "k2", 2.0 * b1 * n_rows * D_HV,
             "bf16", b1 * D_HV * 2,
             lambda: k2_library(x16.to(torch.bfloat16), a, qb, K, 1024),
             lambda: bf._binned_plain(x16, a, q1, K, 1024))):
        err, same, t = res[f"{kind} f16"]
        _, same_b, t_b = res[f"{kind} bf16"]
        row = kernel_row(name, err, t["new"], cuda_ms(plain, 3),
                         bound(ops, peak, in_bytes + q_bytes + out_bytes))
        row.update(
            route="cuda", source=CSRC + ("k1_topk.cu" if kind == "k1"
                                         else "k2_binned.cu"),
            replaces=f"{PALLAS}:{34 if kind == 'k1' else 185} (over a "
                     "halfvec chunk, f16 rows read as stored)",
            launches=launches[kname], rows=n_rows,
            cast_route_ms=t["cast route"], ids_equal_cast_route=same,
            bf16_store_ms=t_b["new"], bf16_store_cast_route_ms=t_b[
                "cast route"], bf16_store_ids_equal_cast_route=same_b,
            library_ms=cuda_ms(lib, 3),
            library_of="phase 8's yardstick over the cast chunk, the cast "
                       "included")
        log(f"{name}: {row['ms']:.4f} ms (the cast route "
            f"{row['cast_route_ms']:.4f}); bf16 store {row['bf16_store_ms']:.4f}"
            f" (cast route {row['bf16_store_cast_route_ms']:.4f}); library "
            f"{row['library_ms']:.4f}; {row['launches']} launches on the "
            "halfvec path's f16 store")
        rows.append(row)
    return rows


def graph_bytes(g) -> int:
    """Bytes of a DeviceGraph's tensors on its device."""
    return sum(t.numel() * t.element_size() for t in vars(g).values()
               if isinstance(t, torch.Tensor))


def sharded_build(sh, x, n_shards, params, devices, seed):
    """``ShardedHnswIndex.build`` from a tensor (the device build,
    serving-only), its stderr captured -> (index, that stderr)."""
    err = io.StringIO()
    with contextlib.redirect_stderr(err):
        idx = sh.ShardedHnswIndex.build(
            x, n_shards=n_shards, metric="l2", params=params,
            method="device", host_graph=False, devices=devices, seed=seed)
    torch.cuda.synchronize()
    return idx, err.getvalue()


def sharded_plain_merge(sh, beam, idx, q, max_steps):
    """The sharded beam's merge over each shard's plain descent and walk
    (``ops/beam.descent_plain`` + ``_walk_plain``, at most ``max_steps``
    steps) -> (tids [B, K], euclidean distances [B, K]) on the host."""
    parts = []
    for shard in idx.shards:
        g = shard.device_graph()
        land, land_d = beam.descent_plain(
            g.values, g.traversable, g.upper_slot, g.upper_neighbors, g.m,
            g.metric, q, g.entry, g.entry_level)
        raw = beam._walk_plain(g.values, g.neighbors0, g.traversable, None,
                               g.metric, q, land[:, None].to(torch.int32),
                               land_d[:, None], width=EF, spill=0,
                               max_steps=max_steps, scan=False)
        pd, pids, _ = beam._serve_finish(*raw)
        tids = torch.where(pids >= 0, g.emit_tid[pids.clamp(min=0)].long(),
                           -1)
        parts.append((torch.where(tids >= 0, pd, float("inf")), tids))
    d, t = sh._merge(parts, K, idx.devices[0])
    return t.cpu().numpy(), torch.sqrt(d.clamp(min=0)).double().cpu().numpy()


def path_launches(bf, fn, names=("k1_topk", "k4_beam")):
    """Run ``fn`` with every launch count set to 0 just before it ->
    (its result, the counts of ``names`` read just after it)."""
    bf.reset_launches()
    out = fn()
    return out, {k: bf.LAUNCHES[k] for k in names}


def need_launches(tag, counts, name):
    """Fail unless ``name`` was launched in the run counted as ``counts``."""
    log(f"28 {tag} launches: {counts}")
    if counts[name] <= 0:
        raise RuntimeError(f"kernel {name} never ran in the sharded {tag}")


def sharded_path(make_dataset, SearchParams, params, device_mod, bf, beam,
                 dev):
    """Phase 28: BASELINE config 5's shape, sharded, on the card (see the
    module docstring), with the K1 and K4 launch counts of each sharded
    call (its references run outside the counted windows)."""
    from pgvector_rx_tpu_torch.graph import device_build as db
    from pgvector_rx_tpu_torch.parallel import sharded as sh

    n_all = S28 * N28
    devices = [dev] * S28
    sp = SearchParams(ef_search=EF)
    log(f"cut: BASELINE config 5 (configs/sharded_100m.py, 100,000,000 x "
        f"128-d l2 in 8 round-robin shards on a TPU v5e-8) runs as {S28} "
        f"shards x {N28:,} rows on one card (the four-card layout; not the "
        f"main path's 1M a shard, for the smoke's time), {N_INSERT:,} more "
        f"rows inserted; its "
        f"checkpoint round trip at {S28} x {N28_CKPT:,} rows")
    with Phase("28 data"):
        data, queries = make_dataset(n_all + N_INSERT, DIM, N_QUERIES,
                                     seed=SEED28)
        x = torch.from_numpy(data).to(dev)
        q_dev = torch.from_numpy(queries).to(dev)
    with Phase("28 sharded device build"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        idx, err = sharded_build(sh, x[:n_all], S28, params, devices, 1)
        dt = time.time() - t0
        lines = [ln for ln in err.splitlines()
                 if ln.startswith("[sharded.build]")]
        for ln in lines:
            log(ln)
        secs = [float(re.search(r" in ([0-9.]+)s", ln).group(1))
                for ln in lines]
        peak = torch.cuda.max_memory_allocated(dev)
        log(f"28 sharded build: {dt:.3f} s in all, {n_all / dt:.1f} rows/s, "
            f"per shard {secs} s; peak device memory {peak / 2**30:.2f} GiB, "
            f"{(peak - base) / 2**30:.2f} above the corpus")
        if len(secs) != S28:
            raise RuntimeError(f"{len(secs)} shard build lines, want {S28}")
        for s, shard in enumerate(idx.shards):
            g = shard.device_graph()
            if g.device != devices[s] or idx.devices[s] != devices[s]:
                raise RuntimeError(f"shard {s} is on {g.device}")
            check_graph(g, M, N28)
            log(f"shard {s}: {graph_bytes(g) / 2**30:.3f} GiB of graph on "
                f"{g.device}")
    with Phase("28 ground truth (K1 l2_topk over every row)"):
        gt = ground_truth(bf, data[:n_all], queries, q_dev)  # row = tid

    def recall(tids):
        return float(np.mean([len(set(tids[b]) & set(gt[b])) / K
                              for b in range(gt.shape[0])]))

    def timed(engine, q=q_dev, **kw):
        idx.search(q[:CHUNK], K, sp, engine=engine, **kw)  # warm
        torch.cuda.synchronize()
        t0 = time.time()
        d, t = idx.search(q, K, sp, engine=engine, **kw)
        return d, t, time.time() - t0

    launches = {}  # the sharded call -> its K1 / K4 launches

    def exact_sq(tids, q):
        """float32 squared l2 of rows ``tids`` (= corpus rows) to ``q``."""
        rows = x[torch.from_numpy(tids).to(dev).clamp(min=0)]
        return ((rows - q[:, None, :]) ** 2).sum(-1).double().cpu().numpy()

    out = {}
    for engine in ("exact", "beam"):
        with Phase(f"28 sharded {engine}, {N_QUERIES:,} queries"):
            (d, t, dt), launches[engine] = path_launches(
                bf, lambda: timed(engine))
            need_launches(engine, launches[engine],
                          "k1_topk" if engine == "exact" else "k4_beam")
            rec = recall(t)
            parts = [sh._shard_topk(s.device_graph(), q_dev, K, EF, engine,
                                    None) for s in idx.shards]
            merge_ms = cuda_ms(lambda: sh._merge(parts, K, dev))
            out[engine] = (d, t, dt)
            log(f"28 {engine}: recall@10={rec:.4f} qps="
                f"{N_QUERIES / dt:.1f} ({dt:.4f} s); the merge "
                f"{merge_ms:.4f} ms on the card, "
                f"{merge_ms / (dt * 1e3):.4f} of the search's wall time")
            if d.shape != (N_QUERIES, K) or not np.isfinite(d).all():
                raise RuntimeError(f"28 {engine}: misshapen or non-finite")
            if engine == "exact":
                gd = exact_sq(gt, q_dev)
                tol = 1e-4 * np.abs(gd).max(axis=1) + 1e-4
                bad = tie_aware_mismatch(t, d ** 2, gt, gd, tol)
                log(f"28 exact against K1 over the union: {bad} rows differ "
                    "but for ties")
                if bad:
                    raise RuntimeError("the sharded exact engine disagrees "
                                       "with K1 over every row")
            elif rec < FLOORS["beam"]:
                raise RuntimeError(f"28 beam recall {rec} < {FLOORS['beam']}")
    with Phase(f"28 sharded beam vs the plain descent and walk, "
               f"{WALK28_Q} queries"):
        qw = q_dev[:WALK28_Q]
        kd, kt = idx.search(qw, K, sp, engine="beam")
        pt, pd = sharded_plain_merge(sh, beam, idx, qw, 4 * EF + 32)
        ct, cd = sharded_plain_merge(sh, beam, idx, qw, EF // 4)
        ok, err_w = walk_agreement(kt, kd, pt, pd)
        okc, _ = walk_agreement(ct, cd, pt, pd)
        log(f"28 sharded beam vs the plain merge: {ok.mean():.4f} of queries "
            f"equal but for ties (max abs err {err_w}); control (plain walk "
            f"cut to {EF // 4} steps): {okc.mean():.4f}")
        if ok.mean() < 0.99:
            raise RuntimeError("the sharded beam disagrees with the plain "
                               "merge")
        if okc.mean() >= 0.99:
            raise RuntimeError("the sharded walk check passes a walk cut to "
                               "ef / 4 steps")
    with Phase(f"28 filtered exact search (tid % {FILTER28} == 0)"):
        keep = np.nonzero(np.arange(n_all) % FILTER28 == 0)[0]
        qf = q_dev[:CHUNK]
        (fd, ft), launches["filtered"] = path_launches(
            bf, lambda: idx.search(qf, K, sp, engine="exact",
                                   filter_mask=np.arange(n_all) % FILTER28
                                   == 0))
        need_launches("filtered exact search", launches["filtered"],
                      "k1_topk")
        _, gi = bf.l2_topk(x[torch.from_numpy(keep).to(dev)], qf, K)
        gtf = keep[gi.cpu().numpy()]
        gfd = exact_sq(gtf, qf)
        tol = 1e-4 * np.abs(gfd).max(axis=1) + 1e-4
        bad = tie_aware_mismatch(ft, fd ** 2, gtf, gfd, tol)
        log(f"28 filtered exact: {bad} of {CHUNK} rows differ from K1 over "
            f"the {len(keep):,} kept rows but for ties")
        if bad or (ft % FILTER28 != 0).any():
            raise RuntimeError("the filtered sharded search disagrees")
    with Phase(f"28 insert_bulk of {N_INSERT:,} rows"):
        torch.cuda.synchronize()
        t0 = time.time()
        added = idx.insert_bulk(x[n_all:], tids=range(n_all,
                                                      n_all + N_INSERT))
        torch.cuda.synchronize()
        dt = time.time() - t0
        sizes = [s.num_tuples for s in idx.shards]
        _, st = idx.search(x[n_all : n_all + CHUNK], K, sp, engine="beam")
        hit = float(np.mean([(n_all + r) in set(st[r].tolist())
                             for r in range(CHUNK)]))
        log(f"28 insert_bulk: {added} rows in {dt:.3f} s "
            f"({N_INSERT / dt:.1f} rows/s), shard sizes {sizes}; inserted "
            f"rows among their own beam top-10: {hit:.4f}")
        if added != N_INSERT or max(sizes) - min(sizes) > 1:
            raise RuntimeError("insert_bulk did not water-fill the shards")
        if hit < SELF_FLOOR:
            raise RuntimeError(f"inserted-row self recall {hit}")
    with Phase(f"28 ShardedScan, {SCAN28_Q} queries, relaxed order, "
               f"max_scan_tuples={SCAN28_MAX}"):
        ssp = SearchParams(ef_search=EF, iterative_scan="relaxed_order",
                           max_scan_tuples=SCAN28_MAX)
        rd, ri = bf.l2_topk(x, q_dev[:SCAN28_Q], SCAN_LIMIT)  # grown corpus
        rd, ri = rd.double().cpu().numpy(), ri.cpu().numpy()
        ms, streams = [], []

        def scans():
            for b in range(SCAN28_Q):
                t0 = time.time()
                scan = idx.scan(queries[b], ssp)
                items = scan.take(SCAN_LIMIT)
                ms.append((time.time() - t0) * 1e3)
                streams.append(items + scan.take(10 * SCAN28_MAX))

        _, launches["scan"] = path_launches(
            bf, scans, ("k1_select", "k1_topk", "k4_beam"))
        need_launches("ShardedScan", launches["scan"], "k1_select")
        sx = idx.shards[0].device_graph().values
        sx = sx[: idx.shards[0].device_graph().cap].contiguous()
        select_vs_plain(bf, sx, (sx * sx).sum(1).contiguous(),
                        q_dev[:3].contiguous(), 500, "28")
        del sx
        bad = 0
        for b, items in enumerate(streams):
            dists = [dd for _, dd in items]
            if len(items) != SCAN28_MAX or dists != sorted(dists):
                raise RuntimeError(f"scan {b}: {len(items)} tuples, sorted "
                                   f"{dists == sorted(dists)}")
            head_t = np.array([[t for t, _ in items[:SCAN_LIMIT]]])
            head_d = np.array([dists[:SCAN_LIMIT]]) ** 2
            bad += tie_aware_mismatch(head_t, head_d, ri[b : b + 1],
                                      rd[b : b + 1],
                                      [1e-4 * rd[b].max() + 1e-4])
        log(f"28 ShardedScan: {SCAN28_MAX} tuples in distance order for "
            f"every query; first {SCAN_LIMIT} differ from K1's exact top-"
            f"{SCAN_LIMIT} but for ties in {bad} of {SCAN28_Q}; ms to the "
            f"{SCAN_LIMIT}th row p50 {np.percentile(ms, 50):.3f} p99 "
            f"{np.percentile(ms, 99):.3f}")
        if bad:
            raise RuntimeError("the sharded scan's head is not the exact "
                               "top-20")
    log(f"sharded path launches: {launches}")
    with Phase(f"28 checkpoint round trip, {S28} x {N28_CKPT:,} rows, with "
               "PGV_BUILD_TIMING and GROUP_STATS"):
        xs = x[: S28 * N28_CKPT]
        plain, _ = sharded_build(sh, xs, S28, params, devices, 2)
        stats = []
        db.GROUP_STATS = stats
        os.environ["PGV_BUILD_TIMING"] = "1"
        try:
            small, err = sharded_build(sh, xs, S28, params, devices, 2)
        finally:
            db.GROUP_STATS = None
            del os.environ["PGV_BUILD_TIMING"]
        n_init = len(re.findall(r"^\[build\]   init\.", err, re.M))
        n_phase = len(re.findall(r"^\[build\] phase ", err, re.M))
        n_batch = len(re.findall(r"^\[build\] batch@", err, re.M))
        rows = sum(r for _, r, _ in stats)
        want = S28 * (N28_CKPT - 1)  # each shard's first row seeds it
        same = all(torch.equal(getattr(a.device_graph(), f),
                               getattr(b.device_graph(), f))
                   for a, b in zip(plain.shards, small.shards)
                   for f in GRAPH_FIELDS)
        log(f"28 PGV_BUILD_TIMING: {n_init} init, {n_phase} phase and "
            f"{n_batch} batch lines; GROUP_STATS: {len(stats)} tuples, "
            f"{rows} rows (want {want}), {sum(s for _, _, s in stats):.3f} s, "
            f"widths {sorted({w for w, _, _ in stats})}; the graphs "
            f"{'equal' if same else 'DIFFER from'} the build without them")
        if (n_init != 4 * S28 or n_phase != 7 * S28 or n_batch != len(stats)
                or rows != want or not same):
            raise RuntimeError("the build's instrumentation is wrong or "
                               "changed the graph")
        qc = q_dev[:CHUNK]
        before = {e: small.search(qc, K, sp, engine=e)[1]
                  for e in ("exact", "beam")}
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.time()
            small.save(Path(tmp) / "ck")
            t_save = time.time() - t0
            t0 = time.time()
            back = sh.ShardedHnswIndex.load(Path(tmp) / "ck", devices=devices)
            t_load = time.time() - t0
        same_ids = {e: bool((back.search(qc, K, sp, engine=e)[1]
                             == before[e]).all()) for e in before}
        log(f"28 checkpoint: save {t_save:.3f} s, load {t_load:.3f} s; ids "
            f"unchanged {same_ids}")
        if not all(same_ids.values()):
            raise RuntimeError("the sharded checkpoint changed the ids")
        del plain, small, back
    with Phase("28 PGV_SCAN_STATS on one shard's search"):
        shard = idx.shards[0]
        g = shard.device_graph()
        qs = q_dev[:CHUNK]
        os.environ["PGV_SCAN_STATS"] = "1"
        try:
            shard.search(qs, K, sp, method="device")
        finally:
            del os.environ["PGV_SCAN_STATS"]
        st = shard.last_scan_stats
        upper = device_mod._coarse_upper(g)
        steps = device_mod._search_batch_coarse(
            g, qs, upper[0], upper[1], EF, 4 * EF + 32)[2]
        total = int(steps.sum())
        log(f"28 scan stats: {st}; K4's steps sum {total}")
        if st is None or st.beam_steps != total or st.distances_computed != (
                total * g.neighbors0.shape[1]):
            raise RuntimeError("PGV_SCAN_STATS disagrees with K4's steps")
    with Phase("28 dryrun_multichip(4)"):
        sh.dryrun_multichip(4)
    del idx, x, q_dev
    torch.cuda.empty_cache()


def main() -> int:
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA GPU; none is visible")
    from pgvector_rx_tpu_torch.data import make_dataset
    from pgvector_rx_tpu_torch import HnswIndex, IndexParams, SearchParams
    from pgvector_rx_tpu_torch.graph import device as device_mod
    from pgvector_rx_tpu_torch.index.scan import DeviceBeamScan, DeviceScan
    from pgvector_rx_tpu_torch.ops import _build, beam
    from pgvector_rx_tpu_torch.ops import bruteforce as bf

    dev = torch.device(DEVICE)
    kernels = {}
    params = IndexParams(m=M, ef_construction=EF_CONSTRUCTION)

    with Phase("1 card + kernel build"):
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip().splitlines()[0]
        log(smi)
        log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
            f"allow_tf32 matmul={torch.backends.cuda.matmul.allow_tf32} "
            f"cudnn={torch.backends.cudnn.allow_tf32}")
        if (torch.backends.cuda.matmul.allow_tf32
                or torch.backends.cudnn.allow_tf32):
            raise RuntimeError("TF32 must stay off in the port")
        log(f"kernel library: {_build.build()}")
        _build.lib()
    # the sparse path's data and native build (phase 24) run on the CPU
    # beside the card phases
    sparse_child, sparse_tmp = start_sparse_build()

    with Phase("2 data"):
        data, queries = make_dataset(N_ROWS + N_INSERT, DIM, N_QUERIES,
                                     seed=0)
        x_dev = torch.from_numpy(data).to(dev)
        q_dev = torch.from_numpy(queries).to(dev)
        log(f"corpus {data.shape} on {x_dev.device}, queries {queries.shape}")

    # ---- device-build path ------------------------------------------------
    bf.reset_launches()
    with Phase("3 device build"):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        t0 = time.time()
        index = HnswIndex.build(x_dev[:N_ROWS], metric="l2", params=params,
                                method="device", host_graph=False,
                                device=dev, seed=1)
        torch.cuda.synchronize()
        dt = time.time() - t0
        main_build = dict(
            s=dt, peak=torch.cuda.max_memory_allocated(dev) / 2**30,
            above=(torch.cuda.max_memory_allocated(dev) - base) / 2**30)
        log(f"device build: {dt:.3f} s, {N_ROWS / dt:.1f} rows/s "
            f"(peak device memory {main_build['peak']:.2f} GiB)")
        g = index.device_graph()
        if g.device.type != dev.type:
            raise RuntimeError("the graph is not on the card")
        check_graph(g, M, N_ROWS)
    live = g.traversable & (g.tid_count > 0)
    a = (g.x2 + torch.where(live, 0.0, bf._NEG_BIG)).contiguous()
    vb = g.values_bf16

    with Phase("4 ground truth (K1 l2_topk)"):
        gt = ground_truth(bf, data[:N_ROWS], queries, q_dev)
    emit_tid = g.emit_tid.cpu().numpy()
    recall = recall_of(emit_tid, gt)
    results = serve_engines(index, q_dev, recall, bf, device_mod, "5")
    main_build["recall"] = recall(results["beam"][1])

    with Phase("6 tile-min probe A/B"):
        def sweep(fn):
            out = [fn(q_dev[s : s + CHUNK]) for s in range(0, N_QUERIES,
                                                            CHUNK)]
            return torch.cat(out).cpu().numpy()

        arms = {
            "k3 tn=1024 + rescore": lambda qc: device_mod._rescore_true(
                g, qc, *bf.tilemin_sweep_topk(vb, a, qc, K, "l2",
                                              tn=1024))[1],
            "k2 tn=1024": lambda qc: bf.binned_sweep_topk(
                vb, a, qc, K, "l2", tn=1024)[1],
            "approx engine": lambda qc: torch.from_numpy(
                device_mod.serve_topk(index, qc, K, engine="approx")[1]),
        }
        ab = {}
        for label, fn in arms.items():
            sweep(fn)  # warm
            torch.cuda.synchronize()
            t0 = time.time()
            ids = sweep(fn)
            dt = time.time() - t0
            ab[label] = (recall(ids), N_QUERIES / dt)
            log(f"A/B {label}: recall@10={ab[label][0]:.4f} "
                f"qps={ab[label][1]:.1f}")
        if ab["k3 tn=1024 + rescore"][0] < K3_FLOOR:
            raise RuntimeError(f"K3 arm recall below {K3_FLOOR}")

    search_vs_serve(index, queries, results, emit_tid, SearchParams, "7")
    main_launches = dict(bf.LAUNCHES)
    log(f"device-build path launches: {main_launches}")
    for name in ("k1_topk", "k2_binned", "k3_tilemin", "k3_x2max",
                 "k4_beam", "k7_coarse"):
        if main_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the main path")

    with Phase("8 kernels vs plain"):
        q1 = q_dev[:CHUNK].contiguous()
        q2max = float((q1 * q1).sum(1).max())
        q2 = (q1 * q1).sum(1, keepdim=True)

        x32 = g.values
        k1_d, k1_i = bf._surrogate_topk_cuda(x32, a, q1, K)
        p1_d, p1_i = bf._surrogate_topk_plain(x32, a, q1, K)
        c1_d, c1_i = bf._surrogate_topk_plain(tf32_truncated(x32), a,
                                              tf32_truncated(q1), K)
        torch.cuda.synchronize()
        p1_d, p1_i = p1_d.cpu().numpy(), p1_i.cpu().numpy()
        err1, ok1 = k1_agreement(k1_d, k1_i, p1_d, p1_i, q2max)
        ctl1, ctl1_ok = k1_agreement(c1_d, c1_i, p1_d, p1_i, q2max)
        log(f"K1 max abs err {err1} ({err1 / q2max:.3e} of max q2); control "
            f"with TF32-truncated operands: {ctl1} ({ctl1 / q2max:.3e})")
        if not ok1:
            raise RuntimeError(f"K1 disagrees with its plain version "
                               f"(max abs err {err1})")
        if ctl1_ok:
            raise RuntimeError("the K1 check passes TF32 operands: too loose "
                               "for a 3xTF32 kernel")
        del c1_d, c1_i
        n_rows, b1 = x32.shape[0], q1.shape[0]
        out_bytes = b1 * K * 8
        kernels["k1_topk"] = dict(
            name="k1_topk", route="cuda", source=CSRC + "k1_topk.cu",
            replaces=f"{PALLAS}:34", max_abs_err=err1,
            ms=cuda_ms(lambda: bf._surrogate_topk_cuda(x32, a, q1, K)),
            plain_ms=cuda_ms(lambda: bf._surrogate_topk_plain(x32, a, q1, K)),
            **bound(3 * 2.0 * b1 * n_rows * DIM, "tf32",
                    (n_rows * DIM + n_rows + b1 * DIM) * 4 + out_bytes),
            library_ms=cuda_ms(lambda: k1_library(x32, a, q1, K), 3),
            library_of="per 65,536-row block: f32 torch.mm (TF32 off), "
                       "a - 2 q.x, torch.topk; merged",
            matmul_ms=cuda_ms(lambda: q1 @ x32.T),
            matmul_of="q @ x.T alone in f32 (the product, not the function)",
        )
        # K1's select form on the same rows (the pad row excluded by `a`)
        err_s = max(select_vs_plain(bf, x32, a, q1[:b].contiguous(), k, "8")
                    for b, k in ((1, K), (3, 100), (64, 61)))
        log(f"K1's select form equals its plain version but for ties at "
            f"B = 1, 3, 64 (max abs err {err_s})")

        qb = q1.to(torch.bfloat16)
        # order distances: squared l2 restored from the surrogate scores
        k2_d, k2_i = bf._binned_cuda(vb, a, qb, K, 1024)
        p2_d, p2_i = bf._binned_plain(vb, a, q1, K, 1024)
        c2_d, c2_i = binned_bf16_sums(vb, a, qb, K, 1024)
        torch.cuda.synchronize()
        p2_d, p2_i = (p2_d + q2).cpu().numpy(), p2_i.cpu().numpy()
        err2, ok2 = k2_agreement(k2_d + q2, k2_i, p2_d, p2_i, q2max)
        ctl2, ctl_ok = k2_agreement(c2_d + q2, c2_i, p2_d, p2_i, q2max)
        log(f"K2 max abs err {err2} ({err2 / q2max:.3e} of max q2 "
            f"{q2max}); control with bf16-rounded sums: {ctl2} "
            f"({ctl2 / q2max:.3e} of max q2)")
        if not ok2:
            raise RuntimeError(f"K2 disagrees with its plain version "
                               f"(max abs err {err2})")
        if ctl_ok:
            raise RuntimeError("the K2 check passes bf16-rounded sums: "
                               "too loose to catch a wrong kernel")
        bf16_bytes = (n_rows * DIM + b1 * DIM) * 2 + n_rows * 4
        kernels["k2_binned"] = dict(
            name="k2_binned", route="cuda", source=CSRC + "k2_binned.cu",
            replaces=f"{PALLAS}:185", max_abs_err=err2,
            ms=cuda_ms(lambda: bf._binned_cuda(vb, a, qb, K, 1024)),
            plain_ms=cuda_ms(lambda: bf._binned_plain(vb, a, q1, K, 1024)),
            **bound(2.0 * b1 * n_rows * DIM, "bf16", bf16_bytes + out_bytes),
            library_ms=cuda_ms(lambda: k2_library(vb, a, qb, K, 1024), 3),
            library_of="per 65,536-row block: bf16 torch.mm, a - 2 q.x in "
                       "f32, torch.min per bin (row mod 1,024); torch.topk "
                       "over the bins",
            matmul_ms=cuda_ms(lambda: qb @ vb.T),
            matmul_of="q @ x.T alone in bf16 (the product, not the function)",
        )

        k3_d, k3_i = bf._tilemin_cuda(vb, a, q1, K, 1024)
        p3_d, p3_i = bf._tilemin_plain(vb, a, q1, K, 1024)
        c3_d, c3_i = tilemin_no_clear(bf, vb, a, q1, K, 1024)
        torch.cuda.synchronize()
        p3_d, p3_i = (p3_d + q2).cpu().numpy(), p3_i.cpu().numpy()
        err3, ok3 = k3_agreement(bf, k3_d + q2, k3_i, p3_d, p3_i, vb, a, q1,
                                 q2, q2max)
        ctl3, ctl3_ok = k3_agreement(bf, c3_d + q2, c3_i, p3_d, p3_i, vb, a,
                                     q1, q2, q2max)
        same3 = float((k3_i.cpu().numpy() == p3_i).mean())
        log(f"K3 max abs err {err3} ({same3:.4f} of ids equal by rank); "
            f"control without the low-bit clear: max abs err {ctl3}, "
            f"{float((c3_i.cpu().numpy() == p3_i).mean()):.4f} of ids equal")
        if not ok3:
            raise RuntimeError(f"K3 disagrees with its plain version "
                               f"(max abs err {err3})")
        if ctl3_ok:
            raise RuntimeError("the K3 check passes uncleared packing: too "
                               "loose to catch a wrong kernel")
        q2x, av3, _ = bf._tilemin_prepare(vb, a, q1)
        kernels["k3_tilemin"] = dict(
            name="k3_tilemin", route="cuda", source=CSRC + "k3_tilemin.cu",
            replaces=f"{PALLAS}:302", max_abs_err=err3,
            ms=cuda_ms(lambda: bf._tilemin_cuda(vb, a, q1, K, 1024)),
            kernel_ms=cuda_ms(
                lambda: bf._tilemin_packed_cuda(vb, av3, q2x, 1024)),
            plain_ms=cuda_ms(lambda: bf._tilemin_plain(vb, a, q1, K, 1024)),
            **bound(2.0 * b1 * n_rows * DIM, "bf16",
                    bf16_bytes + b1 * -(-n_rows // 1024) * 4),
            library_ms=cuda_ms(lambda: k3_library(vb, a, qb, 1024), 3),
            library_of="the sweep alone (compare kernel_ms): per 65,536-row "
                       "block, bf16 torch.mm, a - 2 q.x in f32, torch.min "
                       "per 1,024-row tile",
            matmul_ms=kernels["k2_binned"]["matmul_ms"],
            matmul_of="q @ x.T alone in bf16 (the product, not the function)",
        )

        # K3's shift: the largest f32 sum of squares of the bf16 rows. Two
        # sums of DIM positive terms in any orders differ by at most
        # 2 DIM 2^-24 of the sum.
        x2k = float(bf._row_sq_max_cuda(vb))
        x2p = float(bf._row_sq_max_plain(vb))
        err4 = abs(x2k - x2p)
        log(f"K3 shift reduction: {x2k} vs plain {x2p}, abs err {err4} "
            f"(tolerance {2 * DIM * 2.0 ** -24 * x2p})")
        if err4 > 2 * DIM * 2.0 ** -24 * x2p:
            raise RuntimeError("the shift reduction disagrees with its plain "
                               f"version (abs err {err4})")
        kernels["k3_x2max"] = dict(
            name="k3_x2max", route="cuda", source=CSRC + "k3_tilemin.cu",
            replaces=f"{PALLAS}:372 (the XLA reduction beside the kernel)",
            max_abs_err=err4,
            ms=cuda_ms(lambda: bf._row_sq_max_cuda(vb)),
            plain_ms=cuda_ms(lambda: bf._row_sq_max_plain(vb)),
            **bound(2.0 * n_rows * DIM, "f32", n_rows * DIM * 2 + 4),
            # the same function as one composition: the bf16 rows' squared
            # norms in f32 and their max
            library_ms=cuda_ms(lambda: torch.linalg.vector_norm(
                vb, dim=1, dtype=torch.float32).square().max()),
            library_of="torch.linalg.vector_norm(dtype=f32)^2, max",
            matmul_ms=None, matmul_of=None,
        )
        for kr in kernels.values():
            kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
            log(f"{kr['name']}: kernel {kr['ms']:.4f} ms, plain "
                f"{kr['plain_ms']:.4f} ms, library {kr['library_ms']} ms, "
                f"product alone {kr['matmul_ms']} "
                f"ms, bound {kr['bound_ms']:.4f} ms ({kr['bound_by']}, "
                f"{kr['bound_peak']}), share {kr['share_of_bound']:.4f}, "
                f"max abs err {kr['max_abs_err']}")
        k3 = kernels["k3_tilemin"]
        log(f"k3_tilemin sweep kernel alone: {k3['kernel_ms']:.4f} ms, share "
            f"of bound {k3['bound_ms'] / k3['kernel_ms']:.4f}")
        kernels["k7_coarse"] = k7_check(bf, device_mod, g, q1, "k7_coarse",
                                        DIM)

    del g, vb, a
    torch.cuda.empty_cache()

    # ---- insert-and-scan path (the index of phase 3, grown) -----------------
    n_all = N_ROWS + N_INSERT
    bf.reset_launches()
    g = insert_rows(index, x_dev[N_ROWS:], n_all)
    with Phase("10 ground truth (K1 l2_topk) over the grown corpus"):
        gt_all = ground_truth(bf, data, queries, q_dev)
    emit_all = g.emit_tid.cpu().numpy()
    serve_engines(index, q_dev, recall_of(emit_all, gt_all), bf, device_mod,
                  "10")
    with Phase("10 inserted rows find themselves"):
        inserted_self_recall(index, x_dev, device_mod, N_ROWS)
    with Phase("11 DeviceScan (scan method=auto)"):
        scan_blocks = device_scan_check(index, g, q_dev, bf, SearchParams,
                                        DeviceScan)
    with Phase("11 K1 near tie at ranks 64 / 65"):
        k1_near_tie_check(bf, dev)
    with Phase("11 beam scans, 2% and 0.2% filters"), \
            K7OneCapture(bf) as k7_seedings:
        beam_scan_check(index, g, q_dev, SearchParams, DeviceBeamScan, beam)
    with Phase("12 the t/044 contract, 50,000 x 3-d"):
        contract_044(HnswIndex, SearchParams, dev)
    scan_launches = dict(bf.LAUNCHES)
    log(f"insert-and-scan path launches: {scan_launches}")
    for name in ("k1_topk", "k1_select", "k2_binned", "k4_beam",
                 "k5_beam_scan", "k7_coarse", "k7_coarse_one"):
        if scan_launches[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the "
                               "insert-and-scan path")
    kernels["k7_coarse_one"] = k7_one_check(bf, k7_seedings.calls)
    del k7_seedings

    with Phase("13 K1's select form vs plain"):
        kernels["k1_select"] = k1_select_check(bf, g, q_dev)
        kernels["k1_select"]["scan_block_ms"] = scan_blocks
        kernels["k1_select"]["exact_peak_mib"] = exact_select_peak(
            index, device_mod, bf, g, q_dev)
    with Phase("13 walk kernel vs plain"):
        walk_vs_plain(g, q_dev, gt_all, emit_all, device_mod, beam, kernels)
        for name in ("k4_beam", "k5_beam_scan"):
            kr = kernels[name]
            kr["share_of_bound"] = kr["bound_ms"] / kr["ms"]
            log(f"{name}: kernel {kr['ms']:.4f} ms, plain "
                f"{kr['plain_ms']:.4f} ms, bound {kr['bound_ms']:.4f} ms "
                f"({kr['bound_by']}, {kr['bound_peak']}), share "
                f"{kr['share_of_bound']:.4f}, {kr['steps_mean']:.1f} steps "
                f"and {kr['scored_mean']:.1f} rows scored per query, max abs "
                f"err {kr['max_abs_err']}")

    for name in kernels:
        kernels[name]["launches"] = (
            scan_launches if name in ("k5_beam_scan", "k1_select",
                                      "k7_coarse_one")
            else main_launches)[name]
    beam_variants(index, g, q_dev, emit_all, gt_all, device_mod, beam, bf,
                  kernels, SearchParams)
    del g, x_dev  # the grown index stays for phase 20
    torch.cuda.empty_cache()

    # ---- native path (first N_NATIVE rows) ---------------------------------
    bf.reset_launches()
    log(f"cut: the native path builds the first {N_NATIVE:,} rows "
        "(single-threaded host build)")
    with Phase("14 native build"):
        nat = HnswIndex.build(
            data[:N_NATIVE], metric="l2", params=params, method="native",
            host_graph=False, seed=1,  # no device named: the card
        )
        gn = nat.device_graph()
        log(f"graph: cap={gn.cap} entry={gn.entry} level={gn.entry_level} "
            f"upper rows={gn.upper_neighbors.shape[0]} on {gn.device}")
        if gn.device.type != dev.type or gn.cap != N_NATIVE:
            raise RuntimeError("the native graph is not on the card at size")
    with Phase("15 ground truth (K1 l2_topk)"):
        gt_n = ground_truth(bf, data[:N_NATIVE], queries, q_dev)
    emit_n = gn.emit_tid.cpu().numpy()
    res_n = serve_engines(nat, q_dev, recall_of(emit_n, gt_n), bf,
                          device_mod, "16")
    search_vs_serve(nat, queries, res_n, emit_n, SearchParams, "17")
    for name in ("k1_topk", "k2_binned", "k4_beam", "k7_coarse"):
        if bf.LAUNCHES[name] <= 0:
            raise RuntimeError(f"kernel {name} never ran on the native path")
    log(f"native path launches: {dict(bf.LAUNCHES)}")
    del nat, gn
    torch.cuda.empty_cache()

    # ---- 768-d cosine, l1 and persistence ----------------------------------
    from pgvector_rx_tpu_torch.graph import device_build as db

    x27, q768 = cosine_768(HnswIndex, IndexParams, make_dataset, device_mod,
                           db, bf, beam, dev, kernels)
    build_knobs(HnswIndex, device_mod, db, bf, data, queries, q_dev, gt,
                main_build, x27, q768, dev)
    del x27, q768
    l1_path(HnswIndex, IndexParams, device_mod, db, bf, data, q_dev, dev)
    persistence(index, q_dev, HnswIndex, IndexParams, SearchParams,
                device_mod, data, dev)
    del index
    torch.cuda.empty_cache()
    halfvec_path(HnswIndex, IndexParams, make_dataset, device_mod, bf, dev,
                 kernels)

    # ---- the bit kind, the flat index and the operator classes -------------
    from pgvector_rx_tpu_torch.ops import bits as bits_mod

    xbits, qbits, qw = bit_path(HnswIndex, IndexParams, SearchParams,
                                make_dataset, device_mod, db, bf, bits_mod,
                                beam, dev, kernels)
    jaccard_path(HnswIndex, IndexParams, device_mod, db, bf, bits_mod, xbits,
                 qbits, qw, dev, kernels)
    flat_and_facade(data, queries, q_dev, xbits, qbits, qw, bf, bits_mod,
                    SearchParams, dev)
    del data, queries, q_dev, xbits, qbits, qw
    torch.cuda.empty_cache()

    # ---- the sparse kind ----------------------------------------------------
    sparse_path(sparse_child, sparse_tmp, HnswIndex, SearchParams, device_mod,
                beam, bf, dev, kernels)

    # ---- the sharded configuration ------------------------------------------
    sharded_path(make_dataset, SearchParams, params, device_mod, bf, beam,
                 dev)

    foreign = [m for m in sys.modules
               if m.split(".")[0] in ("jax", "jaxlib", "pgvector_rx_tpu", "bench")]
    if foreign:
        raise RuntimeError(f"the port's path imported {sorted(foreign)[:5]}")
    log(json.dumps({"kernels": [kernels[k] for k in
                                ("k1_topk", "k2_binned", "k3_tilemin",
                                 "k3_x2max", "k4_beam", "k5_beam_scan",
                                 "k9_bits", "k9_bits_tc", "k4_beam_words",
                                 "k10_sparse",
                                 "k10_sparse_lookup", "k10_compact",
                                 "k4_beam_sparse",
                                 "k4_beam_expand4", "k4_beam_visited",
                                 "k4_beam_expand4_visited",
                                 "k4_beam_bf16", "k4_words_expand4",
                                 "k1_topk_2byte", "k2_binned_f16",
                                 "k4_words_visited",
                                 "k4_words_expand4_visited",
                                 "k4_sparse_visited",
                                 "k5_beam_scan_expand4",
                                 "k5_beam_scan_bf16", "k7_coarse",
                                 "k8_beam_ground", "k1_select",
                                 "k7_coarse_one")]}))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--sparse-build"]:
        sys.exit(sparse_build_child(sys.argv[2]))
    sys.exit(main())
