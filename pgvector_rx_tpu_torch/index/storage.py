"""Persistence of the PyTorch port: checkpoint snapshots + append log (the
WAL analog).

The port's copy of ``pgvector_rx_tpu/index/storage.py``, in the same file
format (``FORMAT_VERSION`` 1, the same ``meta.json`` keys and ``arrays.npz``
arrays), so a checkpoint written by either package loads in the other. The
reference delegates durability to PostgreSQL: a full-index WAL dump at
build (build.rs:891-901) and per-mutation GenericXLog records
(insert.rs:216-263), validated by replica-equivalence tests
(tests/t/010_hnsw_wal.pl). Here the durable objects are:

- a checkpoint: ``meta.json`` + ``arrays.npz`` holding the full graph
  (meta-page analog: magic/version/dims/m/ef_construction/entry —
  types/hnsw.rs:55-74 — plus levels/versions/deleted/neighbors/TIDs)
- an append-only JSONL log of inserts/deletes since the checkpoint,
  replayed on load (:func:`load` with ``replay=True``)

What differs from the JAX package:

- the serving graphs a load makes are torch ``DeviceGraph`` s on the
  loaded index's device (``device=None``: the card);
- ``arrays.npz`` is written to a temporary file and moved into place with
  ``os.replace``, as ``meta.json`` is, so a crash mid-write never leaves a
  torn archive (the JAX package writes it in place);
- ``save`` refuses a directory whose ``log.jsonl`` holds records: they
  are already in the index, and a load would replay them a second time.

The sparse kind's rows are saved as ``sp_indices`` / ``sp_values`` (the
store's padded CSR); its checkpoints load host-graph only, as in the JAX
package (``serving=True`` refuses them: no sparse index is serving-only).
"""

from __future__ import annotations

import json
import os
from contextlib import contextmanager
from pathlib import Path

import numpy as np

from .. import constants as C
from ..config import IndexParams
from ..graph.host import GraphElement

FORMAT_VERSION = 1


def _value_arrays(index, rows, n: int) -> dict:
    """The serving graph's value tensors from the checkpoint's ``rows``
    (n of them, plus the zero sentinel row): f32 values under the serving
    dtype policy, or the bit kind's packed words (uint32, the layout of
    ``ops/bits.pack_bits``) from its byte rows."""
    from ..graph.device import _serve_dtype_for, _serve_value_arrays, _tensor
    from ..ops.bits import bytes_to_words

    if index.kind == "bit":
        words = np.zeros((n + 1, -(-index.dim // 32)), dtype=np.uint32)
        if n:
            words[:n] = bytes_to_words(rows, index.dim)
        return dict(words=words)
    vals = np.zeros((n + 1, index.dim), dtype=np.float32)
    vals[:n] = rows.astype(np.float32)
    return _serve_value_arrays(_tensor(vals, index.device),
                               _serve_dtype_for(index))


def _refuse_live_log(path: Path) -> None:
    log = path / "log.jsonl"
    if log.exists() and log.stat().st_size > 0:
        raise ValueError(
            f"{log} holds append-log records that the index already "
            "contains: a load of this checkpoint would replay them twice; "
            "move or truncate the log, or save to another directory"
        )


def _write_arrays(path: Path, arrays: dict) -> None:
    """``arrays.npz`` through a temporary file and ``os.replace``."""
    tmp = path / "arrays.npz.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path / "arrays.npz")


def _write_meta(path: Path, meta: dict) -> None:
    tmp = path / "meta.json.tmp"
    tmp.write_text(json.dumps(meta))
    os.replace(tmp, path / "meta.json")


def save(index, path) -> None:
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    _refuse_live_log(path)
    if getattr(index, "serving_only", False):
        _save_serving(index, path)
        return
    n = len(index.elements)

    levels = np.array([e.level for e in index.elements], dtype=np.int16)
    versions = np.array([e.version for e in index.elements], dtype=np.int16)
    deleted = np.array([e.deleted for e in index.elements], dtype=bool)

    nb_ids, nb_dists, nb_counts = [], [], []
    for e in index.elements:
        for layer_list in e.neighbors:
            nb_counts.append(len(layer_list))
            for d, i in layer_list:
                nb_dists.append(d)
                nb_ids.append(i)

    tid_flat, tid_counts = [], []
    for tids in index.heap_tids:
        tid_counts.append(len(tids))
        tid_flat.extend(tids)

    if index.kind == "sparse":
        rows = {"sp_indices": index.store.indices[:n],
                "sp_values": index.store.values[:n]}
    else:
        rows = {"rows": index.store.rows[:n]}
    _write_arrays(path, {
        "levels": levels,
        "versions": versions,
        "deleted": deleted,
        "nb_ids": np.array(nb_ids, dtype=np.int32),
        "nb_dists": np.array(nb_dists, dtype=np.float32),
        "nb_counts": np.array(nb_counts, dtype=np.int32),
        "tid_flat": np.array(tid_flat, dtype=np.int64),
        "tid_counts": np.array(tid_counts, dtype=np.int32),
        "free_slots": np.array(index.free_slots, dtype=np.int32),
        **rows,
    })
    _write_meta(path, {
        "magic": C.HNSW_MAGIC_NUMBER,
        "format_version": FORMAT_VERSION,
        "hnsw_version": C.HNSW_VERSION,
        "kind": index.kind,
        "metric": index.metric,
        "dim": index.dim,
        "m": index.params.m,
        "ef_construction": index.params.ef_construction,
        "dtype": str(index.dtype) if index.dtype is not None else None,
        "entry": index.entry,
        "seed": index.seed,
        "rng_state": _rng_state_to_json(index._rng),
        "n_elements": n,
        "stats": index.stats,
    })


def _new_index(meta, device):
    from .hnsw import HnswIndex

    return HnswIndex(
        meta["dim"],
        metric=meta["metric"],
        kind=meta["kind"],
        params=IndexParams(m=meta["m"], ef_construction=meta["ef_construction"]),
        dtype=np.dtype(meta["dtype"]) if meta["dtype"] else np.float32,
        seed=meta["seed"],
        device=device,
    )


def load(path, replay: bool = True, serving: bool = False, device=None):
    """Load a checkpoint onto ``device`` (None: the card). ``serving=True``
    loads a HOST-GRAPH checkpoint as a serving-only index: the flat npz
    arrays are converted straight into the DeviceGraph layout with
    vectorized numpy — no per-element Python objects, so a multi-million-row
    checkpoint loads in seconds instead of the minutes the mutation-capable
    materialization costs past ~2M elements. Pending append-log inserts are
    replayed through insert_bulk; logged deletes cannot apply to a
    serving-only index and raise (load mutation-capable, vacuum,
    re-checkpoint)."""
    path = Path(path)
    meta = json.loads((path / "meta.json").read_text())
    if meta["magic"] != C.HNSW_MAGIC_NUMBER:
        raise ValueError("hnsw index is not valid (magic number mismatch)")
    if meta.get("serving_only"):
        return _load_serving(meta, path, device)
    if serving:
        return _load_host_as_serving(meta, path, replay, device)

    index = _new_index(meta, device)
    z = np.load(path / "arrays.npz")
    n = int(meta["n_elements"])

    if n > 2_000_000:
        import warnings

        warnings.warn(
            f"loading a host-graph checkpoint of {n} elements "
            "materializes per-element Python objects (minutes at this "
            "scale); prefer serving-only checkpoints "
            "(build(host_graph=False)) for large serving corpora",
            stacklevel=2,
        )
    # NOTE: hoist every z[...] access out of loops — NpzFile re-decompresses
    # the WHOLE array on each __getitem__ (O(n^2) in a per-row loop)
    if meta["kind"] == "sparse":
        sp_i, sp_v = z["sp_indices"], z["sp_values"]
        for i in range(n):
            keep = sp_i[i] != index.store.PAD
            index.store.append((sp_i[i][keep], sp_v[i][keep]))
    else:
        index.store.bulk_load(z["rows"])

    # elements — plain-Python lists up front: per-element numpy scalar
    # boxing in the hot loop was the measured cost of host-graph loads
    levels = z["levels"].tolist()
    versions = z["versions"].tolist()
    deleted = z["deleted"].tolist()
    nb_ids = z["nb_ids"].tolist()
    nb_dists = z["nb_dists"].tolist()
    nb_counts = z["nb_counts"].tolist()
    ci = 0  # index into nb_counts
    off = 0  # index into nb_ids/nb_dists
    for i in range(n):
        e = GraphElement(level=levels[i], version=versions[i])
        e.deleted = deleted[i]
        for lc in range(levels[i] + 1):
            cnt = nb_counts[ci]
            ci += 1
            e.neighbors[lc] = list(
                zip(nb_dists[off : off + cnt], nb_ids[off : off + cnt])
            )
            off += cnt
        index.elements.append(e)

    tid_flat = z["tid_flat"].tolist()
    tid_counts = z["tid_counts"].tolist()
    toff = 0
    for i in range(n):
        cnt = tid_counts[i]
        index.heap_tids.append(tid_flat[toff : toff + cnt])
        toff += cnt

    index.entry = meta["entry"]
    index.free_slots = [int(s) for s in z["free_slots"]]
    index.stats.update(meta.get("stats", {}))
    _rng_state_from_json(index._rng, meta["rng_state"])

    log_path = path / "log.jsonl"
    if replay and log_path.exists():
        replay_log(index, log_path)
    return index


def _load_host_as_serving(meta, path: Path, replay: bool, device):
    """Host-graph checkpoint -> serving-only index, vectorized.

    The flat nb_ids/nb_counts arrays (saved per element, layers 0..L in
    order) scatter directly into the DeviceGraph layout with
    repeat/cumsum index arithmetic — O(edges) numpy, no Python loop over
    elements."""
    from ..constants import hnsw_get_layer_m
    from ..graph.device import DeviceGraph

    if meta["kind"] == "sparse":
        raise ValueError("serving load supports dense and bit checkpoints")
    index = _new_index(meta, device)
    z = np.load(path / "arrays.npz")
    n = int(meta["n_elements"])
    m = meta["m"]
    lm0 = hnsw_get_layer_m(m, 0)

    levels = z["levels"].astype(np.int32)
    deleted = z["deleted"]
    live = ~deleted
    nb_ids = z["nb_ids"].astype(np.int32)
    nb_counts = z["nb_counts"].astype(np.int64)
    # list l of element i lives at flat-list index first[i] + l;
    # its ids start at ccum[first[i] + l]
    first = np.concatenate([[0], np.cumsum(levels + 1)[:-1]]).astype(np.int64)
    ccum = np.concatenate([[0], np.cumsum(nb_counts)])

    def scatter_layer(dst, dst_rows, el, lc, width, col_off=0):
        """Write each element's layer-lc list (clipped to `width`
        entries) into dst[dst_rows[j], col_off + 0..] — pure
        repeat/cumsum indexing, no per-element loop."""
        cnt = np.minimum(nb_counts[first[el] + lc], width).astype(np.int64)
        total = int(cnt.sum())
        if total == 0:
            return
        within = np.arange(total) - np.repeat(np.cumsum(cnt) - cnt, cnt)
        flat = np.repeat(ccum[first[el] + lc], cnt) + within
        dst[np.repeat(dst_rows, cnt), col_off + within] = nb_ids[flat]

    neighbors0 = np.full((n + 1, lm0), -1, dtype=np.int32)
    el0 = np.nonzero(live)[0]
    scatter_layer(neighbors0, el0, el0, 0, lm0)

    lmax = max(int(levels.max(initial=0)), 1)
    upper_el = np.nonzero(live & (levels >= 1))[0]
    upper_slot = np.full(n + 1, -1, dtype=np.int32)
    upper_slot[upper_el] = np.arange(len(upper_el), dtype=np.int32)
    upper = np.full((max(len(upper_el), 1), lmax * m), -1, dtype=np.int32)
    for lc in range(1, lmax + 1):
        el = np.nonzero(live & (levels >= lc))[0]
        if len(el):
            scatter_layer(
                upper, upper_slot[el], el, lc, m, col_off=(lc - 1) * m
            )

    tid_counts = z["tid_counts"].astype(np.int32)
    tid_flat = z["tid_flat"]
    toffs = np.concatenate([[0], np.cumsum(tid_counts)])
    emit_tid = np.full(n + 1, -1, dtype=np.int32)
    has = tid_counts > 0
    emit_tid[:n][has] = tid_flat[toffs[:-1][has]].astype(np.int32)
    tid_count_arr = np.zeros(n + 1, dtype=np.int32)
    tid_count_arr[:n] = tid_counts
    flat_list = tid_flat.tolist()
    offs = toffs.tolist()
    index.heap_tids = [flat_list[offs[i] : offs[i + 1]] for i in range(n)]

    levels_pad = np.full(n + 1, -1, dtype=np.int32)
    levels_pad[:n] = levels
    trav = np.zeros(n + 1, dtype=bool)
    trav[:n] = live

    rows = z["rows"]
    index.store.bulk_load(rows)
    entry = int(meta["entry"]) if meta["entry"] is not None else -1
    index.entry = entry if entry >= 0 else None
    index.serving_only = True
    index._serving_dead = int(n - live.sum())
    index._device = DeviceGraph.from_numpy(
        dict(neighbors0=neighbors0, upper_neighbors=upper,
             upper_slot=upper_slot, levels=levels_pad, traversable=trav,
             emit_tid=emit_tid, tid_count=tid_count_arr,
             **_value_arrays(index, rows, n)),
        kind=meta["kind"], metric=meta["metric"], cap=n, m=m, entry=entry,
        entry_level=int(levels[entry]) if entry >= 0 else -1,
        device=index.device,
    )
    index.stats.update(meta.get("stats", {}))

    log_path = path / "log.jsonl"
    if replay and log_path.exists():
        rows, tids = [], []
        with open(log_path, "rb") as fh:
            for raw in fh:
                stripped = raw.strip()
                if not stripped:
                    continue
                rec = json.loads(stripped)
                if rec["op"] == "delete":
                    raise ValueError(
                        "serving load can only replay dense insert "
                        "records (bulk insert path); load "
                        "mutation-capable, vacuum, re-checkpoint"
                    )
                rows.append(_decode_value(index, rec["value"]))
                tids.append(int(rec["tid"]))
        if rows:
            log = index._log
            index._log = None
            try:
                index.insert_bulk(np.stack(rows), tids=tids)
            finally:
                index._log = log
    return index


# ---------------------------------------------------------------------------
# Append log
# ---------------------------------------------------------------------------


class AppendLog:
    """Append-only insert/delete log (GenericXLog analog).

    Records mutations that happened after the last checkpoint; `load`
    replays them to reconstruct the exact post-mutation state the way a
    streaming replica replays WAL (tests/t/010_hnsw_wal.pl model).
    """

    def __init__(self, path, index, fsync: bool | None = None):
        self.path = Path(path)
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self._fh = open(self.path, "a", encoding="utf-8")
        self.index = index
        # fsync-per-record gives the GenericXLog durability contract (a
        # committed insert survives power loss, insert.rs:216-263). ON by
        # default, like every reference mutation; PGV_LOG_FSYNC=0 opts out
        # (flush-only: survives process crashes but not kernel/power
        # ones); bulk inserts amortize via batch() group commit.
        self.fsync = (
            fsync
            if fsync is not None
            else os.environ.get("PGV_LOG_FSYNC", "1") != "0"
        )
        self._defer = 0
        self._dirty = False

    def _append(self, rec: dict) -> None:
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if self.fsync:
            if self._defer:
                self._dirty = True
            else:
                os.fsync(self._fh.fileno())

    @contextmanager
    def batch(self):
        """Group commit: records appended inside the context share ONE
        fsync at exit (the batch becomes durable together — the WAL
        group-commit analog for bulk inserts)."""
        self._defer += 1
        try:
            yield
        finally:
            self._defer -= 1
            if not self._defer and self._dirty:
                self._fh.flush()
                if self.fsync:
                    os.fsync(self._fh.fileno())
                self._dirty = False

    def record_insert(self, value, tid: int) -> None:
        self._append(
            {"op": "insert", "tid": int(tid),
             "value": _encode_value(self.index, value)}
        )

    def record_delete(self, tids) -> None:
        self._append({"op": "delete", "tids": [int(t) for t in tids]})

    def close(self) -> None:
        self._fh.close()


def replay_log(index, log_path) -> int:
    """Apply logged mutations in order. Returns number of records.

    A torn FINAL record (a crash mid-append left a half-written last line)
    is tolerated: it is truncated away with a warning, matching WAL
    replay's treatment of a torn tail record — the mutation never
    committed. Corruption anywhere BEFORE the final record is real data
    loss and raises.
    """
    count = 0
    log = index._log
    index._log = None  # don't re-log replays
    try:
        # BINARY mode: offsets are unambiguous bytes (a text-mode
        # character count passed to truncate() would corrupt the last good
        # record on any non-ASCII payload or CRLF log), and a long-lived
        # log replays at O(1) host memory
        with open(log_path, "rb") as fh:
            offset = 0
            ln = 0
            for raw in fh:
                line_start = offset
                offset += len(raw)
                ln += 1
                stripped = raw.strip()
                if not stripped:
                    continue
                try:
                    rec = json.loads(stripped)
                except json.JSONDecodeError:
                    if fh.read(1) == b"":  # nothing follows: torn tail
                        import warnings

                        warnings.warn(
                            f"append log {log_path} ends in a torn "
                            "record (crash mid-append); truncating the "
                            "tail — the mutation never committed",
                            stacklevel=2,
                        )
                        with open(log_path, "r+b") as tfh:
                            tfh.truncate(line_start)
                        break
                    raise ValueError(
                        f"append log {log_path} is corrupt at line "
                        f"{ln} (not the final record) — cannot replay"
                    )
                if rec["op"] == "insert":
                    index.insert(
                        _decode_value(index, rec["value"]), rec["tid"]
                    )
                elif rec["op"] == "delete":
                    index.delete(rec["tids"])
                count += 1
    finally:
        index._log = log
    return count


def _encode_value(index, value):
    if index.kind == "bit":
        v = np.asarray(value)
        if (v.dtype == np.uint8 and v.ndim == 1
                and v.shape[0] == index.store.nbytes):
            return {"packed": v.tobytes().hex()}
        return {"bits": v.astype(int).tolist()}
    if index.kind == "sparse":
        idx, val = ((value.indices, value.values)
                    if hasattr(value, "indices") else value)
        return {"i": np.asarray(idx).tolist(), "v": np.asarray(val).tolist()}
    return np.asarray(value, dtype=np.float32).tolist()


def _decode_value(index, enc):
    if index.kind == "bit":
        if "packed" in enc:
            return np.frombuffer(bytes.fromhex(enc["packed"]), dtype=np.uint8)
        return np.asarray(enc["bits"], dtype=np.uint8)
    if index.kind == "sparse":
        return (np.asarray(enc["i"], dtype=np.int32),
                np.asarray(enc["v"], dtype=np.float32))
    return np.asarray(enc, dtype=np.float32)


def _rng_state_to_json(rng) -> dict:
    st = rng.bit_generator.state
    return json.loads(json.dumps(st, default=int))


def _rng_state_from_json(rng, state) -> None:
    rng.bit_generator.state = state


# ---------------------------------------------------------------------------
# Serving-only checkpoints (flat device tensors; bulk_build host_graph=False)
# ---------------------------------------------------------------------------


def _save_serving(index, path: Path) -> None:
    g = index.device_graph()
    # persist the real rows only: row n is the sentinel row (all -1 /
    # False), so [:n+1] is a whole graph; the JAX package's padded
    # capacity is not part of the format, and both packages load it as n
    n = len(index.heap_tids)
    tid_flat, tid_counts = [], []
    for tids in index.heap_tids:
        tid_counts.append(len(tids))
        tid_flat.extend(tids)

    def host(t, rows=None):
        return (t if rows is None else t[:rows]).cpu().numpy()

    _write_arrays(path, {
        "rows": index.store.rows[:n],
        "neighbors0": host(g.neighbors0, n + 1),
        "upper_neighbors": host(g.upper_neighbors),
        "upper_slot": host(g.upper_slot, n + 1),
        "levels": host(g.levels, n + 1),
        "traversable": host(g.traversable, n + 1),
        "tid_flat": np.array(tid_flat, dtype=np.int64),
        "tid_counts": np.array(tid_counts, dtype=np.int32),
    })
    _write_meta(path, {
        "magic": C.HNSW_MAGIC_NUMBER,
        "format_version": FORMAT_VERSION,
        "hnsw_version": C.HNSW_VERSION,
        "serving_only": True,
        "kind": index.kind,
        "metric": index.metric,
        "dim": index.dim,
        "m": index.params.m,
        "ef_construction": index.params.ef_construction,
        "dtype": str(index.dtype) if index.dtype is not None else None,
        "entry": g.entry,
        "entry_level": g.entry_level,
        "seed": index.seed,
        "n_elements": n,
        "stats": index.stats,
    })


def _load_serving(meta, path: Path, device):
    from ..graph.device import DeviceGraph

    index = _new_index(meta, device)
    z = np.load(path / "arrays.npz")
    n = int(meta["n_elements"])
    rows = z["rows"]
    index.store.bulk_load(rows)
    tid_counts = z["tid_counts"].astype(np.int64)
    flat_list = z["tid_flat"].tolist()
    offs = np.concatenate([[0], np.cumsum(tid_counts)]).tolist()
    index.heap_tids = [flat_list[offs[i] : offs[i + 1]] for i in range(n)]
    emit_tid = np.full(n + 1, -1, dtype=np.int32)
    tid_count = np.zeros(n + 1, dtype=np.int32)
    tid_count[:n] = tid_counts
    has = tid_counts > 0
    emit_tid[:n][has] = z["tid_flat"][np.asarray(offs[:-1])[has]]
    index.serving_only = True
    index.entry = int(meta["entry"]) if int(meta["entry"]) >= 0 else None
    # the dtype-native serving policy applies on reload too (halfvec
    # checkpoints come back as one f16 tensor, not the f32 pair)
    index._device = DeviceGraph.from_numpy(
        dict(neighbors0=z["neighbors0"],
             # layer-major flat [U, LMAX*m]; reshape pre-flattening
             # checkpoints
             upper_neighbors=z["upper_neighbors"].reshape(
                 z["upper_neighbors"].shape[0], -1),
             upper_slot=z["upper_slot"], levels=z["levels"],
             traversable=z["traversable"], emit_tid=emit_tid,
             tid_count=tid_count,
             **_value_arrays(index, rows, n)),
        kind=meta["kind"], metric=meta["metric"], cap=n, m=meta["m"],
        entry=int(meta["entry"]), entry_level=int(meta["entry_level"]),
        device=index.device,
    )
    index.stats.update(meta.get("stats", {}))
    return index
