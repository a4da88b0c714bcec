"""Value stores: the arena of vector values behind an index.

The analog of the reference's build arena (``values: Vec<u8>`` +
value_offset/size per element, build.rs:239-245,:441-454) and of the
on-disk element tuples' varlena payloads (types/hnsw.rs:112-128) — but
held as flat numpy arrays that mirror directly into device HBM arrays.

Each store kind provides batched order-distance kernels (host side) with
the same numeric discipline as the scalar type functions, plus byte
equality for duplicate detection (build.rs:480-496 compares raw bytes,
not distance == 0).
"""

from __future__ import annotations

import numpy as np

from ..constants import HNSW_MAX_NNZ
from ..types.bitvec import _POPCOUNT

_GROW = 1024


class DenseStore:
    """f32 / f16 rows. Metrics: l2 (squared), ip (negated), cosine, l1."""

    kind = "dense"

    def __init__(self, dim: int, metric: str, dtype=np.float32):
        self.dim = int(dim)
        self.metric = metric
        self.dtype = np.dtype(dtype)
        self._rows = np.zeros((0, dim), dtype=self.dtype)
        self._device_rows = None  # pending device-resident backing
        self.count = 0

    @property
    def rows(self) -> np.ndarray:
        """Host row matrix. If the store was bulk-loaded from a
        device-resident array (``bulk_load_device``), the one-time
        download happens here, on first host access — serving reads go
        through the device graph and never pay it."""
        if self._device_rows is not None:
            dev, self._device_rows = self._device_rows, None
            host = np.asarray(dev).astype(self.dtype, copy=False)
            # capacity-padded device backing: keep the live prefix
            self._rows = host[: max(self.count, 0)] if (
                host.shape[0] > self.count
            ) else host
        return self._rows

    @rows.setter
    def rows(self, value: np.ndarray) -> None:
        self._device_rows = None
        self._rows = value

    def _ensure(self, n: int) -> None:
        if n > self.rows.shape[0]:
            cap = max(n, self.rows.shape[0] * 2, _GROW)
            new = np.zeros((cap, self.dim), dtype=self.dtype)
            new[: self.count] = self.rows[: self.count]
            self.rows = new

    def append(self, value: np.ndarray) -> int:
        idx = self.count
        self._ensure(idx + 1)
        self.rows[idx] = value
        self.count += 1
        return idx

    def overwrite(self, idx: int, value) -> None:
        self.rows[idx] = value

    def bulk_load(self, rows: np.ndarray) -> None:
        """Adopt a whole [N, dim] matrix at once (empty store only)."""
        assert self.count == 0
        self.rows = np.ascontiguousarray(rows, dtype=self.dtype)
        self.count = len(rows)

    def bulk_load_device(self, dev_rows, count: int | None = None) -> None:
        """Adopt a device-resident [N, dim] array without downloading it
        (empty store only). The host copy materializes lazily on first
        ``rows`` access (save/host-scan paths); device serving never
        downloads. ``count`` < N adopts a capacity-padded buffer whose
        first ``count`` rows are live (the lazy download slices)."""
        assert self.count == 0
        self._device_rows = dev_rows
        self.count = int(count if count is not None else dev_rows.shape[0])

    def rebind_device(self, dev_rows) -> None:
        """Swap the device backing for an equal-content array (e.g. the
        compact serve-dtype copy at build finalize) without touching
        ``count`` — frees the previous (typically f32) backing once the
        caller drops its own references."""
        assert self._device_rows is not None
        self._device_rows = dev_rows

    def reset_device(self, dev_rows) -> None:
        """Replace the whole backing with a device-resident [N, dim]
        array (device-input bulk insert into a device-backed store)."""
        self._rows = np.zeros((0, self.dim), dtype=self.dtype)
        self._device_rows = dev_rows
        self.count = int(dev_rows.shape[0])

    def zero(self, idx: int) -> None:
        self.rows[idx] = 0

    def pop(self) -> None:
        self.count -= 1
        self.rows[self.count] = 0

    def get(self, idx: int) -> np.ndarray:
        return self.rows[idx]

    def value_bytes(self, idx: int) -> bytes:
        return self.rows[idx].tobytes()

    def bytes_equal(self, idx: int, value) -> bool:
        return np.asarray(value, dtype=self.dtype).tobytes() == self.value_bytes(idx)

    def _dist(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        q32 = np.asarray(q, dtype=np.float32)
        r32 = rows.astype(np.float32, copy=False)
        if self.metric == "l2":
            d = r32 - q32[None, :]
            return np.sum(d * d, axis=1, dtype=np.float32)
        if self.metric == "ip":
            return -np.sum(r32 * q32[None, :], axis=1, dtype=np.float32)
        if self.metric == "cosine":
            sims = np.sum(r32 * q32[None, :], axis=1, dtype=np.float32)
            return (1.0 - np.clip(sims.astype(np.float64), -1.0, 1.0)).astype(
                np.float32
            )
        if self.metric == "l1":
            return np.sum(np.abs(r32 - q32[None, :]), axis=1, dtype=np.float32)
        raise ValueError(f"unknown dense metric: {self.metric}")

    def dist_many(self, query, ids) -> np.ndarray:
        return self._dist(query, self.rows[np.asarray(ids, dtype=np.int64)])

    def pair_many(self, idx: int, ids) -> np.ndarray:
        return self.dist_many(self.rows[idx], ids)

    def pair_matrix(self, ids) -> np.ndarray:
        """All-pairs distances among rows `ids` in one batched op."""
        sel = self.rows[np.asarray(ids, dtype=np.int64)].astype(np.float32, copy=False)
        if self.metric == "l2":
            d = sel[:, None, :] - sel[None, :, :]
            return np.sum(d * d, axis=2, dtype=np.float32)
        if self.metric == "ip":
            return -(sel @ sel.T).astype(np.float32)
        if self.metric == "cosine":
            sims = (sel @ sel.T).astype(np.float64)
            return (1.0 - np.clip(sims, -1.0, 1.0)).astype(np.float32)
        if self.metric == "l1":
            return np.sum(
                np.abs(sel[:, None, :] - sel[None, :, :]), axis=2, dtype=np.float32
            )
        raise ValueError(f"unknown dense metric: {self.metric}")


class BitStore:
    """Packed bit rows (uint8 bytes, MSB-first). Metrics: hamming, jaccard."""

    kind = "bit"

    def __init__(self, nbits: int, metric: str):
        self.dim = int(nbits)
        self.metric = metric
        self.nbytes = (nbits + 7) // 8
        self.rows = np.zeros((0, self.nbytes), dtype=np.uint8)
        self.count = 0

    def _ensure(self, n: int) -> None:
        if n > self.rows.shape[0]:
            cap = max(n, self.rows.shape[0] * 2, _GROW)
            new = np.zeros((cap, self.nbytes), dtype=np.uint8)
            new[: self.count] = self.rows[: self.count]
            self.rows = new

    def append(self, value: np.ndarray) -> int:
        idx = self.count
        self._ensure(idx + 1)
        self.rows[idx] = value
        self.count += 1
        return idx

    def bulk_load(self, rows: np.ndarray) -> None:
        """Adopt a whole [n, nbytes] packed matrix (device bulk build)."""
        assert self.count == 0
        self.rows = np.ascontiguousarray(rows, dtype=np.uint8)
        self.count = rows.shape[0]

    def overwrite(self, idx: int, value) -> None:
        self.rows[idx] = value

    def zero(self, idx: int) -> None:
        self.rows[idx] = 0

    def pop(self) -> None:
        self.count -= 1
        self.rows[self.count] = 0

    def get(self, idx: int) -> np.ndarray:
        return self.rows[idx]

    def value_bytes(self, idx: int) -> bytes:
        return self.rows[idx].tobytes()

    def bytes_equal(self, idx: int, value) -> bool:
        return np.asarray(value, dtype=np.uint8).tobytes() == self.value_bytes(idx)

    def _dist(self, q: np.ndarray, rows: np.ndarray) -> np.ndarray:
        q = np.asarray(q, dtype=np.uint8)
        if self.metric == "hamming":
            return _POPCOUNT[rows ^ q[None, :]].sum(axis=1).astype(np.float32)
        if self.metric == "jaccard":
            ab = _POPCOUNT[rows & q[None, :]].sum(axis=1).astype(np.float64)
            aa = float(_POPCOUNT[q].sum())
            bb = _POPCOUNT[rows].sum(axis=1).astype(np.float64)
            union = aa + bb - ab
            out = np.where(ab == 0, 1.0, 1.0 - ab / np.where(union > 0, union, 1.0))
            return out.astype(np.float32)
        raise ValueError(f"unknown bit metric: {self.metric}")

    def dist_many(self, query, ids) -> np.ndarray:
        return self._dist(query, self.rows[np.asarray(ids, dtype=np.int64)])

    def pair_many(self, idx: int, ids) -> np.ndarray:
        return self.dist_many(self.rows[idx], ids)

    def pair_matrix(self, ids) -> np.ndarray:
        sel = self.rows[np.asarray(ids, dtype=np.int64)]
        if self.metric == "hamming":
            return (
                _POPCOUNT[sel[:, None, :] ^ sel[None, :, :]].sum(axis=2).astype(np.float32)
            )
        ab = _POPCOUNT[sel[:, None, :] & sel[None, :, :]].sum(axis=2).astype(np.float64)
        pops = _POPCOUNT[sel].sum(axis=1).astype(np.float64)
        union = pops[:, None] + pops[None, :] - ab
        out = np.where(ab == 0, 1.0, 1.0 - ab / np.where(union > 0, union, 1.0))
        return out.astype(np.float32)


class SparseStore:
    """Padded-CSR sparse rows. Metrics: l2, ip, cosine, l1.

    Values are (indices[P] int32 sorted + PAD, values[P] f32) pairs; the
    pad index is int32 max so rows stay sorted (see ops/sparse.py). The
    HNSW nnz cap (hnsw_constants.rs:7, enforced at build.rs:195-205) is
    checked by the index layer.
    """

    kind = "sparse"
    PAD = np.int32(2**31 - 1)

    def __init__(self, dim: int, metric: str, budget: int = 16):
        # `budget` is the padded row width; it grows on demand (powers
        # of two, capped by HNSW_MAX_NNZ) so low-nnz workloads don't pay
        # for the 1000-nnz worst case.
        self.dim = int(dim)
        self.metric = metric
        self.budget = min(int(budget), HNSW_MAX_NNZ)
        self.indices = np.full((0, self.budget), self.PAD, dtype=np.int32)
        self.values = np.zeros((0, self.budget), dtype=np.float32)
        self.count = 0

    def _grow_budget(self, need: int) -> None:
        new_budget = self.budget
        while new_budget < need:
            new_budget *= 2
        new_budget = min(max(new_budget, need), max(HNSW_MAX_NNZ, need))
        ni = np.full((self.indices.shape[0], new_budget), self.PAD, dtype=np.int32)
        nv = np.zeros((self.values.shape[0], new_budget), dtype=np.float32)
        ni[:, : self.budget] = self.indices
        nv[:, : self.budget] = self.values
        self.indices, self.values, self.budget = ni, nv, new_budget

    def _ensure(self, n: int) -> None:
        if n > self.indices.shape[0]:
            cap = max(n, self.indices.shape[0] * 2, _GROW)
            ni = np.full((cap, self.budget), self.PAD, dtype=np.int32)
            nv = np.zeros((cap, self.budget), dtype=np.float32)
            ni[: self.count] = self.indices[: self.count]
            nv[: self.count] = self.values[: self.count]
            self.indices, self.values = ni, nv

    def _pad(self, value) -> tuple[np.ndarray, np.ndarray]:
        idx, val = value
        k = len(idx)
        if k > self.budget:
            self._grow_budget(k)
        pi = np.full(self.budget, self.PAD, dtype=np.int32)
        pv = np.zeros(self.budget, dtype=np.float32)
        pi[:k] = idx
        pv[:k] = val
        return pi, pv

    def append(self, value) -> int:
        i = self.count
        self._ensure(i + 1)
        self.indices[i], self.values[i] = self._pad(value)
        self.count += 1
        return i

    def overwrite(self, idx: int, value) -> None:
        self.indices[idx], self.values[idx] = self._pad(value)

    def zero(self, idx: int) -> None:
        self.indices[idx] = self.PAD
        self.values[idx] = 0

    def pop(self) -> None:
        self.count -= 1
        self.zero(self.count)

    def get(self, idx: int):
        keep = self.indices[idx] != self.PAD
        return self.indices[idx][keep], self.values[idx][keep]

    def value_bytes(self, idx: int) -> bytes:
        return self.indices[idx].tobytes() + self.values[idx].tobytes()

    def bytes_equal(self, idx: int, value) -> bool:
        pi, pv = self._pad(value)
        return pi.tobytes() + pv.tobytes() == self.value_bytes(idx)

    def _dist(self, q, rows_i: np.ndarray, rows_v: np.ndarray) -> np.ndarray:
        qi, qv = self._pad(q)
        n = rows_i.shape[0]
        # One batched binary search for all rows: composite uint64 keys
        # (row << 32 | index) are globally sorted because each row is
        # sorted and PAD-padded (see ops/sparse.py for the device twin).
        row_ids = np.arange(n, dtype=np.uint64)[:, None]
        flat_keys = (
            (row_ids << np.uint64(32)) | rows_i.astype(np.uint32).astype(np.uint64)
        ).ravel()
        qkeys = (row_ids << np.uint64(32)) | qi.astype(np.uint32).astype(np.uint64)
        pos = np.searchsorted(flat_keys, qkeys.ravel())
        pos_c = np.minimum(pos, n * self.budget - 1)
        found = (
            (pos < n * self.budget)
            & (flat_keys[pos_c] == qkeys.ravel())
            & (np.broadcast_to(qi[None, :] != self.PAD, (n, self.budget)).ravel())
        ).reshape(n, self.budget)
        mcv = np.where(found, rows_v.ravel()[pos_c].reshape(n, self.budget), 0.0)
        dot = np.sum(qv[None, :] * mcv, axis=1, dtype=np.float32)
        q_sq = np.float32(np.sum(qv * qv, dtype=np.float32))
        c_sq = np.sum(rows_v * rows_v, axis=1, dtype=np.float32)
        if self.metric == "l2":
            return np.maximum(q_sq + c_sq - 2.0 * dot, 0.0).astype(np.float32)
        if self.metric == "ip":
            return (-dot).astype(np.float32)
        if self.metric == "cosine":
            denom = np.sqrt(q_sq.astype(np.float64) * c_sq.astype(np.float64))
            sim = np.where(denom > 0, dot / np.where(denom > 0, denom, 1.0), 0.0)
            return (1.0 - np.clip(sim, -1.0, 1.0)).astype(np.float32)
        if self.metric == "l1":
            q_abs = np.float32(np.sum(np.abs(qv), dtype=np.float32))
            c_abs = np.sum(np.abs(rows_v), axis=1, dtype=np.float32)
            corr = np.sum(
                np.where(found, np.abs(qv[None, :] - mcv) - np.abs(qv[None, :]) - np.abs(mcv), 0.0),
                axis=1,
                dtype=np.float32,
            )
            return (q_abs + c_abs + corr).astype(np.float32)
        raise ValueError(f"unknown sparse metric: {self.metric}")

    def dist_many(self, query, ids) -> np.ndarray:
        sel = np.asarray(ids, dtype=np.int64)
        return self._dist(query, self.indices[sel], self.values[sel])

    def pair_many(self, idx: int, ids) -> np.ndarray:
        return self.dist_many(self.get(idx), ids)

    def pair_matrix(self, ids) -> np.ndarray:
        sel = np.asarray(ids, dtype=np.int64)
        ci, cv = self.indices[sel], self.values[sel]
        return np.stack([self._dist(self.get(int(i)), ci, cv) for i in sel])
