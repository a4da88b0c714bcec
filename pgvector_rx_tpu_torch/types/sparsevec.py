"""The ``sparsevec`` type: ``{i:v,...}/dim`` text format, CSR storage.

Parity source: reference ``src/types/sparsevec.rs`` (pgvector-rx).
Behavior mirrored: text grammar with 1-based SQL indices stored 0-based
(sparsevec.rs:217-424, :339-346, :443-444), zero values dropped on input
(:339-341), sorted-unique index validation (:171-186), dim/nnz caps
(:29,:32,:134-163), merge-join distance kernels (:875-1090), normalize
that re-compacts exact zeros (:1139-1173), and the btree total order
(:1203-1297) which compares as-if-dense with sign-aware gap handling.

Device-side, sparse rows are padded to a fixed nnz budget (HNSW enforces
nnz <= 1000, hnsw_constants.rs:7) and distances match each row entry in
the query's sorted indices — see :mod:`pgvector_rx_tpu_torch.ops.sparse`.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..constants import SPARSEVEC_MAX_DIM, SPARSEVEC_MAX_NNZ
from ._common import format_f32, parse_f32, skip_space


def check_dim(dim: int) -> None:
    if dim < 1:
        raise ValueError("sparsevec must have at least 1 dimension")
    if dim > SPARSEVEC_MAX_DIM:
        raise ValueError(
            f"sparsevec cannot have more than {SPARSEVEC_MAX_DIM} dimensions"
        )


def check_expected_dim(typmod: int | None, dim: int) -> None:
    if typmod is not None and typmod != -1 and typmod != dim:
        raise ValueError(f"expected {typmod} dimensions, not {dim}")


def check_nnz(nnz: int, dim: int) -> None:
    if nnz < 0:
        raise ValueError("sparsevec cannot have negative number of elements")
    if nnz > SPARSEVEC_MAX_NNZ:
        raise ValueError(
            f"sparsevec cannot have more than {SPARSEVEC_MAX_NNZ} non-zero elements"
        )
    if nnz > dim:
        raise ValueError("sparsevec cannot have more elements than dimensions")


def check_indices(indices: np.ndarray, dim: int) -> None:
    """Parity: sparsevec.rs:171-186 (bounds, ascending, unique)."""
    if indices.size == 0:
        return
    if indices.min(initial=0) < 0 or indices.max(initial=-1) >= dim:
        if ((indices < 0) | (indices >= dim)).any():
            raise ValueError("sparsevec index out of bounds")
    d = np.diff(indices)
    if (d < 0).any():
        raise ValueError("sparsevec indices must be in ascending order")
    if (d == 0).any():
        raise ValueError("sparsevec indices must not contain duplicates")


class SparseVec:
    """A sparse f32 vector: sorted unique 0-based int32 indices + values."""

    __slots__ = ("dim", "indices", "values")

    def __init__(self, dim: int, indices, values, _validate: bool = True):
        idx = np.asarray(indices, dtype=np.int32)
        val = np.asarray(values, dtype=np.float32)
        if idx.ndim != 1 or val.ndim != 1 or idx.shape[0] != val.shape[0]:
            raise ValueError("sparsevec indices/values must be 1-D and equal length")
        if _validate:
            check_dim(dim)
            check_nnz(idx.shape[0], dim)
            check_indices(idx, dim)
            if np.isnan(val).any():
                raise ValueError("NaN not allowed in sparsevec")
            if np.isinf(val).any():
                raise ValueError("infinite value not allowed in sparsevec")
        self.dim = int(dim)
        self.indices = idx
        self.values = val

    @property
    def nnz(self) -> int:
        return int(self.indices.shape[0])

    @classmethod
    def from_dense(cls, dense, dim: int | None = None) -> "SparseVec":
        """``vector``/array -> ``sparsevec`` cast (drops zeros)."""
        a = np.asarray(dense, dtype=np.float32)
        if a.ndim != 1:
            raise ValueError("array must be 1-D")
        d = a.shape[0] if dim is None else dim
        nz = np.nonzero(a)[0]
        check_nnz(nz.shape[0], d)
        return cls(d, nz.astype(np.int32), a[nz])

    def to_dense(self) -> np.ndarray:
        """``sparsevec`` -> ``vector`` cast. Errors if dim too large for dense."""
        from ..constants import VECTOR_MAX_DIM

        if self.dim > VECTOR_MAX_DIM:
            raise ValueError(
                f"vector cannot have more than {VECTOR_MAX_DIM} dimensions"
            )
        out = np.zeros(self.dim, dtype=np.float32)
        out[self.indices] = self.values
        return out

    def to_vector(self, typmod: int | None = None):
        """``sparsevec`` -> ``vector`` typed cast.

        Parity: sparsevec.rs sparsevec_to_vector (:663-695).
        """
        from .vector import Vector
        from .vector import check_expected_dim as _v_typmod

        _v_typmod(typmod, self.dim)
        return Vector(self.to_dense(), _validate=False)

    def to_halfvec(self, typmod: int | None = None):
        """``sparsevec`` -> ``halfvec`` cast. NOTE: the reference applies
        f32_to_half here WITHOUT the overflow check that vector->halfvec
        has (sparsevec.rs:700-731 vs halfvec.rs:661-666), so out-of-range
        values silently become +/-inf; mirrored faithfully.
        """
        from .halfvec import HalfVec
        from .halfvec import check_dim as _h_dim
        from .halfvec import check_expected_dim as _h_typmod

        _h_dim(self.dim)
        _h_typmod(typmod, self.dim)
        dense = np.zeros(self.dim, dtype=np.float32)
        dense[self.indices] = self.values
        with np.errstate(over="ignore"):
            h = dense.astype(np.float16)
        return HalfVec(h, _validate=False)

    def norm(self) -> float:
        a = self.values.astype(np.float64)
        return float(np.sqrt(np.sum(a * a)))

    def l2_normalize(self) -> "SparseVec":
        """Normalize; re-compact exact zeros. Parity: sparsevec.rs:1139-1173."""
        a = self.values.astype(np.float64)
        n = math.sqrt(float(np.sum(a * a)))
        if n <= 0.0:
            return SparseVec(self.dim, self.indices.copy(), self.values.copy(),
                             _validate=False)
        out = (a / n).astype(np.float32)
        if np.isinf(out).any():
            raise ValueError("value out of range: overflow")
        keep = out != 0.0
        return SparseVec(self.dim, self.indices[keep], out[keep], _validate=False)

    # -- text I/O -----------------------------------------------------------

    @classmethod
    def from_text(cls, text: str, typmod: int | None = None) -> "SparseVec":
        """Parse ``{i:v,...}/dim``. Parity: sparsevec_in, sparsevec.rs:217-424."""
        lit = text.encode("utf-8")

        def bad():
            raise ValueError(f'invalid input syntax for type sparsevec: "{text}"')

        max_nnz = lit.count(b",") + 1
        if max_nnz > SPARSEVEC_MAX_NNZ:
            raise ValueError(
                f"sparsevec cannot have more than {SPARSEVEC_MAX_NNZ} non-zero elements"
            )

        elements: list[tuple[int, np.float32]] = []
        pos = skip_space(lit, 0)
        if pos >= len(lit) or lit[pos : pos + 1] != b"{":
            bad()
        pos = skip_space(lit, pos + 1)
        if pos < len(lit) and lit[pos : pos + 1] == b"}":
            pos += 1
        else:
            while True:
                pos = skip_space(lit, pos)
                if pos >= len(lit):
                    bad()
                # index: optional sign + digits
                idx_start = pos
                if pos < len(lit) and lit[pos : pos + 1] in (b"-", b"+"):
                    pos += 1
                while pos < len(lit) and lit[pos : pos + 1].isdigit():
                    pos += 1
                if pos == idx_start or (
                    pos == idx_start + 1 and lit[idx_start : idx_start + 1] in (b"-", b"+")
                ):
                    bad()
                idx_str = lit[idx_start:pos].decode()
                try:
                    index = int(idx_str)
                except ValueError:
                    bad()
                # Clamp to i32 range like the reference (C strtol semantics).
                index = max(-(2**31) + 1, min(2**31 - 1, index))

                pos = skip_space(lit, pos)
                if pos >= len(lit) or lit[pos : pos + 1] != b":":
                    bad()
                pos = skip_space(lit, pos + 1)

                val_start = pos
                while pos < len(lit) and lit[pos] in b"0123456789.-+eEinfINFaA":
                    pos += 1
                val_str = lit[val_start:pos].decode("utf-8", "replace")
                if not val_str:
                    bad()
                value = parse_f32(val_str, bad)
                if math.isnan(float(value)):
                    raise ValueError("NaN not allowed in sparsevec")
                if math.isinf(float(value)):
                    raise ValueError("infinite value not allowed in sparsevec")

                # 1-based SQL -> 0-based storage; drop zeros (sparsevec.rs:339-346)
                if float(value) != 0.0:
                    elements.append((index - 1, value))

                pos = skip_space(lit, pos)
                if pos < len(lit) and lit[pos : pos + 1] == b",":
                    pos += 1
                elif pos < len(lit) and lit[pos : pos + 1] == b"}":
                    pos += 1
                    break
                else:
                    bad()

        pos = skip_space(lit, pos)
        if pos >= len(lit) or lit[pos : pos + 1] != b"/":
            bad()
        pos = skip_space(lit, pos + 1)
        dim_start = pos
        if pos < len(lit) and lit[pos : pos + 1] in (b"-", b"+"):
            pos += 1
        while pos < len(lit) and lit[pos : pos + 1].isdigit():
            pos += 1
        if pos == dim_start:
            bad()
        try:
            dim = int(lit[dim_start:pos].decode())
        except ValueError:
            bad()
        dim = max(-(2**31), min(2**31 - 1, dim))
        pos = skip_space(lit, pos)
        if pos != len(lit):
            bad()

        check_dim(dim)
        check_expected_dim(typmod, dim)

        elements.sort(key=lambda e: e[0])
        indices = np.array([e[0] for e in elements], dtype=np.int64)
        values = np.array([e[1] for e in elements], dtype=np.float32)
        check_indices(indices, dim)
        return cls(dim, indices.astype(np.int32), values, _validate=False)

    def to_text(self) -> str:
        """Format ``{i:v,...}/dim`` (1-based). Parity: sparsevec_out."""
        parts = [
            f"{int(i) + 1}:{format_f32(v)}"
            for i, v in zip(self.indices, self.values)
        ]
        return "{" + ",".join(parts) + "}/" + str(self.dim)

    # -- binary I/O ----------------------------------------------------------

    def to_binary(self) -> bytes:
        """int32 dim, int32 nnz, int32 unused, indices, values (big-endian)."""
        head = struct.pack(">iii", self.dim, self.nnz, 0)
        idx = self.indices.astype(">i4").tobytes()
        val = self.values.astype(">f4").tobytes()
        return head + idx + val

    @classmethod
    def from_binary(cls, buf: bytes, typmod: int | None = None) -> "SparseVec":
        dim, nnz, unused = struct.unpack_from(">iii", buf, 0)
        check_dim(dim)
        check_nnz(nnz, dim)
        check_expected_dim(typmod, dim)
        if unused != 0:
            raise ValueError(f"expected unused to be 0, not {unused}")
        indices = np.frombuffer(buf, dtype=">i4", count=nnz, offset=12).astype(np.int32)
        values = np.frombuffer(buf, dtype=">f4", count=nnz, offset=12 + 4 * nnz).astype(
            np.float32
        )
        check_indices(indices, dim)
        if np.isnan(values).any():
            raise ValueError("NaN not allowed in sparsevec")
        if np.isinf(values).any():
            raise ValueError("infinite value not allowed in sparsevec")
        if (values == 0.0).any():
            raise ValueError("binary representation of sparsevec cannot contain zero values")
        return cls(dim, indices, values, _validate=False)

    # -- comparison (btree opclass; sparsevec.rs:1203-1297) ------------------

    def compare(self, other: "SparseVec") -> int:
        a_idx, b_idx = self.indices, other.indices
        a_val, b_val = self.values, other.values
        n = min(self.nnz, other.nnz)
        for i in range(n):
            if a_idx[i] < b_idx[i]:
                return -1 if a_val[i] < 0.0 else 1
            if a_idx[i] > b_idx[i]:
                return 1 if b_val[i] < 0.0 else -1
            if a_val[i] < b_val[i]:
                return -1
            if a_val[i] > b_val[i]:
                return 1
        if self.nnz < other.nnz and b_idx[n] < self.dim:
            return 1 if b_val[n] < 0.0 else -1
        if self.nnz > other.nnz and a_idx[n] < other.dim:
            return -1 if a_val[n] < 0.0 else 1
        return (self.dim > other.dim) - (self.dim < other.dim)

    def __eq__(self, other) -> bool:
        return isinstance(other, SparseVec) and self.compare(other) == 0

    def __lt__(self, other) -> bool:
        return self.compare(other) < 0

    def __le__(self, other) -> bool:
        return self.compare(other) <= 0

    def __repr__(self) -> str:
        return f"SparseVec({self.to_text()})"


# ---------------------------------------------------------------------------
# Scalar-pair distances: sequential f32 accumulation in merged-index order,
# matching the reference's merge-join kernels (sparsevec.rs:875-1090).
# ---------------------------------------------------------------------------


def _merge_iter(a: SparseVec, b: SparseVec):
    """Yield (a_val, b_val) f32 pairs over the union of indices, in order."""
    i = j = 0
    an, bn = a.nnz, b.nnz
    while i < an or j < bn:
        ai = a.indices[i] if i < an else None
        bj = b.indices[j] if j < bn else None
        if bj is None or (ai is not None and ai < bj):
            yield np.float32(a.values[i]), np.float32(0.0)
            i += 1
        elif ai is None or bj < ai:
            yield np.float32(0.0), np.float32(b.values[j])
            j += 1
        else:
            yield np.float32(a.values[i]), np.float32(b.values[j])
            i += 1
            j += 1


def l2_squared_distance(a: SparseVec, b: SparseVec) -> float:
    if a.dim != b.dim:
        raise ValueError(f"different sparsevec dimensions {a.dim} and {b.dim}")
    acc = np.float32(0.0)
    for av, bv in _merge_iter(a, b):
        d = np.float32(av - bv)
        acc = np.float32(acc + d * d)
    return float(acc)


def l2_distance(a: SparseVec, b: SparseVec) -> float:
    return math.sqrt(l2_squared_distance(a, b))


def inner_product(a: SparseVec, b: SparseVec) -> float:
    if a.dim != b.dim:
        raise ValueError(f"different sparsevec dimensions {a.dim} and {b.dim}")
    acc = np.float32(0.0)
    for av, bv in _merge_iter(a, b):
        acc = np.float32(acc + av * bv)
    return float(acc)


def negative_inner_product(a: SparseVec, b: SparseVec) -> float:
    return -inner_product(a, b)


def cosine_distance(a: SparseVec, b: SparseVec) -> float:
    """Parity: sparsevec.rs:1008-1037 (f32 accumulate, f64 divide, clamp)."""
    if a.dim != b.dim:
        raise ValueError(f"different sparsevec dimensions {a.dim} and {b.dim}")
    sim = np.float32(0.0)
    for av, bv in _merge_iter(a, b):
        sim = np.float32(sim + av * bv)
    norma = np.float32(np.sum(a.values * a.values, dtype=np.float32))
    normb = np.float32(np.sum(b.values * b.values, dtype=np.float32))
    similarity = float(sim) / math.sqrt(float(norma) * float(normb))
    return 1.0 - min(1.0, max(-1.0, similarity))


def l1_distance(a: SparseVec, b: SparseVec) -> float:
    """Parity: sparsevec.rs:1043-1090."""
    if a.dim != b.dim:
        raise ValueError(f"different sparsevec dimensions {a.dim} and {b.dim}")
    acc = np.float32(0.0)
    for av, bv in _merge_iter(a, b):
        acc = np.float32(acc + np.float32(abs(np.float32(av - bv))))
    return float(acc)
