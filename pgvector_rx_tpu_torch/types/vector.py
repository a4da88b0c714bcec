"""The ``vector`` (f32) type: text/binary I/O, casts, distances.

Parity source: reference ``src/types/vector.rs`` (pgvector-rx). Behavior
mirrored: text grammar ``[1,2,3]`` (vector.rs:172-260), shortest-float
output (vector.rs:267-300), binary send/recv layout (vector.rs:327-392),
element validation — NaN/Inf rejected (vector.rs:77-84), dim caps
(vector.rs:30,:62-65), array casts (vector.rs:398-460), distance functions
(vector.rs:518-567) including cosine's f32-accumulate / f64-divide /
clamp-to-[-1,1] discipline (vector.rs:541-556,:645).

Host (numpy) scalar-pair functions live here for SQL-function parity;
batched device distances are in :mod:`pgvector_rx_tpu_torch.ops.distances`.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..constants import VECTOR_MAX_DIM
from ._common import format_f32_list, parse_f32, skip_space


def check_dim(dim: int) -> None:
    """Parity: vector.rs:60-66."""
    if dim < 1:
        raise ValueError("vector must have at least 1 dimension")
    if dim > VECTOR_MAX_DIM:
        raise ValueError(f"vector cannot have more than {VECTOR_MAX_DIM} dimensions")


def check_expected_dim(typmod: int | None, dim: int) -> None:
    """Parity: vector.rs:69-73."""
    if typmod is not None and typmod != -1 and typmod != dim:
        raise ValueError(f"expected {typmod} dimensions, not {dim}")


def check_element(value: float) -> None:
    """Parity: vector.rs:77-84."""
    if math.isnan(value):
        raise ValueError("NaN not allowed in vector")
    if math.isinf(value):
        raise ValueError("infinite value not allowed in vector")


class Vector:
    """An f32 vector value (varlena analog: dim + f32 data)."""

    __slots__ = ("data",)

    def __init__(self, data, _validate: bool = True):
        arr = np.asarray(data, dtype=np.float32)
        if arr.ndim != 1:
            raise ValueError("array must be 1-D")
        if _validate:
            check_dim(arr.shape[0])
            if np.isnan(arr).any():
                raise ValueError("NaN not allowed in vector")
            if np.isinf(arr).any():
                raise ValueError("infinite value not allowed in vector")
        self.data = arr

    # -- properties ---------------------------------------------------------

    @property
    def dim(self) -> int:
        return int(self.data.shape[0])

    def dims(self) -> int:
        """SQL ``vector_dims``. Parity: vector.rs:664-669."""
        return self.dim

    def norm(self) -> float:
        """SQL ``vector_norm``: f64 accumulation. Parity: vector.rs:672-685."""
        a = self.data.astype(np.float64)
        return float(np.sqrt(np.sum(a * a)))

    def l2_normalize(self) -> "Vector":
        """SQL ``l2_normalize``: zero vector stays zero. Parity: vector.rs:688-711."""
        a = self.data.astype(np.float64)
        n = math.sqrt(float(np.sum(a * a)))
        if n > 0.0:
            out = (a / n).astype(np.float32)
        else:
            out = np.zeros_like(self.data)
        return Vector(out, _validate=False)

    # -- text I/O -----------------------------------------------------------

    @classmethod
    def from_text(cls, text: str, typmod: int | None = None) -> "Vector":
        """Parse ``[1,2,3]``. Parity: vector_in, vector.rs:172-264."""
        lit = text.encode("utf-8")

        def bad():
            raise ValueError(f'invalid input syntax for type vector: "{text}"')

        pos = skip_space(lit, 0)
        if pos >= len(lit) or lit[pos : pos + 1] != b"[":
            bad()
        pos = skip_space(lit, pos + 1)
        if pos < len(lit) and lit[pos : pos + 1] == b"]":
            raise ValueError("vector must have at least 1 dimension")

        values: list[np.float32] = []
        while True:
            if len(values) >= VECTOR_MAX_DIM:
                raise ValueError(
                    f"vector cannot have more than {VECTOR_MAX_DIM} dimensions"
                )
            pos = skip_space(lit, pos)
            if pos >= len(lit):
                bad()
            start = pos
            while (
                pos < len(lit)
                and lit[pos : pos + 1] not in (b",", b"]")
                and lit[pos] not in b" \t\n\r\v\f"
            ):
                pos += 1
            val = parse_f32(lit[start:pos].decode("utf-8", "replace"), bad)
            check_element(float(val))
            values.append(val)
            pos = skip_space(lit, pos)
            if pos < len(lit) and lit[pos : pos + 1] == b",":
                pos += 1
            elif pos < len(lit) and lit[pos : pos + 1] == b"]":
                pos += 1
                break
            else:
                bad()

        pos = skip_space(lit, pos)
        if pos < len(lit):
            bad()

        dim = len(values)
        check_dim(dim)
        check_expected_dim(typmod, dim)
        return cls(np.array(values, dtype=np.float32), _validate=False)

    def to_text(self) -> str:
        """Format ``[1,2,3]``. Parity: vector_out, vector.rs:267-300."""
        return "[" + format_f32_list(self.data) + "]"

    # -- binary I/O (PG wire format) ----------------------------------------

    def to_binary(self) -> bytes:
        """``vector_send``: int16 dim, int16 unused, big-endian f32s.

        Parity: vector.rs:355-372.
        """
        return struct.pack(f">hh{self.dim}f", self.dim, 0, *self.data.tolist())

    @classmethod
    def from_binary(cls, buf: bytes, typmod: int | None = None) -> "Vector":
        """``vector_recv``. Parity: vector.rs:327-352."""
        dim, unused = struct.unpack_from(">hh", buf, 0)
        check_dim(dim)
        check_expected_dim(typmod, dim)
        if unused != 0:
            raise ValueError(f"expected unused to be 0, not {unused}")
        values = struct.unpack_from(f">{dim}f", buf, 4)
        for v in values:
            check_element(v)
        return cls(np.array(values, dtype=np.float32), _validate=False)

    # -- casts ---------------------------------------------------------------

    @classmethod
    def from_array(cls, arr, typmod: int | None = None) -> "Vector":
        """``array_to_vector``. Parity: vector.rs:398-460."""
        a = np.asarray(arr)
        if a.ndim != 1:
            raise ValueError("array must be 1-D")
        if a.dtype == object and any(x is None for x in arr):
            raise ValueError("array must not contain nulls")
        a = a.astype(np.float32)
        check_dim(a.shape[0])
        check_expected_dim(typmod, a.shape[0])
        v = cls(a, _validate=True)
        return v

    def to_float4_array(self) -> np.ndarray:
        """``vector_to_float4``. Parity: vector.rs:465-487."""
        return self.data.copy()

    @classmethod
    def from_numeric_array(cls, arr, typmod: int | None = None) -> "Vector":
        """``numeric[] -> vector`` cast: arbitrary-precision decimals
        (Python ``decimal.Decimal`` / ``int`` / ``Fraction``) convert
        through float with NaN/Inf rejection, like every element cast.
        Parity: vector.rs:398-460 (the numeric[] registration of
        array_to_vector; elements go through CheckElement).
        """
        vals = []
        for x in arr:
            if x is None:
                raise ValueError("array must not contain nulls")
            v = float(x)
            check_element(v)
            vals.append(v)
        a = np.asarray(vals, dtype=np.float32)
        check_dim(a.shape[0])
        check_expected_dim(typmod, a.shape[0])
        return cls(a, _validate=True)

    def to_numeric_array(self) -> list:
        """``vector -> numeric[]`` cast: exact decimal rendering of the
        stored f32 values (shortest-roundtrip text, like vector_out's
        element rendering). Parity: the numeric[] leg of the cast
        family, vector.rs:398 region."""
        from decimal import Decimal

        from ._common import format_f32

        return [Decimal(format_f32(v)) for v in self.data]

    def cast(self, typmod: int) -> "Vector":
        """``vector`` -> ``vector(N)`` cast. Parity: vector_cast."""
        check_expected_dim(typmod, self.dim)
        return self

    def to_halfvec(self, typmod: int | None = None):
        """``vector`` -> ``halfvec`` cast: RNE rounding; a finite value
        that overflows f16 to inf errors. Parity: halfvec.rs
        vector_to_halfvec (:644-672).
        """
        from .halfvec import HalfVec
        from .halfvec import check_expected_dim as _hv_typmod

        _hv_typmod(typmod, self.dim)
        return HalfVec(self.data)

    def to_sparsevec(self, typmod: int | None = None):
        """``vector`` -> ``sparsevec`` cast: exact zeros drop out.

        Parity: sparsevec.rs vector_to_sparsevec (:585-619).
        """
        from .sparsevec import SparseVec
        from .sparsevec import check_expected_dim as _sv_typmod

        _sv_typmod(typmod, self.dim)
        return SparseVec.from_dense(self.data)

    # -- dunder --------------------------------------------------------------

    def __repr__(self) -> str:
        return f"Vector({self.to_text()})"

    def __eq__(self, other) -> bool:
        return isinstance(other, Vector) and np.array_equal(self.data, other.data)

    def __len__(self) -> int:
        return self.dim


# ---------------------------------------------------------------------------
# Scalar-pair distance functions (SQL function parity; vector.rs:518-567)
# ---------------------------------------------------------------------------


def _as_pair(a, b) -> tuple[np.ndarray, np.ndarray]:
    ax = a.data if isinstance(a, Vector) else np.asarray(a, dtype=np.float32)
    bx = b.data if isinstance(b, Vector) else np.asarray(b, dtype=np.float32)
    if ax.shape[0] != bx.shape[0]:
        raise ValueError(f"different vector dimensions {ax.shape[0]} and {bx.shape[0]}")
    return ax, bx


def l2_squared_distance(a, b) -> float:
    """f32 accumulation, f64 result. Parity: vector.rs:517-526,:597-608."""
    ax, bx = _as_pair(a, b)
    d = ax - bx
    return float(np.float32(np.sum(d * d, dtype=np.float32)))


def l2_distance(a, b) -> float:
    """sqrt in f64 of f32 sum. Parity: vector.rs:584-594."""
    return math.sqrt(l2_squared_distance(a, b))


def inner_product(a, b) -> float:
    """Parity: vector.rs:528-536,:611-620."""
    ax, bx = _as_pair(a, b)
    return float(np.float32(np.sum(ax * bx, dtype=np.float32)))


def negative_inner_product(a, b) -> float:
    """HNSW IP opclass distance. Parity: vector.rs:623-635."""
    return -inner_product(a, b)


def cosine_distance(a, b) -> float:
    """1 - clamp(similarity). f32 accumulate, f64 divide.

    Parity: vector.rs:539-556,:638-651.
    """
    ax, bx = _as_pair(a, b)
    sim = np.float32(np.sum(ax * bx, dtype=np.float32))
    norma = np.float32(np.sum(ax * ax, dtype=np.float32))
    normb = np.float32(np.sum(bx * bx, dtype=np.float32))
    similarity = float(sim) / math.sqrt(float(norma) * float(normb))
    return 1.0 - min(1.0, max(-1.0, similarity))


def l1_distance(a, b) -> float:
    """Parity: vector.rs:558-566,:654-661."""
    ax, bx = _as_pair(a, b)
    return float(np.float32(np.sum(np.abs(ax - bx), dtype=np.float32)))
