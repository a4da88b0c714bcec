"""The ``halfvec`` (f16 storage) type.

Parity source: reference ``src/types/halfvec.rs`` (pgvector-rx). The
reference hand-writes IEEE-754 half<->float conversion with
round-to-nearest-even and denormal handling (halfvec.rs:54-143); numpy's
``float16`` implements exactly those semantics, so we use it directly and
pin the behavior with round-trip tests (mirroring halfvec.rs:1083-1113).
All arithmetic happens in f32 (halfvec.rs:687-733). Values that overflow
f16 on input raise (halfvec.rs:372-376); computed overflow (e.g. in
normalize) raises "value out of range: overflow" (halfvec.rs:225-231).

On TPU the natural compute dtype for halfvec columns is bfloat16/f32 with
f16 as the storage dtype; the index stores ``jnp.float16`` arrays and
upcasts at distance time.
"""

from __future__ import annotations

import math
import struct

import numpy as np

from ..constants import HALFVEC_MAX_DIM
from ._common import format_f32_list, parse_f32, skip_space


def check_dim(dim: int) -> None:
    if dim < 1:
        raise ValueError("halfvec must have at least 1 dimension")
    if dim > HALFVEC_MAX_DIM:
        raise ValueError(f"halfvec cannot have more than {HALFVEC_MAX_DIM} dimensions")


def check_expected_dim(typmod: int | None, dim: int) -> None:
    if typmod is not None and typmod != -1 and typmod != dim:
        raise ValueError(f"expected {typmod} dimensions, not {dim}")


def check_element(value: np.float16) -> None:
    """Parity: halfvec.rs:174-181."""
    if np.isnan(value):
        raise ValueError("NaN not allowed in halfvec")
    if np.isinf(value):
        raise ValueError("infinite value not allowed in halfvec")


def f32_to_f16_checked(value: float, in_range_message: bool = True) -> np.float16:
    """Convert f32 -> f16 (RNE), raising on overflow-to-inf.

    Parity: halfvec.rs:92-143 conversion + :372-376 input range check.
    """
    h = np.float16(value)
    if np.isinf(h) and not math.isinf(value):
        if in_range_message:
            raise ValueError(f'"{value}" is out of range for type halfvec')
        raise ValueError("value out of range: overflow")
    return h


class HalfVec:
    """An f16 vector value."""

    __slots__ = ("data",)

    def __init__(self, data, _validate: bool = True):
        if isinstance(data, np.ndarray) and data.dtype == np.float16:
            arr = data
        else:
            src = np.asarray(data, dtype=np.float64)
            with np.errstate(over="ignore"):
                arr = src.astype(np.float16)
            if _validate:
                bad = np.isinf(arr) & ~np.isinf(src)
                if bad.any():
                    i = int(np.argmax(bad))
                    raise ValueError(f'"{src[i]}" is out of range for type halfvec')
        if arr.ndim != 1:
            raise ValueError("array must be 1-D")
        if _validate:
            check_dim(arr.shape[0])
            if np.isnan(arr).any():
                raise ValueError("NaN not allowed in halfvec")
            if np.isinf(arr).any():
                raise ValueError("infinite value not allowed in halfvec")
        self.data = arr

    @property
    def dim(self) -> int:
        return int(self.data.shape[0])

    def dims(self) -> int:
        return self.dim

    def norm(self) -> float:
        a = self.data.astype(np.float64)
        return float(np.sqrt(np.sum(a * a)))

    def l2_normalize(self) -> "HalfVec":
        """Parity: halfvec.rs normalize with overflow check (:225-231)."""
        a = self.data.astype(np.float64)
        n = math.sqrt(float(np.sum(a * a)))
        if n > 0.0:
            scaled = a / n
            out = scaled.astype(np.float16)
            if (np.isinf(out) & ~np.isinf(scaled)).any():
                raise ValueError("value out of range: overflow")
        else:
            out = np.zeros_like(self.data)
        return HalfVec(out, _validate=False)

    # -- text I/O -----------------------------------------------------------

    @classmethod
    def from_text(cls, text: str, typmod: int | None = None) -> "HalfVec":
        """Parse ``[1,2,3]``. Parity: halfvec.rs:283-380 (same grammar as vector)."""
        lit = text.encode("utf-8")

        def bad():
            raise ValueError(f'invalid input syntax for type halfvec: "{text}"')

        pos = skip_space(lit, 0)
        if pos >= len(lit) or lit[pos : pos + 1] != b"[":
            bad()
        pos = skip_space(lit, pos + 1)
        if pos < len(lit) and lit[pos : pos + 1] == b"]":
            raise ValueError("halfvec must have at least 1 dimension")

        values: list[np.float16] = []
        while True:
            if len(values) >= HALFVEC_MAX_DIM:
                raise ValueError(
                    f"halfvec cannot have more than {HALFVEC_MAX_DIM} dimensions"
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
            fval = parse_f32(lit[start:pos].decode("utf-8", "replace"), bad)
            if math.isnan(float(fval)):
                raise ValueError("NaN not allowed in halfvec")
            if math.isinf(float(fval)):
                raise ValueError("infinite value not allowed in halfvec")
            with np.errstate(over="ignore"):
                h = np.float16(fval)
            if np.isinf(h):
                raise ValueError(
                    f'"{lit[start:pos].decode("utf-8", "replace")}" is out of range for type halfvec'
                )
            values.append(h)
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
        return cls(np.array(values, dtype=np.float16), _validate=False)

    def to_text(self) -> str:
        return "[" + format_f32_list(self.data.astype(np.float32)) + "]"

    # -- binary I/O ----------------------------------------------------------

    def to_binary(self) -> bytes:
        """int16 dim, int16 unused, big-endian f16s. Parity: halfvec_send."""
        payload = self.data.astype(">f2").tobytes()
        return struct.pack(">hh", self.dim, 0) + payload

    @classmethod
    def from_binary(cls, buf: bytes, typmod: int | None = None) -> "HalfVec":
        dim, unused = struct.unpack_from(">hh", buf, 0)
        check_dim(dim)
        check_expected_dim(typmod, dim)
        if unused != 0:
            raise ValueError(f"expected unused to be 0, not {unused}")
        arr = np.frombuffer(buf, dtype=">f2", count=dim, offset=4).astype(np.float16)
        for v in arr:
            check_element(v)
        return cls(arr, _validate=False)

    # -- casts ---------------------------------------------------------------

    @classmethod
    def from_array(cls, arr, typmod: int | None = None) -> "HalfVec":
        a = np.asarray(arr)
        if a.ndim != 1:
            raise ValueError("array must be 1-D")
        if a.dtype == object and any(x is None for x in arr):
            raise ValueError("array must not contain nulls")
        check_dim(a.shape[0])
        check_expected_dim(typmod, a.shape[0])
        return cls(a, _validate=True)

    def to_vector(self, typmod: int | None = None):
        """``halfvec`` -> ``vector`` widening cast.

        Parity: halfvec.rs halfvec_to_vector (:617-639).
        """
        from .vector import Vector
        from .vector import check_expected_dim as _v_typmod

        _v_typmod(typmod, self.dim)
        return Vector(self.data.astype(np.float32), _validate=False)

    def to_sparsevec(self, typmod: int | None = None):
        """``halfvec`` -> ``sparsevec`` cast: widen to f32, drop zeros.

        Parity: sparsevec.rs halfvec_to_sparsevec (:624-658).
        """
        from .sparsevec import SparseVec
        from .sparsevec import check_expected_dim as _sv_typmod

        _sv_typmod(typmod, self.dim)
        return SparseVec.from_dense(self.data.astype(np.float32))

    def cast(self, typmod: int) -> "HalfVec":
        check_expected_dim(typmod, self.dim)
        return self

    def __repr__(self) -> str:
        return f"HalfVec({self.to_text()})"

    def __eq__(self, other) -> bool:
        return isinstance(other, HalfVec) and np.array_equal(self.data, other.data)

    def __len__(self) -> int:
        return self.dim


# ---------------------------------------------------------------------------
# Scalar-pair distances: upcast f16 -> f32, then vector formulas
# (parity: halfvec.rs:687-733)
# ---------------------------------------------------------------------------


def _as_pair(a, b) -> tuple[np.ndarray, np.ndarray]:
    ax = a.data if isinstance(a, HalfVec) else np.asarray(a, dtype=np.float16)
    bx = b.data if isinstance(b, HalfVec) else np.asarray(b, dtype=np.float16)
    if ax.shape[0] != bx.shape[0]:
        raise ValueError(
            f"different halfvec dimensions {ax.shape[0]} and {bx.shape[0]}"
        )
    return ax.astype(np.float32), bx.astype(np.float32)


def l2_squared_distance(a, b) -> float:
    ax, bx = _as_pair(a, b)
    d = ax - bx
    return float(np.float32(np.sum(d * d, dtype=np.float32)))


def l2_distance(a, b) -> float:
    return math.sqrt(l2_squared_distance(a, b))


def inner_product(a, b) -> float:
    ax, bx = _as_pair(a, b)
    return float(np.float32(np.sum(ax * bx, dtype=np.float32)))


def negative_inner_product(a, b) -> float:
    return -inner_product(a, b)


def cosine_distance(a, b) -> float:
    ax, bx = _as_pair(a, b)
    sim = np.float32(np.sum(ax * bx, dtype=np.float32))
    norma = np.float32(np.sum(ax * ax, dtype=np.float32))
    normb = np.float32(np.sum(bx * bx, dtype=np.float32))
    similarity = float(sim) / math.sqrt(float(norma) * float(normb))
    return 1.0 - min(1.0, max(-1.0, similarity))


def l1_distance(a, b) -> float:
    ax, bx = _as_pair(a, b)
    return float(np.float32(np.sum(np.abs(ax - bx), dtype=np.float32)))
