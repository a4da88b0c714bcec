"""Bit-vector support: PostgreSQL ``bit(n)`` analog with packed storage.

Parity source: reference ``src/types/bitvec.rs`` (pgvector-rx).
Behavior mirrored: Hamming distance = popcount(XOR) (bitvec.rs:97-106),
Jaccard distance = 1 - |A∩B| / |A∪B| with the |A∩B|=0 -> 1.0 edge case
(bitvec.rs:113-132), bit-length equality check (bitvec.rs:83-91), and the
HNSW cap of 64000 bits = HNSW_MAX_DIM * 32 (bitvec.rs:180-187).

Storage here is packed ``uint8`` MSB-first (the same byte layout as
PostgreSQL varbit), padded with zero bits. The device sweeps pack further
into 32-bit words (int32 tensors with the bits of the words), which the
bit sweep K9 either counts with population counts or unpacks to {0,1}
bytes for the int8 tensor cores — see :mod:`pgvector_rx_tpu_torch.ops.bits`.
"""

from __future__ import annotations

import numpy as np


class BitVec:
    """A fixed-length bit string, packed MSB-first into uint8 bytes."""

    __slots__ = ("nbits", "data")

    def __init__(self, nbits: int, data: np.ndarray):
        if nbits < 1:
            raise ValueError("bit string length must be at least 1")
        expect = (nbits + 7) // 8
        arr = np.asarray(data, dtype=np.uint8)
        if arr.shape != (expect,):
            raise ValueError(f"expected {expect} bytes for {nbits} bits")
        # Zero any padding bits past nbits (PG keeps them zeroed).
        pad = expect * 8 - nbits
        if pad:
            arr = arr.copy()
            arr[-1] &= np.uint8((0xFF << pad) & 0xFF)
        self.nbits = int(nbits)
        self.data = arr

    @classmethod
    def from_text(cls, text: str) -> "BitVec":
        """Parse a bit string like ``"10101"`` (PG bit literal body)."""
        if not text or any(c not in "01" for c in text):
            raise ValueError(f'"{text}" is not a valid binary digit string')
        bits = np.frombuffer(text.encode(), dtype=np.uint8) - ord("0")
        return cls.from_bits(bits)

    @classmethod
    def from_bits(cls, bits) -> "BitVec":
        """Build from a 0/1 array (unpacked)."""
        b = np.asarray(bits, dtype=np.uint8)
        if b.ndim != 1:
            raise ValueError("bits must be 1-D")
        packed = np.packbits(b)  # MSB-first, zero-padded — varbit layout
        return cls(b.shape[0], packed)

    def to_bits(self) -> np.ndarray:
        return np.unpackbits(self.data)[: self.nbits]

    def to_text(self) -> str:
        return "".join("1" if b else "0" for b in self.to_bits())

    def __len__(self) -> int:
        return self.nbits

    def __repr__(self) -> str:
        return f"BitVec({self.to_text()})"

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, BitVec)
            and self.nbits == other.nbits
            and np.array_equal(self.data, other.data)
        )


def _as_pair(a, b) -> tuple[np.ndarray, np.ndarray]:
    if isinstance(a, BitVec) and isinstance(b, BitVec):
        if a.nbits != b.nbits:
            raise ValueError(f"different bit lengths {a.nbits} and {b.nbits}")
        return a.data, b.data
    av = a if isinstance(a, BitVec) else BitVec.from_bits(a)
    bv = b if isinstance(b, BitVec) else BitVec.from_bits(b)
    return _as_pair(av, bv)


_POPCOUNT = np.unpackbits(np.arange(256, dtype=np.uint8)[:, None], axis=1).sum(1)


def hamming_distance(a, b) -> float:
    """popcount(a XOR b). Parity: bitvec.rs:97-106,:145-158."""
    ax, bx = _as_pair(a, b)
    return float(_POPCOUNT[ax ^ bx].sum())


def jaccard_distance(a, b) -> float:
    """1 - |A∩B|/|A∪B|; 1.0 when intersection empty. Parity: bitvec.rs:113-132."""
    ax, bx = _as_pair(a, b)
    ab = int(_POPCOUNT[ax & bx].sum())
    if ab == 0:
        return 1.0
    aa = int(_POPCOUNT[ax].sum())
    bb = int(_POPCOUNT[bx].sum())
    return 1.0 - ab / (aa + bb - ab)
