"""Vector data types: ``vector`` (f32), ``halfvec`` (f16), ``sparsevec``,
and ``bit`` — the TPU-native analog of reference ``src/types/``.
"""

from . import bitvec, halfvec, sparsevec, vector
from .bitvec import BitVec
from .halfvec import HalfVec
from .sparsevec import SparseVec
from .vector import Vector

__all__ = [
    "Vector",
    "HalfVec",
    "SparseVec",
    "BitVec",
    "vector",
    "halfvec",
    "sparsevec",
    "bitvec",
]
