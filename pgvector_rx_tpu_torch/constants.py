"""HNSW constants for the TPU-native index.

Parity source: reference ``src/hnsw_constants.rs:4-134`` (pgvector-rx).
All user-visible parameters, ranges, and derived formulas match the
reference (which itself matches pgvector C) so that recall/behavior tests
transfer 1:1.
"""

import math

# --- Dimension caps (reference hnsw_constants.rs:4-7, types/*.rs) ---

#: Max dims for a `vector` (f32) column in an HNSW index (hnsw_constants.rs:4).
HNSW_MAX_DIM = 2000
#: Max non-zeros for `sparsevec` in an HNSW index (hnsw_constants.rs:7).
HNSW_MAX_NNZ = 1000
#: Max dims of the `vector` type itself (types/vector.rs:30).
VECTOR_MAX_DIM = 16000
#: Max dims of the `halfvec` type (types/halfvec.rs).
HALFVEC_MAX_DIM = 16000
#: Max dims for halfvec in HNSW = HNSW_MAX_DIM * 2 (types/halfvec.rs:876).
HNSW_MAX_DIM_HALFVEC = HNSW_MAX_DIM * 2
#: Max bits for `bit` in HNSW = HNSW_MAX_DIM * 32 (types/bitvec.rs:180-187).
HNSW_MAX_DIM_BIT = HNSW_MAX_DIM * 32
#: Max dimension value of a sparsevec (types/sparsevec.rs:29).
SPARSEVEC_MAX_DIM = 1_000_000_000
#: Max stored non-zeros of a sparsevec (types/sparsevec.rs:32).
SPARSEVEC_MAX_NNZ = 16000

# --- Versioning (hnsw_constants.rs:20-29) ---

HNSW_VERSION = 1
HNSW_MAGIC_NUMBER = 0xA953A953
HNSW_PAGE_ID = 0xFF90

# --- HNSW parameters (hnsw_constants.rs:47-74) ---

HNSW_DEFAULT_M = 16
HNSW_MIN_M = 2
HNSW_MAX_M = 100

HNSW_DEFAULT_EF_CONSTRUCTION = 64
HNSW_MIN_EF_CONSTRUCTION = 4
HNSW_MAX_EF_CONSTRUCTION = 1000

HNSW_DEFAULT_EF_SEARCH = 40
HNSW_MIN_EF_SEARCH = 1
HNSW_MAX_EF_SEARCH = 1000

#: Heap TIDs (payload ids) stored per element for duplicate handling
#: (hnsw_constants.rs:85).
HNSW_HEAPTIDS = 10

# --- Entry point update modes (hnsw_constants.rs:87-93) ---

HNSW_UPDATE_ENTRY_GREATER = 1
HNSW_UPDATE_ENTRY_ALWAYS = 2

# --- Iterative scan modes (hnsw_constants.rs:95-112) ---

HNSW_ITERATIVE_SCAN_OFF = "off"
HNSW_ITERATIVE_SCAN_RELAXED = "relaxed_order"
HNSW_ITERATIVE_SCAN_STRICT = "strict_order"

HNSW_DEFAULT_MAX_SCAN_TUPLES = 20000
HNSW_DEFAULT_SCAN_MEM_MULTIPLIER = 1.0

# --- Tuple versioning (vacuum reuse detection; types/hnsw.rs, vacuum.rs) ---

#: Version wraps 15 -> 1 (vacuum.rs:797-803); 4-bit field on disk.
HNSW_MAX_VERSION = 15


def hnsw_get_layer_m(m: int, layer: int) -> int:
    """Connections for a layer: 2*M at layer 0, M above.

    Parity: hnsw_constants.rs:122-128.
    """
    return m * 2 if layer == 0 else m


def hnsw_get_ml(m: int) -> float:
    """Level-assignment multiplier mL = 1/ln(M). Parity: hnsw_constants.rs:132-134."""
    return 1.0 / math.log(m)


# PostgreSQL page geometry: informational size math reproduced from the
# reference's on-disk format (types/hnsw.rs). The TPU index stores the
# graph as flat device arrays, not 8KB pages, but the formulas below
# govern the reference's element-size limits and level cap, and the
# level cap is behavior-visible (it bounds random levels at build).
BLCKSZ = 8192
_PAGE_HEADER_SIZE = 24
_PAGE_OPAQUE_SIZE = 8  # HnswPageOpaqueData: nextblkno + page_id + padding
_ITEM_ID_SIZE = 4
_NEIGHBOR_TUPLE_HEADER = 4  # type u8 + version u8 + count u16
_ITEM_POINTER_SIZE = 6
#: HnswElementTupleData fixed header: type/level/deleted/version (4 x u8)
#: + 10 heap TIDs (6B each) + neighbortid (6B) + unused u16
#: (types/hnsw.rs:112-128).
_ELEMENT_TUPLE_HEADER = 4 + HNSW_HEAPTIDS * _ITEM_POINTER_SIZE + 6 + 2


def maxalign(x: int) -> int:
    """8-byte alignment, parity with types/hnsw.rs maxalign()."""
    return (x + 7) & ~7


_maxalign = maxalign


def hnsw_element_tuple_size(data_size: int) -> int:
    """On-disk element tuple size for a `data_size`-byte varlena value.

    Parity: types/hnsw.rs hnsw_element_tuple_size()
    (C's HNSW_ELEMENT_TUPLE_SIZE).
    """
    return maxalign(_ELEMENT_TUPLE_HEADER + data_size)


def hnsw_neighbor_tuple_size(level: int, m: int) -> int:
    """On-disk neighbor tuple size: header + (level+2)*m item pointers.

    Parity: types/hnsw.rs hnsw_neighbor_tuple_size()
    (C's HNSW_NEIGHBOR_TUPLE_SIZE).
    """
    return maxalign(
        _NEIGHBOR_TUPLE_HEADER + (level + 2) * m * _ITEM_POINTER_SIZE
    )


def hnsw_max_size() -> int:
    """Max usable space on one HNSW page (C's HNSW_MAX_SIZE).

    Parity: types/hnsw.rs hnsw_max_size():
    BLCKSZ - MAXALIGN(page header) - MAXALIGN(opaque) - sizeof(ItemId).
    """
    return (
        BLCKSZ
        - maxalign(_PAGE_HEADER_SIZE)
        - maxalign(_PAGE_OPAQUE_SIZE)
        - _ITEM_ID_SIZE
    )


def hnsw_get_max_level(m: int) -> int:
    """Cap on element level so one neighbor tuple fits a PG page, <=255.

    Parity: types/hnsw.rs:337-349. A neighbor tuple holds (level+2)*m item
    pointers; solve for the max level that fits in one 8KB page.
    e.g. m=16 -> 82.
    """
    available = (
        BLCKSZ
        - _maxalign(_PAGE_HEADER_SIZE)
        - _maxalign(_PAGE_OPAQUE_SIZE)
        - _NEIGHBOR_TUPLE_HEADER
        - _ITEM_ID_SIZE
    )
    level = available // _ITEM_POINTER_SIZE // m - 2
    return min(level, 255)
