"""Shared helpers for the vector type family.

Parity source: reference ``src/types/*.rs`` (pgvector-rx). Error message
strings match the reference exactly — golden tests depend on them
(reference vector.rs:62-84 et al.).
"""

from __future__ import annotations

import numpy as np

#: Whitespace accepted by the reference parsers (vector_isspace: C isspace set).
_WHITESPACE = b" \t\n\r\v\f"


def is_space(ch: int) -> bool:
    return ch in _WHITESPACE


def skip_space(s: bytes, pos: int) -> int:
    n = len(s)
    while pos < n and s[pos] in _WHITESPACE:
        pos += 1
    return pos


def parse_f32(token: str, on_error) -> np.float32:
    """Parse a float token the way Rust's ``str::parse::<f32>`` does.

    Notably: no leading/trailing junk, accepts inf/infinity/nan (any case),
    rejects empty strings and bare signs. Values overflowing f32 round to
    +/-inf (Rust parse semantics).
    """
    t = token.strip()
    if t == "" or t in ("+", "-", ".", "+.", "-."):
        on_error()
    low = t.lower().lstrip("+-")
    if low not in ("inf", "infinity", "nan"):
        # Rust f32 parse accepts forms like "1.", ".5", "1e3"; Python float()
        # accepts a superset (e.g. underscores, "infin") — reject those.
        allowed = set("0123456789.eE+-")
        if not set(t) <= allowed:
            on_error()
        if "_" in t:
            on_error()
    try:
        with np.errstate(over="ignore"):
            return np.float32(float(t))
    except (ValueError, OverflowError):
        on_error()
        raise AssertionError("unreachable")


def format_f32(v) -> str:
    """Shortest-round-trip decimal for an f32, with trailing ``.0`` stripped.

    Parity: reference vector.rs:281-288 (ryu shortest + strip ``.0``),
    matching PostgreSQL's float_to_shortest_decimal_bufn.
    """
    f = np.float32(v)
    if np.isnan(f):
        return "NaN"
    if np.isinf(f):
        return "Infinity" if f > 0 else "-Infinity"
    # numpy's dragon4 produces the shortest string that round-trips at
    # float32 precision, same contract as ryu.
    s = np.format_float_positional(f, unique=True, trim="-")
    if "e" in s or "E" in s:  # pragma: no cover - positional never has exp
        return s
    # Large/small magnitudes: use scientific like ryu/PG does.
    af = abs(float(f))
    if af != 0.0 and (af >= 1e16 or af < 1e-4):
        s = np.format_float_scientific(f, unique=True, trim="-")
        # numpy: "1.e+20" style → normalize to "1e+20"
        s = s.replace(".e", "e")
        return s
    return s


def format_f32_list(values) -> str:
    return ",".join(format_f32(v) for v in np.asarray(values, dtype=np.float32))
