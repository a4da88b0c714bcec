"""Access-method facade: capability flags, opclass registry, progress.

Parity source: reference ``src/index/handler.rs:122-194`` (the
IndexAmRoutine) and the ``extension_sql!`` opclass registrations in each
type module (vector.rs:839-865, halfvec.rs:1043-1073,
sparsevec.rs:1552-1582, bitvec.rs:220-237). In a library setting these
become an introspectable registry: which operator classes exist, what
operator/metric they map to, the AM's capability flags, and the build
progress phase names (handler.rs:110-116).
"""

from __future__ import annotations

import dataclasses

import numpy as np

#: AM capability flags — parity with handler.rs:139-159.
AM_CAPABILITIES = {
    "amcanorder": False,
    "amcanorderbyop": True,  # ORDER BY col <-> q
    "amcanbackward": False,
    "amcanunique": False,
    "amcanmulticol": False,
    "amoptionalkey": True,
    "amsearcharray": False,
    "amsearchnulls": False,
    "amstorage": False,
    "amclusterable": False,
    "ampredlocks": False,
    "amcanparallel": False,
    "amcanbuildparallel": False,  # sequential reference build; the
    # batched device build is the (new) parallel story
    "amcaninclude": False,
    "amusemaintenanceworkmem": False,
    "amgettuple": True,
    "amgetbitmap": False,
}

#: Build progress phase names — handler.rs:110-116.
PROGRESS_PHASES = {2: "loading tuples"}


@dataclasses.dataclass(frozen=True)
class OperatorClass:
    name: str
    kind: str  # dense | bit | sparse
    metric: str  # order-distance metric key
    operator: str  # SQL operator the ordering matches
    dtype: object | None = None
    #: FUNCTION 2 (norm) present — only cosine opclasses (vector.rs:852-856)
    has_norm_proc: bool = False


OPERATOR_CLASSES = {
    # vector (f32) — vector.rs:839-865
    "vector_l2_ops": OperatorClass("vector_l2_ops", "dense", "l2", "<->", np.float32),
    "vector_ip_ops": OperatorClass("vector_ip_ops", "dense", "ip", "<#>", np.float32),
    "vector_cosine_ops": OperatorClass(
        "vector_cosine_ops", "dense", "cosine", "<=>", np.float32, has_norm_proc=True
    ),
    "vector_l1_ops": OperatorClass("vector_l1_ops", "dense", "l1", "<+>", np.float32),
    # halfvec — halfvec.rs:1043-1073
    "halfvec_l2_ops": OperatorClass("halfvec_l2_ops", "dense", "l2", "<->", np.float16),
    "halfvec_ip_ops": OperatorClass("halfvec_ip_ops", "dense", "ip", "<#>", np.float16),
    "halfvec_cosine_ops": OperatorClass(
        "halfvec_cosine_ops", "dense", "cosine", "<=>", np.float16, has_norm_proc=True
    ),
    "halfvec_l1_ops": OperatorClass("halfvec_l1_ops", "dense", "l1", "<+>", np.float16),
    # sparsevec — sparsevec.rs:1552-1582
    "sparsevec_l2_ops": OperatorClass("sparsevec_l2_ops", "sparse", "l2", "<->"),
    "sparsevec_ip_ops": OperatorClass("sparsevec_ip_ops", "sparse", "ip", "<#>"),
    "sparsevec_cosine_ops": OperatorClass(
        "sparsevec_cosine_ops", "sparse", "cosine", "<=>", has_norm_proc=True
    ),
    "sparsevec_l1_ops": OperatorClass("sparsevec_l1_ops", "sparse", "l1", "<+>"),
    # bit — bitvec.rs:220-237
    "bit_hamming_ops": OperatorClass("bit_hamming_ops", "bit", "hamming", "<~>"),
    "bit_jaccard_ops": OperatorClass("bit_jaccard_ops", "bit", "jaccard", "<%>"),
}


def validate_opclass(name: str) -> bool:
    """amvalidate analog (handler.rs:104-106): accepts known opclasses."""
    return name in OPERATOR_CLASSES


def create_index_for_opclass(name: str, dim: int, **kwargs):
    """CREATE INDEX ... USING hnsw (col <opclass>) analog: the port's
    ``HnswIndex`` on ``device=`` (a keyword passed through with the
    others; None: the card).

    The returned index is empty — this doubles as the ``ambuildempty``
    analog (build.rs:919-944: an UNLOGGED index's init fork is just a
    valid empty meta page; here an empty HnswIndex saves/loads as a
    valid empty checkpoint)."""
    from .hnsw import HnswIndex

    if name not in OPERATOR_CLASSES:
        raise ValueError(f'operator class "{name}" does not exist')
    oc = OPERATOR_CLASSES[name]
    return HnswIndex(
        dim,
        metric=oc.metric,
        kind=oc.kind,
        dtype=oc.dtype if oc.dtype is not None else np.float32,
        **kwargs,
    )


def build_phase_name(phase: int) -> str | None:
    """ambuildphasename analog."""
    return PROGRESS_PHASES.get(phase)
