"""pgvector_rx_tpu_torch — the PyTorch/CUDA port of pgvector_rx_tpu.

It runs the serving path of ``pgvector_rx_tpu`` on an NVIDIA GPU (or on
the CPU, through each kernel's plain-torch version): the flat-array
``DeviceGraph``, the exact / approx / beam engines, ``serve_topk`` and
``HnswIndex.search``, the batched device build, and the sharded index
(``parallel.ShardedHnswIndex``: one process, a shard per device). It
stands alone: the framework-free modules of ``pgvector_rx_tpu`` are
copied here at the same relative paths (constants, config, types, utils/rwlock, utils/stats,
graph/host, index/stores, index/vacuum, the host half of index/scan and
index/hnsw, the native engine with ``csrc/hnswcore.cpp``), and
``tests/test_torch_standalone.py`` holds the copies to the originals.
Nothing here imports JAX or ``pgvector_rx_tpu``.

An index and its ``DeviceGraph`` live on the ``device`` they were built
with; ``device=None`` means the card (``"cuda"``) and raises where no
CUDA device is visible, so a CPU run passes ``device="cpu"``. TF32 stays
off for matmuls and cuDNN, so FP32 products are full precision.
"""

import torch

from . import constants
from .config import IndexParams, SearchParams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["constants", "IndexParams", "SearchParams", "HnswIndex"]


def __getattr__(name):
    if name == "HnswIndex":
        from .index.hnsw import HnswIndex

        return HnswIndex
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
