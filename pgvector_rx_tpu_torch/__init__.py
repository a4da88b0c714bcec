"""pgvector_rx_tpu_torch — the PyTorch/CUDA port of pgvector_rx_tpu.

It runs the serving path of ``pgvector_rx_tpu`` on an NVIDIA GPU (or on
the CPU, through each kernel's plain-torch version): the flat-array
``DeviceGraph``, the exact / approx / beam engines, ``serve_topk`` and
``HnswIndex.search``. The framework-free modules of ``pgvector_rx_tpu``
(constants, config, types, the host graph, stores, the native C++
engine) are imported, not copied; nothing here imports JAX.

Every device is explicit: an index and its ``DeviceGraph`` live on the
``device`` they were built with. TF32 stays off for matmuls and cuDNN,
so FP32 products are full precision.
"""

import torch

from pgvector_rx_tpu import constants
from pgvector_rx_tpu.config import IndexParams, SearchParams

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["constants", "IndexParams", "SearchParams", "HnswIndex"]


def __getattr__(name):
    if name == "HnswIndex":
        from .index.hnsw import HnswIndex

        return HnswIndex
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
