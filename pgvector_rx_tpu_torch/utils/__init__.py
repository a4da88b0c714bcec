"""Utilities of the PyTorch port: observability (copies of
``pgvector_rx_tpu/utils/rwlock.py`` and ``stats.py``) and profiling
(``torch.profiler``)."""

from .profiling import trace
from .stats import IndexStats, ScanStats

__all__ = ["IndexStats", "ScanStats", "trace"]
