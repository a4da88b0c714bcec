"""Framework-free utilities of the PyTorch port (copies of
``pgvector_rx_tpu/utils/rwlock.py`` and ``stats.py``)."""
