"""Scale-out of the PyTorch port: a node-partitioned index whose shards
each own an HNSW sub-graph on their own device, with queries replicated
and the shards' top-k merged on the first device (:mod:`.sharded`, the
port of ``pgvector_rx_tpu/parallel``)."""

from .sharded import ShardedHnswIndex

__all__ = ["ShardedHnswIndex"]
