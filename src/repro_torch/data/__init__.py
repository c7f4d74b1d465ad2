"""Training data pipeline of the port: deterministic synthetic token
shards, assigned to loader workers by the paper's bin-packing autoscaler
(shard throughputs are the item sizes, a loader's ingest capacity the
bin size), into fixed-shape next-token batches with resumable state."""
from .pipeline import LoaderPool, ShardSpec, SyntheticShard, TokenPipeline

__all__ = ["LoaderPool", "ShardSpec", "SyntheticShard", "TokenPipeline"]
