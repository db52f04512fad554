"""Data pipeline of the port: synthetic corpus, online bloomRF dedup and
shard range admission."""
from .pipeline import (ShardRangeIndex, StreamDeduper, SyntheticCorpus,
                       batch_iterator)

__all__ = ["SyntheticCorpus", "StreamDeduper", "ShardRangeIndex",
           "batch_iterator"]
