"""SketchStore: packed signature storage + vectorized LSH, on one device."""

from .packed import PackedConfig, PackedSignatureBuffer
from .planner import QueryPlanner, TopKPartial, finalize_topk
from .sharded import InProcessShard, ShardedSketchStore
from .store import SketchStore, StoreConfig
from .table import BandedLSHTable

__all__ = ["PackedConfig", "PackedSignatureBuffer", "QueryPlanner",
           "SketchStore", "ShardedSketchStore", "StoreConfig",
           "BandedLSHTable", "TopKPartial", "finalize_topk",
           "InProcessShard"]
