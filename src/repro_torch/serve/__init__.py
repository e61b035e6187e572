from ..sched.stats import AggregateStats
from .engine import GenStats, ServeEngine, ServeMetrics
from .snapshots import LoadedSnapshot, MemorySnapshotStore, SnapshotStore

__all__ = [
    "AggregateStats",
    "GenStats",
    "LoadedSnapshot",
    "MemorySnapshotStore",
    "ServeEngine",
    "ServeMetrics",
    "SnapshotStore",
]
