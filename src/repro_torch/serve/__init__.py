from ..sched.service import WorkflowService
from ..sched.stats import AggregateStats
from .engine import GenStats, ServeEngine, ServeMetrics
from .fabric import mount_serve_engine
from .snapshots import (
    FabricSnapshotStore,
    LoadedSnapshot,
    MemorySnapshotStore,
    SnapshotStore,
)

__all__ = [
    "AggregateStats",
    "FabricSnapshotStore",
    "GenStats",
    "LoadedSnapshot",
    "MemorySnapshotStore",
    "ServeEngine",
    "ServeMetrics",
    "SnapshotStore",
    "WorkflowService",
    "mount_serve_engine",
]
