"""Core RISP library: the paper's contribution as composable components.

The port exports what the reference package's ``core`` exports from the
modules it has ported (``adaptive``, ``corpus`` and ``metrics`` are not)."""
from .backends import LocalFSBackend, MemoryBackend, StorageBackend, TieredBackend
from .codecs import Codec, available_codecs, register_codec, resolve_codec
from .cost import CostModel
from .eviction import (
    EvictionManager,
    EvictionPolicy,
    GainLossEviction,
    LRUEviction,
    gain_loss_ratio,
)
from .executor import RunResult, WorkflowError, WorkflowExecutor
from .kvcodec import KVSnapshotInfo, load_kv, read_kv_info, save_kv
from .provenance import ProvenanceLog, RunRecord
from .registry import ModuleRegistry, ToolStateError, UnknownModuleError
from .risp import RISP, TSAR, TSFR, TSPAR, Recommendation, StoragePolicy, make_policy
from .rules import Rule, RuleMiner
from .store import ArtifactRecord, IntermediateStore, PutResult
from .workflow import (
    ModuleRef,
    ModuleSpec,
    PrefixKey,
    ToolState,
    Workflow,
    decode_param,
    encode_param,
)

__all__ = [
    "ArtifactRecord",
    "Codec",
    "CostModel",
    "EvictionManager",
    "EvictionPolicy",
    "GainLossEviction",
    "IntermediateStore",
    "KVSnapshotInfo",
    "LRUEviction",
    "LocalFSBackend",
    "MemoryBackend",
    "ModuleRef",
    "ModuleRegistry",
    "ModuleSpec",
    "PrefixKey",
    "ProvenanceLog",
    "PutResult",
    "RISP",
    "Recommendation",
    "Rule",
    "RuleMiner",
    "RunRecord",
    "RunResult",
    "StoragePolicy",
    "StorageBackend",
    "TSAR",
    "TSFR",
    "TSPAR",
    "TieredBackend",
    "ToolState",
    "ToolStateError",
    "UnknownModuleError",
    "Workflow",
    "WorkflowError",
    "WorkflowExecutor",
    "available_codecs",
    "decode_param",
    "encode_param",
    "gain_loss_ratio",
    "load_kv",
    "make_policy",
    "read_kv_info",
    "register_codec",
    "resolve_codec",
    "save_kv",
]
