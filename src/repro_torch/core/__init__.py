"""Core RISP library: the paper's contribution as composable components."""
from .adaptive import adaptive_policy, adaptive_risp
from .backends import LocalFSBackend, MemoryBackend, StorageBackend, TieredBackend
from .codecs import Codec, available_codecs, register_codec, resolve_codec
from .corpus import CorpusSpec, galaxy_ch4_corpus, galaxy_ch5_corpus, generate_corpus
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
from .metrics import PolicyReport, evaluate_all, evaluate_policy
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
    "CorpusSpec",
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
    "PolicyReport",
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
    "adaptive_policy",
    "adaptive_risp",
    "available_codecs",
    "decode_param",
    "encode_param",
    "evaluate_all",
    "evaluate_policy",
    "gain_loss_ratio",
    "galaxy_ch4_corpus",
    "galaxy_ch5_corpus",
    "generate_corpus",
    "load_kv",
    "make_policy",
    "read_kv_info",
    "register_codec",
    "resolve_codec",
    "save_kv",
]
