"""``repro_torch.net`` — the intermediate-data store as a cross-process service.

Everything below the ``StorageBackend`` seam can live in another process:

  * :class:`StoreServer`     — daemon owning the shared artifact pool, plus
    the lease table (fleet-wide single-flight) and the eviction-event stream;
  * :class:`RemoteBackend`   — drop-in ``StorageBackend`` speaking the framed
    TCP protocol with reconnect/retry and content-digest verification;
  * :class:`CachingBackend`  — bounded, digest-validated read-through LRU so
    hot prefixes are served at local speed;
  * :class:`DistributedSingleFlight` — two-level (threads, then processes)
    compute deduplication for uncomputed prefixes;
  * :class:`ShardedBackend` + :class:`HashRing` — **cluster mode**: N servers
    behind one consistent-hash ring with replication factor R, failover
    reads, read-repair, and ring-aware lease election
    (``Client(store_url="h:7077,h:7078,h:7079", replication=2)``).

``python -m repro_torch.net.serve --root DIR`` starts one server (one shard); see
``docs/remote.md`` for the protocol, cluster semantics, and deployment
sketch.
"""
from .cache import CachingBackend
from .client import LeaseGrant, RemoteBackend
from .flight import DistributedSingleFlight
from .protocol import (
    DEFAULT_CHUNK_BYTES,
    PROTO_VERSION,
    ConnectionClosed,
    IntegrityError,
    ProtocolError,
    RemoteStoreError,
    StoreUnreachable,
)
from .ring import HashRing
from .server import StoreServer
from .sharded import ShardedBackend

__all__ = [
    "CachingBackend",
    "ConnectionClosed",
    "DEFAULT_CHUNK_BYTES",
    "PROTO_VERSION",
    "DistributedSingleFlight",
    "HashRing",
    "IntegrityError",
    "LeaseGrant",
    "ProtocolError",
    "RemoteBackend",
    "RemoteStoreError",
    "ShardedBackend",
    "StoreServer",
    "StoreUnreachable",
]
