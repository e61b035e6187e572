"""The store service, copied from the reference package's ``net``:
:class:`StoreServer` (the daemon owning the shared artifact pool, its lease
table and its eviction-event stream; ``python -m repro_torch.net.serve
--root DIR`` starts one), :class:`RemoteBackend` (a ``StorageBackend`` over
the framed TCP protocol), :class:`CachingBackend` (the bounded,
digest-validated read-through tier in front of it), :class:`LeaseGrant`,
and :class:`DistributedSingleFlight` (one computer of a prefix across
processes).  Cluster mode (``ring``, ``sharded``) is not copied yet."""
from .cache import CachingBackend
from .client import LeaseGrant, RemoteBackend
from .flight import DistributedSingleFlight
from .server import StoreServer

__all__ = ["CachingBackend", "DistributedSingleFlight", "LeaseGrant", "RemoteBackend",
           "StoreServer"]
