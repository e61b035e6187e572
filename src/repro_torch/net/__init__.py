"""The store-service client side, copied from the reference package's
``net``: :class:`RemoteBackend` (a ``StorageBackend`` over the framed TCP
protocol, with the lease table and the eviction-event stream),
:class:`LeaseGrant`, and :class:`DistributedSingleFlight` (one computer of a
prefix across processes).  The server, the cache tier and cluster mode stay
behind until a slice needs them."""
from .client import LeaseGrant, RemoteBackend
from .flight import DistributedSingleFlight

__all__ = ["DistributedSingleFlight", "LeaseGrant", "RemoteBackend"]
