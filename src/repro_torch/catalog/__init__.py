"""The provenance catalog's records and in-memory index, copied from the
reference package's ``catalog`` for the store server, which answers the
``catalog_*`` ops from them.  ``catalog.py`` and ``query.py`` (the
client-side ``Catalog``) are not copied yet."""
from .index import CatalogIndex
from .records import (
    CatalogQuery,
    CatalogRecord,
    rank_key,
    record_for_prefix,
    split_namespaced_dataset,
)

__all__ = [
    "CatalogIndex",
    "CatalogQuery",
    "CatalogRecord",
    "rank_key",
    "record_for_prefix",
    "split_namespaced_dataset",
]
