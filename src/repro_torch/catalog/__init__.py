"""``repro_torch.catalog`` — queryable provenance index over the artifact space.

The store answers exact :class:`~repro_torch.core.workflow.PrefixKey` lookups;
the catalog answers *find-by-statepoint* questions ("what artifacts exist
for module ``align`` with ``k=31`` on this dataset?") — the discoverability
surface the thesis' reuse results depend on, modeled on signac's
content-hashed statepoint index with ``find(filter)``.
"""
from .catalog import CATALOG_META, Catalog
from .index import CatalogIndex
from .records import (
    CatalogQuery,
    CatalogRecord,
    rank_key,
    record_for_prefix,
    split_namespaced_dataset,
)

__all__ = [
    "CATALOG_META",
    "Catalog",
    "CatalogIndex",
    "CatalogQuery",
    "CatalogRecord",
    "rank_key",
    "record_for_prefix",
    "split_namespaced_dataset",
]
