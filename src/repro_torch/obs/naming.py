"""The canonical metric-name map for the fabric's legacy stats surfaces.

Before ``repro_torch.obs`` there were three divergent stats shapes —
``StoreServer.stats()``, ``ShardedBackend.server_stats()``, and
``GatewayServer.stats_doc()`` — each naming the same quantity differently
("requests" vs "ops", "singleflight_waits" under ``fabric`` but ``waits``
on the flight object).  The registry is now the single home; the old dict
keys survive as **deprecated aliases** so existing callers keep working.

``ALIASES`` pins the mapping: ``"<surface>:<dotted.key>"`` → canonical
registry metric (``{label=value}`` marks the series the alias reads).
``tests/test_torch_obs.py::test_stats_alias_mapping_pinned`` fails if an alias
disappears or a canonical name drifts.
"""
from __future__ import annotations

__all__ = ["ALIASES", "SURFACES"]

#: the legacy stats surfaces and the accessor that produces each
SURFACES = {
    "store_server": "repro_torch.net.server.StoreServer.stats()",
    "cluster": "repro_torch.net.sharded.ShardedBackend.server_stats()",
    "gateway": "repro_torch.gateway.server.GatewayServer.stats_doc()",
    "serve": "repro_torch.serve.ServeEngine.aggregate_stats()",
}

ALIASES: dict[str, str] = {
    # -- StoreServer.stats() ------------------------------------------------
    "store_server:requests": "repro_store_server_requests_total",
    "store_server:ops.*": "repro_store_server_requests_total{op=*}",
    "store_server:streaming.chunks_in": "repro_store_server_stream_chunks_total{dir=in}",
    "store_server:streaming.chunks_out": "repro_store_server_stream_chunks_total{dir=out}",
    "store_server:streaming.bytes_in": "repro_store_server_stream_bytes_total{dir=in}",
    "store_server:streaming.bytes_out": "repro_store_server_stream_bytes_total{dir=out}",
    "store_server:streaming.streamed_writes": "repro_store_server_requests_total{op=write_blob_chunked}",
    "store_server:active_leases": "repro_store_server_active_leases",
    "store_server:connections": "repro_store_server_connections",
    "store_server:subscribers": "repro_store_server_subscribers",
    "store_server:catalog_records": "repro_store_server_catalog_records",
    "store_server:uptime_s": "repro_store_server_uptime_seconds",
    # -- ShardedBackend.server_stats() (per-shard docs are StoreServer.stats()
    # shapes; the aggregate keys below sum them) ----------------------------
    "cluster:requests": "repro_store_server_requests_total",
    "cluster:ops.*": "repro_store_server_requests_total{op=*}",
    # client-side cluster counters (attribute aliases)
    "cluster:failover_reads": "repro_cluster_failover_reads_total",
    "cluster:read_repairs": "repro_cluster_read_repairs_total",
    "cluster:lease_failovers": "repro_cluster_lease_failovers_total",
    "cluster:reconnects": "repro_remote_reconnects_total",
    # -- GatewayServer.stats_doc() ------------------------------------------
    "gateway:fabric.runs": "repro_runs_total",
    "gateway:fabric.failures": "repro_runs_total{status=failed}",
    "gateway:fabric.stored": "repro_run_stored_total",
    "gateway:fabric.singleflight_waits": "repro_singleflight_waits_total",
    "gateway:fabric.pending_runs": "repro_service_pending_runs",
    "gateway:fabric.rejected_runs": "repro_service_rejected_total",
    "gateway:gateway.*": "repro_gateway_requests_total{op=*}",
    "gateway:gateway.http_*": "repro_gateway_http_responses_total{status=*}",
    "gateway:tenant.runs": "repro_tenant_runs_total{tenant=*}",
    "gateway:tenant.rejected": "repro_tenant_rejected_total{tenant=*}",
    "gateway:tenant.in_flight": "repro_tenant_inflight{tenant=*}",
    "gateway:tenant.bytes_stored": "repro_tenant_stored_bytes{tenant=*}",
    # -- ServeEngine.aggregate_stats() (AggregateStats shape; the engine's
    # tallies live on the registry — the dataclass fields below are
    # reconstructed from these canonical series) ----------------------------
    "serve:runs": "repro_serve_requests_total",
    "serve:busy_seconds": "repro_serve_busy_seconds_total",
    "serve:units_total": "repro_serve_chunks_total",
    "serve:units_skipped": "repro_serve_chunks_skipped_total",
    "serve:stored": "repro_serve_snapshots_stored_total",
    # snapshot-store accounting (SnapshotStore attribute aliases)
    "serve:n_snapshots": "repro_serve_snapshots",
    "serve:snapshot_bytes": "repro_serve_snapshot_stored_bytes",
    "serve:n_snapshot_evictions": "repro_serve_snapshot_evictions_total{source=*}",
}
