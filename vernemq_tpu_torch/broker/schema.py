"""Reference config-schema surface.

The reference compiles ``vernemq.conf`` through 217 cuttlefish mappings
(``apps/vmq_server/priv/vmq_server.schema``). This module is the
authoritative classification of that surface for the conf-file loader
(:mod:`vernemq_tpu.broker.conf`): every mapping name either

- maps onto a :data:`~vernemq_tpu.broker.config.DEFAULTS` knob (same
  name, an alias, or a unit conversion),
- is a listener-tree option (``listener.<kind>[.<name>].<opt>``), or
- is a **deliberate gap** — rejected with a reason naming the
  architectural difference, never silently dropped.

``tests/test_conf.py`` diffs this classification against the mapping
list extracted from the reference schema file, so coverage can't rot
silently.
"""

from __future__ import annotations

import re
from typing import Dict, Optional, Tuple

# --------------------------------------------------------------- flat knobs

#: schema names that resolve to a different DEFAULTS key
FLAT_ALIASES: Dict[str, str] = {
    # vmq_server.schema:62 — documented alias of max_message_size
    "message_size_limit": "max_message_size",
    # the storage engine is the C++ kvstore, not leveldb, but the knob's
    # meaning (message-store directory) carries over
    "leveldb_message_store.directory": "message_store_dir",
    # metadata directory (the plumtree/swc on-disk seat)
    "plumtree.directory": "metadata_dir",
    "plumtree.outstanding_limit": "plumtree_outstanding_limit",
    "plumtree.drop_i_have_threshold": "plumtree_drop_ihave_threshold",
    # release-script knobs; honored as base directories at boot
    "setup.data_dir": "data_dir",
    "setup.log_dir": "log_dir",
    # vmq_swc.schema's db_backend knob (leveldb/rocksdb/leveled there;
    # kvstore/bucketed here — the same engine-choice seam)
    "vmq_swc.db_backend": "swc_db_backend",
}

#: extension family: the adaptive overload governor
#: (robustness/overload.py). The reference exposes its load shedding
#: through vmq_ranch/vmq_queue internals without conf knobs; ours is
#: operator-tunable, so the flat ``overload_*`` DEFAULTS also get a
#: dotted ``overload.<knob>`` conf-tree spelling, consistent with the
#: reference's dotted trees (plumtree.*, setup.*).
FLAT_ALIASES.update({
    f"overload.{k[len('overload_'):]}": k
    for k in (
        "overload_mode", "overload_tick_ms", "overload_hold_s",
        "overload_exit_ratio", "overload_l1_enter", "overload_l2_enter",
        "overload_l3_enter", "overload_l1_throttle_ms",
        "overload_l2_client_rate", "overload_l2_burst",
        "overload_l3_disconnect_top", "overload_dispatch_budget_ms",
    )
})

#: extension family: the stall watchdog (robustness/watchdog.py) —
#: deadline abandonment for silent stalls; same dotted-tree spelling
#: discipline as overload.* above
FLAT_ALIASES.update({
    f"watchdog.{k[len('watchdog_'):]}": k
    for k in (
        "watchdog_enabled", "watchdog_tick_ms",
        "watchdog_dispatch_deadline_ms", "watchdog_rebuild_deadline_s",
        "watchdog_collector_expiry_budgets",
    )
})
FLAT_ALIASES["watchdog.cluster_stall_timeout_s"] = "cluster_stall_timeout_s"

#: extension family: the live-handoff state machine
#: (cluster/handoff.py) — freeze→drain→fence→adopt elastic
#: rebalancing; same dotted-tree spelling discipline as overload.*
FLAT_ALIASES.update({
    f"handoff.{k[len('handoff_'):]}": k
    for k in (
        "handoff_freeze_deadline_ms", "handoff_drain_deadline_s",
        "handoff_v5_redirect", "handoff_batch_max_sessions",
    )
})
FLAT_ALIASES["mqtt5.qos2_dedup_max"] = "qos2_dedup_max"

#: extension family: the membership health plane (cluster/health.py) —
#: accrual failure detection + the automatic rebalance planner. The
#: flat spellings keep their subsystem prefixes (health_*,
#: rebalance_*); the dotted tree groups them under cluster.* with the
#: other cluster knobs.
FLAT_ALIASES.update({
    f"cluster.{k}": k
    for k in (
        "health_enabled", "health_tick_ms", "health_window",
        "health_phi_suspect", "health_phi_down", "health_exit_ratio",
        "health_hold_s", "rebalance_enabled",
        "rebalance_require_quorum", "rebalance_debounce_s",
        "rebalance_cooldown_s", "rebalance_max_concurrent",
    )
})
FLAT_ALIASES["cluster.advertised_address"] = "cluster_advertised_address"

#: extension family: the multi-process session front end
#: (broker/workers.py / broker/match_service.py). The plumbing knobs
#: (ring/stats segment names, worker index) are set by the WorkerGroup
#: parent, never by conf files — only the operator-facing ones get a
#: dotted spelling.
FLAT_ALIASES.update({
    "workers.count": "workers",
    "workers.match_service_timeout_ms": "match_service_timeout_ms",
})

#: extension family: the hot-path flight recorder / stage histograms
#: (vernemq_tpu/observability/) — same dotted-tree discipline
FLAT_ALIASES.update({
    "observability.enabled": "observability_enabled",
    "observability.sample_n": "flight_recorder_sample_n",
    "observability.recorder_capacity": "flight_recorder_capacity",
    "observability.profiler_capacity": "profiler_capacity",
    "observability.events_capacity": "events_capacity",
    "observability.canary_enabled": "canary_enabled",
    "observability.canary_interval_ms": "canary_interval_ms",
    "observability.canary_slo_ms": "canary_slo_ms",
})

#: extension family: the mesh-native matcher (parallel/mesh_match.py)
#: + slice map (cluster/mesh_map.py) — same dotted-tree discipline
FLAT_ALIASES.update({
    "mesh.topology": "tpu_mesh",
    "mesh.native": "tpu_mesh_native",
})

#: extension family: the native wire plane (protocol/fastpath.py) —
#: same dotted-tree discipline
FLAT_ALIASES.update({
    "wire.fastpath_enabled": "wire_fastpath_enabled",
})

#: extension family: the unified storage tier (storage/segment.py +
#: storage/resume.py) — segment engine geometry, the budgeted
#: compaction loop, and batched reconnect-storm resumption
FLAT_ALIASES.update({
    "store.segment_max_bytes": "store_segment_max_bytes",
    "store.checkpoint_every_bytes": "store_checkpoint_every_bytes",
    "store.compact_interval_ms": "store_compact_interval_ms",
    "store.compact_budget_bytes": "store_compact_budget_bytes",
    "store.expire_sweep_budget": "store_expire_sweep_budget",
    "store.fsync": "msg_store_fsync",
    "store.group_commit": "msg_store_group_commit",
    "resume.batched": "resume_batched",
    "resume.window_us": "resume_window_us",
    "resume.max_batch": "resume_max_batch",
    "resume.host_threshold": "resume_host_threshold",
    "resume.expiry_ms": "resume_expiry_ms",
})

#: extension family: payload filtering & windowed aggregation
#: (vernemq_tpu/filters/) — the MQTT+ predicate/aggregate surface;
#: schema DEFINITIONS are replicated state (`vmq-admin schema set` /
#: the payload_schemas config list), these are the serving knobs
FLAT_ALIASES.update({
    "payload_schema.enabled": "payload_filters_enabled",
    "payload_schema.host_threshold": "predicate_host_threshold",
    "payload_schema.max_pairs": "predicate_max_pairs",
    "payload_schema.initial_windows": "aggregate_initial_windows",
    "payload_schema.max_windows": "aggregate_max_windows",
    "payload_schema.window_tick_ms": "aggregate_tick_ms",
})

#: reference knobs typed in MILLISECONDS whose internal knob is seconds
MS_TO_SECONDS = {
    "systree_interval",
    "graphite_interval",
    "graphite_connect_timeout",
    "graphite_reconnect_timeout",
}

#: knobs taking cuttlefish duration strings ("never", "1w", "30m", "0s");
#: parsed to seconds
DURATION_KEYS = {
    "persistent_client_expiration",
    "max_last_will_delay",
}

#: reference http_modules entries -> our admin/http module names
HTTP_MODULE_ALIASES = {
    "vmq_metrics_http": "metrics",
    "vmq_http_mgmt_api": "mgmt",
    "vmq_status_http": "status",
    "vmq_health_http": "health",
}

#: reference reg_views entries -> our reg-view seam names
REG_VIEW_ALIASES = {"vmq_reg_trie": "trie", "vmq_reg_tpu": "tpu",
                    "trie": "trie", "tpu": "tpu"}

# ------------------------------------------------------------ listener tree

#: conf-file listener kind -> ListenerManager kind
#: (vmq_ranch_config.erl:224-227) — single source for both the
#: classifier and the conf loader's settings assembly
INTERNAL_KINDS: Dict[str, str] = {
    "tcp": "mqtt", "ssl": "mqtts", "ws": "ws", "wss": "wss",
    "http": "http", "https": "https", "vmq": "vmq", "vmqs": "vmqs",
}
LISTENER_KINDS = tuple(INTERNAL_KINDS)
TLS_KINDS = ("ssl", "wss", "https", "vmqs")

#: listener options whose values must be integers — non-numeric values
#: fail at parse time (ConfError), not at broker boot
INT_LISTENER_OPTS = {"max_connections", "nr_of_acceptors", "depth",
                     "max_frame_size"}

#: options valid on EVERY listener kind: schema spelling -> internal opt
COMMON_LISTENER_OPTS: Dict[str, str] = {
    "max_connections": "max_connections",
    "nr_of_acceptors": "nr_of_acceptors",
    "mountpoint": "mountpoint",
}

#: extra options per kind (schema spelling -> internal opt)
EXTRA_LISTENER_OPTS: Dict[str, Dict[str, str]] = {
    "tcp": {
        "proxy_protocol": "proxy_protocol",
        "proxy_protocol_use_cn_as_username":
            "proxy_protocol_use_cn_as_username",
        "allowed_protocol_versions": "allowed_protocol_versions",
    },
    "ws": {
        "proxy_protocol": "proxy_protocol",
        "proxy_protocol_use_cn_as_username":
            "proxy_protocol_use_cn_as_username",
        "allowed_protocol_versions": "allowed_protocol_versions",
    },
    "wss": {
        "allowed_protocol_versions": "allowed_protocol_versions",
    },
    "ssl": {
        "allowed_protocol_versions": "allowed_protocol_versions",
    },
    "http": {
        "proxy_protocol": "proxy_protocol",
        "proxy_protocol_use_cn_as_username":
            "proxy_protocol_use_cn_as_username",
        "http_modules": "http_modules",
    },
    "https": {"http_modules": "http_modules"},
    "vmq": {},
    "vmqs": {},
}

#: TLS options (only on TLS kinds): schema spelling -> internal opt
TLS_LISTENER_OPTS: Dict[str, str] = {
    "cafile": "cafile",
    "certfile": "certfile",
    "keyfile": "keyfile",
    "ciphers": "ciphers",
    "crlfile": "crl_file",
    "depth": "depth",
    "require_certificate": "require_certificate",
    "tls_version": "tls_version",
    "use_identity_as_username": "use_identity_as_username",
}

# --------------------------------------------------------- deliberate gaps

#: mapping name (or listener option) -> reason it is rejected. These are
#: architectural, not omissions: the error message names the reason so an
#: operator migrating a vernemq.conf knows what to do.
GAPS: Dict[str, str] = {
    "listener.http.$name.config_mod":
        "Erlang module hooks cannot be loaded; mount custom HTTP "
        "endpoints via admin/http.py modules instead",
    "listener.http.$name.config_fun":
        "Erlang module hooks cannot be loaded; mount custom HTTP "
        "endpoints via admin/http.py modules instead",
    "listener.https.$name.config_mod":
        "Erlang module hooks cannot be loaded; mount custom HTTP "
        "endpoints via admin/http.py modules instead",
    "listener.https.$name.config_fun":
        "Erlang module hooks cannot be loaded; mount custom HTTP "
        "endpoints via admin/http.py modules instead",
}

#: accepted-for-compatibility knobs with no behavioral effect here; the
#: conf loader logs the note once instead of erroring (an operator's
#: existing vernemq.conf must not fail to boot over a knob whose concern
#: does not exist in this architecture)
COMPAT_NOOPS: Dict[str, str] = {
    "queue_sup_sup_children":
        "queues live in an O(1) dict registry, not a supervisor tree; "
        "accepted for compatibility, no effect",
    "systree_reg_view":
        "systree publishes route through the configured default_reg_view; "
        "per-publisher views are not separated",
    "graphite_include_labels":
        "metrics are emitted unlabeled; accepted for compatibility",
    "nr_of_acceptors":
        "asyncio listeners have a single accept loop; accepted for "
        "compatibility, no effect",
    "proxy_protocol_use_cn_as_username":
        "PROXY v2 TLS CN forwarding is not extracted; use "
        "use_identity_as_username on TLS listeners instead",
    "shared_subscription_timeout_action":
        "remote shared-subscription deliveries are acked asynchronously; "
        "timed-out deliveries are retried by the queue, 'requeue' "
        "semantics are always in effect",
}


_LISTENER_RE = re.compile(r"^listener\.(?P<kind>[a-z]+)"
                          r"(?:\.(?P<rest>.+))?$")


def classify_listener_key(
    key: str,
) -> Optional[Tuple[str, Optional[str], Optional[str], Optional[str]]]:
    """Classify a ``listener.*`` conf key.

    Returns ``(scope, kind, name, opt)`` where scope is one of
    ``"global-opt"`` (listener.<opt>), ``"kind-opt"``
    (listener.<kind>.<opt>), ``"addr"`` (listener.<kind>.<name>), or
    ``"name-opt"`` (listener.<kind>.<name>.<opt>) — or None if the key
    is not a listener key. Raises KeyError with a reason for unknown
    kinds/options and deliberate gaps.

    Disambiguation rule (same as cuttlefish's): a third segment that is
    a known option name for the kind is a kind-level default; anything
    else is a listener name (you cannot name a listener 'mountpoint').
    """
    if not key.startswith("listener."):
        return None
    parts = key.split(".")
    if len(parts) == 2:
        opt = parts[1]
        if opt not in COMMON_LISTENER_OPTS:
            raise KeyError(
                f"unknown global listener option {opt!r} "
                f"(valid: {', '.join(sorted(COMMON_LISTENER_OPTS))})")
        return ("global-opt", None, None, COMMON_LISTENER_OPTS[opt])
    kind = parts[1]
    if kind not in LISTENER_KINDS:
        raise KeyError(f"unknown listener kind {kind!r} "
                       f"(valid: {', '.join(LISTENER_KINDS)})")
    valid = dict(COMMON_LISTENER_OPTS)
    valid.update(EXTRA_LISTENER_OPTS.get(kind, {}))
    if kind in TLS_KINDS:
        valid.update(TLS_LISTENER_OPTS)
    if len(parts) == 3:
        seg = parts[2]
        if seg in valid:
            return ("kind-opt", kind, None, valid[seg])
        return ("addr", kind, seg, None)
    name, opt = parts[2], ".".join(parts[3:])
    gap = GAPS.get(f"listener.{kind}.$name.{opt}")
    if gap is not None:
        raise KeyError(f"deliberate gap: {gap}")
    if opt not in valid:
        # tolerate our own extension opts that predate this schema layer
        if opt in ("max_frame_size", "buffer_sizes"):
            return ("name-opt", kind, name, opt)
        raise KeyError(
            f"unknown listener option {opt!r} for kind {kind!r} "
            f"(valid: {', '.join(sorted(valid))})")
    return ("name-opt", kind, name, valid[opt])


_DUR_RE = re.compile(r"(\d+)\s*(ms|[smhdwy])")
_DUR_SECONDS = {"ms": 0.001, "s": 1, "m": 60, "h": 3600, "d": 86400,
                "w": 604800, "y": 31557600}


def parse_duration(raw: str) -> int:
    """Cuttlefish duration string -> whole seconds. Accepts ``never``
    (0), bare integers (seconds), and concatenated units (``1w2d``,
    ``30m``). Non-zero sub-second values round UP to 1s — truncating to
    0 would invert the semantics (0 means "never" for
    persistent_client_expiration)."""
    s = raw.strip().lower()
    if s in ("never", "0"):
        return 0
    if s.isdigit():
        return int(s)
    total = 0.0
    pos = 0
    for m in _DUR_RE.finditer(s):
        if m.start() != pos:
            break
        total += int(m.group(1)) * _DUR_SECONDS[m.group(2)]
        pos = m.end()
    if pos != len(s):
        raise ValueError(f"bad duration {raw!r} "
                         "(expected e.g. never, 1w, 30m, 1w2d)")
    if 0 < total < 1:
        return 1
    return int(total)


def reference_mapping_names(schema_text: str):
    """Extract the mapping names from a cuttlefish schema file (for the
    coverage test)."""
    return re.findall(r'\{mapping,\s*"([^"]+)"', schema_text)
