"""The ``vmq-admin`` command tree.

Plays the role of clique in the reference: subsystems register commands
into one tree (``vmq_server_cli.erl:52-73`` registers node/cluster/session/
plugin/listener/metrics/api-key commands), the CLI and the HTTP management
API both dispatch into it (``vmq_http_mgmt_api.erl:100-140`` maps
``/api/v1/<path>?flags`` onto the same registry).

A command is ``(path_words, fn(broker, flags) -> result, usage, help)``.
Results are plain JSON-able values; tabular results are
``{"table": [row-dicts]}`` so the CLI can pretty-print and the HTTP API can
return JSON unchanged (the clique writer split, ``vmq_cli_json_writer``).
"""

from __future__ import annotations

import os
import secrets
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple


class CommandError(Exception):
    def __init__(self, message: str, usage: Optional[str] = None):
        super().__init__(message)
        self.message = message
        self.usage = usage


CommandFn = Callable[[Any, Dict[str, Any]], Any]


class _Bare:
    """Sentinel for a bare ``--flag`` (no ``=value``): truthy, but
    distinguishable from an explicit ``flag=true`` so commands like
    ``session show`` can tell column selectors from filters."""

    def __bool__(self) -> bool:
        return True

    def __repr__(self) -> str:
        return "true"


BARE = _Bare()


class CommandRegistry:
    def __init__(self) -> None:
        # path tuple -> (fn, usage, help)
        self._commands: Dict[Tuple[str, ...], Tuple[CommandFn, str, str]] = {}

    def register(self, path: Sequence[str], fn: CommandFn, usage: str,
                 help_text: str = "") -> None:
        self._commands[tuple(path)] = (fn, usage, help_text)

    def commands(self) -> List[Tuple[Tuple[str, ...], str, str]]:
        return [(p, u, h) for p, (_, u, h) in sorted(self._commands.items())]

    def resolve(self, words: Sequence[str]) -> Tuple[Tuple[str, ...], Dict[str, Any]]:
        """Split ``words`` into the longest registered command path plus
        ``key=value`` / ``--flag`` arguments (clique parsing shape)."""
        path: List[str] = []
        args: List[str] = []
        for w in words:
            if args or "=" in w or w.startswith("--"):
                args.append(w)
            else:
                path.append(w)
        # longest-prefix match so `session show` wins over `session`
        for cut in range(len(path), 0, -1):
            if tuple(path[:cut]) in self._commands:
                args = path[cut:] + args
                return tuple(path[:cut]), self._parse_flags(args)
        raise CommandError(f"unknown command: {' '.join(words) or '(empty)'}",
                           usage=self.usage_overview())
    @staticmethod
    def _parse_flags(args: Sequence[str]) -> Dict[str, Any]:
        flags: Dict[str, Any] = {}
        for a in args:
            if a.startswith("--"):
                a = a[2:]
            if "=" in a:
                k, _, v = a.partition("=")
                flags[k.replace("-", "_")] = _coerce(v)
            else:
                k = a.replace("-", "_")
                flags.setdefault(k, BARE)
                flags.setdefault("_bare", []).append(k)
        return flags

    def run(self, broker: Any, words: Sequence[str]) -> Any:
        path, flags = self.resolve(words)
        fn, usage, _ = self._commands[path]
        try:
            return fn(broker, flags)
        except CommandError as e:
            if e.usage is None:
                e.usage = usage
            raise

    def usage_overview(self) -> str:
        lines = ["Usage: vmq-admin <command>", "", "Commands:"]
        seen = set()
        for p, u, h in self.commands():
            head = p[0]
            if head not in seen:
                seen.add(head)
                lines.append(f"  {head}")
        lines.append("")
        lines.append("Run a full command for detailed output; "
                     "flags are key=value pairs.")
        return "\n".join(lines)


def _coerce(v: str) -> Any:
    if v.lower() in ("true", "on", "yes"):
        return True
    if v.lower() in ("false", "off", "no"):
        return False
    try:
        return int(v)
    except ValueError:
        pass
    try:
        return float(v)
    except ValueError:
        pass
    return v


# --------------------------------------------------------------------------
# core command set (vmq_server_cli.erl usage tree :521-584)
# --------------------------------------------------------------------------

def register_core_commands(reg: CommandRegistry) -> CommandRegistry:
    reg.register(["node", "status"], _node_status, "vmq-admin node status")
    reg.register(["cluster", "show"], _cluster_show, "vmq-admin cluster show")
    reg.register(["cluster", "join"], _cluster_join,
                 "vmq-admin cluster join discovery-node=HOST:PORT")
    reg.register(["cluster", "leave"], _cluster_leave,
                 "vmq-admin cluster leave node=NodeName")
    reg.register(["cluster", "fix-dead-queues"], _cluster_fix_dead_queues,
                 "vmq-admin cluster fix-dead-queues [targets=n1,n2]")
    reg.register(["cluster", "migrations"], _cluster_migrations,
                 "vmq-admin cluster migrations")
    reg.register(["cluster", "health"], _cluster_health,
                 "vmq-admin cluster health  (per-peer failure-detector "
                 "verdict, suspicion phi, gossiped load score, "
                 "last-heartbeat age, quorum)")
    reg.register(["cluster", "drain-node"], _cluster_drain_node,
                 "vmq-admin cluster drain-node [targets=n1,n2]  "
                 "(evacuate this node: flush filter windows, hand "
                 "every persistent queue + owned mesh slice to live "
                 "peers through bounded live handoffs)")
    reg.register(["handoff", "show"], _handoff_show,
                 "vmq-admin handoff show  (in-flight freeze->drain->"
                 "fence->adopt moves, recent history, admission "
                 "breaker)")
    reg.register(["handoff", "drain"], _handoff_drain,
                 "vmq-admin handoff drain client-id=CID target=Node "
                 "[mountpoint=]  (live session handoff — bounded "
                 "pause, zero QoS>=1 loss, rollback on deadline)")
    reg.register(["handoff", "rebalance"], _handoff_rebalance,
                 "vmq-admin handoff rebalance  (move local mesh "
                 "slices the round-robin assigns elsewhere, one "
                 "bounded handoff per slice)")
    reg.register(["cluster", "spool", "show"], _cluster_spool_show,
                 "vmq-admin cluster spool show")
    reg.register(["cluster", "spool", "flush"], _cluster_spool_flush,
                 "vmq-admin cluster spool flush [node=NodeName]")
    reg.register(["session", "disconnect"], _session_disconnect,
                 "vmq-admin session disconnect client-id=CID "
                 "[mountpoint=] [cleanup=true]")
    reg.register(["webhooks", "register"], _webhooks_register,
                 "vmq-admin webhooks register hook=H endpoint=URL "
                 "[base64payload=true]")
    reg.register(["webhooks", "deregister"], _webhooks_deregister,
                 "vmq-admin webhooks deregister hook=H endpoint=URL")
    reg.register(["webhooks", "show"], _webhooks_show,
                 "vmq-admin webhooks show")
    reg.register(["session", "show"], _session_show,
                 "vmq-admin session show [--limit=N] [client_id=X] "
                 "[order_by=f1,f2] [--<field>...]")
    reg.register(["ql", "query"], _ql_query,
                 "vmq-admin ql query q='SELECT f FROM sessions|queues|"
                 "subscriptions|messages|retain|retained_index|events|"
                 "cluster_health "
                 "[WHERE ...] [ORDER BY f [DESC]] [LIMIT n]'")
    reg.register(["queue", "show"], _queue_show,
                 "vmq-admin queue show [--limit=N]")
    reg.register(["subscription", "show"], _subscription_show,
                 "vmq-admin subscription show [--limit=N]")
    reg.register(["retain", "show"], _retain_show,
                 "vmq-admin retain show [--limit=N]")
    reg.register(["retain", "index"], _retain_index_show,
                 "vmq-admin retain index  (device retained-index status; "
                 "row diffs via ql table retained_index)")
    reg.register(["metrics", "show"], _metrics_show,
                 "vmq-admin metrics show [--with-descriptions]")
    reg.register(["plugin", "show"], _plugin_show, "vmq-admin plugin show")
    reg.register(["bridge", "show"], _bridge_show, "vmq-admin bridge show")
    reg.register(["trace", "client"], _trace_client,
                 "vmq-admin trace client client-id=X [mountpoint=MP] "
                 "[payload-limit=N] [rate-max=N] [rate-interval=Secs]")
    reg.register(["trace", "show"], _trace_show, "vmq-admin trace show")
    reg.register(["trace", "stop"], _trace_stop, "vmq-admin trace stop")
    reg.register(["churney", "start"], _churney_start,
                 "vmq-admin churney start [host=H] [port=P] [concurrency=N]")
    reg.register(["churney", "report"], _churney_report,
                 "vmq-admin churney report")
    reg.register(["churney", "stop"], _churney_stop, "vmq-admin churney stop")
    reg.register(["updo", "diff"], _updo_diff,
                 "vmq-admin updo diff  (changed-on-disk modules)")
    reg.register(["updo", "run"], _updo_run,
                 "vmq-admin updo run [dry=true]  (hot code upgrade; "
                 "re-executes changed modules' top level — top levels "
                 "must be side-effect-free)")
    reg.register(["script", "show"], _script_show,
                 "vmq-admin script show")
    reg.register(["script", "reload"], _script_reload,
                 "vmq-admin script reload path=/path/to/script.lua")
    reg.register(["plugin", "enable"], _plugin_enable,
                 "vmq-admin plugin enable name=PluginName [opt=val...]")
    reg.register(["plugin", "disable"], _plugin_disable,
                 "vmq-admin plugin disable name=PluginName")
    reg.register(["config", "show"], _config_show,
                 "vmq-admin config show [key=K]")
    reg.register(["config", "set"], _config_set,
                 "vmq-admin config set key=value [key=value ...]")
    reg.register(["listener", "show"], _listener_show,
                 "vmq-admin listener show")
    reg.register(["listener", "start"], _listener_start,
                 "vmq-admin listener start address=A port=P "
                 "[--mqtt|--mqtts|--ws|--wss|--http]")
    reg.register(["listener", "stop"], _listener_stop,
                 "vmq-admin listener stop address=A port=P")
    reg.register(["listener", "restart"], _listener_restart,
                 "vmq-admin listener restart address=A port=P")
    reg.register(["listener", "delete"], _listener_delete,
                 "vmq-admin listener delete address=A port=P")
    reg.register(["config", "reset"], _config_reset,
                 "vmq-admin config reset key=K [key=K2 ...]")
    reg.register(["node", "stop"], _node_stop,
                 "vmq-admin node stop  (graceful broker shutdown)")
    reg.register(["node", "start"], _node_start, "vmq-admin node start")
    reg.register(["node", "upgrade"], _node_upgrade,
                 "vmq-admin node upgrade [dry=true]  (alias of updo run)")
    reg.register(["script", "load"], _script_load,
                 "vmq-admin script load path=/path/to/script")
    reg.register(["script", "unload"], _script_unload,
                 "vmq-admin script unload path=/path/to/script")
    reg.register(["webhooks", "cache"], _webhooks_cache,
                 "vmq-admin webhooks cache  (stats; resets after show)")
    reg.register(["api-key", "create"], _api_key_create,
                 "vmq-admin api-key create")
    reg.register(["api-key", "show"], _api_key_show, "vmq-admin api-key show")
    reg.register(["api-key", "delete"], _api_key_delete,
                 "vmq-admin api-key delete key=KEY")
    reg.register(["fault", "show"], _fault_show, "vmq-admin fault show")
    reg.register(["fault", "inject"], _fault_inject,
                 "vmq-admin fault inject point=P "
                 "[kind=error|latency|hang|wedge] [probability=1.0] "
                 "[after=0] [count=-1] [latency-ms=0] [seed=0]")
    reg.register(["fault", "clear"], _fault_clear, "vmq-admin fault clear")
    reg.register(["fault", "release"], _fault_release,
                 "vmq-admin fault release point=P  (free a wedge fault)")
    reg.register(["watchdog", "show"], _watchdog_show,
                 "vmq-admin watchdog show  (in-flight monitored ops, "
                 "stall/abandon/late-discard counters)")
    reg.register(["workers", "show"], _workers_show,
                 "vmq-admin workers show  (per-worker health/pressure "
                 "rows from the shared stats block + match-service "
                 "state; multi-process mode only)")
    reg.register(["mesh", "show"], _mesh_show,
                 "vmq-admin mesh show  (slice map: slice->node "
                 "ownership, rows/slice, delta-route counts; mesh "
                 "mode only)")
    reg.register(["breaker", "show"], _breaker_show,
                 "vmq-admin breaker show")
    reg.register(["breaker", "trip"], _breaker_trip,
                 "vmq-admin breaker trip [mountpoint=] "
                 "[path=match|retained|predicate|wire|store|handoff]")
    reg.register(["breaker", "reset"], _breaker_reset,
                 "vmq-admin breaker reset [mountpoint=] "
                 "[path=match|retained|predicate|wire|store|handoff]")
    reg.register(["store", "show"], _store_show,
                 "vmq-admin store show  (storage tier: engine kinds, "
                 "segments, live/garbage bytes, compaction + resume "
                 "collector counters, breaker)")
    reg.register(["store", "compact"], _store_compact,
                 "vmq-admin store compact [budget=BYTES]  (schedule "
                 "one budgeted off-loop maintenance pass now)")
    reg.register(["schema", "show"], _schema_show,
                 "vmq-admin schema show [mountpoint=MP]",
                 "Registered payload schemas (replicated cluster-wide "
                 "through the metadata plane)")
    reg.register(["schema", "set"], _schema_set,
                 "vmq-admin schema set topic=FILTER "
                 "fields=name:kind,... [mountpoint=MP]  (kinds: "
                 "number, bool, enum(a|b|...))")
    reg.register(["schema", "del"], _schema_del,
                 "vmq-admin schema del topic=FILTER [mountpoint=MP]")
    reg.register(["filter", "show"], _filter_show,
                 "vmq-admin filter show  (payload-filter engine: "
                 "compiled predicates, window table, device-vs-host "
                 "split, breaker)")
    reg.register(["timeline", "show"], _timeline_show,
                 "vmq-admin timeline show [n=20]",
                 "Recent flight-recorder publish samples with "
                 "per-stage latency deltas")
    reg.register(["timeline", "dump"], _timeline_dump,
                 "vmq-admin timeline dump [path=timeline.json] "
                 "[--merge]",
                 "Export flight-recorder samples + device dispatch "
                 "records + control-plane events as Chrome trace-event "
                 "JSON (Perfetto); --merge folds every worker slot's "
                 "event stream into the one artifact")
    reg.register(["events", "show"], _events_show,
                 "vmq-admin events show [n=50] [code=C] [since=T]",
                 "Recent control-plane journal events (breaker/"
                 "governor/watchdog/supervisor/mesh/spool/wire/canary "
                 "transitions); since=<monotonic> tail-follows")
    reg.register(["events", "dump"], _events_dump,
                 "vmq-admin events dump [path=events.json] [--merge]",
                 "Export the event journal as one JSON artifact; "
                 "--merge folds every worker slot (and the match "
                 "service) into it")
    reg.register(["profile", "device"], _profile_device,
                 "vmq-admin profile device [kind=match] [n=20]",
                 "Per-dispatch device profile: K, batch fill, "
                 "Bpad/Dpad, compile-vs-execute, rebuild phases")
    reg.register(["overload", "show"], _overload_show,
                 "vmq-admin overload show  (governor level, fused "
                 "signals, per-stage shed counters)")
    reg.register(["overload", "set-level"], _overload_set_level,
                 "vmq-admin overload set-level level=0..3|auto  "
                 "(pin a level for drills, like breaker trip)")
    reg.register(["api-key", "add"], _api_key_add,
                 "vmq-admin api-key add key=KEY")
    return reg


def _node_status(broker, flags):
    return {"table": [{
        "node": broker.node_name,
        "running": True,
        "uptime_s": round(time.time() - broker._started, 1),
        "sessions": len(broker.sessions),
        "queues": len(broker.registry.queues),
        "subscriptions": int(broker.registry.stats()["router_subscriptions"]),
    }]}


def _cluster_show(broker, flags):
    rows = [{"node": broker.node_name, "running": True, "self": True}]
    if broker.cluster is not None:
        for node, up in broker.cluster.status():
            if node != broker.node_name:
                rows.append({"node": node, "running": up, "self": False})
    mm = getattr(broker, "mesh_map", None)
    if mm is not None:
        # mesh slice ownership per node (the gossiped slice map —
        # `vmq-admin mesh show` has the per-slice detail)
        counts = mm.counts_by_node()
        for r in rows:
            r["mesh_slices"] = counts.get(r["node"], 0)
    health = getattr(broker.cluster, "health", None) \
        if broker.cluster is not None else None
    if health is not None:
        # the failure detector's verdict, alongside the TCP-level
        # "running" flag (`cluster health` has phi/load/age detail)
        for r in rows:
            r["health"] = health.state_of(r["node"])
    return {"table": rows}


def _cluster_health(broker, flags):
    """Per-peer accrual failure-detector state (cluster/health.py):
    alive/suspect/down verdict, current suspicion phi, gossiped load
    score and last-heartbeat age, plus the quorum verdict gating the
    automatic rebalance planner."""
    health = getattr(broker.cluster, "health", None) \
        if broker.cluster is not None else None
    if health is None:
        raise CommandError("health plane not running (not clustered, "
                           "or health_enabled=false)")
    return {"table": health.status_rows(),
            "quorum": health.quorum_ok()}


def _mesh_show(broker, flags):
    """Slice map + routing counters of the mesh-native matcher
    (parallel/mesh_match.py, cluster/mesh_map.py)."""
    mm = getattr(broker, "mesh_map", None)
    view = broker.registry.reg_views.get("tpu")
    st_fn = getattr(view, "mesh_status", None)
    st = st_fn() if st_fn is not None else None
    if mm is None and not st:
        raise CommandError("no mesh configured (tpu_mesh unset, or "
                           "tpu_mesh_native=false)")
    n = mm.n_slices if mm is not None else st["slices"]
    owners = {r["slice"]: r for r in mm.snapshot()} if mm is not None \
        else {}
    rps = (st or {}).get("rows_per_slice", [])
    slice_rows = (st or {}).get("slice_rows", 0)
    addressable = set((st or {}).get("addressable", []))
    rows = []
    for s in range(n):
        rec = owners.get(s, {})
        rows.append({
            "slice": s,
            "node": rec.get("node"),
            "epoch": rec.get("epoch", 0),
            "rows": rps[s] if s < len(rps) else None,
            "window": slice_rows or None,
            "resident": s in addressable,
        })
    out: Dict[str, Any] = {"table": rows}
    if st:
        out["routing"] = {
            "delta_flushes": st["route_flushes"],
            "dirty_slices": st["route_dirty_slices"],
            "gzone_flushes": st["route_gzone_flushes"],
            "delta_rows": st["route_rows"],
            "full_scatters": st["full_scatters"],
            "dispatches": st["mesh_dispatches"],
            "slice_adoptions": st.get("slice_adoptions", 0),
            "last": st.get("last_route", {}),
        }
    return out


def _cluster_join(broker, flags):
    if broker.cluster is None:
        raise CommandError("clustering is not enabled on this node")
    target = flags.get("discovery_node")
    if not isinstance(target, str) or ":" not in target:
        raise CommandError("discovery-node=HOST:PORT required")
    host, _, port = target.rpartition(":")
    broker.cluster.join(host, int(port))
    return f"join request sent to {target}"


def _cluster_leave(broker, flags):
    import asyncio

    if broker.cluster is None:
        raise CommandError("clustering is not enabled on this node")
    node = flags.get("node")
    if not isinstance(node, str):
        raise CommandError("node=NodeName required")
    if node == broker.node_name:
        # graceful leave: migrate every locally-homed offline queue to the
        # live peers, then flip membership (vmq_reg:migrate_offline_queues
        # behind `vmq-admin cluster leave`, vmq_reg.erl:433-477). Strong
        # reference via _bg_tasks (the loop holds tasks weakly) + an
        # error-surfacing callback: the command returns before the
        # migration finishes.
        task = asyncio.get_event_loop().create_task(
            broker.cluster.leave_gracefully())
        broker._bg_tasks.append(task)

        def _done(t):
            if not t.cancelled() and t.exception() is not None:
                import logging

                logging.getLogger("vernemq_tpu_torch.cluster").error(
                    "graceful leave failed: %s", t.exception())

        task.add_done_callback(_done)
        return (f"node {node} leaving: offline queues migrating to live "
                f"peers — progress via `vmq-admin cluster migrations`")
    broker.cluster.leave(node)
    return (f"node {node} removed from the cluster (if it died without "
            f"leaving, run `vmq-admin cluster fix-dead-queues`)")


def _cluster_fix_dead_queues(broker, flags):
    if broker.cluster is None:
        raise CommandError("clustering is not enabled on this node")
    targets = flags.get("targets")
    if isinstance(targets, str):
        targets = [t for t in targets.split(",") if t]
    try:
        fixed = broker.cluster.fix_dead_queues(targets)
    except RuntimeError as e:
        raise CommandError(str(e)) from None
    return f"fixed {fixed} dead subscriber records"


def _cluster_migrations(broker, flags):
    rows = [{"subscriber": f"{sid[0]}/{sid[1]}", "target": m["target"],
             "pending": m["pending"], "retries": m["retries"],
             "tried": ",".join(m.get("tried", [m["target"]])),
             "state": m["state"]}
            for sid, m in sorted(broker.migrations.items())]
    return {"table": rows}


def _cluster_drain_node(broker, flags):
    """Whole-node evacuation behind `vmq-admin cluster drain-node`:
    every unit moves through its own bounded freeze->drain->fence->
    adopt handoff, so one wedged move rolls back alone while the sweep
    continues. Background task (same pattern as graceful leave) — the
    command returns immediately; progress via `handoff show`."""
    import asyncio

    targets = flags.get("targets")
    if isinstance(targets, str):
        targets = [t for t in targets.split(",") if t]

    task = asyncio.get_event_loop().create_task(
        broker.handoff.drain_node(targets))
    broker._bg_tasks.append(task)

    def _done(t):
        if not t.cancelled() and t.exception() is not None:
            import logging

            logging.getLogger("vernemq_tpu_torch.handoff").error(
                "drain-node failed: %s", t.exception())

    task.add_done_callback(_done)
    return ("node draining: queues and mesh slices handing off to "
            "live peers — progress via `vmq-admin handoff show`")


def _handoff_show(broker, flags):
    rows = broker.handoff.status_rows()
    st = broker.handoff.breaker.status()
    out = {"breaker": st["state"],
           "started": broker.handoff.started,
           "completed": broker.handoff.completed,
           "rollbacks": broker.handoff.rollbacks}
    if rows:
        out["table"] = rows
        return out
    out["note"] = "no handoffs in flight or in recent history"
    return out


def _handoff_drain(broker, flags):
    """One live-session handoff, synchronously awaited: the bounded
    pause IS the command latency, so the operator sees the verdict."""
    from ..cluster.handoff import HandoffRefused

    cid = flags.get("client-id") or flags.get("client_id")
    if not cid:
        raise CommandError("client-id is required")
    target = flags.get("target")
    if not isinstance(target, str) or not target:
        raise CommandError("target=NodeName required")
    sid = (flags.get("mountpoint", ""), cid)
    # cheap admission checks surface synchronously; the FSM re-checks
    # (the background task can only log)
    if broker.cluster is None:
        raise CommandError("clustering is not enabled on this node")
    if broker.registry.queues.get(sid) is None:
        raise CommandError(f"no queue for {sid!r}")

    async def _go():
        try:
            return await broker.handoff.handoff_session(sid, target)
        except HandoffRefused as e:
            raise CommandError(str(e)) from None

    return _await_admin(broker, _go())


def _handoff_rebalance(broker, flags):
    from ..cluster.handoff import HandoffRefused

    async def _go():
        try:
            return await broker.handoff.rebalance_slices()
        except HandoffRefused as e:
            raise CommandError(str(e)) from None

    res = _await_admin(broker, _go())
    if isinstance(res, dict):
        return (f"moved slices {res['moved']} (failed {res['failed']}) "
                f"across {res['members']}")
    return res


def _await_admin(broker, coro):
    """Run a coroutine to completion from an admin command handler.
    Admin handlers are called ON the broker loop (sync), so awaiting
    inline would deadlock — schedule and report instead when a loop is
    already running; block only from a loop-less caller (tests)."""
    import asyncio

    try:
        loop = asyncio.get_event_loop()
    except RuntimeError:
        loop = None
    if loop is not None and loop.is_running():
        task = loop.create_task(coro)
        broker._bg_tasks.append(task)

        def _done(t):
            if not t.cancelled() and t.exception() is not None:
                import logging

                logging.getLogger("vernemq_tpu_torch.handoff").error(
                    "handoff command failed: %s", t.exception())

        task.add_done_callback(_done)
        return ("handoff started in the background — progress via "
                "`vmq-admin handoff show`")
    return asyncio.get_event_loop().run_until_complete(coro) \
        if loop is not None else asyncio.run(coro)


def _cluster_spool(broker):
    cl = broker.cluster
    if cl is None:
        raise CommandError("clustering is not enabled on this node")
    if cl.spool is None:
        raise CommandError("the cluster spool is disabled "
                           "(cluster_spool_enabled=false)")
    return cl


def _cluster_spool_show(broker, flags):
    cl = _cluster_spool(broker)
    rows = []
    for r in cl.spool.peer_stats():
        r["spool_capable"] = "spool" in cl._peer_caps.get(r["peer"], ())
        rows.append(r)
    if not rows:
        return "spool empty (no QoS>=1 frames journaled)"
    return {"table": rows}


def _cluster_spool_flush(broker, flags):
    cl = _cluster_spool(broker)
    node = flags.get("node")
    frames, nbytes = cl.spool.flush(node if isinstance(node, str) else None)
    where = f" for {node}" if node else ""
    return (f"flushed {frames} spooled frame(s) ({nbytes} bytes){where}; "
            f"their cross-node delivery guarantee is waived")


_SESSION_FIELDS = ("client_id", "mountpoint", "user", "peer_host", "peer_port",
                   "protocol", "is_online", "queue_size", "clean_session")


def _loose_eq(row_value: Any, want: Any) -> bool:
    """Filter equality tolerant of flag coercion: a client_id of "123"
    must match the int-coerced flag value 123."""
    if row_value == want:
        return True
    if isinstance(want, bool) or isinstance(row_value, bool):
        return str(row_value).lower() == str(want).lower()
    return str(row_value) == str(want)


def _session_disconnect(broker, flags):
    """Forcibly disconnect a live session (vmq-admin session disconnect,
    vmq_info_cli's disconnect command); cleanup=true also discards the
    persistent queue (clean-session semantics on the way out)."""
    import asyncio

    cid = flags.get("client-id") or flags.get("client_id")
    if not cid:
        raise CommandError("client-id is required")
    mp = flags.get("mountpoint", "")
    sid = (mp, cid)
    session = broker.sessions.get(sid)
    if session is None:
        raise CommandError(f"no live session for {sid!r}")
    cleanup = str(flags.get("cleanup", "false")).lower() in ("true", "1")

    async def _close():
        await session.close("administrative_action", send_will=False)
        if cleanup:
            broker.registry.cleanup_subscriber(sid)

    asyncio.get_event_loop().create_task(_close())
    return f"disconnect scheduled for {cid!r}" + \
        (" (with cleanup)" if cleanup else "")


def _webhooks_plugin(broker):
    p = broker.plugins._enabled.get("vmq_webhooks")
    if p is None:
        raise CommandError("vmq_webhooks plugin is not enabled")
    return p


def _webhooks_register(broker, flags):
    hook, endpoint = flags.get("hook"), flags.get("endpoint")
    if not hook or not endpoint:
        raise CommandError("hook and endpoint are required")
    b64 = str(flags.get("base64payload", "true")).lower() in ("true", "1")
    try:
        _webhooks_plugin(broker).register_endpoint(
            hook, endpoint, base64_payload=b64)
    except ValueError as e:
        raise CommandError(str(e)) from None
    return f"registered {endpoint} for {hook}"


def _webhooks_deregister(broker, flags):
    hook, endpoint = flags.get("hook"), flags.get("endpoint")
    if not hook or not endpoint:
        raise CommandError("hook and endpoint are required")
    _webhooks_plugin(broker).deregister_endpoint(hook, endpoint)
    return f"deregistered {endpoint} for {hook}"


def _webhooks_show(broker, flags):
    p = _webhooks_plugin(broker)
    return {"table": [
        {"hook": h, "endpoint": e, "base64payload": o.get("base64_payload")}
        for h, lst in sorted(p.endpoints.items()) for e, o in lst]}


def _session_show(broker, flags):
    # vmq_ql-backed in the reference (vmq_info.erl); shares ql.run_query
    from .ql import run_query

    limit = int(flags.pop("limit", 100))
    order_raw = flags.pop("order_by", flags.pop("order-by", None))
    # order_by=f1,f2:desc — same engine (and DESC support) as `ql query`
    order_by = None
    if order_raw is not None:
        order_by = []
        for part in str(order_raw).split(","):
            field, _, direction = part.strip().partition(":")
            order_by.append((field, -1 if direction.lower() == "desc"
                             else 1))
    # bare --field flags select columns; key=value pairs filter rows
    bare = flags.pop("_bare", [])
    fields = [k for k in bare if k in _SESSION_FIELDS] or list(_SESSION_FIELDS)
    where = {k: v for k, v in flags.items() if v is not BARE}

    def match(row):
        return all(_loose_eq(row.get(k), v) for k, v in where.items())

    return {"table": run_query(broker, "sessions", fields, match,
                               order_by, limit)}


def _ql_query(broker, flags):
    """vmq-admin ql query q='SELECT ... FROM ...' — the raw vmq_ql
    surface (vmq_ql_query_mgr fold_query)."""
    from .ql import QLError
    from .ql import query as ql_query

    q = flags.get("q") or flags.get("query")
    if not q or q is BARE:
        raise CommandError("usage: ql query q='SELECT ... FROM sessions'")
    try:
        return {"table": ql_query(broker, str(q))}
    except QLError as e:
        raise CommandError(f"ql: {e}") from None


def _queue_show(broker, flags):
    limit = int(flags.get("limit", 100))
    rows = []
    for sid, q in list(broker.registry.queues.items())[:limit]:
        info = q.info()
        info["mountpoint"], info["client_id"] = sid
        rows.append(info)
    return {"table": rows}


def _subscription_show(broker, flags):
    from .ql import subscription_rows

    limit = int(flags.get("limit", 100))
    rows = []
    for row in subscription_rows(broker):
        rows.append(row)
        if len(rows) >= limit:
            break
    return {"table": rows}


def _retain_show(broker, flags):
    from .ql import retain_rows

    limit = int(flags.get("limit", 100))
    rows = []
    for row in retain_rows(broker):
        row.pop("payload", None)  # CLI listing shows sizes, not bodies
        rows.append(row)
        if len(rows) >= limit:
            break
    return {"table": rows}


def _retain_index_show(broker, flags):
    """Device retained-index status per mountpoint (rows, dispatches,
    host fallbacks, breaker) — the operator's device-vs-host-store view;
    row-level diffing lives in the ``retained_index`` QL table."""
    eng = getattr(broker, "_retained_engine", None)
    if eng is None or not eng._indexes:
        return ("retained device index not active (needs "
                "default_reg_view=tpu, tpu_retained_enabled, and at "
                "least one replayed subscribe)")
    rows = [{"mountpoint": mp or "(default)", **idx.status()}
            for mp, idx in eng._indexes.items()]
    return {"table": rows}


def _metrics_show(broker, flags):
    with_desc = bool(flags.get("with_descriptions"))
    rows = []
    for k, v in sorted(broker.metrics.all_metrics().items()):
        row = {"metric": k, "value": v}
        if with_desc:
            row["description"] = broker.metrics.describe(k)
        rows.append(row)
    return {"table": rows}


def _churney_start(broker, flags):
    """Session-churn self-test (vmq_churney.erl)."""
    if getattr(broker, "churney", None) is not None:
        raise CommandError("churney already running")
    from .churney import Churney

    listeners = broker.listeners.show() if broker.listeners else []
    mqtt = [l for l in listeners if l.get("type") == "mqtt"]
    host = flags.get("host") or (mqtt[0]["address"] if mqtt else "127.0.0.1")
    port = int(flags.get("port") or (mqtt[0]["port"] if mqtt else 1883))
    broker.churney = Churney(broker, host, port,
                             concurrency=int(flags.get("concurrency", 1)))
    broker.churney.start()
    return {"text": f"churney started against {host}:{port}"}


def _churney_report(broker, flags):
    import json

    ch = getattr(broker, "churney", None)
    if ch is None:
        raise CommandError("churney not running")
    return {"text": json.dumps(ch.report(), indent=2)}


def _churney_stop(broker, flags):
    import json

    ch = getattr(broker, "churney", None)
    if ch is None:
        raise CommandError("churney not running")
    report = ch.report()
    ch.stop()
    broker.churney = None
    return {"text": json.dumps(report, indent=2)}


def _trace_client(broker, flags):
    """Start tracing a client's sessions (vmq_tracer_cli trace_client_cmd)."""
    client_id = flags.get("client_id")
    if not client_id:
        raise CommandError("client-id=X is required")
    try:
        broker.start_trace(
            client_id,
            mountpoint=flags.get("mountpoint", ""),
            payload_limit=int(flags.get("payload_limit", 1000)),
            max_rate=(int(flags.get("rate_max", 10)),
                      float(flags.get("rate_interval", 0.1))))
    except RuntimeError as e:
        raise CommandError(str(e))
    return {"text": f'Tracing client "{client_id}". '
                    "Use `trace show` to drain output, `trace stop` to end."}


def _trace_show(broker, flags):
    if broker.tracer is None:
        raise CommandError("no trace running")
    return {"text": "\n".join(broker.tracer.drain())}


def _trace_stop(broker, flags):
    if broker.tracer is None:
        raise CommandError("no trace running")
    info = broker.tracer.info()
    broker.stop_trace()
    return {"text": f"Trace for \"{info['client_id']}\" stopped "
                    f"after {info['traced_frames']} frames."}


def _bridge_show(broker, flags):
    """vmq-admin bridge show (the vmq_bridge_cli info table)."""
    plugin = broker.plugins.get("vmq_bridge")
    rows = plugin.show() if plugin is not None else []
    return {"table": rows}


def _script_show(broker, flags):
    """vmq-admin script show — loaded Lua/Python scripts and their hooks
    (vmq_diversity_cli 'script' command group)."""
    plugin = broker.plugins.get("vmq_diversity")
    if plugin is None:
        return {"table": []}
    return {"table": plugin.show()}


def _updo_diff(broker, flags):
    """vmq-admin updo diff (vmq_updo:dry_run/0 — the changed set)."""
    from ..broker import updo

    changed = updo.diff()
    if not changed:
        return "no modules changed on disk"
    return "\n".join(changed)


def _updo_run(broker, flags):
    """vmq-admin updo run [dry=true] (vmq_updo:run/0)."""
    from ..broker import updo

    dry = str(flags.get("dry", "")).lower() in ("true", "1", "on", "yes")
    rep = updo.run(dry_run=dry)
    lines = [("plan (dry run):" if dry else "upgraded:")]
    lines += [f"  {m}" for m in (rep["changed"] if dry
                                 else rep["upgraded"])] or ["  (none)"]
    for mod, errs in rep["failed"].items():
        lines.append(f"FAILED {mod}:")
        lines += [f"  {e}" for e in errs]
    for mod, names in rep["removed"].items():
        lines.append(f"removed in {mod}: {', '.join(names)} "
                     "(live references keep the old code)")
    return "\n".join(lines)


def _script_reload(broker, flags):
    """vmq-admin script reload path=... (vmq_diversity_cli reload)."""
    plugin = broker.plugins.get("vmq_diversity")
    if plugin is None:
        raise CommandError("vmq_diversity plugin not enabled")
    path = flags.get("path")
    if not isinstance(path, str):
        raise CommandError("path=/path/to/script required")
    if path not in plugin.scripts:
        raise CommandError(f"no such script {path!r}")
    try:
        plugin.reload_script(path)
    except Exception as e:  # syntax error / missing file: clean CLI error
        raise CommandError(f"reload failed: {e}") from e
    return f"script {path} reloaded"


def _plugin_show(broker, flags):
    return {"table": [{"plugin": name, "info": info}
                      for name, info in broker.plugins.show()]}


def _plugin_enable(broker, flags):
    flags.pop("_bare", None)
    name = flags.pop("name", None)
    if not isinstance(name, str):
        raise CommandError("name=PluginName required")
    broker.plugins.enable(name, **flags)
    return f"plugin {name} enabled"


def _plugin_disable(broker, flags):
    name = flags.get("name")
    if not isinstance(name, str):
        raise CommandError("name=PluginName required")
    broker.plugins.disable(name)
    return f"plugin {name} disabled"


def _config_show(broker, flags):
    snap = broker.config.snapshot()
    if "key" in flags:
        key = flags["key"]
        if key not in snap:
            raise CommandError(f"unknown config key: {key}")
        return {"table": [{"key": key, "value": snap[key]}]}
    return {"table": [{"key": k, "value": v} for k, v in sorted(snap.items())]}


def _config_set(broker, flags):
    if not flags:
        raise CommandError("config set needs key=value pairs")
    for k, v in flags.items():
        try:
            broker.config.set(k, v)
        except KeyError:
            raise CommandError(f"unknown config key: {k}") from None
    return f"{len(flags)} config value(s) updated"


def _listener_manager(broker):
    lm = getattr(broker, "listeners", None)
    if lm is None:
        raise CommandError("listener manager not running")
    return lm


def _listener_show(broker, flags):
    return {"table": _listener_manager(broker).show()}


def _listener_start(broker, flags):
    lm = _listener_manager(broker)
    addr = str(flags.get("address", "127.0.0.1"))
    port = int(flags.get("port", 0))
    kind = "mqtt"
    for k in ("mqtt", "mqtts", "ws", "wss", "http", "https", "vmq", "vmqs"):
        if flags.get(k):
            kind = k
    import asyncio

    listener = asyncio.get_event_loop().create_task(
        lm.start_listener(kind, addr, port, flags))
    lm.track_start_task(listener)
    return f"starting {kind} listener on {addr}:{port}"


def _listener_stop(broker, flags):
    lm = _listener_manager(broker)
    addr = str(flags.get("address", "127.0.0.1"))
    port = int(flags.get("port", 0))
    lm.stop_listener(addr, port)
    return f"listener {addr}:{port} stopping"


def _listener_restart(broker, flags):
    """vmq-admin listener restart: stop-and-start with retained opts."""
    import asyncio

    lm = _listener_manager(broker)
    addr = str(flags.get("address", "127.0.0.1"))
    port = int(flags.get("port", 0))
    if (addr, port) not in lm._listeners:
        raise CommandError(f"no listener on {addr}:{port}")
    task = asyncio.get_event_loop().create_task(
        lm.restart_listener(addr, port))
    lm.track_start_task(task)
    return f"listener {addr}:{port} restarting"


def _listener_delete(broker, flags):
    """vmq-admin listener delete: stop and forget the listener."""
    lm = _listener_manager(broker)
    addr = str(flags.get("address", "127.0.0.1"))
    port = int(flags.get("port", 0))
    try:
        lm.delete_listener(addr, port)
    except KeyError as e:
        raise CommandError(str(e)) from None
    return f"listener {addr}:{port} deleted"


def _config_reset(broker, flags):
    """vmq-admin config reset key=K: back to the compiled default."""
    import copy

    from ..broker.config import DEFAULTS

    # both spellings work: `config reset key=K` and `config reset K1 K2`
    # (the flags dict collapses repeated key=..., so multi-key uses the
    # bare form, which _parse_flags records in order under "_bare")
    keys = list(flags.pop("_bare", []))
    for k, v in flags.items():
        if v is BARE:
            continue  # already in the bare list
        if k == "key":
            keys.append(v)
        else:
            raise CommandError(f"unexpected flag {k}={v!r}; usage: "
                               "config reset key=K | config reset K1 K2")
    if not keys:
        raise CommandError("config reset needs key=K or bare key names")
    for k in keys:
        if k not in DEFAULTS:
            raise CommandError(f"unknown config key: {k}")
    for k in keys:  # validate-all-then-apply: no partial resets
        # deep copy: DEFAULTS holds mutable values (lists/dicts) and the
        # live config must never alias the process-wide default objects
        broker.config.set(k, copy.deepcopy(DEFAULTS[k]))
    return f"{len(keys)} config value(s) reset to defaults"


def _node_stop(broker, flags):
    """vmq-admin node stop: graceful shutdown of this broker node —
    sessions closed through their lifecycle hooks, listeners down,
    state flushed (the vmq-admin node stop / vernemq stop path)."""
    import asyncio

    # broker.stop() owns the ordering: sessions first (lifecycle hooks
    # fire), then plugins, then listeners — stopping listeners first
    # would deadlock on wait_closed behind the still-open sessions
    task = asyncio.get_event_loop().create_task(broker.stop())

    def _done(t: "asyncio.Task") -> None:
        if not t.cancelled() and t.exception() is not None:
            import logging

            logging.getLogger("vernemq_tpu_torch.admin").error(
                "node stop failed mid-shutdown", exc_info=t.exception())

    task.add_done_callback(_done)
    return "draining sessions and stopping the node"


def _node_start(broker, flags):
    raise CommandError(
        "this admin channel lives inside a running broker; use the "
        "service launcher (python -m vernemq_tpu_torch.broker.server ...) to start one")


def _node_upgrade(broker, flags):
    """vmq-admin node upgrade: the hot-code-upgrade entry (vmq_updo:run
    behind the reference's upgrade command) — alias of `updo run`."""
    return _updo_run(broker, flags)


def _script_load(broker, flags):
    plugin = broker.plugins.get("vmq_diversity")
    if plugin is None:
        raise CommandError("vmq_diversity plugin not enabled")
    path = flags.get("path")
    if not isinstance(path, str):
        raise CommandError("path=/path/to/script required")
    try:
        plugin.load_script(path)
    except Exception as e:
        raise CommandError(f"load failed: {e}") from e
    return f"script {path} loaded"


def _script_unload(broker, flags):
    plugin = broker.plugins.get("vmq_diversity")
    if plugin is None:
        raise CommandError("vmq_diversity plugin not enabled")
    path = flags.get("path")
    if not isinstance(path, str):
        raise CommandError("path=/path/to/script required")
    if path not in plugin.scripts:
        raise CommandError(f"no such script {path!r}")
    plugin.unload_script(path)
    return f"script {path} unloaded"


def _webhooks_cache(broker, flags):
    """vmq-admin webhooks cache: hit/miss/entry stats, reset after show
    (vmq_webhooks_cli cache_stats_cmd + reset_stats)."""
    wh = broker.plugins.get("vmq_webhooks")
    if wh is None:
        raise CommandError("vmq_webhooks plugin not enabled")
    cache = wh.cache
    row = {"hits": cache.hits, "misses": cache.misses,
           "entries": len(cache._data)}
    cache.hits = 0
    cache.misses = 0
    return {"table": [row]}


# --- api keys: stored in replicated metadata (mgmt API auth) ---------------

API_KEY_PREFIX = "api_key"


def _api_key_create(broker, flags):
    key = secrets.token_urlsafe(24)
    broker.metadata.put(API_KEY_PREFIX, key, {"created": time.time()})
    return {"table": [{"key": key}]}


def _api_key_add(broker, flags):
    key = flags.get("key")
    if not isinstance(key, str):
        raise CommandError("key=KEY required")
    broker.metadata.put(API_KEY_PREFIX, key, {"created": time.time()})
    return f"api key added"


def _api_key_show(broker, flags):
    return {"table": [{"key": k} for k, _ in broker.metadata.fold(API_KEY_PREFIX)]}


def _api_key_delete(broker, flags):
    key = flags.get("key")
    if not isinstance(key, str):
        raise CommandError("key=KEY required")
    broker.metadata.delete(API_KEY_PREFIX, key)
    return "api key deleted"


def valid_api_key(broker, key: str) -> bool:
    return broker.metadata.get(API_KEY_PREFIX, key) is not None


# ------------------------------------------------- robustness (fault/breaker)

def _fault_show(broker, flags):
    """Active fault plan: rules, per-point hit counts, fired totals —
    wedge entries/releases counted separately from latency/hang."""
    from ..robustness import faults

    plan = faults.active()
    if plan is None:
        return "no fault plan installed"
    st = plan.status()
    rows = [{"rule": i, **r} for i, r in enumerate(st["rules"])]
    for point, hits in sorted(st["hits"].items()):
        rows.append({"rule": "", "point": point, "hits": hits})
    rows.append({"rule": "", "point": "(wedges)",
                 "hits": st["wedged"],
                 "wedged_now": st["wedged_now"],
                 "releases": st["wedge_releases"]})
    return {"table": rows}


def _fault_release(broker, flags):
    """Free a wedge fault blocked at point=P (the operator half of the
    escape path; the stall watchdog releases automatically at
    abandonment)."""
    from ..robustness import faults

    point = flags.get("point")
    if not isinstance(point, str):
        raise CommandError("point=NAME required (e.g. device.dispatch)")
    if faults.release(point):
        return f"wedge at {point} released"
    return f"no wedge blocked at {point}"


def _watchdog_show(broker, flags):
    """In-flight monitored operations + stall counters (the operator
    face of robustness/watchdog.py)."""
    wd = broker.watchdog
    stats = wd.stats()
    rows = [{"point": op["point"], "label": op["label"],
             "age_s": op["age_s"], "deadline_s": op["deadline_s"],
             "stalled": op["stalled"], "abandoned": op["abandoned"]}
            for op in wd.inflight()]
    if not rows:
        rows = [{"point": "(none in flight)", "label": "", "age_s": 0.0,
                 "deadline_s": 0.0, "stalled": False, "abandoned": False}]
    rows.append({"point": "(totals)", "label": "",
                 "age_s": stats["watchdog_inflight_age_max"],
                 "deadline_s": 0.0,
                 "stalled": int(stats["watchdog_stalls"]),
                 "abandoned": int(stats["watchdog_abandoned"])})
    rows.append({"point": "(late results discarded)", "label": "",
                 "age_s": 0.0, "deadline_s": 0.0,
                 "stalled": int(stats["watchdog_late_discarded"]),
                 "abandoned": int(stats["watchdog_cluster_stalls"])})
    return {"table": rows}


def _workers_show(broker, flags):
    """Per-worker health rows out of the shared stats block plus the
    match service header — the operator face of the multi-process
    front end (broker/workers.py, broker/match_service.py)."""
    ws = broker.worker_stats
    if ws is None:
        raise CommandError("not running in multi-process worker mode "
                           "(no shared stats block attached)")
    rows = []
    for s in ws.read_all():
        lags = sorted(s.pop("lag_samples", []))
        hb = s["heartbeat_age_s"]
        lag_p99 = (round(lags[min(len(lags) - 1,
                                  int(0.99 * len(lags)))] * 1e3, 2)
                   if lags else None)
        rows.append({
            "worker": s["worker"], "pid": s["pid"],
            "alive": hb is not None and hb < 5.0,
            "heartbeat_age_s": (round(hb, 2) if hb is not None
                                else None),
            "level": s["level"], "pressure": round(s["pressure"], 3),
            "sessions": s["sessions"],
            "admitted_pubs": s["admitted_pubs"],
            "loop_lag_ms_p99": lag_p99,
        })
    out = {"table": rows}
    svc = ws.service_info()
    if svc["epoch"]:
        out["match_service"] = {
            k: (round(v, 2) if isinstance(v, float) else v)
            for k, v in svc.items()}
    if broker.match_client is not None:
        out["match_client"] = {
            k: int(v) for k, v in broker.match_client.stats_dict().items()}
    return out


def _dump_async(path, blob, what):
    """Write one dump artifact atomically OFF the event loop (the admin
    handlers run on it — a multi-MB write to a slow disk must not stall
    session IO). Per-dump-unique tmp name so overlapping dumps to one
    path can't replace each other's half-written blob; a failure is
    logged (the command already returned — the broker log is the only
    place the operator can see it). Shared by `timeline dump` and
    `events dump` so the write protocol can't drift between them."""
    import threading as _threading

    def _write(p=path, b=blob):
        tmp = f"{p}.{os.getpid()}.{_threading.get_ident()}.tmp"
        try:
            with open(tmp, "w") as fh:
                fh.write(b)
            os.replace(tmp, p)
        except OSError:
            import logging

            logging.getLogger("vernemq_tpu_torch.admin").exception(
                "%s dump to %r failed", what, p)
            try:
                os.unlink(tmp)
            except OSError:
                pass

    _threading.Thread(target=_write, name=f"{what}-dump",
                      daemon=True).start()


def _timeline_show(broker, flags):
    """Recent flight-recorder samples (observability/recorder.py): one
    row per sampled publish, stage deltas in ms."""
    n = int(flags.get("n", 20) or 20)
    recs = broker.recorder.snapshot(limit=n)
    rows = []
    for r in recs:
        row = {"client": r.get("client"), "topic": r.get("topic"),
               "qos": r.get("qos"), "total_ms": r.get("total_ms"),
               "pid": r.get("pid")}
        if r.get("svc_pid"):
            row["svc_pid"] = r["svc_pid"]
        row.update(r.get("stages", {}))
        rows.append(row)
    if not rows:
        rows = [{"client": "(no samples yet)", "topic": "",
                 "qos": "", "total_ms": 0.0, "pid": 0}]
    st = broker.recorder.stats()
    return {"table": rows,
            "recorder": {k: int(v) for k, v in st.items()}}


def _timeline_dump(broker, flags):
    """Chrome trace-event export: flight-recorder publish stages plus
    device dispatch records plus control-plane journal events on one
    CLOCK_MONOTONIC axis, pid-tagged so worker, match-service and
    remote-node spans land in separate Perfetto tracks. ``--merge``
    folds every live worker slot's (and the match service's) event
    stream into this one artifact."""
    import json as _json

    from ..observability import chrome_trace
    from ..observability.profiler import profiler as _profiler

    trace = chrome_trace(broker.recorder.snapshot(),
                         _profiler().snapshot(),
                         node=broker.node_name,
                         journal_events=broker.merged_journal_events(
                             merge=bool(flags.get("merge"))))
    path = flags.get("path")
    if not isinstance(path, str) or not path:
        path = f"timeline_{broker.node_name}.json"
    _dump_async(path, _json.dumps(trace), "timeline")
    return {"writing": path, "events": len(trace["traceEvents"])}


def _events_show(broker, flags):
    """Recent control-plane journal events (observability/events.py):
    one row per state-machine transition, newest last. ``since=<t>``
    (a monotonic stamp from a previous call's last row) returns only
    newer events — the tail-follow loop for live debugging."""
    from ..observability import events as _events

    n = int(flags.get("n", 50) or 50)
    code = flags.get("code")
    since = flags.get("since")
    following = isinstance(since, (int, float))
    evs = _events.journal().snapshot(
        code=code if isinstance(code, str) else None,
        since=float(since) if following else None)
    # a plain show wants the NEWEST n; a since= follow must take the
    # OLDEST n past the cursor — keeping the newest would jump the
    # returned cursor over everything a bursty window emitted beyond
    # n, and the follower would silently lose exactly the storm the
    # journal exists to explain (the next poll catches up instead)
    evs = evs[:n] if following else evs[-n:]
    rows = [{
        "t": round(e["t"], 6),
        "time": time.strftime("%H:%M:%S", time.localtime(e["ts"]))
                + f".{int((e['ts'] % 1) * 1e3):03d}",
        "code": e["code"],
        "detail": e["detail"],
        "value": e["value"],
        "pid": e["pid"],
    } for e in evs]
    if not rows:
        rows = [{"t": 0.0, "time": "", "code": "(no events)",
                 "detail": "", "value": 0.0, "pid": 0}]
    out = {"table": rows,
           "journal": {k: int(v)
                       for k, v in _events.journal().stats().items()
                       if k.startswith("events_")}}
    if evs:
        # FULL precision: the snapshot filter is a strict `t > since`
        # at full float precision, so a rounded-DOWN cursor would
        # re-return its own event on every tail-follow poll
        out["cursor"] = evs[-1]["t"]
    return out


def _events_dump(broker, flags):
    """One JSON artifact of the event journal (``--merge``: every live
    worker slot's packed stream and the match service's folded in,
    interleaved by monotonic stamp). Same off-loop atomic write
    discipline as `timeline dump`."""
    import json as _json

    from ..observability import events as _events

    evs = broker.merged_journal_events(merge=bool(flags.get("merge")))
    blob = _json.dumps({
        "node": broker.node_name,
        "clock": "CLOCK_MONOTONIC",
        "merged": bool(flags.get("merge")),
        "codes": {c: sub for c, (sub, _h) in
                  _events.KNOWN_EVENTS.items()},
        "events": evs,
    })
    path = flags.get("path")
    if not isinstance(path, str) or not path:
        path = f"events_{broker.node_name}.json"
    _dump_async(path, blob, "events")
    return {"writing": path, "events": len(evs)}


def _profile_device(broker, flags):
    """Per-dispatch device profile records + per-kind aggregates (the
    operator face of observability/profiler.py)."""
    from ..observability.profiler import profiler as _profiler

    kind = flags.get("kind")
    n = int(flags.get("n", 20) or 20)
    prof = _profiler()
    rows = [dict(r) for r in prof.snapshot(
        kind if isinstance(kind, str) else None, limit=n)]
    for r in rows:
        r.pop("t0", None)
    if not rows:
        rows = [{"kind": "(no dispatches recorded)", "dur_ms": 0.0}]
    return {"table": rows,
            "summary": {k: {kk: round(vv, 3) for kk, vv in v.items()}
                        for k, v in prof.summary().items()}}


def _fault_inject(broker, flags):
    """Add a rule to the live fault plan (creating one if none active).
    ``seed=`` only takes effect when the call creates the plan — a live
    plan's streams must not be re-seeded mid-run."""
    from ..robustness import faults

    point = flags.get("point")
    if not isinstance(point, str):
        raise CommandError("point=NAME required (e.g. device.dispatch)")
    try:
        # a drill against a misspelled seam must fail here, not pass
        # vacuously (the registry the fault-registry lint pass enforces)
        faults.validate_point(point)
    except ValueError as e:
        raise CommandError(str(e))
    rule = faults.FaultRule(
        point=point,
        kind=str(flags.get("kind", "error")),
        probability=float(flags.get("probability", 1.0)),
        after=int(flags.get("after", 0)),
        count=int(flags.get("count", -1)),
        latency_ms=float(flags.get("latency_ms",
                                   flags.get("latency-ms", 0.0)) or 0.0),
    )
    if rule.kind not in ("error", "latency", "hang", "wedge"):
        raise CommandError("kind must be error, latency, hang or wedge")
    plan = faults.active()
    if plan is None:
        plan = faults.install(
            faults.FaultPlan(seed=int(flags.get("seed", 0))))
    plan.add_rule(rule)
    return (f"rule added to plan (seed {plan.seed}): {rule.as_dict()}")


def _fault_clear(broker, flags):
    from ..robustness import faults

    was = faults.active()
    faults.clear()
    return ("fault plan cleared" if was is not None
            else "no fault plan was installed")


def _tpu_view(broker):
    view = broker.registry.reg_views.get("tpu")
    if view is None or not hasattr(view, "breaker_status"):
        raise CommandError("tpu reg view not active")
    return view


def _breaker_show(broker, flags):
    """Both device paths' breakers: the publish matcher ("match") and
    the retained reverse-match index ("retained")."""
    rows = []
    try:
        for mp, st in _tpu_view(broker).breaker_status().items():
            if st is None:
                rows.append({"path": "match", "mountpoint": mp,
                             "state": "disabled"})
            else:
                rows.append({"path": "match", "mountpoint": mp, **st})
    except CommandError:
        pass  # tpu view not active; retained may still be
    eng = getattr(broker, "_retained_engine", None)
    if eng is not None:
        for mp, st in eng.breaker_status().items():
            if st is None:
                rows.append({"path": "retained", "mountpoint": mp,
                             "state": "disabled"})
            else:
                rows.append({"path": "retained", "mountpoint": mp, **st})
    feng = getattr(broker, "filter_engine", None)
    if feng is not None:
        for mp, st in feng.breaker_status().items():
            if st is None:
                rows.append({"path": "predicate", "mountpoint": mp,
                             "state": "disabled"})
            else:
                rows.append({"path": "predicate", "mountpoint": mp,
                             **st})
    # the wire-plane codec breaker is process-global (the native codec
    # is process state, not per-mountpoint): one row, always present
    from ..protocol import fastpath as _fastpath

    rows.append({"path": "wire", "mountpoint": "(all)",
                 **_fastpath.breaker.status()})
    # the store maintenance breaker: one per broker — open = budgeted
    # compaction paused, the engines run append-only
    rows.append({"path": "store", "mountpoint": "(all)",
                 **broker.store_breaker.status()})
    # the live-handoff admission breaker: open = new freeze/drain/
    # fence/adopt moves refused (units stay with their current owner)
    rows.append({"path": "handoff", "mountpoint": "(all)",
                 **broker.handoff.breaker.status()})
    return {"table": rows}


def _each_breaker(broker, flags):
    """Breakers selected by the optional mountpoint=/path= flags — both
    the publish matchers' and the retained indexes' breakers, so
    trip/reset drills cover every device path."""
    from ..robustness.breaker import BREAKER_PATHS

    want = flags.get("mountpoint")
    path = flags.get("path")
    # the registered set, not a hand-maintained tuple: a new breakered
    # device path registers in BREAKER_PATHS and is drillable here
    # immediately (the fault-registry lint pass proves the show rows
    # below stay in sync)
    if path is not None and path not in BREAKER_PATHS:
        raise CommandError(
            f"path must be one of {', '.join(BREAKER_PATHS)}")
    if path in (None, "match"):
        view = broker.registry.reg_views.get("tpu")
        for mp, m in getattr(view, "_matchers", {}).items():
            if want is not None and mp != want:
                continue
            if m.breaker is not None:
                yield mp, m.breaker
    if path in (None, "retained"):
        eng = getattr(broker, "_retained_engine", None)
        for mp, idx in getattr(eng, "_indexes", {}).items():
            if want is not None and mp != want:
                continue
            if idx.breaker is not None:
                yield mp, idx.breaker
    if path in (None, "predicate"):
        feng = getattr(broker, "filter_engine", None)
        if feng is not None and feng.breaker is not None \
                and want is None:
            # one engine-wide breaker (the predicate table is tiny):
            # no per-mountpoint granularity to select on
            yield "(all)", feng.breaker
    if path in (None, "wire"):
        if want is None:
            # process-global codec breaker: trip pins every batch onto
            # the pure-Python codec until reset (the keep-off drill)
            from ..protocol import fastpath as _fastpath

            yield "(all)", _fastpath.breaker
    if path in (None, "store"):
        if want is None:
            # one per broker: trip pins compaction paused (append-only
            # degraded mode) until reset — delivery is untouched
            yield "(all)", broker.store_breaker
    if path in (None, "handoff"):
        if want is None:
            # one per broker: trip refuses new live handoffs (every
            # unit stays with its current owner) until reset
            yield "(all)", broker.handoff.breaker


def _store_show(broker, flags):
    """Storage-tier status: which engine serves each durable family
    (msg store buckets + cluster spool journal), segment/garbage
    accounting, the compaction loop's counters + breaker, and the
    batched resume collector."""
    st = broker.store_status()
    rows = []
    for eng in st["engines"]:
        rows.append({
            "kind": eng.get("kind", "?"),
            "keys": eng.get("keys", ""),
            "segments": eng.get("segments", ""),
            "live_bytes": eng.get("live_bytes", ""),
            "garbage_bytes": eng.get("garbage_bytes", ""),
            "compactions": eng.get("compactions", ""),
            "checkpoints": eng.get("checkpoints", ""),
        })
    if not rows:
        rows.append({"kind": st["engine_kind"], "keys": "-",
                     "segments": "-", "live_bytes": "-",
                     "garbage_bytes": "-", "compactions": "-",
                     "checkpoints": "-"})
    out = {"table": rows,
           "breaker": st["breaker"]["state"],
           "compactions": st["compactions"],
           "compacted_bytes": st["compacted_bytes"],
           "compact_paused": st["compact_paused"],
           "compact_errors": st["compact_errors"]}
    if "resume" in st:
        out["resume"] = {k: int(v) for k, v in st["resume"].items()}
    return out


def _store_compact(broker, flags):
    """vmq-admin store compact [budget=BYTES] — schedule one budgeted
    maintenance pass off the loop (the periodic loop's tick body)."""
    import asyncio as _asyncio

    budget = flags.get("budget")
    budget = int(budget) if budget else None
    _asyncio.get_event_loop().create_task(
        broker.store_maintain_once(budget))
    return ("maintenance pass scheduled "
            f"(budget={budget if budget else 'store_compact_budget_bytes'})")


def _schemas(broker):
    sr = getattr(broker, "schema_registry", None)
    if sr is None:
        raise CommandError("payload filters disabled "
                           "(payload_filters_enabled=off)")
    return sr


def _schema_show(broker, flags):
    """Registered payload schemas (the replicated field layouts the
    predicate compiler and payload decoder resolve against)."""
    sr = _schemas(broker)
    rows = [{"mountpoint": s.mountpoint or "(default)",
             "topic": s.filter_str, "fields": s.fields_spec()}
            for s in sr.schemas(flags.get("mountpoint"))]
    return {"table": rows or [{"mountpoint": "-", "topic": "(none)",
                               "fields": "-"}]}


def _schema_set(broker, flags):
    """vmq-admin schema set topic=... fields=... [mountpoint=] —
    replicates cluster-wide through the metadata plane (LWW, AE)."""
    sr = _schemas(broker)
    topic = flags.get("topic")
    fields = flags.get("fields")
    if not topic or not fields:
        raise CommandError("topic= and fields= required")
    try:
        schema = sr.set_schema(str(flags.get("mountpoint", "") or ""),
                               str(topic), str(fields))
    except ValueError as e:
        raise CommandError(str(e)) from None
    return (f"schema set for {schema.mountpoint or '(default)'} "
            f"{schema.filter_str}: {schema.fields_spec()}")


def _schema_del(broker, flags):
    sr = _schemas(broker)
    topic = flags.get("topic")
    if not topic:
        raise CommandError("topic= required")
    mp = str(flags.get("mountpoint", "") or "")
    if not sr.delete_schema(mp, str(topic)):
        raise CommandError(f"no schema for {mp or '(default)'} {topic}")
    return f"schema deleted: {mp or '(default)'} {topic}"


def _filter_show(broker, flags):
    """Payload-filter engine status: compiled predicates, window table,
    device-vs-host serving split, breaker state."""
    eng = getattr(broker, "filter_engine", None)
    if eng is None:
        raise CommandError("payload filters disabled "
                           "(payload_filters_enabled=off)")
    return eng.status()


def _governor(broker):
    gov = getattr(broker, "overload", None)
    if gov is None:
        raise CommandError("overload governor not running")
    return gov


def _overload_show(broker, flags):
    """Governor state: level, fused signals, per-stage shed counters."""
    gov = _governor(broker)
    st = gov.status()
    m = broker.metrics
    st["counters"] = {name: m.value(name) for name in (
        "overload_publish_throttled", "overload_rate_limited",
        "overload_qos0_shed", "overload_replay_deferred",
        "overload_connects_refused", "overload_talker_disconnects")}
    return st


def _overload_set_level(broker, flags):
    """Pin the governor to a level for a drill (``level=auto`` unpins)."""
    gov = _governor(broker)
    raw = flags.get("level")
    if raw is None:
        raise CommandError("level= required (0..3 or auto)")
    if str(raw).lower() in ("auto", "none", "-1"):
        gov.pin(None)
        return "overload level unpinned (automatic)"
    try:
        level = int(raw)
        gov.pin(level)
    except ValueError as e:
        raise CommandError(str(e) if str(e) else "level must be 0..3 "
                           "or auto") from None
    return (f"overload level pinned at {level} "
            f"({gov.status()['level_name']})")


def _breaker_trip(broker, flags):
    """Force the breaker open (drill the degraded path in production)."""
    n = 0
    for _, br in _each_breaker(broker, flags):
        br.trip()
        n += 1
    return f"tripped {n} breaker(s): matching serves from the host trie"


def _breaker_reset(broker, flags):
    n = 0
    for _, br in _each_breaker(broker, flags):
        br.reset()
        n += 1
    return f"reset {n} breaker(s)"
