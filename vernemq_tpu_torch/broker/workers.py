"""Multi-process host scale-out: N broker workers sharing one MQTT port.

The reference runs one lightweight Erlang process per socket scheduled
across all BEAM schedulers (``vmq_ranch.erl:41-43``) — per-connection
parallelism inside one OS process. A GIL-bound asyncio broker can't do
that, so the same capability is delivered the OS way: **N worker
processes**, each a full broker (sessions, queues, matcher, storage
views), accepting on ONE shared MQTT port via ``SO_REUSEPORT`` (the
kernel balances accepts), and meshed over the existing cluster-node
machinery on loopback — a worker IS a lightweight local node, so
cross-worker delivery, subscriber replication, session takeover and
shared subscriptions all reuse the cluster data/metadata plane
(``cluster/``), exactly as they work between real nodes.

Usage::

    python -m vernemq_tpu_torch.broker.workers --workers 4 --port 1883 \
        [--conf vernemq.conf] [--allow-anonymous] \
        [--match-service --match-view tpu --device cuda]

or programmatically :class:`WorkerGroup` (used by ``tools/loadtest.py
--workers N``).

The parent supervises: a dead worker is relaunched with its same
identity (worker index, cluster port), mirroring the restart discipline
of ``broker/supervisor.py`` one level up.

In the port, workers never touch the card: with the match service on the
GPU view (``match_view="tpu"``) the service process is the one process of
the group on ``match_device``, and the parent builds its kernel libraries
(``nvcc`` only, no CUDA context) before anything starts, so a kernel that
does not build fails :meth:`WorkerGroup.start`.
"""

from __future__ import annotations

import argparse
import atexit
import multiprocessing as mp
import os
import secrets
import signal
import sys
import time
from typing import Any, Dict, List, Optional, Tuple

#: cluster channel of worker i listens on loopback at base + i (kept BELOW the kernel ephemeral port range 32768+, or client sockets collide with it under load)
DEFAULT_CLUSTER_BASE = 24100


def _run_worker(idx: int, n_workers: int, host: str, port: int,
                cluster_base: int, overrides: Dict[str, Any],
                conf_path: Optional[str],
                direct_base: Optional[int] = None) -> None:
    """Worker-process entry point (spawn-safe, top-level)."""
    import asyncio
    import faulthandler

    dump_s = int(os.environ.get("TIER1_FAULTHANDLER_S") or 0)
    if dump_s > 0:
        # hung-child forensics (tests/conftest.py arms the parent the
        # same way): a wedged worker prints WHERE it hung before the
        # outer timeout kills the test run
        faulthandler.enable()
        faulthandler.dump_traceback_later(dump_s, repeat=True, exit=False)

    async def amain() -> None:
        from .config import Config
        from .server import start_broker

        if conf_path:
            from .conf import load_conf_file

            cfg = load_conf_file(conf_path)
            for k, v in overrides.items():
                cfg.set(k, v)
            # conf-declared listeners must not EADDRINUSE across the
            # group: MQTT/WS listeners join the SO_REUSEPORT set on
            # every worker; singleton kinds (admin HTTP, explicit
            # cluster listeners) run on worker 0 only
            shared_kinds = ("mqtt", "mqtts", "ws", "wss")
            rewritten = []
            for ent in cfg.get("listeners", []):
                if ent["kind"] in shared_kinds:
                    ent = {**ent,
                           "opts": {**ent.get("opts", {}),
                                    "reuse_port": True}}
                elif idx > 0:
                    continue
                rewritten.append(ent)
            cfg.set("listeners", rewritten)
        else:
            cfg = Config(**overrides)
        if idx > 0 and cfg.get("http_enabled", False):
            # the admin HTTP endpoint is a fixed-port singleton
            cfg.set("http_enabled", False)
        broker, server = await start_broker(
            cfg, host=host, port=port,
            node_name=f"worker{idx}",
            cluster_listen=("127.0.0.1", cluster_base + idx),
            join=("127.0.0.1", cluster_base) if idx > 0 else None,
            reuse_port=True)
        if direct_base:
            # per-worker direct MQTT port (base + idx): lets operators
            # and the efficiency harness address ONE worker instead of
            # taking the kernel's SO_REUSEPORT pick — the analog of
            # dialing a specific node of a cluster. Through the
            # ListenerManager so it shows in `listener show` and stops
            # with the broker like every other listener.
            from .listeners import ListenerManager

            lm = broker.listeners or ListenerManager(broker)
            await lm.start_listener("mqtt", "127.0.0.1",
                                    direct_base + idx)
        stop = asyncio.Event()
        loop = asyncio.get_running_loop()
        for sig in (signal.SIGTERM, signal.SIGINT):
            loop.add_signal_handler(sig, stop.set)
        await stop.wait()
        await broker.stop()
        await server.stop()

    asyncio.run(amain())


class WorkerGroup:
    """Spawn + supervise N broker worker processes on one shared port.

    With ``match_service=True`` the group additionally owns ONE
    device-match service process and the shared-memory plumbing
    (broker/match_service.py): per-worker request/response rings plus
    the worker stats block. Workers then boot with
    ``default_reg_view=tpu`` served by the ring stub — their parse/
    auth/session/queue work stays local, matching is centralized. A
    stats block is created regardless of match_service (it carries the
    fused overload pressure and ``vmq-admin workers show`` health rows
    and never touches the match path), so ``workers=1`` without a
    service runs byte-identical to the single-process broker."""

    def __init__(self, n_workers: int, host: str = "127.0.0.1",
                 port: int = 1883,
                 cluster_base: int = DEFAULT_CLUSTER_BASE,
                 conf_path: Optional[str] = None,
                 direct_base: Optional[int] = None,
                 match_service: bool = False,
                 match_view: str = "trie",
                 ring_bytes: int = 1 << 22,
                 match_device: str = "cuda",
                 match_tpu_opts: Optional[Dict[str, Any]] = None,
                 **config_overrides: Any):
        """``match_device`` / ``match_tpu_opts``: the device and the
        ``GpuRegView`` keyword arguments (capacity, fanout, breaker) of the
        match service's ``"tpu"`` view."""
        if n_workers < 1:
            raise ValueError("need at least one worker")
        self.n_workers = n_workers
        self.host = host
        self.port = port
        self.cluster_base = cluster_base
        self.conf_path = conf_path
        self.direct_base = direct_base
        self.match_service = match_service
        self.match_view = match_view
        self.match_device = match_device
        self.match_tpu_opts = dict(match_tpu_opts or {})
        self.ring_bytes = ring_bytes
        self.overrides = config_overrides
        self._ctx = mp.get_context("spawn")
        self._procs: List[Any] = []
        self._service_proc: Optional[Any] = None
        self._service_epoch = 0
        self.service_restarts = 0
        self._stopping = False
        self._shm_tag = f"vmqw{os.getpid() & 0xFFFF:x}{secrets.token_hex(3)}"
        self.stats_name = f"{self._shm_tag}s"
        self._stats = None
        self._rings: List[Tuple[Any, Any]] = []  # parent-held (req, resp)

    # ------------------------------------------------- cluster port block

    def _probe_cluster_base(self) -> int:
        """Find a bindable loopback port block for the workers' cluster
        channels. The configured base is a *preference*: this host's
        ephemeral range (``ip_local_port_range``) may cover it, so any
        client socket can squat ``base + i`` between runs — probe the
        whole block and slide past squatters instead of letting worker
        ``i`` crash-loop on EADDRINUSE at boot."""
        import socket

        base = self.cluster_base
        for _ in range(64):
            socks = []
            try:
                for i in range(self.n_workers):
                    s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                    s.setsockopt(socket.SOL_SOCKET,
                                 socket.SO_REUSEADDR, 1)
                    try:
                        s.bind(("127.0.0.1", base + i))
                    except OSError:
                        s.close()
                        break
                    socks.append(s)
                else:
                    return base
            finally:
                for s in socks:
                    s.close()
            base += max(16, self.n_workers)
        raise RuntimeError(
            f"no free cluster port block of {self.n_workers} near "
            f"{self.cluster_base}")

    # --------------------------------------------------- shm plumbing

    def _ring_names(self, idx: int) -> Tuple[str, str]:
        return (f"{self._shm_tag}q{idx}", f"{self._shm_tag}r{idx}")

    def _create_shm(self) -> None:
        from ..parallel.shm_ring import ShmRing, WorkerStatsBlock

        self._stats = WorkerStatsBlock.create(self.stats_name,
                                              self.n_workers)
        if self.match_service:
            for i in range(self.n_workers):
                rq, rs = self._ring_names(i)
                self._rings.append((ShmRing.create(rq, self.ring_bytes),
                                    ShmRing.create(rs, self.ring_bytes)))

    def _destroy_shm(self) -> None:
        for rq, rs in self._rings:
            rq.close()
            rq.unlink()
            rs.close()
            rs.unlink()
        self._rings = []
        if self._stats is not None:
            self._stats.close()
            self._stats.unlink()
            self._stats = None

    def stats_block(self):
        """The parent's handle on the shared stats table (bench /
        supervision reads)."""
        return self._stats

    def _worker_overrides(self, idx: int) -> Dict[str, Any]:
        ov = dict(self.overrides)
        # a dead PEER WORKER is not a netsplit: it shares this host, the
        # supervisor respawns it within seconds, and its sessions are
        # dropped with DISCONNECT semantics — surviving workers must
        # keep admitting work through the respawn window instead of
        # refusing every publish behind the cluster-consistency gate.
        # Explicit operator settings still win.
        for flag in ("allow_publish_during_netsplit",
                     "allow_subscribe_during_netsplit",
                     "allow_unsubscribe_during_netsplit",
                     "allow_register_during_netsplit"):
            ov.setdefault(flag, True)
        ov.update(worker_stats_block=self.stats_name, worker_index=idx,
                  workers_total=self.n_workers)
        if self.match_service:
            rq, rs = self._ring_names(idx)
            # default_reg_view=tpu mounts the ring stub; the retained
            # device index stays OFF in workers — they own no device
            # (the service does), so subscribe replay host-walks locally
            ov.update(match_service_req_ring=rq,
                      match_service_resp_ring=rs,
                      default_reg_view="tpu",
                      tpu_retained_enabled=False)
        return ov

    # ----------------------------------------------------- supervision

    def _spawn(self, idx: int):
        p = self._ctx.Process(
            target=_run_worker,
            args=(idx, self.n_workers, self.host, self.port,
                  self.cluster_base, self._worker_overrides(idx),
                  self.conf_path, self.direct_base),
            name=f"vmq-worker{idx}", daemon=True)
        p.start()
        return p

    def _spawn_service(self):
        from .match_service import _service_main

        self._service_epoch += 1
        p = self._ctx.Process(
            target=_service_main,
            args=(self.stats_name,
                  [self._ring_names(i) for i in range(self.n_workers)],
                  self.match_view, self._service_epoch, self.match_tpu_opts,
                  self.match_device),
            name="vmq-match-service", daemon=True)
        p.start()
        return p

    def start(self) -> None:
        self._stopping = False
        # publish-ordering fence check before any ring exists: one
        # warning when the TSO fallback runs on a weakly-ordered host
        from ..parallel.shm_ring import fence_startup_check

        fence_startup_check()
        if (self.match_service and self.match_view == "tpu"
                and str(self.match_device).startswith("cuda")):
            # nvcc only: this process creates no CUDA context
            from ..models.matcher import KERNEL_LIBS
            from ..ops import _build

            _build.build(KERNEL_LIBS)
        self.cluster_base = self._probe_cluster_base()
        self._create_shm()
        atexit.register(self.stop)  # leaked groups must not pin the
        # reuseport socket / shm segments past the parent (test reaper)
        if self.match_service:
            self._service_proc = self._spawn_service()
        # worker 0 is the cluster seed: it must be listening before the
        # rest dial in, so stagger it first
        self._procs = [self._spawn(0)]
        time.sleep(0.3)
        for i in range(1, self.n_workers):
            self._procs.append(self._spawn(i))

    def poll_restart(self) -> int:
        """Supervision tick: relaunch dead workers (same identity —
        worker index, cluster port, ring pair) and a dead match service
        (new epoch: workers notice the bump in the stats block and
        resync their owned rows). Returns the number restarted."""
        if self._stopping:
            return 0
        restarted = 0
        for i, p in enumerate(self._procs):
            if not p.is_alive():
                self._procs[i] = self._spawn(i)
                restarted += 1
        if (self.match_service and self._service_proc is not None
                and not self._service_proc.is_alive()):
            self._service_proc = self._spawn_service()
            self.service_restarts += 1
            restarted += 1
        return restarted

    def alive_count(self) -> int:
        return sum(1 for p in self._procs if p.is_alive())

    def service_alive(self) -> bool:
        return (self._service_proc is not None
                and self._service_proc.is_alive())

    def stop(self, timeout: float = 10.0) -> None:
        if self._stopping:
            return
        self._stopping = True
        procs = list(self._procs)
        if self._service_proc is not None:
            procs.append(self._service_proc)
        for p in procs:
            if p.is_alive():
                p.terminate()
        deadline = time.time() + timeout
        for p in procs:
            p.join(max(0.1, deadline - time.time()))
            if p.is_alive():
                p.kill()
                p.join(1.0)
        self._procs = []
        self._service_proc = None
        self._destroy_shm()


def main(argv: Optional[List[str]] = None) -> None:  # pragma: no cover
    ap = argparse.ArgumentParser(
        description="vernemq_tpu_torch multi-process broker")
    ap.add_argument("--workers", type=int, default=None,
                    help="worker process count (default: the conf "
                         "file's `workers` knob, else cpu_count/2)")
    ap.add_argument("--host", default="0.0.0.0")
    ap.add_argument("--port", type=int, default=1883)
    ap.add_argument("--cluster-base", type=int,
                    default=DEFAULT_CLUSTER_BASE)
    ap.add_argument("--direct-base", type=int, default=None,
                    help="also open a per-worker MQTT port at "
                         "direct_base+idx (address ONE worker)")
    ap.add_argument("--conf", default=None)
    ap.add_argument("--allow-anonymous", action="store_true")
    ap.add_argument("--match-service", action="store_true",
                    help="centralize matching in ONE device-match "
                         "service process fed over shared-memory rings "
                         "(workers keep parse/auth/session/queue local)")
    ap.add_argument("--match-view", default="trie",
                    choices=["trie", "tpu"],
                    help="what the match service folds on: the host "
                         "trie or the GPU match engine")
    ap.add_argument("--device", default="cuda",
                    help="device of the match service's tpu view "
                         "(default cuda; cpu runs its plain PyTorch path)")
    args = ap.parse_args(argv)
    n_workers = args.workers
    if n_workers is None and args.conf:
        from .conf import parse_conf

        # probe the RAW parsed file, not a Config: Config merges
        # DEFAULTS (workers=1), so .get() can never distinguish "knob
        # absent" from "knob set to 1" and the cpu_count/2 fallback
        # below would be unreachable for every conf-file launch
        with open(args.conf, "r", encoding="utf-8") as fh:
            raw = parse_conf(fh.read())
        if "workers" in raw:
            n_workers = int(raw["workers"])
    if n_workers is None:
        n_workers = max(2, (os.cpu_count() or 2) // 2)
    args.workers = n_workers
    overrides: Dict[str, Any] = {}
    if args.allow_anonymous:
        overrides["allow_anonymous"] = True
    group = WorkerGroup(args.workers, args.host, args.port,
                        cluster_base=args.cluster_base,
                        conf_path=args.conf,
                        direct_base=args.direct_base,
                        match_service=args.match_service,
                        match_view=args.match_view,
                        match_device=args.device, **overrides)
    group.start()
    print(f"started {args.workers} workers on {args.host}:{args.port}",
          file=sys.stderr, flush=True)
    try:
        while True:
            time.sleep(1.0)
            n = group.poll_restart()
            if n:
                print(f"restarted {n} dead worker(s)", file=sys.stderr,
                      flush=True)
    except KeyboardInterrupt:
        pass
    finally:
        group.stop()


if __name__ == "__main__":  # pragma: no cover
    main()
