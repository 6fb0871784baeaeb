"""Adaptive overload governor: multi-signal pressure levels with staged,
cheapest-first responses.

The reference ships load shedding as a headline feature (its README's
"load-shedding" bullet): ``vmq_ranch`` throttles readers, the queue caps
drop QoS0 first, and CONNECTs are refused when the node is saturated.
Before this module the port reduced all of that to one binary flag —
``Sysmon.overloaded`` (loop lag only) mapped to a fixed ``sleep`` in the
publish path, punishing every producer equally and never protecting the
device dispatch path the framework exists to serve. Past saturation that
shape collapses p99 for *all* clients instead of shedding the
cheap-to-shed work first (the goodput cliff in the broker-benchmarking
literature, PAPERS.md).

:class:`OverloadGovernor` fuses graded signals into one **pressure**
score in ``[0, 1]`` and maps it to a level 0–3:

========  ==========================  =====================================
signal    source                      severity mapping (0..1)
========  ==========================  =====================================
loop_lag  Sysmon lag samples          EWMA / (4 x lag_threshold); a raw
                                      over-threshold sample floors the
                                      score at the L1 gate (instant cheap
                                      response; L2/L3 need the SUSTAINED
                                      EWMA so one GC pause can't shed)
rss       Sysmon RSS watermark        (rss/watermark - 0.75) x 2
collector BatchCollector /            pending depth vs the overload shed
          RetainedBatchCollector      bound, plus dispatch-latency EWMA
                                      vs ``overload_dispatch_budget_ms``
breaker   device circuit breakers     open = 0.2, half-open = 0.1 —
                                      deliberately BELOW the L1 gate:
                                      degraded mode is designed to serve
                                      everything from the host trie, so
                                      an open breaker signals reduced
                                      headroom (visible in the pressure
                                      gauge), not overload by itself;
                                      real overload shows up as lag or
                                      collector depth
cluster   writer buffers + spool      fill ratio of the worst peer buffer
                                      and the delivery-spool byte cap
injected  ``device.pressure`` fault   1.0 while an error rule fires — the
          point                       chaos hook that forces any level
========  ==========================  =====================================

``pressure = max(severities)`` — one saturated subsystem is overload even
when the rest idle (fusing by average would hide a drowning collector
behind a healthy event loop).

Levels carry per-level hysteresis reusing the ``Sysmon.observe_lag``
enter/exit-ratio pattern: escalation is immediate, de-escalation needs
pressure below ``enter_threshold x exit_ratio`` for a full ``hold_s``
window (boundary pressure re-arms the window and counts an extend), so
levels never flap at the shed/unshed edge. Each level's response is
staged cheapest-first and strictly additive:

- **L1** — proportional per-session read throttle replacing the old
  fixed sleeps: heavier-than-average talkers wait longer
  (:meth:`publish_delay`).
- **L2** — per-client token-bucket publish rate limiting (heaviest
  talkers exhaust tokens first), QoS0 fanout shedding at the routing
  admission gate (:meth:`shed_qos0` — no ack is owed, so it is the
  cheapest work in the broker to drop), and retained-replay deferral
  (:meth:`defer_replay` — a subscribe storm's replay batches wait out
  the congestion instead of competing with live publishes for the
  device).
- **L3** — new CONNECTs refused at the listener (MQTT5 CONNACK 0x97
  Quota exceeded / MQTT3 Server unavailable) and the top-N heaviest
  talkers disconnected with Server busy (QoS>=1 state follows the normal
  close rules: nothing acked is lost, persistent sessions keep their
  backlog).

``overload_mode=binary`` keeps the legacy behaviour (the flag + fixed
0.1s sleep, no graded responses) so the two postures can be A/B'd —
bench config 9 ("overload storm") runs both. ``vmq-admin overload
show|set-level`` surfaces the state and pins a level for drills, like
``breaker trip``. These levels are the hardware-tuning surface for
ROADMAP's fault-storms item: on the real chip the ``tpu_breaker_*``
backoffs modulate the same collector/breaker severities this governor
fuses.
"""

from __future__ import annotations

import asyncio
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

from . import faults
from ..observability import events

log = logging.getLogger("vernemq_tpu_torch.overload")

LEVEL_NAMES = ("ok", "throttle", "shed", "refuse")

#: EWMA smoothing for the loop-lag signal: one 1s stall from zero lands
#: at 0.3s smoothed — enough for L1, not enough to reach the sustained
#: levels until the stall repeats
LAG_ALPHA = 0.3


def _clamp01(x: float) -> float:
    return 0.0 if x < 0.0 else (1.0 if x > 1.0 else x)


#: dispatch-latency EWMA smoothing for the collector signals (rise time
#: ~3 flushes) — one constant so both collectors stay comparable
LATENCY_EWMA_ALPHA = 0.3
#: latency contribution cap: BELOW the L1 gate by design — a slow-but-
#: covered dispatch (busy/rebuild/degraded sheds serve identical
#: results) is reduced headroom, not overload; only DEPTH (arrivals
#: outpacing service) may escalate the level
LATENCY_SEVERITY_CAP = 0.2


def fold_latency_ewma(prev_ms: float, dt_ms: float) -> float:
    """One EWMA step for a collector's whole-flush service time."""
    return LATENCY_EWMA_ALPHA * dt_ms + (1 - LATENCY_EWMA_ALPHA) * prev_ms


def collector_pressure(depth: int, depth_bound: int,
                       latency_ewma_ms: float,
                       latency_budget_ms: float) -> float:
    """The shared depth/latency fusion both batch collectors report to
    the governor: queue depth against the collector's own overload
    bound saturates to 1.0; the latency EWMA against its budget caps at
    LATENCY_SEVERITY_CAP (see above)."""
    d = min(1.0, depth / depth_bound) if depth_bound else 0.0
    lat = 0.0
    if latency_budget_ms > 0:
        lat = LATENCY_SEVERITY_CAP * min(
            1.0, latency_ewma_ms / latency_budget_ms)
    return max(d, lat)


class OverloadGovernor:
    def __init__(self, broker, *,
                 mode: str = "governor",
                 tick_s: float = 0.25,
                 hold_s: float = 5.0,
                 exit_ratio: float = 0.5,
                 l1_enter: float = 0.25,
                 l2_enter: float = 0.5,
                 l3_enter: float = 0.8,
                 l1_throttle_ms: float = 100.0,
                 l2_client_rate: float = 50.0,
                 l2_burst: float = 100.0,
                 l3_disconnect_top: int = 5):
        self.broker = broker
        self.mode = mode
        self.tick_s = tick_s
        self.hold_s = hold_s
        self.exit_ratio = exit_ratio
        self._enter = (0.0, l1_enter, l2_enter, l3_enter)
        self.l1_throttle_s = l1_throttle_ms / 1e3
        self.l2_client_rate = float(l2_client_rate)
        self.l2_burst = float(l2_burst)
        self.l3_disconnect_top = int(l3_disconnect_top)

        self.level = 0
        self.pinned: Optional[int] = None
        self.level_extends = 0      # hysteresis windows re-armed by
        self.enters = [0, 0, 0, 0]  # boundary pressure (per observe_lag)
        self.time_at_level = [0.0, 0.0, 0.0, 0.0]
        self._hold_until = 0.0
        self._last_tick = time.monotonic()
        self._last_pressure = 0.0
        self._last_signals: Dict[str, float] = {}

        self._lag_ewma = 0.0
        self._lag_raw = 0.0
        self._rss = 0
        self._rss_watermark = 0

        # multi-process fusion (broker/workers.py): the shared stats
        # block and this worker's slot index. Each tick writes the
        # LOCAL pressure (peers excluded — writing the fused value
        # would echo-amplify between workers) and reads the peers' as
        # one more severity signal, so L2/L3 shedding engages on every
        # worker when any one of them drowns — the cluster-style
        # aggregate level. None outside worker mode.
        self._wstats: Optional[Any] = None
        self._widx = 0
        self._local_pressure = 0.0

        # talker tracking: per-sid publish counts folded into EWMA rates
        # each tick — drives the L1 proportional factor, the L2 buckets'
        # "heaviest first" property and the L3 top-N pick
        self._talker_counts: Dict[Any, int] = {}
        self._talker_rates: Dict[Any, float] = {}
        self._rates_mean = 0.0  # cached per fold: publish_delay runs
        self._buckets: Dict[Any, List[float]] = {}  # per inbound PUBLISH
        # sessions currently parked inside a governor throttle: the
        # DEMAND signal the lag EWMA goes blind to once shedding works
        # (throttled readers stop generating lag while their sockets
        # stay full) — used to step de-escalation down one level per
        # hold window instead of unleashing the whole backlog at once
        self._active_throttles = 0

        self._task: Optional[asyncio.Task] = None

    # ------------------------------------------------------------ lifecycle

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    def stop(self) -> None:
        if self._task is not None:
            self._task.cancel()
            self._task = None

    async def _run(self) -> None:
        while True:
            await asyncio.sleep(self.tick_s)
            try:
                self.tick()
            except Exception:
                log.exception("overload governor tick failed")

    # -------------------------------------------------------------- signals

    def observe_lag(self, lag: float) -> None:
        """One loop-lag sample from the sysmon loop. Recomputes the level
        immediately (not just at the next tick) so the cheap L1 response
        lands on the very first over-threshold sample — the latency of
        shedding must not be a tick interval behind the overload."""
        self._lag_raw = lag
        self._lag_ewma = LAG_ALPHA * lag + (1 - LAG_ALPHA) * self._lag_ewma
        pressure, signals = self._pressure_cheap()
        self._last_pressure, self._last_signals = pressure, signals
        self._update_level(time.monotonic(), pressure)

    def observe_rss(self, rss: int, watermark: int) -> None:
        self._rss = rss
        self._rss_watermark = watermark

    def _lag_threshold(self) -> float:
        return float(self.broker.config.get("sysmon_lag_threshold", 0.25))

    def _pressure_cheap(self) -> Tuple[float, Dict[str, float]]:
        """Signals that cost nothing to read (no collector/cluster pulls,
        no fault point) — what observe_lag recomputes inline."""
        s: Dict[str, float] = {}
        thr = self._lag_threshold()
        if thr > 0:
            sev = self._lag_ewma / (4.0 * thr)
            if self._lag_raw > thr:
                # raw over-threshold: instant L1 floor; the EWMA alone
                # gates the sustained levels
                sev = max(sev, self._enter[1])
            s["loop_lag"] = _clamp01(sev)
        if self._rss_watermark > 0 and self._rss > 0:
            s["rss"] = _clamp01(
                (self._rss / self._rss_watermark - 0.75) * 2.0)
        # keep slow-path signals sticky between ticks so an inline
        # recompute can't mask a saturated collector (or a drowning
        # peer worker)
        for k in ("collector", "retained", "breaker", "cluster",
                  "injected", "workers"):
            if k in self._last_signals:
                s[k] = self._last_signals[k]
        return (max(s.values(), default=0.0), s)

    def _pressure(self) -> Tuple[float, Dict[str, float]]:
        pressure, s = self._pressure_cheap()
        col = getattr(self.broker, "_collector", None)
        if col is not None and hasattr(col, "pressure"):
            s["collector"] = _clamp01(col.pressure())
        else:
            s.pop("collector", None)
        rcol = getattr(self.broker, "_retained_collector", None)
        if rcol is not None and hasattr(rcol, "pressure"):
            s["retained"] = _clamp01(rcol.pressure())
        else:
            s.pop("retained", None)
        b = self._breaker_severity()
        if b > 0:
            s["breaker"] = b
        else:
            s.pop("breaker", None)
        c = self._cluster_severity()
        if c > 0:
            s["cluster"] = c
        else:
            s.pop("cluster", None)
        s.pop("injected", None)
        s.pop("workers", None)
        try:
            # chaos seam: an error rule here forces full pressure (the
            # way tests drive collector-depth conditions without a real
            # storm); latency rules model a slow signal read, capped so
            # a hang drill stalls the tick, never the loop for long
            faults.inject("device.pressure", max_delay_s=0.05)
        except Exception:
            # only an EXACTLY-targeted rule forces pressure: a broad
            # device.* outage drill must degrade the device path (the
            # breaker signal carries that), not read as total overload
            plan = faults.active()
            if plan is not None and any(r.point == "device.pressure"
                                        for r in plan.rules):
                s["injected"] = 1.0
        # local pressure = what THIS worker contributes to the fused
        # view (written to the stats slot by tick(); peers excluded so
        # two workers can't echo-amplify each other's fused value)
        self._local_pressure = max(s.values(), default=0.0)
        w = self._worker_severity()
        if w > 0:
            s["workers"] = w
        return (max(s.values(), default=0.0), s)

    def attach_worker_stats(self, stats: Any, worker_index: int) -> None:
        """Join the cross-worker fusion (multi-process front end): read
        peers' pressure as a signal, export local pressure per tick."""
        self._wstats = stats
        self._widx = int(worker_index)

    def _worker_severity(self) -> float:
        """Fused peer-worker pressure: the max of every LIVE peer
        slot's LOCAL pressure. Deliberately pressure-only — fusing the
        peers' LEVELS would let two hysteresis-held governors pin each
        other up forever (A holds L3 because B's slot says L3, which B
        holds because A's does). Local pressures exclude this signal,
        so the fusion converges: when the drowning worker's own load
        drops, every peer's ``workers`` signal drops with it and each
        governor de-escalates through its own hysteresis. Stale slots
        (dead worker) are ignored by the block's heartbeat gate."""
        if self._wstats is None:
            return 0.0
        try:
            peers = self._wstats.peer_pressure(self._widx)
        except Exception:
            return 0.0
        return _clamp01(peers["pressure"])

    def _breaker_severity(self) -> float:
        """An open device breaker means the host trie is carrying device
        load: reduced headroom, NOT overload by itself (degraded mode is
        designed to serve full traffic) — so the contribution sits below
        the L1 gate and only informs the pressure gauge unless lag or
        collector depth confirm actual distress."""
        sev = 0.0
        sources = []
        reg = getattr(self.broker, "registry", None)
        if reg is not None:
            sources.append(getattr(reg, "reg_views", {}).get("tpu"))
        sources.append(getattr(self.broker, "_retained_engine", None))
        for src in sources:
            st_fn = getattr(src, "breaker_status", None)
            if st_fn is None:
                continue
            try:
                for st in st_fn().values():
                    state = st.get("state") if isinstance(st, dict) else st
                    if state in ("open", "forced_open"):
                        sev = max(sev, 0.2)
                    elif state == "half_open":
                        sev = max(sev, 0.1)
            except Exception:
                pass
        return sev

    def _cluster_severity(self) -> float:
        cl = getattr(self.broker, "cluster", None)
        if cl is None:
            return 0.0
        sev = 0.0
        spool = getattr(cl, "spool", None)
        if spool is not None and getattr(spool, "max_bytes", 0):
            try:
                depth = spool.stats().get("cluster_spool_depth_bytes", 0.0)
                sev = max(sev, _clamp01(depth / spool.max_bytes))
            except Exception:
                pass
        for w in list(getattr(cl, "_writers", {}).values()):
            mb = getattr(w, "max_buffer_bytes", 0)
            if mb:
                sev = max(sev, _clamp01(
                    getattr(w, "_buf_bytes", 0) / mb))
        return sev

    # ---------------------------------------------------------------- level

    def tick(self) -> int:
        now = time.monotonic()
        dt = max(0.0, now - self._last_tick)
        self._last_tick = now
        self.time_at_level[self.level] += dt
        self._fold_talkers(dt)
        pressure, signals = self._pressure()
        self._last_pressure, self._last_signals = pressure, signals
        self._update_level(now, pressure)
        if self._wstats is not None:
            # export AFTER the level update so peers see the level this
            # tick actually enforces; local pressure only (see above)
            try:
                self._wstats.write_overload(self._widx, self.level,
                                            self._local_pressure)
            except Exception:
                pass  # a torn block must never kill the governor tick
        if self.level < 2 and self._buckets:
            self._buckets.clear()  # token debt dies with the episode
        return self.level

    def _target_level(self, pressure: float) -> int:
        for lv in (3, 2, 1):
            if pressure >= self._enter[lv]:
                return lv
        return 0

    def _update_level(self, now: float, pressure: float) -> None:
        if self.pinned is not None:
            if self.level != self.pinned:
                self._set_level(self.pinned, now)
            return
        target = self._target_level(pressure)
        if target > self.level:
            self._set_level(target, now)
        elif target == self.level:
            if self.level > 0:
                self._hold_until = now + self.hold_s
        else:
            # de-escalation wants out: only below the CURRENT level's
            # exit bound for a full hold window (the observe_lag
            # enter/exit-ratio pattern — boundary pressure re-arms)
            if pressure > self._enter[self.level] * self.exit_ratio:
                self.level_extends += 1
                self._hold_until = max(self._hold_until,
                                       now + self.hold_s)
            elif now >= self._hold_until:
                if (self._active_throttles > 0
                        and target < self.level - 1):
                    # the lag signal is quiet BECAUSE shedding works,
                    # but demand is still parked in reader throttles:
                    # unleashing straight to target would re-stall the
                    # loop and limit-cycle between extremes — drain
                    # gracefully, one level per hold window
                    self._set_level(self.level - 1, now)
                else:
                    # true load drop: straight to target, so recovery
                    # completes within ONE hysteresis window
                    self._set_level(target, now)

    def _set_level(self, level: int, now: float) -> None:
        prev, self.level = self.level, level
        self._hold_until = now + self.hold_s
        if level > prev:
            for lv in range(prev + 1, level + 1):
                self.enters[lv] += 1
            log.warning("overload level %d -> %d (%s): pressure=%.2f %s",
                        prev, level, LEVEL_NAMES[level],
                        self._last_pressure, self._last_signals)
            events.emit("overload_level_enter",
                        detail=f"{LEVEL_NAMES[level]} {self._last_signals}",
                        value=float(level))
            if level >= 3:
                self._shed_top_talkers()
        elif level < prev:
            log.info("overload level %d -> %d (recovered to %s)",
                     prev, level, LEVEL_NAMES[level])
            events.emit("overload_level_exit",
                        detail=LEVEL_NAMES[level], value=float(level))

    # ------------------------------------------------------------ responses

    def record_publish(self, sid: Any) -> None:
        if sid is not None:
            self._talker_counts[sid] = self._talker_counts.get(sid, 0) + 1

    def record_publish_n(self, sid: Any, n: int) -> None:
        """Batched talker accounting for the wire fast path: admitted
        QoS0 batches bypass publish_delay (the path only runs at level
        0), but the heaviest-talker signal must keep integrating — L3's
        top-N pick and the L1 proportional factor read these rates the
        moment pressure arrives."""
        if sid is not None and self.mode == "governor":
            self._talker_counts[sid] = self._talker_counts.get(sid, 0) + n

    def _fold_talkers(self, dt: float) -> None:
        """Fold this tick's per-sid publish counts into rate estimates.
        Asymmetric: rates ratchet UP fast but decay slowly — tracked
        rates measure ADMITTED load, and once the throttle bites, a
        flood's admitted rate collapses to the throttle rate; without
        the slow decay the flood would read as "light" (and a
        well-behaved client as the heaviest talker) for as long as the
        shedding works. "Recently heavy stays heavy" is the property
        the proportional factor and the L3 top-N pick need."""
        if dt <= 0:
            return
        counts, self._talker_counts = self._talker_counts, {}
        for sid, n in counts.items():
            inst = n / dt
            prev = self._talker_rates.get(sid, 0.0)
            if inst >= prev:
                self._talker_rates[sid] = 0.5 * prev + 0.5 * inst
            else:
                self._talker_rates[sid] = max(inst, prev * 0.97)
        for sid in list(self._talker_rates):
            if sid not in counts:
                r = self._talker_rates[sid] * 0.9  # idle: decay faster
                if r < 0.1:
                    del self._talker_rates[sid]
                else:
                    self._talker_rates[sid] = r
        # mean cached here, read per-PUBLISH by publish_delay: rates
        # only mutate in this fold, and an O(sessions) sum on the hot
        # path would deepen the very overload being governed
        rates = self._talker_rates
        self._rates_mean = (sum(rates.values()) / len(rates)) if rates \
            else 0.0

    async def throttle_publish(self, sid: Any) -> float:
        """Apply the graded reader pause for one inbound PUBLISH and
        return it. Parked sessions are counted while they sleep — the
        demand signal de-escalation consults (see _update_level)."""
        delay = self.publish_delay(sid)
        if delay > 0:
            self._active_throttles += 1
            try:
                await asyncio.sleep(delay)
            finally:
                self._active_throttles -= 1
        return delay

    def publish_delay(self, sid: Any) -> float:
        """Reader-loop pause for one inbound PUBLISH, combining the L1
        proportional throttle with the L2 token bucket. 0.0 below L1.
        In binary mode this IS the legacy response: a fixed 0.1s while
        the sysmon flag is up."""
        if self.mode != "governor":
            sysmon = getattr(self.broker, "sysmon", None)
            return 0.1 if (sysmon is not None and sysmon.overloaded) \
                else 0.0
        self.record_publish(sid)
        lv = self.level
        if lv <= 0:
            return 0.0
        # proportional: the delay scales with the session's share of
        # recent publish volume — heavier-than-average talkers wait up
        # to 4x the base, well-behaved (below-average) talkers as
        # little as 0.1x, so shedding lands on the load source instead
        # of collapsing p99 for everyone (the binary flag's failure
        # mode). With no rate history yet everyone pays the base.
        mean = self._rates_mean
        share = (self._talker_rates.get(sid, 0.0) / mean) \
            if mean > 0 else 1.0
        delay = self.l1_throttle_s * lv * min(4.0, max(0.1, share))
        if lv >= 2:
            wait = self._token_wait(sid, time.monotonic())
            if wait > 0:
                self.broker.metrics.incr("overload_rate_limited")
                delay = max(delay, wait)
        if delay > 0:
            # counted only when a real pause results: with the L1 base
            # configured to 0 the counter must not climb at publish rate
            self.broker.metrics.incr("overload_publish_throttled")
        return delay

    def _token_wait(self, sid: Any, now: float) -> float:
        rate = self.l2_client_rate
        if rate <= 0:
            return 0.0
        b = self._buckets.get(sid)
        if b is None:
            b = self._buckets[sid] = [self.l2_burst, now]
        tokens = min(self.l2_burst, b[0] + (now - b[1]) * rate)
        b[1] = now
        # consume even past empty (bounded debt): sustained floods pay
        # ~1/rate per publish instead of resetting at each wake
        b[0] = max(-self.l2_burst, tokens - 1.0)
        if tokens >= 1.0:
            return 0.0
        # capped at 1s: a throttled reader must not outlive its client's
        # keepalive budget inside one frame
        return min(1.0, (1.0 - tokens) / rate)

    def shed_qos0(self) -> bool:
        """L2+: QoS0 fanout is shed at the routing admission gate — no
        ack is owed, so it is the cheapest load in the broker to drop
        (the reference's queues drop QoS0 first under pressure too)."""
        if self.mode != "governor" or self.level < 2:
            return False
        self.broker.metrics.incr("overload_qos0_shed")
        return True

    def defer_replay(self) -> bool:
        """L2+: retained-replay flushes wait out the congestion instead
        of competing with live publishes for the device."""
        if self.mode != "governor" or self.level < 2:
            return False
        self.broker.metrics.incr("overload_replay_deferred")
        return True

    def refuse_connects(self) -> bool:
        """L3: new CONNECTs are refused at the listener."""
        if self.mode != "governor" or self.level < 3:
            return False
        self.broker.metrics.incr("overload_connects_refused")
        return True

    def _shed_top_talkers(self) -> None:
        """Entering L3: disconnect the N heaviest talkers with Server
        busy. QoS>=1 state follows the normal close rules (persistent
        sessions keep their backlog; clients reconnect-and-retry), so
        shedding them loses no acked work."""
        n = self.l3_disconnect_top
        if n <= 0 or self.mode != "governor":
            return
        try:
            loop = asyncio.get_running_loop()
        except RuntimeError:
            return  # sync test harness: no loop to schedule closes on
        rates = self._talker_rates
        # floor: only talkers above the declared L2 fair rate qualify —
        # a well-behaved client must never be shed just because
        # throttling starved the heavy talkers' ADMITTED rates down to
        # nothing (tracked rates measure admitted load, not offered)
        floor = max(1.0, self.l2_client_rate)
        shed = 0
        for sid, rate in sorted(rates.items(), key=lambda kv: -kv[1]):
            if shed >= n or rate < floor:
                break
            sess = self.broker.sessions.get(sid)
            if sess is None or sess.closed:
                continue
            self.broker.metrics.incr("overload_talker_disconnects")
            loop.create_task(sess.overload_disconnect())
            shed += 1

    # ---------------------------------------------------------------- admin

    def pin(self, level: Optional[int]) -> None:
        """Manual level pin for drills (like ``breaker trip``); None
        returns control to the signal fusion."""
        if level is not None and not 0 <= level <= 3:
            raise ValueError("level must be 0..3")
        self.pinned = level
        if level is not None:
            self._set_level(level, time.monotonic())

    def status(self) -> Dict[str, Any]:
        return {
            "level": self.level,
            "level_name": LEVEL_NAMES[self.level],
            "mode": self.mode,
            "pinned": self.pinned,
            "pressure": round(self._last_pressure, 4),
            "signals": {k: round(v, 4)
                        for k, v in sorted(self._last_signals.items())},
            "hold_s": self.hold_s,
            "level_extends": self.level_extends,
            "enters": {f"l{i}": self.enters[i] for i in (1, 2, 3)},
            "seconds": {f"l{i}": round(self.time_at_level[i], 3)
                        for i in (1, 2, 3)},
            "tracked_talkers": len(self._talker_rates),
        }

    def stats(self) -> Dict[str, float]:
        """Gauge snapshot for $SYS / Prometheus (broker._gauges)."""
        return {
            "overload_level": float(self.level),
            "overload_pressure": round(self._last_pressure, 4),
            "overload_level_pinned": float(
                -1 if self.pinned is None else self.pinned),
            "overload_level_extends": float(self.level_extends),
            "overload_l1_seconds": round(self.time_at_level[1], 3),
            "overload_l2_seconds": round(self.time_at_level[2], 3),
            "overload_l3_seconds": round(self.time_at_level[3], 3),
            "overload_level_enters_l1": float(self.enters[1]),
            "overload_level_enters_l2": float(self.enters[2]),
            "overload_level_enters_l3": float(self.enters[3]),
            "overload_peer_pressure": round(
                self._last_signals.get("workers", 0.0), 4),
        }
