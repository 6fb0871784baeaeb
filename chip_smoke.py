"""Chip smoke run of the PyTorch/CUDA port (vernemq_tpu_torch) on one card.

    python3 chip_smoke.py
    python3 chip_smoke.py --phase broker|cluster|replay [--repeat N]

from the root of a checkout, on a machine with a CUDA card (Hopper: the
kernels are built for sm_90a). ``--phase`` builds the kernels and runs
one serving phase alone, ``N`` times (``broker`` with ``[admin]`` and
``[plugins]``), and prints no ``ok`` line. With no arguments it

1. prints the card's name and power limit and builds every kernel of the
   port from the sources in the checkout (``nvcc``); then, in a fresh
   process where CUDA has loaded no kernel module yet, builds a matcher of
   100,000 subscriptions, times its first build's warm dispatch and its
   first two ``match_batch`` calls of 21 publishes, and fails if the first
   call would overrun the broker's default queued-publish expiry (200 ms);
2. holds the tile-match kernel against its plain PyTorch version, bit for
   bit, at the headline probe-A and probe-B shapes (K = 40), at a
   24-bit-id shape (K = 48) on operands that include ids at the byte-plane
   edges, at K = 96 with every id 2^24 - 1 or 65535 (the largest partial
   sums its exactness argument allows), and with publishes longer than L
   and ``$`` publishes against wildcard-first rows; and the reverse-compare
   kernel against its plain version, packed words and chunk counts, at
   probe windows of 512 and 16,384 rows (16- and 24-bit ids), the dense
   window of a 2^20-row table with lc < L, tiles of 64 and 256 query slots,
   lc = 1 and lc = 16 at L = 16, and a table whose size is no multiple of
   the 256-row chunk with windows starting off the chunk grid, with
   ``$``-topics, inactive rows and empty slots; and the extraction kernel
   against its plain version (idx where valid, valid and count, bit for
   bit) with and without chunk counts at the probe-A and retained-dense
   widths, ragged widths, k = 1 and k = 256 and one row, on rows that are
   empty, all ones (count past k), repeated and dead;
3. drives the port's main path — ``GpuRegView.fold_batch`` over a
   1,000,000-subscription table (the bench.py headline corpus: 60% exact,
   20% ``w0/+/w2``, 10% ``+/w1/w2``, 10% ``w0/w1/#``; L = 8, max_fanout 256,
   flat_avg 128) with zipf batches of 4096 publishes — and checks exact
   ``(filter, key)`` set equality with the port's own host trie on 1024
   publishes of every batch, that no publish fell back to the host, and
   that the tile and extraction kernels were launched on that path (one
   extraction a probe and one for dense region 0 in every dispatch, and no
   plain extraction of a tensor on the card);
4. adds and removes 1,000 subscriptions, syncs and checks parity again;
5. times the kernel (CUDA events) per probe and per batch beside its bound
   (achieved TFLOP/s, share of the bound), its plain version, a batched
   fp32 ``torch.bmm`` of the same product (a yardstick the port never
   calls); holds the extraction kernel against its plain version on the
   batch's own packed masks (probe A, probe B, dense region 0) and times
   each (CUDA events, and from a CUDA graph) beside its bound and its plain
   version; then the device path (beside the 11.03 ms of an earlier run
   with the plain extraction) and its profile, a whole batch and the host
   encode/prep, and prints them beside the card and the ptxas register /
   spill report of every kernel template the run launched; then
   ``[mesh]``, the multi-GPU matcher on the one card: the same registry
   served by a ``GpuRegView`` on a (1, 4) mesh of the card (the
   mesh-native seat) for 16 windows of 4096, every publish's rows equal to
   the single-GPU view's and the trie's, nothing served off the card, the
   tile kernel in its shard and dense modes and the extraction kernel
   launched on every shard (launches per shard printed) with no plain
   extraction or bit-pack; a delta round of 2,000 unsubscribes and 2,000
   subscribes and a burst under one level-0 word, each flush written only
   into the slices that own its rows; an adoption replayed exactly once;
   ``match_local_slices`` of 64 topics equal to the trie; the device path
   per window beside the single-GPU one (CUDA events, in turns); and 2
   windows through the legacy sharded seat on a (2, 2) mesh (the tile
   kernel's shard mode is also held against its plain version in step 2,
   at the mesh's slice geometry);
6. serves publish bursts through the serving layer's entry point, a
   ``BatchCollector`` over the same view (200 µs window, windows of 4096,
   super-batches of up to 8, host threshold 8, 500 ms lock bound): 4
   rounds of 9 windows submitted at once, the first one included, with no
   warm-up — two windows fill the two pipeline slots and the other seven
   leave as one super-batch — with exact trie parity on 1024 publishes of
   every window, release in submission order, every host-served counter at
   0, and publishes/s, per-publish latency p50/p99, the dispatch EWMA, the
   windows per super-batch and the ``stage_device_dispatch_ms`` histogram
   printed;
7. churn: 2 more rounds through a collector with the same 500 ms lock
   bound while subscriptions are added and removed through ``on_delta``
   on the event loop, so deltas reach the device between and during the
   flushes: every host-served counter, ``busy_host_pubs`` first, at 0;
8. holds ``match_many``'s ``[K, C + 3B]`` result for K = 8 windows of one
   snapshot against K single dispatches element for element, and times
   both (CUDA events) and ``fold_many`` against K ``fold_batch`` calls;
   then the operator tools (``[tools]``, ``vernemq_tpu_torch/tools/``):
   the kernel-resident scan probe (``PackedScan``: K staged windows
   captured in one CUDA graph) at K = 1, 4 and 16, its replayed rows
   bit-equal to ``match_many_staged`` on the same staged block and its
   ``(chk, tot)`` equal to the host's int32 sums, the tile and extraction
   kernels counted at the capture (no plain extraction or bit-pack); the
   roofline's K ladder (K = 1..16: ``W(K) = a + b·K`` of
   ``call_match_many`` beside the graph's time per window and the bound);
   and ``collector_latency`` at 2,000 and 20,000 publishes/s for 2.5 s
   each, every publish's rows equal to the trie's, none served on the
   host;
9. breaker drill: a fault plan fails ``device.dispatch`` as often as the
   breaker's threshold; the collector's flushes go to the trie with exact
   parity and the breaker opens; with the plan cleared, one half-open
   probe past the (short) backoff closes it and the kernel runs again;
10. background-rebuild drill, on a second view of 100,000 subscriptions
   (``initial_capacity`` 2^17), through a collector with the 500 ms lock
   bound: subscriptions added through ``on_delta`` while the collector
   submits grow the table past its capacity; flushes shed
   ``RebuildInProgress`` to the trie with exact parity while the worker
   thread builds on the card, after the install the device serves again,
   and the ``stage_rebuild_ms`` histogram is printed;
11. the port's broker end to end (``start_broker`` on the card): the same
   1,000,000 subscriptions registered through ``Registry.subscribe`` under
   10,000 subscriber ids of 100 filters with no session, 64 live MQTT
   subscribers (v3.1.1 and v5, 4 filters each from the hot end of the
   pools) and 16 MQTT publishers over TCP in a second process sending the
   burst's 36,864 zipf publishes, a quarter at QoS 1: every subscriber's
   deliveries equal the registry trie's rows for its subscriptions, in
   publish order per publisher; every host-served counter 0; the tile
   and extraction kernels launched; publishes/s, PUBLISH→delivery and
   PUBACK p50/p99 printed; on the same broker the admin surface
   (``[admin]``): during the counted load the clients' process polls the
   admin HTTP API (API key on) every 0.5 s through ``admin/cli.py`` —
   ``metrics show``, ``breaker show``, ``watchdog show``, ``profile
   device`` and a
   ``/metrics`` scrape — with the phase's exactness and 0 host-served
   publishes kept and the admin's device counters equal to the broker's
   own; after it ``breaker trip path=match`` (256 publishes delivered
   exactly, all served by the trie) and ``breaker reset`` (256 more,
   served on the card), a client trace, a ``ql query`` of one subscriber
   id (its 100 filters) and a Graphite reporter into a local sink
   carrying the device counters; then on the same broker the bundled
   plugins (``[plugins]``): over the admin API ``config set
   allow_anonymous=off``, ``plugin enable`` vmq_passwd (``$6$`` entries)
   and vmq_acl (a read rule for all, a user block, a ``%c`` pattern), 16
   authenticated subscribers and 8 authenticated publishers in a second
   process sending 4,096 zipf publishes, a quarter at QoS 1, every
   delivery exact against the trie; a wrong password and an anonymous
   client refused at CONNACK, an ACL-denied SUBSCRIBE answered 0x80 and
   ACL-denied publishes delivered to no one, as the reference broker
   answers; 64 publishes rewritten by a Lua ``auth_on_publish``
   (vmq_diversity, ``script load``) and 64 by an ``auth_on_publish``
   webhook's ``topic`` modifier, and a bridge each way to a second broker
   on the card: every rewritten and bridged publish matched on the card
   and delivered as the trie of its final topic gives it, the host-served
   counters unmoved, the tile and extraction kernels launched; then every
   plugin disabled and anonymous clients allowed again; each counted
   load (``[broker]``, each ``[cluster]`` node, ``[replay]``) runs under
   the broker's own full-collection policy, which freezes the heap its
   bulk load left (``broker/heap.py``): the phase fails if the policy
   froze nothing, and prints every full and young collection of the
   load; then two port
   nodes on the one card
   (``[cluster]``): two broker processes started through
   ``start_broker(cluster_listen=, join=)`` with the SWC store, the same
   corpus split by subscriber id so each node's GPU table holds its
   ~500k rows and the peer's filters as ~300k node-pointer rows (the SWC
   replication time printed), the same live load (all 36,864 publishes)
   split over the nodes with every delivery exact against the nodes'
   tries, cross-node deliveries, no publish served off the card on either
   node (read over each node's admin HTTP API), the tile and extraction
   kernels launched on both (no plain extraction on the card), and an
   unsubscribe of 100 filters on A that stops B's publishes reaching
   them until they are resubscribed;
12. retained reverse match (bench.py config 8, the retained subscribe
   storm): 1,000,000 retained inserts of ``r{0..63}/d{0..255}/m{0..63}``
   topics through a ``RetainStore`` whose dirty hook writes through to a
   ``RetainedIndex`` on the card (L = 8, capacity 2^20, background first
   build waited for), 8 batches of 4096 filters of the storm mix (85%
   ``r/+/m``, 10% ``r/d/#``, 5% ``+/d/m``) through ``match_filters`` with
   every filter equal to ``RetainStore.match_filter``, then 1,000 retain
   deletes and 1,000 new topics scattered in place and one more batch
   checked the same way; filters/s and
   replayed rows/s beside the host walk's, host-fallback filters, the
   compare and extraction kernels' launches per batch (and no plain
   extraction on the card), and the probe and dense launches of both
   timed (CUDA events back to back, and replayed
   from a CUDA graph, which leaves out the wrappers' host work) beside
   their bound (the compare at the card's INT32 lane rate, and at the fp32
   rate earlier runs used), the first design's times, their plain
   versions and the reference's coded dense product as one fp32
   ``torch.matmul``; the device path split into the launches, the
   two-level extraction and the rest;
13. retained replay through the port's broker: the same 1,000,000 stores
   into the broker's ``RetainStore`` (write-through to the GPU index,
   built and waited for), then 16 MQTT subscribers in a second process
   each SUBSCRIBE with 16 storm filters at once: every client's replays,
   as a multiset of (topic, payload, retain), equal the store's matches;
   the replay collector's device path served filters; every degraded,
   rebuild, fallback, stalled and expired replay counter 0 at the broker's
   default expiry; the reverse compare and extraction kernels launched;
14. worker mode (``[workers]``): the broker phase's load through 4
   SO_REUSEPORT workers and one match service on the card — the first
   quarter of the corpus subscribed over MQTT by 2,500 persistent sessions
   through the workers (ring ops to the service), the table settled, then
   the same
   live clients in a second process through the shared port, at a
   queued-publish expiry of 5 s (the broker's default is 200 ms): every
   live subscriber's deliveries exact, nothing served off the card (the
   service's trie-served publishes and failed folds, each worker's
   trie-served publishes and missed folds, all 0), the service's tile and
   extraction kernel launches read from the workers' stats block (no plain
   extraction on the card), and of the group only
   the service holds a GPU device node; publishes/s, PUBLISH->delivery and
   PUBACK p50/p99 and the load time printed beside the broker phase's;
15. the predicate phase (``[predicate]``, bench.py config 13): 512 ``$gt``,
   128 ``$avg`` and 32 host-escape conjunction subscriptions, 6 batches
   of 2048 publishes through ``FilterEngine.filter_batch`` with every
   verdict pair of a batch (1,048,576) on the device (``max_pairs`` 2^20):
   pairs/s beside the host evaluator's, the kernel held against its plain
   version on the last dispatch's inputs (verdicts, count, min, max bit
   for bit; sums allclose), per dispatch the host pair build, upload,
   kernel (CUDA events and a CUDA graph) beside its bound and the plain
   version, and download; ``filter_batch`` equal to
   ``filter_batch_host`` on a fresh batch; the ``device.predicate`` outage
   drill (the breaker opens, the host serves the same rows, a probe closes
   it, dispatches resume).

Its last line is ``{"ok": true, "device": {...}}``; any failed check exits
non-zero before it. Without CUDA it exits non-zero at once.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys
import time

# the headline corpus and its zipf publish stream (bench.py's mix), the
# roofline's tile-kernel bound and the card's data-sheet rates: one code
# with the port's operator tools
from vernemq_tpu_torch.tools.corpus import build_corpus, zipf_topics
from vernemq_tpu_torch.tools.roofline import (BF16_FLOP_PER_S,
                                              HBM_BYTES_PER_S, tile_bound,
                                              window_rows)

SEED = 42
N_SUBS = 1_000_000
BATCH = 4096
BATCHES = 16
DELTA = 1000
PARITY_PUBS = 1024
# serving phases: collector rounds of BURST_WINDOWS windows each (2 fill the
# pipeline slots, the other 7 ride one super-batch of up to SUPER_K)
SUPER_K = 8
BURST_WINDOWS = 9
BURST_ROUNDS = 4
# churn phase: rounds, and subscriptions added (and, past CHURN_LIVE live
# ones, removed) per step of the churn task on the event loop
CHURN_ROUNDS = 2
CHURN_STEP = 100
CHURN_LIVE = 2000
MANY_K = 8
# [tools]: PackedScan at these K against match_many_staged, the roofline's
# K ladder, and collector_latency at TOOLS_RATES publishes/s for TOOLS_SECS
# seconds each
TOOLS_KS = (1, 4, 16)
TOOLS_LADDER = (1, 2, 4, 8, 16)
TOOLS_RATES = (2000.0, 20000.0)
TOOLS_SECS = 2.5
# drills: breaker backoff (s) and the smaller view of the rebuild drill
# mesh phase: windows of BATCH zipf publishes through the 4-slice mesh seat
# (each held to the single-GPU view and the trie), subscribes and as many
# unsubscribes of the delta round, windows through the legacy (2, 2) seat,
# topics of the per-slice match
MESH_WINDOWS = 16
MESH_DELTA = 2000
MESH_LEGACY_WINDOWS = 2
MESH_LOCAL_TOPICS = 64
DRILL_BACKOFF = 0.05
DRILL_SUBS = 100_000
DRILL_CAP = 1 << 17
# broker phase: the headline corpus under subscriber ids of BROKER_PER_ID
# filters each (no session), BROKER_LIVE live MQTT subscribers of 4 filters
# drawn from the hot BROKER_HOT words of each pool, BROKER_PUBLISHERS MQTT
# publishers sending the burst's publishes, a BROKER_QOS1 share at QoS 1;
# the clients run in a process of their own and must be done within
# BROKER_WAIT_S
BROKER_PER_ID = 100
BROKER_LIVE = 64
BROKER_HOT = 8
BROKER_PUBLISHERS = 16
BROKER_PUBS = BURST_WINDOWS * BATCH
BROKER_QOS1 = 0.25
BROKER_WAIT_S = 300
# admin phase, on the broker phase's broker: during its counted load the
# clients' process polls the admin HTTP API (API key on) every
# ADMIN_POLL_S with ADMIN_POLL and a /metrics scrape; after it, the breaker
# drill sends ADMIN_DRILL_PUBS publishes with the match breaker tripped and
# as many after the reset, to ADMIN_DRILL_SUBS subscribers with the
# filters of the first live subscribers; ADMIN_QL_ID's filters come back
# through `ql query`
ADMIN_POLL = (("metrics", "show"), ("breaker", "show"), ("watchdog", "show"),
              ("profile", "device"))
ADMIN_POLL_S = 0.5
ADMIN_DRILL_PUBS = 256
ADMIN_DRILL_SUBS = 8
ADMIN_TRACE_PUBS = 8
ADMIN_QL_ID = "bulk7"
# plugins phase, on the broker phase's broker after [admin]: the shipped
# defaults (allow_anonymous off, vmq_passwd, vmq_acl) turned on over the
# admin API, PLUGIN_LIVE authenticated subscribers and PLUGIN_PUBLISHERS
# authenticated publishers sending PLUGIN_PUBS zipf publishes (a
# BROKER_QOS1 share at QoS 1); then the refusals, PLUGIN_STEP publishes
# rewritten by a Lua script (vmq_diversity) and by a webhook, and
# PLUGIN_STEP publishes each way over a bridge to a second broker
PLUGIN_LIVE = 16
PLUGIN_PUBLISHERS = 8
PLUGIN_PUBS = 4096
PLUGIN_STEP = 64
PLUGIN_USERS = {"plug-sub": "sub-secret", "plug-pub": "pub-secret"}
#: mosquitto-style: every user reads the corpus' topics, the publishers
#: write them, and a client writes under its own client id
PLUGIN_ACL = ("topic read +/+/+\ntopic read +/+/#\nuser plug-pub\n"
              "topic write +/+/+\npattern write own/%c/#\n")
#: the reference broker's answers (tests/test_plugins.py): a wrong
#: password and an anonymous client at CONNACK (v3.1.1), a SUBSCRIBE the
#: ACL denies
RC_BAD_PASSWORD, RC_NOT_AUTHORIZED, SUBACK_DENIED = 4, 5, 0x80
# cluster phase: two broker processes on the one card, each started through
# start_broker(cluster_listen=, join=) with the SWC metadata store; the
# broker phase's corpus split by subscriber id (the first half on node A),
# subscribed CLUSTER_YIELD ids between event-loop turns; the broker
# phase's live load with subscriber j and publisher k on node j % 2 / k % 2;
# then CLUSTER_UNSUB of A's live subscribers (4 filters each) unsubscribe
# and resubscribe while B's publishers send to their exact filters
CLUSTER_NODES = ("A", "B")
CLUSTER_YIELD = 25
CLUSTER_UNSUB = 25
CLUSTER_WAIT_S = 300
#: the broker's host-served publish counters as `metrics show` names them
HOST_METRICS = ("tpu_hybrid_host_pubs", "tpu_overload_shed_pubs",
                "tpu_rebuild_shed_pubs", "tpu_busy_shed_pubs",
                "tpu_degraded_host_pubs", "tpu_stalled_host_pubs",
                "tpu_expired_host_pubs", "tpu_host_fallbacks",
                "tpu_degraded_sheds", "tpu_device_failures")
# workers phase: the broker phase's corpus and live load through worker
# mode — WORKERS_N SO_REUSEPORT workers and one match service on the card.
# The corpus is subscribed over MQTT by persistent v3.1.1 sessions of
# BROKER_PER_ID filters each (QoS 0, disconnected after SUBACK: the
# worker-mode stand-in for the broker phase's session-less ids), spread
# round-robin over the workers' direct ports, WORKERS_CONNECT of them at
# a time, never more than WORKERS_OPS_AHEAD rows ahead of the service
WORKERS_N = 4
# the subscriptions of the workers' load: a quarter of the broker phase's
# corpus (its first quarter by subscription order), a cut of depth that
# keeps the script within its time since the [mesh] phase was added; the
# subscribe load over MQTT through the workers is the script's longest
# step (~155 s at the whole corpus, 52.9-73.6 s at half of it, one H100
# 80GB HBM3 at 700 W)
WORKERS_SUBS = N_SUBS // 4
WORKERS_CONNECT = 32
WORKERS_OPS_AHEAD = 100_000
WORKERS_SETTLE_S = 300
# the workers' queued-publish expiry, in the broker's budgets of 50 ms:
# 100 (5 s, the dispatch deadline). At the default (4, 200 ms) 1.2% of
# this load expired to the workers' tries on one H100 80GB HBM3: their
# event loops, not the card, hold the queue (PERF.md §5)
WORKERS_EXPIRY_BUDGETS = 100
# retained phases, the reference's bench.py config 8 ("retained subscribe
# storm", bench.py:888-1020): RET_N inserts of r{0..63}/d{0..255}/m{0..63}
# topics (L = 8, capacity 2^20), RET_BATCHES batches of BATCH filters of its
# storm mix, the host walk timed on RET_HOST filters; the broker replay:
# RET_SUBSCRIBERS MQTT clients of one SUBSCRIBE of RET_FILTERS storm-mix
# filters each, all replays due within RET_WAIT_S
RET_N = 1_000_000
RET_BATCHES = 8
RET_DELTA = 1000
RET_HOST = 500
RET_SUBSCRIBERS = 16
RET_FILTERS = 16
RET_WAIT_S = 300
# predicate phase, the reference's bench.py config 13 ("telemetry
# downsampling storm", bench.py:2155-2260): schema value:number,
# unit:enum(c|f) on sensors/+/temp over PRED_SENSORS sensors; PRED_GT
# $gt(value,T) subscriptions, PRED_AGG $avg(value,50) windows and PRED_CONJ
# host-escape conjunctions; PRED_BATCHES distinct batches of PRED_BATCH
# publishes cycled over PRED_REPS dispatches, window_cap 2^14, host
# threshold 1; the host evaluator timed on PRED_HOST_REPS of the same
# batches. PRED_MAX_PAIRS: the bench builds its engine with the default
# max_pairs 65,536, below a batch's 1,048,576 verdict pairs, so there every
# batch goes to the host evaluator; here every pair rides the device.
# PRED_REPS and PRED_HOST_REPS are cuts of depth (24 and 2 before, then
# 12 and 2; 6 and 1 since the [tools] phase): each dispatch's ~4 s is host
# pair build, and the script must stay inside its time limit.
PRED_SENSORS = 64
PRED_GT = 512
PRED_AGG = 128
PRED_CONJ = 32
PRED_BATCH = 2048
PRED_BATCHES = 6
PRED_REPS = 6
PRED_HOST_REPS = 1
PRED_WINDOW_CAP = 1 << 14
PRED_MAX_PAIRS = 1 << 20
PRED_DRILL = 16  # publishes per batch of the outage drill
PREDICATE_DESIGN = (
    "one wave of blocks split by role: pair blocks take four pairs a thread "
    "(16-byte loads, one 32-bit store of the verdicts, the next group's "
    "loads in flight) against the predicate table staged in shared memory; "
    "fold blocks reduce into a held zeroed scratch with one float2 atomic "
    "add of (count, value) and min/max atomics only where the value moves "
    "them; the merge, a programmatic dependent launch, writes the partials, "
    "updates acc in place and zeroes the scratch (no memset)")
# HBM_BYTES_PER_S and BF16_FLOP_PER_S (tools/roofline.py) are the NVIDIA
# H100 SXM data sheet's HBM3 bandwidth and dense bf16 tensor rate. The
# reverse kernel's integer compares run on the INT32 lanes, 64 per SM per
# clock (the Hopper architecture white paper): int32_ops_per_s() takes that
# rate from the card (SMs and the max SM clock). FP32_OPS_PER_S, the CUDA
# cores' float32 rate (an FMA counted as two), is the rate the first
# reverse kernel's bounds used; it is printed beside the INT32 bound so the
# row's history compares.
FP32_OPS_PER_S = 67e12
INT32_LANES_PER_SM = 64
DEVICE = "cuda"
# the tile kernel's first version (fp32 FMAs on the CUDA cores), probe A + B
# per batch, measured by this script's first version on one H100 80GB HBM3 at
# 700 W; printed for reference beside this run's time, never as this run's
EARLIER_MS = 7.32
# kernel phase: (label, id bits, L, S, T, TP, seg_max, row mode, options of
# synthetic_probe, glob_pad) — the headline geometry (1M subs, L=8, B=4096:
# S rows, K=40, probe A 24 x 256 x 262144, probe B 24 x 256 x 32768, dense
# region 0 as 32 tiles of 128 publishes x 2048 rows from row 0), a 24-bit-id
# shape (K=48), K=96 at the largest partial sums (every id 2^24-1 or 65535,
# every level weighted), publishes longer than L (and than the kernel's key
# clamp of 31) with $ publishes on wildcard-first rows, the dense mode
# at a glob_pad that is not a multiple of 256 with tiles of 16, and the
# shard mode at the [mesh] phase's geometry (a quarter of the headline
# table, S 403,456 rows, glob_pad 174,080): slice 2, whose rows all lie
# past glob_pad, slice 0 with windows across glob_pad, and the guard off
# over a whole slice (match_local_slices); ``row_base`` in the options is
# the slice's first global row
HEADLINE_S = 1_613_824  # the path phase's table S at the headline corpus
MESH_SL = HEADLINE_S // 4
MESH_GLOB = 174_080
KERNEL_SHAPES = [
    ("probe A K=40", 16, 8, 1_613_824, 24, 256, 262_144, "a", {}, 2048),
    ("probe B K=40", 16, 8, 1_613_824, 24, 256, 32_768, "b", {}, 2048),
    ("dense K=40", 16, 8, 1_613_824, 32, 128, 2048, "dense",
     dict(zero_starts=True), 2048),
    ("24-bit K=48", 24, 8, 1 << 20, 8, 256, 65_536, "a", {}, 2048),
    ("K=96 max ids", 24, 16, 1 << 20, 8, 256, 65_536, "a",
     dict(vocab=[(1 << 24) - 1, 65535], eff_lo=15), 2048),
    ("plen>L $ wild", 16, 8, 1 << 20, 8, 256, 65_536, "b",
     dict(long_pubs=0.3), 2048),
    ("dense ragged", 24, 8, 1 << 20, 5, 16, 2304, "dense",
     dict(zero_starts=True, long_pubs=0.3), 2080),
    ("shard past glob", 16, 8, MESH_SL, 25, 256, 65_536, "shard",
     dict(row_base=2 * MESH_SL), MESH_GLOB),
    ("shard across glob", 16, 8, MESH_SL, 8, 256, 65_536, "shard",
     dict(starts=[MESH_GLOB - 65_536 + 777, MESH_GLOB - 100, 0,
                  MESH_GLOB - 30_000, 150_000, 120_003, MESH_GLOB - 65_536,
                  MESH_GLOB - 1]), MESH_GLOB),
    ("shard guard off", 16, 8, MESH_SL, 1, 64, MESH_SL, "shard",
     dict(zero_starts=True, row_base=MESH_SL), 0),
]
# the reverse kernel's first design (32 queries x 256 rows a block, a
# ballot per query and row word), probe and dense launch of one storm batch,
# measured by an earlier version of this script on one H100 80GB HBM3 at
# 700 W; printed beside this run's times, never as this run's
REVERSE_EARLIER_MS = {"probe": 0.1386, "dense": 0.4195}
# the reverse kernel against its plain version, words and chunk counts:
# (label, N, L, id bits, lc, tiles, TP query slots, seg, ragged) — probe
# windows of 512 and 16,384 rows (16- and 24-bit ids), the dense window of a
# whole 2^20-row table with lc < L, tiles of 64 and 256 slots, lc = 1 and
# lc = 16 at L = 16, and a table of N rows that is no multiple of the
# 256-row chunk with windows starting off the chunk grid (at 777 and at
# N - seg); $-topics, inactive rows and ~10% empty slots everywhere
#: lc templates that spill (ptxas, sm_90a) -> the nearest one that does not
SPILL_NEIGHBOUR = {8: 7, 16: 12}
REVERSE_SHAPES = [
    ("probe seg=512 lc=3", 1 << 20, 8, 16, 3, 128, 32, 512, False),
    ("probe seg=16384 24-bit lc=8", 1 << 20, 8, 24, 8, 128, 32, 16_384,
     False),
    ("dense 2^20 rows lc=3<L", 1 << 20, 8, 16, 3, 8, 32, 1 << 20, False),
    ("probe TP=64 lc=1 L=16", 1 << 20, 16, 16, 1, 128, 64, 16_384, False),
    ("dense TP=256 lc=16 L=16", 1 << 20, 16, 16, 16, 1, 256, 1 << 20,
     False),
    ("ragged N=2^20-100 starts off the chunk grid", (1 << 20) - 100, 8, 16,
     3, 16, 96, 4096, True),
]
# the extraction kernel's first design (one warp a row, one lane emitting a
# chunk's bits), the retained probe and dense extraction of one storm batch
# by CUDA events / from a CUDA graph, and the forward device path per
# 4096-publish batch while its extraction was plain PyTorch, all measured by
# earlier versions of this script on one H100 80GB HBM3 at 700 W; printed
# beside this run's times, never as this run's
EXTRACT_EARLIER_MS = {"probe": (0.0593, 0.0100), "dense": (0.0388, 0.0313)}
PATH_EARLIER_MS = 11.03
# dense region 0 while plain PyTorch packed it (fp32 matmul, compare,
# epilogue, _pack_mask): its profiled operations per 4096-publish batch
# (the pack's sum / mul / copy_ 0.148 ms, the product's mm / add / where /
# eq 0.097 ms) and the device path per batch, measured by an earlier
# version of this script on one H100 80GB HBM3 at 700 W; printed beside
# this run's times, never as this run's
DENSE_EARLIER_MS = 0.245
PATH_EARLIER_MS_PLAIN_DENSE = 3.28
# the extraction kernel against its plain version: (label, R0 rows, W
# words, k, with chunk counts, R selected rows or None for every row) — the
# forward probe A width split over warps and one warp a row, the retained
# dense width (4,136 chunks a row, 224 rows), ragged widths (W = 1029 and
# 61: a last chunk of 5 words), k = 1 and k = 256, one row; every case has an
# empty and an all-ones row (count = 32 W > k), repeated rows out of order
# and ~10% dead rows
EXTRACT_SHAPES = [
    ("probe A width, split rows", 512, 8192, 256, False, 300),
    ("probe A width, a warp a row", 512, 8192, 256, False, 3000),
    ("probe A width, k = 1", 512, 8192, 1, False, 3000),
    ("counts, k = 256", 512, 8192, 256, True, 600),
    ("counts, k = 1", 512, 8192, 1, True, 600),
    ("retained dense width, counts", 224, 4136 * 8, 256, True, 224),
    ("ragged W = 1029", 256, 1029, 256, False, 300),
    ("ragged W = 61, k = 1", 64, 61, 1, False, 64),
    ("every row, W = 64", 4096, 64, 256, False, None),
    ("one row", 8, 8192, 256, False, 1),
    ("one row, counts", 8, 8192, 256, True, 1),
]


class Registry:
    """The registry surface GpuRegView reads (fold_subscriptions + trie).
    The warm load replays subscriptions in the order they were made, as
    bench.py fills its table, so the table gets the bench's layout."""

    def __init__(self, trie_cls):
        self._trie = trie_cls()
        self._rows = {}  # (filter, key) -> None, in subscription order

    def add(self, f, key):
        self._trie.add(f, key, None)
        self._rows[(tuple(f), key)] = None

    def remove(self, f, key):
        self._trie.remove(f, key)
        del self._rows[(tuple(f), key)]

    def fold_subscriptions(self, mountpoint):
        return ((f, key, None) for f, key in self._rows)

    def trie(self, mountpoint):
        return self._trie


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def int32_ops_per_s(torch) -> float:
    """The card's INT32 lane rate: 64 lanes per SM per clock at the max SM
    clock ``nvidia-smi`` reports."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    mhz = float(out.stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return INT32_LANES_PER_SM * sms * mhz * 1e6


def event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` over ``iters`` runs (CUDA events)."""
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def graph_ms(fn, iters: int) -> float:
    """Mean device time of ``fn()`` with the host out of the way: ``iters``
    calls captured in one CUDA graph, the graph replayed and timed by CUDA
    events. Beside :func:`event_ms` it shows how much of a short launch's
    time is the wrapper's host work between launches."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # allocations and first-launch set-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    ms = event_ms(graph.replay, 5) / iters
    del graph
    return ms


def mask_diff(x, y) -> int:
    """Largest |difference| between two packed masks' bits (0 = equal)."""
    return int(((x ^ y) != 0).any()) if x.shape == y.shape else 1


def reset_counts() -> None:
    """Zero the forward path's counters: tile-matcher launches (probes and
    dense mode), extraction kernel launches, and plain extractions and
    bit-packs of tensors on the card."""
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM

    TM.launches = TM.dense_launches = EX.launches = 0
    TK.plain_cuda_extractions = TK.plain_cuda_packs = 0


def forward_counts(label: str, counts=None):
    """``(tile, extraction, dense)`` launches since :func:`reset_counts` in
    this process, or ``counts = (tile, extraction, plain, dense,
    plain_packs)`` read from another. Fails unless the tile kernel ran in
    both its probe and its dense mode and every dispatch's zones went
    through the extraction kernel: a dispatch launches one extraction per
    probe launch and one for dense region 0, so more extraction than probe
    launches, and no plain extraction or plain bit-pack touched the
    card."""
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM

    tile, ex, plain, dense, packs = counts if counts is not None else (
        TM.launches, EX.launches, TK.plain_cuda_extractions,
        TM.dense_launches, TK.plain_cuda_packs)
    if tile <= 0 or ex <= tile or plain or dense <= 0 or packs:
        fail(f"{label}: tile launches {tile}, dense-mode launches {dense}, "
             f"extraction launches {ex}, plain extractions on the card "
             f"{plain}, plain bit-packs on the card {packs}: a dispatch ran "
             f"without its kernels")
    return tile, ex, dense


def synthetic_probe(torch, TK, bits: int, L: int, S: int, T: int, TP: int,
                    seg: int, seed: int, vocab=None, eff_lo: int = 1,
                    long_pubs: float = 0.0, zero_starts: bool = False,
                    starts=None):
    """Random tile-matcher operands on the card and the host copy of the
    window starts. By default a corpus-like vocabulary plus byte-plane edge
    ids, 20% ``+`` levels, eff 1..3, tile publishes copied from rows of
    their own window (so many rows match), ~5% unknown publish words and
    random lengths 1..3. With ``vocab`` every id is drawn from it (no ``+``,
    no unknown words), eff from ``eff_lo``..L, and half the publishes take
    their source row's length; ``long_pubs`` of them get a length in
    L+1..L+39. ``zero_starts``: every window starts at row 0 (the dense
    mode's); ``starts``: these window starts."""
    import numpy as np

    rng = np.random.default_rng(seed)
    if vocab is None:
        edges = np.array([0, 1, 2, 254, 255, 256, 65535, 65536], np.int32)
        vocab = np.concatenate(
            [rng.integers(3, 1 << bits, 380).astype(np.int32), edges])
        plus, unknown, eff_hi = 0.2, 0.05, 4
    else:
        vocab = np.asarray(vocab, np.int32)
        plus, unknown, eff_hi = 0.0, 0.0, L + 1
    words = rng.choice(vocab, (S, L)).astype(np.int32)
    words[rng.random((S, L)) < plus] = TK.PLUS_ID
    eff = rng.integers(eff_lo, eff_hi, S, dtype=np.int32)
    flags = ((rng.random(S) < 0.1) * 1 | (rng.random(S) < 0.3) * 2
             | (rng.random(S) < 0.95) * 4).astype(np.int32)
    start = rng.integers(0, S - seg + 1, T).astype(np.int32)
    if zero_starts:
        start[:] = 0
    if starts is not None:
        start = np.asarray(starts, np.int32)
    src = start[:, None] + rng.integers(0, seg, (T, TP))
    pw = words[src]
    pw[pw == TK.PLUS_ID] = vocab[0]
    pw[rng.random(pw.shape) < unknown] = -2  # UNKNOWN_ID
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    F_t, t1 = TK.build_operands(cuda(words), cuda(eff), bits)
    Gt = TK.build_pub_operand(cuda(pw.reshape(T * TP, L)), bits) \
        .reshape(T, TP, -1).contiguous()
    plt = rng.integers(1, 4, (T, TP)).astype(np.int32)
    if eff_lo > 1 or long_pubs:
        plt = np.where(rng.random((T, TP)) < 0.5, eff[src], plt)
        long = rng.random((T, TP)) < long_pubs
        plt[long] = rng.integers(L + 1, L + 40, int(long.sum()))
    pdt = cuda((rng.random((T, TP)) < 0.1).astype(np.int32))
    return (F_t, t1, cuda(eff), cuda(flags), Gt, cuda(plt.astype(np.int32)),
            pdt, cuda(start)), start


def ptxas_report(text: str, kernel: str = "tile_match_kernel"):
    """{template argument: (registers, spill-store bytes, spill-load bytes)}
    of every ``kernel<N>`` in an ``nvcc -Xptxas -v`` log."""
    import re

    out, kp, spill = {}, None, (0, 0)
    for ln in text.splitlines():
        m = re.search(kernel + r"ILi(\d+)E", ln)
        if m and "Compiling entry function" in ln:
            kp, spill = int(m.group(1)), (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and kp is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and kp is not None:
            out[kp] = (int(m.group(1)), *spill)
            kp = None
    return out


def ptxas_kernels(text: str, names) -> dict:
    """{kernel name: (registers, spill-store bytes, spill-load bytes)} of
    the untemplated kernels ``names`` in an ``nvcc -Xptxas -v`` log."""
    import re

    out, cur, spill = {}, None, (0, 0)
    for ln in text.splitlines():
        if "Compiling entry function" in ln:
            cur = next((n for n in names if n in ln), None)
            spill = (0, 0)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      ln)
        if m and cur is not None:
            spill = (int(m.group(1)), int(m.group(2)))
        m = re.search(r"Used (\d+) registers", ln)
        if m and cur is not None:
            out[cur] = (int(m.group(1)), *spill)
            cur = None
    return out


def probe_bound(inputs, seg: int):
    """(bytes, FLOP) the tile function must move and do on ``inputs``
    (``tools/roofline.py`` ``tile_bound``): every table row the windows
    touch read once (its K bf16 operands, t1, eff, flags), the tile
    operands read once, the packed mask written once; 2·K FLOP per
    (publish, window row)."""
    F_t, _t1, _eff, _flags, Gt, _plt, _pdt, start = inputs
    T, TP, _ = Gt.shape
    return tile_bound(F_t.shape[0], T, TP, start.cpu().tolist(), seg)


def time_dense_region0(card: str, F_t, t1, eff, hh, fw, act, flags, pw,
                       G_all, pl, pd, statics) -> dict:
    """Dense region 0 of one path batch: the tile kernel's dense mode
    (``tile_match.dense_region0_packed``, the path's one launch) held bit
    for bit against its plain version ``match_kernel._dense_region0_packed``
    (the kernel's words past glob_pad/32 all 0), then timed by CUDA events
    and from a CUDA graph beside its bound and the plain version. Returns
    the numbers and the kernel's packed mask (``packed``)."""
    import torch

    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM

    gp = statics["glob_pad"]
    B, K = G_all.shape

    def run():
        return TM.dense_region0_packed(F_t, t1, eff, flags, G_all, pl, pd,
                                       glob_pad=gp)

    def plain():
        return TK._dense_region0_packed(
            F_t, t1, eff, hh, fw, act, pw, pl, pd > 0,
            id_bits=statics["id_bits"], glob_pad=gp, gc=statics["gc"])

    d0 = TM.dense_launches
    got = run()
    want = plain()
    torch.cuda.synchronize()
    W0 = want.shape[1]
    err = mask_diff(got[:, :W0].contiguous(), want) \
        or int(bool((got[:, W0:] != 0).any()))
    if err or TM.dense_launches != d0 + 1:
        fail(f"dense region 0: the dense mode disagrees with "
             f"_dense_region0_packed (max_abs_err {err}) or did not launch "
             f"({TM.dense_launches - d0} launches)")
    T, TP, seg = TM.dense_geometry(B, gp, F_t.shape[1])
    ms = event_ms(run, 20)
    gms = graph_ms(run, 20)
    plain_ms = event_ms(plain, 3)
    # region 0's rows read once (K bf16 operands, t1, eff, flags), the
    # publishes' operands read once, the [B, seg/32] words written once;
    # 2·K FLOP per (publish, region-0 row)
    nbytes = gp * (2 * K + 12) + B * (2 * K + 8) + T * 4 + B * seg // 8
    flop = 2.0 * B * gp * K
    t_b, t_o = nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S
    bound_ms = max(t_b, t_o) * 1e3
    ones = int(TK._popcount(want).sum())
    print(f"[time] {card} | dense region 0 ({B} publishes x glob_pad {gp}): "
          f"one tile launch in dense mode (T={T} TP={TP} seg={seg}), "
          f"{ones} set bits, bit-equal to _dense_region0_packed; kernel "
          f"{ms:.4f} ms by CUDA events, {gms:.4f} ms from a CUDA graph, its "
          f"bound {bound_ms:.4f} ms ({'bytes' if t_b >= t_o else 'operations'}"
          f": {nbytes / 1e6:.2f} MB, {flop / 1e9:.2f} GFLOP; the graph's "
          f"launch at {100 * bound_ms / gms:.1f}% of it), plain version "
          f"{plain_ms:.3f} ms (its operations profiled in an earlier run: "
          f"{DENSE_EARLIER_MS} ms a batch)", flush=True)
    return dict(packed=got, ms=ms, graph_ms=gms, plain_ms=plain_ms,
                bound_ms=bound_ms,
                bound_by="bytes" if t_b >= t_o else "operations",
                bytes=nbytes, flop=flop, max_abs_err=err, T=T, TP=TP,
                seg=seg, set_bits=ones)


def profile_device_path(torch, fn, card: str, path_ms: float,
                        reps: int = 3) -> None:
    """Where the device path's time goes: torch.profiler over ``reps``
    batches — the device-busy share (kernel time over the profiled window's
    wall time, and over ``path_ms``, the path's time per batch measured
    with CUDA events and no profiler), the top operators by the device time
    of their kernels (with input shapes), and the hand kernels' own rows."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    avg = prof.key_averages(group_by_input_shape=True)
    kernels = [e for e in avg if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    print(f"[profile] {card} | device path x{reps}: wall {wall_ms:.2f} ms, "
          f"kernels {busy_ms:.2f} ms (device busy "
          f"{100 * busy_ms / wall_ms:.1f}% of the profiled wall, "
          f"{100 * busy_ms / reps / path_ms:.1f}% of the unprofiled "
          f"{path_ms:.2f} ms per batch)")
    ops = [e for e in avg if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    ops.sort(key=lambda e: -e.self_device_time_total)
    for e in ops[:10] + [e for e in kernels if "tile_match" in e.key
                         or "extract_kernel" in e.key]:
        shapes = str(getattr(e, "input_shapes", "") or "")[:60]
        print(f"[profile]   {e.self_device_time_total / 1e3 / reps:8.3f} ms "
              f"per batch  x{e.count // reps:<3d} {e.key[:44]} {shapes}")


#: counters of the collector and the matcher that count publishes served by
#: the host instead of the device: all 0 outside the drills
COLLECTOR_HOST = ("degraded_host_pubs", "busy_host_pubs", "rebuild_host_pubs",
                  "overload_host_pubs", "expired_host_pubs",
                  "stalled_host_pubs", "host_hybrid_pubs")
MATCHER_HOST = ("host_fallbacks", "degraded_sheds", "device_failures")


def host_served(col, m, base=None):
    """The host-served counters of a collector and a matcher (the matcher's
    as deltas from ``base``)."""
    out = {k: getattr(col, k) for k in COLLECTOR_HOST}
    for k in MATCHER_HOST:
        out[k] = getattr(m, k) - (base or {}).get(k, 0)
    return out


def settle_sync(m) -> int:
    """Finish any pending table sync, waiting out a background rebuild;
    returns how many rebuilds ran in the background."""
    from vernemq_tpu_torch.models.matcher import RebuildInProgress

    before = m.rebuilds_async
    while True:
        with m.lock:
            try:
                m.sync()
                return m.rebuilds_async - before
            except RebuildInProgress:
                th = m._rebuild_thread
        if th is not None:
            th.join()


def check_rows(trie, topics, rows, label: str) -> None:
    """Exact (filter, key) equality with the trie on 1024 publishes of
    every window of ``topics``."""
    for w in range(0, len(topics), BATCH):
        for i in range(w, min(w + PARITY_PUBS, len(topics))):
            want = trie.match(list(topics[i]))
            if sorted((f, str(k)) for f, k, _ in rows[i]) != \
                    sorted((f, str(k)) for f, k, _ in want):
                fail(f"{label}: topic {topics[i]} got {len(rows[i])} rows, "
                     f"trie {len(want)}")


async def serve(col, topics):
    """Submit every topic at once and await them all. Returns (rows,
    release order, per-publish latency ms from submit to result, wall s,
    seconds spent in the submit loop)."""
    import asyncio

    n = len(topics)
    order, sub_t, done_t = [], [0.0] * n, [0.0] * n

    def done(_f, i):
        order.append(i)
        done_t[i] = time.perf_counter()

    t0 = time.perf_counter()
    futs = []
    for i, tp in enumerate(topics):
        f = col.submit("", tp)
        sub_t[i] = time.perf_counter()
        f.add_done_callback(lambda f, i=i: done(f, i))
        futs.append(f)
    submit_s = time.perf_counter() - t0
    rows = await asyncio.gather(*futs)
    wall = time.perf_counter() - t0
    return (rows, order, [(d - s) * 1e3 for s, d in zip(sub_t, done_t)],
            wall, submit_s)


def collector_kw() -> dict:
    return dict(window_us=200, max_batch=BATCH, super_batch_k=SUPER_K,
                host_threshold=8, lock_busy_shed_ms=500)


def phase_mesh(card: str, reg, view, rng, pools) -> dict:
    """[mesh] the multi-GPU matcher on one card: the path phase's registry
    (nothing new loaded) served by a ``GpuRegView`` whose mesh is (1, 4)
    of the one card (the mesh-native seat) and then (2, 2) (the legacy
    sharded seat, ``mesh_native=False``). Every publish of every window
    must get the single-GPU view's rows and the trie's, nothing may be
    served off the card, and the windows' dispatches must launch the tile
    kernel (shard and dense modes) and the extraction kernel with no plain
    extraction or bit-pack on the card. A delta round must be written only
    into the slices that own its rows, an adoption replayed exactly once,
    and the per-slice match of 64 topics must union to the trie. Prints
    the launches per shard and the device path per window beside the
    single-GPU path's (CUDA events, in turns)."""
    import numpy as np
    import torch

    from vernemq_tpu_torch.models.matcher import GpuRegView
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM
    from vernemq_tpu_torch.parallel import mesh_match as MM
    from vernemq_tpu_torch.parallel import sharded_match as SM
    from vernemq_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    trie = reg.trie("")
    kw = dict(max_levels=8, initial_capacity=1 << (N_SUBS - 1).bit_length(),
              max_fanout=256, flat_avg=128)

    def norm(rows):
        return sorted((f, str(k)) for f, k, _ in rows)

    def counts():
        return (TM.launches, EX.launches, TK.plain_cuda_extractions,
                TM.dense_launches, TK.plain_cuda_packs)

    def windows(n: int, label: str, v, m):
        """n windows through view ``v`` (seat ``m``), each publish held to
        the single-GPU view and the trie; returns (per-window ms, the
        seat's launches (tile, extraction, plain, dense, plain packs))."""
        base = {k: getattr(m, k) for k in MATCHER_HOST}
        got = [0] * 5
        lat = []
        for w in range(n):
            topics = zipf_topics(rng, pools, BATCH)
            single = view.fold_batch("", topics)
            c0 = counts()
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = v.fold_batch("", topics)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            got = [g + b - a for g, a, b in zip(got, c0, counts())]
            for tp, a, b in zip(topics, rows, single):
                want = norm(trie.match(list(tp)))
                if norm(a) != want or norm(b) != want:
                    fail(f"{label} window {w}: topic {tp} got {len(a)} rows, "
                         f"the single-GPU view {len(b)}, the trie "
                         f"{len(want)}")
        off = {k: getattr(m, k) - base[k] for k in MATCHER_HOST}
        if any(off.values()):
            fail(f"{label}: publishes served off the card: {off}")
        forward_counts(label, tuple(got))
        return lat, got

    # ---------------------------------------------- the mesh-native seat
    t0 = time.perf_counter()
    mview = GpuRegView(reg, mesh=make_mesh([DEVICE] * 4, batch=1), **kw)
    mm = mview.matcher("")
    mview.fold_batch("", zipf_topics(rng, pools, BATCH))  # first build
    torch.cuda.synchronize()
    sw = mm._swm
    nsl = sw.nslices
    print(f"[mesh] {card} | GpuRegView on a (1, 4) mesh of {DEVICE} x 4 "
          f"(MeshGpuMatcher): the path phase's {len(reg._rows)} "
          f"subscriptions "
          f"loaded and built in {time.perf_counter() - t0:.1f}s, S={sw._S} "
          f"in {nsl} slices of {sw._S // nsl} rows, dense zone {sw._glob} "
          f"rows ({sw._glob // nsl} a slice), warm dispatch "
          f"{mm.warm_ms:.1f} ms", flush=True)
    SM.shard_launches.clear()
    lat, launched = windows(MESH_WINDOWS, "[mesh]", mview, mm)
    per_shard = {f"{b},{s_}": dict(c)
                 for (b, s_), c in sorted(SM.shard_launches.items())}
    p50 = float(np.percentile(lat, 50))
    print(f"[mesh] {card} | {MESH_WINDOWS} windows x {BATCH}: every "
          f"publish's rows equal the single-GPU view's and the trie's, "
          f"host-served 0, tile / dense-mode / extraction launches "
          f"{launched[0]} / {launched[3]} / {launched[1]}, plain "
          f"extractions and bit-packs on the card 0; per shard (batch, "
          f"slice): {per_shard}; fold_batch p50 {p50:.2f} ms", flush=True)

    # --------------------------------------------------------- delta round
    drng = random.Random(SEED + 12)
    l0, l1, l2 = pools
    for f, key in drng.sample(list(reg._rows), MESH_DELTA):
        reg.remove(f, key)
        for v in (view, mview):
            v.on_delta("remove", "", list(f), key, None)
    for i in range(MESH_DELTA):
        f = [drng.choice(l0), drng.choice(l1), drng.choice(l2)]
        if drng.random() < 0.3:
            f[drng.randrange(3)] = "+"
        reg.add(f, f"mesh{i}")
        for v in (view, mview):
            v.on_delta("add", "", f, f"mesh{i}", None)
    with mm.lock:
        dirty = np.array(sorted(mm.table.dirty), dtype=np.int64)
    owners = sorted(set(sw.slice_of_rows(dirty).tolist()))
    snap = [(sw._dev[1].data(0, s_).clone(), sw._dev[2].data(0, s_).clone())
            for s_ in range(nsl)]
    flushes0, builds0 = sw.route_flushes, sw.full_scatters
    t0 = time.perf_counter()
    if settle_sync(mm) or sw.full_scatters != builds0:
        fail("[mesh] the delta round rebuilt the table instead of routing")
    delta_ms = (time.perf_counter() - t0) * 1e3
    written = [s_ for s_ in range(nsl) if not (
        torch.equal(sw._dev[1].data(0, s_), snap[s_][0])
        and torch.equal(sw._dev[2].data(0, s_), snap[s_][1]))]
    route = dict(sw.last_route)
    if sw.route_flushes != flushes0 + 1 or route["dirty_slices"] != owners \
            or not set(written) <= set(owners):
        fail(f"[mesh] delta routed to {route['dirty_slices']}, wrote "
             f"{written}, owners {owners}, flushes "
             f"{sw.route_flushes - flushes0}")
    del snap
    st = mview.mesh_status()
    print(f"[mesh] {card} | delta round +{MESH_DELTA}/-{MESH_DELTA} "
          f"subscriptions ({len(dirty)} dirty rows) in one slice-routed "
          f"flush of {delta_ms:.1f} ms: route_flushes {st['route_flushes']}, "
          f"dirty slices {route['dirty_slices']} (rows owned there), g-zone "
          f"mirrors {'written' if route['gzone'] else 'untouched'}, slices "
          f"whose rows changed {written}, full placements "
          f"{st['full_scatters']}; rows per slice {st['rows_per_slice']}",
          flush=True)
    # a subscribe burst under one level-0 word: rows of one bucket region,
    # so the flush lands on the slice(s) owning it and not on the g-zone
    word = l0[5]
    for i in range(MESH_DELTA // 10):
        f = [word, drng.choice(l1), drng.choice(l2)]
        reg.add(f, f"meshb{i}")
        for v in (view, mview):
            v.on_delta("add", "", f, f"meshb{i}", None)
    with mm.lock:
        dirty = np.array(sorted(mm.table.dirty), dtype=np.int64)
    owners = sorted(set(sw.slice_of_rows(dirty).tolist()))
    settle_sync(mm)
    burst = dict(sw.last_route)
    if burst["dirty_slices"] != owners or burst["gzone"] \
            or len(owners) > 2 or sw.full_scatters != builds0:
        fail(f"[mesh] one-word burst routed to {burst}, owners {owners}")
    print(f"[mesh] {card} | a burst of {MESH_DELTA // 10} subscribes under "
          f"{word!r}: one flush routed to slice(s) {owners} only, the g-zone "
          f"mirrors untouched", flush=True)
    windows(2, "[mesh] after the deltas", mview, mm)

    # ----------------------------------------------------------- adoption
    flushes1 = sw.route_flushes
    token = ("chip_smoke", 1)
    marked = mview.adopt_slices([1], token)
    again = mview.adopt_slices([1], token)
    settle_sync(mm)
    adopted_route = list(sw.last_route["dirty_slices"])
    third = mview.adopt_slices([1], token)
    settle_sync(mm)
    if marked <= 0 or again or third or adopted_route != [1] \
            or sw.route_flushes != flushes1 + 1 or mm.slice_adoptions != 1:
        fail(f"[mesh] adoption: marked {marked}, repeats {again} / {third}, "
             f"route {adopted_route}, flushes "
             f"{sw.route_flushes - flushes1}")
    print(f"[mesh] {card} | adopt_slices([1]) replayed {marked} rows in one "
          f"flush routed to slice 1; the repeated token replayed 0 rows "
          f"twice (slice_adoptions {mm.slice_adoptions})", flush=True)

    # --------------------------------------------------- per-slice match
    topics = zipf_topics(rng, pools, MESH_LOCAL_TOPICS)
    MM.local_launches.update(tile=0, extract=0)
    c0 = counts()
    ids, ranges = sw.match_local_slices(topics)
    plain = [b - a for a, b in zip(c0, counts())]
    ent = mm.table.entries
    for tp, sl in zip(topics, ids):
        rows = [ent[i] for i in sl if ent[i] is not None]
        if norm(rows) != norm(trie.match(list(tp))):
            fail(f"[mesh] match_local_slices: topic {tp} got {len(rows)}")
    if plain[2] or plain[4] or MM.local_launches["tile"] != nsl:
        fail(f"[mesh] match_local_slices launches {MM.local_launches}, "
             f"plain extractions / bit-packs {plain[2]} / {plain[4]}")
    print(f"[mesh] {card} | match_local_slices: {MESH_LOCAL_TOPICS} topics "
          f"over {len(ranges)} slices, the union equal to the trie, on the "
          f"tile kernel (shard mode, guard off) and the extraction kernel: "
          f"launches {MM.local_launches}", flush=True)

    # ----------------------------------------- device path beside single
    m = view.matcher("")
    topics = zipf_topics(rng, pools, BATCH)
    with mm.lock:
        mm.sync()
        p = sw._prep_encoded(*mm._encode_batch_ex(topics)[:4], len(topics))
    mesh_fn = sw._fn_for(*p["geom"], glob=p["glob"], S=p["S"],
                         bits=p["bits"])
    with m.lock:
        m.sync()
        enc = m._encode_batch_ex(topics)
        args, statics, _ = m._flat_prep(
            m._layout_locked(), int(m._operands[0].shape[1]), *enc,
            len(topics))
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    host = [cuda(a) for a in args[:3]] + [int(args[3]), cuda(args[4]),
                                          args[5], cuda(args[6]), args[7]] \
        + [cuda(a) for a in args[8:]]
    table = (*m._operands, *m._dev_arrays[1:])
    single_call = lambda: TK.match_extract_windowed_flat(*table, *host,
                                                          **statics)
    mesh_call = lambda: mesh_fn(*p["dev"], *p["args"])
    turns = [event_ms(f, 5) for f in (single_call, mesh_call, mesh_call,
                                      single_call)]
    single_ms, mesh_ms = (turns[0] + turns[3]) / 2, (turns[1] + turns[2]) / 2
    print(f"[mesh] {card} | device path per {BATCH}-publish window (CUDA "
          f"events, 5 calls each, in turns single / mesh / mesh / single): "
          f"4-slice mesh {turns[1]:.3f} / {turns[2]:.3f} ms, single-GPU "
          f"{turns[0]:.3f} / {turns[3]:.3f} ms (recorded, not targeted)",
          flush=True)
    mview.close()
    del mview, mm, sw, p, mesh_fn, mesh_call, ids
    torch.cuda.empty_cache()

    # -------------------------------------------------- the legacy seat
    t0 = time.perf_counter()
    lview = GpuRegView(reg, mesh=make_mesh([DEVICE] * 4, batch=2),
                       mesh_native=False, **kw)
    lm = lview.matcher("")
    lview.fold_batch("", zipf_topics(rng, pools, BATCH))
    torch.cuda.synchronize()
    if not isinstance(lm, SM.ShardedGpuMatcher) or not lm._swm.merge \
            or isinstance(lm, MM.MeshGpuMatcher):
        fail(f"[mesh] tpu_mesh_native=false seated {type(lm).__name__}")
    load_s = time.perf_counter() - t0
    legacy_lat, legacy = windows(MESH_LEGACY_WINDOWS, "[mesh] legacy",
                                 lview, lm)
    print(f"[mesh] {card} | legacy seat (ShardedGpuMatcher, merge=True) on "
          f"a (2, 2) mesh of {DEVICE} x 4, built in {load_s:.1f}s: "
          f"{MESH_LEGACY_WINDOWS} windows x {BATCH} equal to the single-GPU "
          f"view and the trie, host-served 0, tile / dense-mode / "
          f"extraction launches {legacy[0]} / {legacy[3]} / {legacy[1]}",
          flush=True)
    lview.close()
    del lview, lm
    torch.cuda.empty_cache()
    took = time.perf_counter() - t_phase
    print(f"[mesh] {card} | [mesh] took {took:.1f}s", flush=True)
    return dict(tile=launched[0], dense=launched[3], extract=launched[1],
                legacy_tile=legacy[0], legacy_dense=legacy[3],
                legacy_extract=legacy[1], per_shard=per_shard,
                local_launches=dict(MM.local_launches), ms=mesh_ms,
                single_ms=single_ms, fold_p50_ms=p50, delta_ms=delta_ms,
                seconds=took)


def phase_burst(view, m, trie, rng, pools, card: str) -> tuple:
    """Collector bursts at the headline width; returns the tile and
    extraction launches of the measured rounds."""
    import asyncio

    import numpy as np

    from vernemq_tpu_torch.models.matcher import BatchCollector
    from vernemq_tpu_torch.observability import histogram as hist
    from vernemq_tpu_torch.observability.profiler import profiler

    # no warm-up: the first round is measured like the others
    rounds = [zipf_topics(rng, pools, BURST_WINDOWS * BATCH)
              for _ in range(BURST_ROUNDS)]
    col = BatchCollector(view, **collector_kw())
    base = {k: getattr(m, k) for k in MATCHER_HOST}
    sd0 = m.super_dispatches

    async def measured():
        return [await serve(col, r) for r in rounds]

    hist.reset_all()
    profiler().reset()
    reset_counts()
    served = asyncio.run(measured())
    launches, ex_launches, dense = forward_counts("burst")
    for r, (topics, (rows, order, *_)) in enumerate(zip(rounds, served)):
        check_rows(trie, topics, rows, f"burst round {r}")
        if order != list(range(len(topics))):
            fail(f"burst round {r}: results released out of submission "
                 f"order")
    hs = host_served(col, m, base)
    if any(hs.values()):
        fail(f"burst: publishes served by the host: {hs}")
    if launches <= 0:
        fail("burst: the collector never launched the tile kernel")
    supers = m.super_dispatches - sd0
    if col.super_batches < 1 or supers < 1:
        fail(f"burst: no super-batch (collector {col.super_batches}, "
             f"matcher {supers})")
    lat = np.concatenate([np.asarray(x[2]) for x in served])
    wall = sum(x[3] for x in served)
    submit_ms = 1e3 * sum(x[4] for x in served) / len(served)
    n_pubs = BURST_ROUNDS * BURST_WINDOWS * BATCH
    per_super = col.super_batch_pubs / col.super_batches / BATCH
    print(f"[burst] {card} | {BURST_ROUNDS} rounds x {BURST_WINDOWS} windows "
          f"x {BATCH}: {n_pubs / wall:.0f} publishes/s end to end, "
          f"per-publish latency p50 {np.percentile(lat, 50):.1f} ms p99 "
          f"{np.percentile(lat, 99):.1f} ms, dispatch EWMA "
          f"{col.dispatch_ewma_ms:.1f} ms, round wall "
          f"{1e3 * wall / len(served):.0f} ms (rounds "
          f"{', '.join(f'{1e3 * x[3]:.0f}' for x in served)}, the first "
          f"unwarmed) of which {submit_ms:.0f} ms in the submit loop, {col.super_batches} super-batches "
          f"of {per_super:.2f} windows each ({supers} match_many "
          f"dispatches), saturated merges {col.saturated_merges}; parity "
          f"exact on {PARITY_PUBS} publishes per window, released in "
          f"submission order, tile / dense-mode / extraction launches "
          f"{launches} / {dense} / {ex_launches}, plain bit-packs on the "
          f"card 0, host-served counters all 0", flush=True)
    # the dispatch records (encode, window prep, device, download; no row
    # resolve) of the measured rounds, by windows per dispatch
    recs = profiler().snapshot(kind="match")
    by_k = {}
    for r in recs:
        by_k.setdefault(r["k"], []).append(r["dur_ms"])
    wait = hist.summary(hist.get("stage_collector_wait_ms").snapshot())
    disp = hist.summary(hist.get("stage_device_dispatch_ms").snapshot())
    print(f"[burst] {card} | dispatches without the row resolve: " + ", ".join(
        f"{len(v)} x {k} window(s) mean {np.mean(v):.1f} ms"
        for k, v in sorted(by_k.items())) + f"; stage_device_dispatch_ms "
          f"mean {disp.get('mean_ms', 0):.1f} ms (log2-bucket p99 "
          f"{disp.get('p99_ms', 0):.1f}) over {int(disp['count'])}; "
          f"queue wait at flush start "
          f"p50 {wait.get('p50_ms', 0):.1f} ms p99 "
          f"{wait.get('p99_ms', 0):.1f} ms over {int(wait['count'])} "
          f"flushes", flush=True)
    return launches, ex_launches, dense


def phase_churn(view, m, trie, reg, rng, pools, card: str) -> tuple:
    """Collector rounds under subscription churn, with the 500 ms lock
    bound: a task on the event loop adds CHURN_STEP subscriptions through
    on_delta at every step (and removes the oldest past CHURN_LIVE) while
    the rounds run, so delta syncs land between and during the flushes.
    The churned filters end in one of 64 words no publish carries, so the
    trie's rows stay what the device must return and the word ids stay
    within the table's id width. Every host-served counter must read 0 and
    no rebuild may run, the final sync included; returns the tile and
    extraction launches of the phase."""
    import asyncio
    import collections

    import numpy as np

    from vernemq_tpu_torch.models.matcher import BatchCollector

    l0, l1, _ = pools
    crng = random.Random(SEED + 2)
    rounds = [zipf_topics(rng, pools, BURST_WINDOWS * BATCH)
              for _ in range(CHURN_ROUNDS)]
    col = BatchCollector(view, **collector_kw())
    base = {k: getattr(m, k) for k in MATCHER_HOST}
    rb0, cap0 = m.rebuilds_async, m.table.cap
    live = collections.deque()
    n = [0, 0]  # added, removed

    async def churn(stop):
        while not stop.is_set():
            for _ in range(CHURN_STEP):
                f = [crng.choice(l0), crng.choice([crng.choice(l1), "+"]),
                     f"churn{n[0] % 64}"]
                key = f"churn{n[0]}"
                reg.add(f, key)
                view.on_delta("add", "", f, key, None)
                live.append((f, key))
                n[0] += 1
                if len(live) > CHURN_LIVE:
                    f, key = live.popleft()
                    reg.remove(f, key)
                    view.on_delta("remove", "", f, key, None)
                    n[1] += 1
            await asyncio.sleep(0.005)

    async def run():
        stop = asyncio.Event()
        task = asyncio.get_running_loop().create_task(churn(stop))
        try:
            return [await serve(col, r) for r in rounds]
        finally:
            stop.set()
            await task

    reset_counts()
    served = asyncio.run(run())
    launches, ex_launches, dense = forward_counts("churn")
    settle_sync(m)  # the deltas after the last flush
    for r, (topics, (rows, order, *_)) in enumerate(zip(rounds, served)):
        check_rows(trie, topics, rows, f"churn round {r}")
        if order != list(range(len(topics))):
            fail(f"churn round {r}: results released out of submission "
                 f"order")
    hs = host_served(col, m, base)
    if any(hs.values()) or m.rebuilds_async != rb0:
        fail(f"churn: publishes served by the host: {hs} (rebuilds "
             f"{m.rebuilds_async - rb0})")
    if launches <= 0 or n[0] <= 0:
        fail(f"churn: tile launches {launches}, subscriptions added {n[0]}")
    lat = np.concatenate([np.asarray(x[2]) for x in served])
    wall = sum(x[3] for x in served)
    print(f"[churn] {card} | {CHURN_ROUNDS} rounds x {BURST_WINDOWS} windows "
          f"x {BATCH} with 500 ms lock bound while +{n[0]}/-{n[1]} "
          f"subscriptions went through on_delta (S {cap0} -> "
          f"{m.table.cap}, no rebuild): "
          f"{CHURN_ROUNDS * BURST_WINDOWS * BATCH / wall:.0f} publishes/s, "
          f"p50 {np.percentile(lat, 50):.1f} ms p99 "
          f"{np.percentile(lat, 99):.1f} ms, {col.super_batches} "
          f"super-batches; parity exact, released in submission order, "
          f"tile / dense-mode / extraction launches {launches} / {dense} / "
          f"{ex_launches}, busy_host_pubs 0 and every other host-served "
          f"counter 0", flush=True)
    return launches, ex_launches, dense


def phase_many(view, m, rng, pools, card: str) -> None:
    """match_many's [K, C + 3B] result against K single dispatches of one
    snapshot, element for element; its K launches under the sync check;
    timings beside K single dispatches and K fold_batch calls."""
    import numpy as np
    import torch

    from vernemq_tpu_torch.ops import match_kernel as TK

    batches = [zipf_topics(rng, pools, BATCH) for _ in range(MANY_K)]
    with m.lock:
        m.sync()
        layout = m._layout_locked()
        encs = [m._encode_batch_ex(t) for t in batches]
    S = int(m._operands[0].shape[1])
    preps = [m._flat_prep(layout, S, *e, BATCH) for e in encs]
    statics = preps[0][1]
    if any(p[1] != statics for p in preps) or any(p[2] for p in preps):
        fail("match_many: windows of one snapshot differ in geometry or "
             "left publishes to the host")
    args = [p[0] for p in preps]
    table = (*m._operands, *m._dev_arrays[1:])
    many = TK.call_match_many(*table, args, statics)
    singles = np.stack([m._dispatch_flat(m._dev_arrays, m._operands, a,
                                         statics) for a in args])
    if many.shape != singles.shape or (many != singles).any():
        fail(f"match_many differs from {MANY_K} single dispatches in "
             f"{int((many != singles).sum())} elements")
    staged = TK.stage_many(args, DEVICE)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a device→host sync raises
    try:
        out = TK.match_many_staged(*table, staged, args, statics)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not np.array_equal(out.cpu().numpy(), many):
        fail("match_many_staged differs from call_match_many")
    C = statics["C"]
    matched = int(many[:, C + BATCH:C + 2 * BATCH].sum())
    print(f"[many] K={MANY_K} windows of {BATCH} from one snapshot: "
          f"[{MANY_K}, C + 3B] = {tuple(many.shape)} equal to {MANY_K} "
          f"single dispatches element for element ({matched} matched "
          f"slots); K launches free of host syncs", flush=True)
    many_ms = event_ms(lambda: TK.call_match_many(*table, args, statics), 5)
    single_ms = event_ms(lambda: [m._dispatch_flat(
        m._dev_arrays, m._operands, a, statics) for a in args], 5)
    staged_ms = event_ms(lambda: TK.match_many_staged(
        *table, staged, args, statics), 5)
    fm, fb = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        view.fold_many("", batches)
        fm.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        for b in batches:
            view.fold_batch("", b)
        fb.append((time.perf_counter() - t0) * 1e3)
    print(f"[many] {card} | per {MANY_K} windows, CUDA events (stream time, "
          f"transfers and host gaps included): match_many {many_ms:.2f} ms "
          f"(one upload, {MANY_K} windows, one download) vs {MANY_K} single "
          f"dispatches {single_ms:.2f} ms; the {MANY_K} windows alone from "
          f"the staged block {staged_ms:.2f} ms", flush=True)
    print(f"[many] {card} | wall per {MANY_K} windows: fold_many "
          f"{min(fm):.1f} ms (runs {', '.join(f'{x:.1f}' for x in fm)}) vs "
          f"{MANY_K} x fold_batch {min(fb):.1f} ms (runs "
          f"{', '.join(f'{x:.1f}' for x in fb)})", flush=True)


def phase_tools(view, m, trie, rng, pools, card: str) -> dict:
    """The port's operator tools on the headline matcher: the
    kernel-resident scan probe (``match_kernel.PackedScan``: K staged
    windows captured in one CUDA graph) at K = 1, 4 and 16, its replayed
    ``[K, C + 3B]`` rows bit-equal to ``match_many_staged`` on the same
    staged block and its ``(chk, tot)`` equal to the host's int32 sums of
    those rows, the tile and extraction kernels counted at the capture (no
    plain extraction or bit-pack); the roofline's K ladder (``W(K) = a +
    b·K`` of ``call_match_many`` beside the graph's time per window and the
    bound); a two-rate ``collector_latency`` run exact against the trie.
    Returns the captured launches and the ladder's numbers."""
    import asyncio

    import numpy as np
    import torch

    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.tools import collector_latency as CL
    from vernemq_tpu_torch.tools import roofline as RF
    from vernemq_tpu_torch.tools.corpus import staged_windows

    t0 = time.perf_counter()
    head = (*m._operands, *m._dev_arrays[1:])
    captured = dict(tile=0, dense=0, extract=0)
    for k in TOOLS_KS:
        preps, statics, _ = staged_windows(m, pools, rng, k, BATCH)
        staged = TK.stage_many(preps, DEVICE)
        reset_counts()
        scan = TK.PackedScan(*head, staged, preps, statics)
        forward_counts(f"tools K={k}")
        cap = scan.captured
        two = 2 if statics["seg2_max"] else 1
        if cap != dict(tile=two * k, dense=k, extract=(two + 1) * k):
            fail(f"tools: the K={k} graph captured {cap} launches, not "
                 f"{two} probe, 1 dense and {two + 1} extraction launches a "
                 f"window")
        for key in captured:
            captured[key] += cap[key]
        want = TK.match_many_staged(*head, staged, preps, statics)
        scan.run()
        torch.cuda.synchronize()
        got = scan.rows.cpu().numpy()
        ref = want.cpu().numpy()
        if got.shape != ref.shape or (got != ref).any():
            fail(f"tools: the K={k} graph's rows differ from "
                 f"match_many_staged in {int((got != ref).sum())} elements")
        B, C = preps[0][0].shape[0], statics["C"]
        h = ref.astype(np.int64)
        wrap = lambda x: int((x + 2**31) % 2**32 - 2**31)
        sums = (wrap(h[:, :C].sum()), wrap(h[:, C + B:C + 2 * B].sum()))
        if scan.result() != sums:
            fail(f"tools: the K={k} graph's (chk, tot) {scan.result()} "
                 f"against the host's int32 sums {sums}")
        ms = event_ms(scan.run, 5) / k
        print(f"[tools] {card} | PackedScan K={k}: [{k}, C + 3B] = "
              f"{tuple(got.shape)} replayed from its CUDA graph, bit-equal "
              f"to match_many_staged; (chk, tot) = {sums} equal to the "
              f"host's int32 sums; captured tile / dense-mode / extraction "
              f"launches {cap['tile']} / {cap['dense']} / {cap['extract']}, "
              f"plain extractions and bit-packs 0; {ms:.4f} ms a window "
              f"from the graph", flush=True)
        del scan, staged, want
    torch.cuda.empty_cache()
    lad = RF.k_ladder(m, pools, rng, TOOLS_LADDER, 3, BATCH)
    steps = "; ".join(
        f"K={r['K']}: {r['match_many_ms']:.3f} ms "
        f"({r['match_many_ms_per_window']:.3f} a window), graph "
        f"{r['graph_ms_per_window']:.4f} a window" for r in lad["ladder"])
    print(f"[tools] {card} | roofline K ladder, {BATCH}-publish windows: "
          f"{steps}", flush=True)
    print(f"[tools] {card} | W(K) = a + b·K of call_match_many (host clock, "
          f"best of 3; staging, upload, K dispatches, one download): a = "
          f"{lad['fit_a_ms']:.3f} ms per dispatch, b = {lad['fit_b_ms']:.3f} "
          f"ms per window; the graph's time per window "
          f"{lad['graph_ms_per_window']:.4f} ms (CUDA events); the bound "
          f"per window {lad['bound_ms_per_window']:.4f} ms (tools/roofline.py"
          f" at {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
          f"{BF16_FLOP_PER_S / 1e12:.0f} TFLOP/s)", flush=True)

    async def ladder():
        return await CL.ladder(view, m, trie,
                               lambda n: zipf_topics(rng, pools, n),
                               TOOLS_RATES, TOOLS_SECS)

    fb0 = m.host_fallbacks
    rows = asyncio.run(ladder())
    for r in rows:
        if r["mismatched"] or r["failed"] or r["host_served_pubs"]:
            fail(f"tools: collector_latency at {r['rate_pubs_per_sec']:.0f}"
                 f"/s: {r['mismatched']} publishes' rows differ from the "
                 f"trie's, {r['failed']} failed, {r['host_served_pubs']} "
                 f"served on the host ({r['host']})")
        print(f"[tools] {card} | collector_latency at "
              f"{r['rate_pubs_per_sec']:.0f} publishes/s for {TOOLS_SECS}s "
              f"(achieved {r['achieved_device_rate']:.0f}/s): added p50 "
              f"{r['added_ms_p50']:.2f} ms p99 {r['added_ms_p99']:.2f} ms "
              f"(collector {r['device_ms_p50']:.2f} / "
              f"{r['device_ms_p99']:.2f}, trie {r['trie_ms_p50']:.4f} / "
              f"{r['trie_ms_p99']:.4f}); {r['served_device_pubs']} served "
              f"on the card, 0 on the host; queue wait at flush start p50 "
              f"{r['queue_wait_ms_p50']:.2f} p99 "
              f"{r['queue_wait_ms_p99']:.2f} ms over {r['flushes']:.0f} "
              f"flushes; every publish's rows equal to the trie's "
              f"({r['checked']})", flush=True)
    if m.host_fallbacks != fb0:
        fail(f"tools: {m.host_fallbacks - fb0} publishes fell back to the "
             f"host")
    secs = time.perf_counter() - t0
    print(f"[tools] {card} | phase {secs:.1f}s", flush=True)
    return dict(captured=captured, fit_a_ms=lad["fit_a_ms"],
                fit_b_ms=lad["fit_b_ms"],
                graph_ms=lad["graph_ms_per_window"],
                bound_ms=lad["bound_ms_per_window"],
                latency=[{k: r[k] for k in (
                    "rate_pubs_per_sec", "added_ms_p50", "added_ms_p99",
                    "queue_wait_ms_p50", "queue_wait_ms_p99")}
                    for r in rows], seconds=secs)


def phase_breaker(view, m, trie, rng, pools) -> None:
    """Fail device.dispatch as often as the threshold: flushes go to the
    trie and the breaker opens; cleared, one half-open probe closes it and
    the kernel runs again."""
    import asyncio

    from vernemq_tpu_torch.models.matcher import BatchCollector
    from vernemq_tpu_torch.observability import events
    from vernemq_tpu_torch.ops import tile_match as TM
    from vernemq_tpu_torch.robustness import faults

    col = BatchCollector(view, **collector_kw())
    thr = m.breaker.failure_threshold
    closes0 = m.breaker.closes
    t_drill = time.monotonic()

    async def drill():
        faults.install(faults.FaultPlan(
            [faults.FaultRule("device.dispatch", count=thr)], seed=SEED))
        try:
            for i in range(thr):
                topics = zipf_topics(rng, pools, BATCH)
                rows = (await serve(col, topics))[0]
                check_rows(trie, topics, rows, f"breaker drill flush {i}")
            state = m.breaker.state_name
        finally:
            faults.clear()
        await asyncio.sleep(3 * DRILL_BACKOFF)
        TM.launches = 0
        topics = zipf_topics(rng, pools, BATCH)
        rows = (await serve(col, topics))[0]
        check_rows(trie, topics, rows, "breaker drill probe")
        return state, TM.launches

    failures0 = m.device_failures
    opened, launches = asyncio.run(drill())
    failed = m.device_failures - failures0
    if col.degraded_host_pubs != thr * BATCH or failed != thr \
            or opened != "open":
        fail(f"breaker drill: {col.degraded_host_pubs} publishes degraded, "
             f"{failed} device failures, breaker {opened} after {thr} "
             f"injected failures")
    if m.breaker.state_name != "closed" or m.breaker.closes != closes0 + 1 \
            or launches <= 0:
        fail(f"breaker drill: breaker {m.breaker.state_name} after the "
             f"probe, tile launches {launches}")
    codes = [e["code"] for e in events.journal().snapshot(since=t_drill)]
    if codes != ["breaker_open", "breaker_half_open", "breaker_close"]:
        fail(f"breaker drill: event journal {codes}")
    print(f"[breaker] {thr} injected device.dispatch failures: "
          f"{col.degraded_host_pubs} publishes served by the trie with exact "
          f"parity, breaker opened; cleared, the half-open probe after "
          f"{3 * DRILL_BACKOFF:.2f}s closed it (closes {m.breaker.closes}) "
          f"and the kernel ran again ({launches} launches); events "
          f"{', '.join(codes)}", flush=True)


def phase_rebuild(trie_cls, card: str) -> None:
    """Grow a 100,000-subscription view past its capacity while the
    collector submits: flushes shed RebuildInProgress to the trie while
    the worker thread builds, then the device serves again."""
    import asyncio

    from vernemq_tpu_torch.models.matcher import BatchCollector, GpuRegView
    from vernemq_tpu_torch.observability import histogram as hist
    from vernemq_tpu_torch.ops import tile_match as TM

    rng = random.Random(SEED + 3)
    reg = Registry(trie_cls)
    pools = build_corpus(rng, DRILL_SUBS, reg.add)
    trie = reg.trie("")
    view = GpuRegView(reg, max_levels=8, initial_capacity=DRILL_CAP,
                      max_fanout=256, flat_avg=128, device=DEVICE)
    m = view.matcher("")
    view.fold_batch("", zipf_topics(rng, pools, 64))  # the first build
    s0 = m.table.cap
    col = BatchCollector(view, **collector_kw())
    hist.get("stage_rebuild_ms").reset()

    async def drill():
        served = [0, 0]  # flushes on the device before / after the install
        added = 0
        while True:
            topics = zipf_topics(rng, pools, BATCH)
            shed0, l0 = col.rebuild_host_pubs, TM.launches
            rows = (await serve(col, topics))[0]
            check_rows(trie, topics, rows, "rebuild drill")
            shed = col.rebuild_host_pubs > shed0
            if not shed and TM.launches == l0:
                fail("rebuild drill: a flush neither shed nor launched")
            if m.rebuilds_async == 0:
                served[0] += not shed
                # grow one level-0 word's region until the spare is spent
                # and the table must be rebuilt at a larger capacity
                for _ in range(2000):
                    f = [pools[0][0], "+", f"grow{added}"]
                    reg.add(f, f"g{added}")
                    view.on_delta("add", "", f, f"g{added}", None)
                    added += 1
                if added > 200_000:
                    fail("rebuild drill: the table never outgrew its "
                         "capacity")
            elif not shed and m._rebuild_thread is None:
                served[1] += 1
                if served[1] == 2:
                    return served, added

    t0 = time.perf_counter()
    served, added = asyncio.run(drill())
    hs = {k: v for k, v in host_served(col, m).items()
          if k not in ("rebuild_host_pubs", "host_fallbacks")}
    if m.rebuilds_async < 1 or col.rebuild_host_pubs <= 0 or any(hs.values()):
        fail(f"rebuild drill: rebuilds {m.rebuilds_async}, shed "
             f"{col.rebuild_host_pubs}, other host-served {hs}")
    print(f"[rebuild] {card} | {DRILL_SUBS} subscriptions, capacity "
          f"{DRILL_CAP}: +{added} subscriptions through on_delta while "
          f"serving; S {s0} -> {m.table.cap}, {m.rebuilds_async} background "
          f"rebuild(s), {col.rebuild_host_pubs} publishes shed to the trie "
          f"meanwhile (exact parity), device-served flushes before/after "
          f"the install {served[0]}/{served[1]} (exact parity), "
          f"{time.perf_counter() - t0:.1f}s", flush=True)
    reb = hist.summary(hist.get("stage_rebuild_ms").snapshot())
    print(f"[rebuild] {card} | stage_rebuild_ms (upload + operands) over "
          f"{int(reb['count'])} build(s): mean {reb.get('mean_ms', 0):.1f} "
          f"ms (log2-bucket p50 {reb.get('p50_ms', 0):.1f} ms)", flush=True)


#: the broker's default queued-publish expiry (watchdog_collector_expiry_
#: budgets x overload_dispatch_budget_ms), which the first match of a fresh
#: process must fit
EXPIRY_MS = 4 * 50.0


def release(card: str, when: str) -> None:
    """Collect this process's garbage (a stopped broker's heap and its
    device tables are reference cycles) and hand its cached device memory
    back to CUDA, then print what the card has free."""
    import gc

    import torch

    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    print(f"[memory] {card} | {when}: this process holds "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB of tensors "
          f"({torch.cuda.memory_reserved() / 2**30:.2f} GiB reserved); the "
          f"card has {free / 2**30:.2f} of {total / 2**30:.2f} GiB free",
          flush=True)


class HeapWatch:
    """CPython's collections during a counted load, timed through
    ``gc.callbacks``. The broker freezes the heap its bulk load leaves by
    its own policy (``vernemq_tpu_torch/broker/heap.py``: after a GPU
    matcher's first build, a rebuild swapped in or a cluster join's
    metadata exchange, one timed full collection and ``gc.freeze``; never
    on a delta): a full collection over a broker
    process holding a million subscriptions holds the interpreter lock
    longer than the queued-publish expiry, and the publishes queued across
    it are answered by the trie. This only reads what the policy did
    (``policy``: the process's ``broker.heap.POLICY``) and times every full and
    young collection during the load; it freezes nothing. :meth:`check`
    fails the phase if the policy never froze the loaded heap."""

    def __init__(self, policy, label: str) -> None:
        import gc

        self.policy = policy
        self.label = label
        # the policy's own count: gc.get_freeze_count() walks the frozen
        # heap with the interpreter lock held (CPython 3.12)
        st = policy.status()
        self.frozen = st["frozen_objects"]
        self.refreezes0 = st["refreezes"]
        self.pauses = {0: [], 1: [], 2: []}
        self._t0 = 0.0
        self._open = True
        gc.callbacks.append(self._timed)

    def _timed(self, phase: str, info: dict) -> None:
        if phase == "start":
            self._t0 = time.perf_counter()
        else:
            self.pauses[info["generation"]].append(
                (time.perf_counter() - self._t0) * 1e3)

    def check(self) -> None:
        st = self.policy.status()
        if not st["refreezes"] or not self.frozen:
            fail(f"{self.label}: the broker's heap policy froze nothing "
                 f"after the bulk load ({st})")

    def summary(self) -> str:
        st = self.policy.status()
        young = sorted(self.pauses[0] + self.pauses[1])
        p99 = young[int(0.99 * (len(young) - 1))] if young else 0.0
        return (f"the broker's heap policy froze {self.frozen} objects "
                f"({st['refreezes']} re-freeze(s), the last after "
                f"{st['last_reason']}: its full collection took "
                f"{st['last_pause_ms']:.1f} ms, the longest "
                f"{st['max_pause_ms']:.1f} ms, against the {EXPIRY_MS:.0f} "
                f"ms expiry); during the load "
                f"{st['refreezes'] - self.refreezes0} re-freezes, "
                f"{len(self.pauses[2])} full "
                f"collections (longest "
                f"{max(self.pauses[2], default=0.0):.2f} ms) and "
                f"{len(young)} young ones (longest "
                f"{max(young, default=0.0):.2f} ms, p99 {p99:.2f} ms, "
                f"{sum(x > 50 for x in young)} past 50 ms, "
                f"{sum(young):.0f} ms in all)")

    def close(self) -> str:
        import gc

        if self._open:
            self._open = False
            gc.callbacks.remove(self._timed)
        return self.summary()


class StackSampler:
    """A sampling profile of this process's threads during a counted load:
    a daemon thread reads every other thread's Python stack
    (``sys._current_frames``) every ``period`` seconds. A sample whose
    innermost frame waits (``select``, a condition, a pipe) counts as
    idle; of the busy ones it counts, per thread, each function on the
    stack once (inclusive) and the innermost ``depth`` frames (leaf
    stacks). A thread that waits for the interpreter lock is busy where
    it waits. :meth:`stop` ends it and returns the counts."""

    IDLE = frozenset(("select", "wait", "_recv", "_wait_for_tstate_lock",
                      "accept", "poll", "_poll"))

    def __init__(self, period: float = 0.005, depth: int = 5) -> None:
        import collections
        import threading

        self.period, self.depth = period, depth
        self.samples = collections.Counter()
        self.busy = collections.Counter()
        self.inclusive = collections.Counter()
        self.leaves = collections.Counter()
        self.max_gap_ms, self.max_gap_at = 0.0, 0.0
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="stack-sampler")
        self._thread.start()

    def _run(self) -> None:
        import threading

        me = threading.get_ident()
        last = time.perf_counter()
        while not self._stop.wait(self.period):
            # a wake far past the period: the interpreter lock was held
            # (a C call such as a collection) or the process descheduled
            now = time.perf_counter()
            gap = (now - last - self.period) * 1e3
            last = now
            if gap > self.max_gap_ms:
                self.max_gap_ms, self.max_gap_at = gap, now
            names = {t.ident: t.name.split("_")[0]
                     for t in threading.enumerate()}
            for ident, f in sys._current_frames().items():
                if ident == me:
                    continue
                name = names.get(ident, "?")
                self.samples[name] += 1
                if f.f_code.co_name in self.IDLE:
                    continue
                self.busy[name] += 1
                stack, seen = [], set()
                while f is not None:
                    code = f.f_code
                    where = (f"{os.path.basename(code.co_filename)}:"
                             f"{code.co_qualname}")
                    if len(stack) < self.depth:
                        stack.append(f"{where}:{f.f_lineno}")
                    if where not in seen:
                        seen.add(where)
                        self.inclusive[(name, where)] += 1
                    f = f.f_back
                self.leaves[(name, " < ".join(stack))] += 1

    def stop(self, top: int = 16) -> dict:
        self._stop.set()
        self._thread.join(5)
        n = self.busy["MainThread"]
        return dict(
            samples={t: (self.busy[t], c) for t, c in self.samples.items()},
            main=[(w, c) for (t, w), c in self.inclusive.most_common()
                  if t == "MainThread" and c < n][:top],
            leaves=[(t, s, c) for (t, s), c in self.leaves.most_common()
                    if t == "MainThread"][:top // 2]
            + [(t, s, c) for (t, s), c in self.leaves.most_common()
               if t != "MainThread"][:top // 4])


def stack_profile(name: str, prof: dict) -> str:
    """A node's :class:`StackSampler` counts as printed lines."""
    n = prof["samples"].get("MainThread", (0, 0))[0] or 1
    main = "; ".join(f"{w} {c / n:.1%}" for w, c in prof["main"])
    leaves = "\n    ".join(f"{c} {t}: {s}" for t, s, c in prof["leaves"])
    return (f"node {name} stack samples (busy, all) per thread "
            f"{prof['samples']}; of the event loop thread's busy samples, "
            f"inclusive: {main}\n  busy leaf stacks (samples, thread: "
            f"innermost first):\n    {leaves}")


class StepWatch:
    """One step of a serving phase, watched from the event loop it runs
    on: CPython's collections (:class:`HeapWatch`), the loop's lags past a
    5 ms sleep, a :class:`StackSampler`, and the heap policy's and the
    matcher's log records (a re-freeze or its skip, a publish expired to
    the trie), each at its offset into the step. :meth:`stop` returns one
    line; :meth:`detail` the longest lags, the log records and the stack
    sample."""

    def __init__(self, policy) -> None:
        import asyncio
        import logging

        self.t0 = time.perf_counter()
        self.heap = HeapWatch(policy, "step")
        self.sampler = StackSampler()
        self.lags: list = []
        self.records: list = []
        watch = self

        class Keep(logging.Handler):
            def emit(self, rec):
                watch.records.append((watch.at(), rec.name.rsplit(".")[-1],
                                      rec.getMessage()[:160]))

        self.handler = Keep(logging.DEBUG)
        self.loggers = [logging.getLogger(n) for n in (
            "vernemq_tpu_torch.heap", "vernemq_tpu_torch.matcher")]
        self.levels = [lg.level for lg in self.loggers]
        for lg in self.loggers:
            lg.addHandler(self.handler)
            lg.setLevel(logging.DEBUG)
        self.task = asyncio.get_running_loop().create_task(self._lags())
        self.line = ""

    def at(self) -> float:
        return round((time.perf_counter() - self.t0) * 1e3, 1)

    async def _lags(self) -> None:
        import asyncio

        while True:
            t = time.perf_counter()
            await asyncio.sleep(0.005)
            lag = (time.perf_counter() - t - 0.005) * 1e3
            if lag > 20:
                self.lags.append((self.at(), round(lag, 1)))

    def stop(self, note: str = "") -> str:
        if self.line:
            return self.line
        self.task.cancel()
        for lg, lv in zip(self.loggers, self.levels):
            lg.removeHandler(self.handler)
            lg.setLevel(lv)
        self.prof = self.sampler.stop()
        gap = (self.sampler.max_gap_ms,
               round((self.sampler.max_gap_at - self.t0) * 1e3, 1))
        st = self.heap.policy.status()
        self.line = (
            f"{self.at():.0f} ms; {note}; heap policy {st}; event-loop lags "
            f"past 20 ms {len(self.lags)}, the longest "
            f"{max((x for _, x in self.lags), default=0.0):.1f} ms; the "
            f"sampler's longest wake gap {gap[0]:.1f} ms at {gap[1]} ms; "
            f"{self.heap.close()}")
        return self.line

    def detail(self) -> str:
        top = sorted(self.lags, key=lambda x: -x[1])[:8]
        return (f"  lags (ms into the step, ms): {top}\n  log records: "
                f"{self.records[:12]}\n  " + stack_profile("(this process)",
                                                    self.prof))


def time_cluster_batches(b, out: dict) -> None:
    """Time every inbound ``vmq-send`` batch of a node's cluster channel
    (``ClusterCom._process``): its wall and sub-frames go to
    ``out["batches"]``, and each sub-frame's ``_dispatch`` to
    ``out["kinds"]`` (count, ms in all, longest ms per frame kind)."""
    import asyncio

    from vernemq_tpu_torch.cluster import com as CC

    com = b.cluster._com
    process, dispatch = com._process, com._dispatch

    def done(t0: float, blob: bytes) -> None:
        out["batches"].append(((time.perf_counter() - t0) * 1e3,
                               CC._count_subframes(blob)))

    if asyncio.iscoroutinefunction(process):
        async def timed(origin, blob):
            t0 = time.perf_counter()
            try:
                await process(origin, blob)
            finally:
                done(t0, blob)
    else:
        def timed(origin, blob):
            t0 = time.perf_counter()
            try:
                process(origin, blob)
            finally:
                done(t0, blob)

    def timed_dispatch(origin, cmd, term):
        t0 = time.perf_counter()
        try:
            dispatch(origin, cmd, term)
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            n, tot, top = out["kinds"].get(cmd, (0, 0.0, 0.0))
            out["kinds"][cmd] = (n + 1, tot + ms, max(top, ms))

    com._process, com._dispatch = timed, timed_dispatch


def batch_summary(out: dict) -> str:
    """:func:`time_cluster_batches`' record of one load as a line."""
    import numpy as np

    ms = np.array([w for w, _ in out["batches"]] or [0.0])
    frames = np.array([n for _, n in out["batches"]] or [0])
    kinds = {k.decode(): (n, round(tot, 1), round(top, 2))
             for k, (n, tot, top) in sorted(out["kinds"].items())}
    return (f"{len(out['batches'])} inbound vmq-send batches: wall max "
            f"{ms.max():.2f} ms p99 {np.percentile(ms, 99):.2f} ms, "
            f"{ms.sum():.0f} ms in all; sub-frames a batch max "
            f"{frames.max()} p99 {np.percentile(frames, 99):.0f}, "
            f"{frames.sum()} in all; per kind (frames, ms in all, longest "
            f"ms) {kinds}")


def cold_start_child(conn) -> None:
    """The first device matches of a fresh process: a matcher over
    DRILL_SUBS subscriptions, its first build (with the warm dispatch
    apart), then two ``match_batch`` calls of a broker-sized flush. Sends
    the times (ms) back over ``conn``."""
    import torch

    from vernemq_tpu_torch.models.matcher import GpuMatcher

    m = GpuMatcher(max_levels=8, initial_capacity=DRILL_CAP, device=DEVICE)
    rng = random.Random(SEED + 5)
    pools = build_corpus(rng, DRILL_SUBS,
                         lambda f, key: m.table.add(f, key, None))
    torch.zeros(1, device=DEVICE)  # the context, outside the timings
    t0 = time.perf_counter()
    with m.lock:
        m.sync()
    build_ms = (time.perf_counter() - t0) * 1e3
    first = []
    for _ in range(2):
        t1 = time.perf_counter()
        m.match_batch(zipf_topics(rng, pools, 21))
        first.append((time.perf_counter() - t1) * 1e3)
    conn.send((build_ms, m.warm_ms, first))
    conn.close()


def phase_cold(card: str) -> None:
    """Run :func:`cold_start_child` in a spawned process and check that
    the first match after the build fits the broker's expiry: the warm
    dispatch, not the first flush, pays CUDA's module loading."""
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=cold_start_child, args=(child,), daemon=True)
    proc.start()
    child.close()
    try:
        if not conn.poll(300):
            fail("cold start: the fresh process did not answer in time")
        build_ms, warm_ms, first = conn.recv()
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
    print(f"[cold] {card} | a fresh process, {DRILL_SUBS} subscriptions: "
          f"first build {build_ms:.1f} ms, of it the warm dispatch "
          f"{warm_ms:.1f} ms; then match_batch of 21 publishes "
          f"{first[0]:.1f} ms and {first[1]:.1f} ms", flush=True)
    if first[0] > EXPIRY_MS:
        fail(f"cold start: the first match of a fresh process took "
             f"{first[0]:.1f} ms, past the broker's {EXPIRY_MS:.0f} ms "
             f"queued-publish expiry")


def broker_config():
    """The broker phase's configuration: the GPU view with a table
    capacity that holds the headline corpus without a growth rebuild,
    every flush on the device (no hybrid host dispatch of
    small flushes), no $SYS publisher and no loop-lag sampler (the corpus
    load holds the loop for tens of seconds on purpose, which no live
    broker does), and the admin HTTP API on an ephemeral port with its
    API-key check on. The queued-publish expiry and the dispatch deadline
    are the broker's own defaults: a publish they send to the trie fails
    the phase."""
    from vernemq_tpu_torch.broker.config import Config

    return Config(allow_anonymous=True, default_reg_view="tpu",
                  systree_enabled=False, sysmon_enabled=False,
                  tpu_initial_capacity=1 << (N_SUBS - 1).bit_length(),
                  tpu_host_batch_threshold=0, http_enabled=True,
                  http_host="127.0.0.1", http_port=0)


def admin_poller(http_port: int, api_key: str, stop, out: list) -> None:
    """Poll a broker's admin HTTP API every ADMIN_POLL_S until ``stop`` is
    set, through the port's ``admin/cli.py`` (``run_remote``): the
    ADMIN_POLL commands, then a ``/metrics`` scrape. Appends (what,
    latency ms, ok) per request to ``out``, and each ``metrics show``
    table as ("metrics", rows, True)."""
    import urllib.request

    from vernemq_tpu_torch.admin.cli import run_remote

    base = f"http://127.0.0.1:{http_port}"
    while not stop.is_set():
        t_round = time.monotonic()
        for words in ADMIN_POLL:
            t = time.monotonic()
            res = run_remote(base, api_key, list(words), timeout=30)
            ok = res.get("type") == "table" and "error" not in res
            out.append((" ".join(words), (time.monotonic() - t) * 1e3, ok))
            if ok and words == ("metrics", "show"):
                out.append(("metrics", res["table"], True))
        t = time.monotonic()
        try:
            with urllib.request.urlopen(base + "/metrics", timeout=30) as r:
                ok = r.status == 200 and b"tpu_match_publishes" in r.read()
        except OSError:
            ok = False
        out.append(("/metrics", (time.monotonic() - t) * 1e3, ok))
        stop.wait(max(0.0, ADMIN_POLL_S - (time.monotonic() - t_round)))


async def mqtt_connect(cid: str, v5: bool, port: int):
    """A connected port MQTT client (v5 or v3.1.1, no keepalive)."""
    from vernemq_tpu_torch.client import MQTTClient

    c = MQTTClient("127.0.0.1", port, client_id=cid, keepalive=0,
                   proto_ver=5 if v5 else 4)
    await c.connect(timeout=60)
    return c


async def live_traffic(subs, publishers, pubs, expect, admin=None):
    """The counted load of the broker phases over connected clients: send
    each publisher's ``pubs[k]`` ((seq, topic, qos)) with a send timestamp
    in the payload — awaiting the PUBACK of every QoS 1 publish, as a
    client with one message in flight does — until every subscriber has
    its ``expect[j]`` deliveries, then take whatever more arrives within
    half a second. Returns per subscriber the (publisher, seq, QoS,
    latency ms) of every delivery in arrival order, the QoS 1 PUBACK
    latencies, the wall from the first send to the last delivery, and the
    admin poll's records: with ``admin`` ((HTTP port, API key)) a thread
    polls that broker's admin API (:func:`admin_poller`) from the first
    send to the last delivery."""
    import asyncio
    import struct
    import threading

    loop = asyncio.get_running_loop()
    got = [[] for _ in subs]
    last = [0.0]
    acks = []
    polls, stop = [], threading.Event()

    def take(j, m):
        pub, seq, t = struct.unpack("<IId", m.payload)
        now = time.monotonic()
        got[j].append((pub, seq, m.qos, (now - t) * 1e3))
        last[0] = max(last[0], now)

    async def receive(j, c):
        while len(got[j]) < expect[j]:
            m = await c.messages.get()
            if m is None:
                return
            take(j, m)

    async def publish(k, c):
        for seq, topic, qos in pubs[k]:
            t = time.monotonic()
            payload = struct.pack("<IId", k, seq, t)
            if qos:
                await c.publish(topic, payload, qos=1, timeout=120)
                acks.append((time.monotonic() - t) * 1e3)
            else:
                await c.publish(topic, payload)

    poller = None
    if admin is not None:
        poller = threading.Thread(target=admin_poller,
                                  args=(*admin, stop, polls), daemon=True)
        poller.start()
    readers = [loop.create_task(receive(j, c)) for j, c in enumerate(subs)]
    t0 = time.monotonic()
    await asyncio.gather(*(publish(k, c) for k, c in enumerate(publishers)))
    _, late = await asyncio.wait(readers, timeout=BROKER_WAIT_S)
    for r in late:
        r.cancel()
    stop.set()
    await asyncio.sleep(0.5)  # any delivery past the expected ones
    for j, c in enumerate(subs):
        while not c.messages.empty():
            m = c.messages.get_nowait()
            if m is not None:
                take(j, m)
    if poller is not None:
        await loop.run_in_executor(None, poller.join)
    return got, acks, last[0] - t0, polls


def broker_clients(port: int, live, pubs, expect, conn, admin=None) -> None:
    """The MQTT clients of the broker phases, in a process of their own:
    connect and subscribe the live subscribers (``live``: (filters, v5))
    and connect the publishers on ``port``, say ``"ready"`` over ``conn``
    and wait for a word back, then run :func:`live_traffic` (with the
    ``admin`` poller) and send its result back over ``conn``."""
    import asyncio

    async def run():
        subs = []
        for j, (filters, v5) in enumerate(live):
            c = await mqtt_connect(f"live{j}", v5, port)
            await c.subscribe(filters, qos=1 if v5 else 0, timeout=60)
            subs.append(c)
        publishers = [await mqtt_connect(f"pub{k}", k % 2 == 0, port)
                      for k in range(len(pubs))]
        conn.send("ready")
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        result = await live_traffic(subs, publishers, pubs, expect, admin)
        for c in subs + publishers:
            await c.disconnect()
        return result

    conn.send(asyncio.run(run()))
    conn.close()


def cluster_clients(live, pubs, expect, conn, sub_ports, pub_ports,
                    probe_port: int) -> None:
    """The MQTT clients of the cluster phase, in a process of their own:
    subscriber ``j`` on ``sub_ports[j]`` and publisher ``k`` on
    ``pub_ports[k]``, and a marker subscriber on ``probe_port``; after
    ``"ready"`` and a word back, :func:`live_traffic`, whose result goes
    back over ``conn``. Then the clients stay connected and serve
    commands over ``conn`` until ``"done"``: ``("unsub", js)`` / ``("sub",
    js)`` unsubscribe / resubscribe the filters of subscribers ``js`` and
    answer the monotonic time of the last acknowledgement; ``("probe",
    [(k, topic)], expect)`` sends each topic from publisher ``k`` at QoS
    1, then a marker from each of those publishers to the marker
    subscriber, and answers, once the markers are in and the subscribers
    of ``expect`` ({j: n}) hold their n deliveries, with every
    subscriber's probe deliveries {j: [topic]} after half a second
    more."""
    import asyncio

    async def probe(subs, publishers, marker, sends, want):
        seen = {j: [] for j in range(len(subs))}
        for k, topic in sends:
            await publishers[k].publish(topic, b"probe", qos=1, timeout=120)
        ks = sorted({k for k, _ in sends})
        for k in ks:
            await publishers[k].publish(f"$probe/{k}", b"m", qos=1,
                                        timeout=120)
        marks = set()
        while len(marks) < len(ks):
            m = await asyncio.wait_for(marker.messages.get(), 120)
            marks.add(m.topic)

        def drain():
            for j, c in enumerate(subs):
                while not c.messages.empty():
                    m = c.messages.get_nowait()
                    if m is not None:
                        seen[j].append(m.topic)

        deadline = time.monotonic() + 60
        while True:
            drain()
            if all(len(seen[j]) >= n for j, n in want.items()) \
                    or time.monotonic() > deadline:
                break
            await asyncio.sleep(0.05)
        await asyncio.sleep(0.5)
        drain()
        return seen

    async def run():
        subs = []
        for j, (filters, v5) in enumerate(live):
            c = await mqtt_connect(f"live{j}", v5, sub_ports[j])
            await c.subscribe(filters, qos=1 if v5 else 0, timeout=60)
            subs.append(c)
        publishers = [await mqtt_connect(f"pub{k}", k % 2 == 0, pub_ports[k])
                      for k in range(len(pubs))]
        marker = await mqtt_connect("probe-marker", True, probe_port)
        await marker.subscribe("$probe/#", qos=1, timeout=60)
        conn.send("ready")
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, conn.recv)
        conn.send(await live_traffic(subs, publishers, pubs, expect))
        while True:
            cmd = await loop.run_in_executor(None, conn.recv)
            if cmd == "done":
                break
            if cmd[0] in ("unsub", "sub"):
                for j in cmd[1]:
                    filters, v5 = live[j]
                    if cmd[0] == "unsub":
                        await subs[j].unsubscribe(filters, timeout=60)
                    else:
                        await subs[j].subscribe(
                            filters, qos=1 if v5 else 0, timeout=60)
                conn.send(time.monotonic())  # the last (UN)SUBACK
            else:
                _, sends, want = cmd
                conn.send(await probe(subs, publishers, marker, sends, want))
        for c in subs + publishers + [marker]:
            await c.disconnect()

    asyncio.run(run())
    conn.close()


def live_load(rng: random.Random, pools, label: str, n_live=None,
              n_pubs=None, n_publishers=None):
    """The live client load of the broker phases: ``n_live`` subscribers
    (v3.1.1 and v5 alternating) of 4 filters from the hot end of the pools,
    ``n_pubs`` zipf publishes (a BROKER_QOS1 share at QoS 1) split over
    ``n_publishers`` publishers, and each subscriber's stop count; by
    default BROKER_LIVE, BROKER_PUBS and BROKER_PUBLISHERS."""
    from vernemq_tpu_torch.models.trie import SubscriptionTrie

    n_live = n_live or BROKER_LIVE
    n_pubs = n_pubs or BROKER_PUBS
    n_publishers = n_publishers or BROKER_PUBLISHERS
    l0, l1, l2 = pools
    live = []
    for j in range(n_live):
        w = lambda pool: pool[rng.randrange(BROKER_HOT)]  # noqa: E731
        live.append(([f"{w(l0)}/{w(l1)}/{w(l2)}",
                      f"{w(l0)}/+/{w(l2)}", f"+/{w(l1)}/{w(l2)}",
                      f"{w(l0)}/{w(l1)}/#"], j % 2 == 0))
    topics = ["/".join(t) for t in zipf_topics(rng, pools, n_pubs)]
    qos = [int(rng.random() < BROKER_QOS1) for _ in topics]
    pubs = [[(i, topics[i], qos[i]) for i in range(k, n_pubs, n_publishers)]
            for k in range(n_publishers)]
    local = SubscriptionTrie()  # the stop condition of the clients
    for j, (filters, _) in enumerate(live):
        for f in filters:
            local.add(f.split("/"), j, None)
    expect = [0] * n_live
    for t in topics:
        for _f, j, _v in local.match(t.split("/")):
            expect[j] += 1
    if not all(expect):
        fail(f"{label}: a live subscriber would receive nothing: {expect}")
    return live, topics, qos, pubs, expect


def check_live(got, want, label: str) -> int:
    """Each live subscriber's deliveries, as a multiset of (publisher,
    seq), equal ``want`` (one per matching filter), in publish order per
    publisher at each QoS; returns the order inversions across QoS levels,
    which MQTT does not order."""
    import collections

    inversions = 0
    for j in range(len(want)):
        have = collections.Counter((p, q) for p, q, _, _ in got[j])
        if have != want[j]:
            fail(f"{label}: live{j} got {sum(have.values())} deliveries "
                 f"({len(have - want[j])} unexpected), the trie gives "
                 f"{sum(want[j].values())} ({len(want[j] - have)} missing)")
        last, last_any = {}, {}
        for p, q, qos_, _ in got[j]:
            if q < last.get((p, qos_), -1):
                fail(f"{label}: live{j} received publisher {p}'s seq {q} "
                     f"at QoS {qos_} after {last[(p, qos_)]}")
            last[(p, qos_)] = q
            inversions += q < last_any.get(p, -1)
            last_any[p] = max(q, last_any.get(p, -1))
    return inversions


def live_numbers(got, acks, wall: float) -> dict:
    """Publishes/s over the traffic's wall and PUBLISH->delivery and
    PUBACK percentiles (ms)."""
    import numpy as np

    lat = np.array([x for g in got for _, _, _, x in g])
    return dict(pubs_per_s=BROKER_PUBS / wall, wall_s=wall,
                deliveries=len(lat),
                lat_p50=float(np.percentile(lat, 50)),
                lat_p99=float(np.percentile(lat, 99)),
                ack_p50=float(np.percentile(acks, 50)),
                ack_p99=float(np.percentile(acks, 99)))


def phase_broker(card: str, path_S: int) -> dict:
    """The port's broker end to end on the card: the headline corpus
    registered through ``Registry.subscribe`` under subscriber ids with no
    session (after the GPU view's matcher exists, so the table fills in
    subscription order), live MQTT subscribers and publishers over TCP in
    a second process, exact delivery parity against the registry's trie
    and per-publisher order; every host-served counter 0. Returns the
    tile launches of the traffic, publishes/s, latencies and the load
    time."""
    import asyncio
    import collections
    import multiprocessing

    import numpy as np

    from vernemq_tpu_torch.admin.commands import (CommandRegistry,
                                                  register_core_commands)
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.models.trie import SubscriptionTrie
    from vernemq_tpu_torch.observability import histogram as hist
    from vernemq_tpu_torch.observability.profiler import profiler
    from vernemq_tpu_torch.protocol import fastpath
    from vernemq_tpu_torch.protocol.types import SubOpts

    async def run():
        b, server = await start_broker(broker_config(), port=0,
                                       device=DEVICE)
        try:
            return await drive(b, server.port)
        finally:
            await b.stop()
            await server.stop()

    async def drive(b, port):
        reg = b.registry
        view = reg.reg_view("tpu")
        m = view.matcher("")  # empty: the load below fills it in order
        t0 = time.perf_counter()
        opts = SubOpts(qos=0)
        batch = []

        def add(f, i):
            batch.append((f, opts))
            if len(batch) == BROKER_PER_ID:
                reg.subscribe(("", f"bulk{i // BROKER_PER_ID}"), batch)
                batch.clear()

        pools = build_corpus(random.Random(SEED), N_SUBS, add)
        if batch:
            reg.subscribe(("", "bulk-tail"), batch)
        t_load = time.perf_counter() - t0
        settle_sync(m)  # the first build
        S, rows = int(m.table.cap), m.table.count
        print(f"[broker] {card} | {N_SUBS} subscriptions registered "
              f"through Registry.subscribe under "
              f"{-(-N_SUBS // BROKER_PER_ID)} subscriber ids in "
              f"{t_load:.1f}s; table rows {rows} (a filter repeated under "
              f"one id is one subscription), S={S} (path phase S="
              f"{path_S}), device table built in "
              f"{time.perf_counter() - t0 - t_load:.1f}s (warm dispatch "
              f"{m.warm_ms:.1f} ms)", flush=True)
        if S >= 1.5 * path_S:
            fail(f"broker: table S {S} against the path phase's {path_S}: "
                 f"the load order doubled the table")
        rng = random.Random(SEED + 4)
        live, topics, qos, pubs, expect = live_load(rng, pools, "broker")
        # [admin]: an API key for the management API, and one metrics
        # scrape at this size timed in-process
        api_key = register_core_commands(CommandRegistry()).run(
            b, ["api-key", "create"])["table"][0]["key"]
        t1 = time.perf_counter()
        n_metrics = len(b.metrics.all_metrics())
        scrape_ms = (time.perf_counter() - t1) * 1e3
        # what each scrape cost while the trie's stats walked every node
        # (the reference's SubscriptionTrie.stats): one such walk, timed
        t1 = time.perf_counter()
        stack, nodes = [reg.trie("")._root], 0
        while stack:
            nd = stack.pop()
            nodes += 1
            stack.extend(nd.children.values())
        walk_ms = (time.perf_counter() - t1) * 1e3
        if nodes != reg.trie("").stats()["nodes"]:
            fail(f"admin: the trie's kept node count "
                 f"{reg.trie('').stats()['nodes']} against a walk's {nodes}")
        heap = HeapWatch(b.heap, "broker")
        heap.check()
        ctx = multiprocessing.get_context("spawn")
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=broker_clients,
                           args=(port, live, pubs, expect, child,
                                 (b.http.port, api_key)),
                           daemon=True)
        proc.start()
        child.close()
        loop = asyncio.get_running_loop()

        async def recv():
            if not await loop.run_in_executor(None, conn.poll,
                                              BROKER_WAIT_S + 120):
                fail("broker: the clients did not answer in time")
            return await loop.run_in_executor(None, conn.recv)

        try:
            await recv()  # every live subscription is in place
            # parity: each live subscriber's deliveries, as a multiset of
            # (publisher, seq), equal the rows the registry's trie gives
            # for its subscriptions (one per matching filter), in publish
            # order per publisher
            sids = {("", f"live{j}"): j for j in range(BROKER_LIVE)}
            trie = reg.trie("")
            want = [collections.Counter() for _ in live]
            for i, t in enumerate(topics):
                for _f, key, _o in trie.match(t.split("/")):
                    j = sids.get(key)
                    if j is not None:
                        want[j][(i % BROKER_PUBLISHERS, i)] += 1
            if [sum(w.values()) for w in want] != expect:
                fail("broker: the clients' stop counts disagree with the "
                     "registry's trie")
            col = b.batch_collector()
            hist.reset_all()
            profiler().reset()
            reset_counts()
            conn.send("go")
            got, acks, wall, polls = await recv()
            launches, ex_launches, dense = forward_counts("broker")
        finally:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        inversions = check_live(got, want, "broker")
        hs = host_served(col, m)
        if any(hs.values()):
            fail(f"broker: publishes served by the host: {hs}")
        if launches <= 0:
            fail("broker: the tile kernel was never launched")
        live_ids = set(sids) | {("", f"pub{k}")
                                for k in range(BROKER_PUBLISHERS)}
        stray = [sid for sid, q in reg.queues.items()
                 if sid not in live_ids or q.offline]
        drops = b.metrics.value("queue_message_drop")
        if stray or drops:
            fail(f"broker: queues outside the live clients or with offline "
                 f"messages {stray[:5]}, queue drops {drops}")
        lat = np.array([x for g in got for _, _, _, x in g])
        n_del = len(lat)
        wait_snap = hist.get("stage_collector_wait_ms").snapshot()
        wait = hist.summary(wait_snap)
        top = max(i for i, c in enumerate(wait_snap[0]) if c)
        wait_max = (hist.BUCKET_BOUNDS_MS[top]
                    if top < len(hist.BUCKET_BOUNDS_MS) else float("inf"))
        eng = b.filter_engine
        res = live_numbers(got, acks, wall)
        res.update(launches=launches, extract_launches=ex_launches,
                   dense_launches=dense, load_s=t_load)
        print(f"[broker] {card} | {BROKER_PUBS} publishes "
              f"({sum(qos)} at QoS 1) from {BROKER_PUBLISHERS} MQTT "
              f"publishers to {BROKER_LIVE} MQTT subscribers (v3.1.1 and "
              f"v5) over TCP: {res['pubs_per_s']:.0f} publishes/s from the "
              f"first send to the last delivery ({wall:.2f}s), {n_del} "
              f"deliveries", flush=True)
        print(f"[broker] {card} | PUBLISH->delivery p50 "
              f"{res['lat_p50']:.2f} ms p99 {res['lat_p99']:.2f} ms; QoS 1 "
              f"PUBACK p50 {res['ack_p50']:.2f} ms p99 "
              f"{res['ack_p99']:.2f} ms", flush=True)
        print(f"[broker] {card} | {int(wait['count'])} collector flushes "
              f"({col.super_batches} super-batches carrying "
              f"{col.super_batch_pubs} publishes), {m.match_batches} device "
              f"batches for {m.match_publishes} publishes; host-served "
              f"counters {hs}; tile / dense-mode / extraction launches "
              f"{launches} / {dense} / {ex_launches}, plain bit-packs on "
              f"the card 0; native wire codec "
              f"{'loaded' if fastpath.load_native() is not None else 'not loaded (pure-Python codec)'}; "
              f"predicate phase device dispatches {eng.dispatches} (no "
              f"predicated subscription in this load); parity exact for "
              f"every live subscriber, "
              f"per-publisher order kept at each QoS ({inversions} "
              f"inversions across QoS levels), no offline queue, no drop",
              flush=True)
        disp = np.array([r["dur_ms"] for r in profiler().snapshot(
            kind="match")])
        # the device's share, estimated: one flush of the mean size
        # dispatched alone (uploads, device path, download; CUDA events),
        # times the flushes, over the wall
        n_mean = max(1, round(m.match_publishes / max(m.match_batches, 1)))
        with m.lock:
            m.sync()
            layout = m._layout_locked()
            enc = m._encode_batch_ex(zipf_topics(rng, pools, n_mean))
        args, statics, _ = m._flat_prep(
            layout, int(m._operands[0].shape[1]), *enc, n_mean)
        flush_ms = event_ms(lambda: m._dispatch_flat(
            m._dev_arrays, m._operands, args, statics), 20)
        print(f"[broker] {card} | where the time goes: "
              f"{m.match_publishes / max(m.match_batches, 1):.1f} publishes "
              f"per flush; queue wait at flush start p50 "
              f"{wait.get('p50_ms', 0):.1f} ms p99 "
              f"{wait.get('p99_ms', 0):.1f} ms max <= {wait_max:.1f} ms "
              f"(log2 buckets; the expiry is {EXPIRY_MS:.0f} ms); dispatch "
              f"without the row resolve (encode, prep, device, download) "
              f"p50 {np.percentile(disp, 50):.2f} ms p99 "
              f"{np.percentile(disp, 99):.2f} ms mean {disp.mean():.2f} ms "
              f"over {len(disp)}; one {n_mean}-publish flush dispatched "
              f"alone {flush_ms:.2f} ms of stream time (CUDA events), so "
              f"the device was busy at most ~"
              f"{100 * flush_ms * m.match_batches / 1e3 / wall:.0f}% of "
              f"the traffic's wall (estimate); {heap.summary()}",
              flush=True)
        res["admin"] = await phase_admin(card, b, m, col, port, api_key,
                                         polls, live, pools, rng,
                                         (scrape_ms, n_metrics, walk_ms,
                                          nodes))
        res["plugins"] = await phase_plugins(card, b, m, port, api_key,
                                             pools, rng)
        heap.close()
        return res

    return asyncio.run(run())


def plugin_clients(port: int, live, pubs, expect, conn) -> None:
    """The MQTT clients of the plugins phase, in a process of their own:
    the live subscribers and publishers connect to ``port`` with the
    phase's credentials; after ``"ready"`` and a word back,
    :func:`live_traffic`, whose result goes back over ``conn``. Then they
    serve commands until ``"done"``: ``("connect", cid, user, password)``
    answers a v3.1.1 CONNACK's code; ``("subscribe", j, filters)`` the
    SUBACK's codes of live subscriber ``j``; ``("send", port, k, [(topic,
    qos)], want)`` publishes each topic from publisher ``k`` (``port`` 0)
    or from a client of the broker at ``port``, with payload ``b"<tag>
    <i>"``, and answers every live subscriber's deliveries
    {j: [(topic, payload)]} once the subscribers of ``want`` ({j: n}) hold
    n each and half a second more; ``("sink",)`` starts a webhook endpoint
    that answers ``auth_on_publish`` with the topic less its first word
    and answers its URL, ``("calls",)`` the endpoint's calls so far;
    ``("watch", port, filter)`` subscribes a client of the broker at
    ``port``, ``("watched", n)`` answers its first ``n`` deliveries."""
    import asyncio
    import json as _json

    from vernemq_tpu_torch.client import MQTTClient

    sub_user, pub_user = list(PLUGIN_USERS)
    calls = [0]

    async def sink_handle(reader, writer):
        try:
            while True:
                if not await reader.readline():
                    return
                length = 0
                while True:
                    h = await reader.readline()
                    if h in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = h.decode().partition(":")
                    if k.strip().lower() == "content-length":
                        length = int(v)
                body = _json.loads(await reader.readexactly(length))
                calls[0] += 1
                resp = _json.dumps({"result": "ok", "modifiers": {
                    "topic": body["topic"].split("/", 1)[1]}}).encode()
                writer.write(b"HTTP/1.1 200 OK\r\nContent-Length: %d\r\n"
                             b"\r\n%s" % (len(resp), resp))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionError):
            pass

    async def connect(cid, v5, user, port_=port):
        c = MQTTClient("127.0.0.1", port_, client_id=cid, keepalive=0,
                       proto_ver=5 if v5 else 4, username=user,
                       password=(PLUGIN_USERS[user].encode()
                                 if user else None))
        ack = await c.connect(timeout=60)
        if ack.rc:
            fail(f"plugins: {cid} refused at CONNACK ({ack.rc})")
        return c

    async def run():
        subs = []
        for j, (filters, v5) in enumerate(live):
            c = await connect(f"plug-sub{j}", v5, sub_user)
            await c.subscribe(filters, qos=1 if v5 else 0, timeout=60)
            subs.append(c)
        publishers = [await connect(f"plug-pub{k}", k % 2 == 0, pub_user)
                      for k in range(len(pubs))]
        conn.send("ready")
        loop = asyncio.get_running_loop()
        await loop.run_in_executor(None, conn.recv)
        conn.send(await live_traffic(subs, publishers, pubs, expect))
        others, sink, watcher = {}, None, None
        while True:
            cmd = await loop.run_in_executor(None, conn.recv)
            if cmd == "done":
                break
            if cmd[0] == "connect":
                _, cid, user, word = cmd
                c = MQTTClient("127.0.0.1", port, client_id=cid, keepalive=0,
                               username=user, password=word)
                conn.send((await c.connect(timeout=60)).rc)
                await c.close()
            elif cmd[0] == "subscribe":
                _, j, filters = cmd
                conn.send((await subs[j].subscribe(
                    filters, qos=0, timeout=60)).reason_codes)
            elif cmd[0] == "send":
                _, port_, k, sends, want = cmd
                if port_:
                    if port_ not in others:
                        others[port_] = await connect(f"plug-ext{port_}",
                                                      False, None, port_)
                    c = others[port_]
                else:
                    c = publishers[k]
                for i, (topic, qos) in enumerate(sends):
                    await c.publish(topic, b"%s %d" % (cmd[0].encode(), i),
                                    qos=qos, timeout=120)
                got = {j: [] for j in range(len(subs))}

                def drain():
                    for j, sc in enumerate(subs):
                        while not sc.messages.empty():
                            m = sc.messages.get_nowait()
                            if m is not None:
                                got[j].append((m.topic, bytes(m.payload)))

                deadline = time.monotonic() + 120
                while time.monotonic() < deadline:
                    drain()
                    if all(len(got[j]) >= n for j, n in want.items()):
                        break
                    await asyncio.sleep(0.02)
                await asyncio.sleep(0.5)
                drain()
                conn.send(got)
            elif cmd[0] == "sink":
                sink = await asyncio.start_server(sink_handle, "127.0.0.1", 0)
                conn.send(f"http://127.0.0.1:"
                          f"{sink.sockets[0].getsockname()[1]}/hook")
            elif cmd[0] == "calls":
                conn.send(calls[0])
            elif cmd[0] == "watch":
                _, port_, filt = cmd
                watcher = await connect("plug-watch", True, None, port_)
                await watcher.subscribe(filt, qos=1, timeout=60)
                conn.send("watching")
            elif cmd[0] == "watched":
                out = []
                for _ in range(cmd[1]):
                    m = await asyncio.wait_for(watcher.messages.get(), 120)
                    out.append((m.topic, bytes(m.payload)))
                await asyncio.sleep(0.5)
                while not watcher.messages.empty():
                    m = watcher.messages.get_nowait()
                    if m is not None:
                        out.append((m.topic, bytes(m.payload)))
                conn.send(out)
        for c in subs + publishers + list(others.values()) \
                + ([watcher] if watcher is not None else []):
            await c.disconnect()
        if sink is not None:
            sink.close()

    asyncio.run(run())
    conn.close()


async def phase_plugins(card: str, b, m, port: int, api_key: str, pools,
                        rng) -> dict:
    """[plugins], on the broker phase's broker after [admin] (999,447 GPU
    rows): the shipped defaults turned on over the admin API (``config set
    allow_anonymous=off``, ``plugin enable`` vmq_passwd with ``$6$``
    entries for the phase's users and vmq_acl with PLUGIN_ACL); a load of
    PLUGIN_PUBS publishes from authenticated clients in a second process,
    every delivery exact against the registry trie; the refusals answered
    as the reference broker answers them; a vmq_diversity Lua script
    (``script load``) whose ``auth_on_publish`` rewrites ``rw/<topic>`` to
    ``<topic>``; a webhook (``webhooks register``) in the clients' process
    that answers ``auth_on_publish`` with a ``topic`` modifier; a bridge
    to a second broker on the card, each way with a prefix; every
    rewritten and bridged publish matched on the card and delivered
    exactly as the trie of its final topic gives it. Every host-served
    counter stays at 0 (read over the admin API), the tile and extraction
    kernels launch, and the broker is left with no plugin and anonymous
    clients allowed again."""
    import asyncio
    import collections
    import multiprocessing
    import shutil
    import tempfile

    from vernemq_tpu_torch.admin.cli import run_remote
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.plugins import passwd

    t_start = time.perf_counter()
    loop = asyncio.get_running_loop()
    base = f"http://127.0.0.1:{b.http.port}"

    async def admin(*words):
        res = await loop.run_in_executor(None, run_remote, base, api_key,
                                         list(words), 30)
        if "error" in res:
            fail(f"plugins: {' '.join(words)}: {res['error']}")
        return res

    async def host_metrics():
        rows = (await admin("metrics", "show"))["table"]
        return {r["metric"]: r["value"] for r in rows
                if r["metric"] in HOST_METRICS + ("tpu_match_publishes",)}

    tmp = tempfile.mkdtemp(prefix="vmq-plugins-")
    pw_file, acl_file, lua_file = (os.path.join(tmp, n) for n in (
        "vmq.passwd", "vmq.acl", "rewrite.lua"))
    with open(pw_file, "w") as f:
        f.writelines(passwd.make_entry(u, w) + "\n"
                     for u, w in PLUGIN_USERS.items())
    with open(acl_file, "w") as f:
        f.write(PLUGIN_ACL)
    with open(lua_file, "w") as f:
        f.write('function auth_on_publish(pub)\n'
                '    if string.sub(pub.topic, 1, 3) == "rw/" then\n'
                '        return {topic = string.sub(pub.topic, 4)}\n'
                '    end\n'
                'end\n'
                'hooks = { auth_on_publish = auth_on_publish }\n')
    before = await host_metrics()
    reset_counts()
    await admin("config", "set", "allow_anonymous=off")
    await admin("plugin", "enable", "name=vmq_passwd",
                f"passwd_file={pw_file}")
    await admin("plugin", "enable", "name=vmq_acl", f"acl_file={acl_file}")

    live, topics, qos, pubs, expect = live_load(
        rng, pools, "plugins", PLUGIN_LIVE, PLUGIN_PUBS, PLUGIN_PUBLISHERS)
    trie = b.registry.trie("")
    sids = {("", f"plug-sub{j}"): j for j in range(PLUGIN_LIVE)}

    def rows_of(topic_list, tag: str):
        """Each live subscriber's deliveries of ``topic_list`` (publish i
        carrying ``b"<tag> <i>"``) as the trie gives them, and counts."""
        want = [collections.Counter() for _ in range(PLUGIN_LIVE)]
        for i, t in enumerate(topic_list):
            for _f, key, _o in trie.match(t.split("/")):
                j = sids.get(key)
                if j is not None:
                    want[j][(t, b"%s %d" % (tag.encode(), i))] += 1
        return want, {j: sum(w.values()) for j, w in enumerate(want) if w}

    ctx = multiprocessing.get_context("spawn")
    conn, child = ctx.Pipe()
    proc = ctx.Process(target=plugin_clients,
                       args=(port, live, pubs, expect, child), daemon=True)
    proc.start()
    child.close()

    async def ask(cmd=None):
        if cmd is not None:
            conn.send(cmd)
        deadline = time.monotonic() + BROKER_WAIT_S + 120
        while not await loop.run_in_executor(None, conn.poll, 1.0):
            if time.monotonic() > deadline or not proc.is_alive():
                fail(f"plugins: the clients did not answer "
                     f"{cmd[0] if isinstance(cmd, tuple) else cmd} (exit "
                     f"code {proc.exitcode})")
        return await loop.run_in_executor(None, conn.recv)

    b2 = s2 = step = None
    try:
        await ask()  # every authenticated client connected and subscribed
        want = [collections.Counter() for _ in live]
        for i, t in enumerate(topics):
            for _f, key, _o in trie.match(t.split("/")):
                j = sids.get(key)
                if j is not None:
                    want[j][(i % PLUGIN_PUBLISHERS, i)] += 1
        if [sum(w.values()) for w in want] != expect:
            fail("plugins: the clients' stop counts disagree with the trie")
        n0, t0 = m.match_publishes, time.perf_counter()
        conn.send("go")
        got, acks, wall, _ = await ask()
        check_live(got, want, "plugins")
        n_del = sum(len(g) for g in got)
        load_pubs = m.match_publishes - n0
        if load_pubs != PLUGIN_PUBS:
            fail(f"plugins: the card matched {load_pubs} of the load's "
                 f"{PLUGIN_PUBS} publishes")

        # ---- refusals, as the reference broker answers them
        refused = dict(
            bad_password=await ask(("connect", "plug-bad", "plug-pub",
                                    b"wrong")),
            anonymous=await ask(("connect", "plug-anon", None, None)),
            subscribe=await ask(("subscribe", 1, "secret")),
            watch=await ask(("subscribe", 0, "own/+/x/y")))
        if (refused["bad_password"] != RC_BAD_PASSWORD
                or refused["anonymous"] != RC_NOT_AUTHORIZED
                or refused["subscribe"] != [SUBACK_DENIED]
                or refused["watch"] != [0]):
            fail(f"plugins: refusals {refused}")
        l0, l1, l2 = pools
        # under plug-sub0's ".../#" filter: delivered to it if routed
        deep = live[0][0][3][:-1] + "x/y"
        # 4 levels: only the pattern rule lets plug-pub1 write them
        mine, other = "own/plug-pub1/x/y", "own/plug-pub3/x/y"
        sends = [(mine, 0), (other, 0), (deep, 0), (mine, 0)]
        seen = await ask(("send", 0, 1, sends, {0: 2}))
        leaked = {j: g for j, g in seen.items()
                  if g != ([(mine, b"send 0"), (mine, b"send 3")] if j == 0
                           else [])}
        if leaked:
            fail(f"plugins: an ACL-denied publish was delivered: {leaked}")

        async def rewritten(tag: str, prefix: str, port_: int = 0):
            """PLUGIN_STEP zipf publishes sent as ``prefix`` + topic, or
            (``prefix`` None) into the second broker at ``port_`` less
            their first word, which the bridge's ``in_word`` prefix puts
            back; returns the card's publishes and tile launches for them
            and the deliveries, after checking every live subscriber's
            deliveries against the trie of the final topics."""
            from vernemq_tpu_torch.ops import tile_match as TM

            final = ["/".join(t) for t in zipf_topics(rng, pools,
                                                      PLUGIN_STEP)]
            if prefix is None:
                final = [in_word + "/" + t.split("/", 1)[1] for t in final]
            want, counts = rows_of(final, "send")
            if not counts:
                fail(f"plugins: the {tag} publishes match no subscriber")
            sent = [(prefix + t if prefix else t.split("/", 1)[1], i % 2)
                    for i, t in enumerate(final)]
            n, launches = m.match_publishes, TM.launches
            seen = await ask(("send", port_, 1, sent, counts))
            if m.match_publishes - n != PLUGIN_STEP \
                    or TM.launches <= launches:
                fail(f"plugins: {tag}: {m.match_publishes - n} of "
                     f"{PLUGIN_STEP} matched on the card, tile launches "
                     f"+{TM.launches - launches}")
            for j in range(PLUGIN_LIVE):
                if collections.Counter(seen[j]) != want[j]:
                    fail(f"plugins: {tag}: plug-sub{j} got "
                         f"{len(seen[j])} deliveries, the trie of the "
                         f"final topics gives {sum(want[j].values())}")
            return (m.match_publishes - n, TM.launches - launches,
                    sum(counts.values()))

        out_word, in_word = l0[0], l0[1]  # the bridge's two prefixes

        # ---- vmq_diversity: a Lua auth_on_publish rewrites rw/<topic>
        await admin("plugin", "enable", "name=vmq_diversity")
        await admin("script", "load", f"path={lua_file}")
        lua = await rewritten("the Lua rewrite", "rw/")

        # ---- vmq_webhooks: an auth_on_publish webhook's topic modifier
        url = await ask(("sink",))
        await admin("plugin", "enable", "name=vmq_webhooks")
        await admin("webhooks", "register", "hook=auth_on_publish",
                    f"endpoint={url}")
        hook = await rewritten("the webhook rewrite", "wh/")
        hook_calls = await ask(("calls",))
        await admin("webhooks", "deregister", "hook=auth_on_publish",
                    f"endpoint={url}")
        if hook_calls != PLUGIN_STEP:
            fail(f"plugins: the webhook was called {hook_calls} times for "
                 f"{PLUGIN_STEP} publishes")

        # ---- vmq_bridge: a second broker on the card, bridged each way;
        # the step is watched (collections, event-loop lags, a stack
        # sample, the heap policy's and the collectors' log lines): the
        # second broker's first build lands in it
        step = StepWatch(b.heap)
        cfg2 = broker_config()
        cfg2.set("tpu_initial_capacity", 1 << 13)
        cfg2.set("http_enabled", False)
        b2, s2 = await start_broker(cfg2, port=0, device=DEVICE)
        plugin = b.plugins.enable("vmq_bridge", bridges=[{
            "name": "plug-br", "host": "127.0.0.1", "port": s2.port,
            "restart_timeout": 0.2, "topics": [
                {"pattern": f"{out_word}/+/+", "direction": "out",
                 "qos": 1, "remote_prefix": "big"},
                {"pattern": "+/+", "direction": "in", "qos": 1,
                 "local_prefix": in_word}]}])
        deadline = time.monotonic() + 60
        while not (plugin.bridges["plug-br"].info()["connected"]
                   and b2.registry.trie("").match(["x", "y"])):
            if time.monotonic() > deadline:
                fail("plugins: the bridge never linked the two brokers")
            await asyncio.sleep(0.05)
        shown = (await admin("bridge", "show"))["table"]
        if [r["name"] for r in shown] != ["plug-br"] \
                or not shown[0]["connected"]:
            fail(f"plugins: bridge show lists {shown}")
        await ask(("watch", s2.port, "big/#"))
        out_topics = [f"{out_word}/{l1[rng.randrange(BROKER_HOT)]}/"
                      f"{l2[rng.randrange(BROKER_HOT)]}"
                      for _ in range(PLUGIN_STEP)]
        want_out, counts_out = rows_of(out_topics, "send")
        n = m.match_publishes
        seen = await ask(("send", 0, 1, [(t, 1) for t in out_topics],
                          counts_out))
        if any(collections.Counter(seen[j]) != want_out[j]
               for j in range(PLUGIN_LIVE)):
            fail("plugins: the bridged-out publishes' local deliveries "
                 "differ from the trie's")
        remote = await ask(("watched", PLUGIN_STEP))
        if sorted(remote) != sorted(
                (f"big/{t}", b"send %d" % i)
                for i, t in enumerate(out_topics)):
            fail(f"plugins: the second broker's subscriber got "
                 f"{len(remote)} of {PLUGIN_STEP} bridged publishes")
        bridge_out = m.match_publishes - n
        warm2 = b2.registry.reg_view("tpu").matcher("").warm_ms
        policy = step.stop(f"the second broker's warm dispatch "
                           f"{warm2:.1f} ms")
        if bridge_out != PLUGIN_STEP:
            fail(f"plugins: {bridge_out} of the {PLUGIN_STEP} bridged-out "
                 f"publishes matched on the card; the bridge step: "
                 f"{policy}\n{step.detail()}")
        bridged_in = await rewritten("the bridged-in publishes",
                                     None, s2.port)
        hs2 = host_served(b2.batch_collector(),
                          b2.registry.reg_view("tpu").matcher(""))

        # ---- restore: no plugin, anonymous clients allowed
        for name in ("vmq_bridge", "vmq_webhooks", "vmq_diversity",
                     "vmq_acl", "vmq_passwd"):
            await admin("plugin", "disable", f"name={name}")
        if (await admin("plugin", "show"))["table"]:
            fail("plugins: plugins left enabled")
        await admin("config", "set", "allow_anonymous=on")
        conn.send("done")
    finally:
        proc.join(30)
        if proc.is_alive():
            proc.kill()
            proc.join()
        if step is not None:
            step.stop()
        if b2 is not None:
            await b2.stop()
            await s2.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    after = await host_metrics()
    moved = {k: after[k] - before[k] for k in HOST_METRICS
             if after[k] != before[k]}
    if moved or any(hs2.values()):
        fail(f"plugins: publishes served by the host: {moved}, second "
             f"broker {hs2}")
    launches, ex, dense = forward_counts("plugins")
    card_pubs = after["tpu_match_publishes"] - before["tpu_match_publishes"]
    total = time.perf_counter() - t_start
    print(f"[plugins] {card} | the shipped defaults over the admin API "
          f"(allow_anonymous off, vmq_passwd with $6$ entries, vmq_acl): "
          f"{PLUGIN_PUBS} publishes ({sum(qos)} at QoS 1) from "
          f"{PLUGIN_PUBLISHERS} authenticated publishers to {PLUGIN_LIVE} "
          f"authenticated subscribers (v3.1.1 and v5) at "
          f"{PLUGIN_PUBS / wall:.0f} publishes/s ({wall:.2f}s), {n_del} "
          f"deliveries exact against the trie; refusals as the reference "
          f"broker answers them: wrong password CONNACK "
          f"{refused['bad_password']}, anonymous {refused['anonymous']}, "
          f"denied SUBSCRIBE {refused['subscribe']}, ACL-denied publishes "
          f"delivered to no one", flush=True)
    print(f"[plugins] {card} | {PLUGIN_STEP} publishes rewritten by a Lua "
          f"auth_on_publish (vmq_diversity, `script load`): {lua[0]} "
          f"matched on the card ({lua[1]} tile launches), {lua[2]} "
          f"deliveries exact against the trie of the rewritten topics; "
          f"{PLUGIN_STEP} rewritten by an auth_on_publish webhook "
          f"({hook_calls} endpoint calls): {hook[0]} on the card, {hook[2]} "
          f"deliveries exact; bridge `plug-br` to a second broker on the "
          f"card: {bridge_out} publishes out (all {PLUGIN_STEP} at the "
          f"remote subscriber under big/), {bridged_in[0]} in through the "
          f"bridge matched on the card, {bridged_in[2]} deliveries exact; "
          f"the bridge step: {policy}", flush=True)
    print(f"[plugins] {card} | exact, 0 host-served (deltas over the admin "
          f"API), {card_pubs} publishes on the card, {launches} tile / "
          f"{dense} dense-mode / {ex} extraction launches, no plain "
          f"extraction or bit-pack on the card; every plugin disabled, "
          f"allow_anonymous on; [plugins] took {total:.1f}s", flush=True)
    return dict(launches=launches, extract_launches=ex, seconds=total,
                pubs_per_s=PLUGIN_PUBS / wall, card_pubs=card_pubs)


def cluster_config():
    """A cluster node's configuration: the broker phase's (the GPU view at
    capacity 2^20, the broker's own queued-publish expiry and dispatch
    deadline, the admin HTTP API) with the SWC metadata store."""
    cfg = broker_config()
    cfg.set("metadata_plugin", "swc")
    return cfg


def node_state(b) -> dict:
    """A cluster node's counters read before and after the counted load:
    overload-level entries and the level, anti-entropy rounds, cluster
    channel bytes sent and received, spool replays, and the process's CPU
    seconds, the device allocator's retries and the card's free memory."""
    import torch

    gov = b.overload.stats() if b.overload is not None else {}
    return dict(enters=[int(gov.get(f"overload_level_enters_l{lv}", 0))
                        for lv in (1, 2, 3)],
                level=int(gov.get("overload_level", 0)),
                exchanges=b.metadata.stats().get("swc_exchanges", 0),
                sent=b.metrics.value("cluster_bytes_sent"),
                received=b.metrics.value("cluster_bytes_received"),
                replayed=b.metrics.value("cluster_spool_replayed"),
                cpu_s=time.process_time(),
                retries=torch.cuda.memory_stats().get("num_alloc_retries",
                                                      0),
                free_gib=torch.cuda.mem_get_info()[0] / 2**30)


async def watch_node(b, seen: dict) -> None:
    """Sample a cluster node's event loop every 10 ms during the counted
    load: its lag past the sleep, its overload level and the largest
    outgoing cluster buffer. Keeps the largest lag and buffer, the count
    of lags past 50 ms, and the first 30 such lags or level changes as
    (seconds into the load, lag ms, level, buffer bytes)."""
    import asyncio

    t0 = time.monotonic()
    level = b.overload.level if b.overload is not None else 0
    while True:
        t = time.monotonic()
        await asyncio.sleep(0.01)
        now = time.monotonic()
        lag = (now - t - 0.01) * 1e3
        buf = max((getattr(w, "_buf_bytes", 0) for w in list(
            getattr(b.cluster, "_writers", {}).values())), default=0)
        lv = b.overload.level if b.overload is not None else 0
        seen["max_lag_ms"] = max(seen["max_lag_ms"], lag)
        seen["max_buf"] = max(seen["max_buf"], buf)
        if lag > 50:
            seen["lags"] += 1
        if (lag > 50 or lv != level) and len(seen["events"]) < 30:
            seen["events"].append((round(now - t0, 2), round(lag, 1), lv,
                                   buf))
        level = lv


def cluster_node(name: str, join, conn) -> None:
    """One node of the cluster phase, in a process of its own: a broker
    on the card through ``start_broker(cluster_listen=, join=)``, its
    cluster listener on an ephemeral port that it sends to the parent
    first, serving the parent's commands over ``conn`` (see
    :func:`phase_cluster`). It counts the publishes the peer forwards to
    it: each is folded on its host trie for its local subscribers
    (``Registry.publish_from_remote``, as the reference does)."""
    import asyncio
    import collections

    from vernemq_tpu_torch.admin.commands import (CommandRegistry,
                                                  register_core_commands)
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.observability import histogram as hist
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM
    from vernemq_tpu_torch.protocol.types import SubOpts

    mine = CLUSTER_NODES.index(name)
    n_ids = -(-N_SUBS // BROKER_PER_ID)
    ids = collections.defaultdict(list)
    build_corpus(random.Random(SEED), N_SUBS,
                 lambda f, i: ids[i // BROKER_PER_ID].append(f))
    own = [i for i in sorted(ids) if (2 * i >= n_ids) == bool(mine)]
    peer = set(ids) - set(own)
    local = sum(len({tuple(f) for f in ids[i]}) for i in own)
    remote = len({tuple(f) for i in peer for f in ids[i]})

    async def run():
        b, server = await start_broker(
            cluster_config(), host="127.0.0.1", port=0, node_name=name,
            device=DEVICE, cluster_listen=("127.0.0.1", 0), join=join)
        conn.send(("listening", b.cluster.listen_port))
        try:
            await serve(b, server)
        finally:
            await b.cluster.stop()
            await b.stop()
            await server.stop()

    async def serve(b, server):
        loop = asyncio.get_running_loop()
        reg = b.registry
        deadline = time.monotonic() + CLUSTER_WAIT_S
        while not (len(b.cluster.members()) == 2 and b.cluster.is_ready()):
            if time.monotonic() > deadline:
                fail(f"cluster: node {name} never joined")
            await asyncio.sleep(0.05)
        view = reg.reg_view("tpu")
        m = view.matcher("")  # empty: the load fills it in order
        folds = [0]  # trie folds of publishes the peer forwarded
        from_peer = reg.publish_from_remote

        def counted(msg, trace=None):
            folds[0] += 1
            return from_peer(msg, trace=trace)

        reg.publish_from_remote = counted
        col = b.batch_collector()
        api_key = register_core_commands(CommandRegistry()).run(
            b, ["api-key", "create"])["table"][0]["key"]
        conn.send(("up", server.port, b.http.port, api_key, os.getpid()))
        base = {}
        inbound = dict(batches=[], kinds={})
        time_cluster_batches(b, inbound)
        while True:
            cmd = await loop.run_in_executor(None, conn.recv)
            if cmd[0] == "load":
                c0, t0 = time.process_time(), time.monotonic()
                opts = SubOpts(qos=0)
                for n, i in enumerate(own):
                    reg.subscribe(("", f"bulk{i}"),
                                  [(f, opts) for f in ids[i]])
                    if n % CLUSTER_YIELD == CLUSTER_YIELD - 1:
                        await asyncio.sleep(0)  # the channel drains
                t_loaded, c_loaded = time.monotonic(), time.process_time()
                while len(reg.trie("")) < local + remote:
                    if time.monotonic() > t0 + CLUSTER_WAIT_S:
                        fail(f"cluster: node {name} holds "
                             f"{len(reg.trie(''))} of {local + remote} "
                             f"rows")
                    await asyncio.sleep(0.01)
                conn.send(("loaded", t0, t_loaded, time.monotonic(),
                           c_loaded - c0, time.process_time() - c_loaded,
                           local, remote, len(reg.trie("")),
                           b.metrics.value("cluster_frames_dropped"),
                           b.metrics.value("cluster_bytes_dropped")))
            elif cmd[0] == "build":
                t0 = time.perf_counter()
                settle_sync(m)
                t_built = time.perf_counter() - t0
                heap = HeapWatch(b.heap, f"cluster node {name}")
                heap.check()
                conn.send(("built", t_built, m.table.count,
                           int(m.table.cap), m.warm_ms))
            elif cmd[0] == "want":
                # each local live subscriber's deliveries as this node's
                # trie (local rows and the peer's pointers) gives them
                _, topics, sids = cmd
                trie = reg.trie("")
                want = {j: collections.Counter() for j in sids.values()}
                for i, t in enumerate(topics):
                    for _f, key, _o in trie.match(t.split("/")):
                        j = sids.get(key)
                        if j is not None:
                            want[j][(i % BROKER_PUBLISHERS, i)] += 1
                conn.send(want)
            elif cmd[0] == "reset":
                hist.reset_all()
                reset_counts()
                base = dict(pubs=m.match_publishes, batches=m.match_batches,
                            folds=folds[0],
                            remote=b.metrics.value("router_matches_remote"),
                            dropped=b.metrics.value(
                                "cluster_frames_dropped"))
                seen = dict(max_lag_ms=0.0, lags=0, max_buf=0, events=[],
                            before=node_state(b))
                inbound["batches"].clear()
                inbound["kinds"].clear()
                watcher = loop.create_task(watch_node(b, seen))
                sampler = StackSampler()
                conn.send("reset")
            elif cmd[0] == "read":
                watcher.cancel()
                seen["after"] = node_state(b)
                conn.send(dict(
                    watch=seen, profile=sampler.stop(),
                    inbound=batch_summary(inbound),
                    launches=TM.launches, extract_launches=EX.launches,
                    plain_extractions=TK.plain_cuda_extractions,
                    dense_launches=TM.dense_launches,
                    plain_packs=TK.plain_cuda_packs,
                    pubs=m.match_publishes - base["pubs"],
                    batches=m.match_batches - base["batches"],
                    flushes=hist.get("stage_collector_wait_ms").snapshot()[2],
                    wait=hist.summary(hist.get(
                        "stage_collector_wait_ms").snapshot()),
                    forwards=b.metrics.value("router_matches_remote")
                    - base["remote"],
                    trie_folds=folds[0] - base["folds"],
                    dropped=b.metrics.value("cluster_frames_dropped")
                    - base["dropped"],
                    rows=m.table.count, gc=heap.summary(),
                    host={k: getattr(col, k) for k in (
                        "degraded_host_pubs", "busy_host_pubs",
                        "rebuild_host_pubs", "overload_host_pubs",
                        "expired_host_pubs", "stalled_host_pubs",
                        "host_hybrid_pubs")}))
            elif cmd[0] == "synced":
                # the peer's (un)subscribe reached this node's store and
                # trie: each sid's record holds ``n`` filters; answers the
                # monotonic time this node first saw it so
                _, sids, n = cmd
                t0 = time.monotonic()
                while any(len(getattr(reg.db.read(sid), "subs", {})) != n
                          for sid in sids):
                    if time.monotonic() > t0 + CLUSTER_WAIT_S:
                        fail(f"cluster: node {name} never saw the peer's "
                             f"records of {len(sids)} subscribers with "
                             f"{n} filters")
                    await asyncio.sleep(0.001)
                conn.send(time.monotonic())
            else:
                return

    asyncio.run(run())
    conn.close()


def phase_cluster(card: str, single: dict) -> dict:
    """[cluster]: two port nodes on the one card, each a broker process
    started through ``start_broker(cluster_listen=, join=)`` with the SWC
    store (node B joins node A). The broker phase's corpus, split by
    subscriber id between them, reaches each node's GPU table as its own
    rows and the peer's node-pointer rows (~1M rows per node); the broker
    phase's live load split over both nodes is delivered exactly as each
    node's trie gives it, with cross-node deliveries, no publish served
    off the card on either node (read over each node's admin HTTP API) and
    the tile kernel launched on both; then an unsubscribe of 100 filters
    on A stops B's publishes reaching them, and the resubscribe brings
    them back."""
    import collections
    import multiprocessing
    import threading

    import numpy as np

    from vernemq_tpu_torch.admin.cli import run_remote
    from vernemq_tpu_torch.models.trie import SubscriptionTrie

    from vernemq_tpu_torch.ops import _build

    t_phase = time.perf_counter()
    from vernemq_tpu_torch.models import matcher as GM
    from vernemq_tpu_torch.retained import index as RI

    release(card, "before the cluster's nodes start")
    # every library a node loads is built here, before the nodes spawn:
    # two processes never run nvcc into the build directory at once
    _build.build(sorted({*GM.KERNEL_LIBS, *RI.KERNEL_LIBS, "predicate"}))
    pools = build_corpus(random.Random(SEED), 0, None)
    rng = random.Random(SEED + 4)
    live, topics, qos, pubs, expect = live_load(rng, pools, "cluster")
    ctx = multiprocessing.get_context("spawn")
    nodes, procs = [], []
    client = None

    def spawn(name: str, join) -> None:
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=cluster_node, args=(name, join, child),
                           daemon=True)
        proc.start()
        child.close()
        nodes.append((name, proc, conn))
        procs.append(proc)

    def ask(i: int, cmd=None, limit: float = CLUSTER_WAIT_S):
        name, proc, conn = nodes[i]
        if cmd is not None:
            conn.send(cmd)
        deadline = time.monotonic() + limit
        while not conn.poll(1.0):
            if time.monotonic() > deadline or not proc.is_alive():
                fail(f"cluster: node {name} did not answer "
                     f"{cmd[0] if cmd else 'up'} (exit code "
                     f"{proc.exitcode})")
        return conn.recv()

    def both(cmd):
        for _, _, conn in nodes:
            conn.send(cmd)
        return [ask(i) for i in range(len(nodes))]

    try:
        spawn(CLUSTER_NODES[0], None)
        # B joins A at the port A's cluster listener took
        spawn(CLUSTER_NODES[1], ("127.0.0.1", ask(0)[1]))
        ask(1)  # B's listener
        ups = [ask(i, limit=CLUSTER_WAIT_S) for i in range(len(nodes))]
        t_up = time.perf_counter() - t_phase
        mqtt = [u[1] for u in ups]
        loaded = both(("load",))
        t_last = max(x[2] for x in loaded)
        repl_s = max(x[3] for x in loaded) - t_last
        built = both(("build",))
        for (name, _, _), up, ld, bl in zip(nodes, ups, loaded, built):
            print(f"[cluster] {card} | node {name} (pid {up[4]}): "
                  f"{ld[6]} local rows of its {BROKER_PER_ID}-filter ids "
                  f"subscribed in {ld[2] - ld[1]:.1f}s ({ld[4]:.1f} CPU s), "
                  f"{ld[7]} node-pointer rows of the peer's filters; "
                  f"table rows {bl[2]}, S={bl[3]}; device table built in "
                  f"{bl[1]:.1f}s; after its own last subscribe it spent "
                  f"{ld[5]:.1f} CPU s until it held every row "
                  f"({ld[3] - ld[2]:.1f}s); its channel to the peer dropped "
                  f"{ld[9]} frames ({ld[10] / 1e6:.1f} MB) of the load, "
                  f"past its {cluster_config().outgoing_clustering_buffer_size / 1e6:.0f} "
                  f"MB buffer, and anti-entropy repaired them", flush=True)
            if bl[2] != ld[6] + ld[7]:
                fail(f"cluster: node {name}'s table holds {bl[2]} rows, "
                     f"its trie {ld[6] + ld[7]}")
        print(f"[cluster] {card} | both nodes up in {t_up:.1f}s; SWC "
              f"replication of {-(-N_SUBS // BROKER_PER_ID)} subscriber "
              f"records: from the last subscribe to both tables holding "
              f"every row {repl_s:.2f}s", flush=True)

        sub_ports = [mqtt[j % 2] for j in range(BROKER_LIVE)]
        pub_ports = [mqtt[k % 2] for k in range(BROKER_PUBLISHERS)]
        conn, child = ctx.Pipe()
        client = ctx.Process(target=cluster_clients,
                             args=(live, pubs, expect, child, sub_ports,
                                   pub_ports, mqtt[0]),
                             daemon=True)
        client.start()
        child.close()
        if not conn.poll(BROKER_WAIT_S + 120):
            fail("cluster: the clients did not answer in time")
        conn.recv()  # every live subscription is in place
        print(f"[cluster] {card} | {BROKER_LIVE} live subscribers and "
              f"{BROKER_PUBLISHERS} publishers connected "
              f"{time.perf_counter() - t_phase:.1f}s into the phase",
              flush=True)
        want = [None] * BROKER_LIVE
        for n in range(len(nodes)):
            sids = {("", f"live{j}"): j for j in range(n, BROKER_LIVE, 2)}
            for j, w in ask(n, ("want", topics, sids)).items():
                want[j] = w
        if [sum(w.values()) for w in want] != expect:
            fail("cluster: the clients' stop counts disagree with the "
                 "nodes' tries")
        both(("reset",))
        own_cpu = time.process_time()
        threads = sorted(t.name for t in threading.enumerate())
        conn.send("go")
        if not conn.poll(BROKER_WAIT_S + 120):
            fail("cluster: the clients did not finish in time")
        got, acks, wall, _ = conn.recv()
        t_traffic = time.perf_counter()
        print(f"[cluster] {card} | this script's own process during the "
              f"load: {time.process_time() - own_cpu:.1f} CPU s, load "
              f"average {os.getloadavg()[0]:.1f} at its end, threads "
              f"{threads}", flush=True)
        reads = both(("read",))
        lat = {"local": [], "cross-node": []}
        for j, g in enumerate(got):
            for k, _seq, _q, ms in g:
                lat["cross-node" if k % 2 != j % 2 else "local"].append(ms)
        res = live_numbers(got, acks, wall)
        print(f"[cluster] {card} | {BROKER_PUBS} publishes ({sum(qos)} at "
              f"QoS 1) from {BROKER_PUBLISHERS} MQTT publishers "
              f"({BROKER_PUBLISHERS // 2} per node) to {BROKER_LIVE} MQTT "
              f"subscribers ({BROKER_LIVE // 2} per node): "
              f"{res['pubs_per_s']:.0f} publishes/s ({wall:.2f}s; one "
              f"broker: {single['pubs_per_s']:.0f}), {res['deliveries']} "
              f"deliveries of which {len(lat['cross-node'])} cross-node; "
              f"PUBLISH->delivery local {percentiles(lat['local'])}, "
              f"cross-node {percentiles(lat['cross-node'])}; QoS 1 PUBACK "
              f"p50 {res['ack_p50']:.2f} ms p99 {res['ack_p99']:.2f} ms "
              f"({t_traffic - t_phase:.1f}s into the phase)", flush=True)
        for (name, _, _), r in zip(nodes, reads):
            print(f"[cluster] {card} | node {name}: {r['flushes']} collector "
                  f"flushes, {r['batches']} device batches for {r['pubs']} "
                  f"publishes, tile / dense-mode / extraction launches "
                  f"{r['launches']} / {r['dense_launches']} / "
                  f"{r['extract_launches']}, plain bit-packs on the card "
                  f"{r['plain_packs']}, queue wait at "
                  f"flush start p50 {r['wait'].get('p50_ms', 0):.1f} ms p99 "
                  f"{r['wait'].get('p99_ms', 0):.1f} ms; {r['forwards']} "
                  f"matches forwarded to the peer; {r['trie_folds']} "
                  f"publishes forwarded by the peer matched for its local "
                  f"subscribers on its host trie, as the reference does "
                  f"(Registry.publish_from_remote); host-served "
                  f"{r['host']}; cluster frames dropped during the traffic "
                  f"{r['dropped']}; {r['gc']}", flush=True)
            w, w0, w1 = r["watch"], r["watch"]["before"], r["watch"]["after"]
            print(f"[cluster] {card} | node {name} during the load: "
                  f"{w1['cpu_s'] - w0['cpu_s']:.1f} CPU s; event loop "
                  f"sampled every 10 ms: largest lag {w['max_lag_ms']:.1f} "
                  f"ms, {w['lags']} lags past 50 ms; largest outgoing "
                  f"cluster buffer {w['max_buf']} bytes; cluster channel "
                  f"{w1['sent'] - w0['sent']} bytes sent, "
                  f"{w1['received'] - w0['received']} received, spool "
                  f"replays {w1['replayed'] - w0['replayed']}; device "
                  f"allocator retries {w1['retries'] - w0['retries']}, "
                  f"card memory free {w0['free_gib']:.1f} GiB at the "
                  f"start; overload "
                  f"level {w0['level']} at the start, entries (1, 2, 3) "
                  f"{w0['enters']} before, {w1['enters']} after; "
                  f"anti-entropy rounds {w1['exchanges'] - w0['exchanges']}"
                  f"; (s into the load, lag ms, level, buffer bytes): "
                  f"{w['events']}", flush=True)
            print(f"[cluster] {card} | node {name} cluster channel: "
                  f"{r['inbound']}", flush=True)
            print(f"[cluster] {card} | {stack_profile(name, r['profile'])}",
                  flush=True)
        inversions = check_live(got, want, "cluster")
        over_http = []
        for (name, _, _), u in zip(nodes, ups):
            shown = run_remote(f"http://127.0.0.1:{u[2]}", u[3],
                               ["metrics", "show"], 30)
            if "error" in shown:
                fail(f"cluster: node {name}'s admin API: {shown['error']}")
            over_http.append({r["metric"]: r["value"]
                              for r in shown["table"]})
        off = {name: {k: mt[k] for k in HOST_METRICS if mt[k]}
               for (name, _, _), mt in zip(nodes, over_http)}
        if any(off.values()) or any(any(r["host"].values()) for r in reads):
            fail(f"cluster: publishes served off the card: {off}, "
                 f"{[r['host'] for r in reads]}")
        for (name, _, _), r in zip(nodes, reads):
            forward_counts(f"cluster node {name}", (
                r["launches"], r["extract_launches"],
                r["plain_extractions"], r["dense_launches"],
                r["plain_packs"]))
        if any(r["dropped"] for r in reads):
            fail(f"cluster: cluster frames dropped during the traffic "
                 f"{[r['dropped'] for r in reads]}")
        if not lat["cross-node"]:
            fail("cluster: no cross-node delivery")
        if [r["trie_folds"] for r in reads] != \
                [r["forwards"] for r in reads[::-1]]:
            fail(f"cluster: trie folds of forwarded publishes "
                 f"{[r['trie_folds'] for r in reads]} against the peer's "
                 f"forwards {[r['forwards'] for r in reads[::-1]]}")
        print(f"[cluster] {card} | parity exact for every live subscriber "
              f"against its node's trie over the whole corpus, "
              f"per-publisher order kept at each QoS ({inversions} "
              f"inversions across QoS levels); over each node's admin API "
              f"tpu_match_publishes "
              f"{[mt['tpu_match_publishes'] for mt in over_http]} and every "
              f"host-served counter 0: every publish a client sent to a "
              f"node was matched on the card; every publish forwarded to "
              f"the peer was matched there again for its local subscribers "
              f"on its host trie ({[r['trie_folds'] for r in reads]}), as "
              f"the reference does; no cluster frame dropped during the "
              f"traffic", flush=True)

        # one unsubscribe round: 100 filters on A
        unsub = list(range(0, BROKER_LIVE, 2))[:CLUSTER_UNSUB]
        sids = [("", f"live{j}") for j in unsub]
        sends = [(1 + 2 * (n % (BROKER_PUBLISHERS // 2)), live[j][0][0])
                 for n, j in enumerate(unsub)]
        check = SubscriptionTrie()
        for j in unsub:
            for f in live[j][0]:
                check.add(f.split("/"), j, None)
        want_probe = collections.Counter(
            j for _k, t in sends for _f, j, _v in check.match(t.split("/")))
        rounds = []
        for op, n_filters in (("unsub", 0), ("sub", 4)):
            conn.send((op, unsub))
            t_ack = conn.recv()
            # an upper bound: B may have held them before it was asked
            sync_s = ask(1, ("synced", sids, n_filters)) - t_ack
            conn.send(("probe", sends,
                       {} if op == "unsub" else dict(want_probe)))
            if not conn.poll(BROKER_WAIT_S):
                fail("cluster: the probe did not finish in time")
            seen = conn.recv()
            counts = {j: len(seen[j]) for j in unsub}
            rounds.append((sync_s, sum(counts.values())))
            if op == "unsub" and any(counts.values()):
                fail(f"cluster: after the unsubscribe B's publishes still "
                     f"reached {sum(map(bool, counts.values()))} of A's "
                     f"subscribers")
            if op == "sub" and counts != {j: want_probe[j] for j in unsub}:
                fail(f"cluster: after the resubscribe {counts} against "
                     f"{dict(want_probe)}")
        print(f"[cluster] {card} | unsubscribe round: {len(unsub)} of A's "
              f"live subscribers unsubscribed {4 * len(unsub)} filters, "
              f"on B's store at most {rounds[0][0] * 1e3:.1f} ms after the "
              f"last UNSUBACK; {len(sends)} publishes from B's publishers "
              f"to their exact filters reached them 0 times; resubscribed, "
              f"on B at most {rounds[1][0] * 1e3:.1f} ms after the last "
              f"SUBACK, the same publishes reached them {rounds[1][1]} "
              f"times, as the filters give", flush=True)
        conn.send("done")
        for _, _, c in nodes:
            c.send(("stop",))
    finally:
        for pr in procs + ([client] if client is not None else []):
            pr.join(60)
            if pr.is_alive():
                pr.kill()
                pr.join()
    res.update(launches=sum(r["launches"] for r in reads),
               node_launches=[r["launches"] for r in reads],
               node_dense_launches=[r["dense_launches"] for r in reads],
               node_extract_launches=[r["extract_launches"] for r in reads],
               replication_s=repl_s,
               cross_node=len(lat["cross-node"]),
               trie_folds=[r["trie_folds"] for r in reads],
               lat_local_p50=float(np.percentile(lat["local"], 50)),
               lat_cross_p50=float(np.percentile(lat["cross-node"], 50)),
               seconds=time.perf_counter() - t_phase)
    print(f"[cluster] {card} | [cluster] took {res['seconds']:.1f}s",
          flush=True)
    return res


def percentiles(xs) -> str:
    import numpy as np

    return (f"p50 {np.percentile(xs, 50):.2f} ms p99 "
            f"{np.percentile(xs, 99):.2f} ms") if len(xs) else "none"


async def phase_admin(card: str, b, m, col, port: int, api_key: str, polls,
                      live, pools, rng, scrape) -> dict:
    """[admin], on the broker phase's broker after its counted load: the
    poll's requests and latencies, the admin's device counters against the
    broker's own, then the breaker drill (trip: the trie serves, reset:
    the card serves), a client trace, a ``ql query`` of one subscriber id
    and a Graphite reporter into a local sink. Returns the numbers for the
    kernels line. ``scrape``: one in-process metrics scrape's ms and
    metric count, and the ms and node count of one walk of the trie."""
    import asyncio
    import collections

    import numpy as np

    from vernemq_tpu_torch.admin.cli import run_remote
    from vernemq_tpu_torch.admin.graphite import GraphiteReporter
    from vernemq_tpu_torch.client import MQTTClient
    from vernemq_tpu_torch.ops import tile_match as TM

    t_start = time.perf_counter()
    loop = asyncio.get_running_loop()
    base = f"http://127.0.0.1:{b.http.port}"

    async def admin(*words, timeout=30):
        res = await loop.run_in_executor(None, run_remote, base, api_key,
                                         list(words), timeout)
        if "error" in res:
            fail(f"admin: {' '.join(words)}: {res['error']}")
        return res

    def metrics(rows):
        return {r["metric"]: r["value"] for r in rows}

    reqs = [(w, ms, ok) for w, ms, ok in polls if w != "metrics"]
    seen = [metrics(rows) for w, rows, _ in polls if w == "metrics"]
    bad = [w for w, _, ok in reqs if not ok]
    if not reqs or bad or not seen:
        fail(f"admin: {len(reqs)} requests during the load, {len(bad)} "
             f"failed ({bad[:3]}), {len(seen)} metrics tables")
    per = collections.defaultdict(list)
    for w, ms, _ in reqs:
        per[w].append(ms)
    final = metrics((await admin("metrics", "show"))["table"])
    own = dict(tpu_match_publishes=m.match_publishes,
               tpu_match_batches=m.match_batches,
               tpu_table_rows=m.table.count,
               tpu_degraded_host_pubs=col.degraded_host_pubs,
               tpu_expired_host_pubs=col.expired_host_pubs,
               tpu_stalled_host_pubs=col.stalled_host_pubs,
               tpu_busy_shed_pubs=col.busy_host_pubs,
               tpu_host_fallbacks=m.host_fallbacks)
    if any(final[k] != v for k, v in own.items()) \
            or any(final[k] for k in HOST_METRICS):
        fail(f"admin: the admin's device counters "
             f"{ {k: final[k] for k in own} } against the broker's {own}, "
             f"host-served { {k: final[k] for k in HOST_METRICS} }")
    mid = [x["tpu_match_publishes"] for x in seen]
    if mid != sorted(mid) or mid[-1] > final["tpu_match_publishes"] \
            or not any(0 < x < final["tpu_match_publishes"] for x in mid):
        fail(f"admin: the polled device counters never moved with the "
             f"load: {mid[:3]}..{mid[-3:]}")
    print(f"[admin] {card} | during [broker]'s counted load: {len(reqs)} "
          f"admin requests over HTTP (API key on; every "
          f"{ADMIN_POLL_S} s: {', '.join(' '.join(w) for w in ADMIN_POLL)}, "
          f"/metrics), 0 failed, {percentiles([x for _, x, _ in reqs])}; "
          + "; ".join(f"{w} {percentiles(v)}" for w, v in per.items())
          + f"; tpu_match_publishes read {len(seen)} times rising to "
          f"{mid[-1]}; after the load the admin's device counters equal "
          f"the broker's own ({', '.join(f'{k} {v}' for k, v in own.items())}"
          f"), host-served counters all 0; one in-process metrics scrape of "
          f"{scrape[1]} metrics at {m.table.count} rows {scrape[0]:.1f} ms "
          f"(the trie's node count kept, not walked: one walk of its "
          f"{scrape[3]} nodes takes {scrape[2]:.1f} ms)", flush=True)

    # ---- breaker drill: trip → the trie serves; reset → the card serves
    drill = [(f"drill{j}", filters) for j, (filters, _) in
             enumerate(live[:ADMIN_DRILL_SUBS])]
    subs = []
    for cid, filters in drill:
        c = MQTTClient("127.0.0.1", port, client_id=cid, keepalive=0,
                       proto_ver=5)
        await c.connect(timeout=60)
        await c.subscribe(filters, qos=1, timeout=60)
        subs.append(c)
    pub = MQTTClient("127.0.0.1", port, client_id="drill-pub", keepalive=0)
    await pub.connect(timeout=60)
    trie = b.registry.trie("")

    async def send(tag: str) -> dict:
        """ADMIN_DRILL_PUBS zipf publishes at QoS 0, every drill
        subscriber's deliveries equal to the trie's rows; returns the
        device and host counters' deltas."""
        topics = ["/".join(t) for t in zipf_topics(rng, pools,
                                                   ADMIN_DRILL_PUBS)]
        want = [collections.Counter() for _ in subs]
        for i, t in enumerate(topics):
            for _f, key, _o in trie.match(t.split("/")):
                for j, (cid, _) in enumerate(drill):
                    if key == ("", cid):
                        want[j][(t, b"%s%d" % (tag.encode(), i))] += 1
        n_want = sum(sum(w.values()) for w in want)
        if not n_want:
            fail(f"admin: the {tag} drill's publishes match no drill "
                 f"subscriber")
        before = (TM.launches, m.match_publishes, col.degraded_host_pubs,
                  sum(getattr(col, k) for k in (
                      "busy_host_pubs", "rebuild_host_pubs",
                      "overload_host_pubs", "expired_host_pubs",
                      "stalled_host_pubs", "host_hybrid_pubs")))
        for i, t in enumerate(topics):
            await pub.publish(t, b"%s%d" % (tag.encode(), i))
        got = [collections.Counter() for _ in subs]

        async def take(j, c):
            while sum(got[j].values()) < sum(want[j].values()):
                msg = await c.messages.get()
                got[j][(msg.topic, bytes(msg.payload))] += 1

        await asyncio.wait_for(asyncio.gather(
            *(take(j, c) for j, c in enumerate(subs))), 120)
        await asyncio.sleep(0.3)
        for j, c in enumerate(subs):
            while not c.messages.empty():
                msg = c.messages.get_nowait()
                got[j][(msg.topic, bytes(msg.payload))] += 1
        if got != want:
            fail(f"admin: the {tag} drill's deliveries differ from the "
                 f"trie's rows")
        after = (TM.launches, m.match_publishes, col.degraded_host_pubs,
                 sum(getattr(col, k) for k in (
                     "busy_host_pubs", "rebuild_host_pubs",
                     "overload_host_pubs", "expired_host_pubs",
                     "stalled_host_pubs", "host_hybrid_pubs")))
        return dict(zip(("launches", "device_pubs", "trie_pubs", "other"),
                        (a - b_ for a, b_ in zip(after, before))),
                    deliveries=n_want)

    t0 = time.perf_counter()
    trip = await admin("breaker", "trip", "path=match")
    tripped = await send("trip")
    shown = {r["path"]: r["state"] for r in
             (await admin("breaker", "show"))["table"]}
    await admin("breaker", "reset", "path=match")
    reset = await send("reset")
    if (tripped["trie_pubs"] != ADMIN_DRILL_PUBS or tripped["launches"]
            or tripped["device_pubs"] or tripped["other"]
            or shown.get("match") != "forced_open"):
        fail(f"admin: with the match breaker tripped ({trip}, shown "
             f"{shown.get('match')}) {tripped}")
    if (reset["launches"] <= 0 or reset["device_pubs"] != ADMIN_DRILL_PUBS
            or reset["trie_pubs"] or reset["other"]):
        fail(f"admin: after the reset {reset}")
    t_drill = time.perf_counter() - t0
    print(f"[admin] {card} | breaker drill: `breaker trip path=match` "
          f"({trip['text']}), {ADMIN_DRILL_PUBS} publishes to "
          f"{ADMIN_DRILL_SUBS} subscribers delivered exactly "
          f"({tripped['deliveries']} deliveries), all {tripped['trie_pubs']} "
          f"served by the trie and counted as the drill's, tile launches "
          f"+{tripped['launches']}, `breaker show` match={shown['match']}; "
          f"`breaker reset`, {ADMIN_DRILL_PUBS} more delivered exactly "
          f"({reset['deliveries']}) on the card: tile launches "
          f"+{reset['launches']}, device publishes +{reset['device_pubs']}, "
          f"host-served +{reset['trie_pubs'] + reset['other']} "
          f"({t_drill:.1f}s)", flush=True)

    # ---- trace one publisher's PUBLISH frames
    # the tracer's rate limit (10 frames per 0.1 s by default) raised
    # past the frames of the traced publishes and their PUBACKs
    await admin("trace", "client", "client-id=drill-pub",
                f"rate-max={4 * ADMIN_TRACE_PUBS}")
    for i in range(ADMIN_TRACE_PUBS):
        await pub.publish(f"trace/{i}", b"t", qos=1, timeout=60)
    lines = (await admin("trace", "show"))["text"]["text"].splitlines()
    await admin("trace", "stop")
    traced = [ln for ln in lines if "MQTT RECV: PUBLISH" in ln
              and "[drill-pub]" in ln]
    if len(traced) != ADMIN_TRACE_PUBS:
        fail(f"admin: the trace shows {len(traced)} of drill-pub's "
             f"{ADMIN_TRACE_PUBS} PUBLISH frames: {lines[:4]}")
    for c in subs + [pub]:
        await c.disconnect()

    # ---- ql query of one subscriber id
    t0 = time.perf_counter()
    rows = (await admin("ql", "query", f"q=SELECT topic FROM subscriptions "
                        f"WHERE client_id='{ADMIN_QL_ID}'", timeout=120))
    ql_ms = (time.perf_counter() - t0) * 1e3
    have = sorted(r["topic"] for r in rows["table"])
    want_ql = sorted("/".join(w) for w in
                     b.registry.subscriptions[("", ADMIN_QL_ID)])
    if have != want_ql or len(have) != BROKER_PER_ID:
        fail(f"admin: ql query of {ADMIN_QL_ID} gave {len(have)} filters, "
             f"its subscriptions are {len(want_ql)}")

    # ---- Graphite into a local sink
    lines = []

    async def handle(reader, writer):
        while True:
            ln = await reader.readline()
            if not ln:
                break
            lines.append(ln.decode())
        writer.close()

    sink = await asyncio.start_server(handle, "127.0.0.1", 0)
    b.config.set("graphite_host", "127.0.0.1")
    b.config.set("graphite_port", sink.sockets[0].getsockname()[1])
    b.config.set("graphite_interval", ADMIN_POLL_S)
    reporter = GraphiteReporter(b)
    t0 = time.perf_counter()
    reporter.start()
    try:
        deadline = time.monotonic() + 30
        while not any(".tpu_match_publishes " in ln for ln in lines):
            if time.monotonic() > deadline:
                fail("admin: no Graphite line carried the device counters")
            await asyncio.sleep(0.05)
    finally:
        reporter._task.cancel()
        sink.close()
    graphite_s = time.perf_counter() - t0
    gvals = {ln.split()[0].rsplit(".", 1)[-1]: float(ln.split()[1])
             for ln in lines}
    if gvals["tpu_match_publishes"] != m.match_publishes or any(
            gvals.get(k, 0) != getattr(col, c) for k, c in (
                ("tpu_degraded_host_pubs", "degraded_host_pubs"),
                ("tpu_expired_host_pubs", "expired_host_pubs"))):
        fail(f"admin: Graphite's device counters "
             f"{ {k: gvals.get(k) for k in HOST_METRICS} } against the "
             f"broker's")
    total = time.perf_counter() - t_start
    print(f"[admin] {card} | `trace client client-id=drill-pub`: its "
          f"{len(traced)} PUBLISH frames in `trace show`; `ql query` of "
          f"{ADMIN_QL_ID}: exactly its {len(have)} filters in "
          f"{ql_ms:.0f} ms (a scan of every subscriber record); Graphite: "
          f"{len(lines)} lines in the local sink after {graphite_s:.2f}s, "
          f"tpu_match_publishes {gvals['tpu_match_publishes']:.0f} and "
          f"tpu_table_rows {gvals.get('tpu_table_rows', 0):.0f} as the "
          f"broker holds them; [admin] after the load took {total:.1f}s",
          flush=True)
    lat = [x for _, x, _ in reqs]
    return dict(requests=len(reqs), p50_ms=float(np.percentile(lat, 50)),
                p99_ms=float(np.percentile(lat, 99)),
                drill_trie_pubs=tripped["trie_pubs"],
                drill_launches=reset["launches"], seconds=total)


# --------------------------------------------------------- worker mode


def free_port_block(n: int) -> int:
    """The first base below the ephemeral range with ``n`` consecutive
    free loopback ports."""
    import socket

    for base in range(20000, 32000 - n, 97):
        socks = []
        try:
            for i in range(n):
                sk = socket.socket()
                socks.append(sk)
                sk.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sk in socks:
                sk.close()
    fail(f"no block of {n} free ports")


def gpu_pids() -> set:
    """The processes with a context on the card as ``nvidia-smi`` lists
    them (in a container its pids may be of another pid namespace)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi: {out.stderr.strip()}")
    return {int(x) for x in out.stdout.split() if x.strip().isdigit()}


def cuda_context_pids(pids) -> set:
    """Those of ``pids`` that hold a GPU device node (``/dev/nvidia<N>``)
    open, which a process does once it has created a CUDA context."""
    import re

    on = set()
    for pid in pids:
        try:
            fds = os.listdir(f"/proc/{pid}/fd")
        except OSError:
            continue
        for fd in fds:
            try:
                target = os.readlink(f"/proc/{pid}/fd/{fd}")
            except OSError:
                continue
            if re.fullmatch(r"/dev/nvidia\d+", target):
                on.add(pid)
                break
    return on


def offcard(stats) -> dict:
    """The worker group's counters of work done off the card: the
    service's trie-served publishes, failed folds and device batches, and
    each worker's trie-served publishes and missed folds; beside them the
    service's kernel launches (dense mode apart) and plain extractions and
    bit-packs on the card."""
    svc = stats.service_info()
    slots = stats.read_all()
    kern = stats.service_launches()
    dense = stats.service_dense()
    return dict(svc_host=svc["host_pubs"], svc_errors=svc["fold_errors"],
                batches=svc["device_batches"], folds=svc["folds"],
                ops=svc["ops"], tile=kern["tile"], extract=kern["extract"],
                plain=kern["plain"], dense=dense["dense"],
                packs=dense["plain_packs"],
                workers_host=[w["host_pubs"] for w in slots],
                workers_failed=[w["folds_failed"] for w in slots])


def bulk_clients(port: int, stats_name: str, sessions, k: int,
                 n: int) -> None:
    """Subscribe ``sessions`` (lists of filters; session ``k + n*i`` is
    ``bulk{k + n*i}``) as persistent v3.1.1 sessions at QoS 0 on ``port``,
    WORKERS_CONNECT at a time, each disconnected after its SUBACK; keeps
    this process's share of rows at most WORKERS_OPS_AHEAD / n ahead of
    the match service (the stats block ``stats_name``)."""
    import asyncio

    from vernemq_tpu_torch.client import MQTTClient
    from vernemq_tpu_torch.parallel.shm_ring import WorkerStatsBlock

    stats = WorkerStatsBlock.attach(stats_name)
    sem = asyncio.Semaphore(WORKERS_CONNECT)
    sent = [0]

    async def one(i, filters):
        async with sem:
            while sent[0] * n - stats.service_info()["ops"] \
                    > WORKERS_OPS_AHEAD:
                await asyncio.sleep(0.05)
            c = MQTTClient("127.0.0.1", port, client_id=f"bulk{k + n * i}",
                           clean_start=False, keepalive=0)
            await c.connect(timeout=120)
            await c.subscribe(filters, qos=0, timeout=300)
            sent[0] += len(set(filters))
            await c.disconnect()

    async def run():
        await asyncio.gather(*(one(i, fs) for i, fs in enumerate(sessions)))

    try:
        asyncio.run(run())
    finally:
        stats.close()


def worker_hist(stats, names) -> dict:
    """The workers' stage histograms ``names`` merged across their stats
    slots: {name: snapshot}."""
    from vernemq_tpu_torch.observability import histogram as hist

    out = {}
    for i in range(stats.n_workers):
        for name, snap in hist.unpack_flat(stats.read_hist(i)).items():
            if name in names:
                out[name] = hist.merge(out[name], snap) \
                    if name in out else snap
    return out


def phase_workers(card: str, single: dict) -> dict:
    """The broker phase's load through worker mode on the card: WORKERS_N
    SO_REUSEPORT workers and one match service (the GPU view), the same
    corpus subscribed over MQTT through the workers (ring ops to the
    service), then the same live clients in a second process; exact
    deliveries, nothing served off the card after the settle, and the
    service the only process of the group with a CUDA context."""
    import asyncio
    import collections
    import multiprocessing

    from vernemq_tpu_torch.broker.workers import WorkerGroup
    from vernemq_tpu_torch.client import MQTTClient
    from vernemq_tpu_torch.models.trie import SubscriptionTrie

    corpus = collections.defaultdict(list)
    pools = build_corpus(random.Random(SEED), N_SUBS,
                         lambda f, i: corpus[i // BROKER_PER_ID].append(
                             "/".join(f)) if i < WORKERS_SUBS else None)
    corpus = [corpus[i] for i in sorted(corpus)]
    rows = sum(len(set(fs)) for fs in corpus)
    rng = random.Random(SEED + 4)
    live, topics, qos, pubs, expect = live_load(rng, pools, "workers")
    direct = free_port_block(WORKERS_N + 1)
    port = direct + WORKERS_N
    ports = [direct + i for i in range(WORKERS_N)]
    g = WorkerGroup(
        WORKERS_N, "127.0.0.1", port, direct_base=direct,
        match_service=True, match_view="tpu", match_device=DEVICE,
        match_tpu_opts=dict(
            initial_capacity=1 << (WORKERS_SUBS - 1).bit_length(),
            max_fanout=256, flat_avg=128),
        allow_anonymous=True, systree_enabled=False, sysmon_enabled=False,
        tpu_host_batch_threshold=0,
        watchdog_collector_expiry_budgets=WORKERS_EXPIRY_BUDGETS)
    t0 = time.perf_counter()
    g.start()
    stats = g.stats_block()

    async def until(cond, what: str, limit: float = WORKERS_SETTLE_S):
        deadline = time.monotonic() + limit
        while not cond():
            if time.monotonic() > deadline or not g.service_alive() \
                    or g.alive_count() < WORKERS_N:
                fail(f"workers: {what} within {limit:.0f}s "
                     f"({offcard(stats)}, workers alive {g.alive_count()}, "
                     f"service alive {g.service_alive()})")
            await asyncio.sleep(0.1)

    async def warm_round(clients) -> dict:
        """One QoS 1 publish through every worker (no subscriber); the
        counters after the heartbeats have carried it."""
        for c in clients:
            await c.publish("warm/up", b"w", qos=1, timeout=120)
        await asyncio.sleep(0.6)
        return offcard(stats)

    async def settle(clients, label: str) -> dict:
        """Warm rounds until two in a row reached the service's device
        path with nothing served off the card."""
        deadline = time.monotonic() + WORKERS_SETTLE_S
        stable, before = 0, offcard(stats)
        while stable < 2:
            if time.monotonic() > deadline:
                fail(f"workers: {label} never settled: {offcard(stats)}")
            after = await warm_round(clients)
            clean = (after["batches"] > before["batches"]
                     and after["svc_host"] == before["svc_host"]
                     and after["workers_host"] == before["workers_host"]
                     and after["workers_failed"] == before["workers_failed"])
            stable = stable + 1 if clean else 0
            before = after
        return before

    async def load():
        import socket

        def up():
            try:
                for p in ports + [port]:
                    socket.create_connection(("127.0.0.1", p), 0.5).close()
                return stats.service_info()["heartbeat_age_s"] is not None
            except OSError:
                return False

        await until(up, "the group did not come up")
        t_boot = time.perf_counter() - t0
        warm = [MQTTClient("127.0.0.1", p, client_id=f"warm{i}",
                           keepalive=0) for i, p in enumerate(ports)]
        for c in warm:
            await c.connect(timeout=60)
        # the service's matcher exists before the load, so its table fills
        # in subscription order (as the broker phase's does)
        await settle(warm, "the empty table")
        # one client process per worker, each subscribing the sessions of
        # its worker's direct port
        ctx = multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=bulk_clients,
                             args=(ports[k], stats.name, corpus[k::WORKERS_N],
                                   k, WORKERS_N), daemon=True)
                 for k in range(WORKERS_N)]
        t1 = time.perf_counter()
        for pr in procs:
            pr.start()
        await until(lambda: not any(pr.is_alive() for pr in procs),
                    "the bulk clients did not finish")
        if any(pr.exitcode for pr in procs):
            fail(f"workers: bulk clients exited "
                 f"{[pr.exitcode for pr in procs]}")
        t_sub = time.perf_counter() - t1
        ops0 = offcard(stats)["ops"]
        await until(lambda: stats.service_info()["ops"] >= rows,
                    f"the service did not apply {rows} rows")
        t_load = time.perf_counter() - t1
        base = await settle(warm, "the loaded table")
        t_settle = time.perf_counter() - t1 - t_load
        for c in warm:
            await c.disconnect()
        return t_boot, t_sub, t_load, t_settle, ops0, base

    try:
        t_boot, t_sub, t_load, t_settle, ops0, base = asyncio.run(load())
        print(f"[workers] {card} | {WORKERS_N} workers + 1 match service "
              f"(GPU view on {DEVICE}) up in {t_boot:.1f}s; {len(corpus)} "
              f"persistent sessions subscribed {rows} distinct rows over "
              f"MQTT through the workers' direct ports ({WORKERS_N} client "
              f"processes) in {t_sub:.1f}s "
              f"({ops0} applied by the service by then), all {rows} ring "
              f"ops applied after {t_load:.1f}s (the first {WORKERS_SUBS} "
              f"of the corpus; the single-process broker "
              f"phase: {single['load_s']:.1f}s through "
              f"Registry.subscribe), the loaded table settled on the "
              f"device in {t_settle:.1f}s", flush=True)
        local = SubscriptionTrie()
        for j, (filters, _) in enumerate(live):
            for f in filters:
                local.add(f.split("/"), j, None)
        want = [collections.Counter() for _ in live]
        for i, t in enumerate(topics):
            for _f, j, _v in local.match(t.split("/")):
                want[j][(i % BROKER_PUBLISHERS, i)] += 1
        ctx = multiprocessing.get_context("spawn")
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=broker_clients,
                           args=(port, live, pubs, expect, child),
                           daemon=True)
        proc.start()
        child.close()
        try:
            if not conn.poll(BROKER_WAIT_S + 120):
                fail("workers: the clients did not answer in time")
            conn.recv()  # every live subscription is in place
            time.sleep(1.0)  # their ring ops and replication
            base = offcard(stats)
            conn.send("go")
            if not conn.poll(BROKER_WAIT_S + 120):
                fail("workers: the clients did not finish in time")
            smi = gpu_pids()
            group = {p.pid for p in g._procs} | {proc.pid}
            svc_pid = g._service_proc.pid
            on_card = cuda_context_pids(group | {svc_pid})
            got, acks, wall, _ = conn.recv()
            time.sleep(0.6)  # one more heartbeat of every counter
            after = offcard(stats)
            waits = worker_hist(stats, ("stage_collector_wait_ms",
                                        "stage_ring_rtt_ms"))
        finally:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()
    finally:
        g.stop()
    inversions = check_live(got, want, "workers")
    off = dict(service_host_pubs=after["svc_host"] - base["svc_host"],
               service_fold_errors=after["svc_errors"] - base["svc_errors"],
               worker_host_pubs=[a - b for a, b in zip(
                   after["workers_host"], base["workers_host"])],
               worker_folds_failed=[a - b for a, b in zip(
                   after["workers_failed"], base["workers_failed"])])
    if off["service_host_pubs"] or off["service_fold_errors"] \
            or any(off["worker_host_pubs"]) \
            or any(off["worker_folds_failed"]):
        fail(f"workers: publishes served off the card: {off}")
    folds = after["folds"] - base["folds"]
    batches = after["batches"] - base["batches"]
    if folds <= 0 or batches <= 0:
        fail(f"workers: the service served {folds} folds in {batches} "
             f"device batches")
    # dense and packs are uint32 in the stats block: differences mod 2^32
    launches, ex_launches, dense = forward_counts("workers service", tuple(
        (after[k] - base[k]) % (1 << 32) if k in ("dense", "packs")
        else after[k] - base[k]
        for k in ("tile", "extract", "plain", "dense", "packs")))
    if on_card != {svc_pid}:
        fail(f"workers: processes with a CUDA context {sorted(on_card)}; "
             f"the service is {svc_pid}, workers and clients "
             f"{sorted(group)}")
    from vernemq_tpu_torch.observability import histogram as hist

    wait, rtt = (hist.summary(waits.get(n, ([], 0.0, 0))) for n in
                 ("stage_collector_wait_ms", "stage_ring_rtt_ms"))
    res = live_numbers(got, acks, wall)
    res.update(load_s=t_load, folds=folds, device_batches=batches,
               launches=launches, extract_launches=ex_launches,
               dense_launches=dense,
               wait_p99=wait.get("p99_ms", 0), rtt_p50=rtt.get("p50_ms", 0))
    print(f"[workers] {card} | {BROKER_PUBS} publishes ({sum(qos)} at QoS "
          f"1) from {BROKER_PUBLISHERS} MQTT publishers to {BROKER_LIVE} "
          f"MQTT subscribers through the shared port: "
          f"{res['pubs_per_s']:.0f} publishes/s ({wall:.2f}s; single-process "
          f"broker phase {single['pubs_per_s']:.0f}), PUBLISH->delivery p50 "
          f"{res['lat_p50']:.2f} ms p99 {res['lat_p99']:.2f} ms (single "
          f"{single['lat_p50']:.2f} / {single['lat_p99']:.2f}), QoS 1 PUBACK "
          f"p50 {res['ack_p50']:.2f} ms p99 {res['ack_p99']:.2f} ms (single "
          f"{single['ack_p50']:.2f} / {single['ack_p99']:.2f}); "
          f"{res['deliveries']} deliveries, parity exact for every live "
          f"subscriber, per-publisher order kept at each QoS ({inversions} "
          f"inversions across QoS levels)", flush=True)
    print(f"[workers] {card} | {folds} ring folds served in {batches} "
          f"device batches ({BROKER_PUBS / max(batches, 1):.1f} publishes "
          f"per batch), tile / dense-mode / extraction launches in the "
          f"service {launches} / {dense} / {ex_launches}, plain bit-packs "
          f"0; the workers' queue wait at flush "
          f"start p50 "
          f"{wait.get('p50_ms', 0):.1f} ms p99 {wait.get('p99_ms', 0):.1f} "
          f"ms, ring round trip p50 {rtt.get('p50_ms', 0):.1f} ms p99 "
          f"{rtt.get('p99_ms', 0):.1f} ms over {int(rtt['count'])} folds "
          f"(whole run, log2 buckets; queued-publish expiry "
          f"{WORKERS_EXPIRY_BUDGETS * 50} ms); off the card: {off}; of the "
          f"group's processes "
          f"only the service ({svc_pid}) holds a GPU device node, not the "
          f"workers {sorted(p for p in group if p != proc.pid)} or the "
          f"clients ({proc.pid}) (nvidia-smi lists pids {sorted(smi)}, "
          f"of its own pid namespace)", flush=True)
    return res


# ------------------------------------------------------ retained replay

def synthetic_reverse(torch, TR, N: int, L: int, bits: int, lc: int, T: int,
                      TP: int, seg: int, seed: int, ragged: bool = False,
                      B: int = 1024):
    """Random operands of the reverse-compare kernel on the card and the
    host copy of the window starts: N retained rows of 1..lc levels (~10%
    $-topics, ~10% inactive, pad words past each row's length) over a small
    vocabulary with byte-plane edge ids, and B filters, half copied from
    rows, widened with ``+``, cut to ``#`` prefixes or given unknown words;
    T tiles of TP random query slots (~10% empty) at random window starts,
    with ``ragged`` the first two at 777 and at N - seg."""
    import numpy as np

    rng = np.random.default_rng(seed)
    vocab = np.array([3, 4, 5, 6, 7, 255, 256, 65535]
                     + ([65536, (1 << 24) - 1] if bits == 24 else []),
                     np.int32)
    words = rng.choice(vocab, (N, L)).astype(np.int32)
    row_len = rng.integers(1, lc + 1, N).astype(np.int32)
    words[np.arange(L)[None, :] >= row_len[:, None]] = TR.PAD_ID
    meta = TR.pack_row_meta(row_len, rng.random(N) < 0.1,
                            rng.random(N) < 0.9)
    src = rng.integers(0, N, B)
    qw, qe = words[src].copy(), row_len[src].copy()
    qh = rng.random(B) < 0.25
    qe[qh] = rng.integers(0, qe[qh] + 1)
    fresh = rng.random(B) < 0.5
    qw[fresh] = rng.choice(vocab, (int(fresh.sum()), L))
    qe[fresh] = rng.integers(1, lc + 2, int(fresh.sum()))
    qw[rng.random((B, L)) < 0.2] = TR.PLUS_ID
    qw[rng.random((B, L)) < 0.03] = -2  # UNKNOWN_ID
    qw[np.arange(L)[None, :] >= qe[:, None]] = TR.PAD_ID
    qf = (qw[:, 0] == TR.PLUS_ID) | ((qe == 0) & qh)
    sel = rng.integers(0, B, (T, TP)).astype(np.int32)
    sel[rng.random((T, TP)) < 0.1] = -1  # empty slots
    start = rng.integers(0, N - seg + 1, T).astype(np.int32)
    if ragged:
        start[:2] = [777, N - seg]
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    return (cuda(words), cuda(meta), cuda(qw), cuda(qe.astype(np.int32)),
            TR.query_flags(cuda(qh), cuda(qf)), cuda(sel), cuda(start)), start


def extract_diff(got, want) -> int:
    """The largest absolute difference between two extractions over the
    counts, the validity flags and the indices that either holds valid
    (0 = equal)."""
    gi, gv, gc = got
    wi, wv, wc = want
    either = (gv | wv).long()
    errs = [(gc.long() - wc.long()).abs(), (gv.long() - wv.long()).abs(),
            (gi.long() - wi.long()).abs() * either]
    return max((int(e.max()) for e in errs if e.numel()), default=0)


def extract_bytes(packed, counts, k: int, rows=None, ok=None) -> int:
    """Bytes the extraction must move for this run's data, each input read
    once (a row selected twice is read once): without counts every live
    source row's words, with them those rows' chunk counts and the words of
    every chunk that holds one of a row's first k matches; the row
    selectors and liveness read once (None: not read); idx, valid and the
    count written once."""
    import torch

    R0, W = packed.shape
    R = R0 if rows is None else rows.shape[0]
    src = torch.arange(R0, device=packed.device) if rows is None \
        else rows.long()
    if ok is not None:
        src = src[ok]
    src = torch.unique(src)
    io = (0 if rows is None else R * 4) + (0 if ok is None else R) \
        + R * k * 5 + R * 4
    if counts is None:
        return src.numel() * W * 4 + io
    c = counts.index_select(0, src)
    excl = c.cumsum(dim=1) - c
    chunks = int(((c > 0) & (excl < k)).sum())
    nb = c.shape[1]
    return src.numel() * nb * 4 + chunks * (W // nb) * 4 + io


def reverse_bound(starts, seg: int, lc: int, n_queries: int):
    """(bytes, operations) the reverse compare must move and do for
    ``n_queries`` real queries against windows of ``seg`` rows at
    ``starts``: every distinct window row's lc words and meta read once,
    each query's lc words, eff and flags read once, its packed mask row
    and chunk counts written once; lc + 3 integer operations per (query,
    row) pair (lc level compares, the length rule, the $ rule,
    liveness)."""
    nbytes = (window_rows(starts, seg) * (4 * lc + 4)
              + n_queries * (4 * lc + 8 + seg // 8 + seg // 64))
    return nbytes, float(n_queries) * seg * (lc + 3)


def retained_pools():
    """bench.py config 8's topic words (bench.py:913-915)."""
    return ([f"r{i}" for i in range(64)], [f"d{i}" for i in range(256)],
            [f"m{i}" for i in range(64)])


def storm_filters(rng: random.Random, pools, n: int):
    """bench.py config 8's storm mix as its code draws it (a copy of its
    ``mk_filters``, bench.py:934-947): 85% ``r/+/m``, 10% ``r/d/#``, 5%
    ``+/d/m`` (the dense phase)."""
    l0, l1, l2 = pools
    out = []
    for _ in range(n):
        r = rng.random()
        if r < 0.85:
            out.append((rng.choice(l0), "+", rng.choice(l2)))
        elif r < 0.95:
            out.append((rng.choice(l0), rng.choice(l1), "#"))
        else:
            out.append(("+", rng.choice(l1), rng.choice(l2)))
    return out


def skewed_storm(rng: random.Random, pools, n: int, hot: float = 0.9):
    """The storm mix with its concrete filters skewed to one region: each
    ``r/+/m`` or ``r/d/#`` filter names region ``r0`` with probability
    ``hot`` (a subscribe storm after one site's clients reconnect)."""
    return [(pools[0][0], *f[1:]) if f[0] != "+" and rng.random() < hot
            else f for f in storm_filters(rng, pools, n)]


def skewed_probe(idx, store, pools, card: str, int32_rate: float) -> dict:
    """One skewed-storm batch (:func:`skewed_storm`) through
    ``match_filters``, held to the store; then its probe launch at the
    single tile width ``_prep`` gives every tile (the busiest region's)
    against the same tiles cut to their own widths (the last live slot,
    rounded up to a warp), one launch per width, both bit-equal to the
    plain version. Shows what the one width costs where the regions'
    loads differ most."""
    import numpy as np
    import torch

    from vernemq_tpu_torch.ops import reverse_kernel as TR
    from vernemq_tpu_torch.ops import reverse_tiles as RT

    filters = skewed_storm(random.Random(SEED + 12), pools, BATCH)
    for f, rows in zip(filters, idx.match_filters(filters)):
        want = store.match_filter("", list(f))
        if sorted(want if rows is None else rows) != sorted(want):
            fail(f"retained skewed storm: filter {f} disagrees with the "
                 f"store")
    with idx.lock:
        idx.sync()
        layout = idx._layout_locked()
        enc = idx._encode_locked([tuple(f) for f in filters])
        rw, meta = idx._dev
    a, _, _, _ = idx._prep(layout, *enc, len(filters))
    cuda = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)
    q = (rw, meta, cuda(a["qw"]), cuda(a["qe"]),
         TR.query_flags(cuda(a["qh"]), cuda(a["qf"])))
    seg, lc = a["seg"], a["lc"]
    t_sel, t_start = a["t_sel"], a["t_start"]
    T, TP = t_sel.shape
    live = t_sel >= 0
    width = -(-(TP - np.argmax(live[:, ::-1], axis=1)) // 32) * 32
    groups = {int(w): np.nonzero(width == w)[0] for w in np.unique(width)}
    one = (cuda(t_sel), cuda(t_start))
    cut = {w: (cuda(t_sel[ix, :w]), cuda(t_start[ix]), t_start[ix], ix)
           for w, ix in groups.items()}
    single = RT.reverse_tiles_packed(*q, *one, seg=seg, lc=lc,
                                     start_host=t_start)
    want = RT.reverse_tiles_packed_ref(*q, *one, seg=seg, lc=lc)
    bad = any(mask_diff(g, w) for g, w in zip(single, want))
    for w, (sel, st, st_h, ix) in cut.items():
        got = RT.reverse_tiles_packed(*q, sel, st, seg=seg, lc=lc,
                                      start_host=st_h)
        rows = (torch.from_numpy(ix).to(DEVICE)[:, None] * TP
                + torch.arange(w, device=DEVICE)[None, :]).reshape(-1)
        bad |= any(mask_diff(g, o.index_select(0, rows))
                   for g, o in zip(got, single))
    torch.cuda.synchronize()
    if bad:
        fail("retained skewed storm: the probe launch disagrees with its "
             "plain version or with its per-width launches")
    del single, want
    one_ms = event_ms(lambda: RT.reverse_tiles_packed(
        *q, *one, seg=seg, lc=lc, start_host=t_start), 20)

    def per_width():
        for sel, st, st_h, _ in cut.values():
            RT.reverse_tiles_packed(*q, sel, st, seg=seg, lc=lc,
                                    start_host=st_h)
    cut_ms = event_ms(per_width, 20)
    one_g = graph_ms(lambda: RT.reverse_tiles_packed(
        *q, *one, seg=seg, lc=lc, start_host=t_start), 20)
    cut_g = graph_ms(per_width, 20)
    n_real = int(live.sum())
    nbytes, ops = reverse_bound(t_start[live.any(axis=1)], seg, lc, n_real)
    bound = max(nbytes / HBM_BYTES_PER_S, ops / int32_rate) * 1e3
    hot = int(np.bincount(enc[4][:len(filters)][enc[4][:len(filters)] > 0])
              .max())
    print(f"[retained] {card} | skewed storm (90% of the concrete filters "
          f"in one region, its {hot} queries): probe launch at one width, "
          f"{T} tiles x {TP} slots ({n_real} real queries) x seg {seg}: "
          f"{one_ms:.4f} ms ({one_g:.4f} ms replayed from a CUDA graph); "
          f"the same tiles cut to their own widths ("
          + ", ".join(f"{len(ix)} x {w}" for w, ix in groups.items())
          + f"), {len(groups)} launches: {cut_ms:.4f} ms ({cut_g:.4f} ms "
          f"from a graph); bound "
          f"{bound:.4f} ms; every filter equal to the store, both bit-equal",
          flush=True)
    return dict(one_width_ms=one_ms, per_width_ms=cut_ms,
                one_width_graph_ms=one_g, per_width_graph_ms=cut_g,
                bound_ms=bound,
                tiles=T, slots=TP, queries=n_real, hot_region_queries=hot,
                widths={str(w): len(ix) for w, ix in groups.items()})


def load_retained(rng: random.Random, pools, insert) -> None:
    """RET_N retained inserts of bench.py config 8's topics (bench.py:
    926-930; a topic drawn again replaces its message), each with its own
    payload ``b"<i>"`` (the bench stores one payload for all) so a replay
    that returned another row's message would show."""
    l0, l1, l2 = pools
    for i in range(RET_N):
        insert((rng.choice(l0), rng.choice(l1), rng.choice(l2)),
               b"%d" % i)


def settle_retained(idx) -> None:
    """Wait out the index's background build (the first build included):
    sync until nothing is left to install."""
    from vernemq_tpu_torch.models.matcher import RebuildInProgress

    while True:
        with idx.lock:
            try:
                idx.sync()
                return
            except RebuildInProgress:
                th = idx._rebuild_thread
        if th is not None:
            th.join()


def phase_retained(card: str) -> dict:
    """The retained reverse match at the storm's width: a ``RetainStore``
    whose dirty hook writes through to a ``RetainedIndex`` on the card (the
    production wiring, background first build), RET_N inserts, then
    RET_BATCHES batches of BATCH storm-mix filters through
    ``match_filters`` with every filter held to ``RetainStore.
    match_filter``; then both kernel launches of one batch timed (CUDA
    events) beside their plain version, the bound and the reference's
    coded dense product (fp32 ``torch.matmul``, never called by the port).
    Returns the numbers of the kernels line."""
    import numpy as np
    import torch

    from vernemq_tpu_torch.broker.retain import RetainStore
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import reverse_kernel as TR
    from vernemq_tpu_torch.ops import reverse_tiles as RT
    from vernemq_tpu_torch.retained.index import RetainedIndex

    holder = {}
    store = RetainStore(on_dirty=lambda mp, t, v: holder["idx"].on_retain(
        t, v))
    idx = holder["idx"] = RetainedIndex(
        store, max_levels=8, initial_capacity=1 << (RET_N - 1).bit_length(),
        max_fanout=256, device=DEVICE)
    rng = random.Random(SEED + 8)
    pools = retained_pools()
    t0 = time.perf_counter()
    load_retained(rng, pools, lambda t, v: store.insert("", t, v))
    t_load = time.perf_counter() - t0
    t0 = time.perf_counter()
    settle_retained(idx)  # the async first build, with its warm dispatch
    t_build = time.perf_counter() - t0
    tab = idx.table
    print(f"[retained] {card} | {RET_N} retained inserts ({len(store)} "
          f"distinct topics) through the store's dirty hook in "
          f"{t_load:.1f}s; table S={tab.cap} NB={tab.NB} (dedicated "
          f"{tab.NBD}) widest live region {idx._bucket_max} rows, lc "
          f"{idx._lc}; background first build {t_build:.2f}s (warm "
          f"dispatch {idx.warm_ms:.1f} ms)", flush=True)

    def norm(rows):
        return sorted((t, v) for t, v in rows)

    # the serial host walk (the broker's path without the index)
    host_f = storm_filters(rng, pools, RET_HOST)
    t0 = time.perf_counter()
    host_rows = sum(len(store.match_filter("", list(f))) for f in host_f)
    host_s = time.perf_counter() - t0

    batches = [storm_filters(rng, pools, BATCH) for _ in range(RET_BATCHES)]
    fb0 = idx.host_fallback_queries
    walls, replayed = [], 0
    RT.launches = EX.launches = TK.plain_cuda_extractions = 0
    for b, filters in enumerate(batches):
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        res = idx.match_filters(filters)
        walls.append(time.perf_counter() - t1)
        for f, rows in zip(filters, res):
            want = store.match_filter("", list(f))
            if rows is None:
                rows = want  # a per-filter escape: the host walk answers
            if norm(rows) != norm(want):
                fail(f"retained batch {b}: filter {f} got {len(rows)} rows, "
                     f"the store {len(want)}")
            replayed += len(rows)
    # deltas on the card: retain deletes and new topics through the store,
    # scattered in place (no rebuild), then one more batch held to the store
    builds = idx.rebuilds
    drng = random.Random(SEED + 10)
    topics = [t for t, _ in store.items("")]
    for i in range(RET_DELTA):
        store.delete("", drng.choice(topics))
        store.insert("", (drng.choice(pools[0]), f"d{256 + i % 32}",
                          drng.choice(pools[2])), b"delta%d" % i)
    filters = storm_filters(drng, pools, BATCH)
    for f, rows in zip(filters, idx.match_filters(filters)):
        want = store.match_filter("", list(f))
        if norm(want if rows is None else rows) != norm(want):
            fail(f"retained after deltas: filter {f} disagrees with the "
                 f"store")
    if idx.rebuilds != builds:
        fail("retained: the deltas rebuilt the table instead of "
             "scattering in place")
    print(f"[retained] {card} | {RET_DELTA} retain deletes + {RET_DELTA} new "
          f"topics scattered in place (no rebuild); a batch after them "
          f"equal to the store", flush=True)
    launches, ex_launches = RT.launches, EX.launches
    fallbacks = idx.host_fallback_queries - fb0
    if launches <= 0 or ex_launches <= 0 or TK.plain_cuda_extractions:
        fail(f"retained: a reverse kernel was never launched (compare "
             f"{launches}, extraction {ex_launches}) or a plain extraction "
             f"ran on the card ({TK.plain_cuda_extractions})")
    if idx.device_failures or idx.degraded_sheds:
        fail(f"retained: device failures {idx.device_failures}, degraded "
             f"sheds {idx.degraded_sheds}")
    n_f = RET_BATCHES * BATCH
    dev_s = sum(walls)
    print(f"[retained] {card} | {RET_BATCHES} batches x {BATCH} storm "
          f"filters through match_filters: {n_f / dev_s:.0f} filters/s, "
          f"{replayed / dev_s:.0f} replayed rows/s (batch wall p50 "
          f"{1e3 * float(np.percentile(walls, 50)):.2f} ms, host resolve "
          f"included); the host walk {RET_HOST / host_s:.0f} filters/s, "
          f"{host_rows / host_s:.0f} rows/s; every filter equal to "
          f"RetainStore.match_filter ({replayed} rows); host-fallback "
          f"filters {fallbacks}; compare / extraction kernel launches "
          f"{launches} / {ex_launches} ({launches / (RET_BATCHES + 1):.1f} "
          f"/ {ex_launches / (RET_BATCHES + 1):.1f} per batch over these "
          f"batches and the one after the deltas)", flush=True)

    # where one batch's time goes, then its two launches at the shapes the
    # path gave them
    filters = batches[0]
    t1 = time.perf_counter()
    with idx.lock:
        idx.sync()
        layout = idx._layout_locked()
        idx._enc_cache.clear()  # a cold encode, as a batch of new filters
        enc = idx._encode_locked([tuple(f) for f in filters])
        rw, meta = idx._dev
    t2 = time.perf_counter()
    a, _, _, _ = idx._prep(layout, *enc, len(filters))
    t3 = time.perf_counter()
    calls = []
    for _ in range(5):  # uploads, the device path, one download (a sync)
        t4 = time.perf_counter()
        idx._device_call((rw, meta), a)
        calls.append((time.perf_counter() - t4) * 1e3)
    cuda = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(DEVICE)
    targs = [cuda(a[k]) for k in ("qw", "qe", "qh", "qf", "t_sel")]
    tail = [cuda(a[k]) for k in ("q_tile", "q_pos", "d_sel", "d_valid")]
    path_ms = event_ms(lambda: TR.reverse_match(
        rw, meta, *targs, a["t_start"], *tail, k=a["k"], seg=a["seg"],
        lc=a["lc"]), 10)
    wall_ms = 1e3 * float(np.percentile(walls, 50))
    call_ms = float(np.median(calls))
    print(f"[retained] {card} | where a {BATCH}-filter batch's "
          f"{wall_ms:.1f} ms go: encode under the lock (cold cache) "
          f"{(t2 - t1) * 1e3:.2f} ms, window prep {(t3 - t2) * 1e3:.2f} ms, "
          f"the device call {call_ms:.2f} ms (of it the device path "
          f"{path_ms:.2f} ms by CUDA events: both launches, extraction), "
          f"the rest ~{wall_ms - call_ms - (t3 - t1) * 1e3:.1f} ms (resolving "
          f"~{replayed // RET_BATCHES} replayed rows into Python lists)",
          flush=True)
    qw, qe = cuda(a["qw"]), cuda(a["qe"])
    flags = TR.query_flags(cuda(a["qh"]), cuda(a["qf"]))
    lc, seg, N = a["lc"], a["seg"], rw.shape[0]
    d_valid = cuda(a["d_valid"])
    dsel = TR.dense_selectors(cuda(a["d_sel"]), d_valid)
    zeros = np.zeros(dsel.shape[0], np.int32)
    tiled = a["q_tile"][a["q_tile"] >= 0]
    int32_rate = int32_ops_per_s(torch)
    # (inputs, sizes, host starts, windows of real queries, real queries,
    # the extraction's rows and their liveness)
    q_tile = cuda(a["q_tile"])
    TP = a["t_sel"].shape[1]
    launches_of = {
        "probe": ((rw, meta, qw, qe, flags, cuda(a["t_sel"]),
                   cuda(a["t_start"])), dict(seg=seg, lc=lc),
                  a["t_start"], a["t_start"][np.unique(tiled)], len(tiled),
                  q_tile.clamp(min=0) * TP + cuda(a["q_pos"]), q_tile >= 0),
        "dense": ((rw, meta, qw, qe, flags, dsel, cuda(zeros)),
                  dict(seg=N, lc=lc), zeros, [0], int(a["d_valid"].sum()),
                  torch.arange(len(a["d_sel"]), dtype=torch.int32,
                               device=DEVICE), d_valid)}
    per = {}
    for name, (x, kw, start, real_starts, n_real, rows, ok) in \
            launches_of.items():
        got = RT.reverse_tiles_packed(*x, **kw, start_host=start)
        want = RT.reverse_tiles_packed_ref(*x, **kw)
        torch.cuda.synchronize()
        if any(mask_diff(g, w) for g, w in zip(got, want)):
            fail(f"reverse kernel disagrees with its plain version on the "
                 f"retained {name} launch")
        del want
        k_ms = event_ms(lambda: RT.reverse_tiles_packed(
            *x, **kw, start_host=start), 20)
        kg_ms = graph_ms(lambda: RT.reverse_tiles_packed(
            *x, **kw, start_host=start), 20)
        p_ms = event_ms(lambda: RT.reverse_tiles_packed_ref(*x, **kw), 2)
        ex = RT.extract_chunks(*got, a["k"], rows=rows, ok=ok)
        ex_want = RT.extract_chunks_ref(*got, a["k"], rows=rows, ok=ok)
        ex_err = extract_diff(ex, ex_want)
        if ex_err:
            fail(f"extraction kernel disagrees with its plain version on the "
                 f"retained {name} launch (max abs err {ex_err})")
        e_ms = event_ms(lambda: RT.extract_chunks(*got, a["k"], rows=rows,
                                                  ok=ok), 20)
        eg_ms = graph_ms(lambda: RT.extract_chunks(*got, a["k"], rows=rows,
                                                   ok=ok), 20)
        ep_ms = event_ms(lambda: RT.extract_chunks_ref(
            *got, a["k"], rows=rows, ok=ok), 3)
        e_bytes = extract_bytes(*got, a["k"], rows, ok)
        e_split = EX.split(rows.shape[0], got[0].shape[1], True)
        del got, ex, ex_want
        nbytes, ops = reverse_bound(real_starts, kw["seg"], lc, n_real)
        t_b, t_o = nbytes / HBM_BYTES_PER_S, ops / int32_rate
        fp32_ms = max(t_b, ops / FP32_OPS_PER_S) * 1e3
        per[name] = dict(kernel_ms=k_ms, kernel_graph_ms=kg_ms,
                         plain_ms=p_ms, extract_ms=e_ms,
                         extract_graph_ms=eg_ms,
                         extract_plain_ms=ep_ms, extract_bytes=e_bytes,
                         extract_bound_ms=e_bytes / HBM_BYTES_PER_S * 1e3,
                         extract_err=ex_err, bytes=nbytes,
                         ops=ops, bound_ms=max(t_b, t_o) * 1e3,
                         bound_by="bytes" if t_b >= t_o else "operations",
                         bound_ms_at_fp32_rate=fp32_ms,
                         tiles=int(x[5].shape[0]),
                         slots=int(x[5].shape[1]), seg=kw["seg"],
                         queries=n_real)
        print(f"[retained] {card} | {name} launch: {x[5].shape[0]} tiles x "
              f"{x[5].shape[1]} slots ({n_real} real queries) x seg "
              f"{kw['seg']}, lc {lc}: kernel {k_ms:.4f} ms ({kg_ms:.4f} "
              f"ms replayed from a CUDA graph; the first "
              f"design: {REVERSE_EARLIER_MS[name]} ms, an earlier run's "
              f"number), its bound {per[name]['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {ops / 1e9:.2f} G integer ops at "
              f"{int32_rate / 1e12:.2f} T INT32 ops/s, bound by "
              f"{per[name]['bound_by']}; {fp32_ms:.4f} ms at the "
              f"{FP32_OPS_PER_S / 1e12:.0f} T/s fp32 rate used before), "
              f"{100 * per[name]['bound_ms'] / k_ms:.1f}% of the bound; "
              f"plain {p_ms:.2f} ms; words and counts bit-equal", flush=True)
        print(f"[retained] {card} | {name} extraction: kernel {e_ms:.4f} ms "
              f"({eg_ms:.4f} ms replayed from a CUDA graph; the first "
              f"design: {EXTRACT_EARLIER_MS[name][0]} / "
              f"{EXTRACT_EARLIER_MS[name][1]} ms, an earlier run's numbers), "
              f"{e_split} warp(s) a row, its bound "
              f"{per[name]['extract_bound_ms']:.4f} ms "
              f"({e_bytes / 1e6:.2f} MB by bytes), plain two-level "
              f"{ep_ms:.4f} ms; equal to the plain version", flush=True)
    launch_ms = sum(p["kernel_ms"] for p in per.values())
    extract_ms = sum(p["extract_ms"] for p in per.values())
    print(f"[retained] {card} | the device path {path_ms:.4f} ms by CUDA "
          f"events: launches {launch_ms:.4f} ms (probe "
          f"{per['probe']['kernel_ms']:.4f} + dense "
          f"{per['dense']['kernel_ms']:.4f}), extraction {extract_ms:.4f} ms "
          f"(probe {per['probe']['extract_ms']:.4f} + dense "
          f"{per['dense']['extract_ms']:.4f}), the rest "
          f"{path_ms - launch_ms - extract_ms:.4f} ms (selectors, the "
          f"starts' upload, gaps between launches)", flush=True)
    skew = skewed_probe(idx, store, pools, card, int32_rate)
    # the reference's dense phase as its coded product (the MXU route the
    # port does not take), fp32 on upcast bf16 operands, timed alone
    bits = idx._ops_bits
    G = TR.build_row_operands(rw, bits).to(torch.float32)
    dsel_t = cuda(a["d_sel"]).long()
    F_t, _ = TK.build_operands(qw.index_select(0, dsel_t),
                               qe.index_select(0, dsel_t), bits)
    Fq = F_t.to(torch.float32).t().contiguous()
    lib_ms = event_ms(lambda: torch.matmul(Fq, G), 10)
    shape = f"{tuple(Fq.shape)} @ {tuple(G.shape)}"
    del G, Fq
    torch.cuda.empty_cache()
    print(f"[retained] {card} | the reference's coded dense product "
          f"{shape} as one fp32 torch.matmul (a yardstick the port never "
          f"calls): {lib_ms:.4f} ms", flush=True)
    return dict(launches=launches, extract_launches=ex_launches, per=per,
                library_ms=lib_ms,
                path_ms=path_ms, extract_ms=extract_ms,
                extract_err=max(p["extract_err"] for p in per.values()),
                skewed_probe=skew,
                int32_ops_per_s=int32_rate,
                filters_per_s=n_f / dev_s, rows_per_s=replayed / dev_s,
                host_filters_per_s=RET_HOST / host_s,
                host_fallbacks=fallbacks)


def replay_config():
    """The replay phase's broker: the GPU view and its retained index with
    a table capacity that holds the storm's topics without a growth
    rebuild, and online queues deep enough for a SUBSCRIBE's replay burst
    (the default of 1,000 messages would drop replays that the client has
    not read yet). Everything else — the replay collector's window, batch,
    host threshold, queued-replay expiry and dispatch deadline — is the
    broker's default; no $SYS publisher and no loop-lag sampler (the load
    holds the loop on purpose)."""
    from vernemq_tpu_torch.broker.config import Config

    return Config(allow_anonymous=True, default_reg_view="tpu",
                  systree_enabled=False, sysmon_enabled=False,
                  tpu_retained_initial_capacity=1 << (RET_N - 1).bit_length(),
                  max_online_messages=1 << 20)


def replay_clients(port: int, subs, expect, conn) -> None:
    """The MQTT subscribers of the replay phase, in a process of their own:
    connect every client (``subs``: its filters), say ``"ready"`` and wait
    for a word back, then send every client's one SUBSCRIBE at once and
    take replays until each has its ``expect[j]``, then whatever more
    arrives within half a second. Sends back, per client, the (topic,
    payload, retain) of every message, the seconds from its SUBSCRIBE to
    its last due replay, and the wall from the first SUBSCRIBE to the last
    replay."""
    import asyncio

    from vernemq_tpu_torch.client import MQTTClient

    async def run():
        clients = []
        for j in range(len(subs)):
            c = MQTTClient("127.0.0.1", port, client_id=f"replay{j}",
                           keepalive=0, proto_ver=5 if j % 2 == 0 else 4)
            await c.connect(timeout=60)
            clients.append(c)
        conn.send("ready")
        await asyncio.get_running_loop().run_in_executor(None, conn.recv)
        got = [[] for _ in clients]
        took = [None] * len(clients)

        async def one(j, c):
            t = time.monotonic()
            await c.subscribe(["/".join(f) for f in subs[j]], qos=0,
                              timeout=120)
            while len(got[j]) < expect[j]:
                m = await c.messages.get()
                if m is None:
                    return
                got[j].append((m.topic, bytes(m.payload), bool(m.retain)))
            took[j] = time.monotonic() - t

        t0 = time.monotonic()
        tasks = [asyncio.ensure_future(one(j, c))
                 for j, c in enumerate(clients)]
        _, late = await asyncio.wait(tasks, timeout=RET_WAIT_S)
        for r in late:
            r.cancel()
        wall = time.monotonic() - t0
        await asyncio.sleep(0.5)  # any replay past the due ones
        for j, c in enumerate(clients):
            while not c.messages.empty():
                m = c.messages.get_nowait()
                if m is not None:
                    got[j].append((m.topic, bytes(m.payload),
                                   bool(m.retain)))
        for c in clients:
            await c.disconnect()
        return got, took, wall

    conn.send(asyncio.run(run()))
    conn.close()


def phase_replay(card: str) -> int:
    """Retained replay through the port's broker on the card: RET_N
    retained messages go into the broker's ``RetainStore`` (its dirty hook
    writes through to the GPU retained index, built in the background and
    waited for), then RET_SUBSCRIBERS MQTT clients in a second process
    SUBSCRIBE with storm-mix filters at once; each client's replays, as a
    multiset of (topic, payload, retain), must equal the store's matches
    for its filters, the replay collector's device path must have served
    filters, and no replay may have been degraded, rebuild-served,
    host-resolved per filter, stalled or expired. Returns the reverse
    compare and extraction kernels' launches during the replays."""
    import asyncio
    import collections
    import multiprocessing

    import numpy as np

    from vernemq_tpu_torch.broker.reg import RetainedMsg
    from vernemq_tpu_torch.broker.server import start_broker
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import reverse_tiles as RT

    async def run():
        b, server = await start_broker(replay_config(), port=0,
                                       device=DEVICE)
        try:
            return await drive(b, server.port)
        finally:
            await b.stop()
            await server.stop()

    async def drive(b, port):
        idx = await b.retained_engine().index_async("")  # empty: deltas
        rng = random.Random(SEED + 9)                     # write through
        pools = retained_pools()
        t0 = time.perf_counter()
        load_retained(rng, pools, lambda t, v: b.retain.insert(
            "", t, RetainedMsg(v, {}, 0, None)))
        t_load = time.perf_counter() - t0
        t0 = time.perf_counter()
        settle_retained(idx)
        print(f"[replay] {card} | {RET_N} retained PUBLISH stores through "
              f"the broker's RetainStore ({len(b.retain)} topics) in "
              f"{t_load:.1f}s; GPU retained index built in the background "
              f"in {time.perf_counter() - t0:.2f}s (warm dispatch "
              f"{idx.warm_ms:.1f} ms)", flush=True)
        subs = [storm_filters(rng, pools, RET_FILTERS)
                for _ in range(RET_SUBSCRIBERS)]
        want = []
        for filters in subs:
            c = collections.Counter()
            for f in filters:
                for topic, msg in b.retain.match_filter("", list(f)):
                    c[("/".join(topic), bytes(msg.payload), True)] += 1
            want.append(c)
        expect = [sum(c.values()) for c in want]
        col = b.retained_collector()
        heap = HeapWatch(b.heap, "replay")
        heap.check()
        ctx = multiprocessing.get_context("spawn")
        conn, child = ctx.Pipe()
        proc = ctx.Process(target=replay_clients,
                           args=(port, subs, expect, child), daemon=True)
        proc.start()
        child.close()
        loop = asyncio.get_running_loop()

        async def recv():
            if not await loop.run_in_executor(None, conn.poll,
                                              RET_WAIT_S + 120):
                fail("replay: the clients did not answer in time")
            return await loop.run_in_executor(None, conn.recv)

        try:
            await recv()  # every client connected
            RT.launches = EX.launches = TK.plain_cuda_extractions = 0
            conn.send("go")
            got, took, wall = await recv()
            launches = (RT.launches, EX.launches)
            plain = TK.plain_cuda_extractions
        finally:
            proc.join(30)
            if proc.is_alive():
                proc.kill()
                proc.join()
        for j, (g, w) in enumerate(zip(got, want)):
            have = collections.Counter(g)
            if have != w:
                fail(f"replay: client {j} got {sum(have.values())} replays "
                     f"({len(have - w)} unexpected), the store matches "
                     f"{sum(w.values())} ({len(w - have)} missing)")
        st = col.stats()
        bad = {k: v for k, v in st.items() if v and k.endswith((
            "degraded_filters", "rebuild_filters", "fallback_filters",
            "stalled_filters", "expired_filters"))}
        took = np.array([x for x in took if x is not None]) * 1e3
        if bad or st["retained_replay_device_filters"] <= 0:
            fail(f"replay: device filters "
                 f"{st['retained_replay_device_filters']} in "
                 f"{st['retained_replay_device_batches']} flushes, "
                 f"host-served {bad}; SUBSCRIBE->last replay "
                 f"{np.sort(took).round(1).tolist()} ms; {heap.close()}")
        if min(launches) <= 0 or plain:
            fail(f"replay: a reverse kernel was never launched (compare, "
                 f"extraction: {launches}) or a plain extraction ran on "
                 f"the card ({plain})")
        drops = b.metrics.value("queue_message_drop")
        if drops:
            fail(f"replay: {drops} queue drops")
        n = sum(expect)
        print(f"[replay] {card} | {RET_SUBSCRIBERS} MQTT subscribers "
              f"(v5 and v3.1.1) x one SUBSCRIBE of {RET_FILTERS} storm "
              f"filters at once: {n} retained replays in {wall:.2f}s "
              f"({n / wall:.0f} replays/s), SUBSCRIBE->last replay p50 "
              f"{np.percentile(took, 50):.1f} ms max {took.max():.1f} ms; "
              f"every client's replays equal the store's matches; "
              f"{st['retained_replay_device_batches']} device flushes for "
              f"{st['retained_replay_device_filters']} filters, "
              f"small-flush host-threshold filters "
              f"{st['retained_replay_host_filters']}, degraded / rebuild / "
              f"fallback / stalled / expired 0 (expiry "
              f"{b._collector_expiry_ms():.0f} ms, deadline "
              f"{b._dispatch_deadline_ms():.0f} ms); compare / extraction "
              f"kernel launches {launches[0]} / {launches[1]}; no queue "
              f"drop; {heap.close()}", flush=True)
        return launches

    return asyncio.run(run())


# ------------------------------------------------------- predicate phase


def predicate_engine():
    """bench.py config 13's wiring, built standalone on DEVICE: a
    SchemaRegistry and a FilterEngine with PRED_GT ``$gt(value,T)``
    subscriptions (thresholds spread over 0..99), PRED_AGG
    ``$avg(value,50)`` windows and PRED_CONJ ``$gt&$eq`` conjunctions (host
    escapes), all on ``sensors/+/temp``. Returns the engine, the matched
    rows of one publish and a maker of publish batches."""
    from vernemq_tpu_torch.cluster.metadata import MetadataStore
    from vernemq_tpu_torch.filters.engine import FilterEngine
    from vernemq_tpu_torch.filters.schema_registry import SchemaRegistry
    from vernemq_tpu_torch.protocol.types import SubOpts

    rng = random.Random(SEED + 13)
    sreg = SchemaRegistry(MetadataStore("smoke13"), "smoke13")
    sreg.set_schema("", "sensors/+/temp", "value:number,unit:enum(c|f)")
    eng = FilterEngine(sreg, device_gate=lambda: True, host_threshold=1,
                       window_cap=PRED_WINDOW_CAP, max_pairs=PRED_MAX_PAIRS,
                       device=DEVICE)
    emissions = [0]
    eng.emit = lambda *_a: emissions.__setitem__(0, emissions[0] + 1)
    rows = []
    fw = ("sensors", "+", "temp")
    for i in range(PRED_GT):
        o = SubOpts()
        o.filter_expr = f"$gt(value,{rng.randrange(0, 100)})"
        eng.on_sub_delta("add", "", o)
        rows.append((fw, ("", f"p{i}"), o))
    for i in range(PRED_AGG):
        o = SubOpts()
        o.filter_expr = "$avg(value,50)"
        rows.append((fw, ("", f"a{i}"), o))
    for i in range(PRED_CONJ):
        o = SubOpts()
        o.filter_expr = f"$gt(value,{rng.randrange(0, 50)})&$eq(unit,c)"
        rows.append((fw, ("", f"x{i}"), o))
    sensors = [f"s{i}" for i in range(PRED_SENSORS)]

    def mk_batch():
        items = []
        for _ in range(PRED_BATCH):
            t = ("sensors", rng.choice(sensors), "temp")
            payload = json.dumps({"value": round(rng.uniform(0, 100), 2),
                                  "unit": rng.choice(["c", "f"])}).encode()
            items.append((t, eng.encode("", t, payload)))
        return items

    return eng, rows, mk_batch, emissions


def predicate_bytes(table, acc, feats, pp, agg) -> int:
    """Bytes one dispatch must move: the pair arrays and a verdict byte per
    pair, the fold arrays (slot, publish, field, gate, valid), feats, the
    predicate table, acc read and written, and the [4, W] partials."""
    P, A, W = pp.numel(), agg[0].numel(), acc.shape[0]
    return (9 * P + 17 * A + feats.numel() * 4
            + sum(t.numel() * 4 for t in table) + 3 * 16 * W)


def phase_predicate(card: str) -> dict:
    """The predicate phase on the card at bench config 13's shape: every
    verdict pair of a batch in one dispatch of the hand kernel, beside the
    host evaluator on the same batches; the kernel held against its plain
    version on the run's own inputs; filter_batch against filter_batch_host
    on a fresh batch; the device.predicate outage drill. Returns the
    kernel's numbers for the kernels JSON."""
    import numpy as np
    import torch

    from vernemq_tpu_torch.ops import predicate_kernel as PK
    from vernemq_tpu_torch.robustness import faults

    eng, rows, mk_batch, emissions = predicate_engine()
    per_pub = PRED_GT + PRED_AGG + PRED_CONJ
    print(f"[predicate] {card} | bench.py config 13: {PRED_GT} $gt, "
          f"{PRED_AGG} $avg(value,50), {PRED_CONJ} conjunction "
          f"subscriptions on sensors/+/temp ({PRED_SENSORS} sensors), "
          f"batches of {PRED_BATCH}: {PRED_BATCH * PRED_GT:,} verdict pairs "
          f"and {PRED_BATCH * PRED_AGG:,} folds per dispatch; max_pairs "
          f"{eng.max_pairs:,} (the engine's default of 65,536, which "
          f"bench.py keeps, sends every such batch to the host evaluator)",
          flush=True)
    batches = [mk_batch() for _ in range(PRED_BATCHES)]
    last = []  # the kernel arguments of the latest dispatch
    real_phase = PK.predicate_phase

    def spy(*a, **kw):
        last[:] = [(a, kw)]
        return real_phase(*a, **kw)

    disp_s = []
    real_dispatch = eng._dispatch

    def timed_dispatch(*a, **kw):
        t = time.perf_counter()
        try:
            return real_dispatch(*a, **kw)
        finally:
            disp_s.append(time.perf_counter() - t)

    eng._dispatch = timed_dispatch
    PK.predicate_phase = spy
    try:
        t0 = time.perf_counter()
        eng.filter_batch("", batches[0], [list(rows) for _ in batches[0]])
        first_s = time.perf_counter() - t0
        base = dict(eng.stats(), pairs_device=eng.pairs_device,
                    pairs_escaped=eng.pairs_escaped)
        disp_s.clear()
        wall = []
        PK.launches = 0
        t0 = time.perf_counter()
        for i in range(PRED_REPS):
            b = batches[i % PRED_BATCHES]
            t = time.perf_counter()
            eng.filter_batch("", b, [list(rows) for _ in b])
            wall.append(time.perf_counter() - t)
        dev_s = time.perf_counter() - t0
        launches = PK.launches
    finally:
        PK.predicate_phase = real_phase
        eng._dispatch = real_dispatch
    st = eng.stats()
    n_disp = int(st["predicate_dispatches_total"]
                 - base["predicate_dispatches_total"])
    host_b = int(st["predicate_host_batches"]
                 - base["predicate_host_batches"])
    pairs_dev = eng.pairs_device - base["pairs_device"]
    if n_disp != PRED_REPS or host_b or launches != PRED_REPS \
            or pairs_dev != PRED_REPS * PRED_BATCH * PRED_GT:
        fail(f"predicate: {n_disp} dispatches, {host_b} host batches, "
             f"{launches} launches, {pairs_dev} device pairs in "
             f"{PRED_REPS} batches")
    t0 = time.perf_counter()
    for i in range(PRED_HOST_REPS):
        b = batches[i % PRED_BATCHES]
        eng.filter_batch_host("", b, [list(rows) for _ in b])
    host_s = time.perf_counter() - t0
    dev_rate = PRED_REPS * PRED_BATCH * per_pub / dev_s
    host_rate = PRED_HOST_REPS * PRED_BATCH * per_pub / host_s
    print(f"[predicate] {card} | {PRED_REPS} batches through filter_batch: "
          f"{dev_rate:,.0f} pairs/s ({PRED_REPS * PRED_BATCH / dev_s:,.0f} "
          f"publishes/s, {per_pub} pairs per publish), host evaluator "
          f"(filter_batch_host, the first {PRED_HOST_REPS} of the same "
          f"batches) {host_rate:,.0f} pairs/s: {dev_rate / host_rate:.2f}x; "
          f"{n_disp} device dispatches, {launches} kernel launches, "
          f"{pairs_dev:,} device verdict pairs, 0 host batches, "
          f"{eng.pairs_escaped - base['pairs_escaped']:,} conjunction pairs "
          f"escaped to the host evaluator by design, {emissions[0]} window "
          f"emissions; first batch (table upload, window table growth) "
          f"{first_s * 1e3:.1f} ms", flush=True)

    # ------------------------------------------- kernel against plain
    (a, kw), = last
    table, acc, feats, pp, pr, agg = (a[:6], a[6], a[7], a[8], a[9],
                                      a[10:15])
    W = kw["W"]
    acc0 = acc.clone()
    got = PK.predicate_phase(*table, acc0.clone(), feats, pp, pr, *agg, W=W)
    want = PK.predicate_phase_ref(*table, acc0.clone(), feats, pp, pr, *agg,
                                  W=W)
    torch.cuda.synchronize()
    bits = lambda x: x.contiguous().view(torch.int32)  # noqa: E731
    exact = (torch.equal(got[0], want[0])
             and all(torch.equal(bits(g), bits(w)) for g, w in
                     ((got[2], want[2]), (got[4], want[4]),
                      (got[5], want[5]), (got[1][:, [0, 2, 3]],
                                          want[1][:, [0, 2, 3]]))))
    err = max(float((g.float() - w.float()).abs().masked_fill(
        g.float() == w.float(), 0).nan_to_num(nan=float("inf")).max())
        for g, w in zip(got, want))
    sum_ok = torch.allclose(got[3], want[3], rtol=1e-5, atol=1e-5) and \
        torch.allclose(got[1][:, 1], want[1][:, 1], rtol=1e-5, atol=1e-5)
    P, A = pp.numel(), agg[0].numel()
    print(f"[predicate] {card} | kernel vs plain version on the last "
          f"dispatch's inputs (P={P:,} pairs, A={A:,} folds, W={W}): "
          f"verdicts {'bit-equal' if torch.equal(got[0], want[0]) else 'DIFFER'}"
          f", count/min/max {'bit-equal' if exact else 'DIFFER'}, sums "
          f"{'allclose' if sum_ok else 'DIFFER'} (rtol 1e-5); max_abs_err "
          f"{err:.3g}; {int(got[0].sum()):,} kept, "
          f"{int((got[2] > 0).sum())} slots touched", flush=True)
    if not exact or not sum_ok:
        fail("predicate: the kernel disagrees with its plain version")
    scratch = acc0.clone()
    run = lambda: PK.predicate_phase(  # noqa: E731
        *table, scratch, feats, pp, pr, *agg, W=W)
    k_ms = event_ms(run, 50)
    k_graph = graph_ms(run, 20)
    plain_ms = event_ms(lambda: PK.predicate_phase_ref(
        *table, scratch, feats, pp, pr, *agg, W=W), 3)
    nbytes = predicate_bytes(table, acc, feats, pp, agg)
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    # the split, each part from a CUDA graph beside its own byte bound:
    # the verdict pairs alone (eval_pairs: no folds, no partials), the
    # folds alone (no pair) and both (the dispatch's call)
    fixed = feats.numel() * 4 + sum(t.numel() * 4 for t in table)
    none = pp[:0]
    split = {}
    for part, fn, nb in (
            ("pairs", lambda: PK.eval_pairs(*table, feats, pp, pr),
             9 * P + fixed),
            ("folds", lambda: PK.predicate_phase(
                *table, scratch, feats, none, none, *agg, W=W),
             17 * A + fixed + 3 * 16 * W),
            ("both", run, nbytes)):
        g = graph_ms(fn, 20)
        split[part] = dict(graph_ms=g, bound_ms=nb / HBM_BYTES_PER_S * 1e3,
                           bytes=nb)
    print(f"[predicate] {card} | split from a CUDA graph: " + "; ".join(
        f"{part} {v['graph_ms']:.4f} ms against its bound "
        f"{v['bound_ms']:.4f} ms ({v['bytes'] / 1e6:.2f} MB, "
        f"{100 * v['bound_ms'] / v['graph_ms']:.0f}%)"
        for part, v in split.items()), flush=True)
    # the dispatch's host-side pieces, replayed on the same arrays
    idx_np = torch.cat([pp, pr, *agg[:4]]).cpu().numpy()
    f_np = feats.cpu().numpy()

    def host_ms(fn, n=10):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / n * 1e3

    up_ms = host_ms(lambda: (torch.from_numpy(idx_np).to(DEVICE),
                             torch.from_numpy(f_np).to(DEVICE)))
    out = run()
    down_ms = host_ms(lambda: (out[0].cpu().numpy(), torch.stack(
        out[2:]).cpu().numpy()))
    disp_ms = 1e3 * float(np.mean(disp_s))
    wall_ms = 1e3 * float(np.mean(wall))
    print(f"[predicate] {card} | per dispatch: filter_batch {wall_ms:.1f} "
          f"ms: the host's pair build and row assembly "
          f"{wall_ms - disp_ms:.1f} ms, and _dispatch {disp_ms:.2f} ms, of "
          f"it the upload {up_ms:.3f} ms ({idx_np.nbytes + f_np.nbytes:,} "
          f"bytes), the kernel {k_ms:.4f} ms by CUDA events / "
          f"{k_graph:.4f} ms replayed from a CUDA graph and the download "
          f"{down_ms:.3f} ms, the rest host staging of the index arrays "
          f"and the window commit; kernel bound "
          f"{bound_ms:.4f} ms ({nbytes / 1e6:.2f} MB at "
          f"{HBM_BYTES_PER_S / 1e12:.2f} TB/s: {100 * bound_ms / k_ms:.0f}% "
          f"of it reached by events, {100 * bound_ms / k_graph:.0f}% from "
          f"the graph), plain version {plain_ms:.3f} ms", flush=True)

    # ---------------------------------------- parity and the drill
    pb = mk_batch()
    healthy = eng.filter_batch("", pb, [list(rows) for _ in pb])
    oracle = eng.filter_batch_host("", pb, [list(rows) for _ in pb])
    keys = lambda res: [[r[1] for r in x] for x in res]  # noqa: E731
    if keys(healthy) != keys(oracle):
        fail("predicate: filter_batch != filter_batch_host on a fresh "
             "batch")
    # the drill on a slice of the batch: a dispatch shorter than the
    # breaker's 0.2 s first backoff, so the call after the opening one is
    # refused rather than taken as the half-open probe
    db = pb[:PRED_DRILL]
    d_oracle = keys(oracle[:PRED_DRILL])
    br = eng.breaker
    f0, d0 = eng.device_failures, eng.dispatches
    faults.install(faults.FaultPlan(
        [faults.FaultRule("device.predicate", kind="error")], seed=13))
    try:
        for _ in range(br.failure_threshold):
            if keys(eng.filter_batch("", db, [list(rows) for _ in db])) \
                    != d_oracle:
                fail("predicate: the host did not serve the outage exactly")
        opened = br.state_name
        sheds0 = eng.degraded_sheds
        if keys(eng.filter_batch("", db, [list(rows) for _ in db])) \
                != d_oracle:
            fail("predicate: the host did not serve the open breaker "
                 "exactly")
        sheds = eng.degraded_sheds - sheds0
    finally:
        faults.clear()
    deadline = time.monotonic() + 15.0
    while br.state_name != "closed" and time.monotonic() < deadline:
        time.sleep(0.05)
        if keys(eng.filter_batch("", db, [list(rows) for _ in db])) \
                != d_oracle:
            fail("predicate: a probe batch differs from the host's")
    if opened != "open" or sheds < 1 or br.state_name != "closed" \
            or eng.dispatches <= d0:
        fail(f"predicate: drill breaker {opened} -> {br.state_name}, "
             f"{sheds} sheds, dispatches {d0} -> {eng.dispatches}")
    print(f"[predicate] {card} | filter_batch == filter_batch_host on a "
          f"fresh batch; device.predicate outage: "
          f"{eng.device_failures - f0} failures opened the breaker, the "
          f"host evaluator served {br.failure_threshold + 1} batches of "
          f"{PRED_DRILL} publishes exactly ({sheds} refused while open), the "
          f"probe closed it and "
          f"device dispatches resumed ({eng.dispatches - d0} since)",
          flush=True)
    return dict(launches=launches, max_abs_err=err, ms=k_ms,
                graph_ms=k_graph, plain_ms=plain_ms, bound_ms=bound_ms,
                bytes=nbytes, pairs_per_s=dev_rate,
                host_pairs_per_s=host_rate, dispatches=n_disp, split=split,
                dispatch_ms=disp_ms, filter_batch_ms=wall_ms,
                upload_ms=up_ms, download_ms=down_ms,
                max_pairs=eng.max_pairs)


def synthetic_extract(torch, R0: int, W: int, R, seed: int):
    """A packed mask ``[R0, W]`` made on the card: each row empty, all ones
    or the AND of 1, 2, 7 or 11 random words (bit densities 2^-1 .. 2^-11),
    row 0 empty and the last row all ones; and ``R`` selected rows
    (repeats, out of order, those two first) with ~10% of them dead; every
    row and all live when ``R`` is None."""
    import numpy as np

    rng = np.random.default_rng(seed)
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    ands = rng.choice([0, 1, 2, 7, 11, -1], R0)  # 0: empty, -1: all ones
    ands[0], ands[-1] = 0, -1
    n = torch.from_numpy(ands).to(DEVICE)[:, None]

    def rand():
        return torch.randint(-(1 << 31), 1 << 31, (R0, W), generator=gen,
                             device=DEVICE, dtype=torch.int64) \
            .to(torch.int32)

    packed = rand()
    for j in range(1, int(ands.max())):
        packed = torch.where(n > j, packed & rand(), packed)
    packed = torch.where(n == 0, 0, torch.where(n < 0, -1, packed))
    if R is None:
        return packed, None, None
    rows = rng.integers(0, R0, R).astype(np.int32)
    rows[:2] = [R0 - 1, 0][:R]
    ok = rng.random(R) < 0.9
    ok[:2] = True
    cuda = lambda a: torch.from_numpy(a).to(DEVICE)
    return packed, cuda(rows), cuda(ok)


def phase_extract_kernel(compiled: bool):
    """The extraction kernel against its plain version at every
    EXTRACT_SHAPES entry (idx where valid, valid, count: bit for bit), each
    timed beside its bound; with ``compiled`` (this run built the library)
    its ptxas report. Returns ``(largest difference, {template: (registers,
    spill stores, spill loads)} or None)``."""
    import torch

    from vernemq_tpu_torch.ops import _build
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import reverse_tiles as RT

    err_max = 0
    for i, (name, R0, W, k, with_counts, R) in enumerate(EXTRACT_SHAPES):
        packed, rows, ok = synthetic_extract(torch, R0, W, R, SEED + 40 + i)
        counts = RT.chunk_counts(packed) if with_counts else None
        kw = dict(rows=rows, ok=ok, counts=counts)
        got = EX.extract_rows(packed, k, **kw)
        want = EX.extract_rows_ref(packed, k, **kw)
        torch.cuda.synchronize()
        err = extract_diff(got, want)
        count = want[2]
        over, empty = int((count > k).sum()), int((count == 0).sum())
        if err or not over or (R != 1 and not empty):
            fail(f"extraction kernel disagrees with its plain version at "
                 f"{name} (max abs err {err})" if err else f"extraction "
                 f"case {name} is vacuous: {over} rows past k, {empty} "
                 f"empty")
        err_max = max(err_max, err)
        del got, want
        ms = event_ms(lambda: EX.extract_rows(packed, k, **kw), 10)
        g_ms = graph_ms(lambda: EX.extract_rows(packed, k, **kw), 10)
        bound = extract_bytes(packed, counts, k, rows, ok) \
            / HBM_BYTES_PER_S * 1e3
        n = R0 if R is None else R
        print(f"[kernel] extract {name}: {n} of {R0} rows x W {W} words, k "
              f"{k}, {EX.split(n, W, with_counts)} warp(s) a row; rows past "
              f"k {over}, empty or dead {empty}; idx, valid and count "
              f"max_abs_err {err}; {ms:.4f} ms by events, {g_ms:.4f} ms "
              f"from a CUDA graph, bound {bound:.4f} ms "
              f"({100 * bound / g_ms:.1f}% from the graph)", flush=True)
        del packed, rows, ok, counts
    torch.cuda.empty_cache()
    ptxas = None
    if compiled:
        ptxas = ptxas_kernels(_build.log_path("extract").read_text(),
                              ("extract_kernelILb0E", "extract_kernelILb1E"))
        ptxas = {("counts" if "Lb1E" in n else "no counts"): v
                 for n, v in ptxas.items()}
        print("[build] ptxas extract_kernel (template: registers, spill "
              "stores, spill loads): " + ", ".join(
                  f"{n}: {v}" for n, v in sorted(ptxas.items())), flush=True)
    return err_max, ptxas


def phase_reverse_kernel(compiled: bool):
    """The reverse-compare kernel against its plain version at every
    REVERSE_SHAPES entry, packed words and chunk counts bit for bit; with
    ``compiled`` (this run built the library) its ptxas report. Each shape
    is timed beside its bound, a spilling template also at its neighbour
    that does not spill (SPILL_NEIGHBOUR). Returns ``(largest difference,
    {lc template: (registers, spill stores, spill loads, shared memory
    bytes per block at TP 32, at TP 256)} or None)``."""
    import torch

    from vernemq_tpu_torch.ops import _build
    from vernemq_tpu_torch.ops import reverse_kernel as TR
    from vernemq_tpu_torch.ops import reverse_tiles as RT

    reverse_err = 0
    int32_rate = int32_ops_per_s(torch)
    for i, (name, N, L, bits, lc, T, TP, seg, ragged) in \
            enumerate(REVERSE_SHAPES):
        x, start_host = synthetic_reverse(torch, TR, N, L, bits, lc, T, TP,
                                          seg, SEED + 20 + i, ragged)
        n_live = int((x[5] >= 0).sum())
        timed = []
        # a template that spills (SPILL_NEIGHBOUR) also runs at its
        # neighbour that does not: per compare, does the spill cost time?
        for lc_i in (lc, SPILL_NEIGHBOUR.get(lc)):
            if lc_i is None:
                continue
            got = RT.reverse_tiles_packed(*x, seg=seg, lc=lc_i,
                                          start_host=start_host)
            want = RT.reverse_tiles_packed_ref(*x, seg=seg, lc=lc_i)
            torch.cuda.synchronize()
            err = max(mask_diff(got[0], want[0]), mask_diff(got[1], want[1]))
            ones = int(want[1].sum())
            del got, want
            ms = event_ms(lambda: RT.reverse_tiles_packed(
                *x, seg=seg, lc=lc_i, start_host=start_host), 5)
            nbytes, ops = reverse_bound(start_host, seg, lc_i, n_live)
            bound = max(nbytes / HBM_BYTES_PER_S, ops / int32_rate) * 1e3
            timed.append(f"lc {lc_i}: {ms:.4f} ms, bound {bound:.4f} ms "
                         f"({100 * bound / ms:.1f}%), "
                         f"{ms * 1e9 / ops:.3f} ps per operation")
            print(f"[kernel] reverse {name}: N={N} L={L} lc={lc_i} "
                  f"T={T}x{TP} seg={seg} starts {start_host[:2].tolist()}"
                  f"... set bits {ones} words and counts max_abs_err {err}",
                  flush=True)
            if err or not ones:
                fail(f"reverse kernel disagrees with its plain version at "
                     f"{name} lc {lc_i}" if err else f"no matches at reverse "
                     f"{name}: comparison is vacuous")
            reverse_err = max(reverse_err, err)
        print(f"[kernel] reverse {name} timed ({n_live} live slots, CUDA "
              f"events, bound at {int32_rate / 1e12:.2f} T INT32 ops/s): "
              + "; ".join(timed), flush=True)
        del x
        torch.cuda.empty_cache()
    reverse_ptxas = None
    if compiled:
        reverse_ptxas = ptxas_report(
            _build.log_path("reverse_match").read_text(),
            "reverse_match_kernel")
        print("[build] ptxas reverse_match (lc template: registers, spill "
              "stores, spill loads): " + ", ".join(
                  f"{lc}: {v}" for lc, v in sorted(reverse_ptxas.items())),
              flush=True)
        smem = _build.load("reverse_match").reverse_match_smem_bytes
        reverse_ptxas = {lc: (*v, smem(lc, 32), smem(lc, 256))
                         for lc, v in reverse_ptxas.items()}
        print("[build] reverse_match dynamic shared memory per block (lc "
              "template: bytes at TP 32, at TP 256): " + ", ".join(
                  f"{lc}: {v[3]}, {v[4]}"
                  for lc, v in sorted(reverse_ptxas.items())), flush=True)
    torch.cuda.empty_cache()
    return reverse_err, reverse_ptxas


def run_alone(card: str, phase: str, repeat: int) -> int:
    """``--phase`` ``broker`` (with ``[admin]`` and ``[plugins]``),
    ``cluster`` or ``replay`` on its own, ``repeat`` times after the
    kernels' build:
    each run passes or fails as in the whole script. Exits non-zero if
    any run failed, and prints no ``ok`` line."""
    from vernemq_tpu_torch.ops import _build

    _build.build(["tile_match", "extract", "reverse_match", "predicate"])
    passed = 0
    for i in range(repeat):
        t0 = time.perf_counter()
        try:
            if phase == "broker":
                phase_broker(card, HEADLINE_S)
            elif phase == "replay":
                phase_replay(card)
            else:
                phase_cluster(card, {"pubs_per_s": float("nan")})
            passed += 1
            verdict = "passed"
        except SystemExit:
            verdict = "FAILED"
        release(card, f"after {phase} run {i + 1}")
        print(f"[alone] {card} | {phase} run {i + 1} of {repeat} {verdict} "
              f"in {time.perf_counter() - t0:.1f}s", flush=True)
    print(f"[alone] {card} | {phase}: {passed} of {repeat} runs passed",
          flush=True)
    return 0 if passed == repeat else 1


def main(argv=()) -> int:
    import argparse

    import torch

    ap = argparse.ArgumentParser(description="chip smoke run of the port")
    ap.add_argument("--phase", choices=("broker", "cluster", "replay"),
                    help="run this serving phase alone (no ok line)")
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs of --phase")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from vernemq_tpu_torch.models.matcher import GpuRegView
    from vernemq_tpu_torch.models.trie import SubscriptionTrie
    from vernemq_tpu_torch.ops import _build
    from vernemq_tpu_torch.ops import extract as EX
    from vernemq_tpu_torch.ops import match_kernel as TK
    from vernemq_tpu_torch.ops import tile_match as TM

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    if args.phase:
        return run_alone(card, args.phase, args.repeat)

    # ---------------------------------------------------------------- build
    t0 = time.perf_counter()
    libs = ["tile_match", "extract", "reverse_match", "predicate"]
    built = _build.build(libs)  # one nvcc per source, all at once
    print(f"[build] {', '.join(libs)}: built {built or 'none (up to date)'} "
          f"in {time.perf_counter() - t0:.1f}s "
          f"({', '.join(str(_build.lib_path(n)) for n in libs)})",
          flush=True)
    # registers and spills only from a compile of this run: an older log
    # need not describe the library that is loaded
    ptxas = ptxas_report(_build.log_path("tile_match").read_text()) \
        if "tile_match" in built else {}
    if "predicate" in built:
        print("[build] ptxas predicate (registers, spill stores, spill "
              "loads): " + ", ".join(f"{k}: {v}" for k, v in ptxas_kernels(
                  _build.log_path("predicate").read_text(),
                  ("predicate_pass_kernelILb1E", "predicate_pass_kernelILb0E",
                   "predicate_merge_kernel")
              ).items()), flush=True)
    phase_cold(card)

    # ------------------------------------------------------- kernel phase
    kernel_err = 0
    launched_kp = set()  # compiled widths KP the run launched
    for i, (name, bits, L, S, T, TP, seg, mode, opts, gp) in \
            enumerate(KERNEL_SHAPES):
        opts = dict(opts)
        row_base = opts.pop("row_base", 0)
        x, start_host = synthetic_probe(torch, TK, bits, L, S, T, TP, seg,
                                        SEED + i, **opts)
        kw = dict(seg_max=seg, glob_pad=gp, mode=mode, row_base=row_base)
        got = TM.window_tiles_packed(*x, **kw, start_host=start_host)
        want = TM.window_tiles_packed_ref(*x, **kw)
        torch.cuda.synchronize()
        err = mask_diff(got, want)
        hits = TK._popcount(want).sum(dim=2)
        ones = int(hits.sum())
        long_hits = int(hits[x[5] > L].sum())
        launched_kp.add(TM.padded_k(x[0].shape[0]))
        print(f"[kernel] {name}: mode {mode} T={T} TP={TP} seg={seg} "
              f"glob_pad={gp} row_base={row_base} K={x[0].shape[0]} set "
              f"bits {ones} (publishes "
              f"longer than L: {long_hits}) max_abs_err {err}", flush=True)
        if err or not ones:
            fail(f"kernel disagrees with its plain version at {name}"
                 if err else f"no matches at {name}: comparison is vacuous")
        if opts.get("long_pubs") and not long_hits:
            fail(f"no match of a publish longer than L at {name}")
        kernel_err = max(kernel_err, err)
        del x, got, want
    torch.cuda.empty_cache()
    extract_err, extract_ptxas = phase_extract_kernel("extract" in built)
    reverse_err, reverse_ptxas = phase_reverse_kernel(
        "reverse_match" in built)

    # ---------------------------------------------------------- path phase
    t0 = time.perf_counter()
    rng = random.Random(SEED)
    reg = Registry(SubscriptionTrie)
    trie = reg.trie("")
    corpus = []

    def add(f, key):
        reg.add(f, key)
        corpus.append((f, key))

    pools = build_corpus(rng, N_SUBS, add)
    # the breaker's backoff is short for the breaker drill (phase 8)
    view = GpuRegView(reg, max_levels=8,
                      initial_capacity=1 << (N_SUBS - 1).bit_length(),
                      max_fanout=256, flat_avg=128, device=DEVICE,
                      breaker_backoff_initial=DRILL_BACKOFF,
                      breaker_backoff_max=DRILL_BACKOFF)
    m = view.matcher("")
    warm = zipf_topics(rng, pools, BATCH)
    view.fold_batch("", warm)  # first build + first use of every op
    torch.cuda.synchronize()
    t_setup = time.perf_counter() - t0
    tab = m.table
    path_S = int(tab.cap)
    print(f"[path] {N_SUBS} subscriptions, table S={tab.cap} "
          f"K={m._operands[0].shape[0]} glob_pad={m._glob_pad} "
          f"gb_end={m._gb_end} NB={tab.NB} NG={tab.NG} "
          f"set-up {t_setup:.1f}s (of it the first build's warm "
          f"dispatch {m.warm_ms:.1f} ms)", flush=True)

    def drive(n_batches: int, label: str):
        lat = []
        for b in range(n_batches):
            topics = zipf_topics(rng, pools, BATCH)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            rows = view.fold_batch("", topics)
            torch.cuda.synchronize()
            lat.append((time.perf_counter() - t1) * 1e3)
            for topic, got in list(zip(topics, rows))[:PARITY_PUBS]:
                want = trie.match(list(topic))
                if sorted((f, str(k)) for f, k, _ in got) != \
                        sorted((f, str(k)) for f, k, _ in want):
                    fail(f"{label} batch {b}: topic {topic} got "
                         f"{len(got)} rows, trie {len(want)}")
        return lat

    fb0 = m.host_fallbacks
    reset_counts()
    lat = drive(BATCHES, "path")
    path_launches, path_ex, path_dense = forward_counts("path")
    if m.host_fallbacks != fb0:
        fail(f"{m.host_fallbacks - fb0} publishes fell back to the host")
    print(f"[path] {BATCHES} batches x {BATCH}: parity exact on "
          f"{PARITY_PUBS} publishes per batch, tile / dense-mode / "
          f"extraction launches {path_launches} / {path_dense} / {path_ex}, "
          f"plain extractions and bit-packs on the card 0, host fallbacks "
          f"0", flush=True)

    # --------------------------------------------------------- delta phase
    drng = random.Random(SEED + 1)
    for f, key in drng.sample(corpus, DELTA):
        reg.remove(f, key)
        view.on_delta("remove", "", f, key, None)
    l0, l1, l2 = pools
    for i in range(DELTA):
        f = [drng.choice(l0), drng.choice(l1), drng.choice(l2)]
        f[drng.randrange(3)] = drng.choice(["+", f[0]])
        reg.add(f, f"delta{i}")
        view.on_delta("add", "", f, f"delta{i}", None)
    rebuilt = settle_sync(m)  # a region may have outgrown the table
    reset_counts()
    drive(2, "delta")
    delta_counts = forward_counts("delta")
    if m.host_fallbacks != fb0:
        fail("delta phase: host fallbacks")
    print(f"[delta] -{DELTA}/+{DELTA} subscriptions synced ({rebuilt} "
          f"background rebuilds); parity exact, tile / dense-mode / "
          f"extraction launches {delta_counts[0]} / {delta_counts[2]} / "
          f"{delta_counts[1]}", flush=True)

    # -------------------------------------------------------------- timing
    topics = zipf_topics(rng, pools, BATCH)
    t1 = time.perf_counter()
    with m.lock:
        m.sync()
        enc = m._encode_batch_ex(topics)
        args, statics, left = m._flat_prep(
            m._layout_locked(), int(tab.cap), *enc, len(topics))
    prep_ms = (time.perf_counter() - t1) * 1e3
    F_t, t1d = m._operands
    _w, eff, hh, fw, act = m._dev_arrays
    flags = TM.row_flags(hh, fw, act)
    cuda = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(DEVICE)
    G_all = TK.build_pub_operand(cuda(args[0]), statics["id_bits"])
    pl, pd = cuda(args[1]), cuda(args[2]).to(torch.int32)
    launched_kp.add(TM.padded_k(F_t.shape[0]))
    probes = []
    uses = []  # the batch's extractions: (name, packed mask, rows, ok)
    for name, sel, start, seg, mode, tile, pos in (
            ("A", args[4], args[5], statics["seg_max"], "a", args[8],
             args[9]),
            ("B", args[6], args[7], statics["seg2_max"], "b", args[10],
             args[11])):
        if not seg:
            continue
        inputs = (F_t, t1d, eff, flags,
                  *TM.tile_operands(G_all, pl, pd, cuda(sel)), cuda(start))
        kw = dict(seg_max=seg, glob_pad=statics["glob_pad"], mode=mode)
        got = TM.window_tiles_packed(*inputs, **kw, start_host=start)
        want = TM.window_tiles_packed_ref(*inputs, **kw)
        torch.cuda.synchronize()
        if mask_diff(got, want):
            fail(f"kernel disagrees with its plain version on path probe "
                 f"{name}")
        tile = cuda(tile)
        uses.append((f"probe {name}", got.reshape(-1, got.shape[2]),
                     tile.clamp(min=0) * sel.shape[1] + cuda(pos),
                     tile >= 0))
        del got, want
        kernel_ms = event_ms(lambda: TM.window_tiles_packed(
            *inputs, **kw, start_host=start), 20)
        plain_ms = event_ms(
            lambda: TM.window_tiles_packed_ref(*inputs, **kw), 3)
        Gt = inputs[4].to(torch.float32)
        rows = cuda(start).long()[:, None] \
            + torch.arange(seg, device=DEVICE)[None, :]
        Fw = F_t.to(torch.float32)[:, rows].permute(1, 0, 2).contiguous()
        bmm_ms = event_ms(lambda: torch.bmm(Gt, Fw), 10)
        del Fw, rows
        nbytes, flop = probe_bound(inputs, seg)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flop / BF16_FLOP_PER_S) * 1e3
        probes.append(dict(name=name, T=int(sel.shape[0]), seg=seg,
                           kernel_ms=kernel_ms, plain_ms=plain_ms,
                           bmm_ms=bmm_ms, bytes=nbytes, flop=flop,
                           bound_ms=bound_ms))
        print(f"[time] {card} | probe {name} T={sel.shape[0]} "
              f"TP={sel.shape[1]} seg={seg}: kernel {kernel_ms:.4f} ms "
              f"({flop / kernel_ms / 1e9:.1f} TFLOP/s, "
              f"{100 * bound_ms / kernel_ms:.1f}% of its bound "
              f"{bound_ms:.4f} ms: {nbytes / 1e6:.1f} MB, "
              f"{flop / 1e9:.1f} GFLOP), plain {plain_ms:.3f} ms, fp32 bmm "
              f"yardstick {bmm_ms:.3f} ms", flush=True)
    k_ms = sum(p["kernel_ms"] for p in probes)
    k_flop = sum(p["flop"] for p in probes)
    nbytes = sum(p["bytes"] for p in probes)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, k_flop / BF16_FLOP_PER_S
    batch_bound_ms = max(t_bytes, t_ops) * 1e3
    print(f"[time] {card} | tile kernel per batch (probes A + B): "
          f"{k_ms:.4f} ms ({k_flop / k_ms / 1e9:.1f} TFLOP/s, "
          f"{100 * batch_bound_ms / k_ms:.1f}% of its bound "
          f"{batch_bound_ms:.4f} ms), fp32 bmm yardstick "
          f"{sum(p['bmm_ms'] for p in probes):.3f} ms (the CUDA-core "
          f"kernel of the first slice, not timed here: {EARLIER_MS} ms)",
          flush=True)
    dense = time_dense_region0(card, F_t, t1d, eff, hh, fw, act, flags,
                               cuda(args[0]), G_all, pl, pd, statics)
    uses.append(("dense region 0", dense.pop("packed"), None, None))
    k = statics["k"]
    ext = {}
    for name, packed, rows, ok in uses:
        kw = dict(rows=rows, ok=ok)
        err = extract_diff(EX.extract_rows(packed, k, **kw),
                           EX.extract_rows_ref(packed, k, **kw))
        if err:
            fail(f"extraction kernel disagrees with its plain version on "
                 f"the path's {name} (max abs err {err})")
        nbytes = extract_bytes(packed, None, k, rows, ok)
        R = packed.shape[0] if rows is None else rows.shape[0]
        ext[name] = dict(
            ms=event_ms(lambda: EX.extract_rows(packed, k, **kw), 20),
            graph_ms=graph_ms(lambda: EX.extract_rows(packed, k, **kw), 20),
            plain_ms=event_ms(lambda: EX.extract_rows_ref(packed, k, **kw),
                              3),
            bytes=nbytes, bound_ms=nbytes / HBM_BYTES_PER_S * 1e3,
            max_abs_err=err, rows=R, R0=packed.shape[0], W=packed.shape[1],
            split=EX.split(R, packed.shape[1], False))
        e = ext[name]
        print(f"[time] {card} | extraction {name}: {R} rows of "
              f"{tuple(packed.shape)} words, k {k}, {e['split']} warp(s) a "
              f"row: kernel {e['ms']:.4f} ms ({e['graph_ms']:.4f} ms from a "
              f"CUDA graph), its bound {e['bound_ms']:.4f} ms "
              f"({nbytes / 1e6:.1f} MB by bytes; the graph's launch at "
              f"{100 * e['bound_ms'] / e['graph_ms']:.1f}% of it), plain "
              f"{e['plain_ms']:.3f} ms; idx where valid, valid and count "
              f"bit-equal", flush=True)
    del uses
    torch.cuda.empty_cache()
    ex_ms = sum(e["ms"] for e in ext.values())
    ex_graph_ms = sum(e["graph_ms"] for e in ext.values())
    print(f"[time] {card} | extraction per batch (probes A + B, dense region "
          f"0): {ex_ms:.4f} ms by events, {ex_graph_ms:.4f} ms from a CUDA "
          f"graph, bound {sum(e['bound_ms'] for e in ext.values()):.4f} ms, "
          f"plain {sum(e['plain_ms'] for e in ext.values()):.3f} ms; "
          f"{path_ex} launches in the {BATCHES} fold_batch batches",
          flush=True)
    for kp in sorted(launched_kp):
        regs, st_b, ld_b = ptxas.get(kp, (None, None, None))
        print(f"[build] ptxas tile_match_kernel<KP={kp}> (launched): "
              f"{regs} registers, {st_b} bytes spill stores, {ld_b} bytes "
              f"spill loads", flush=True)
    # the window starts (args[5], args[7]) stay on the host
    host = [cuda(a) for a in args[:3]] + [int(args[3]), cuda(args[4]),
                                          args[5], cuda(args[6]), args[7]] \
        + [cuda(a) for a in args[8:]]
    packs0, dense0 = TK.plain_cuda_packs, TM.dense_launches
    flat_ms = event_ms(lambda: TK.match_extract_windowed_flat(
        F_t, t1d, eff, hh, fw, act, *host, **statics), 5)
    print(f"[time] {card} | device path per batch (dense region 0, both "
          f"probes, extraction, flat compaction): {flat_ms:.2f} ms (dense "
          f"region 0 packed by plain PyTorch and extracted by the kernel, an "
          f"earlier run: {PATH_EARLIER_MS_PLAIN_DENSE} ms; with the plain "
          f"extraction too: {PATH_EARLIER_MS} ms)", flush=True)
    profile_device_path(torch, lambda: TK.match_extract_windowed_flat(
        F_t, t1d, eff, hh, fw, act, *host, **statics), card, flat_ms)
    if TK.plain_cuda_packs != packs0 or TM.dense_launches == dense0:
        fail(f"device path: {TK.plain_cuda_packs - packs0} plain bit-packs "
             f"on the card, {TM.dense_launches - dense0} dense-mode "
             f"launches")
    print(f"[profile] {card} | the device path ran dense region 0 in "
          f"{TM.dense_launches - dense0} dense-mode tile launches and no "
          f"plain bit-pack (_pack_mask) on the card", flush=True)
    lat_s = sorted(lat)
    p50 = float(np.percentile(lat_s, 50))
    p99 = float(np.percentile(lat_s, 99))
    print(f"[time] {card} | batch of {BATCH} through fold_batch: p50 "
          f"{p50:.2f} ms p99 {p99:.2f} ms over {len(lat)} batches "
          f"(host resolve included)", flush=True)
    print(f"[time] {card} | host encode + window prep per batch: "
          f"{prep_ms:.2f} ms", flush=True)

    mesh = phase_mesh(card, reg, view, rng, pools)

    # ------------------------------------------------- the serving layer
    burst_launches, burst_ex, burst_dense = phase_burst(view, m, trie, rng,
                                                        pools, card)
    churn_launches, churn_ex, churn_dense = phase_churn(view, m, trie, reg,
                                                        rng, pools, card)
    phase_many(view, m, rng, pools, card)
    tools = phase_tools(view, m, trie, rng, pools, card)
    phase_breaker(view, m, trie, rng, pools)
    phase_rebuild(SubscriptionTrie, card)
    # the path phases' registry, view and operands are done with: the
    # processes and phases that follow find the card's memory and this
    # process's heap as a run of those phases alone would
    view.close()
    reg = trie = view = m = corpus = topics = tab = host = lat = None
    F_t = t1d = eff = hh = fw = act = flags = G_all = pl = pd = None
    release(card, "after the path phases")
    broker = phase_broker(card, path_S)
    cluster = phase_cluster(card, broker)
    workers = phase_workers(card, broker)
    pred = phase_predicate(card)
    ret = phase_retained(card)
    replay_launches = phase_replay(card)

    kernels = [{
        "name": "tile_match",
        "route": "cuda",
        "source": "vernemq_tpu_torch/csrc/tile_match.cu",
        "replaces": "vernemq_tpu/ops/pallas_match.py:117",
        "launches": path_launches,
        "collector_launches": burst_launches,
        "churn_launches": churn_launches,
        "broker_launches": broker["launches"],
        "admin_drill_launches": broker["admin"]["drill_launches"],
        "cluster_launches": cluster["node_launches"],
        "dense_launches": path_dense,
        "launches_per_path": {
            "path": path_launches, "mesh": mesh["tile"],
            "mesh_legacy": mesh["legacy_tile"],
            "plugins": broker["plugins"]["launches"],
            "tools_captured": tools["captured"]["tile"]},
        "dense_launches_per_path": {
            "path": path_dense, "burst": burst_dense, "churn": churn_dense,
            "broker": broker["dense_launches"],
            "cluster": cluster["node_dense_launches"],
            "workers": workers["dense_launches"], "mesh": mesh["dense"],
            "mesh_legacy": mesh["legacy_dense"],
            "tools_captured": tools["captured"]["dense"]},
        "tools": {k: tools[k] for k in (
            "fit_a_ms", "fit_b_ms", "graph_ms", "bound_ms", "latency",
            "seconds")},
        "mesh": {k: mesh[k] for k in (
            "per_shard", "local_launches", "ms", "single_ms", "fold_p50_ms",
            "delta_ms", "seconds")},
        "dense_region0": {k: dense[k] for k in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bound_by", "bytes",
            "flop", "max_abs_err", "T", "TP", "seg")},
        "max_abs_err": max(kernel_err, dense["max_abs_err"]),
        "ms": k_ms,
        "plain_ms": sum(p["plain_ms"] for p in probes),
        "bound_ms": batch_bound_ms,
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
        "bmm_yardstick_ms": sum(p["bmm_ms"] for p in probes),
        "bit_equal": kernel_err == 0,
        "design": "mma.sync",
        "tflops": k_flop / k_ms / 1e9,
        "per_probe": {p["name"]: {k: p[k] for k in (
            "kernel_ms", "bound_ms", "plain_ms", "bmm_ms")} for p in probes},
        "ptxas": {str(kp): ptxas.get(kp) for kp in sorted(launched_kp)}
        if "tile_match" in built else None,
        "per_batch": f"probe A + probe B launches of one {BATCH}-publish "
                     f"batch; dense_region0: the dense-mode launch of the "
                     f"same batch",
        "admin": broker["admin"],
        "cluster": {k: cluster[k] for k in (
            "pubs_per_s", "lat_local_p50", "lat_cross_p50", "lat_p99",
            "cross_node", "trie_folds", "replication_s", "seconds")},
    }, {
        "name": "reverse_match",
        "route": "cuda",
        "source": "vernemq_tpu_torch/csrc/reverse_match.cu",
        "replaces": "vernemq_tpu/ops/reverse_kernel.py:229",
        "launches": ret["launches"],
        "replay_launches": replay_launches[0],
        "max_abs_err": reverse_err,
        "ms": sum(p["kernel_ms"] for p in ret["per"].values()),
        "plain_ms": sum(p["plain_ms"] for p in ret["per"].values()),
        "bound_ms": sum(p["bound_ms"] for p in ret["per"].values()),
        "bound_by": max(ret["per"].values(),
                        key=lambda p: p["bound_ms"])["bound_by"],
        "library_ms": ret["library_ms"],
        "design": "lane = query: up to 256 queries per tile against 1024-row "
                  "spans staged once, ~9 instructions per pair at lc 3, "
                  "per-256-row match counts beside the words",
        "graph_ms": sum(p["kernel_graph_ms"] for p in ret["per"].values()),
        "extraction_ms": ret["extract_ms"],
        "device_path_ms": ret["path_ms"],
        "bound_rate": f"INT32 lanes {ret['int32_ops_per_s']:.4g} ops/s "
                      f"(64 per SM per clock at the max SM clock)",
        "bound_ms_at_fp32_rate": sum(p["bound_ms_at_fp32_rate"]
                                     for p in ret["per"].values()),
        "ptxas": {str(lc): v for lc, v in sorted(reverse_ptxas.items())}
        if reverse_ptxas is not None else None,
        "bit_equal": reverse_err == 0,
        "per_launch": ret["per"],
        "skewed_probe": ret["skewed_probe"],
        "filters_per_s": ret["filters_per_s"],
        "replayed_rows_per_s": ret["rows_per_s"],
        "host_walk_filters_per_s": ret["host_filters_per_s"],
        "host_fallback_filters": ret["host_fallbacks"],
        "per_batch": f"probe + dense launches of one {BATCH}-filter "
                     f"retained batch; library_ms: the reference's coded "
                     f"dense product as one fp32 torch.matmul",
    }, {
        "name": "extract",
        "route": "cuda",
        "source": "vernemq_tpu_torch/csrc/extract.cu",
        "replaces": "vernemq_tpu/ops/match_kernel.py:225 (extract_indices_"
                    "packed, as vernemq_tpu/ops/pallas_match.py:172, "
                    "match_kernel.py:531 and :556 and reverse_kernel.py:194, "
                    ":224 and :269 call it)",
        "launches": path_ex,
        "launches_per_path": {
            "path": path_ex, "burst": burst_ex, "churn": churn_ex,
            "broker": broker["extract_launches"],
            "plugins": broker["plugins"]["extract_launches"],
            "cluster": cluster["node_extract_launches"],
            "workers": workers["extract_launches"],
            "retained": ret["extract_launches"],
            "replay": replay_launches[1], "mesh": mesh["extract"],
            "mesh_legacy": mesh["legacy_extract"],
            "tools_captured": tools["captured"]["extract"]},
        "max_abs_err": max(extract_err, ret["extract_err"],
                           max(e["max_abs_err"] for e in ext.values())),
        "ms": ex_ms,
        "graph_ms": ex_graph_ms,
        "plain_ms": sum(e["plain_ms"] for e in ext.values()),
        "bound_ms": sum(e["bound_ms"] for e in ext.values()),
        "bound_by": "bytes",
        "library_ms": None,
        "design": "lane = 256-column chunk, 4 groups of 32 chunks in flight "
                  "a warp as 16-byte loads, popcounts and a shuffle scan; "
                  "long rows split over up to 8 warps of a block with the "
                  "spans' totals scanned in shared memory; the first k "
                  "positions emitted in parallel (binary search over the "
                  "group's word ranks, popcount select) and written "
                  "coalesced; counts optional",
        "per_use": {**{n: {k: e[k] for k in (
            "ms", "graph_ms", "plain_ms", "bound_ms", "bytes", "rows", "W",
            "split", "max_abs_err")} for n, e in ext.items()},
            **{f"retained {n}": {
                "ms": p["extract_ms"], "graph_ms": p["extract_graph_ms"],
                "plain_ms": p["extract_plain_ms"],
                "bound_ms": p["extract_bound_ms"],
                "bytes": p["extract_bytes"],
                "max_abs_err": p["extract_err"]}
               for n, p in ret["per"].items()}},
        "ptxas": extract_ptxas,
        "per_batch": f"probe A + probe B + dense region 0 extractions of one "
                     f"{BATCH}-publish batch; per_use adds the retained "
                     f"probe and dense extractions of one {BATCH}-filter "
                     f"batch",
    }, {
        "name": "predicate_phase",
        "route": "cuda",
        "source": "vernemq_tpu_torch/csrc/predicate.cu",
        "replaces": "vernemq_tpu/ops/predicate_kernel.py:137",
        "launches": pred["launches"],
        "max_abs_err": pred["max_abs_err"],
        "ms": pred["ms"],
        "plain_ms": pred["plain_ms"],
        "bound_ms": pred["bound_ms"],
        "bound_by": "bytes",
        "library_ms": None,
        "graph_ms": pred["graph_ms"],
        "split": pred["split"],
        "design": PREDICATE_DESIGN,
        "pairs_per_s": pred["pairs_per_s"],
        "host_pairs_per_s": pred["host_pairs_per_s"],
        "dispatches": pred["dispatches"],
        "dispatch_ms": pred["dispatch_ms"],
        "filter_batch_ms": pred["filter_batch_ms"],
        "max_pairs": pred["max_pairs"],
        "per_batch": f"one dispatch of a {PRED_BATCH}-publish batch: "
                     f"{PRED_BATCH * PRED_GT} verdict pairs and "
                     f"{PRED_BATCH * PRED_AGG} folds (bench.py config 13)",
    }]
    print(f"[done] {time.perf_counter() - t_start:.1f}s total", flush=True)
    print(json.dumps({"kernels": kernels}))
    print(card)  # as nvidia-smi prints it: name, power limit
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
