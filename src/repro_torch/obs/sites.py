"""The observability site registry — the single source of truth for
every metric, span, and flight-recorder event name in the tree.

Instrumentation sites must pass one of these names as a string LITERAL
(`obs.record("put.ack_us", ...)`, `obs.span("daemon.put_many")`,
`obs.event("wb.degraded_enter", ...)`): the `metric_site` lint rule
(`repro_torch.devtools.rules`) cross-checks every call site against
`METRIC_SITES` exactly the way `fault_site` polices
`faults.FAULT_SITES`, so a typo'd or unregistered name is a CI failure,
not a silently-empty time series. The Prometheus-dump CI gate
(`scripts/check_metrics_dump.py`) closes the loop from the other side:
every `HISTOGRAM_SITES` name must appear in the exported dump.

Naming convention: `<stage>.<what>`, histograms suffixed with their
unit (`_us` = microseconds).
"""
from __future__ import annotations

# Latency histograms (log-spaced fixed buckets, p50/p99/p999).
HISTOGRAM_SITES = frozenset({
    "put.ack_us",                  # daemon PUT path: submit -> durable ack
    "put.journal_sync_us",         # spill-journal group-commit at the ack point
    "get.sms_sweep_us",            # grouped SMS sweep stage of a GET batch
    "get.cos_fallback_us",         # one demand COS chunk-fetch task
    "get.decode_batch_us",         # one ready-order decode_many batch
    "daemon.queue_wait_us",        # a daemon task's wait: submit -> start
    "daemon.get_us",               # daemon host time of one GET batch
    "recovery.session_us",         # one _recover call: detection to resumption
    "wb.persist_us",               # one background COS writeback PUT
    "rpc.roundtrip_us",            # parent->worker RPC, send to reply
    "transport.heartbeat_age_us",  # pong age sampled at each heartbeat tick
})

# Trace spans (per-op, stitched across threads and processes).
SPAN_SITES = frozenset({
    "client.put_many",             # frontend submission (root)
    "client.get_many",             # frontend submission (root)
    "leader.2pc",                  # cross-shard two-round commit, leader side
    "daemon.put_many",             # client-daemon PUT execution
    "daemon.get_many",             # client-daemon GET execution
    "daemon.2pc_prepare",          # round 1 on a participant shard
    "daemon.2pc_commit",           # round 2 on a participant shard
    "ec.encode",                   # RS encode_many of a batch's fragments
    "get.cos_fallback",            # demand COS chunk fetch (I/O executor)
    "get.decode",                  # ready-order decode_many batch
    "wb.persist",                  # background COS write of one chunk
    "recovery.session",            # one _recover call: detection to resumption
    "journal.append",              # one spill-journal record build+write
    "journal.sync",                # spill-journal durability barrier
})

# Flight-recorder events (state transitions; mirrored to the mmap ring).
EVENT_SITES = frozenset({
    "store.open",                  # a store/worker came up (forensics anchor)
    "wb.degraded_enter",           # writeback flipped into DEGRADED_WRITEBACK
    "wb.degraded_heal",            # COS healed, queue draining again
    "transport.suspect",           # heartbeat aged past suspect_after_s
    "transport.down",              # worker declared DOWN
    "transport.reconnect",         # epoch-fenced reconnect succeeded
    "epoch.bump",                  # worker accepted a new connection epoch
    "2pc.indoubt_resolved",        # an in-doubt ticket rolled forward/back
    "fault.fire",                  # deterministic fault plane fired an action
    "shard.restart",               # parent rebuilt a (crashed) shard
})

# The one manifest the lint rule reads (mirrors faults.FAULT_SITES).
# Keep this literal — the AST scan collects the string constants.
METRIC_SITES = frozenset({
    "put.ack_us",
    "put.journal_sync_us",
    "get.sms_sweep_us",
    "get.cos_fallback_us",
    "get.decode_batch_us",
    "daemon.queue_wait_us",
    "daemon.get_us",
    "recovery.session_us",
    "wb.persist_us",
    "rpc.roundtrip_us",
    "transport.heartbeat_age_us",
    "client.put_many",
    "client.get_many",
    "leader.2pc",
    "daemon.put_many",
    "daemon.get_many",
    "daemon.2pc_prepare",
    "daemon.2pc_commit",
    "ec.encode",
    "get.cos_fallback",
    "get.decode",
    "wb.persist",
    "recovery.session",
    "journal.append",
    "journal.sync",
    "store.open",
    "wb.degraded_enter",
    "wb.degraded_heal",
    "transport.suspect",
    "transport.down",
    "transport.reconnect",
    "epoch.bump",
    "2pc.indoubt_resolved",
    "fault.fire",
    "shard.restart",
})

# the big literal and the per-kind registries must agree — import-time
# check so a name added to one place cannot silently miss the other
assert METRIC_SITES == HISTOGRAM_SITES | SPAN_SITES | EVENT_SITES, \
    "METRIC_SITES out of sync with HISTOGRAM/SPAN/EVENT_SITES"
assert not (HISTOGRAM_SITES & SPAN_SITES & EVENT_SITES)
