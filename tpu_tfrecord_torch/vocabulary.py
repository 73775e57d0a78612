"""The metric and span name registry: one owner for every counter, stage,
gauge and span name the package emits.

Copy of ``tpu_tfrecord/vocabulary.py`` (stdlib only, imports nothing of
the package). Every literal name at a ``METRICS.count`` / ``add`` /
``gauge`` / ``observe``, ``timed``, ``telemetry.span`` / ``instant`` /
``record_span`` call site of ``tpu_tfrecord_torch`` is registered here,
under the JAX name: a dashboard keyed on a name reads the same series from
either package. The port emits no name the JAX registry lacks, so the
tables are the JAX ones; a port-only name would be registered here too.

Kinds mirror the three storage classes of ``metrics.Metrics`` plus spans:

- **counters**: monotonic ``Metrics.count`` events;
- **stages**: ``Metrics.add`` / ``timed`` throughput totals (and latency
  histograms), including the ``Metrics.observe``-only histogram families;
- **gauges**: ``Metrics.gauge`` instantaneous values;
- **spans**: ``telemetry.span`` / ``instant`` / ``record_span`` trace names.

Names formed at run time are covered by ``DYNAMIC_PREFIXES`` (the
autotuner's ``autotune.<knob>`` gauges) and ``DERIVED_SUFFIXES`` (the
``<stage>.errors`` counters ``timed`` mints, the pulse's ``<counter>.delta``
fields). ``vocabulary_markdown`` renders the tables as the README block.
"""

from __future__ import annotations

from typing import Dict, Iterable, Optional

__all__ = [
    "COUNTERS",
    "STAGES",
    "GAUGES",
    "SPANS",
    "DYNAMIC_PREFIXES",
    "DERIVED_SUFFIXES",
    "KINDS",
    "is_registered",
    "registered_names",
    "vocabulary_markdown",
    "VOCABULARY_BEGIN",
    "VOCABULARY_END",
]


#: Monotonic event counters (``Metrics.count``): name -> what one tick means.
COUNTERS: Dict[str, str] = {
    # -- read path robustness
    "read.corrupt_records": "corrupt frames skipped by salvage",
    "read.resyncs": "salvage re-locked onto a valid frame boundary",
    "read.retries": "transient read errors retried (incl. remote resume)",
    "read.skipped_shards": "shards dropped by on_corrupt/on_stall=skip_shard",
    "read.stalls": "reads converted to StallError by the deadline",
    "read.deadline_misses": "per-read deadlines that fired",
    "read.hedges": "straggler hedge opens issued",
    "read.hedge_wins": "hedge backup finished before the primary",
    "read.watchdog_restarts": "silent decode workers replaced",
    "read.backpressure_waits": "producer blocked on a full prefetch queue",
    # -- remote (HTTP) ingestion
    "remote.bad_range": "lying/unparseable Content-Range rejected",
    "remote.fetch_retries": "remote block fetches resumed on a fresh conn",
    # -- write path
    "write.commit_retries": "shard commit rename retried",
    "write.backpressure_waits": "encoder blocked on the committer",
    # -- columnar epoch cache
    "cache.hits": "shards served from a validated cache entry",
    "cache.misses": "shards decoded from ground truth",
    "cache.bytes_written": "bytes committed into cache entries",
    "cache.evictions": "entries removed by the LRU sweep",
    "cache.corrupt_fallbacks": "corrupt/stale entries fallen back to decode",
    "cache.populate_errors": "cache populate jobs aborted (epoch unaffected)",
    # -- autotune / telemetry plumbing
    "autotune.adjustments": "controller knob moves",
    "pulse.observer_errors": "pulse observers that raised (swallowed)",
    "pulse.tick_errors": "pulse ticks that raised (swallowed)",
    # -- fleet spool
    "fleet.spool_writes": "telemetry snapshots landed in the spool",
    "fleet.spool_errors": "snapshot attempts that failed (never raise)",
    # -- data service
    "service.registrations": "workers registered with the dispatcher",
    "service.fetches": "shard streams served by workers",
    "service.bytes_sent": "chunk bytes sent by workers",
    "service.chunks_sent": "chunks sent by workers",
    "service.chunks_recv": "chunks received by consumers",
    "service.shards_served": "shard streams completed by workers",
    "service.shards_done": "shard completions recorded by the dispatcher",
    "service.reconnects": "consumer stream reconnects",
    "service.redelivered_dropped": "duplicate chunks deduped by consumers",
    "service.lease_reassignments": "expired leases re-routed",
    "service.fallbacks": "consumers degraded to local reads",
    "service.journal_errors": "dispatcher journal writes that failed",
    "service.worker_drained": "workers that completed a graceful drain",
    "service.cache_served": "worker shard streams served from warm cache",
    "service.tenants": "distinct dataset fingerprints served",
    "service.shared_cache_hits": "shard completions that rode another job's cache",
    # -- HA: partitioned dispatchers + warm-standby failover
    "service.failovers": "standby promotions to acting primary",
    "service.fenced_writes": "journal appends rejected by the inode fence (zombie primary)",
    "service.demotions": "primaries that stopped granting leases (journal failures / fenced)",
    "service.not_primary_rejects": "lease-path ops refused by a standby or demoted primary",
    # -- elastic fleet scaler
    "elastic.scale_ups": "decode workers spawned by the scaler",
    "elastic.scale_downs": "drains initiated by the scaler",
    "elastic.drains": "workers that said goodbye after draining",
    "elastic.drained_leases": "unstarted leases handed back by drain victims",
    "elastic.spawn_errors": "worker spawns that failed",
    "elastic.step_errors": "scaler control-loop ticks that raised",
    "elastic.verdict_errors": "fleet verdict reads that failed (not idle)",
    "elastic.census_errors": "scaler ticks skipped on an unreadable partition status",
    # -- training flight recorder
    "train.steps": "completed harness train steps",
    # -- async checkpointing (snapshot/commit split)
    "ckpt.bytes_written": "checkpoint bytes committed to disk",
    "ckpt.generations_swept": "retired/dead checkpoint generations removed",
    # -- streamed serving (pipeline inference mode + the serving tier)
    "serve.requests": "generation requests completed by the serving tier",
    "serve.rejected": "requests shed at admission (queue full / draining)",
    "serve.deadline_expired": "requests dropped by their deadline (admission or in flight)",
    "serve.disconnects": "client connections lost mid-request (slots freed)",
    "serve.ticks": "continuous-batching scheduler ticks (microbatches packed)",
    "serve.errors": "serving engine ticks / completion callbacks that raised",
    "elastic.replicas_lost": "serving replicas that died undrained (SIGKILL/crash)",
}

#: Throughput stages (``Metrics.add``/``timed``) and observe-only histogram
#: families. Every entry grows records/bytes/seconds totals and (when
#: timed/observed) a latency histogram.
STAGES: Dict[str, str] = {
    "read": "raw shard bytes into the decoder",
    "read.open": "shard open (every open seam)",
    "read.io": "slab reads off the store",
    "decode": "TFRecord frame -> columnar batch",
    "h2d": "host batch -> device transfer",
    "batch.wait": "consumer blocked waiting for a batch",
    "batch": "consumer-side batch assembly",
    "write": "rows -> TFRecord shards (whole pipeline)",
    "write.encode": "example encode (native/python)",
    "write.compress": "per-slab codec compression",
    "write.io": "shard appends",
    "write.commit": "shard finalize + rename",
    "cache.open": "cache entry open + first-pass verification",
    "cache.serve": "mmap-served cached chunks",
    "cache.commit": "cache entry footer + rename",
    "train.step": "whole train step (latency histogram + spans)",
    "train.data_wait": "train step blocked in next(it)",
    "train.h2d": "train step host->device transfer",
    "train.compute": "train step device compute",
    "train.ckpt": "train step checkpoint writes",
    "ckpt.snapshot": "checkpoint snapshot (caller-thread device_get + copy)",
    "ckpt.commit": "checkpoint commit (background stage+fsync+rename)",
    "ckpt.commit_wait": "save() blocked on the previous in-flight commit",
    # dimensionless in-jit model diagnostics (histograms of fractions —
    # telemetry.DIMENSIONLESS_HIST_PREFIXES keeps them out of ms renderers)
    "moe.dropped_fraction": "tokens dropped at expert capacity (fraction)",
    "moe.gate_entropy": "router gate entropy per step",
    "moe.expert_imbalance": "max/mean routed tokens across experts",
    "pipeline.bubble_fraction": "pipeline schedule idle-tick fraction",
    "pipeline.bubble_fraction_v": "interleaved (V>1) schedule bubble fraction",
    # streamed serving: real latency histograms (not dimensionless)
    "serve.latency": "one serving request, admission -> last token",
    "serve.queue_wait": "one request's admission queue wait, admission -> first pack",
    "serve.service": "one request's service time, first pack -> last token",
}

#: Instantaneous gauges (``Metrics.gauge``): last write wins.
GAUGES: Dict[str, str] = {
    "prefetch.queue_depth": "prefetch queue fill (items)",
    "prefetch.occupancy": "EMA of prefetch queue fill fraction (verdict input)",
    "read.inflight_workers": "decode workers currently busy",
    "write.occupancy": "EMA of writer slab-queue fill (write verdict input)",
    "write.inflight_slabs": "slabs in flight in the write pipeline",
    "elastic.workers": "decode worker processes the scaler believes live",
    "elastic.replicas": "serving replicas the serving scaler believes active",
    "serve.queue_depth": "serving admission queue fill (requests waiting to start)",
    "serve.in_flight": "requests riding the serving pipeline right now",
    "service.partition": "partition index this process serves (or routes to)",
    "train.share.data_wait": "windowed share of step wall in data wait",
    "train.share.h2d": "windowed share of step wall in h2d",
    "train.share.compute": "windowed share of step wall in compute",
    "train.share.ckpt": "windowed share of step wall in checkpointing",
    "ckpt.inflight": "background checkpoint commits in flight (0 or 1)",
    "pack.density": "fraction of emitted packed tokens that are real (bin modes)",
    "lm.fsdp_param_bytes": "per-device at-rest param bytes under the fsdp layout",
    "moe.dropped_fraction": "latest per-step dropped-token fraction",
    "moe.gate_entropy": "latest per-step router gate entropy",
    "moe.expert_imbalance": "latest per-step expert imbalance",
    "pipeline.bubble_fraction": "latest per-step pipeline bubble fraction",
    "pipeline.bubble_fraction_v": "latest interleaved (V>1) bubble fraction",
}

#: Trace span / instant names (``telemetry.span``/``instant``/
#: ``record_span``; the flight-recorder and Perfetto vocabulary).
SPANS: Dict[str, str] = {
    "open": "one shard open",
    "read": "one guarded read region",
    "decode": "one chunk decode (shard-attributed)",
    "batch": "one consumer batch get",
    "write.encode": "one slab encode",
    "write.compress": "one slab compression",
    "write.io": "one slab append",
    "write.commit": "one shard commit",
    "cache.open": "one cache entry open",
    "cache.serve": "one cached chunk serve",
    "cache.commit": "one cache entry commit",
    "service.serve": "one worker shard stream",
    "train.step": "one train step (phase-decomposed)",
    "train.verdict": "windowed training verdict instant",
    "read.stall": "a read deadline fired",
    "read.retry": "a read retry was granted",
    "read.hedge": "a straggler hedge was issued",
    "read.hedge_win": "a hedge backup won",
    "watchdog_restart": "a silent worker was replaced",
    "autotune.adjust": "an autotune knob move",
    "elastic.decision": "a fleet scaler decision",
    "elastic.drain": "a drain was initiated",
    "elastic.drain_complete": "a worker finished draining",
    "service.fallback": "a consumer degraded to local reads",
    "service.lease_reassigned": "an expired lease was re-routed",
    "service.failover": "a standby took over a partition (or adopted its address)",
    "service.demoted": "a primary stopped granting leases",
    # request-scoped tracing (client-minted TraceContext over the wire)
    "serve.request": "one serving request, admission -> completion (root span)",
    "serve.queue_wait": "one request waiting for its first pack (child of serve.request)",
    "serve.tick": "one scheduler tick's slice of one request (child of serve.request)",
    "serve.shed": "a request was shed at admission (instant)",
    "serve.deadline_expired": "a request's deadline fired (instant)",
    "service.lease": "one consumer shard lease, route -> eof (root span)",
    "service.route": "dispatcher routed a shard to a worker (instant, lease-linked)",
}

#: Prefixes under which names are formed at runtime and cannot be
#: enumerated statically: kind -> (prefix, what varies).
DYNAMIC_PREFIXES: Dict[str, Dict[str, str]] = {
    "gauge": {
        "autotune.": "one gauge per tuned knob (workers, prefetch, ...)",
        "train.share.": "one gauge per train phase",
        "train.mesh.": "one gauge per mesh axis (extent)",
        "slo.": "SLO engine state per objective kind (budget remaining, window burns)",
    },
    "stage": {
        "train.": "one stage per train phase",
    },
}

#: Suffixes derived mechanically from any registered name: ``timed`` mints
#: ``<stage>.errors`` counters, the pulse emits ``<counter>.delta`` fields.
DERIVED_SUFFIXES = (".errors", ".delta")

KINDS: Dict[str, Dict[str, str]] = {
    "counter": COUNTERS,
    "stage": STAGES,
    "gauge": GAUGES,
    "span": SPANS,
}


def is_registered(name: str, kind: Optional[str] = None) -> bool:
    """Is ``name`` a registered vocabulary entry of ``kind`` (any kind when
    None)? Derived ``.errors``/``.delta`` spellings of a registered name
    and names under a registered dynamic prefix count as registered."""
    kinds = [kind] if kind is not None else list(KINDS)
    for k in kinds:
        if name in KINDS[k]:
            return True
        for prefix in DYNAMIC_PREFIXES.get(k, ()):
            if name.startswith(prefix):
                return True
    for suffix in DERIVED_SUFFIXES:
        if name.endswith(suffix) and is_registered(name[: -len(suffix)], None):
            return True
    return False


def registered_names(kind: Optional[str] = None) -> Iterable[str]:
    """Every explicitly registered name (dynamic prefixes excluded), for
    the docs-drift check."""
    if kind is not None:
        return sorted(KINDS[kind])
    out = set()
    for table in KINDS.values():
        out.update(table)
    return sorted(out)


# -- README generation -------------------------------------------------------

VOCABULARY_BEGIN = "<!-- graftlint:vocabulary:begin (generated; run python -m tools.graftlint --vocab-md) -->"
VOCABULARY_END = "<!-- graftlint:vocabulary:end -->"

_KIND_TITLES = (
    ("counter", "Counters (`Metrics.count`)"),
    ("stage", "Stages & histograms (`Metrics.add`/`timed`/`observe`)"),
    ("gauge", "Gauges (`Metrics.gauge`)"),
    ("span", "Spans & instants (`telemetry.span`/`instant`)"),
)


def vocabulary_markdown() -> str:
    """The generated README vocabulary block, between the BEGIN and END
    markers: the JAX package's block, character for character."""
    lines = [VOCABULARY_BEGIN, ""]
    for kind, title in _KIND_TITLES:
        lines.append(f"**{title}**")
        lines.append("")
        lines.append("| name | meaning |")
        lines.append("| --- | --- |")
        for name in sorted(KINDS[kind]):
            lines.append(f"| `{name}` | {KINDS[kind][name]} |")
        dyn = DYNAMIC_PREFIXES.get(kind, {})
        for prefix in sorted(dyn):
            lines.append(f"| `{prefix}*` | {dyn[prefix]} |")
        lines.append("")
    lines.append(
        "Derived spellings: any registered name + `.errors` (counter "
        "`timed` mints on a failed block) or `.delta` (per-interval pulse "
        "field) is also registered."
    )
    lines.append("")
    lines.append(VOCABULARY_END)
    return "\n".join(lines)
