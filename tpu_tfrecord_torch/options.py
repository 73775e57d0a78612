"""Typed, validated read/write options.

Copy of ``tpu_tfrecord/options.py`` for the options the port has:
``RecordType`` with the reference's exact spellings, and
``TFRecordOptions``, parsed and validated once by ``from_map``, the
stall-defence, watchdog, pulse, autotune, epoch-cache, trace,
telemetry-export, fleet-spool, data-service and elastic-fleet options
included. An option the port does not have raises, naming itself, rather
than being dropped.
"""

from __future__ import annotations

import difflib
import enum
import os
from dataclasses import dataclass, replace
from typing import Any, Dict, Mapping, Optional

from tpu_tfrecord_torch import wire
from tpu_tfrecord_torch.schema import StructType


class RecordType(enum.Enum):
    EXAMPLE = "Example"
    SEQUENCE_EXAMPLE = "SequenceExample"
    BYTE_ARRAY = "ByteArray"

    @staticmethod
    def parse(value: "RecordType | str | None") -> "RecordType":
        """Parse with the reference's exact accepted spellings and default
        (``Example``; unknown value -> error, ref DefaultSource.scala:67-68)."""
        if value is None or value == "":
            return RecordType.EXAMPLE
        if isinstance(value, RecordType):
            return value
        for rt in RecordType:
            if rt.value == value:
                return rt
        raise ValueError(
            f"Unsupported recordType {value}: recordType can be ByteArray, "
            "Example or SequenceExample"
        )


class OptionNotPortedError(NotImplementedError):
    """An option of the JAX package that the port does not have yet."""


def refuse_mesh(name: str) -> None:
    """Raise for a mesh-placement entry point of the JAX package that the
    port does not have yet: of the models, the DLRM and ``long_doc`` are
    placed over a mesh of ranks (their ``param_shardings``), the LM's
    placements are not."""
    raise OptionNotPortedError(
        f"{name}: not ported yet: of the models, the port places the DLRM and long_doc "
        "over a device mesh, not the LM (ROADMAP.md, Queue A item 8)"
    )


@dataclass(frozen=True)
class TFRecordOptions:
    """All knobs of a read or write, validated at construction.

    - record_type: Example | SequenceExample | ByteArray
    - codec: None | gzip | deflate | zstd | snappy | lz4 | bzip2 (write
      side; reads infer it from the file extension)
    - schema: optional user StructType (skips inference)
    - verify_crc: check record CRCs on read
    - infer_sample_limit: records scanned per file by schema inference
      (None = the whole file, the reference's behaviour)
    - write_workers: encode/compress threads of the write pipeline (1 =
      the sequential path)
    - num_shards: round-robin one task's output over this many shard
      streams per partition directory; setting it engages the slab
      pipeline even at write_workers=1, so the output bytes are a function
      of the data and options, never of the worker count
    - max_records_per_shard: roll a stream over to a new file after this
      many records
    - on_corrupt: ``raise`` (default), ``skip_record`` (resync past each
      bad frame, bounded per shard by ``max_corrupt_records``) or
      ``skip_shard`` (drop the rest of a shard at its first corruption)
    - max_corrupt_records: per-shard quota of corrupt regions under
      ``skip_record`` (None = unlimited); past it, ``corrupt_fallback``
    - corrupt_fallback: ``raise`` (default) or ``skip_shard``
    - write_retries: retries of the writer's commit-side filesystem
      operations (shard open, rename into place, ``_SUCCESS``)
    - read_deadline_ms / open_deadline_ms: deadline of each shard read /
      open (None = off); a miss raises ``stall.DeadlineError`` (an
      OSError, so read retries apply), counted in ``read.stalls`` and
      ``read.deadline_misses``
    - hedge_after_ms: after this long without bytes, a backup open + read
      of the same range starts; the first answer wins (the bytes are the
      same either way). Counted in ``read.hedges`` / ``read.hedge_wins``
    - on_stall: ``raise`` (default) or ``skip_shard``: what a stall that
      outlived the retries (or a worker the watchdog declared wedged) does
    - watchdog_timeout_ms: a decode-pool worker without a progress beat
      for this long is declared wedged; its shard fails with
      ``stall.WatchdogError`` (handled per ``on_stall``) and a
      replacement worker takes its place (``read.watchdog_restarts``)
    - pulse_interval_s: one telemetry JSON line an interval while an
      iterator is live (``telemetry.Pulse``; None = no pulse)
    - autotune: ``off`` (default) or ``on``: a controller at pulse
      boundaries resizes the decode pool and the prefetch queue, retargets
      the readahead window and derives the stall thresholds from observed
      p99s (``autotune.AutotuneController``); batches stay the same
    - autotune_interval_s: the controller's cadence when no
      ``pulse_interval_s`` is set (default 1.0 s)
    - cache: ``off`` (default) or ``auto``: the columnar epoch cache
      (``cache.py``). The first pass over a shard appends its decoded
      chunks to a per-shard entry; later epochs, and later runs with the
      same decode fingerprint, are served as mmap views with no frame
      parse, CRC or protobuf decode. A corrupt or stale entry falls back
      to the TFRecord decode and is rewritten. Engaged only under
      ``on_corrupt="raise"``
    - cache_dir: where the entries live (default: a per-user directory
      under the system temp dir); a local path, since entries are mmapped
    - cache_max_bytes: LRU budget of ``cache_dir`` (None = unbounded),
      swept after each entry's commit (``cache.evictions``)
    - trace: ``off`` (default) or ``on``: span tracing into the
      process-global flight recorder (``telemetry.RECORDER``). Any dataset
      or writer built with ``on`` enables it; ``off`` never disables it
    - telemetry_port: serve the Prometheus text page (``/metrics``) on
      127.0.0.1:PORT from a daemon thread (0 = an ephemeral port; None =
      no endpoint)
    - telemetry_spool_dir: the fleet telemetry spool (``fleet.py``): the
      process snapshots its counters, stage totals, gauges and histogram
      buckets, with a heartbeat, into one atomically rewritten JSONL file
      under this local directory; ``fleet.TelemetryAggregator`` merges
      every process's file (None = no spool)
    - spool_interval_s: the spool's snapshot cadence (default 1.0 s); the
      aggregator's staleness bar is twice it
    - telemetry_role: the role stamped on spool snapshots and trace tracks
      (``"reader"``, ``"trainer"``, ...); None keeps the process's current
      trace-context role
    - service: the data service (``tpu_tfrecord_torch.service``): the
      dispatcher's ``"host:port"``, or a partition-map spec (``"h:p1|h:p2,
      h:p3"``, ``"@map.json"``), makes the dataset's iterators fetch
      decoded chunks from leased decode workers instead of decoding
      locally; batches, positions and shuffles are those of a local read.
      None (default) = decode locally
    - service_lease_ttl_s: the dispatcher's lease TTL (default 10 s): a
      worker whose heartbeat is older loses its leases. Consumers age
      their suspect lists with it until a route reply carries the
      dispatcher's own TTL
    - service_deadline_ms: the consumer's per-socket-op deadline (default
      5000 ms): a worker or dispatcher silent this long is dead for this
      attempt, and the shard re-routes from the acked offset
    - service_fallback_ms: how long a shard may make no progress through
      the service before the consumer reads it locally (default 30000 ms,
      ``service.fallbacks``); None = never fall back
    - elastic_min_workers / elastic_max_workers / elastic_interval_s: the
      elastic decode fleet's floor, ceiling and decision cadence
      (``elastic.FleetScaler``). The dispatcher side reads them (``python
      -m tpu_tfrecord_torch.service dispatcher --elastic`` takes its flag
      defaults from them); they live here so the fleet's vocabulary is
      validated in one place. ``elastic_max_workers`` None defers to the
      scaler's policy default, ``elastic_interval_s`` None to its 1 s
      cadence
    """

    record_type: RecordType = RecordType.EXAMPLE
    codec: Optional[str] = None
    schema: Optional[StructType] = None
    verify_crc: bool = True
    infer_sample_limit: Optional[int] = None
    write_workers: int = 1
    num_shards: Optional[int] = None
    max_records_per_shard: Optional[int] = None
    on_corrupt: str = "raise"
    max_corrupt_records: Optional[int] = 100
    corrupt_fallback: str = "raise"
    write_retries: int = 0
    read_deadline_ms: Optional[float] = None
    open_deadline_ms: Optional[float] = None
    hedge_after_ms: Optional[float] = None
    on_stall: str = "raise"
    watchdog_timeout_ms: Optional[float] = None
    cache: str = "off"
    cache_dir: Optional[str] = None
    cache_max_bytes: Optional[int] = None
    trace: str = "off"
    pulse_interval_s: Optional[float] = None
    telemetry_port: Optional[int] = None
    telemetry_spool_dir: Optional[str] = None
    spool_interval_s: Optional[float] = None
    telemetry_role: Optional[str] = None
    autotune: str = "off"
    autotune_interval_s: Optional[float] = None
    service: Optional[str] = None
    service_lease_ttl_s: float = 10.0
    service_deadline_ms: float = 5000.0
    service_fallback_ms: Optional[float] = 30000.0
    elastic_min_workers: int = 1
    elastic_max_workers: Optional[int] = None
    elastic_interval_s: Optional[float] = None

    _KNOWN_KEYS = (
        "recordType",
        "record_type",
        "codec",
        "schema",
        "verify_crc",
        "verifyCrc",
        "infer_sample_limit",
        "inferSampleLimit",
        "write_workers",
        "writeWorkers",
        "num_shards",
        "numShards",
        "max_records_per_shard",
        "maxRecordsPerShard",
        "on_corrupt",
        "onCorrupt",
        "max_corrupt_records",
        "maxCorruptRecords",
        "corrupt_fallback",
        "corruptFallback",
        "write_retries",
        "writeRetries",
        "read_deadline_ms",
        "readDeadlineMs",
        "open_deadline_ms",
        "openDeadlineMs",
        "hedge_after_ms",
        "hedgeAfterMs",
        "on_stall",
        "onStall",
        "watchdog_timeout_ms",
        "watchdogTimeoutMs",
        "pulse_interval_s",
        "pulseIntervalS",
        "autotune",
        "autotune_interval_s",
        "autotuneIntervalS",
        "cache",
        "cache_dir",
        "cacheDir",
        "cache_max_bytes",
        "cacheMaxBytes",
        "trace",
        "telemetry_port",
        "telemetryPort",
        "telemetry_spool_dir",
        "telemetrySpoolDir",
        "spool_interval_s",
        "spoolIntervalS",
        "telemetry_role",
        "telemetryRole",
        "service",
        "service_lease_ttl_s",
        "serviceLeaseTtlS",
        "service_deadline_ms",
        "serviceDeadlineMs",
        "service_fallback_ms",
        "serviceFallbackMs",
        "elastic_min_workers",
        "elasticMinWorkers",
        "elastic_max_workers",
        "elasticMaxWorkers",
        "elastic_interval_s",
        "elasticIntervalS",
    )

    ON_CORRUPT_POLICIES = ("raise", "skip_record", "skip_shard")
    CORRUPT_FALLBACKS = ("raise", "skip_shard")
    ON_STALL_POLICIES = ("raise", "skip_shard")
    AUTOTUNE_MODES = ("off", "on")
    CACHE_MODES = ("off", "auto")
    TRACE_MODES = ("off", "on")

    @staticmethod
    def from_map(options: Optional[Mapping[str, Any]] = None, **kwargs: Any) -> "TFRecordOptions":
        """Build from a string-keyed map and/or keywords, accepting the
        reference's spellings (``recordType``) as well as snake_case.
        Unknown keys raise with a did-you-mean hint: a typo must fail
        loudly, never change behaviour silently."""
        merged: Dict[str, Any] = dict(options or {})
        merged.update(kwargs)
        record_type = RecordType.parse(
            merged.pop("recordType", merged.pop("record_type", None))
        )
        codec = wire.normalize_codec(merged.pop("codec", None))
        schema = merged.pop("schema", None)
        if isinstance(schema, (str, dict)):
            schema = StructType.from_json(schema)
        verify_crc = _parse_bool(merged.pop("verify_crc", merged.pop("verifyCrc", True)))
        limit = merged.pop("infer_sample_limit", merged.pop("inferSampleLimit", None))
        if limit is not None:
            limit = int(limit)
            if limit <= 0:
                raise ValueError("infer_sample_limit must be positive")
        write_workers = int(merged.pop("write_workers", merged.pop("writeWorkers", 1)))
        if write_workers < 1:
            raise ValueError("write_workers must be >= 1")
        num_shards = merged.pop("num_shards", merged.pop("numShards", None))
        if num_shards is not None:
            num_shards = int(num_shards)
            if num_shards < 1:
                raise ValueError("num_shards must be >= 1")
        max_per_shard = merged.pop(
            "max_records_per_shard", merged.pop("maxRecordsPerShard", None)
        )
        if max_per_shard is not None:
            max_per_shard = int(max_per_shard)
            if max_per_shard < 1:
                raise ValueError("max_records_per_shard must be >= 1")
        on_corrupt = str(merged.pop("on_corrupt", merged.pop("onCorrupt", "raise"))).strip().lower()
        if on_corrupt not in TFRecordOptions.ON_CORRUPT_POLICIES:
            raise ValueError(
                f"on_corrupt must be one of {TFRecordOptions.ON_CORRUPT_POLICIES}, "
                f"got {on_corrupt!r}"
            )
        max_corrupt = merged.pop("max_corrupt_records", merged.pop("maxCorruptRecords", 100))
        if max_corrupt is not None:
            max_corrupt = int(max_corrupt)
            if max_corrupt < 0:
                raise ValueError("max_corrupt_records must be >= 0 (or None)")
        corrupt_fallback = str(
            merged.pop("corrupt_fallback", merged.pop("corruptFallback", "raise"))
        ).strip().lower()
        if corrupt_fallback not in TFRecordOptions.CORRUPT_FALLBACKS:
            raise ValueError(
                f"corrupt_fallback must be one of "
                f"{TFRecordOptions.CORRUPT_FALLBACKS}, got {corrupt_fallback!r}"
            )
        write_retries = int(merged.pop("write_retries", merged.pop("writeRetries", 0)))
        if write_retries < 0:
            raise ValueError("write_retries must be >= 0")

        def _pos_ms(snake: str, camel: str) -> Optional[float]:
            v = merged.pop(snake, merged.pop(camel, None))
            if v is None:
                return None
            v = float(v)
            if v <= 0:
                raise ValueError(f"{snake} must be > 0 (or None)")
            return v

        read_deadline_ms = _pos_ms("read_deadline_ms", "readDeadlineMs")
        open_deadline_ms = _pos_ms("open_deadline_ms", "openDeadlineMs")
        hedge_after_ms = _pos_ms("hedge_after_ms", "hedgeAfterMs")
        watchdog_timeout_ms = _pos_ms("watchdog_timeout_ms", "watchdogTimeoutMs")
        on_stall = str(merged.pop("on_stall", merged.pop("onStall", "raise"))).strip().lower()
        if on_stall not in TFRecordOptions.ON_STALL_POLICIES:
            raise ValueError(
                f"on_stall must be one of {TFRecordOptions.ON_STALL_POLICIES}, got {on_stall!r}"
            )
        pulse_interval_s = merged.pop("pulse_interval_s", merged.pop("pulseIntervalS", None))
        if pulse_interval_s is not None:
            pulse_interval_s = float(pulse_interval_s)
            if pulse_interval_s <= 0:
                raise ValueError("pulse_interval_s must be > 0 (or None)")
        autotune = str(merged.pop("autotune", "off") or "off").strip().lower()
        if autotune not in TFRecordOptions.AUTOTUNE_MODES:
            raise ValueError(
                f"autotune must be one of {TFRecordOptions.AUTOTUNE_MODES}, got {autotune!r}"
            )
        autotune_interval_s = merged.pop(
            "autotune_interval_s", merged.pop("autotuneIntervalS", None)
        )
        if autotune_interval_s is not None:
            autotune_interval_s = float(autotune_interval_s)
            if autotune_interval_s <= 0:
                raise ValueError("autotune_interval_s must be > 0 (or None)")
        cache = str(merged.pop("cache", "off") or "off").strip().lower()
        if cache not in TFRecordOptions.CACHE_MODES:
            raise ValueError(
                f"cache must be one of {TFRecordOptions.CACHE_MODES}, got {cache!r}"
            )
        cache_dir = merged.pop("cache_dir", merged.pop("cacheDir", None))
        if cache_dir is not None:
            cache_dir = os.fspath(cache_dir)
        cache_max_bytes = merged.pop("cache_max_bytes", merged.pop("cacheMaxBytes", None))
        if cache_max_bytes is not None:
            cache_max_bytes = int(cache_max_bytes)
            if cache_max_bytes < 1:
                raise ValueError("cache_max_bytes must be >= 1 (or None)")
        trace = str(merged.pop("trace", "off") or "off").strip().lower()
        if trace not in TFRecordOptions.TRACE_MODES:
            raise ValueError(
                f"trace must be one of {TFRecordOptions.TRACE_MODES}, got {trace!r}"
            )
        telemetry_port = merged.pop("telemetry_port", merged.pop("telemetryPort", None))
        if telemetry_port is not None:
            telemetry_port = int(telemetry_port)
            if not 0 <= telemetry_port <= 65535:
                raise ValueError("telemetry_port must be in [0, 65535] (0 = ephemeral)")
        telemetry_spool_dir = merged.pop("telemetry_spool_dir", merged.pop("telemetrySpoolDir", None))
        if telemetry_spool_dir is not None:
            telemetry_spool_dir = os.fspath(telemetry_spool_dir)
        spool_interval_s = merged.pop("spool_interval_s", merged.pop("spoolIntervalS", None))
        if spool_interval_s is not None:
            spool_interval_s = float(spool_interval_s)
            if spool_interval_s <= 0:
                raise ValueError("spool_interval_s must be > 0 (or None)")
        telemetry_role = merged.pop("telemetry_role", merged.pop("telemetryRole", None))
        if telemetry_role is not None:
            telemetry_role = str(telemetry_role)
            if not telemetry_role:
                raise ValueError("telemetry_role must be non-empty (or None)")
        service = merged.pop("service", None)
        if service is not None:
            service = str(service)
            from tpu_tfrecord_torch.service import PartitionMap

            # loud on anything that is neither a host:port nor a
            # partition-map spec ("h:p1|h:p2,h:p3" / "@map.json")
            PartitionMap.parse(service)
        service_lease_ttl_s = float(
            merged.pop("service_lease_ttl_s", merged.pop("serviceLeaseTtlS", 10.0))
        )
        if service_lease_ttl_s <= 0:
            raise ValueError("service_lease_ttl_s must be > 0")
        service_deadline_ms = float(
            merged.pop("service_deadline_ms", merged.pop("serviceDeadlineMs", 5000.0))
        )
        if service_deadline_ms <= 0:
            raise ValueError("service_deadline_ms must be > 0")
        service_fallback_ms = merged.pop(
            "service_fallback_ms", merged.pop("serviceFallbackMs", 30000.0)
        )
        if service_fallback_ms is not None:
            service_fallback_ms = float(service_fallback_ms)
            if service_fallback_ms < 0:
                raise ValueError("service_fallback_ms must be >= 0 (or None)")
        elastic_min_workers = int(
            merged.pop("elastic_min_workers", merged.pop("elasticMinWorkers", 1))
        )
        if elastic_min_workers < 1:
            raise ValueError("elastic_min_workers must be >= 1")
        elastic_max_workers = merged.pop(
            "elastic_max_workers", merged.pop("elasticMaxWorkers", None)
        )
        if elastic_max_workers is not None:
            elastic_max_workers = int(elastic_max_workers)
            if elastic_max_workers < elastic_min_workers:
                raise ValueError(
                    "elastic_max_workers must be >= elastic_min_workers (or None)"
                )
        elastic_interval_s = merged.pop(
            "elastic_interval_s", merged.pop("elasticIntervalS", None)
        )
        if elastic_interval_s is not None:
            elastic_interval_s = float(elastic_interval_s)
            if elastic_interval_s <= 0:
                raise ValueError("elastic_interval_s must be > 0 (or None)")
        if merged:
            hints = []
            for key in merged:
                close = difflib.get_close_matches(str(key), TFRecordOptions._KNOWN_KEYS, n=1)
                hints.append(f"{key!r}" + (f" (did you mean {close[0]!r}?)" if close else ""))
            raise ValueError(
                f"Unknown option(s): {', '.join(hints)}. Supported options: "
                + ", ".join(TFRecordOptions._KNOWN_KEYS)
            )
        return TFRecordOptions(
            record_type=record_type,
            codec=codec,
            schema=schema,
            verify_crc=verify_crc,
            infer_sample_limit=limit,
            write_workers=write_workers,
            num_shards=num_shards,
            max_records_per_shard=max_per_shard,
            on_corrupt=on_corrupt,
            max_corrupt_records=max_corrupt,
            corrupt_fallback=corrupt_fallback,
            write_retries=write_retries,
            read_deadline_ms=read_deadline_ms,
            open_deadline_ms=open_deadline_ms,
            hedge_after_ms=hedge_after_ms,
            on_stall=on_stall,
            watchdog_timeout_ms=watchdog_timeout_ms,
            pulse_interval_s=pulse_interval_s,
            autotune=autotune,
            autotune_interval_s=autotune_interval_s,
            cache=cache,
            cache_dir=cache_dir,
            cache_max_bytes=cache_max_bytes,
            trace=trace,
            telemetry_port=telemetry_port,
            telemetry_spool_dir=telemetry_spool_dir,
            spool_interval_s=spool_interval_s,
            telemetry_role=telemetry_role,
            service=service,
            service_lease_ttl_s=service_lease_ttl_s,
            service_deadline_ms=service_deadline_ms,
            service_fallback_ms=service_fallback_ms,
            elastic_min_workers=elastic_min_workers,
            elastic_max_workers=elastic_max_workers,
            elastic_interval_s=elastic_interval_s,
        )

    def with_schema(self, schema: StructType) -> "TFRecordOptions":
        return replace(self, schema=schema)

    def file_extension(self) -> str:
        """'.tfrecord' + codec suffix (ref DefaultSource.scala:112-114)."""
        return ".tfrecord" + wire.codec_extension(self.codec)


def _parse_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        return value.strip().lower() in ("1", "true", "yes")
    return bool(value)
