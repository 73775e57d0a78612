"""Elastic service layer: the decode fleet and the serving replicas track
offered load. Copy of ``tpu_tfrecord/elastic.py`` on the port's modules,
with the same names, decisions, counters and status blocks, so a port
scaler drives JAX dispatchers and replicas and a JAX scaler drives the
port's.

- **FleetScaler** closes the loop between the fleet flight recorder and
  the dispatchers' decode-worker fleet. Sensor: a
  ``fleet.TelemetryAggregator`` merges every consumer's spool into one
  verdict over alive processes: ``producer_bound`` (the consumers'
  prefetch queues starve: add a worker), ``consumer_bound`` (queues full:
  decode capacity is wasted) or ``idle`` (no running consumer). Actuator:
  ``spawn`` (``subprocess_spawner``: ``python -m
  tpu_tfrecord_torch.service worker``) grows the fleet; a scale-down
  drains the last active worker in sorted order through
  ``ServiceDispatcher.drain``, which hands its leases back, routes around
  it and lets it finish its streams, say ``goodbye`` and exit. A victim
  SIGKILLed mid-drain is an ordinary dead worker: its heartbeat expires
  and consumers re-route with exactly-once dedupe.
- **Guard rails**: ``autotune.BoundedClimber`` hysteresis and cooldown
  (a flapping verdict never whipsaws the fleet), spawns in flight counted
  against the ceiling, and a below-floor refill outside the climber.
- **Partitions**: ``dispatcher`` may be a list, one per partition, of
  local ``ServiceDispatcher`` objects and ``DispatcherHandle`` proxies.
  The census merges every partition's books by worker id, a victim is
  drained on every partition, and a tick with any partition unreadable
  (a failover in flight) is skipped (``elastic.census_errors``).
- **ServingScaler** scales ``tpu_tfrecord_torch.serving`` replicas on
  their ``status`` RPC: ``queue_bound`` grows, ``idle`` drains one over
  the ``drain`` RPC, and a replica lost undrained is dropped and refilled
  below the floor. ``ServingReplicaSpawner`` starts one and blocks on its
  ready line.

Every consumer's bytes are the same across any resize: the consumer owns
its position (acked offsets, redelivered-prefix dedupe) and the route
only picks who decodes, never what is decoded.

Counters (in the scaler's process): ``elastic.scale_ups``,
``elastic.scale_downs``, ``elastic.drains`` (goodbyes received),
``elastic.drained_leases``, ``elastic.spawn_errors``,
``elastic.census_errors``, ``elastic.replicas_lost``. Gauges:
``elastic.workers``, ``elastic.replicas``. The module imports neither
torch nor jax, so a dispatcher that hosts a scaler stays torch-free.
"""

from __future__ import annotations

import os
import threading
import time
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional

from tpu_tfrecord_torch import telemetry
from tpu_tfrecord_torch.autotune import BoundedClimber
from tpu_tfrecord_torch.metrics import METRICS, logger

__all__ = [
    "ScalerPolicy",
    "FleetScaler",
    "ServingScaler",
    "ServingReplicaSpawner",
    "DispatcherHandle",
    "SubprocessSpawner",
    "subprocess_spawner",
]

#: Scaler decision cadence when the caller sets none.
DEFAULT_INTERVAL_S = 1.0


@dataclass
class ScalerPolicy:
    """Bounds and pacing for the fleet-level hill-climber. The fleet only
    moves after ``hysteresis`` consecutive same-verdict ticks and at most
    once per ``cooldown_s`` wall-clock window (the whipsaw guard); worker
    count is clamped to [min_workers, max_workers]; a spawn that has not
    registered within ``pending_timeout_s`` stops counting against the
    ceiling (the process died at exec — retrying is allowed again)."""

    hysteresis: int = 2
    cooldown_s: float = 5.0
    min_workers: int = 1
    max_workers: int = 8
    pending_timeout_s: float = 30.0

    def __post_init__(self) -> None:
        if self.min_workers < 1:
            raise ValueError("min_workers must be >= 1")
        if self.max_workers < self.min_workers:
            raise ValueError("max_workers must be >= min_workers")
        if self.hysteresis < 1:
            raise ValueError("hysteresis must be >= 1")


class FleetScaler:
    """Fleet-level bounded hill-climbing over the decode-worker count.

    One scaler per FLEET — it is the only thing that spawns or drains
    workers (two scalers over one fleet would fight). ``dispatcher`` is
    a single dispatcher or, under partitioning, a list of
    one per partition — local ``ServiceDispatcher`` objects and/or
    ``DispatcherHandle`` proxies for partitions hosted elsewhere. The
    scaler's verdict block is published to every partition so
    ``serve-status`` shows it no matter which one is asked. ``step()``
    is one decision tick; pass ``interval_s`` and call ``start()`` for
    the production thread, or drive ``step()`` directly with an injected
    clock in tests.

    The verdict source is either a spool directory (a
    ``fleet.TelemetryAggregator`` is built over it) or an injected
    ``aggregator`` object with the same ``aggregate()`` shape — the test
    seam. ``roles`` optionally scopes the verdict to specific telemetry
    roles (e.g. only ``trainer`` processes) via the aggregator's role
    filter.
    """

    def __init__(
        self,
        dispatcher,
        spawn: Callable[[], Any],
        spool_dir: Optional[str] = None,
        aggregator=None,
        policy: Optional[ScalerPolicy] = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        roles: Optional[List[str]] = None,
        trace_id: Optional[str] = None,
        clock: Callable[[], float] = time.monotonic,
    ):
        if (spool_dir is None) == (aggregator is None):
            raise ValueError(
                "exactly one of spool_dir / aggregator must be given"
            )
        if aggregator is None:
            from tpu_tfrecord_torch import fleet

            aggregator = fleet.TelemetryAggregator(
                spool_dir, trace_id=trace_id
            )
        if isinstance(dispatcher, (list, tuple)):
            if not dispatcher:
                raise ValueError("dispatcher list must be non-empty")
            self.dispatchers = list(dispatcher)
        else:
            self.dispatchers = [dispatcher]
        #: partition 0, kept for the single-dispatcher surface
        self.dispatcher = self.dispatchers[0]
        self.spawn = spawn
        self.aggregator = aggregator
        self.policy = policy or ScalerPolicy()
        self.interval_s = float(interval_s)
        self.roles = list(roles) if roles is not None else None
        self.clock = clock
        self._climber = BoundedClimber(
            self.policy.hysteresis,
            self.policy.cooldown_s,
            clock=clock,
            # "idle" (no running consumer) is a shrink signal the
            # per-iterator controller never sees: zero offered load means
            # the fleet should coast at min_workers
            actionable=("producer_bound", "consumer_bound", "idle"),
        )
        #: full decision log, same shape discipline as AutotuneController
        self.log: List[Dict[str, Any]] = []
        self.last_decision: Optional[Dict[str, Any]] = None
        self._tick = 0
        self._pending: List[float] = []  # spawn times not yet registered
        self._known_ids: set = set()
        self._last_verdict: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # surface ourselves on every partition's status() page
        self._publish(self.status(workers=0, draining=[]))

    # -- census ----------------------------------------------------------------

    def _publish(self, st: Dict[str, Any]) -> None:
        """Push the scaler block onto every partition's status page (a
        plain attribute set locally; one ``scaler_status`` RPC through a
        ``DispatcherHandle``). A partition unreachable right now —
        mid-failover — just misses one refresh; the next tick re-pushes."""
        for d in self.dispatchers:
            try:
                d.scaler_status = st
            except OSError as e:
                logger.warning(
                    "tfrecord.elastic scaler-status publish failed: %s", e
                )

    def _census(self) -> Optional[Dict[str, Any]]:
        """Who is in the fleet right now, merged over every partition's
        books (workers register with ALL partitions — dedupe by worker
        id; a worker is active if any partition sees it alive and
        undraining, draining if any partition has it marked): active,
        draining, and the pending spawns that have not registered yet.

        Returns None when ANY partition's status is unreadable: during a
        failover window one partition's books are in transit between
        primary and standby, and a census over the remaining partitions
        would double-count or miss workers — the whipsaw the climber's
        hysteresis cannot see. The tick is skipped instead
        (``elastic.census_errors``)."""
        statuses = []
        for i, d in enumerate(self.dispatchers):
            try:
                statuses.append(d.status())
            except (OSError, RuntimeError) as e:
                METRICS.count("elastic.census_errors")
                logger.warning(
                    "tfrecord.elastic census blind: partition %d "
                    "unreadable (%s)", i, e
                )
                return None
        seen: Dict[str, Dict[str, Any]] = {}
        for st in statuses:
            for w in st["workers"]:
                prev = seen.setdefault(
                    w["worker_id"], {"alive": False, "draining": False}
                )
                prev["alive"] = prev["alive"] or bool(w["alive"])
                prev["draining"] = prev["draining"] or bool(w.get("draining"))
        ids = set(seen)
        # registrations observed since the last tick retire pending spawns
        for _ in ids - self._known_ids:
            if self._pending:
                self._pending.pop(0)
        self._known_ids = ids
        now = self.clock()
        self._pending = [
            t for t in self._pending
            if now - t < self.policy.pending_timeout_s
        ]
        active = sorted(
            wid for wid, w in seen.items()
            if w["alive"] and not w["draining"]
        )
        draining = sorted(
            wid for wid, w in seen.items()
            if w["alive"] and w["draining"]
        )
        return {"active": active, "draining": draining, "statuses": statuses}

    def _verdict(self) -> str:
        """Cluster verdict over the alive, still-running consumers; no
        such process at all = ``idle`` (load removed or never offered)."""
        try:
            snap = self.aggregator.aggregate(roles=self.roles)
        except FileNotFoundError:
            # spool dir not created yet (no consumer has ever spooled):
            # indistinguishable from zero offered load
            return "idle"
        except OSError as e:
            # any OTHER read failure (EACCES, EIO, an NFS hiccup) is an
            # unreadable fleet, not an idle one — the aggregator's own
            # invariant. Non-actionable: the tick is skipped, a loaded
            # fleet is never drained on blindness.
            METRICS.count("elastic.verdict_errors")
            logger.warning("tfrecord.elastic verdict unreadable: %s", e)
            return "unreadable"
        running = [
            p for p in snap.alive
            if not p.final and telemetry.OCCUPANCY_GAUGE in p.gauges
        ]
        if not running:
            return "idle"
        return snap.verdict

    # -- the decision tick -----------------------------------------------------

    def step(self) -> Optional[Dict[str, Any]]:
        """One control step: read the verdict, apply at most one fleet
        move (spawn or drain), update the dispatcher's scaler status.
        Returns the decision dict when a move was made, else None."""
        self._tick += 1
        pol = self.policy
        census = self._census()
        if census is None:
            # a partition is unreadable (failover in flight): the fleet
            # view is partial, so neither the climber nor the floor
            # check may act on it — and the stale published verdict is
            # left in place rather than replaced with a blind one
            return None
        active, draining = census["active"], census["draining"]
        effective = len(active) + len(self._pending)
        verdict = self._verdict()
        self._last_verdict = verdict
        decision: Optional[Dict[str, Any]] = None
        if effective < pol.min_workers:
            # below the floor is not a hill-climbing question — refill
            # immediately (dead workers, a fleet coming up from zero)
            decision = self._spawn_one(effective, "below_min")
        else:
            act = self._climber.observe(verdict)
            if act == "producer_bound" and effective < pol.max_workers:
                decision = self._spawn_one(effective, act)
                if decision is not None:
                    self._climber.acted()
            elif act in ("consumer_bound", "idle") and len(active) > pol.min_workers:
                decision = self._drain_one(active, act)
                if decision is not None:
                    self._climber.acted()
        METRICS.gauge("elastic.workers", float(len(active)))
        self._publish(self.status(workers=len(active), draining=draining))
        return decision

    def _spawn_one(self, effective: int, reason: str) -> Optional[Dict[str, Any]]:
        try:
            self.spawn()
        except Exception as e:  # noqa: BLE001 — a failed exec must not
            # kill the control loop; the next tick retries
            METRICS.count("elastic.spawn_errors")
            logger.warning("tfrecord.elastic spawn failed: %s", e)
            return None
        self._pending.append(self.clock())
        METRICS.count("elastic.scale_ups")
        return self._record("scale_up", reason, {"workers": effective,
                                                 "target": effective + 1})

    def _drain_one(self, active: List[str], reason: str) -> Optional[Dict[str, Any]]:
        # deterministic victim: the LAST worker in sorted id order — the
        # same pick on every replay of the same fleet state, and (because
        # routing interleaves over the sorted alive list) the one whose
        # removal perturbs the fewest existing assignments
        victim = active[-1]
        # the victim holds leases on EVERY partition that routed work to
        # it — each must hand them back; "drained" if any partition knew
        # the worker at all (partitions that never routed to it answer
        # False harmlessly)
        drained = False
        for i, d in enumerate(self.dispatchers):
            try:
                drained = bool(d.drain(victim)) or drained
            except OSError as e:
                logger.warning(
                    "tfrecord.elastic drain of %s on partition %d "
                    "failed: %s", victim, i, e
                )
        if not drained:
            return None
        METRICS.count("elastic.scale_downs")
        return self._record("scale_down", reason, {"workers": len(active),
                                                   "target": len(active) - 1,
                                                   "victim": victim})

    def _record(self, action: str, reason: str, extra: Dict[str, Any]) -> Dict[str, Any]:
        decision = {"tick": self._tick, "action": action, "reason": reason,
                    **extra}
        self.log.append(decision)
        self.last_decision = decision
        telemetry.instant("elastic.decision", action=action, reason=reason)
        return decision

    def status(self, workers: int, draining: List[str]) -> Dict[str, Any]:
        """The ``scaler`` block surfaced on the dispatcher's status page
        (and thus ``tfrecord_doctor serve-status``)."""
        return {
            "workers": workers,
            "draining": list(draining),
            "pending_spawns": len(self._pending),
            "min_workers": self.policy.min_workers,
            "max_workers": self.policy.max_workers,
            "verdict": self._last_verdict,
            "last_decision": self.last_decision,
            "scale_ups": METRICS.counter("elastic.scale_ups"),
            "scale_downs": METRICS.counter("elastic.scale_downs"),
            "drains_completed": METRICS.counter("elastic.drains"),
        }

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "FleetScaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tfr-fleet-scaler"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "FleetScaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the control loop is
                # telemetry-adjacent: it must never die silently mid-fleet
                METRICS.count("elastic.step_errors")
                logger.warning("tfrecord.elastic step failed: %s", e)


class DispatcherHandle:
    """Remote-dispatcher proxy with exactly the surface ``FleetScaler``
    touches — ``status()``, ``drain()``, and ``scaler_status``
    assignment — so one scaler can federate over partitions it does not
    host in-process. ``addrs`` is one partition's member list in
    preference order (primary first, then its standby, i.e. one ``|``
    group of the partition-map spec): every RPC walks the list and a
    member answering ``not_primary`` (a standby, or a demoted zombie) is
    skipped for primary-only ops, so the handle follows a failover
    without reconfiguration."""

    def __init__(self, addrs, timeout: float = 5.0):
        if isinstance(addrs, str):
            addrs = [a.strip() for a in addrs.split("|") if a.strip()]
        if not addrs:
            raise ValueError("DispatcherHandle needs at least one address")
        self.addrs = [str(a) for a in addrs]
        self.timeout = float(timeout)
        self._scaler_status: Optional[Dict[str, Any]] = None

    def _rpc(self, msg: Dict[str, Any], primary_only: bool) -> Dict[str, Any]:
        from tpu_tfrecord_torch import service as _service
        from tpu_tfrecord_torch import service_protocol as sp

        last: Optional[BaseException] = None
        for addr in self.addrs:
            try:
                sock = sp.connect(addr, timeout=self.timeout)
                try:
                    sock.settimeout(self.timeout)
                    reply = sp.request(
                        sock, addr,
                        {**msg, "proto": _service.PROTO_VERSION},
                    )
                finally:
                    try:
                        sock.close()
                    except OSError:
                        pass
            except OSError as e:  # ProtocolError is a ConnectionError
                last = e
                continue
            if primary_only and reply.get("error") == "not_primary":
                last = OSError(f"{addr}: not primary")
                continue
            return reply
        raise OSError(
            f"no member of partition {self.addrs} answered: {last}"
        )

    def status(self) -> Dict[str, Any]:
        return self._rpc({"op": "status"}, primary_only=False)

    def drain(self, worker_id: str) -> bool:
        reply = self._rpc(
            {"op": "drain", "worker_id": str(worker_id)}, primary_only=True
        )
        return bool(reply.get("drained"))

    @property
    def scaler_status(self) -> Optional[Dict[str, Any]]:
        return self._scaler_status

    @scaler_status.setter
    def scaler_status(self, st: Optional[Dict[str, Any]]) -> None:
        # assignment IS the publish — mirrors the plain-attribute set on
        # a local ServiceDispatcher; OSError propagates for the caller
        # (FleetScaler._publish) to log
        self._scaler_status = st
        self._rpc({"op": "scaler_status", "status": st}, primary_only=False)


class SubprocessSpawner:
    """The production ``spawn``: each call launches one
    ``python -m tpu_tfrecord_torch.service worker`` subprocess pointed at the
    dispatcher — ``dispatcher_addr`` may be a single ``host:port`` or a
    full partition-map spec (``h:p1|h:p2,h:p3``), which the worker
    parses to register with every partition — with any extra CLI args
    appended (``--cache``, ``--spool-dir``, ``--fault-plan`` for chaos
    replays, ...). Tracks its
    children so ``reap()`` can terminate whatever is still alive — a
    drained worker exits on its own; reap is the shutdown safety net."""

    def __init__(
        self,
        dispatcher_addr: str,
        extra_args: tuple = (),
        env: Optional[Dict[str, str]] = None,
    ):
        self.dispatcher_addr = str(dispatcher_addr)
        self.extra_args = tuple(str(a) for a in extra_args)
        self.env = dict(env) if env is not None else None
        self.procs: List[Any] = []
        self._lock = threading.Lock()

    def __call__(self):
        import subprocess
        import sys

        # keep the CALLER's cwd — relative dataset paths in job specs,
        # relative --spool-dir/--fault-plan worker args, etc. must
        # resolve exactly as they would for a manually started worker.
        # Importability of `-m tpu_tfrecord_torch.service` is guaranteed by
        # prepending this package's parent to the child's PYTHONPATH
        # instead.
        env = dict(self.env) if self.env is not None else dict(os.environ)
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_parent
        )
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_tfrecord_torch.service", "worker",
             "--dispatcher", self.dispatcher_addr, *self.extra_args],
            stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL,
            env=env,
        )
        with self._lock:
            self.procs.append(p)
        return p

    def reap(self, timeout: float = 10.0) -> None:
        with self._lock:
            procs = list(self.procs)
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=timeout)
                except Exception:  # noqa: BLE001  # graftlint: swallow(best-effort shutdown reap; kill() fallback follows)
                    try:
                        p.kill()
                    except OSError:
                        pass


def subprocess_spawner(
    dispatcher_addr: str,
    extra_args: tuple = (),
    env: Optional[Dict[str, str]] = None,
) -> SubprocessSpawner:
    return SubprocessSpawner(dispatcher_addr, extra_args, env=env)


# ---------------------------------------------------------------------------
# Serving role: replicas scale on queue-depth/p99
# ---------------------------------------------------------------------------


def _serving_status_rpc(addr: str, timeout: float = 5.0) -> Dict[str, Any]:
    from tpu_tfrecord_torch import service_protocol as sp

    sock = sp.connect(addr, timeout=timeout)
    try:
        sock.settimeout(timeout)
        return sp.request(
            sock, addr, {"v": sp.PROTO_VERSION, "op": "status", "req": 0}
        )
    finally:
        try:
            sock.close()
        except OSError:
            pass


def _serving_drain_rpc(addr: str, timeout: float = 5.0) -> Dict[str, Any]:
    from tpu_tfrecord_torch import service_protocol as sp

    sock = sp.connect(addr, timeout=timeout)
    try:
        sock.settimeout(timeout)
        return sp.request(
            sock, addr, {"v": sp.PROTO_VERSION, "op": "drain", "req": 0}
        )
    finally:
        try:
            sock.close()
        except OSError:
            pass


class ServingScaler:
    """The serving-role twin of :class:`FleetScaler`: scales
    inference REPLICAS (``tpu_tfrecord_torch.serving`` servers) on
    queue-depth/p99 the way the decode fleet scales on producer_bound.

    - **Sensor**: each replica's ``status`` RPC (queue depth, in-flight,
      per-request p99, completion counter). The fleet verdict is the
      worst replica's `telemetry.serving_verdict` — ``queue_bound``
      (requests queue faster than slots free: add a replica), or —
      when every replica is empty AND no request completed since the
      last tick — ``idle`` (drain one). ``meeting_slo``/
      ``compute_bound`` hold the size: more replicas cannot speed up
      the compiled step itself.
    - **Actuator**: ``spawn()`` must launch a replica and return its
      address once it is ready to serve (the ServingReplicaSpawner
      shape: block on the child's ready line). Scale-down picks the
      LAST active address in sorted order and sends the ``drain`` RPC:
      the replica stops admitting, finishes in-flight requests, lands
      its ``final: true`` spool snapshot, and exits; its disappearance
      retires it from the member list (``elastic.drains``).
    - **Guard rails**: the same ``BoundedClimber`` hysteresis/cooldown.
      A replica that stops answering WITHOUT having been drained — a
      SIGKILL — is dropped from the membership immediately, and the
      ``min_workers`` floor refills it outside the climber (the same
      below-floor bypass the decode fleet uses); meanwhile clients walk
      the member list, so the dead replica's queue drains through the
      survivors.

    ``step()`` is one decision tick (drive it directly with an injected
    clock in tests); ``start()`` runs the production thread.
    """

    def __init__(
        self,
        spawn: Callable[[], str],
        replicas: Optional[List[str]] = None,
        policy: Optional[ScalerPolicy] = None,
        interval_s: float = DEFAULT_INTERVAL_S,
        status_fn: Callable[[str], Dict[str, Any]] = _serving_status_rpc,
        drain_fn: Callable[[str], Dict[str, Any]] = _serving_drain_rpc,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.spawn = spawn
        self.replicas: List[str] = list(replicas or [])
        self.policy = policy or ScalerPolicy()
        self.interval_s = float(interval_s)
        self._status = status_fn
        self._drain = drain_fn
        self.clock = clock
        self._climber = BoundedClimber(
            self.policy.hysteresis,
            self.policy.cooldown_s,
            clock=clock,
            actionable=("queue_bound", "idle"),
        )
        self.log: List[Dict[str, Any]] = []
        self.last_decision: Optional[Dict[str, Any]] = None
        self._tick = 0
        self._draining: set = set()
        self._last_completed: Optional[int] = None
        self._last_verdict: Optional[str] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # -- census ----------------------------------------------------------------

    def _census(self) -> Dict[str, Any]:
        """Poll every member: active statuses, replicas mid-drain, and —
        unlike the decode fleet's partition census — DEAD members, which
        are actionable here: a drained replica saying goodbye retires
        cleanly (``elastic.drains``) while an undrained death is a kill
        the floor check must refill."""
        statuses: Dict[str, Dict[str, Any]] = {}
        for addr in list(self.replicas):
            try:
                st = self._status(addr)
            except (OSError, RuntimeError) as e:
                self.replicas.remove(addr)
                if addr in self._draining:
                    self._draining.discard(addr)
                    METRICS.count("elastic.drains")
                else:
                    METRICS.count("elastic.replicas_lost")
                    logger.warning(
                        "tfrecord.elastic serving replica %s lost "
                        "undrained: %s", addr, e
                    )
                continue
            statuses[addr] = st
            if st.get("draining"):
                self._draining.add(addr)
        active = sorted(a for a in statuses if a not in self._draining)
        return {"active": active, "statuses": statuses}

    def _verdict(self, census: Dict[str, Any]) -> str:
        """Worst replica wins; idleness needs BOTH empty queues and zero
        completions since the last tick (a fleet at exactly its capacity
        has empty queues between bursts — that is not idle)."""
        active = census["active"]
        if not active:
            return "unknown"
        statuses = [census["statuses"][a] for a in active]
        completed = sum(int(s.get("completed") or 0) for s in statuses)
        delta = (
            None if self._last_completed is None
            else completed - self._last_completed
        )
        self._last_completed = completed
        backlog = sum(
            int(s.get("queue_depth") or 0) + int(s.get("in_flight") or 0)
            for s in statuses
        )
        if backlog == 0 and delta == 0:
            return "idle"
        worst = "unknown"
        rank = {"meeting_slo": 1, "compute_bound": 2, "queue_bound": 3}
        for s in statuses:
            v = telemetry.serving_verdict(
                s.get("p99_ms"), s.get("queue_depth"),
                float(s.get("slo_p99_ms") or 0.0) or 250.0,
                max_queue=int(s.get("max_queue") or 16),
            )
            if rank.get(v, 0) > rank.get(worst, 0):
                worst = v
        return worst

    # -- the decision tick -----------------------------------------------------

    def step(self) -> Optional[Dict[str, Any]]:
        """One control step: census, verdict, at most one fleet move.
        Below-floor refill (dead replica) bypasses the climber — a
        SIGKILLed replica is replaced on the next tick, not after
        ``hysteresis`` of them."""
        self._tick += 1
        pol = self.policy
        census = self._census()
        active = census["active"]
        verdict = self._verdict(census)
        self._last_verdict = verdict
        decision: Optional[Dict[str, Any]] = None
        if len(active) < pol.min_workers:
            decision = self._spawn_one(len(active), "below_min")
        else:
            act = self._climber.observe(verdict)
            if act == "queue_bound" and len(active) < pol.max_workers:
                decision = self._spawn_one(len(active), act)
                if decision is not None:
                    self._climber.acted()
            elif act == "idle" and len(active) > pol.min_workers:
                decision = self._drain_one(active, act)
                if decision is not None:
                    self._climber.acted()
        METRICS.gauge("elastic.replicas", float(len(census["active"])))
        return decision

    def _spawn_one(self, n: int, reason: str) -> Optional[Dict[str, Any]]:
        try:
            addr = self.spawn()
        except Exception as e:  # noqa: BLE001 — a failed exec must not
            # kill the control loop; the next tick retries
            METRICS.count("elastic.spawn_errors")
            logger.warning("tfrecord.elastic serving spawn failed: %s", e)
            return None
        self.replicas.append(str(addr))
        METRICS.count("elastic.scale_ups")
        return self._record("scale_up", reason,
                            {"replicas": n, "target": n + 1,
                             "addr": str(addr)})

    def _drain_one(self, active: List[str], reason: str) -> Optional[Dict[str, Any]]:
        from tpu_tfrecord_torch import service_protocol as sp

        victim = active[-1]
        try:
            self._drain(victim)
        except sp.ProtocolError as e:
            # the request went out and the replica closed without a reply:
            # a JAX replica can stop before its writer flushes the drain's
            # own reply. It is draining; its exit is a clean goodbye.
            logger.info(
                "tfrecord.elastic serving replica %s closed on its drain: %s",
                victim, e,
            )
        except OSError as e:
            logger.warning(
                "tfrecord.elastic drain of serving replica %s failed: %s",
                victim, e,
            )
            return None
        self._draining.add(victim)
        METRICS.count("elastic.scale_downs")
        return self._record("scale_down", reason,
                            {"replicas": len(active),
                             "target": len(active) - 1, "victim": victim})

    def _record(self, action: str, reason: str, extra: Dict[str, Any]) -> Dict[str, Any]:
        decision = {"tick": self._tick, "action": action, "reason": reason,
                    **extra}
        self.log.append(decision)
        self.last_decision = decision
        telemetry.instant("elastic.decision", action=action, reason=reason)
        return decision

    def status(self) -> Dict[str, Any]:
        return {
            "replicas": list(self.replicas),
            "draining": sorted(self._draining),
            "min_workers": self.policy.min_workers,
            "max_workers": self.policy.max_workers,
            "verdict": self._last_verdict,
            "last_decision": self.last_decision,
            "scale_ups": METRICS.counter("elastic.scale_ups"),
            "scale_downs": METRICS.counter("elastic.scale_downs"),
            "drains_completed": METRICS.counter("elastic.drains"),
        }

    # -- lifecycle -------------------------------------------------------------

    def start(self) -> "ServingScaler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="tfr-serving-scaler"
            )
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=2.0)
            self._thread = None

    def __enter__(self) -> "ServingScaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            try:
                self.step()
            except Exception as e:  # noqa: BLE001 — the control loop is
                # telemetry-adjacent: it must never die silently mid-fleet
                METRICS.count("elastic.step_errors")
                logger.warning(
                    "tfrecord.elastic serving step failed: %s", e
                )


class ServingReplicaSpawner:
    """The production serving ``spawn``: each call launches one
    ``python -m tpu_tfrecord_torch.serving`` replica (synthetic model, seeded
    — the chaos/scale harness shape) with the given CLI args, BLOCKS on
    its ready line, and returns the replica's address — exactly what
    :class:`ServingScaler` appends to its member list. ``reap()`` is the
    shutdown safety net for replicas still alive (a drained replica
    exits on its own)."""

    def __init__(
        self,
        extra_args: tuple = (),
        env: Optional[Dict[str, str]] = None,
    ):
        self.extra_args = tuple(str(a) for a in extra_args)
        self.env = dict(env) if env is not None else None
        self.procs: List[Any] = []
        self._lock = threading.Lock()

    def __call__(self) -> str:
        import json as _json
        import subprocess
        import sys

        env = dict(self.env) if self.env is not None else dict(os.environ)
        pkg_parent = os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))
        )
        env["PYTHONPATH"] = (
            pkg_parent + os.pathsep + env["PYTHONPATH"]
            if env.get("PYTHONPATH") else pkg_parent
        )
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_tfrecord_torch.serving", *self.extra_args],
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
            env=env,
        )
        with self._lock:
            self.procs.append(p)
        line = p.stdout.readline()
        if not line:
            raise OSError("serving replica died before its ready line")
        return str(_json.loads(line)["addr"])

    def reap(self, timeout: float = 10.0) -> None:
        with self._lock:
            procs = list(self.procs)
        for p in procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=timeout)
                except Exception:  # noqa: BLE001  # graftlint: swallow(best-effort shutdown reap; kill() fallback follows)
                    try:
                        p.kill()
                    except OSError:
                        pass
