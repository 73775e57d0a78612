"""Multi-process coordination over ``torch.distributed``.

Port of ``tpu_tfrecord/tpu/distributed.py``. The process group is gloo:
every collective here moves bytes in CPU tensors (JAX runs them over DCN),
and gloo is the backend that holds more than one rank on one card (NCCL
refuses two ranks on one device). Every process derives the same state
from the same inputs (sorted shard list, interleaved assignment), so
nothing is broadcast but the bytes below:

- ``allgather_bytes``: a variable-length byte string from every rank, in
  rank order (lengths first, then the padded payloads);
- ``merge_schema_across_hosts``: each rank's partial type map folded with
  the same combOp everywhere; a rank's local failure rides the gather in
  place of its map, so no rank raises before the collective and leaves
  its peers blocked in it;
- ``barrier`` / ``finalize_distributed_write``: gloo's monitored barrier,
  which names a rank that never arrives instead of hanging its peers.

Collectives of one group must be issued in the same order on every rank:
call them from one thread of each process at a time.
"""

from __future__ import annotations

import dataclasses
import datetime
import json
import os
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from tpu_tfrecord_torch.infer import TypeMap, merge_type_maps, type_map_to_schema
from tpu_tfrecord_torch.schema import StructType, data_type_from_json

# how long a collective or barrier waits for its peers before it raises
GROUP_TIMEOUT_S = 300.0


def process_slot() -> Tuple[int, int]:
    """(rank, world size) of this process in the default group, (0, 1)
    when no group is up."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def process_index() -> int:
    return process_slot()[0]


def process_count() -> int:
    return process_slot()[1]


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Join the process group; a no-op for one process with no address.

    An argument left ``None`` is read from ``torchrun``'s environment:
    ``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK``. The group is
    gloo over ``tcp://<coordinator_address>``, and its collectives raise
    after ``GROUP_TIMEOUT_S`` instead of waiting for a dead peer forever.
    """
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if num_processes in (None, 1) and coordinator_address is None:
        return
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError(
            "initialize: coordinator_address, num_processes and process_id are all "
            f"needed (got {coordinator_address!r}, {num_processes!r}, {process_id!r})"
        )
    dist.init_process_group(
        backend="gloo",
        init_method=f"tcp://{coordinator_address}",
        world_size=int(num_processes),
        rank=int(process_id),
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S),
    )


def _encode_type_map(type_map: TypeMap) -> bytes:
    obj = {name: (None if dtype is None else dtype.to_json()) for name, dtype in type_map.items()}
    return json.dumps(obj, sort_keys=True).encode("utf-8")


def _decode_type_map(data: bytes) -> TypeMap:
    obj = json.loads(data.decode("utf-8"))
    return {name: (None if t is None else data_type_from_json(t)) for name, t in obj.items()}


class Lockstep:
    """The batches of ``it`` while every rank of the group has one: before
    each, the ranks take the minimum of a has-a-batch flag, so all stop at
    the first batch one of them lacks (a rank with more rows would
    otherwise wait alone in a collective)."""

    def __init__(self, it):
        self.it = it

    def __iter__(self):
        return self

    def __next__(self):
        cb = next(self.it, None)
        have = torch.tensor([0 if cb is None else 1], dtype=torch.int32)
        dist.all_reduce(have, op=dist.ReduceOp.MIN)
        if not int(have.item()):
            raise StopIteration
        return cb


def allgather_bytes(payload: bytes) -> List[bytes]:
    """Every rank's ``payload``, in rank order: the lengths are gathered
    first, then the payloads padded to the longest, as ``uint8`` CPU
    tensors. One process: ``[payload]``."""
    count = process_count()
    if count == 1:
        return [payload]
    length = torch.tensor([len(payload)], dtype=torch.int64)
    lengths = [torch.empty_like(length) for _ in range(count)]
    dist.all_gather(lengths, length)
    sizes = [int(n.item()) for n in lengths]
    width = max(1, max(sizes))  # a zero-width tensor is not sent
    padded = torch.zeros(width, dtype=torch.uint8)
    padded[: len(payload)] = torch.from_numpy(np.frombuffer(payload, dtype=np.uint8).copy())
    gathered = [torch.empty_like(padded) for _ in range(count)]
    dist.all_gather(gathered, padded)
    return [g[:n].numpy().tobytes() for g, n in zip(gathered, sizes)]


class DistributedInferenceError(RuntimeError):
    """One or more processes' local inference failed; raised on every
    process after the allgather, naming the processes that failed."""


def merge_schema_across_hosts(
    local_type_map: TypeMap, local_error: Optional[str] = None
) -> StructType:
    """Distributed schema inference: allgather each process's partial type
    map and fold them with the same combOp, in rank order, on every
    process, so all return the same schema.

    ``local_error``: this process's local fold failed. Pass its message in
    place of raising: it rides the gather in the map's place, and every
    process raises the same ``DistributedInferenceError`` after it."""
    payload = (
        b"E" + local_error.encode("utf-8", "replace")
        if local_error is not None
        else b"M" + _encode_type_map(local_type_map)
    )
    gathered = allgather_bytes(payload)
    errors = [(i, p[1:].decode("utf-8", "replace")) for i, p in enumerate(gathered)
              if p[:1] == b"E"]
    if errors:
        detail = "; ".join(f"process {i}: {msg}" for i, msg in errors)
        raise DistributedInferenceError(
            f"schema inference failed on {len(errors)} process(es): {detail}"
        )
    merged: TypeMap = {}
    for p in gathered:
        merged = merge_type_maps(merged, _decode_type_map(p[1:]))
    return type_map_to_schema(merged)


def barrier(name: str) -> None:
    """Cross-process barrier (a no-op for one process). On gloo it is the
    monitored barrier: rank 0 raises naming the ranks that did not arrive
    within ``GROUP_TIMEOUT_S`` (or died), and the others raise with it."""
    if process_count() == 1:
        return
    timeout = datetime.timedelta(seconds=GROUP_TIMEOUT_S)
    try:
        if dist.get_backend() == "gloo":
            dist.monitored_barrier(timeout=timeout, wait_all_ranks=True)
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def finalize_distributed_write(output_path: str) -> None:
    """The job commit of a write by every process: each process calls it
    after its own ``DatasetWriter`` job committed (written with
    ``write_success=False`` and ``task_id`` = its rank, so part files never
    collide). All barrier, rank 0 alone writes ``_SUCCESS``, all barrier
    again: when this returns on any process, the marker exists."""
    from tpu_tfrecord_torch.io.paths import write_success_marker

    barrier(f"tfr_write_commit:{output_path}")
    if process_index() == 0:
        write_success_marker(output_path)
    barrier(f"tfr_write_done:{output_path}")


def adopt_shared_trace_context(role: str = "worker"):
    """Give every process of the group one trace id, rank 0's, adopted on
    the process-global recorder: each contributes its context to one
    allgather and takes index 0's ids. Ranks other than 0 record rank 0's
    span as their parent; each keeps its own span id, host and pid.
    Returns the adopted ``TraceContext``; one process adopts its own
    context with ``role``."""
    from tpu_tfrecord_torch import telemetry

    local = telemetry.current_context()
    gathered = allgather_bytes(json.dumps(local.to_json(), sort_keys=True).encode("utf-8"))
    root = telemetry.TraceContext.from_json(json.loads(gathered[0].decode("utf-8")))
    ctx = dataclasses.replace(
        local,
        trace_id=root.trace_id,
        parent_span_id=None if process_index() == 0 else root.span_id,
        role=role,
    )
    return telemetry.adopt(ctx)


def shared_service_address(addr: str) -> str:
    """Check that every process points its consumers at the same
    data-service dispatcher before any bytes flow; returns ``addr``."""
    assert_same_across_hosts(str(addr).encode("utf-8"), "data-service dispatcher address")
    return str(addr)


def assert_same_across_hosts(value: bytes, what: str = "value") -> None:
    """Raise on every process when ``value`` (schema JSON, a shard-list
    digest) differs between processes."""
    if any(g != value for g in allgather_bytes(value)):
        raise RuntimeError(f"{what} differs across hosts")
