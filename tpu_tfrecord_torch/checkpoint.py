"""Checkpoints of the dataset's position and of train state: port of
``tpu_tfrecord/checkpoint.py``.

The iterator's O(1) position (``io.dataset.IteratorState``) persists as a
small JSON file a process (``save_state`` / ``load_state``), written
durably. Train state persists as generations written in two phases:

- **snapshot** (the caller's thread, all the train loop blocks on, the
  ``ckpt.snapshot`` stage): every leaf of the tree copied once into reused
  host buffers (a CUDA tensor into a pinned buffer, on the current stream,
  an event recorded after the copies and waited on), plus the JSON
  payload;
- **commit** (one background thread, ``ckpt.commit``): the process's shard
  ``gen-<step>/shard-<pid>.npz`` (``meta`` + ``leaf_<i>``) written to a tmp
  twin, fsynced and renamed, then the generation's ``MANIFEST.json`` LAST
  through the same helper. A kill -9 at any point leaves the newest
  complete generation restorable.

At most one commit is in flight: the next ``save()`` waits for the
previous one (a ``ckpt.commit_wait`` record), ``wait()`` / ``close()``
drain, and a commit's failure re-raises on the next call as
``CheckpointCommitError``. The layout, the versions and the chaos seam
(``TFR_CKPT_CHAOS_*``) are the JAX package's, so either package restores
what the other wrote.

A tree is flattened as ``jax.tree.flatten`` flattens the same nesting
(``tree_flatten``): dicts by sorted key, lists and tuples in order,
NamedTuples by field, None as no leaf. Leaves are torch tensors or numpy
arrays (or scalars); a leaf numpy cannot hold (bfloat16) raises, naming
it. ``restore`` gives numpy arrays, or CPU tensors where the template
holds tensors: moving them to the device is the caller's step
(``models.dlrm.load_train_state``).

``TrainCheckpointer`` pairs the model tree with the input position in one
generation (the position is the payload), so the pairing commits
atomically with the manifest. The JAX one is built on orbax; this one on
``AsyncCheckpointer`` (the chip machine has no orbax).

The process index comes from ``torch.distributed`` when it is
initialized, else 0.
"""

from __future__ import annotations

import json
import os
import queue
import shutil
import sys
import threading
import time
import zipfile
from typing import Any, Callable, List, Optional, Tuple

import numpy as np
import torch

from tpu_tfrecord_torch.device.distributed import process_slot
# the durable-write helpers live in a torch-free module (the data service's
# dispatcher journals through them); they are this module's names too
from tpu_tfrecord_torch.durable import (  # noqa: F401
    FencedWriteError,
    _chaos_point,
    _fsync_dir,
    durable_append,
    durable_write,
)
from tpu_tfrecord_torch.io.dataset import CheckpointableIterator, IteratorState

_FORMAT_VERSION = 1
# Version 2: the state carries ``window_emitted`` (a position inside a
# shuffle window). An old reader that dropped it would replay batches, so
# such states are written as version 2, which old readers refuse.
_FORMAT_VERSION_WINDOWED = 2
_READABLE_VERSIONS = (1, 2)


def state_path(directory: str, process_index: Optional[int] = None) -> str:
    """Per-process state file ('_input_state.<pid>.json'). "_"-prefixed
    like _SUCCESS, so shard discovery never reads it as a shard."""
    if process_index is None:
        process_index = process_slot()[0]
    return os.path.join(directory, f"_input_state.{process_index}.json")


def _extract_state(state_or_iterator) -> IteratorState:
    return (
        state_or_iterator.state()
        if isinstance(state_or_iterator, CheckpointableIterator)
        else state_or_iterator
    )


def _make_payload(state: IteratorState, step: Optional[int] = None) -> dict:
    version = _FORMAT_VERSION_WINDOWED if getattr(state, "window_emitted", 0) else _FORMAT_VERSION
    payload = {"version": version, "state": state.to_json()}
    if step is not None:
        payload["step"] = step
    return payload


def _check_version(payload: dict, where: str) -> None:
    if payload.get("version") not in _READABLE_VERSIONS:
        raise ValueError(f"unsupported input-state version {payload.get('version')} {where}")


# ---------------------------------------------------------------------------
# Trees
# ---------------------------------------------------------------------------


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def tree_flatten_with_path(tree, path: str = "") -> Tuple[List[Tuple[str, Any]], Any]:
    """([(path, leaf)], treedef) in ``jax.tree.flatten``'s leaf order;
    ``path`` names a leaf like ``['params']['w'][0]``."""
    if tree is None:
        return [], None
    if isinstance(tree, dict):
        keys = sorted(tree)
        out, defs = [], []
        for k in keys:
            leaves, d = tree_flatten_with_path(tree[k], f"{path}[{k!r}]")
            out += leaves
            defs.append(d)
        return out, ("dict", keys, defs)
    if _is_namedtuple(tree):
        out, defs = [], []
        for name in tree._fields:
            leaves, d = tree_flatten_with_path(getattr(tree, name), f"{path}.{name}")
            out += leaves
            defs.append(d)
        return out, ("namedtuple", type(tree), defs)
    if isinstance(tree, (list, tuple)):
        out, defs = [], []
        for i, item in enumerate(tree):
            leaves, d = tree_flatten_with_path(item, f"{path}[{i}]")
            out += leaves
            defs.append(d)
        return out, (type(tree).__name__, len(tree), defs)
    return [(path, tree)], "leaf"


def tree_flatten(tree) -> Tuple[list, Any]:
    """(leaves, treedef), the leaves in ``jax.tree.flatten``'s order."""
    leaves, treedef = tree_flatten_with_path(tree)
    return [leaf for _, leaf in leaves], treedef


def _count(treedef) -> int:
    if treedef is None:
        return 0
    if treedef == "leaf":
        return 1
    return sum(_count(d) for d in treedef[2])


def tree_unflatten(treedef, leaves: list):
    """The inverse of ``tree_flatten``."""
    leaves = list(leaves)
    if len(leaves) != _count(treedef):
        raise ValueError(f"{len(leaves)} leaves for a tree of {_count(treedef)}")

    def build(d):
        if d is None:
            return None
        if d == "leaf":
            return leaves.pop(0)
        kind, meta, defs = d
        items = [build(sub) for sub in defs]
        if kind == "dict":
            return dict(zip(meta, items))
        if kind == "namedtuple":
            return meta(*items)
        return list(items) if kind == "list" else tuple(items)

    return build(treedef)


# ---------------------------------------------------------------------------
# Durability primitives
# ---------------------------------------------------------------------------


class TornStateError(ValueError):
    """A state or checkpoint file exists but its bytes cannot be parsed:
    a torn write (a crash that outran fsync) or foreign bytes."""


class CheckpointCommitError(RuntimeError):
    """A background checkpoint commit failed. Raised on the NEXT
    ``save()`` / ``wait()`` / ``close()``; ``__cause__`` is the original."""


def save_state(
    directory: str,
    state_or_iterator,
    process_index: Optional[int] = None,
    step: Optional[int] = None,
) -> str:
    """Durably persist an iterator's position (or an ``IteratorState``);
    returns the file's path."""
    state = _extract_state(state_or_iterator)
    os.makedirs(directory, exist_ok=True)
    path = state_path(directory, process_index)
    durable_write(path, json.dumps(_make_payload(state, step)).encode("utf-8"), chaos="state")
    return path


def load_state(directory: str, process_index: Optional[int] = None) -> Optional[IteratorState]:
    """This process's saved position; None if there is none. A file that
    cannot be parsed raises ``TornStateError``."""
    path = state_path(directory, process_index)
    if not os.path.exists(path):
        return None
    try:
        with open(path) as fh:
            payload = json.load(fh)
    except (ValueError, UnicodeDecodeError) as e:
        raise TornStateError(
            f"input-state file {path} exists but cannot be parsed "
            f"({type(e).__name__}: {e}) — a torn write from a crash that "
            "outran fsync, or foreign bytes. Delete the file to start "
            "fresh, or restore it alongside its model checkpoint."
        ) from e
    _check_version(payload, f"at {path}")
    return IteratorState.from_json(payload["state"])


# ---------------------------------------------------------------------------
# The background commit lane
# ---------------------------------------------------------------------------


class _Commit:
    """One commit: its closure, its completion event and its error."""

    __slots__ = ("step", "fn", "done", "error")

    def __init__(self, step: int, fn: Callable[[], None]):
        self.step = step
        self.fn = fn
        self.done = threading.Event()
        self.error: Optional[BaseException] = None


class _CommitWorker:
    """One daemon commit thread, at most one commit in flight.

    ``reserve()`` (the caller's thread) waits out the previous commit (a
    ``ckpt.commit_wait`` record) and re-raises its failure; ``submit``
    hands the next one over; ``run_inline`` is the sync twin (same
    throttle, same ``ckpt.commit`` stage, the caller's thread).
    ``commit_delay_s`` (env ``TFR_CKPT_COMMIT_THROTTLE_S`` when unset)
    slows every commit, a seeded slow disk for tests."""

    def __init__(self, metrics=None, commit_delay_s: Optional[float] = None):
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        self.metrics = metrics
        if commit_delay_s is None:
            env = os.environ.get("TFR_CKPT_COMMIT_THROTTLE_S")
            commit_delay_s = float(env) if env else 0.0
        self.commit_delay_s = float(commit_delay_s)
        self._queue: "queue.Queue[Optional[_Commit]]" = queue.Queue(maxsize=1)
        self._last: Optional[_Commit] = None
        self._thread: Optional[threading.Thread] = None

    def reserve(self) -> None:
        """Block until the previous commit is done (counted as
        ``ckpt.commit_wait``) and re-raise its failure."""
        job = self._last
        if job is not None and not job.done.is_set():
            t0 = time.perf_counter()
            job.done.wait()
            waited = time.perf_counter() - t0
            self.metrics.add("ckpt.commit_wait", records=1, seconds=waited, latency=waited)
        self.wait()

    def submit(self, step: int, fn: Callable[[], None]) -> None:
        """Hand one commit to the background thread (after ``reserve()``)."""
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(target=self._run, name="ckpt-commit", daemon=True)
            self._thread.start()
        job = _Commit(step, fn)
        self._last = job
        self.metrics.gauge("ckpt.inflight", 1)
        self._queue.put(job)

    def run_inline(self, step: int, fn: Callable[[], None]) -> None:
        """The sync twin: the commit on the caller's thread."""
        self._execute(_Commit(step, fn))
        self.wait()

    def wait(self) -> None:
        """Drain the in-flight commit; re-raise its failure as
        ``CheckpointCommitError``."""
        job = self._last
        if job is None:
            return
        job.done.wait()
        self._last = None
        if job.error is not None:
            raise CheckpointCommitError(
                f"background checkpoint commit of step {job.step} failed: {job.error!r}"
            ) from job.error

    def close(self) -> None:
        """Drain, then stop the worker thread."""
        try:
            self.wait()
        finally:
            if self._thread is not None and self._thread.is_alive():
                self._queue.put(None)
                self._thread.join(timeout=30)
            self._thread = None

    def _execute(self, job: _Commit) -> None:
        t0 = time.perf_counter()
        try:
            if self.commit_delay_s:
                time.sleep(self.commit_delay_s)
            job.fn()
        except BaseException as e:  # re-raised by wait()/reserve() as CheckpointCommitError
            job.error = e
        finally:
            dt = time.perf_counter() - t0
            self.metrics.add("ckpt.commit", records=1, seconds=dt, latency=dt)
            self.metrics.gauge("ckpt.inflight", 0)
            job.done.set()

    def _run(self) -> None:
        while True:
            job = self._queue.get()
            if job is None:
                return
            self._execute(job)


# ---------------------------------------------------------------------------
# AsyncCheckpointer
# ---------------------------------------------------------------------------

_GEN_PREFIX = "gen-"
_MANIFEST_VERSION = 1


def _host_dtype(path: str, leaf) -> np.dtype:
    """The numpy dtype a leaf is stored in; a tensor dtype numpy has no
    counterpart for raises (no silent cast)."""
    if isinstance(leaf, torch.Tensor):
        try:
            return torch.empty(0, dtype=leaf.dtype).numpy().dtype
        except TypeError as e:
            raise TypeError(
                f"checkpoint leaf {path or '<root>'} is {leaf.dtype}, which numpy cannot "
                "hold: cast it explicitly before saving"
            ) from e
    return np.asarray(leaf).dtype


class AsyncCheckpointer:
    """Train state + O(1) payload as generations with a manifest-last
    commit on a background thread (the JAX ``AsyncCheckpointer``).

    ``save(step, tree, payload)`` snapshots on the caller's thread: every
    leaf is copied once into a reused host buffer (CUDA tensors into pinned
    buffers with ``non_blocking`` copies on the current stream, then one
    event recorded and waited on, so the caller may mutate the tensors as
    soon as ``save`` returns), and the commit goes to the background
    thread (inline with ``sync``). Buffers are reused while the leaves'
    shapes and dtypes stay the same; ``reserve()`` keeps the next save
    from touching them until the previous commit is done. The first save
    allocates them (pinning host memory), so it is slower than the rest.

    Layout::

        directory/
          gen-00000008/
            shard-00000.npz     # meta + leaf_<i>, fsynced, renamed
            MANIFEST.json       # written last: the generation is complete
          gen-00000016/ ...

    Commits sweep complete generations beyond ``keep`` and dead ones
    (shards, no manifest, older than the newest), each counted in
    ``ckpt.generations_swept``. On more than one process pass ``barrier``
    so process 0 writes the manifest after every shard landed.
    """

    MANIFEST = "MANIFEST.json"

    def __init__(
        self,
        directory: str,
        *,
        keep: Optional[int] = 2,
        process_index: Optional[int] = None,
        process_count: Optional[int] = None,
        sync: bool = False,
        commit_delay_s: Optional[float] = None,
        barrier: Optional[Callable[[], None]] = None,
        metrics=None,
    ):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        index, count = process_slot()
        self.process_index = int(index if process_index is None else process_index)
        self.process_count = int(count if process_count is None else process_count)
        self.keep = keep
        self.sync = bool(sync)
        self._barrier = barrier
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        self.metrics = metrics
        self._worker = _CommitWorker(metrics=metrics, commit_delay_s=commit_delay_s)
        self._bufs: Optional[List[np.ndarray]] = None
        self._pinned: List[Optional[torch.Tensor]] = []

    # -- layout --------------------------------------------------------------

    def _gen_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"{_GEN_PREFIX}{step:08d}")

    def _shard_name(self, process_index: int) -> str:
        return f"shard-{process_index:05d}.npz"

    # -- save ----------------------------------------------------------------

    def _alloc(self, leaves) -> None:
        """Host buffers for ``leaves``: pinned tensors (seen as numpy) for
        CUDA tensors, plain numpy arrays for the rest."""
        bufs, pinned = [], []
        for path, leaf in leaves:
            dtype = _host_dtype(path, leaf)
            if isinstance(leaf, torch.Tensor):
                host = torch.empty(tuple(leaf.shape), dtype=leaf.dtype,
                                   pin_memory=leaf.is_cuda)
                pinned.append(host)
                bufs.append(host.numpy())
            else:
                pinned.append(None)
                bufs.append(np.empty(np.shape(leaf), dtype))
        self._bufs, self._pinned = bufs, pinned

    def _snapshot(self, leaves) -> None:
        """Copy every leaf into its buffer; CUDA copies are queued on the
        current stream and one event after them is waited on."""
        bufs = self._bufs
        if bufs is None or len(bufs) != len(leaves) or any(
            b.shape != tuple(np.shape(leaf)) or b.dtype != _host_dtype(path, leaf)
            for b, (path, leaf) in zip(bufs, leaves)
        ):
            self._alloc(leaves)
        event = None
        for (_, leaf), buf, host in zip(leaves, self._bufs, self._pinned):
            if isinstance(leaf, torch.Tensor):
                host.copy_(leaf.detach(), non_blocking=leaf.is_cuda)
                if leaf.is_cuda:
                    event = event or torch.cuda.Event()
            else:
                np.copyto(buf, np.asarray(leaf))
        if event is not None:
            event.record(torch.cuda.current_stream())
            event.synchronize()

    def save(self, step: int, state_pytree, payload: Optional[dict] = None) -> None:
        """Snapshot ``state_pytree`` + ``payload`` for ``step`` and hand the
        commit to the background thread (inline when ``sync``)."""
        self._worker.reserve()  # the buffers are reused: previous commit first
        t0 = time.perf_counter()
        leaves, _ = tree_flatten_with_path(state_pytree)
        self._snapshot(leaves)
        meta = json.dumps({"step": int(step), "payload": payload or {}}).encode("utf-8")
        _chaos_point("snapshot")
        dt = time.perf_counter() - t0
        self.metrics.add("ckpt.snapshot", records=1, seconds=dt, latency=dt)
        bufs = self._bufs

        def commit() -> None:
            self._commit(int(step), bufs, meta)

        if self.sync:
            self._worker.run_inline(int(step), commit)
        else:
            self._worker.submit(int(step), commit)

    def _commit(self, step: int, leaves, meta: bytes) -> None:
        gen = self._gen_dir(step)
        os.makedirs(gen, exist_ok=True)
        # tmp orphans of an earlier life of this generation: this process's
        # own only (its shard's, and the manifest's on process 0), since
        # another process may be writing its shard's tmp twin right now
        mine = [self._shard_name(self.process_index) + ".tmp."]
        if self.process_index == 0:
            mine.append(self.MANIFEST + ".tmp.")
        for name in os.listdir(gen):
            if name.startswith(tuple(mine)):
                try:
                    os.remove(os.path.join(gen, name))
                except OSError:
                    pass
        shard = os.path.join(gen, self._shard_name(self.process_index))

        def write(fh) -> None:
            np.savez(
                fh,
                meta=np.frombuffer(meta, np.uint8),
                **{f"leaf_{i}": a for i, a in enumerate(leaves)},
            )

        durable_write(shard, write_fn=write, chaos="shard")
        self.metrics.count("ckpt.bytes_written", os.path.getsize(shard))
        _chaos_point("pre_manifest")
        if self._barrier is not None:
            self._barrier()  # every process's shard lands first
        if self.process_index == 0:
            manifest = {
                "version": _MANIFEST_VERSION,
                "step": step,
                "process_count": self.process_count,
                "shards": [self._shard_name(i) for i in range(self.process_count)],
            }
            durable_write(os.path.join(gen, self.MANIFEST),
                          json.dumps(manifest).encode("utf-8"), chaos="manifest")
            self._sweep(step)

    def _sweep(self, newest_step: int) -> None:
        """Retire complete generations beyond ``keep`` and remove dead ones
        (no manifest, older than the generation just committed)."""
        complete, dead = [], []
        for name in os.listdir(self.directory):
            if not name.startswith(_GEN_PREFIX):
                continue
            try:
                step = int(name[len(_GEN_PREFIX):])
            except ValueError:
                continue
            if os.path.exists(os.path.join(self.directory, name, self.MANIFEST)):
                complete.append(step)
            elif step < newest_step:
                dead.append(step)
        complete.sort()
        retired = complete[: -self.keep] if self.keep else []
        for step in retired + dead:
            shutil.rmtree(self._gen_dir(step), ignore_errors=True)
            self.metrics.count("ckpt.generations_swept")

    # -- restore -------------------------------------------------------------

    def _complete_generations(self) -> List[int]:
        """Ascending steps of every complete generation: its manifest
        parses and every shard it names exists."""
        out = []
        if not os.path.isdir(self.directory):
            return out
        for name in os.listdir(self.directory):
            if not name.startswith(_GEN_PREFIX):
                continue
            try:
                step = int(name[len(_GEN_PREFIX):])
            except ValueError:
                continue
            gen = os.path.join(self.directory, name)
            try:
                with open(os.path.join(gen, self.MANIFEST)) as fh:
                    manifest = json.load(fh)
            except (OSError, ValueError, UnicodeDecodeError):
                continue
            shards = manifest.get("shards") or []
            if shards and all(os.path.exists(os.path.join(gen, s)) for s in shards):
                out.append(step)
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self._complete_generations()
        return steps[-1] if steps else None

    def restore(self, template_pytree):
        """(step, tree, payload) from the newest complete generation, or
        (None, template, None) when there is none. The tree has the
        template's structure; a leaf is a numpy array, or a CPU tensor over
        it where the template's leaf is a tensor. A generation whose shard
        does not load falls back one generation, loudly."""
        for step in reversed(self._complete_generations()):
            shard = os.path.join(self._gen_dir(step), self._shard_name(self.process_index))
            try:
                with np.load(shard) as z:
                    meta = json.loads(z["meta"].tobytes().decode("utf-8"))
                    leaves = [z[f"leaf_{i}"] for i in range(len(z.files) - 1)]
            except (OSError, ValueError, KeyError, zipfile.BadZipFile) as e:
                print(
                    f"checkpoint generation {step} at {shard} unreadable "
                    f"({type(e).__name__}: {e}); falling back a generation",
                    file=sys.stderr,
                )
                continue
            template, treedef = tree_flatten(template_pytree)
            leaves = [torch.from_numpy(a) if isinstance(t, torch.Tensor) else a
                      for a, t in zip(leaves, template)]
            return meta["step"], tree_unflatten(treedef, leaves), meta.get("payload") or {}
        return None, template_pytree, None

    # -- lifecycle -----------------------------------------------------------

    def wait(self) -> None:
        """Drain the in-flight commit (re-raising its failure)."""
        self._worker.wait()

    def clear(self) -> None:
        """Remove every generation (after draining the commit)."""
        self._worker.wait()
        for name in os.listdir(self.directory):
            if name.startswith(_GEN_PREFIX):
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)

    def close(self) -> None:
        self._worker.close()

    def __enter__(self) -> "AsyncCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class AsyncStateSaver:
    """``save_state``'s async twin: the position is read on the caller's
    thread (``ckpt.snapshot``), the durable write runs on the commit thread
    (``ckpt.commit``) under the same one-in-flight contract. Same file,
    same bytes as ``save_state``."""

    def __init__(
        self,
        directory: str,
        process_index: Optional[int] = None,
        *,
        sync: bool = False,
        commit_delay_s: Optional[float] = None,
        metrics=None,
    ):
        self.directory = directory
        self.process_index = process_index
        self.sync = bool(sync)
        if metrics is None:
            from tpu_tfrecord_torch.metrics import METRICS as metrics  # noqa: N813
        self.metrics = metrics
        self._worker = _CommitWorker(metrics=metrics, commit_delay_s=commit_delay_s)

    def save(self, state_or_iterator, step: Optional[int] = None) -> str:
        """Snapshot the position now; persist it in the background.
        Returns the (eventual) state file's path."""
        self._worker.reserve()
        t0 = time.perf_counter()
        data = json.dumps(_make_payload(_extract_state(state_or_iterator), step)).encode("utf-8")
        path = state_path(self.directory, self.process_index)
        dt = time.perf_counter() - t0
        self.metrics.add("ckpt.snapshot", records=1, seconds=dt, latency=dt)

        def commit() -> None:
            os.makedirs(self.directory, exist_ok=True)
            durable_write(path, data, chaos="state")
            self.metrics.count("ckpt.bytes_written", len(data))

        if self.sync:
            self._worker.run_inline(step or 0, commit)
        else:
            self._worker.submit(step or 0, commit)
        return path

    def wait(self) -> None:
        self._worker.wait()

    def close(self) -> None:
        self._worker.close()

    def __enter__(self) -> "AsyncStateSaver":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class TrainCheckpointer:
    """Model state + input position, saved together per step.

    The tree is the generation's state and the position its payload, in
    one ``AsyncCheckpointer`` generation, so the manifest commits the
    pairing atomically: no restorable step has parameters without its
    input position. ``async_save=False`` commits on the caller's thread.

    Usage::

        ckpt = TrainCheckpointer("/ckpts", max_to_keep=1)
        ckpt.save(step, train_state(model, opt), it)
        ...
        step, tree, resume = ckpt.restore(train_state(model, opt))
        load_train_state(model, opt, tree)
        with ds.batches(resume) as it: ...
    """

    def __init__(
        self,
        directory: str,
        max_to_keep: Optional[int] = None,
        *,
        async_save: bool = True,
        commit_delay_s: Optional[float] = None,
        metrics=None,
    ):
        self.async_save = bool(async_save)
        self._ckpt = AsyncCheckpointer(directory, keep=max_to_keep, sync=not self.async_save,
                                       commit_delay_s=commit_delay_s, metrics=metrics)
        self.directory = self._ckpt.directory
        self.metrics = self._ckpt.metrics

    def save(self, step: int, state_pytree, state_or_iterator) -> None:
        """Snapshot the tree and the input position for ``step``; the
        commit follows in the background (``wait``/``close`` drain)."""
        payload = _make_payload(_extract_state(state_or_iterator), step)
        self._ckpt.save(step, state_pytree, payload)

    def wait(self) -> None:
        self._ckpt.wait()

    def latest_step(self) -> Optional[int]:
        return self._ckpt.latest_step()

    def restore(self, template_pytree):
        """(step, tree, IteratorState) of the newest complete generation,
        or (None, template, None) when there is none."""
        step, tree, payload = self._ckpt.restore(template_pytree)
        if step is None:
            return None, template_pytree, None
        _check_version(payload, f"in checkpoint step {step}")
        return step, tree, IteratorState.from_json(payload["state"])

    def clear(self) -> None:
        self._ckpt.clear()

    def close(self) -> None:
        self._ckpt.close()

    def __enter__(self) -> "TrainCheckpointer":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
