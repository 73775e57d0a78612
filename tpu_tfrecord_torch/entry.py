"""Entry points of the port: the flagship DLRM forward, the serving path
from TFRecord files to logits, and the training path from TFRecord files to
updated weights.

- ``entry(device)``: (fn, args) of one DLRM forward on a synthetic batch,
  the counterpart of ``__graft_entry__.py::entry``.
- ``write_dryrun_dataset``: SequenceExample shard dirs with the schema of
  ``__graft_entry__.py::_write_dryrun_dataset``.
- ``score_files``: the feed -> DLRM forward, batch by batch, for every
  shard under a directory. The feed: ``TFRecordDataset`` (native decode on
  a producer thread, ``num_workers`` shards at a time) ->
  ``HostPrefetcher`` (``host_batch_from_columnar``, ``log1p``, the label
  cast and the optional wire packing, on its own thread) ->
  ``DeviceIterator`` (copies on a side stream out of a pinned ring, a batch
  ahead or on a transfer thread).
- ``train_files``: the same feed (optionally shuffled, optionally
  bit-packed on the wire) -> a sparse (row-wise AdaGrad on the table) or
  dense train step per batch; the counterpart of the loop in
  ``examples/train_dlrm.py`` and of the bench's DLRM feed
  (``bench.py::_train_duty_cycle``) without their harness, checkpoints and
  resume.
"""

from __future__ import annotations

import contextlib
import os
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from tpu_tfrecord_torch.device.bitpack import pack_mixed, unpack_bits
from tpu_tfrecord_torch.device.ingest import (
    DeviceIterator,
    HostPrefetcher,
    host_batch_from_columnar,
    make_device_batch,
)
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.models.dlrm import (
    DLRM,
    DLRMConfig,
    SparseEmbOptState,
    init_params,
    make_synthetic_batch,
    sparse_opt_init,
    sparse_train_step,
    train_step,
)
from tpu_tfrecord_torch.schema import (
    ArrayType,
    FloatType,
    IntegerType,
    LongType,
    StringType,
    StructField,
    StructType,
)
from tpu_tfrecord_torch.tracing import DutyCycle


def entry(device="cuda"):
    """(fn, (batch,)): one forward of the flagship DLRM (dot interaction,
    sequence tower) on a synthetic batch of 32, on ``device``."""
    cfg = DLRMConfig(seq_len=16, seq_dim=8, interaction="dot")
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    batch = make_device_batch(make_synthetic_batch(cfg, batch_size=32, seed=0), device)
    return model, (batch,)


def dryrun_schema(cfg: DLRMConfig) -> StructType:
    """label + d1..dN longs + c1..cM strings + the ragged 'frames' list."""
    return StructType(
        [StructField("label", LongType(), nullable=False)]
        + [StructField(f"d{i}", LongType()) for i in range(1, cfg.num_dense + 1)]
        + [StructField(f"c{i}", StringType()) for i in range(1, cfg.num_categorical + 1)]
        + [StructField("frames", ArrayType(ArrayType(FloatType())))]
    )


def dryrun_rows(cfg: DLRMConfig, rng: np.random.Generator, n_rows: int, vocab: int):
    """Rows of ``dryrun_schema``, drawn from ``rng`` in the JAX dryrun's order."""
    for _ in range(n_rows):
        row = [int(rng.integers(0, 2))]
        row += [int(v) for v in rng.integers(0, 100, size=cfg.num_dense)]
        row += [f"tok{int(rng.integers(0, vocab * 4))}" for _ in range(cfg.num_categorical)]
        n_frames = int(rng.integers(1, cfg.seq_len + 1))
        row.append(
            [[float(x) for x in rng.normal(size=cfg.seq_dim)] for _ in range(n_frames)]
        )
        yield row


def write_dryrun_dataset(
    data_dir: str, cfg: DLRMConfig, shard_rows: Sequence[int], vocab: int
) -> None:
    """Shard dirs 'shard00', 'shard01', ... of SequenceExample rows, shard
    ``i`` seeded with ``1234 + i``, through the port's own writer."""
    from tpu_tfrecord_torch import io as tfio

    schema = dryrun_schema(cfg)
    for idx, n in enumerate(shard_rows):
        rng = np.random.default_rng(1234 + idx)
        tfio.write(
            list(dryrun_rows(cfg, rng, n, vocab)),
            schema,
            os.path.join(data_dir, f"shard{idx:02d}"),
            mode="overwrite",
            recordType="SequenceExample",
        )


@dataclass
class ScoreResult:
    """Logits of every scored row, in file order, and times in seconds.

    The feed's threads decode, densify and copy ahead while the loop
    scores, so the per-batch times overlap that work and do not add up to
    the wall time:

    - ``host_s``: the loop's wait in the ``DeviceIterator``'s ``next()``;
    - ``h2d_s``: the share of that wait spent on transfers, the increment
      of ``DeviceIterator.transfer_seconds`` over it (at most the wait):
      issuing the next batch's copies in dispatch-ahead mode, or what the
      transfer thread finished meanwhile;
    - ``forward_s``: the forward, its stream synchronized on a CUDA device;
    - ``done_s``: when each batch's forward finished, from the loop's start;
    - ``wall_s``: the whole loop, from starting the producer to the last
      batch. Rows/s and the device's idle share come from it;
    - ``duty_cycle``: ``tracing.DutyCycle`` of the loop, forward time over
      forward plus wait time.
    """

    logits: torch.Tensor
    host_s: List[float] = field(default_factory=list)
    h2d_s: List[float] = field(default_factory=list)
    forward_s: List[float] = field(default_factory=list)
    done_s: List[float] = field(default_factory=list)
    wall_s: float = 0.0
    duty_cycle: Optional[float] = None

    @property
    def batches(self) -> int:
        return len(self.forward_s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


WIRE = "wire"  # the pack group of the bit-packed read: label, dense, cat


def _read_plan(data_dir, cfg: DLRMConfig, dense_cols, cat_cols, wire: bool = False):
    """(paths, hash_buckets, pack, pad_to) of the DLRM's read: the dryrun
    column names unless given, the categoricals hashed into
    ``cfg.vocab_size`` buckets, dense and cat packed (with ``wire``, the
    label, dense and cat in one group, in that order), a directory of
    'shard*' dirs expanded to them."""
    dense_cols = dense_cols or [f"d{i}" for i in range(1, cfg.num_dense + 1)]
    cat_cols = cat_cols or [f"c{i}" for i in range(1, cfg.num_categorical + 1)]
    hash_buckets = {c: cfg.vocab_size for c in cat_cols}
    if wire:
        pack = {WIRE: ["label"] + dense_cols + cat_cols}
    else:
        pack = {"dense": dense_cols, "cat": cat_cols}
    pad_to = {"frames": (cfg.seq_len, cfg.seq_dim)} if cfg.seq_len else {}
    paths = data_dir
    if isinstance(data_dir, (str, os.PathLike)) and os.path.isdir(data_dir):
        shard_dirs = sorted(
            os.path.join(data_dir, d) for d in os.listdir(data_dir) if d.startswith("shard")
        )
        paths = shard_dirs or data_dir
    return paths, hash_buckets, pack, pad_to


def _host_batch(cb, ds: TFRecordDataset, pad_to, log1p_dense: bool, float_label: bool = False):
    """One host batch as the step takes it: densified, dense through
    log(1 + max(x, 0)) and the label cast to float32 when asked."""
    hb = host_batch_from_columnar(
        cb, ds.schema, pad_to=pad_to, hash_buckets=ds.hash_buckets, pack=ds.pack
    )
    hb.pop("frames_inner_len", None)  # per-frame lengths: unused by DLRM
    if log1p_dense:
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
    if float_label:
        hb["label"] = hb["label"].astype(np.float32)
    return hb


def _split_wire(batch, cfg: DLRMConfig, wire_bits: int):
    """The wire group on the device -> label (float32), dense (float32,
    log(1 + max(x, 0)), computed in float64 as the host path computes it)
    and cat (``unpack_bits``)."""
    m = batch.pop(WIRE)
    nd = cfg.num_dense
    batch["label"] = m[:, 0].float()
    batch["dense"] = torch.log1p(m[:, 1:1 + nd].clamp(min=0).double()).float()
    batch["cat"] = unpack_bits(m[:, 1 + nd:], cfg.num_categorical, wire_bits)
    return batch


@contextlib.contextmanager
def _device_feed(ds: TFRecordDataset, device, transfer_thread: bool, to_host):
    """dataset -> HostPrefetcher (``to_host`` on its thread) ->
    DeviceIterator; every thread is stopped and joined on the way out."""
    with ds.batches() as it, HostPrefetcher(map(to_host, it)) as pf, \
            DeviceIterator(pf, device, transfer_thread=transfer_thread) as dev:
        yield dev


def _drive(dev: DeviceIterator, device, step, times) -> tuple:
    """Run ``step`` on every batch of ``dev``, its stream synchronized after
    each; append to ``times`` = (host_s, h2d_s, step_s, done_s). Returns
    (outputs, wall seconds, duty cycle)."""
    host_s, h2d_s, step_s, done_s = times
    duty = DutyCycle()
    outs = []
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        moved = dev.transfer_seconds
        with duty.wait():
            batch = next(dev, None)
        t1 = time.perf_counter()
        if batch is None:
            break
        with duty.step():
            outs.append(step(batch))
            _sync(device)
        t2 = time.perf_counter()
        host_s.append(t1 - t0)
        h2d_s.append(min(max(0.0, dev.transfer_seconds - moved), t1 - t0))
        step_s.append(t2 - t1)
        done_s.append(t2 - start)
    return outs, time.perf_counter() - start, duty.value()


@torch.no_grad()
def score_files(
    data_dir,
    cfg: DLRMConfig,
    params: DLRM,
    batch_size: int,
    device="cuda",
    *,
    recordType: str = "SequenceExample",
    schema: Optional[StructType] = None,
    dense_cols: Optional[List[str]] = None,
    cat_cols: Optional[List[str]] = None,
    log1p_dense: bool = False,
    num_epochs: int = 1,
    num_workers: int = 1,
    transfer_thread: bool = False,
) -> ScoreResult:
    """Score every full batch of the dataset under ``data_dir`` (a path, a
    list of paths, or a directory of 'shard*' dirs) with the DLRM ``params``,
    ``num_epochs`` times over.

    Columns default to the dryrun names (d1..dN dense, c1..cM categorical,
    'frames' when the config has a sequence tower); the categorical columns
    are hashed into ``cfg.vocab_size`` buckets and both groups are packed.
    ``log1p_dense`` applies the usual Criteo preprocessing log(1 + max(x, 0))
    to the dense group on the host. ``num_workers`` shards decode at a time;
    ``transfer_thread`` moves the copies to the ``DeviceIterator``'s
    transfer thread."""
    device = torch.device(device)
    paths, hash_buckets, pack, pad_to = _read_plan(data_dir, cfg, dense_cols, cat_cols)
    ds = TFRecordDataset(
        paths,
        batch_size=batch_size,
        schema=schema,
        recordType=recordType,
        hash_buckets=hash_buckets,
        pack=pack,
        num_epochs=num_epochs,
        num_workers=num_workers,
    )
    result = ScoreResult(logits=torch.empty(0))
    times = (result.host_s, result.h2d_s, result.forward_s, result.done_s)
    to_host = lambda cb: _host_batch(cb, ds, pad_to, log1p_dense)  # noqa: E731
    with _device_feed(ds, device, transfer_thread, to_host) as dev:
        outs, result.wall_s, result.duty_cycle = _drive(dev, device, params, times)
    result.logits = torch.cat(outs) if outs else torch.empty(0, device=device)
    return result


@dataclass
class TrainResult:
    """The loss of every step, in step order, the optimizer state after the
    last step, and times in seconds with ``ScoreResult``'s meanings:

    - ``host_s``: the loop's wait in the ``DeviceIterator``'s ``next()``;
    - ``h2d_s``: the share of that wait spent on transfers (as in
      ``ScoreResult``);
    - ``step_s``: the train step (with the wire unpack, when the read is
      bit-packed), its stream synchronized on a CUDA device;
    - ``done_s``: when each step finished, from the loop's start;
    - ``wall_s``: the whole loop. Rows/s and the idle share come from it;
    - ``duty_cycle``: step time over step plus wait time.

    The losses stay on the device during the loop and are read once, at
    its end.
    """

    losses: torch.Tensor
    opt: Union[SparseEmbOptState, torch.optim.Optimizer]
    host_s: List[float] = field(default_factory=list)
    h2d_s: List[float] = field(default_factory=list)
    step_s: List[float] = field(default_factory=list)
    done_s: List[float] = field(default_factory=list)
    wall_s: float = 0.0
    duty_cycle: Optional[float] = None

    @property
    def steps(self) -> int:
        return len(self.step_s)


# the optimizer of examples/train_dlrm.py: optax.adam(1e-3) on whatever the
# step differentiates, and the sparse step's default row-wise AdaGrad
TRAIN_LR = 1e-3


def _adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=TRAIN_LR)


def _check_wire(schema: StructType, cfg: DLRMConfig, dense_cols, wire_bits: int) -> None:
    """The wire group's lanes are int32: the label and the dense columns
    must be IntegerType, and every bucket id must fit in ``wire_bits``."""
    if cfg.vocab_size > 1 << wire_bits:
        raise ValueError(
            f"wire_bits={wire_bits} cannot hold bucket ids below vocab_size={cfg.vocab_size}"
        )
    for name in ["label"] + list(dense_cols):
        dt = schema[name].data_type
        if not isinstance(dt, IntegerType):
            raise ValueError(
                f"wire_bits: column {name!r} is {dt}, not IntegerType: the wire "
                "carries the label and the dense columns in int32 lanes"
            )


def train_files(
    data_dir,
    cfg: DLRMConfig,
    model: DLRM,
    batch_size: int,
    device="cuda",
    *,
    sparse: bool = True,
    shuffle: bool = False,
    shuffle_window: int = 0,
    seed: int = 0,
    recordType: str = "SequenceExample",
    schema: Optional[StructType] = None,
    dense_cols: Optional[List[str]] = None,
    cat_cols: Optional[List[str]] = None,
    num_epochs: int = 1,
    num_workers: int = 1,
    transfer_thread: bool = False,
    wire_bits: Optional[int] = None,
) -> TrainResult:
    """Train ``model`` (on ``device``) in place on every full batch of the
    dataset under ``data_dir``, ``num_epochs`` times over, read as
    ``score_files`` reads it and shuffled as ``TFRecordDataset`` shuffles
    (``shuffle``, ``shuffle_window``, ``seed``).

    ``sparse`` takes ``sparse_train_step``: Adam at ``TRAIN_LR`` over the
    MLPs, row-wise AdaGrad at its default rate on the touched table rows.
    Otherwise ``train_step`` with Adam at ``TRAIN_LR`` over every
    parameter, the table's dense gradient included. As in
    ``examples/train_dlrm.py``, dense features get log(1 + max(x, 0)) and
    labels are cast to float32.

    ``wire_bits`` sends the batch as the bench does: the read packs the
    label, the dense columns (IntegerType) and the categoricals into one
    int32 group, the prefetch thread packs the categoricals to
    ``wire_bits`` bits (``pack_mixed``), and the device unpacks them and
    casts and transforms the rest."""
    device = torch.device(device)
    wire = wire_bits is not None
    paths, hash_buckets, pack, pad_to = _read_plan(data_dir, cfg, dense_cols, cat_cols, wire)
    if wire:
        if schema is None:  # the wire's lane check needs the schema up front
            schema = TFRecordDataset(paths, batch_size, recordType=recordType).schema
        _check_wire(schema, cfg, pack[WIRE][1:1 + cfg.num_dense], wire_bits)
    ds = TFRecordDataset(
        paths,
        batch_size=batch_size,
        schema=schema,
        recordType=recordType,
        hash_buckets=hash_buckets,
        pack=pack,
        num_epochs=num_epochs,
        shuffle=shuffle,
        shuffle_window=shuffle_window,
        seed=seed,
        num_workers=num_workers,
    )
    if sparse:
        opt = sparse_opt_init(model, cfg, _adam)
        train = lambda batch: sparse_train_step(model, opt, batch, cfg)  # noqa: E731
    else:
        opt = _adam(list(model.parameters()))
        train = lambda batch: train_step(model, opt, batch)  # noqa: E731
    step = (lambda batch: train(_split_wire(batch, cfg, wire_bits))) if wire else train
    result = TrainResult(losses=torch.empty(0), opt=opt)
    times = (result.host_s, result.h2d_s, result.step_s, result.done_s)

    def to_host(cb):
        if not wire:
            return _host_batch(cb, ds, pad_to, log1p_dense=True, float_label=True)
        # label and dense lanes verbatim, the categoricals packed to wire_bits
        hb = _host_batch(cb, ds, pad_to, log1p_dense=False)
        hb[WIRE] = pack_mixed(hb[WIRE], 1 + cfg.num_dense, wire_bits)
        return hb

    with _device_feed(ds, device, transfer_thread, to_host) as dev:
        losses, result.wall_s, result.duty_cycle = _drive(dev, device, step, times)
    result.losses = torch.stack(losses).cpu() if losses else torch.empty(0)
    return result
