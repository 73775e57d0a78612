"""Entry points of the port: the flagship DLRM forward, the serving path
from TFRecord files to logits, and the training path from TFRecord files to
updated weights.

- ``entry(device)``: (fn, args) of one DLRM forward on a synthetic batch,
  the counterpart of ``__graft_entry__.py::entry``.
- ``write_dryrun_dataset``: SequenceExample shard dirs with the schema of
  ``__graft_entry__.py::_write_dryrun_dataset``.
- ``score_files``: TFRecordDataset (native decode on a producer thread)
  -> host_batch_from_columnar -> make_device_batch -> DLRM forward, batch
  by batch, for every shard under a directory.
- ``train_files``: the same read (optionally shuffled) -> a sparse
  (row-wise AdaGrad on the table) or dense train step per batch; the
  counterpart of the loop in ``examples/train_dlrm.py`` without its
  harness, checkpoints and resume.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Iterable, List, Optional, Sequence, Union

import numpy as np
import torch

from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
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
    LongType,
    StringType,
    StructField,
    StructType,
)


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

    The dataset's producer thread reads and decodes ahead while the loop
    scores, so the per-batch stage times overlap decode and do not add up
    to the wall time:

    - ``host_s``: the loop's wait for the next decoded batch plus densify
      (``host_batch_from_columnar`` and the optional log1p);
    - ``h2d_s``: the host-to-device copy, synchronized on a CUDA device;
    - ``forward_s``: the forward, synchronized on a CUDA device;
    - ``done_s``: when each batch's forward finished, from the loop's start;
    - ``wall_s``: the whole loop, from starting the producer to the last
      batch. Rows/s and the device's idle share come from it.
    """

    logits: torch.Tensor
    host_s: List[float] = field(default_factory=list)
    h2d_s: List[float] = field(default_factory=list)
    forward_s: List[float] = field(default_factory=list)
    done_s: List[float] = field(default_factory=list)
    wall_s: float = 0.0

    @property
    def batches(self) -> int:
        return len(self.forward_s)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _read_plan(data_dir, cfg: DLRMConfig, dense_cols, cat_cols):
    """(paths, hash_buckets, pack, pad_to) of the DLRM's read: the dryrun
    column names unless given, the categoricals hashed into
    ``cfg.vocab_size`` buckets, dense and cat packed, a directory of
    'shard*' dirs expanded to them."""
    dense_cols = dense_cols or [f"d{i}" for i in range(1, cfg.num_dense + 1)]
    cat_cols = cat_cols or [f"c{i}" for i in range(1, cfg.num_categorical + 1)]
    hash_buckets = {c: cfg.vocab_size for c in cat_cols}
    pack = {"dense": dense_cols, "cat": cat_cols}
    pad_to = {"frames": (cfg.seq_len, cfg.seq_dim)} if cfg.seq_len else {}
    paths = data_dir
    if isinstance(data_dir, (str, os.PathLike)) and os.path.isdir(data_dir):
        shard_dirs = sorted(
            os.path.join(data_dir, d) for d in os.listdir(data_dir) if d.startswith("shard")
        )
        paths = shard_dirs or data_dir
    return paths, hash_buckets, pack, pad_to


def _host_batch(cb, ds: TFRecordDataset, pad_to, log1p_dense: bool):
    hb = host_batch_from_columnar(
        cb, ds.schema, pad_to=pad_to, hash_buckets=ds.hash_buckets, pack=ds.pack
    )
    hb.pop("frames_inner_len", None)  # per-frame lengths: unused by DLRM
    if log1p_dense:
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
    return hb


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
) -> ScoreResult:
    """Score every full batch of the dataset under ``data_dir`` (a path, a
    list of paths, or a directory of 'shard*' dirs) with the DLRM ``params``,
    ``num_epochs`` times over.

    Columns default to the dryrun names (d1..dN dense, c1..cM categorical,
    'frames' when the config has a sequence tower); the categorical columns
    are hashed into ``cfg.vocab_size`` buckets and both groups are packed.
    ``log1p_dense`` applies the usual Criteo preprocessing log(1 + max(x, 0))
    to the dense group on the host."""
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
    )
    result = ScoreResult(logits=torch.empty(0))
    outs = []
    start = time.perf_counter()
    with ds.batches() as it:
        while True:
            t0 = time.perf_counter()
            cb = next(it, None)
            if cb is None:
                break
            hb = _host_batch(cb, ds, pad_to, log1p_dense)
            t1 = time.perf_counter()
            batch = make_device_batch(hb, device)
            _sync(device)
            t2 = time.perf_counter()
            outs.append(params(batch))
            _sync(device)
            t3 = time.perf_counter()
            result.host_s.append(t1 - t0)
            result.h2d_s.append(t2 - t1)
            result.forward_s.append(t3 - t2)
            result.done_s.append(t3 - start)
    result.wall_s = time.perf_counter() - start
    result.logits = torch.cat(outs) if outs else torch.empty(0, device=device)
    return result


@dataclass
class TrainResult:
    """The loss of every step, in step order, the optimizer state after the
    last step, and times in seconds with ``ScoreResult``'s meanings:

    - ``host_s``: the wait for the next decoded batch plus densify (and
      ``log1p``, the label cast);
    - ``h2d_s``: the host-to-device copy, synchronized on a CUDA device;
    - ``step_s``: the train step, synchronized on a CUDA device;
    - ``done_s``: when each step finished, from the loop's start;
    - ``wall_s``: the whole loop. Rows/s and the idle share come from it.

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

    @property
    def steps(self) -> int:
        return len(self.step_s)


# the optimizer of examples/train_dlrm.py: optax.adam(1e-3) on whatever the
# step differentiates, and the sparse step's default row-wise AdaGrad
TRAIN_LR = 1e-3


def _adam(params: Iterable[torch.nn.Parameter]) -> torch.optim.Optimizer:
    return torch.optim.Adam(params, lr=TRAIN_LR)


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
    labels are cast to float32."""
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
        shuffle=shuffle,
        shuffle_window=shuffle_window,
        seed=seed,
    )
    if sparse:
        opt = sparse_opt_init(model, cfg, _adam)
        step = lambda batch: sparse_train_step(model, opt, batch, cfg)  # noqa: E731
    else:
        opt = _adam(list(model.parameters()))
        step = lambda batch: train_step(model, opt, batch)  # noqa: E731
    result = TrainResult(losses=torch.empty(0), opt=opt)
    losses = []
    start = time.perf_counter()
    with ds.batches() as it:
        while True:
            t0 = time.perf_counter()
            cb = next(it, None)
            if cb is None:
                break
            hb = _host_batch(cb, ds, pad_to, log1p_dense=True)
            hb["label"] = hb["label"].astype(np.float32)
            t1 = time.perf_counter()
            batch = make_device_batch(hb, device)
            _sync(device)
            t2 = time.perf_counter()
            losses.append(step(batch))
            _sync(device)
            t3 = time.perf_counter()
            result.host_s.append(t1 - t0)
            result.h2d_s.append(t2 - t1)
            result.step_s.append(t3 - t2)
            result.done_s.append(t3 - start)
    result.wall_s = time.perf_counter() - start
    result.losses = torch.stack(losses).cpu() if losses else torch.empty(0)
    return result
