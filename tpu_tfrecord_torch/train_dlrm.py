"""End-to-end example: train the DLRM on TFRecord data, resumably; the twin
of ``examples/train_dlrm.py``.

    python -m tpu_tfrecord_torch.train_dlrm [--device cpu] [--data-dir D] [--ckpt-dir C]

1. generate a Criteo-like TFRecord dataset (4 shards x 4,096 rows, once);
2. stream it with ``TFRecordDataset`` (native decode on a producer thread,
   seeded shard-order shuffle and 8-batch row windows);
3. hash the categoricals into 2^16 buckets, pack dense and cat, log(1+x)
   the dense features, cast the label, copy the batch to the device;
4. train through ``harness.run_train_loop`` for 2 epochs (32 steps of
   1,024 rows), saving the input position every 8 steps;
5. a rerun resumes from the saved position ("resuming from ..."); a run
   that spends the epoch budget clears it ("done: ...").

``DLRM_SPARSE=1`` takes the sparse step (row-wise AdaGrad on the touched
table rows, Adam on the MLPs); otherwise Adam over every parameter. As in
the JAX example, only the input position is saved here (a job pairs it
with the model through ``checkpoint.TrainCheckpointer``). Runs on
``cuda`` unless ``--device cpu``; ``--max-steps`` stops early and keeps
the position.

Under a process group (``torchrun``'s environment, read by
``device.distributed.initialize``) every rank sits on the mesh's 'data'
axis (``create_mesh()``), reads its slot of the shards, builds global
batches with ``make_global_batch`` and takes the sharded step
(``models.dlrm.sharded_train_step`` / ``sharded_sparse_train_step``).
Each rank saves its own input position. The ranks agree before every step
that each has a batch, so all stop at the first batch one of them lacks
(a rank with more rows would otherwise wait alone in a collective).
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from tpu_tfrecord_torch import _native, harness
from tpu_tfrecord_torch.columnar import Column, ColumnarBatch, slice_batch
from tpu_tfrecord_torch.device import distributed
from tpu_tfrecord_torch.device.ingest import (
    host_batch_from_columnar,
    make_device_batch,
    make_global_batch,
)
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.models.dlrm import (
    DLRMConfig,
    init_params,
    shard_model,
    sharded_sparse_train_step,
    sharded_train_step,
    sparse_opt_init,
    sparse_train_step,
    train_step,
)
from tpu_tfrecord_torch.options import RecordType
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType

NUM_DENSE, NUM_CAT = 13, 26
VOCAB = 1 << 16
BATCH = 1024
EXAMPLE_ROOT = os.path.join(tempfile.gettempdir(), "tpu_tfrecord_torch_example")


def make_schema() -> StructType:
    fields = [StructField("label", LongType(), nullable=False)]
    fields += [StructField(f"I{i}", LongType()) for i in range(NUM_DENSE)]
    fields += [StructField(f"C{i}", StringType()) for i in range(NUM_CAT)]
    return StructType(fields)


def generate(data_dir: str, shards: int = 4, rows: int = 4096) -> None:
    """The JAX example's rows and files (the same draws of the same
    generator and seed, row by row), once; encoded a shard at a time by
    the native encoder."""
    if os.path.exists(os.path.join(data_dir, "_SUCCESS")):
        return
    schema = make_schema()
    rng = np.random.default_rng(0)
    n = shards * rows
    label = np.empty(n, np.int64)
    dense = np.empty((NUM_DENSE, n), np.int64)
    cat = np.empty((NUM_CAT, n), np.int64)
    for i in range(n):
        label[i] = rng.integers(0, 2)
        dense[:, i] = rng.integers(0, 1 << 20, size=NUM_DENSE)
        cat[:, i] = rng.integers(0, 5000, size=NUM_CAT)
    cols = {"label": Column("label", schema["label"].data_type, values=label)}
    for i in range(NUM_DENSE):
        cols[f"I{i}"] = Column(f"I{i}", schema[f"I{i}"].data_type, values=dense[i])
    for i in range(NUM_CAT):
        strs = [b"v%d" % v for v in cat[i].tolist()]
        offsets = np.zeros(n + 1, np.int64)
        np.cumsum([len(x) for x in strs], out=offsets[1:])
        cols[f"C{i}"] = Column(f"C{i}", schema[f"C{i}"].data_type, blob=b"".join(strs),
                               blob_offsets=offsets)
    whole = ColumnarBatch(cols, n)
    encoder = _native.make_encoder(schema, RecordType.EXAMPLE)
    os.makedirs(data_dir, exist_ok=True)
    for s in range(shards):
        with open(os.path.join(data_dir, f"part-{s:05d}-gen.tfrecord"), "wb") as fh:
            fh.write(encoder.encode_batch(slice_batch(whole, s * rows, (s + 1) * rows)))
    open(os.path.join(data_dir, "_SUCCESS"), "wb").close()  # zero-byte marker


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=os.path.join(EXAMPLE_ROOT, "data"))
    ap.add_argument("--ckpt-dir", default=os.path.join(EXAMPLE_ROOT, "ckpt"))
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    distributed.initialize()
    rank, count = distributed.process_slot()
    mesh = None
    if count > 1:
        from tpu_tfrecord_torch.device import mesh as meshes

        mesh = meshes.create_mesh(device_type=device.type)  # every rank on 'data'
        device = meshes.mesh_device(mesh)
        if rank == 0:
            generate(args.data_dir)
        distributed.barrier("train_dlrm data")
    else:
        generate(args.data_dir)
    schema = make_schema()

    cfg = DLRMConfig(num_dense=NUM_DENSE, num_categorical=NUM_CAT, vocab_size=VOCAB, embed_dim=16)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    if mesh is not None:
        model = shard_model(model, mesh)
    sparse_step, dense_step = ((sparse_train_step, train_step) if mesh is None
                               else (sharded_sparse_train_step, sharded_train_step))
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
    if os.environ.get("DLRM_SPARSE", "0") == "1":
        # sparse embedding updates: the table's gradient never materializes
        opt = sparse_opt_init(model, cfg, adam)
        step_fn = lambda gb: sparse_step(model, opt, gb, cfg)  # noqa: E731
    else:
        opt = adam(list(model.parameters()))
        step_fn = lambda gb: dense_step(model, opt, gb)  # noqa: E731

    hash_buckets = {f"C{i}": VOCAB for i in range(NUM_CAT)}
    pack = {"dense": [f"I{i}" for i in range(NUM_DENSE)], "cat": [f"C{i}" for i in range(NUM_CAT)]}
    ds = TFRecordDataset(
        args.data_dir, batch_size=BATCH, schema=schema, num_epochs=2,
        # two-scale mixing: seeded shard order and 8-batch row windows
        shuffle=True, shuffle_window=8, seed=0, process_index=rank, process_count=count,
    )

    def produce(cb):
        hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=hash_buckets, pack=pack)
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)  # Criteo log(1+x)
        hb["label"] = hb["label"].astype(np.float32)
        return make_device_batch(hb, device) if mesh is None else make_global_batch(hb, mesh)

    def step(state, gb):
        return state, step_fn(gb)

    spool = harness.trainer_spool()
    phases = harness.StepPhases()
    t0 = time.perf_counter()
    it, _resume = harness.resume_or_fresh(ds, args.ckpt_dir)
    save_cb, saver = harness.state_saver(args.ckpt_dir)
    batches = it if mesh is None else distributed.Lockstep(it)
    try:
        with it:
            _, steps, duty = harness.run_train_loop(
                batches, produce, step, (model, opt), phases=phases, max_steps=args.max_steps,
                save=lambda n, _live, state: save_cb(n, it, state),
            )
        saver.wait()  # drain the background commit before the summary
        spent = args.max_steps is None or steps < args.max_steps
        harness.finish(args.ckpt_dir, steps, BATCH, t0, duty, clear_state=spent, stages=True,
                       phases=phases)
    finally:
        saver.close()
        harness.release_trainer_spool(spool)


if __name__ == "__main__":
    main()
