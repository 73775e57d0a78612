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
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from tpu_tfrecord_torch import harness, wire
from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.models.dlrm import (
    DLRMConfig,
    init_params,
    sparse_opt_init,
    sparse_train_step,
    train_step,
)
from tpu_tfrecord_torch.options import RecordType
from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType
from tpu_tfrecord_torch.serde import TFRecordSerializer, encode_row

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
    """The JAX example's rows (the same generator and seed), once."""
    if os.path.exists(os.path.join(data_dir, "_SUCCESS")):
        return
    ser = TFRecordSerializer(make_schema())
    rng = np.random.default_rng(0)

    def all_rows():
        for _ in range(shards * rows):
            row = [int(rng.integers(0, 2))]
            row += [int(v) for v in rng.integers(0, 1 << 20, size=NUM_DENSE)]
            row += [f"v{int(v)}" for v in rng.integers(0, 5000, size=NUM_CAT)]
            yield encode_row(ser, RecordType.EXAMPLE, row)

    os.makedirs(data_dir, exist_ok=True)
    it = all_rows()
    for s in range(shards):
        wire.write_records(os.path.join(data_dir, f"part-{s:05d}-gen.tfrecord"),
                           (next(it) for _ in range(rows)))
    open(os.path.join(data_dir, "_SUCCESS"), "wb").close()  # zero-byte marker


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=os.path.join(EXAMPLE_ROOT, "data"))
    ap.add_argument("--ckpt-dir", default=os.path.join(EXAMPLE_ROOT, "ckpt"))
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    generate(args.data_dir)
    schema = make_schema()

    cfg = DLRMConfig(num_dense=NUM_DENSE, num_categorical=NUM_CAT, vocab_size=VOCAB, embed_dim=16)
    model = init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-3)  # noqa: E731
    if os.environ.get("DLRM_SPARSE", "0") == "1":
        # sparse embedding updates: the table's gradient never materializes
        opt = sparse_opt_init(model, cfg, adam)
        step_fn = lambda gb: sparse_train_step(model, opt, gb, cfg)  # noqa: E731
    else:
        opt = adam(list(model.parameters()))
        step_fn = lambda gb: train_step(model, opt, gb)  # noqa: E731

    hash_buckets = {f"C{i}": VOCAB for i in range(NUM_CAT)}
    pack = {"dense": [f"I{i}" for i in range(NUM_DENSE)], "cat": [f"C{i}" for i in range(NUM_CAT)]}
    ds = TFRecordDataset(
        args.data_dir, batch_size=BATCH, schema=schema, num_epochs=2,
        # two-scale mixing: seeded shard order and 8-batch row windows
        shuffle=True, shuffle_window=8, seed=0,
    )

    def produce(cb):
        hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=hash_buckets, pack=pack)
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)  # Criteo log(1+x)
        hb["label"] = hb["label"].astype(np.float32)
        return make_device_batch(hb, device)

    def step(state, gb):
        return state, step_fn(gb)

    spool = harness.trainer_spool()
    phases = harness.StepPhases()
    t0 = time.perf_counter()
    it, _resume = harness.resume_or_fresh(ds, args.ckpt_dir)
    save_cb, saver = harness.state_saver(args.ckpt_dir)
    try:
        with it:
            _, steps, duty = harness.run_train_loop(
                it, produce, step, (model, opt), save=save_cb, phases=phases,
                max_steps=args.max_steps,
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
