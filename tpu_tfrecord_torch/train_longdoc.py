"""End-to-end example: train the long-document classifier on SequenceExamples,
resumably; the twin of ``examples/train_longdoc.py`` on one card.

    python -m tpu_tfrecord_torch.train_longdoc [--device cpu] [--data-dir D]
        [--ckpt-dir C] [--max-steps N]

1. generate ragged documents (4 shards x 256 SequenceExamples, 4 to 64
   frames of 16 features, the label following the content: the JAX
   example's generator and seed), once;
2. stream them with ``TFRecordDataset`` (shuffled shard order, seed 0,
   batches of 64, 2 epochs);
3. pad the frames to [64, 64, 16] and round them to bf16 in one native
   pass (half the bytes to copy), with their lengths; copy the batch to
   the card;
4. train the classifier (d_model 32, 4 heads, 2 layers, bf16 activations,
   the masked mean-pool) with Adam(1e-3) through
   ``harness.run_train_loop``, saving the input position every 8 steps;
5. a rerun resumes from the saved position ("resuming from ..."); a run
   that spends its epoch budget clears it ("done: ...").

``LONGDOC_KV_HEADS=2`` runs GQA; ``LONGDOC_MOE_EXPERTS=4`` swaps every
block's FFN for a 4-expert Switch MoE (top 1, capacity factor 1.25, the
aux loss at weight 0.01), routed over each document's valid prefix. Not
ported: ``LONGDOC_SP_ATTENTION`` (sequence-parallel ring or Ulysses
attention: the twin's attention is the dense one), refused, naming what is
missing. Runs on ``cuda`` unless ``--device cpu``; ``--max-steps`` stops
early and keeps the position.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from tpu_tfrecord_torch import harness
from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.io.writer import DatasetWriter
from tpu_tfrecord_torch.models import long_doc, optim
from tpu_tfrecord_torch.options import OptionNotPortedError, TFRecordOptions
from tpu_tfrecord_torch.schema import ArrayType, FloatType, LongType, StructField, StructType

SEQ_DIM = 16
MAX_LEN = 64
BATCH = 64
LR = 1e-3
EXAMPLE_ROOT = os.path.join(tempfile.gettempdir(), "tpu_tfrecord_torch_longdoc")


def make_schema() -> StructType:
    return StructType([
        StructField("label", LongType(), nullable=False),
        StructField("frames", ArrayType(ArrayType(FloatType()))),
    ])


def make_config() -> long_doc.LongDocConfig:
    if os.environ.get("LONGDOC_SP_ATTENTION"):
        raise OptionNotPortedError(
            "LONGDOC_SP_ATTENTION: sequence-parallel attention needs torch.distributed "
            "across cards; the twin runs the dense attention"
        )
    return long_doc.LongDocConfig(
        seq_dim=SEQ_DIM, d_model=32, n_heads=4, n_layers=2, max_len=MAX_LEN,
        moe_experts=int(os.environ.get("LONGDOC_MOE_EXPERTS", "0")),
        n_kv_heads=int(os.environ.get("LONGDOC_KV_HEADS", "0")),
    )


def generate(data_dir: str, shards: int = 4, rows: int = 256) -> None:
    """The JAX example's documents (the same generator and seed), written
    as SequenceExamples in one job, so ``_SUCCESS`` never covers a partial
    dataset."""
    if os.path.exists(os.path.join(data_dir, "_SUCCESS")):
        return
    rng = np.random.default_rng(0)
    all_rows = []
    for _ in range(shards * rows):
        n = int(rng.integers(4, MAX_LEN + 1))
        frames = rng.normal(size=(n, SEQ_DIM))
        label = int(frames[:, 0].mean() > 0)
        all_rows.append([label, [[float(x) for x in row] for row in frames]])
    DatasetWriter(
        data_dir,
        make_schema(),
        TFRecordOptions.from_map(recordType="SequenceExample"),
        mode="overwrite",
        max_records_per_file=rows,
    ).write_rows(all_rows)


def host_batch(cb, schema) -> dict:
    """A decoded batch as the model's host batch: frames padded to
    [B, MAX_LEN, SEQ_DIM] and rounded to bf16 in the native pad (a CPU
    bf16 tensor), ``frames_len`` and ``label``."""
    hb = host_batch_from_columnar(
        cb, schema, pad_to={"frames": (MAX_LEN, SEQ_DIM)}, cast={"frames": torch.bfloat16},
    )
    hb.pop("frames_inner_len")
    return hb


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--data-dir", default=os.path.join(EXAMPLE_ROOT, "data"))
    ap.add_argument("--ckpt-dir", default=os.path.join(EXAMPLE_ROOT, "ckpt"))
    ap.add_argument("--max-steps", type=int, default=None)
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    cfg = make_config()
    generate(args.data_dir)
    params = long_doc.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = optim.adam(params, LR)
    ds = TFRecordDataset(
        args.data_dir, batch_size=BATCH, schema=make_schema(), num_epochs=2,
        recordType="SequenceExample", shuffle=True, seed=0,
    )

    def produce(cb):
        return make_device_batch(host_batch(cb, ds.schema), device)

    def step(state, gb):
        return state, long_doc.train_step(params, opt, gb, cfg)

    spool = harness.trainer_spool()  # raises when TFR_TRAIN_SPOOL_DIR asks for one
    phases = harness.StepPhases()
    t0 = time.perf_counter()
    it, _resume = harness.resume_or_fresh(ds, args.ckpt_dir)
    save_cb, saver = harness.state_saver(args.ckpt_dir)
    try:
        with it:
            _, steps, duty = harness.run_train_loop(
                it, produce, step, (params, opt), save=save_cb, phases=phases,
                max_steps=args.max_steps,
            )
        saver.wait()  # drain the background commit before the summary
        spent = args.max_steps is None or steps < args.max_steps
        harness.finish(args.ckpt_dir, steps, BATCH, t0, duty, clear_state=spent,
                       phases=phases)
    finally:
        saver.close()
        harness.release_trainer_spool(spool)


if __name__ == "__main__":
    main()
