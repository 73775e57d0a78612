"""End-to-end example: train the long-document classifier on SequenceExamples,
resumably; the twin of ``examples/train_longdoc.py``.

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
aux loss at weight 0.01), routed over each document's valid prefix. Runs
on ``cuda`` unless ``--device cpu``; ``--max-steps`` stops early and keeps
the position.

Under a process group (``torchrun``'s environment, read by
``device.distributed.initialize``) the ranks form the JAX example's
(data, seq) mesh (``pick_mesh``: a seq axis of 4, 2 or 1 that the world
size, the batch and the padded length allow): each rank reads the slot of
its 'data' coordinate (``BATCH / data`` documents a batch), keeps its
chunk of the padded frames on 'seq', and takes the sharded step
(``long_doc.train_step(mesh=, data_axis="data")``), its attention the
ring or, with ``LONGDOC_SP_ATTENTION=ulysses``, the all-to-all exchange.
With ``LONGDOC_MOE_EXPERTS`` the MoE routes over the tokens of every
rank's documents (``models.long_doc``'s global route), as the JAX
example's does under GSPMD. Each rank saves its own input position; the
ranks agree before every step that each has a batch
(``distributed.Lockstep``). One process runs
the dense attention on its whole batch, as before.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import numpy as np
import torch

from tpu_tfrecord_torch import harness
from tpu_tfrecord_torch.device import distributed
from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
from tpu_tfrecord_torch.io.dataset import TFRecordDataset
from tpu_tfrecord_torch.io.writer import DatasetWriter
from tpu_tfrecord_torch.models import long_doc, optim
from tpu_tfrecord_torch.options import TFRecordOptions
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
    return long_doc.LongDocConfig(
        seq_dim=SEQ_DIM, d_model=32, n_heads=4, n_layers=2, max_len=MAX_LEN,
        # 'ring' (the default) or 'ulysses': 4 heads cover every seq axis
        # that pick_mesh chooses
        sp_attention=os.environ.get("LONGDOC_SP_ATTENTION", "ring"),
        moe_experts=int(os.environ.get("LONGDOC_MOE_EXPERTS", "0")),
        n_kv_heads=int(os.environ.get("LONGDOC_KV_HEADS", "0")),
    )


def pick_mesh(world: int) -> dict:
    """The JAX example's (data, seq) picker over ``world`` ranks: the
    largest seq axis of 4, 2, 1 that divides the world with ``BATCH``
    divisible by the data axis and ``MAX_LEN`` by the seq axis."""
    for seq in (4, 2, 1):
        if world % seq == 0 and BATCH % (world // seq) == 0 and MAX_LEN % seq == 0:
            return {"data": world // seq, "seq": seq}
    raise ValueError(f"no (data, seq) mesh of {world} ranks divides batch {BATCH} "
                     f"and length {MAX_LEN}")


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
    distributed.initialize()
    rank, count = distributed.process_slot()
    mesh, slot, slots, cols = None, 0, 1, slice(None)
    if count > 1:
        from tpu_tfrecord_torch.device import mesh as meshes
        from tpu_tfrecord_torch.models import sharded

        axes = pick_mesh(count)
        mesh = meshes.create_mesh(axes, device_type=device.type)
        device = meshes.mesh_device(mesh)
        slot, slots = sharded.axis_index(mesh, "data"), axes["data"]
        lc = MAX_LEN // axes["seq"]
        cols = slice(sharded.axis_index(mesh, "seq") * lc, (sharded.axis_index(mesh, "seq") + 1) * lc)
        print(f"mesh: {axes} sp_attention={cfg.sp_attention} (rank {rank}: data {slot}, "
              f"frames [{cols.start}, {cols.stop}))")
        if rank == 0:
            generate(args.data_dir)
        distributed.barrier("train_longdoc data")
    else:
        generate(args.data_dir)
    params = long_doc.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = optim.adam(params, LR)
    ds = TFRecordDataset(
        args.data_dir, batch_size=BATCH // slots, schema=make_schema(), num_epochs=2,
        recordType="SequenceExample", shuffle=True, seed=0, process_index=slot,
        process_count=slots,
    )

    def produce(cb):
        hb = host_batch(cb, ds.schema)
        hb["frames"] = hb["frames"][:, cols].contiguous()  # this rank's steps on 'seq'
        return make_device_batch(hb, device)

    def step(state, gb):
        return state, long_doc.train_step(params, opt, gb, cfg, mesh=mesh, data_axis="data")

    spool = harness.trainer_spool()
    phases = harness.StepPhases()
    t0 = time.perf_counter()
    it, _resume = harness.resume_or_fresh(ds, args.ckpt_dir)
    save_cb, saver = harness.state_saver(args.ckpt_dir)
    try:
        with it:
            _, steps, duty = harness.run_train_loop(
                it if mesh is None else distributed.Lockstep(it), produce, step, (params, opt),
                save=lambda n, _live, state: save_cb(n, it, state), phases=phases,
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
