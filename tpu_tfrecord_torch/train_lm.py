"""End-to-end example: train the causal LM on packed token SequenceExamples,
resumably; the twin of ``examples/train_lm.py``.

    python -m tpu_tfrecord_torch.train_lm [--device cpu] [--steps 64]
        [--save-every 8] [--ckpt-mode async|sync] [--epochs 4]
        [--digest-out FILE] [--data-dir D] [--ckpt-dir C] [--mesh KIND]
        [--moe EXPERTS] [--diagnostics] [--trace-out FILE]

1. generate token documents from the sparse-bigram language (4 shards x
   256 SequenceExamples, the JAX example's generator and seed), once;
2. stream them with ``TFRecordDataset`` (shuffled shard order, seed 0,
   64 documents a read) and pack them into dense [32, 65] causal batches
   with ``TokenPacker`` (slice mode: no padding, no masks);
3. copy each packed batch to the card through ``DeviceIterator``;
4. train the LM (vocab 256, d_model 64, 4 heads, 2 layers, L = 64) with
   Adam(3e-3) through ``harness.run_train_loop``; ``--moe E`` swaps every
   block's FFN for a top-2 MoE of E experts (capacity factor 1.25, aux
   weight 0.01), and ``--diagnostics`` folds the model's diagnostics into
   the ``moe.*`` gauges after each step's loss has been waited on and
   prints the last values as a ``model diagnostics:`` line;
5. every ``--save-every`` steps save the parameters, Adam's state, the
   input position and the packer's carry in one ``AsyncCheckpointer``
   generation (keep 2), in the JAX example's layout: a generation written
   by either trainer resumes in the other. A rerun after a kill prints
   ``resumed at step N`` and continues the packed stream and the losses;
   ``--digest-out`` writes (and prints, as ``lm_step`` lines) each step's
   batch digest and loss. A run that spends its epoch budget before
   ``--steps`` clears the checkpoints.

On the card the step runs with ``torch.use_deterministic_algorithms``
(cuBLAS workspace ``:4096:8``), so a resumed run's losses are bit-equal to
an uninterrupted run's. ``--trace-out FILE`` turns the flight recorder on
and saves its Chrome trace (``train.step`` spans) there at the end.
``--mesh`` takes the JAX example's five kinds, its default ``LM_MESH`` or
``dp_sp``, and picks the mesh as the JAX example's ``pick_mesh`` does
over the ranks of the process group (``torchrun``'s environment, read by
``device.distributed.initialize``) where the JAX example counts devices.
``dp_sp`` on an even number W of ranks trains 2 layers on
``{"data": W/2, "seq": 2}``: every rank reads and packs the whole stream,
keeps the rows of its 'data' coordinate, and its step shards the
sequence over 'seq' with the zigzag causal ring (``models.lm``'s dense
loop over a ``DeviceMesh``). ``dp_fsdp`` on an even W trains 2 layers on
``{"data": 2, "fsdp": W/2}``: the rows are cut on 'data' only, each rank
keeps its ``lm.shard_params`` slices of the weights and of Adam's state
and gathers each weight on use, and it prints ``fsdp param bytes/device:
N`` (its slices' bytes). ``dp`` on W ranks trains on ``{"data": W}``;
an odd W under ``dp_sp`` or ``dp_fsdp`` trains as ``dp``. On one process
every kind but ``dp_pp`` trains as ``dp`` with 2 layers, as the JAX
example does on one device. ``dp_pp`` trains what the JAX example trains
on two devices: 4 layers in 2 pipeline stages (``{"pipe": 2, "data":
1}``), 8 microbatches a step, ``--virtual 2`` interleaving 2 chunks a
stage; on the one card the pipe axis is a tensor dimension
(``models.pipeline``), and ``--diagnostics`` folds the measured bubble
into the ``pipeline.bubble_fraction`` gauge (``pipeline.bubble_fraction_v``
too with ``--virtual 2``). Not ported, refused over several ranks:
``dp_pp`` and ``dp_fsdp_pp`` (stages across processes, ROADMAP item 8h).
``--virtual 2`` needs ``--mesh dp_pp`` and ``--moe`` is refused with
``--mesh dp_pp`` and over several ranks, as the MoE FFN under a mesh is
not ported (8g). Every run over ranks, and every one-process run of
another kind than ``dp``, prints ``mesh: {shape} mode=KIND (...)`` first;
the shape is published as ``train.mesh.<axis>`` gauges on every run
(``harness.report_mesh``). The checkpoint is layout-free, as the JAX
example's: the [n_layers, ...] stack of the whole parameters and Adam
state, written by rank 0. Under ``dp_fsdp`` every rank gathers its
slices at a save step, in step with the others, and rank 0 writes the
whole tree; on a start every rank reads the whole tree and keeps its
slices. So a ``dp_fsdp`` run resumes a ``dp`` run's generations and a
``dp`` run a ``dp_fsdp`` run's. ``--spool DIR`` (``--spool-interval
S``) spools the trainer's telemetry under the ``trainer`` role into DIR
for ``fleet.TelemetryAggregator``; a clean exit lands the ``final``
snapshot. Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import tempfile
import time

import numpy as np
import torch

from tpu_tfrecord_torch import checkpoint, harness, telemetry
from tpu_tfrecord_torch.device import distributed
from tpu_tfrecord_torch.device.ingest import DeviceIterator, TokenPacker
from tpu_tfrecord_torch.io.dataset import IteratorState, TFRecordDataset
from tpu_tfrecord_torch.io.writer import DatasetWriter
from tpu_tfrecord_torch.models import lm, optim
from tpu_tfrecord_torch.options import OptionNotPortedError, TFRecordOptions
from tpu_tfrecord_torch.schema import ArrayType, LongType, StructField, StructType

VOCAB = 256
SEQ_LEN = 64
BATCH = 32
READ_BATCH = 64  # documents a dataset batch
LR = 3e-3
EXAMPLE_ROOT = os.path.join(tempfile.gettempdir(), "tpu_tfrecord_torch_lm")


def make_schema() -> StructType:
    return StructType([StructField("tokens", ArrayType(LongType()))])


MESH_KINDS = ("dp", "dp_sp", "dp_pp", "dp_fsdp", "dp_fsdp_pp")
DIAG_GAUGES = ("moe.expert_imbalance", "moe.dropped_fraction", "moe.gate_entropy",
               "pipeline.bubble_fraction", "pipeline.bubble_fraction_v")
PIPE_MICRO = 8  # microbatches a step in the pipe mode, the JAX example's


def make_config(n_layers: int = 2, moe_experts: int = 0, axes=None,
                virtual: int = 1) -> lm.LMConfig:
    """The twin's model; with a ``pipe_axis`` in ``axes`` the JAX example's
    pipe-mode config (``n_micro`` 8, ``virtual`` chunks a stage)."""
    pipe = "pipe_axis" in (axes or {})
    return lm.LMConfig(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=n_layers,
                       max_len=SEQ_LEN, moe_experts=moe_experts,
                       n_micro=PIPE_MICRO if pipe else None,
                       n_virtual=virtual if pipe else 1)


def pick_mesh(kind: str, virtual: int = 1, world: int = 1):
    """(mesh shape, cfg axes, n_layers) of ``--mesh kind`` over ``world``
    ranks, as the JAX example's ``pick_mesh`` over as many devices:
    ``dp_sp`` on an even world is ``{"data": world/2, "seq": 2}`` and
    ``dp_fsdp`` ``{"data": 2, "fsdp": world/2}``, with 2 layers; ``dp_pp``
    on one process is 2 stages of 4 layers with a data axis of 1 (for
    either ``virtual``), the pipe axis a tensor dimension of the one card;
    every other case is ``dp`` over the world with 2 layers (``dp_fsdp_pp``
    on one process, as the JAX example on one device). ``dp_pp`` and
    ``dp_fsdp_pp`` over several ranks raise (8h)."""
    if kind not in MESH_KINDS:
        raise ValueError(f"--mesh {kind!r}: one of {MESH_KINDS}")
    if kind == "dp_sp" and world % 2 == 0:
        return {"data": world // 2, "seq": 2}, {"data_axis": "data", "seq_axis": "seq"}, 2
    if kind == "dp_fsdp" and world % 2 == 0:
        return {"data": 2, "fsdp": world // 2}, {"data_axis": "data", "fsdp_axis": "fsdp"}, 2
    if kind == "dp_pp" and world == 1:
        return {"pipe": 2, "data": 1}, {"data_axis": "data", "pipe_axis": "pipe"}, 4
    if world > 1 and kind in ("dp_pp", "dp_fsdp_pp"):
        raise OptionNotPortedError(
            f"--mesh {kind} over {world} ranks: pipeline stages across processes are not "
            "ported yet (ROADMAP.md, Queue A item 8h)")
    return {"data": world}, {"data_axis": "data"}, 2


def generate(data_dir: str, shards: int = 4, docs: int = 256) -> None:
    """The JAX example's documents (the same generator and seed), written
    as SequenceExamples in one job, so ``_SUCCESS`` never covers a partial
    dataset."""
    if os.path.exists(os.path.join(data_dir, "_SUCCESS")):
        return
    rng = np.random.default_rng(0)
    table = lm.bigram_table(VOCAB, 4)
    rows = []
    for _ in range(shards * docs):
        n = int(rng.integers(16, 97))
        t = int(rng.integers(VOCAB))
        doc = np.empty(n, np.int64)
        for j in range(n):
            doc[j] = t
            t = int(table[t, rng.integers(4)])
        rows.append([doc.tolist()])
    DatasetWriter(
        data_dir,
        make_schema(),
        TFRecordOptions.from_map(recordType="SequenceExample"),
        mode="overwrite",
        max_records_per_file=docs,
    ).write_rows(rows)


class LMCheckpoint:
    """Parameters, Adam's state, the input position and the packer's carry
    in one generation of an ``AsyncCheckpointer`` (keep 2): the JAX
    example's ``LMCheckpoint``. The tree is ``optim.train_state``'s, the
    JAX ``(params, opt_state)`` leaf for leaf; ``sync`` commits on the
    caller's thread."""

    def __init__(self, directory: str, *, sync: bool = False):
        self.directory = directory
        self._ck = checkpoint.AsyncCheckpointer(
            directory, keep=2, process_index=0, process_count=1, sync=sync,
        )

    def save(self, step: int, state, payload: dict) -> None:
        self._ck.save(step, state, payload)

    def load(self, template):
        """(step, state, payload) or (None, template, None)."""
        return self._ck.restore(template)

    def latest_step(self):
        """The newest complete generation's step, or None."""
        return self._ck.latest_step()

    def clear(self) -> None:
        """Drop every generation (the epoch budget is spent)."""
        self._ck.clear()

    def wait(self) -> None:
        self._ck.wait()

    def close(self) -> None:
        self._ck.close()


def shard_state(params, opt, mesh):
    """(slices, Adam over them): this rank's FSDP slices of the one-process
    parameters and of Adam's state (``lm.shard_params`` of each tree)."""
    adam = optim.adam_state(params, opt)[0]
    shard = lm.shard_params(params, mesh)
    shard_opt = optim.adam(shard, LR)
    optim.load_adam_state(shard, shard_opt, optim.ScaleByAdamState(
        adam.count, lm.shard_params(adam.mu, mesh), lm.shard_params(adam.nu, mesh)))
    return shard, shard_opt


def full_state(params, opt, mesh):
    """The one-process ``optim.train_state`` of FSDP slices, gathered on
    every rank: a collective, so every rank calls it at the same step."""
    adam, empty = optim.adam_state(params, opt)
    return lm.unshard_params(params, mesh), (optim.ScaleByAdamState(
        adam.count, lm.unshard_params(adam.mu, mesh), lm.unshard_params(adam.nu, mesh)), empty)


def batch_digest(b: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(b).tobytes()).hexdigest()[:16]


def packed_stream(it, packer: TokenPacker, snaps: dict):
    """Columnar batches -> packed host batches. For packed batch n it
    records the (input position, packer carry, digest) that resume the
    stream at batch n+1. ``DeviceIterator`` runs at most a batch ahead of
    the step, so ``snaps`` keeps the last 16."""
    n = 0
    while True:
        b = packer.pop()
        while b is None:
            cb = next(it, None)
            if cb is None:
                return
            packer.feed_column(cb["tokens"])
            b = packer.pop()
        snaps[n] = {
            "input": it.state().to_json(),
            "packer": packer.state(),
            "digest": batch_digest(b),
        }
        for old in [k for k in snaps if k < n - 16]:
            del snaps[old]
        yield {"tokens": b}
        n += 1


def refuse_unported(ap: argparse.ArgumentParser, args) -> None:
    if args.virtual > 1 and args.mesh != "dp_pp":
        ap.error("--virtual > 1 needs --mesh dp_pp")
    if args.moe and args.mesh == "dp_pp":
        ap.error("--moe is not supported with --mesh dp_pp")


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=os.environ.get("LM_MESH", "dp_sp"), choices=MESH_KINDS,
                    help="the JAX example's mesh kinds, picked over the process group's "
                         "ranks as the JAX example picks over devices")
    ap.add_argument("--steps", type=int, default=64,
                    help="total train steps (absolute, resumed ones included)")
    ap.add_argument("--save-every", type=int, default=8)
    ap.add_argument("--ckpt-mode", default=os.environ.get("TFR_CKPT_MODE", "async"),
                    choices=("async", "sync"))
    ap.add_argument("--epochs", type=int, default=4)
    ap.add_argument("--digest-out", default=None,
                    help="append one {'step','digest','loss'} JSON line per step")
    ap.add_argument("--data-dir", default=os.path.join(EXAMPLE_ROOT, "data"))
    ap.add_argument("--ckpt-dir", default=os.path.join(EXAMPLE_ROOT, "ckpt"))
    ap.add_argument("--spool", default=None, metavar="SPOOL_DIR",
                    help="spool this trainer's telemetry (role=trainer) into SPOOL_DIR")
    ap.add_argument("--spool-interval", type=float, default=None, metavar="SECONDS",
                    help="spool snapshot cadence")
    ap.add_argument("--trace-out", default=None, metavar="FILE",
                    help="turn the flight recorder on and save its Chrome trace here")
    ap.add_argument("--diagnostics", action="store_true",
                    help="fold the model's diagnostics into gauges each step")
    ap.add_argument("--moe", type=int, default=0, metavar="EXPERTS",
                    help="a top-2 MoE FFN with this many experts in every block (0: dense)")
    ap.add_argument("--virtual", type=int, default=1, choices=(1, 2), metavar="V")
    args = ap.parse_args(argv)
    refuse_unported(ap, args)
    device = torch.device(args.device)
    if device.type == "cuda":
        # deterministic kernels (the embedding gather's backward accumulates
        # with atomics otherwise): a resumed run repeats the losses bit for bit
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
        torch.use_deterministic_algorithms(True)
        print("deterministic algorithms: on")
    distributed.initialize()
    rank, world = distributed.process_slot()
    if world > 1 and args.moe:
        ap.error("--moe over several ranks: the MoE FFN under a data or seq mesh is not "
                 "ported yet")
    shape, axes, n_layers = pick_mesh(args.mesh, args.virtual, world)
    cfg = make_config(n_layers, args.moe, axes, args.virtual)
    rows = slice(None)
    if world > 1:
        # every rank reads and packs the whole stream and keeps its rows on 'data'
        from tpu_tfrecord_torch.device import mesh as meshes
        from tpu_tfrecord_torch.models import sharded

        mesh = meshes.create_mesh(shape, device_type=device.type)
        device = meshes.mesh_device(mesh)
        per = BATCH // shape["data"]
        rows = slice(sharded.axis_index(mesh, "data") * per,
                     (sharded.axis_index(mesh, "data") + 1) * per)
        model_kw = dict(axes, mesh=mesh)
        print(f"mesh: {harness.report_mesh(mesh)} mode={args.mesh} ({world} ranks: {n_layers} "
              f"layers, rank {rank} holds rows [{rows.start}, {rows.stop}) of each batch)")
        if rank == 0:
            generate(args.data_dir)
        distributed.barrier("train_lm data")
    else:
        generate(args.data_dir)
        # the pipe mode runs the schedule on the one card; every other kind is dp
        model_kw = dict(axes, mesh=shape) if "pipe_axis" in axes else {}
        harness.report_mesh(shape)
        if model_kw:
            print(f"mesh: {shape} mode={args.mesh} (one device: {n_layers} layers in "
                  f"{shape['pipe']} stages, n_micro {cfg.n_micro}, virtual {cfg.n_virtual})")
        elif args.mesh != "dp":
            print(f"mesh: {shape} mode={args.mesh} (one device: trains as dp with "
                  f"{n_layers} layers)")
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = optim.adam(params, LR)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    ck = LMCheckpoint(args.ckpt_dir, sync=(args.ckpt_mode == "sync"))
    start_step, tree, payload = ck.load(optim.train_state(params, opt))
    if start_step is not None:
        optim.load_train_state(params, opt, tree)
    del tree
    fsdp = "fsdp_axis" in axes
    if fsdp:
        # every rank holds the whole tree, drawn or restored: it keeps its slices
        params, opt = shard_state(params, opt, mesh)
        print(f"fsdp param bytes/device: {harness.report_fsdp_param_bytes(params)}")
    if start_step is None:
        start_step = 0
        print("fresh start")
    else:
        print(f"resumed at step {start_step}")

    ds = TFRecordDataset(
        args.data_dir, batch_size=READ_BATCH, schema=make_schema(), num_epochs=args.epochs,
        recordType="SequenceExample", shuffle=True, seed=0, process_index=0, process_count=1,
    )
    resume = IteratorState.from_json(payload["input"]) if payload else None
    packer = TokenPacker(BATCH, SEQ_LEN)
    if payload:
        packer.restore(payload["packer"])
    snaps: dict = {}
    # rank 0 alone saves the (whole) state, clears and writes digests
    digest_fh = open(args.digest_out, "a") if args.digest_out and rank == 0 else None
    last_diag: dict = {}
    folded: dict = {}  # this run's folded diagnostics, last values

    def step_fn(state, gb):
        if not args.diagnostics:
            return state, lm.train_step(params, opt, gb["tokens"], cfg, **model_kw)
        loss, last_diag["diag"] = lm.train_step(params, opt, gb["tokens"], cfg,
                                                diagnostics=True, **model_kw)
        return state, loss

    def save(rel_step, _it, _state):
        snap = snaps.get(rel_step - 1)  # the stream position after that batch
        if snap is None or (rank != 0 and not fsdp):
            return
        # under fsdp every rank gathers its slices here, at the same step
        state = full_state(params, opt, mesh) if fsdp else optim.train_state(params, opt)
        if rank == 0:
            ck.save(start_step + rel_step, state,
                    {"input": snap["input"], "packer": snap["packer"]})

    def on_step(rel_step, loss):
        # the loss has been waited on: the diag's one copy adds no wait
        diag = last_diag.pop("diag", None)
        if diag is not None:
            folded.update(harness.fold_model_diagnostics(diag))
        if not args.digest_out:
            return
        line = {"step": start_step + rel_step,
                "digest": snaps.get(rel_step - 1, {}).get("digest"),
                "loss": repr(float(loss))}
        print("lm_step", json.dumps(line), flush=True)
        if digest_fh is not None:
            digest_fh.write(json.dumps(line) + "\n")
            digest_fh.flush()

    if args.trace_out:
        telemetry.enable()
    spool = harness.trainer_spool(args.spool, args.spool_interval)
    phases = harness.StepPhases()
    t0 = time.perf_counter()
    try:
        with ds.batches(resume) as it:
            stream = ({"tokens": b["tokens"][rows]} for b in packed_stream(it, packer, snaps))
            with DeviceIterator(stream, device) as dev_it:
                _, steps, duty = harness.run_train_loop(
                    dev_it,
                    produce=lambda gb: gb,  # DeviceIterator placed it
                    step_fn=step_fn,
                    state=(params, opt),
                    save=save,
                    save_every=args.save_every,
                    on_step=on_step if args.diagnostics or args.digest_out else None,
                    max_steps=args.steps - start_step if args.steps else None,
                    phases=phases,
                )
        ck.wait()  # the in-flight commit lands before completion is judged
        if rank == 0 and not (args.steps and start_step + steps >= args.steps):
            ck.clear()  # the epoch budget is spent: the next run starts afresh
        if args.trace_out:
            telemetry.RECORDER.save_chrome_trace(args.trace_out)
            print(f"trace saved: {args.trace_out}")
        harness.finish(None, start_step + steps, BATCH, t0, duty, clear_state=False,
                       stages=True, phases=phases)
        if args.diagnostics:
            # this run's last values: the process-wide gauges may also hold
            # an earlier run's in the same process
            print("model diagnostics:", json.dumps({k: folded[k] for k in DIAG_GAUGES
                                                    if k in folded}))
    finally:
        if digest_fh is not None:
            digest_fh.close()
        ck.close()
        # a clean exit lands the spool's `final: true` goodbye snapshot
        harness.release_trainer_spool(spool)


if __name__ == "__main__":
    main()
