"""End-to-end example: train the causal LM on packed token SequenceExamples,
resumably; the twin of ``examples/train_lm.py`` on one card.

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
``dp_sp``; on the one card the port trains on, every kind trains as ``dp``
with 2 layers, as the JAX example's ``pick_mesh`` does on one device,
``--virtual 2`` needs ``--mesh dp_pp`` there too, and ``--moe`` is refused
with ``--mesh dp_pp`` as in JAX. Not ported: ``--spool`` and
``--spool-interval`` (the trainer's telemetry spool), which raise
``OptionNotPortedError``. Runs on ``cuda`` unless ``--device cpu``.
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
from tpu_tfrecord_torch.device.ingest import DeviceIterator, TokenPacker
from tpu_tfrecord_torch.io.dataset import IteratorState, TFRecordDataset
from tpu_tfrecord_torch.io.writer import DatasetWriter
from tpu_tfrecord_torch.metrics import METRICS
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
MOE_GAUGES = ("moe.expert_imbalance", "moe.dropped_fraction", "moe.gate_entropy")


def make_config(n_layers: int = 2, moe_experts: int = 0) -> lm.LMConfig:
    return lm.LMConfig(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=n_layers,
                       max_len=SEQ_LEN, moe_experts=moe_experts)


def pick_mesh(kind: str, virtual: int = 1):
    """(mesh shape, cfg axes, n_layers) of ``--mesh kind`` on one card: the
    JAX example's ``pick_mesh`` with one device, where every kind degrades
    to ``dp`` with 2 layers (its sp, fsdp and pp meshes need an even device
    count, and ``virtual`` only shapes the dp_pp mesh)."""
    if kind not in MESH_KINDS:
        raise ValueError(f"--mesh {kind!r}: one of {MESH_KINDS}")
    return {"data": 1}, {"data_axis": "data"}, 2


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

    def clear(self) -> None:
        """Drop every generation (the epoch budget is spent)."""
        self._ck.clear()

    def wait(self) -> None:
        self._ck.wait()

    def close(self) -> None:
        self._ck.close()


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
    if args.spool_interval is not None:
        raise OptionNotPortedError(
            "--spool-interval: the trainer's telemetry spool needs the fleet layer, "
            "which the port does not have yet"
        )
    harness.trainer_spool(args.spool)  # raises for a directory


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--mesh", default=os.environ.get("LM_MESH", "dp_sp"), choices=MESH_KINDS,
                    help="the JAX example's mesh kinds; on one card each trains as dp "
                         "with 2 layers")
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
    ap.add_argument("--spool", default=None, metavar="SPOOL_DIR")
    ap.add_argument("--spool-interval", type=float, default=None, metavar="SECONDS")
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
    generate(args.data_dir)
    mesh, _axes, n_layers = pick_mesh(args.mesh, args.virtual)
    if args.mesh != "dp":
        print(f"mesh: {mesh} mode={args.mesh} (one device: trains as dp with {n_layers} layers)")
    cfg = make_config(n_layers, args.moe)
    params = lm.init_params(cfg, torch.Generator(device=device).manual_seed(0), device)
    opt = optim.adam(params, LR)
    os.makedirs(args.ckpt_dir, exist_ok=True)
    ck = LMCheckpoint(args.ckpt_dir, sync=(args.ckpt_mode == "sync"))
    start_step, tree, payload = ck.load(optim.train_state(params, opt))
    if start_step is None:
        start_step = 0
        print("fresh start")
    else:
        optim.load_train_state(params, opt, tree)
        print(f"resumed at step {start_step}")
    del tree

    ds = TFRecordDataset(
        args.data_dir, batch_size=READ_BATCH, schema=make_schema(), num_epochs=args.epochs,
        recordType="SequenceExample", shuffle=True, seed=0,
    )
    resume = IteratorState.from_json(payload["input"]) if payload else None
    packer = TokenPacker(BATCH, SEQ_LEN)
    if payload:
        packer.restore(payload["packer"])
    snaps: dict = {}
    digest_fh = open(args.digest_out, "a") if args.digest_out else None
    last_diag: dict = {}

    def step_fn(state, gb):
        if not args.diagnostics:
            return state, lm.train_step(params, opt, gb["tokens"], cfg)
        loss, last_diag["diag"] = lm.train_step(params, opt, gb["tokens"], cfg, diagnostics=True)
        return state, loss

    def save(rel_step, _it, _state):
        snap = snaps.get(rel_step - 1)  # the stream position after that batch
        if snap is None:
            return
        ck.save(start_step + rel_step, optim.train_state(params, opt),
                {"input": snap["input"], "packer": snap["packer"]})

    def on_step(rel_step, loss):
        # the loss has been waited on: the diag's one copy adds no wait
        diag = last_diag.pop("diag", None)
        if diag is not None:
            harness.fold_model_diagnostics(diag)
        if digest_fh is None:
            return
        line = {"step": start_step + rel_step,
                "digest": snaps.get(rel_step - 1, {}).get("digest"),
                "loss": repr(float(loss))}
        print("lm_step", json.dumps(line), flush=True)
        digest_fh.write(json.dumps(line) + "\n")
        digest_fh.flush()

    if args.trace_out:
        telemetry.enable()
    phases = harness.StepPhases()
    t0 = time.perf_counter()
    try:
        with ds.batches(resume) as it:
            with DeviceIterator(packed_stream(it, packer, snaps), device) as dev_it:
                _, steps, duty = harness.run_train_loop(
                    dev_it,
                    produce=lambda gb: gb,  # DeviceIterator placed it
                    step_fn=step_fn,
                    state=(params, opt),
                    save=save,
                    save_every=args.save_every,
                    on_step=on_step if args.diagnostics or digest_fh is not None else None,
                    max_steps=args.steps - start_step if args.steps else None,
                    phases=phases,
                )
        ck.wait()  # the in-flight commit lands before completion is judged
        if not (args.steps and start_step + steps >= args.steps):
            ck.clear()  # the epoch budget is spent: the next run starts afresh
        if args.trace_out:
            telemetry.RECORDER.save_chrome_trace(args.trace_out)
            print(f"trace saved: {args.trace_out}")
        harness.finish(None, start_step + steps, BATCH, t0, duty, clear_state=False,
                       stages=True, phases=phases)
        if args.diagnostics:
            gauges = {k: METRICS.gauge_value(k) for k in MOE_GAUGES}
            print("model diagnostics:", json.dumps({k: v for k, v in gauges.items()
                                                    if v is not None}))
    finally:
        if digest_fh is not None:
            digest_fh.close()
        ck.close()


if __name__ == "__main__":
    main()
