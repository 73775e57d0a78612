"""End-to-end example: serve the causal LM through the microbatch-streamed
pipeline; the twin of ``examples/serve_lm.py`` on one card.

    python -m tpu_tfrecord_torch.serve_lm [--device cpu] [--ckpt-dir C]
        [--pipe S] [--virtual V] [--requests N] [--mb MB]
    python -m tpu_tfrecord_torch.serve_lm --serve [--host H] [--port P]
        [--max-queue Q] [--default-deadline-s D] [--slo-p99-ms T]

1. load the newest complete generation of an ``LMCheckpoint``
   (``train_lm``'s, in the JAX example's layout: a generation either
   package wrote) through the manifest-last restore (``load_checkpoint``):
   a generation that is still committing has no manifest and is invisible;
2. re-stack its [n_layers, ...] blocks into S x V interleaved chunks
   (``--pipe`` stages of the one-device schedule, ``--virtual`` chunks a
   stage) and answer requests one [mb, L+1] microbatch at a time through
   ``models.lm.LMStream``;
3. time one pass over ``--requests`` microbatches after a warm-up pass,
   check that the streamed logits equal the batch path
   (``LMStream.batch_reference``) bitwise, and print one ``serve_lm OK:``
   JSON line: requests/s, sequences/s, p50/p99 latency (submit to pop,
   host clock).

With ``--serve`` it runs a serving replica over the same checkpoint
(``serving.ServingEngine`` behind a ``serving.ServeServer``): continuous
batching of concurrent socket clients with admission control, deadlines
and a graceful drain on SIGTERM/SIGINT (exit 0). The ready line (addr, pid
JSON) goes to stdout. ``--spool-dir DIR`` spools the replica's telemetry
into DIR under ``--role``; the drain lands its ``final: true`` snapshot.

The model is the JAX example's: vocab 256, d_model 64, 4 heads,
``N_LAYERS`` = 4, L = 64 (the JAX example's ``n_micro`` = 32 / mb is the
batch path's microbatch count, which the one-device stream does not read:
it takes one microbatch a push). On the card the process runs
with ``torch.use_deterministic_algorithms`` (cuBLAS workspace
``:4096:8``). Runs on ``cuda`` unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

from tpu_tfrecord_torch import serving
from tpu_tfrecord_torch.checkpoint import tree_flatten_with_path
from tpu_tfrecord_torch.metrics import METRICS
from tpu_tfrecord_torch.models import lm, optim
from tpu_tfrecord_torch.train_lm import EXAMPLE_ROOT, LR, SEQ_LEN, VOCAB, LMCheckpoint

# the dp_pp trainer's depth: the checkpoint this twin loads carries 4
# stacked blocks
N_LAYERS = 4


def make_config(virtual: int = 2) -> lm.LMConfig:
    return lm.LMConfig(vocab_size=VOCAB, d_model=64, n_heads=4, n_layers=N_LAYERS,
                       max_len=SEQ_LEN, n_virtual=virtual)


def checkpoint_template(cfg: lm.LMConfig):
    """The ``(params, optax.adam state)`` tree the trainer checkpoints, on
    the CPU: the restore's template."""
    params = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return optim.train_state(params, optim.adam(params, LR))


def load_checkpoint(ckpt_dir: str, template):
    """The one serving-side checkpoint read: ``LMCheckpoint.load``, the
    manifest-last ``AsyncCheckpointer.restore``. A generation whose commit
    has not finished (or that a crash left half-written) has no
    ``MANIFEST.json`` and is invisible: the newest complete generation is
    served. Every leaf must have its template leaf's shape.

    Returns ``(step, state)``; ``(None, template)`` when no complete
    generation exists."""
    ck = LMCheckpoint(ckpt_dir)
    try:
        step, state, _payload = ck.load(template)
    finally:
        ck.close()
    if step is not None:
        for (path, got), (_, want) in zip(tree_flatten_with_path(state)[0],
                                          tree_flatten_with_path(template)[0]):
            if tuple(np.shape(got)) != tuple(want.shape):
                raise ValueError(f"checkpoint step {step} leaf {path}: shape "
                                 f"{tuple(np.shape(got))} != {tuple(want.shape)}")
    return step, state


def serve(stream: lm.LMStream, requests) -> dict:
    """Push every request through the stream, collecting the logits FIFO
    and each request's latency (submit to pop, host clock)."""
    outs, lat, submit_t = [], [], []
    t0 = time.perf_counter()

    def collect(ready):
        now = time.perf_counter()
        for o in ready:
            lat.append(now - submit_t[len(outs)])
            outs.append(o)
            METRICS.count("serve.requests")
            METRICS.observe("serve.latency", lat[-1])

    for r in requests:
        submit_t.append(time.perf_counter())
        collect(stream.submit(r))
    collect(stream.flush())
    return {"outs": outs, "latencies": lat, "wall_s": time.perf_counter() - t0}


def one_shot(params, cfg: lm.LMConfig, n_stages: int, mb: int, n_requests: int,
             device, step=None) -> tuple:
    """The timed pass: ``n_requests`` microbatches of ``mb`` synthetic
    sequences after a warm-up pass of S·V + 2, then the bitwise check
    against the batch path. Returns (the ``serve_lm OK:`` line's fields,
    the streamed logits)."""
    stream = lm.LMStream(params, cfg, n_stages, device=device)
    reqs = [lm.make_synthetic_tokens(cfg, mb, seed=1000 + i) for i in range(n_requests)]
    serve(stream, reqs[: min(len(reqs), n_stages * cfg.n_virtual + 2)])
    stream.reset()
    res = serve(stream, reqs)
    outs, lat = res["outs"], res["latencies"]
    if len(outs) != len(reqs):
        raise SystemExit(f"serve_lm: {len(outs)} outputs for {len(reqs)} requests")
    ref = stream.batch_reference(reqs)
    identical = all(np.array_equal(a, b) for a, b in zip(outs, ref))
    if not identical:
        raise SystemExit("serve_lm: streamed logits diverged from the batch path")
    line = {
        "requests": len(reqs),
        "requests_per_s": len(reqs) / res["wall_s"],
        "sequences_per_s": len(reqs) * mb / res["wall_s"],
        "latency_ms_p50": float(np.percentile(lat, 50)) * 1e3,
        "latency_ms_p99": float(np.percentile(lat, 99)) * 1e3,
        "byte_identical_to_batch": identical,
        "ckpt_step": step,
        "shape": f"mb={mb} L={cfg.max_len} S={n_stages} V={cfg.n_virtual}",
        "device": str(torch.device(device)),
    }
    return line, outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--ckpt-dir", default=os.path.join(EXAMPLE_ROOT, "ckpt"),
                    help="train_lm's checkpoint dir (gen-*/ generations)")
    ap.add_argument("--pipe", type=int, default=2, metavar="S",
                    help="stages of the one-device pipeline schedule")
    ap.add_argument("--virtual", type=int, default=2, metavar="V",
                    help="interleaved virtual stages a stage (n_layers must divide by S*V)")
    ap.add_argument("--requests", type=int, default=32, metavar="N",
                    help="streamed microbatches of the timed pass")
    ap.add_argument("--mb", type=int, default=8, help="sequences a request microbatch")
    ap.add_argument("--serve", action="store_true",
                    help="run a serving replica (continuous batching over sockets, "
                         "graceful SIGTERM/SIGINT drain) instead of the timed pass")
    ap.add_argument("--host", default="127.0.0.1", help="--serve: bind host")
    ap.add_argument("--port", type=int, default=0,
                    help="--serve: bind port (0 = ephemeral, printed on the ready line)")
    ap.add_argument("--max-queue", type=int, default=16,
                    help="--serve: admission queue bound (beyond it requests are shed "
                         "with a Retry-After hint)")
    ap.add_argument("--default-deadline-s", type=float, default=None,
                    help="--serve: deadline of requests that carry none")
    ap.add_argument("--slo-p99-ms", type=float, default=250.0,
                    help="--serve: p99 target of the status verdict")
    ap.add_argument("--spool-dir", default=None,
                    help="--serve: telemetry spool dir (read with fleet.TelemetryAggregator)")
    ap.add_argument("--role", default="serving",
                    help="--serve: telemetry role stamped on the spool")
    args = ap.parse_args(argv)
    serving._deterministic(args.device)

    cfg = make_config(args.virtual)
    step, state = load_checkpoint(args.ckpt_dir, checkpoint_template(cfg))
    if step is None:
        print(f"no complete checkpoint generation in {args.ckpt_dir}: run train_lm first",
              file=sys.stderr)
        sys.exit(1)
    params = state[0]  # the serving path reads the params half of (params, opt)
    print(f"serving checkpoint step {step} on pipe={args.pipe} virtual={args.virtual} "
          f"mb={args.mb} device={args.device}", file=sys.stderr if args.serve else sys.stdout)

    if args.serve:
        policy = serving.ServePolicy(mb=args.mb, max_queue=args.max_queue,
                                     default_deadline_s=args.default_deadline_s,
                                     slo_p99_ms=args.slo_p99_ms)
        engine = serving.ServingEngine(params, cfg, args.pipe, policy=policy, device=args.device)
        server = serving.ServeServer(engine, host=args.host, port=args.port).start()
        sys.exit(serving.run_server(server, spool_dir=args.spool_dir, role=args.role,
                                    ready_fh=sys.stdout))

    line, _ = one_shot(params, cfg, args.pipe, args.mb, args.requests, args.device, step)
    print("serve_lm OK:", json.dumps(line), flush=True)


if __name__ == "__main__":
    main()
