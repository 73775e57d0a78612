"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device facts: the card's name and power limit, TF32 switched off.
2. Build every CUDA kernel from ``tpu_tfrecord_torch/csrc`` with nvcc for
   sm_90a (all sources at once), print ptxas' registers and spills for each
   kernel instance (a spill fails the run), and hold each instance against
   its plain PyTorch version on the card at the main-path shape and at the
   edges of its design.
3. Time each instance at the main-path shape beside its plain version, one
   PyTorch library call computing the same function, and the least time
   the card could take (bytes over 3.35 TB/s or operations over the peak
   rate). Device times come from CUDA-graph replays of many calls, so the
   host's launch time is not counted (it is printed apart: eager calls back
   to back). Warm: one input (partly L2-resident, as on the main path where
   E was just written by the concat). Cold: the calls cycle over inputs
   that together exceed the 50 MB L2, so no call finds its input there;
   the share of the bound is stated for the cold time.
4. The main path at full Criteo width. Host facts first (CPU model and
   cores, ``g++ --version``): host rates depend on them. The native host
   library (``tpu_tfrecord_torch/csrc/tfrecord_native.cc``, g++) is built
   beside the CUDA kernels and its build time printed. Then: write 2 shards
   x 16,384 Example rows through the port's writer; iterate them for 8
   epochs with ``TFRecordDataset`` (native decode on its producer thread,
   hashing into 2^20 buckets, packing dense/cat) without scoring, for the
   decode-only rate; score the same 8 epochs (16 batches) with the
   26 x 2^20 x 32 DLRM (3.49 GB table) through ``score_files`` in bf16
   (the bf16 instance), and the same 8 epochs in f32 activations (the f32
   instance). Each path's launch counts must match the batches it scored,
   and its logits must match a run whose interaction is the plain version.
   One 16,384-row batch decoded natively and by the Python oracle must give
   identical dense and cat matrices. Then, for each dtype, the forward's
   device time, its kernels (torch.profiler), the rows/s whole and steady
   (batches 2-16), host and H2D ms per batch, and the card's idle share.

5. Training at full width, in phase 4's shards. The sparse path:
   ``train_files(sparse=True, shuffle=True, shuffle_window=2, seed=0)``
   over 8 epochs (16 steps of 16,384 rows: Adam(1e-3) on the MLPs,
   row-wise AdaGrad on the table at embed_lr 0.01) with its own counter
   window; every loss finite, 16 ``bf16_mma`` launches and 0 ``f32_tiled``;
   the losses and the table match a run from the same weights under the
   plain interaction (plain forward, autograd backward). The same sparse
   run in f32 activations (16 ``f32_tiled`` launches, 0 ``bf16_mma``), with
   the same checks and its own step profile. The dense path (bf16 only):
   ``train_files(sparse=False)`` over one shard for 2 epochs (2 steps,
   Adam over every parameter, the table's 3.49 GB gradient included),
   the same checks. The interaction's backward (``DotInteraction``)
   against autograd through the plain version at (16384, 27, 32) in bf16
   and f32, with its device time (graph replay) beside the kernel's. Then
   where a training step's time goes: one sparse step's time on a resident
   batch (CUDA events, back to back), its profile by part (gather,
   forward, interaction backward, the rest of the backward, Adam, sort,
   segment sums, scatters), the loop's rows/s (whole and steps 2-16), host,
   H2D and step ms per step, and the device's idle share.

6. The feed at full width, in phase 4's shards. Decode-only rows/s at 1, 2,
   4 and 6 decode workers over the same 8 epochs, with every batch's
   checksum equal across the worker counts. bf16 serving through
   ``score_files(num_workers=n)`` at the same counts against the direct loop
   (decode on one thread, densify inline, a synchronized copy out of fresh
   pinned buffers) in the same run: logits bit-equal. The host side alone
   (decode and densify at 4 workers, nothing sent to the card), and which
   stage binds serving and training. bf16 sparse training, 16
   shuffled steps at 4 decode workers, through three feeds (dispatch-ahead,
   the transfer thread, the 20-bit wire), each against the direct loop at
   phase 5's tolerances (before the wire run, the first and second call of
   its unpack and dense transform, timed); one f32 sparse run through the
   fastest of them, against the direct loop in f32. For each run: whole and steady rows/s, the
   host-wait, H2D and step medians, the duty cycle and the launches. Last,
   the staging race check: 64 batches of distinct contents through
   ``DeviceIterator(depth=2)`` in both modes while the consumer runs a long
   device op on each; every device batch's checksum must equal its host
   batch's.

7. The data-source API at full width, in phase 4's temp dir, host CPU facts
   first. (a) ``DatasetWriter.write_batches`` at bench_write.py's shape
   (6 x 16,384 Criteo columnar rows): sequential (1 worker) and pipelined
   (4 workers, 4 shards), uncompressed and deflate, 3 interleaved pairs,
   best of each, beside bench_write.py's two-thread zlib probe; the
   pipelined files' bytes must be identical at 2 and 4 workers. (b) Phase
   4's rows with ``day`` = the shard's index through ``io.write(...,
   partition_by=["day"], codec="gzip")`` at 1 and 4 write workers, the same
   records both ways. (c) ``reader().schema()`` and
   ``infer_schema_all_files(num_workers=4)`` must give the written schema
   with ``day`` appended as LongType, and ``read(limit=1024)`` the first
   1,024 source rows. (d) bf16 scoring of the partitioned root over 8
   epochs (``day`` read and ignored by the model): logits bit-equal to
   phase 4's bf16 logits, 16 ``bf16_mma`` launches in its own window.
   (e) Shard00's records through snappy, lz4 and bzip2 (and zstd where
   ``zstandard`` is installed): every decoded batch digest equal to the
   uncompressed shard's.

8. Resumable training at full width, in phase 4's shards (bf16, sparse
   steps through ``harness.run_train_loop``, phase 5's shuffled read:
   ``shuffle_window=2, seed=0``, 8 epochs, 16 steps). The free disk is
   printed beside the checkpoint's size (3.6 GB; keep=1 holds two during a
   commit) and the phase fails if it is short. An uninterrupted run with no
   checkpoint records each step's batch digest and loss. A run from the
   same seed with a ``TrainCheckpointer`` (async, keep=1) saving every 8
   steps stops at step 12; a model from another seed restores step 8 and
   its input position (every tensor bit-equal to the step-8 snapshot),
   then runs steps 9-16: digests equal to the uninterrupted run's, losses
   within 2e-2, table rows within 5e-3 (phase 5's gates). Async and sync
   twins of 16 steps saving at 8 and 16 split what the background commit
   hides: snapshot (the first save of the process apart: it pins the host
   buffers), commit, commit wait, drain, StepPhases shares and verdict,
   rows/s beside phase 5's loop. 68 ``bf16_mma`` launches (16 + 12 + 8 +
   16 + 16). Last, the kill drill: ``python -m tpu_tfrecord_torch.train_dlrm``
   (sparse, on the card) is killed with SIGKILL after its "step 16" line
   and run again; it must resume from a nonzero position and finish, the
   saved step plus its steps making the 32-step epoch budget.

9. The sequence models (no DLRM kernel runs here: every instance's launch
   count over the phase must be 0). The twins' SequenceExamples are
   written (``train_lm``'s 4 x 256 token documents, ``train_longdoc``'s
   4 x 256 frame documents). (1) The LM at the twin's width (vocab 256,
   d_model 64, 4 heads, 2 layers, L = 64, B = 32, f32, TF32 off) with one
   set of weights on the card and on the CPU: logits within 1e-4, then 16
   Adam steps with losses within a relative 1e-4, on slice-packed batches
   and on ``TokenPacker(32, 64, "best_fit")`` batches with segment ids.
   (2) The long_doc feed's bf16 frames (native pad and round,
   ``DeviceIterator``) bit-equal to the float32 pad cast on the card, and
   the classifier's logits card against CPU (bf16 within 2e-2, f32 within
   1e-4). (3) ``python -m tpu_tfrecord_torch.train_lm`` for 64 steps
   saving every 8, then killed with SIGKILL after step 20 and run again:
   it must resume at step 16 with the uninterrupted run's digests for
   steps 17-64 and its losses (bit-equal, or within a relative 1e-4: the
   line says which), and its tokens/s whole and steady. (4) ``python -m
   tpu_tfrecord_torch.train_longdoc`` whole (32 steps, bf16 frames):
   finite losses, the phase shares and verdict. (5) Rates beside the
   card's name and power limit: LM and long_doc train steps/s eager on a
   resident batch, with device ms a step (torch.profiler) and the idle
   share; ``TokenPacker`` docs/s and density at the bench's pack shape.

10. LM serving (no DLRM kernel runs here: every instance's launch count
   over the phase must be 0), under deterministic algorithms. (a) The
   serve_lm LM (vocab 256, d_model 64, 4 heads, 4 layers, L = 64) trained
   16 Adam steps on ``make_synthetic_tokens`` and saved through
   ``train_lm.LMCheckpoint``; a second generation parked before its
   manifest by a writer killed there; ``serve_lm.load_checkpoint`` must
   return the complete one, bit-equal. (b) serve_lm's timed pass (32
   requests of mb 8) at (S, V) = (1, 2) and (2, 2): streamed logits
   bitwise equal to ``batch_reference``, the layouts within 1e-5 of each
   other and the card within 1e-4 of a CPU run; requests/s, sequences/s,
   p50/p99. (c) A replica (``ServingEngine`` + ``ServeServer`` on
   127.0.0.1, S = 1, V = 2, mb 8, max_queue 16) under 8 concurrent
   ``ServeClient`` threads of 4 requests x 16 new tokens: every request's
   tokens equal ``sequential_reference`` on the card; meanwhile a client
   hangs up mid-generation (counted once), a ``burst`` of 8 past a full
   queue on a second replica is shed by exactly 8 with a Retry-After hint,
   and two deadlines (at admission, mid-generation) are dropped and
   counted; tokens/s, requests/s, latencies, ticks, ``serve.*`` counters
   and the verdict. (d) One engine tick at (1, 2) under torch.profiler:
   host ms, device ms, kernels, idle share. (e) ``python -m
   tpu_tfrecord_torch.serving --device cuda`` as a subprocess: its ready
   line, 4 requests equal to the reference, SIGTERM, exit 0 within 60 s.

11. Mixture-of-Experts on one card (no DLRM kernel runs here: every
   instance's launch count over the phase must be 0), under deterministic
   algorithms. (a) ``moe_apply`` at T = 2048 (d_model 64, d_ff 256, 4
   experts, f32) on the card against the CPU at top_k 2, top_k 1, capacity
   factor 0.25 and a quarter of the tokens masked out: y and aux within
   1e-4, the routing (each rank's expert and slot) and the counts equal,
   the gradients of x and the three weights within 1e-4 of their scale,
   and the smallest probability margin of a choice. (b) The MoE LM of
   ``train_lm --moe 4`` (top-2) with one set of weights on the card and on
   the CPU: logits within 1e-4, then 16 Adam steps in lockstep (the CPU
   takes the card's parameters and moments before each step) with losses
   within a relative 1e-4 and each step's ``expert_tokens`` and
   ``expert_kept`` equal; the same steps run free are printed, not gated.
   (c) ``python -m tpu_tfrecord_torch.train_lm --moe 4 --diagnostics
   --trace-out`` for 32 steps saving every 8, then killed with SIGKILL
   after step 12 and run again: it must resume at step 8 with the
   uninterrupted run's digests and losses for steps 9-32 (bit-equal, or
   within a relative 1e-4: the line says which), finite ``moe.*`` gauges
   and ``train.step`` spans in its trace. (d) The MoE long_doc's logits
   card against CPU (bf16 within 2e-2, f32 within 1e-4) and
   ``LONGDOC_MOE_EXPERTS=4 python -m tpu_tfrecord_torch.train_longdoc``
   whole (finite losses, the phase shares and verdict), run beside (c).
   (e) Under the default algorithms, beside the card's name and power
   limit: the MoE LM train step and phase 9's dense step on a resident
   batch (host ms, device ms and kernels a step, idle share) and
   ``moe_apply``'s forward at T = 2048.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Without
a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import copy
import dataclasses
import gc
import hashlib
import itertools
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS_PER_S = {torch.bfloat16: 989e12, torch.float32: 67e12}  # dense, no sparsity

CRITEO_ROWS_PER_SHARD = 16384
CRITEO_SHARDS = 2
BATCH = 16384
VOCAB = 1 << 20
EPOCHS = 8  # of the main path: 16 batches


def device_facts() -> str:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(smi)
    print(
        f"allow_tf32: matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}"
    )
    return smi


def graph_ms(fn, reps: int = 15, calls: int = 20) -> float:
    """Median over ``reps`` replays of the device time per call of a CUDA
    graph that holds ``calls`` calls of ``fn`` (captured after a warm-up on
    a side stream): no host launch time is counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    for _ in range(3):
        graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def median_ms(fn, warmup: int = 10, reps: int = 15, calls: int = 20) -> float:
    """Median over ``reps`` windows of the device time per call, each window
    ``calls`` back-to-back calls between two CUDA events (so the queue stays
    full and host launch time is not counted)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


# the main path's shape, then the edges of the bf16 kernel's design
CHECK_SHAPES = [
    (16384, 27, 32),  # main path
    (1, 27, 32),      # one sample
    (13, 27, 32),     # ragged last tile
    (37, 17, 24),     # F and D not multiples of 16 (row and K padding)
    (40, 27, 8),      # D=8: K padding, one 16-byte chunk per row
    (21, 27, 12),     # rows not whole 16-byte chunks: scalar staging
    (64, 64, 16),     # large F
    (9, 128, 16),     # F=128
    (11, 127, 32),    # odd P and a tile below 8: spans start mid-chunk
    (8, 2, 8),        # F=2, P=1
    (21, 27, 7),      # D % 4 != 0: f32 rows not whole 16-byte chunks either
]
MAIN_SHAPE = (BATCH, 27, 32)
INSTANCE_DTYPE = {"bf16_mma": torch.bfloat16, "f32_tiled": torch.float32}
DTYPE_INSTANCE = {v: k for k, v in INSTANCE_DTYPE.items()}


def check_build_log(log: str) -> None:
    """Print registers and spills of each kernel instance in ptxas' report;
    fail on any spill."""
    names = re.findall(r"Compiling entry function '(\w+)'", log)
    spills = re.findall(r"(\d+) bytes spill stores, (\d+) bytes spill loads", log)
    regs = re.findall(r"Used (\d+) registers", log)
    if not names or not len(names) == len(spills) == len(regs):
        raise SystemExit("could not read ptxas' report of the kernel build")
    for mangled, (st, ld), r in zip(names, spills, regs):
        m = re.search(r"(dot_interaction_[a-z]+_kernel)(?:ILb([01])E(?:Li(\d+)E)?E)?", mangled)
        name = mangled if m is None else m[1] + (
            "" if not m[2] else f"<vec_loads={m[2] == '1'}, k_steps={m[3]}>" if m[3]
            else f"<vec_loads={m[2] == '1'}>")
        print(f"ptxas {name}: {r} registers, spill stores {st} B, spill loads {ld} B")
        if int(st) or int(ld):
            raise SystemExit(f"kernel {name} spills registers")


def check_interaction() -> dict:
    """Both kernel instances vs the plain version on the card at every
    listed shape, and on an E whose base is not 16-byte aligned; returns the max abs error of each instance at the main-path
    shape."""
    from tpu_tfrecord_torch.models.interaction import (
        dot_interaction_cuda,
        dot_interaction_reference,
    )

    tol = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = {}

    def check(emb, label):
        got = dot_interaction_cuda(emb)
        torch.cuda.synchronize()
        want = dot_interaction_reference(emb)
        err = (got.float() - want.float()).abs().max().item()
        ok = got.shape == want.shape and torch.allclose(got.float(), want.float(), **tol[emb.dtype])
        print(f"dot_interaction {label} {str(emb.dtype)[6:]}: max_abs_err={err} "
              f"{'ok' if ok else 'MISMATCH'} ({tol[emb.dtype]})")
        if not ok:
            raise SystemExit(f"dot_interaction kernel disagrees at {label} {emb.dtype}")
        return err

    for shape in CHECK_SHAPES:
        for instance, dtype in INSTANCE_DTYPE.items():
            err = check(torch.randn(shape, generator=gen, device="cuda").to(dtype), shape)
            if shape == MAIN_SHAPE:
                main_err[instance] = err
    for dtype in INSTANCE_DTYPE.values():
        flat = torch.randn(13 * 27 * 32 + 1, generator=gen, device="cuda").to(dtype)
        check(flat[1:].view(13, 27, 32),
              f"(13, 27, 32) at a base {flat.element_size()} bytes past 16-byte alignment")
    return main_err


def time_interaction(dtype, cold_inputs: int = 6) -> dict:
    """Warm and cold device times of the kernel instance for ``dtype`` at
    the main-path shape, beside the plain version, one library call and the
    bound."""
    from tpu_tfrecord_torch.models.interaction import (
        _interaction_plan,
        dot_interaction_cuda,
        dot_interaction_reference,
        tril_pairs,
    )

    b, f, d = MAIN_SHAPE
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"plan at {MAIN_SHAPE} {str(dtype)[6:]}: {_interaction_plan(b, f, d, dtype, sms)}")
    gen = torch.Generator(device="cuda").manual_seed(1)
    embs = [torch.randn(MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
            for _ in range(cold_inputs)]
    emb = embs[0]
    rows, cols = (t.long() for t in tril_pairs(f, emb.device))
    p = f * (f - 1) // 2

    def library(e):  # one PyTorch call's worth of work; never used by the port
        return torch.einsum("bfd,bgd->bfg", e, e)[:, rows, cols]

    cycle = itertools.cycle(embs)
    elt = emb.element_size()
    nbytes = b * f * d * elt + b * p * elt
    nops = 2 * b * p * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S[dtype] * 1e3
    out = {
        "ms": graph_ms(lambda: dot_interaction_cuda(emb)),
        "cold_ms": graph_ms(lambda: dot_interaction_cuda(next(cycle)), calls=4 * cold_inputs),
        "eager_ms": median_ms(lambda: dot_interaction_cuda(emb)),
        "plain_ms": graph_ms(lambda: dot_interaction_reference(emb)),
        "library_ms": graph_ms(lambda: library(emb)),
        "library_cold_ms": graph_ms(lambda: library(next(cycle)), calls=4 * cold_inputs),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    out["cold_bytes_per_s"] = nbytes / (out["cold_ms"] / 1e3)
    out["cold_share_of_bound"] = out["bound_ms"] / out["cold_ms"]
    print(f"dot_interaction timing at {MAIN_SHAPE} {str(dtype)[6:]} (device time per call, "
          f"CUDA graph replay): kernel warm {out['ms']:.4f} ms, cold {out['cold_ms']:.4f} ms "
          f"({cold_inputs} inputs, {cold_inputs * b * f * d * elt / 1e6:.0f} MB, cycled); "
          f"plain {out['plain_ms']:.4f} ms; library einsum+index warm {out['library_ms']:.4f} ms, "
          f"cold {out['library_cold_ms']:.4f} ms; bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP); cold: "
          f"{out['cold_bytes_per_s'] / 1e12:.3f} TB/s, {out['cold_share_of_bound']:.3f} of the bound; "
          f"eager wrapper calls back to back (CUDA events, host launch included): "
          f"{out['eager_ms']:.4f} ms per call")
    return out


def check_small_forward() -> None:
    """A small f32 DLRM (dot + sequence tower) gives the same logits on the
    card as on the CPU."""
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import DLRMConfig, init_params, make_synthetic_batch

    cfg = DLRMConfig(num_dense=4, num_categorical=3, vocab_size=16, embed_dim=8,
                     bottom_mlp=(8, 8), top_mlp=(8, 1), seq_len=4, seq_dim=4,
                     dtype=torch.float32, interaction="dot")
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(1), "cuda")
    host = make_synthetic_batch(cfg, 13, seed=3)
    got = model(make_device_batch(host, "cuda")).cpu()
    want = model.to("cpu")(make_device_batch(host, "cpu"))
    err = (got - want).abs().max().item()
    print(f"small f32 DLRM forward, card vs CPU: max_abs_err={err}")
    if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
        raise SystemExit("small DLRM forward on the card disagrees with the CPU")


def criteo_write_schema():
    """The write-side Criteo schema: int64 label and ints, 26 strings."""
    from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType

    return StructType(
        [StructField("label", LongType(), nullable=False)]
        + [StructField(f"I{i}", LongType()) for i in range(1, 14)]
        + [StructField(f"C{i}", StringType()) for i in range(1, 27)]
    )


def criteo_shard_rows():
    """The rows of each of phase 4's shards, as lazy generators: Criteo-shaped
    (label, 13 ints, 26 8-letter strings), as bench.py generates them."""
    rng = np.random.default_rng(0)
    shards = []
    for _ in range(CRITEO_SHARDS):
        n = CRITEO_ROWS_PER_SHARD
        ints = rng.integers(0, 1 << 31, size=(n, 13))
        labels = rng.integers(0, 2, size=n)
        cats = rng.integers(0, 16, size=(n, 26, 8), dtype=np.uint8) + 97
        shards.append((
            [int(labels[r])] + [int(v) for v in ints[r]]
            + [cats[r, c].tobytes().decode() for c in range(26)]
            for r in range(n)
        ))
    return shards


def write_criteo(data_dir: str) -> None:
    """Phase 4's shards through the port's writer, one dir per shard."""
    from tpu_tfrecord_torch import io as tfio

    schema = criteo_write_schema()
    for s, rows in enumerate(criteo_shard_rows()):
        tfio.write(rows, schema, os.path.join(data_dir, f"shard{s:02d}"), mode="overwrite")


@contextlib.contextmanager
def plain_interaction():
    """Run the DLRM with the plain interaction in place of the kernel."""
    from tpu_tfrecord_torch.models import dlrm, interaction

    dlrm.dot_interaction = interaction.dot_interaction_reference
    try:
        yield
    finally:
        dlrm.dot_interaction = interaction.dot_interaction


def with_dtype(model, dtype):
    """The same DLRM parameters (shared, not copied: the 3.49 GB table stays
    one) under a config whose activations are ``dtype``."""
    twin = copy.copy(model)
    twin.cfg = dataclasses.replace(model.cfg, dtype=dtype)
    return twin


def host_facts() -> None:
    """The host CPU's model and cores, and the C++ compiler that builds the
    native library: host rates depend on them."""
    with open("/proc/cpuinfo") as fh:
        cpuinfo = fh.read()
    logical = len(re.findall(r"^processor\s*:", cpuinfo, re.M))
    first = {}
    for line in cpuinfo.split("\n\n")[0].splitlines():
        key, sep, value = line.partition(":")
        if sep:
            first[key.strip()] = value.strip()
    model = first.get("model name", "unknown")
    if model == "unknown":  # some virtual machines do not report it there
        lscpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
        found = re.search(r"^Model name:\s*(.+)$", lscpu, re.M)
        model = found[1].strip() if found else "not reported"
    ident = ", ".join(f"{k} {first[k]}" for k in ("vendor_id", "cpu family", "model",
                                                   "stepping", "cpu MHz", "cache size")
                      if k in first)
    flags = set(first.get("flags", "").split())
    usable = len(os.sched_getaffinity(0))
    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True,
                         check=True).stdout.splitlines()[0]
    print(f"host CPU: {model} ({ident}; sse4_2={'sse4_2' in flags}, bmi2={'bmi2' in flags}); "
          f"{logical} logical CPUs, {usable} usable by this process")
    print(f"host C++ compiler: {gxx}")


def build_native() -> None:
    """Build (or find) and load the native host library, and say how long
    it took."""
    from tpu_tfrecord_torch import _native

    existed = _native.lib_path().exists()
    t0 = time.perf_counter()
    _native.load()
    secs = time.perf_counter() - t0
    how = "found already built" if existed else "built with " + " ".join(
        _native.compile_command(_native.lib_path()))
    print(f"native host library {_native.lib_path().name}: {how}, {secs:.1f} s")


def criteo_read_kw() -> dict:
    """The read side of the main path: the Criteo schema with int32 ints,
    categoricals hashed into VOCAB buckets, dense and cat packed."""
    from tpu_tfrecord_torch.schema import IntegerType, StringType, StructField, StructType

    schema = StructType(
        [StructField("label", IntegerType(), nullable=False)]
        + [StructField(f"I{i}", IntegerType()) for i in range(1, 14)]
        + [StructField(f"C{i}", StringType()) for i in range(1, 27)]
    )
    return dict(schema=schema, recordType="Example",
                hash_buckets={f"C{i}": VOCAB for i in range(1, 27)},
                pack={"dense": [f"I{i}" for i in range(1, 14)],
                      "cat": [f"C{i}" for i in range(1, 27)]})


def shard_dirs(data_dir: str) -> list:
    return sorted(os.path.join(data_dir, d) for d in os.listdir(data_dir) if d.startswith("shard"))


def decode_only(data_dir: str) -> None:
    """Rows/s of the dataset alone (native decode, hash and pack on the
    producer thread) over the shards, EPOCHS times, with no scoring."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(shard_dirs(data_dir), BATCH, num_epochs=EPOCHS, **criteo_read_kw())
    rows = 0
    t0 = time.perf_counter()
    with ds.batches() as it:
        for cb in it:
            rows += cb.num_rows
    secs = time.perf_counter() - t0
    want = CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD * EPOCHS
    if ds.decoder != "native" or rows != want:
        raise SystemExit(f"decode-only: {rows} rows from the {ds.decoder} decoder, want {want}")
    print(f"decode only ({ds.decoder} decoder, producer thread, {EPOCHS} epochs of "
          f"{CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} rows): {rows} rows in {secs:.3f} s "
          f"= {rows / secs:.1f} rows/s (host)")


def check_native_vs_python(data_dir: str) -> None:
    """One full batch decoded by the native decoder and by the Python
    oracle on this host: the dense and cat matrices must be identical."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    got = {}
    for decoder in ("native", "python"):
        ds = TFRecordDataset(shard_dirs(data_dir)[0], BATCH, decoder=decoder, **criteo_read_kw())
        t0 = time.perf_counter()
        with ds.batches() as it:
            cb = next(it)
        got[decoder] = (cb, time.perf_counter() - t0)
    (nat, nat_s), (py, py_s) = got["native"], got["python"]
    for name in ("dense", "cat"):
        a, b = nat[name].values, py[name].values
        if a.dtype != b.dtype or a.shape != b.shape or not (a == b).all():
            raise SystemExit(f"native and Python decoders disagree on {name}: "
                             f"{a.dtype}{a.shape} vs {b.dtype}{b.shape}")
    print(f"native vs Python decoder, one {BATCH}-row batch: dense {nat['dense'].values.shape} "
          f"and cat {nat['cat'].values.shape} identical; native {nat_s * 1e3:.1f} ms, "
          f"Python {py_s:.2f} s (first batch of a fresh dataset, host)")


def score_path(label, paths, cfg, model, tol, **kw):
    """Score ``paths`` through ``score_files`` with the counts set to 0 just
    before and read just after; check the logits against a run with the
    plain interaction. Returns (ScoreResult, {instance: launches})."""
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    reset_launch_counts()
    res = score_files(paths, cfg, model, BATCH, "cuda", **kw)
    launches = dict(dot_interaction.instance_launches)
    with plain_interaction():
        ref = score_files(paths, cfg, model, BATCH, "cuda", **kw)
    for i in range(res.batches):
        print(f"{label} batch {i}: host (wait) {res.host_s[i] * 1e3:.2f} ms, "
              f"h2d {res.h2d_s[i] * 1e3:.3f} ms, forward {res.forward_s[i] * 1e3:.3f} ms, "
              f"done at {res.done_s[i]:.4f} s")
    logits = res.logits
    n_rows = res.batches * BATCH
    if res.batches == 0 or logits.shape != (n_rows,) or not torch.isfinite(logits).all():
        raise SystemExit(f"{label}: bad logits: shape {tuple(logits.shape)}, "
                         f"finite={bool(torch.isfinite(logits).all())}")
    want = {k: (res.batches if k == DTYPE_INSTANCE[cfg.dtype] else 0) for k in launches}
    if launches != want:
        raise SystemExit(f"{label}: kernel launches {launches} for {res.batches} batches")
    err = (logits - ref.logits).abs().max().item()
    print(f"{label}: {res.batches} batches, {n_rows} logits, kernel launches {launches}, "
          f"max |logit - plain-interaction logit| = {err}")
    if not torch.allclose(logits, ref.logits, rtol=tol, atol=tol):
        raise SystemExit(f"{label}: logits disagree with the plain-interaction forward")
    return res, launches


def criteo_cfg(dtype=torch.bfloat16):
    from tpu_tfrecord_torch.models.dlrm import DLRMConfig

    return DLRMConfig(num_dense=13, num_categorical=26, vocab_size=VOCAB, embed_dim=32,
                      bottom_mlp=(64, 32), top_mlp=(64, 1), interaction="dot", dtype=dtype)


def criteo_files_kw() -> dict:
    """The keywords of ``score_files`` / ``train_files`` for the Criteo shards."""
    read = criteo_read_kw()
    return dict(recordType="Example", schema=read["schema"],
                dense_cols=read["pack"]["dense"], cat_cols=read["pack"]["cat"])


def main_path(data_dir: str) -> dict:
    """Full-width Criteo DLRM scoring from TFRecord files written into
    ``data_dir``, in bf16 (the main path) and in f32 activations, each over
    the same 8 epochs; returns each kernel instance's launches on the path
    that runs it."""
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch

    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    model_f32 = with_dtype(model, torch.float32)
    table_gb = model.embeddings.numel() * model.embeddings.element_size() / 1e9
    print(f"DLRM at Criteo width: table {tuple(model.embeddings.shape)} f32 = {table_gb:.2f} GB on the card")
    kw = dict(criteo_files_kw(), log1p_dense=True)
    # warm-up forwards (cuBLAS handles, allocator) outside the counted runs
    warm = make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), "cuda")
    model(warm)
    model_f32(warm)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    write_criteo(data_dir)
    print(f"wrote {CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} Example rows in "
          f"{time.perf_counter() - t0:.1f} s (host)")
    decode_only(data_dir)
    runs = {}
    for label, m, tol in (("main path (bf16)", model, 2e-2), ("f32 path", model_f32, 1e-3)):
        res, launches = score_path(label, data_dir, m.cfg, m, tol, num_epochs=EPOCHS, **kw)
        if res.batches != EPOCHS * CRITEO_SHARDS:
            raise SystemExit(f"{label} scored {res.batches} batches, want {EPOCHS * CRITEO_SHARDS}")
        runs[DTYPE_INSTANCE[m.cfg.dtype]] = (label, m, res, launches)
    check_native_vs_python(data_dir)
    for label, m, res, _ in runs.values():
        profile_forward(label, m, warm, res)
    bf16 = runs["bf16_mma"][2]
    MAIN_BF16.update(logits=bf16.logits.cpu(), whole=bf16.batches * BATCH / bf16.wall_s,
                     steady=steady_rate(bf16))
    return {k: launches[k] for k, (_, _, _, launches) in runs.items()}


# phase 4's bf16 logits and rates, which phase 7 holds its serving run against
MAIN_BF16: dict = {}


def steady_rate(res) -> float:
    """Rows/s over batches 2 to the last of a scoring run."""
    return (res.batches - 1) * BATCH / (res.done_s[-1] - res.done_s[0])


def profile_forward(label, model, batch, res) -> None:
    """Where a full-width batch's time goes on the card: the forward's device
    time (CUDA events), its kernels by device time (torch.profiler), and
    the scoring run's rows/s and the card's idle share, over the whole run
    and over its steady state (batches 2 to the last)."""
    from torch.profiler import ProfilerActivity, profile

    eager_ms = median_ms(lambda: model(batch), warmup=3, reps=7, calls=5)
    fwd_ms = graph_ms(lambda: model(batch), reps=7, calls=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    print(f"{label}: forward at batch {BATCH}: {fwd_ms:.4f} ms device time per call (CUDA graph "
          f"replay); {eager_ms:.4f} ms per call eager, back to back (CUDA events, host launch "
          "included); one forward by torch.profiler:")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    busy = sum(res.h2d_s) + res.batches * fwd_ms / 1e3
    print(f"{label}: scoring run, {res.batches} batches: {res.batches * BATCH / res.wall_s:.1f} rows/s end "
          f"to end over {res.wall_s:.4f} s of wall time (first batch's decode included); device "
          f"idle share ~{1 - busy / res.wall_s:.4f} (1 - (h2d + forward device time) / wall time)")
    steady = res.batches - 1
    window = res.done_s[-1] - res.done_s[0]
    busy = sum(res.h2d_s[1:]) + steady * fwd_ms / 1e3
    host_ms = np.array(res.host_s[1:]) * 1e3
    h2d_ms = np.array(res.h2d_s[1:]) * 1e3
    print(f"{label}: steady state, batches 2-{res.batches}: {steady * BATCH / window:.1f} rows/s; per batch "
          f"host (wait) {host_ms.mean():.3f} ms mean, {np.median(host_ms):.3f} median; "
          f"h2d {h2d_ms.mean():.3f} ms mean, {np.median(h2d_ms):.3f} median; device idle share "
          f"~{1 - busy / window:.4f}")


# tolerances of phase 5 against the plain-interaction runs: the losses at
# the bf16 tolerance of the scoring path; the table after the steps
# absolutely (a row moves by about embed_lr = 0.01 a step)
TRAIN_LOSS_TOL = 2e-2
TRAIN_TABLE_ATOL = 5e-3
TRAIN_SPARSE_EPOCHS = 8  # both shards: 16 steps
TRAIN_DENSE_EPOCHS = 2   # one shard: 2 steps
TRAIN_SEED = 0


def new_criteo_model(dtype=torch.bfloat16):
    from tpu_tfrecord_torch.models.dlrm import init_params

    return init_params(criteo_cfg(dtype), torch.Generator(device="cuda").manual_seed(TRAIN_SEED),
                       "cuda")


def free_cuda() -> None:
    """Collect what the caller dropped and hand the cached blocks back."""
    gc.collect()
    torch.cuda.empty_cache()


def train_run(label, paths, steps, sparse, epochs, dtype=torch.bfloat16, **kw):
    """``train_files`` on a fresh full-width model in ``dtype`` activations,
    with the counts set to 0
    just before and read just after; then the same run from the same seed
    under the plain interaction. Checks the launches, finite losses, the
    losses and the table against the plain run (rows neither run moved must
    be bit-equal). Returns (TrainResult, launches, model)."""
    from tpu_tfrecord_torch.entry import train_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    cfg = criteo_cfg(dtype)
    model = new_criteo_model(dtype)
    reset_launch_counts()
    res = train_files(paths, cfg, model, BATCH, "cuda", sparse=sparse, num_epochs=epochs, **kw)
    launches = dict(dot_interaction.instance_launches)
    want = {k: (steps if k == DTYPE_INSTANCE[dtype] else 0) for k in INSTANCE_DTYPE}
    if res.steps != steps or not torch.isfinite(res.losses).all() or launches != want:
        raise SystemExit(f"{label}: {res.steps} steps (want {steps}), launches {launches} "
                         f"(want {want}), losses {res.losses}")
    # the plain twin: the table is compared row by row, then the twin is freed
    twin = new_criteo_model(dtype)
    with plain_interaction():
        ref = train_files(paths, cfg, twin, BATCH, "cuda", sparse=sparse, num_epochs=epochs, **kw)
    ref.opt = None  # the twin's optimizer state goes with the twin
    for i in range(res.steps):
        print(f"{label} step {i}: loss {res.losses[i].item():.6f} (plain "
              f"{ref.losses[i].item():.6f}); host (wait) {res.host_s[i] * 1e3:.2f} ms, "
              f"h2d {res.h2d_s[i] * 1e3:.3f} ms, step {res.step_s[i] * 1e3:.3f} ms, "
              f"done at {res.done_s[i]:.4f} s")
    check_training(label, res.losses, model, ref.losses, twin, dtype, "plain", launches)
    del twin
    free_cuda()
    return res, launches, model


def check_training(label, losses, model, ref_losses, ref_model, dtype, ref_name, launches) -> None:
    """Phase 5's check of a training run against a reference run from the
    same weights: the losses within TRAIN_LOSS_TOL, every table row within
    TRAIN_TABLE_ATOL, and the rows neither run moved bit-equal."""
    loss_err = (losses - ref_losses).abs().max().item()
    with torch.no_grad():
        init = new_criteo_model(dtype).embeddings
        moved = torch.maximum((model.embeddings - init).abs().amax(-1),
                              (ref_model.embeddings - init).abs().amax(-1)) > 0     # [F, V]
        del init
        row_err = (model.embeddings - ref_model.embeddings).abs().amax(-1)          # [F, V]
        table_err = row_err.max().item()
        still_equal = bool((row_err[~moved] == 0).all())
        n_moved = int(moved.sum())
        del row_err, moved
    free_cuda()
    print(f"{label}: {len(losses)} steps, kernel launches {launches}; max |loss - {ref_name} loss| = "
          f"{loss_err} (tol {TRAIN_LOSS_TOL}); {n_moved} table rows moved, max |row - {ref_name} "
          f"row| = {table_err} (atol {TRAIN_TABLE_ATOL}); rows neither run moved bit-equal: "
          f"{still_equal}")
    if len(losses) != len(ref_losses):
        raise SystemExit(f"{label}: {len(losses)} steps against the {ref_name} run's {len(ref_losses)}")
    if not torch.allclose(losses, ref_losses, rtol=TRAIN_LOSS_TOL, atol=TRAIN_LOSS_TOL):
        raise SystemExit(f"{label}: losses {losses} disagree with the {ref_name} run's {ref_losses}")
    if table_err > TRAIN_TABLE_ATOL or not still_equal:
        raise SystemExit(f"{label}: the table disagrees with the {ref_name} run")


def check_backward() -> dict:
    """``DotInteraction``'s gradient against autograd through the plain
    version at the main-path shape, both dtypes, and the backward's device
    time (graph replay) and bound. Returns per instance
    {backward_max_abs_err, backward_ms, backward_bound_ms}."""
    from tpu_tfrecord_torch.models.interaction import (
        dot_interaction,
        dot_interaction_backward_reference,
        dot_interaction_reference,
    )

    tol = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}
    b, f, d = MAIN_SHAPE
    p = f * (f - 1) // 2
    gen = torch.Generator(device="cuda").manual_seed(4)
    out = {}
    for instance, dtype in INSTANCE_DTYPE.items():
        base = torch.randn(MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
        g = torch.randn((b, p), generator=gen, device="cuda").to(dtype)
        emb = base.clone().requires_grad_()
        dot_interaction(emb).backward(g)
        ref = base.clone().requires_grad_()
        dot_interaction_reference(ref).backward(g)
        torch.cuda.synchronize()
        err = (emb.grad.float() - ref.grad.float()).abs().max().item()
        ok = torch.allclose(emb.grad.float(), ref.grad.float(), **tol[dtype])
        elt = base.element_size()
        nbytes = 2 * b * f * d * elt + b * p * elt        # E and g in, dE out
        nops = 4 * b * p * d                               # each pair feeds two rows
        bound = max(nbytes / HBM_BYTES_PER_S, nops / PEAK_OPS_PER_S[torch.float32]) * 1e3
        out[instance] = dict(
            backward_max_abs_err=err,
            backward_ms=graph_ms(lambda: dot_interaction_backward_reference(base, g)),
            backward_bound_ms=bound,
        )
        print(f"interaction backward at {MAIN_SHAPE} {str(dtype)[6:]}: DotInteraction vs autograd "
              f"through the plain version max_abs_err={err} {'ok' if ok else 'MISMATCH'} "
              f"({tol[dtype]}); device time per call (CUDA graph replay): backward "
              f"{out[instance]['backward_ms']:.4f} ms (torch ops: scatter, transpose add, f32 bmm); "
              f"bound {bound:.4f} ms "
              f"({nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP at the f32 rate)")
        if not ok:
            raise SystemExit(f"interaction backward disagrees with autograd at {dtype}")
    return out


def step_split(events):
    """(device ms of all kernels, {part: device ms}) of one profiled sparse
    step. The step's named ranges ("sparse_step.<part>") hold the kernels
    their ops launched; the backward runs on autograd's device thread, so
    it is read from the engine's per-node events instead: the interaction's
    node (DotInteractionBackward) and all the others (the MLPs, the casts,
    the concat and the gather's row gradient)."""
    from torch.autograd import DeviceType

    kernels = sum(e.time_range.elapsed_us() for e in events
                  if e.device_type == DeviceType.CUDA
                  and not getattr(e, "is_user_annotation", False))
    cpu = [e for e in events if e.device_type == DeviceType.CPU]
    parts = {name: sum(e.device_time_total for e in cpu if e.name == f"sparse_step.{name}") / 1e3
             for name in ("gather", "forward", "dense_opt", "dedup_sort", "segment_sums",
                          "scatters")}
    nodes = [e for e in cpu if e.name.startswith("autograd::engine::evaluate_function:")]
    inter = sum(e.device_time_total for e in nodes if "DotInteractionBackward" in e.name) / 1e3
    parts["interaction_backward"] = inter
    parts["rest_of_backward"] = sum(e.device_time_total for e in nodes) / 1e3 - inter
    return kernels / 1e3, parts


def profile_sparse_step(label, model, opt, res) -> None:
    """Where a sparse step's time goes: its time on a resident full-width
    batch (CUDA events over steps back to back), one step by
    torch.profiler split by part, and the training loop's rows/s, host /
    H2D / step ms and the card's idle share, whole and over steps 2-16."""
    from torch.profiler import ProfilerActivity, profile

    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import make_synthetic_batch, sparse_train_step

    cfg = model.cfg
    batch = make_device_batch(make_synthetic_batch(cfg, BATCH, seed=2), "cuda")
    batch["cat"] = batch["cat"].int()
    step = lambda: sparse_train_step(model, opt, batch, cfg)  # noqa: E731
    step_ms = median_ms(step, warmup=3, reps=7, calls=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    print(f"{label}: sparse step at batch {BATCH}: {step_ms:.4f} ms per step, back to back (CUDA events; "
          "host launch included where it is slower than the card); one step by torch.profiler:")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=25))
    kernels_ms, parts = step_split(prof.events())
    print(f"{label}: sparse step split (device ms of the kernels each part launched, torch.profiler): "
          + ", ".join(f"{k} {v:.4f}" for k, v in parts.items()) + f"; all kernels {kernels_ms:.4f}")
    if kernels_ms <= 0:
        print("torch.profiler recorded no device time: the split is not measured")
    dev_step_ms = kernels_ms if kernels_ms > 0 else step_ms
    busy = sum(res.h2d_s) + res.steps * dev_step_ms / 1e3
    print(f"{label}: sparse training run, {res.steps} steps: {res.steps * BATCH / res.wall_s:.1f} rows/s end to "
          f"end over {res.wall_s:.4f} s of wall time (first batch's decode included); device idle "
          f"share ~{1 - busy / res.wall_s:.4f} (1 - (h2d + steps x {dev_step_ms:.4f} ms device "
          "time) / wall time)")
    steady = res.steps - 1
    window = res.done_s[-1] - res.done_s[0]
    busy = sum(res.h2d_s[1:]) + steady * dev_step_ms / 1e3
    host_ms, h2d_ms, st_ms = (np.array(x[1:]) * 1e3 for x in (res.host_s, res.h2d_s, res.step_s))
    print(f"{label}: steady state, steps 2-{res.steps}: {steady * BATCH / window:.1f} rows/s; per step host "
          f"(wait) {host_ms.mean():.3f} ms mean, {np.median(host_ms):.3f} median; h2d "
          f"{h2d_ms.mean():.3f} ms mean, {np.median(h2d_ms):.3f} median; step (host clock, "
          f"synchronized) {st_ms.mean():.3f} ms mean, {np.median(st_ms):.3f} median; device idle "
          f"share ~{1 - busy / window:.4f}")


# phase 5's bf16 sparse rows/s (train_files, one decode worker), beside which
# phase 8 prints the harness loop's
TRAIN_BF16: dict = {}


def train_path(data_dir: str) -> dict:
    """Phase 5: the sparse training path at full width over phase 4's
    shards in bf16 and in f32, the dense one in bf16, the backward check and
    each sparse step's profile. Returns each kernel instance's launches over
    the training paths and the backward's numbers."""
    kw = criteo_files_kw()
    launches = dict.fromkeys(INSTANCE_DTYPE, 0)
    for dtype in (torch.bfloat16, torch.float32):
        label = f"sparse training (shuffled, {str(dtype)[6:]})"
        res, sparse, model = train_run(
            label, data_dir, TRAIN_SPARSE_EPOCHS * CRITEO_SHARDS, True, TRAIN_SPARSE_EPOCHS,
            dtype, shuffle=True, shuffle_window=2, seed=0, **kw)
        profile_sparse_step(label, model, res.opt, res)
        if dtype == torch.bfloat16:
            TRAIN_BF16.update(whole=res.steps * BATCH / res.wall_s,
                              steady=(res.steps - 1) * BATCH / (res.done_s[-1] - res.done_s[0]))
        launches = {k: launches[k] + sparse[k] for k in launches}
        del model, res
        free_cuda()
    torch.cuda.reset_peak_memory_stats()
    _, dense, model = train_run(
        "dense training (shard00)", os.path.join(data_dir, "shard00"), TRAIN_DENSE_EPOCHS, False,
        TRAIN_DENSE_EPOCHS, **kw)
    print(f"dense path: peak device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB "
          "(the model, its dense gradient and Adam state, and the plain twin's)")
    del model
    free_cuda()
    backward = check_backward()
    return {k: dict(train_launches=launches[k] + dense[k], **backward[k]) for k in INSTANCE_DTYPE}


# -- phase 6: the feed -------------------------------------------------------------

FEED_DECODE_WORKERS = (1, 2, 4, 6)
FEED_WORKERS = 4
WIRE_BITS = 20
TRAIN_FEEDS = {
    "dispatch-ahead": {},
    "transfer thread": dict(transfer_thread=True),
    "20-bit wire": dict(wire_bits=WIRE_BITS),
}
RACE_BATCHES = 64
RACE_SLEEP_CYCLES = 4_000_000  # about 2 ms of one SM's clock on an H100


def batch_digest(cb) -> str:
    """A digest of a decoded batch's columns, names and bytes."""
    h = hashlib.blake2b(digest_size=16)
    for name in sorted(cb.columns):
        h.update(name.encode())
        h.update(np.ascontiguousarray(cb[name].values).tobytes())
    return h.hexdigest()


def decode_workers(data_dir: str) -> dict:
    """Decode-only rows/s at each worker count over the same EPOCHS epochs;
    every batch's digest must be the same at every count. The batches are
    kept during the timed read and digested after it."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    want = CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD * EPOCHS
    rates, digests = {}, {}
    for n in FEED_DECODE_WORKERS:
        ds = TFRecordDataset(shard_dirs(data_dir), BATCH, num_epochs=EPOCHS, num_workers=n,
                             **criteo_read_kw())
        t0 = time.perf_counter()
        with ds.batches() as it:
            kept = list(it)
        secs = time.perf_counter() - t0
        rows = sum(cb.num_rows for cb in kept)
        if rows != want:
            raise SystemExit(f"decode at {n} workers: {rows} rows, want {want}")
        digests[n] = [batch_digest(cb) for cb in kept]
        rates[n] = rows / secs
        print(f"feed: decode only at {n} workers ({EPOCHS} epochs of {CRITEO_SHARDS} x "
              f"{CRITEO_ROWS_PER_SHARD} rows): {rows} rows in {secs:.4f} s = {rates[n]:.1f} rows/s "
              f"(host)")
        del kept
    same = all(digests[n] == digests[1] for n in FEED_DECODE_WORKERS)
    print(f"feed: batch digests at {FEED_DECODE_WORKERS} workers identical: {same} "
          f"({len(digests[1])} batches)")
    if not same:
        raise SystemExit("feed: the batches differ between worker counts")
    return rates


def direct_loop(data_dir, step, *, train: bool, **read):
    """The loop without the feed, kept as the reference of phase 6: the
    dataset at one decode worker, densify (``log1p``, and the label cast
    when training) on the consumer thread, ``make_device_batch`` (fresh
    pinned buffers) synchronized, then ``step`` synchronized. Returns
    (outputs, wall_s, host_s, h2d_s, step_s, done_s)."""
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(shard_dirs(data_dir), BATCH, **criteo_read_kw(), **read)
    outs, host_s, h2d_s, step_s, done_s = [], [], [], [], []
    start = time.perf_counter()
    with ds.batches() as it:
        while True:
            t0 = time.perf_counter()
            cb = next(it, None)
            if cb is None:
                break
            hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
            hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
            if train:
                hb["label"] = hb["label"].astype(np.float32)
            t1 = time.perf_counter()
            batch = make_device_batch(hb, "cuda")
            torch.cuda.synchronize()
            t2 = time.perf_counter()
            outs.append(step(batch))
            torch.cuda.synchronize()
            t3 = time.perf_counter()
            host_s.append(t1 - t0)
            h2d_s.append(t2 - t1)
            step_s.append(t3 - t2)
            done_s.append(t3 - start)
    return outs, time.perf_counter() - start, host_s, h2d_s, step_s, done_s


def loop_stats(label, wall_s, host_s, h2d_s, step_s, done_s, duty=None, launches=None) -> dict:
    """Print and return a loop's rows/s, whole and steady (batches 2 to the
    last), and its per-batch medians over the steady batches."""
    n = len(step_s)
    out = dict(whole=n * BATCH / wall_s, steady=(n - 1) * BATCH / (done_s[-1] - done_s[0]),
               host_ms=float(np.median(host_s[1:])) * 1e3, h2d_ms=float(np.median(h2d_s[1:])) * 1e3,
               step_ms=float(np.median(step_s[1:])) * 1e3, duty_cycle=duty)
    print(f"{label}: {n} batches, {out['whole']:.1f} rows/s whole, {out['steady']:.1f} steady "
          f"(batches 2-{n}); medians over batches 2-{n}: host wait {out['host_ms']:.3f} ms, "
          f"h2d {out['h2d_ms']:.3f} ms, step {out['step_ms']:.3f} ms; duty cycle {duty}"
          + ("" if launches is None else f"; kernel launches {launches}"))
    return out


def feed_serving(data_dir: str) -> tuple:
    """bf16 scoring through ``score_files(num_workers=n)`` for each decode
    worker count, against the direct loop over the same 8 epochs: logits
    bit-equal, 16 launches each. Returns ({n: stats}, the launches of the
    FEED_WORKERS run)."""
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    model = new_criteo_model(torch.bfloat16)
    with torch.no_grad():
        outs, *times = direct_loop(data_dir, model, train=False, num_epochs=EPOCHS)
    want = torch.cat(outs)
    loop_stats("feed: serving bf16, the direct loop", *times)
    stats, named = {}, None
    for n in FEED_DECODE_WORKERS:
        reset_launch_counts()
        res = score_files(data_dir, model.cfg, model, BATCH, "cuda", num_epochs=EPOCHS,
                          num_workers=n, log1p_dense=True, **criteo_files_kw())
        launches = dict(dot_interaction.instance_launches)
        stats[n] = loop_stats(f"feed: serving bf16, score_files(num_workers={n})", res.wall_s,
                              res.host_s, res.h2d_s, res.forward_s, res.done_s, res.duty_cycle,
                              launches)
        err = (res.logits.float() - want.float()).abs().max().item()
        equal = res.logits.shape == want.shape and torch.equal(res.logits, want)
        print(f"feed: serving at {n} workers, logits against the direct loop: bit-equal {equal}, "
              f"max |diff| {err}")
        expect = {"bf16_mma": EPOCHS * CRITEO_SHARDS, "f32_tiled": 0}
        if not equal or launches != expect or not torch.isfinite(res.logits).all():
            raise SystemExit(f"feed: serving disagrees with the direct loop (launches {launches})")
        if n == FEED_WORKERS:
            named = launches
        del res
    del model
    free_cuda()
    return stats, named


def host_feed_rate(data_dir: str, workers: int) -> float:
    """Rows/s of the feed's host side alone: the dataset at ``workers``
    decode workers and the prefetch thread's densify and ``log1p``, over
    the same EPOCHS epochs, with nothing sent to the card."""
    from tpu_tfrecord_torch.device.ingest import HostPrefetcher, host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(shard_dirs(data_dir), BATCH, num_epochs=EPOCHS, num_workers=workers,
                         **criteo_read_kw())

    def densify(cb):
        hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
        return hb

    t0 = time.perf_counter()
    with ds.batches() as it, HostPrefetcher(map(densify, it)) as pf:
        rows = sum(len(hb["label"]) for hb in pf)
    rate = rows / (time.perf_counter() - t0)
    print(f"feed: host side alone at {workers} workers (decode, densify and log1p on the "
          f"prefetch thread, no device): {rows} rows, {rate:.1f} rows/s (host)")
    return rate


def binding_stage(label, rates: dict) -> str:
    """Print the stages' rates (rows/s) and name the slowest."""
    slowest = min(rates, key=rates.get)
    print(f"{label}: binds at {slowest} ("
          + ", ".join(f"{k} {v:.1f} rows/s" for k, v in rates.items()) + ")")
    return slowest


def consumer_rate(stats: dict) -> float:
    """Rows/s the consumer thread alone could take: a batch per median step
    plus median inline transfer."""
    return BATCH / ((stats["step_ms"] + stats["h2d_ms"]) / 1e3)


def wire_first_call() -> dict:
    """Host-clock ms of the wire's unpack and dense transform on a
    full-width batch, first call in the process and second, each
    synchronized; then their device time per batch (graph replay) and
    their eager time back to back (CUDA events)."""
    from tpu_tfrecord_torch.device.bitpack import pack_mixed, unpack_bits

    rng = np.random.default_rng(7)
    host = np.concatenate([rng.integers(0, 2, size=(BATCH, 1)),
                           rng.integers(0, 1 << 31, size=(BATCH, 13)),
                           rng.integers(0, VOCAB, size=(BATCH, 26))], axis=1).astype(np.int32)
    m = torch.from_numpy(pack_mixed(host, 14, WIRE_BITS)).cuda()
    torch.cuda.synchronize()
    out = {}

    def timed(name, fn):
        t0 = time.perf_counter()
        got = fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3
        return got

    for call in ("first", "second"):
        cat = timed(f"unpack_bits {call}", lambda: unpack_bits(m[:, 14:], 26, WIRE_BITS))
        timed(f"log1p f64 {call}", lambda: torch.log1p(m[:, 1:14].clamp(min=0).double()).float())
        timed(f"label cast {call}", lambda: m[:, 0].float())
    if not torch.equal(cat.cpu(), torch.from_numpy(host[:, 14:])):
        raise SystemExit("feed: unpack_bits on the card disagrees with the host matrix")

    def split():
        return (m[:, 0].float(), torch.log1p(m[:, 1:14].clamp(min=0).double()).float(),
                unpack_bits(m[:, 14:], 26, WIRE_BITS))

    out["unpack_bits device"] = graph_ms(lambda: unpack_bits(m[:, 14:], 26, WIRE_BITS))
    out["split device"] = graph_ms(split)
    out["split eager"] = median_ms(split)
    print("feed: wire split on a full-width batch, host-clock ms, synchronized: "
          + ", ".join(f"{k} {v:.3f}" for k, v in out.items() if "device" not in k
                      and "eager" not in k)
          + f"; device time per batch (CUDA graph replay): unpack_bits "
          f"{out['unpack_bits device']:.4f} ms, the whole split (label cast, log1p in f64, "
          f"unpack) {out['split device']:.4f} ms; eager back to back {out['split eager']:.4f} ms")
    return out


def feed_train_reference(data_dir: str, dtype):
    """The direct training loop: sparse, shuffled, 16 steps, on a fresh model."""
    from tpu_tfrecord_torch.entry import TRAIN_LR
    from tpu_tfrecord_torch.models.dlrm import sparse_opt_init, sparse_train_step

    cfg = criteo_cfg(dtype)
    model = new_criteo_model(dtype)
    opt = sparse_opt_init(model, cfg, lambda ps: torch.optim.Adam(ps, lr=TRAIN_LR))
    losses, *times = direct_loop(
        data_dir, lambda b: sparse_train_step(model, opt, b, cfg), train=True,
        num_epochs=TRAIN_SPARSE_EPOCHS, shuffle=True, shuffle_window=2, seed=TRAIN_SEED)
    loop_stats(f"feed: sparse training {str(dtype)[6:]}, the direct loop", *times)
    return torch.stack(losses).cpu(), model


def feed_train(data_dir: str, dtype, name: str, feed_kw: dict, ref) -> tuple:
    """Sparse shuffled training through one feed at FEED_WORKERS decode
    workers, on a fresh model, against the direct loop ``ref``. Returns (stats,
    launches)."""
    from tpu_tfrecord_torch.entry import train_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    label = f"feed: sparse training {str(dtype)[6:]}, {name}"
    model = new_criteo_model(dtype)
    reset_launch_counts()
    res = train_files(data_dir, criteo_cfg(dtype), model, BATCH, "cuda", sparse=True,
                      num_epochs=TRAIN_SPARSE_EPOCHS, shuffle=True, shuffle_window=2,
                      seed=TRAIN_SEED, num_workers=FEED_WORKERS, **criteo_files_kw(), **feed_kw)
    launches = dict(dot_interaction.instance_launches)
    steps = TRAIN_SPARSE_EPOCHS * CRITEO_SHARDS
    want = {k: (steps if k == DTYPE_INSTANCE[dtype] else 0) for k in INSTANCE_DTYPE}
    stats = loop_stats(label, res.wall_s, res.host_s, res.h2d_s, res.step_s, res.done_s,
                       res.duty_cycle, launches)
    print(f"{label}: step 1 {res.step_s[0] * 1e3:.1f} ms (host clock, synchronized)")
    if res.steps != steps or launches != want or not torch.isfinite(res.losses).all():
        raise SystemExit(f"{label}: {res.steps} steps, launches {launches} (want {want})")
    res.opt = None
    check_training(label, res.losses, model, ref[0], ref[1], dtype, "direct loop", launches)
    del model, res
    free_cuda()
    return stats, launches


def staging_race_check(transfer_thread: bool) -> None:
    """RACE_BATCHES batches of distinct contents through
    ``DeviceIterator(depth=2)``: the consumer spins the card for a while on
    each batch and then digests it, and drops the batch before the digest
    has run. A ring slot rewritten before its copy finished, a copy the
    consumer did not wait for, or a block the allocator handed out again
    too early would change a digest."""
    from tpu_tfrecord_torch.device.ingest import DeviceIterator

    rng = np.random.default_rng(6)
    base = rng.integers(0, 1 << 31, size=(1024, 1024), dtype=np.int64).astype(np.int32)
    weights_np = (np.arange(base.size, dtype=np.int64) % 251 + 1).reshape(base.shape)
    weights = torch.from_numpy(weights_np).cuda()

    def host_batches():
        for i in range(RACE_BATCHES):
            a = (base ^ np.int32((i * 0x9E3779B) & 0x7FFFFFFF)) & np.int32(0x7FFFFFFF)
            yield {"a": a, "b": np.full(4096, i, np.int64)}

    want = [int((hb["a"].astype(np.int64) * weights_np).sum()) + int(hb["b"].sum())
            for hb in host_batches()]
    got = []
    with DeviceIterator(host_batches(), "cuda", transfer_thread=transfer_thread, depth=2) as it:
        for batch in it:
            torch.cuda._sleep(RACE_SLEEP_CYCLES)
            got.append((batch["a"].long() * weights).sum() + batch["b"].sum())
            del batch
    got = [int(x) for x in torch.stack(got).cpu()]
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    mode = "transfer thread" if transfer_thread else "dispatch-ahead"
    print(f"feed: staging race check ({mode}, {RACE_BATCHES} batches of 4.2 MB, "
          f"{RACE_SLEEP_CYCLES} spin cycles each): {len(got)} digests, {len(bad)} wrong")
    if len(got) != RACE_BATCHES or bad:
        raise SystemExit(f"feed: staging race check ({mode}) failed at batches {bad[:8]}")


def feed_path(data_dir: str) -> dict:
    """Phase 6: decode at 1-6 workers, serving at 1-6 workers and sparse
    training through the feeds against the direct loop, the f32 run through the
    fastest feed, which stage binds each path, and the staging race check.
    Returns each instance's launches by path."""
    decode = decode_workers(data_dir)
    serve, serve_launches = feed_serving(data_dir)
    host_rate = host_feed_rate(data_dir, FEED_WORKERS)
    binds = {"serving": binding_stage(
        f"feed: serving at {FEED_WORKERS} workers (whole {serve[FEED_WORKERS]['whole']:.1f} rows/s)",
        {"decode pool": decode[FEED_WORKERS], "host side (decode + densify)": host_rate,
         "consumer (forward + inline transfer)": consumer_rate(serve[FEED_WORKERS])})}
    paths = {"feed serving bf16": serve_launches}
    ref = feed_train_reference(data_dir, torch.bfloat16)
    train, wire = {}, None
    for name, kw in TRAIN_FEEDS.items():
        if "wire_bits" in kw:
            wire = wire_first_call()
        train[name], paths[f"feed training bf16, {name}"] = feed_train(
            data_dir, torch.bfloat16, name, kw, ref)
    del ref
    free_cuda()
    best = max(train, key=lambda k: train[k]["steady"])
    print(f"feed: the fastest training feed, by steady rows/s: {best}")
    binds["training"] = binding_stage(
        f"feed: sparse training bf16, {best} (steady {train[best]['steady']:.1f} rows/s)",
        {"decode pool": decode[FEED_WORKERS], "host side (decode + densify)": host_rate,
         "consumer (step + inline transfer)": consumer_rate(train[best])})
    ref = feed_train_reference(data_dir, torch.float32)
    _, paths[f"feed training f32, {best}"] = feed_train(
        data_dir, torch.float32, best, TRAIN_FEEDS[best], ref)
    del ref
    free_cuda()
    for transfer_thread in (False, True):
        staging_race_check(transfer_thread)
    print("feed: " + json.dumps({
        "decode_rows_per_s": decode, "host_side_rows_per_s": host_rate, "serving": serve,
        "training": train, "best": best, "binds": binds, "wire_first_call_ms": wire}))
    return {k: {p: launches[k] for p, launches in paths.items()} for k in INSTANCE_DTYPE}

# -- phase 7: the data-source API ----------------------------------------------------

WRITE_BATCHES = 6      # bench_write.py's shape: 6 batches of BATCH Criteo rows
WRITE_REPS = 3         # interleaved sequential/pipelined pairs, best of each
WRITE_WORKERS = 4
WRITE_SHARDS = 4
CAT_LEN = 8
OTHER_CODECS = ("snappy", "lz4", "bzip2")


def bench_write_batches():
    """Criteo-shaped ColumnarBatches built from numpy buffers, as
    bench_write.py builds them: int64 label, 13 int64 ints, 26 8-byte
    categoricals, WRITE_BATCHES x BATCH rows."""
    from tpu_tfrecord_torch.columnar import Column, ColumnarBatch

    schema = criteo_write_schema()
    rng = np.random.default_rng(0)
    offsets = np.arange(BATCH + 1, dtype=np.int64) * CAT_LEN
    batches = []
    for _ in range(WRITE_BATCHES):
        cols = {"label": Column("label", schema["label"].data_type,
                                values=rng.integers(0, 2, size=BATCH, dtype=np.int64))}
        for i in range(1, 14):
            cols[f"I{i}"] = Column(f"I{i}", schema[f"I{i}"].data_type,
                                   values=rng.integers(0, 1 << 31, size=BATCH, dtype=np.int64))
        for i in range(1, 27):
            blob = (rng.integers(0, 16, size=BATCH * CAT_LEN, dtype=np.uint8) + 97).tobytes()
            cols[f"C{i}"] = Column(f"C{i}", schema[f"C{i}"].data_type, blob=blob,
                                   blob_offsets=offsets)
        batches.append(ColumnarBatch(cols, BATCH))
    return schema, batches


def zlib_scaling_probe() -> float:
    """bench_write.py's probe: wall(1 thread, 2N zlib.compress of 4 MiB) /
    wall(2 threads, N each); 2.0 = two unshared cores for GIL-free work."""
    import threading
    import zlib

    data = os.urandom(4 << 20)

    def spin(count):
        for _ in range(count):
            zlib.compress(data)

    spin(1)
    t0 = time.perf_counter()
    spin(6)
    serial = time.perf_counter() - t0
    threads = [threading.Thread(target=spin, args=(3,)) for _ in range(2)]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    return serial / (time.perf_counter() - t0)


def file_digests(root: str) -> list:
    """(relative dir, file name without the job id, sha256) of every data
    file under ``root``."""
    out = []
    for dirpath, _, names in os.walk(root):
        for name in names:
            if name.startswith("part-"):
                path = os.path.join(dirpath, name)
                with open(path, "rb") as fh:
                    digest = hashlib.sha256(fh.read()).hexdigest()
                # part-<task>-<12-hex job id>.c<n>.tfrecord[.ext]
                out.append((os.path.relpath(dirpath, root), name[:10] + name[23:], digest))
    return sorted(out)


def write_once(schema, batches, out, codec, workers, shards) -> float:
    """One DatasetWriter.write_batches job; its rows/s."""
    from tpu_tfrecord_torch.io.writer import DatasetWriter
    from tpu_tfrecord_torch.options import TFRecordOptions

    opts = TFRecordOptions.from_map(codec=codec, write_workers=workers, num_shards=shards)
    t0 = time.perf_counter()
    DatasetWriter(out, schema, opts, mode="overwrite").write_batches(batches)
    return sum(b.num_rows for b in batches) / (time.perf_counter() - t0)


def write_rates(work: str) -> dict:
    """Phase 7 (a): DatasetWriter.write_batches at bench_write.py's shape,
    sequential (1 worker) and pipelined (WRITE_WORKERS, WRITE_SHARDS shards),
    uncompressed and deflate, repeats interleaved, best of each; the
    pipelined files at 2 and 4 workers must be byte-identical."""
    from tpu_tfrecord_torch.metrics import METRICS

    host_facts()
    probe = zlib_scaling_probe()
    print(f"datasource: two-thread zlib scaling probe (bench_write.py): {probe:.3f}x")
    schema, batches = bench_write_batches()
    rates = {}
    for codec in (None, "deflate"):
        name = codec or "none"
        out = os.path.join(work, f"write_{name}")
        write_once(schema, batches, out, codec, 1, None)  # warm both paths
        write_once(schema, batches, out, codec, WRITE_WORKERS, WRITE_SHARDS)
        seq = par = 0.0
        for _ in range(WRITE_REPS):
            seq = max(seq, write_once(schema, batches, out, codec, 1, None))
            METRICS.reset()
            par = max(par, write_once(schema, batches, out, codec, WRITE_WORKERS, WRITE_SHARDS))
        stages = {k: round(v["seconds"], 4) for k, v in METRICS.snapshot("write").items()
                  if "seconds" in v}
        print(f"datasource: write_batches {WRITE_BATCHES} x {BATCH} Criteo rows, codec {name}: "
              f"sequential {seq:.1f} rows/s, pipelined ({WRITE_WORKERS} workers, {WRITE_SHARDS} "
              f"shards) {par:.1f} rows/s, {par / seq:.3f}x (best of {WRITE_REPS} interleaved "
              f"pairs, host); last pipelined run's stage seconds {stages}")
        digests = {}
        for workers in (2, 4):
            sub = os.path.join(work, f"write_{name}_{workers}")
            write_once(schema, batches, sub, codec, workers, WRITE_SHARDS)
            digests[workers] = file_digests(sub)
            shutil.rmtree(sub)
        same = digests[2] == digests[4] and len(digests[2]) == WRITE_SHARDS
        print(f"datasource: pipelined files, codec {name}, 2 vs 4 workers: {len(digests[2])} "
              f"files, bytes identical {same}")
        if not same:
            raise SystemExit(f"datasource: pipelined output differs between 2 and 4 workers ({name})")
        shutil.rmtree(out)
        rates[name] = {"sequential": seq, "pipelined": par}
    rates["zlib_probe"] = probe
    return rates


def partitioned_write(work: str) -> tuple:
    """Phase 7 (b): phase 4's rows with ``day`` = the shard's index through
    ``io.write(partition_by=["day"], codec="gzip")`` at 1 and WRITE_WORKERS
    write workers. Both layouts must hold the same records. Returns (the
    root written at WRITE_WORKERS, the written schema, {workers: seconds})."""
    from tpu_tfrecord_torch import io as tfio, wire
    from tpu_tfrecord_torch.schema import LongType, StructField, StructType

    schema = StructType(list(criteo_write_schema().fields) + [StructField("day", LongType())])
    secs, records = {}, {}
    for workers in (1, WRITE_WORKERS):
        root = os.path.join(work, f"days_w{workers}")
        rows = (row + [day] for day, shard in enumerate(criteo_shard_rows()) for row in shard)
        t0 = time.perf_counter()
        tfio.write(rows, schema, root, partition_by=["day"], codec="gzip", write_workers=workers)
        secs[workers] = time.perf_counter() - t0
        records[workers] = {
            (os.path.basename(os.path.dirname(sh.path)), i): rec
            for sh in tfio.discover_shards(root)
            for i, rec in enumerate(wire.read_records(sh.path))
        }
        layout = sorted(os.listdir(root))
        print(f"datasource: io.write of {CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} Criteo rows, "
              f"partition_by day, gzip, write_workers={workers}: {secs[workers]:.2f} s "
              f"({CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD / secs[workers]:.1f} rows/s, host); "
              f"layout {layout}")
        if layout != ["_SUCCESS"] + [f"day={d}" for d in range(CRITEO_SHARDS)]:
            raise SystemExit(f"datasource: partitioned layout {layout}")
    print("datasource: the row-by-row writer this one replaced took 4.7-9.6 s for the same "
          "rows, unpartitioned and uncompressed, measured on other H100 hosts")
    if records[1] != records[WRITE_WORKERS]:
        raise SystemExit("datasource: partitioned records differ between 1 and "
                         f"{WRITE_WORKERS} write workers")
    return os.path.join(work, f"days_w{WRITE_WORKERS}"), schema, secs


def read_back(root: str, schema) -> dict:
    """Phase 7 (c): the reader's schema, inference over every file at 4
    workers, and the head of ``read``, against what was written."""
    from tpu_tfrecord_torch import io as tfio
    from tpu_tfrecord_torch.schema import LongType

    def types(s):
        return [(f.name, f.data_type) for f in s]

    want = sorted(types(schema)[:-1]) + [("day", LongType())]
    t0 = time.perf_counter()
    got = tfio.reader(root).schema()
    reader_s = time.perf_counter() - t0
    r = tfio.reader(root)
    t0 = time.perf_counter()
    all_files = r.infer_schema_all_files(num_workers=4)
    infer_s = time.perf_counter() - t0
    all_files = list(all_files.fields) + list(r.partition_schema.fields)
    print(f"datasource: reader().schema() {reader_s * 1e3:.1f} ms (first file), "
          f"infer_schema_all_files(num_workers=4) over {len(r.shards)} files "
          f"{infer_s * 1e3:.1f} ms ({CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD / infer_s:.1f} rows/s, "
          f"host); {len(want)} fields")
    if types(got) != want or [(f.name, f.data_type) for f in all_files] != want:
        raise SystemExit(f"datasource: inferred schema {types(got)} != written {want}")
    t0 = time.perf_counter()
    head = tfio.read(root, limit=1024)
    read_s = time.perf_counter() - t0
    source = [dict(zip(schema.names, row + [day])) for day, shard in enumerate(criteo_shard_rows())
              for row in shard][:1024]
    equal = head.to_dicts() == source
    print(f"datasource: read(limit=1024) {read_s * 1e3:.1f} ms "
          f"({1024 / read_s:.1f} rows/s, host); rows equal to the source {equal}")
    if not equal:
        raise SystemExit("datasource: read() head differs from the written rows")
    return {"infer_all_files_s": infer_s, "read_head_s": read_s}


def serve_partitioned(root: str) -> tuple:
    """Phase 7 (d): bf16 scoring of the partitioned root over EPOCHS epochs
    (``day`` is read and ignored by the model): logits bit-equal to phase
    4's bf16 run, one bf16_mma launch a batch."""
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    model = new_criteo_model(torch.bfloat16)
    reset_launch_counts()
    res = score_files(root, model.cfg, model, BATCH, "cuda", num_epochs=EPOCHS,
                      log1p_dense=True, **criteo_files_kw())
    launches = dict(dot_interaction.instance_launches)
    equal = res.logits.shape == MAIN_BF16["logits"].shape and torch.equal(
        res.logits.cpu(), MAIN_BF16["logits"])
    whole, steady = res.batches * BATCH / res.wall_s, steady_rate(res)
    print(f"datasource: bf16 scoring of the partitioned gzip root, {res.batches} batches: "
          f"{whole:.1f} rows/s whole, {steady:.1f} steady (phase 4, uncompressed shards: "
          f"{MAIN_BF16['whole']:.1f} whole, {MAIN_BF16['steady']:.1f} steady); launches "
          f"{launches}; logits bit-equal to phase 4's {equal}")
    want = {"bf16_mma": EPOCHS * CRITEO_SHARDS, "f32_tiled": 0}
    if not equal or launches != want or not torch.isfinite(res.logits).all():
        raise SystemExit(f"datasource: partitioned serving disagrees with phase 4 "
                         f"(launches {launches})")
    del model, res
    free_cuda()
    return launches, {"whole": whole, "steady": steady}


def codec_round_trips(data_dir: str, work: str) -> dict:
    """Phase 7 (e): shard00's records through snappy, lz4 and bzip2 (and
    zstd where ``zstandard`` is installed); each decoded batch's digest must
    equal the uncompressed shard's."""
    from tpu_tfrecord_torch import wire
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    def digests(path):
        ds = TFRecordDataset(path, BATCH, **criteo_read_kw())
        with ds.batches() as it:
            return [batch_digest(cb) for cb in it]

    src = shard_dirs(data_dir)[0]
    (plain,) = [os.path.join(src, n) for n in os.listdir(src) if n.startswith("part-")]
    records = list(wire.read_records(plain))
    want = digests(src)
    codecs = list(OTHER_CODECS) + (["zstd"] if wire._zstandard() is not None else [])
    out = {}
    for codec in codecs:
        path = os.path.join(work, f"codec_{codec}", "part-00000" + ".tfrecord"
                            + wire.codec_extension(codec))
        os.makedirs(os.path.dirname(path))
        t0 = time.perf_counter()
        wire.write_records(path, records, codec=codec)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        got = digests(os.path.dirname(path))
        read_s = time.perf_counter() - t0
        size = os.path.getsize(path)
        print(f"datasource: {codec}: {len(records)} records, {size} bytes "
              f"({size / os.path.getsize(plain):.3f} of uncompressed), write {write_s:.3f} s, "
              f"decode {read_s:.3f} s (host); batch digests equal to the uncompressed shard's "
              f"{got == want}")
        if got != want:
            raise SystemExit(f"datasource: {codec} round trip changed the batches")
        out[codec] = {"write_s": write_s, "decode_s": read_s, "ratio": size / os.path.getsize(plain)}
    if "zstd" not in codecs:
        print("datasource: zstd: the zstandard module is not installed here, not run")
    return out


def datasource_path(data_dir: str) -> dict:
    """Phase 7: the data-source API at full width. Returns the bf16_mma
    launches of its serving run."""
    with tempfile.TemporaryDirectory(prefix="datasource_", dir=data_dir) as work:
        rates = write_rates(work)
        root, schema, row_write_s = partitioned_write(work)
        reads = read_back(root, schema)
        launches, serving = serve_partitioned(root)
        codecs = codec_round_trips(data_dir, work)
    print("datasource: " + json.dumps({
        "write_batches_rows_per_s": rates, "row_write_s": row_write_s, "reads": reads,
        "serving": serving, "codecs": codecs}))
    return launches


# -- phase 8: resumable training -------------------------------------------------------

RESUME_EPOCHS = 8          # both shards: 16 steps
RESUME_SAVE_EVERY = 8
RESUME_STOP = 12           # the interrupted run's last step
RESUME_SEED = 1            # the resumed model's own weights, before the restore
DRILL_STEPS = 32           # train_dlrm: 2 epochs of 16 batches
DRILL_KILL_AT = "step 16"
DRILL_TIMEOUT_S = 300


def resume_dataset(data_dir: str):
    """Phase 8's read: phase 5's shuffled read of phase 4's shards."""
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    return TFRecordDataset(shard_dirs(data_dir), BATCH, shuffle=True, shuffle_window=2, seed=0,
                           num_epochs=RESUME_EPOCHS, **criteo_read_kw())


def sparse_state(seed: int = TRAIN_SEED):
    """A fresh full-width bf16 model from ``seed`` and its sparse optimizer
    (Adam 1e-3 on the MLPs, row-wise AdaGrad accumulators)."""
    from tpu_tfrecord_torch.models.dlrm import init_params, sparse_opt_init

    cfg = criteo_cfg()
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(seed), "cuda")
    opt = sparse_opt_init(model, cfg, lambda ps: torch.optim.Adam(ps, lr=1e-3))
    return model, opt


def harness_run(model, opt, data_dir, state=None, *, save=None, max_steps=None, metrics=None):
    """Sparse steps through ``harness.run_train_loop`` over phase 8's read
    from ``state``: produce = densify + log1p + label cast +
    ``make_device_batch``. Returns a dict of the batch digests and losses
    of every step, the StepPhases recorder and the loop's rows/s (whole:
    from opening the iterator to the last step's end; steady: from step 2's
    dispatch, which waits for step 1, to the end)."""
    from tpu_tfrecord_torch import harness
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar, make_device_batch
    from tpu_tfrecord_torch.models.dlrm import sparse_train_step

    ds = resume_dataset(data_dir)
    cfg = model.cfg
    kept, losses, dispatched = [], [], []

    def produce(cb):
        kept.append(cb)  # digested after the run, outside the timed loop
        hb = host_batch_from_columnar(cb, ds.schema, hash_buckets=ds.hash_buckets, pack=ds.pack)
        hb["dense"] = np.log1p(hb["dense"].clip(min=0)).astype(np.float32)
        hb["label"] = hb["label"].astype(np.float32)
        return make_device_batch(hb, "cuda")

    def step(st, gb):
        dispatched.append(time.perf_counter())
        loss = sparse_train_step(model, opt, gb, cfg)
        losses.append(loss)
        return st, loss

    phases = harness.StepPhases(metrics=metrics)
    t0 = time.perf_counter()
    with ds.batches(state) as it:
        _, steps, duty = harness.run_train_loop(it, produce, step, (), save=save,
                                                save_every=RESUME_SAVE_EVERY, log_every=1 << 30,
                                                max_steps=max_steps, phases=phases)
    end = time.perf_counter()
    return dict(
        ds=ds, steps=steps, digests=[batch_digest(cb) for cb in kept],
        losses=torch.stack(losses).float().cpu() if losses else torch.empty(0),
        phases=phases, duty=duty.value(), whole=steps * BATCH / (end - t0),
        steady=(steps - 1) * BATCH / (end - dispatched[1]) if steps > 1 else None,
    )


def tree_bytes(tree) -> int:
    from tpu_tfrecord_torch.checkpoint import tree_flatten

    return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0])


def bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits as an integer tensor of the same element size."""
    return t.view({1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}[t.element_size()])


def print_run(label, run, ref=None) -> None:
    shares = {k: round(v, 4) for k, v in run["phases"].shares().items()}
    print(f"resume: {label}: {run['steps']} steps, {run['whole']:.1f} rows/s whole, "
          f"{run['steady']:.1f} steady (steps 2-{run['steps']}); duty cycle {run['duty']:.4f}; "
          f"StepPhases shares {shares}, verdict {run['phases'].verdict()}")
    if ref is not None:
        n = run["steps"]
        if run["digests"] != ref["digests"][:n]:
            raise SystemExit(f"resume: {label}: batch digests differ from the uninterrupted run's")
        err = (run["losses"] - ref["losses"][:n]).abs().max().item()
        print(f"resume: {label}: batch digests of steps 1-{n} equal the uninterrupted run's; "
              f"max |loss - uninterrupted loss| = {err} (tol {TRAIN_LOSS_TOL})")
        if not torch.allclose(run["losses"], ref["losses"][:n], rtol=TRAIN_LOSS_TOL,
                              atol=TRAIN_LOSS_TOL):
            raise SystemExit(f"resume: {label}: losses disagree with the uninterrupted run's")


def save_times(metrics, saves: list):
    """A save callback's wrapper that records each save's snapshot, commit
    wait and (sync) commit seconds from the run's own registry."""
    def timed_save(ck, step, it, tree) -> None:
        before = {k: metrics.stage(k).seconds for k in ("ckpt.snapshot", "ckpt.commit_wait",
                                                        "ckpt.commit")}
        t0 = time.perf_counter()
        ck.save(step, tree, it)
        saves.append(dict(step=step, call_s=time.perf_counter() - t0,
                          **{k: metrics.stage(k).seconds - v for k, v in before.items()}))
    return timed_save


def checkpoint_twin(data_dir, ckpt_dir, sync: bool, ref) -> dict:
    """16 sparse steps with a TrainCheckpointer (keep=1) saving at 8 and 16,
    async or sync: the commit's cost split by where it lands."""
    from tpu_tfrecord_torch.checkpoint import TrainCheckpointer
    from tpu_tfrecord_torch.metrics import Metrics
    from tpu_tfrecord_torch.models.dlrm import train_state

    label = "sync twin" if sync else "async twin"
    model, opt = sparse_state()
    m = Metrics()
    saves: list = []
    timed_save = save_times(m, saves)
    with TrainCheckpointer(ckpt_dir, max_to_keep=1, async_save=not sync, metrics=m) as ck:
        run = harness_run(model, opt, data_dir, metrics=m,
                          save=lambda s, it, _: timed_save(ck, s, it, train_state(model, opt)))
        t0 = time.perf_counter()
        ck.wait()
        drain = time.perf_counter() - t0
        gens = sorted(os.listdir(ckpt_dir))
        ck.clear()
    print_run(label, run, ref)
    commit = m.stage("ckpt.commit")
    out = dict(saves=saves, drain_s=drain, commit_s=commit.seconds / max(1, commit.records),
               commits=commit.records, bytes_written=m.counter("ckpt.bytes_written"),
               commit_wait_s=m.stage("ckpt.commit_wait").seconds,
               shares=run["phases"].shares(), verdict=run["phases"].verdict(),
               whole=run["whole"], steady=run["steady"])
    print(f"resume: {label}: saves {saves}; commit {out['commit_s']:.3f} s each over "
          f"{commit.records} commits, {out['bytes_written']} bytes written; commit wait "
          f"{out['commit_wait_s']:.3f} s; drain after the loop {drain:.3f} s; generations on "
          f"disk at the end (keep=1): {gens}")
    if gens != ["gen-00000016"]:
        raise SystemExit(f"resume: {label}: generations {gens}, want the last only")
    del model, opt, run
    free_cuda()
    return out


def kill_drill(work: str) -> dict:
    """The twin trainer (``python -m tpu_tfrecord_torch.train_dlrm``, sparse,
    on the card) killed with SIGKILL after its "step 16" line, then run
    again: it must resume from a nonzero position, finish with "done:", and
    the saved step plus the second run's steps must be the epoch budget."""
    import signal

    from tpu_tfrecord_torch import checkpoint

    repo = os.path.dirname(os.path.abspath(__file__))
    data, ckpt = os.path.join(work, "drill_data"), os.path.join(work, "drill_ckpt")
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.train_dlrm", "--data-dir", data,
           "--ckpt-dir", ckpt]
    env = dict(os.environ, DLRM_SPARSE="1", PYTHONPATH=repo)
    t0 = time.perf_counter()
    with open(os.path.join(work, "drill_1.err"), "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE, stderr=err,
                                text=True)
        first = []
        timer = threading.Timer(DRILL_TIMEOUT_S, proc.kill)  # a hung run ends the read
        timer.start()
        try:
            for line in proc.stdout:
                first.append(line.rstrip())
                if line.startswith(DRILL_KILL_AT + " "):
                    proc.send_signal(signal.SIGKILL)
                    break
        finally:
            timer.cancel()
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
    killed_s = time.perf_counter() - t0
    print("resume: drill run 1 (killed): " + " | ".join(first))
    if proc.returncode != -signal.SIGKILL:
        raise SystemExit(f"resume: drill run 1 ended with {proc.returncode} before {DRILL_KILL_AT!r}; "
                         f"stderr: {open(os.path.join(work, 'drill_1.err')).read()[-2000:]}")
    with open(checkpoint.state_path(ckpt, 0)) as fh:
        saved = json.load(fh)
    t0 = time.perf_counter()
    second = subprocess.run(cmd, cwd=repo, env=env, capture_output=True, text=True,
                            timeout=DRILL_TIMEOUT_S)
    resumed_s = time.perf_counter() - t0
    lines = second.stdout.strip().splitlines()
    print("resume: drill run 2: " + " | ".join(lines))
    if second.returncode != 0:
        raise SystemExit(f"resume: drill run 2 failed ({second.returncode}): {second.stderr[-2000:]}")
    resumed = [ln for ln in lines if ln.startswith("resuming from")]
    done = [ln for ln in lines if ln.startswith("done:")]
    pos = saved["state"]
    nonzero = any(pos.get(k, 0) for k in ("epoch", "shard_cursor", "record_offset"))
    steps2 = int(done[0].split()[1]) if done else -1
    ok = (bool(resumed) and nonzero and saved.get("step") in (8, 16)
          and steps2 + saved["step"] == DRILL_STEPS
          and not os.path.exists(checkpoint.state_path(ckpt, 0)))
    print(f"resume: drill: saved position {pos} at step {saved.get('step')}; run 2 took "
          f"{steps2} steps; {saved.get('step')} + {steps2} = {DRILL_STEPS} (the epoch budget): "
          f"{ok}; run 1 {killed_s:.1f} s to the kill, run 2 {resumed_s:.1f} s (host clock)")
    if not ok:
        raise SystemExit("resume: the kill drill did not resume and finish the epoch budget")
    return dict(saved_step=saved["step"], second_steps=steps2, killed_s=killed_s,
                resumed_s=resumed_s)


def resume_path(data_dir: str) -> dict:
    """Phase 8: resumable sparse training at full width through the harness
    and the TrainCheckpointer. Returns each kernel instance's launches."""
    from tpu_tfrecord_torch.checkpoint import TrainCheckpointer, tree_flatten_with_path
    from tpu_tfrecord_torch.metrics import Metrics
    from tpu_tfrecord_torch.models.dlrm import load_train_state, train_state
    from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

    model, opt = sparse_state()
    need = tree_bytes(train_state(model, opt))
    free = shutil.disk_usage(data_dir).free
    print(f"resume: a checkpoint of the full-width sparse state is {need} bytes; keep=1 holds "
          f"at most 2 on disk during a commit; free in {data_dir}: {free} bytes")
    if free < 2 * need + (1 << 30):
        raise SystemExit(f"resume: {2 * need + (1 << 30)} bytes of free disk needed, {free} free")
    reset_launch_counts()
    ref = harness_run(model, opt, data_dir)
    ref_model = model
    del opt
    print_run("uninterrupted (no checkpoint)", ref)
    print(f"resume: phase 5's bf16 sparse loop (train_files, one decode worker) in this call: "
          f"{TRAIN_BF16.get('whole', float('nan')):.1f} rows/s whole, "
          f"{TRAIN_BF16.get('steady', float('nan')):.1f} steady")

    # interrupted at step 12, with one async save at step 8
    ckpt_dir = os.path.join(data_dir, "resume_ckpt")
    model, opt = sparse_state()
    m = Metrics()
    saves: list = []
    timed_save = save_times(m, saves)
    snap = {}

    def save(step, it, _):
        tree = train_state(model, opt)
        timed_save(ck, step, it, tree)
        # the snapshot's bits, kept on the card, to hold the restore against
        snap.update({p: t.detach().clone() for p, t in tree_flatten_with_path(tree)[0]})

    ck = TrainCheckpointer(ckpt_dir, max_to_keep=1, metrics=m)
    part = harness_run(model, opt, data_dir, save=save, max_steps=RESUME_STOP, metrics=m)
    t0 = time.perf_counter()
    ck.wait()
    drain = time.perf_counter() - t0
    ck.close()
    print_run(f"interrupted at step {RESUME_STOP}", part, ref)
    print(f"resume: interrupted run: save {saves}; commit {m.stage('ckpt.commit').seconds:.3f} s, "
          f"{m.counter('ckpt.bytes_written')} bytes; drained {drain:.3f} s after the loop")
    del model, opt, ck, part
    free_cuda()

    # resumed from another seed's weights
    model, opt = sparse_state(RESUME_SEED)
    ck = TrainCheckpointer(ckpt_dir, max_to_keep=1)
    t0 = time.perf_counter()
    step, tree, resume = ck.restore(train_state(model, opt))
    t1 = time.perf_counter()
    load_train_state(model, opt, tree)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    ck.close()
    del tree
    live = tree_flatten_with_path(train_state(model, opt))[0]
    same = [p for p, t in live if torch.equal(bits(t), bits(snap[p].to(t.device)))]
    print(f"resume: restore of step {step} at {resume}: disk -> host {t1 - t0:.3f} s, host -> "
          f"device {t2 - t1:.3f} s (load_train_state, synchronized); {len(same)} of {len(live)} "
          f"tensors bit-equal to the step-{RESUME_SAVE_EVERY} snapshot")
    if step != RESUME_SAVE_EVERY or resume is None or len(same) != len(live) or len(live) != len(snap):
        raise SystemExit(f"resume: restored step {step}, position {resume}, "
                         f"{len(same)}/{len(live)} tensors equal to the snapshot")
    del snap, live
    rest = harness_run(model, opt, data_dir, resume)
    if rest["ds"].fingerprint() != resume.fingerprint or rest["steps"] != 16 - RESUME_SAVE_EVERY:
        raise SystemExit(f"resume: the resumed run took {rest['steps']} steps")
    if rest["digests"] != ref["digests"][RESUME_SAVE_EVERY:]:
        raise SystemExit("resume: the resumed batches differ from steps 9-16 of the uninterrupted run")
    print("resume: batch digests of the resumed steps 9-16 equal the uninterrupted run's")
    check_training("resume: resumed steps 9-16", rest["losses"], model,
                   ref["losses"][RESUME_SAVE_EVERY:], ref_model, torch.bfloat16, "uninterrupted",
                   "counted at the end of the phase")
    print_run("resumed, steps 9-16", rest)
    restore = dict(disk_to_host_s=t1 - t0, host_to_device_s=t2 - t1)
    interrupted = dict(saves=saves, commit_s=m.stage("ckpt.commit").seconds,
                       bytes_written=m.counter("ckpt.bytes_written"), drain_s=drain)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    del model, opt, ref_model, rest
    free_cuda()

    twins = {mode: checkpoint_twin(data_dir, os.path.join(data_dir, f"ckpt_{mode}"),
                                   mode == "sync", ref) for mode in ("async", "sync")}
    launches = dict(dot_interaction.instance_launches)
    want = {"bf16_mma": 16 + RESUME_STOP + (16 - RESUME_SAVE_EVERY) + 16 + 16, "f32_tiled": 0}
    print(f"resume: kernel launches over phase 8 (uninterrupted 16 + interrupted {RESUME_STOP} + "
          f"resumed {16 - RESUME_SAVE_EVERY} + async twin 16 + sync twin 16): {launches}")
    if launches != want:
        raise SystemExit(f"resume: launches {launches}, want {want}")
    drill = kill_drill(data_dir)
    print("resume: " + json.dumps({
        "free_bytes": free, "checkpoint_bytes": need, "interrupted": interrupted,
        "restore": restore, "twins": twins, "drill": drill,
        "rows_per_s": {"uninterrupted": [ref["whole"], ref["steady"]],
                       "phase5_train_files": [TRAIN_BF16.get("whole"), TRAIN_BF16.get("steady")]},
    }, default=float))
    return launches


# -- phase 9: the sequence models -------------------------------------------------------

SEQ_DEVICE = "cuda"
SEQ_PARITY_STEPS = 16
LM_LOGITS_ATOL = 1e-4      # f32, TF32 off: the card against the CPU
SEQ_LOSS_RTOL = 1e-4
LONGDOC_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4}
LM_DRILL_STEPS = 64
LM_DRILL_SAVE_EVERY = 8
LM_DRILL_KILL_AT = 20
LM_DRILL_RESUMED_AT = 16
SEQ_TIMEOUT_S = 300
RATE_STEPS = 50
PROFILE_STEPS = 5
PACK_REPS = 40


def seq_sync() -> None:
    if torch.device(SEQ_DEVICE).type == "cuda":
        torch.cuda.synchronize()


def tree_to(tree, device):
    """A copy of a parameter tree on ``device``."""
    from tpu_tfrecord_torch.checkpoint import tree_flatten, tree_unflatten

    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.detach().to(device).clone() for t in leaves])


def packed_batches(data_dir: str, packing: str, n: int) -> tuple:
    """The first ``n`` packed batches of the LM twin's read (its dataset,
    ``TokenPacker(32, 64, packing)``) as dicts, and the packer's density."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.device.ingest import TokenPacker
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset

    ds = TFRecordDataset(data_dir, batch_size=tw.READ_BATCH, schema=tw.make_schema(),
                         num_epochs=4, recordType="SequenceExample", shuffle=True, seed=0)
    pk = TokenPacker(tw.BATCH, tw.SEQ_LEN, packing=packing)
    out = []
    with ds.batches() as it:
        for cb in it:
            pk.feed_column(cb["tokens"])
            while len(out) < n and (b := pk.pop()) is not None:
                out.append(b if isinstance(b, dict) else {"tokens": b})
            if len(out) == n:
                break
    if len(out) < n:
        raise SystemExit(f"seq: {packing} packing gave {len(out)} batches, want {n}")
    return out, pk.density()


def lm_parity(data_dir: str, packing: str) -> dict:
    """Phase 9 (1): the twin's LM (f32, TF32 off) with one set of weights
    on the card and on the CPU: logits of the first packed batch within
    ``LM_LOGITS_ATOL``, then 16 Adam(3e-3) steps with losses within
    ``SEQ_LOSS_RTOL``."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.models import lm, optim

    cfg = tw.make_config()
    batches, density = packed_batches(data_dir, packing, SEQ_PARITY_STEPS)
    host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_to(host, SEQ_DEVICE)

    def args(b, device):
        segs = b.get("segment_ids")
        return (torch.from_numpy(b["tokens"]).to(device),
                None if segs is None else torch.from_numpy(segs).to(device))

    with torch.no_grad():
        tok, seg = args(batches[0], "cpu")
        want = lm.forward(host, tok, cfg, segments=seg)[0]
        tok, seg = args(batches[0], SEQ_DEVICE)
        got = lm.forward(card, tok, cfg, segments=seg)[0].cpu()
    err = float((got - want).abs().max())
    opts = {"cpu": optim.adam(host, tw.LR), SEQ_DEVICE: optim.adam(card, tw.LR)}
    losses = {d: [] for d in opts}
    for b in batches:
        for device, params in (("cpu", host), (SEQ_DEVICE, card)):
            tok, seg = args(b, device)
            losses[device].append(float(lm.train_step(params, opts[device], tok, cfg, segments=seg)))
    lc, lg = np.array(losses["cpu"]), np.array(losses[SEQ_DEVICE])
    rel = float(np.max(np.abs(lg - lc) / np.abs(lc)))
    ok = err <= LM_LOGITS_ATOL and rel <= SEQ_LOSS_RTOL and np.isfinite(lg).all()
    print(f"seq: LM parity, {packing} batches ({SEQ_PARITY_STEPS} of [32, 65]"
          f"{', segment_ids' if packing != 'slice' else ''}; density {density:.4f}): logits max abs "
          f"err {err:.3e} (atol {LM_LOGITS_ATOL}); {SEQ_PARITY_STEPS} Adam steps, losses card "
          f"{lg[0]:.6f} -> {lg[-1]:.6f}, max rel diff to the CPU {rel:.3e} (rtol {SEQ_LOSS_RTOL}): {ok}")
    if not ok:
        raise SystemExit(f"seq: LM card/CPU parity failed on {packing} batches")
    return dict(logits_err=err, loss_rel=rel, density=density)


def longdoc_parity(data_dir: str) -> dict:
    """Phase 9 (2): the bf16 frames of the long_doc twin's feed (native pad
    and round, ``DeviceIterator``) bit-equal to the float32 pad cast on the
    card; the twin's classifier on the card and on the CPU, bf16 logits
    within 2e-2 and float32 within 1e-4."""
    from tpu_tfrecord_torch import train_longdoc as tw
    from tpu_tfrecord_torch.device.ingest import DeviceIterator, host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.models import long_doc

    ds = TFRecordDataset(data_dir, batch_size=tw.BATCH, schema=tw.make_schema(),
                         recordType="SequenceExample", shuffle=True, seed=0)
    with ds.batches() as it:
        cb = next(it)
    hb = tw.host_batch(cb, ds.schema)
    f32 = host_batch_from_columnar(cb, ds.schema, pad_to={"frames": (tw.MAX_LEN, tw.SEQ_DIM)})
    with DeviceIterator([hb], SEQ_DEVICE) as dit:
        fed = next(dit)
    cast = torch.from_numpy(f32["frames"]).to(SEQ_DEVICE).to(torch.bfloat16)
    same = (fed["frames"].dtype == torch.bfloat16
            and torch.equal(fed["frames"].view(torch.int16), cast.view(torch.int16))
            and all(torch.equal(fed[k].cpu(), torch.from_numpy(f32[k])) for k in ("frames_len", "label")))
    print(f"seq: long_doc feed: frames {tuple(fed['frames'].shape)} {fed['frames'].dtype} through "
          f"DeviceIterator bit-equal to the float32 pad cast on the card: {same}")
    if not same:
        raise SystemExit("seq: the bf16 frame feed disagrees with the cast on the card")
    out = {}
    for dtype, frames in ((torch.bfloat16, hb["frames"]), (torch.float32, torch.from_numpy(f32["frames"]))):
        cfg = dataclasses.replace(tw.make_config(), dtype=dtype)
        host = long_doc.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = tree_to(host, SEQ_DEVICE)
        batch = {"frames": frames, "frames_len": torch.from_numpy(f32["frames_len"]),
                 "label": torch.from_numpy(f32["label"])}
        with torch.no_grad():
            want = long_doc.forward(host, batch, cfg)
            got = long_doc.forward(card, {k: v.to(SEQ_DEVICE) for k, v in batch.items()}, cfg).cpu()
        err = float((got - want).abs().max())
        tol = LONGDOC_TOL[dtype]
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"seq: long_doc logits [64, 2] {dtype}, card against the CPU: max abs err {err:.3e} "
              f"(tol {tol}): {ok}")
        if not ok:
            raise SystemExit(f"seq: long_doc card/CPU parity failed in {dtype}")
        out[str(dtype).replace("torch.", "")] = err
    return out


def run_twin(module: str, args: list, work: str, log: str, kill_after_step=None, device=None,
             env=None):
    """``python -m <module> --device <device> *args`` in a subprocess
    (``SEQ_DEVICE`` unless ``device``; ``env`` added to this process's):
    (return code, [(host seconds since start, line)], stderr). With
    ``kill_after_step`` it is killed with SIGKILL after that step's
    ``lm_step`` line."""
    import signal

    repo = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", module, "--device", device or SEQ_DEVICE, *args]
    env = dict(os.environ, PYTHONPATH=repo, **(env or {}))
    lines = []
    t0 = time.perf_counter()
    with open(os.path.join(work, log), "w") as err:
        proc = subprocess.Popen(cmd, cwd=repo, env=env, stdout=subprocess.PIPE, stderr=err,
                                text=True)
        timer = threading.Timer(SEQ_TIMEOUT_S, proc.kill)  # a hung run ends the read
        timer.start()
        try:
            for line in proc.stdout:
                lines.append((time.perf_counter() - t0, line.rstrip()))
                if (kill_after_step is not None and line.startswith("lm_step ")
                        and json.loads(line.split(" ", 1)[1])["step"] == kill_after_step):
                    proc.send_signal(signal.SIGKILL)
                    break
        finally:
            timer.cancel()
            if kill_after_step is None:
                with contextlib.suppress(subprocess.TimeoutExpired):
                    proc.wait(timeout=60)
            if proc.poll() is None:
                proc.kill()
            proc.wait(timeout=60)
            proc.stdout.close()
    with open(os.path.join(work, log)) as fh:
        stderr = fh.read()
    return proc.returncode, lines, stderr


def lm_steps(lines) -> dict:
    out = {}
    for t, ln in lines:
        if ln.startswith("lm_step "):
            rec = json.loads(ln.split(" ", 1)[1])
            out[rec["step"]] = dict(rec, t=t)
    return out


def done_rate(lines) -> float:
    """examples/s of a twin's "done: N steps, X examples/s" line."""
    done = [m for _, ln in lines if (m := re.match(r"done: \d+ steps, ([\d,.]+) examples/s", ln))]
    if not done:
        raise SystemExit("seq: the twin printed no done line")
    return float(done[-1].group(1).replace(",", ""))


def lm_drill(work: str, data_dir: str) -> dict:
    """Phase 9 (3): the train_lm twin, uninterrupted for 64 steps saving
    every 8, then killed with SIGKILL after step 20 and run again: it must
    resume at step 16 and give the uninterrupted run's digests for steps
    17-64 and its losses, bit-equal or within ``SEQ_LOSS_RTOL``."""
    import signal

    from tpu_tfrecord_torch import train_lm as tw

    common = ["--data-dir", data_dir, "--steps", str(LM_DRILL_STEPS),
              "--save-every", str(LM_DRILL_SAVE_EVERY)]
    runs = {}
    for name, ckpt, kill in (("uninterrupted", "lm_ckpt_ref", None), ("killed", "lm_ckpt", LM_DRILL_KILL_AT),
                             ("resumed", "lm_ckpt", None)):
        rc, lines, err = run_twin("tpu_tfrecord_torch.train_lm", common + [
            "--ckpt-dir", os.path.join(work, ckpt),
            "--digest-out", os.path.join(work, f"lm_{name}.jsonl")], work, f"lm_{name}.err", kill)
        want_rc = -signal.SIGKILL if kill else 0
        if rc != want_rc:
            raise SystemExit(f"seq: train_lm {name} run ended with {rc}: {err[-3000:]}")
        runs[name] = lines
        head = [ln for _, ln in lines if not ln.startswith("lm_step")]
        print(f"seq: train_lm {name}: " + " | ".join(head))
    ref, res = lm_steps(runs["uninterrupted"]), lm_steps(runs["resumed"])
    first = [ln for _, ln in runs["resumed"]][:3]
    resumed_at = f"resumed at step {LM_DRILL_RESUMED_AT}" in first
    later = range(LM_DRILL_RESUMED_AT + 1, LM_DRILL_STEPS + 1)
    digests = sorted(res) == list(later) and all(res[s]["digest"] == ref[s]["digest"] for s in later)
    bit_equal = all(res[s]["loss"] == ref[s]["loss"] for s in later)
    rel = max(abs(float(res[s]["loss"]) - float(ref[s]["loss"])) / abs(float(ref[s]["loss"]))
              for s in later) if digests else float("inf")
    determinism = "bit-equal" if bit_equal else f"within a relative {SEQ_LOSS_RTOL} (max {rel:.3e})"
    print(f"seq: train_lm drill: {first[:2]}; resumed at step {LM_DRILL_RESUMED_AT}: {resumed_at}; "
          f"digests of steps {later[0]}-{later[-1]} equal the uninterrupted run's: {digests}; "
          f"losses {determinism}")
    if not (resumed_at and digests and (bit_equal or rel <= SEQ_LOSS_RTOL)):
        raise SystemExit("seq: the train_lm kill drill did not continue the uninterrupted run")
    losses = [float(ref[s]["loss"]) for s in sorted(ref)]
    if not np.isfinite(losses).all():
        raise SystemExit("seq: train_lm losses are not finite")
    whole = done_rate(runs["uninterrupted"]) * tw.SEQ_LEN
    t2, tn = ref[2]["t"], ref[LM_DRILL_STEPS]["t"]
    steady = (LM_DRILL_STEPS - 2) * tw.BATCH * tw.SEQ_LEN / (tn - t2)
    print(f"seq: train_lm uninterrupted: losses {losses[0]:.4f} -> {losses[-1]:.4f}; {whole:.1f} "
          f"tokens/s whole (its done line), {steady:.1f} steady (steps 3-{LM_DRILL_STEPS}, lm_step "
          "lines' arrival, host clock)")
    return dict(determinism=determinism, loss_rel=rel, tokens_per_s_whole=whole,
                tokens_per_s_steady=steady, first_loss=losses[0], last_loss=losses[-1])


def longdoc_twin(work: str, data_dir: str) -> dict:
    """Phase 9 (4): the train_longdoc twin whole (2 epochs, 32 steps, bf16
    frames): finite losses, the harness's phase shares and verdict."""
    from tpu_tfrecord_torch import train_longdoc as tw

    rc, lines, err = run_twin("tpu_tfrecord_torch.train_longdoc",
                              ["--data-dir", data_dir, "--ckpt-dir", os.path.join(work, "ld_ckpt")],
                              work, "longdoc.err")
    text = [ln for _, ln in lines]
    print("seq: train_longdoc: " + " | ".join(text))
    losses = [float(ln.split("~")[1]) for ln in text if ln.startswith("step ")]
    phases = [ln for ln in text if ln.startswith("train phases:")]
    if rc != 0 or not losses or not np.isfinite(losses).all() or not phases \
            or not any(ln.startswith("done: 32 steps") for ln in text):
        raise SystemExit(f"seq: train_longdoc failed ({rc}): {err[-3000:]}")
    return dict(losses=losses, phases=phases[0], steps_per_s_whole=done_rate(lines) / tw.BATCH)


def step_rate(label, step, tokens_per_step: int) -> dict:
    """Steps/s of ``step`` run back to back (host clock, synchronized), the
    device ms per step of its kernels (torch.profiler over a few steps) and
    the card's idle share (1 - device ms / wall ms per step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(5):
        step()
    seq_sync()
    t0 = time.perf_counter()
    for _ in range(RATE_STEPS):
        step()
    seq_sync()
    wall_ms = (time.perf_counter() - t0) * 1e3 / RATE_STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILE_STEPS):
            step()
        seq_sync()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / PROFILE_STEPS
    per_step = len(kernels) / PROFILE_STEPS
    idle = 1 - dev_ms / wall_ms if dev_ms > 0 else float("nan")
    print(f"seq: {label}: {1e3 / wall_ms:.1f} steps/s eager ({wall_ms:.3f} ms a step, host clock, "
          f"{RATE_STEPS} steps back to back; {tokens_per_step * 1e3 / wall_ms:.1f} tokens/s); device "
          f"{dev_ms:.4f} ms a step in {per_step:.0f} kernels (torch.profiler, {PROFILE_STEPS} steps"
          f"{'' if dev_ms > 0 else ': no device time recorded, not measured'}); idle share {idle:.4f}")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    return dict(steps_per_s=1e3 / wall_ms, step_ms=wall_ms, device_ms=dev_ms,
                kernels_per_step=per_step, idle_share=idle)


def seq_rates(card: str) -> dict:
    """Phase 9 (5): LM train steps/s at the bench's shape on
    ``make_synthetic_tokens``, long_doc steps/s on a resident full-width
    batch, and ``TokenPacker`` docs/s and density at the bench's
    ``pack_shape``."""
    from tpu_tfrecord_torch import train_lm as lm_tw, train_longdoc as ld_tw
    from tpu_tfrecord_torch.device.ingest import TokenPacker
    from tpu_tfrecord_torch.models import lm, long_doc, optim

    print(f"seq: rates on {card}")
    cfg = lm_tw.make_config()
    params = lm.init_params(cfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0), SEQ_DEVICE)
    opt = optim.adam(params, lm_tw.LR)
    toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, 32, seed=0)).to(SEQ_DEVICE)
    out = {"lm": step_rate("LM train step, B=32 L=64 d=64 (make_synthetic_tokens)",
                           lambda: lm.train_step(params, opt, toks, cfg), 32 * 64)}
    lcfg = ld_tw.make_config()
    lparams = long_doc.init_params(lcfg, torch.Generator(device=SEQ_DEVICE).manual_seed(0), SEQ_DEVICE)
    lopt = optim.adam(lparams, ld_tw.LR)
    hb = long_doc.make_synthetic_batch(lcfg, ld_tw.BATCH, seed=0)
    batch = {"frames": torch.from_numpy(hb["frames"]).to(SEQ_DEVICE).to(torch.bfloat16),
             "frames_len": torch.from_numpy(hb["frames_len"]).to(SEQ_DEVICE),
             "label": torch.from_numpy(hb["label"]).to(SEQ_DEVICE)}
    out["long_doc"] = step_rate("long_doc train step, B=64 L=64 d=32 bf16 (make_synthetic_batch)",
                                lambda: long_doc.train_step(lparams, lopt, batch, lcfg),
                                ld_tw.BATCH * ld_tw.MAX_LEN)
    sizes = np.random.default_rng(15).choice([2, 6, 10, 15, 16, 21, 25, 31], size=300)
    docs = [np.ones(int(n), np.int32) for n in sizes]
    t0 = time.perf_counter()
    for _ in range(PACK_REPS):
        pk = TokenPacker(4, 32, packing="best_fit")
        pk.feed_docs(docs)
        while pk.pop() is not None:
            pass
    secs = time.perf_counter() - t0
    out["packer"] = dict(docs_per_s=PACK_REPS * len(docs) / secs, density=pk.density())
    print(f"seq: TokenPacker at the bench's pack_shape (B=4 L=32 best_fit ragged[2..31]x300): "
          f"{out['packer']['docs_per_s']:.1f} docs/s (host clock, {PACK_REPS} repetitions), "
          f"density {out['packer']['density']:.4f}")
    return out


def seq_path(work: str, card: str) -> dict:
    """Phase 9: the sequence-model families at the twins' widths, on
    ``card`` (nvidia-smi's name and power limit). Returns the phase's
    numbers."""
    from tpu_tfrecord_torch import train_lm, train_longdoc

    lm_data, ld_data = os.path.join(work, "lm_data"), os.path.join(work, "ld_data")
    t0 = time.perf_counter()
    train_lm.generate(lm_data)
    train_longdoc.generate(ld_data)
    print(f"seq: wrote the twins' SequenceExamples (4 x 256 token documents, 4 x 256 frame "
          f"documents) in {time.perf_counter() - t0:.1f} s")
    out = {"lm_parity": {p: lm_parity(lm_data, p) for p in ("slice", "best_fit")},
           "long_doc_parity": longdoc_parity(ld_data)}
    out["train_lm"] = lm_drill(work, lm_data)
    out["train_longdoc"] = longdoc_twin(work, ld_data)
    out["rates"] = seq_rates(card)
    out["card"] = card
    print("seq: " + json.dumps(out, default=float))
    return out


# -- phase 10: LM serving ----------------------------------------------------------------

SERVE_DEVICE = "cuda"
SERVE_TRAIN_STEPS = 16
SERVE_MB = 8
SERVE_REQUESTS = 32
SERVE_LAYOUTS = ((1, 2), (2, 2))      # (stages of the one-device schedule, virtual chunks)
SERVE_LAYOUT_ATOL = 1e-5              # f32 logits, (1, 2) against (2, 2) on the card
SERVE_CPU_ATOL = 1e-4                 # f32 logits, TF32 off: the card against the CPU
REPLICA_CLIENTS = 8
REPLICA_REQUESTS = 4                  # a client
REPLICA_NEW = 16                      # new tokens a request
REPLICA_MAX_QUEUE = 16
REPLICA_BURST = 8                     # arrivals past max_queue in the shed check
TICK_RATE_SUBMITS = 50
TICK_PROFILE_SUBMITS = 5
SERVE_TIMEOUT_S = 120


def serve_sync() -> None:
    if torch.device(SERVE_DEVICE).type == "cuda":
        torch.cuda.synchronize()


PARK_WRITER = r"""
import sys
sys.path.insert(0, {repo!r})
from tpu_tfrecord_torch import serve_lm, train_lm
ck = train_lm.LMCheckpoint({ckpt!r})
ck.save({step}, serve_lm.checkpoint_template(serve_lm.make_config()), {{"input": None, "packer": None}})
ck.wait()
"""


def serve_checkpoint(work: str) -> tuple:
    """Phase 10 (a): the serve_lm-width LM (vocab 256, d_model 64, 4 heads,
    4 layers, L = 64) trained 16 Adam steps on ``make_synthetic_tokens``
    under deterministic algorithms, saved through ``train_lm.LMCheckpoint``
    at step 16; a second generation (step 24) parked after its shard,
    before its manifest, by a writer process killed there. Returns (step,
    the parameters ``serve_lm.load_checkpoint`` gave, on the CPU)."""
    import signal

    from tpu_tfrecord_torch import serve_lm, train_lm
    from tpu_tfrecord_torch.checkpoint import tree_flatten
    from tpu_tfrecord_torch.models import lm, optim

    cfg = serve_lm.make_config(2)
    params = tree_to(lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu"), SERVE_DEVICE)
    opt = optim.adam(params, train_lm.LR)
    losses = []
    for i in range(SERVE_TRAIN_STEPS):
        toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, train_lm.BATCH, seed=i)).to(SERVE_DEVICE)
        losses.append(float(lm.train_step(params, opt, toks, cfg)))
    if not np.isfinite(losses).all():
        raise SystemExit(f"serve: training losses not finite: {losses}")
    ckpt = os.path.join(work, "serve_ckpt")
    ck = train_lm.LMCheckpoint(ckpt, sync=True)
    try:
        ck.save(SERVE_TRAIN_STEPS, optim.train_state(params, opt), {"input": None, "packer": None})
    finally:
        ck.close()
    mark = os.path.join(work, "serve_parked")
    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, TFR_CKPT_CHAOS_STAGE="pre_manifest", TFR_CKPT_CHAOS_MARK=mark)
    proc = subprocess.Popen([sys.executable, "-c", PARK_WRITER.format(
        repo=repo, ckpt=ckpt, step=SERVE_TRAIN_STEPS + 8)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + SERVE_TIMEOUT_S
        while not os.path.exists(mark):
            if proc.poll() is not None or time.monotonic() > deadline:
                raise SystemExit(f"serve: the parked writer never parked: {proc.communicate(timeout=30)}")
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)
    parked = os.path.join(ckpt, f"gen-{SERVE_TRAIN_STEPS + 8:08d}")
    torn = os.path.isdir(parked) and not os.path.exists(os.path.join(parked, "MANIFEST.json"))
    step, state = serve_lm.load_checkpoint(ckpt, serve_lm.checkpoint_template(cfg))
    same = step == SERVE_TRAIN_STEPS and all(
        torch.equal(a, b.detach().cpu()) for a, b in zip(tree_flatten(state[0])[0],
                                                         tree_flatten(params)[0]))
    print(f"serve: checkpoint: {SERVE_TRAIN_STEPS} Adam steps on the card under deterministic "
          f"algorithms, losses {losses[0]:.4f} -> {losses[-1]:.4f}; generation {SERVE_TRAIN_STEPS + 8} "
          f"parked before its manifest and killed: {torn}; load_checkpoint returned step {step}, "
          f"parameters bit-equal to the trained ones: {same}")
    if not (torn and same):
        raise SystemExit("serve: the manifest-last restore did not return the complete generation")
    return step, state[0]


def serve_one_shot(params, step, card: str) -> dict:
    """Phase 10 (b): serve_lm's timed pass at each layout on the card (32
    requests of mb 8 after the warm-up, streamed logits bitwise equal to
    ``batch_reference`` or it fails), the layouts' logits against each
    other and the card's against a CPU run of the same checkpoint."""
    from tpu_tfrecord_torch import serve_lm

    out, logits = {}, {}
    for stages, virtual in SERVE_LAYOUTS:
        cfg = serve_lm.make_config(virtual)
        line, outs = serve_lm.one_shot(params, cfg, stages, SERVE_MB, SERVE_REQUESTS, SERVE_DEVICE,
                                       step)
        print(f"serve: serve_lm OK: {json.dumps(line)}  ({card})")
        out[f"S{stages}V{virtual}"] = line
        logits[(stages, virtual)] = outs
    a, b = (logits[k] for k in SERVE_LAYOUTS)
    layout_err = max(float(np.abs(x - y).max()) for x, y in zip(a, b))
    _, cpu = serve_lm.one_shot(params, serve_lm.make_config(SERVE_LAYOUTS[0][1]),
                               SERVE_LAYOUTS[0][0], SERVE_MB, SERVE_REQUESTS, "cpu", step)
    cpu_err = max(float(np.abs(x - y).max()) for x, y in zip(a, cpu))
    ok = layout_err <= SERVE_LAYOUT_ATOL and cpu_err <= SERVE_CPU_ATOL
    print(f"serve: logits of {SERVE_LAYOUTS[0]} against {SERVE_LAYOUTS[1]} on the card: max abs "
          f"diff {layout_err:.3e} (atol {SERVE_LAYOUT_ATOL}); card against the CPU at "
          f"{SERVE_LAYOUTS[0]}: {cpu_err:.3e} (atol {SERVE_CPU_ATOL}): {ok}")
    if not ok:
        raise SystemExit("serve: the one-shot logits disagree across layouts or with the CPU")
    out.update(layout_err=layout_err, cpu_err=cpu_err)
    return out


def replica_windows(n: int, seed: int):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, size=64).astype(np.int32) for _ in range(n)]


def shed_check(params, cfg) -> dict:
    """Phase 10 (c), over-admission: a replica whose engine has not started
    (the accept loop only) takes ``REPLICA_MAX_QUEUE`` arrivals plus a
    ``burst`` rule's ``REPLICA_BURST`` more; exactly the excess is shed
    with "overloaded" and a Retry-After hint, and the admitted ones are
    served with the sequential reference's tokens once the engine runs."""
    from tpu_tfrecord_torch import faults, serving
    from tpu_tfrecord_torch import service_protocol as sp
    from tpu_tfrecord_torch.metrics import Metrics

    plan = faults.FaultPlan([faults.FaultRule(op="serve", kind="burst", path="load",
                                              burst_n=REPLICA_MAX_QUEUE + REPLICA_BURST - 1)])
    metrics = Metrics()
    eng = serving.ServingEngine(params, cfg, 1, policy=serving.ServePolicy(
        mb=SERVE_MB, max_queue=REPLICA_MAX_QUEUE), metrics=metrics, device=SERVE_DEVICE)
    srv = serving.ServeServer(eng, port=0, fault_plan=plan)
    srv._accept_thread = threading.Thread(target=srv._accept_loop, name="shed-accept", daemon=True)
    srv._accept_thread.start()
    socks, shed = [], []
    ws = replica_windows(REPLICA_MAX_QUEUE, seed=77)
    try:
        arrivals = 1 + plan.apply_serve("load")
        for i in range(arrivals):
            s = sp.connect(srv.addr, timeout=30.0)
            socks.append(s)
            sp.send_msg(s, {"v": sp.PROTO_VERSION, "op": "generate", "req": i,
                            "tokens": ws[i % len(ws)].tolist(), "n_new": 1, "deadline_s": None})
            if i < REPLICA_MAX_QUEUE:
                deadline = time.monotonic() + 30
                while eng.report()["queue_depth"] < i + 1:
                    if time.monotonic() > deadline:
                        raise SystemExit("serve: an admitted arrival never queued")
                    time.sleep(0.005)
            else:
                shed.append(sp.recv_msg(s, srv.addr))
        eng.start()
        served = [sp.recv_msg(s, srv.addr) for s in socks[:REPLICA_MAX_QUEUE]]
    finally:
        for s in socks:
            s.close()
        srv.stop()
        srv._accept_thread.join(timeout=30)
    ref = serving.sequential_reference(params, cfg, 1, [(w, 1) for w in ws], SERVE_MB,
                                       device=SERVE_DEVICE)
    hints = [r.get("retry_after_s", 0) for r in shed]
    ok = (arrivals == REPLICA_MAX_QUEUE + REPLICA_BURST and len(shed) == REPLICA_BURST
          and all(r.get("error") == "overloaded" for r in shed) and min(hints) > 0
          and metrics.counter("serve.rejected") == REPLICA_BURST
          and [r.get("tokens") for r in served] == ref
          and not srv._accept_thread.is_alive())
    print(f"serve: over-admission: {arrivals} arrivals (burst rule) at max_queue "
          f"{REPLICA_MAX_QUEUE}: {len(shed)} shed 'overloaded' (serve.rejected "
          f"{metrics.counter('serve.rejected')}), Retry-After {min(hints):.4f}-{max(hints):.4f} s, "
          f"the {len(served)} admitted served with the reference's tokens: {ok}")
    if not ok:
        raise SystemExit("serve: the over-admission burst was not shed by exactly the excess")
    return dict(arrivals=arrivals, shed=len(shed), retry_after_s=[min(hints), max(hints)])


def replica_path(params, card: str) -> dict:
    """Phase 10 (c): a replica (``ServingEngine`` + ``ServeServer`` on
    127.0.0.1, S = 1, V = 2, mb 8, max_queue 16) driven by 8 concurrent
    ``ServeClient`` threads, 4 requests of 16 new tokens each from seeded
    64-token windows; every request's tokens equal ``sequential_reference``
    on the card. Meanwhile: a raw client hangs up mid-generation (its slot
    frees, counted once), the over-admission check (``shed_check``), and
    two deadlines (one expired at admission, one of 0.25 s on a request of
    100,000 tokens), dropped and counted, never served late."""
    from tpu_tfrecord_torch import serving
    from tpu_tfrecord_torch import service_protocol as sp
    from tpu_tfrecord_torch.metrics import Metrics
    from tpu_tfrecord_torch.serve_lm import make_config

    cfg = make_config(2)
    metrics = Metrics()
    eng = serving.ServingEngine(params, cfg, 1, policy=serving.ServePolicy(
        mb=SERVE_MB, max_queue=REPLICA_MAX_QUEUE), metrics=metrics, device=SERVE_DEVICE)
    srv = serving.ServeServer(eng, port=0).start()
    reqs = [replica_windows(REPLICA_REQUESTS, seed=100 + c) for c in range(REPLICA_CLIENTS)]
    results, errors, lat, done = {}, [], [], []
    lock = threading.Lock()

    def client(c):
        cl = serving.ServeClient([srv.addr], timeout_s=60.0)
        try:
            for r, w in enumerate(reqs[c]):
                t0 = time.perf_counter()
                toks = cl.generate(w, REPLICA_NEW)
                with lock:
                    lat.append(time.perf_counter() - t0)
                    results[(c, r)] = toks
        except Exception as e:  # noqa: BLE001 - the phase fails on any client error below
            errors.append(f"client {c}: {type(e).__name__}: {e}")
        finally:
            cl.close()
            with lock:
                done.append(time.perf_counter())

    doomed = sp.connect(srv.addr, timeout=30.0)
    sp.send_msg(doomed, {"v": sp.PROTO_VERSION, "op": "generate", "req": 1,
                         "tokens": replica_windows(1, seed=99)[0].tolist(), "n_new": 100000,
                         "deadline_s": None})
    deadline = time.monotonic() + 30
    while metrics.gauge_value("serve.in_flight", 0.0) < 1:
        if time.monotonic() > deadline:
            raise SystemExit("serve: the long request never started")
        time.sleep(0.005)
    threads = [threading.Thread(target=client, args=(c,), name=f"serve-client-{c}")
               for c in range(REPLICA_CLIENTS)]
    t0 = time.perf_counter()
    expired = {}
    try:
        for t in threads:
            t.start()
        doomed.close()  # hang up mid-generation while the clients run
        for key, kw in (("admission", dict(deadline_s=0.0)), ("mid_generation", dict(deadline_s=0.25))):
            cl = serving.ServeClient([srv.addr], timeout_s=60.0)
            try:
                got = cl.generate(replica_windows(1, seed=98)[0], 100000, **kw)
                expired[key] = f"served {len(got)} tokens"
            except serving.DeadlineExpired:
                expired[key] = "DeadlineExpired"
            finally:
                cl.close()
        shed = shed_check(params, cfg)
    finally:
        for t in threads:
            t.join(timeout=SERVE_TIMEOUT_S)
    wall = max(done, default=time.perf_counter()) - t0  # the last client's last reply
    hung = [t.name for t in threads if t.is_alive()]
    deadline = time.monotonic() + 30
    while eng.report()["in_flight"] or eng.report()["queue_depth"]:
        if time.monotonic() > deadline:
            break
        time.sleep(0.01)
    rep = eng.report()
    ticks = metrics.counter("serve.ticks")
    drained = srv.drain(timeout=60)
    ref = serving.sequential_reference(
        params, cfg, 1, [(w, REPLICA_NEW) for c in range(REPLICA_CLIENTS) for w in reqs[c]],
        SERVE_MB, device=SERVE_DEVICE)
    got = [results.get((c, r)) for c in range(REPLICA_CLIENTS) for r in range(REPLICA_REQUESTS)]
    parted = [(i, next(j for j, (a, b) in enumerate(zip(g, w)) if a != b) if g else None)
              for i, (g, w) in enumerate(zip(got, ref)) if g != w]
    n = len(got)
    counters = rep["counters"]
    ok = (not errors and not hung and not parted and drained
          and counters["serve.requests"] == n
          and counters["serve.disconnects"] == 1
          and counters["serve.deadline_expired"] == 2
          and expired == {"admission": "DeadlineExpired", "mid_generation": "DeadlineExpired"}
          and rep["in_flight"] == 0 and rep["queue_depth"] == 0)
    tokens_per_s = n * REPLICA_NEW / wall
    out = dict(requests=n, tokens_per_s=tokens_per_s, requests_per_s=n / wall, wall_s=wall,
               latency_ms_p50=float(np.percentile(lat, 50)) * 1e3 if lat else None,
               latency_ms_p99=float(np.percentile(lat, 99)) * 1e3 if lat else None,
               engine_p50_ms=rep["p50_ms"], engine_p99_ms=rep["p99_ms"], ticks=ticks,
               counters=counters, verdict=rep["verdict"], expired=expired, shed=shed)
    print(f"serve: replica S=1 V=2 mb={SERVE_MB} max_queue={REPLICA_MAX_QUEUE}: "
          f"{REPLICA_CLIENTS} clients x {REPLICA_REQUESTS} requests x {REPLICA_NEW} tokens in "
          f"{wall:.3f} s: {tokens_per_s:.1f} tokens/s, {n / wall:.2f} requests/s (host clock, the "
          f"checks' requests sharing the card); client latency p50 {out['latency_ms_p50']:.2f} ms "
          f"p99 {out['latency_ms_p99']:.2f} ms; engine serve.latency p50 {rep['p50_ms']:.2f} ms p99 "
          f"{rep['p99_ms']:.2f} ms; {ticks} ticks; counters {counters}; verdict {rep['verdict']} "
          f"(slo {rep['slo_p99_ms']} ms) ({card})")
    print(f"serve: tokens equal sequential_reference on the card for {n - len(parted)}/{n} "
          f"requests{'' if not parted else f'; parted (request, position): {parted}'}; hung-up "
          f"client counted once: {counters['serve.disconnects'] == 1}; deadlines {expired}, "
          f"serve.deadline_expired {counters['serve.deadline_expired']}; drained: {drained}"
          f"{'; errors: ' + '; '.join(errors) if errors else ''}{'; hung: ' + str(hung) if hung else ''}")
    if not ok:
        raise SystemExit("serve: the replica check failed")
    return out


def tick_profile(params, card: str) -> dict:
    """Phase 10 (d): where one serving tick's time goes at (1, 2): an
    engine tick is one ``LMStream.submit`` of a full [8, 65] microbatch
    (two schedule ticks at S = 1, V = 2: the previous microbatch's second
    chunk, then this one's first; embed, head and the copy to the host).
    Its host ms (submits back to back; each ends in the host copy), device
    ms and kernels (torch.profiler over a few submits) and the idle share
    (1 - device / host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from tpu_tfrecord_torch.models import lm
    from tpu_tfrecord_torch.serve_lm import make_config

    cfg = make_config(2)
    stream = lm.LMStream(params, cfg, 1, device=SERVE_DEVICE)
    toks = lm.make_synthetic_tokens(cfg, SERVE_MB, seed=5)
    for _ in range(10):
        stream.submit(toks)
    serve_sync()
    t0 = time.perf_counter()
    for _ in range(TICK_RATE_SUBMITS):
        stream.submit(toks)
    host_ms = (time.perf_counter() - t0) * 1e3 / TICK_RATE_SUBMITS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(TICK_PROFILE_SUBMITS):
            stream.submit(toks)
        serve_sync()
    kernels = [e for e in prof.events()
               if e.device_type == DeviceType.CUDA and not getattr(e, "is_user_annotation", False)]
    dev_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / TICK_PROFILE_SUBMITS
    per_tick = len(kernels) / TICK_PROFILE_SUBMITS
    idle = 1 - dev_ms / host_ms if dev_ms > 0 else float("nan")
    print(f"serve: one engine tick at S=1 V=2 (one submit of [{SERVE_MB}, 65]: 2 schedule ticks, "
          f"embed, head, one host copy): {host_ms:.4f} ms host ({TICK_RATE_SUBMITS} back to back), "
          f"device {dev_ms:.4f} ms in {per_tick:.0f} kernels (torch.profiler, "
          f"{TICK_PROFILE_SUBMITS} submits{'' if dev_ms > 0 else ': no device time recorded, not measured'}); "
          f"idle share {idle:.4f} ({card})")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=8))
    return dict(host_ms=host_ms, device_ms=dev_ms, kernels=per_tick, idle_share=idle)


def replica_subprocess(card: str) -> dict:
    """Phase 10 (e): ``python -m tpu_tfrecord_torch.serving --device
    <SERVE_DEVICE>`` (its synthetic seeded LM): the ready line, 4 requests
    answered with the tokens of the same seed's weights computed here,
    SIGTERM, exit 0 within 60 s."""
    import argparse
    import signal

    from tpu_tfrecord_torch import serving

    repo = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=repo)
    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "tpu_tfrecord_torch.serving", "--device",
                             SERVE_DEVICE], cwd=repo, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready = {}
        reader = threading.Thread(target=lambda: ready.update(json.loads(proc.stdout.readline() or "{}")))
        reader.start()
        reader.join(timeout=SERVE_TIMEOUT_S)
        if "addr" not in ready:
            raise SystemExit(f"serve: the replica printed no ready line: {proc.poll()}")
        ready_s = time.perf_counter() - t0
        syn = argparse.Namespace(vocab=96, d_model=32, heads=2, layers=4, max_len=16, mb=4,
                                 virtual=1, seed=0)
        params, cfg = serving._build_synthetic(syn)
        rng = np.random.default_rng(3)
        ws = [rng.integers(0, 96, size=16).astype(np.int32) for _ in range(4)]
        cl = serving.ServeClient([ready["addr"]], timeout_s=60.0)
        try:
            got = [cl.generate(w, 4) for w in ws]
        finally:
            cl.close()
        want = serving.sequential_reference(params, cfg, 2, [(w, 4) for w in ws], 4,
                                            device=SERVE_DEVICE)
        t1 = time.perf_counter()
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=60)
        exit_s = time.perf_counter() - t1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    ok = rc == 0 and got == want
    print(f"serve: python -m tpu_tfrecord_torch.serving --device {SERVE_DEVICE}: ready in "
          f"{ready_s:.1f} s; 4 requests equal to the reference: {got == want}; SIGTERM -> exit "
          f"{rc} in {exit_s:.2f} s (limit 60 s)")
    if not ok:
        raise SystemExit(f"serve: the replica subprocess failed: {err[-3000:]}")
    return dict(ready_s=ready_s, exit_s=exit_s, rc=rc)


def serve_path(work: str, card: str) -> dict:
    """Phase 10: LM serving on ``card`` (nvidia-smi's name and power limit),
    under deterministic algorithms (cuBLAS workspace ``:4096:8``)."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        step, params = serve_checkpoint(work)
        out = {"one_shot": serve_one_shot(params, step, card)}
        out["replica"] = replica_path(params, card)
        out["tick"] = tick_profile(params, card)
        out["subprocess"] = replica_subprocess(card)
    finally:
        torch.use_deterministic_algorithms(False)
    out["card"] = card
    print("serve: " + json.dumps(out, default=float))
    return out

# -- phase 11: Mixture-of-Experts on one card -----------------------------------------------

MOE_DEVICE = "cuda"
MOE_EXPERTS = 4
MOE_TOKENS = (32, 64)                 # the LM twin's B x L: T = 2048 tokens a layer
MOE_CASES = {                         # (top_k, capacity factor, share of tokens masked out)
    "top2": (2, 1.25, 0.0),
    "top1": (1, 1.25, 0.0),
    "top2_drop": (2, 0.25, 0.0),
    "top2_valid": (2, 1.25, 0.25),
}
MOE_ATOL = 1e-4                       # f32, TF32 off: the card against the CPU
MOE_PARITY_STEPS = 16
MOE_DRILL_STEPS = 32
MOE_DRILL_SAVE_EVERY = 8
MOE_DRILL_KILL_AT = 12
MOE_DRILL_RESUMED_AT = 8


def moe_layer_run(moe, cfg, params, x, cot, valid, device) -> dict:
    """One ``moe_apply`` forward and backward on ``device`` (float32): y,
    aux, the diagnostics, the gradients of x and the three weights, and
    the routing (each rank's expert and slot, kept or not) with the
    router probabilities."""
    p = {k: v.detach().to(device).clone().requires_grad_(True) for k, v in params.items()}
    xx = torch.tensor(x, device=device, requires_grad=True)
    v = None if valid is None else torch.from_numpy(valid).to(device)
    y, aux, diag = moe.moe_apply(p, xx, cfg, valid=v, diagnostics=True)
    (torch.sum(y * torch.from_numpy(cot).to(device)) + aux).backward()
    with torch.no_grad():
        xt = xx.detach().reshape(-1, cfg.d_model)
        probs = moe._router_probs(p, xt)
        r = moe._route(probs, cfg, moe._capacity(xt.shape[0], cfg),
                       None if v is None else v.reshape(-1))
    return dict(y=y.detach().cpu(), aux=float(aux), diag={k: t.cpu() for k, t in diag.items()},
                grads=[xx.grad.cpu()] + [p[k].grad.cpu() for k in ("router", "w_in", "w_out")],
                route=[t.cpu() for t in (r.expert, r.slot, r.kept)], probs=probs.cpu())


def moe_layer_parity() -> dict:
    """Phase 11 (a): ``moe_apply`` at T = 2048 (d_model 64, d_ff 256, 4
    experts) on the card against the CPU at top_k 2, top_k 1, a capacity
    factor of 0.25 and a quarter of the tokens masked out: y and aux within
    ``MOE_ATOL``, the routing and the diagnostics' counts equal, the
    gradients of x and the three weights within ``MOE_ATOL`` times their
    largest magnitude (at least 1). The smallest probability margin between
    a token's chosen expert and the next one says how close a tie came."""
    from tpu_tfrecord_torch.models import moe

    rng = np.random.default_rng(11)
    x = rng.normal(size=MOE_TOKENS + (64,)).astype(np.float32)
    cot = rng.normal(size=x.shape).astype(np.float32)
    mask = rng.random(MOE_TOKENS) >= 0.25
    out = {}
    for name, (top_k, cf, pad) in MOE_CASES.items():
        cfg = moe.MoEConfig(d_model=64, d_ff=256, n_experts=MOE_EXPERTS, capacity_factor=cf,
                            top_k=top_k)
        params = moe.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        valid = mask if pad else None
        cpu = moe_layer_run(moe, cfg, params, x, cot, valid, "cpu")
        card = moe_layer_run(moe, cfg, params, x, cot, valid, MOE_DEVICE)
        y_err = float((card["y"] - cpu["y"]).abs().max())
        aux_err = abs(card["aux"] - cpu["aux"])
        routing = all(torch.equal(a, b) for a, b in zip(card["route"], cpu["route"]))
        counts = all(torch.equal(card["diag"][k], cpu["diag"][k]) for k in ("expert_tokens", "expert_kept"))
        grad_errs = [float((g - h).abs().max()) for g, h in zip(card["grads"], cpu["grads"])]
        grad_scales = [max(1.0, float(h.abs().max())) for h in cpu["grads"]]
        grads_ok = all(e <= MOE_ATOL * s for e, s in zip(grad_errs, grad_scales))
        top = torch.sort(cpu["probs"], dim=-1, descending=True).values
        keep = torch.ones(top.shape[0], dtype=torch.bool) if valid is None else torch.from_numpy(valid.reshape(-1))
        margin = float(min((top[keep, r] - top[keep, r + 1]).min() for r in range(top_k)))
        ok = y_err <= MOE_ATOL and aux_err <= MOE_ATOL and routing and counts and grads_ok \
            and bool(torch.isfinite(card["y"]).all())
        kept = card["diag"]["expert_kept"].tolist()
        print(f"moe: moe_apply {name} (top_k {top_k}, capacity factor {cf}, "
              f"{'a quarter masked' if pad else 'no mask'}; T=2048, C={moe._capacity(2048, cfg)}): "
              f"y max abs err {y_err:.3e}, aux {aux_err:.3e} (atol {MOE_ATOL}); routing equal "
              f"{routing}, counts equal {counts} (kept {kept}, dropped fraction "
              f"{float(card['diag']['dropped_fraction']):.4f}); grad errs x/router/w_in/w_out "
              f"{['%.3e' % e for e in grad_errs]} (scales {['%.2f' % s for s in grad_scales]}); "
              f"smallest top-{top_k} probability margin {margin:.3e}: {ok}")
        if not ok:
            raise SystemExit(f"moe: moe_apply {name} disagrees between the card and the CPU")
        out[name] = dict(y_err=y_err, aux_err=aux_err, grad_errs=grad_errs, margin=margin,
                         kept=kept)
    return out


def moe_lm_parity(data_dir: str) -> dict:
    """Phase 11 (b): the MoE LM of ``train_lm --moe 4`` (vocab 256, d_model
    64, 4 heads, 2 layers, L = 64, 4 experts top-2, f32) with one set of
    weights on the card and on the CPU: the first packed batch's logits
    within ``MOE_ATOL``, then 16 Adam steps in lockstep (before each step the
    CPU takes the card's parameters and Adam moments) with losses within a
    relative ``SEQ_LOSS_RTOL`` and each step's ``expert_tokens`` and
    ``expert_kept`` equal. The same 16 steps run free on both sides are
    printed beside, not gated: a top-k router's choices are discontinuous,
    so the two trajectories part once rounding flips a near tie."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.models import lm, optim

    cfg = tw.make_config(2, MOE_EXPERTS)
    batches, _ = packed_batches(data_dir, "slice", MOE_PARITY_STEPS)
    toks = [torch.from_numpy(b["tokens"]) for b in batches]
    host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = tree_to(host, MOE_DEVICE)
    with torch.no_grad():
        want, want_aux, want_diag = lm.forward(host, toks[0], cfg, diagnostics=True)
        got, got_aux, got_diag = lm.forward(card, toks[0].to(MOE_DEVICE), cfg, diagnostics=True)
    err = float((got.cpu() - want).abs().max())
    first_counts = all(torch.equal(got_diag[k].cpu(), want_diag[k]) for k in ("expert_tokens", "expert_kept"))
    runs = {}
    for mode in ("lockstep", "free"):
        h, c = tree_to(host, "cpu"), tree_to(host, MOE_DEVICE)
        ho, co = optim.adam(h, tw.LR), optim.adam(c, tw.LR)
        rels, equal = [], []
        for t in toks:
            if mode == "lockstep":
                optim.load_train_state(h, ho, optim.train_state(c, co))
            lh, dh = lm.train_step(h, ho, t, cfg, diagnostics=True)
            lc, dc = lm.train_step(c, co, t.to(MOE_DEVICE), cfg, diagnostics=True)
            rels.append(abs(float(lc) - float(lh)) / abs(float(lh)))
            equal.append(all(torch.equal(dc[k].cpu(), dh[k]) for k in ("expert_tokens", "expert_kept")))
        runs[mode] = dict(max_rel=max(rels), equal_steps=sum(equal), last_loss=float(lc),
                          last_drop=float(dc["dropped_fraction"]))
    lock = runs["lockstep"]
    ok = err <= MOE_ATOL and first_counts and lock["max_rel"] <= SEQ_LOSS_RTOL \
        and lock["equal_steps"] == len(toks) and np.isfinite(lock["last_loss"])
    print(f"moe: MoE LM parity (train_lm --moe {MOE_EXPERTS} width, [32, 65] slice batches): logits "
          f"max abs err {err:.3e} (atol {MOE_ATOL}), aux {float(got_aux):.6f} vs {float(want_aux):.6f}, "
          f"counts equal {first_counts}; {len(toks)} Adam steps in lockstep: max loss rel diff "
          f"{lock['max_rel']:.3e} (rtol {SEQ_LOSS_RTOL}), expert_tokens/expert_kept equal on "
          f"{lock['equal_steps']}/{len(toks)} steps, last loss {lock['last_loss']:.6f}, dropped "
          f"fraction {lock['last_drop']:.4f}: {ok}")
    print(f"moe: the same {len(toks)} steps run free on both sides (not gated): max loss rel diff "
          f"{runs['free']['max_rel']:.3e}, counts equal on {runs['free']['equal_steps']}/{len(toks)} "
          "steps")
    if not ok:
        raise SystemExit("moe: the MoE LM disagrees between the card and the CPU")
    return dict(logits_err=err, **{f"{m}_{k}": v for m, r in runs.items() for k, v in r.items()})


def moe_twins(work: str, lm_data: str, ld_data: str) -> dict:
    """Phase 11 (c) and (d): ``train_lm --moe 4 --diagnostics --trace-out``
    for 32 steps saving every 8, uninterrupted, and again killed with
    SIGKILL after step 12 and rerun: it must resume at step 8 with the
    uninterrupted run's digests for steps 9-32 and its losses (bit-equal,
    or within a relative ``SEQ_LOSS_RTOL``: the line says which), print
    finite ``moe.*`` gauges and write its trace. Beside them,
    ``LONGDOC_MOE_EXPERTS=4 train_longdoc`` whole: finite losses, the phase
    shares and the verdict. The uninterrupted run, the killed run and
    train_longdoc run at once (three processes on the card)."""
    import signal

    common = ["--data-dir", lm_data, "--steps", str(MOE_DRILL_STEPS), "--save-every",
              str(MOE_DRILL_SAVE_EVERY), "--moe", str(MOE_EXPERTS), "--diagnostics"]

    def lm_run(name, ckpt, kill=None):
        return run_twin("tpu_tfrecord_torch.train_lm", common + [
            "--ckpt-dir", os.path.join(work, ckpt),
            "--digest-out", os.path.join(work, f"moe_{name}.jsonl"),
            "--trace-out", os.path.join(work, f"moe_{name}_trace.json")],
            work, f"moe_{name}.err", kill, device=MOE_DEVICE)

    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        ref_f = pool.submit(lm_run, "uninterrupted", "moe_ckpt_ref")
        kill_f = pool.submit(lm_run, "killed", "moe_ckpt", MOE_DRILL_KILL_AT)
        ld_f = pool.submit(run_twin, "tpu_tfrecord_torch.train_longdoc",
                           ["--data-dir", ld_data, "--ckpt-dir", os.path.join(work, "moe_ld_ckpt")],
                           work, "moe_longdoc.err", None, MOE_DEVICE, {"LONGDOC_MOE_EXPERTS": "4"})
        runs = {"uninterrupted": ref_f.result(), "killed": kill_f.result()}
        ld = ld_f.result()
    runs["resumed"] = lm_run("resumed", "moe_ckpt")
    for name, (rc, lines, err) in runs.items():
        want_rc = -signal.SIGKILL if name == "killed" else 0
        if rc != want_rc:
            raise SystemExit(f"moe: train_lm --moe {name} run ended with {rc}: {err[-3000:]}")
        head = [ln for _, ln in lines if not ln.startswith("lm_step")]
        print(f"moe: train_lm --moe {MOE_EXPERTS} --diagnostics {name}: " + " | ".join(head))
    ref, res = lm_steps(runs["uninterrupted"][1]), lm_steps(runs["resumed"][1])
    first = [ln for _, ln in runs["resumed"][1]][:3]
    resumed_at = f"resumed at step {MOE_DRILL_RESUMED_AT}" in first
    later = range(MOE_DRILL_RESUMED_AT + 1, MOE_DRILL_STEPS + 1)
    digests = sorted(res) == list(later) and all(res[s]["digest"] == ref[s]["digest"] for s in later)
    bit_equal = digests and all(res[s]["loss"] == ref[s]["loss"] for s in later)
    rel = max(abs(float(res[s]["loss"]) - float(ref[s]["loss"])) / abs(float(ref[s]["loss"]))
              for s in later) if digests else float("inf")
    determinism = "bit-equal" if bit_equal else f"within a relative {SEQ_LOSS_RTOL} (max {rel:.3e})"
    gauges = {}
    traces = {}
    for name in ("uninterrupted", "resumed"):
        line = [ln for _, ln in runs[name][1] if ln.startswith("model diagnostics: ")]
        gauges[name] = json.loads(line[-1].split(": ", 1)[1]) if line else {}
        path = os.path.join(work, f"moe_{name}_trace.json")
        with open(path) as fh:
            events = json.load(fh)["traceEvents"]
        traces[name] = sum(1 for e in events if e.get("name") == "train.step")
    losses = [float(ref[s]["loss"]) for s in sorted(ref)]
    gauges_ok = all(sorted(g) == ["moe.dropped_fraction", "moe.expert_imbalance", "moe.gate_entropy"]
                    and all(np.isfinite(v) for v in g.values()) for g in gauges.values())
    ok = resumed_at and digests and (bit_equal or rel <= SEQ_LOSS_RTOL) and gauges_ok \
        and np.isfinite(losses).all() and traces["uninterrupted"] == MOE_DRILL_STEPS \
        and traces["resumed"] == MOE_DRILL_STEPS - MOE_DRILL_RESUMED_AT
    print(f"moe: train_lm --moe drill: {first[:3]}; resumed at step {MOE_DRILL_RESUMED_AT}: "
          f"{resumed_at}; digests of steps {later[0]}-{later[-1]} equal the uninterrupted run's: "
          f"{digests}; losses {determinism}; losses {losses[0]:.4f} -> {losses[-1]:.4f}; moe gauges "
          f"{gauges}; train.step spans in the traces {traces}: {ok}")
    if not ok:
        raise SystemExit("moe: the train_lm --moe kill drill did not continue the uninterrupted run")
    rc, lines, err = ld
    text = [ln for _, ln in lines]
    print("moe: LONGDOC_MOE_EXPERTS=4 train_longdoc: " + " | ".join(text))
    ld_losses = [float(ln.split("~")[1]) for ln in text if ln.startswith("step ")]
    phases = [ln for ln in text if ln.startswith("train phases:")]
    if rc != 0 or not ld_losses or not np.isfinite(ld_losses).all() or not phases \
            or not any(ln.startswith("done: 32 steps") for ln in text):
        raise SystemExit(f"moe: train_longdoc with MoE failed ({rc}): {err[-3000:]}")
    return dict(determinism=determinism, loss_rel=rel, first_loss=losses[0], last_loss=losses[-1],
                gauges=gauges, longdoc_losses=ld_losses, longdoc_phases=phases[0])


def moe_longdoc_parity(data_dir: str) -> dict:
    """Phase 11 (d): the MoE long_doc (4 experts, top 1, routed over the
    valid prefix) on the twin's first batch, card against CPU: bf16 logits
    within 2e-2, float32 within 1e-4."""
    from tpu_tfrecord_torch import train_longdoc as tw
    from tpu_tfrecord_torch.device.ingest import host_batch_from_columnar
    from tpu_tfrecord_torch.io.dataset import TFRecordDataset
    from tpu_tfrecord_torch.models import long_doc

    ds = TFRecordDataset(data_dir, batch_size=tw.BATCH, schema=tw.make_schema(),
                         recordType="SequenceExample", shuffle=True, seed=0)
    with ds.batches() as it:
        cb = next(it)
    hb = tw.host_batch(cb, ds.schema)
    f32 = host_batch_from_columnar(cb, ds.schema, pad_to={"frames": (tw.MAX_LEN, tw.SEQ_DIM)})
    out = {}
    for dtype, frames in ((torch.bfloat16, hb["frames"]), (torch.float32, torch.from_numpy(f32["frames"]))):
        cfg = dataclasses.replace(tw.make_config(), moe_experts=MOE_EXPERTS, dtype=dtype)
        host = long_doc.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        card = tree_to(host, MOE_DEVICE)
        batch = {"frames": frames, "frames_len": torch.from_numpy(f32["frames_len"]),
                 "label": torch.from_numpy(f32["label"])}
        with torch.no_grad():
            want, want_aux = long_doc.forward(host, batch, cfg, with_aux=True)
            got, got_aux = long_doc.forward(card, {k: v.to(MOE_DEVICE) for k, v in batch.items()},
                                            cfg, with_aux=True)
        err = float((got.cpu() - want).abs().max())
        tol = LONGDOC_TOL[dtype]
        ok = err <= tol and bool(torch.isfinite(got).all())
        print(f"moe: MoE long_doc logits [64, 2] {dtype} (T=4096, C=1280, top 1), card against the "
              f"CPU: max abs err {err:.3e} (tol {tol}); aux {float(got_aux):.6f} vs "
              f"{float(want_aux):.6f}: {ok}")
        if not ok:
            raise SystemExit(f"moe: MoE long_doc card/CPU parity failed in {dtype}")
        out[str(dtype).replace("torch.", "")] = err
    return out


def moe_rates(card: str) -> dict:
    """Phase 11 (e), beside ``card`` (nvidia-smi's name and power limit):
    the MoE LM train step and phase 9's dense step on a resident batch
    (host ms, device ms and kernels a step, idle share), and ``moe_apply``'s
    forward at T = 2048, under the default algorithms as in phase 9."""
    from tpu_tfrecord_torch import train_lm as tw
    from tpu_tfrecord_torch.models import lm, moe, optim

    print(f"moe: rates on {card}")
    out = {}
    for name, experts in (("moe", MOE_EXPERTS), ("dense", 0)):
        cfg = tw.make_config(2, experts)
        params = lm.init_params(cfg, torch.Generator(device=MOE_DEVICE).manual_seed(0), MOE_DEVICE)
        opt = optim.adam(params, tw.LR)
        toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, 32, seed=0)).to(MOE_DEVICE)
        label = (f"MoE LM train step ({experts} experts, top 2)" if experts else "dense LM train step")
        out[name] = step_rate(f"{label}, B=32 L=64 d=64 (make_synthetic_tokens)",
                              lambda: lm.train_step(params, opt, toks, cfg), 32 * 64)
    cfg = moe.MoEConfig(d_model=64, d_ff=256, n_experts=MOE_EXPERTS, top_k=2)
    params = moe.init_params(cfg, torch.Generator(device=MOE_DEVICE).manual_seed(0), MOE_DEVICE)
    x = torch.randn(MOE_TOKENS + (64,), generator=torch.Generator(device=MOE_DEVICE).manual_seed(1),
                    device=MOE_DEVICE)
    with torch.no_grad():
        out["moe_apply_forward"] = step_rate("moe_apply forward, T=2048 d=64 d_ff=256 4 experts top 2",
                                             lambda: moe.moe_apply(params, x, cfg), 2048)
    return out


def moe_path(work: str, card: str) -> dict:
    """Phase 11: the Mixture-of-Experts models on ``card`` (nvidia-smi's
    name and power limit), the parities and twins under deterministic
    algorithms (cuBLAS workspace ``:4096:8``), the rates under the default
    ones. Uses phase 9's SequenceExamples under ``work`` (written again
    when absent)."""
    from tpu_tfrecord_torch import train_lm, train_longdoc

    lm_data, ld_data = os.path.join(work, "lm_data"), os.path.join(work, "ld_data")
    train_lm.generate(lm_data)
    train_longdoc.generate(ld_data)
    t0 = time.perf_counter()
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    torch.use_deterministic_algorithms(True)
    try:
        out = {"moe_apply": moe_layer_parity(), "lm_parity": moe_lm_parity(lm_data),
               "long_doc_parity": moe_longdoc_parity(ld_data)}
        out["twins"] = moe_twins(work, lm_data, ld_data)
    finally:
        torch.use_deterministic_algorithms(False)
    out["rates"] = moe_rates(card)  # default algorithms, as phase 9 times its steps
    out["card"] = card
    out["seconds"] = time.perf_counter() - t0
    print(f"moe: phase 11 took {out['seconds']:.1f} s")
    print("moe: " + json.dumps(out, default=float))
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_tfrecord_torch import _cuda

    t_start = time.perf_counter()
    smi = device_facts()
    host_facts()
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        native = pool.submit(build_native)  # g++ beside nvcc
        _cuda.build(["interaction"])
        print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s")
        native.result()
    for name, log in _cuda.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}")
    if "interaction" in _cuda.BUILD_LOGS:
        check_build_log(_cuda.BUILD_LOGS["interaction"])
    else:
        print("interaction kernels were built before this run: no ptxas report to check")
    errs = check_interaction()
    check_small_forward()
    timing = {k: time_interaction(dtype) for k, dtype in INSTANCE_DTYPE.items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        launches = main_path(data_dir)
        free_cuda()
        train = train_path(data_dir)
        free_cuda()
        feed = feed_path(data_dir)
        free_cuda()
        datasource = datasource_path(data_dir)
        free_cuda()
        resume = resume_path(data_dir)
        free_cuda()
        from tpu_tfrecord_torch.models.interaction import dot_interaction, reset_launch_counts

        reset_launch_counts()
        seq_path(data_dir, smi)
        seq_launches = dict(dot_interaction.instance_launches)
        free_cuda()
        reset_launch_counts()
        serve_path(data_dir, smi)
        serve_launches = dict(dot_interaction.instance_launches)
        free_cuda()
        reset_launch_counts()
        moe_path(data_dir, smi)
        moe_launches = dict(dot_interaction.instance_launches)
    phase_launches = {"seq": seq_launches, "serve": serve_launches, "moe": moe_launches}
    for phase, counts in phase_launches.items():
        if any(counts.values()):
            raise SystemExit(f"dot_interaction launched in the {phase} phase: {counts}")
    design = {
        "bf16_mma": "mma.sync m16n8k16 bf16 Gram, cp.async 16-byte double-buffered "
                    "staging, persistent grid, 16-byte stores through shared memory",
        "f32_tiled": "f32 FMAs in 4x4 register blocks of row pairs, cp.async 16-byte "
                     "double-buffered staging at an odd-chunk sample stride, persistent grid, "
                     "16-byte stores through shared memory",
    }
    kernels = [dict(
        name=f"dot_interaction_{k}",
        route="cuda",
        source="tpu_tfrecord_torch/csrc/interaction.cu",
        replaces="tpu_tfrecord/models/interaction.py:78",
        design=design[k],
        launches=launches[k],
        max_abs_err=errs[k],
        **timing[k],
        **train[k],
        feed_launches=feed[k],
        datasource_launches=datasource[k],
        resume_launches=resume[k],
        seq_launches=seq_launches[k],
        serve_launches=serve_launches[k],
        moe_launches=moe_launches[k],
    ) for k in INSTANCE_DTYPE]
    print(f"total {time.perf_counter() - t_start:.1f} s on {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
