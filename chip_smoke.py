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
import subprocess
import sys
import tempfile
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


def write_criteo(data_dir: str) -> None:
    """Criteo-shaped Example rows (label, 13 ints, 26 8-letter strings), as
    bench.py generates them, through the port's writer, one dir per shard."""
    from tpu_tfrecord_torch import io as tfio
    from tpu_tfrecord_torch.schema import LongType, StringType, StructField, StructType

    schema = StructType(
        [StructField("label", LongType(), nullable=False)]
        + [StructField(f"I{i}", LongType()) for i in range(1, 14)]
        + [StructField(f"C{i}", StringType()) for i in range(1, 27)]
    )
    rng = np.random.default_rng(0)
    for s in range(CRITEO_SHARDS):
        n = CRITEO_ROWS_PER_SHARD
        ints = rng.integers(0, 1 << 31, size=(n, 13))
        labels = rng.integers(0, 2, size=n)
        cats = rng.integers(0, 16, size=(n, 26, 8), dtype=np.uint8) + 97
        rows = (
            [int(labels[r])] + [int(v) for v in ints[r]]
            + [cats[r, c].tobytes().decode() for c in range(26)]
            for r in range(n)
        )
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
    return {k: launches[k] for k, (_, _, _, launches) in runs.items()}


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
