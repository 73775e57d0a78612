"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU (built for an H100).

    python3 chip_smoke.py

Phases, each of which fails the run (non-zero exit) when it fails:

1. Device facts: the card's name and power limit, TF32 switched off.
2. Build every CUDA kernel from ``tpu_tfrecord_torch/csrc`` with nvcc for
   sm_90a (all sources at once) and hold each kernel against its plain
   PyTorch version on the card.
3. Time each kernel at its main-path shape beside its plain version, one
   PyTorch library call computing the same function, and the least time
   the card could take (bytes over 3.35 TB/s or operations over the peak
   rate).
4. The main path at full Criteo width: write 2 shards x 16,384 Example rows
   through the port's writer, read them back with ``TFRecordDataset``
   (hashing into 2^20 buckets, packing dense/cat), and score every batch
   with the 26 x 2^20 x 32 DLRM (3.49 GB table) through ``score_files``.
   The kernel launch counts of that run must match the batches scored, and
   the logits must match a run whose interaction is the plain version.
   Then the forward's device time, its kernels (torch.profiler), rows/s and
   the card's idle share over the run.

The line before the last is a JSON object with each kernel's launches,
error and times; the last line is ``{"ok": true, "device": {...}}``. Without
a CUDA device the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import json
import os
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


def check_interaction() -> float:
    """Kernel vs plain version on the card at every listed shape; returns
    the max abs error at the main-path shape (16384, 27, 32) bf16."""
    from tpu_tfrecord_torch.models.interaction import (
        dot_interaction_cuda,
        dot_interaction_reference,
    )

    tol = {torch.float32: dict(atol=1e-4, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}
    gen = torch.Generator(device="cuda").manual_seed(0)
    main_err = None
    for shape in [(16384, 27, 32), (13, 27, 32), (64, 64, 16), (8, 2, 8)]:
        for dtype in (torch.bfloat16, torch.float32):
            emb = torch.randn(shape, generator=gen, device="cuda").to(dtype)
            got = dot_interaction_cuda(emb)
            torch.cuda.synchronize()
            want = dot_interaction_reference(emb)
            err = (got.float() - want.float()).abs().max().item()
            ok = got.shape == want.shape and torch.allclose(
                got.float(), want.float(), **tol[dtype]
            )
            print(f"dot_interaction {shape} {str(dtype)[6:]}: max_abs_err={err} "
                  f"{'ok' if ok else 'MISMATCH'} ({tol[dtype]})")
            if not ok:
                raise SystemExit(f"dot_interaction kernel disagrees at {shape} {dtype}")
            if shape == (16384, 27, 32) and dtype == torch.bfloat16:
                main_err = err
    return main_err


def time_interaction(b=BATCH, f=27, d=32, dtype=torch.bfloat16) -> dict:
    from tpu_tfrecord_torch.models.interaction import (
        dot_interaction_cuda,
        dot_interaction_reference,
        tril_pairs,
    )

    gen = torch.Generator(device="cuda").manual_seed(1)
    emb = torch.randn((b, f, d), generator=gen, device="cuda").to(dtype)
    rows, cols = (t.long() for t in tril_pairs(f, emb.device))
    p = f * (f - 1) // 2

    def library():  # one PyTorch call's worth of work; never used by the port
        return torch.einsum("bfd,bgd->bfg", emb, emb)[:, rows, cols]

    elt = emb.element_size()
    nbytes = b * f * d * elt + b * p * elt
    nops = 2 * b * p * d
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / PEAK_OPS_PER_S[dtype] * 1e3
    out = {
        "ms": median_ms(lambda: dot_interaction_cuda(emb)),
        "plain_ms": median_ms(lambda: dot_interaction_reference(emb)),
        "library_ms": median_ms(library),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
    }
    print(f"dot_interaction timing at ({b}, {f}, {d}) {str(dtype)[6:]}: "
          f"kernel {out['ms']:.4f} ms, plain {out['plain_ms']:.4f} ms, "
          f"library einsum+index {out['library_ms']:.4f} ms, bound {out['bound_ms']:.4f} ms "
          f"({out['bound_by']}: {nbytes / 1e6:.1f} MB, {nops / 1e9:.3f} GFLOP)")
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


def main_path() -> int:
    """Full-width Criteo DLRM scoring from TFRecord files; returns the
    kernel's launches during the scoring run."""
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.entry import score_files
    from tpu_tfrecord_torch.models.dlrm import DLRMConfig, init_params, make_synthetic_batch
    from tpu_tfrecord_torch.models.interaction import dot_interaction
    from tpu_tfrecord_torch.schema import IntegerType, StringType, StructField, StructType

    cfg = DLRMConfig(num_dense=13, num_categorical=26, vocab_size=VOCAB, embed_dim=32,
                     bottom_mlp=(64, 32), top_mlp=(64, 1), interaction="dot",
                     dtype=torch.bfloat16)
    model = init_params(cfg, torch.Generator(device="cuda").manual_seed(0), "cuda")
    table_gb = model.embeddings.numel() * model.embeddings.element_size() / 1e9
    print(f"DLRM at Criteo width: table {tuple(model.embeddings.shape)} f32 = {table_gb:.2f} GB on the card")
    read_schema = StructType(
        [StructField("label", IntegerType(), nullable=False)]
        + [StructField(f"I{i}", IntegerType()) for i in range(1, 14)]
        + [StructField(f"C{i}", StringType()) for i in range(1, 27)]
    )
    kw = dict(recordType="Example", schema=read_schema,
              dense_cols=[f"I{i}" for i in range(1, 14)],
              cat_cols=[f"C{i}" for i in range(1, 27)], log1p_dense=True)
    # warm-up forward (cuBLAS handles, allocator) outside the counted run
    warm = make_device_batch(make_synthetic_batch(cfg, BATCH, seed=1), "cuda")
    model(warm)
    torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as data_dir:
        t0 = time.perf_counter()
        write_criteo(data_dir)
        print(f"wrote {CRITEO_SHARDS} x {CRITEO_ROWS_PER_SHARD} Example rows in "
              f"{time.perf_counter() - t0:.1f} s (host)")
        dot_interaction.launches = 0
        res = score_files(data_dir, cfg, model, BATCH, "cuda", **kw)
        launches = dot_interaction.launches
        with plain_interaction():
            ref = score_files(data_dir, cfg, model, BATCH, "cuda", **kw)
    n_rows = CRITEO_SHARDS * CRITEO_ROWS_PER_SHARD // BATCH * BATCH
    for i in range(res.batches):
        print(f"batch {i}: host {res.host_s[i] * 1e3:.1f} ms, h2d {res.h2d_s[i] * 1e3:.3f} ms, "
              f"forward {res.forward_s[i] * 1e3:.3f} ms")
    logits = res.logits
    if logits.shape != (n_rows,) or not torch.isfinite(logits).all():
        raise SystemExit(f"bad logits: shape {tuple(logits.shape)}, "
                         f"finite={bool(torch.isfinite(logits).all())}")
    if launches != res.batches or launches == 0:
        raise SystemExit(f"dot_interaction launched {launches} times for {res.batches} batches")
    err = (logits - ref.logits).abs().max().item()
    print(f"main path: {res.batches} batches, {n_rows} logits, kernel launches {launches}, "
          f"max |logit - plain-interaction logit| = {err}")
    if not torch.allclose(logits, ref.logits, rtol=2e-2, atol=2e-2):
        raise SystemExit("main-path logits disagree with the plain-interaction forward")
    profile_forward(model, warm, res)
    return launches


def profile_forward(model, batch, res) -> None:
    """Where a full-width batch's time goes on the card: the forward's device
    time (CUDA events), its kernels by device time (torch.profiler), and the
    card's idle share over the scoring run's batches."""
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = median_ms(lambda: model(batch), warmup=3, reps=7, calls=5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model(batch)
        torch.cuda.synchronize()
    print(f"forward at batch {BATCH}: {fwd_ms:.4f} ms device time per call (CUDA events); "
          "one forward by torch.profiler:")
    print(prof.key_averages().table(sort_by="self_device_time_total", row_limit=12))
    wall = sum(res.host_s) + sum(res.h2d_s) + sum(res.forward_s)
    busy = sum(res.h2d_s) + res.batches * fwd_ms / 1e3
    print(f"scoring run: {res.batches * BATCH / wall:.1f} rows/s end to end; device idle share "
          f"~{1 - busy / wall:.4f} (1 - (h2d + forward device time) / wall time)")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tpu_tfrecord_torch import _cuda

    t_start = time.perf_counter()
    smi = device_facts()
    t0 = time.perf_counter()
    _cuda.build(["interaction"])
    print(f"built CUDA kernels in {time.perf_counter() - t0:.1f} s")
    for name, log in _cuda.BUILD_LOGS.items():
        print(f"nvcc {name}:\n{log.strip()}")
    err = check_interaction()
    check_small_forward()
    timing = time_interaction()
    launches = main_path()
    kernels = [dict(
        name="dot_interaction",
        route="cuda",
        source="tpu_tfrecord_torch/csrc/interaction.cu",
        replaces="tpu_tfrecord/models/interaction.py:78",
        launches=launches,
        max_abs_err=err,
        **timing,
    )]
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
