"""Where the dot-interaction kernel's time goes, on one NVIDIA GPU.

    python -m tpu_tfrecord_torch.interaction_sweep

For each instance (bf16 ``mma``, f32 ``tiled``), at the DLRM main path's
shape (16384, 27, 32) with cold inputs (the calls cycle over 6 inputs,
170 MB in bf16 and 340 MB in f32, past the 50 MB L2), this times:

- the kernel at the geometry ``_interaction_plan`` picks, and at other
  tiles (samples per tile) and blocks per SM, called through the C entry
  point with that geometry;
- diagnostic builds of the same source with one part of the instance's
  work taken out: ``no_gram`` (no products and no staging of outputs),
  ``no_store`` (no output stores), ``no_load`` (only each block's first
  tile is copied in), and a 3-stage ring of row buffers (``stages3``, both
  instances); their outputs are wrong by design and are not checked;
- ``torch.Tensor.copy_`` of E, the rate this card reaches on a plain
  read + write stream.

Each build goes to ``_build/sweep/``. Prints the card's name and power
limit first; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import ctypes
import itertools
import subprocess
import sys

import numpy as np
import torch

SHAPE = (16384, 27, 32)
COLD_INPUTS = 6
DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32}

# name -> (source edits, kStages, instances it is timed for); each edit must
# hit the source once
VARIANTS = {
    "kernel": ([], 2, ("bf16", "f32")),
    "stages3": ([("constexpr int kStages = 2;", "constexpr int kStages = 3;")], 3,
                ("bf16", "f32")),
    "no_gram": ([("      gram_sample<kNks>(buf + s * sample",
                  "      if (B < 0) gram_sample<kNks>(buf + s * sample")], 2, ("bf16",)),
    "no_store": ([("    for (int lo = threadIdx.x * 8; lo < n;",
                   "    for (int lo = threadIdx.x * 8; lo < (B < 0 ? n : 0);")], 2, ("bf16",)),
    "no_load": ([("    stage(k + kStages - 1);", "    if (B < 0) stage(k + kStages - 1);")], 2,
                ("bf16",)),
    "f32_no_gram": ([("      gram_block(buf", "      if (B < 0) gram_block(buf")], 2, ("f32",)),
    "f32_no_store": ([("    for (int lo = threadIdx.x * 4; lo < n;",
                       "    for (int lo = threadIdx.x * 4; lo < (B < 0 ? n : 0);")], 2, ("f32",)),
    "f32_no_load": ([("    load_tile(k + kStages - 1);",
                      "    if (B < 0) load_tile(k + kStages - 1);")], 2, ("f32",)),
}
# geometries tried besides the plan's: (tiles, blocks per SM)
GEOMETRIES = {"bf16": ((2, 4, 8, 16), (2, 4, 6, 8)), "f32": ((4, 8, 16, 24), (1, 2, 3, 4))}
_SMEM_SM = 233_472
_SMEM_BLOCK_MAX = 232_448


def build_variants(names) -> dict:
    from tpu_tfrecord_torch import _cuda

    src = (_cuda.CSRC / "interaction.cu").read_text()
    out_dir = _cuda.BUILD_DIR / "sweep"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        text = src
        for old, new in VARIANTS[name][0]:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name}: {old!r} is not in interaction.cu once")
            text = text.replace(old, new)
        cu = out_dir / f"{name}.cu"
        cu.write_text(text)
        cmd = [_cuda.nvcc_path(), *_cuda.NVCC_FLAGS, "-o", str(out_dir / f"{name}.so"), str(cu)]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed for variant {name}:\n{log}")
        lib = ctypes.CDLL(str(out_dir / f"{name}.so"))
        for fn in (lib.dot_interaction_bf16, lib.dot_interaction_f32):
            fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
            fn.restype = ctypes.c_int
        libs[name] = lib
    return libs


def median_ms(call, warmup: int = 10, reps: int = 15, calls: int = 24) -> float:
    for _ in range(warmup):
        call()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            call()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


def sweep(key: str, libs: dict, sms: int) -> None:
    """Time one instance's geometries and diagnostic builds, then copy_."""
    from tpu_tfrecord_torch.models.interaction import _interaction_plan, dot_interaction_reference

    dtype = DTYPES[key]
    b, f, d = SHAPE
    p = f * (f - 1) // 2
    plan = _interaction_plan(b, f, d, dtype, sms)
    print(f"plan at {SHAPE} {key} on {sms} SMs: {plan}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    embs = [torch.randn(SHAPE, generator=gen, device="cuda").to(dtype) for _ in range(COLD_INPUTS)]
    out = torch.empty((b, p), dtype=dtype, device="cuda")
    want = dot_interaction_reference(embs[0])
    tol = dict(atol=1e-2, rtol=8e-3) if key == "bf16" else dict(atol=1e-4, rtol=1e-5)
    stream = torch.cuda.current_stream().cuda_stream
    entry = "dot_interaction_bf16" if key == "bf16" else "dot_interaction_f32"

    def smem(stages, tile):
        if key == "bf16":
            return stages * tile * plan.fp * plan.stride * 2 + (-(-(8 + tile * p) // 8) * 8) * 2
        return (stages * tile * (plan.fp * plan.stride + 4) + (-(-(4 + tile * p) // 4) * 4)) * 4

    def time_variant(name, tile, per_sm):
        stages = VARIANTS[name][1]
        nbytes = smem(stages, tile)
        grid = min(sms * per_sm, -(-b // tile))
        cycle = itertools.cycle(embs)
        fn = getattr(libs[name], entry)

        def call(emb=None):
            err = fn((emb if emb is not None else next(cycle)).data_ptr(), out.data_ptr(),
                     b, f, d, p, plan.fp, plan.dp, plan.stride, tile, nbytes, grid, 1, stream)
            if err:
                raise SystemExit(f"{key} {name} tile {tile} grid {grid}: cudaError {err}")

        check = ""
        if name in ("kernel", "stages3"):
            call(embs[0])
            torch.cuda.synchronize()
            ok = torch.allclose(out.float(), want.float(), **tol)
            check = " matches the plain version" if ok else " MISMATCH"
        print(f"{key} {name:12s} tile {tile:2d} blocks/SM {per_sm:2d} grid {grid:4d} "
              f"smem {nbytes:6d} B: cold {median_ms(call):.4f} ms{check}", flush=True)

    per_sm_plan = -(-plan.grid // sms)
    tiles, per_sms = GEOMETRIES[key]
    for tile in tiles:
        for per_sm in per_sms:
            if smem(2, tile) <= _SMEM_BLOCK_MAX and (smem(2, tile) + 1024) * per_sm <= _SMEM_SM:
                time_variant("kernel", tile, per_sm)
    for name, (_, _, keys) in VARIANTS.items():
        if name != "kernel" and key in keys:
            time_variant(name, plan.tile, per_sm_plan)
    dst = torch.empty_like(embs[0])
    cycle = itertools.cycle(embs)
    copy_ms = median_ms(lambda: dst.copy_(next(cycle)))
    moved = 2 * embs[0].numel() * embs[0].element_size()
    print(f"{key} copy_ of E ({moved / 1e6:.1f} MB read + written): cold {copy_ms:.4f} ms, "
          f"{moved / copy_ms / 1e9:.3f} TB/s", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        print("interaction_sweep: no CUDA device", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    libs = build_variants(VARIANTS)
    for key in DTYPES:
        sweep(key, libs, sms)
    return 0


if __name__ == "__main__":
    sys.exit(main())
