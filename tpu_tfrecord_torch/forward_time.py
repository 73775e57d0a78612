"""Device time of one full-width Criteo DLRM forward, in bf16 and in f32
activations, and of the dot-interaction kernel at its shape, on one NVIDIA
GPU.

    python3 tpu_tfrecord_torch/forward_time.py [CHECKOUT]

Times the port in CHECKOUT (default: the checkout that holds this file),
using that checkout's ``chip_smoke.py`` helpers, so two commits can be
compared in one run: unpack the other with ``git archive`` and run the
script on each in turns (A, B, B, A). Times are CUDA-graph replays: the
forward on one resident batch of 16,384 rows, the kernel on one input
(warm) and cycled over 6 inputs (cold). Prints the card's name and power
limit, then one JSON line; exits non-zero without a CUDA device.
"""

from __future__ import annotations

import itertools
import json
import os
import sys

import torch


def main() -> int:
    checkout = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                               os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    if not torch.cuda.is_available():
        print("forward_time: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, checkout)
    import chip_smoke as cs
    from tpu_tfrecord_torch.device.ingest import make_device_batch
    from tpu_tfrecord_torch.models.dlrm import init_params, make_synthetic_batch
    from tpu_tfrecord_torch.models.interaction import dot_interaction_cuda

    cs.device_facts()
    model = init_params(cs.criteo_cfg(), torch.Generator(device="cuda").manual_seed(0), "cuda")
    batch = make_device_batch(make_synthetic_batch(model.cfg, cs.BATCH, seed=1), "cuda")
    gen = torch.Generator(device="cuda").manual_seed(1)
    out = {"checkout": checkout}
    for dtype in (torch.bfloat16, torch.float32):
        key = str(dtype)[6:]
        m = cs.with_dtype(model, dtype)
        embs = [torch.randn(cs.MAIN_SHAPE, generator=gen, device="cuda").to(dtype)
                for _ in range(6)]
        cycle = itertools.cycle(embs)
        out[key] = {
            "forward_ms": cs.graph_ms(lambda: m(batch), reps=9, calls=5),
            "kernel_warm_ms": cs.graph_ms(lambda: dot_interaction_cuda(embs[0])),
            "kernel_cold_ms": cs.graph_ms(lambda: dot_interaction_cuda(next(cycle)), calls=24),
        }
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
