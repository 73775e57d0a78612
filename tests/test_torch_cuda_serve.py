"""LM serving on a card at small widths: ``LMStream``'s streamed logits
bitwise equal to its batch path at (S, V) = (1, 2) and (2, 2), the card
within 1e-4 of the CPU, and the continuous-batching engine's tokens equal
to ``sequential_reference`` on the card. Every test needs a CUDA device and
skips without one. The file imports torch and the port only:

    python -m pytest tests/test_torch_cuda_serve.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_tfrecord_torch.metrics import Metrics  # noqa: E402
from tpu_tfrecord_torch.models import lm  # noqa: E402
from tpu_tfrecord_torch.serving import ServePolicy, ServingEngine, sequential_reference  # noqa: E402

pytestmark = pytest.mark.cuda

KW = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=4, max_len=16)
MB = 4


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's side of LM serving")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def params():
    return lm.init_params(lm.LMConfig(**KW), torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("n_stages,n_virtual", [(1, 2), (2, 2)])
def test_stream_bitwise_equals_batch_path_on_the_card(cuda_device, n_stages, n_virtual):
    cfg = lm.LMConfig(n_virtual=n_virtual, **KW)
    p = params()
    reqs = [lm.make_synthetic_tokens(cfg, MB, seed=i) for i in range(6)]
    stream = lm.LMStream(p, cfg, n_stages, device=cuda_device)
    got = [o for r in reqs for o in stream.submit(r)] + stream.flush()
    assert len(got) == 6 and all(isinstance(o, np.ndarray) for o in got)
    for a, b in zip(got, stream.batch_reference(reqs)):
        np.testing.assert_array_equal(a, b)
    cpu = lm.LMStream(p, cfg, n_stages, device="cpu")
    want = [o for r in reqs for o in cpu.submit(r)] + cpu.flush()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_engine_tokens_equal_sequential_reference_on_the_card(cuda_device):
    cfg = lm.LMConfig(**KW)
    p = params()
    rng = np.random.default_rng(0)
    reqs = [(rng.integers(1, 96, size=16).astype(np.int32), 1 + i % 4) for i in range(7)]
    eng = ServingEngine(p, cfg, 2, policy=ServePolicy(mb=MB, max_queue=32), metrics=Metrics(),
                        device=cuda_device)
    try:
        handles = [eng.submit(w, n) for w, n in reqs]
        eng.run_until_idle()
        got = [h.result(timeout=0) for h in handles]
    finally:
        eng.stop()
    assert got == sequential_reference(p, cfg, 2, reqs, MB, device=cuda_device)
