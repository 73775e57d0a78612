"""The sequence-model path of the port on a card, against the CPU: a host
batch holding a CPU bf16 tensor (a column cast to ``torch.bfloat16``)
through the staging ring, and the LM and long_doc train steps card against
CPU at small widths. Every test needs a CUDA device and skips without one.
The file imports torch and the port only, so it also runs where jax is not
installed:

    python -m pytest tests/test_torch_cuda_seq.py --noconftest -q
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_tfrecord_torch.checkpoint import tree_flatten, tree_unflatten  # noqa: E402
from tpu_tfrecord_torch.device.ingest import DeviceIterator, make_device_batch  # noqa: E402
from tpu_tfrecord_torch.models import lm, long_doc, optim  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's side of the sequence models")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def on(tree, device):
    leaves, treedef = tree_flatten(tree)
    return tree_unflatten(treedef, [t.detach().to(device).clone() for t in leaves])


@pytest.mark.parametrize("transfer_thread", [False, True], ids=["dispatch_ahead", "thread"])
def test_bf16_host_tensors_reach_the_card_bit_equal(cuda_device, transfer_thread):
    rng = np.random.default_rng(1)
    hosts = [{"frames": torch.from_numpy(rng.normal(size=(5, 7, 3)).astype(np.float32)).to(torch.bfloat16),
              "frames_len": rng.integers(0, 8, size=5).astype(np.int32)} for _ in range(4)]
    with DeviceIterator(iter(hosts), cuda_device, transfer_thread=transfer_thread) as it:
        got = list(it)
    assert len(got) == len(hosts)
    for g, h in zip(got, hosts):
        assert g["frames"].dtype == torch.bfloat16 and g["frames"].is_cuda
        assert torch.equal(g["frames"].cpu().view(torch.int16), h["frames"].view(torch.int16))
        assert torch.equal(g["frames_len"].cpu(), torch.from_numpy(h["frames_len"]))
        assert torch.equal(make_device_batch(h, cuda_device)["frames"], g["frames"])


@pytest.mark.parametrize("with_segments", [False, True], ids=["slice", "segments"])
def test_lm_steps_card_match_cpu(cuda_device, with_segments):
    cfg = lm.LMConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2, max_len=16)
    host = lm.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    card = on(host, cuda_device)
    opts = {"cpu": optim.adam(host, 3e-3), "cuda": optim.adam(card, 3e-3)}
    segs = None
    if with_segments:
        segs = torch.ones(4, 17, dtype=torch.int32)
        segs[:, 9:] = 2
        segs[:, 15:] = 0
    for i in range(4):
        toks = torch.from_numpy(lm.make_synthetic_tokens(cfg, 4, seed=i))
        want = lm.train_step(host, opts["cpu"], toks, cfg, segments=segs)
        got = lm.train_step(card, opts["cuda"], toks.to(cuda_device), cfg,
                            segments=None if segs is None else segs.to(cuda_device))
        np.testing.assert_allclose(float(got), float(want), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_long_doc_logits_card_match_cpu(cuda_device, dtype, tol):
    cfg = dataclasses.replace(long_doc.LongDocConfig(seq_dim=8, d_model=16, max_len=12,
                                                     n_kv_heads=2), dtype=dtype)
    host = long_doc.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = {k: torch.from_numpy(v) for k, v in long_doc.make_synthetic_batch(cfg, 6).items()}
    with torch.no_grad():
        want = long_doc.forward(host, batch, cfg)
        got = long_doc.forward(on(host, cuda_device),
                               {k: v.to(cuda_device) for k, v in batch.items()}, cfg)
    assert got.dtype == torch.float32
    assert float((got.cpu() - want).abs().max()) <= tol
