"""The port's CUDA kernel and its users on a card, against their plain
PyTorch versions. Every test here needs a CUDA device and skips without
one. The file imports torch and the port only, so it also runs where jax is
not installed:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import os
import sys

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from tpu_tfrecord_torch.device.ingest import (  # noqa: E402
    DeviceIterator,
    StagingRing,
    make_device_batch,
)
from tpu_tfrecord_torch.entry import score_files, write_dryrun_dataset  # noqa: E402
from tpu_tfrecord_torch.models.dlrm import (  # noqa: E402
    DLRMConfig,
    init_params,
    make_synthetic_batch,
    sparse_opt_init,
    sparse_train_step,
    train_step,
)
from tpu_tfrecord_torch.models.interaction import (  # noqa: E402
    DotInteraction,
    _interaction_plan,
    dot_interaction,
    dot_interaction_cuda,
    dot_interaction_reference,
)
from chip_smoke import CHECK_SHAPES, staging_race_check  # noqa: E402  the main path's shape and the design's edges

pytestmark = pytest.mark.cuda

SMALL = dict(num_dense=4, num_categorical=3, vocab_size=8, embed_dim=8,
             bottom_mlp=(8, 8), top_mlp=(8, 1), seq_len=4, seq_dim=4, interaction="dot")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the interaction kernel runs only on the card")
    return torch.device("cuda")


# f32: sums in another order than the einsum; bf16: one bf16 ulp
TOL = {torch.float32: dict(rtol=1e-5, atol=1e-4), torch.bfloat16: dict(rtol=8e-3, atol=1e-2)}
INSTANCE = {torch.float32: "f32_tiled", torch.bfloat16: "bf16_mma"}


@pytest.mark.parametrize("shape", CHECK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_matches_plain_version(cuda_device, shape, dtype):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    emb = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    before = dot_interaction.launches
    before_instance = dot_interaction.instance_launches[INSTANCE[dtype]]
    got = dot_interaction(emb)
    torch.cuda.synchronize()
    assert dot_interaction.launches == before + 1
    assert dot_interaction.instance_launches[INSTANCE[dtype]] == before_instance + 1
    want = dot_interaction_reference(emb)
    assert got.dtype == dtype and got.shape == want.shape
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_bf16_kernel_takes_a_misaligned_e(cuda_device):
    # a base that is not 16-byte aligned is staged with scalar loads
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    flat = torch.randn(13 * 27 * 32 + 1, generator=gen, device=cuda_device).bfloat16()
    emb = flat[1:].view(13, 27, 32)
    assert emb.is_contiguous() and emb.data_ptr() % 16 != 0
    got = dot_interaction_cuda(emb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), dot_interaction_reference(emb).float(),
                               **TOL[torch.bfloat16])


def test_f32_kernel_takes_a_misaligned_e(cuda_device):
    # a base 4 bytes past 16-byte alignment is staged with scalar loads
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    flat = torch.randn(13 * 27 * 32 + 1, generator=gen, device=cuda_device)
    emb = flat[1:].view(13, 27, 32)
    assert emb.is_contiguous() and emb.data_ptr() % 16 == 4
    before = dot_interaction.instance_launches["f32_tiled"]
    got = dot_interaction_cuda(emb)
    torch.cuda.synchronize()
    assert dot_interaction.instance_launches["f32_tiled"] == before + 1
    torch.testing.assert_close(got, dot_interaction_reference(emb), **TOL[torch.float32])


def test_f32_kernel_stages_rows_of_odd_width(cuda_device):
    # D % 4 != 0: rows are not whole 16-byte chunks, scalar staging into
    # columns padded to 8
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    emb = torch.randn((21, 27, 7), generator=gen, device=cuda_device)
    plan = _interaction_plan(21, 27, 7, torch.float32)
    assert not plan.vec_loads and plan.dp == 8
    got = dot_interaction_cuda(emb)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, dot_interaction_reference(emb), **TOL[torch.float32])


def test_f32_kernel_refuses_a_sample_over_shared_memory(cuda_device):
    # one sample of (1024, 64) f32 is 256 KB, over a block's shared memory:
    # the plan raises before any launch, and nothing falls back
    before = dict(dot_interaction.instance_launches)
    with pytest.raises(ValueError, match="shared memory"):
        dot_interaction_cuda(torch.zeros(1, 1024, 64, device=cuda_device))
    assert dot_interaction.instance_launches == before


def test_kernel_refuses_what_it_does_not_take(cuda_device):
    emb = torch.randn(4, 32, 6, device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        dot_interaction_cuda(emb.transpose(1, 2))
    with pytest.raises(TypeError, match="bf16 or f32"):
        dot_interaction_cuda(emb.half())
    with pytest.raises(ValueError, match=r"\[B, F, D\]"):
        dot_interaction_cuda(emb[0])
    # shapes the plan refuses raise before any launch; never the plain version
    before = dot_interaction.launches
    with pytest.raises(ValueError, match="D <= 128"):
        dot_interaction_cuda(torch.zeros(2, 4, 136, device=cuda_device, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="shared memory"):
        dot_interaction_cuda(torch.zeros(2, 400, 64, device=cuda_device, dtype=torch.bfloat16))
    assert dot_interaction.launches == before


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
def test_dlrm_forward_card_matches_cpu(cuda_device, dtype, tol):
    cfg = DLRMConfig(dtype=dtype, **SMALL)
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(1), cuda_device)
    host = make_synthetic_batch(cfg, 37, seed=3)
    before = dot_interaction.launches
    got = model(make_device_batch(host, cuda_device)).cpu()
    assert dot_interaction.launches == before + 1
    want = model.to("cpu")(make_device_batch(host, "cpu"))
    torch.testing.assert_close(got, want, rtol=tol, atol=tol)


def test_score_files_on_card_launches_once_per_batch(cuda_device, tmp_path):
    cfg = DLRMConfig(dtype=torch.float32, **SMALL)
    write_dryrun_dataset(str(tmp_path), cfg, [6, 14], vocab=8)
    model = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(0), cuda_device)
    before = dot_interaction.launches
    res = score_files(str(tmp_path), cfg, model, 8, cuda_device)
    assert dot_interaction.launches - before == res.batches == 2
    want = score_files(str(tmp_path), cfg, model.to("cpu"), 8, "cpu")
    assert res.logits.device.type == "cuda"
    np.testing.assert_allclose(res.logits.cpu().numpy(), want.logits.numpy(), rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("shape", CHECK_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_forward_is_differentiable(cuda_device, shape, dtype):
    """On a CUDA E that requires grad the kernel's output carries a
    grad_fn, and E gets the plain version's gradient: without it the pairs
    would train as constants."""
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    base = torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
    g = torch.randn((shape[0], shape[1] * (shape[1] - 1) // 2), generator=gen,
                    device=cuda_device).to(dtype)
    emb = base.clone().requires_grad_()
    before = dot_interaction.instance_launches[INSTANCE[dtype]]
    out = dot_interaction(emb)
    assert isinstance(out.grad_fn, DotInteraction._backward_cls)
    assert dot_interaction.instance_launches[INSTANCE[dtype]] == before + 1
    out.backward(g)
    assert dot_interaction.instance_launches[INSTANCE[dtype]] == before + 1  # forward only
    ref = base.clone().requires_grad_()
    dot_interaction_reference(ref).backward(g)
    torch.testing.assert_close(emb.grad.float(), ref.grad.float(), **TOL[dtype])


TRAIN = dict(num_dense=4, num_categorical=3, vocab_size=16, embed_dim=8,
             bottom_mlp=(8, 8), top_mlp=(8, 1), interaction="dot", dtype=torch.float32)


@pytest.mark.parametrize("sparse", [True, False], ids=["sparse", "dense"])
def test_train_steps_card_match_cpu(cuda_device, sparse):
    cfg = DLRMConfig(**TRAIN)
    card = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(4), cuda_device)
    cpu = init_params(cfg, torch.Generator(device=cuda_device).manual_seed(4), cuda_device).to("cpu")
    host = make_synthetic_batch(cfg, 37, seed=5)
    host["cat"] = np.random.default_rng(6).integers(0, 5, size=host["cat"].shape)  # duplicates
    adam = lambda ps: torch.optim.Adam(ps, lr=1e-2)  # noqa: E731
    states = [sparse_opt_init(m, cfg, adam) if sparse else adam(list(m.parameters()))
              for m in (card, cpu)]
    before = dot_interaction.launches
    for _ in range(3):
        losses = []
        for model, state, device in ((card, states[0], cuda_device), (cpu, states[1], "cpu")):
            batch = make_device_batch(host, device)
            step = (sparse_train_step(model, state, batch, cfg) if sparse
                    else train_step(model, state, batch))
            losses.append(step.cpu())
        torch.testing.assert_close(losses[0], losses[1], rtol=1e-4, atol=1e-5)
    assert dot_interaction.launches == before + 3
    for (name, a), (_, b) in zip(card.state_dict().items(), cpu.state_dict().items()):
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5, msg=name)
    if sparse:
        torch.testing.assert_close(states[0].accum.cpu(), states[1].accum, rtol=1e-4, atol=1e-7)


# -- the feed --------------------------------------------------------------------


@pytest.mark.parametrize("transfer_thread", [False, True], ids=["dispatch_ahead", "thread"])
def test_staging_race_check(cuda_device, transfer_thread):
    """chip_smoke's check: 64 distinct batches through DeviceIterator(depth=2)
    while the consumer spins the card on each; every digest matches."""
    staging_race_check(transfer_thread)


@pytest.mark.parametrize("transfer_thread", [False, True], ids=["dispatch_ahead", "thread"])
def test_device_iterator_batches_equal_make_device_batch(cuda_device, transfer_thread):
    rng = np.random.default_rng(0)
    hosts = [{"dense": rng.normal(size=(33, 13)).astype(np.float32),
              "cat": rng.integers(0, 1 << 20, size=(33, 26)).astype(np.int32)[:, ::2],
              "label": rng.integers(0, 2, size=33).astype(np.float32)} for _ in range(7)]
    with DeviceIterator(iter(hosts), cuda_device, transfer_thread=transfer_thread) as it:
        got = list(it)
        assert it.transfer_seconds > 0
    assert len(got) == len(hosts)
    for g, h in zip(got, hosts):
        want = make_device_batch(h, cuda_device)
        for k in want:
            assert g[k].device.type == "cuda" and torch.equal(g[k], want[k]), k


def test_staging_ring_reuses_pinned_slots(cuda_device):
    ring = StagingRing(3)
    host = {"x": np.arange(1000, dtype=np.float32), "y": np.arange(6, dtype=np.int64)}
    ptrs = []
    for i in range(7):
        slot, pinned = ring.stage(host)
        assert slot == i % 3
        assert all(t.is_pinned() for t in pinned.values())
        assert np.array_equal(pinned["x"].numpy(), host["x"])
        event = torch.cuda.Event()
        event.record()
        ring.done(slot, event)
        ptrs.append(pinned["x"].data_ptr())
    assert ptrs[:3] == ptrs[3:6] and ptrs[6] == ptrs[0] and len(set(ptrs[:3])) == 3


def _reuses_freed_block(cuda_device):
    """Whether the next batch's copy lands in the block of a batch the
    consumer dropped while its work on that batch was still queued."""
    host = {"x": np.arange(1 << 20, dtype=np.int32)}
    it = DeviceIterator(iter([host] * 3), cuda_device, depth=2)
    first = next(it)  # also issues the second batch's copy
    freed = first["x"].data_ptr()
    torch.cuda._sleep(50_000_000)  # the consumer's queued work on the first batch
    total = first["x"].sum()
    del first
    next(it)  # issues the third batch's copy into a new allocation
    reused = it._pending[0]["x"].data_ptr() == freed
    torch.cuda.synchronize()
    del total
    return reused


def test_record_stream_keeps_a_dropped_batch_from_reuse(cuda_device, monkeypatch):
    """With record_stream the allocator does not hand a dropped batch's block
    to the next copy while the consumer's work on it is queued; without it,
    it does (the hazard the mark guards against)."""
    assert not _reuses_freed_block(cuda_device)
    monkeypatch.setattr(torch.Tensor, "record_stream", lambda self, stream: None)
    assert _reuses_freed_block(cuda_device)
