"""The port's ``LMStream`` against the JAX ``LMStream`` on the same weights
(the [n_layers, ...] tree moved through ``interop``) and the same numpy
requests, at (S, V) in {(1, 1), (2, 1), (2, 2), (4, 1)}: how many logits
pop at each submit, the logits at rtol = atol = 1e-5, tags FIFO, and the
port's streamed logits bitwise equal to its ``batch_reference``. Also the
chunk re-stack against the JAX ``_stage_stack`` and the MoE refusal."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tfrecord.models import lm as jlm
from tpu_tfrecord.tpu import create_mesh
from tpu_tfrecord_torch import interop
from tpu_tfrecord_torch.models import lm as tlm

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
KW = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=4, max_len=12)
MB = 4


def models(n_virtual, seed=0):
    jcfg = jlm.LMConfig(dtype=jnp.float32, n_virtual=n_virtual, **KW)
    tcfg = tlm.LMConfig(dtype=torch.float32, n_virtual=n_virtual, **KW)
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(seed), jcfg))
    return jcfg, tcfg, jp, interop.lm_params_from_jax(jp, tcfg, device="cpu")


def requests(n, seed=0):
    cfg = tlm.LMConfig(**KW)
    return [tlm.make_synthetic_tokens(cfg, MB, seed=seed + i) for i in range(n)]


def run(stream, reqs):
    outs, pops = [], []
    for i, r in enumerate(reqs):
        got = stream.submit_tagged(r, ("req", i))
        pops.append(len(got))
        outs += got
    return outs + stream.flush_tagged(), pops


@pytest.mark.parametrize("n_stages,n_virtual", [(1, 1), (2, 1), (2, 2), (4, 1)])
def test_stream_matches_jax_lm_stream(n_stages, n_virtual):
    jcfg, tcfg, jp, tp = models(n_virtual)
    reqs = requests(6, seed=n_stages * 10 + n_virtual)
    mesh = create_mesh({"pipe": n_stages}, jax.devices()[:n_stages])
    jouts, jpops = run(jlm.LMStream(jp, jcfg, mesh), reqs)
    stream = tlm.LMStream(tp, tcfg, n_stages, device="cpu")
    touts, tpops = run(stream, reqs)
    assert tpops == jpops
    assert [t for _, t in touts] == [t for _, t in jouts] == [("req", i) for i in range(6)]
    for (a, _), (b, _) in zip(touts, jouts):
        assert isinstance(a, np.ndarray) and a.dtype == np.float32
        assert a.shape == (MB, KW["max_len"], KW["vocab_size"])
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    ref = stream.batch_reference(reqs)
    for (a, _), b in zip(touts, ref):
        np.testing.assert_array_equal(a, b)
    # and both equal the dense forward of the same weights
    dense, _ = tlm.forward(tp, torch.from_numpy(reqs[0]), tlm.LMConfig(**KW))
    np.testing.assert_allclose(touts[0][0], dense.numpy(), **TOL)


def test_reset_and_untagged_submit_replay():
    _, tcfg, _, tp = models(2)
    stream = tlm.LMStream(tp, tcfg, 2, device="cpu")
    reqs = requests(5, seed=3)
    first = [o for r in reqs for o in stream.submit(r)] + stream.flush()
    stream.reset()
    tagged, _ = run(stream, reqs)
    assert len(first) == len(tagged) == 5
    for a, (b, _) in zip(first, tagged):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_stages,n_virtual", [(1, 1), (2, 1), (2, 2), (1, 4)])
def test_stage_stack_matches_jax(n_stages, n_virtual):
    jcfg, tcfg, jp, tp = models(n_virtual)
    want = jlm._stage_stack(jp["blocks"], jcfg, n_stages)
    got = tlm._stage_stack(tp["blocks"], tcfg, n_stages)
    for name in want:
        for leaf in ("w", "b"):
            np.testing.assert_array_equal(got[name][leaf].numpy(), np.asarray(want[name][leaf]))


def test_layer_count_must_divide_into_chunks():
    _, tcfg, _, tp = models(1)
    with pytest.raises(ValueError, match="must divide"):
        tlm.LMStream(tp, dataclasses.replace(tcfg, n_virtual=3), 1, device="cpu")
    with pytest.raises(ValueError, match="must divide"):
        tlm.LMStream(tp, tcfg, 3, device="cpu")


def test_moe_refused_as_in_jax():
    jcfg, tcfg, jp, tp = models(1)
    mesh = create_mesh({"pipe": 1}, jax.devices()[:1])
    with pytest.raises(ValueError, match="moe_experts > 0 is not supported"):
        jlm.LMStream(jp, dataclasses.replace(jcfg, moe_experts=4), mesh)
    with pytest.raises(ValueError, match="moe_experts > 0 is not supported"):
        tlm.LMStream(tp, dataclasses.replace(tcfg, moe_experts=4), 1, device="cpu")


def test_numpy_weights_serve_like_tensors():
    """The stream takes the trainer's tree as numpy arrays too (the JAX
    example's host params)."""
    _, tcfg, jp, tp = models(1)
    reqs = requests(3, seed=8)
    a, _ = run(tlm.LMStream(jp, tcfg, 1, device="cpu"), reqs)
    b, _ = run(tlm.LMStream(tp, tcfg, 1, device="cpu"), reqs)
    for (x, _), (y, _) in zip(a, b):
        np.testing.assert_array_equal(x, y)
