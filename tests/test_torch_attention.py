"""The port's dense attention (``tpu_tfrecord_torch.models.attention``)
against the JAX ``attention_reference`` on the same numpy inputs: causal
and not, ``lengths`` (zero included), ``segments``, MHA, GQA and MQA, in
float32 (``atol=1e-6, rtol=1e-5``) and bf16 (``atol=1e-2, rtol=8e-3``),
with no NaN anywhere."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tfrecord.models import attention as jatt

from tpu_tfrecord_torch.models import attention as tatt
from tpu_tfrecord_torch.options import OptionNotPortedError

B, L, H, D = 3, 12, 4, 8
TOL = {torch.float32: dict(atol=1e-6, rtol=1e-5), torch.bfloat16: dict(atol=1e-2, rtol=8e-3)}
JDT = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}


def inputs(hkv, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, L, H, D)).astype(np.float32)
    k = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    v = rng.normal(size=(B, L, hkv, D)).astype(np.float32)
    lengths = np.array([L, 5, 0], np.int32)
    # two packed documents and a padding tail per row
    segments = np.zeros((B, L), np.int32)
    segments[:, :4], segments[:, 4:9] = 1, 2
    segments[1, :] = 1
    return q, k, v, lengths, segments


def run_both(q, k, v, dtype, **kw):
    tkw = {n: torch.from_numpy(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    jkw = {n: jnp.asarray(a) if isinstance(a, np.ndarray) else a for n, a in kw.items()}
    got = tatt.attention_reference(*(torch.from_numpy(a).to(dtype) for a in (q, k, v)), **tkw)
    want = jatt.attention_reference(*(jnp.asarray(a, JDT[dtype]) for a in (q, k, v)), **jkw)
    assert got.dtype == dtype and got.shape == (B, L, H, D)
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("hkv", [4, 2, 1], ids=["mha", "gqa", "mqa"])
@pytest.mark.parametrize("mask", ["none", "lengths", "causal", "segments", "causal_segments_lengths"])
def test_matches_jax(dtype, hkv, mask):
    q, k, v, lengths, segments = inputs(hkv)
    kw = {}
    if "lengths" in mask:
        kw["lengths"] = lengths
    if "causal" in mask:
        kw["causal"] = True
    if "segments" in mask:
        kw["segments"] = segments
    got, want = run_both(q, k, v, dtype, **kw)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TOL[dtype])


def test_zero_length_row_is_uniform_not_nan():
    q, k, v, lengths, _ = inputs(4)
    got, _ = run_both(q, k, v, torch.float32, lengths=lengths)
    # every key masked: equal weights over all keys, the mean of v
    np.testing.assert_allclose(got[2], np.broadcast_to(v[2].mean(axis=0), (L, H, D)),
                               atol=1e-6, rtol=1e-5)


def test_expand_kv_repeats_each_head_in_place():
    q = torch.zeros(1, 2, 4, 3)
    kv = torch.arange(2 * 2 * 3, dtype=torch.float32).reshape(1, 2, 2, 3)
    got = tatt._expand_kv(q, kv).numpy()
    want = np.asarray(jatt._expand_kv(jnp.zeros((1, 2, 4, 3)), jnp.asarray(kv.numpy())))
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="GQA"):
        tatt._expand_kv(torch.zeros(1, 2, 4, 3), torch.zeros(1, 2, 3, 3))


def test_explicit_scale():
    q, k, v, lengths, _ = inputs(2)
    got, want = run_both(q, k, v, torch.float32, scale=0.3, causal=True)
    np.testing.assert_allclose(got, want, **TOL[torch.float32])


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_flavours_raise(fn):
    with pytest.raises(OptionNotPortedError, match="torch.distributed"):
        getattr(tatt, fn)()
