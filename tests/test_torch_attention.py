"""The port's dense attention (``tpu_tfrecord_torch.models.attention``)
against the JAX ``attention_reference`` on the same numpy inputs: causal
and not, ``lengths`` (zero included), ``segments``, MHA, GQA and MQA, in
float32 (``atol=1e-6, rtol=1e-5``) and bf16 (``atol=1e-2, rtol=8e-3``),
with no NaN anywhere; the sequence-parallel flavours' argument checks
against JAX's."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tfrecord.models import attention as jatt

from tpu_tfrecord_torch.models import attention as tatt

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


class _SeqMesh:
    """A stand-in for a ``DeviceMesh`` with a 'seq' axis of 2: enough for
    the argument checks, which raise before any collective."""

    mesh_dim_names = ("seq",)

    def size(self, dim: int) -> int:
        return 2


BAD_CALLS = {  # flavour -> (q, k, v shapes, kwargs) that JAX refuses on a seq axis of 2
    "ring_attention": [((1, 8, 4, 2), (1, 8, 4, 2), dict(zigzag=True)),
                       ((1, 6, 4, 2), (1, 6, 4, 2), dict(zigzag=True, causal=True))],
    "ulysses_attention": [((1, 8, 3, 2), (1, 8, 3, 2), {}),
                          ((1, 8, 4, 2), (1, 8, 1, 2), {})],
}


@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_flavours_raise(fn):
    """Both flavours are ported (held to JAX over gloo ranks in
    ``test_torch_sp_attention.py``); a call JAX refuses on a seq axis of 2
    raises the same ``ValueError`` here, before any exchange: zigzag
    without causal and a length not divisible by 2p for the ring, a head
    count the axis does not divide for Ulysses."""
    import jax
    from jax.sharding import Mesh

    jmesh = Mesh(np.array(jax.devices()[:2]), ("seq",))
    for qs, kvs, kw in BAD_CALLS[fn]:
        with pytest.raises(ValueError) as jerr:
            getattr(jatt, fn)(jnp.zeros(qs), jnp.zeros(kvs), jnp.zeros(kvs), jmesh, **kw)
        # the port takes this rank's chunk: half the sequence
        local = lambda shape: torch.zeros(shape[0], shape[1] // 2, *shape[2:])  # noqa: E731
        with pytest.raises(ValueError) as terr:
            getattr(tatt, fn)(local(qs), local(kvs), local(kvs), _SeqMesh(), **kw)
        assert str(terr.value) == str(jerr.value)
