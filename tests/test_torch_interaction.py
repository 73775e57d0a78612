"""Port dot interaction vs the JAX package: the plain version against
``dot_interaction_pallas`` (interpret mode) and ``dot_interaction_reference``
on the CPU. The CUDA kernel's own tests are in ``test_torch_cuda.py``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord.models.interaction import (  # noqa: E402
    dot_interaction_pallas,
    dot_interaction_reference as j_ref,
)

from tpu_tfrecord_torch.models.interaction import (  # noqa: E402
    dot_interaction,
    dot_interaction_cuda,
    dot_interaction_reference,
    tril_pairs,
)

F32 = dict(rtol=1e-5, atol=1e-5)
BF16 = dict(rtol=1e-2, atol=1e-2)


def make_emb(b, f, d, seed=0):
    return np.random.default_rng(seed).normal(size=(b, f, d)).astype(np.float32)


def as_f32(x):
    return np.asarray(jnp.asarray(x, dtype=jnp.float32))


class TestPlainVersion:
    @pytest.mark.parametrize("b,f,d", [(32, 27, 16), (16, 4, 8), (64, 13, 32), (32, 27, 32)])
    def test_matches_pallas_and_reference_f32(self, b, f, d):
        emb = make_emb(b, f, d)
        got = dot_interaction_reference(torch.from_numpy(emb)).numpy()
        assert got.shape == (b, f * (f - 1) // 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, np.asarray(j_ref(jnp.asarray(emb))), **F32)
        block_b = 16 if b % 16 == 0 else 8
        pallas = dot_interaction_pallas(jnp.asarray(emb), block_b=block_b, interpret=True)
        np.testing.assert_allclose(got, np.asarray(pallas), **F32)

    def test_bf16_matches_pallas(self):
        emb = make_emb(32, 27, 16)
        got = dot_interaction_reference(torch.from_numpy(emb).bfloat16())
        assert got.dtype == torch.bfloat16
        want = dot_interaction_pallas(jnp.asarray(emb, dtype=jnp.bfloat16), block_b=32,
                                      interpret=True)
        assert want.dtype == jnp.bfloat16
        np.testing.assert_allclose(got.float().numpy(), as_f32(want), **BF16)

    def test_large_f(self):
        emb = make_emb(16, 64, 8)
        got = dot_interaction_reference(torch.from_numpy(emb)).numpy()
        want = dot_interaction_pallas(jnp.asarray(emb), block_b=8, block_p=512, interpret=True)
        assert got.shape == (16, 64 * 63 // 2)
        np.testing.assert_allclose(got, np.asarray(want), **F32)

    def test_prime_batch_against_jax_reference(self):
        # the TPU kernel refuses B=13 (no tile >= 8 divides it); the port does not
        emb = make_emb(13, 27, 32)
        got = dot_interaction_reference(torch.from_numpy(emb)).numpy()
        np.testing.assert_allclose(got, np.asarray(j_ref(jnp.asarray(emb))), **F32)

    def test_pair_order_is_tril(self):
        rows, cols = tril_pairs(5)
        r, c = np.tril_indices(5, k=-1)
        np.testing.assert_array_equal(rows.numpy(), r)
        np.testing.assert_array_equal(cols.numpy(), c)
        assert list(zip(rows.tolist()[:4], cols.tolist()[:4])) == [(1, 0), (2, 0), (2, 1), (3, 0)]

    def test_pairs_are_the_dots(self):
        emb = make_emb(2, 4, 3)
        got = dot_interaction_reference(torch.from_numpy(emb)).numpy()
        r, c = np.tril_indices(4, k=-1)
        want = np.stack([[emb[b, i] @ emb[b, j] for i, j in zip(r, c)] for b in range(2)])
        np.testing.assert_allclose(got, want, rtol=1e-6)


class TestDispatch:
    def test_cpu_tensor_uses_plain_version_and_does_not_count(self):
        emb = torch.from_numpy(make_emb(8, 5, 4))
        before = dot_interaction.launches
        torch.testing.assert_close(dot_interaction(emb), dot_interaction_reference(emb),
                                   rtol=0, atol=0)
        assert dot_interaction.launches == before

    def test_kernel_wrapper_refuses_cpu_tensor(self):
        with pytest.raises(ValueError, match="CUDA tensor"):
            dot_interaction_cuda(torch.zeros(2, 3, 4))
