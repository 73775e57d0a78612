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

from chip_smoke import CHECK_SHAPES  # noqa: E402
from tpu_tfrecord_torch.models.interaction import (  # noqa: E402
    SMEM_BLOCK_MAX,
    _interaction_plan,
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


# The shapes the card is checked at and a few more. The CUDA kernel cannot
# run here; its geometry and index arithmetic are plain Python and integers,
# checked below.
PLAN_SHAPES = CHECK_SHAPES + [(7, 128, 16), (9, 5, 12)]


def epilogue_writes(b, f, plan):
    """How many times the kernel's store loop writes each output, and
    whether each 16-byte store is aligned: its loop over tiles and chunks of
    16 bytes (8 bf16 or 4 f32), replayed with integers."""
    p = f * (f - 1) // 2
    w = 8 if plan.instance == "bf16_mma" else 4
    written = np.zeros(b * p, dtype=np.int64)
    aligned = True
    for t in range(-(-b // plan.tile)):
        n_s = min(plan.tile, b - t * plan.tile)
        e0 = t * plan.tile * p
        phase = e0 & (w - 1)
        n = phase + n_s * p
        for lo in range(0, n, w):
            hi = min(lo + w, n)
            if lo >= phase and hi - lo == w:
                aligned &= (e0 - phase + lo) % w == 0
                written[e0 - phase + lo:e0 - phase + hi] += 1
            else:
                written[e0 - phase + max(lo, phase):e0 - phase + hi] += 1
    return written, aligned


def block_row(blk):
    """The f32 kernel's ``block_row``: R with R(R+1)/2 <= blk < (R+1)(R+2)/2
    from a float32 square root (IEEE, as sqrtf), then one correction each
    way."""
    r = int((np.sqrt(np.float32(8 * blk + 1)) - np.float32(1)) * np.float32(0.5))
    if (r + 1) * (r + 2) // 2 <= blk:
        r += 1
    if r * (r + 1) // 2 > blk:
        r -= 1
    return r


def replay_tiled_kernel(emb, plan):
    """The f32 kernel on E [b, f, d] (numpy f32) with ``plan``: each block of
    the persistent grid stages its tiles into a zeroed [tile][sample]
    buffer, each item (4x4 block, sample) sums its 16 pairs in f32 over the
    padded columns, and the pairs c < r < f leave through the staged span."""
    b, f, d = emb.shape
    p = f * (f - 1) // 2
    fp, stride, tile = plan.fp, plan.stride, plan.tile
    sample = fp * stride + 4
    nb = fp // 4
    n_items = tile * nb * (nb + 1) // 2
    out = np.full(b * p, np.nan, dtype=np.float32)
    for blk_id in range(plan.grid):
        buf = np.zeros(tile * sample, dtype=np.float32)
        for t in range(blk_id, -(-b // tile), plan.grid):
            n_s = min(tile, b - t * tile)
            for s in range(n_s):  # rows < f, columns < d of each sample
                for j in range(f * d):
                    buf[s * sample + j + (j // d) * (stride - d)] = emb[t * tile + s].reshape(-1)[j]
            e0 = t * tile * p
            phase = e0 & 3
            stg = np.full(4 + tile * p, np.nan, dtype=np.float32)
            for it in range(n_items):
                blk, s = divmod(it, tile)
                if s >= n_s:
                    continue
                big_r = block_row(blk)
                big_c = blk - big_r * (big_r + 1) // 2
                smp = buf[s * sample:s * sample + fp * stride].reshape(fp, stride)
                acc = smp[4 * big_r:4 * big_r + 4] @ smp[4 * big_c:4 * big_c + 4].T
                for i in range(4):
                    r = 4 * big_r + i
                    for jj in range(4):
                        c = 4 * big_c + jj
                        if c < r < f:
                            stg[phase + s * p + r * (r - 1) // 2 + c] = acc[i, jj]
            n = phase + n_s * p
            out[e0 - phase + phase:e0 - phase + n] = stg[phase:n]
    return out.reshape(b, p)


class TestKernelPlan:
    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_bf16_plan(self, shape):
        b, f, d = shape
        p = f * (f - 1) // 2
        plan = _interaction_plan(b, f, d, torch.bfloat16)
        assert plan.instance == "bf16_mma"
        assert plan.fp % 16 == 0 and f <= plan.fp < f + 16
        assert plan.dp % 16 == 0 and d <= plan.dp < d + 16
        # 16 bytes of row pad: a row is an odd number of 16-byte chunks, so
        # the 8 rows of one ldmatrix fall in 8 different bank groups
        assert plan.stride == plan.dp + 8 and (plan.stride * 2 // 16) % 2 == 1
        assert {(r * plan.stride * 2 // 16) % 8 for r in range(8)} == set(range(8))
        # two tiles of rows and one of outputs fit, as the C entry checks
        assert 2 * (2 * plan.tile * plan.fp * plan.stride + 8 + plan.tile * p) <= plan.smem
        assert plan.smem <= SMEM_BLOCK_MAX and plan.smem % 16 == 0
        assert 1 <= plan.tile <= 32 and 1 <= plan.grid <= -(-b // plan.tile)
        assert plan.grid <= 132 * 4
        assert plan.vec_loads == (d % 8 == 0)

    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_f32_plan(self, shape):
        b, f, d = shape
        p = f * (f - 1) // 2
        plan = _interaction_plan(b, f, d, torch.float32)
        assert plan.instance == "f32_tiled"
        assert plan.fp % 4 == 0 and f <= plan.fp < f + 4
        assert plan.dp % 4 == 0 and d <= plan.dp < d + 4 and plan.stride == plan.dp
        # two tiles of rows and one of outputs fit, as the C entry checks
        sample = plan.fp * plan.stride + 4
        assert 4 * (2 * plan.tile * sample + 4 + plan.tile * p) <= plan.smem
        assert plan.smem <= SMEM_BLOCK_MAX and plan.smem % 16 == 0
        assert 1 <= plan.tile <= 32 and 1 <= plan.grid <= -(-b // plan.tile)
        assert plan.grid <= 132 * 3  # persistent: at most 3 blocks per SM
        # a tile is the largest multiple of 8 samples (8 to 32) that gives
        # each of the 256 threads at most one 4x4 block, or fewer samples
        # where one more would not fit in shared memory
        nb = plan.fp // 4
        want = max(8, min(32, 256 // (nb * (nb + 1) // 2) // 8 * 8))
        assert plan.tile == want or (plan.tile < want and 4 * (
            2 * (plan.tile + 1) * sample + 4 + (plan.tile + 1) * p) > SMEM_BLOCK_MAX)
        assert plan.vec_loads == (d % 4 == 0)

    def test_main_path_geometry(self):
        # 4 samples (6.9 KB of E) a tile, 4 blocks on each of the 132 SMs
        plan = _interaction_plan(16384, 27, 32, torch.bfloat16)
        assert (plan.fp, plan.dp, plan.stride, plan.tile, plan.grid) == (32, 32, 40, 4, 528)
        # two row buffers, then 8 + 4 * 351 outputs rounded up to 16 bytes
        assert plan.smem == 2 * 4 * 32 * 40 * 2 + 1416 * 2 == 23312
        assert _interaction_plan(16384, 27, 32, torch.bfloat16, sms=100).grid == 400

    def test_f32_main_path_geometry(self):
        # 8 samples (27.6 KB of E) a tile, 3 blocks on each of the 132 SMs
        plan = _interaction_plan(16384, 27, 32, torch.float32)
        assert (plan.fp, plan.dp, plan.stride, plan.tile, plan.grid) == (28, 32, 32, 8, 396)
        # two row buffers of 8 samples of 28 x 32 + 4 floats, then 4 + 8 * 351 outputs
        assert plan.smem == (2 * 8 * 900 + 2812) * 4 == 68848
        assert plan.vec_loads

    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_f32_epilogue_stores_every_output_once(self, shape):
        b, f, d = shape
        b = min(b, 67)  # a ragged last tile at every tile size
        written, aligned = epilogue_writes(b, f, _interaction_plan(b, f, d, torch.float32))
        assert aligned and (written == 1).all()

    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_f32_sample_stride_is_conflict_free(self, shape):
        # a float4 read of a quarter-warp (8 threads) is conflict-free when
        # its 8 16-byte chunks lie in 8 different bank groups (of 8). Items
        # are numbered sample-fastest, so with tile % 8 == 0 the 8 threads
        # take one 4x4 block of 8 consecutive samples and read the same row
        # and column of each: the sample stride, an odd number of chunks,
        # spreads them
        b, f, d = shape
        plan = _interaction_plan(b, f, d, torch.float32)
        sample = plan.fp * plan.stride + 4
        assert sample % 4 == 0 and (sample // 4) % 2 == 1
        for row in range(plan.fp):
            for col in range(0, plan.dp, 4):
                groups = {((s * sample + row * plan.stride + col) // 4) % 8 for s in range(8)}
                assert len(groups) == 8
        nb = plan.fp // 4
        n_items = plan.tile * nb * (nb + 1) // 2
        if plan.tile % 8 == 0:
            for q in range(0, 256, 8):
                items = [it for it in range(q, q + 8) if it < n_items]
                assert len({it // plan.tile for it in items}) <= 1
                assert [it % plan.tile for it in items] == list(range(q % plan.tile,
                                                                       q % plan.tile + len(items)))

    @pytest.mark.parametrize("f", range(2, 129))
    def test_f32_blocks_cover_pairs_once(self, f):
        # block blk -> (R, C) by the kernel's float32 triangular root and its
        # two corrections; the 4x4 blocks keep each pair c < r < f once
        fp = -(-f // 4) * 4
        nb = fp // 4
        cover = np.zeros((fp, fp), dtype=np.int64)
        for blk in range(nb * (nb + 1) // 2):
            big_r = block_row(blk)
            c = blk - big_r * (big_r + 1) // 2
            assert 0 <= c <= big_r < nb
            cover[4 * big_r:4 * big_r + 4, 4 * c:4 * c + 4] += 1
        r, c = np.tril_indices(f, k=-1)
        assert (cover <= 1).all() and (cover[r, c] == 1).all()
        if f == 27:
            assert nb * (nb + 1) // 2 == 28

    @pytest.mark.parametrize("d", [4, 8, 12, 24, 32, 64, 128])
    def test_f32_vector_staging_offsets(self, d):
        # with d % 4 == 0 the stride is d and chunk j of a sample (4 floats)
        # lands at j * 4: row j // (d / 4), column (j % (d / 4)) * 4, aligned
        f = 27
        plan = _interaction_plan(64, f, d, torch.float32)
        assert plan.vec_loads and plan.stride == d
        sample = plan.fp * plan.stride + 4
        for s in range(plan.tile):
            for j in range(f * d // 4):
                off = s * sample + j * 4
                row, col = divmod(j * 4, d)
                assert off == s * sample + row * plan.stride + col and off % 4 == 0

    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_f32_kernel_replay_matches_plain_version(self, shape):
        # the whole f32 kernel replayed with numpy: staging into the padded
        # layout, every block's items over tiles and the persistent grid, the
        # 4x4 register blocks in f32, the pair index, the staged store
        b, f, d = shape
        b = min(b, 37)
        emb = make_emb(b, f, d, seed=7)
        got = replay_tiled_kernel(emb, _interaction_plan(b, f, d, torch.float32))
        want = dot_interaction_reference(torch.from_numpy(emb)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("shape", PLAN_SHAPES)
    def test_epilogue_stores_every_output_once(self, shape):
        b, f, d = shape
        b = min(b, 67)  # a ragged last tile at every tile size
        written, aligned = epilogue_writes(b, f, _interaction_plan(b, f, d, torch.bfloat16))
        assert aligned and (written == 1).all()

    @pytest.mark.parametrize("d", [8, 16, 24, 32, 64, 128])
    def test_vector_staging_offsets(self, d):
        # chunk j of a sample (8 bf16) lands at row f = j // cpr, column
        # (j - f * cpr) * 8 of the padded layout, 16-byte aligned
        f = 27
        plan = _interaction_plan(64, f, d, torch.bfloat16)
        cpr = d // 8
        for j in range(f * cpr):
            row = j // cpr
            off = j * 8 + row * (plan.stride - d)
            assert off == row * plan.stride + (j - row * cpr) * 8 and off % 8 == 0

    @pytest.mark.parametrize("f", range(2, 129))
    def test_pair_arithmetic_matches_tril(self, f):
        # p = r(r-1)/2 + c is the kernel's pair index; the 16x8 Gram tiles it
        # computes (strip mt, column tile nt < n_nt) cover each pair once
        r, c = np.tril_indices(f, k=-1)
        np.testing.assert_array_equal(r * (r - 1) // 2 + c, np.arange(f * (f - 1) // 2))
        fp = -(-f // 16) * 16
        cover = np.zeros((fp, fp), dtype=np.int64)
        n_tiles = 0
        for mt in range(fp // 16):
            n_nt = (min(16 * mt + 15, f - 1) - 1) // 8 + 1
            for nt in range(n_nt):
                assert 8 * nt + 8 <= fp
                cover[16 * mt:16 * mt + 16, 8 * nt:8 * nt + 8] += 1
                n_tiles += 1
        assert (cover <= 1).all() and (cover[r, c] == 1).all()
        if f == 27:
            assert n_tiles == 6

    @pytest.mark.parametrize("shape,dtype,match", [
        ((2, 4, 136), torch.bfloat16, "D <= 128"),
        ((2, 400, 64), torch.bfloat16, "shared memory"),
        ((1, 1024, 64), torch.float32, "shared memory"),
        ((0, 27, 32), torch.bfloat16, "B >= 1"),
        ((4, 1, 32), torch.float32, "F >= 2"),
        ((4, 27, 32), torch.float16, "bf16 or f32"),
    ])
    def test_plan_refuses(self, shape, dtype, match):
        with pytest.raises(ValueError, match=match):
            _interaction_plan(*shape, dtype)
