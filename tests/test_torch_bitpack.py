"""The port's transfer bit-packing against ``tpu_tfrecord.tpu.bitpack``,
bit for bit: ``pack_bits``, ``pack_mixed`` (the native pass on int32, numpy
on int64) and ``unpack_bits`` (torch ops, on the CPU here) over the grid of
``tests/test_bitpack.py``, its mixed and straddle cases and its argument
errors."""

import jax
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord.tpu import bitpack as jbp  # noqa: E402

from tpu_tfrecord_torch import _native as tnative  # noqa: E402
from tpu_tfrecord_torch.device import bitpack as tbp  # noqa: E402

BITS = [1, 3, 7, 13, 20, 24, 31, 32]
COLS = [1, 2, 26, 40]


def jax_unpack(packed, n_cols, bits):
    return np.asarray(jax.jit(jbp.unpack_bits, static_argnums=(1, 2))(packed, n_cols, bits))


def torch_unpack(packed, n_cols, bits):
    out = tbp.unpack_bits(torch.from_numpy(packed), n_cols, bits)
    assert out.dtype == torch.int32 and out.shape == (packed.shape[0], n_cols)
    return out.numpy()


@pytest.mark.parametrize("bits", BITS)
@pytest.mark.parametrize("n_cols", COLS)
def test_round_trip_matches_jax(bits, n_cols):
    rng = np.random.default_rng(bits * 100 + n_cols)
    vals = rng.integers(0, 1 << bits, size=(64, n_cols)).astype(np.int64)
    packed = tbp.pack_bits(vals, bits)
    want = jbp.pack_bits(vals, bits)
    assert packed.dtype == want.dtype == np.int32
    assert packed.shape == want.shape == (64, tbp.packed_width(n_cols, bits))
    np.testing.assert_array_equal(packed, want)
    got = torch_unpack(packed, n_cols, bits)
    np.testing.assert_array_equal(got, jax_unpack(want, n_cols, bits))
    np.testing.assert_array_equal(got, vals.astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("bits", [5, 20, 27])
def test_all_ones_straddle(bits):
    vals = np.full((8, 33), (1 << bits) - 1, dtype=np.int64)
    packed = tbp.pack_bits(vals, bits)
    np.testing.assert_array_equal(packed, jbp.pack_bits(vals, bits))
    np.testing.assert_array_equal(torch_unpack(packed, 33, bits), vals.astype(np.int32))
    np.testing.assert_array_equal(torch_unpack(packed, 33, bits), jax_unpack(packed, 33, bits))


def test_packed_width_matches_jax():
    for n in range(0, 50):
        for bits in range(1, 33):
            assert tbp.packed_width(n, bits) == jbp.packed_width(n, bits)
    assert tbp.packed_width(26, 20) == 17


def test_bits32_passthrough_values():
    vals = np.array([[0, 1, (1 << 31) - 1]], dtype=np.int64)
    np.testing.assert_array_equal(tbp.pack_bits(vals, 32), jbp.pack_bits(vals, 32))
    np.testing.assert_array_equal(torch_unpack(tbp.pack_bits(vals, 32), 3, 32),
                                  vals.astype(np.int32))
    big = np.array([[3_000_000_000]], dtype=np.int64)
    assert tbp.pack_bits(big, 32)[0, 0] == jbp.pack_bits(big, 32)[0, 0] == (
        np.uint32(3_000_000_000).view(np.int32))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("bits", [1, 7, 20, 31, 32])
@pytest.mark.parametrize("keep,c", [(0, 26), (14, 26), (3, 1), (5, 0)])
def test_pack_mixed_matches_jax(dtype, bits, keep, c, monkeypatch):
    rng = np.random.default_rng(bits + keep)
    arr = np.concatenate(
        [rng.integers(0, 1 << 31, size=(37, keep)),
         rng.integers(0, min(1 << bits, 1 << 31), size=(37, c))],
        axis=1,
    ).astype(dtype)
    native = []
    real = tnative.pack_mixed
    monkeypatch.setattr(tnative, "pack_mixed", lambda *a: (native.append(1), real(*a))[1])
    got = tbp.pack_mixed(arr, keep, bits)
    assert bool(native) == (dtype == np.int32)  # int32 takes the native pass
    want = jbp.pack_mixed(arr, keep, bits)
    assert got.dtype == want.dtype == np.int32
    np.testing.assert_array_equal(got, want)
    if c:
        np.testing.assert_array_equal(torch_unpack(got[:, keep:], c, bits),
                                      jax_unpack(want[:, keep:], c, bits))


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
def test_pack_mixed_rejects_bad_args_like_jax(dtype):
    arr = np.zeros((4, 6), dtype=dtype)
    bad = np.zeros((2, 3), dtype=dtype)
    bad[1, 2] = -1
    cases = [
        ((arr, 7, 20), "keep"),
        ((bad, 1, 20), "non-negative"),
        ((np.zeros(3, dtype=dtype), 0, 20), r"\[B, C\]"),
        ((arr, 1, 0), "bits"),
        ((arr, 1, 33), "bits"),
    ]
    for args, match in cases:
        for mod in (tbp, jbp):
            with pytest.raises(ValueError, match=match):
                mod.pack_mixed(*args)
    ok = np.full((2, 3), -7, dtype=dtype)  # keep lanes pass negatives verbatim
    np.testing.assert_array_equal(tbp.pack_mixed(ok, 3, 20), jbp.pack_mixed(ok, 3, 20))


def test_native_error_names_the_value():
    bad = np.zeros((3, 5), dtype=np.int32)
    bad[2, 4] = -9
    with pytest.raises(ValueError, match=r"found -9 at row 2, column 4"):
        tnative.pack_mixed(bad, 2, 20)


def test_pack_bits_rejects_like_jax():
    for mod in (tbp, jbp):
        with pytest.raises(ValueError, match="non-negative"):
            mod.pack_bits(np.array([[-1, 2]], dtype=np.int64), 20)
        with pytest.raises(ValueError, match="non-negative"):
            mod.pack_bits(np.array([[-5]], dtype=np.int64), 32)
        with pytest.raises(ValueError, match=r"\[B, C\]"):
            mod.pack_bits(np.zeros(5, dtype=np.int32), 20)
        with pytest.raises(ValueError, match="bits"):
            mod.packed_width(4, 0)


def test_bench_wire_layout():
    """label + 13 dense lanes verbatim, 26 cats at 20 bits: the bench's
    [B, 31] wire matrix, split back on the torch side."""
    rng = np.random.default_rng(1)
    full = np.concatenate(
        [rng.integers(0, 2, size=(128, 1)), rng.integers(0, 1 << 31, size=(128, 13)),
         rng.integers(0, 1 << 20, size=(128, 26))], axis=1,
    ).astype(np.int32)
    wire = tbp.pack_mixed(full, 14, 20)
    assert wire.shape == (128, 31)
    np.testing.assert_array_equal(wire, jbp.pack_mixed(full, 14, 20))
    m = torch.from_numpy(wire)
    np.testing.assert_array_equal(m[:, :14].numpy(), full[:, :14])
    np.testing.assert_array_equal(tbp.unpack_bits(m[:, 14:], 26, 20).numpy(), full[:, 14:])
