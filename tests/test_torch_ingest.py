"""Port host batches vs the JAX package's ``host_batch_from_columnar``:
exactly equal arrays on the Criteo read schema (hashed + packed) and on the
dryrun SequenceExample schema (padded frames), and the device copy."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord import schema as jschema  # noqa: E402
from tpu_tfrecord.columnar import ColumnarDecoder as JDecoder  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402
from tpu_tfrecord.tpu.ingest import host_batch_from_columnar as j_hbfc  # noqa: E402

from tpu_tfrecord_torch import schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.columnar import ColumnarDecoder as TDecoder  # noqa: E402
from tpu_tfrecord_torch.device.ingest import (  # noqa: E402
    hash_bytes_column,
    host_batch_from_columnar as t_hbfc,
    make_device_batch,
)
from tpu_tfrecord_torch.entry import write_dryrun_dataset  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.models.dlrm import DLRMConfig  # noqa: E402

N_DENSE, N_CAT = 13, 26
BUCKETS = 1 << 20


def criteo_schemas(mod, int_type):
    return mod.StructType(
        [mod.StructField("label", int_type(), nullable=False)]
        + [mod.StructField(f"I{i}", int_type()) for i in range(1, N_DENSE + 1)]
        + [mod.StructField(f"C{i}", mod.StringType()) for i in range(1, N_CAT + 1)]
    )


def write_criteo(path, n, seed=0):
    """bench.py-style Criteo rows through the JAX writer (LongType ints)."""
    rng = np.random.default_rng(seed)
    ints = rng.integers(0, 1 << 31, size=(n, N_DENSE))
    labels = rng.integers(0, 2, size=n)
    cats = rng.integers(0, 16, size=(n, N_CAT, 8), dtype=np.uint8) + 97
    rows = [
        [int(labels[r])] + [int(v) for v in ints[r]]
        + [cats[r, c].tobytes().decode() for c in range(N_CAT)]
        for r in range(n)
    ]
    jio.write(rows, criteo_schemas(jschema, jschema.LongType), path)


HASH = {f"C{i}": BUCKETS for i in range(1, N_CAT + 1)}
PACK = {"dense": [f"I{i}" for i in range(1, N_DENSE + 1)],
        "cat": [f"C{i}" for i in range(1, N_CAT + 1)]}


def assert_host_batches_equal(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
        assert a[k].shape == b[k].shape, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _first_batches(ds, n):
    with ds.batches() as it:
        return [next(it) for _ in range(n)]


class TestCriteo:
    def test_hashed_packed_host_batch_exact(self, tmp_path):
        write_criteo(str(tmp_path / "ds"), 96)
        js = criteo_schemas(jschema, jschema.IntegerType)
        ts = criteo_schemas(tschema, tschema.IntegerType)
        jds = JDataset(str(tmp_path / "ds"), batch_size=32, schema=js,
                       hash_buckets=HASH, pack=PACK)
        tds = TDataset(str(tmp_path / "ds"), batch_size=32, schema=ts,
                       hash_buckets=HASH, pack=PACK)
        for jb, tb in zip(_first_batches(jds, 3), _first_batches(tds, 3)):
            want = j_hbfc(jb, jds.schema, hash_buckets=HASH, pack=PACK)
            got = t_hbfc(tb, tds.schema, hash_buckets=HASH, pack=PACK)
            assert_host_batches_equal(want, got)
            assert got["dense"].shape == (32, N_DENSE) and got["cat"].dtype == np.int32

    def test_unfused_decode_then_hash_exact(self, tmp_path):
        """Hashing and packing at host-batch time (no decode fusion) on the
        same records: the JAX pure-Python path against the port."""
        write_criteo(str(tmp_path / "ds"), 40, seed=1)
        (part,) = [os.path.join(tmp_path, "ds", n) for n in os.listdir(tmp_path / "ds")
                   if n.startswith("part-")]
        recs = list(twire.read_records(part))
        js = criteo_schemas(jschema, jschema.IntegerType)
        ts = criteo_schemas(tschema, tschema.IntegerType)
        want = j_hbfc(JDecoder(js).decode_batch(recs), js, hash_buckets=HASH, pack=PACK)
        got = t_hbfc(TDecoder(ts).decode_batch(recs), ts, hash_buckets=HASH, pack=PACK)
        assert_host_batches_equal(want, got)

    def test_hash_bytes_column_matches(self):
        from tpu_tfrecord.tpu.ingest import hash_bytes_column as j_hash

        blobs = [b"", b"a", b"tok123", bytes(range(40))]
        for buckets in (1, 7, BUCKETS):
            np.testing.assert_array_equal(hash_bytes_column(blobs, buckets), j_hash(blobs, buckets))


class TestSequenceExample:
    CFG = DLRMConfig(num_dense=4, num_categorical=3, vocab_size=8, embed_dim=4,
                     bottom_mlp=(8, 4), top_mlp=(8, 1), seq_len=4, seq_dim=4,
                     interaction="dot")

    @pytest.mark.parametrize("pad_to", [(4, 4), (2, 3)])
    def test_dryrun_host_batch_exact(self, tmp_path, pad_to):
        write_dryrun_dataset(str(tmp_path), self.CFG, [5, 11], vocab=8)
        dirs = sorted(str(tmp_path / d) for d in os.listdir(tmp_path))
        hb = {f"c{i}": 8 for i in range(1, 4)}
        pack = {"dense": [f"d{i}" for i in range(1, 5)], "cat": [f"c{i}" for i in range(1, 4)]}
        kw = dict(batch_size=4, recordType="SequenceExample", hash_buckets=hb, pack=pack)
        jds, tds = JDataset(dirs, **kw), TDataset(dirs, **kw)
        assert tds.schema.json() == jds.schema.json()
        for jb, tb in zip(_first_batches(jds, 4), _first_batches(tds, 4)):
            want = j_hbfc(jb, jds.schema, pad_to={"frames": pad_to}, hash_buckets=hb, pack=pack)
            got = t_hbfc(tb, tds.schema, pad_to={"frames": pad_to}, hash_buckets=hb, pack=pack)
            assert_host_batches_equal(want, got)
            assert got["frames"].shape == (4,) + pad_to
            assert set(got) == {"label", "dense", "cat", "frames", "frames_len",
                                "frames_inner_len"}

    def test_ragged_column_needs_pad_to(self, tmp_path):
        write_dryrun_dataset(str(tmp_path), self.CFG, [3], vocab=8)
        tds = TDataset(str(tmp_path / "shard00"), batch_size=3, recordType="SequenceExample")
        (tb,) = _first_batches(tds, 1)
        with pytest.raises(KeyError):
            t_hbfc(tb, tds.schema)


class TestDeviceBatch:
    def test_cpu_copy_keeps_values_and_dtypes(self):
        host = {"dense": np.arange(12, dtype=np.float32).reshape(3, 4),
                "cat": np.arange(6, dtype=np.int32).reshape(3, 2),
                "label": np.array([0, 1, 1], dtype=np.int32)}
        dev = make_device_batch(host, "cpu")
        for k, v in host.items():
            assert dev[k].device.type == "cpu"
            np.testing.assert_array_equal(dev[k].numpy(), v)
            assert dev[k].dtype == torch.from_numpy(v).dtype
