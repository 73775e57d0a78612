"""Port host layer vs the JAX package: CRC32C, the on-disk bytes of written
shards, columnar decode in both directions, and schema inference."""

import os

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord import schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.columnar import ColumnarDecoder as JDecoder  # noqa: E402
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import infer as tinfer, schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.columnar import ColumnarDecoder as TDecoder  # noqa: E402
from tpu_tfrecord_torch.entry import dryrun_rows, dryrun_schema  # noqa: E402
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset  # noqa: E402
from tpu_tfrecord_torch.models.dlrm import DLRMConfig  # noqa: E402
from tpu_tfrecord_torch.options import RecordType as TRT  # noqa: E402

SEQ_CFG = DLRMConfig(num_dense=4, num_categorical=3, vocab_size=8, embed_dim=4,
                     bottom_mlp=(8, 4), top_mlp=(8, 1), seq_len=4, seq_dim=4,
                     interaction="dot")


def _criteo_fields(mod, int_type):
    return (
        [mod.StructField("label", int_type(), nullable=False)]
        + [mod.StructField(f"I{i}", int_type()) for i in range(1, 5)]
        + [mod.StructField(f"C{i}", mod.StringType()) for i in range(1, 4)]
        + [mod.StructField("w", mod.ArrayType(mod.FloatType()))]
    )


def criteo_schemas(int_type="LongType"):
    """(jax schema, port schema) of a small Criteo-like Example schema with
    a ragged float column and nulls."""
    return (
        jschema.StructType(_criteo_fields(jschema, getattr(jschema, int_type))),
        tschema.StructType(_criteo_fields(tschema, getattr(tschema, int_type))),
    )


def criteo_rows(n, seed=0):
    rng = np.random.default_rng(seed)
    for r in range(n):
        row = [int(rng.integers(0, 2))]
        row += [None if rng.random() < 0.1 else int(v)
                for v in rng.integers(-5, 1 << 40, size=4)]
        row += [f"v{int(x)}" for x in rng.integers(0, 50, size=3)]
        row.append([float(x) for x in rng.normal(size=int(rng.integers(0, 4)))])
        yield row


def seq_schemas():
    names = dryrun_schema(SEQ_CFG).json()
    return jschema.StructType.from_json(names), tschema.StructType.from_json(names)


def seq_rows(n, seed=1234):
    return list(dryrun_rows(SEQ_CFG, np.random.default_rng(seed), n, vocab=8))


def part_file(path):
    (name,) = [n for n in os.listdir(path) if n.startswith("part-")]
    return os.path.join(path, name)


class TestCrc:
    @pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 4097])
    def test_crc32c_matches(self, n):
        data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
        assert twire.crc32c(data) == jwire.crc32c_py(data)
        assert twire.masked_crc32c(data) == jwire.masked_crc32c(data)

    def test_crc32c_known_vector(self):
        # RFC 3720 test vector: 32 bytes of zeros
        assert twire.crc32c(bytes(32)) == 0x8A9136AA

    def test_encode_record_matches(self):
        for payload in (b"", b"abc", bytes(range(256)) * 3):
            assert twire.encode_record(payload) == jwire.encode_record(payload)

    def test_corrupt_record_raises(self, tmp_path):
        path = str(tmp_path / "x.tfrecord")
        twire.write_records(path, [b"hello", b"world"])
        raw = bytearray(open(path, "rb").read())
        raw[14] ^= 0xFF
        open(path, "wb").write(bytes(raw))
        with pytest.raises(twire.TFRecordCorruptionError, match="CRC"):
            list(twire.read_records(path))


class TestWrite:
    def test_example_shard_bytes_identical(self, tmp_path):
        js, ts = criteo_schemas()
        rows = list(criteo_rows(40))
        jio.write(rows, js, str(tmp_path / "jax"), mode="overwrite")
        written = tio.write(rows, ts, str(tmp_path / "port"), mode="overwrite")
        assert written == [part_file(str(tmp_path / "port"))]
        assert sorted(os.listdir(tmp_path / "port")) == ["_SUCCESS", os.path.basename(written[0])]
        assert written[0].endswith(".c000.tfrecord")
        with open(part_file(str(tmp_path / "jax")), "rb") as a, open(written[0], "rb") as b:
            assert a.read() == b.read()

    def test_sequence_example_shard_bytes_identical(self, tmp_path):
        js, ts = seq_schemas()
        rows = seq_rows(25)
        jio.write(rows, js, str(tmp_path / "jax"), mode="overwrite",
                  recordType="SequenceExample")
        tio.write(rows, ts, str(tmp_path / "port"), mode="overwrite",
                  recordType="SequenceExample")
        with open(part_file(str(tmp_path / "jax")), "rb") as a, \
                open(part_file(str(tmp_path / "port")), "rb") as b:
            assert a.read() == b.read()

    @pytest.mark.parametrize("codec,ext", [("gzip", ".tfrecord.gz"), ("deflate", ".tfrecord.deflate")])
    def test_codec_round_trip_through_jax_reader(self, tmp_path, codec, ext):
        js, ts = criteo_schemas()
        rows = list(criteo_rows(30, seed=5))
        (path,) = tio.write(rows, ts, str(tmp_path / "port"), codec=codec)
        assert path.endswith(ext)
        recs = list(twire.read_records(path))
        assert recs == list(jwire.read_records(path))
        assert len(recs) == 30
        # same records as the uncompressed write of the same rows
        (plain,) = tio.write(rows, ts, str(tmp_path / "plain"))
        assert recs == list(jwire.read_records(plain))

    def test_save_modes(self, tmp_path):
        _, ts = criteo_schemas()
        out = str(tmp_path / "ds")
        tio.write(list(criteo_rows(3)), ts, out)
        with pytest.raises(FileExistsError):
            tio.write(list(criteo_rows(3)), ts, out)
        assert tio.write(list(criteo_rows(3)), ts, out, mode="ignore") == []
        tio.write(list(criteo_rows(3)), ts, out, mode="append")
        assert len([n for n in os.listdir(out) if n.startswith("part-")]) == 2
        tio.write(list(criteo_rows(3)), ts, out, mode="overwrite")
        assert len([n for n in os.listdir(out) if n.startswith("part-")]) == 1
        assert tio.has_success_marker(out)
        assert not os.path.exists(os.path.join(out, "_temporary"))


def assert_batches_equal(a, b):
    assert a.num_rows == b.num_rows
    assert sorted(a.columns) == sorted(b.columns)
    for name in a.columns:
        ca, cb = a[name], b[name]
        assert ca.hash_buckets == cb.hash_buckets, name
        for attr in ("values", "offsets", "inner_offsets", "blob_offsets", "mask"):
            va, vb = getattr(ca, attr), getattr(cb, attr)
            assert (va is None) == (vb is None), (name, attr)
            if va is not None:
                va, vb = np.asarray(va), np.asarray(vb)
                assert va.dtype == vb.dtype, (name, attr, va.dtype, vb.dtype)
                np.testing.assert_array_equal(va, vb, err_msg=f"{name}.{attr}")
        assert (None if ca.blob is None else bytes(ca.blob)) == (
            None if cb.blob is None else bytes(cb.blob)
        ), name


def _jax_batches(paths, **kw):
    ds = JDataset(paths, **kw)
    with ds.batches() as it:
        return ds, list(it)


def _port_batches(paths, **kw):
    ds = TDataset(paths, **kw)
    with ds.batches() as it:
        return ds, list(it)


class TestReadInterchange:
    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_example_batches_equal(self, tmp_path, writer):
        js, ts = criteo_schemas()
        rows = list(criteo_rows(50, seed=2))
        (jio if writer == "jax" else tio).write(
            rows, js if writer == "jax" else ts, str(tmp_path / "ds")
        )
        _, jb = _jax_batches(str(tmp_path / "ds"), batch_size=16, schema=js,
                             drop_remainder=False)
        _, tb = _port_batches(str(tmp_path / "ds"), batch_size=16, schema=ts,
                              drop_remainder=False)
        assert [b.num_rows for b in tb] == [16, 16, 16, 2]
        for a, b in zip(jb, tb):
            assert_batches_equal(a, b)

    @pytest.mark.parametrize("writer", ["jax", "port"])
    def test_sequence_example_batches_straddle_shards(self, tmp_path, writer):
        js, ts = seq_schemas()
        dirs = []
        for i, n in enumerate([5, 9]):
            d = str(tmp_path / f"shard{i:02d}")
            rows = seq_rows(n, seed=1234 + i)
            if writer == "jax":
                jio.write(rows, js, d, recordType="SequenceExample")
            else:
                tio.write(rows, ts, d, recordType="SequenceExample")
            dirs.append(d)
        _, jb = _jax_batches(dirs, batch_size=4, recordType="SequenceExample")
        _, tb = _port_batches(dirs, batch_size=4, recordType="SequenceExample")
        assert [b.num_rows for b in tb] == [4, 4, 4]   # drop_remainder
        assert len(jb) == len(tb)
        for a, b in zip(jb, tb):
            assert_batches_equal(a, b)

    def test_hashed_packed_batches_equal(self, tmp_path):
        js, ts = criteo_schemas("IntegerType")
        jio.write(list(criteo_rows(40, seed=3)), criteo_schemas()[0], str(tmp_path / "ds"))
        kw = dict(batch_size=8,
                  hash_buckets={f"C{i}": 1 << 20 for i in range(1, 4)},
                  pack={"dense": [f"I{i}" for i in range(1, 5)],
                        "cat": [f"C{i}" for i in range(1, 4)]})
        _, jb = _jax_batches(str(tmp_path / "ds"), schema=js, **kw)
        _, tb = _port_batches(str(tmp_path / "ds"), schema=ts, **kw)
        assert len(jb) == len(tb) == 5
        for a, b in zip(jb, tb):
            for name in ("dense", "cat", "label"):
                assert a[name].values.dtype == b[name].values.dtype
                np.testing.assert_array_equal(a[name].values, b[name].values)

    def test_decoder_matches_on_records(self, tmp_path):
        js, ts = seq_schemas()
        recs_path = str(tmp_path / "r.tfrecord")
        from tpu_tfrecord.options import RecordType as JRT
        from tpu_tfrecord.serde import TFRecordSerializer, encode_row

        ser = TFRecordSerializer(js)
        jwire.write_records(recs_path, (
            encode_row(ser, JRT.SEQUENCE_EXAMPLE, r) for r in seq_rows(11)))
        recs = list(twire.read_records(recs_path))
        assert_batches_equal(
            JDecoder(js, "SequenceExample").decode_batch(recs),
            TDecoder(ts, "SequenceExample").decode_batch(recs),
        )


class TestInference:
    def test_dataset_schema_inferred_equal(self, tmp_path):
        js, ts = seq_schemas()
        tio.write(seq_rows(12), ts, str(tmp_path / "ds"), recordType="SequenceExample")
        want = jio.reader(str(tmp_path / "ds"), recordType="SequenceExample").schema()
        got = TDataset(str(tmp_path / "ds"), batch_size=4, recordType="SequenceExample").schema
        assert got.json() == want.json()
        # inference sorts by name; the types are the written ones
        assert {f.name: f.data_type for f in got} == {f.name: f.data_type for f in ts}

    def test_type_maps_equal(self, tmp_path):
        from tpu_tfrecord import infer as jinfer
        from tpu_tfrecord.options import RecordType as JRT

        _, ts = criteo_schemas()
        (path,) = tio.write(list(criteo_rows(30, seed=9)), ts, str(tmp_path / "ds"))
        recs = list(twire.read_records(path))
        jmap = jinfer.infer_from_records(recs, JRT.EXAMPLE)
        tmap = tinfer.infer_from_records(recs, TRT.EXAMPLE)
        assert jinfer.type_map_to_schema(jmap).json() == tinfer.type_map_to_schema(tmap).json()
        merged_j = jinfer.merge_type_maps(jmap, {"extra": None, "w": None})
        merged_t = tinfer.merge_type_maps(tmap, {"extra": None, "w": None})
        assert (jinfer.type_map_to_schema(merged_j).json()
                == tinfer.type_map_to_schema(merged_t).json())
