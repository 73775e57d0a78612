"""The port's native library (``tpu_tfrecord_torch/_native.py`` over its own
copy of ``tfrecord_native.cc``) against the JAX package's
``tpu_tfrecord._native`` and against the port's pure-Python oracles: CRC32C,
frame scanning, batch decode (Example and SequenceExample, fused hashing and
packing, ragged and ragged² columns, the edge cases the JAX native tests
pin) and the fused ragged pads. The records are made from a numpy seed and
written to shard files once per module; both packages read the same bytes.
Every comparison is bit-exact."""

import gc

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import _native as jnative, schema as jschema, wire as jwire  # noqa: E402
from tpu_tfrecord.proto import (  # noqa: E402
    Example,
    Feature,
    FeatureList,
    SequenceExample,
    encode_example,
    encode_sequence_example,
)
from tpu_tfrecord.serde import NullValueError as JNullValueError  # noqa: E402

from tpu_tfrecord_torch import _native as tnative, schema as tschema, wire as twire  # noqa: E402
from tpu_tfrecord_torch.columnar import (  # noqa: E402
    ColumnarDecoder as TDecoder,
    pad_ragged,
    pad_ragged2,
)
from tpu_tfrecord_torch.serde import NullValueError as TNullValueError  # noqa: E402


def schemas(spec):
    """(jax schema, port schema) from [(name, type maker, nullable)]; a
    type maker maps a schema module to a DataType."""
    return tuple(
        mod.StructType([mod.StructField(n, t(mod), nullable) for n, t, nullable in spec])
        for mod in (jschema, tschema)
    )


def arr(elem):
    return lambda m: m.ArrayType(elem(m))


def arr2(elem):
    return lambda m: m.ArrayType(m.ArrayType(elem(m)))


INT, LONG, FLOAT, DOUBLE = (lambda m: m.IntegerType()), (lambda m: m.LongType()), \
    (lambda m: m.FloatType()), (lambda m: m.DoubleType())
STR, BIN = (lambda m: m.StringType()), (lambda m: m.BinaryType())

EXAMPLE_SPEC = [
    ("i", INT, True), ("l", LONG, True), ("f", FLOAT, True), ("d", DOUBLE, True),
    ("s", STR, True), ("b", BIN, True), ("fv", arr(FLOAT), True),
    ("lv", arr(LONG), True), ("sv", arr(STR), True),
]
SEQ_SPEC = [
    ("label", LONG, False), ("ctx", arr(FLOAT), True), ("tags", arr(STR), True),
    ("frames", arr2(FLOAT), True), ("ids", arr2(LONG), True), ("words", arr2(STR), True),
    ("steps", arr(LONG), True),
]
CRITEO_SPEC = (
    [("label", INT, False)]
    + [(f"I{i}", INT, True) for i in range(4)]
    + [(f"C{i}", STR, True) for i in range(3)]
    + [("tags", arr(STR), True)]
)
CRITEO_HASH = {"C0": 97, "C1": 1 << 20, "C2": 5, "tags": 31}
CRITEO_PACK = {"dense": [f"I{i}" for i in range(4)], "cat": [f"C{i}" for i in range(3)]}


def example_records(n, seed=0):
    """Every Example column kind, with missing features, empty lists,
    int32-overflowing ints and features the schema does not ask for."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        feats = {}
        if k % 7 != 3:
            feats["i"] = Feature.int64_list([int(rng.integers(-(2**33), 2**33))])
            feats["l"] = Feature.int64_list([int(rng.integers(-(2**62), 2**62))])
        feats["f"] = Feature.float_list([float(rng.normal())])
        feats["d"] = Feature.float_list([float(rng.normal())])
        feats["s"] = Feature.bytes_list([f"str-{k}-é".encode("utf-8")])
        feats["b"] = Feature.bytes_list([bytes(rng.integers(0, 256, size=k % 5, dtype=np.uint8))])
        feats["fv"] = Feature.float_list(rng.normal(size=k % 4).tolist())
        feats["lv"] = Feature.int64_list(rng.integers(0, 100, size=(k * 3) % 7).tolist())
        feats["sv"] = Feature.bytes_list([f"t{j}".encode() for j in range(k % 3)])
        feats["extra_unrequested"] = Feature.int64_list([1, 2, 3])
        out.append(encode_example(Example(features=feats)))
    return out


def sequence_records(n, seed=1):
    """Context features and feature lists of every layout, with empty and
    missing lists."""
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        ctx = {"label": Feature.int64_list([k % 2]),
               "ctx": Feature.float_list(rng.normal(size=k % 3).tolist())}
        if k % 4:
            ctx["tags"] = Feature.bytes_list([f"g{int(v)}".encode()
                                              for v in rng.integers(0, 9, size=k % 4)])
        fl = {
            "frames": FeatureList([Feature.float_list(rng.normal(size=int(m)).tolist())
                                   for m in rng.integers(0, 5, size=k % 5)]),
            "ids": FeatureList([Feature.int64_list(rng.integers(-5, 1 << 40, size=int(m)).tolist())
                                for m in rng.integers(1, 4, size=(k + 1) % 4)]),
            "words": FeatureList([Feature.bytes_list([f"w{j}".encode() for j in range(int(m))])
                                  for m in rng.integers(0, 3, size=k % 3)]),
            "steps": FeatureList([Feature.int64_list([int(v)])
                                  for v in rng.integers(0, 50, size=k % 6)]),
        }
        if k % 5 == 2:
            del fl["words"]
        out.append(encode_sequence_example(SequenceExample(context=ctx, feature_lists=fl)))
    return out


def criteo_records(n, seed=2):
    rng = np.random.default_rng(seed)
    out = []
    for k in range(n):
        feats = {"label": Feature.int64_list([k % 2])}
        for i in range(4):
            if (k + i) % 9 != 5:  # some missing: a group reads 0 there
                feats[f"I{i}"] = Feature.int64_list([int(rng.integers(0, 1 << 40))])
        for i in range(3):
            if (k + i) % 11 != 4:
                feats[f"C{i}"] = Feature.bytes_list([f"c{int(rng.integers(0, 50))}".encode()])
        feats["tags"] = Feature.bytes_list(
            [f"tag{int(v)}".encode() for v in rng.integers(0, 50, size=k % 5)]
        )
        out.append(encode_example(Example(features=feats)))
    return out


@pytest.fixture(scope="module")
def shards(tmp_path_factory):
    """{name: (file bytes, records)} of one shard per record kind, written
    once through the JAX writer; both packages read these bytes."""
    d = tmp_path_factory.mktemp("native_shards")
    out = {}
    for name, recs in (("example", example_records(90)), ("sequence", sequence_records(60)),
                       ("criteo", criteo_records(120))):
        path = str(d / f"{name}.tfrecord")
        jwire.write_records(path, recs)
        with open(path, "rb") as fh:
            out[name] = (fh.read(), recs)
    return out


def assert_batches_equal(a, b):
    """Bit-exact: values, offsets, inner offsets, masks, blobs, blob offsets
    and group matrices, with their dtypes."""
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
                assert va.dtype == vb.dtype and va.shape == vb.shape, (name, attr)
                assert np.array_equal(va, vb, equal_nan=True), f"{name}.{attr}"
        assert (None if ca.blob is None else bytes(ca.blob)) == (
            None if cb.blob is None else bytes(cb.blob)
        ), name


# ---------------------------------------------------------------------------
# CRC32C and scan
# ---------------------------------------------------------------------------


class TestCrcAndScan:
    @pytest.mark.parametrize("n", [0, 1, 7, 8, 9, 63, 1000, 4097, 65537])
    def test_crc32c_native_equals_jax_and_oracle(self, n):
        data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8).tobytes()
        want = twire.crc32c_py(data)
        assert want == jwire.crc32c_py(data) == jnative.crc32c(data)
        assert tnative.crc32c(data) == want and twire.crc32c(data) == want

    def test_crc32c_check_values(self):
        assert twire.crc32c(b"123456789") == twire.crc32c_py(b"123456789") == 0xE3069283
        # the Python oracle continues a CRC across pieces
        assert twire.crc32c_py(b"6789", twire.crc32c_py(b"12345")) == 0xE3069283

    @pytest.mark.parametrize("kind", ["example", "sequence", "criteo"])
    def test_scan_equals_jax_and_python_framing(self, shards, kind, tmp_path):
        buf, recs = shards[kind]
        offsets, lengths = tnative.scan(buf)
        jo, jl = jnative.scan(buf)
        assert offsets.dtype == jo.dtype == np.uint64
        assert np.array_equal(offsets, jo) and np.array_equal(lengths, jl)
        assert [buf[o:o + n] for o, n in zip(offsets.tolist(), lengths.tolist())] == recs
        path = tmp_path / "s.tfrecord"
        path.write_bytes(buf)
        assert list(twire.read_records(str(path))) == recs

    @pytest.mark.parametrize("cut", [0, 5, 12, 16, 40, 1000, -3, -1])
    def test_scan_partial_tail_equals_jax(self, shards, cut):
        buf = shards["example"][0]
        part = buf[:cut] if cut >= 0 else buf[:len(buf) + cut]
        got, want = tnative.scan_partial(part), jnative.scan_partial(part)
        assert np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])
        assert got[2] == want[2]

    @pytest.mark.parametrize("damage,match", [
        ("length_crc", "bad length CRC"), ("length", "length CRC"),
        ("data", "bad data CRC"), ("data_crc", "bad data CRC"), ("truncate", "truncated"),
    ])
    def test_corrupt_frames_raise_like_jax_and_oracle(self, damage, match, tmp_path):
        good = [b"first", b"payload-2", b"third"]
        buf = bytearray(b"".join(jwire.encode_record(r) for r in good))
        second = len(jwire.encode_record(good[0]))
        if damage == "truncate":
            buf = buf[:-2]
        else:
            pos = {"length": 0, "length_crc": 9, "data": 13, "data_crc": 12 + 9 + 2}[damage]
            buf[second + pos] ^= 0x55
        buf = bytes(buf)
        with pytest.raises(twire.TFRecordCorruptionError, match=match):
            tnative.scan(buf)
        with pytest.raises(jwire.TFRecordCorruptionError, match=match):
            jnative.scan(buf)
        path = tmp_path / "bad.tfrecord"
        path.write_bytes(buf)
        with pytest.raises(twire.TFRecordCorruptionError):
            list(twire.read_records(str(path)))
        if damage in ("data", "data_crc"):  # framing holds without CRC checks
            got, want = tnative.scan(buf, verify_crc=False), jnative.scan(buf, verify_crc=False)
            assert np.array_equal(got[0], want[0]) and len(got[0]) == 3


# ---------------------------------------------------------------------------
# Batch decode
# ---------------------------------------------------------------------------


DECODE_CASES = {
    "example": ("example", EXAMPLE_SPEC, "Example", None, None),
    "sequence": ("sequence", SEQ_SPEC, "SequenceExample", None, None),
    "criteo_hashed_packed": ("criteo", CRITEO_SPEC, "Example", CRITEO_HASH, CRITEO_PACK),
    "criteo_hashed": ("criteo", CRITEO_SPEC, "Example", CRITEO_HASH, None),
    "sequence_hashed_ragged": ("sequence", SEQ_SPEC, "SequenceExample",
                               {"tags": 13}, None),
}


class TestDecode:
    @pytest.mark.parametrize("case", sorted(DECODE_CASES))
    def test_decode_spans_equals_jax(self, shards, case):
        kind, spec, rt, hb, pack = DECODE_CASES[case]
        buf, _ = shards[kind]
        js, ts = schemas(spec)
        offsets, lengths = tnative.scan(buf)
        got = tnative.NativeDecoder(ts, rt, hb, pack).decode_spans(buf, offsets, lengths)
        want = jnative.NativeDecoder(js, rt, hb, pack).decode_spans(buf, offsets, lengths)
        assert_batches_equal(got, want)

    @pytest.mark.parametrize("case", sorted(DECODE_CASES))
    @pytest.mark.parametrize("chunk", [7, 1000])
    def test_scan_decode_chunks_equal_jax(self, shards, case, chunk):
        kind, spec, rt, hb, pack = DECODE_CASES[case]
        buf, recs = shards[kind]
        js, ts = schemas(spec)
        tdec = tnative.NativeDecoder(ts, rt, hb, pack)
        jdec = jnative.NativeDecoder(js, rt, hb, pack)
        view = np.frombuffer(buf, np.uint8)
        pos = jpos = 0
        rows = 0
        while True:
            got = tdec.scan_decode(view, pos, True, 0, chunk, length=len(buf))
            want = jdec.scan_decode(view, jpos, True, 0, chunk, length=len(buf))
            assert got[1:] == want[1:]
            if got[2] == 0:
                assert got[0] is None and want[0] is None and got[3] == len(buf)
                break
            assert_batches_equal(got[0], want[0])
            rows += got[2]
            pos, jpos = got[3], want[3]
        assert rows == len(recs)

    @pytest.mark.parametrize("kind,spec,rt", [
        ("example", EXAMPLE_SPEC, "Example"),
        ("sequence", SEQ_SPEC, "SequenceExample"),
        ("criteo", CRITEO_SPEC, "Example"),
    ])
    def test_native_equals_python_oracle(self, shards, kind, spec, rt):
        _, recs = shards[kind]
        _, ts = schemas(spec)
        assert_batches_equal(tnative.NativeDecoder(ts, rt).decode_batch(recs),
                             TDecoder(ts, rt).decode_batch(recs))

    def test_fused_hash_equals_python_hash_of_oracle(self, shards):
        """Fused hashing and packing against the Python decoder, hashed by
        the pure-Python CRC and stacked by numpy."""
        _, recs = shards["criteo"]
        _, ts = schemas(CRITEO_SPEC)
        got = tnative.NativeDecoder(ts, "Example", CRITEO_HASH, CRITEO_PACK).decode_batch(recs)
        plain = TDecoder(ts, "Example").decode_batch(recs)

        def py_hash(col, buckets):
            return np.array([twire.crc32c_py(b) % buckets for b in col.blobs], np.int32)

        cat = np.stack([py_hash(plain[f"C{i}"], CRITEO_HASH[f"C{i}"]) for i in range(3)], axis=1)
        assert got["cat"].values.dtype == np.int32 and np.array_equal(got["cat"].values, cat)
        dense = np.stack([plain[f"I{i}"].values for i in range(4)], axis=1)
        assert np.array_equal(got["dense"].values, dense)
        assert np.array_equal(got["tags"].values, py_hash(plain["tags"], 31))
        assert np.array_equal(got["tags"].offsets, plain["tags"].offsets)
        assert got["tags"].blob is None and got["tags"].hash_buckets == 31

    def test_group_views_outlive_decoder_and_free_with_last_view(self, shards):
        buf, _ = shards["criteo"]
        _, ts = schemas(CRITEO_SPEC)
        dec = tnative.NativeDecoder(ts, "Example", CRITEO_HASH, CRITEO_PACK)
        batch = dec.decode_spans(buf, *tnative.scan(buf))
        dense = batch["dense"].values
        want = dense.copy()
        owner = dense
        while not isinstance(owner, tnative._NativeResult):
            base = getattr(owner, "base", None)
            owner = base if base is not None else getattr(owner, "_owner", None)
            assert owner is not None, "the result owner is not on the base chain"
        del dec, batch, owner
        gc.collect()
        assert np.array_equal(dense, want)
        tensor = torch.from_numpy(dense)
        del dense
        gc.collect()
        assert np.array_equal(tensor.numpy(), want)


def _one(spec, feats_list, rt="Example"):
    js, ts = schemas(spec)
    if rt == "Example":
        recs = [encode_example(Example(features=f)) for f in feats_list]
    else:
        recs = [encode_sequence_example(se) for se in feats_list]
    return js, ts, recs


def _dup_key_example():
    def entry(value_varint):
        int64_list = bytes([0x0A, 0x01, value_varint])
        feature = bytes([0x1A, len(int64_list)]) + int64_list
        e = bytes([0x0A, 1, ord("x"), 0x12, len(feature)]) + feature
        return bytes([0x0A, len(e)]) + e

    payload = entry(5) + entry(9)  # two map entries, same key: the last wins
    return [bytes([0x0A, len(payload)]) + payload]


def _dup_featurelist(ragged2):
    def int64_feature(vals):
        il = bytes([0x0A, len(vals)] + list(vals))
        return bytes([0x1A, len(il)]) + il

    def fl_entry(frames):
        feats = b"".join(bytes([0x0A, len(int64_feature(f))]) + int64_feature(f)
                         for f in frames)
        e = bytes([0x0A, 1, ord("x"), 0x12, len(feats)]) + feats
        return bytes([0x0A, len(e)]) + e

    first, last = ([[1, 2], [3]], [[7]]) if ragged2 else ([[5], [6]], [[9]])
    payload = fl_entry(first) + fl_entry(last)
    return [bytes([0x12, len(payload)]) + payload]


def _dup_key_missing_last():
    def entry(payload_feature):
        e = bytes([0x0A, 1, ord("a"), 0x12, len(payload_feature)]) + payload_feature
        return bytes([0x0A, len(e)]) + e

    int64_list = bytes([0x0A, 0x01, 7])
    features = entry(bytes([0x1A, len(int64_list)]) + int64_list) + entry(b"")
    return [bytes([0x0A, len(features)]) + features]


# name -> (spec, records, record type, hash_buckets, pack, expected column values)
EDGE_CASES = {
    "int32_truncation": (
        [("x", INT, True)],
        [encode_example(Example(features={"x": Feature.int64_list([2**31 + 10, 1])}))],
        "Example", None, None, {"x": [-(2**31) + 10]},
    ),
    "duplicate_key_last_wins": (
        [("x", LONG, True)], _dup_key_example(), "Example", None, None, {"x": [9]},
    ),
    "duplicate_featurelist_key_last_wins": (
        [("x", arr(LONG), True)], _dup_featurelist(False), "SequenceExample",
        None, None, {"x": [9]},
    ),
    "duplicate_featurelist_key_last_wins_ragged2": (
        [("x", arr2(LONG), True)], _dup_featurelist(True), "SequenceExample",
        None, None, {"x": [7]},
    ),
    "duplicate_key_missing_last_grouped": (
        [("a", LONG, True), ("b", LONG, True)], _dup_key_missing_last(), "Example",
        None, {"g": ["a", "b"]}, {"g": [[0, 0]]},
    ),
    "empty_bytes_lists_fused_hash": (
        [("c", STR, True)],
        [encode_example(Example(features={"c": Feature.bytes_list([b"x"])})),
         encode_example(Example(features={"c": Feature(1, [])})),
         encode_example(Example(features={"c": Feature.bytes_list([b"y"])})),
         encode_example(Example())],
        "Example", {"c": 97}, None,
        {"c": [twire.crc32c_py(b"x") % 97, twire.crc32c_py(b"") % 97,
               twire.crc32c_py(b"y") % 97, 0]},
    ),
    "missing_grouped_field_reads_zero": (
        [("a", LONG, True), ("b", LONG, True)],
        [encode_example(Example(features={"a": Feature.int64_list([7])}))],
        "Example", None, {"g": ["a", "b"]}, {"g": [[7, 0]]},
    ),
    "multi_hot_fused_hash": (
        [("tags", arr(STR), True), ("x", LONG, True)],
        [encode_example(Example(features={"tags": Feature.bytes_list(tags),
                                          "x": Feature.int64_list([k])}))
         for k, tags in enumerate([[b"a", b"b"], [], [b"c"], [b"a", b"b", b"c", b"d", b"e"]])],
        "Example", {"tags": 64}, None,
        {"tags": [twire.crc32c_py(t) % 64 for t in (b"a", b"b", b"c", b"a", b"b", b"c",
                                                      b"d", b"e")]},
    ),
    "empty_bytes_scalar": (
        [("s", STR, True)], [encode_example(Example(features={"s": Feature(1, [])}))],
        "Example", None, None, {},
    ),
    "context_beats_feature_lists": (
        [("x", arr(LONG), True)],
        [encode_sequence_example(SequenceExample(
            context={"x": Feature.int64_list([1, 2])},
            feature_lists={"x": FeatureList([Feature.int64_list([9])])}))],
        "SequenceExample", None, None, {"x": [1, 2]},
    ),
}


class TestEdgeCases:
    @pytest.mark.parametrize("case", sorted(EDGE_CASES))
    def test_edge_case_equals_jax(self, case):
        spec, recs, rt, hb, pack, expect = EDGE_CASES[case]
        js, ts = schemas(spec)
        got = tnative.NativeDecoder(ts, rt, hb, pack).decode_batch(recs)
        want = jnative.NativeDecoder(js, rt, hb, pack).decode_batch(recs)
        assert_batches_equal(got, want)
        for name, values in expect.items():
            assert np.array_equal(np.asarray(got[name].values)[:len(values)], values), name
        if not hb and not pack:  # and the Python oracle agrees
            assert_batches_equal(got, TDecoder(ts, rt).decode_batch(recs))

    def test_missing_non_nullable_raises(self):
        js, ts = schemas([("x", LONG, False)])
        recs = [encode_example(Example())]
        with pytest.raises(TNullValueError):
            tnative.NativeDecoder(ts).decode_batch(recs)
        with pytest.raises(JNullValueError):
            jnative.NativeDecoder(js).decode_batch(recs)
        with pytest.raises(TNullValueError):
            TDecoder(ts).decode_batch(recs)

    @pytest.mark.parametrize("spec,feats,rt,match", [
        ([("x", FLOAT, True)], Example(features={"x": Feature.int64_list([1])}),
         "Example", "kind"),
        ([("toks", arr(LONG), True)],
         SequenceExample(feature_lists={"toks": FeatureList([Feature(3, [])])}),
         "SequenceExample", "empty inner"),
    ])
    def test_malformed_features_raise_like_jax(self, spec, feats, rt, match):
        js, ts = schemas(spec)
        enc = encode_example if rt == "Example" else encode_sequence_example
        recs = [enc(feats)]
        with pytest.raises(ValueError, match=match):
            tnative.NativeDecoder(ts, rt).decode_batch(recs)
        with pytest.raises(ValueError, match=match):
            jnative.NativeDecoder(js, rt).decode_batch(recs)

    @pytest.mark.parametrize("hb,pack,match", [
        ({"x": 8}, None, "not a string/binary column"),
        ({"c": -5}, None, "positive"),
        ({"c": 8}, {"g": ["x", "f"]}, "one dtype"),
        (None, {"g": ["c"]}, "hash_buckets"),
        (None, {"x": ["x"]}, "collides"),
        (None, {"g": []}, "no members"),
        (None, {"g1": ["x"], "g2": ["x"]}, "packed once"),
        (None, {"g": ["zz"]}, "no such data column"),
    ])
    def test_configuration_errors_raise_like_jax(self, hb, pack, match):
        js, ts = schemas([("x", LONG, True), ("f", FLOAT, True), ("c", STR, True)])
        with pytest.raises(ValueError, match=match):
            tnative.NativeDecoder(ts, "Example", hb, pack)
        with pytest.raises(ValueError, match=match):
            jnative.NativeDecoder(js, "Example", hb, pack)

    def test_unsupported_schema_and_byte_array_take_the_python_decoder(self):
        _, ts = schemas([("x", lambda m: m.ArrayType(m.ArrayType(m.ArrayType(m.LongType()))),
                          True)])
        assert tnative.make_decoder(ts, "SequenceExample") is None
        _, ts = schemas([("byteArray", BIN, True)])
        assert tnative.make_decoder(ts, "ByteArray") is None
        _, ts = schemas([("x", LONG, True)])
        assert isinstance(tnative.make_decoder(ts, "Example"), tnative.NativeDecoder)


# ---------------------------------------------------------------------------
# Fused ragged pads
# ---------------------------------------------------------------------------


def _ragged(seed, dtype, n=17):
    rng = np.random.default_rng(seed)
    lengths = rng.integers(0, 7, size=n)
    offsets = np.concatenate(([0], np.cumsum(lengths))).astype(np.int64)
    values = (rng.normal(size=int(offsets[-1])) * 100).astype(dtype)
    return values, offsets


class TestPads:
    @pytest.mark.parametrize("dtype,out", [(np.float32, None), (np.int64, None),
                                           (np.int64, np.int32)])
    @pytest.mark.parametrize("max_len", [0, 1, 3, 8])
    def test_pad_ragged_equals_jax_and_numpy(self, dtype, out, max_len):
        values, offsets = _ragged(max_len, dtype)
        got = tnative.pad_ragged_dense(values, offsets, max_len, out)
        want = jnative.pad_ragged_dense(values, offsets, max_len, out)
        dense, lengths = pad_ragged(values, offsets, max_len)
        for g, w, ref in zip(got, want, (dense.astype(out or dtype), lengths)):
            assert g.dtype == w.dtype == ref.dtype and np.array_equal(g, w)
            assert np.array_equal(g, ref)

    @pytest.mark.parametrize("dtype", [np.float32, np.int64])
    @pytest.mark.parametrize("lo,li", [(1, 1), (3, 2), (6, 5), (0, 4)])
    def test_pad_ragged2_equals_jax_and_numpy(self, dtype, lo, li):
        rng = np.random.default_rng(lo * 10 + li)
        inner_lengths = rng.integers(0, 6, size=40)
        inner = np.concatenate(([0], np.cumsum(inner_lengths))).astype(np.int64)
        splits = np.concatenate(([0], np.cumsum(rng.integers(0, 5, size=11)))).astype(np.int64)
        splits = np.minimum(splits, len(inner) - 1)
        values = (rng.normal(size=int(inner[-1])) * 100).astype(dtype)
        got = tnative.pad_ragged2_dense(values, inner, splits, lo, li)
        want = jnative.pad_ragged2_dense(values, inner, splits, lo, li)
        ref = pad_ragged2(values, inner, splits, lo, li)
        for g, w, r in zip(got, want, ref):
            assert g.dtype == w.dtype == r.dtype and np.array_equal(g, w)
            assert np.array_equal(g, r)

    def test_pads_refuse_what_they_do_not_take(self):
        values, offsets = _ragged(0, np.int32)
        assert tnative.pad_ragged_dense(values, offsets, 3) is None  # int32 input
        values, offsets = _ragged(0, np.float32)
        assert tnative.pad_ragged_dense(values, offsets, 3, pad_value=1.0) is None
        with pytest.raises(IndexError):
            tnative.pad_ragged_dense(values[:2], offsets, 3)
