"""The port's data-source API against the JAX package's, flow by flow over
``tests/test_io.py``: every flow runs through both packages on the same
inputs, and their tables, schemas, directory layouts and errors must be
equal. Also: partition helpers and type inference case by case, the
registry, the read guard, every codec, and datasets written by one package
read by the other."""

import decimal
import glob
import os
import types

import pytest
import torch

torch.set_num_threads(1)

import tpu_tfrecord.io as jio  # noqa: E402
from tpu_tfrecord import proto as jproto, registry as jregistry, schema as jschema  # noqa: E402
from tpu_tfrecord import serde as jserde, wire as jwire  # noqa: E402
from tpu_tfrecord.io import paths as jpaths  # noqa: E402
from tpu_tfrecord.options import RecordType as JRT, TFRecordOptions as JOptions  # noqa: E402

import tpu_tfrecord_torch.io as tio  # noqa: E402
from tpu_tfrecord_torch import proto as tproto, registry as tregistry, schema as tschema  # noqa: E402
from tpu_tfrecord_torch import serde as tserde, wire as twire  # noqa: E402
from tpu_tfrecord_torch.io import paths as tpaths  # noqa: E402
from tpu_tfrecord_torch.options import RecordType as TRT, TFRecordOptions as TOptions  # noqa: E402

J = types.SimpleNamespace(io=jio, schema=jschema, wire=jwire, proto=jproto, serde=jserde,
                          paths=jpaths, registry=jregistry, RT=JRT, Options=JOptions)
T = types.SimpleNamespace(io=tio, schema=tschema, wire=twire, proto=tproto, serde=tserde,
                          paths=tpaths, registry=tregistry, RT=TRT, Options=TOptions)
HAS_ZSTD = twire._zstandard() is not None


def sch(pkg, spec):
    """A StructType of ``pkg`` from [(name, type expression), ...] where the
    expression is evaluated over the package's schema module."""
    ns = vars(pkg.schema)
    return pkg.schema.StructType([
        pkg.schema.StructField(name, eval(expr, {}, ns), *extra) for name, expr, *extra in spec
    ])


MAIN = [("id", "IntegerType()"), ("IntegerCol", "IntegerType()"), ("LongCol", "LongType()"),
        ("FloatCol", "FloatType()"), ("DoubleCol", "DoubleType()"), ("DecimalCol", "DecimalType()"),
        ("VectorCol", "ArrayType(DoubleType())"), ("StringCol", "StringType()"),
        ("BinaryCol", "BinaryType()")]
ROWS = [
    [11, 1, 23, 10.0, 14.0, decimal.Decimal("1.0"), [1.0, 2.0], "r1", b"\x01"],
    [21, 2, 24, 12.0, 15.0, decimal.Decimal("2.0"), [2.0, 2.0], "r2", b"\x02"],
    [31, 3, 25, 14.0, 16.0, decimal.Decimal("3.0"), [3.0, 2.0], "r3", b"\x03"],
]
NUMBER = [("number", "LongType()"), ("word", "StringType()")]
NUMBER_ROWS = [[8, "bat"], [8, "abc"], [1, "xyz"], [2, "aaa"]]


def table_view(table):
    """A package-free view of a Table: schema JSON and sorted rows."""
    return table.schema.to_json(), sorted(table.rows, key=repr)


def layout(out):
    """Relative paths under ``out`` with the random job id masked."""
    got = []
    for root, dirs, files in os.walk(out):
        dirs.sort()
        for f in sorted(files):
            rel = os.path.relpath(os.path.join(root, f), out)
            got.append(rel if not f.startswith("part-") else rel.replace(f[11:23], "<job>"))
    return sorted(got)


def outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the error's type is part of the behaviour
        return ("raises", type(e).__name__)


def run_both(tmp_path, flow):
    j = outcome(lambda: flow(J, str(tmp_path / "jax")))
    t = outcome(lambda: flow(T, str(tmp_path / "port")))
    assert t == j
    return t


# ---------------------------------------------------------------------------
# flows of tests/test_io.py, through both packages
# ---------------------------------------------------------------------------


def flow_example_user_schema(pkg, out):
    s = sch(pkg, MAIN)
    pkg.io.write(ROWS, s, out, mode="overwrite")
    return table_view(pkg.io.read(out, schema=s)), layout(out)


def flow_example_inferred(pkg, out):
    pkg.io.write(ROWS, sch(pkg, MAIN), out, mode="overwrite")
    return table_view(pkg.io.read(out)), pkg.io.has_success_marker(out)


def flow_column_pruning(pkg, out):
    s = sch(pkg, MAIN)
    pkg.io.write(ROWS, s, out, mode="overwrite")
    return table_view(pkg.io.read(out, schema=s, columns=["StringCol", "id"]))


def flow_partition_layout(pkg, out):
    pkg.io.write(NUMBER_ROWS, sch(pkg, NUMBER), out, mode="overwrite", partition_by=["number"])
    return layout(out), table_view(pkg.io.read(out))


def flow_partition_multi_level(pkg, out):
    rows = [["2026-01-01", 0, 1.0], ["2026-01-01", 1, 2.0], ["2026-01-02", 0, 3.0]]
    s = sch(pkg, [("date", "StringType()"), ("shard", "LongType()"), ("v", "FloatType()")])
    pkg.io.write(rows, s, out, mode="overwrite", partition_by=["date", "shard"])
    return layout(out), table_view(pkg.io.read(out))


def flow_partition_escaping(pkg, out):
    rows = [["a/b:c", 1], [None, 2], ["x=y%z", 3], ["#tag?", 4]]
    pkg.io.write(rows, sch(pkg, [("k", "StringType()"), ("v", "LongType()")]), out,
                 mode="overwrite", partition_by=["k"])
    return layout(out), table_view(pkg.io.read(out))


def flow_partition_column_not_in_records(pkg, out):
    pkg.io.write(NUMBER_ROWS, sch(pkg, NUMBER), out, mode="overwrite", partition_by=["number"])
    f = glob.glob(os.path.join(out, "number=8", "*.tfrecord"))[0]
    return [sorted(pkg.proto.parse_example(r).features) for r in pkg.wire.read_records(f)]


def flow_all_columns_partition(pkg, out):
    pkg.io.write([[1]], sch(pkg, [("x", "LongType()")]), out, partition_by=["x"])


def flow_array_partition(pkg, out):
    pkg.io.write([[[1], 2]], sch(pkg, [("a", "ArrayType(LongType())"), ("b", "LongType()")]),
                 out, partition_by=["a"])


def flow_partitioned_pipelined(pkg, out):
    rows = [[i, f"w{i % 7}", i % 3] for i in range(9000)]
    s = sch(pkg, [("n", "LongType()"), ("w", "StringType()"), ("day", "LongType()")])
    pkg.io.write(rows, s, out, mode="overwrite", partition_by=["day"], codec="gzip",
                 write_workers=3, num_shards=2)
    return layout(out), table_view(pkg.io.read(out))


def flow_sequence_example(pkg, out):
    s = sch(pkg, [("id", "LongType()"), ("F", "ArrayType(ArrayType(FloatType()))"),
                  ("S", "ArrayType(ArrayType(StringType()))")])
    rows = [[1, [[1.0, 2.0], [3.0]], [["a"], ["b", "c"]]], [2, [[5.0]], [["z"]]]]
    pkg.io.write(rows, s, out, mode="overwrite", recordType="SequenceExample")
    return (table_view(pkg.io.read(out, schema=s, recordType="SequenceExample")),
            table_view(pkg.io.read(out, recordType="SequenceExample")))


def flow_byte_array(pkg, out):
    rows = [[b"raw-1"], [b"\x00\xff"], [b""]]
    pkg.io.write(rows, sch(pkg, [("byteArray", "BinaryType()")]), out, mode="overwrite",
                 recordType="ByteArray")
    return table_view(pkg.io.read(out, recordType="ByteArray"))


def flow_byte_array_partitioned(pkg, out):
    rows = [[b"p1", "a"], [b"p2", "b"]]
    s = sch(pkg, [("byteArray", "BinaryType()"), ("day", "StringType()")])
    pkg.io.write(rows, s, out, mode="overwrite", partition_by=["day"], recordType="ByteArray")
    return table_view(pkg.io.read(out, recordType="ByteArray"))


def flow_save_modes(pkg, out):
    s = sch(pkg, MAIN)
    seen = []
    pkg.io.write(ROWS, s, out, mode="overwrite")
    pkg.io.write(ROWS[:1], s, out, mode="overwrite")
    seen.append(len(pkg.io.read(out, schema=s)))
    pkg.io.write(ROWS, s, out, mode="append")
    seen.append(len(pkg.io.read(out, schema=s)))
    seen.append(outcome(lambda: pkg.io.write(ROWS, s, out)))
    seen.append(pkg.io.write(ROWS[:1], s, out, mode="ignore"))
    seen.append(outcome(lambda: pkg.io.write(ROWS, s, out + "x", mode="clobber")))
    seen.append(len(layout(out)))
    return seen


def flow_ignore_leaves_files(pkg, out):
    s = sch(pkg, MAIN)
    pkg.io.write(ROWS, s, out, mode="overwrite")
    before = {f: os.path.getmtime(os.path.join(out, f)) for f in os.listdir(out)}
    pkg.io.write(ROWS[:1], s, out, mode="ignore")
    return before == {f: os.path.getmtime(os.path.join(out, f)) for f in os.listdir(out)}


def flow_existence_semantics(pkg, out):
    s = sch(pkg, MAIN)
    seen = []
    for mode in ("error", "ignore", "overwrite", "append"):
        d = f"{out}_{mode}"
        os.makedirs(d)
        seen.append((mode, outcome(lambda: len(pkg.io.write(ROWS, s, d, mode=mode)))))
    return seen


def flow_failed_job_retry(pkg, out):
    s = sch(pkg, MAIN)

    def bad_rows():
        yield ROWS[0]
        raise RuntimeError("boom")

    first = outcome(lambda: pkg.io.write(bad_rows(), s, out))
    return first, os.path.exists(out), len(pkg.io.write(ROWS, s, out))


def flow_overwrite_keeps_other_jobs_temp(pkg, out):
    s = sch(pkg, MAIN)
    pkg.io.write(ROWS, s, out, mode="overwrite")
    other = os.path.join(out, "_temporary", "other-job")
    os.makedirs(other)
    open(os.path.join(other, "inflight.tmp"), "wb").close()
    pkg.io.write(ROWS[:1], s, out, mode="overwrite")
    return os.path.exists(os.path.join(other, "inflight.tmp")), len(pkg.io.read(out, schema=s))


def flow_hadoop_codec_name(pkg, out):
    files = pkg.io.write(ROWS, sch(pkg, MAIN), out, mode="overwrite",
                         codec="org.apache.hadoop.io.compress.GzipCodec")
    return [os.path.basename(f)[23:] for f in files], table_view(pkg.io.read(out))


def flow_multi_file_and_glob(pkg, out):
    s = sch(pkg, MAIN)
    pkg.io.write(ROWS[:2], s, out + "/m1", mode="overwrite")
    pkg.io.write(ROWS[2:], s, out + "/m2", mode="overwrite")
    return (table_view(pkg.io.read([out + "/m1", out + "/m2"], schema=s)),
            table_view(pkg.io.read(out + "/m*", schema=s)))


def flow_inference_skips_empty(pkg, out):
    os.makedirs(out)
    open(os.path.join(out, "part-00000-aaa.tfrecord"), "wb").close()
    s = sch(pkg, MAIN)
    ser = pkg.serde.TFRecordSerializer(s)
    pkg.wire.write_records(os.path.join(out, "part-00001-bbb.tfrecord"),
                           (pkg.serde.encode_row(ser, pkg.RT.EXAMPLE, r) for r in ROWS))
    return table_view(pkg.io.read(out))


def flow_no_input(pkg, out):
    pkg.io.read(out + "/nope")


def flow_empty_dir_inference(pkg, out):
    os.makedirs(out)
    pkg.io.read(out)


def flow_infer_all_files(pkg, out):
    shapes = [[("x", "LongType()")], [("x", "FloatType()"), ("y", "LongType()")],
              [("y", "FloatType()"), ("z", "StringType()")], [("x", "LongType()"), ("z", "StringType()")]]
    rows = [[[1]], [[1.5, 2]], [[2.5, "s"]], [[7, "t"]]]
    for spec, rws in zip(shapes, rows):
        pkg.io.write(rws, sch(pkg, spec), out, mode="append")
    r = pkg.io.reader(out)
    serial = r.infer_schema_all_files()
    return serial.to_json(), [r.infer_schema_all_files(num_workers=w) == serial for w in (2, 3, 4, 8)]


def flow_unknown_option(pkg, out):
    pkg.io.write([[1]], sch(pkg, [("x", "LongType()")]), out, mode="overwrite")
    return pkg.io.read(out, recordtype="Example")


def flow_unknown_column(pkg, out):
    s = sch(pkg, MAIN)
    pkg.io.write(ROWS, s, out, mode="overwrite")
    return pkg.io.read(out, schema=s, columns=["id", "nope"])


def flow_read_guard(pkg, out):
    s = sch(pkg, [("n", "LongType()")])
    pkg.io.write([[i] for i in range(50)], s, out, mode="overwrite")
    return (table_view(pkg.io.read(out, schema=s, limit=7)),
            pkg.io.read(out, schema=s, limit=0).rows,
            outcome(lambda: pkg.io.read(out, schema=s, max_bytes=1)),
            len(pkg.io.read(out, schema=s, max_bytes=1, limit=2)),
            len(pkg.io.read(out, schema=s, max_bytes=None)))


def flow_data_source(pkg, out):
    src = pkg.registry.lookup_format("TFRecord")
    s = sch(pkg, NUMBER)
    w = src.writer(out, s, mode="overwrite", partition_by=["number"], codec="deflate")
    w.write_rows(NUMBER_ROWS)
    return (src.short_name, src == pkg.registry.lookup_format("tfrecord"),
            src.infer_schema(out).to_json(),
            sorted(map(repr, src.reader(out).rows())), layout(out))


FLOWS = {name[5:]: fn for name, fn in dict(globals()).items() if name.startswith("flow_")}


# the flows whose outcome is an error (of the same type in both packages)
RAISING = {"all_columns_partition", "array_partition", "empty_dir_inference", "no_input",
           "unknown_column", "unknown_option"}


@pytest.mark.parametrize("name", sorted(FLOWS))
def test_flow_matches_jax(tmp_path, name):
    kind, _ = run_both(tmp_path, FLOWS[name])
    assert kind == ("raises" if name in RAISING else "ok")


def test_unknown_format_raises():
    for reg in (jregistry, tregistry):
        with pytest.raises(ValueError):
            reg.lookup_format("parquet-nope")


@pytest.mark.parametrize("codec", ["gzip", "deflate", "snappy", "lz4", "bzip2", "zlib", "bz2",
                                   pytest.param("zstd", marks=pytest.mark.skipif(
                                       not HAS_ZSTD, reason="no zstandard"))])
@pytest.mark.parametrize("workers", [1, 2])
def test_codec_round_trip_matches_jax(tmp_path, codec, workers):
    def flow(pkg, out):
        files = pkg.io.write(ROWS, sch(pkg, MAIN), out, mode="overwrite", codec=codec,
                             write_workers=workers)
        return [os.path.basename(f)[23:] for f in files], table_view(pkg.io.read(out))

    run_both(tmp_path, flow)


# ---------------------------------------------------------------------------
# partition helpers, case by case
# ---------------------------------------------------------------------------

TYPE_CASES = [
    ["1", "-2", "+3"], ["1", "2.5"], ["1e3", ".5", "3.", "-1.5E-2"], [" 1", "1 ", " 1.5 "],
    ["NaN", "Infinity", "-Infinity", "2.5"], ["1_0"], ["inf"], ["nan"], ["infinity"], ["0x10"],
    ["1.0f"], [""], [" "], ["1", "1_0"], [None, "4"], [None], ["2026-01-01"], ["007"],
]


@pytest.mark.parametrize("values", TYPE_CASES, ids=repr)
def test_partition_type_inference_matches_jax(values):
    jt = jpaths.infer_partition_type(values)
    tt = tpaths.infer_partition_type(values)
    assert type(tt).__name__ == type(jt).__name__
    for v in values:
        assert tpaths.cast_partition_value(v, tt) == jpaths.cast_partition_value(v, jt) or (
            v is not None and v.strip() == "NaN")


VALUES = ["plain", "a/b:c", "x=y%z", "#?*[]^{}\\'\"", "\x01\x1f\x7f", "ünï", "", None, 3, -2.5,
          True, False, b"bytes", b"\xff", 1e20]


@pytest.mark.parametrize("value", VALUES, ids=repr)
def test_partition_helpers_match_jax(value):
    assert tpaths.format_partition_value(value) == jpaths.format_partition_value(value)
    rendered = tpaths.format_partition_value(value)
    assert tpaths.escape_partition_value(rendered) == jpaths.escape_partition_value(rendered)
    assert tpaths.unescape_partition_value(tpaths.escape_partition_value(rendered)) == rendered
    rel = tpaths.partition_dir(["k", "c=d"], [value, "x"])
    assert rel == jpaths.partition_dir(["k", "c=d"], [value, "x"])
    for comp in rel.split("/"):
        assert tpaths.parse_partition_component(comp) == jpaths.parse_partition_component(comp)


def test_discovery_matches_jax(tmp_path):
    out = str(tmp_path / "disc")
    rows = [[i, "2026-01-0" + str(i % 2), i % 3] for i in range(30)]
    jio.write(rows, sch(J, [("n", "LongType()"), ("d", "StringType()"), ("h", "LongType()")]), out,
              partition_by=["d", "h"])
    os.makedirs(os.path.join(out, "_temporary", "x"))
    open(os.path.join(out, ".hidden"), "wb").close()
    js_, ts_ = jpaths.discover_shards(out), tpaths.discover_shards(out)
    assert [(s.path, s.size, s.partition_values) for s in ts_] == [
        (s.path, s.size, s.partition_values) for s in js_]
    assert ts_[0].partitions == js_[0].partitions
    assert tpaths.partition_columns_of(ts_) == jpaths.partition_columns_of(js_) == ["d", "h"]


# ---------------------------------------------------------------------------
# a dataset written by one package, read by the other
# ---------------------------------------------------------------------------

CROSS = {
    "plain": dict(),
    "partitioned": dict(partition_by=["day"]),
    "partitioned_gzip_pipelined": dict(partition_by=["day"], codec="gzip", write_workers=4,
                                       num_shards=2),
    "snappy": dict(codec="snappy"),
    "bzip2_rotated": dict(codec="bzip2", max_records_per_shard=700),
}


@pytest.mark.parametrize("name", sorted(CROSS))
@pytest.mark.parametrize("writer", ["jax", "port"])
def test_written_by_one_read_by_other(tmp_path, writer, name):
    rows = [[i, float(i) / 4, f"w{i % 5}", [i, i + 1], i % 3] for i in range(2500)]
    spec = [("n", "LongType()"), ("f", "FloatType()"), ("w", "StringType()"),
            ("v", "ArrayType(LongType())"), ("day", "LongType()")]
    src, dst = (J, T) if writer == "jax" else (T, J)
    out = str(tmp_path / "ds")
    src.io.write(rows, sch(src, spec), out, mode="overwrite", **CROSS[name])
    a, b = dst.io.read(out), src.io.read(out)
    assert table_view(a) == table_view(b)
    assert len(a) == len(rows)
    assert dst.io.reader(out).partition_schema.to_json() == src.io.reader(out).partition_schema.to_json()
