"""The port's codecs and framing against the JAX package, bit-exact: raw
snappy and lz4 (native and pure-Python), Hadoop block framing, bzip2,
zstd (skipped where ``zstandard`` is missing, as the JAX tests skip it),
the per-slab chunk compressors of the write pipeline, codec names and
extensions, ``RecordWriter``, ``scan_buffer_partial``, ``scan_buffer``,
``resync`` and the native ``scan_partial`` with ``max_records``."""

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

from tpu_tfrecord import _native as jnative, hadoop_codecs as jhc, wire as jwire  # noqa: E402

from tpu_tfrecord_torch import _native as tnative, hadoop_codecs as thc, wire as twire  # noqa: E402

HAS_ZSTD = twire._zstandard() is not None


def payloads():
    rng = np.random.default_rng(7)
    return {
        "empty": b"",
        "one": b"a",
        "text": b"hello world " * 500,
        "ramp": bytes(range(256)) * 300,
        "random": rng.integers(0, 256, size=5000, dtype=np.uint8).tobytes(),
        "letters": (rng.integers(0, 16, size=300_000, dtype=np.uint8) + 97).tobytes(),
    }


PAYLOADS = payloads()
CHUNK_CODECS = [None, "gzip", "deflate", "snappy", "lz4", "bzip2",
                pytest.param("zstd", marks=pytest.mark.skipif(not HAS_ZSTD, reason="no zstandard"))]
FILE_CODECS = ["deflate", "snappy", "lz4", "bzip2",
               pytest.param("zstd", marks=pytest.mark.skipif(not HAS_ZSTD, reason="no zstandard"))]


@pytest.fixture(autouse=True, scope="module")
def _jax_native():
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")


# ---------------------------------------------------------------------------
# raw snappy / lz4
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_raw_compress_bit_exact_and_round_trip(codec, name):
    data = PAYLOADS[name]
    tc = getattr(thc, f"{codec}_compress")(data)
    assert tc == getattr(jhc, f"{codec}_compress")(data)
    assert getattr(thc, f"{codec}_decompress")(tc) == data
    assert getattr(jhc, f"{codec}_decompress")(tc) == data


@pytest.mark.parametrize("name", sorted(PAYLOADS))
@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_native_bindings_match_jax(codec, name):
    data = PAYLOADS[name]
    comp = getattr(tnative, f"{codec}_compress")(data)
    assert comp == getattr(jnative, f"{codec}_compress")(data)
    assert getattr(tnative, f"{codec}_decompress")(comp) == getattr(jnative, f"{codec}_decompress")(comp)


SPEC_VECTORS = {
    # snappy: literal then a 1-byte-offset copy; overlapping RLE copy; a
    # 2-byte-offset copy after a long literal
    "snappy_copy1": ("snappy", bytes([8, 3 << 2]) + b"abcd" + bytes([0x01, 4])),
    "snappy_rle": ("snappy", bytes([8, 1 << 2]) + b"ab" + bytes([(6 - 4) << 2 | 0x01, 2])),
    "snappy_copy2": ("snappy", bytes([84, 60 << 2, 76]) + b"x" * 70 + b"PATTERN"
                     + bytes([(7 - 1) << 2 | 0x02]) + (7).to_bytes(2, "little")),
    # lz4: a match after 4 literals; extended literal length
    "lz4_match": ("lz4", bytes([(4 << 4) | 4]) + b"abcd" + (4).to_bytes(2, "little")),
    "lz4_extended": ("lz4", bytes([0xF0, 255, 512 - 15 - 255]) + bytes(range(256)) * 2),
}


@pytest.mark.parametrize("name", sorted(SPEC_VECTORS))
def test_spec_vectors_decode_like_jax(name):
    codec, blob = SPEC_VECTORS[name]
    want = getattr(jhc, f"{codec}_decompress")(blob)
    assert getattr(thc, f"{codec}_decompress")(blob) == want
    assert getattr(thc, f"_{codec}_decompress_py")(blob) == want


CORRUPT_VECTORS = {
    "snappy_short": ("snappy", bytes([9, 3 << 2]) + b"abcd"),
    "snappy_bad_offset": ("snappy", bytes([8, 3 << 2]) + b"abcd" + bytes([0x01, 200])),
    "snappy_huge_varint": ("snappy", bytes([0xFF, 0xFF, 0xFF, 0xFF, 0x0F]) + b"ab"),
    "lz4_bad_offset": ("lz4", bytes([(4 << 4) | 4]) + b"abcd" + (9).to_bytes(2, "little")),
}


@pytest.mark.parametrize("name", sorted(CORRUPT_VECTORS))
def test_corrupt_inputs_raise_like_jax(name):
    codec, blob = CORRUPT_VECTORS[name]
    with pytest.raises(jwire.TFRecordCorruptionError):
        getattr(jhc, f"{codec}_decompress")(blob)
    with pytest.raises(twire.TFRecordCorruptionError):
        getattr(thc, f"{codec}_decompress")(blob)


def _random_snappy(rng, n_elems=40):
    """A valid raw-snappy stream built element by element (literals and
    2-byte-offset copies, overlapping ones included)."""
    out, body = bytearray(), bytearray()
    for _ in range(n_elems):
        if not out or rng.random() < 0.5:
            lit = rng.integers(0, 256, size=int(rng.integers(1, 60)), dtype=np.uint8).tobytes()
            body.append((len(lit) - 1) << 2)
            body += lit
            out += lit
        else:
            length = int(rng.integers(4, 12))
            offset = int(rng.integers(1, min(len(out), 2000) + 1))
            body.append(((length - 1) << 2) | 0x02)
            body += offset.to_bytes(2, "little")
            start = len(out) - offset
            for i in range(length):
                out.append(out[start + i])
    return bytes(thc._write_varint(len(out)) + body), bytes(out)


@pytest.mark.parametrize("seed", range(4))
def test_snappy_native_against_python_oracle(seed):
    rng = np.random.default_rng(seed)
    for _ in range(10):
        blob, want = _random_snappy(rng)
        assert tnative.snappy_decompress(blob) == want
        assert thc._snappy_decompress_py(blob) == want
        assert jhc._snappy_decompress_py(blob) == want


@pytest.mark.parametrize("seed", range(4))
def test_lz4_native_against_python_oracle(seed):
    rng = np.random.default_rng(100 + seed)
    for _ in range(10):
        data = (rng.integers(0, 4, size=int(rng.integers(1, 20_000)), dtype=np.uint8) + 65).tobytes()
        blob = tnative.lz4_compress(data)
        assert thc._lz4_decompress_py(blob) == data == tnative.lz4_decompress(blob, len(data))


@pytest.mark.parametrize("name", ["text", "letters"])
def test_python_literal_encoders_match_jax_fallbacks(name, monkeypatch):
    data = PAYLOADS[name]
    assert thc.snappy_decompress(thc._snappy_compress_py(data)) == data
    assert thc.lz4_decompress(thc._lz4_compress_py(data)) == data
    # the JAX package's literal-only lz4 path, reached past its size guard
    monkeypatch.setattr(jhc, "LZ4_NATIVE_MAX_BYTES", 16)
    monkeypatch.setattr(thc, "LZ4_NATIVE_MAX_BYTES", 16)
    assert thc.lz4_compress(data) == jhc.lz4_compress(data) == thc._lz4_compress_py(data)


def test_native_lz4_refuses_out_of_contract_sizes():
    class Huge(bytes):
        def __len__(self):
            return 2**31

    with pytest.raises(ValueError, match="int32"):
        tnative.lz4_compress(Huge(b"x"))


# ---------------------------------------------------------------------------
# Hadoop block framing, chunk compressors, file codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("size", [0, 1, 1000, 256 * 1024, 256 * 1024 + 1, 700_000])
@pytest.mark.parametrize("codec", ["snappy", "lz4"])
def test_compress_hadoop_blocks_bit_exact(codec, size):
    data = (PAYLOADS["letters"] * 3)[:size]
    assert thc.compress_hadoop_blocks(codec, data) == jhc.compress_hadoop_blocks(codec, data)


@pytest.mark.parametrize("name", ["empty", "text", "letters"])
@pytest.mark.parametrize("codec", CHUNK_CODECS)
def test_compress_chunk_bit_exact(codec, name):
    data = PAYLOADS[name]
    assert twire.codec_supports_chunks(codec) == jwire.codec_supports_chunks(codec)
    assert twire.compress_chunk(codec, data) == jwire.compress_chunk(codec, data)
    # the bytes of several chunks are one valid stream of the codec
    assert twire.compress_chunk(codec, np.frombuffer(data, np.uint8)) == jwire.compress_chunk(codec, data)


def _records(n=300, seed=0):
    rng = np.random.default_rng(seed)
    return [(rng.integers(0, 8, size=int(rng.integers(0, 400)), dtype=np.uint8) + 97).tobytes()
            for _ in range(n)]


@pytest.mark.parametrize("codec", FILE_CODECS)
def test_stream_files_bit_exact_and_cross_read(tmp_path, codec):
    recs = _records()
    ext = twire.codec_extension(codec)
    assert ext == jwire.codec_extension(codec)
    tp, jp = str(tmp_path / f"t.tfrecord{ext}"), str(tmp_path / f"j.tfrecord{ext}")
    assert twire.write_records(tp, recs, codec=codec) == len(recs)
    jwire.write_records(jp, recs, codec=codec)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    assert list(twire.read_records(jp)) == recs == list(jwire.read_records(tp))


def test_gzip_stream_cross_read(tmp_path):
    """gzip's header holds the write time, so the files are compared by
    their records."""
    recs = _records(seed=3)
    tp, jp = str(tmp_path / "t.tfrecord.gz"), str(tmp_path / "j.tfrecord.gz")
    twire.write_records(tp, recs, codec="gzip")
    jwire.write_records(jp, recs, codec="gzip")
    assert list(twire.read_records(jp)) == recs == list(jwire.read_records(tp))


@pytest.mark.parametrize("codec", ["gzip"] + FILE_CODECS)
def test_concatenated_chunks_read_back(tmp_path, codec):
    """The pipeline's per-slab chunks, concatenated, read as one file."""
    recs = _records(seed=5)
    framed = [b"".join(twire.encode_record(r) for r in recs[i:i + 70]) for i in range(0, len(recs), 70)]
    path = str(tmp_path / f"c.tfrecord{twire.codec_extension(codec)}")
    with open(path, "wb") as fh:
        for f in framed:
            fh.write(twire.compress_chunk(codec, f))
    assert list(twire.read_records(path)) == recs == list(jwire.read_records(path))


@pytest.mark.parametrize("codec", ["gzip"] + FILE_CODECS)
def test_truncation_detected_like_jax(tmp_path, codec):
    path = str(tmp_path / f"x.tfrecord{twire.codec_extension(codec)}")
    twire.write_records(path, _records(seed=9), codec=codec)
    raw = open(path, "rb").read()
    open(path, "wb").write(raw[: len(raw) - 7])
    # a TFRecordCorruptionError, or for gzip the stdlib's EOFError, in both
    with pytest.raises((jwire.TFRecordCorruptionError, EOFError)) as jerr:
        list(jwire.read_records(path))
    with pytest.raises((twire.TFRecordCorruptionError, EOFError)) as terr:
        list(twire.read_records(path))
    assert terr.type.__name__ == jerr.type.__name__


def test_multi_block_hadoop_file(tmp_path):
    data = PAYLOADS["letters"] * 2  # 600 KB: three 256 KiB blocks
    tp, jp = str(tmp_path / "t.snappy"), str(tmp_path / "j.snappy")
    with thc.HadoopBlockFile(tp, "wb", "snappy") as fh:
        fh.write(data[:1000])
        fh.write(data[1000:])
    with jhc.HadoopBlockFile(jp, "wb", "snappy") as fh:
        fh.write(data)
    assert open(tp, "rb").read() == open(jp, "rb").read()
    with thc.HadoopBlockFile(jp, "rb", "snappy") as fh:
        assert fh.read() == data


CODEC_NAMES = sorted(jwire._CODEC_ALIASES) + ["GZIP", " Snappy ", "bogus", "lzo"]


@pytest.mark.parametrize("name", CODEC_NAMES)
def test_codec_names_like_jax(name):
    try:
        want = jwire.normalize_codec(name)
    except ValueError:
        with pytest.raises(ValueError):
            twire.normalize_codec(name)
        return
    assert twire.normalize_codec(name) == want
    assert twire.codec_extension(name) == jwire.codec_extension(name)


@pytest.mark.parametrize("path", ["a.tfrecord", "a.gz", "a.GZIP", "a.deflate", "a.zlib", "a.zst",
                                  "a.zstd", "a.snappy", "a.lz4", "a.bz2", "a.bzip2", "a.txt"])
def test_codec_from_path_like_jax(path):
    assert twire.codec_from_path(path) == jwire.codec_from_path(path)


def test_urls_are_not_ported_yet(tmp_path):
    """URLs are ported: ``open_compressed`` takes a URL through its
    filesystem, as the JAX one does (a missing object raises the same
    error; a written one reads back through the codec)."""
    pytest.importorskip("fsspec")
    missing = "memory://codec-url-test/none.tfrecord"
    with pytest.raises(FileNotFoundError):
        twire.open_compressed(missing, "rb", None)
    with pytest.raises(FileNotFoundError):
        jwire.open_compressed(missing, "rb", None)
    url = "memory://codec-url-test/x.tfrecord.gz"
    with twire.open_compressed(url, "wb", "gzip") as fh:
        fh.write(b"remote bytes")
    with jwire.open_compressed(url, "rb", "gzip") as fh:
        assert fh.read() == b"remote bytes"
    with twire.open_compressed(url, "rb", "gzip") as fh:
        assert fh.read() == b"remote bytes"


# ---------------------------------------------------------------------------
# framing: RecordWriter, scans, resync
# ---------------------------------------------------------------------------


def test_record_writer_counts_like_jax(tmp_path):
    recs = _records(50)
    out = {}
    for name, mod in (("t", twire), ("j", jwire)):
        path = str(tmp_path / name)
        with open(path, "wb") as fh:
            w = mod.RecordWriter(fh)
            for r in recs:
                w.write(r)
        out[name] = (w.records_written, w.bytes_written, open(path, "rb").read())
    assert out["t"] == out["j"]
    with open(str(tmp_path / "t"), "rb") as fh:
        reader = twire.RecordReader(fh)
        assert list(reader) == recs
        assert (reader.records_read, reader.bytes_read) == (50, len(out["t"][2]))


def _stream(n=40, seed=1):
    return b"".join(twire.encode_record(r) for r in _records(n, seed))


@pytest.mark.parametrize("cut", [0, 5, 11, 12, 100, 1000, -1, -4])
@pytest.mark.parametrize("max_records", [None, 0, 3, 1000])
def test_scan_buffer_partial_like_jax(cut, max_records):
    buf = _stream()
    buf = buf[:cut] if cut > 0 else buf[: len(buf) + cut] if cut < 0 else buf
    want = jwire.scan_buffer_partial(buf, True, max_records=max_records)
    assert twire.scan_buffer_partial(buf, True, max_records=max_records) == want
    offs, lens, consumed = tnative.scan_partial(buf, True, max_records=max_records)
    joffs, jlens, jconsumed = jnative.scan_partial(buf, True, max_records=max_records)
    assert (offs.tolist(), lens.tolist(), consumed) == (joffs.tolist(), jlens.tolist(), jconsumed)
    if max_records is None:
        assert [(int(o), int(l)) for o, l in zip(offs, lens)] == want[0]


def test_scan_buffer_strict_like_jax():
    buf = _stream()
    assert list(twire.scan_buffer(buf)) == list(jwire.scan_buffer(buf))
    for mod in (twire, jwire):
        with pytest.raises(mod.TFRecordCorruptionError):
            list(mod.scan_buffer(buf[:-3]))


@pytest.mark.parametrize("seed", range(6))
def test_resync_like_jax(seed):
    """Corrupt a few bytes of a stream; the next plausible header from every
    position is the JAX package's."""
    rng = np.random.default_rng(seed)
    buf = bytearray(_stream(12, seed))
    for at in rng.integers(0, len(buf), size=3):
        buf[int(at)] ^= 0xFF
    buf = bytes(buf)
    for pos in range(0, len(buf), 7):
        for kw in ({}, {"max_record_bytes": 200}, {"end": len(buf) - 9}):
            assert twire.resync(buf, pos, **kw) == jwire.resync(buf, pos, **kw)
