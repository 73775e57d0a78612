"""Dataset writer: save modes and the job-level atomic commit.

Cut-down copy of the single-threaded path of ``tpu_tfrecord/io/writer.py``:
rows are serialized, framed and streamed into one part file under
``_temporary/<job>/``; on success the file is renamed into the output
directory and a ``_SUCCESS`` marker is written. The layout on disk is the
JAX writer's: ``part-00000-<job>.c000.tfrecord[.gz|.deflate]`` plus
``_SUCCESS``, with the same record bytes for the same rows.
"""

from __future__ import annotations

import os
import shutil
import uuid
from typing import Any, Iterable, List, Sequence

from tpu_tfrecord_torch import wire
from tpu_tfrecord_torch.io import paths as p
from tpu_tfrecord_torch.options import TFRecordOptions
from tpu_tfrecord_torch.schema import StructType
from tpu_tfrecord_torch.serde import TFRecordSerializer, encode_row

SAVE_MODES = ("error", "errorifexists", "overwrite", "append", "ignore")


def _prepare_output(out: str, mode: str) -> bool:
    """Apply save-mode semantics; False means the write is a no-op
    (mode=ignore with existing output). Existence means path existence."""
    if os.path.exists(out):
        if mode in ("error", "errorifexists"):
            raise FileExistsError(f"path {out} already exists (save mode: ErrorIfExists)")
        if mode == "ignore":
            return False
        if mode == "overwrite":
            if os.path.isdir(out):
                for entry in os.listdir(out):
                    if entry == p.TEMP_PREFIX:
                        continue  # other jobs may have shards in flight
                    fp = os.path.join(out, entry)
                    if os.path.isdir(fp):
                        shutil.rmtree(fp)
                    else:
                        os.remove(fp)
            else:
                os.remove(out)
    os.makedirs(out, exist_ok=True)
    return True


def write_rows(
    rows: Iterable[Sequence[Any]],
    schema: StructType,
    path: str,
    options: TFRecordOptions,
    mode: str = "error",
) -> List[str]:
    """Write all rows as one job into one part file; returns its final path
    (an empty list when mode=ignore finds existing output)."""
    mode = (mode or "error").lower()
    if mode not in SAVE_MODES:
        raise ValueError(f"Unknown save mode {mode!r}; one of {SAVE_MODES}")
    out = os.fspath(path)
    if not _prepare_output(out, mode):
        return []
    job_id = uuid.uuid4().hex[:12]
    temp_root = os.path.join(out, p.TEMP_PREFIX, job_id)
    os.makedirs(temp_root, exist_ok=True)
    fname = p.new_shard_filename(0, ".c000" + options.file_extension(), job_id)
    tmp_path = os.path.join(temp_root, fname)
    serializer = TFRecordSerializer(schema)
    try:
        with wire.open_compressed(tmp_path, "wb", options.codec) as fh:
            for row in rows:
                fh.write(wire.encode_record(encode_row(serializer, options.record_type, row)))
        final_path = os.path.join(out, fname)
        os.replace(tmp_path, final_path)
    finally:
        shutil.rmtree(temp_root, ignore_errors=True)
        try:
            # only removable once no other job is using the shared parent
            os.rmdir(os.path.join(out, p.TEMP_PREFIX))
        except OSError:
            pass
    p.write_success_marker(out)
    return [final_path]
