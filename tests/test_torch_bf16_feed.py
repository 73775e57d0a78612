"""The bf16 frame feed stands without ``ml_dtypes`` (the card's machine does
not have it): no source of the port imports it or names it, and in a
process where ``import ml_dtypes`` fails, SequenceExample frames padded and
cast to ``torch.bfloat16`` go through ``host_batch_from_columnar``,
``make_device_batch`` and ``DeviceIterator`` on the CPU. In
``tests/test_torch_isolation.py``'s manner: a subprocess, and a scan of
every source."""

import ast
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_tfrecord_torch")


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_does_not_import_ml_dtypes(path):
    src = open(path).read()
    for node in ast.walk(ast.parse(src, filename=path)):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        assert all(n.split(".")[0] != "ml_dtypes" for n in names), (path, node.lineno)
    # nor through importlib or __import__ with the name in a string
    strings = [n.value for n in ast.walk(ast.parse(src)) if isinstance(n, ast.Constant)
               and isinstance(n.value, str)]
    assert not any("ml_dtypes" in s and "import" in s for s in strings), path


def test_bf16_frame_feed_runs_without_ml_dtypes(tmp_path):
    code = (
        "import json, sys\n"
        "sys.modules['ml_dtypes'] = None\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "import torch\n"
        "from tpu_tfrecord_torch import train_longdoc as tw\n"
        "from tpu_tfrecord_torch.device.ingest import DeviceIterator, make_device_batch\n"
        "from tpu_tfrecord_torch.io.dataset import TFRecordDataset\n"
        "d = sys.argv[1]\n"
        "tw.generate(d, shards=1, rows=8)\n"
        "ds = TFRecordDataset(d, batch_size=4, schema=tw.make_schema(),\n"
        "                     recordType='SequenceExample')\n"
        "with ds.batches() as it:\n"
        "    hbs = [tw.host_batch(cb, ds.schema) for cb in it]\n"
        "direct = make_device_batch(hbs[0], 'cpu')\n"
        "with DeviceIterator(iter(hbs), 'cpu') as dit:\n"
        "    fed = list(dit)\n"
        "print(json.dumps({'direct': str(direct['frames'].dtype),\n"
        "                  'fed': [str(b['frames'].dtype) for b in fed],\n"
        "                  'shape': list(fed[0]['frames'].shape),\n"
        "                  'equal': torch.equal(direct['frames'], fed[0]['frames']),\n"
        "                  'ml_dtypes': sys.modules['ml_dtypes']}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code, str(tmp_path / "data")],
                          capture_output=True, text=True, cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out == {"direct": "torch.bfloat16", "fed": ["torch.bfloat16"] * 2,
                   "shape": [4, 64, 16], "equal": True, "ml_dtypes": None}
