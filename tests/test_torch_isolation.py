"""The port stands alone: importing every module of ``tpu_tfrecord_torch``
and ``chip_smoke.py`` loads neither jax nor the JAX package, and no source
file of the port imports them."""

import ast
import json
import os
import pkgutil
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_tfrecord_torch")


def port_modules():
    import tpu_tfrecord_torch

    names = ["tpu_tfrecord_torch"]
    for info in pkgutil.walk_packages(tpu_tfrecord_torch.__path__, "tpu_tfrecord_torch."):
        names.append(info.name)
    return sorted(names)


def port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(PKG):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return sorted(out)


def test_every_module_is_found():
    mods = port_modules()
    for want in ("tpu_tfrecord_torch.io.dataset", "tpu_tfrecord_torch.device.ingest",
                 "tpu_tfrecord_torch.models.interaction", "tpu_tfrecord_torch.entry",
                 "tpu_tfrecord_torch.interop", "tpu_tfrecord_torch._cuda"):
        assert want in mods


def test_imports_load_no_jax():
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m == 'jaxlib' or m == 'tpu_tfrecord' or m.startswith('tpu_tfrecord.'))\n"
        "print(json.dumps(bad))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert json.loads(proc.stdout.strip().splitlines()[-1]) == []


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_source_has_no_jax_import(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "tpu_tfrecord"), (path, node.lineno, name)


def test_chip_smoke_fails_without_cuda_and_prints_no_result(tmp_path):
    """Here there is no CUDA device: the script must exit non-zero with no
    result line, both in the repo and alone in an empty directory."""
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; this checks the no-device exit")
    alone = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), alone)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for cwd, script in ((REPO, os.path.join(REPO, "chip_smoke.py")), (tmp_path, alone)):
        proc = subprocess.run([sys.executable, str(script)], capture_output=True, text=True,
                              cwd=str(cwd), env=env, timeout=300)
        assert proc.returncode != 0
        assert '"ok"' not in proc.stdout
