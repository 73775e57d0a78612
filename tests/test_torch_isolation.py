"""The port stands alone: importing every module of ``tpu_tfrecord_torch``
and ``chip_smoke.py`` loads neither jax nor the JAX package, and no source
file of the port imports them; the optional fsspec loads only when a
non-HTTP URL is opened."""

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
                 "tpu_tfrecord_torch.interop", "tpu_tfrecord_torch._cuda",
                 "tpu_tfrecord_torch._native", "tpu_tfrecord_torch.serving",
                 "tpu_tfrecord_torch.models.pipeline", "tpu_tfrecord_torch.serve_lm",
                 "tpu_tfrecord_torch.faults", "tpu_tfrecord_torch.service_protocol",
                 "tpu_tfrecord_torch.stall", "tpu_tfrecord_torch.autotune",
                 "tpu_tfrecord_torch.cache", "tpu_tfrecord_torch.vocabulary",
                 "tpu_tfrecord_torch.device.distributed", "tpu_tfrecord_torch.device.mesh",
                 "tpu_tfrecord_torch.httpfs", "tpu_tfrecord_torch.fs",
                 "tpu_tfrecord_torch.fleet", "tpu_tfrecord_torch.slo",
                 "tpu_tfrecord_torch.service", "tpu_tfrecord_torch.elastic",
                 "tpu_tfrecord_torch.models.sharded"):
        assert want in mods


@pytest.mark.parametrize("name", ["fleet", "slo", "service", "elastic"])
def test_fleet_and_slo_import_only_the_port(name):
    """``fleet.py``, ``slo.py``, the data service's ``service.py`` and its
    scalers' ``elastic.py`` import the stdlib, torch, numpy and the port,
    and loading them alone loads no jax and nothing of the JAX package;
    ``service`` and ``elastic`` load no torch either, so a dispatcher that
    hosts a scaler starts without it."""
    tree = ast.parse(open(os.path.join(PKG, f"{name}.py")).read())
    roots = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            roots |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    allowed = set(sys.stdlib_module_names) | {"torch", "numpy", "tpu_tfrecord_torch"}
    assert roots <= allowed, roots - allowed
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"importlib.import_module('tpu_tfrecord_torch.{name}')\n"
        "print(json.dumps(sorted(m for m in sys.modules if m.split('.')[0] in\n"
        "                        ('jax', 'jaxlib', 'tpu_tfrecord', 'torch'))))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    if name not in ("service", "elastic"):
        loaded = [m for m in loaded if m.split(".")[0] != "torch"]
    assert loaded == []


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


def test_imports_load_no_fsspec_until_a_url_needs_it():
    """fsspec is optional: importing every module of the port (``httpfs``
    and ``fs`` included) and using an ``http://`` filesystem loads none of
    it; the first non-HTTP URL does."""
    code = (
        "import importlib, json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        f"for m in {port_modules()!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "from tpu_tfrecord_torch import fs, httpfs\n"
        "assert isinstance(fs.filesystem_for('http://127.0.0.1:1/x'), httpfs.HttpFS)\n"
        "before = sorted(m for m in sys.modules if m.split('.')[0] == 'fsspec')\n"
        "try:\n"
        "    fs.filesystem_for('memory://x')\n"
        "except ImportError:\n"
        "    pass\n"
        "after = 'fsspec' in sys.modules\n"
        "print(json.dumps([before, after]))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr
    before, after = json.loads(proc.stdout.strip().splitlines()[-1])
    assert before == []
    import importlib.util

    assert after == (importlib.util.find_spec("fsspec") is not None)


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


def test_native_library_is_built_and_loaded_from_the_port():
    """After the port's ``_native.load()`` the loaded library lies under
    ``tpu_tfrecord_torch/_build/`` and no file under ``tpu_tfrecord/`` is
    mapped into the process."""
    code = (
        "import json, sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from tpu_tfrecord_torch import _native\n"
        "_native.load()\n"
        "maps = sorted({line.split(None, 5)[5].strip() for line in open('/proc/self/maps')\n"
        "               if len(line.split(None, 5)) == 6})\n"
        "print(json.dumps({'lib': str(_native.lib_path()), 'maps': maps}))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=600)
    assert proc.returncode == 0, proc.stderr
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    build_dir = os.path.join(PKG, "_build") + os.sep
    assert out["lib"].startswith(build_dir)
    native = [m for m in out["maps"] if "tfrecord_native" in m]
    assert native and all(m.startswith(build_dir) for m in native), native
    jax_pkg = os.path.join(REPO, "tpu_tfrecord") + os.sep
    assert not [m for m in out["maps"] if m.startswith(jax_pkg)]


def _string_constants(path):
    """String literals of a source file, docstrings left out."""
    tree = ast.parse(open(path).read(), filename=path)
    docstrings = set()
    for node in ast.walk(tree):
        if isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef, ast.AsyncFunctionDef)):
            body = node.body
            if body and isinstance(body[0], ast.Expr) and isinstance(body[0].value, ast.Constant):
                docstrings.add(id(body[0].value))
    return [n.value for n in ast.walk(tree)
            if isinstance(n, ast.Constant) and isinstance(n.value, str) and id(n) not in docstrings]


@pytest.mark.parametrize("path", [p for p in port_sources() if os.sep + "tpu_tfrecord_torch" + os.sep in p],
                         ids=lambda p: os.path.relpath(p, REPO))
def test_source_names_no_path_under_the_jax_package(path):
    import re

    for s in _string_constants(path):
        assert not re.search(r"(^|[^\w])tpu_tfrecord([/\\]|$)", s), (path, s)


def test_concurrent_first_builds_compile_once(tmp_path):
    """Processes that start together on an empty build dir all load a whole
    library: one compiles under the lock, the others wait and load it."""
    code = (
        "import sys\n"
        f"sys.path.insert(0, {REPO!r})\n"
        "from pathlib import Path\n"
        "from tpu_tfrecord_torch import _native\n"
        "_native.BUILD_DIR = Path(sys.argv[1])\n"
        "print(hex(_native.crc32c(b'123456789')))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path)], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    for proc in procs:
        out, err = proc.communicate(timeout=600)
        assert proc.returncode == 0, err
        assert out.strip() == "0xe3069283"
    built = sorted(p.name for p in tmp_path.iterdir())
    assert built == ["libtfrecord_native-" + _lib_digest() + ".so", "tfrecord_native.lock"]


def _lib_digest():
    from tpu_tfrecord_torch import _native

    return _native.lib_path().name[len("libtfrecord_native-"):-len(".so")]
