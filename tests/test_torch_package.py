"""The port's package data ships every source it compiles at first use: the
``tpu_tfrecord_torch`` entry of ``[tool.setuptools.package-data]`` in
``pyproject.toml`` must cover every file under ``tpu_tfrecord_torch/csrc/``
(the CUDA kernels for nvcc, the native host library's C++ for g++)."""

import fnmatch
import os
import tomllib

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "tpu_tfrecord_torch")


def port_package_data():
    with open(os.path.join(REPO, "pyproject.toml"), "rb") as fh:
        conf = tomllib.load(fh)
    return conf["tool"]["setuptools"]["package-data"]["tpu_tfrecord_torch"]


def csrc_files():
    out = []
    for root, _, files in os.walk(os.path.join(PKG, "csrc")):
        out += [os.path.relpath(os.path.join(root, f), PKG).replace(os.sep, "/") for f in files]
    return sorted(out)


def test_csrc_is_not_empty():
    assert "csrc/tfrecord_native.cc" in csrc_files()
    assert "csrc/interaction.cu" in csrc_files()


@pytest.mark.parametrize("path", csrc_files())
def test_package_data_covers_csrc_file(path):
    globs = port_package_data()
    assert any(fnmatch.fnmatchcase(path, g) for g in globs), (path, globs)


def test_sources_compiled_at_first_use_are_shipped():
    from tpu_tfrecord_torch import _cuda, _native

    globs = port_package_data()
    for src in (_native.SRC, _cuda.CSRC / "interaction.cu"):
        rel = os.path.relpath(src, PKG).replace(os.sep, "/")
        assert any(fnmatch.fnmatchcase(rel, g) for g in globs), rel
