"""``--mesh`` of the port's train_lm twin on one device: for four of the
JAX example's five kinds the port picks what the JAX ``pick_mesh`` picks
when ``jax.devices()`` holds one device (dp with 2 layers); for ``dp_pp``
it picks the JAX two-device result (4 layers in 2 stages), whose pipe axis
the one card runs as a tensor dimension, and ``python -m
tpu_tfrecord_torch.train_lm --mesh dp_pp --device cpu`` trains it."""

import os
import sys

import jax
import pytest
import torch

from tpu_tfrecord_torch import train_lm as tw

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import train_lm as jx  # noqa: E402

torch.set_num_threads(1)


# the choices of the JAX example's --mesh
KINDS = ("dp", "dp_sp", "dp_pp", "dp_fsdp", "dp_fsdp_pp")


@pytest.mark.parametrize("virtual", [1, 2])
@pytest.mark.parametrize("kind", KINDS)
def test_pick_mesh_matches_jax_on_one_device(kind, virtual, monkeypatch):
    # dp_pp: the JAX result on two devices, the pipeline the one card runs
    devices = jax.devices()[:2 if kind == "dp_pp" else 1]
    monkeypatch.setattr(jax, "devices", lambda *a, **k: devices)
    jmesh, jaxes, jlayers = jx.pick_mesh(kind, virtual)
    shape, axes, layers = tw.pick_mesh(kind, virtual)
    assert shape == dict(jmesh.shape)
    assert axes == jaxes
    assert layers == jlayers == (4 if kind == "dp_pp" else 2)


def test_unknown_kind_refused():
    assert tw.MESH_KINDS == KINDS
    with pytest.raises(ValueError, match="--mesh"):
        tw.pick_mesh("tp")


def test_dp_pp_trains_as_dp_with_two_layers(tmp_path, capsys):
    # (named for when dp_pp degraded to dp on one card; it now trains the
    # JAX example's 4 layers in 2 stages through the schedule)
    data = str(tmp_path / "data")
    tw.generate(data, shards=2, docs=64)
    tw.main(["--device", "cpu", "--mesh", "dp_pp", "--virtual", "2", "--steps", "2",
             "--save-every", "8", "--epochs", "1", "--data-dir", data,
             "--ckpt-dir", str(tmp_path / "ck")])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == ("mesh: {'pipe': 2, 'data': 1} mode=dp_pp (one device: 4 layers in "
                      "2 stages, n_micro 8, virtual 2)")
    assert out[1] == "fresh start"
    assert any(ln.startswith("done: 2 steps") for ln in out)
