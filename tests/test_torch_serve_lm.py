"""The serve_lm twin (``tpu_tfrecord_torch.serve_lm``) on the CPU, serving a
4-layer checkpoint that the JAX example's ``LMCheckpoint`` wrote, with a
second generation parked mid-commit (the checkpoint chaos seam, then
SIGKILL): the restore must return the complete generation, bit for bit;
the timed pass prints its ``serve_lm OK:`` line with the streamed logits
bitwise equal to the batch path and within 1e-5 of the JAX ``LMStream``'s;
``--serve`` runs a replica that answers with the sequential reference's
tokens and exits 0 on SIGTERM, and with ``--spool-dir`` it spools."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from tpu_tfrecord.models import lm as jlm
from tpu_tfrecord.tpu import create_mesh
from tpu_tfrecord_torch import serve_lm, serving
from tpu_tfrecord_torch.checkpoint import tree_flatten

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# writes gen 4 complete, then parks generation 8 after its shard, before
# its manifest (the checkpoint layer's chaos seam)
WRITER = r"""
import os, sys
sys.path.insert(0, {repo!r}); sys.path.insert(0, os.path.join({repo!r}, "examples"))
import jax
jax.config.update("jax_platforms", "cpu")
import optax
from tpu_tfrecord.models import lm
from train_lm import LMCheckpoint
cfg = lm.LMConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=4, max_len=64)
params = lm.init_params(jax.random.key(0), cfg)
opt = optax.adam(3e-3).init(params)
ck = LMCheckpoint({ckpt!r})
ck.save(4, (params, opt), {{"input": None, "packer": None}})
ck.wait()
print("saved 4", flush=True)
ck.save(8, (jax.tree.map(lambda a: a * 2, params), opt), {{"input": None, "packer": None}})
ck.wait()
"""


def jax_params():
    cfg = jlm.LMConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=4, max_len=64)
    return jax.tree.map(np.asarray, jlm.init_params(jax.random.key(0), cfg))


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("serve_lm") / "ckpt")
    mark = d + ".parked"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", TFR_CKPT_CHAOS_STAGE="pre_manifest",
               TFR_CKPT_CHAOS_MARK=mark, TFR_CKPT_CHAOS_SKIP="1")
    proc = subprocess.Popen([sys.executable, "-c", WRITER.format(repo=REPO, ckpt=d)], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        deadline = time.monotonic() + 180
        while not os.path.exists(mark):
            assert proc.poll() is None, proc.communicate(timeout=30)
            assert time.monotonic() < deadline, "the writer never parked"
            time.sleep(0.05)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.communicate(timeout=60)
    gens = sorted(n for n in os.listdir(d) if n.startswith("gen-"))
    assert gens == ["gen-00000004", "gen-00000008"]
    assert not os.path.exists(os.path.join(d, "gen-00000008", "MANIFEST.json"))
    return d


def test_load_returns_the_complete_generation(ckpt):
    cfg = serve_lm.make_config(2)
    step, state = serve_lm.load_checkpoint(ckpt, serve_lm.checkpoint_template(cfg))
    assert step == 4
    want = jax.tree.leaves(jax_params())
    got = tree_flatten(state[0])[0]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), w)


def test_load_rejects_a_checkpoint_of_another_depth(ckpt):
    cfg = serve_lm.make_config(1)
    two = serve_lm.checkpoint_template(serve_lm.lm.LMConfig(
        vocab_size=256, d_model=64, n_heads=4, n_layers=2, max_len=64))
    with pytest.raises(ValueError, match="shape"):
        serve_lm.load_checkpoint(ckpt, two)
    assert serve_lm.load_checkpoint(ckpt + "-empty", serve_lm.checkpoint_template(cfg))[0] is None


@pytest.mark.parametrize("pipe,virtual", [(1, 2), (2, 2)])
def test_one_shot_matches_jax_stream(ckpt, pipe, virtual, capsys):
    serve_lm.main(["--device", "cpu", "--ckpt-dir", ckpt, "--pipe", str(pipe), "--virtual",
                   str(virtual), "--requests", "6"])
    out = capsys.readouterr().out.splitlines()
    assert out[0] == f"serving checkpoint step 4 on pipe={pipe} virtual={virtual} mb=8 device=cpu"
    line = json.loads(out[-1].split("serve_lm OK: ", 1)[1])
    assert line["byte_identical_to_batch"] is True and line["ckpt_step"] == 4
    assert line["requests"] == 6 and line["shape"] == f"mb=8 L=64 S={pipe} V={virtual}"
    # the same pass against the JAX stream on the same weights
    cfg = serve_lm.make_config(virtual)
    _, state = serve_lm.load_checkpoint(ckpt, serve_lm.checkpoint_template(cfg))
    _, outs = serve_lm.one_shot(state[0], cfg, pipe, 8, 6, "cpu")
    jcfg = jlm.LMConfig(vocab_size=256, d_model=64, n_heads=4, n_layers=4, max_len=64,
                        n_micro=4, n_virtual=virtual)
    stream = jlm.LMStream(jax_params(), jcfg, create_mesh({"pipe": pipe}, jax.devices()[:pipe]))
    reqs = [jlm.make_synthetic_tokens(jcfg, 8, seed=1000 + i) for i in range(6)]
    want = [o for r in reqs for o in stream.submit(r)] + stream.flush()
    assert len(want) == len(outs) == 6
    for a, b in zip(outs, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-5)


def test_replica_mode_serves_and_drains(ckpt):
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.serve_lm", "--serve", "--device", "cpu",
           "--ckpt-dir", ckpt, "--pipe", "1", "--virtual", "2", "--mb", "4"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready = {}
        reader = threading.Thread(target=lambda: ready.update(json.loads(proc.stdout.readline())))
        reader.start()
        reader.join(timeout=120)
        assert "addr" in ready, proc.stderr.read() if proc.poll() is not None else "no ready line"
        cfg = serve_lm.make_config(2)
        _, state = serve_lm.load_checkpoint(ckpt, serve_lm.checkpoint_template(cfg))
        w = np.random.default_rng(0).integers(0, 256, size=64).astype(np.int32)
        c = serving.ServeClient([ready["addr"]], timeout_s=60.0)
        try:
            got = c.generate(w, n_new=3)
        finally:
            c.close()
        assert got == serving.sequential_reference(state[0], cfg, 1, [(w, 3)], 4, device="cpu")[0]
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()


def test_spool_refused(ckpt, tmp_path):
    """``--serve --spool-dir``, once refused, spools the replica under
    ``--role``; SIGTERM's drain lands the ``final: true`` snapshot with the
    request it served."""
    from tpu_tfrecord_torch import fleet

    spool_dir = str(tmp_path / "spool")
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.serve_lm", "--serve", "--device", "cpu",
           "--ckpt-dir", ckpt, "--pipe", "1", "--virtual", "2", "--mb", "4",
           "--spool-dir", spool_dir, "--role", "lm-replica"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        ready = {}
        reader = threading.Thread(target=lambda: ready.update(json.loads(proc.stdout.readline())))
        reader.start()
        reader.join(timeout=120)
        assert "addr" in ready, proc.stderr.read() if proc.poll() is not None else "no ready line"
        w = np.random.default_rng(1).integers(0, 256, size=64).astype(np.int32)
        c = serving.ServeClient([ready["addr"]], timeout_s=60.0)
        try:
            assert len(c.generate(w, n_new=2)) == 2
        finally:
            c.close()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
        (name,) = os.listdir(spool_dir)
        snap = fleet.read_spool(os.path.join(spool_dir, name))
        assert snap.final and snap.role == "lm-replica" and snap.pid == proc.pid
        assert snap.interval_s == 0.2 and snap.counters["serve.requests"] == 1
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        proc.stdout.close()
        proc.stderr.close()
