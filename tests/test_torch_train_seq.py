"""The port's sequence trainers (``tpu_tfrecord_torch.train_lm``,
``tpu_tfrecord_torch.train_longdoc``) against the JAX examples on the CPU.

- Both generators write the JAX examples' records, byte for byte.
- The LM twin's packed stream (``packed_stream`` over the port's shuffled
  dataset and ``TokenPacker``) gives the JAX ``packed_stream``'s batches,
  digests, input positions and packer carries for 12 batches.
- An LM checkpoint written through the JAX ``LMCheckpoint``
  (``AsyncCheckpointer``, ``(params, optax.adam state)``) restores into the
  twin, and one the twin wrote restores through the JAX ``LMCheckpoint``;
  one more step on each side then gives the same loss.
- The twin killed with SIGKILL after step 10 resumes at step 8 and repeats
  the uninterrupted run's digests and losses (bit-equal on the CPU, one
  torch thread).
- The long_doc twin's host batches equal the JAX
  ``host_batch_from_columnar`` batches (bf16 frames compared as uint16
  bits), and its bf16 frames equal the float32 pad cast with
  ``.to(torch.bfloat16)``.
"""

import functools
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from tpu_tfrecord import wire as jwire
from tpu_tfrecord.io.dataset import TFRecordDataset as JDataset
from tpu_tfrecord.models import lm as jlm
from tpu_tfrecord.tpu.ingest import TokenPacker as JPacker, host_batch_from_columnar as j_hbfc

from tpu_tfrecord_torch import train_lm as tw_lm, train_longdoc as tw_ld
from tpu_tfrecord_torch.checkpoint import tree_flatten
from tpu_tfrecord_torch.device.ingest import TokenPacker as TPacker, host_batch_from_columnar
from tpu_tfrecord_torch.io.dataset import TFRecordDataset as TDataset
from tpu_tfrecord_torch.models import lm as tlm, optim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "examples"))
import train_lm as jx_lm  # noqa: E402
import train_longdoc as jx_ld  # noqa: E402

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def lm_data(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("lm") / "data")
    tw_lm.generate(d)
    return d


def shard_records(d):
    return [list(jwire.read_records(os.path.join(d, f)))
            for f in sorted(os.listdir(d)) if f.startswith("part-")]


@pytest.mark.parametrize("which", ["lm", "longdoc"])
def test_generators_write_the_jax_examples_records(tmp_path, which):
    twin, jax_example = (tw_lm, jx_lm) if which == "lm" else (tw_ld, jx_ld)
    twin.generate(str(tmp_path / "port"), shards=2, **{"docs" if which == "lm" else "rows": 5})
    jax_example.generate(str(tmp_path / "jax"), shards=2, **{"docs" if which == "lm" else "rows": 5})
    got, want = shard_records(tmp_path / "port"), shard_records(tmp_path / "jax")
    assert len(got) == len(want) == 2
    assert got == want


def test_packed_stream_equals_jax(lm_data):
    def stream(ds_cls, packer_cls, packed_stream, schema):
        ds = ds_cls(lm_data, batch_size=tw_lm.READ_BATCH, schema=schema, num_epochs=4,
                    recordType="SequenceExample", shuffle=True, seed=0)
        snaps = {}
        out = []
        with ds.batches(None) as it:
            for n, b in enumerate(packed_stream(it, packer_cls(tw_lm.BATCH, tw_lm.SEQ_LEN), snaps)):
                out.append((b["tokens"], dict(snaps[n])))
                if n == 11:
                    break
        return out

    got = stream(TDataset, TPacker, tw_lm.packed_stream, tw_lm.make_schema())
    want = stream(JDataset, JPacker, jx_lm.packed_stream, jx_lm.make_schema())
    assert len(got) == len(want) == 12
    for (gb, gs), (wb, ws) in zip(got, want):
        assert gb.shape == (tw_lm.BATCH, tw_lm.SEQ_LEN + 1)
        np.testing.assert_array_equal(gb, wb)
        assert gs["digest"] == ws["digest"]
        assert gs["input"] == ws["input"]
        assert gs["packer"] == ws["packer"]


def small_cfgs():
    kw = dict(vocab_size=64, d_model=16, n_heads=4, n_layers=2, max_len=12)
    return jlm.LMConfig(dtype=jnp.float32, **kw), tlm.LMConfig(**kw)


def port_leaves(params, opt):
    """The twin's checkpoint leaves, in the order it saves them."""
    return [t.detach().numpy() for t in tree_flatten(optim.train_state(params, opt))[0]]


def test_lm_checkpoint_interchanges_both_ways(tmp_path):
    jcfg, tcfg = small_cfgs()
    tx = optax.adam(tw_lm.LR)
    jstep = jax.jit(functools.partial(jlm.train_step, cfg=jcfg, tx=tx))
    toks = [jlm.make_synthetic_tokens(jcfg, 4, seed=s) for s in range(4)]
    payload = {"input": "{}", "packer": {"residual": [1, 2], "pending": []}}

    # JAX writes step 2; the twin restores it
    jp = jlm.init_params(jax.random.key(0), jcfg)
    jo = tx.init(jp)
    for t in toks[:2]:
        jp, jo, _ = jstep(jp, jo, t)
    jck = jx_lm.LMCheckpoint(str(tmp_path / "from_jax"))
    jck.save(2, (jp, jo), payload)
    jck.close()
    tp = tlm.init_params(tcfg, torch.Generator().manual_seed(5), device="cpu")
    topt = optim.adam(tp, tw_lm.LR)
    tck = tw_lm.LMCheckpoint(str(tmp_path / "from_jax"))
    step, tree, got_payload = tck.load(optim.train_state(tp, topt))
    tck.close()
    assert step == 2 and got_payload == payload
    optim.load_train_state(tp, topt, tree)
    want = jax.tree.leaves(jax.tree.map(np.asarray, (jp, jo)))
    got = port_leaves(tp, topt)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    # one more step on both sides: the same loss
    jp, jo, jloss = jstep(jp, jo, toks[2])
    tloss = tlm.train_step(tp, topt, torch.from_numpy(toks[2]), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)

    # the twin writes step 3; JAX restores it
    tck = tw_lm.LMCheckpoint(str(tmp_path / "from_port"))
    tck.save(3, optim.train_state(tp, topt), payload)
    tck.close()
    template = jlm.init_params(jax.random.key(9), jcfg)
    jck = jx_lm.LMCheckpoint(str(tmp_path / "from_port"))
    step, (rp, ro), got_payload = jck.load((template, tx.init(template)))
    jck.close()
    assert step == 3 and got_payload == payload
    assert int(ro[0].count) == 3 and ro[0].count.dtype == jnp.int32
    for g, w in zip(jax.tree.leaves((rp, ro)), port_leaves(tp, topt)):
        np.testing.assert_array_equal(np.asarray(g), w)
    rp, ro, jloss = jstep(rp, ro, toks[3])
    tloss = tlm.train_step(tp, topt, torch.from_numpy(toks[3]), tcfg)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=1e-5, atol=1e-5)


def committed(args, step):
    """Is generation ``step`` complete in the twin's ``--ckpt-dir``? Its
    manifest is written last."""
    ckpt_dir = args[args.index("--ckpt-dir") + 1]
    return os.path.exists(os.path.join(ckpt_dir, f"gen-{step:08d}", "MANIFEST.json"))


def run_twin(args, kill_after=None, deadline_s=120.0):
    """The LM twin in a subprocess on the CPU; with ``kill_after`` it is
    killed with SIGKILL once that step's lm_step line is out and the save
    before it is committed (the save is asynchronous: on a loaded machine
    its commit may land after later steps' lines; waited for at most
    ``deadline_s``)."""
    cmd = [sys.executable, "-m", "tpu_tfrecord_torch.train_lm", "--device", "cpu", *args]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    # one thread: torch's threaded CPU reductions may round a loss's last
    # bit differently from run to run
    env.update(PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    lines = []
    try:
        for line in proc.stdout:
            lines.append(line.rstrip())
            if kill_after is not None and line.startswith("lm_step ") and \
                    json.loads(line.split(" ", 1)[1])["step"] == kill_after:
                every = int(args[args.index("--save-every") + 1])
                deadline = time.monotonic() + deadline_s
                while not committed(args, kill_after // every * every) and \
                        time.monotonic() < deadline:
                    time.sleep(0.002)
                proc.send_signal(signal.SIGKILL)
                break
        proc.wait(timeout=300)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        err = proc.stderr.read()
        proc.stdout.close()
        proc.stderr.close()
    return proc.returncode, lines, err


def steps_of(lines):
    return {json.loads(ln.split(" ", 1)[1])["step"]: json.loads(ln.split(" ", 1)[1])
            for ln in lines if ln.startswith("lm_step ")}


def test_twin_kill_and_resume_continues_the_digests(lm_data, tmp_path, capsys, monkeypatch):
    monkeypatch.delenv("LM_MESH", raising=False)
    common = ["--data-dir", lm_data, "--steps", "12", "--save-every", "4"]
    # the uninterrupted run in this process (one torch thread, as the
    # subprocesses run)
    tw_lm.main(["--device", "cpu", *common, "--ckpt-dir", str(tmp_path / "ref"),
                "--digest-out", str(tmp_path / "ref.jsonl")])
    # the default --mesh (LM_MESH, else dp_sp) trains as dp and says so first
    ref = capsys.readouterr().out.splitlines()
    assert ref[0].startswith("mesh: {'data': 1}"), ref[:2]
    assert ref[1] == "fresh start" and any(ln.startswith("done: 12 steps") for ln in ref)
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--digest-out", str(tmp_path / "run.jsonl")]
    rc, first, err = run_twin(common + ckpt, kill_after=10)
    assert rc == -signal.SIGKILL, (rc, err)
    rc, second, err = run_twin(common + ckpt)
    assert rc == 0, err
    assert second[1] == "resumed at step 8", second[:3]
    want, got = steps_of(ref), steps_of(second)
    assert sorted(got) == list(range(9, 13))
    for s in range(9, 13):
        assert got[s] == want[s]  # digest and loss, bit for bit
    assert steps_of(first)[10] == want[10]


def test_twin_refuses_unported_flags(lm_data):
    # every --mesh kind trains on one card (test_torch_train_lm_mesh.py),
    # and --moe / --diagnostics train (test_torch_train_moe.py); --virtual 2
    # still needs --mesh dp_pp, and --moe is refused with dp_pp as in JAX
    for flags in (["--virtual", "2"], ["--mesh", "dp_pp", "--moe", "4"],
                  ["--mesh", "dp_sp", "--virtual", "2"]):
        with pytest.raises(SystemExit):
            tw_lm.main(["--device", "cpu", "--data-dir", lm_data, *flags])


def test_longdoc_host_batches_equal_jax(tmp_path):
    d = str(tmp_path / "data")
    tw_ld.generate(d, shards=2, rows=40)
    kw = dict(batch_size=16, num_epochs=1, recordType="SequenceExample", shuffle=True, seed=0)
    tds = TDataset(d, schema=tw_ld.make_schema(), **kw)
    jds = JDataset(d, schema=jx_ld.make_schema(), **kw)
    n = 0
    with tds.batches(None) as tit, jds.batches(None) as jit_:
        for tcb, jcb in zip(tit, jit_):
            got = tw_ld.host_batch(tcb, tds.schema)
            want = j_hbfc(jcb, jds.schema, pad_to={"frames": (tw_ld.MAX_LEN, tw_ld.SEQ_DIM)},
                          cast={"frames": ml_dtypes.bfloat16})
            want.pop("frames_inner_len")
            assert sorted(got) == sorted(want)
            assert got["frames"].dtype == torch.bfloat16
            np.testing.assert_array_equal(got["frames"].view(torch.int16).numpy().view(np.uint16),
                                          want["frames"].view(np.uint16))
            for k in ("frames_len", "label"):
                assert got[k].dtype == want[k].dtype
                np.testing.assert_array_equal(got[k], want[k])
            f32 = host_batch_from_columnar(tcb, tds.schema,
                                           pad_to={"frames": (tw_ld.MAX_LEN, tw_ld.SEQ_DIM)})
            assert torch.equal(torch.from_numpy(f32["frames"]).to(torch.bfloat16).view(torch.int16),
                               got["frames"].view(torch.int16))
            n += 1
    assert n == 5


def test_longdoc_twin_refuses_unported_env(monkeypatch):
    """``LONGDOC_SP_ATTENTION`` is ported (the twin over ranks: in
    test_torch_seq_mesh.py): the config takes it, and a flavour that is
    neither 'ring' nor 'ulysses' is refused at init, as in JAX."""
    monkeypatch.setenv("LONGDOC_SP_ATTENTION", "ulysses")
    assert tw_ld.make_config().sp_attention == "ulysses"
    monkeypatch.setenv("LONGDOC_SP_ATTENTION", "zigzag")
    with pytest.raises(ValueError, match="sp_attention"):
        tw_ld.long_doc.init_params(tw_ld.make_config(), device="cpu")
    monkeypatch.delenv("LONGDOC_SP_ATTENTION")
    assert tw_ld.make_config().sp_attention == "ring"
    # LONGDOC_MOE_EXPERTS is ported: the twin's config takes it and its
    # MoE model initialises
    monkeypatch.setenv("LONGDOC_MOE_EXPERTS", "4")
    cfg = tw_ld.make_config()
    assert cfg.moe_experts == 4
    params = tw_ld.long_doc.init_params(cfg, device="cpu")
    assert params["layers"][0]["moe"]["w_in"].shape == (4, 32, 128)


def test_cast_dtypes_of_the_port(tmp_path):
    """``cast`` takes ``torch.bfloat16`` (a bf16 CPU tensor, scalar
    columns too) and numpy or torch dtypes numpy has; a bfloat16 numpy
    dtype from an extension package raises, naming the column."""
    d = str(tmp_path / "data")
    tw_ld.generate(d, shards=1, rows=4)
    ds = TDataset(d, batch_size=4, schema=tw_ld.make_schema(), recordType="SequenceExample")
    with ds.batches(None) as it:
        cb = next(it)
    pad = {"frames": (tw_ld.MAX_LEN, tw_ld.SEQ_DIM)}
    hb = host_batch_from_columnar(cb, ds.schema, pad_to=pad,
                                  cast={"frames": torch.float16, "label": torch.bfloat16})
    assert hb["frames"].dtype == np.float16 and hb["label"].dtype == torch.bfloat16
    plain = host_batch_from_columnar(cb, ds.schema, pad_to=pad)
    assert torch.equal(hb["label"], torch.from_numpy(plain["label"]).to(torch.bfloat16))
    for bad in (ml_dtypes.bfloat16, torch.complex64, "not-a-dtype"):
        with pytest.raises(ValueError, match="'frames'"):
            host_batch_from_columnar(cb, ds.schema, pad_to=pad, cast={"frames": bad})
