"""The port's one-device pipeline schedule (``tpu_tfrecord_torch.models.pipeline``)
against the JAX package's on the same numpy weights and microbatches.

- ``pipeline_reference`` and the batch path ``pipeline_apply`` against the
  JAX ``pipeline_reference`` for S in {1, 2, 4} and V in {1, 2} (f32,
  rtol = atol = 1e-5; the JAX ``pipeline_apply`` composes stages through a
  ``shard_map`` scan that this jax rejects, so the sequential oracle is
  the reference);
- ``PipelineStream`` against the JAX ``PipelineStream`` on a pipe mesh of
  the CPU's fake devices: outputs at 1e-5, how many pop at each push (the
  S·V latency), tags FIFO, flush, pushes after a flush, ``reset``;
- the stream against the port's batch path bitwise, and a slot's bytes
  independent of its neighbours and of its row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_tfrecord.models import pipeline as jpipe
from tpu_tfrecord.tpu import create_mesh
from tpu_tfrecord_torch.models import pipeline as tpipe

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-5)
D = 8


def stage_weights(n_stages, n_virtual, seed=0):
    rng = np.random.default_rng(seed)
    lead = (n_stages, n_virtual) if n_virtual > 1 else (n_stages,)
    return {"w": (rng.normal(size=lead + (D, D)) * 0.5).astype(np.float32),
            "b": (rng.normal(size=lead + (D,)) * 0.1).astype(np.float32)}


def j_stage(p, x):
    return jax.nn.gelu(x @ p["w"] + p["b"])


def t_stage(p, x):
    return torch.nn.functional.gelu(x @ p["w"] + p["b"], approximate="tanh")


def both(n_stages, n_virtual, seed=0):
    w = stage_weights(n_stages, n_virtual, seed)
    return ({k: jnp.asarray(v) for k, v in w.items()},
            {k: torch.from_numpy(v) for k, v in w.items()})


def micro(m, rows=2, seed=0):
    return np.random.default_rng(seed).normal(size=(m, rows, D)).astype(np.float32)


def serve(stream, xs, tagged=False):
    """Every slice through the stream, then a flush: (outputs FIFO as
    numpy, outputs popped by each push)."""
    outs, per_push = [], []
    for i, x in enumerate(xs):
        got = stream.push_tagged(x, tag=i) if tagged else stream.push(x)
        per_push.append(len(got))
        outs += got
    outs += stream.flush_tagged() if tagged else stream.flush()
    if tagged:
        return [(np.asarray(o), t) for o, t in outs], per_push
    return [np.asarray(o) for o in outs], per_push


@pytest.mark.parametrize("n_virtual", [1, 2])
@pytest.mark.parametrize("n_stages", [1, 2, 4])
def test_batch_path_and_oracle_match_jax_reference(n_stages, n_virtual):
    jp, tp = both(n_stages, n_virtual, seed=n_stages + n_virtual)
    xs = micro(7, seed=n_stages)
    want = np.asarray(jpipe.pipeline_reference(j_stage, jp, jnp.asarray(xs), n_virtual=n_virtual))
    ref = tpipe.pipeline_reference(t_stage, tp, torch.from_numpy(xs), n_virtual=n_virtual)
    got = tpipe.pipeline_apply(t_stage, tp, torch.from_numpy(xs), n_virtual=n_virtual)
    np.testing.assert_allclose(ref.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the schedule composes the same chunks in the same order as the oracle
    assert torch.equal(got, ref)


@pytest.mark.parametrize("n_stages,n_virtual,m", [(1, 1, 3), (1, 2, 4), (2, 1, 5), (2, 2, 7),
                                                  (4, 1, 6), (4, 2, 9)])
def test_stream_matches_jax_stream(n_stages, n_virtual, m):
    jp, tp = both(n_stages, n_virtual, seed=3)
    xs = micro(m, seed=m)
    mesh = create_mesh({"pipe": n_stages}, jax.devices()[:n_stages])
    jouts, jpops = serve(jpipe.PipelineStream(j_stage, jp, mesh, n_virtual=n_virtual), xs)
    stream = tpipe.PipelineStream(t_stage, tp, n_virtual=n_virtual)
    touts, tpops = serve(stream, xs)
    assert tpops == jpops
    assert len(touts) == m and stream.served == m and stream.in_flight == 0
    for a, b in zip(touts, jouts):
        np.testing.assert_allclose(a, b, **TOL)
    batch = tpipe.pipeline_apply(t_stage, tp, torch.from_numpy(xs), n_virtual=n_virtual)
    for i in range(m):
        np.testing.assert_array_equal(touts[i], batch[i].numpy())


@pytest.mark.parametrize("n_stages,n_virtual", [(4, 1), (2, 2)])
def test_pipeline_latency_is_s_times_v_ticks(n_stages, n_virtual):
    """Nothing pops before push S (push S-1 at V = 1), at V = 1 one output
    pops a push from then on, and a flush ends S·V ticks after the last
    injection: its output's birth tick, inj + S·V - 1."""
    _, tp = both(n_stages, n_virtual)
    stream = tpipe.PipelineStream(t_stage, tp, n_virtual=n_virtual)
    pops = [len(stream.push(x)) for x in micro(8)]
    warm = n_stages - 1 if n_virtual == 1 else n_stages
    assert sum(pops[:warm]) == 0 and pops[warm] > 0
    if n_virtual == 1:
        assert pops[warm:] == [1] * (8 - warm)
    assert stream._t == stream._inj(7) + 1
    assert sum(pops) + len(stream.flush()) == 8
    assert stream._t == stream._inj(7) + n_stages * n_virtual


@pytest.mark.parametrize("n_stages,n_virtual", [(2, 2), (4, 1)])
def test_tags_pop_fifo_as_in_jax(n_stages, n_virtual):
    jp, tp = both(n_stages, n_virtual, seed=7)
    xs = micro(7, seed=7)
    mesh = create_mesh({"pipe": n_stages}, jax.devices()[:n_stages])
    jouts, jpops = serve(jpipe.PipelineStream(j_stage, jp, mesh, n_virtual=n_virtual), xs,
                         tagged=True)
    touts, tpops = serve(tpipe.PipelineStream(t_stage, tp, n_virtual=n_virtual), xs, tagged=True)
    assert tpops == jpops
    assert [t for _, t in touts] == [t for _, t in jouts] == list(range(7))
    for (a, _), (b, _) in zip(touts, jouts):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("n_stages,n_virtual", [(2, 1), (4, 2)])
def test_push_after_flush_rebases_as_in_jax(n_stages, n_virtual):
    """An idle drain (flush) mid-serve advances the clock; the next push
    re-bases onto the first usable injection slot, as the JAX stream does,
    and the outputs stay the batch path's."""
    jp, tp = both(n_stages, n_virtual, seed=9)
    xs = micro(6, seed=9)
    mesh = create_mesh({"pipe": n_stages}, jax.devices()[:n_stages])
    streams = (jpipe.PipelineStream(j_stage, jp, mesh, n_virtual=n_virtual),
               tpipe.PipelineStream(t_stage, tp, n_virtual=n_virtual))
    runs = []
    for stream in streams:
        outs, pops = [], []
        for i, x in enumerate(xs):
            got = stream.push(x)
            if i % 2 == 0:
                got += stream.flush()
            pops.append(len(got))
            outs += [np.asarray(o) for o in got]
        outs += [np.asarray(o) for o in stream.flush()]
        runs.append((outs, pops, stream._t))
    (jouts, jpops, jt), (touts, tpops, tt) = runs
    assert tpops == jpops and tt == jt
    batch = tpipe.pipeline_apply(t_stage, tp, torch.from_numpy(xs), n_virtual=n_virtual)
    for i in range(6):
        np.testing.assert_allclose(touts[i], jouts[i], **TOL)
        np.testing.assert_array_equal(touts[i], batch[i].numpy())


def test_reset_replays_identically():
    _, tp = both(4, 1)
    stream = tpipe.PipelineStream(t_stage, tp)
    xs = micro(5)
    first, pops1 = serve(stream, xs)
    stream.reset()
    second, pops2 = serve(stream, xs)
    assert pops1 == pops2
    for a, b in zip(first, second):
        np.testing.assert_array_equal(a, b)


def test_shape_and_dtype_changes_rejected():
    _, tp = both(2, 1)
    stream = tpipe.PipelineStream(t_stage, tp)
    stream.push(np.zeros((2, D), np.float32))
    with pytest.raises(ValueError, match="one shape"):
        stream.push(np.zeros((3, D), np.float32))
    with pytest.raises(ValueError, match="one dtype"):
        stream.push(np.zeros((2, D), np.float64))
    fixed = tpipe.PipelineStream(t_stage, tp, microbatch_shape=(2, D))
    with pytest.raises(ValueError, match="one shape"):
        fixed.push(np.zeros((4, D), np.float32))


def test_stage_stacks_validated():
    _, tp = both(2, 2)
    with pytest.raises(ValueError, match=r"\[S, V, \.\.\.\]"):
        tpipe.PipelineStream(t_stage, tp, n_virtual=3)
    with pytest.raises(ValueError, match="n_virtual must be >= 1"):
        tpipe.pipeline_apply(t_stage, tp, torch.zeros(1, 2, D), n_virtual=0)


def test_changing_one_slot_perturbs_no_other_slot():
    """A row's output is a function of that row alone: refilling one slot
    of one microbatch mid-stream leaves every other row's bytes as they
    were (continuous batching rests on it)."""
    s, v, m, rows = 2, 2, 6, 4
    _, tp = both(s, v, seed=21)
    xs = micro(m, rows, seed=21)
    stream = tpipe.PipelineStream(t_stage, tp, n_virtual=v)
    base, _ = serve(stream, xs)
    xs2 = xs.copy()
    xs2[3, 1] = np.random.default_rng(99).normal(size=D).astype(np.float32)
    stream.reset()
    got, _ = serve(stream, xs2)
    for i in range(m):
        keep = [r for r in range(rows) if i != 3 or r != 1]
        np.testing.assert_array_equal(got[i][keep], base[i][keep])
    assert not np.array_equal(got[3][1], base[3][1])


def test_slot_output_invariant_to_row_position():
    s, v, rows = 2, 2, 4
    _, tp = both(s, v, seed=5)
    row = np.random.default_rng(5).normal(size=D).astype(np.float32)
    outs = []
    for slot in range(rows):
        x = np.zeros((rows, D), np.float32)
        x[slot] = row
        stream = tpipe.PipelineStream(t_stage, tp, n_virtual=v)
        (out,) = [*stream.push(x), *stream.flush()]
        outs.append(out[slot].numpy())
    for slot in range(1, rows):
        np.testing.assert_array_equal(outs[slot], outs[0])
