"""The port's serving engine (``tpu_tfrecord_torch.serving``) on the CPU,
without sockets: ``ServePolicy``, the serving verdict, admission (a full
queue sheds exactly the excess, loudly, with a Retry-After hint),
deadlines at admission and at the tick under a fake clock, cancellation,
request spans, and the continuous-batching engine's tokens against the
port's ``sequential_reference`` and the JAX ``sequential_reference`` on
the same weights, token for token."""

import jax
import numpy as np
import pytest
import torch

from tpu_tfrecord import serving as jserving
from tpu_tfrecord.models import lm as jlm
from tpu_tfrecord.tpu import create_mesh
from tpu_tfrecord_torch import interop, telemetry
from tpu_tfrecord_torch.metrics import Metrics
from tpu_tfrecord_torch.models import lm
from tpu_tfrecord_torch.serving import (
    DeadlineExpired,
    ServePolicy,
    ServeRejected,
    ServingEngine,
    sequential_reference,
)

torch.set_num_threads(1)

KW = dict(vocab_size=96, d_model=32, n_heads=2, n_layers=4, max_len=16, n_virtual=1)
CFG = lm.LMConfig(**KW)
MB = 4
STAGES = 2


@pytest.fixture(scope="module")
def model():
    """The JAX init's weights in both packages (the port's through interop)."""
    jcfg = jlm.LMConfig(n_micro=4, **KW)
    jp = jax.tree.map(np.asarray, jlm.init_params(jax.random.key(0), jcfg))
    return jp, jcfg, interop.lm_params_from_jax(jp, CFG, device="cpu")


def windows(n, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, CFG.vocab_size, size=CFG.max_len).astype(np.int32) for _ in range(n)]


class FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def engine(model, clock=None, **pol):
    metrics = Metrics()
    kw = {} if clock is None else {"clock": clock}
    eng = ServingEngine(model[2], CFG, STAGES, policy=ServePolicy(mb=MB, **pol),
                        metrics=metrics, device="cpu", **kw)
    return eng, metrics


def reference(model, reqs):
    return sequential_reference(model[2], CFG, STAGES, reqs, MB, device="cpu")


class TestServePolicy:
    def test_validation(self):
        with pytest.raises(ValueError, match="mb"):
            ServePolicy(mb=0)
        with pytest.raises(ValueError, match="max_queue"):
            ServePolicy(max_queue=0)
        with pytest.raises(ValueError, match="retry_after_s"):
            ServePolicy(retry_after_s=-1.0)

    def test_hint_scales_with_queue_pressure_as_in_jax(self):
        pol, jpol = ServePolicy(mb=4, retry_after_s=0.1), jserving.ServePolicy(mb=4, retry_after_s=0.1)
        for depth in (0, 3, 4, 8, 17):
            assert pol.hint(depth) == jpol.hint(depth)
        assert pol.hint(8) > pol.hint(4) > pol.hint(0) == pytest.approx(0.1)

    @pytest.mark.parametrize("p99,depth,want", [(None, 0, "unknown"), (100.0, 3, "meeting_slo"),
                                                (900.0, 8, "queue_bound"),
                                                (900.0, 0, "compute_bound")])
    def test_serving_verdict(self, p99, depth, want):
        from tpu_tfrecord import telemetry as jtelemetry

        assert telemetry.serving_verdict(p99, depth, 250.0, max_queue=16) == want
        assert jtelemetry.serving_verdict(p99, depth, 250.0, max_queue=16) == want

    def test_scaler_not_ported(self):
        """The replica autoscaler is ported: ``elastic.ServingScaler``
        constructs, and its first tick over an empty fleet spawns the
        floor, as the JAX one does."""
        from tpu_tfrecord import elastic as jelastic
        from tpu_tfrecord_torch import elastic, serving

        assert not hasattr(serving, "ServingScaler")  # it lives in elastic, as in JAX
        decisions = []
        for mod in (elastic, jelastic):
            spawned = []
            s = mod.ServingScaler(
                lambda: spawned.append(f"h:{len(spawned)}") or spawned[-1],
                policy=mod.ScalerPolicy(min_workers=1, max_workers=2),
                status_fn=lambda addr: {"queue_depth": 0, "completed": 0},
                drain_fn=lambda addr: {"ok": True})
            decisions.append(s.step())
            assert s.replicas == spawned == ["h:0"]
            assert s.step() is None  # at the floor, no verdict streak yet
        assert decisions[0] == decisions[1] == {
            "tick": 1, "action": "scale_up", "reason": "below_min",
            "replicas": 0, "target": 1, "addr": "h:0"}


class TestAdmission:
    def test_queue_full_shed_loudly_with_hint(self, model):
        eng, metrics = engine(model, max_queue=3)
        ws = windows(4, seed=1)
        for w in ws[:3]:
            eng.submit(w, 1)
        with pytest.raises(ServeRejected, match="queue full") as ei:
            eng.submit(ws[3], 1)
        assert ei.value.retry_after_s > 0
        assert metrics.counter("serve.rejected") == 1
        eng.stop()

    def test_draining_rejects_new_requests(self, model):
        eng, _ = engine(model)
        eng.drain()
        with pytest.raises(ServeRejected, match="draining"):
            eng.submit(windows(1)[0], 1)

    def test_deadline_unmeetable_at_admission(self, model):
        clock = FakeClock()
        eng, metrics = engine(model, clock=clock)
        clock.advance(10.0)
        with pytest.raises(DeadlineExpired, match="admission"):
            eng.submit(windows(1)[0], 1, deadline_s=0.0)
        assert metrics.counter("serve.deadline_expired") == 1
        eng.stop()

    def test_bad_requests_rejected(self, model):
        eng, _ = engine(model)
        with pytest.raises(ValueError, match="window shape"):
            eng.submit(np.zeros(7, np.int32), 1)
        with pytest.raises(ValueError, match="n_new"):
            eng.submit(windows(1)[0], 0)
        eng.stop()

    def test_overload_sheds_exactly_the_excess(self, model):
        """A burst of 10 against a queue of 3: exactly 7 shed (counted),
        every admitted request served with the reference tokens, none
        late."""
        eng, metrics = engine(model, max_queue=3)
        admitted, shed = [], 0
        for w in windows(10, seed=2):
            try:
                admitted.append((w, eng.submit(w, 2, deadline_s=60.0)))
            except ServeRejected:
                shed += 1
        assert len(admitted) == 3 and shed == 7
        assert metrics.counter("serve.rejected") == 7
        eng.run_until_idle()
        want = reference(model, [(w, 2) for w, _ in admitted])
        assert [req.result(timeout=0) for _, req in admitted] == want
        assert metrics.counter("serve.deadline_expired") == 0
        assert metrics.counter("serve.requests") == 3
        eng.stop()


class TestEngineParity:
    def test_multiplexed_equals_port_and_jax_sequential(self, model):
        """Mixed-length requests packed and refilled across ticks give the
        tokens of one-at-a-time runs: the port's oracle and the JAX one on
        the same weights."""
        jp, jcfg, _ = model
        eng, metrics = engine(model, max_queue=32)
        reqs = [(w, 1 + i % 3) for i, w in enumerate(windows(7, seed=3))]
        handles = [eng.submit(w, n) for w, n in reqs]
        eng.run_until_idle()
        got = [h.result(timeout=0) for h in handles]
        assert got == reference(model, reqs)
        mesh = create_mesh({"pipe": STAGES}, jax.devices()[:STAGES])
        assert got == jserving.sequential_reference(jp, jcfg, mesh, reqs, MB)
        assert metrics.counter("serve.requests") == 7
        assert metrics.counter("serve.ticks") > 0
        rep = eng.report()
        assert rep["completed"] == 7 and rep["queue_depth"] == 0 and rep["in_flight"] == 0
        assert rep["p99_ms"] is not None and rep["verdict"] in ("meeting_slo", "compute_bound")
        eng.stop()

    def test_interleaved_stages_serve_the_same_tokens(self, model):
        """The (S, V) layout does not change a request's tokens: (1, 2) and
        (2, 2) against the (2, 1) oracle."""
        reqs = [(w, 3) for w in windows(5, seed=4)]
        want = reference(model, reqs)
        for stages, virtual in ((1, 2), (2, 2)):
            cfg = lm.LMConfig(**dict(KW, n_virtual=virtual))
            eng = ServingEngine(model[2], cfg, stages, policy=ServePolicy(mb=MB, max_queue=32),
                                metrics=Metrics(), device="cpu")
            handles = [eng.submit(w, n) for w, n in reqs]
            eng.run_until_idle()
            assert [h.result(timeout=0) for h in handles] == want
            eng.stop()

    def test_deadline_expiry_in_flight_frees_slot_without_perturbing(self, model):
        clock = FakeClock()
        eng, metrics = engine(model, clock=clock, max_queue=32)
        ws = windows(4, seed=4)
        survivors = [eng.submit(w, 3) for w in ws[:3]]
        doomed = eng.submit(ws[3], 3, deadline_s=1.5)
        assert eng.step() == 4
        clock.advance(2.0)  # the deadline passes mid-generation
        while eng.step() > 0:
            pass
        with pytest.raises(DeadlineExpired):
            doomed.result(timeout=0)
        assert len(doomed.out) < 3, "an expired request must not be served late"
        assert metrics.counter("serve.deadline_expired") == 1
        want = reference(model, [(w, 3) for w in ws[:3]])
        assert [h.result(timeout=0) for h in survivors] == want
        eng.stop()

    def test_deadline_in_queue_never_served(self, model):
        """A request still queued when its deadline passes is dropped at
        the pack and never takes a slot."""
        clock = FakeClock()
        eng, metrics = engine(model, clock=clock, max_queue=32)
        ws = windows(6, seed=6)
        first = [eng.submit(w, 2) for w in ws[:MB]]
        late = eng.submit(ws[MB], 2, deadline_s=0.5)
        eng.step()          # the first MB fill the microbatch, `late` waits
        clock.advance(1.0)
        eng.run_until_idle()
        with pytest.raises(DeadlineExpired):
            late.result(timeout=0)
        assert late.out == [] and late.first_pack is None
        assert [h.result(timeout=0) for h in first] == reference(model, [(w, 2) for w in ws[:MB]])
        assert metrics.counter("serve.deadline_expired") == 1
        eng.stop()

    def test_cancel_frees_slot_without_perturbing(self, model):
        eng, _ = engine(model, max_queue=32)
        ws = windows(4, seed=5)
        keep = [eng.submit(w, 3) for w in ws[:3]]
        gone = eng.submit(ws[3], 3)
        assert eng.step() == 4
        eng.cancel(gone)
        eng.run_until_idle()
        with pytest.raises(ServeRejected, match="cancelled"):
            gone.result(timeout=0)
        assert [h.result(timeout=0) for h in keep] == reference(model, [(w, 3) for w in ws[:3]])
        eng.stop()

    def test_engine_thread_serves_and_drains(self, model):
        eng, _ = engine(model, max_queue=32)
        eng.start()
        try:
            reqs = [(w, 2) for w in windows(5, seed=8)]
            handles = [eng.submit(w, n) for w, n in reqs]
            assert [h.result(timeout=60) for h in handles] == reference(model, reqs)
            assert eng.drain(timeout=30)
        finally:
            eng.stop()


class TestRequestSpans:
    @pytest.fixture(autouse=True)
    def _recorder(self):
        telemetry.RECORDER.clear()
        telemetry.enable()
        yield
        telemetry.disable()
        telemetry.RECORDER.clear()

    def test_one_root_span_per_request_with_exact_duration(self, model):
        clock = FakeClock()
        clock.advance(100.0)
        eng, _ = engine(model, clock=clock, max_queue=32)
        ws = windows(3, seed=9)
        served = [eng.submit(w, 2) for w in ws[:2]]
        doomed = eng.submit(ws[2], 2, deadline_s=0.5)
        eng.step()
        clock.advance(1.0)
        eng.run_until_idle()
        with pytest.raises(DeadlineExpired):
            doomed.result(timeout=0)
        roots = [s for s in telemetry.RECORDER.spans() if s[0] == "serve.request"]
        assert len(roots) == 3
        by_rid = {s[4]["rid"]: s for s in roots}
        for req in served + [doomed]:
            name, t0, dur, _, attrs, ph = by_rid[req.rid]
            assert t0 == int(req.birth * 1e9) and ph == "X"
            assert attrs["trace_id"] == req.trace_id and attrs["span_id"] == req.span_id
        assert by_rid[doomed.rid][4]["status"] == "deadline_expired"
        assert any(s[0] == "serve.deadline_expired" for s in telemetry.RECORDER.spans())
        ticks = [s for s in telemetry.RECORDER.spans() if s[0] == "serve.tick"]
        assert ticks and all(s[4]["parent_span_id"] for s in ticks)
        eng.stop()
