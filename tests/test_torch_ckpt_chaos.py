"""Kill -9 matrix for the port's checkpoint layer, as
``tests/test_ckpt_chaos.py`` runs it for the JAX package.

This file is also its own worker: ``python test_torch_ckpt_chaos.py MODE
DIR --steps N --save-every K`` runs a deterministic loop that checkpoints
through ``AsyncCheckpointer`` (mode ``pytree``: a tree of CPU tensors) or
``save_state`` (mode ``state``), printing one line a step. The chaos seam
(``TFR_CKPT_CHAOS_STAGE`` / ``_MARK`` / ``_SKIP``) parks the writer at an
exact stage of generation 2 of 3, the test lands SIGKILL there, and a
clean relaunch must resume from the newest complete generation (step 4)
and end bit-identical to an uninterrupted run.

Matrix: snapshot, shard (tmp written, not renamed), pre_manifest (shard
landed, no manifest), manifest (manifest tmp fsynced, not renamed), and
the state leg (``save_state`` parked between fsync and rename)."""

import argparse
import hashlib
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

STEPS, SAVE_EVERY = 12, 4  # generations at 4, 8, 12


# -- the worker ------------------------------------------------------------------


def _digest(state) -> str:
    h = hashlib.sha256()
    for k in sorted(state):
        h.update(k.encode())
        h.update(np.ascontiguousarray(state[k].numpy()).tobytes())
    return h.hexdigest()[:16]


def _row_digest(step: int) -> str:
    rng = np.random.default_rng(step)
    return hashlib.sha256(rng.integers(0, 256, 32).tobytes()).hexdigest()[:16]


def _update(state, step: int):
    return {k: v * 0.9 + torch.from_numpy(np.random.default_rng([step, i]).standard_normal(
        tuple(v.shape))) for i, (k, v) in enumerate(sorted(state.items()))}


def _init_state():
    return {"w": torch.arange(96, dtype=torch.float64).reshape(8, 12),
            "b": torch.zeros(12, dtype=torch.float64)}


def run_pytree(directory: str, steps: int, save_every: int) -> None:
    from tpu_tfrecord_torch.checkpoint import AsyncCheckpointer

    ck = AsyncCheckpointer(directory, keep=2, process_index=0, process_count=1)
    start, state, _ = ck.restore(_init_state())
    if start is None:
        start, state = 0, _init_state()
    print(f"resumed {start}", flush=True)
    try:
        for step in range(start + 1, steps + 1):
            state = _update(state, step)
            print(f"step {step} state={_digest(state)} rows={_row_digest(step)}", flush=True)
            if step % save_every == 0:
                ck.save(step, state, {"rows": _row_digest(step)})
        ck.wait()
        print(f"final {steps} {_digest(state)}", flush=True)
    finally:
        ck.close()


def run_state(directory: str, steps: int, save_every: int) -> None:
    from tpu_tfrecord_torch.checkpoint import load_state, save_state
    from tpu_tfrecord_torch.io.dataset import IteratorState

    resume = load_state(directory, process_index=0)
    start = resume.shard_cursor if resume is not None else 0
    print(f"resumed {start}", flush=True)
    h = hashlib.sha256()
    for step in range(1, steps + 1):
        h.update(_row_digest(step).encode())
        if step <= start:
            continue
        print(f"step {step} rows={_row_digest(step)}", flush=True)
        if step % save_every == 0:
            save_state(directory, IteratorState(shard_cursor=step), process_index=0, step=step)
    print(f"final {steps} {h.hexdigest()[:16]}", flush=True)


def worker_main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("mode", choices=["pytree", "state"])
    ap.add_argument("directory")
    ap.add_argument("--steps", type=int, default=STEPS)
    ap.add_argument("--save-every", type=int, default=SAVE_EVERY)
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    os.makedirs(a.directory, exist_ok=True)
    (run_pytree if a.mode == "pytree" else lambda *x: run_state(*x))(
        a.directory, a.steps, a.save_every)
    return 0


# -- the tests -------------------------------------------------------------------

STAGES = ["snapshot", "shard", "pre_manifest", "manifest"]


def _cmd(mode, directory):
    return [sys.executable, os.path.abspath(__file__), mode, directory,
            "--steps", str(STEPS), "--save-every", str(SAVE_EVERY)]


def _env(extra=None):
    env = {k: v for k, v in os.environ.items() if not k.startswith("TFR_CKPT_CHAOS")}
    return {**env, "OMP_NUM_THREADS": "1", **(extra or {})}


def _start(mode, directory, chaos=None):
    return subprocess.Popen(_cmd(mode, directory), stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=_env(chaos))


def _finish(p):
    out, err = p.communicate(timeout=120)
    assert p.returncode == 0, err
    return out


def _digest_lines(stdout):
    steps, final = {}, None
    for line in stdout.splitlines():
        if line.startswith("step "):
            _, n, rest = line.split(" ", 2)
            steps[int(n)] = rest
        elif line.startswith("final "):
            final = line.split(" ", 2)[2]
    return steps, final


@pytest.fixture(scope="module")
def matrix(tmp_path_factory):
    """Every leg at once (the workers are independent processes): the two
    uninterrupted references, and each kill point armed on generation 2
    (skip 1), killed once its marker appears, then relaunched clean.
    Returns {"reference": {mode: lines}, leg: (dir, (gens after the kill,
    whether generation 8's manifest was there), relaunch stdout)}."""
    base = tmp_path_factory.mktemp("chaos")
    refs = {mode: _start(mode, str(base / f"ref-{mode}")) for mode in ("pytree", "state")}
    legs = {stage: ("pytree", stage) for stage in STAGES}
    legs["state"] = ("state", "state")
    killed = {}
    for leg, (mode, stage) in legs.items():
        mark = str(base / f"mark-{leg}")
        chaos = {"TFR_CKPT_CHAOS_STAGE": stage, "TFR_CKPT_CHAOS_MARK": mark,
                 "TFR_CKPT_CHAOS_SKIP": "1"}
        killed[leg] = (_start(mode, str(base / leg), chaos), mark)
    deadline = time.time() + 120
    try:
        for leg, (p, mark) in killed.items():
            while not os.path.exists(mark):
                if p.poll() is not None:
                    out, err = p.communicate()
                    raise AssertionError(f"worker exited before parking at {leg}:\n{out}\n{err}")
                if time.time() > deadline:
                    raise AssertionError(f"worker never parked at {leg}")
                time.sleep(0.02)
            os.kill(p.pid, signal.SIGKILL)
    finally:
        for p, _ in killed.values():
            if p.poll() is None:
                p.kill()
            p.communicate()
    gens = {leg: (sorted(n for n in os.listdir(base / leg) if n.startswith("gen-")),
                  os.path.exists(base / leg / "gen-00000008" / "MANIFEST.json"))
            for leg in legs}
    relaunched = {leg: _start(mode, str(base / leg)) for leg, (mode, _) in legs.items()}
    out = {"reference": {mode: _digest_lines(_finish(p)) for mode, p in refs.items()}}
    for leg, p in relaunched.items():
        out[leg] = (str(base / leg), gens[leg], _finish(p))
    return out


@pytest.mark.parametrize("stage", STAGES)
def test_kill9_matrix_resumes_complete_generation(stage, matrix):
    d, (gens, _), stdout = matrix[stage]
    assert "gen-00000004" in gens
    assert "gen-00000012" not in gens
    # the relaunch committed 8 and 12 again; its sweep left the newest two
    assert sorted(n for n in os.listdir(d) if n.startswith("gen-")) == [
        "gen-00000008", "gen-00000012"]
    assert "resumed 4" in stdout
    steps, final = _digest_lines(stdout)
    ref_steps, ref_final = matrix["reference"]["pytree"]
    assert sorted(steps) == list(range(5, STEPS + 1))
    assert final == ref_final, "resumed end state diverged from the reference"
    for step, rest in steps.items():
        assert rest == ref_steps[step], f"step {step} diverged on resume"


def test_kill9_matrix_leaves_generation_8_incomplete(matrix):
    """No kill point lets generation 8's manifest land before the kill."""
    for stage in STAGES:
        _, (gens, manifest_8), _ = matrix[stage]
        assert gens in (["gen-00000004"], ["gen-00000004", "gen-00000008"]), (stage, gens)
        assert not manifest_8, f"manifest landed despite kill at {stage}"


def test_kill9_state_leg_never_tears(matrix):
    """save_state parked between fsync and rename: the previous complete
    state file survives the kill, and the relaunch resumes from it."""
    _, _, stdout = matrix["state"]
    assert "resumed 4" in stdout
    assert _digest_lines(stdout)[1] == matrix["reference"]["state"][1]


if __name__ == "__main__":
    sys.exit(worker_main())
