"""The port's asynchronous stage 3 under stress and preemption, the
counterpart of ``tests/test_async_soak.py`` (whose driver imports
``repro.core``, ROADMAP Queue 3, R1).

Drives ``tests/_torch_ckpt_driver.py`` (the tiny 3-stage pipeline, stage 3
in ``sync``, ``lockstep`` or ``stale`` mode) in subprocesses:

- **backpressure**: a slow consumer lets the producer outrun PPO; the
  queue must block the producer at capacity (``max_depth <= capacity``,
  ``put_wait_s > 0``) and still deliver every batch once;
- **starvation**: a slow producer starves the consumer; the run must wait
  (``get_wait_s > 0``) and finish clean;
- **lockstep under slow phases** stays bit-identical to the synchronous
  run;
- **preemption**: a checkpointed lockstep run killed (exit 37) at the top
  of PPO iteration 2, resumed in sync and in lockstep, must be
  bit-identical to the uninterrupted synchronous run (metrics, reward
  trajectory, SHA-256 of the actor, critic and EMA states): the checkpoint
  holds the generator state the consumed item carried.

Bit-identity is claimed for lockstep only: with real staleness the
behavior policy of a batch depends on thread timing, so the ``stale`` legs
assert liveness and conservation.
"""
import json
import os
import shutil
import subprocess
import sys

import pytest

from repro_torch.training.checkpoint import CheckpointManager

pytestmark = pytest.mark.async_rlhf

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
DRIVER = os.path.join(TESTS_DIR, "_torch_ckpt_driver.py")
DIE_EXIT_CODE = 37
PPO_STEPS = 4


def run_driver(*args, check=True):
    env = dict(os.environ,
               PYTHONPATH=os.path.join(REPO_ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_CKPT_FAULT", None)
    proc = subprocess.run([sys.executable, DRIVER, "--ppo-steps",
                           str(PPO_STEPS), *map(str, args)],
                          env=env, cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600)
    if check and proc.returncode != 0:
        raise AssertionError(
            f"driver exited {proc.returncode}\n--- stdout ---\n"
            f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc


def run_record(tmp, name, *args):
    out = tmp / f"{name}.json"
    run_driver("--out", out, *args)
    with open(out) as f:
        return json.load(f)


@pytest.fixture(scope="module")
def sync_ref(tmp_path_factory):
    """The uninterrupted synchronous run (no queue, no checkpoints)."""
    return run_record(tmp_path_factory.mktemp("soak_ref"), "sync_ref",
                      "--mode", "sync")


def assert_bit_identical(ref: dict, got: dict):
    assert got["scores"] == ref["scores"]
    assert len(got["stage3"]) == len(ref["stage3"]) == PPO_STEPS
    for i, (a, b) in enumerate(zip(ref["stage3"], got["stage3"])):
        assert a == b, f"iteration {i} metrics diverge: {a} vs {b}"
    for k in ("actor_sha", "critic_sha", "ema_sha"):
        assert got[k] == ref[k], f"{k} differs"


# ===================================================================== #
# soak: slow phases must give backpressure or waiting, never loss
# ===================================================================== #
def test_soak_slow_consumer_backpressures(tmp_path):
    """A crawling consumer (iterations [1, 4)): the queue clamps at its
    capacity and the producer waits in ``put`` (queue depth 1 < max_lag +
    1, so the version gate admits one batch past the queued one)."""
    rec = run_record(tmp_path, "slowc", "--mode", "stale", "--queue-depth",
                     1, "--slow-consumer-iters", "1:4", "--slow-ms", 300)
    a = rec["async_stats"]
    q = a["queue"]
    assert q["puts"] == q["gets"] == a["produced"] == PPO_STEPS
    assert q["dropped"] == 0 and q["depth"] == 0
    assert q["puts"] == q["gets"] + q["dropped"] + q["depth"]
    assert q["max_depth"] <= q["capacity"] == 1
    assert q["put_wait_s"] > 0.0          # backpressure engaged
    assert len(rec["scores"]) == PPO_STEPS


def test_soak_slow_producer_starves_consumer_cleanly(tmp_path):
    rec = run_record(tmp_path, "slowp", "--mode", "stale",
                     "--slow-producer-iters", "1:3", "--slow-ms", 300)
    q = rec["async_stats"]["queue"]
    assert q["puts"] == q["gets"] == PPO_STEPS and q["dropped"] == 0
    assert q["puts"] == q["gets"] + q["dropped"] + q["depth"]
    assert q["get_wait_s"] > 0.0          # the consumer really waited
    assert len(rec["scores"]) == PPO_STEPS


def test_soak_lockstep_with_slow_phases_stays_bit_identical(sync_ref,
                                                            tmp_path):
    rec = run_record(tmp_path, "slowlock", "--mode", "lockstep",
                     "--slow-consumer-iters", "1:2",
                     "--slow-producer-iters", "2:3", "--slow-ms", 200)
    assert_bit_identical(sync_ref, rec)


# ===================================================================== #
# preemption: a checkpoint written mid-async-run resumes in either mode
# ===================================================================== #
@pytest.fixture(scope="module")
def crashed_ckpt(tmp_path_factory):
    """One checkpointed lockstep run killed at the top of PPO iteration 2
    (of 4), after the in-flight write drained."""
    tmp = tmp_path_factory.mktemp("async_crash")
    ckpt, out = tmp / "ckpt", tmp / "dead.json"
    proc = run_driver("--mode", "lockstep", "--ckpt-dir", ckpt, "--out", out,
                      "--die-at-iter", 2, check=False)
    assert proc.returncode == DIE_EXIT_CODE, proc.stderr
    assert not out.exists()
    mgr = CheckpointManager(str(ckpt))
    latest = mgr.latest_step()
    assert latest == 4                    # sft=1, rm=2, ppo iters 0 and 1
    mgr.verify(latest)
    assert mgr.restore_metadata(latest)["ppo_iter"] == 2
    return ckpt


@pytest.mark.parametrize("resume_mode", ["sync", "lockstep"])
def test_preempted_async_run_resumes_bit_identical(sync_ref, crashed_ckpt,
                                                   tmp_path, resume_mode):
    ckpt = tmp_path / "ckpt"
    shutil.copytree(crashed_ckpt, ckpt)   # each leg resumes the original
    rec = run_record(tmp_path, "resumed", "--mode", resume_mode,
                     "--ckpt-dir", ckpt)
    assert_bit_identical(sync_ref, rec)
