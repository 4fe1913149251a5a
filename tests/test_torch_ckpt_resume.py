"""The port's fault-tolerant RLHF and SFT: crash injection and resume on
the CPU, the port's counterpart of ``tests/test_checkpoint_resume.py``
(whose subprocess legs cannot run here: their driver imports
``repro.core``, ROADMAP Queue 3, R1).

A subprocess driver (``tests/_torch_ckpt_driver.py``) runs a tiny 3-stage
pipeline and is killed at the top of a PPO iteration after draining the
in-flight write, or inside the background writer before the commit or
halfway through the shard files; each rerun must continue bit for bit as
the uninterrupted run (metrics, reward trajectory, SHA-256 of the actor,
critic and EMA states), and a torn write must stay invisible.  In-process:
``launch.train`` SFT with ``--ckpt-dir/--save-every/--resume`` against an
uninterrupted run by hash; the pipeline crossing the reference's
stage-boundary checkpoints, and refusing a reference mid-PPO checkpoint
(its PRNG carry is a JAX key) by shape."""
import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from repro.models import reward as JR
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.training import checkpoint as jckpt
from repro.training.train_state import TrainState as JTrainState
from repro_torch.core import (PPOConfig, RLHFEngine, RLHFPipeline,
                              StageConfig)
from repro_torch.data import (ConstantTaskDataset, CopyTaskDataset,
                              DataBlender)
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import (FAULT_EXIT_CODE,
                                             CheckpointError,
                                             CheckpointManager, tree_sha256)

TESTS_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(TESTS_DIR)
DRIVER = os.path.join(TESTS_DIR, "_torch_ckpt_driver.py")
DIE_EXIT_CODE = 37                  # the driver's simulated preemption


def run_driver(*args, fault=None, check=True):
    env = dict(os.environ,
               PYTHONPATH=os.path.join(REPO_ROOT, "src")
               + os.pathsep + os.environ.get("PYTHONPATH", ""))
    env.pop("REPRO_CKPT_FAULT", None)
    if fault is not None:
        env["REPRO_CKPT_FAULT"] = fault
    proc = subprocess.run([sys.executable, DRIVER, *map(str, args)],
                          env=env, cwd=REPO_ROOT, capture_output=True,
                          text=True, timeout=600)
    if check and proc.returncode != 0:
        raise AssertionError(
            f"driver exited {proc.returncode}\n--- stdout ---\n"
            f"{proc.stdout}\n--- stderr ---\n{proc.stderr}")
    return proc


@pytest.fixture(scope="module")
def uninterrupted(tmp_path_factory):
    """One uninterrupted run without checkpoints (so saving is also shown
    not to perturb training)."""
    out = tmp_path_factory.mktemp("ref") / "ref.json"
    run_driver("--out", out)
    with open(out) as f:
        return json.load(f)


def assert_bit_identical(ref: dict, got: dict):
    assert got["scores"] == ref["scores"]
    assert len(got["stage3"]) == len(ref["stage3"]) == 3
    for i, (a, b) in enumerate(zip(ref["stage3"], got["stage3"])):
        assert a == b, f"iteration {i} metrics diverge: {a} vs {b}"
    for k in ("actor_sha", "critic_sha", "ema_sha"):
        assert got[k] == ref[k], f"{k} differs after resume"


def test_kill_mid_run_then_resume_bit_identical(uninterrupted, tmp_path):
    """Kill a checkpointed run at the top of PPO iteration 1 (of 3) after
    the drain, rerun with the same flags, and get exactly the
    uninterrupted run's remaining iterations and final states."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "out.json"
    proc = run_driver("--ckpt-dir", ckpt, "--out", out,
                      "--die-at-iter", 1, check=False)
    assert proc.returncode == DIE_EXIT_CODE, proc.stderr
    assert not out.exists()
    mgr = CheckpointManager(str(ckpt))
    assert mgr.latest_step() == 3      # sft=1, rm=2, then ppo iteration 0
    mgr.verify(3)
    assert mgr.restore_metadata(3)["ppo_iter"] == 1
    run_driver("--ckpt-dir", ckpt, "--out", out)
    with open(out) as f:
        assert_bit_identical(uninterrupted, json.load(f))


def test_crash_before_commit_is_atomic(uninterrupted, tmp_path):
    """Kill the writer between finishing the temp dir and committing it
    (the 3rd save, the first stage-3 one): the torn write is invisible,
    the previous checkpoint stays loadable, and the resume matches."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "out.json"
    proc = run_driver("--ckpt-dir", ckpt, "--out", out, check=False,
                      fault="before_commit:3")
    assert proc.returncode == FAULT_EXIT_CODE, proc.stderr
    assert any(n.startswith(".tmp-") for n in os.listdir(ckpt))
    mgr = CheckpointManager(str(ckpt))      # sweeps the stale temp dir
    assert not any(n.startswith(".tmp-") for n in os.listdir(ckpt))
    assert mgr.latest_step() == 2
    mgr.verify(2)
    assert mgr.restore_metadata(2)["stage"] == "rm_done"
    run_driver("--ckpt-dir", ckpt, "--out", out)
    with open(out) as f:
        assert_bit_identical(uninterrupted, json.load(f))


def test_crash_mid_shard_write_is_atomic(uninterrupted, tmp_path):
    """Kill the writer at the 5th shard file of the first save: nothing
    is committed, and the rerun starts cleanly from nothing."""
    ckpt, out = tmp_path / "ckpt", tmp_path / "out.json"
    proc = run_driver("--ckpt-dir", ckpt, "--out", out, check=False,
                      fault="shard:5")
    assert proc.returncode == FAULT_EXIT_CODE, proc.stderr
    assert CheckpointManager(str(ckpt)).latest_step() is None
    run_driver("--ckpt-dir", ckpt, "--out", out)
    with open(out) as f:
        assert_bit_identical(uninterrupted, json.load(f))


def test_train_cli_sft_resume_matches_an_uninterrupted_run(tmp_path):
    """``launch.train`` SFT: save every 2 of 5 steps, drop the last
    checkpoint (a crash after the step-4 commit), resume: the final state
    hash is the uninterrupted run's, and the resumed run starts at the
    step after the checkpoint."""
    base = ["--device", "cpu", "--arch", "smollm-135m", "--reduced",
            "--steps", "5", "--batch", "2", "--seq", "16"]
    ref = tlaunch.main(base)
    d = str(tmp_path / "ckpt")
    first = tlaunch.main([*base, "--ckpt-dir", d, "--save-every", "2"])
    assert first["state_sha256"] == ref["state_sha256"]
    mgr = CheckpointManager(d)
    assert mgr.all_steps() == [2, 4, 5]
    assert mgr.restore_metadata(5) == {"arch": "smollm-135m-reduced",
                                       "step": 4}
    shutil.rmtree(os.path.join(d, "step_00000005"))
    again = tlaunch.main([*base, "--ckpt-dir", d, "--save-every", "2",
                          "--resume"])
    assert again["start"] == 4 and len(again["loss"]) == 1
    assert again["loss"] == ref["loss"][4:]
    assert again["state_sha256"] == ref["state_sha256"]
    assert again["restore"]["step"] == 4
    assert CheckpointManager(d).latest_step() == 5


@pytest.mark.parametrize("argv", [
    ["--save-every", "2"], ["--resume"], ["--ckpt-dir", "d", "--keep", "0"],
    ["--rlhf", "--lora", "4"], ["--rlhf", "--ckpt", "x.npz"],
    ["--lora", "4", "--micro", "2"]])
def test_train_cli_refuses_misused_checkpoint_and_lora_flags(argv, capsys):
    """Flags that would be silently ignored are refused before anything
    is built or written."""
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", *argv])
    assert e.value.code == 2
    assert "error:" in capsys.readouterr().err


# --------------------------------------------------------------------- #
# the pipeline and the reference's checkpoints
# --------------------------------------------------------------------- #
V = 64
_KW = dict(arch_type="dense", n_layers=1, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=V, compute_dtype="float32",
           remat=False)


def _pipeline(ckpt, ppo_steps=1):
    actor = ModelConfig(name="a", use_kernels=False, **_KW)
    ds = [ConstantTaskDataset(200, 6, 6, V, seed=1),
          CopyTaskDataset(200, 6, 6, V, seed=2)]
    eng = RLHFEngine(actor, actor.replace(name="c"),
                     torch.Generator().manual_seed(0))
    return RLHFPipeline(
        eng, DataBlender(ds, [0.7, 0.3], seed=0),
        StageConfig(sft_steps=2, sft_batch=4, rm_steps=2, rm_batch=4,
                    ppo_steps=ppo_steps, ppo_batch=4),
        PPOConfig(max_new_tokens=4, temperature=1.0),
        checkpointer=ckpt)


def _reference_params(seed):
    jcfg = JModelConfig(name="a", **_KW)
    return JT.init_params(jcfg, jax.random.PRNGKey(seed))


def test_pipeline_adopts_a_reference_stage_boundary(tmp_path):
    """A stage-boundary checkpoint holds params only, so the reference's
    crosses: the port skips SFT, and its frozen reference policy is the
    reference's saved one, bit for bit, after RM and PPO."""
    actor, ref = _reference_params(1), _reference_params(2)
    jckpt.CheckpointManager(str(tmp_path)).save(
        1, {"actor": actor, "ref": ref},
        {"stage": "sft_done", "log": {"stage1": [1.0], "stage2": [],
                                      "stage3": []},
         "rm_acc": [], "timings": {"stage1": 0.5}}, wait=True)
    pipe = _pipeline(CheckpointManager(str(tmp_path)))
    out = pipe.run()
    assert out["sft_loss"] == [1.0] and len(out["rm_acc"]) == 2
    assert len(out["ppo_scores"]) == 1
    want = convert.params_from_numpy(jax.tree.map(np.asarray, ref), "cpu")
    assert tree_sha256(pipe.e.ref_params) == tree_sha256(want)


def test_pipeline_refuses_a_reference_mid_ppo_checkpoint(tmp_path):
    """A reference stage-3 checkpoint carries a JAX key (uint32[2]) as its
    PRNG state, which no torch generator state matches (R6): the restore
    refuses it by shape."""
    p = _reference_params(3)
    c = JR.init_params(JModelConfig(name="c", **_KW),
                       jax.random.PRNGKey(4))
    jckpt.CheckpointManager(str(tmp_path)).save(
        3, {"trainer": {"actor": JTrainState.create(p),
                        "critic": JTrainState.create(c),
                        "ema": jax.tree.map(lambda x: x, p)},
            "ref": p, "reward": c,
            "rng": np.asarray(jax.random.PRNGKey(0))},
        {"stage": "ppo", "ppo_iter": 1, "log": {}, "rm_acc": [],
         "timings": {}}, wait=True)
    pipe = _pipeline(CheckpointManager(str(tmp_path)))
    with pytest.raises(CheckpointError, match=r"'rng': saved shape \(2,\)"):
        pipe.run()
