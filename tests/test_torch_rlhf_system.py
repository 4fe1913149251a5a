"""The port's whole 3-stage RLHF pipeline on the CPU: the fixture of
``tests/test_system.py`` (same configs, data, ``StageConfig`` and
``PPOConfig``), started from the reference's initial weights for
``PRNGKey(0)`` carried across, held to the same thresholds (SFT loss drops
by more than 0.3, reward accuracy above 0.7, 10 finite PPO scores), with
the frozen reference policy and reward model unchanged by stage 3; the
same with int8-KV experience generation; and ``launch.train --rlhf``.
Stage 1 is also held to the reference's own SFT loop from the same start
(losses at rtol/atol 1e-4, as the training tests hold a trajectory)."""
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import (ConstantTaskDataset as JConstant,
                        CopyTaskDataset as JCopy, DataBlender as JBlender)
from repro.models import reward as JR
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.training import schedules as jschedules
from repro.training.steps import lm_train_step as j_lm_train_step
from repro.training.train_state import TrainState as JTrainState
from repro_torch.core import (PPOConfig, RLHFEngine, RLHFPipeline,
                              StageConfig)
from repro_torch.core.pipeline import clone_params
from repro_torch.data import (ConstantTaskDataset, CopyTaskDataset,
                              DataBlender)
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves

ROOT = Path(__file__).resolve().parents[1]
V = 64
_KW = dict(arch_type="dense", n_layers=2, d_model=64, n_heads=4,
           n_kv_heads=2, d_ff=128, vocab_size=V, compute_dtype="float32",
           remat=False)
STAGES = StageConfig(sft_steps=60, sft_batch=16, rm_steps=50, rm_batch=16,
                     ppo_steps=10, ppo_batch=8)


def _port_cfg(name):
    """The port's twin of the reference config: its plain path, as the
    reference's default (``use_pallas=False``) runs its jnp path; the
    kernels take head_dim 32, 64 or 128, and this model's is 16."""
    return ModelConfig(name=name, use_kernels=False, **_KW)


def _reference_start():
    """The reference's ``RLHFEngine(ACTOR, CRITIC, PRNGKey(0))`` weights."""
    jactor_cfg = JModelConfig(name="a", **_KW)
    k1, k2 = jax.random.split(jax.random.PRNGKey(0))
    return (jactor_cfg, JT.init_params(jactor_cfg, k1),
            JR.init_params(jactor_cfg.replace(name="c"), k2))


def _run(kv_quant: bool):
    _, jactor, jcritic = _reference_start()
    actor = _port_cfg("a")
    ds = [ConstantTaskDataset(400, 8, 8, V, seed=1),
          CopyTaskDataset(400, 8, 8, V, seed=2)]
    bl = DataBlender(ds, [0.7, 0.3], seed=0)
    eng = RLHFEngine(actor, actor.replace(name="c"),
                     torch.Generator().manual_seed(0))
    eng.actor_params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jactor), "cpu")
    eng.critic_params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jcritic), "cpu")
    pipe = RLHFPipeline(eng, bl, STAGES,
                        PPOConfig(max_new_tokens=8, temperature=1.0,
                                  ptx_coef=0.05, kv_quant=kv_quant))
    pipe.run_sft()
    assert all(torch.equal(a, b) for a, b in zip(
        tree_leaves(eng.ref_params), tree_leaves(eng.actor_params)))
    pipe.run_reward()
    frozen = {"ref": clone_params(eng.ref_params),
              "reward": clone_params(eng.reward_params),
              "actor": clone_params(eng.actor_params)}
    scores = pipe.run_ppo()
    return {"sft_loss": pipe.log["stage1"], "rm_acc": pipe.rm_acc,
            "ppo_scores": scores, "frozen": frozen, "pipe": pipe}


@pytest.fixture(scope="module", params=[False, True],
                ids=["bf16kv", "int8kv"])
def pipeline_result(request):
    return _run(request.param)


def test_sft_loss_decreases(pipeline_result):
    losses = pipeline_result["sft_loss"]
    assert np.mean(losses[-10:]) < np.mean(losses[:10]) - 0.3


def test_reward_model_learns_ranking(pipeline_result):
    accs = pipeline_result["rm_acc"]
    assert np.mean(accs[-10:]) > 0.7


def test_ppo_runs_and_is_finite(pipeline_result):
    scores = pipeline_result["ppo_scores"]
    assert len(scores) == 10
    assert np.isfinite(scores).all()
    log = pipeline_result["pipe"].log["stage3"]
    assert all(np.isfinite(m[k]) for m in log
               for k in ("actor_loss", "v_loss", "ratio_mean", "approx_kl",
                         "ptx_loss"))
    # the first actor step sees the params that scored its experience
    assert log[0]["ratio_mean"] == pytest.approx(1.0, abs=1e-6)


def test_stage3_leaves_the_frozen_models_unchanged(pipeline_result):
    """The actor and critic are updated in place; the reference policy and
    the reward model are clones, so stage 3 must not move them."""
    pipe, frozen = pipeline_result["pipe"], pipeline_result["frozen"]
    trainer = pipe.trainer
    for name, live in (("ref", trainer.ref_params),
                       ("reward", trainer.reward_params)):
        assert all(torch.equal(a, b) for a, b in zip(
            tree_leaves(live), tree_leaves(frozen[name]))), name
    moved = [not torch.equal(a, b) for a, b in zip(
        tree_leaves(trainer.actor.params), tree_leaves(frozen["actor"]))]
    assert any(moved)
    assert pipe.e.actor_params is trainer.actor.params


def test_sft_stage_matches_the_reference_loop():
    """Stage 1 from the reference's initial weights: the port's losses
    against the reference's ``run_sft`` loop (jitted ``lm_train_step``,
    ``cosine_warmup(lr, steps // 10 + 1, steps)``) on the same blend."""
    jcfg, jactor, _ = _reference_start()
    ds = [JConstant(400, 8, 8, V, seed=1), JCopy(400, 8, 8, V, seed=2)]
    bl = JBlender(ds, [0.7, 0.3], seed=0)
    st = STAGES
    lr = jschedules.cosine_warmup(st.sft_lr, st.sft_steps // 10 + 1,
                                  st.sft_steps)
    step = jax.jit(lambda s, b, lr: j_lm_train_step(jcfg, s, b, lr))
    state, want = JTrainState.create(jactor), []
    for i, b in enumerate(bl.sft_batches(st.sft_batch, st.sft_steps)):
        state, m = step(state, {k: jnp.asarray(v) for k, v in b.items()},
                        lr(i))
        want.append(float(m["loss"]))
    actor = _port_cfg("a")
    eng = RLHFEngine(actor, actor, torch.Generator().manual_seed(0))
    eng.actor_params = convert.params_from_numpy(
        jax.tree.map(np.asarray, jactor), "cpu")
    tds = [ConstantTaskDataset(400, 8, 8, V, seed=1),
           CopyTaskDataset(400, 8, 8, V, seed=2)]
    pipe = RLHFPipeline(eng, DataBlender(tds, [0.7, 0.3], seed=0), st,
                        PPOConfig())
    got = pipe.run_sft()
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


def test_train_cli_rlhf_returns_a_summary():
    out = tlaunch.main(["--device", "cpu", "--arch", "opt-1.3b", "--reduced",
                        "--rlhf", "--steps", "2", "--batch", "2", "--seq",
                        "16", "--max-new", "4", "--kv-quant"])
    assert len(out["sft_loss"]) == len(out["rm_acc"]) == 2
    assert len(out["ppo_scores"]) == len(out["stage3"]) == 2
    assert np.isfinite(out["ppo_scores"]).all()
    assert set(out["timings"]) == {"stage1", "stage2", "stage3"}
    assert out["gen_tok_s"] > 0 and out["peak_mem_bytes"] is None
    assert all(v == 0 for v in out["launches"].values())   # CPU: no kernel


def test_train_cli_rlhf_runs_on_cpu():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu",
         "--arch", "smollm-135m", "--reduced", "--rlhf", "--steps", "2",
         "--batch", "2", "--seq", "16", "--max-new", "4"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert re.search(r"sft_loss=[\d.]+  rm_acc=[\d.]+  reward=-?[\d.]+",
                     res.stdout), res.stdout
    assert re.search(r"stage1=[\d.]+s  stage2=[\d.]+s  stage3=[\d.]+s  "
                     r"gen=[\d.]+tok/s", res.stdout), res.stdout
