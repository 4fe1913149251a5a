"""The port's asynchronous stage 3 on the CPU, the counterpart of
``tests/test_async_rlhf.py`` (whose tests cannot run here: they import
``repro.core``, ROADMAP Queue 3, R1).

Against itself: ``AsyncConfig.lockstep()`` is the synchronous pipeline
bit for bit (metrics without the wall-time and async-only keys, reward
trajectory, SHA-256 of the actor, critic and EMA states) and carries the
async telemetry, on one device and on the 1 x 1 mesh (a one-rank gloo
group); the one-step-stale leg reports ``policy_lag`` 0, 1, 0, 1
and the guard; the abort threshold falls back to lockstep; behavior
logprobs are the sampling-time ones; the first on-policy ratio is 1;
``is_clip`` clamps the ratio; a producer failure fails the run;
``launch.train --rlhf --async-rlhf`` runs.

Against the reference: ``tests/_jax_async_reference.py`` runs the
reference's own ``RLHFPipeline.run_ppo`` in a subprocess on the same
weights (greedy fp32 PPO on a tiny dense pair) in three modes, lockstep,
``publish_every=2, max_lag=1`` and the same with an ``is_ratio_abort``
that trips at the first lag-1 batch; the port's run of each mode must give
the same sequences, ``policy_lag`` and ``lockstep_fallback``, and the
ratios, scores, losses and final params at rtol/atol 1e-4 (as
``tests/test_torch_rlhf_system.py`` holds a trajectory).
"""
import dataclasses
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from _torch_parity import leaf_pairs, to_np
from repro_torch.core import (AsyncConfig, PPOConfig, RLHFEngine,
                              RLHFPipeline, StageConfig)
from repro_torch.core import ppo as tppo
from repro_torch.core.pipeline import clone_params
from repro_torch.data import ConstantTaskDataset, CopyTaskDataset, DataBlender
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import convert
from repro_torch.models import reward as TR
from repro_torch.models import transformer as TT
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves
from repro_torch.training.checkpoint import tree_sha256

pytestmark = pytest.mark.async_rlhf

ROOT = Path(__file__).resolve().parents[1]
V = 64
# head_dim 8 is below the kernels' smallest: the model's plain path
_KW = dict(arch_type="dense", n_layers=1, d_model=32, n_heads=4,
           n_kv_heads=2, d_ff=64, vocab_size=V, compute_dtype="float32",
           remat=False)
ACTOR = ModelConfig(name="a", use_kernels=False, **_KW)
CRITIC = ACTOR.replace(name="c")
# wall-time / topology telemetry: differs between modes by design
WALL_KEYS = ("gen_tok_s", "gen_s", "score_ms", "actor_ms", "critic_ms",
             "publish_s", "publish_bytes", "queue_depth", "policy_lag",
             "is_ratio_mean", "is_ratio_max", "lockstep_fallback")
STAGES = StageConfig(sft_steps=2, sft_batch=4, rm_steps=2, rm_batch=4,
                     ppo_steps=4, ppo_batch=4, seed=0)
STALE = dict(queue_depth=2, publish_every=2, max_lag=1)


def _blender(width: int = 6):
    ds = [ConstantTaskDataset(200, width, width, V, seed=1),
          CopyTaskDataset(200, width, width, V, seed=2)]
    return DataBlender(ds, [0.7, 0.3], seed=0)


def run_pipeline(async_cfg, *, ppo_kw=None, stages=STAGES):
    eng = RLHFEngine(ACTOR, CRITIC, torch.Generator().manual_seed(0))
    pipe = RLHFPipeline(eng, _blender(), stages,
                        PPOConfig(max_new_tokens=4, temperature=1.0,
                                  **(ppo_kw or {})),
                        async_cfg=async_cfg)
    return pipe.run(), pipe


def strip_wall(metrics: dict) -> dict:
    return {k: v for k, v in metrics.items() if k not in WALL_KEYS}


# ===================================================================== #
# lockstep: async must BE the sync pipeline, bit for bit
# ===================================================================== #
@pytest.fixture(scope="module")
def sync_and_lockstep(reference_proc):
    # the reference's subprocess (the last tests') starts first, so that
    # it runs while these do
    return run_pipeline(None), run_pipeline(AsyncConfig.lockstep())


def test_lockstep_bit_identical_to_sync(sync_and_lockstep):
    (out_s, p_s), (out_a, p_a) = sync_and_lockstep
    assert out_s["ppo_scores"] == out_a["ppo_scores"]
    assert len(p_s.log["stage3"]) == len(p_a.log["stage3"]) == \
        STAGES.ppo_steps
    for ms, ma in zip(p_s.log["stage3"], p_a.log["stage3"]):
        assert strip_wall(ms) == strip_wall(ma)
        assert ma["policy_lag"] == 0.0
        assert ma["is_ratio_mean"] == 1.0 and ma["is_ratio_max"] == 1.0
    for k in ("actor", "critic", "ema"):
        assert tree_sha256(getattr(p_s.trainer, k)) == \
            tree_sha256(getattr(p_a.trainer, k)), k
    # the producer really ran (on its own thread) and drained
    assert p_a.async_stats["produced"] == STAGES.ppo_steps
    assert p_a.async_stats["queue"]["dropped"] == 0
    assert p_a.async_stats["queue"]["max_depth"] <= 1
    # one publish of the start, then one after every step; two retained
    assert p_a.async_stats["publisher"]["publishes"] == STAGES.ppo_steps + 1
    assert p_a.async_stats["publisher"]["total_publish_bytes"] == 0
    n = sum(t.numel() for t in tree_leaves(p_a.trainer.actor.params))
    assert p_a.async_stats["retained_bytes"] == 2 * 4 * n


def test_lockstep_metrics_carry_async_telemetry(sync_and_lockstep):
    _, (_, p_a) = sync_and_lockstep
    m = p_a.log["stage3"][0]
    for k in ("policy_lag", "is_ratio_mean", "is_ratio_max",
              "queue_depth", "reward_score", "gen_tok_s", "publish_s",
              "publish_bytes"):
        assert k in m


@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed afterwards."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("pg") / "store"
    owned = not dist.is_initialized()
    init_distributed("cpu", init_method=f"file://{store}", rank=0,
                     world_size=1)
    yield
    if owned:
        dist.destroy_process_group()


def test_lockstep_on_the_1x1_mesh_is_sync(one_rank, sync_and_lockstep):
    """The 1 x 1 mesh (the Hybrid Engine at one rank) runs asynchronous
    stage 3 too: lockstep there is the synchronous run without a mesh,
    bit for bit (the published params skip ``to_inference``)."""
    (out_s, p_s), _ = sync_and_lockstep
    eng = RLHFEngine(ACTOR, CRITIC, torch.Generator().manual_seed(0),
                     mesh=make_mesh(1, 1))
    pipe = RLHFPipeline(eng, _blender(), STAGES,
                        PPOConfig(max_new_tokens=4, temperature=1.0),
                        async_cfg=AsyncConfig.lockstep())
    out = pipe.run()
    assert out["ppo_scores"] == out_s["ppo_scores"]
    assert [strip_wall(m) for m in pipe.log["stage3"]] == \
        [strip_wall(m) for m in p_s.log["stage3"]]
    for k in ("actor", "critic", "ema"):
        assert tree_sha256(getattr(pipe.trainer, k)) == \
            tree_sha256(getattr(p_s.trainer, k)), k
    assert pipe.async_stats["produced"] == STAGES.ppo_steps


# ===================================================================== #
# one-step-stale leg: deterministic lag pattern + live ratio guard
# ===================================================================== #
def test_stale_leg_reports_policy_lag_and_guard():
    cfg = AsyncConfig(**STALE)
    _, pipe = run_pipeline(cfg)
    lags = [m["policy_lag"] for m in pipe.log["stage3"]]
    # the version gate and a publish every 2 steps make the staleness
    # deterministic: the versions used are 0, 0, 2, 2, so lag alternates
    assert lags == [0.0, 1.0] * (STAGES.ppo_steps // 2)
    for m in pipe.log["stage3"]:
        if m["policy_lag"] == 0.0:
            assert m["is_ratio_mean"] == 1.0
            assert m["is_ratio_max"] == 1.0
        else:
            assert m["is_ratio_max"] != 1.0
            assert m["is_ratio_mean"] > 0.0
    q = pipe.async_stats["queue"]
    assert q["max_depth"] <= cfg.queue_depth
    assert q["puts"] == q["gets"] + q["dropped"] + q["depth"]
    assert pipe.async_stats["produced"] == STAGES.ppo_steps
    # max_lag + 2 versions retained
    assert pipe.async_stats["publisher"]["retained"] == 3


def test_abort_threshold_falls_back_to_lockstep():
    # any stale consume trips a threshold of 1.0 (ratio_max > 1 as soon as
    # the policy moves), so the run must drop to lockstep and stay
    cfg = AsyncConfig(queue_depth=2, publish_every=1, max_lag=1,
                      is_ratio_abort=1.0)
    _, pipe = run_pipeline(cfg)
    lags = [m["policy_lag"] for m in pipe.log["stage3"]]
    assert pipe.async_stats["lockstep_fallbacks"] >= 1
    trip = next(i for i, m in enumerate(pipe.log["stage3"])
                if m.get("lockstep_fallback"))
    # at most max_lag batches already admitted may still be stale
    assert all(lag == 0.0 for lag in lags[trip + 1 + cfg.max_lag:])


def test_producer_failure_fails_the_run():
    """A producer exception cancels the queue and surfaces in the consumer
    as ``RuntimeError("rollout producer failed")`` from it; the threads
    are shut down and the telemetry kept."""
    eng = RLHFEngine(ACTOR, CRITIC, torch.Generator().manual_seed(0))
    pipe = RLHFPipeline(eng, _blender(), STAGES,
                        PPOConfig(max_new_tokens=4),
                        async_cfg=AsyncConfig(**STALE))

    def fail(i):
        if i == 2:
            raise ValueError("decode failed")

    pipe.rollout_hook = fail
    eng.ref_params = clone_params(eng.actor_params)
    eng.reward_params = clone_params(eng.critic_params)
    with pytest.raises(RuntimeError, match="rollout producer failed") as e:
        pipe.run_ppo()
    assert isinstance(e.value.__cause__, ValueError)
    assert pipe.async_stats["produced"] == 2
    assert pipe.async_stats["queue"]["puts"] == 2


# ===================================================================== #
# behavior logprobs are the sampling-time logprobs
# ===================================================================== #
def _tiny_trainer():
    g = torch.Generator().manual_seed(0)
    actor, critic = TT.init_params(ACTOR, g), TR.init_params(CRITIC, g)
    return tppo.PPOTrainer(
        actor_cfg=ACTOR, critic_cfg=CRITIC, actor_params=actor,
        critic_params=critic, ref_params=clone_params(actor),
        reward_params=clone_params(critic),
        ppo=PPOConfig(max_new_tokens=4, temperature=1.0))


def test_behavior_logprobs_are_sampling_time_not_recomputed():
    tr = _tiny_trainer()
    prompts = np.full((4, 6), 3, np.int64)
    rollout, _ = tr.generate_rollout(prompts,
                                     torch.Generator().manual_seed(7))
    exp0, sm0 = tr.score_rollout(rollout, policy_lag=0)
    behavior = clone_params(tr.actor.params)
    tr.train_rlhf(exp0)                       # the policy moves, in place
    # scoring with the tagged behavior params reproduces the sampling-time
    # logprobs exactly (the same forward, the same weights) ...
    exp_b, _ = tr.score_rollout(rollout, behavior_params=behavior)
    assert torch.equal(exp_b.logprobs, exp0.logprobs)
    # ... while recomputing from the updated actor would hide staleness
    exp_c, _ = tr.score_rollout(rollout)
    assert not torch.equal(exp_c.logprobs, exp_b.logprobs)
    _, sm_stale = tr.score_rollout(rollout, behavior_params=behavior,
                                   policy_lag=1)
    assert sm_stale["policy_lag"] == 1.0
    assert sm_stale["is_ratio_max"] != 1.0
    assert sm0["is_ratio_mean"] == 1.0 and sm0["is_ratio_max"] == 1.0


def test_on_policy_first_step_ratio_is_one():
    tr = _tiny_trainer()
    prompts = np.full((4, 6), 3, np.int64)
    exp, _ = tr.generate_experience(prompts,
                                    torch.Generator().manual_seed(7))
    tm = tr.train_rlhf(exp)
    assert abs(tm["ratio_mean"] - 1.0) < 1e-5
    assert abs(tm["approx_kl"]) < 1e-6


def test_is_clip_clamps_importance_ratio():
    tr = _tiny_trainer()
    prompts = np.full((4, 6), 3, np.int64)
    exp, _ = tr.generate_experience(prompts,
                                    torch.Generator().manual_seed(7))
    # a strongly off-policy batch: behavior logprobs shifted down by 1
    # nat, so the unclamped ratio is e ~ 2.72 everywhere
    off = exp._replace(logprobs=exp.logprobs - 1.0)
    ppo_clip = dataclasses.replace(tr.ppo, is_clip=1.5)
    _, m_clip = tppo.actor_loss_fn(ACTOR, ppo_clip, tr.actor.params, off)
    _, m_raw = tppo.actor_loss_fn(ACTOR, tr.ppo, tr.actor.params, off)
    assert float(m_raw["ratio_mean"]) > 2.0
    assert float(m_clip["ratio_mean"]) <= 1.5 + 1e-6


def test_generate_rollout_with_published_params_skips_the_reshard():
    """``gen_params`` are used as given and tag the rollout; the engine's
    ``to_inference`` is not called and no reshard metric is added."""
    tr = _tiny_trainer()

    class Engine:
        calls = 0
        last_reshard_stats = {"gathered_bytes": 0, "seconds": 0.0}

        def to_inference(self, params):
            Engine.calls += 1
            return params

    tr.engine = Engine()
    prompts = np.full((4, 6), 3, np.int64)
    published = clone_params(tr.actor.params)
    r_pub, gm_pub = tr.generate_rollout(
        prompts, torch.Generator().manual_seed(7), gen_params=published,
        version=5)
    assert Engine.calls == 0 and r_pub.version == 5
    assert "reshard_s" not in gm_pub
    r_sync, gm_sync = tr.generate_rollout(prompts,
                                          torch.Generator().manual_seed(7))
    assert Engine.calls == 1 and "reshard_s" in gm_sync
    assert r_sync.version == 0
    assert torch.equal(r_pub.sequences, r_sync.sequences)
    assert tr.publish_shardings() is None


# ===================================================================== #
# the launcher
# ===================================================================== #
CLI = ["--device", "cpu", "--arch", "opt-1.3b", "--reduced", "--rlhf",
       "--steps", "2", "--batch", "2", "--seq", "16", "--max-new", "4"]


def test_train_cli_async_rlhf_returns_the_async_summary(capsys):
    out = tlaunch.main([*CLI, "--async-rlhf", "--max-lag", "1"])
    a = out["async"]
    assert a["produced"] == len(out["ppo_scores"]) == 2
    for k in ("max_depth", "dropped", "fallbacks", "publishes", "queue",
              "publisher", "lockstep_fallbacks", "retained_bytes"):
        assert k in a
    assert out["stage3"][0]["policy_lag"] == 0.0
    assert np.isfinite(out["ppo_scores"]).all()
    assert re.search(r"^async: produced=2 max_depth=\d dropped=0 "
                     r"fallbacks=0 publishes=3$", capsys.readouterr().out,
                     flags=re.M)


def test_train_cli_async_rlhf_lockstep_equals_sync(capsys):
    """``--max-lag 0 --queue-depth 1`` is lockstep: the launcher's run
    ends in the synchronous run's states, bit for bit."""
    sync = tlaunch.main(CLI)
    assert sync["async"] is None
    lock = tlaunch.main([*CLI, "--async-rlhf", "--max-lag", "0",
                         "--queue-depth", "1"])
    assert lock["state_sha256"] == sync["state_sha256"]
    assert lock["ppo_scores"] == sync["ppo_scores"]
    assert "async: produced=2 max_depth=1 dropped=0 fallbacks=0 " \
           "publishes=3" in capsys.readouterr().out


# ===================================================================== #
# against the reference's own asynchronous stage 3
# ===================================================================== #
REF_TOL = dict(rtol=1e-4, atol=1e-4)
REF_MODEL = dict(_KW, n_layers=2, d_model=64, d_ff=128)
REF_STAGES = dict(sft_steps=0, sft_batch=4, rm_steps=0, rm_batch=4,
                  ppo_steps=4, ppo_batch=4, seed=0)
REF_PPO = dict(max_new_tokens=4, temperature=0.0)
MODES = {"lockstep": dict(queue_depth=1, publish_every=1, max_lag=0),
         "stale": STALE,
         # trips at the first lag-1 batch (iteration 1): lags 0, 1, 0, 0
         "abort": dict(STALE, is_ratio_abort=1.0)}
COMPARED = ("is_ratio_mean", "is_ratio_max", "reward_score", "actor_loss",
            "pg_loss", "v_loss", "ratio_mean")


def _ref_models():
    """Four models from one seed: the actor and critic, the reference
    policy and reward model as copies of them (the state after stage 2)."""
    g = torch.Generator().manual_seed(11)
    cfg = ModelConfig(name="a", use_kernels=False, **REF_MODEL)
    actor = TT.init_params(cfg, g)
    critic = TR.init_params(cfg.replace(name="c"), g)
    return cfg, {"actor": actor, "ref": clone_params(actor),
                 "critic": critic, "reward": clone_params(critic)}


@pytest.fixture(scope="module")
def reference_proc(tmp_path_factory):
    """The reference's three runs in one subprocess, started first so that
    it runs while the port's do."""
    d = tmp_path_factory.mktemp("async_reference")
    _, models = _ref_models()
    inp = {k: convert.params_to_numpy(v) for k, v in models.items()}
    inp.update(model=REF_MODEL, width=6, stages=REF_STAGES, ppo_kw=REF_PPO,
               modes=MODES)
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")
    env.pop("XLA_FLAGS", None)
    with open(d / "log", "w") as log:
        proc = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_async_reference.py"),
             str(d / "in.pkl"), str(d / "out.pkl")], stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    yield d, proc
    proc.kill()
    proc.wait()


@pytest.fixture(scope="module")
def reference(reference_proc):
    d, proc = reference_proc
    try:
        proc.wait(timeout=600)
    except subprocess.TimeoutExpired:
        pass                              # returncode None: fails below
    assert proc.returncode == 0, (d / "log").read_text()[-4000:]
    with open(d / "out.pkl", "rb") as f:
        return pickle.load(f)


def _port_mode(async_kw) -> dict:
    cfg, models = _ref_models()
    eng = RLHFEngine(cfg, cfg.replace(name="c"),
                     torch.Generator().manual_seed(0))
    for k, v in models.items():
        setattr(eng, f"{k}_params", v)
    pipe = RLHFPipeline(eng, _blender(), StageConfig(**REF_STAGES),
                        PPOConfig(**REF_PPO),
                        async_cfg=AsyncConfig(**async_kw))
    seen, score = [], tppo.PPOTrainer.score_rollout

    def recording(self, rollout, **kw):
        seen.append(to_np(rollout.sequences))
        return score(self, rollout, **kw)

    tppo.PPOTrainer.score_rollout = recording
    try:
        pipe.run_ppo()
    finally:
        tppo.PPOTrainer.score_rollout = score
    return {"sequences": seen, "log": pipe.log["stage3"],
            "async_stats": pipe.async_stats, "trainer": pipe.trainer}


@pytest.mark.parametrize("mode", list(MODES))
def test_matches_the_reference_async_stage3(reference_proc, reference, mode):
    got, want = _port_mode(MODES[mode]), reference[mode]
    assert len(got["sequences"]) == len(want["sequences"]) == 4
    for a, b in zip(got["sequences"], want["sequences"]):
        np.testing.assert_array_equal(a, b)
    lags = [m["policy_lag"] for m in got["log"]]
    assert lags == [m["policy_lag"] for m in want["log"]]
    assert lags == {"lockstep": [0.0] * 4, "stale": [0.0, 1.0] * 2,
                    "abort": [0.0, 1.0, 0.0, 0.0]}[mode]
    assert [m.get("lockstep_fallback") for m in got["log"]] == \
        [m.get("lockstep_fallback") for m in want["log"]]
    for mg, mw in zip(got["log"], want["log"]):
        for k in COMPARED:
            np.testing.assert_allclose(mg[k], mw[k], err_msg=k, **REF_TOL)
        if mg["policy_lag"] == 0.0:
            assert mg["is_ratio_max"] == mw["is_ratio_max"] == 1.0
    for k in ("produced", "lockstep_fallbacks"):
        assert got["async_stats"][k] == want["async_stats"][k]
    assert got["async_stats"]["publisher"]["publishes"] == \
        want["async_stats"]["publisher"]["publishes"]
    tr = got["trainer"]
    for name, tree in (("actor", tr.actor.params),
                       ("critic", tr.critic.params),
                       ("ema", tr.ema_params())):
        for a, b in leaf_pairs(tree, want[name]):
            np.testing.assert_allclose(to_np(a), b, err_msg=name,
                                       **REF_TOL)
