"""The port's SSM / hybrid training slice on the CPU (part 3 of 3, beside
``test_torch_ssm_training.py``): the 3-stage pipeline and ``launch.train``
(``--rlhf``, Zamba2 also with ``--kv-quant``) at the reduced Mamba2-370M
and Zamba2-1.2B, and Zamba2's int8-KV greedy and served streams against
the reference's greedy decode on its int8 cache (weights carried across
through numpy, fp32; tokens identical).
"""
import numpy as np
import pytest
import torch

from repro_torch import configs as tconfigs
from repro_torch.core import ppo as tppo
from repro_torch.core.pipeline import (RLHFEngine, RLHFPipeline, StageConfig,
                                       clone_params)
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import GenerationEngine, Request
from repro_torch.training.train_state import TrainState

from _torch_parity import config_pair, jax_greedy, params_pair


# ------------------------------------------------------------------ #
# the pipeline and the launcher
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch,kv_quant", [("mamba2-370m", False),
                                           ("zamba2-1.2b", False),
                                           ("zamba2-1.2b", True)],
                         ids=["mamba2", "zamba2", "zamba2-int8kv"])
def test_rlhf_pipeline_trains_ssm_models(arch, kv_quant):
    """SFT -> RM -> PPO at the reduced model, the critic on the actor's
    config (the launcher's recipe): every loss finite, the first ratio 1,
    the frozen reference and reward models unchanged by stage 3 and the
    actor moved."""
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    eng = RLHFEngine(cfg, cfg.replace(name=cfg.name + "-critic"),
                     torch.Generator().manual_seed(0))
    pipe = RLHFPipeline(
        eng, tlaunch.lm_data(cfg, 16, 0),
        StageConfig(sft_steps=3, sft_batch=2, rm_steps=2, rm_batch=2,
                    ppo_steps=2, ppo_batch=2),
        tppo.PPOConfig(max_new_tokens=5, temperature=1.0, ptx_coef=0.05,
                       kv_quant=kv_quant))
    pipe.run_sft()
    pipe.run_reward()
    frozen = {"ref": clone_params(eng.ref_params),
              "reward": clone_params(eng.reward_params),
              "actor": clone_params(eng.actor_params)}
    scores = pipe.run_ppo()
    assert np.isfinite(pipe.log["stage1"] + pipe.log["stage2"]).all()
    assert len(scores) == 2 and np.isfinite(scores).all()
    log = pipe.log["stage3"]
    assert all(np.isfinite(m[k]) for m in log
               for k in ("actor_loss", "v_loss", "ptx_loss", "approx_kl"))
    assert log[0]["ratio_mean"] == pytest.approx(1.0, abs=1e-6)
    assert pipe.trainer.gen_engine.cfg.kv_quant == kv_quant
    tr = pipe.trainer
    for name, live in (("ref", tr.ref_params), ("reward", tr.reward_params)):
        assert all(torch.equal(a, b) for a, b in zip(
            TM.tree_leaves(live), TM.tree_leaves(frozen[name]))), name
    assert any(not torch.equal(a, b) for a, b in zip(
        TM.tree_leaves(tr.actor.params), TM.tree_leaves(frozen["actor"])))


@pytest.mark.parametrize("argv", [
    ["--arch", "mamba2-370m"], ["--arch", "zamba2-1.2b"],
    ["--arch", "zamba2-1.2b", "--kv-quant"]],
    ids=["mamba2", "zamba2", "zamba2-int8kv"])
def test_train_cli_rlhf_runs_ssm_models(argv, capsys):
    out = tlaunch.main(["--device", "cpu", "--reduced", "--rlhf", "--steps",
                        "2", "--batch", "2", "--seq", "16", "--max-new", "4",
                        *argv])
    assert len(out["sft_loss"]) == len(out["rm_acc"]) == 2
    assert len(out["ppo_scores"]) == len(out["stage3"]) == 2
    assert np.isfinite(out["sft_loss"]).all()
    assert np.isfinite(out["ppo_scores"]).all()
    assert all(v == 0 for v in out["launches"].values())   # CPU: no kernel
    assert "sft_loss=" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ("mamba2-370m", "zamba2-1.2b"))
def test_sft_loop_loss_falls(arch):
    cfg = tconfigs.reduced(tconfigs.get_config(arch))
    state = TrainState.create(TT.init_params(
        cfg, torch.Generator().manual_seed(0)))
    _, summary = tlaunch.train_lm(cfg, state, steps=8, batch=4, seq=40,
                                  lr=3e-3, device="cpu")
    assert np.isfinite(summary["loss"]).all()
    assert summary["loss"][-1] < summary["loss"][0]


# ------------------------------------------------------------------ #
# int8 KV for the hybrid's attention layers
# ------------------------------------------------------------------ #
@pytest.fixture(scope="module")
def zamba2_int8():
    jcfg, tcfg = config_pair("zamba2-1.2b", kv_quant=True)
    tcfg = tcfg.replace(use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=5)
    return jcfg, tcfg, jparams, tparams


def test_zamba2_int8_kv_greedy_matches_jax(zamba2_int8):
    """The fixed path on the int8 arena (the attention layers' K/V rows
    int8 with fp32 scales, the SSM layers' conv and state as before)
    against the reference's greedy decode on its int8 cache."""
    jcfg, tcfg, jparams, tparams = zamba2_int8
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                               37).astype(np.int32)
    eng = GenerationEngine(tcfg, max_new_tokens=10, temperature=0.0,
                           device="cpu")
    out = eng.generate(tparams, prompt[None], torch.Generator())
    assert out["sequences"][0, 37:].tolist() == jax_greedy(jcfg, jparams,
                                                           prompt, 10)


def test_zamba2_int8_kv_served_streams_match_jax(zamba2_int8):
    """Ragged requests through the continuous engine: exact-length
    admission writes int8 rows and scales into the slot's arena rows."""
    jcfg, tcfg, jparams, tparams = zamba2_int8
    rng = np.random.default_rng(11)
    reqs = [Request(uid=i, tokens=rng.integers(0, jcfg.vocab_size, lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate(zip([5, 40, 1], [6, 4, 5]))]
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=3,
                           device="cpu")
    S = max(len(r.tokens) + r.max_new_tokens for r in reqs)
    _, _, _, done = tserve.run_schedule(eng, tparams, reqs,
                                        torch.Generator(), mode="continuous",
                                        slots=2, max_seq_len=S)
    for r in reqs:
        assert done[r.uid] == jax_greedy(jcfg, jparams, r.tokens,
                                         r.max_new_tokens)
