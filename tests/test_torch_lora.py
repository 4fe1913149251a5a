"""The port's LoRA (``repro_torch.core.lora``) and the launchers' LoRA and
export flags, held to the reference: ``repro/core/lora.py`` (loaded by
file path: ``repro.core`` does not import here, ROADMAP Queue 3, R1) on
the same weights and the same adapters, carried across through numpy (the
two frameworks' draws differ, R6).  Also ``serve --ckpt`` on a
reference-saved export against the reference's greedy decode, and the
three torch examples at their smallest scale on the CPU."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import (STEP_TOL, assert_params_moved_alike, close_rel,
                           config_pair, jax_greedy, params_pair, to_np)
from repro.models import transformer as JT
from repro.models.config import ModelConfig as JModelConfig
from repro.training import checkpoint as jckpt
from repro.training.steps import lm_loss_fn as j_lm_loss_fn
from repro.training.train_state import TrainState as JTrainState
from repro_torch import to_device
from repro_torch.core import lora
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models.modules import flatten_with_path, tree_leaves
from repro_torch.training.steps import lm_loss_fn, value_and_grad
from repro_torch.training.train_state import TrainState

ROOT = Path(__file__).resolve().parents[1]


def _ref_lora():
    spec = importlib.util.spec_from_file_location(
        "_reference_lora", ROOT / "src" / "repro" / "core" / "lora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JLORA = _ref_lora()


def _carried_adapters(jparams, rank=4, seed=0):
    """Adapters with random ``a`` and ``b`` on the reference's targets, as
    numpy, jax and torch trees."""
    rng = np.random.default_rng(seed)
    ad = {}
    for key, shape, _ in JLORA._target_paths(jparams, JLORA.DEFAULT_TARGETS):
        *lead, din, dout = shape
        ad[key] = {"a": (rng.standard_normal((*lead, din, rank))
                         / np.sqrt(din)).astype(np.float32),
                   "b": (0.05 * rng.standard_normal(
                       (*lead, rank, dout))).astype(np.float32)}
    return (jax.tree.map(jnp.asarray, ad),
            convert.params_from_numpy(ad, "cpu"))


def _assert_tree_equals_ref(got, want, rel=None):
    """The port tree ``got`` leaf by leaf against the reference tree
    ``want`` (matched by path): bitwise, or to ``rel`` of max |want|."""
    flat = dict(flatten_with_path(got))
    pairs = jax.tree_util.tree_flatten_with_path(want)[0]
    assert len(pairs) == len(flat)
    for p, w in pairs:
        key = tuple(getattr(c, "key", getattr(c, "idx", c)) for c in p)
        if rel is None:
            np.testing.assert_array_equal(to_np(flat[key]), np.asarray(w))
        else:
            close_rel(flat[key], np.asarray(w), rel)


def _lm_batch(cfg, seed=0):
    return next(tlaunch.lm_data(cfg, 16, seed).sft_batches(2, 1))


@pytest.mark.parametrize("arch", ["smollm-135m", "opt-1.3b"])
def test_init_targets_and_shapes_follow_the_reference(arch):
    jcfg, _ = config_pair(arch)
    jparams, tparams = params_pair(jcfg, seed=1)
    want = [(k, tuple(s)) for k, s, _ in
            JLORA._target_paths(jparams, JLORA.DEFAULT_TARGETS)]
    got = lora.init(tparams, 8, torch.Generator().manual_seed(0))
    assert [(k, tuple(v["a"].shape[:-1]) + (v["b"].shape[-1],))
            for k, v in got.items()] == want
    jad = JLORA.init(jparams, 8, jax.random.PRNGKey(0))
    for k, v in got.items():
        for n in ("a", "b"):
            assert tuple(v[n].shape) == jad[k][n].shape
            assert v[n].dtype == torch.float32
        assert not v["b"].any()
        din = v["a"].shape[-2]
        # a ~ N(0, 1/in), as the reference draws it
        assert abs(float(v["a"].std()) * np.sqrt(din) - 1) < 0.2


def test_merge_and_fold_match_the_reference():
    jcfg, _ = config_pair("smollm-135m")
    jparams, tparams = params_pair(jcfg, seed=2)
    jad, tad = _carried_adapters(jparams)
    for alpha in (16.0, 4.0):
        want = JLORA.merge(jparams, jad, alpha)
        for fn in (lora.merge, lora.fold):
            _assert_tree_equals_ref(fn(tparams, tad, alpha), want, 1e-6)
    folded = lora.fold(tparams, tad)
    assert not any(t.requires_grad for t in tree_leaves(folded))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_one_lora_step_matches_the_reference(use_kernels):
    """The launcher's LoRA step against the reference launcher's (a
    ``jax.value_and_grad`` of the LM loss of the merged params over the
    adapters, then AdamW): loss, adapter grads and updated adapters; the
    base params get no grad, no Adam state and no update."""
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels)
    jcfg = jcfg.replace(use_pallas=False)
    jparams, tparams = params_pair(jcfg, seed=3)
    jad, tad = _carried_adapters(jparams, seed=3)
    batch = _lm_batch(tcfg)
    lr = 3e-3

    def jloss(ad):
        return j_lm_loss_fn(jcfg, JLORA.merge(jparams, ad),
                            {k: jnp.asarray(v) for k, v in batch.items()})
    (jl, _), jg = jax.value_and_grad(jloss, has_aux=True)(jad)
    jstate, _ = JTrainState.create(jad).apply_gradients(jg, lr=lr)

    tb = to_device(batch, "cpu")
    base = [t.clone() for t in tree_leaves(tparams)]
    (tl, _), tg = value_and_grad(
        lambda ad: lm_loss_fn(tcfg, lora.merge(tparams, ad), tb), tad)
    np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
    for k in tad:
        for n in ("a", "b"):
            close_rel(tg[k][n], np.asarray(jg[k][n]), 1e-4)

    state = TrainState.create(convert.params_from_numpy(
        jax.tree.map(np.asarray, jad), "cpu"))
    state, m = tlaunch.lora_train_step(tcfg, tparams, state, tb, lr)
    np.testing.assert_allclose(float(m["loss"]), float(jl), **STEP_TOL)
    assert_params_moved_alike(state.params, jstate.params, jg, lr)
    assert sorted(state.opt.m) == sorted(tad)          # adapters only
    assert int(state.step) == 1
    for t, b in zip(tree_leaves(tparams), base):
        assert t.grad is None and torch.equal(t, b)


def test_lora_cli_export_is_read_by_the_reference(tmp_path):
    """``--lora 4 --ckpt`` writes ``fold(base, adapters)``; the
    reference's ``checkpoint.load`` reads it back bitwise.  The state
    holds the adapters of every target, and ``b`` has left zero."""
    path = str(tmp_path / "lora.npz")
    out = tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                        "--reduced", "--steps", "3", "--batch", "2",
                        "--seq", "16", "--lora", "4", "--ckpt", path])
    ad = out["state"].params
    assert out["adapter_params"] == sum(t.numel() for t in tree_leaves(ad))
    assert sorted(ad) == [k for k, _ in lora._target_paths(
        out["params"], lora.DEFAULT_TARGETS)]
    assert any(float(v["b"].abs().max()) > 0 for v in ad.values())
    jcfg, _ = config_pair("smollm-135m")
    got = jckpt.load(path, JT.init_params(jcfg, jax.random.PRNGKey(0)))
    _assert_tree_equals_ref(lora.fold(out["params"], ad), got)
    assert jckpt.load_metadata(path) == {"arch": "smollm-135m-reduced",
                                         "steps": 3}


def test_serve_ckpt_serves_a_reference_export_greedily(tmp_path, capsys):
    """``serve --ckpt`` on a ``.npz`` the reference saved: each request's
    greedy tokens equal the reference's greedy decode on those weights."""
    jcfg, _ = config_pair("smollm-135m")
    jparams, _ = params_pair(jcfg, seed=7)
    path = str(tmp_path / "ref.npz")
    jckpt.save(path, jparams, {"arch": "smollm-135m-reduced"})
    out = tserve.main(["--device", "cpu", "--arch", "smollm-135m",
                       "--reduced", "--ckpt", path, "--requests", "3",
                       "--ragged", "--prompt-len", "10", "--max-new", "5",
                       "--batch", "2", "--temperature", "0"])
    assert f"loaded {path}" in capsys.readouterr().out
    assert out["load_s"] is not None
    for r in out["requests"]:
        assert out["completions"][r.uid] == jax_greedy(
            jcfg, jparams, r.tokens, r.max_new_tokens)
    # serving the same weights from memory gives the same tokens
    mem = tserve.main(["--device", "cpu", "--arch", "smollm-135m",
                       "--reduced", "--requests", "3", "--ragged",
                       "--prompt-len", "10", "--max-new", "5", "--batch",
                       "2", "--temperature", "0"],
                      params=convert.params_from_numpy(
                          jax.tree.map(np.asarray, jparams), "cpu"))
    assert mem["completions"] == out["completions"]


# --------------------------------------------------------------------- #
# the torch examples, on the CPU at their smallest scale
# --------------------------------------------------------------------- #
def _example(name):
    spec = importlib.util.spec_from_file_location(
        f"_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_torch_rlhf_e2e_example_runs_and_exports(tmp_path, capsys):
    """All three stages at ``--scale tiny``; the actor and EMA exports are
    read by the reference's ``checkpoint.load``, and the EMA export is the
    trainer's EMA weights."""
    ex = _example("torch_rlhf_e2e")
    out = ex.main(["--device", "cpu", "--scale", "tiny", "--sft-steps",
                   "12", "--rm-steps", "12", "--ppo-steps", "3",
                   "--out", str(tmp_path)])
    text = capsys.readouterr().out
    assert "SFT loss" in text and "checkpoints in" in text
    assert len(out["ppo_scores"]) == 3
    assert np.isfinite(out["ppo_scores"]).all()
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "actor.npz", "actor.npz.meta.json", "actor_ema.npz",
        "actor_ema.npz.meta.json", "log.json"]
    pipe = out["pipeline"]
    a = out["actor_cfg"]
    jcfg = JModelConfig(name=a.name, arch_type="dense", n_layers=a.n_layers,
                        d_model=a.d_model, n_heads=a.n_heads,
                        n_kv_heads=a.n_kv_heads, d_ff=a.d_ff,
                        vocab_size=a.vocab_size)
    like = JT.init_params(jcfg, jax.random.PRNGKey(0))
    for fname, tree in (("actor.npz", pipe.e.actor_params),
                        ("actor_ema.npz", pipe.trainer.ema_params())):
        _assert_tree_equals_ref(tree, jckpt.load(str(tmp_path / fname),
                                                 like))


def test_torch_quickstart_example_runs(capsys):
    out = _example("torch_quickstart").main(["--device", "cpu"])
    assert "done." in capsys.readouterr().out
    assert len(out["sft_loss"]) == 60 and len(out["ppo_scores"]) == 12
    assert np.isfinite(out["ppo_scores"]).all()
    assert all(len(c.tokens) == 8 for c in out["completions"].values())


def test_torch_serve_chat_example_runs(capsys):
    out = _example("torch_serve_chat").main(["--device", "cpu", "--max-new",
                                             "6", "--prompt-len", "32"])
    assert "streamed" in capsys.readouterr().out
    assert 0 < out["tokens"] <= 8 * 6
    assert len(out["texts"]) == 8


def test_examples_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    for name in ("torch_rlhf_e2e", "torch_quickstart", "torch_serve_chat"):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            _example(name).main([])
