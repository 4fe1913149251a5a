"""The port's training path against the reference's, on the same weights
and train states (carried across through numpy) and the same batches
(numpy, seeded), at the reduced OPT-1.3B and smollm-135m configs in fp32.

- AdamW, the LR schedules and the data blender: optimizer at rtol/atol
  1e-6 (the same fp32 arithmetic), schedules at 1e-6, batches bitwise.
- ``lm_loss`` / ``per_token_logprobs``: 1e-5.
- ``lm_train_step`` (micro 1 and 2) and ``reward_train_step``, with the
  port's plain path and its kernel path (the kernels' plain versions on
  the CPU), held to the reference's jnp path: loss, grad norm and grads
  at 1e-4; the new params where |grad| is well above the noise (Adam's
  first step is about ``lr * sign(g)``, and a grad near 0 may flip sign
  between frameworks).
- a 5-step SFT trajectory of the launcher's loop against the reference's
  loop at 1e-4, and the launcher's command line.
"""
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
                        CopyTaskDataset as JCopy, DataBlender as JBlender,
                        SortTaskDataset as JSort)
from repro.models import reward as JR
from repro.models import transformer as JT
from repro.training import optimizer as jopt
from repro.training import schedules as jsched
from repro.training import steps as jsteps
from repro_torch.data import (ConstantTaskDataset, CopyTaskDataset,
                              DataBlender, SortTaskDataset)
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import reward as TR
from repro_torch.models import transformer as TT
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.training import optimizer as topt
from repro_torch.training import schedules as tsched
from repro_torch.training import steps as tsteps
from repro_torch.training.train_state import TrainState

from _torch_parity import (ARCHS, config_pair, jax_lm_loop, params_pair,
                           state_pair, to_np)

ROOT = Path(__file__).resolve().parents[1]
OPT_TOL = dict(rtol=1e-6, atol=1e-6)
STEP_TOL = dict(rtol=1e-4, atol=1e-4)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _batch_t(batch):
    return tlaunch.to_device(batch, "cpu")


def _batch_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _pairs(got, *want):
    """Leaves of the port's tree beside the reference trees' leaves at the
    same paths (JAX orders dict keys, the port keeps insertion order)."""
    out = []
    tree_map(lambda *xs: out.append(xs), got, *want)
    assert len(out) == len(jax.tree.leaves(want[0]))
    return out


def _assert_trees_close(got, want, **tol):
    for a, b in _pairs(got, want):
        np.testing.assert_allclose(to_np(a), np.asarray(b), **tol)


def _assert_grads_close(got, want, rel=1e-4):
    """Each leaf to ``rel`` of its largest |grad|."""
    for a, b in _pairs(got, want):
        b = np.asarray(b)
        scale = max(float(np.abs(b).max()), 1e-12)
        assert float(np.abs(to_np(a) - b).max()) <= rel * scale


def _assert_params_moved_alike(got, want, grads, lr):
    """New params match where |grad| is well above the noise; elsewhere
    they stay within one Adam step (``lr``)."""
    for a, b, g in _pairs(got, want, grads):
        a, b, g = to_np(a), np.asarray(b), np.abs(np.asarray(g))
        big = g > 1e-3 * max(float(g.max()), 1e-12)
        np.testing.assert_allclose(a[big], b[big], **STEP_TOL)
        assert float(np.abs(a - b).max()) <= 2.5 * lr


# --------------------------------------------------------------------- #
# trees, train state, conversion
# --------------------------------------------------------------------- #
def test_tree_map_rebuilds_namedtuples():
    """``tree_map`` over an AdamState / TrainState keeps the NamedTuple
    types (their fields are positional arguments, not one iterable)."""
    params = {"a": torch.ones(2), "b": (torch.zeros(3), torch.ones(1))}
    st = TrainState.create(params)
    doubled = tree_map(lambda t: t * 2, st)
    assert type(doubled) is TrainState
    assert type(doubled.opt) is topt.AdamState
    assert doubled.opt.m["b"][0].shape == (3,)
    assert tree_map(lambda t: t, st.opt)._fields == ("m", "v", "step")


def test_train_state_round_trips_through_convert():
    jcfg, _ = config_pair("opt-1.3b")
    jparams, _ = params_pair(jcfg)
    rng = np.random.default_rng(0)
    jstate = jax.tree.map(lambda a: a, state_pair(jparams)[0])
    jstate = jstate._replace(
        opt=jopt.AdamState(
            m=jax.tree.map(lambda p: jnp.asarray(
                rng.standard_normal(p.shape).astype(np.float32)), jparams),
            v=jax.tree.map(lambda p: jnp.asarray(
                rng.random(p.shape).astype(np.float32)), jparams),
            step=jnp.asarray(7, jnp.int32)),
        step=jnp.asarray(7, jnp.int32))
    tstate = convert.train_state_from_numpy(_np_tree(jstate), "cpu")
    assert type(tstate) is TrainState and type(tstate.opt) is topt.AdamState
    assert int(tstate.step) == 7 and int(tstate.opt.step) == 7
    back = convert.params_to_numpy(tstate)
    assert type(back) is TrainState and type(back.opt) is topt.AdamState
    for a, b in _pairs(back, _np_tree(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------- #
# optimizer and schedules
# --------------------------------------------------------------------- #
def _opt_case(seed, big):
    rng = np.random.default_rng(seed)
    shapes = {"w": (6, 5), "seg": ({"a": (3, 4)}, {"b": (7,)}), "n": (5,)}
    params = jax.tree.map(lambda s: rng.standard_normal(s).astype(np.float32),
                          shapes, is_leaf=lambda x: isinstance(x, tuple)
                          and all(isinstance(i, int) for i in x))
    mult = 3.0 if big else 0.01
    grads = jax.tree.map(
        lambda p: (mult * rng.standard_normal(p.shape)).astype(np.float32),
        params)
    m = jax.tree.map(lambda p: (0.1 * rng.standard_normal(p.shape))
                     .astype(np.float32), params)
    v = jax.tree.map(lambda p: rng.random(p.shape).astype(np.float32) * 0.01,
                     params)
    return params, grads, m, v


@pytest.mark.parametrize("big_grads", [True, False], ids=["clip", "noclip"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("step", [0, 5])
def test_optimizer_update_matches_reference(big_grads, weight_decay, masked,
                                            step):
    params, grads, m, v = _opt_case(step * 10 + big_grads, big_grads)
    mask = None
    if masked:
        mask = {"w": True, "seg": ({"a": False}, {"b": True}), "n": False}
    jstate = jopt.AdamState(m=jax.tree.map(jnp.asarray, m),
                            v=jax.tree.map(jnp.asarray, v),
                            step=jnp.asarray(step, jnp.int32))
    jp, js, jg = jopt.update(jax.tree.map(jnp.asarray, params),
                             jax.tree.map(jnp.asarray, grads), jstate,
                             lr=jnp.float32(3e-3), weight_decay=weight_decay,
                             trainable_mask=mask)
    tstate = topt.AdamState(m=convert.params_from_numpy(m),
                            v=convert.params_from_numpy(v),
                            step=torch.tensor(step, dtype=torch.int32))
    tp, ts, tg = topt.update(convert.params_from_numpy(params),
                             convert.params_from_numpy(grads), tstate,
                             lr=torch.tensor(3e-3), weight_decay=weight_decay,
                             trainable_mask=mask)
    np.testing.assert_allclose(float(tg), float(jg), rtol=1e-6)
    assert int(ts.step) == int(js.step) == step + 1
    _assert_trees_close(tp, jp, **OPT_TOL)
    _assert_trees_close(ts.m, js.m, **OPT_TOL)
    _assert_trees_close(ts.v, js.v, **OPT_TOL)
    if masked:      # masked-off leaves untouched
        np.testing.assert_array_equal(to_np(tp["n"]), params["n"])
        np.testing.assert_array_equal(to_np(ts.m["n"]), m["n"])


def test_optimizer_with_elementwise_mask_matches_reference():
    params, grads, m, v = _opt_case(3, True)
    rng = np.random.default_rng(9)
    mask = jax.tree.map(lambda p: rng.random(p.shape) > 0.5, params)
    jstate = jopt.init(jax.tree.map(jnp.asarray, params))
    jp, js, _ = jopt.update(jax.tree.map(jnp.asarray, params),
                            jax.tree.map(jnp.asarray, grads), jstate,
                            lr=1e-2, trainable_mask=mask)
    tparams = convert.params_from_numpy(params)
    tp, ts, _ = topt.update(tparams, convert.params_from_numpy(grads),
                            topt.init(tparams), lr=1e-2,
                            trainable_mask=convert.params_from_numpy(mask))
    _assert_trees_close(tp, jp, **OPT_TOL)
    _assert_trees_close(ts.v, js.v, **OPT_TOL)


def test_optimizer_without_clip_reports_zero_norm():
    params, grads, m, v = _opt_case(1, True)
    tparams = convert.params_from_numpy(params)
    tp, _, gn = topt.update(tparams, convert.params_from_numpy(grads),
                            topt.init(tparams), lr=1e-3, grad_clip=None)
    jp, _, _ = jopt.update(jax.tree.map(jnp.asarray, params),
                           jax.tree.map(jnp.asarray, grads),
                           jopt.init(jax.tree.map(jnp.asarray, params)),
                           lr=1e-3, grad_clip=None)
    assert float(gn) == 0.0
    _assert_trees_close(tp, jp, **OPT_TOL)


@pytest.mark.parametrize("warmup,total", [(1, 10), (6, 50), (0, 5)])
def test_schedules_match_reference(warmup, total):
    jf = jsched.cosine_warmup(3e-4, warmup, total)
    tf = tsched.cosine_warmup(3e-4, warmup, total)
    for step in range(total + 3):
        got = tf(step)
        assert got.dtype == torch.float32 and got.shape == ()
        np.testing.assert_allclose(float(got), float(jf(step)), rtol=1e-6)
    assert float(tsched.constant(1e-3)(7)) == float(jsched.constant(1e-3)(7))


# --------------------------------------------------------------------- #
# data
# --------------------------------------------------------------------- #
def _blenders(seed):
    mk = lambda Copy, Sort, Const: [Copy(500, 6, 9, 64, seed=1),
                                    Sort(500, 6, 9, 64, seed=2),
                                    Const(300, 6, 9, 64, seed=3)]
    return (JBlender(mk(JCopy, JSort, JConstant), [1, 2, 1], seed=seed),
            DataBlender(mk(CopyTaskDataset, SortTaskDataset,
                           ConstantTaskDataset), [1, 2, 1], seed=seed))


@pytest.mark.parametrize("stream,args", [
    ("sft_batches", (4, 3)), ("reward_batches", (3, 3)),
    ("prompt_batches", (5, 2)), ("pretrain_batches", (2, 3))])
@pytest.mark.parametrize("skip", [0, 2])
def test_blender_batches_are_bitwise_equal(stream, args, skip):
    jb, tb = _blenders(seed=4)
    got = list(getattr(tb, stream)(*args, skip=skip))
    want = list(getattr(jb, stream)(*args, skip=skip))
    assert len(got) == len(want) == args[1] - skip
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in g:
            assert g[k].dtype == w[k].dtype, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


# --------------------------------------------------------------------- #
# losses
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("logit_chunk", [0, 5])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_logprobs_match_reference(arch, logit_chunk):
    jcfg, tcfg = config_pair(arch, logit_chunk=logit_chunk)
    jparams, tparams = params_pair(jcfg)
    rng = np.random.default_rng(2)
    B, L = 2, 13
    hidden = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
    labels = rng.integers(0, jcfg.vocab_size, (B, L)).astype(np.int32)
    mask = (rng.random((B, L)) > 0.3).astype(np.float32)
    want = JT.lm_loss(jcfg, jparams, jnp.asarray(hidden), jnp.asarray(labels),
                      jnp.asarray(mask))
    got = TT.lm_loss(tcfg, tparams, torch.from_numpy(hidden),
                     torch.from_numpy(labels), torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    want_lp = JT.per_token_logprobs(jcfg, jparams, jnp.asarray(hidden),
                                    jnp.asarray(labels))
    got_lp = TT.per_token_logprobs(tcfg, tparams, torch.from_numpy(hidden),
                                   torch.from_numpy(labels))
    np.testing.assert_allclose(got_lp.numpy(), np.asarray(want_lp),
                               rtol=1e-5, atol=1e-5)


def test_lm_loss_grad_with_chunks_matches_unchunked():
    """Checkpointed chunks give the gradient of the whole loss."""
    _, tcfg = config_pair("opt-1.3b")
    _, tparams = params_pair(config_pair("opt-1.3b")[0])
    rng = np.random.default_rng(5)
    h = torch.from_numpy(rng.standard_normal((2, 11, tcfg.d_model))
                         .astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, tcfg.vocab_size, (2, 11)))
    mask = torch.ones(2, 11)
    grads = []
    for chunk in (0, 4):
        hh = h.clone().requires_grad_()
        TT.lm_loss(tcfg.replace(logit_chunk=chunk), tparams, hh, labels,
                   mask).backward()
        grads.append(hh.grad)
    np.testing.assert_allclose(grads[0].numpy(), grads[1].numpy(),
                               rtol=1e-5, atol=1e-7)


def test_reward_specs_match_reference():
    jcfg, tcfg = config_pair("opt-1.3b")
    js, ts = JR.param_specs(jcfg), TR.param_specs(tcfg)
    assert "lm_head" not in ts and ts["v_head"].shape == (tcfg.d_model, 1)
    for t, j in _pairs(ts, js):
        assert (t.shape, t.axes, t.init) == (j.shape, j.axes, j.init)


# --------------------------------------------------------------------- #
# train steps
# --------------------------------------------------------------------- #
def _sft_batch(jcfg, seed, B=4, half=8):
    ds = [JCopy(100, half, half, min(jcfg.vocab_size, 256), seed=1),
          JSort(100, half, half, min(jcfg.vocab_size, 256), seed=2)]
    return next(JBlender(ds, seed=seed).sft_batches(B, 1))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_lm_train_step_matches_reference(arch, micro, use_kernels):
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels)
    jcfg = jcfg.replace(use_pallas=False)     # the reference's jnp path
    jparams, _ = params_pair(jcfg, seed=1)
    jstate, tstate = state_pair(jparams)
    batch = _sft_batch(jcfg, seed=micro)
    lr = 1e-3
    (jl, _), jg = jax.value_and_grad(
        lambda p: jsteps.lm_loss_fn(jcfg, p, _batch_j(batch)),
        has_aux=True)(jparams)
    if micro > 1:           # the reference's grads are the micro average
        mb = {k: v.reshape((micro, -1) + v.shape[1:])
              for k, v in batch.items()}
        gs = [jax.grad(lambda p: jsteps.lm_loss_fn(
            jcfg, p, _batch_j({k: v[i] for k, v in mb.items()}))[0])(jparams)
            for i in range(micro)]
        jg = jax.tree.map(lambda *g: sum(g) / micro, *gs)
    jstate2, jm = jax.jit(lambda s, b: jsteps.lm_train_step(
        jcfg, s, b, lr, micro=micro))(jstate, _batch_j(batch))
    (tl, _), tg = tsteps.lm_value_and_grad(tcfg, tstate.params,
                                           _batch_t(batch), micro)
    _assert_grads_close(tg, jg)
    tstate2, tm = tsteps.lm_train_step(tcfg, tstate, _batch_t(batch), lr,
                                       micro=micro)
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                               **STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **STEP_TOL)
    if micro == 1:
        np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
    assert int(tstate2.step) == int(jstate2.step) == 1
    _assert_params_moved_alike(tstate2.params, jstate2.params, jg, lr)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("arch", ARCHS)
def test_reward_train_step_matches_reference(arch, use_kernels):
    jcfg, tcfg = config_pair(arch, use_kernels=use_kernels)
    jcfg = jcfg.replace(use_pallas=False)
    jparams = JR.init_params(jcfg, jax.random.PRNGKey(3))
    jstate, tstate = state_pair(jparams)
    ds = [JCopy(100, 6, 6, 64, seed=1), JSort(100, 6, 6, 64, seed=2)]
    batch = next(JBlender(ds, seed=0).reward_batches(4, 1))
    batch["chosen_mask"][1, 9:] = 0.0          # a ragged row: score at 8
    lr = 1e-3
    (jl, jmet), jg = jax.value_and_grad(
        lambda p: jsteps.reward_loss_fn(jcfg, p, _batch_j(batch)),
        has_aux=True)(jparams)
    (tl, tmet), tg = tsteps.value_and_grad(
        lambda p: tsteps.reward_loss_fn(tcfg, p, _batch_t(batch)),
        tstate.params)
    np.testing.assert_allclose(float(tl), float(jl), **STEP_TOL)
    assert float(tmet["rm_acc"]) == float(jmet["rm_acc"])
    _assert_grads_close(tg, jg)
    jstate2, jm = jsteps.reward_train_step(jcfg, jstate, _batch_j(batch), lr)
    tstate2, tm = tsteps.reward_train_step(tcfg, tstate, _batch_t(batch), lr)
    np.testing.assert_allclose(float(tm["grad_norm"]),
                               float(jm["grad_norm"]), **STEP_TOL)
    _assert_params_moved_alike(tstate2.params, jstate2.params, jg, lr)


def test_remat_gives_the_same_grads():
    _, tcfg = config_pair("smollm-135m")
    _, tparams = params_pair(config_pair("smollm-135m")[0], seed=2)
    batch = _batch_t(_sft_batch(config_pair("smollm-135m")[0], seed=0))
    got = [tsteps.lm_value_and_grad(tcfg.replace(remat=r), tparams, batch)
           for r in (False, True)]
    assert float(got[0][0][0]) == float(got[1][0][0])
    for a, b in zip(tree_leaves(got[0][1]), tree_leaves(got[1][1])):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-7)


def test_sharded_pieces_are_not_ported():
    """What of the sharded training path is still not ported: a Mamba2
    mixer whose groups the model axis does not divide (3 over 2) and the
    disaggregated meshes; the gather / grad pspecs need a state in a mesh
    layout."""
    from types import SimpleNamespace
    from repro_torch.launch import mesh as tmesh
    _, tcfg = config_pair("opt-1.3b")
    _, ssm = config_pair("mamba2-370m")
    tp_mesh = SimpleNamespace(shape={"data": 1, "model": 2},
                              axis_names=("data", "model"))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tsteps.make_sharded_lm_step(ssm.replace(ssm_ngroups=3), tp_mesh,
                                    "zero3")
    state = TrainState.create({"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="mesh layout"):
        tsteps.lm_train_step(tcfg, state, {}, 1e-3, gather_pspecs={})
    # the split needs a world of both meshes' ranks: a process without a
    # group is one rank
    with pytest.raises(ValueError, match="disaggregated meshes need 1 "
                       "rollout \\+ 1 train = 2 ranks, have 1"):
        tmesh.make_disaggregated_meshes(rollout=1, train=1)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_five_step_sft_trajectory_matches_reference(use_kernels):
    """The launcher's loop (``train_lm``) and the reference's loop from one
    train state: losses and grad norms at every step to 1e-4."""
    jcfg, tcfg = config_pair("smollm-135m", use_kernels=use_kernels)
    jcfg = jcfg.replace(use_pallas=False)
    jparams, _ = params_pair(jcfg, seed=5)
    jstate, tstate = state_pair(jparams)
    kw = dict(steps=5, batch=4, seq=16, lr=3e-3, seed=0)
    _, jl, jgn = jax_lm_loop(jcfg, jstate, **kw)
    _, summary = tlaunch.train_lm(tcfg, tstate, device="cpu", **kw)
    np.testing.assert_allclose(summary["loss"], jl, **STEP_TOL)
    np.testing.assert_allclose(summary["grad_norm"], jgn, **STEP_TOL)
    assert summary["loss"][-1] < summary["loss"][0]


# --------------------------------------------------------------------- #
# launcher
# --------------------------------------------------------------------- #
def _run(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train",
                           *args], capture_output=True, text=True, env=env,
                          cwd=ROOT, timeout=300)


def test_train_cli_runs_on_cpu():
    res = _run(["--device", "cpu", "--arch", "smollm-135m", "--reduced",
                "--steps", "3"])
    assert res.returncode == 0, res.stderr
    steps = re.findall(r"^step +(\d+) +loss=([\d.]+) +gnorm=([\d.]+)",
                       res.stdout, flags=re.M)
    assert [s[0] for s in steps] == ["0", "1", "2"], res.stdout
    assert "tok/s" in res.stdout


def test_train_main_returns_a_summary():
    out = tlaunch.main(["--device", "cpu", "--arch", "opt-1.3b", "--reduced",
                        "--steps", "2", "--batch", "4", "--seq", "16",
                        "--micro", "2"])
    assert len(out["loss"]) == len(out["step_ms"]) == 2
    assert all(np.isfinite(out["loss"])) and out["tok_s"] > 0
    assert out["peak_mem_bytes"] is None and out["device"] == "cpu"
    assert out["launches"][0]["flash_attention_bwd"] == 0   # CPU: no kernel


@pytest.mark.parametrize("flag", [
    ["--mesh", "1,1", "--lora", "4"],
    ["--strategy", "fsdp"], ["--zero", "2"],
    ["--rlhf", "--async-rlhf", "--mesh", "2,1"],
    ["--async-rlhf"],
    ["--rollout-mesh", "2"], ["--train-mesh", "2"], ["--queue-depth", "2"],
    ["--publish-every", "1"], ["--max-lag", "1"], ["--is-ratio-abort", "2"],
    ["--max-new", "8"], ["--kv-quant"]])
def test_train_cli_refuses_unported_flags(flag):
    """A mesh the world cannot hold (``--mesh 2,1`` in one process, here
    with ``--rlhf --async-rlhf``), one of ``--rollout-mesh`` /
    ``--train-mesh`` without the other, and the RLHF options without
    ``--rlhf`` (the asynchronous knobs also without ``--async-rlhf``),
    exit with an error before anything runs."""
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", *flag])
    assert e.value.code != 0


def test_train_cli_refusal_names_the_flag():
    """The split's flags go together (the reference's words); the split
    itself runs under ``torchrun`` (``tests/test_torch_disaggregated.py``).
    A ``--mesh`` larger than the world names the ranks it needs (on two
    ranks ``--async-rlhf`` runs there: ``tests/test_torch_async_mesh.py``)."""
    res = _run(["--device", "cpu", "--arch", "smollm-135m", "--reduced",
                "--rollout-mesh", "2"])
    assert res.returncode == 2 and \
        "--rollout-mesh and --train-mesh go together" in res.stderr
    res = _run(["--device", "cpu", "--arch", "smollm-135m", "--reduced",
                "--rlhf", "--async-rlhf", "--mesh", "2,1"])
    assert res.returncode == 2 and \
        "mesh 2x1 needs 2 ranks, have 1" in res.stderr


def test_train_cli_without_a_card_refuses_to_run():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    res = _run(["--arch", "smollm-135m", "--reduced", "--steps", "1"])
    assert res.returncode != 0
    assert "CUDA is not available" in res.stderr
