"""The port's tensor-parallel compute of the remaining layer kinds on gloo
ranks over the CPU: the Mamba2 mixer (Mamba2, Zamba2), MLA, cross-attention,
heads that do not split whole over ``model``, and MoE at ``micro=2`` over
a sharded batch, held to the single-rank port and to the reference on the
same mesh.

One launch of ``tests/_torch_mesh_driver.py`` per mesh (1 x 2, 2 x 2 and
1 x 4) runs the ``tpl_*`` cases, and the reference runs the same weights,
batches and prompts on the same meshes of simulated host devices, in one
subprocess of ``tests/_jax_mesh_reference.py`` per mesh, started with the
launches.  The rules are ``tests/test_torch_tensor_parallel.py``'s:
against the single-rank port, greedy tokens identical and the rest at
rtol 2e-4, atol 2e-5 in fp32; against the reference, 1e-5.  Updated params
are compared where every step's |grad| is above 1e-3 of its leaf's max,
and everywhere within one Adam step (``2.5 * lr``).

- ``make_sharded_lm_step`` (zero3 + ZeRO-1 and tp + ZeRO-1, two steps) on
  reduced mamba2-370m, zamba2-1.2b, deepseek-v2-lite-16b (MLA + MoE),
  llama-3.2-vision-11b (with encoder embeddings) and smollm-135m at 9
  heads and 3 kv heads (attention computed whole on every rank), and
  reduced llama4-scout-17b-a16e at ``micro=2`` (at 2 x 2 each micro slice
  is one data rank's rows: the other rank routes zero rows with it).
- Greedy ``generate`` through the Hybrid Engine for Mamba2, Zamba2 (its
  KV arena in the compute dtype and in int8), MLA (at 2 x 2 its MoE
  layers route the data group's rows together) and the vision model,
  token-identical; the rank's cache holds its SSM heads
  and channels, its kv heads, or the whole MLA latents.
- One ``train_rlhf`` step of PPO through the Hybrid Engine with a reduced
  Zamba2 actor and critic.
- Local bytes and the Mamba2 compute view; the views of ``w_in``,
  ``conv_w`` and ``conv_b`` from the pspecs alone at the full configs;
  ``torchrun ... launch.train --arch mamba2-370m --mesh 1,2`` against
  ``--mesh 1,1``.
"""
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_driver as D
from _torch_parity import STEP_TOL, leaf_pairs
from repro_torch.configs import get_config
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves, tree_map
from repro_torch.serving.engine import GenerationEngine
from repro_torch.sharding import strategy as S
from repro_torch.training.steps import lm_train_step, lm_value_and_grad
from repro_torch.training.train_state import TrainState
from test_torch_tensor_parallel import (FakeMesh, _assert_ppo_close, _env,
                                        _params_close, _torchrun, _wait)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
REF_TOL = dict(rtol=1e-5, atol=1e-5)
# Mamba2's and Zamba2's params against the reference: the train steps'
# tolerance of the SSM tests.  Their random-weight SSM layers amplify a
# rounding over depth, and the reference's own Zamba2 steps on 1 x 2 and
# 1 x 4 differ from its 1 x 1 steps by more than 1e-5 on elements the
# |grad| rule keeps.
SSM_REF_TOL = STEP_TOL
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
MESHES = ((1, 2), (2, 2), (1, 4))
IDS = [f"{dp}x{tp}" for dp, tp in MESHES]
CASES = "tpl_lm,tpl_engine,tpl_ppo,tpl_layout"
LM_IDS = [c[0] for c in D.TPL_LM_CASES]
# the reference runs the zero3 layout of each config (its tp layout
# computes the same function)
REF_LM = [c for c in D.TPL_LM_CASES if c[3] == "zero3"]
GEN = [(m, name) for m in MESHES for name, _, _ in D.TPL_GEN_CASES]
GEN_IDS = [f"{dp}x{tp}-{n}" for (dp, tp), n in GEN]


def _reference_inputs():
    np_ = convert.params_to_numpy
    lm = {}
    for name, arch, over, _, micro in REF_LM:
        cfg = D.tpl_config(arch, over)
        lm[name] = (arch, over, micro, np_(D.embed_params(cfg)),
                    [{k: v.numpy() for k, v in b.items()}
                     for b in D.tpl_batches(cfg)])
    gen = {}
    for name, arch, over in D.TPL_GEN_CASES:
        cfg = D.tpl_config(arch, over)
        enc = D.tpl_encoder(cfg)
        gen[name] = (arch, over, np_(D.tpl_gen_params(cfg)),
                     None if enc is None else enc.numpy())
    return {"tpl_lm": lm, "tpl_gen": gen, "prompts": D.PROMPTS,
            "ppo_kw": D.PPO_KW, "lm_lr": D.TP_LR}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The reference's runs and the gloo launches, one of each per mesh,
    all started together."""
    d = tmp_path_factory.mktemp("tpl")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(_reference_inputs(), f)
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = ROOT / "tests" / "_jax_mesh_reference.py"
    refs, runs = {}, {}
    for dp, tp in MESHES:
        with open(d / f"ref{dp}x{tp}.log", "w") as log:
            refs[(dp, tp)] = subprocess.Popen(
                [sys.executable, str(script), str(d / "in.pkl"),
                 str(d / f"ref{dp}x{tp}.pkl"), str(dp), str(tp)],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    for dp, tp in MESHES:
        out = d / f"run{dp}x{tp}"
        out.mkdir()
        runs[(dp, tp)] = (out, _torchrun(
            dp * tp, out / "log",
            str(ROOT / "tests" / "_torch_mesh_driver.py"), "--out",
            str(out), "--cases", CASES, "--mesh", f"{dp},{tp}"))
    yield d, refs, runs
    for p in list(refs.values()) + [p for _, p in runs.values()]:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def runs(launches):
    _, _, procs = launches
    out = {}
    for mesh, (d, p) in procs.items():
        _wait(p, d / "log")
        out[mesh] = {c: torch.load(d / f"{c}.pt", weights_only=False)
                     for c in CASES.split(",")}
    return out


@pytest.fixture(scope="module")
def reference(launches):
    d, procs, _ = launches
    out = {}
    for (dp, tp), p in procs.items():
        _wait(p, d / f"ref{dp}x{tp}.log")
        with open(d / f"ref{dp}x{tp}.pkl", "rb") as f:
            out[(dp, tp)] = pickle.load(f)
    return out


# --------------------------------------------------------------------- #
# the single-rank port
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lm_single():
    """Each LM case's two plain ``lm_train_step``\\ s, with each step's
    grads (the mean of the micro slices')."""
    out = {}
    for name, arch, over, _, micro in D.TPL_LM_CASES:
        cfg = D.tpl_config(arch, over)
        state = TrainState.create(D.embed_params(cfg))
        grads, losses, gnorms = [], [], []
        for b in D.tpl_batches(cfg):
            _, g = lm_value_and_grad(cfg, state.params, b, micro)
            grads.append([t.numpy() for t in tree_leaves(g)])
            state, m = lm_train_step(cfg, state, b, D.TP_LR, micro=micro)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": gnorms, "grads": grads,
                     "params": [t.numpy() for t in tree_leaves(
                         state.params)]}
    return out


@pytest.fixture(scope="module")
def gen_single():
    out = {}
    for name, arch, over in D.TPL_GEN_CASES:
        cfg = D.tpl_config(arch, over)
        eng = GenerationEngine(cfg, device="cpu", **D.PPO_KW)
        out[name] = D.tpl_generate(eng, cfg, D.tpl_gen_params(cfg))
    return out


# --------------------------------------------------------------------- #
# LM steps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", LM_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tpl_lm_step_matches_single_rank(runs, lm_single, mesh, case):
    got, want = runs[mesh]["tpl_lm"][case], lm_single[case]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    _params_close(got["params"], want["params"], want["grads"], D.TP_LR,
                  TOL, f"{mesh} {case}")


@pytest.mark.parametrize("case", [c[0] for c in REF_LM])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tpl_lm_step_matches_the_reference(runs, reference, mesh, case):
    """``make_sharded_lm_step(..., "zero3")`` of the reference on the same
    mesh: losses at rtol/atol 1e-5, grad norms at rtol 1e-4, params by the
    |grad| rule (the SSM configs' at :data:`SSM_REF_TOL`)."""
    _, arch, over, _, _ = next(c for c in REF_LM if c[0] == case)
    got, want = runs[mesh]["tpl_lm"][case], reference[mesh]["lm"][case]
    np.testing.assert_allclose(got["loss"], want["loss"], **REF_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    tpl = D.embed_params(D.tpl_config(arch, over))
    ref = lambda tree: [np.asarray(b) for _, b in leaf_pairs(tpl, tree)]
    _params_close(got["params"], ref(want["params"]),
                  [ref(g) for g in want["grads"]], D.TP_LR,
                  SSM_REF_TOL if arch in SSM_ARCHS else REF_TOL,
                  f"{mesh} {case}")


def test_tpl_lm_steps_clip(lm_single):
    """Every LM step's grad norm is above the clip of 1.0, so the steps
    compared are clipped steps: the norm sums every element once."""
    for case, r in lm_single.items():
        assert min(r["grad_norm"]) > 1.0, case


# --------------------------------------------------------------------- #
# generation
# --------------------------------------------------------------------- #
def _assert_gen_equal(got, want):
    for k in ("sequences", "response_mask"):
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert got["steps"] == want["steps"]


@pytest.mark.parametrize("mesh,case", GEN, ids=GEN_IDS)
def test_tpl_generate_is_token_identical(runs, gen_single, mesh, case):
    _assert_gen_equal(runs[mesh]["tpl_engine"][case], gen_single[case])


@pytest.mark.parametrize("mesh,case", GEN, ids=GEN_IDS)
def test_tpl_generate_matches_the_reference(runs, reference, mesh, case):
    _assert_gen_equal(runs[mesh]["tpl_engine"][case],
                      reference[mesh]["gen"][case])


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tpl_cache_holds_the_rank_heads(runs, mesh):
    """The rank's cache: Mamba2's ``state`` holds its ``nh / tp`` heads and
    ``conv`` its ``di / tp`` channels plus ``B`` and ``C``; the vision
    model's self-attention and cross-attention arenas the kv heads its q
    heads read; MLA's latents are whole (they carry no heads)."""
    tp = mesh[1]
    got = runs[mesh]["tpl_engine"]
    cfg = D.lm_config("mamba2-370m")
    di, nh, gn = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state
    for name in ("mamba2", "zamba2"):
        c = got[name]["cache"][0]
        assert c["state"][2:] == (nh // tp, cfg.ssm_headdim, cfg.ssm_state)
        assert c["conv"][3] == di // tp + 2 * gn
    vcfg = D.lm_config("llama-3.2-vision-11b")
    kv = max(1, vcfg.n_kv_heads // tp)
    assert got["vision"]["cache"][0]["k"][3] == kv
    assert got["vision"]["cache"][-1]["xk"][3] == kv
    if "mla" in got:
        mcfg = D.lm_config("deepseek-v2-lite-16b")
        assert got["mla"]["cache"][0]["ckv"][3] == mcfg.kv_lora_rank


# --------------------------------------------------------------------- #
# PPO with a Zamba2 actor
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def ppo_single():
    cfg = D.lm_config("zamba2-1.2b")
    return D.ppo_run(D.tpl_trainer(cfg, None), D.PROMPTS, steps=1)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tpl_ppo_zamba2_matches_single_rank(runs, ppo_single, mesh):
    got = runs[mesh]["tpl_ppo"]
    _assert_ppo_close(got, ppo_single, f"{mesh} zamba2", TOL)
    for name in ("actor", "critic", "ema"):
        for a, b in zip(got[name], ppo_single[name], strict=True):
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)


# --------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tpl_local_bytes_and_mamba2_view(runs, mesh):
    """In the ``tp`` layout a rank holds its replicated leaves plus ``1 /
    tp`` of its ``model``-sharded ones; its compute view of the mixer holds
    ``z``, ``x`` and ``dt`` of its heads with the whole of ``B`` and ``C``
    (``w_in``, ``conv_*``), its channels of ``out_norm`` and ``w_out``, and
    every head of the per-head vectors."""
    dp, tp = mesh
    cfg = D.lm_config("mamba2-370m")
    got = runs[mesh]["tpl_layout"]
    ps = tree_leaves(S.param_pspecs(cfg, FakeMesh(
        {"data": dp, "model": tp}), "tp"), is_leaf=S.is_pspec)
    full = tree_leaves(T.init_params(cfg, D._gen(0)))
    rep = sum(4 * t.numel() for t, p in zip(full, ps) if "model" not in p)
    cut = sum(4 * t.numel() for t, p in zip(full, ps) if "model" in p)
    assert cut > 0 and got["rest_bytes"] == rep + cut // tp
    di, nh, n, L = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state, cfg.n_layers
    v = got["view"]
    assert v["w_in"] == (L, cfg.d_model, 2 * di // tp + 2 * n + nh // tp)
    assert v["conv_w"] == (L, cfg.ssm_conv, di // tp + 2 * n)
    assert v["conv_b"] == (L, di // tp + 2 * n)
    assert v["out_norm"] == (L, di // tp)
    assert v["w_out"] == (L, di // tp, cfg.d_model)
    assert v["A_log"] == v["D_skip"] == v["dt_bias"] == (L, nh)


def _views(cfg, tp, rank, strategy):
    ps = S.param_pspecs(cfg, FakeMesh({"data": 1, "model": tp}), strategy)
    dims = tree_map(S.model_dim, ps, is_leaf=S.is_pspec)
    return S.compute_slices(T.param_specs(cfg), dims, cfg, tp, rank)


def _cols(view, n):
    """The columns of a leaf dim of ``n`` that ``view`` takes, in order."""
    if view.kind == S.SEGMENTS:
        return [c for a, b in view.cols for c in range(a, b)]
    if view.kind == S.FULL:
        return list(range(n))
    m = n // view.parts
    return list(range(view.index * m, (view.index + 1) * m))


@pytest.mark.parametrize("strategy", ["tp", "zero3"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_views_follow_the_heads(arch, tp, strategy):
    """From the pspecs alone, at the full configs: rank ``r`` computes on
    ``z``, ``x`` and ``dt`` of heads ``[r nh / tp, (r + 1) nh / tp)`` of
    ``w_in`` and the whole of ``B`` and ``C``, on its ``x`` channels and
    ``B`` and ``C`` of ``conv_w`` / ``conv_b``, and on channels ``[r di /
    tp, (r + 1) di / tp)`` of ``out_norm`` / ``w_out`` (head-major); the
    ranks' ``z``, ``x`` and ``dt`` columns together are each column
    once."""
    cfg = get_config(arch)
    di, nh, hp = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_headdim
    gn = cfg.ssm_ngroups * cfg.ssm_state
    seen = []
    for r in range(tp):
        ssm = _views(cfg, tp, r, strategy)["segments"][0][0]["ssm"]
        heads = range(r * nh // tp, (r + 1) * nh // tp)
        ch = [h * hp + i for h in heads for i in range(hp)]
        bc = list(range(2 * gn))
        w_in = _cols(ssm["w_in"], 2 * di + 2 * gn + nh)
        assert w_in == (ch + [di + c for c in ch] + [2 * di + c for c in bc]
                        + [2 * di + 2 * gn + h for h in heads])
        for k in ("conv_w", "conv_b"):
            assert ssm[k].kind == S.SEGMENTS
            assert _cols(ssm[k], di + 2 * gn) == ch + [di + c for c in bc]
        for k in ("out_norm", "w_out"):
            assert _cols(ssm[k], di) == ch, k
        for k in ("A_log", "D_skip", "dt_bias"):
            assert ssm[k].kind == S.FULL
        seen += ch
    assert sorted(seen) == list(range(di))


@pytest.mark.parametrize("tp", [2, 4])
def test_uneven_heads_are_computed_whole(tp):
    """9 heads and 3 kv heads over ``model`` 2 or 4: the pspecs cut ``H *
    hd`` into half heads, and every rank computes each attention leaf
    whole; the MLP and the vocabulary stay split.  MLA and the vision
    model's heads split whole."""
    cfg = D.tpl_config("smollm-135m", {"n_heads": 9, "n_kv_heads": 3})
    for r in range(tp):
        v = _views(cfg, tp, r, "zero3")["segments"][0][0]
        assert {x.kind for x in v["attn"].values()} == {S.FULL}
        assert {x.kind for x in v["mlp"].values()} == {S.ALIGNED}
    for arch, key in (("deepseek-v2-lite-16b", "attn"),
                      ("llama-3.2-vision-11b", "xattn")):
        cfg = get_config(arch)
        unit = _views(cfg, tp, 1, "zero3")["segments"][0]
        a = next(lp[key] for lp in unit if key in lp)
        assert a["wq"].kind == a["wo"].kind == S.ALIGNED


# --------------------------------------------------------------------- #
# the launcher under torchrun
# --------------------------------------------------------------------- #
def test_torchrun_launcher_mamba2_on_a_tp_mesh(tmp_path):
    """``launch.train --arch mamba2-370m --reduced --mesh 1,2 --strategy
    tp`` exits 0, rank 0 alone prints, and its losses equal ``--mesh
    1,1``'s."""
    procs = {m: _torchrun(
        int(np.prod([int(x) for x in m.split(",")])), tmp_path / m, "-m",
        "repro_torch.launch.train", "--device", "cpu", "--arch",
        "mamba2-370m", "--reduced", "--mesh", m, "--strategy", "tp",
        "--seq", "16", "--steps", "3", "--batch", "4")
        for m in ("1,2", "1,1")}
    outs = {}
    for m, p in procs.items():
        out = _wait(p, tmp_path / m, timeout=300)
        assert out.count(f"mesh={{'data': 1, 'model': {m[-1]}}}") == 1, out
        outs[m] = out
    got, want = (np.array([float(x) for x in re.findall(
        r"^step +\d+ +loss=([0-9.]+)", outs[m], flags=re.M)])
        for m in ("1,2", "1,1"))
    assert len(got) == 3 and len(want) == 3
    np.testing.assert_allclose(got, want, **TOL)
