"""The port's tensor-parallel compute (``model > 1``), on gloo ranks over the
CPU, held to the single-rank port and to the reference on the same mesh.

One launch of ``tests/_torch_mesh_driver.py`` per mesh (1 x 2, 2 x 2 and
1 x 4) runs the ``tp_*`` cases, and the reference runs the same weights,
prompts and batches on the same meshes of simulated host devices, in one
subprocess of ``tests/_jax_mesh_reference.py`` per mesh, started with the
launches.  The rules are ``tests/test_torch_multidevice.py``'s: against the
single-rank port, greedy tokens identical and the rest at rtol 2e-4, atol
2e-5 in fp32; against the reference, rtol/atol 1e-5.  Updated params are
compared where both steps' |grad| is above 1e-3 of its leaf's max, and
everywhere within one Adam step (``2.5 * lr``): Adam turns an ulp of a
grad near 0 into up to an LR-sized step.

- PPO through the Hybrid Engine, ``zero3`` and ``tp`` + ZeRO-1: greedy
  experience token-identical, two ``train_rlhf`` steps, actor, critic and
  EMA params.  ``ACTOR`` has 4 heads and 2 kv heads: at 1 x 4 its kv
  heads are cut into half heads by the pspecs, which the compute view
  gathers.
- The engine: ``generate`` and the dense, paged int8 and tight paged int8
  request paths, token-identical; a sampled ``generate`` whose tokens are
  equal on every rank; the rank's KV arena holds its own kv heads.
- ``make_sharded_lm_step`` on reduced qwen3-8b (qk-norm; half-head kv
  shards at 1 x 4) in both layouts, a tied-embedding config, a vocabulary
  of 511 (replicated: it divides no ``tp``), ``remat=True`` with logit
  chunks, reduced llama4-scout-17b-a16e (global routing over ``data`` at
  2 x 2) and a ``trainable_mask``; every step's clip triggers.
- The reward step.
- Local bytes and shapes: at rest, a rank holds its replicated leaves
  plus ``1 / tp`` of its ``model``-sharded ones; an aligned 1 x 2 view
  gathers no weight over ``model``.
- MoE generation over a batch sharded on ``data`` at 2 x 2 (its decode
  routes the data group's rows together), token-identical, and
  ``torchrun ... launch.train --mesh 1,2`` (SFT and ``--rlhf``) against
  ``--mesh 1,1``.  The other layer kinds on ``model > 1`` are
  ``tests/test_torch_tp_layers.py``'s.
"""
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_driver as D
from _torch_parity import leaf_pairs
from repro_torch.core.pipeline import StageConfig
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.serving.engine import GenerationEngine, Request
from repro_torch.sharding import strategy as S
from repro_torch.training.steps import lm_loss_fn, lm_train_step
from repro_torch.training.steps import value_and_grad
from repro_torch.training.train_state import TrainState

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
REF_TOL = dict(rtol=1e-5, atol=1e-5)
MESHES = ((1, 2), (2, 2), (1, 4))
IDS = [f"{dp}x{tp}" for dp, tp in MESHES]
CASES = "tp_lm,tp_ppo,tp_engine,tp_reward,tp_layout,tp_refusals"
REF_LM = {"qwen3": "qwen3-8b", "moe": "llama4-scout-17b-a16e"}
PATHS = ["generate", "dense", "paged_int8", "paged_int8_tight"]
LM_IDS = [c[0] for c in D.TP_LM_CASES]


class FakeMesh:
    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")


def _torchrun(n: int, log: Path, *args):
    """A ``torchrun`` launch of ``n`` ranks, started (not waited on), its
    output to ``log`` (a pipe that nobody reads while the test waits on
    another process would block a rank inside a collective)."""
    with open(log, "w") as f:
        return subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n), *args], stdout=f,
            stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=_env())


def _wait(proc, log: Path, timeout=600) -> str:
    """The launch's output once it exits 0."""
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        pass                              # returncode None: fails below
    out = log.read_text()
    assert proc.returncode == 0, out[-4000:]
    return out


def _reference_inputs():
    """``_torch_mesh_driver``'s weights, prompts and batches, as numpy."""
    np_ = convert.params_to_numpy
    cfg = D.lm_config("smollm-135m")
    lm = {}
    for name, arch in REF_LM.items():
        c = D.tp_lm_config(arch, {})
        lm[name] = (arch, np_(T.init_params(c, D._gen(5))),
                    [{k: v.numpy() for k, v in b.items()}
                     for b in D.tp_lm_batches(c)])
    return {"ppo_kw": D.PPO_KW, "prompts": D.PROMPTS,
            **dict(zip(("actor", "ref", "critic", "reward"),
                       map(np_, D.models()))),
            "engine_params": np_(T.init_params(D.ACTOR, D._gen(1))),
            "rm_params": np_(R.init_params(cfg, D._gen(6))),
            "rm_lr": StageConfig.rm_lr,
            "rm_batches": list(tlaunch.lm_data(cfg, 16, 0).reward_batches(
                8, 2)),
            "lm": lm, "lm_lr": D.TP_LR}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The reference's runs and the gloo launches, one of each per mesh,
    all started together."""
    d = tmp_path_factory.mktemp("tp")
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
            dp * tp, out / "log", str(ROOT / "tests" / "_torch_mesh_driver.py"),
            "--out", str(out), "--cases", CASES, "--mesh", f"{dp},{tp}"))
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
def single():
    return {"ppo": D.ppo_run(D.trainer(None), D.PROMPTS)}


@pytest.fixture(scope="module")
def lm_single():
    """Each LM case's two plain ``lm_train_step``\\ s, with each step's
    grads."""
    out = {}
    for name, arch, over, _ in D.TP_LM_CASES:
        cfg = D.tp_lm_config(arch, over)
        params = T.init_params(cfg, D._gen(5))
        mask = D.tp_mask(params) if name == "mask" else None
        state = TrainState.create(params)
        grads, losses, gnorms = [], [], []
        for b in D.tp_lm_batches(cfg):
            _, g = value_and_grad(lambda p: lm_loss_fn(cfg, p, b),
                                  state.params)
            grads.append([t.numpy() for t in tree_leaves(g)])
            state, m = lm_train_step(cfg, state, b, D.TP_LR,
                                     trainable_mask=mask)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": gnorms, "grads": grads,
                     "params": [t.numpy() for t in tree_leaves(
                         state.params)]}
    return out


def _params_close(got, want, grads, lr, tol, err):
    """Updated params: at ``tol`` where every step's |grad| is above 1e-3
    of its leaf's max, everywhere within ``2.5 * lr``."""
    for i, (a, b) in enumerate(zip(got, want, strict=True)):
        big = np.logical_and.reduce([
            np.abs(g[i]) > 1e-3 * max(float(np.abs(g[i]).max()), 1e-12)
            for g in grads])
        np.testing.assert_allclose(a[big], b[big], err_msg=f"{err} {i}",
                                   **tol)
        assert float(np.abs(a - b).max()) <= 2.5 * lr, f"{err} {i}"


def _assert_ppo_close(got, want, err, tol):
    for k, v in want["exp"].items():
        if k in ("sequences", "mask"):
            np.testing.assert_array_equal(got["exp"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["exp"][k], v,
                                       err_msg=f"{err} {k}", **tol)
    for k in ("reward_score", "gen_len", "decode_steps"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   err_msg=f"{err} {k}", **tol)
    assert len(got["steps"]) == len(want["steps"])
    for g, w in zip(got["steps"], want["steps"]):
        for k, v in w.items():
            if not k.endswith("_ms"):
                np.testing.assert_allclose(g[k], float(v),
                                           err_msg=f"{err} {k}", **tol)


# --------------------------------------------------------------------- #
# PPO through the Hybrid Engine
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("strategy", ["zero3", "tp"],
                         ids=["zero3", "tp_zero1"])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_ppo_matches_single_rank(runs, single, mesh, strategy):
    got, want = runs[mesh]["tp_ppo"][strategy], single["ppo"]
    _assert_ppo_close(got, want, f"{mesh} {strategy}", TOL)
    for name in ("actor", "critic", "ema"):
        for a, b in zip(got[name], want[name], strict=True):
            np.testing.assert_allclose(a, b, err_msg=name, **TOL)
    dp = mesh[0]
    # params sharded over data in the zero3 layout: a real gather
    assert (got["metrics"]["reshard_bytes"] > 0) == (
        strategy == "zero3" and dp > 1)


def _templates():
    actor, _, critic, _ = D.models()
    return {"actor": actor, "ema": actor, "critic": critic,
            "rm": R.init_params(D.lm_config("smollm-135m"), D._gen(6))}


def _ref_leaves(template, tree):
    return [np.asarray(b) for _, b in leaf_pairs(template, tree)]


@pytest.mark.parametrize("strategy", ["zero3", "tp"],
                         ids=["zero3", "tp_zero1"])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_ppo_matches_the_reference(runs, reference, mesh, strategy):
    """The reference's ``PPOTrainer(engine=HybridEngine)`` on the same
    ``dp x tp`` mesh: the experience, the step metrics, the reshard bytes
    and the actor, critic and EMA params."""
    got = runs[mesh]["tp_ppo"][strategy]
    want = reference[mesh]["ppo"][strategy]
    _assert_ppo_close(got, want, f"{mesh} {strategy}", REF_TOL)
    np.testing.assert_allclose(got["metrics"]["reshard_bytes"],
                               want["metrics"]["reshard_bytes"])
    tpl = _templates()
    for name in ("actor", "critic", "ema"):
        for a, b in zip(got[name], _ref_leaves(tpl[name], want[name])):
            np.testing.assert_allclose(a, b, err_msg=name, **REF_TOL)


# --------------------------------------------------------------------- #
# the engine
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def engine_single():
    params = T.init_params(D.ACTOR, D._gen(1))
    e0 = GenerationEngine(D.ACTOR, device="cpu", **D.PPO_KW)
    out = {"generate": {k: v.numpy() for k, v in e0.generate(
        params, torch.as_tensor(D.PROMPTS), D._gen(7)).items()},
        "generate_steps": e0.last_stats["decode_steps"]}
    reqs = [Request(uid=i, tokens=D.PROMPTS[i], max_new_tokens=8)
            for i in range(len(D.PROMPTS))]
    qcfg = D.ACTOR.replace(kv_quant=True)
    paged = dict(kv_layout="paged", block_size=4)
    for name, cfg, kw, skw in (
            ("dense", D.ACTOR, {}, dict(slots=2)),
            ("paged_int8", qcfg, paged, dict(slots=2)),
            ("paged_int8_tight", qcfg, dict(paged, chunk=2),
             dict(slots=2, max_seq_len=16, num_blocks=7, watermark=0))):
        eng = GenerationEngine(cfg, device="cpu", **{**D.PPO_KW, **kw})
        out[name] = {c.uid: (c.tokens, c.finish_reason)
                     for c in eng.serve(params, reqs, D._gen(7), **skw)}
    return out


def _assert_paths_equal(got, want, path):
    if path == "generate":
        for k, v in want["generate"].items():
            np.testing.assert_array_equal(got["generate"][k], v, err_msg=k)
        assert got["generate_steps"] == want["generate_steps"]
        return
    assert sorted(got[path]) == sorted(want[path])
    for uid, (toks, reason) in want[path].items():
        np.testing.assert_array_equal(got[path][uid][0], toks)
        assert got[path][uid][1] == reason


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_engine_is_token_identical(runs, engine_single, mesh, path):
    _assert_paths_equal(runs[mesh]["tp_engine"], engine_single, path)


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_engine_matches_the_reference(runs, reference, mesh, path):
    _assert_paths_equal(runs[mesh]["tp_engine"], reference[mesh]["engine"],
                        path)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_sampled_tokens_agree_across_ranks(runs, mesh):
    """Temperature 0.8: every rank (the ranks of a model group sample from
    the same gathered logits with the same generator, and the data group
    gathers the rows) returns the same tokens, and they are not greedy's."""
    seqs = runs[mesh]["tp_engine"]["sampled"]
    assert len(seqs) == mesh[0] * mesh[1]
    for s in seqs[1:]:
        np.testing.assert_array_equal(s, seqs[0])
    greedy = runs[mesh]["tp_engine"]["generate"]["sequences"]
    assert not np.array_equal(seqs[0], greedy)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_kv_arena_holds_the_rank_kv_heads(runs, mesh):
    """``ACTOR``'s 2 kv heads: one a rank at tp 2 and at tp 4 (the one its
    q heads read)."""
    for k in ("k", "v"):
        assert runs[mesh]["tp_engine"]["kv_arena"][k][3] == 1


# --------------------------------------------------------------------- #
# LM and reward steps
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("case", LM_IDS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_lm_step_matches_single_rank(runs, lm_single, mesh, case):
    got, want = runs[mesh]["tp_lm"][case], lm_single[case]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    _params_close(got["params"], want["params"], want["grads"], D.TP_LR,
                  TOL, f"{mesh} {case}")


def test_tp_lm_steps_clip(lm_single):
    """Every LM step's grad norm is above the clip of 1.0, so each one
    above is a clipped step: the norm sums every element once."""
    for case, r in lm_single.items():
        assert min(r["grad_norm"]) > 1.0, case


@pytest.mark.parametrize("case", sorted(REF_LM))
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_lm_step_matches_the_reference(runs, reference, mesh, case):
    """``make_sharded_lm_step(..., "zero3")`` of the reference on the same
    mesh: losses and grad norms at rtol/atol 1e-5, params by the |grad|
    rule."""
    got, want = runs[mesh]["tp_lm"][case], reference[mesh]["lm"][case]
    np.testing.assert_allclose(got["loss"], want["loss"], **REF_TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                               rtol=1e-4)
    tpl = T.init_params(D.tp_lm_config(REF_LM[case], {}), D._gen(5))
    _params_close(got["params"], _ref_leaves(tpl, want["params"]),
                  [_ref_leaves(tpl, g) for g in want["grads"]], D.TP_LR,
                  REF_TOL, f"{mesh} {case}")


@pytest.fixture(scope="module")
def reward_single():
    return D.reward_run()


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_reward_step_matches_single_rank(runs, reward_single, mesh):
    got = runs[mesh]["tp_reward"]
    for g, w in zip(got["metrics"], reward_single["metrics"], strict=True):
        assert g.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, err_msg=k, **TOL)
    for a, b in zip(got["params"], reward_single["params"], strict=True):
        np.testing.assert_allclose(a, b, **TOL)


@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_reward_step_matches_the_reference(runs, reference, mesh):
    got, want = runs[mesh]["tp_reward"], reference[mesh]["reward"]
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, err_msg=k, **REF_TOL)
    tpl = _templates()["rm"]
    _params_close(got["params"], _ref_leaves(tpl, want["params"]),
                  [_ref_leaves(tpl, g) for g in want["grads"]],
                  StageConfig.rm_lr, REF_TOL, f"reward {mesh}")


# --------------------------------------------------------------------- #
# layouts
# --------------------------------------------------------------------- #
def _want_bytes(dp, tp, strategy):
    """Bytes of a rank's piece of ``ACTOR``'s params under the pspecs: a
    dim on ``data`` cut ``dp`` ways, a dim on ``model`` ``tp`` ways."""
    mesh = FakeMesh({"data": dp, "model": tp})
    ps = S.param_pspecs(D.ACTOR, mesh, strategy)
    n = 0
    for t, p in zip(tree_leaves(T.init_params(D.ACTOR, D._gen(0))),
                    tree_leaves(ps, is_leaf=S.is_pspec)):
        cut = {"data": dp, "model": tp}
        n += t.numel() // int(np.prod([cut[e] for e in p if e in cut]))
    return 4 * n


@pytest.mark.parametrize("strategy", ["tp", "zero3"])
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_tp_local_bytes_follow_the_pspecs(runs, mesh, strategy):
    """At rest a rank holds its pspec's piece; in the ``tp`` layout that is
    its replicated leaves plus ``1 / tp`` of the ``model``-sharded ones.
    Computing, it holds those plus, at ``tp > KV``, its one kv head
    gathered from the half heads the pspec cut; an aligned mesh gathers
    nothing over ``model``."""
    dp, tp = mesh
    got = runs[mesh]["tp_layout"][strategy]
    assert got["rest_bytes"] == _want_bytes(dp, tp, strategy)
    ps = tree_leaves(S.param_pspecs(D.ACTOR, FakeMesh(
        {"data": dp, "model": tp}), "tp"), is_leaf=S.is_pspec)
    full = tree_leaves(T.init_params(D.ACTOR, D._gen(0)))
    if strategy == "tp" and dp == 1:
        rep = sum(4 * t.numel() for t, p in zip(full, ps) if "model" not in p)
        cut = sum(4 * t.numel() for t, p in zip(full, ps) if "model" in p)
        assert got["rest_bytes"] == rep + cut // tp
    if tp == 2:
        assert got["model_gathers"] == []
        assert got["view_bytes"] == _want_bytes(1, tp, "tp")
    else:               # wk and wv, layers stacked: half heads gathered
        assert len(got["model_gathers"]) == 2
        kv = D.ACTOR.n_kv_heads * D.ACTOR.head_dim
        assert got["view_bytes"] == _want_bytes(1, tp, "tp") + 2 * 4 * (
            D.ACTOR.n_layers * D.ACTOR.d_model * (kv // 2 - kv // tp))


@pytest.mark.parametrize("strategy", ["tp", "zero3", "zero1"])
@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("arch", ["actor", "qwen3-8b"])
def test_compute_slices_follow_the_heads_each_rank_reads(arch, tp,
                                                         strategy):
    """``strategy.compute_slices`` from the pspecs alone: where the layout
    cuts heads, rank ``r`` computes q heads ``[r H / tp, (r + 1) H / tp)``
    of ``wq`` / ``wo`` and exactly the kv heads they read (head ``h`` reads
    ``h // G``, R4) of ``wk`` / ``wv``, sliced from the gathered leaf when
    the pspec cuts half heads; MLP width and vocabulary as cut; a layout
    that cuts nothing over ``model`` (zero1) computes every leaf whole."""
    from repro_torch.models.modules import tree_map
    cfg = D.ACTOR if arch == "actor" else D.lm_config(arch)
    mesh = FakeMesh({"data": 1, "model": tp})
    ps = S.param_pspecs(cfg, mesh, strategy)
    dims = tree_map(S.model_dim, ps, is_leaf=S.is_pspec)
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    for r in range(tp):
        v = S.compute_slices(T.param_specs(cfg), dims, cfg, tp, r)
        attn = v["segments"][0][0]["attn"]
        if strategy == "zero1":
            assert all(x.kind == S.FULL for x in tree_leaves(
                v, is_leaf=lambda x: isinstance(x, S.View)))
            continue
        cols = lambda x, n: set(range(x.index * (n // x.parts),
                                      (x.index + 1) * (n // x.parts)))
        q = cols(attn["wq"], H * hd)
        assert attn["wq"].kind == S.ALIGNED and q == cols(attn["wo"], H * hd)
        read = {(c // hd) // (H // KV) for c in q}
        for k in ("wk", "wv"):
            assert {c // hd for c in cols(attn[k], KV * hd)} == read, k
            assert len(cols(attn[k], KV * hd)) == len(read) * hd
            assert attn[k].kind == (S.ALIGNED if KV % tp == 0
                                    else S.SLICED)
        mlp = v["segments"][0][0]["mlp"]
        assert {mlp[k].kind for k in mlp} == {S.ALIGNED}
        assert v["embed"].kind == S.ALIGNED
        assert v["final_norm"].kind == S.FULL


def test_tp_moe_generation_over_data_is_refused(runs):
    """At 2 x 2 an MoE model's greedy decode over a batch sharded on
    ``data`` runs (it routes the data group's rows together, R13), and its
    tokens are the single-rank engine's (``tests/test_torch_mesh_serving.py``
    holds the rows each MoE call routes)."""
    got = runs[(2, 2)]["tp_refusals"]
    assert got["engine_moe_rows"] is None
    moe = D.lm_config("llama4-scout-17b-a16e")
    want = GenerationEngine(moe, device="cpu", **D.PPO_KW).generate(
        T.init_params(moe, D._gen(0)), torch.as_tensor(D.PROMPTS),
        D._gen(0))["sequences"].numpy()
    np.testing.assert_array_equal(got["moe_sequences"], want)


# --------------------------------------------------------------------- #
# the launcher under torchrun
# --------------------------------------------------------------------- #
def _launch(mesh: str, rlhf: bool, log: Path):
    n = int(np.prod([int(x) for x in mesh.split(",")]))
    extra = (["--rlhf", "--steps", "2", "--batch", "2", "--max-new", "4"]
             if rlhf else ["--steps", "3", "--batch", "4"])
    return _torchrun(n, log, "-m", "repro_torch.launch.train", "--device",
                     "cpu", "--arch", "smollm-135m", "--reduced", "--mesh",
                     mesh, "--strategy", "tp", "--seq", "16", *extra)


@pytest.mark.parametrize("rlhf", [False, True], ids=["sft", "rlhf"])
def test_torchrun_launcher_on_a_tp_mesh(rlhf, tmp_path):
    """``--mesh 1,2 --strategy tp`` exits 0, rank 0 alone prints, and its
    losses equal ``--mesh 1,1``'s."""
    procs = {m: _launch(m, rlhf, tmp_path / m) for m in ("1,2", "1,1")}
    outs = {}
    for m, p in procs.items():
        out = _wait(p, tmp_path / m, timeout=300)
        assert out.count(f"mesh={{'data': 1, 'model': {m[-1]}}}") == 1, out
        outs[m] = out
    pat = (r"^sft_loss=([0-9.]+)" if rlhf
           else r"^step +\d+ +loss=([0-9.]+)")
    got, want = (np.array([float(x) for x in re.findall(
        pat, outs[m], flags=re.M)]) for m in ("1,2", "1,1"))
    assert len(got) == (1 if rlhf else 3) and len(want) == len(got)
    np.testing.assert_allclose(got, want, **TOL)


# --------------------------------------------------------------------- #
# the example
# --------------------------------------------------------------------- #
def _demo():
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "_example_torch_hybrid_engine_demo",
        ROOT / "examples" / "torch_hybrid_engine_demo.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_hybrid_engine_demo_matches_the_reference_printout(capsys):
    """``examples/torch_hybrid_engine_demo.py`` on a one-rank gloo group:
    the roundtrip and analytics lines are the reference demo's (run in a
    subprocess through ``tests/_jax_mesh_reference.py``'s loader)."""
    out = _demo().main(["--device", "cpu"])
    mine = capsys.readouterr().out.splitlines()
    assert out["roundtrip_exact"]
    ref = subprocess.run(
        [sys.executable, "-c", "import runpy, _jax_mesh_reference; "
         "runpy.run_path('examples/hybrid_engine_demo.py', "
         "run_name='__main__')"], capture_output=True, text=True, cwd=ROOT,
        env=dict(_env(), JAX_PLATFORMS="cpu"), timeout=300)
    assert ref.returncode == 0, ref.stderr[-4000:]
    keep = lambda lines: [s for s in lines if "roundtrip" in s
                          or "generated tokens" in s or "amortizes" in s]
    assert keep(mine) == keep(ref.stdout.splitlines())
    assert len(keep(mine)) == 5


def test_hybrid_engine_demo_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this check is for a machine without CUDA")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        _demo().main([])
