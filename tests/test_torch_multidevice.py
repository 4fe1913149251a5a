"""The port's data-parallel meshes, on gloo ranks over the CPU, held to the
single-rank port and to the reference on the same mesh.

The rule is the reference's under GSPMD: on a ``dp x 1`` mesh every result
is the single-device result of the global batch.  Greedy tokens are
identical; losses, metrics and updated params agree to rtol 2e-4, atol
2e-5 in fp32 (``tests/test_multidevice.py``'s tolerance: collectives sum in
another order).  Two launches of ``tests/_torch_mesh_driver.py`` (dp 2 and
dp 4) run every case; the single-rank references run here.

The reference itself runs the same weights (carried across with
``convert``), prompts and reward batches on ``dp x 1`` meshes of simulated
host devices, in two subprocesses of ``tests/_jax_mesh_reference.py`` that
run while the gloo launches do.  Against it, at ``tests/test_torch_ppo.py``'s
tolerances: the PPO experience (tokens identical, the rest at rtol/atol
1e-5), the step metrics and the actor, critic and EMA params (rtol/atol
1e-5), the engine's tokens, and the reward step's metrics (rtol/atol 1e-5)
and params (rtol/atol 1e-5 where both steps' |grad| is above 1e-3 of its
leaf's max; everywhere within one Adam step, ``2.5 * lr``).

- PPO through the Hybrid Engine with ``zero3`` and with ``tp`` + ZeRO-1:
  greedy experience token-identical, two ``train_rlhf`` steps, the actor,
  critic and EMA params; ``reshard_bytes > 0`` for zero3 at dp > 1.
- The engine under the mesh: ``generate``, and the dense, paged int8 and
  tight paged int8 request paths, token-identical.
- A batch of 6 at dp 4 (replicated: it does not divide).
- ``make_sharded_lm_step`` at micro 2 through the launcher's loop, against
  ``lm_train_step`` and the reference's ``jax_lm_loop``; ``ddp``; zero3
  with the gather / grad pspecs; a reduced ``mamba2-370m`` step; the
  reduced ``musicgen-medium`` (frame embeddings) and
  ``llama-3.2-vision-11b`` (encoder embeddings) steps against
  ``lm_train_step`` on one rank.
- The reward step (pairwise loss and accuracy over the global batch).
- The train state's local shard shapes against the pspecs.
- The refusals: ``rollout_mesh``, ``--mesh`` with ``--lora``; the
  request core on a 4 x 1 mesh, accepted, with the single-rank core's
  stats; ``torchrun ... launch.train --mesh 2,1 --ckpt-dir`` commits
  sharded checkpoints that verify; and ``torchrun ... launch.train --mesh
  2,1 --strategy zero3`` (SFT and ``--rlhf``) exits 0.
"""
import json
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import _torch_mesh_driver as D
from _torch_parity import jax_lm_loop, leaf_pairs
from repro.training.train_state import TrainState as JTrainState
from repro_torch.core.pipeline import StageConfig
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.serving.engine import GenerationEngine, Request
from repro_torch.sharding import strategy as S
from repro_torch.training.steps import lm_train_step
from repro_torch.training.train_state import TrainState

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
REF_TOL = dict(rtol=1e-5, atol=1e-5)    # tests/test_torch_ppo.py's
DPS = (2, 4)
LM_CASES = D.LM_CASES


class FakeMesh:
    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


def _env():
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")


def _torchrun(n: int, *args, timeout=300):
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", str(n), *args], capture_output=True, text=True,
        cwd=ROOT, timeout=timeout, env=_env())


def _reference_inputs():
    """``_torch_mesh_driver``'s weights, prompts and reward batches, as
    numpy."""
    cfg = D.lm_config("smollm-135m")
    np_ = convert.params_to_numpy
    return {"ppo_kw": D.PPO_KW, "prompts": D.PROMPTS,
            "prompts6": D.PROMPTS6,
            **dict(zip(("actor", "ref", "critic", "reward"),
                       map(np_, D.models()))),
            "engine_params": np_(T.init_params(D.ACTOR, D._gen(1))),
            "rm_params": np_(R.init_params(cfg, D._gen(6))),
            "rm_lr": StageConfig.rm_lr,
            "rm_batches": list(tlaunch.lm_data(cfg, 16, 0).reward_batches(
                8, 2))}


@pytest.fixture(scope="module")
def reference_procs(tmp_path_factory):
    """The reference's runs, one subprocess per dp, started before the
    gloo launches and read at the end of the file, so that they run while
    the tests before them do."""
    d = tmp_path_factory.mktemp("reference")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(_reference_inputs(), f)
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS=f"--xla_force_host_platform_device_count={max(DPS)}")
    script, procs = ROOT / "tests" / "_jax_mesh_reference.py", {}
    for dp in DPS:
        with open(d / f"dp{dp}.log", "w") as log:
            procs[dp] = subprocess.Popen(
                [sys.executable, str(script), str(d / "in.pkl"),
                 str(d / f"dp{dp}.pkl"), str(dp)],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    yield d, procs
    for p in procs.values():
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def reference(reference_procs):
    d, procs = reference_procs
    out = {}
    for dp, p in procs.items():
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            pass                          # returncode None: fails below
        assert p.returncode == 0, (d / f"dp{dp}.log").read_text()[-4000:]
        with open(d / f"dp{dp}.pkl", "rb") as f:
            out[dp] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def runs(reference_procs, tmp_path_factory):
    """Each dp's results, from one multi-rank launch per dp."""
    out = {}
    for dp in DPS:
        d = tmp_path_factory.mktemp(f"dp{dp}")
        cases = ("ppo,engine,lm,embeds,reward"
                 + (",refusals" if dp == 4 else ""))
        res = _torchrun(dp, str(ROOT / "tests" / "_torch_mesh_driver.py"),
                        "--out", str(d), "--cases", cases)
        assert res.returncode == 0, res.stderr[-4000:]
        out[dp] = {c: torch.load(d / f"{c}.pt", weights_only=False)
                   for c in cases.split(",")}
    return out


@pytest.fixture(scope="module")
def single():
    """The single-rank port on the same weights and prompts."""
    return {"ppo": D.ppo_run(D.trainer(None), D.PROMPTS),
            "batch6": D.ppo_run(D.trainer(None), D.PROMPTS6, steps=1)}


def _close(got, want, err):
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, err_msg=err, **TOL)


def _assert_ppo_close(got, want, err):
    for k, v in want["exp"].items():
        if k in ("sequences", "mask"):
            np.testing.assert_array_equal(got["exp"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["exp"][k], v, err_msg=f"{err} {k}",
                                       **TOL)
    for k in ("reward_score", "gen_len", "decode_steps"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   err_msg=f"{err} {k}", **TOL)
    assert len(got["steps"]) == len(want["steps"])
    for g, w in zip(got["steps"], want["steps"]):
        for k, v in w.items():
            if not k.endswith("_ms"):
                np.testing.assert_allclose(g[k], v, err_msg=f"{err} {k}",
                                           **TOL)
    for name in ("actor", "critic", "ema"):
        _close(got[name], want[name], f"{err} {name}")


@pytest.mark.parametrize("strategy", ["zero3", "tp"],
                         ids=["zero3", "tp_zero1"])
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_sharded_ppo_matches_single_rank(runs, single, dp, strategy):
    got = runs[dp]["ppo"][strategy]
    _assert_ppo_close(got, single["ppo"], f"dp={dp} {strategy}")
    assert got["metrics"]["reshard_s"] > 0
    if strategy == "zero3":
        # params sharded over data in the train layout: a real gather
        assert got["metrics"]["reshard_bytes"] > 0
    else:
        assert got["metrics"]["reshard_bytes"] == 0


@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_batch_that_does_not_divide_is_replicated(runs, single, dp):
    """6 prompts: sharded at dp 2, replicated at dp 4 (every rank computes
    the whole batch; the grads are neither summed nor divided)."""
    _assert_ppo_close(runs[dp]["ppo"]["batch6"], single["batch6"],
                      f"batch 6 at dp={dp}")
    assert (S.batch_pspec(FakeMesh({"data": dp, "model": 1}), 6, 2)[0]
            is None) == (dp == 4)


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


@pytest.mark.parametrize("path", ["generate", "dense", "paged_int8",
                                  "paged_int8_tight"])
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_engine_under_mesh_is_token_identical(runs, engine_single, dp,
                                              path):
    got, want = runs[dp]["engine"][path], engine_single[path]
    if path == "generate":
        for k, v in want.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
        assert (runs[dp]["engine"]["generate_steps"]
                == engine_single["generate_steps"])
        return
    assert sorted(got) == sorted(want)
    for uid, (toks, reason) in want.items():
        np.testing.assert_array_equal(got[uid][0], toks)
        assert got[uid][1] == reason


@pytest.fixture(scope="module")
def lm_single():
    out = {}
    for arch, strategy, micro, steps in LM_CASES:
        if strategy.endswith("-gather"):  # fp32 compute: the cast is exact
            out[(arch, strategy)] = out[(arch, "ddp")]
            continue
        cfg = D.lm_config(arch)
        params = T.init_params(cfg, D._gen(5))
        kw = {**D.LM_KW, "steps": steps}
        state, summ = tlaunch.train_lm(cfg, TrainState.create(params),
                                       device="cpu", micro=micro, **kw)
        out[(arch, strategy)] = {
            "loss": summ["loss"], "grad_norm": summ["grad_norm"],
            "params": [t.numpy() for t in tree_leaves(state.params)],
            "m": [t.numpy() for t in tree_leaves(state.opt.m)],
            "v": [t.numpy() for t in tree_leaves(state.opt.v)]}
    return out


@pytest.mark.parametrize("case", LM_CASES, ids=[f"{a}-{s}-micro{m}"
                                                for a, s, m, _ in LM_CASES])
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_sharded_lm_step_matches_lm_train_step(runs, lm_single, dp, case):
    key = case[:2]
    got, want = runs[dp]["lm"][key], lm_single[key]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    np.testing.assert_allclose(got["grad_norm"], want["grad_norm"], **TOL)
    for name in ("params", "m", "v"):
        _close(got[name], want[name], f"dp={dp} {key} {name}")


@pytest.mark.parametrize("arch", D.EMBED_ARCHS)
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_sharded_lm_step_takes_embedding_inputs(runs, dp, arch):
    """The audio decoder's frame embeddings and the VLM's encoder
    embeddings shard with their rows: two zero3 + ZeRO-1 steps on the mesh
    equal two ``lm_train_step`` on one rank (losses, params)."""
    cfg = D.lm_config(arch)
    want = D.embed_run(cfg, TrainState.create(D.embed_params(cfg)),
                       lambda s, b, lr: lm_train_step(cfg, s, b, lr))
    got = runs[dp]["embeds"][arch]
    np.testing.assert_allclose(got["loss"], want["loss"], **TOL)
    _close(got["params"], want["params"], f"dp={dp} {arch} params")


def test_sharded_lm_step_matches_the_reference_loop(runs):
    """The reference's SFT loop at micro 2 (``jax_lm_loop``) from the same
    weights: losses and grad norms of every step, at both dp."""
    arch, _, micro, steps = LM_CASES[0]
    cfg = D.lm_config(arch)
    from repro import configs as jconfigs
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        use_pallas=False)
    jparams = jax.tree.map(lambda a: jnp.array(a, copy=True),
                           convert.params_to_numpy(
                               T.init_params(cfg, D._gen(5))))
    _, jl, jgn = jax_lm_loop(jcfg, JTrainState.create(jparams),
                             micro=micro, **{**D.LM_KW, "steps": steps})
    for dp in DPS:
        got = runs[dp]["lm"][(arch, "zero3")]
        np.testing.assert_allclose(got["loss"], jl, **TOL)
        np.testing.assert_allclose(got["grad_norm"], jgn, **TOL)


@pytest.fixture(scope="module")
def reward_single():
    return D.reward_run()


@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_sharded_reward_step_matches_single_rank(runs, reward_single, dp):
    """The pairwise loss and accuracy are the global batch's means."""
    got = runs[dp]["reward"]
    for g, w in zip(got["metrics"], reward_single["metrics"]):
        assert g.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, err_msg=k, **TOL)
    _close(got["params"], reward_single["params"], f"reward dp={dp}")


@pytest.mark.parametrize("strategy", ["zero3", "tp"],
                         ids=["zero3", "tp_zero1"])
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_train_state_local_shapes_follow_the_pspecs(runs, dp, strategy):
    """Each rank holds exactly the pspec's piece: a dim on ``data`` is cut
    dp ways, every other dim is whole; ZeRO-1 moments cut ``embed``."""
    mesh = FakeMesh({"data": dp, "model": 1})
    ps = S.train_state_pspecs(D.ACTOR, mesh, strategy, zero=1)
    full = [tuple(t.shape) for t in tree_leaves(T.init_params(
        D.ACTOR, D._gen(0)))]
    shapes = runs[dp]["ppo"]["shapes"][strategy]
    for kind, tree in (("params", ps.params), ("m", ps.opt.m)):
        want = [tuple(n // dp if e == "data" else n for n, e in zip(shp, p))
                for shp, p in zip(full, tree_leaves(
                    tree, is_leaf=S.is_pspec))]
        assert shapes[kind] == want, kind
    if strategy == "tp":        # params replicated, moments sharded
        assert shapes["params"] == full and shapes["m"] != full


@pytest.mark.parametrize("what", ["mla_tp2", "ssm_tp2", "xattn_tp2",
                                  "core", "rollout_mesh"])
def test_mesh_refusals(runs, what):
    """A ``rollout_mesh`` without the training mesh's engine, or sharing
    the engine's ranks (not the disjoint pair of
    ``make_disaggregated_meshes``), is refused (the split itself:
    ``tests/test_torch_disaggregated.py``); MLA, SSM and cross-attention layers on
    ``model > 1`` are accepted (their compute is
    ``tests/test_torch_tp_layers.py``'s), and so is ``core()`` on a 4 x 1
    mesh: drained on 4 slots (one a data rank), its ``stats()`` are the
    single-rank core's (its streams: ``tests/test_torch_mesh_serving.py``)."""
    msg = runs[4]["refusals"][what]
    if what.endswith("_tp2"):
        assert msg is None
        return
    if what == "core":
        assert msg is None
        core = GenerationEngine(D.ACTOR, device="cpu", **D.PPO_KW).core(
            D.models()[0], D._gen(0), slots=4, max_seq_len=16)
        for r in D.ms_requests():
            core.add_request(r)
        while core.has_work():
            core.step()
        assert runs[4]["refusals"]["core_stats"] == core.stats()
        return
    assert msg == ("ValueError: PPOTrainer(rollout_mesh=) needs engine=: a "
                   "HybridEngine on the training mesh, disjoint from the "
                   "rollout mesh")
    shared = runs[4]["refusals"]["rollout_mesh_shared"]
    assert shared.startswith("ValueError: a rollout mesh and a training "
                             "mesh come from make_disaggregated_meshes")


def test_mesh_with_checkpoints_is_refused(tmp_path):
    """``--mesh 2,1 --ckpt-dir`` saves (sharded, both ranks writing; the
    checkpoints verify and some leaf has a shard per data rank);
    ``--mesh`` with ``--lora`` stays refused."""
    from repro_torch.training.checkpoint import CheckpointManager
    res = _torchrun(2, "-m", "repro_torch.launch.train", "--device", "cpu",
                    "--arch", "smollm-135m", "--reduced", "--mesh", "2,1",
                    "--seq", "16", "--batch", "4", "--steps", "2",
                    "--save-every", "1", "--ckpt-dir", str(tmp_path))
    assert res.returncode == 0, res.stderr[-4000:]
    mgr = CheckpointManager(str(tmp_path))
    assert mgr.all_steps() == [1, 2]
    for step in (1, 2):
        mgr.verify(step)
    with open(tmp_path / "step_00000002" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]
    assert max(len(e["shards"]) for e in leaves.values()) == 2
    with pytest.raises(SystemExit):
        tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", "--mesh", "2,1", "--lora", "4"])


@pytest.mark.parametrize("rlhf", [False, True], ids=["sft", "rlhf"])
def test_torchrun_launcher_on_a_mesh(rlhf):
    """``torchrun --nproc-per-node 2 -m repro_torch.launch.train --mesh
    2,1``: exits 0, and rank 0 alone prints the summaries."""
    extra = (["--rlhf", "--steps", "2", "--batch", "2", "--max-new", "4"]
             if rlhf else ["--steps", "3", "--batch", "4"])
    res = _torchrun(2, "-m", "repro_torch.launch.train", "--device", "cpu",
                    "--arch", "smollm-135m", "--reduced", "--mesh", "2,1",
                    "--strategy", "zero3", "--seq", "16", *extra)
    assert res.returncode == 0, res.stderr[-4000:]
    assert res.stdout.count("mesh={'data': 2, 'model': 1}") == 1, res.stdout
    if rlhf:
        assert len(re.findall(r"^sft_loss=", res.stdout, flags=re.M)) == 1
    else:
        steps = re.findall(r"^step +(\d+) +loss=", res.stdout, flags=re.M)
        assert steps == ["0", "1", "2"], res.stdout


# --------------------------------------------------------------------- #
# the reference on the same mesh
# --------------------------------------------------------------------- #
def _templates():
    """Port trees to order the reference's leaves by (JAX sorts dict
    keys; the port keeps insertion order)."""
    actor, _, critic, _ = D.models()
    return {"actor": actor, "ema": actor, "critic": critic,
            "rm": R.init_params(D.lm_config("smollm-135m"), D._gen(6))}


def _ref_leaves(template, tree):
    return [np.asarray(b) for _, b in leaf_pairs(template, tree)]


@pytest.mark.parametrize("what", ["zero3", "tp", "batch6"],
                         ids=["zero3", "tp_zero1", "batch6"])
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_sharded_ppo_matches_the_reference(runs, reference, dp, what):
    """The port's sharded PPO against the reference's ``PPOTrainer(engine=
    HybridEngine)`` on the same ``dp x 1`` mesh: greedy experience
    token-identical, the rest of it, the experience and step metrics and
    the actor, critic and EMA params at rtol/atol 1e-5; the measured
    reshard bytes equal."""
    got, want = runs[dp]["ppo"][what], reference[dp]["ppo"][what]
    for k, v in want["exp"].items():
        if k in ("sequences", "mask"):
            np.testing.assert_array_equal(got["exp"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["exp"][k], v, err_msg=k,
                                       **REF_TOL)
    for k in ("reward_score", "gen_len", "decode_steps", "reshard_bytes"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   err_msg=k, **REF_TOL)
    assert len(got["steps"]) == len(want["steps"])
    for g, w in zip(got["steps"], want["steps"]):
        for k, v in w.items():
            np.testing.assert_allclose(g[k], float(v), err_msg=k, **REF_TOL)
    tpl = _templates()
    for name in ("actor", "critic", "ema"):
        for a, b in zip(got[name], _ref_leaves(tpl[name], want[name])):
            np.testing.assert_allclose(a, b, err_msg=name, **REF_TOL)


@pytest.mark.parametrize("path", ["generate", "dense", "paged_int8",
                                  "paged_int8_tight"])
@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_engine_under_mesh_matches_the_reference(runs, reference, dp, path):
    got, want = runs[dp]["engine"], reference[dp]["engine"]
    if path == "generate":
        for k, v in want["generate"].items():
            np.testing.assert_array_equal(got["generate"][k], v, err_msg=k)
        assert got["generate_steps"] == want["generate_steps"]
        return
    assert sorted(got[path]) == sorted(want[path])
    for uid, (toks, reason) in want[path].items():
        np.testing.assert_array_equal(got[path][uid][0], toks)
        assert got[path][uid][1] == reason


@pytest.mark.parametrize("dp", DPS, ids=[f"dp{d}" for d in DPS])
def test_sharded_reward_step_matches_the_reference(runs, reference, dp):
    """Two reward steps on the zero3 + ZeRO-1 state against the
    reference's jitted step on the same mesh: metrics at rtol/atol 1e-5;
    params at rtol/atol 1e-5 where both steps' |grad| is above the noise,
    and everywhere within one Adam step (Adam turns a grad near 0 into up
    to an LR-sized step, and such a grad may flip sign between
    frameworks)."""
    got, want = runs[dp]["reward"], reference[dp]["reward"]
    for g, w in zip(got["metrics"], want["metrics"], strict=True):
        assert g.keys() == w.keys()
        for k, v in w.items():
            np.testing.assert_allclose(g[k], v, err_msg=k, **REF_TOL)
    tpl = _templates()["rm"]
    grads = [_ref_leaves(tpl, g) for g in want["grads"]]
    for i, (a, b) in enumerate(zip(got["params"],
                                   _ref_leaves(tpl, want["params"]))):
        big = np.logical_and.reduce([
            np.abs(g[i]) > 1e-3 * max(float(np.abs(g[i]).max()), 1e-12)
            for g in grads])
        np.testing.assert_allclose(a[big], b[big], **REF_TOL)
        assert float(np.abs(a - b).max()) <= 2.5 * StageConfig.rm_lr
