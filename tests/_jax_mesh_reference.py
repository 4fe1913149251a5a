"""The reference's data- and tensor-parallel runs, on simulated host
devices, for ``tests/test_torch_multidevice.py``,
``tests/test_torch_tensor_parallel.py`` and
``tests/test_torch_tp_layers.py``::

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        python tests/_jax_mesh_reference.py IN.pkl OUT.pkl DP [TP]

``IN`` holds numpy trees made from the port's seeds (``_torch_mesh_driver``'s
weights, prompts and reward and LM batches).  The reference runs, on a
``DP x TP`` mesh (``TP`` 1 by default), what
``tests/_torch_mesh_driver.py`` runs on ``DP * TP`` gloo ranks:

- ``PPOTrainer(engine=HybridEngine)`` with ``zero3`` and with ``tp`` +
  ZeRO-1 (greedy experience, two ``train_rlhf`` steps), and a batch of 6
  (one step);
- the engine under the mesh: ``generate`` and the dense, paged int8 and
  tight paged int8 request paths;
- two jitted ``reward_train_step`` calls on the ``zero3`` + ZeRO-1 state
  and the sharded batch, with each step's grads;
- with ``TP``: two steps of ``make_sharded_lm_step(..., "zero3")`` on each
  reduced config the inputs name (``lm``), with each step's grads, and no
  batch of 6.

Inputs that hold ``tpl_lm`` (``tests/test_torch_tp_layers.py``) run
:func:`layers_run` alone: the Mamba2, Zamba2, MLA, cross-attention,
uneven-heads and MoE micro-2 steps and the greedy generations.  Inputs
that hold ``ms`` (``tests/test_torch_mesh_serving.py``) run
:func:`serving_run` alone: ``serve`` on the greedy request paths, and
reduced MoE models' ``generate`` and ``serve`` on the mesh.

Inputs that hold ``ck`` (``tests/test_torch_mesh_checkpoint.py``) run
:func:`ck_run` alone: the shard windows of the layouts the window tests
use, then the port's 2 x 2 PPO state (``state.pkl``, which the port's
launch writes; this process waits for it) saved sharded on the 2 x 2
mesh, and the port's checkpoint of that state restored onto 4 x 1 and one
device.

``OUT`` gets the results as numpy, params as trees (the reference's
structure, which ``repro_torch.models.convert`` reads).

``repro.serving.engine`` does not import on Python 3.12 (ROADMAP Queue 3,
R1: a dataclass field with an ``np.ndarray`` default).  This process loads
that one module through a loader that gives the field the same default
object by ``default_factory``; the file is read as it is, and nothing
else changes.
"""
from __future__ import annotations

import importlib.abc
import importlib.machinery
import importlib.util
import pickle
import sys
from pathlib import Path

_ENGINE = (Path(__file__).resolve().parents[1] / "src" / "repro" / "serving"
           / "engine.py")
_R1 = "new_tokens: np.ndarray = _NO_TOKENS"
_R1_FIX = ("new_tokens: np.ndarray = dataclasses.field("
           "default_factory=lambda: _NO_TOKENS)")


class _R1Loader(importlib.machinery.SourceFileLoader):
    def get_code(self, fullname):
        src = Path(self.path).read_text()
        assert src.count(_R1) == 1, "R1's line moved"
        return compile(src.replace(_R1, _R1_FIX), self.path, "exec")


class _R1Finder(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name != "repro.serving.engine":
            return None
        return importlib.util.spec_from_file_location(
            name, _ENGINE, loader=_R1Loader(name, str(_ENGINE)))


sys.meta_path.insert(0, _R1Finder())

import jax  # noqa: E402
import jax.numpy as jnp
import numpy as np

from repro import configs as jconfigs
from repro.core.hybrid_engine import HybridEngine
from repro.core.ppo import PPOConfig, PPOTrainer
from repro.launch.mesh import make_mesh
from repro.models.config import ModelConfig
from repro.models import reward as R
from repro.serving.engine import Request
from repro.sharding import strategy as S
from repro.training.steps import (lm_loss_fn, make_sharded_lm_step,
                                  reward_loss_fn, reward_train_step)
from repro.training.train_state import TrainState

ACTOR = ModelConfig(name="a", arch_type="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                    compute_dtype="float32", remat=False)
CRITIC = ACTOR.replace(name="c")
KEY = jax.random.PRNGKey(7)          # greedy: the stream draws nothing


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jnp(tree):
    return jax.tree.map(lambda a: jnp.array(a, copy=True), tree)


def ppo_run(inp, he, prompts, steps):
    actor, ref, critic, reward = (_jnp(inp[k]) for k in
                                  ("actor", "ref", "critic", "reward"))
    tr = PPOTrainer(actor_cfg=ACTOR, critic_cfg=CRITIC, actor_params=actor,
                    critic_params=critic, ref_params=ref,
                    reward_params=reward, ppo=PPOConfig(**inp["ppo_kw"]),
                    engine=he)
    exp, metrics = tr.generate_experience(jnp.asarray(prompts), KEY)
    out = {"exp": {k: np.asarray(v) for k, v in exp._asdict().items()},
           "metrics": dict(metrics), "steps": []}
    for _ in range(steps):
        out["steps"].append(tr.train_rlhf(exp))
    out.update(actor=_np(tr.actor.params), critic=_np(tr.critic.params),
               ema=_np(tr.ema))
    return out


def engine_run(inp, he):
    params = _jnp(inp["engine_params"])
    p_infer = he.to_inference(jax.device_put(params, he.train_shardings))
    kw = inp["ppo_kw"]
    e = he.generation_engine(**kw)
    o = e.generate(p_infer, jnp.asarray(inp["prompts"]), KEY)
    out = {"generate": {k: np.asarray(v) for k, v in o.items()},
           "generate_steps": e.last_stats["decode_steps"]}
    reqs = [Request(uid=i, tokens=p, max_new_tokens=kw["max_new_tokens"])
            for i, p in enumerate(inp["prompts"])]
    qcfg = ACTOR.replace(kv_quant=True)
    paged = dict(kv_layout="paged", block_size=4)
    for name, cfg, ekw, skw in (
            ("dense", ACTOR, {}, dict(slots=2)),
            ("paged_int8", qcfg, paged, dict(slots=2)),
            ("paged_int8_tight", qcfg, dict(paged, chunk=2),
             dict(slots=2, max_seq_len=16, num_blocks=7, watermark=0))):
        eng = he.generation_engine(cfg=cfg, **{**kw, **ekw})
        out[name] = {c.uid: (np.asarray(c.tokens), c.finish_reason)
                     for c in eng.serve(p_infer, reqs, KEY, **skw)}
    return out


def reward_run(inp, mesh):
    cfg = jconfigs.reduced(jconfigs.get_config("smollm-135m")).replace(
        use_pallas=False)
    state = TrainState.create(_jnp(inp["rm_params"]),
                              shardings=S.train_state_shardings(
                                  cfg, mesh, "zero3", zero=1,
                                  specs=R.param_specs(cfg)))
    step = jax.jit(lambda s, b: reward_train_step(cfg, s, b, inp["rm_lr"]))
    grad = jax.jit(jax.grad(lambda p, b: reward_loss_fn(cfg, p, b)[0]))
    metrics, grads = [], []
    for b in inp["rm_batches"]:
        b = S.shard_batch({k: jnp.asarray(v) for k, v in b.items()}, mesh)
        grads.append(_np(grad(state.params, b)))
        state, m = step(state, b)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _np(state.params), "grads": grads}


def lm_run(inp, mesh):
    """Two zero3 + ZeRO-1 steps of each reduced config in ``inp["lm"]``
    (name -> arch, params, batches), with each step's grads."""
    out = {}
    for name, (arch, params, batches) in inp["lm"].items():
        cfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
            use_pallas=False)
        step, sh, shard_batch = make_sharded_lm_step(cfg, mesh, "zero3",
                                                     zero=1)
        state = TrainState.create(_jnp(params), shardings=sh)
        grad = jax.jit(jax.grad(lambda p, b: lm_loss_fn(cfg, p, b)[0]))
        losses, gnorms, grads = [], [], []
        with mesh:
            for b in batches:
                b = shard_batch({k: jnp.asarray(v) for k, v in b.items()})
                grads.append(_np(grad(state.params, b)))
                state, m = step(state, b, inp["lm_lr"])
                losses.append(float(m["loss"]))
                gnorms.append(float(m["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": gnorms,
                     "params": _np(state.params), "grads": grads}
    return out


def _reduced(arch, over):
    return jconfigs.reduced(jconfigs.get_config(arch)).replace(
        use_pallas=False, **over)


def layers_run(inp, mesh):
    """The remaining layer kinds on the mesh: two ``make_sharded_lm_step(
    ..., "zero3")`` steps of each config of ``inp["tpl_lm"]`` (name ->
    arch, overrides, micro, params, batches), with each step's grads (the
    mean of the micro slices'), and greedy ``generate`` through the Hybrid
    Engine of each of ``inp["tpl_gen"]`` (name -> arch, overrides, params,
    encoder embeddings or None)."""
    lm, gen = {}, {}
    for name, (arch, over, micro, params, batches) in inp["tpl_lm"].items():
        cfg = _reduced(arch, over)
        step, sh, shard_batch = make_sharded_lm_step(cfg, mesh, "zero3",
                                                     zero=1, micro=micro)
        state = TrainState.create(_jnp(params), shardings=sh)
        grad = jax.jit(jax.grad(lambda p, b: lm_loss_fn(cfg, p, b)[0]))
        losses, gnorms, grads = [], [], []
        for b in batches:
            n = len(b["labels"]) // micro
            gs = [_np(grad(state.params, {k: jnp.asarray(v[i * n:(i + 1) * n])
                                          for k, v in b.items()}))
                  for i in range(micro)]
            grads.append(jax.tree.map(lambda *g: sum(g) / micro, *gs))
            state, m = step(state, shard_batch(
                {k: jnp.asarray(v) for k, v in b.items()}), inp["lm_lr"])
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        lm[name] = {"loss": losses, "grad_norm": gnorms,
                    "params": _np(state.params), "grads": grads}
    for name, (arch, over, params, enc) in inp["tpl_gen"].items():
        cfg = _reduced(arch, over)
        he = HybridEngine(cfg, mesh)
        p_infer = he.to_inference(jax.device_put(_jnp(params),
                                                 he.train_shardings))
        e = he.generation_engine(**inp["ppo_kw"])
        o = e.generate(p_infer, jnp.asarray(inp["prompts"]), KEY,
                       encoder_embeds=None if enc is None
                       else jnp.asarray(enc))
        gen[name] = {k: np.asarray(v) for k, v in o.items()}
        gen[name]["steps"] = e.last_stats["decode_steps"]
    return {"lm": lm, "gen": gen}


def _serve(eng, params, reqs, skw):
    return {c.uid: (np.asarray(c.tokens), c.finish_reason)
            for c in eng.serve(params, reqs, KEY, **skw)}


def serving_run(inp, mesh):
    """The request core on the mesh: ``serve`` of ``inp["reqs"]`` on each
    greedy path of ``inp["paths"]`` (name -> config overrides, engine and
    serve kwargs) through the Hybrid Engine on ``inp["engine_params"]``;
    and for each reduced MoE config of ``inp["moe"]`` (name -> arch,
    params, layouts) a greedy ``generate`` of ``inp["prompts"]`` and
    ``serve`` of the requests on 2 slots in each layout."""
    kw = inp["ppo_kw"]
    reqs = [Request(uid=i, tokens=t, max_new_tokens=kw["max_new_tokens"])
            for i, t in enumerate(inp["reqs"])]
    he = HybridEngine(ACTOR, mesh)
    p_infer = he.to_inference(jax.device_put(_jnp(inp["engine_params"]),
                                             he.train_shardings))
    out = {"paths": {}, "moe": {}}
    for name, (over, ekw, skw) in inp["paths"].items():
        eng = he.generation_engine(cfg=ACTOR.replace(**over), **{**kw, **ekw})
        out["paths"][name] = _serve(eng, p_infer, reqs, skw)
    for name, (arch, params, layouts) in inp["moe"].items():
        cfg = _reduced(arch, {})
        mhe = HybridEngine(cfg, mesh)
        p = mhe.to_inference(jax.device_put(_jnp(params),
                                            mhe.train_shardings))
        e = mhe.generation_engine(**kw)
        o = e.generate(p, jnp.asarray(inp["prompts"]), KEY)
        res = {"generate": {**{k: np.asarray(v) for k, v in o.items()},
                            "steps": e.last_stats["decode_steps"]}}
        for layout in layouts:
            ekw = (dict(kv_layout="paged", block_size=4)
                   if layout == "paged" else {})
            res[layout] = _serve(mhe.generation_engine(**kw, **ekw), p,
                                 reqs, {"slots": 2})
        out["moe"][name] = res
    return out


def _windows(cfg, strategy, mesh):
    """Each leaf's shard windows (``[start, stop]`` or None per dim) in
    ``addressable_shards`` order, by checkpoint key, of a TrainState of
    ``cfg`` under ``strategy`` params and ZeRO-1 moments on ``mesh``."""
    from repro.models import transformer as JT
    from repro.training import checkpoint as C
    state = jax.device_put(
        TrainState.create(JT.init_params(cfg, jax.random.PRNGKey(0))),
        S.train_state_shardings(cfg, mesh, strategy, zero=1))
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]:
        wins = []
        for sh in leaf.addressable_shards:
            wins.append([None if (sl.start in (None, 0) and sl.stop in
                                  (None, n)) else [sl.start or 0,
                                                   n if sl.stop is None
                                                   else sl.stop]
                         for sl, n in zip(sh.index, leaf.shape)])
        out[C._path_key(path)] = wins
    return out


def _wait(path, timeout=240.0):
    import os
    import time
    t0 = time.time()
    while not os.path.exists(path):
        if time.time() - t0 > timeout:
            raise TimeoutError(path)
        time.sleep(0.2)


def _ck_tree(state):
    """The port's state (numpy, by model) as the reference's trees."""
    from repro.training.optimizer import AdamState

    def ts(d):
        return TrainState(params=d["params"],
                          opt=AdamState(m=d["m"], v=d["v"],
                                        step=np.int32(d["opt_step"])),
                          step=np.int32(d["step"]))
    return {"trainer": {"actor": ts(state["actor"]),
                        "critic": ts(state["critic"]), "ema": state["ema"]},
            "rng": state["rng"]}


def _ck_shardings(mesh):
    from jax.sharding import NamedSharding, PartitionSpec as P
    a = S.train_state_shardings(ACTOR, mesh, "tp", zero=1)
    c = S.train_state_shardings(CRITIC, mesh, "tp", zero=1,
                                specs=R.param_specs(CRITIC))
    return {"trainer": {"actor": a, "critic": c, "ema": a.params},
            "rng": NamedSharding(mesh, P())}


def ck_run(inp, mesh):
    """The windows of ``inp["layouts"]`` on each of ``inp["meshes"]``; the
    port's state saved on ``mesh`` (2 x 2) under ``inp["ref_dir"]``; the
    port's checkpoint (``inp["port_dir"]``) restored onto 4 x 1 and one
    device."""
    import os
    from repro.training import checkpoint as C
    out = {"windows": {}, "restored": {}}
    for name, arch, over, strategy in inp["layouts"]:
        cfg = _reduced(arch, over)
        for dp, tp in inp["meshes"]:
            out["windows"][(name, dp, tp)] = _windows(cfg, strategy,
                                                      make_mesh(dp, tp))
    _wait(inp["state"])
    with open(inp["state"], "rb") as f:
        tree = _ck_tree(pickle.load(f))
    C.CheckpointManager(inp["ref_dir"]).save(
        1, jax.device_put(tree, _ck_shardings(mesh)), {"ppo_iter": 1},
        wait=True)
    _wait(os.path.join(inp["port_dir"], "step_00000001", "manifest.json"))
    port = C.CheckpointManager(inp["port_dir"])
    for name, m in (("4x1", make_mesh(4, 1)), ("1x1", None)):
        got, meta = port.restore(tree, shardings=None if m is None
                                 else _ck_shardings(m))
        out["restored"][name] = {"tree": {
            C._path_key(p): np.asarray(leaf) for p, leaf in
            jax.tree_util.tree_flatten_with_path(got)[0]}, "meta": meta}
    return out


def main(src: str, dst: str, dp: int, tp: int = 1) -> None:
    with open(src, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(dp, tp)
    for key, run in (("tpl_lm", layers_run), ("ms", serving_run),
                     ("ck", ck_run)):
        if key in inp:
            with open(dst, "wb") as f:
                pickle.dump(run(inp, mesh), f)
            return
    out = {"ppo": {}}
    for strategy in ("zero3", "tp"):
        he = HybridEngine(ACTOR, mesh, train_strategy=strategy, zero=1)
        out["ppo"][strategy] = ppo_run(inp, he, inp["prompts"], 2)
    if tp == 1:
        out["ppo"]["batch6"] = ppo_run(inp, HybridEngine(ACTOR, mesh),
                                       inp["prompts6"], 1)
    out["engine"] = engine_run(inp, HybridEngine(ACTOR, mesh))
    out["reward"] = reward_run(inp, mesh)
    if tp > 1:
        out["lm"] = lm_run(inp, mesh)
    with open(dst, "wb") as f:
        pickle.dump(out, f)


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2], *(int(a) for a in sys.argv[3:]))
