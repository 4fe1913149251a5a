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


def main(src: str, dst: str, dp: int, tp: int = 1) -> None:
    with open(src, "rb") as f:
        inp = pickle.load(f)
    mesh = make_mesh(dp, tp)
    for key, run in (("tpl_lm", layers_run), ("ms", serving_run)):
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
