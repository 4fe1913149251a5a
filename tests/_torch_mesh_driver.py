"""One rank of the port's data- and tensor-parallel checks, on gloo over
the CPU.

Launched by ``tests/test_torch_multidevice.py``,
``tests/test_torch_hybrid_engine.py``, ``tests/test_torch_tensor_parallel.py``,
``tests/test_torch_tp_layers.py``, ``tests/test_torch_mesh_serving.py`` and
``tests/test_torch_mesh_checkpoint.py`` as::

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/_torch_mesh_driver.py --out DIR --cases ppo,lm,... \\
        [--mesh DP,TP]

Every rank builds the same weights from fixed seeds, runs the named cases
on meshes over the first ranks, and rank 0 writes each case's results
(full tensors, gathered) to ``DIR/<case>.pt``.  The ``tp_*``, ``tpl_*``,
``ms_*`` and ``ck_*`` cases run on the ``--mesh`` given (``DP x TP`` over
the first ranks; the ``ck_*`` cases' checkpoints under ``--ck``).  The
tests hold them to the single-rank port and the reference.  Every process
group
times out after 60 s, so a failing rank fails the run instead of hanging
it.
"""
from __future__ import annotations

import argparse
import contextlib
import os
import sys
import time
import traceback

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config, reduced
from repro_torch.core.hybrid_engine import HybridEngine
from repro_torch.core.pipeline import StageConfig, clone_params
from repro_torch.core.ppo import PPOConfig, PPOTrainer
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import init_distributed, make_mesh
from repro_torch.models import reward as R
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_leaves
from repro_torch.serving.engine import (GenerationEngine, Request,
                                        SamplingParams)
from repro_torch.sharding import runtime
from repro_torch.sharding import strategy as S
from repro_torch.training.steps import lm_train_step, make_sharded_lm_step
from repro_torch.training.train_state import TrainState

V = 64
ACTOR = ModelConfig(name="a", arch_type="dense", n_layers=2, d_model=64,
                    n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=V,
                    compute_dtype="float32", remat=False,
                    use_kernels=False)        # head_dim 16: plain code
CRITIC = ACTOR.replace(name="c")
PROMPTS = np.random.RandomState(9).randint(0, V, size=(4, 6))
PROMPTS6 = np.random.RandomState(10).randint(0, V, size=(6, 6))
PPO_KW = dict(max_new_tokens=8, temperature=0.0, eos_id=3)
RESHARD_MESHES = ((1, 1), (2, 1), (4, 1), (2, 2), (1, 2))
LM_KW = dict(steps=3, batch=8, seq=16, lr=3e-3, seed=0)


def _gen(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(seed)


def models():
    """Actor, ref (a clone), critic and reward params, from fixed seeds."""
    actor = T.init_params(ACTOR, _gen(0))
    return (actor, clone_params(actor), R.init_params(CRITIC, _gen(1)),
            R.init_params(CRITIC, _gen(2)))


def lm_config(arch: str):
    """The reduced config the parity tests use (plain code)."""
    return reduced(get_config(arch)).replace(use_kernels=False)


def trainer(engine):
    """The PPO trainer over :func:`models`, greedy, with ``engine``."""
    actor, ref, critic, reward = models()
    return PPOTrainer(actor_cfg=ACTOR, critic_cfg=CRITIC, actor_params=actor,
                      critic_params=critic, ref_params=ref,
                      reward_params=reward, ppo=PPOConfig(**PPO_KW),
                      engine=engine)


def _np(x):
    """The full tensor as a numpy copy (a replicated leaf's local tensor is
    the live one, which a later step updates in place)."""
    return runtime.full(x).detach().cpu().numpy().copy()


def _tree_np(tree):
    return [_np(t) for t in tree_leaves(tree)]


def ppo_run(tr, prompts, steps: int = 2) -> dict:
    exp, metrics = tr.generate_experience(prompts, _gen(7))
    out = {"exp": {k: _np(v) for k, v in exp._asdict().items()},
           "metrics": metrics, "steps": []}
    for _ in range(steps):
        out["steps"].append(tr.train_rlhf(exp))
    out["actor"] = _tree_np(tr.actor.params)
    out["critic"] = _tree_np(tr.critic.params)
    out["ema"] = _tree_np(tr.ema)
    return out


# --------------------------------------------------------------------- #
# cases: each returns what rank 0 writes
# --------------------------------------------------------------------- #
def case_reshard(world: int) -> dict:
    """Roundtrip and measured stats on every mesh the world holds."""
    out = {}
    for dp, tp in RESHARD_MESHES:
        if dp * tp > world:
            continue
        mesh = make_mesh(dp, tp)
        if mesh.get_coordinate() is None:
            continue
        he = HybridEngine(ACTOR, mesh)
        params = T.init_params(ACTOR, _gen(2))
        p_train = runtime.place_tree(params, he.train_shardings)
        p_infer = he.to_inference(p_train)
        s_in = dict(he.last_reshard_stats)
        p_back = he.to_train(p_infer)
        s_back = dict(he.last_reshard_stats)
        exact = all(torch.equal(runtime.full(a), b) and torch.equal(
            runtime.full(c), b) for a, c, b in zip(
                tree_leaves(p_back), tree_leaves(p_infer),
                tree_leaves(params)))
        same_layout = all(
            tuple(a.placements) == tuple(b.placements)
            for a, b in zip(tree_leaves(p_back), tree_leaves(p_train)))
        out[(dp, tp)] = {"to_inference": s_in, "to_train": s_back,
                         "exact": exact, "same_layout": same_layout,
                         "reshard_bytes_per_phase":
                             he.reshard_bytes_per_phase(),
                         "param_bytes": he.param_bytes()}
    return out


def case_ppo(dp: int) -> dict:
    """Sharded PPO (zero3, and tp + ZeRO-1) at dp x 1, two steps."""
    mesh = make_mesh(dp, 1)
    out = {}
    for strategy in ("zero3", "tp"):
        tr = trainer(HybridEngine(ACTOR, mesh, train_strategy=strategy,
                                  zero=1))
        out[strategy] = ppo_run(tr, PROMPTS)
    # a batch of 6 at this dp: replicated when it does not divide
    tr = trainer(HybridEngine(ACTOR, mesh))
    out["batch6"] = ppo_run(tr, PROMPTS6, steps=1)
    # the local shard shapes of the committed train states
    shapes = {}
    for strategy in ("zero3", "tp"):
        he = HybridEngine(ACTOR, mesh, train_strategy=strategy, zero=1)
        st = TrainState.create(models()[0],
                               shardings=he.train_state_shardings())
        shapes[strategy] = {
            "params": [tuple(runtime.local(t).shape)
                       for t in tree_leaves(st.params)],
            "m": [tuple(runtime.local(t).shape)
                  for t in tree_leaves(st.opt.m)]}
    out["shapes"] = shapes
    return out


def case_engine(dp: int) -> dict:
    """The engine under the mesh: greedy generate, the dense and the
    paged int8 request paths, a tight paged int8 pool."""
    return engine_paths(make_mesh(dp, 1))


# (arch, strategy, micro, steps): "zero3-gather" is zero3 with the
# reference's gather / grad pspecs (the tp layout gathered once a step,
# the grads reduced into the zero3 param layout)
LM_CASES = (("smollm-135m", "zero3", 2, 3), ("smollm-135m", "ddp", 2, 1),
            ("smollm-135m", "zero3-gather", 2, 1),
            ("mamba2-370m", "zero3", 1, 1))


def case_lm(dp: int) -> dict:
    """make_sharded_lm_step at micro 2 (zero3 + ZeRO-1, ddp, and zero3
    with gather / grad pspecs) through the launcher's loop, and a reduced
    Mamba2 step."""
    mesh = make_mesh(dp, 1)
    out = {}
    for arch, strategy, micro, steps in LM_CASES:
        cfg = lm_config(arch)
        params = T.init_params(cfg, _gen(5))
        gather = strategy.endswith("-gather")
        step, sh, shard_batch = make_sharded_lm_step(
            cfg, mesh, strategy.removesuffix("-gather"), zero=1, micro=micro)
        if gather:
            gp = S.param_pspecs(cfg, mesh, "tp")
            grp = S.param_pspecs(cfg, mesh, "zero3")
            step = lambda s, b, lr: lm_train_step(
                cfg, s, b, lr, micro=micro, gather_pspecs=gp,
                grad_pspecs=grp)
        state = TrainState.create(params, shardings=sh)
        state, summ = tlaunch.train_lm(
            cfg, state, device="cpu", micro=micro,
            step_fn=lambda s, b, lr: step(s, shard_batch(b), lr),
            **{**LM_KW, "steps": steps})
        out[(arch, strategy)] = {
            "loss": summ["loss"], "grad_norm": summ["grad_norm"],
            "params": _tree_np(state.params), "m": _tree_np(state.opt.m),
            "v": _tree_np(state.opt.v)}
    return out


# the embedding-input and cross-attention configs: their SFT batches carry
# frame embeddings (the audio decoder) or encoder embeddings (the VLM)
EMBED_ARCHS = ("musicgen-medium", "llama-3.2-vision-11b")


def embed_batches(cfg, n: int) -> list:
    """``n`` SFT batches of 8 rows of 16 tokens of the blend, the same on
    every rank: the tokens through a fixed table for the audio decoder,
    and encoder embeddings beside them for the VLM."""
    g = _gen(9)
    table = torch.randn((256, cfg.d_model), generator=g)
    out = []
    for b in tlaunch.lm_data(cfg, 16, 0).sft_batches(8, n):
        b = {k: torch.as_tensor(v) for k, v in b.items()}
        if not cfg.embed_inputs:
            b["embeds"] = table[b.pop("tokens").long()]
        if cfg.arch_type == "vlm":
            b["encoder_embeds"] = torch.randn(
                (8, cfg.encoder_len, cfg.encoder_dim), generator=g)
        out.append(b)
    return out


def embed_params(cfg):
    """Params from a fixed seed, cross-attention gates at 0.7 (at their init
    of 0 the encoder would reach no output)."""
    params = T.init_params(cfg, _gen(5))
    for seg in params["segments"]:
        for lp in seg:
            if "xattn" in lp:
                lp["xattn"]["gate"].fill_(0.7)
    return params


def embed_run(cfg, state, step, steps: int = 2) -> dict:
    """``steps`` LM steps of ``step`` on :func:`embed_batches`."""
    losses = []
    for b in embed_batches(cfg, steps):
        state, m = step(state, b, 3e-3)
        losses.append(float(m["loss"]))
    return {"loss": losses, "params": _tree_np(state.params)}


def case_embeds(dp: int) -> dict:
    """make_sharded_lm_step (zero3 + ZeRO-1) on batches of frame or encoder
    embeddings, sharded over ``data``."""
    mesh = make_mesh(dp, 1)
    out = {}
    for arch in EMBED_ARCHS:
        cfg = lm_config(arch)
        step, sh, shard_batch = make_sharded_lm_step(cfg, mesh, "zero3",
                                                     zero=1)
        state = TrainState.create(embed_params(cfg), shardings=sh)
        out[arch] = embed_run(cfg, state,
                              lambda s, b, lr: step(s, shard_batch(b), lr))
    return out


def reward_run(mesh=None, steps: int = 2) -> dict:
    """``reward_train_step`` at the reduced smollm-135m on 8 pairs of the
    synthetic blend (``zero3`` + ZeRO-1 on ``mesh``; plain without), at
    the pipeline's reward LR (``StageConfig.rm_lr``): Adam turns an ulp of
    a grad whose second moment is near 0 into up to an LR-sized step, so
    the params' agreement scales with the LR."""
    from repro_torch import to_device
    from repro_torch.training.steps import reward_train_step
    cfg = lm_config("smollm-135m")
    params = R.init_params(cfg, _gen(6))
    if mesh is None:
        state, put = TrainState.create(params), (lambda b: b)
    else:
        state = TrainState.create(params, shardings=S.train_state_shardings(
            cfg, mesh, "zero3", zero=1, specs=R.param_specs(cfg)))
        put = lambda b: S.shard_batch(b, mesh)
    metrics = []
    for b in tlaunch.lm_data(cfg, 16, 0).reward_batches(8, steps):
        state, m = reward_train_step(cfg, state, put(to_device(b, "cpu")),
                                     StageConfig.rm_lr)
        metrics.append({k: float(v) for k, v in m.items()})
    return {"metrics": metrics, "params": _tree_np(state.params)}


def case_reward(dp: int) -> dict:
    return reward_run(make_mesh(dp, 1))


def case_refusals(world: int) -> dict:
    """What a mesh still refuses, as the exception each raises (``None``:
    accepted): MLA, SSM and cross-attention layers on ``model = 2`` are
    accepted, and so is the request core on a ``world x 1`` mesh (its
    ``stats()`` after draining :func:`ms_requests` on 4 slots are kept)."""
    out = {}

    def grab(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:                      # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"

    mesh = make_mesh(world // 2, 2)                 # model = 2
    grab("mla_tp2", lambda: make_sharded_lm_step(
        lm_config("deepseek-v2-lite-16b"), mesh, "zero3"))
    grab("ssm_tp2", lambda: make_sharded_lm_step(
        lm_config("mamba2-370m"), mesh, "zero3"))
    grab("xattn_tp2", lambda: make_sharded_lm_step(
        lm_config("llama-3.2-vision-11b"), mesh, "zero3"))
    dmesh = make_mesh(world, 1)

    def core_drain():
        core = GenerationEngine(ACTOR, mesh=dmesh, device="cpu",
                                **PPO_KW).core(models()[0], _gen(0), slots=4,
                                               max_seq_len=16)
        for r in ms_requests():
            core.add_request(r)
        while core.has_work():
            core.step()
        out["core_stats"] = core.stats()
    grab("core", core_drain)
    # a rollout mesh needs the training mesh's engine beside it, and the
    # two must be make_disaggregated_meshes' disjoint pair
    trainer = lambda **kw: PPOTrainer(
        actor_cfg=ACTOR, critic_cfg=CRITIC, actor_params=models()[0],
        critic_params=models()[2], ref_params=models()[1],
        reward_params=models()[3], ppo=PPOConfig(**PPO_KW),
        rollout_mesh=dmesh, **kw)
    grab("rollout_mesh", trainer)
    grab("rollout_mesh_shared",
         lambda: trainer(engine=HybridEngine(ACTOR, dmesh)))
    return out


# --------------------------------------------------------------------- #
# tensor-parallel cases, on the ``--mesh dp,tp`` mesh
# --------------------------------------------------------------------- #
# (name, arch, config overrides, strategy): the reduced configs, two LM
# steps each; "mask" trains under a trainable_mask
TP_LM_CASES = (("qwen3", "qwen3-8b", {}, "zero3"),
               ("qwen3_tp", "qwen3-8b", {}, "tp"),
               ("tied", "smollm-135m", {"tie_embeddings": True}, "zero3"),
               ("vocab511", "smollm-135m", {"vocab_size": 511}, "zero3"),
               ("remat", "smollm-135m", {"remat": True, "logit_chunk": 8},
                "zero3"),
               ("moe", "llama4-scout-17b-a16e", {}, "zero3"),
               ("mask", "smollm-135m", {}, "zero3"))
TP_LR = 1e-3
SAMPLED = dict(max_new_tokens=8, temperature=0.8, eos_id=3)


def tp_lm_config(arch: str, over: dict):
    return lm_config(arch).replace(**over)


def tp_lm_batches(cfg, steps: int = 2) -> list:
    """``steps`` SFT batches of 8 rows of 16 tokens of the blend."""
    return [{k: torch.as_tensor(v) for k, v in b.items()}
            for b in tlaunch.lm_data(cfg, 16, 0).sft_batches(8, steps)]


def tp_mask(params):
    """A trainable_mask: the embedding frozen, the first layer's ``wq``
    trained on its even columns only, the rest trained."""
    mask = tree_map_like(params, True)
    mask["embed"] = False
    wq = params["segments"][0][0]["attn"]["wq"]
    cols = torch.zeros(wq.shape, dtype=torch.bool)
    cols[..., ::2] = True
    mask["segments"][0][0]["attn"]["wq"] = cols
    return mask


def tree_map_like(tree, value):
    from repro_torch.models.modules import tree_map
    return tree_map(lambda _: value, tree)


def tp_lm_run(cfg, state, step, mask=None) -> dict:
    """Two LM steps of ``step`` at :data:`TP_LR` on :func:`tp_lm_batches`."""
    losses, gnorms = [], []
    for b in tp_lm_batches(cfg):
        state, m = step(state, b, TP_LR, mask)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return {"loss": losses, "grad_norm": gnorms,
            "params": _tree_np(state.params)}


def case_tp_lm(dp: int, tp: int) -> dict:
    """make_sharded_lm_step's layouts (zero3 + ZeRO-1, tp + ZeRO-1) at
    ``dp x tp`` on the reduced configs of :data:`TP_LM_CASES`."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    out = {}
    for name, arch, over, strategy in TP_LM_CASES:
        cfg = tp_lm_config(arch, over)
        _, sh, shard_batch = make_sharded_lm_step(cfg, mesh, strategy,
                                                  zero=1)
        params = T.init_params(cfg, _gen(5))
        mask = tp_mask(params) if name == "mask" else None
        state = TrainState.create(params, shardings=sh)
        out[name] = tp_lm_run(cfg, state, lambda s, b, lr, m: lm_train_step(
            cfg, s, shard_batch(b), lr, trainable_mask=m), mask)
    return out


def case_tp_ppo(dp: int, tp: int) -> dict:
    """PPO through the Hybrid Engine (zero3, and tp + ZeRO-1) at
    ``dp x tp``, two steps."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    return {strategy: ppo_run(trainer(HybridEngine(
        ACTOR, mesh, train_strategy=strategy, zero=1)), PROMPTS)
        for strategy in ("zero3", "tp")}


def case_tp_engine(dp: int, tp: int) -> dict:
    """The engine's four paths at ``dp x tp`` (:func:`case_engine`'s), a
    sampled generate whose every rank's tokens come back (the ranks of a
    model group must agree), and the rank's KV arena."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    out = engine_paths(mesh)
    he = HybridEngine(ACTOR, mesh)
    params = T.init_params(ACTOR, _gen(1))
    p_infer = he.to_inference(runtime.place_tree(params, he.train_shardings))
    eng = he.generation_engine(device="cpu", **SAMPLED)
    seqs = eng.generate(p_infer, torch.as_tensor(PROMPTS), _gen(11))
    got = [None] * dist.get_world_size()      # a launch of dp * tp ranks
    dist.all_gather_object(got, seqs["sequences"].numpy())
    out["sampled"] = got
    view, _ = eng._view(p_infer)
    lc = T.local_cfg(ACTOR, view)
    out["kv_arena"] = {k: tuple(v[0]) for k, v in T.cache_struct(
        lc, 2, 16)[0][0].items()}
    return out


def engine_paths(mesh) -> dict:
    """Greedy generate, the dense and the paged int8 request paths and a
    tight paged int8 pool, through the Hybrid Engine on ``mesh``."""
    he = HybridEngine(ACTOR, mesh)
    params = T.init_params(ACTOR, _gen(1))
    p_infer = he.to_inference(runtime.place_tree(params, he.train_shardings))
    out = {}
    e1 = he.generation_engine(device="cpu", **PPO_KW)
    o = e1.generate(p_infer, torch.as_tensor(PROMPTS), _gen(7))
    out["generate"] = {k: v.numpy() for k, v in o.items()}
    out["generate_steps"] = e1.last_stats["decode_steps"]
    reqs = [Request(uid=i, tokens=PROMPTS[i], max_new_tokens=8)
            for i in range(len(PROMPTS))]
    qcfg = ACTOR.replace(kv_quant=True)
    paged = dict(kv_layout="paged", block_size=4)
    for name, cfg, kw, skw in (
            ("dense", ACTOR, {}, dict(slots=2)),
            ("paged_int8", qcfg, paged, dict(slots=2)),
            ("paged_int8_tight", qcfg, dict(paged, chunk=2),
             dict(slots=2, max_seq_len=16, num_blocks=7, watermark=0))):
        eng = he.generation_engine(cfg=cfg, device="cpu",
                                   **{**PPO_KW, **kw})
        comps = eng.serve(p_infer, reqs, _gen(7), **skw)
        out[name] = {c.uid: (c.tokens, c.finish_reason) for c in comps}
    return out


def case_tp_reward(dp: int, tp: int) -> dict:
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    return reward_run(mesh)


def case_tp_layout(dp: int, tp: int) -> dict:
    """This rank's bytes at rest (the train state's params in the ``tp``
    and ``zero3`` layouts) and while computing (the compute view), and the
    gathers over ``model`` that taking the view makes."""
    from torch.distributed.tensor import Replicate
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    from repro_torch.training.steps import mesh_view
    out = {}
    gathers = []
    real = runtime.redistribute
    mi = mesh.mesh_dim_names.index("model")

    def spy(x, placements):
        if (x.placements[mi].is_shard() and mesh.size(mi) > 1
                and isinstance(placements[mi], Replicate)):
            gathers.append(tuple(x.shape))
        return real(x, placements)
    for strategy in ("tp", "zero3"):
        he = HybridEngine(ACTOR, mesh, train_strategy=strategy, zero=1)
        st = TrainState.create(models()[0],
                               shardings=he.train_state_shardings())
        runtime.redistribute = spy
        try:
            del gathers[:]
            view, _, _ = mesh_view(ACTOR, st.params)
        finally:
            runtime.redistribute = real
        out[strategy] = {
            "rest_bytes": runtime.local_bytes(st.params),
            "view_bytes": runtime.local_bytes(view),
            "model_gathers": list(gathers),
            "params": [tuple(runtime.local(t).shape)
                       for t in tree_leaves(st.params)],
            "m": [tuple(runtime.local(t).shape)
                  for t in tree_leaves(st.opt.m)]}
    return out


def case_tp_refusals(dp: int, tp: int) -> dict:
    """What ``model > 1`` still refuses, as the exception each raises
    (``None``: accepted).  At ``dp > 1`` an MoE model's greedy decode over
    the data rank's rows runs (its MoE layers route the data group's rows
    together) and its sequences are kept."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    out = {}

    def grab(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:                      # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"
    if dp > 1:          # an MoE decode over the data rank's rows
        moe = lm_config("llama4-scout-17b-a16e")
        grab("engine_moe_rows", lambda: out.__setitem__(
            "moe_sequences", GenerationEngine(
                moe, mesh=mesh, device="cpu", **PPO_KW).generate(
                    T.init_params(moe, _gen(0)), torch.as_tensor(PROMPTS),
                    _gen(0))["sequences"].numpy()))
    return out


# --------------------------------------------------------------------- #
# the remaining layer kinds on ``model > 1``: Mamba2 / Zamba2, MLA,
# cross-attention, heads that do not split whole, MoE at micro 2
# --------------------------------------------------------------------- #
# (name, arch, config overrides): each reduced config trains under zero3
# and under tp (``<name>_tp``); "heads9" has 9 heads and 3 kv heads, which
# no model axis of 2 or 4 splits whole
TPL_ARCHS = (("mamba2", "mamba2-370m", {}), ("zamba2", "zamba2-1.2b", {}),
             ("mla", "deepseek-v2-lite-16b", {}),
             ("vision", "llama-3.2-vision-11b", {}),
             ("heads9", "smollm-135m", {"n_heads": 9, "n_kv_heads": 3}))
# (name, arch, config overrides, strategy, micro)
TPL_LM_CASES = tuple(
    (name + sfx, arch, over, strategy, 1)
    for name, arch, over in TPL_ARCHS
    for sfx, strategy in (("", "zero3"), ("_tp", "tp"))) + (
    ("moe_micro2", "llama4-scout-17b-a16e", {}, "zero3", 2),)
# (name, arch, config overrides): greedy generate through the Hybrid
# Engine (MLA's MoE layers route the data group's rows together at 2 x 2)
TPL_GEN_CASES = (("mamba2", "mamba2-370m", {}), ("zamba2", "zamba2-1.2b", {}),
                 ("zamba2_int8", "zamba2-1.2b", {"kv_quant": True}),
                 ("mla", "deepseek-v2-lite-16b", {}),
                 ("vision", "llama-3.2-vision-11b", {}))


def tpl_config(arch: str, over: dict):
    return lm_config(arch).replace(**over)


def tpl_batches(cfg) -> list:
    """Two SFT batches of 8 rows of 16 tokens (with encoder embeddings
    for the VLM)."""
    return (embed_batches(cfg, 2) if cfg.arch_type == "vlm"
            else tp_lm_batches(cfg))


def tpl_encoder(cfg, n: int = 4):
    """Encoder embeddings for ``n`` prompts of a VLM (``None`` else)."""
    if cfg.arch_type != "vlm":
        return None
    return torch.randn((n, cfg.encoder_len, cfg.encoder_dim),
                       generator=_gen(12))


def tpl_gen_params(cfg):
    """Greedy-generation params (cross-attention gates at 0.7)."""
    params = T.init_params(cfg, _gen(1))
    for seg in params["segments"]:
        for lp in seg:
            if "xattn" in lp:
                lp["xattn"]["gate"].fill_(0.7)
    return params


def case_tpl_lm(dp: int, tp: int) -> dict:
    """make_sharded_lm_step (zero3 + ZeRO-1 and tp + ZeRO-1) at ``dp x tp``
    on the reduced configs of :data:`TPL_LM_CASES`, two steps each."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    out = {}
    for name, arch, over, strategy, micro in TPL_LM_CASES:
        cfg = tpl_config(arch, over)
        step, sh, shard_batch = make_sharded_lm_step(cfg, mesh, strategy,
                                                     zero=1, micro=micro)
        state = TrainState.create(embed_params(cfg), shardings=sh)
        losses, gnorms = [], []
        for b in tpl_batches(cfg):
            state, m = step(state, shard_batch(b), TP_LR)
            losses.append(float(m["loss"]))
            gnorms.append(float(m["grad_norm"]))
        out[name] = {"loss": losses, "grad_norm": gnorms,
                     "params": _tree_np(state.params)}
    return out


def tpl_generate(eng, cfg, params) -> dict:
    o = eng.generate(params, torch.as_tensor(PROMPTS), _gen(7),
                     encoder_embeds=tpl_encoder(cfg))
    return {**{k: v.numpy() for k, v in o.items()},
            "steps": eng.last_stats["decode_steps"]}


def case_tpl_engine(dp: int, tp: int) -> dict:
    """Greedy generate at ``dp x tp`` through the Hybrid Engine for
    :data:`TPL_GEN_CASES`, and the rank's cache shapes."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    out = {}
    for name, arch, over in TPL_GEN_CASES:
        cfg = tpl_config(arch, over)
        he = HybridEngine(cfg, mesh)
        p_infer = he.to_inference(runtime.place_tree(
            tpl_gen_params(cfg), he.train_shardings))
        eng = he.generation_engine(device="cpu", **PPO_KW)
        out[name] = tpl_generate(eng, cfg, p_infer)
        view, _ = eng._view(p_infer)
        out[name]["cache"] = [
            {k: tuple(v[0]) for k, v in unit.items()}
            for seg in T.cache_struct(T.local_cfg(cfg, view), 2, 16)
            for unit in seg]
    return out


def tpl_trainer(cfg, engine):
    """The greedy PPO trainer of a reduced ``cfg`` actor and critic."""
    actor = T.init_params(cfg, _gen(0))
    return PPOTrainer(actor_cfg=cfg, critic_cfg=cfg, actor_params=actor,
                      critic_params=R.init_params(cfg, _gen(1)),
                      ref_params=clone_params(actor),
                      reward_params=R.init_params(cfg, _gen(2)),
                      ppo=PPOConfig(**PPO_KW), engine=engine)


def case_tpl_ppo(dp: int, tp: int) -> dict:
    """One ``train_rlhf`` step of PPO through the Hybrid Engine (zero3 +
    ZeRO-1) with a reduced Zamba2 actor and critic."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    cfg = lm_config("zamba2-1.2b")
    return ppo_run(tpl_trainer(cfg, HybridEngine(
        cfg, mesh, train_strategy="zero3", zero=1)), PROMPTS, steps=1)


def case_tpl_layout(dp: int, tp: int) -> dict:
    """Reduced Mamba2 in the ``tp`` layout: this rank's bytes at rest, and
    the shapes of its compute view's mixer leaves."""
    mesh = make_mesh(dp, tp)
    if mesh.get_coordinate() is None:
        return {}
    from repro_torch.training.steps import mesh_view
    cfg = lm_config("mamba2-370m")
    st = TrainState.create(T.init_params(cfg, _gen(0)),
                           shardings=S.train_state_shardings(cfg, mesh, "tp",
                                                             zero=1))
    view, _, _ = mesh_view(cfg, st.params)
    ssm = view["segments"][0][0]["ssm"]
    return {"rest_bytes": runtime.local_bytes(st.params),
            "view": {k: tuple(v.shape) for k, v in ssm.items()}}


# --------------------------------------------------------------------- #
# the request core on a mesh: serve and core() over slots split on data,
# and MoE generation that routes the data group's rows together
# --------------------------------------------------------------------- #
PAGED = dict(kv_layout="paged", block_size=4)
SAMPLED_KW = dict(temperature=0.8, top_k=40)
# (name, config overrides, engine kwargs, serve kwargs): a 2-slot dense
# arena (its slots split over data at dp 2), a 4-slot one, the paged int8
# pool, a paged int8 pool tight enough to preempt, and sampled runs with
# one seeded request (dense and paged)
MS_PATHS = (("dense", {}, {}, dict(slots=2)),
            ("dense4", {}, {}, dict(slots=4)),
            ("paged_int8", {"kv_quant": True}, PAGED, dict(slots=2)),
            ("paged_int8_tight", {"kv_quant": True}, dict(PAGED, chunk=2),
             dict(slots=2, max_seq_len=16, num_blocks=7, watermark=0)),
            ("sampled", {}, SAMPLED_KW, dict(slots=2)),
            ("sampled_paged", {}, dict(PAGED, **SAMPLED_KW), dict(slots=2)))
MS_LENS = (3, 7, 5, 6, 4, 8)
# (name, arch, layouts): reduced MoE configs served over data
MS_MOE = (("scout", "llama4-scout-17b-a16e", ("dense", "paged")),
          ("deepseek", "deepseek-v2-lite-16b", ("dense",)))


def ms_requests(seeded: bool = False) -> list:
    """Six ragged requests of up to 8 new tokens (request 2 with a seed
    of its own when ``seeded``)."""
    rng = np.random.RandomState(13)
    return [Request(uid=i, tokens=rng.randint(0, V, size=n),
                    max_new_tokens=8,
                    params=SamplingParams(seed=5 if seeded and i == 2
                                          else None))
            for i, n in enumerate(MS_LENS)]


def _engine_maker(cfg, params, mesh):
    """``(params to serve, engine(**kw))``: through the Hybrid Engine's
    inference layout on ``mesh``, the plain params and engine without."""
    if mesh is None:
        return params, lambda c=cfg, **kw: GenerationEngine(
            c, device="cpu", **kw)
    he = HybridEngine(cfg, mesh)
    p = he.to_inference(runtime.place_tree(params, he.train_shardings))
    return p, lambda c=cfg, **kw: he.generation_engine(cfg=c, device="cpu",
                                                       **kw)


def _drain(eng, params, reqs, skw) -> dict:
    """``serve`` and ``core()`` (driven by the serve launcher's drain loop)
    on the same requests: completions by uid and ``last_stats`` /
    ``stats()``."""
    from repro_torch.launch.serve import run_schedule
    comps = eng.serve(params, reqs, _gen(7), **skw)
    out = {"serve": {c.uid: (c.tokens, c.finish_reason) for c in comps},
           "serve_stats": dict(eng.last_stats)}
    S = skw.get("max_seq_len") or max(len(r.tokens) + r.max_new_tokens
                                      for r in reqs)
    _, st, _, fin = run_schedule(eng, params, reqs, _gen(7),
                                 mode="continuous", max_seq_len=S,
                                 **{k: v for k, v in skw.items()
                                    if k != "max_seq_len"})
    out.update(core={u: np.asarray(t, np.int32) for u, t in fin.items()},
               core_stats=st)
    return out


def ms_serve(mesh=None) -> dict:
    """:data:`MS_PATHS` through ``serve`` and ``core()`` on ``mesh`` (one
    rank without), on ``engine_paths``' weights."""
    params, make = _engine_maker(ACTOR, T.init_params(ACTOR, _gen(1)), mesh)
    out = {}
    for name, over, kw, skw in MS_PATHS:
        eng = make(ACTOR.replace(**over), **{**PPO_KW, **kw})
        out[name] = _drain(eng, params, ms_requests(name.startswith(
            "sampled")), skw)
    return out


@contextlib.contextmanager
def routed_rows(log: list):
    """Each MoE layer's router probabilities ``(T, E)`` in call order: the
    rows the layer routes together (R13)."""
    from repro_torch.models import modules as M
    real = M.moe_route

    def spy(cfg, probs):
        log.append(probs.detach().clone())
        return real(cfg, probs)
    M.moe_route = spy
    try:
        yield log
    finally:
        M.moe_route = real


def ms_moe(mesh=None) -> dict:
    """:data:`MS_MOE`: greedy ``generate`` of :data:`PROMPTS` and the six
    requests through ``serve`` and ``core()`` on 2 slots, with the rows
    each MoE call routed."""
    out = {}
    for name, arch, layouts in MS_MOE:
        cfg = lm_config(arch)
        params, make = _engine_maker(cfg, T.init_params(cfg, _gen(1)), mesh)
        res = {}
        with routed_rows([]) as log:
            eng = make(**PPO_KW)
            o = eng.generate(params, torch.as_tensor(PROMPTS), _gen(7))
            res["generate"] = {**{k: v.numpy() for k, v in o.items()},
                               "steps": eng.last_stats["decode_steps"],
                               "routes": list(log)}
            for layout in layouts:
                del log[:]
                eng = make(**PPO_KW, **(PAGED if layout == "paged" else {}))
                res[layout] = _drain(eng, params, ms_requests(), {"slots": 2})
                res[layout]["routes"] = list(log)
        out[name] = res
    return out


def ms_ppo_moe(mesh=None) -> dict:
    """One stage-3 experience (greedy, zero3 + ZeRO-1 on ``mesh``) with a
    reduced llama4-scout actor and critic."""
    cfg = lm_config("llama4-scout-17b-a16e")
    he = None if mesh is None else HybridEngine(cfg, mesh,
                                                train_strategy="zero3",
                                                zero=1)
    return ppo_run(tpl_trainer(cfg, he), PROMPTS, steps=0)


def case_ms_engine(dp: int, tp: int) -> dict:
    mesh = make_mesh(dp, tp)
    return {} if mesh.get_coordinate() is None else ms_serve(mesh)


def case_ms_moe(dp: int, tp: int) -> dict:
    mesh = make_mesh(dp, tp)
    return {} if mesh.get_coordinate() is None else ms_moe(mesh)


def case_ms_ppo(dp: int, tp: int) -> dict:
    mesh = make_mesh(dp, tp)
    return {} if mesh.get_coordinate() is None else ms_ppo_moe(mesh)


# --------------------------------------------------------------------- #
# sharded checkpoints, on the ``--mesh dp,tp`` mesh; checkpoints under
# ``--ck`` (shared by the launches and the reference's ``ck`` run)
# --------------------------------------------------------------------- #
# the layouts the window tests hold to ``chunk`` and to the reference's
# shards: (name, arch, config overrides, strategy), ZeRO-1 moments
CK_LAYOUTS = (("zero3", "smollm-135m", {}, "zero3"),
              ("tp_zero1", "smollm-135m", {}, "tp"),
              ("heads9", "smollm-135m", {"n_heads": 9, "n_kv_heads": 3},
               "zero3"),
              ("mamba2", "mamba2-370m", {}, "zero3"))
CK = {"dir": None}                 # --ck: the checkpoints' root
CK_WAIT_S = 240.0                  # for a checkpoint another process makes
# ck_slow: rank 1's writes held up CK_SLOW_S, past the writers' base wait
# (cut to CK_SLOW_BASE_S), within the wait its share's bytes give at the
# floor rate (cut to CK_SLOW_FLOOR_BPS: tens of seconds for these params)
CK_SLOW_S, CK_SLOW_BASE_S, CK_SLOW_FLOOR_BPS = 8.0, 4.0, 4096
NOT_METRICS = ("actor_ms", "critic_ms")


def ck_trainer(mesh):
    """:func:`trainer` with ``tp`` params and ZeRO-1 moments on ``mesh``
    (plain without): the reference test's trainer."""
    return trainer(None if mesh is None else HybridEngine(
        ACTOR, mesh, train_strategy="tp", zero=1))


def ck_shardings(mesh):
    """:func:`ck_trainer`'s state layouts on ``mesh`` (at any size, 1 x 1
    included) for a ``{"trainer", "rng"}`` tree; ``None`` without."""
    if mesh is None:
        return None
    a = S.train_state_shardings(ACTOR, mesh, "tp", zero=1)
    c = S.train_state_shardings(CRITIC, mesh, "tp", zero=1,
                                specs=R.param_specs(CRITIC))
    return {"trainer": {"actor": a, "critic": c, "ema": a.params},
            "rng": None}


def ck_like():
    """The ``{"trainer", "rng"}`` restore target (structure only)."""
    from repro_torch.training import checkpoint
    return {"trainer": checkpoint.like(trainer(None).state_tree()),
            "rng": _gen(7).get_state()}


def ck_wait(step_dir: str) -> str:
    """``step_dir`` once its checkpoint has committed (another process
    writes it)."""
    t0 = time.time()
    while not os.path.exists(os.path.join(step_dir, "manifest.json")):
        if time.time() - t0 > CK_WAIT_S:
            raise TimeoutError(f"no checkpoint at {step_dir}")
        time.sleep(0.2)
    return os.path.dirname(step_dir)


def ck_state_numpy(state_tree, rng) -> dict:
    """A PPO state tree and the generator state as numpy, by model, for
    the reference (which builds its own TrainStates from it)."""
    def ts(s):
        return {"params": _tree_np_dict(s.params), "m": _tree_np_dict(
            s.opt.m), "v": _tree_np_dict(s.opt.v),
            "opt_step": int(s.opt.step), "step": int(s.step)}
    return {"actor": ts(state_tree["actor"]),
            "critic": ts(state_tree["critic"]),
            "ema": _tree_np_dict(state_tree["ema"]), "rng": rng.numpy()}


def _tree_np_dict(tree):
    from repro_torch.models.modules import tree_map
    return tree_map(_np, tree)


def ck_keyed(tree) -> dict:
    """The tree's leaves, full and as numpy, by checkpoint key."""
    from repro_torch.models.modules import flatten_with_path
    from repro_torch.training.checkpoint import _path_key
    return {_path_key(p): _np(t) for p, t in flatten_with_path(tree)}


def ck_continue(tr, rng) -> dict:
    """One more greedy experience and PPO step of ``tr`` from the generator
    state ``rng``: the tokens, the metrics (but times) and the state."""
    g = torch.Generator()
    g.set_state(rng)
    exp, _ = tr.generate_experience(PROMPTS, g)
    m = tr.train_rlhf(exp)
    return {"tokens": _np(exp.sequences),
            "metrics": {k: v for k, v in m.items() if k not in NOT_METRICS},
            "state": ck_keyed(tr.state_tree())}


def ck_resume(ckdir: str, mesh) -> dict:
    """The reference test's ``_resume_on``: a fresh :func:`ck_trainer` on
    ``mesh`` restores the checkpoint in ``ckdir`` into its layout, then
    continues (:func:`ck_continue`); with the restored state."""
    from repro_torch.training.checkpoint import CheckpointManager
    tr = ck_trainer(mesh)
    sh = tr.state_shardings()
    tree, meta = CheckpointManager(ckdir).restore(
        ck_like(), shardings=None if sh is None else {"trainer": sh,
                                                      "rng": None})
    restored = ck_keyed(tree)
    tr.load_state_tree(tree["trainer"])
    return dict(ck_continue(tr, tree["rng"]), restored=restored, meta=meta)


def ck_restore(ckdir: str, mesh) -> dict:
    """The checkpoint in ``ckdir`` read into :func:`ck_shardings`' layouts
    on ``mesh`` (full tensors without one), gathered to numpy."""
    from repro_torch.training.checkpoint import CheckpointManager
    tree, meta = CheckpointManager(ckdir).restore(
        ck_like(), shardings=ck_shardings(mesh))
    return {"tree": ck_keyed(tree), "meta": meta,
            "dtensors": sum(runtime.is_dtensor(t)
                            for t in tree_leaves(tree))}


def case_ck_save(dp: int, tp: int) -> dict:
    """One greedy PPO step of :func:`ck_trainer` on the mesh, saved as
    ``port/step_00000001`` with the generator state; rank 0 then writes
    the state as numpy (``state.pkl``, for the reference to save on its
    own mesh).  Then the uninterrupted continuation and a same-mesh resume
    of the checkpoint."""
    import pickle
    from repro_torch.training.checkpoint import CheckpointManager
    mesh = make_mesh(dp, tp)
    tr = ck_trainer(mesh)
    g = _gen(7)
    exp, _ = tr.generate_experience(PROMPTS, g)
    tr.train_rlhf(exp)
    rng = g.get_state()
    ckdir = os.path.join(CK["dir"], "port")
    mgr = CheckpointManager(ckdir)
    mgr.save(1, {"trainer": tr.state_tree(), "rng": rng}, {"ppo_iter": 1},
             wait=True)
    state = ck_state_numpy(tr.state_tree(), rng)
    if dist.get_rank() == 0:
        tmp = os.path.join(CK["dir"], ".state.pkl")
        with open(tmp, "wb") as f:
            pickle.dump(state, f)
        os.replace(tmp, os.path.join(CK["dir"], "state.pkl"))
    return {"saved": ck_keyed({"trainer": tr.state_tree(), "rng": rng}),
            "stats": mgr.stats, "continued": ck_continue(tr, rng),
            "resumed": ck_resume(ckdir, mesh)}


def case_ck_resume(dp: int, tp: int) -> dict:
    """On the mesh: the resume of the port's 2 x 2 checkpoint (once it has
    committed), then the reference's checkpoint read into the layout."""
    mesh = make_mesh(dp, tp)
    port = ck_wait(os.path.join(CK["dir"], "port", "step_00000001"))
    out = {"resumed": ck_resume(port, mesh)}
    ref = ck_wait(os.path.join(CK["dir"], "ref", "step_00000001"))
    out["reference"] = ck_restore(ref, mesh)
    return out


def case_ck_fault(dp: int, tp: int) -> dict:
    """A ``fault_hook`` that raises on rank 1 alone, at its first shard of
    step 2, synchronously and in the background: every rank's result
    (the exception each rank's ``save`` / ``wait_for_save`` raised, its
    seconds, the committed steps, and whether step 1 verifies)."""
    from repro_torch.training.checkpoint import CheckpointManager
    mesh = make_mesh(dp, tp)
    rank = dist.get_rank()
    armed = []

    def hook(event, n):
        if armed and rank == 1 and event == "shard":
            raise RuntimeError("rank 1 cannot write")
    tree = runtime.place_tree(T.init_params(ACTOR, _gen(3)),
                              S.param_shardings(ACTOR, mesh, "tp"))
    out = {}
    for mode in ("sync", "async"):
        mgr = CheckpointManager(os.path.join(CK["dir"], f"fault_{mode}"),
                                fault_hook=hook)
        armed.clear()
        mgr.save(1, tree, {"ok": 1}, wait=True)
        armed.append(True)
        t0, err = time.perf_counter(), None
        try:
            mgr.save(2, tree, {"ok": 0}, wait=mode == "sync")
            mgr.wait_for_save()
        except Exception as e:                       # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
        mgr.verify(1)
        res = {"error": err, "seconds": time.perf_counter() - t0,
               "steps": mgr.all_steps()}
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, res)
        out[mode] = got
    return out


def case_ck_slow(dp: int, tp: int) -> list:
    """Rank 1's first shard held up :data:`CK_SLOW_S` by its ``fault_hook``,
    past the writers' base wait (cut to :data:`CK_SLOW_BASE_S`, and the
    floor rate to :data:`CK_SLOW_FLOOR_BPS`): every rank's result (the
    exception its ``save`` raised, its seconds, the bytes it wrote, the
    committed steps)."""
    from repro_torch.training import checkpoint as C
    mesh = make_mesh(dp, tp)
    rank = dist.get_rank()

    def hook(event, n):
        if rank == 1 and event == "shard" and n == 1:
            time.sleep(CK_SLOW_S)
    tree = runtime.place_tree(T.init_params(ACTOR, _gen(3)),
                              S.param_shardings(ACTOR, mesh, "tp"))
    kept = C._WRITERS_TIMEOUT_S, C._WRITE_FLOOR_BPS
    C._WRITERS_TIMEOUT_S, C._WRITE_FLOOR_BPS = CK_SLOW_BASE_S, \
        CK_SLOW_FLOOR_BPS
    try:
        mgr = C.CheckpointManager(os.path.join(CK["dir"], "slow"),
                                  fault_hook=hook)
        t0, err = time.perf_counter(), None
        try:
            mgr.save(1, tree, {"ok": 1}, wait=True)
        except Exception as e:                       # noqa: BLE001
            err = f"{type(e).__name__}: {e}"
        res = {"error": err, "seconds": time.perf_counter() - t0,
               "bytes": mgr.stats[-1]["bytes"], "steps": mgr.all_steps()}
    finally:
        C._WRITERS_TIMEOUT_S, C._WRITE_FLOOR_BPS = kept
    got = [None] * dist.get_world_size()
    dist.all_gather_object(got, res)
    return got


def case_ck_pipe(dp: int, tp: int) -> dict:
    """``tests/_torch_ckpt_driver.py``'s pipeline, uninterrupted and without
    checkpoints, on a 2 x (world / 2) mesh of this launch's ranks: the
    record its killed and crashed runs are held to."""
    import _torch_ckpt_driver as K
    return K.run(K.parse(["--out", "-", "--mesh",
                          f"2,{dist.get_world_size() // 2}"]))


CASES = {"reshard": case_reshard, "ppo": case_ppo, "engine": case_engine,
         "lm": case_lm, "embeds": case_embeds, "reward": case_reward,
         "refusals": case_refusals}
TP_CASES = {"tp_lm": case_tp_lm, "tp_ppo": case_tp_ppo,
            "tp_engine": case_tp_engine, "tp_reward": case_tp_reward,
            "tp_layout": case_tp_layout, "tp_refusals": case_tp_refusals,
            "tpl_lm": case_tpl_lm, "tpl_engine": case_tpl_engine,
            "tpl_ppo": case_tpl_ppo, "tpl_layout": case_tpl_layout,
            "ms_engine": case_ms_engine, "ms_moe": case_ms_moe,
            "ms_ppo": case_ms_ppo, "ck_save": case_ck_save,
            "ck_resume": case_ck_resume, "ck_fault": case_ck_fault,
            "ck_slow": case_ck_slow, "ck_pipe": case_ck_pipe}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    ap.add_argument("--mesh", default="1,1",
                    help="dp,tp of the tp_* cases")
    ap.add_argument("--ck", default=None,
                    help="the ck_* cases' checkpoints' root")
    args = ap.parse_args()
    CK["dir"] = args.ck
    dp, tp = (int(x) for x in args.mesh.split(","))
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60.0)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        for name in args.cases.split(","):
            res = (TP_CASES[name](dp, tp) if name in TP_CASES
                   else CASES[name](world))
            if rank == 0:
                torch.save(res, os.path.join(args.out, f"{name}.pt"))
    except Exception:                                # noqa: BLE001
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)            # do not wait on ranks stuck in a collective
    dist.barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
