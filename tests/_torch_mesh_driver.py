"""One rank of the port's data-parallel checks, on gloo over the CPU.

Launched by ``tests/test_torch_multidevice.py`` and
``tests/test_torch_hybrid_engine.py`` as::

    python -m torch.distributed.run --standalone --nproc-per-node N \\
        tests/_torch_mesh_driver.py --out DIR --cases ppo,lm,...

Every rank builds the same weights from fixed seeds, runs the named cases
on meshes over the first ranks, and rank 0 writes each case's results
(full tensors, gathered) to ``DIR/<case>.pt``.  The tests hold them to the
single-rank port and the reference.  Every process group times out after
60 s, so a failing rank fails the run instead of hanging it.
"""
from __future__ import annotations

import argparse
import os
import sys
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
from repro_torch.serving.engine import GenerationEngine, Request
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
    return runtime.full(x).detach().cpu().numpy()


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
    mesh = make_mesh(dp, 1)
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
    """What a mesh still refuses, as the exception each raises."""
    out = {}

    def grab(name, fn):
        try:
            fn()
            out[name] = None
        except Exception as e:                      # noqa: BLE001
            out[name] = f"{type(e).__name__}: {e}"

    mesh = make_mesh(world // 2, 2)                 # model = 2
    grab("ppo_tp2", lambda: trainer(HybridEngine(ACTOR, mesh)))
    grab("lm_step_tp2", lambda: make_sharded_lm_step(ACTOR, mesh, "zero3"))
    grab("generate_tp2", lambda: GenerationEngine(
        ACTOR, mesh=mesh, device="cpu", **PPO_KW).generate(
            models()[0], torch.as_tensor(PROMPTS), _gen(0)))
    dmesh = make_mesh(world, 1)
    grab("core", lambda: GenerationEngine(
        ACTOR, mesh=dmesh, device="cpu", **PPO_KW).core(
            models()[0], _gen(0), max_seq_len=16))
    grab("rollout_mesh", lambda: PPOTrainer(
        actor_cfg=ACTOR, critic_cfg=CRITIC, actor_params=models()[0],
        critic_params=models()[2], ref_params=models()[1],
        reward_params=models()[3], ppo=PPOConfig(**PPO_KW),
        rollout_mesh=dmesh))
    return out


CASES = {"reshard": case_reshard, "ppo": case_ppo, "engine": case_engine,
         "lm": case_lm, "embeds": case_embeds, "reward": case_reward,
         "refusals": case_refusals}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    torch.set_num_threads(1)
    init_distributed("cpu", timeout_s=60.0)
    rank, world = dist.get_rank(), dist.get_world_size()
    try:
        for name in args.cases.split(","):
            res = CASES[name](world)
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
