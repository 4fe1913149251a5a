"""Training launcher: the SFT (causal-LM) loop, or the 3-stage RLHF
pipeline (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --steps 10 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --rlhf --steps 4 --batch 8 --seq 512 --max-new 256 [--kv-quant]
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --steps 10 --batch 8 --seq 512 [--lora 8] [--ckpt out/model.npz] \\
        [--ckpt-dir out/ckpt --save-every 2 [--resume]]

Trains on the synthetic blend of the reference: a copy task and a sort
task, prompts of ``seq // 2`` tokens over a vocabulary of
``min(vocab, 256)``, with a cosine LR schedule after ``steps // 10 + 1``
warm-up steps, AdamW (b2 = 0.95, clip 1.0) on fp32 master weights and bf16
compute.  Weights are random, drawn from ``--seed``.  Prints the
reference's ``step i loss= gnorm=`` lines; :func:`main` returns a summary
(per-step loss and time, tokens/s, peak device memory, kernel launches).

``--rlhf`` runs SFT -> RM -> PPO instead (:func:`run_rlhf`), every stage
``--steps`` steps of ``--batch``; the critic and reward model share the
actor's config, as in the reference.  PPO generates ``--max-new`` tokens
per prompt at temperature 1.0; ``--kv-quant`` runs that generation on an
int8 KV cache.  ``--async-rlhf`` overlaps stage 3's generation and
training through the replay queue (:mod:`repro_torch.core.replay`; one
device, ``--mesh 1,1`` or the disaggregated split below), with the reference's ``--queue-depth``,
``--publish-every``, ``--max-lag`` (0 = lockstep, bit-identical to the
synchronous run) and ``--is-ratio-abort``, and prints the reference's
``async: produced= ...`` line::

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \
        --rlhf --async-rlhf --max-lag 1 --steps 4 --batch 8 --seq 512

The SSM and hybrid ids (``mamba2-370m``, ``zamba2-1.2b``) train too, SFT,
reward and PPO alike: each SSD layer's forward is the intra-chunk kernel
(twice a step with remat) and its backward the explicit plain one;
Zamba2's attention layers train through the flash kernels, and with
``--rlhf --kv-quant`` generate on the int8 arena.

The MoE ids (``llama4-scout-17b-a16e``, and ``deepseek-v2-lite-16b``,
whose MLA attention trains through the flash kernels at head dim 192) add
their routers' aux loss to the LM loss, as the reference does.  The VLM
and audio ids (``llama-3.2-vision-11b``, ``musicgen-medium``) take
encoder or frame embeddings, which the launcher's token batches do not
hold: they are refused (the reference's launcher fails on them in the
forward), and train through :func:`repro_torch.training.steps.lm_train_step`
with ``encoder_embeds`` / ``embeds`` in the batch.

``--ckpt-dir`` with ``--save-every N`` makes the LM loop fault tolerant,
as in the reference: every N steps (and after the last) the whole
TrainState (params, Adam moments, step counters) is committed through
:class:`repro_torch.training.checkpoint.CheckpointManager` as step
``i + 1`` with metadata ``{"arch", "step": i}``; ``--resume`` restores the
latest valid checkpoint and continues at ``step + 1`` with the LR schedule
and the data cursor where they stopped, bit for bit as an uninterrupted
run.  Under ``--rlhf`` the directory goes to the pipeline, which commits
its stage boundaries and every ``--save-every`` (default 1) PPO
iterations, and resumes by itself; ``--keep`` sets how many committed
checkpoints stay (default 3).  ``--lora R`` trains rank-R adapters
(:mod:`repro_torch.core.lora`) on the frozen base instead of the whole
model; ``--ckpt`` writes the final params (the folded adapters with
``--lora``) as one ``.npz``, which both packages' ``checkpoint.load``
read.  :func:`main` also returns ``state_sha256``, a SHA-256 of the final
state (params, moments and step counters), by which runs are compared.

``--mesh dp,tp`` trains on a ``dp x tp`` mesh, one process per device
under ``torchrun`` (NCCL on CUDA, gloo with ``--device cpu``)::

    torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \
        --arch opt-125m --mesh 2,2 --strategy zero3 --zero 1 --steps 5

The batch shards over ``data``, the params follow ``--strategy``
(``zero3``: ``embed`` dims over ``data``, heads, MLP width, vocabulary and
experts over ``model``; ``tp``: those over ``model`` only;
``ddp``/``zero1``: replicated) and ``--zero 1`` shards the Adam moments
over ``data``; the state is committed to that layout at creation, and the
compute over ``model`` is tensor-parallel.  Under ``--rlhf`` the mesh goes
to the Hybrid Engine (stage 3).  Rank 0 prints.  Every layer kind trains
on ``tp`` > 1 (attention whose heads ``tp`` does not split whole is
computed whole on every rank).  ``--ckpt-dir`` on a mesh writes sharded
checkpoints, every rank its own pieces (the directory must be one that
every rank sees), and ``--resume`` reads one into the current layout,
whatever mesh, ``--strategy`` or ``--zero`` it was saved under, or none::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch opt-125m --mesh 2,1 --ckpt-dir ck --save-every 2 --steps 6
    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch opt-125m --mesh 1,2 --strategy tp --ckpt-dir ck --resume \
        --steps 8

``--rollout-mesh R --train-mesh T`` (with ``--rlhf``; the two go
together) runs stage 3 disaggregated (:mod:`repro_torch.core.pipeline`):
``torchrun`` with ``nr + nt`` ranks, the first ``nr`` a rollout mesh
that generates, the next ``nt`` a training mesh that runs stages 1 and 2,
scoring and the PPO steps, bridged by two gloo groups (weights one way,
rollout batches the other).  ``R`` and ``T`` are rank counts (``n`` is
``1 x n`` for rollout, ``n x 1`` for training) or ``dp,tp``.  With
``--async-rlhf`` generation overlaps training; the first training rank
prints the ``disaggregated: rollout=... train=...`` line and the
summaries.  On CUDA one card may hold one rank of each role (two ranks of
one role mesh on one card are refused), so one card runs ``1 | 1``::

    torchrun --standalone --nproc-per-node 2 -m repro_torch.launch.train \
        --arch opt-125m --rlhf --rollout-mesh 1 --train-mesh 1 --async-rlhf

``--mesh`` with the split is refused (the reference lets the split win
silently), as is ``--async-rlhf`` on a shared ``--mesh`` of more than one
rank (not ported yet: run it disaggregated); ``--mesh`` with ``--lora`` is
refused as in the reference.

Runs on CUDA; ``--device cpu`` runs on the CPU with the kernels' plain
versions.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import io
import math
import statistics
import time

import torch

import numpy as np

from repro_torch import resolve_device, to_device
from repro_torch.configs import get_config, reduced
from repro_torch.core import lora as LoRA
from repro_torch.data import CopyTaskDataset, DataBlender, SortTaskDataset
from repro_torch.kernels import ops
from repro_torch.launch.mesh import (_submesh_shape, init_distributed,
                                     make_disaggregated_meshes,
                                     mesh_from_spec)
from repro_torch.models import transformer as T
from repro_torch.models.modules import tree_leaves
from repro_torch.sharding import runtime
from repro_torch.training import checkpoint, schedules
from repro_torch.training.steps import (lm_loss_fn, lm_train_step,
                                        make_sharded_lm_step,
                                        value_and_grad)
from repro_torch.training.train_state import TrainState

# the asynchronous stage 3's knobs: (flag, dest, the reference's default)
ASYNC_KNOBS = (("--queue-depth", "queue_depth", 2),
               ("--publish-every", "publish_every", 1),
               ("--max-lag", "max_lag", 1),
               ("--is-ratio-abort", "is_ratio_abort", None))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda runs the CUDA kernels; cpu runs their plain "
                         "versions")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--micro", type=int, default=1)
    ap.add_argument("--lora", type=int, default=0,
                    help="train rank-R LoRA adapters on the frozen base")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None,
                    help="final .npz params export (legacy single-file)")
    ap.add_argument("--ckpt-dir", default=None,
                    help="directory for fault-tolerant async "
                         "checkpoints")
    ap.add_argument("--save-every", type=int, default=0,
                    help="checkpoint the full TrainState + data cursor "
                         "every N steps into --ckpt-dir")
    ap.add_argument("--resume", action="store_true",
                    help="resume from the latest valid checkpoint in "
                         "--ckpt-dir (bit-identical continuation)")
    ap.add_argument("--keep", type=int, default=3,
                    help="committed checkpoints kept in --ckpt-dir (the "
                         "CheckpointManager's default)")
    ap.add_argument("--mesh", default=None,
                    help="dp,tp: train on a dp x tp mesh, one process "
                         "per device under torchrun")
    ap.add_argument("--strategy", default="zero3",
                    choices=["ddp", "zero1", "zero3", "tp"],
                    help="param sharding strategy on the mesh")
    ap.add_argument("--zero", type=int, default=1, choices=[0, 1],
                    help="ZeRO stage for the Adam moments on the mesh: "
                         "1 shards them over the data axis")
    ap.add_argument("--rlhf", action="store_true",
                    help="run the 3-stage RLHF pipeline instead of the "
                         "LM loop (--steps/--batch size every stage)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="PPO generation budget per prompt (--rlhf; "
                         "default 16)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for PPO experience generation "
                         "(--rlhf); training forwards are untouched")
    ap.add_argument("--async-rlhf", action="store_true",
                    help="overlap stage-3 generation and training via "
                         "the replay queue (--rlhf; one device, --mesh 1,1 "
                         "or the disaggregated split)")
    ap.add_argument("--queue-depth", type=int, default=None,
                    help="replay queue capacity (backpressure bound; "
                         "default 2)")
    ap.add_argument("--publish-every", type=int, default=None,
                    help="publish actor weights every N PPO steps "
                         "(default 1)")
    ap.add_argument("--max-lag", type=int, default=None,
                    help="max behavior-policy staleness in PPO steps "
                         "(0 = lockstep, bit-identical to sync; default 1)")
    ap.add_argument("--is-ratio-abort", type=float, default=None,
                    help="importance-ratio ceiling: a stale batch whose "
                         "max ratio exceeds it drops the run to lockstep")
    ap.add_argument("--rollout-mesh", default=None,
                    help="disaggregated stage 3 (--rlhf, with "
                         "--train-mesh): the rollout mesh, 'n' (1 x n) or "
                         "'dp,tp', on the first ranks under torchrun; "
                         "refused with --mesh")
    ap.add_argument("--train-mesh", default=None,
                    help="disaggregated stage 3 (--rlhf, with "
                         "--rollout-mesh): the training mesh, 'n' (n x 1) "
                         "or 'dp,tp', on the ranks after the rollout mesh")
    return ap


def lm_data(cfg, seq: int, seed: int) -> DataBlender:
    """The reference's synthetic SFT blend at sequence length ``seq``."""
    half = seq // 2
    V = min(cfg.vocab_size, 256)
    ds = [CopyTaskDataset(10_000, half, seq - half, V, seed=1),
          SortTaskDataset(10_000, half, seq - half, V, seed=2)]
    return DataBlender(ds, seed=seed)


def lora_train_step(cfg, params, state: TrainState, batch, lr):
    """One LoRA step: ``state`` holds the adapters; the loss is the LM loss
    of ``lora.merge(params, adapters)``, whose base is frozen, so only the
    adapters get grads and Adam state."""
    (loss, metrics), grads = value_and_grad(
        lambda ad: lm_loss_fn(cfg, LoRA.merge(params, ad), batch),
        state.params)
    state, gnorm = state.apply_gradients(grads, lr=lr)
    return state, dict(metrics, loss=loss, grad_norm=gnorm)


def train_lm(cfg, state: TrainState, *, steps: int, batch: int, seq: int,
             lr: float, micro: int = 1, seed: int = 0, device=None,
             start: int = 0, step_fn=None, mgr=None, save_every: int = 0):
    """The LM loop from ``state`` at step ``start``: SFT batches
    ``start..steps-1`` of the synthetic blend with the reference's schedule
    and step lines.  ``step_fn(state, batch, lr)`` replaces the SFT step
    (the LoRA step); with ``mgr`` and ``save_every`` the state is saved as
    in the reference.  Returns ``(state, summary)``: ``loss`` and
    ``grad_norm`` per step (``loss`` includes the MoE aux loss, also given
    alone as ``aux_loss``), ``step_ms`` per step (host clock around a
    synchronized step, the save excluded), ``tok_s`` over the steps after
    the first, and the kernel launches of each step."""
    if step_fn is None:
        step_fn = lambda s, b, lr: lm_train_step(cfg, s, b, lr, micro=micro)
    bl = lm_data(cfg, seq, seed)
    lr_fn = schedules.cosine_warmup(lr, steps // 10 + 1, steps)
    losses, gnorms, auxes, step_ms, launches = [], [], [], [], []
    t0 = time.perf_counter()
    for i, b in enumerate(bl.sft_batches(batch, steps, skip=start),
                          start=start):
        b = to_device(b, device)
        before = ops.launch_counts()
        ts = time.perf_counter()
        state, m = step_fn(state, b, lr_fn(i))
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronizes
        step_ms.append((time.perf_counter() - ts) * 1e3)
        after = ops.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        losses.append(loss)
        gnorms.append(gnorm)
        auxes.append(float(m["aux_loss"]))
        if mgr is not None and save_every and (
                (i + 1) % save_every == 0 or i == steps - 1):
            mgr.save(i + 1, state, metadata={"arch": cfg.name, "step": i})
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            print(f"step {i:4d}  loss={loss:.4f}  gnorm={gnorm:.3f}  "
                  f"{time.perf_counter() - t0:6.1f}s")
    steady = step_ms[1:] or step_ms
    tok_s = batch * seq / (statistics.mean(steady) / 1e3) if steady else 0.0
    return state, {"loss": losses, "grad_norm": gnorms, "aux_loss": auxes,
                   "step_ms": step_ms,
                   "tok_s": tok_s, "launches": launches,
                   "tokens_per_step": batch * seq}


def run_rlhf(args, cfg, device, iter_hook=None, mesh=None,
             rollout_mesh=None) -> dict:
    """SFT -> RM -> PPO on the synthetic blend (the reference's
    ``run_rlhf``; ``--ckpt-dir`` makes it durable and resumable,
    ``--async-rlhf`` overlaps stage 3, ``rollout_mesh`` with ``mesh`` the
    training mesh runs it disaggregated).
    Prints the reference's summary lines and returns the pipeline's logs:
    ``sft_loss``, ``rm_acc``, ``ppo_scores``, ``stage3`` (one metrics dict
    per PPO iteration), ``step_ms``, ``timings``, ``gen_tok_s``, the
    SHA-256 of the actor's, critic's and EMA's final states, the
    checkpointer's ``ckpt_stats`` and, with ``--async-rlhf``, ``async``:
    the reference's summary keys (``produced``, ``max_depth``,
    ``dropped``, ``fallbacks``, ``publishes``) beside the queue's, the
    publisher's and the producer's whole telemetry.  ``iter_hook(pipeline,
    i)`` is called at the top of each PPO iteration.  On a rollout rank
    of the split the logs are empty and ``state_sha256`` is ``None``."""
    from repro_torch.core import (AsyncConfig, PPOConfig, RLHFEngine,
                                  RLHFPipeline, StageConfig)
    async_cfg = None
    if args.async_rlhf:
        async_cfg = AsyncConfig(queue_depth=args.queue_depth,
                                publish_every=args.publish_every,
                                max_lag=args.max_lag,
                                is_ratio_abort=args.is_ratio_abort)
        print(f"async stage 3: {async_cfg}")
    eng = RLHFEngine(cfg, cfg.replace(name=cfg.name + "-critic"),
                     torch.Generator(device=device).manual_seed(args.seed),
                     mesh=mesh, train_strategy=args.strategy,
                     zero=args.zero, rollout_mesh=rollout_mesh)
    mgr = (checkpoint.CheckpointManager(args.ckpt_dir, keep=args.keep)
           if args.ckpt_dir else None)
    pipe = RLHFPipeline(
        eng, lm_data(cfg, args.seq, args.seed),
        StageConfig(sft_steps=args.steps, sft_batch=args.batch,
                    rm_steps=args.steps, rm_batch=args.batch,
                    ppo_steps=args.steps, ppo_batch=args.batch,
                    seed=args.seed),
        PPOConfig(max_new_tokens=args.max_new, temperature=1.0,
                  kv_quant=args.kv_quant),
        checkpointer=mgr, save_every=args.save_every or 1,
        async_cfg=async_cfg)
    if iter_hook is not None:
        pipe.iter_hook = functools.partial(iter_hook, pipe)
    out = pipe.run()
    if eng.role == "rollout":
        return dict(out, stage3=[], step_ms=pipe.step_ms, gen_tok_s=0.0,
                    **{"async": pipe.async_stats or None},
                    state_sha256=None, ckpt_stats=None)
    t = out["timings"]
    print(f"sft_loss={out['sft_loss'][-1]:.4f}  "
          f"rm_acc={np.mean(out['rm_acc']):.2f}  "
          f"reward={out['ppo_scores'][-1]:.4f}")
    print("  ".join(f"{k}={v:.1f}s" for k, v in t.items())
          + f"  gen={pipe.gen_tok_s:.1f}tok/s")
    summary_async = None
    if pipe.async_stats:
        a = pipe.async_stats
        summary_async = dict(a, max_depth=a["queue"]["max_depth"],
                             dropped=a["queue"]["dropped"],
                             fallbacks=a["lockstep_fallbacks"],
                             publishes=a["publisher"]["publishes"])
        print(f"async: produced={a['produced']} "
              f"max_depth={summary_async['max_depth']} "
              f"dropped={summary_async['dropped']} "
              f"fallbacks={summary_async['fallbacks']} "
              f"publishes={summary_async['publishes']}")
    tr = pipe.trainer
    return dict(out, stage3=pipe.log["stage3"], step_ms=pipe.step_ms,
                **{"async": summary_async},
                gen_tok_s=pipe.gen_tok_s,
                state_sha256={k: checkpoint.tree_sha256(v) for k, v in (
                        ("actor", tr.actor), ("critic", tr.critic),
                        ("ema", tr.ema))},
                ckpt_stats=mgr.stats if mgr is not None else None)


def main(argv=None, iter_hook=None, cfg=None) -> dict:
    """Parse ``argv``, train, print the reference's step lines and return
    the summary of :func:`train_lm` (or of :func:`run_rlhf` under
    ``--rlhf``) with ``arch``, ``device``, ``peak_mem_bytes``
    (``torch.cuda.max_memory_allocated``, CUDA only), ``state_sha256``
    (:func:`checkpoint.tree_sha256` of the final TrainState; per model
    under ``--rlhf``) and, for ``--rlhf``, the kernel launches of the whole
    run.  The LM loop's summary also holds the final ``state``, the base
    ``params`` (the frozen base under ``--lora``, else the state's),
    ``start`` (the first step run), ``adapter_params`` and the
    checkpointer's ``ckpt_stats`` and ``restore`` timings.
    ``iter_hook(pipeline, i)``, under ``--rlhf``, is called at the top of
    each PPO iteration.  ``cfg``, when given, is trained in place of
    ``--arch``'s config (e.g. cut in depth, for a model whose state one
    card cannot hold whole)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.rollout_mesh is not None or args.train_mesh is not None:
        return _main_split(ap, args, iter_hook, cfg)
    if args.mesh is None:
        return _main(ap, args, iter_hook, cfg)
    if args.async_rlhf and math.prod(
            int(x) for x in args.mesh.split(",")) > 1:
        ap.error("--async-rlhf on a shared mesh of more than one rank: not "
                 "yet ported; run it disaggregated (--rollout-mesh, "
                 "--train-mesh)")
    if args.lora:
        ap.error("--mesh with --lora is not supported")
    import torch.distributed as dist
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to run on the "
                 "CPU with the kernels' plain versions")
    owned = not dist.is_initialized()
    device = init_distributed(args.device)
    try:
        mesh = mesh_from_spec(args.mesh)
        quiet = dist.get_rank() != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet \
                else contextlib.nullcontext():
            print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
                  f"strategy={args.strategy} zero={args.zero}")
            return _main(ap, args, iter_hook, cfg, mesh=mesh, device=device)
    finally:
        if owned:
            dist.destroy_process_group()


def _main_split(ap, args, iter_hook, cfg) -> dict:
    """The disaggregated split under ``torchrun`` (``nr + nt`` ranks)."""
    if args.rollout_mesh is None or args.train_mesh is None:
        ap.error("--rollout-mesh and --train-mesh go together")
    if args.mesh is not None:
        ap.error("--mesh with --rollout-mesh/--train-mesh: give the "
                 "training mesh as --train-mesh")
    if not args.rlhf:
        ap.error("--rollout-mesh and --train-mesh apply to --rlhf")
    try:
        shapes = (_submesh_shape(args.rollout_mesh, "model", "--rollout-mesh"),
                  _submesh_shape(args.train_mesh, "data", "--train-mesh"))
    except ValueError as e:
        ap.error(str(e))
    import torch.distributed as dist
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to run on the "
                 "CPU with the kernels' plain versions")
    owned = not dist.is_initialized()
    device = init_distributed(args.device, shared_cards=True)
    try:
        n = sum(dp * tp for dp, tp in shapes)
        if dist.get_world_size() != n:
            raise SystemExit(
                f"--rollout-mesh {args.rollout_mesh} --train-mesh "
                f"{args.train_mesh} needs exactly {n} ranks (torchrun "
                f"--nproc-per-node {n}), have {dist.get_world_size()}")
        rollout_mesh, mesh, role = make_disaggregated_meshes(
            rollout=args.rollout_mesh, train=args.train_mesh)
        quiet = dist.get_rank() != shapes[0][0] * shapes[0][1]
        with contextlib.redirect_stdout(io.StringIO()) if quiet \
                else contextlib.nullcontext():
            print("disaggregated: rollout={} train={}".format(*(
                dict(zip(m.mesh_dim_names, m.shape))
                for m in (rollout_mesh, mesh))))
            return _main(ap, args, iter_hook, cfg, mesh=mesh, device=device,
                         rollout_mesh=rollout_mesh)
    finally:
        if owned:
            dist.destroy_process_group()


def _main(ap, args, iter_hook, cfg, mesh=None, device=None,
          rollout_mesh=None) -> dict:
    if not args.rlhf and (args.max_new is not None or args.kv_quant
                          or args.async_rlhf):
        ap.error("--max-new, --kv-quant and --async-rlhf apply to --rlhf")
    for flag, dest, default in ASYNC_KNOBS:
        if getattr(args, dest) is not None and not args.async_rlhf:
            ap.error(f"{flag} applies to --rlhf --async-rlhf")
        if dest != "is_ratio_abort" and getattr(args, dest) is None:
            setattr(args, dest, default)
    if args.rlhf and (args.lora or args.ckpt):
        ap.error("--lora and --ckpt apply to the LM loop, not --rlhf")
    if (args.save_every or args.resume) and not args.ckpt_dir:
        ap.error("--save-every and --resume need --ckpt-dir")
    if args.lora and args.micro > 1:
        ap.error("--micro applies to full SFT, not --lora")
    if args.lora < 0 or args.save_every < 0 or args.keep < 1:
        ap.error("--lora and --save-every take a count >= 0, --keep >= 1")
    if args.max_new is None:
        args.max_new = 16
    if args.micro < 1 or args.batch % args.micro:
        ap.error("--batch must be a multiple of --micro")
    if device is None:
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            ap.error(str(e))

    if cfg is None:
        cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if cfg.arch_type == "vlm" or not cfg.embed_inputs:
        # the reference's launcher feeds these models the same token batches
        # and fails in the forward; the port says why before it starts
        ap.error(f"{cfg.name}: the launcher's data are token batches, and "
                 f"this model takes "
                 f"{'encoder_embeds' if cfg.embed_inputs else 'embeds'}; "
                 f"train it through training.steps.lm_train_step with a "
                 f"batch that holds them")
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"device={device}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if args.rlhf:
        before = ops.launch_counts()
        summary = run_rlhf(args, cfg, device, iter_hook, mesh=mesh,
                           rollout_mesh=rollout_mesh)
        after = ops.launch_counts()
        return dict(summary, arch=cfg.name, device=str(device),
                    launches={k: after[k] - before[k] for k in after},
                    peak_mem_bytes=(torch.cuda.max_memory_allocated(device)
                                    if cuda else None))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen)
    step_fn, n_adapter, shardings = None, None, None
    if args.lora:
        adapters = LoRA.init(params, args.lora, gen)
        state = TrainState.create(adapters)
        n_adapter = sum(x.numel() for x in tree_leaves(adapters))
        print(f"LoRA rank={args.lora}: training {n_adapter / 1e6:.2f}M "
              f"adapter params")
        step_fn = functools.partial(lora_train_step, cfg, params)
    elif mesh is not None:
        step, shardings, shard_batch = make_sharded_lm_step(
            cfg, mesh, args.strategy, zero=args.zero, micro=args.micro)
        state, params = TrainState.create(params, shardings=shardings), None
        step_fn = lambda s, b, lr: step(s, shard_batch(b), lr)
    else:
        state, params = TrainState.create(params), None

    mgr, start = None, 0
    if args.ckpt_dir:
        mgr = checkpoint.CheckpointManager(args.ckpt_dir, keep=args.keep)
        if args.resume and mgr.latest_step() is not None:
            target = checkpoint.like(state)
            state = None                  # free the fresh state first
            state, meta = mgr.restore(target, shardings=shardings)
            start = int(meta["step"]) + 1
            print(f"resumed from step {meta['step']} "
                  f"(checkpoint {mgr.latest_step()})")
    state, summary = train_lm(cfg, state, steps=args.steps, batch=args.batch,
                              seq=args.seq, lr=args.lr, micro=args.micro,
                              seed=args.seed, device=device, start=start,
                              step_fn=step_fn, mgr=mgr,
                              save_every=args.save_every)
    if mgr is not None:
        mgr.wait_for_save()           # durable before exit
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    if summary["step_ms"]:
        steady = summary["step_ms"][1:] or summary["step_ms"]
        print(f"trained {len(summary['step_ms'])} steps of {args.batch}x"
              f"{args.seq} tokens: {statistics.median(steady):.1f} ms/step "
              f"(median after the first), {summary['tok_s']:.1f} tok/s"
              + (f", peak memory {peak / 2**30:.2f} GiB" if cuda else ""))
    export_s = None
    if args.ckpt:
        t0 = time.perf_counter()
        tree = (runtime.full_tree(state.params) if not args.lora
                else LoRA.fold(params, state.params))
        if _rank() == 0:
            checkpoint.save(args.ckpt, tree,
                            metadata={"arch": cfg.name, "steps": args.steps})
        export_s = time.perf_counter() - t0
        print("saved", args.ckpt)
    return dict(summary, arch=cfg.name, device=str(device),
                peak_mem_bytes=peak, state=state,
                params=params if args.lora else state.params,
                start=start, adapter_params=n_adapter,
                state_sha256=checkpoint.tree_sha256(state),
                ckpt_stats=mgr.stats if mgr is not None else None,
                restore=mgr.last_restore if mgr is not None else None,
                export_s=export_s)


def _rank() -> int:
    import torch.distributed as dist
    return dist.get_rank() if dist.is_initialized() else 0


if __name__ == "__main__":
    main()
