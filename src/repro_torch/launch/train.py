"""Training launcher: the SFT (causal-LM) loop, or the 3-stage RLHF
pipeline (counterpart of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --steps 10 --batch 8 --seq 512
    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --rlhf --steps 4 --batch 8 --seq 512 --max-new 256 [--kv-quant]

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
int8 KV cache.

Runs on CUDA; ``--device cpu`` runs on the CPU with the kernels' plain
versions.  The reference's LoRA, checkpointing, mesh and asynchronous
RLHF options are not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

import numpy as np

from repro_torch import resolve_device, to_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import CopyTaskDataset, DataBlender, SortTaskDataset
from repro_torch.kernels import ops
from repro_torch.models import transformer as T
from repro_torch.training import schedules
from repro_torch.training.steps import lm_train_step
from repro_torch.training.train_state import TrainState

# the reference's options that belong to later slices: (flag, dest)
NOT_PORTED = (("--lora", "lora"), ("--ckpt", "ckpt"),
              ("--ckpt-dir", "ckpt_dir"), ("--save-every", "save_every"),
              ("--resume", "resume"), ("--mesh", "mesh"),
              ("--strategy", "strategy"), ("--zero", "zero"),
              ("--async-rlhf", "async_rlhf"),
              ("--rollout-mesh", "rollout_mesh"),
              ("--train-mesh", "train_mesh"),
              ("--queue-depth", "queue_depth"),
              ("--publish-every", "publish_every"),
              ("--max-lag", "max_lag"),
              ("--is-ratio-abort", "is_ratio_abort"))


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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rlhf", action="store_true",
                    help="run the 3-stage RLHF pipeline instead of the "
                         "LM loop (--steps/--batch size every stage)")
    ap.add_argument("--max-new", type=int, default=None,
                    help="PPO generation budget per prompt (--rlhf; "
                         "default 16)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache for PPO experience generation "
                         "(--rlhf); training forwards are untouched")
    for flag, dest in NOT_PORTED:
        if flag in ("--resume", "--async-rlhf"):
            ap.add_argument(flag, dest=dest, action="store_true",
                            help=argparse.SUPPRESS)
        else:
            ap.add_argument(flag, dest=dest, default=None,
                            help=argparse.SUPPRESS)
    return ap


def lm_data(cfg, seq: int, seed: int) -> DataBlender:
    """The reference's synthetic SFT blend at sequence length ``seq``."""
    half = seq // 2
    V = min(cfg.vocab_size, 256)
    ds = [CopyTaskDataset(10_000, half, seq - half, V, seed=1),
          SortTaskDataset(10_000, half, seq - half, V, seed=2)]
    return DataBlender(ds, seed=seed)


def train_lm(cfg, state: TrainState, *, steps: int, batch: int, seq: int,
             lr: float, micro: int = 1, seed: int = 0, device=None):
    """The LM loop from ``state``: ``steps`` SFT batches of the synthetic
    blend, the reference's schedule and step lines.  Returns ``(state,
    summary)``: ``loss`` and ``grad_norm`` per step, ``step_ms`` per step
    (host clock around a synchronized step), ``tok_s`` over the steps
    after the first, and the kernel launches of each step."""
    bl = lm_data(cfg, seq, seed)
    lr_fn = schedules.cosine_warmup(lr, steps // 10 + 1, steps)
    losses, gnorms, step_ms, launches = [], [], [], []
    t0 = time.perf_counter()
    for i, b in enumerate(bl.sft_batches(batch, steps)):
        b = to_device(b, device)
        before = ops.launch_counts()
        ts = time.perf_counter()
        state, m = lm_train_step(cfg, state, b, lr_fn(i), micro=micro)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])  # synchronizes
        step_ms.append((time.perf_counter() - ts) * 1e3)
        after = ops.launch_counts()
        launches.append({k: after[k] - before[k] for k in after})
        losses.append(loss)
        gnorms.append(gnorm)
        if i % max(steps // 10, 1) == 0 or i == steps - 1:
            print(f"step {i:4d}  loss={loss:.4f}  gnorm={gnorm:.3f}  "
                  f"{time.perf_counter() - t0:6.1f}s")
    steady = step_ms[1:] or step_ms
    tok_s = batch * seq / (statistics.mean(steady) / 1e3)
    return state, {"loss": losses, "grad_norm": gnorms, "step_ms": step_ms,
                   "tok_s": tok_s, "launches": launches,
                   "tokens_per_step": batch * seq}


def run_rlhf(args, cfg, device) -> dict:
    """SFT -> RM -> PPO on the synthetic blend (the reference's
    ``run_rlhf`` without meshes, asynchronous stage 3 or checkpoints).
    Prints the reference's summary lines and returns the pipeline's logs:
    ``sft_loss``, ``rm_acc``, ``ppo_scores``, ``stage3`` (one metrics dict
    per PPO iteration), ``step_ms``, ``timings`` and ``gen_tok_s``."""
    from repro_torch.core import (PPOConfig, RLHFEngine, RLHFPipeline,
                                  StageConfig)
    eng = RLHFEngine(cfg, cfg.replace(name=cfg.name + "-critic"),
                     torch.Generator(device=device).manual_seed(args.seed))
    pipe = RLHFPipeline(
        eng, lm_data(cfg, args.seq, args.seed),
        StageConfig(sft_steps=args.steps, sft_batch=args.batch,
                    rm_steps=args.steps, rm_batch=args.batch,
                    ppo_steps=args.steps, ppo_batch=args.batch,
                    seed=args.seed),
        PPOConfig(max_new_tokens=args.max_new, temperature=1.0,
                  kv_quant=args.kv_quant))
    out = pipe.run()
    t = out["timings"]
    print(f"sft_loss={out['sft_loss'][-1]:.4f}  "
          f"rm_acc={np.mean(out['rm_acc']):.2f}  "
          f"reward={out['ppo_scores'][-1]:.4f}")
    print("  ".join(f"{k}={v:.1f}s" for k, v in t.items())
          + f"  gen={pipe.gen_tok_s:.1f}tok/s")
    return dict(out, stage3=pipe.log["stage3"], step_ms=pipe.step_ms,
                gen_tok_s=pipe.gen_tok_s)


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's step lines and return
    the summary of :func:`train_lm` (or of :func:`run_rlhf` under
    ``--rlhf``) with ``arch``, ``device``, ``peak_mem_bytes``
    (``torch.cuda.max_memory_allocated``, CUDA only) and, for ``--rlhf``,
    the kernel launches of the whole run."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, dest in NOT_PORTED:
        if getattr(args, dest) not in (None, False):
            ap.error(f"{flag}: not yet ported")
    if not args.rlhf and (args.max_new is not None or args.kv_quant):
        ap.error("--max-new and --kv-quant apply to --rlhf")
    if args.max_new is None:
        args.max_new = 16
    if args.micro < 1 or args.batch % args.micro:
        ap.error("--batch must be a multiple of --micro")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    print(f"arch={cfg.name} params={cfg.n_params() / 1e6:.1f}M "
          f"device={device}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    if args.rlhf:
        before = ops.launch_counts()
        summary = run_rlhf(args, cfg, device)
        after = ops.launch_counts()
        return dict(summary, arch=cfg.name, device=str(device),
                    launches={k: after[k] - before[k] for k in after},
                    peak_mem_bytes=(torch.cuda.max_memory_allocated(device)
                                    if cuda else None))
    gen = torch.Generator(device=device).manual_seed(args.seed)
    state = TrainState.create(T.init_params(cfg, gen))
    _, summary = train_lm(cfg, state, steps=args.steps, batch=args.batch,
                          seq=args.seq, lr=args.lr, micro=args.micro,
                          seed=args.seed, device=device)
    peak = torch.cuda.max_memory_allocated(device) if cuda else None
    steady = summary["step_ms"][1:] or summary["step_ms"]
    print(f"trained {args.steps} steps of {args.batch}x{args.seq} tokens: "
          f"{statistics.median(steady):.1f} ms/step (median after the "
          f"first), {summary['tok_s']:.1f} tok/s"
          + (f", peak memory {peak / 2**30:.2f} GiB" if cuda else ""))
    return dict(summary, arch=cfg.name, device=str(device),
                peak_mem_bytes=peak)


if __name__ == "__main__":
    main()
