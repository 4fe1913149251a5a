"""Training launcher: the SFT (causal-LM) loop (counterpart of the LM loop
of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch opt-1.3b \\
        --steps 10 --batch 8 --seq 512

Trains on the synthetic blend of the reference: a copy task and a sort
task, prompts of ``seq // 2`` tokens over a vocabulary of
``min(vocab, 256)``, with a cosine LR schedule after ``steps // 10 + 1``
warm-up steps, AdamW (b2 = 0.95, clip 1.0) on fp32 master weights and bf16
compute.  Weights are random, drawn from ``--seed``.  Prints the
reference's ``step i loss= gnorm=`` lines; :func:`main` returns a summary
(per-step loss and time, tokens/s, peak device memory, kernel launches).

Runs on CUDA; ``--device cpu`` runs on the CPU with the kernels' plain
versions.  The reference's LoRA, checkpointing, mesh and RLHF options are
not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch import resolve_device
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
              ("--rlhf", "rlhf"), ("--async-rlhf", "async_rlhf"),
              ("--rollout-mesh", "rollout_mesh"),
              ("--train-mesh", "train_mesh"),
              ("--queue-depth", "queue_depth"),
              ("--publish-every", "publish_every"),
              ("--max-lag", "max_lag"),
              ("--is-ratio-abort", "is_ratio_abort"),
              ("--max-new", "max_new"), ("--kv-quant", "kv_quant"))


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
    for flag, dest in NOT_PORTED:
        if flag in ("--resume", "--rlhf", "--async-rlhf", "--kv-quant"):
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


def to_device(batch: dict, device) -> dict:
    """A numpy batch as tensors on ``device`` (token ids as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if not torch.is_floating_point(t):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


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


def main(argv=None) -> dict:
    """Parse ``argv``, train, print the reference's step lines and return
    the summary of :func:`train_lm` with ``arch``, ``device`` and
    ``peak_mem_bytes`` (``torch.cuda.max_memory_allocated``, CUDA only)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, dest in NOT_PORTED:
        if getattr(args, dest) not in (None, False):
            ap.error(f"{flag}: not yet ported")
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
