"""End-to-end RLHF driver on the PyTorch port — the paper's ``train.py
--actor-model ... --reward-model ... --deployment-type`` analogue
(counterpart of ``examples/rlhf_e2e.py``).

    PYTHONPATH=src python examples/torch_rlhf_e2e.py \\
        [--scale 100m|25m|tiny] [--sft-steps N --rm-steps N --ppo-steps N]
        [--no-ema] [--ptx 0.05] [--out out/rlhf] [--device cuda|cpu]

Trains an actor through all three stages on blended synthetic datasets
(copy/sort/constant tasks), with the paper's optional features on by
default (EMA collection, mixture training), saves actor + EMA
checkpoints (``actor.npz``, ``actor_ema.npz``: the ``repro-ckpt``
``.npz`` export, which the JAX package's ``checkpoint.load`` reads) and
``log.json``, and reports per-stage wall time (Table 4/6 analogue).

Scales: ``tiny`` ~1M, ``25m`` ~25M, ``100m`` ~110M params.  Runs on CUDA
with the port's kernels; ``--device cpu`` runs their plain versions.  At
``tiny`` the head dimension (16) is below the kernels' smallest (32), so
that scale runs the model's plain path on either device.
"""
import argparse
import json
import os

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import PPOConfig, RLHFEngine, RLHFPipeline, StageConfig
from repro_torch.data import (ConstantTaskDataset, CopyTaskDataset,
                              DataBlender, SortTaskDataset)
from repro_torch.kernels.flash_attention import HEAD_DIMS
from repro_torch.models.config import ModelConfig
from repro_torch.training import checkpoint

SCALES = {
    "tiny": dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                 vocab_size=64, prompt=8, resp=8),
    "25m": dict(n_layers=6, d_model=384, n_heads=6, n_kv_heads=2,
                d_ff=1024, vocab_size=2048, prompt=16, resp=16),
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=2048, vocab_size=8192, prompt=32, resp=32),
}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", default="25m", choices=list(SCALES))
    ap.add_argument("--sft-steps", type=int, default=120)
    ap.add_argument("--rm-steps", type=int, default=80)
    ap.add_argument("--ppo-steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ptx", type=float, default=0.05)
    ap.add_argument("--no-ema", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="out/rlhf")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    s = SCALES[args.scale]
    hd = s["d_model"] // s["n_heads"]
    actor = ModelConfig(name=f"rlhf-{args.scale}", arch_type="dense",
                        n_layers=s["n_layers"], d_model=s["d_model"],
                        n_heads=s["n_heads"], n_kv_heads=s["n_kv_heads"],
                        d_ff=s["d_ff"], vocab_size=s["vocab_size"],
                        compute_dtype="float32", remat=False,
                        use_kernels=hd in HEAD_DIMS)
    critic = actor.replace(name=f"rlhf-{args.scale}-rm",
                           n_layers=max(2, s["n_layers"] // 3))
    print(f"actor {actor.n_params()/1e6:.1f}M params, "
          f"reward/critic {critic.n_params()/1e6:.1f}M params, "
          f"device={device}, kernels {'on' if actor.use_kernels else 'off'}")

    V = s["vocab_size"]
    ds = [CopyTaskDataset(4000, s["prompt"], s["resp"], min(V, 256), 1),
          SortTaskDataset(4000, s["prompt"], s["resp"], min(V, 256), 2),
          ConstantTaskDataset(4000, s["prompt"], s["resp"], min(V, 256), 3)]
    blender = DataBlender(ds, proportions=[0.4, 0.3, 0.3],
                          split_weights=(2, 4, 4), seed=args.seed)

    engine = RLHFEngine(actor, critic,
                        torch.Generator(device=device).manual_seed(args.seed))
    pipe = RLHFPipeline(
        engine, blender,
        StageConfig(sft_steps=args.sft_steps, sft_batch=args.batch,
                    rm_steps=args.rm_steps, rm_batch=args.batch,
                    ppo_steps=args.ppo_steps, ppo_batch=args.batch,
                    seed=args.seed),
        PPOConfig(max_new_tokens=s["resp"], ptx_coef=args.ptx,
                  use_ema=not args.no_ema))

    out = pipe.run()
    print(f"SFT loss   : {out['sft_loss'][0]:.3f} -> "
          f"{np.mean(out['sft_loss'][-10:]):.3f}")
    print(f"RM acc     : {np.mean(out['rm_acc'][:10]):.2f} -> "
          f"{np.mean(out['rm_acc'][-10:]):.2f}")
    k = max(len(out['ppo_scores']) // 4, 1)
    print(f"PPO reward : {np.mean(out['ppo_scores'][:k]):+.3f} -> "
          f"{np.mean(out['ppo_scores'][-k:]):+.3f}")
    print("stage times:", {k2: f"{v:.1f}s" for k2, v in
                           out["timings"].items()})

    os.makedirs(args.out, exist_ok=True)
    checkpoint.save(os.path.join(args.out, "actor.npz"),
                    pipe.e.actor_params,
                    metadata={"arch": actor.name, "stages": "3"})
    if not args.no_ema:
        checkpoint.save(os.path.join(args.out, "actor_ema.npz"),
                        pipe.trainer.ema_params(),
                        metadata={"arch": actor.name, "ema": True})
    with open(os.path.join(args.out, "log.json"), "w") as f:
        json.dump({k2: (v if not isinstance(v, list) else v)
                   for k2, v in out.items() if k2 != "timings"}, f)
    print("checkpoints in", args.out)
    return dict(out, actor_cfg=actor, pipeline=pipe)


if __name__ == "__main__":
    main()
