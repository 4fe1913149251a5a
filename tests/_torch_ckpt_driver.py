"""Subprocess driver for the port's crash-injection checkpoint suite
(``tests/test_torch_ckpt_resume.py``), the counterpart of
``tests/_ckpt_driver.py`` on ``repro_torch``.

Runs a tiny 3-stage RLHF pipeline on the CPU with fault-tolerant
checkpointing and, on success, writes a JSON record of everything that
must be bit-identical across crash and resume:

- the per-iteration stage-3 metrics without the wall-time keys,
- the PPO reward-score trajectory,
- SHA-256 hashes of the final actor, critic and EMA states.

Crash injection:

- ``--die-at-iter K`` exits hard (code 37) at the top of PPO iteration K
  after draining the in-flight write (a preemption with a grace window);
- ``REPRO_CKPT_FAULT=<event>:<n>`` (read by the CheckpointManager) exits
  hard (code 41) inside the background writer.

It is launched with ``sys.executable``; it is not a pytest module.
"""
from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from repro_torch.core import (PPOConfig, RLHFEngine, RLHFPipeline,
                              StageConfig)
from repro_torch.data import (ConstantTaskDataset, CopyTaskDataset,
                              DataBlender)
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import CheckpointManager, tree_sha256

DIE_EXIT_CODE = 37
V = 64
# head_dim 8 is below the kernels' smallest: the model's plain path
ACTOR = ModelConfig(name="a", arch_type="dense", n_layers=1, d_model=32,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=V,
                    compute_dtype="float32", remat=False, use_kernels=False)
CRITIC = ACTOR.replace(name="c")
# wall-time telemetry: differs run to run, excluded from bit-identity
WALL_TIME = ("gen_tok_s", "gen_s", "score_ms", "actor_ms", "critic_ms")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ppo-steps", type=int, default=3)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--die-at-iter", type=int, default=None)
    args = ap.parse_args()
    torch.set_num_threads(1)

    ds = [ConstantTaskDataset(200, 6, 6, V, seed=1),
          CopyTaskDataset(200, 6, 6, V, seed=2)]
    bl = DataBlender(ds, [0.7, 0.3], seed=0)
    eng = RLHFEngine(ACTOR, CRITIC, torch.Generator().manual_seed(0))
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    pipe = RLHFPipeline(
        eng, bl,
        StageConfig(sft_steps=2, sft_batch=4, rm_steps=2, rm_batch=4,
                    ppo_steps=args.ppo_steps, ppo_batch=4, seed=0),
        PPOConfig(max_new_tokens=4, temperature=1.0, ptx_coef=0.05),
        checkpointer=ckpt, save_every=args.save_every)

    if args.die_at_iter is not None:
        def die(i):
            if i == args.die_at_iter:
                if ckpt is not None:        # preemption grace window:
                    ckpt.wait_for_save()    # drain the in-flight write,
                os._exit(DIE_EXIT_CODE)     # then die hard (no atexit)
        pipe.iter_hook = die

    out = pipe.run()
    record = {
        "scores": out["ppo_scores"],
        "stage3": [{k: v for k, v in m.items() if k not in WALL_TIME}
                   for m in pipe.log["stage3"]],
        "actor_sha": tree_sha256(pipe.trainer.actor),
        "ema_sha": tree_sha256(pipe.trainer.ema),
        "critic_sha": tree_sha256(pipe.trainer.critic),
    }
    with open(args.out, "w") as f:
        json.dump(record, f, indent=1)


if __name__ == "__main__":
    sys.exit(main())
