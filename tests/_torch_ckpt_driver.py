"""Subprocess driver for the port's crash-injection checkpoint suite
(``tests/test_torch_ckpt_resume.py``) and its asynchronous soak suite
(``tests/test_torch_async_soak.py``), the counterpart of
``tests/_ckpt_driver.py`` and ``tests/_async_driver.py`` on
``repro_torch``.

Runs a tiny 3-stage RLHF pipeline on the CPU, stage 3 in one of three
modes (``--mode sync | lockstep | stale``), optionally with
fault-tolerant checkpointing, and, on success, writes a JSON record of
everything that must be bit-identical across modes and across crash and
resume:

- the per-iteration stage-3 metrics without the wall-time keys (and the
  async-only staleness and queue keys, which differ between modes by
  design),
- the PPO reward-score trajectory,
- SHA-256 hashes of the final actor, critic and EMA states,
- the replay queue's and publisher's stats (``async_stats``; empty in
  sync mode), for the backpressure checks.

Crash injection:

- ``--die-at-iter K`` exits hard (code 37) at the top of PPO iteration K
  after draining the in-flight write (a preemption with a grace window);
- ``REPRO_CKPT_FAULT=<event>:<n>`` (read by the CheckpointManager) exits
  hard (code 41) inside the background writer.

Soak injection (asynchronous modes):

- ``--slow-consumer-iters A:B`` sleeps ``--slow-ms`` at the top of PPO
  iterations [A, B) on the consumer thread (``iter_hook``): the producer
  outruns it and must meet the queue's backpressure;
- ``--slow-producer-iters A:B`` sleeps on the producer thread before those
  batches (``rollout_hook``): the consumer waits on an empty queue.

On a mesh (``--mesh DP,TP``, under ``torchrun`` with ``DP * TP`` ranks on
gloo) the pipeline runs through the Hybrid Engine, its checkpoints are
sharded, and rank 0 writes the record (the hashes are of the full
states, gathered).

``--lm ARGS...`` runs ``repro_torch.launch.train.main(ARGS)`` instead (the
LM loop, on a mesh under ``torchrun`` when ``ARGS`` holds ``--mesh``) and
records the SHA-256 of the state the loop starts from (the restored one
after ``--resume``), of the final state, and the losses.

It is launched with ``sys.executable`` or ``torchrun``; it is not a pytest
module.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

from repro_torch.core import (AsyncConfig, PPOConfig, RLHFEngine,
                              RLHFPipeline, StageConfig)
from repro_torch.data import (ConstantTaskDataset, CopyTaskDataset,
                              DataBlender)
from repro_torch.launch.mesh import init_distributed, mesh_from_spec
from repro_torch.models.config import ModelConfig
from repro_torch.training.checkpoint import CheckpointManager, tree_sha256

DIE_EXIT_CODE = 37
V = 64
# head_dim 8 is below the kernels' smallest: the model's plain path
ACTOR = ModelConfig(name="a", arch_type="dense", n_layers=1, d_model=32,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab_size=V,
                    compute_dtype="float32", remat=False, use_kernels=False)
CRITIC = ACTOR.replace(name="c")
# wall-time telemetry and the async-only staleness / queue keys: excluded
# from the bit-identity record
WALL_TIME = ("gen_tok_s", "gen_s", "score_ms", "actor_ms", "critic_ms",
             "publish_s", "publish_bytes", "queue_depth", "policy_lag",
             "is_ratio_mean", "is_ratio_max", "lockstep_fallback",
             "reshard_s")


def _async_cfg(args):
    if args.mode == "sync":
        return None
    if args.mode == "lockstep":
        return AsyncConfig.lockstep()
    return AsyncConfig(queue_depth=args.queue_depth, publish_every=1,
                       max_lag=args.max_lag)


def _span(spec):
    if not spec:
        return None
    a, b = spec.split(":")
    return int(a), int(b)


def _write(path, record) -> None:
    if int(os.environ.get("RANK", 0)) == 0:
        with open(path, "w") as f:
            json.dump(record, f, indent=1)


def run_lm(args) -> None:
    """The LM launcher on ``args.lm``, with the hash of the state its loop
    starts from."""
    from repro_torch.launch import train as tlaunch
    start = {}
    loop = tlaunch.train_lm

    def spy(cfg, state, **kw):
        start["sha"] = tree_sha256(state)      # a collective on a mesh
        return loop(cfg, state, **kw)
    tlaunch.train_lm = spy
    out = tlaunch.main(args.lm)
    _write(args.out, {"start_sha": start["sha"], "start": out["start"],
                      "state_sha256": out["state_sha256"],
                      "loss": out["loss"]})


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--out", required=True)
    ap.add_argument("--ppo-steps", type=int, default=3)
    ap.add_argument("--save-every", type=int, default=1)
    ap.add_argument("--die-at-iter", type=int, default=None)
    ap.add_argument("--mode", choices=("sync", "lockstep", "stale"),
                    default="sync")
    ap.add_argument("--queue-depth", type=int, default=2)
    ap.add_argument("--max-lag", type=int, default=1)
    ap.add_argument("--slow-consumer-iters", default=None)
    ap.add_argument("--slow-producer-iters", default=None)
    ap.add_argument("--slow-ms", type=int, default=150)
    ap.add_argument("--mesh", default=None, help="dp,tp")
    ap.add_argument("--lm", nargs=argparse.REMAINDER, default=None,
                    help="the LM launcher's arguments")
    return ap.parse_args(argv)


def main():
    args = parse()
    torch.set_num_threads(1)
    if args.lm is not None:
        return run_lm(args)
    _write(args.out, run(args))
    if args.mesh is not None:
        import torch.distributed as dist
        dist.destroy_process_group()


def run(args) -> dict:
    """The pipeline of ``args`` (on the ``--mesh`` given, joining the
    process group first); its record."""
    mesh = None
    if args.mesh is not None:
        init_distributed("cpu", timeout_s=60.0)
        mesh = mesh_from_spec(args.mesh)

    ds = [ConstantTaskDataset(200, 6, 6, V, seed=1),
          CopyTaskDataset(200, 6, 6, V, seed=2)]
    bl = DataBlender(ds, [0.7, 0.3], seed=0)
    eng = RLHFEngine(ACTOR, CRITIC, torch.Generator().manual_seed(0),
                     mesh=mesh)
    ckpt = CheckpointManager(args.ckpt_dir) if args.ckpt_dir else None
    pipe = RLHFPipeline(
        eng, bl,
        StageConfig(sft_steps=2, sft_batch=4, rm_steps=2, rm_batch=4,
                    ppo_steps=args.ppo_steps, ppo_batch=4, seed=0),
        PPOConfig(max_new_tokens=4, temperature=1.0, ptx_coef=0.05),
        checkpointer=ckpt, save_every=args.save_every,
        async_cfg=_async_cfg(args))

    slow_c = _span(args.slow_consumer_iters)
    slow_p = _span(args.slow_producer_iters)
    dt = args.slow_ms / 1000.0

    def consumer_hook(i):
        if slow_c and slow_c[0] <= i < slow_c[1]:
            time.sleep(dt)
        if i == args.die_at_iter:
            if ckpt is not None:        # preemption grace window:
                ckpt.wait_for_save()    # drain the in-flight write,
            os._exit(DIE_EXIT_CODE)     # then die hard (no atexit)

    if args.die_at_iter is not None or slow_c:
        pipe.iter_hook = consumer_hook
    if slow_p:
        def producer_hook(i):
            if slow_p[0] <= i < slow_p[1]:
                time.sleep(dt)
        pipe.rollout_hook = producer_hook

    out = pipe.run()
    return {
        "scores": out["ppo_scores"],
        "stage3": [{k: v for k, v in m.items() if k not in WALL_TIME}
                   for m in pipe.log["stage3"]],
        "actor_sha": tree_sha256(pipe.trainer.actor),
        "ema_sha": tree_sha256(pipe.trainer.ema),
        "critic_sha": tree_sha256(pipe.trainer.critic),
        "async_stats": pipe.async_stats,
    }


if __name__ == "__main__":
    sys.exit(main())
