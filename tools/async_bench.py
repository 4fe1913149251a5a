"""Synchronous against one-step-stale asynchronous stage 3 on one card.

    python3 tools/async_bench.py [--iters 4] [--max-new 256]

The RLHF cell of ``chip_smoke.py``'s phase ``async`` (OPT-1.3B actor and
reference, OPT-350M critic and reward model, random weights from seed 0,
bf16 on fp32 masters, 8 x 256 prompts, ptx 0.05, EMA on, temperature 1.0):
``--iters`` PPO iterations at ``--max-new`` new tokens, run four times
from copies of one start, in turns, synchronous, asynchronous
(``AsyncConfig(publish_every=2, max_lag=1)``), asynchronous, synchronous,
each leg through ``chip_smoke._async_leg`` (the same generator seed, the
same data).  Prints, per leg, stage 3's seconds, each iteration's wall
time and phase times (generation, scoring, actor and critic steps), the
queue's waits, the peak memory, and a JSON line per leg; before them the
card's ``name, power.limit``.  The asynchronous legs must report
``policy_lag`` 0, 1, 0, 1, ...; any failure exits non-zero.  Needs a CUDA
card.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts ROOT / "src" on the path)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=256)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("async_bench: CUDA is not available", file=sys.stderr)
        return 1
    from repro_torch.configs import get_config
    from repro_torch.core import AsyncConfig, PPOConfig, RLHFEngine, StageConfig
    from repro_torch.core.pipeline import clone_params
    from repro_torch.kernels import build
    from repro_torch.launch.train import lm_data

    print(cs.nvidia_smi_line(), flush=True)
    build.build()
    actor, critic = get_config("opt-1.3b"), get_config("opt-350m")
    bl = lm_data(actor, 512, 0)
    eng = RLHFEngine(actor, critic,
                     torch.Generator(device="cuda").manual_seed(0))
    start = (eng.actor_params, eng.critic_params)
    eng.ref_params = clone_params(eng.actor_params)
    eng.reward_params = clone_params(eng.critic_params)
    ppo = PPOConfig(max_new_tokens=args.max_new, temperature=1.0,
                    ptx_coef=0.05, use_ema=True)
    stages = StageConfig(ppo_steps=args.iters, ppo_batch=8)
    stale = AsyncConfig(publish_every=2, max_lag=1)
    want_lags = [float(i % 2) for i in range(args.iters)]
    rows, failures = [], []
    for n, mode in enumerate(("sync", "stale", "stale", "sync")):
        t0 = time.perf_counter()
        leg = cs._async_leg(f"{mode}#{n}", eng,
                            tuple(clone_params(t) for t in start), bl,
                            stages, ppo, None if mode == "sync" else stale)
        leg.pop("final")
        log = leg["log"]
        row = {"leg": n, "mode": mode, "stage3_s": leg["stage3_s"],
               "leg_s": time.perf_counter() - t0,
               "wall_s": leg["wall_s"],
               "mean_wall_s": statistics.mean(leg["wall_s"]),
               **{k: [m[k] for m in log] for k in (
                   "gen_s", "score_ms", "actor_ms", "critic_ms")},
               "peak_gib": leg["peak"] / 2**30,
               "launches": leg["launches"]}
        if mode == "stale":
            a = leg["async"]
            row.update(policy_lag=[m["policy_lag"] for m in log],
                       put_wait_s=a["queue"]["put_wait_s"],
                       get_wait_s=a["queue"]["get_wait_s"],
                       publish_s=a["publisher"]["total_publish_s"],
                       retained_gb=a["retained_bytes"] / 1e9)
            if row["policy_lag"] != want_lags:
                failures.append(f"leg {n}: policy_lag {row['policy_lag']}")
        rows.append(row)
        print(json.dumps(row), flush=True)
        del leg
        torch.cuda.empty_cache()
    for mode in ("sync", "stale"):
        s = [r["stage3_s"] for r in rows if r["mode"] == mode]
        cs.log(f"[async_bench] {mode}: stage 3 {s[0]:.2f} / {s[1]:.2f} s "
               f"for {args.iters} iterations at {args.max_new} new tokens")
    if failures:
        print("async_bench: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
