"""Quickstart on the PyTorch port: the DeepSpeed-Chat single-script
experience, reduced to a coffee-break scale (paper §2.2's "train a toy
model over lunch"; counterpart of ``examples/quickstart.py``).

    PYTHONPATH=src python examples/torch_quickstart.py [--device cuda|cpu]

Runs all three InstructGPT steps on a tiny actor over synthetic learnable
tasks, then chats with the result through the inference API.  The actor's
head dimension (16) is below the CUDA kernels' smallest (32), so it runs
the model's plain path, on the card by default or with ``--device cpu``.
"""
import argparse

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core import PPOConfig, RLHFEngine, RLHFPipeline, StageConfig
from repro_torch.data import ConstantTaskDataset, CopyTaskDataset, DataBlender
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import GenerationEngine, Request

V = 64
ACTOR = ModelConfig(name="quickstart-actor", arch_type="dense", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=2, d_ff=128,
                    vocab_size=V, compute_dtype="float32", remat=False,
                    use_kernels=False)
CRITIC = ACTOR.replace(name="quickstart-critic")


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ds = [ConstantTaskDataset(500, 8, 8, V, seed=1),
          CopyTaskDataset(500, 8, 8, V, seed=2)]
    blender = DataBlender(ds, proportions=[0.7, 0.3], seed=0)
    engine = RLHFEngine(ACTOR, CRITIC,
                        torch.Generator(device=device).manual_seed(0))
    pipe = RLHFPipeline(
        engine, blender,
        StageConfig(sft_steps=60, sft_batch=16, rm_steps=50, rm_batch=16,
                    ppo_steps=12, ppo_batch=8),
        PPOConfig(max_new_tokens=8, ptx_coef=0.05))

    print("== Step 1: SFT ==")
    sft = pipe.run_sft()
    print(f"   loss {sft[0]:.3f} -> {sft[-1]:.3f}")
    print("== Step 2: Reward model ==")
    accs = pipe.run_reward()
    print(f"   pairwise acc {np.mean(accs[:5]):.2f} -> "
          f"{np.mean(accs[-5:]):.2f}")
    print("== Step 3: PPO (EMA + mixture training on) ==")
    scores = pipe.run_ppo()
    print(f"   reward {scores[0]:+.3f} -> {scores[-1]:+.3f}")

    print("== Inference API ==")
    engine = GenerationEngine(ACTOR, max_new_tokens=8, temperature=0.0,
                              chunk=4, device=device)
    reqs = [Request(uid=i, tokens=np.asarray(ds[0].get_prompt(i), np.int32))
            for i in range(4)]
    outs = {c.uid: c for c in engine.serve(
        pipe.e.actor_params, reqs,
        torch.Generator(device=device).manual_seed(1), slots=4)}
    for i in range(2):
        print(f"   prompt {np.asarray(reqs[i].tokens)} -> "
              f"{outs[i].tokens}  ({outs[i].finish_reason})")
    print("done.")
    return {"sft_loss": sft, "rm_acc": accs, "ppo_scores": scores,
            "completions": outs}


if __name__ == "__main__":
    main()
