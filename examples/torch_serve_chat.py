"""Streaming serving demo on the PyTorch port — the paper's inference API
on the stepwise request core, with per-request sampling parameters
(counterpart of ``examples/serve_chat.py``).

    PYTHONPATH=src python examples/torch_serve_chat.py [--slots 4] \\
        [--max-new 24] [--device cuda|cpu]

Builds a batch of byte-tokenized "Human: ... Assistant:" prompts where
every request carries its OWN sampling configuration (greedy next to
nucleus next to seeded next to top-k), submits them to an
:class:`repro_torch.serving.engine.EngineCore`, and streams tokens to the
terminal *as they decode* — the engine emits a ``StepEvent`` per request
at every chunk boundary.  All of the mixed configurations run through one
decode step per chunk (the sampling parameters are per-row tensors); the
port runs eagerly, so there are no compiled graphs to count.  Runs on CUDA
with the port's kernels; ``--device cpu`` runs their plain versions.
"""
import argparse
import sys
import time

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.data import ByteTokenizer
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.engine import (GenerationEngine, Request,
                                        SamplingParams)

CFG = ModelConfig(name="chat-demo", arch_type="dense", n_layers=4,
                  d_model=256, n_heads=8, n_kv_heads=4, d_ff=512,
                  vocab_size=259, compute_dtype="float32", remat=False)

QUESTIONS = [
    "Do you know Microsoft?",
    "Can you explain it to a 6-year-old?",
    "What is RLHF training?",
    "Write a haiku about GPUs.",
    "Why is generation memory bound?",
    "Which step dominates RLHF time?",
    "What does the hybrid engine do?",
    "How large can the actor be?",
]

# one batch, four sampling personalities, one decode step per chunk
PARAM_MIX = [
    ("greedy", SamplingParams(temperature=0.0)),
    ("nucleus t=0.7 p=0.9", SamplingParams(temperature=0.7, top_p=0.9)),
    ("top-k 40", SamplingParams(top_k=40)),
    ("seeded(7)", SamplingParams(seed=7)),
]


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=48)
    ap.add_argument("--max-new", type=int, default=24)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    gen = lambda seed: torch.Generator(device=device).manual_seed(seed)

    tok = ByteTokenizer()
    params = T.init_params(CFG, gen(0))
    engine = GenerationEngine(CFG, max_new_tokens=args.max_new,
                              temperature=args.temperature, chunk=8,
                              eos_id=tok.eos_id, device=device)
    reqs = []
    for i, q in enumerate(QUESTIONS):
        ids = tok.encode(f"Human: {q}\nAssistant:",
                         max_len=args.prompt_len)
        name, sp = PARAM_MIX[i % len(PARAM_MIX)]
        reqs.append((name, Request(uid=i, tokens=ids.astype(np.int32),
                                   max_new_tokens=args.max_new, params=sp)))

    S = args.prompt_len + args.max_new
    # warm-up at the serving shapes (first kernel builds, allocator)
    core = engine.core(params, gen(1), slots=args.slots, max_seq_len=S)
    core.add_request(Request(uid=-1, tokens=reqs[0][1].tokens,
                             max_new_tokens=4))
    t0 = time.perf_counter()
    while core.has_work():
        core.step()
    print(f"warm-up (first request): {time.perf_counter() - t0:.1f}s")

    core = engine.core(params, gen(2), slots=args.slots, max_seq_len=S)
    for _, r in reqs:
        core.add_request(r)
    stream_uid = 0                       # watch request 0 decode live
    print(f"[streaming uid={stream_uid} "
          f"({reqs[stream_uid][0]})] Human: {QUESTIONS[stream_uid]}")
    sys.stdout.write("Assistant (untrained, random bytes): ")
    texts = {r.uid: [] for _, r in reqs}
    n_tok = 0
    t0 = time.perf_counter()
    while core.has_work():
        for ev in core.step():
            texts[ev.uid].extend(ev.new_tokens.tolist())
            n_tok += ev.new_tokens.size
            if ev.uid == stream_uid and ev.new_tokens.size:
                sys.stdout.write(repr(tok.decode(ev.new_tokens))[1:-1])
                sys.stdout.flush()
    dt = time.perf_counter() - t0
    print(f"\nstreamed {n_tok} tokens from {len(reqs)} mixed-sampling "
          f"requests in {dt * 1000:.0f} ms  ({n_tok / dt:.0f} tok/s)")
    print(f"sampling configs served together: "
          f"{len(set(n for n, _ in reqs))} (eager decode, no compiled "
          f"graphs)")
    for i in range(min(2, len(reqs))):
        name = reqs[i][0]
        print(f"[{i}] ({name}) Human: {QUESTIONS[i]}")
        print(f"    Assistant: {tok.decode(texts[i])!r}")
    return {"tokens": n_tok, "texts": texts}


if __name__ == "__main__":
    main()
