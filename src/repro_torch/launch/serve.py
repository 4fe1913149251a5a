"""Serving launcher (counterpart of ``repro/launch/serve.py``, dense KV).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \\
        --requests 32 --ragged --prompt-len 256 --max-new 256 --batch 16

Drives the stepwise request-level core
(:class:`repro_torch.serving.engine.EngineCore`) behind
:class:`repro_torch.serving.engine.GenerationEngine` on the dense KV arena.
Both schedulers run the SAME drain loop and differ only in when requests
are fed to the core:

- ``--scheduler fixed``      batch-synchronous baseline: requests are fed
                             in slot-sized waves and a new wave is only
                             admitted once the previous wave fully drains
- ``--scheduler continuous`` everything is queued up front; freed slots
                             are refilled from the queue at chunk
                             boundaries (continuous batching)

``--requests`` is either a COUNT (synthetic workload; ``--ragged`` draws
variable prompt/response lengths) or a PATH to a JSONL file with one
request per line and per-request sampling fields::

    {"prompt": "Hello", "max_new_tokens": 16, "temperature": 0.7,
     "top_p": 0.9, "seed": 1}
    {"tokens": [1, 2, 3], "max_new_tokens": 8, "top_k": 40, "eos_id": 0}

``--chat`` drops into a toy conversation loop on one persistent core.

``--kv-quant`` stores the dense arena's K/V rows as int8 with per-(token,
kv-head) fp32 absmax scales; decode attention then runs the int8 kernel,
which dequantizes on the score and probability tiles.

Runs on CUDA; ``--device cpu`` runs on the CPU with the kernels' plain
versions.  Weights are random, drawn from ``--seed``.  The reference's
``--kv-layout paged``, ``--prefix-cache on``, ``--mesh`` and ``--ckpt``
are not ported yet and are refused.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import deque

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import ByteTokenizer
from repro_torch.models import transformer as T
from repro_torch.serving.engine import (GenerationEngine, Request,
                                        SamplingParams)


def build_requests(args, cfg, rng) -> list:
    """Synthetic workload: ``--requests N`` random prompts."""
    reqs = []
    for i in range(int(args.requests)):
        if args.ragged:
            lp = int(rng.integers(max(2, args.prompt_len // 4),
                                  args.prompt_len + 1))
            mn = int(rng.integers(max(1, args.max_new // 8),
                                  args.max_new + 1))
        else:
            lp, mn = args.prompt_len, args.max_new
        toks = rng.integers(0, cfg.vocab_size, size=lp).astype(np.int32)
        reqs.append(Request(uid=i, tokens=toks, max_new_tokens=mn))
    return reqs


def load_requests(path: str, cfg, tok: ByteTokenizer,
                  default_max_new: int) -> list:
    """JSONL workload: one request per line, ``prompt`` (text) or
    ``tokens`` (id list) plus optional ``max_new_tokens`` and per-request
    sampling fields (``temperature``, ``top_k``, ``top_p``, ``seed``,
    ``eos_id``)."""
    reqs = []
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            d = json.loads(line)
            if "tokens" in d:
                toks = np.clip(np.asarray(d["tokens"], np.int32), 0,
                               cfg.vocab_size - 1)
            else:
                toks = np.minimum(tok.encode(d["prompt"]),
                                  cfg.vocab_size - 1)
            sp = SamplingParams(
                temperature=d.get("temperature"),
                top_k=d.get("top_k"),
                top_p=d.get("top_p"),
                seed=d.get("seed"),
                **({"eos_id": d["eos_id"]} if "eos_id" in d else {}))
            reqs.append(Request(
                uid=d.get("uid", i), tokens=toks,
                max_new_tokens=d.get("max_new_tokens", default_max_new),
                params=sp))
    return reqs


def run_schedule(engine, params, reqs, generator, *, mode: str, slots: int,
                 max_seq_len: int):
    """The one drain loop both schedulers share: feed the core, step it,
    count finished tokens from the event stream.  ``continuous`` queues
    every request up front; ``fixed`` feeds slot-sized waves and starts
    the next wave only when the core goes idle.  Returns (finished tokens,
    core stats, seconds, completions {uid: tokens})."""
    core = engine.core(params, generator, slots=slots,
                       max_seq_len=max_seq_len)
    pending = deque(reqs)
    streams: dict = {}
    finished: dict = {}
    done_tokens = 0
    t0 = time.perf_counter()
    while pending or core.has_work():
        if mode == "continuous":
            while pending:
                core.add_request(pending.popleft())
        elif not core.has_work():
            for _ in range(min(slots, len(pending))):
                core.add_request(pending.popleft())
        for ev in core.step():
            streams.setdefault(ev.uid, []).extend(ev.new_tokens.tolist())
            if ev.finished:
                finished[ev.uid] = streams.pop(ev.uid)
                done_tokens += len(finished[ev.uid])
    if engine.device.type == "cuda":
        torch.cuda.synchronize(engine.device)
    return done_tokens, core.stats(), time.perf_counter() - t0, finished


def chat_loop(engine, params, tok: ByteTokenizer, args) -> None:
    """Toy conversation loop streaming tokens from ONE persistent core:
    each turn's prompt is the whole conversation so far plus the new line.
    When the conversation outgrows the KV geometry the context is cleared.
    Replies stop at the byte tokenizer's EOS unless ``--eos-id`` overrides
    it."""
    print("chat mode — empty line to exit")
    S = 4 * (args.prompt_len + args.max_new)
    eos = (args.eos_id if args.eos_id is not None
           else min(tok.eos_id, engine.cfg.vocab_size - 1))
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    core = engine.core(params, gen, slots=1, max_seq_len=S)
    history = np.zeros((0,), np.int32)
    turn = 0
    while True:
        try:
            text = input("Human: ")
        except EOFError:
            break
        if not text.strip():
            break
        ids = np.minimum(tok.encode(text, max_len=args.prompt_len),
                         engine.cfg.vocab_size - 1).astype(np.int32)
        prompt = np.concatenate([history, ids])
        if len(prompt) + args.max_new > core.S:  # context full: reset
            print("[context full — clearing conversation]")
            history = np.zeros((0,), np.int32)
            prompt = ids
        core.add_request(Request(uid=turn, tokens=prompt,
                                 max_new_tokens=args.max_new,
                                 params=SamplingParams(eos_id=eos)))
        print("Assistant: ", end="", flush=True)
        reply: list = []
        while core.has_work():
            for ev in core.step():
                if ev.new_tokens.size:
                    reply.extend(ev.new_tokens.tolist())
                    sys.stdout.write(tok.decode(ev.new_tokens))
                    sys.stdout.flush()
        print()
        history = np.concatenate([prompt, np.asarray(reply, np.int32)])
        turn += 1


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", required=True)
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda runs the CUDA kernels; cpu runs their plain "
                         "versions")
    ap.add_argument("--scheduler", choices=["fixed", "continuous"],
                    default="continuous")
    ap.add_argument("--requests", default="16",
                    help="request COUNT (synthetic workload) or PATH to "
                         "a JSONL file with per-request sampling fields")
    ap.add_argument("--batch", type=int, default=4,
                    help="fixed-scheduler wave size / continuous slots")
    ap.add_argument("--ragged", action="store_true")
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=32)
    ap.add_argument("--chunk", type=int, default=8)
    ap.add_argument("--kv-layout", choices=["dense", "paged"],
                    default="dense")
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--num-blocks", type=int, default=None)
    ap.add_argument("--watermark", type=int, default=None)
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache: K/V rows stored as int8 with "
                         "per-(token, kv-head) fp32 absmax scales")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="off")
    ap.add_argument("--mesh", default=None)
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--chat", action="store_true")
    return ap


def main(argv=None) -> dict:
    """Parse ``argv``, serve the workload, print the summary line and
    return it as a dict (tokens, seconds, tok_s, slot_util, stats)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    for flag, refused in (("--kv-layout paged", args.kv_layout == "paged"),
                          ("--prefix-cache on", args.prefix_cache == "on"),
                          ("--mesh", args.mesh is not None),
                          ("--ckpt", args.ckpt is not None)):
        if refused:
            ap.error(f"{flag}: not yet ported")
    if args.num_blocks is not None or args.watermark is not None:
        ap.error("--num-blocks/--watermark require --kv-layout paged")
    try:
        device = resolve_device(args.device)
    except RuntimeError as e:
        ap.error(str(e))

    cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=True)
    gen = torch.Generator(device=device).manual_seed(args.seed)
    params = T.init_params(cfg, gen)

    tok = ByteTokenizer()
    engine = GenerationEngine(cfg, max_new_tokens=args.max_new,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              eos_id=args.eos_id, chunk=args.chunk,
                              device=device)
    if args.chat:
        chat_loop(engine, params, tok, args)
        return {}

    rng = np.random.default_rng(args.seed)
    if str(args.requests).isdigit():
        reqs = build_requests(args, cfg, rng)
    else:
        reqs = load_requests(args.requests, cfg, tok, args.max_new)
    # warm-up on a prefix of the queue, at the measured shapes (first
    # kernel builds, cuBLAS heuristics, allocator growth)
    S = max(len(r.tokens) + engine.resolve(r)[3] for r in reqs)
    warm = reqs[:min(len(reqs), args.batch)]
    sched_kw = dict(mode=args.scheduler, slots=args.batch, max_seq_len=S)
    run_schedule(engine, params, warm,
                 torch.Generator(device=device).manual_seed(args.seed),
                 **sched_kw)
    n_tok, stats, dt, finished = run_schedule(
        engine, params, reqs,
        torch.Generator(device=device).manual_seed(args.seed + 1),
        **sched_kw)
    util = n_tok / max(stats["scheduled_tokens"], 1)
    kv = args.kv_layout + ("-int8" if args.kv_quant else "")
    print(f"scheduler={args.scheduler}  kv={kv}  "
          f"requests={len(reqs)}  "
          f"generated {n_tok} tokens in {dt:.3f}s  ({n_tok / dt:.1f} tok/s, "
          f"slot utilization {util:.1%})")
    return {"tokens": n_tok, "seconds": dt, "tok_s": n_tok / dt,
            "slot_util": util, "stats": stats, "requests": reqs,
            "completions": finished}


if __name__ == "__main__":
    main()
