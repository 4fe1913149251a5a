"""Serving launcher (counterpart of ``repro/launch/serve.py``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch opt-1.3b \\
        --requests 32 --ragged --prompt-len 256 --max-new 256 --batch 16

Drives the stepwise request-level core
(:class:`repro_torch.serving.engine.EngineCore`) behind
:class:`repro_torch.serving.engine.GenerationEngine`, on the dense KV arena
or (``--kv-layout paged``) on a shared block pool.
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

``--kv-quant`` stores the K/V rows (arena or pool) as int8 with
per-(token, kv-head) fp32 absmax scales; decode attention then runs the
int8 kernel, which dequantizes on the score and probability tiles.

``--kv-layout paged`` serves from a pool of ``--block-size``-token blocks
(``--num-blocks`` incl. the trash block, default: dense-arena parity;
``--watermark`` free blocks kept at admission, default: one chunk of
appends per running slot); ``--prefix-cache on`` adds prefix-aware block
reuse.  The summary line then reports the pool (and cache) statistics.

``--arch mamba2-370m`` (SSM) and ``--arch zamba2-1.2b`` (hybrid) serve on
the dense layout only: admission prefills each prompt at its exact length
into the slot's recurrent state (and, for the hybrid's attention layers,
its arena rows); ``--kv-layout paged`` raises ``NotImplementedError`` for
them, as in the reference.  ``--kv-quant`` makes only the hybrid's
attention K/V rows int8 (the reference's rule), so Zamba2 decodes through
the int8 kernel; Mamba2 has no K/V rows and serves as without it.

``--arch deepseek-v2-lite-16b`` (MLA + MoE) serves on the dense layout: its
arena holds the latents ``ckv`` and ``krope``, the prompt's attention runs
the flash kernel at head dim 192 and decode the absorbed form (plain
products); ``--kv-layout paged`` raises ``NotImplementedError``, and
``--kv-quant`` leaves the latents in the compute dtype, as in the
reference.  ``--arch llama-3.2-vision-11b`` and ``--arch musicgen-medium``
take encoder or frame embeddings, which a request does not carry: the
request core refuses them with the reference's ``NotImplementedError``
(the VLM generates through ``GenerationEngine.generate(...,
encoder_embeds=)``, the audio decoder through ``serving.generate``'s
``prefill`` / ``decode_step`` with ``embeds``).

The launcher's own weights are held in the compute dtype only, drawn in
fp32 and rounded leaf by leaf.

``--ckpt PATH`` serves the params of a ``.npz`` export (``launch.train
--ckpt``, either package's ``checkpoint.save``) in place of random
weights, which are otherwise drawn from ``--seed``.

``--mesh dp,tp`` serves on a ``("data", "model")`` mesh of ``dp * tp``
ranks, one process a device under ``torchrun`` (gloo with ``--device
cpu``, NCCL with one GPU a rank on CUDA; a single process without
``torchrun`` is a one-rank group, enough for ``--mesh 1,1``)::

    PYTHONPATH=src torchrun --standalone --nproc-per-node 2 \\
        -m repro_torch.launch.serve --device cpu --arch smollm-135m \\
        --reduced --mesh 2,1 --requests 8 --ragged --max-new 8

The params (``--ckpt`` loads, then places) are placed in the ``tp``
layout, as the reference's launcher places them, and served through one
mesh-wide request core (:meth:`GenerationEngine.core`): ``--batch`` slots
and ``--num-blocks`` mean what they mean on one device, the dense arena
holds a data rank's share of the slots and every rank its kv heads, and
every rank takes the same host decisions.  Rank 0 alone prints ``mesh=...
params=tp layout`` and the summary line, whose tokens, slot utilization
and pool statistics are the one-device run's.  ``--chat`` on a mesh: rank
0 reads each line and sends it to every rank, which drive the same
persistent core.

Runs on CUDA; ``--device cpu`` runs on the CPU with the kernels' plain
versions.
"""
from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
from collections import deque

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.configs import get_config, reduced
from repro_torch.data import ByteTokenizer
from repro_torch.launch.mesh import init_distributed, mesh_from_spec
from repro_torch.models import transformer as T
from repro_torch.models.modules import ParamSpec, tree_map
from repro_torch.serving.engine import (GenerationEngine, Request,
                                        SamplingParams)
from repro_torch.sharding import runtime, strategy
from repro_torch.training import checkpoint


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
                 max_seq_len: int, num_blocks=None, watermark=None):
    """The one drain loop both schedulers share: feed the core, step it,
    count finished tokens from the event stream.  ``continuous`` queues
    every request up front; ``fixed`` feeds slot-sized waves and starts
    the next wave only when the core goes idle.  Returns (finished tokens,
    core stats, seconds, completions {uid: tokens})."""
    core = engine.core(params, generator, slots=slots,
                       max_seq_len=max_seq_len, num_blocks=num_blocks,
                       watermark=watermark)
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
            if ev.preempted:                   # generated again from scratch
                streams[ev.uid] = []
                continue
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
    it.  On a mesh rank 0 reads each line and broadcasts it, so every rank
    drives the core alike."""
    print("chat mode — empty line to exit")
    S = 4 * (args.prompt_len + args.max_new)
    eos = (args.eos_id if args.eos_id is not None
           else min(tok.eos_id, engine.cfg.vocab_size - 1))
    gen = torch.Generator(device=engine.device).manual_seed(args.seed)
    core = engine.core(params, gen, slots=1, max_seq_len=S)
    history = np.zeros((0,), np.int32)
    turn = 0
    while True:
        text = _read_line(engine.mesh)
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


def _read_line(mesh) -> str:
    """The next ``Human:`` line ("" at the end of the input); on a mesh
    rank 0 reads it and every rank gets it."""
    line = [""]
    if mesh is None or dist.get_rank() == 0:
        try:
            line[0] = input("Human: ")
        except EOFError:
            pass
    if mesh is not None:
        dist.broadcast_object_list(line, src=0)
    return line[0]


def mesh_spec(text: str) -> str:
    """A ``--mesh`` value: ``dp,tp``, two sizes >= 1."""
    parts = text.split(",")
    if len(parts) != 2 or not all(p.isdigit() and int(p) >= 1
                                  for p in parts):
        raise argparse.ArgumentTypeError(
            f"expects 'dp,tp', two sizes >= 1 (got {text!r})")
    return text


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
                    default="dense",
                    help="KV layout behind the core: fixed arena or "
                         "block-pooled paged cache")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: tokens per KV block")
    ap.add_argument("--num-blocks", type=int, default=None,
                    help="paged: pool size in blocks incl. the trash "
                         "block (default: dense-arena parity)")
    ap.add_argument("--watermark", type=int, default=None,
                    help="paged: free blocks reserved at admission "
                         "(default: one chunk of appends per running slot)")
    ap.add_argument("--kv-quant", action="store_true",
                    help="int8 KV cache: K/V rows stored as int8 with "
                         "per-(token, kv-head) fp32 absmax scales")
    ap.add_argument("--prefix-cache", choices=["on", "off"], default="off",
                    help="paged: prefix-aware block reuse (cached prompt "
                         "prefixes are mapped, only the suffix prefilled)")
    ap.add_argument("--mesh", type=mesh_spec, default=None,
                    help="dp,tp: serve on a (data, model) mesh of dp * tp "
                         "ranks, one process a device under torchrun, "
                         "params in the tp layout")
    ap.add_argument("--temperature", type=float, default=0.8)
    ap.add_argument("--top-k", type=int, default=40)
    ap.add_argument("--top-p", type=float, default=1.0)
    ap.add_argument("--eos-id", type=int, default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--chat", action="store_true")
    return ap


def main(argv=None, params=None, warmup: bool = True, cfg=None) -> dict:
    """Parse ``argv``, serve the workload, print the summary line and
    return it as a dict (tokens, seconds, tok_s, slot_util, stats, the
    requests, their completions and ``load_s``, the seconds of the
    ``--ckpt`` load).  ``params``, when given, are served in place of
    random weights or ``--ckpt``.  ``warmup=False`` skips the warm-up run,
    for a caller that has just served the same shapes in this process.
    ``cfg``, when given, is served in place of ``--arch``'s config (e.g.
    cut in depth, for a model one card cannot hold whole)."""
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.mesh is None:
        return _main(ap, args, params, warmup, cfg)
    if args.device == "cuda" and not torch.cuda.is_available():
        ap.error("CUDA is not available; pass --device cpu to run on the "
                 "CPU with the kernels' plain versions")
    owned = not dist.is_initialized()
    device = init_distributed(args.device)
    try:
        dp, tp = (int(x) for x in args.mesh.split(","))
        if dist.get_world_size() != dp * tp:
            ap.error(f"--mesh {args.mesh} takes {dp * tp} ranks, the group "
                     f"has {dist.get_world_size()}")
        mesh = mesh_from_spec(args.mesh)
        quiet = dist.get_rank() != 0
        with contextlib.redirect_stdout(io.StringIO()) if quiet \
                else contextlib.nullcontext():
            return _main(ap, args, params, warmup, cfg, mesh=mesh,
                         device=device)
    finally:
        if owned:
            dist.destroy_process_group()


def _main(ap, args, params, warmup, cfg, mesh=None, device=None) -> dict:
    if params is not None and args.ckpt:
        ap.error("--ckpt and params= are two sources of weights")
    if args.kv_layout == "dense" and (args.num_blocks is not None
                                      or args.watermark is not None):
        ap.error("--num-blocks/--watermark require --kv-layout paged")
    if args.prefix_cache == "on" and args.kv_layout != "paged":
        ap.error("--prefix-cache on requires --kv-layout paged")
    if device is None:
        try:
            device = resolve_device(args.device)
        except RuntimeError as e:
            ap.error(str(e))

    if cfg is None:
        cfg = get_config(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    if args.kv_quant:
        cfg = cfg.replace(kv_quant=True)
    load_s = None
    # the launcher's own weights are held in the compute dtype only: the
    # engine would cast an fp32 tree and serve that copy, and the fp32 tree
    # beside it would cost 4 more bytes a parameter
    if params is None and args.ckpt:
        t0 = time.perf_counter()
        target = tree_map(
            lambda sp: checkpoint.Like(tuple(sp.shape), cfg.pdtype,
                                       torch.device(device)),
            T.param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))
        params = T.cast_params(cfg, checkpoint.load(args.ckpt, target))
        load_s = time.perf_counter() - t0
        print("loaded", args.ckpt)
    elif params is None:
        params = T.init_params(
            cfg, torch.Generator(device=device).manual_seed(args.seed),
            cfg.cdtype)
    if mesh is not None:
        params = runtime.place_tree(
            params, strategy.param_shardings(cfg, mesh, "tp"))
        print(f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} "
              f"params=tp layout")

    tok = ByteTokenizer()
    engine = GenerationEngine(cfg, max_new_tokens=args.max_new,
                              temperature=args.temperature,
                              top_k=args.top_k, top_p=args.top_p,
                              eos_id=args.eos_id, chunk=args.chunk,
                              kv_layout=args.kv_layout,
                              block_size=args.block_size,
                              prefix_cache=args.prefix_cache == "on",
                              mesh=mesh, device=device)
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
    sched_kw = dict(mode=args.scheduler, slots=args.batch, max_seq_len=S,
                    num_blocks=args.num_blocks, watermark=args.watermark)
    if warmup:
        run_schedule(engine, params, warm,
                     torch.Generator(device=device).manual_seed(args.seed),
                     **sched_kw)
    n_tok, stats, dt, finished = run_schedule(
        engine, params, reqs,
        torch.Generator(device=device).manual_seed(args.seed + 1),
        **sched_kw)
    util = n_tok / max(stats["scheduled_tokens"], 1)
    kv = args.kv_layout + ("-int8" if args.kv_quant else "")
    extra = ""
    if args.kv_layout == "paged":
        extra = (f"  [paged: blocks={stats['num_blocks']} "
                 f"hwm={stats['block_high_water']} "
                 f"preempt={stats['preemptions']} "
                 f"mean_conc={stats['mean_concurrency']:.1f}]")
        if args.prefix_cache == "on":
            extra += (
                f"  [prefix-cache: hit_rate={stats['prefill_hit_rate']:.1%}"
                f" cached_tokens={stats['cached_prefill_tokens']}"
                f" computed_tokens={stats['computed_prefill_tokens']}"
                f" evictions={stats['cache_evictions']}"
                f" cached_blocks={stats['cached_blocks']}]")
    print(f"scheduler={args.scheduler}  kv={kv}  "
          f"requests={len(reqs)}  "
          f"generated {n_tok} tokens in {dt:.3f}s  ({n_tok / dt:.1f} tok/s, "
          f"slot utilization {util:.1%}){extra}")
    return {"tokens": n_tok, "seconds": dt, "tok_s": n_tok / dt,
            "slot_util": util, "stats": stats, "requests": reqs,
            "completions": finished, "load_s": load_s}


if __name__ == "__main__":
    main()
