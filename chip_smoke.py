#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases build,kernels

Phases (any failure raises, so the run exits non-zero):

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions.
2. ``build``   — every CUDA source of the port built with ``nvcc``, one
   process per source, all in parallel; seconds and ``ptxas`` registers
   and spills per kernel.  Fails if a bf16 tensor-core flash
   kernel at D = 64 or D = 192, a decode split or combine kernel with bf16
   queries at D = 64 (fp and int8 rows) or a bf16 tensor-core SSD kernel
   spills.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the main paths' shapes (OPT-1.3B, OPT-350M and smollm-135m widths),
   in fp32 (TF32 off) and bf16, with kernel / plain / library device times
   (medians of CUDA-graph replays timed with CUDA events) and each shape's
   lower bound on time (RMSNorm also at the SFT and reward steps' 4,096
   and 8,192 rows, with ``floor_ms``, the time of ``x.clone()`` on the
   same bytes); the flash forward's LSE against the plain LSE, and
   the flash backward (dq, dk, dv) against its plain version at the
   training shapes (OPT-1.3B: B=8, H=32, L=512), with the backward of
   ``F.scaled_dot_product_attention`` (fwd+bwd less fwd) as its yardstick,
   its dK/dV and dQ kernels also timed apart, and the fp32 backward held
   to exactly 0.  Flash rows print the achieved TFLOP/s (the bound's
   operations over the kernel time).
4. ``parity``  — OPT-1.3B at full width and depth in fp32, random weights:
   one teacher-forced token stream (prefill 256 + 32 decode steps) through
   the kernel path and the plain path; max |dlogits| / max |logits|.
5. ``serve``   — ``repro_torch.launch.serve`` at OPT-1.3B in bf16: 32
   ragged requests (prompts up to 256, up to 64 new tokens:
   ``REPEAT_NEW``), 16 slots, chunk 8, continuous batching, default
   sampling.  Launch counts are set to 0 just before and read just after;
   every kernel must have launched.  The workload's repeats (here, in
   phases ``ssm``, ``ssm_train``, ``gqa128`` and ``moe``) generate as
   many.  Then a short greedy run at smollm-135m full width.
6. ``train``   — (a) OPT-1.3B at full width, cut to 4 layers, fp32 (TF32
   off): one LM step's loss and grads through the kernels against the
   plain path (loss to 1e-5 relative, every grad leaf to 1e-4 of its
   max |grad|); (b) ``repro_torch.launch.train`` at OPT-1.3B, full width
   and depth, bf16: 10 SFT steps of 8 x 512 tokens, every loss finite and
   the last below the first, with launch counts set to 0 just before and
   read just after (RMSNorm, flash forward and flash backward must all
   have launched); (c) 5 reward-model steps at OPT-350M, full width
   and depth, on ``DataBlender.reward_batches(8, ...)`` at seq 512.
7. ``rlhf``    — the 3-stage pipeline (``repro_torch.core.RLHFPipeline``)
   at full width and depth: OPT-1.3B actor and reference, OPT-350M critic
   and reward model, bf16 compute on fp32 masters, the copy + sort blend
   at 256 prompt + 256 response tokens, batch 8.  4 SFT steps, 4 RM steps,
   2 PPO iterations generating 256 tokens on an int8 KV cache (ptx 0.05,
   EMA on), then 1 iteration with a bf16 KV cache on the same trainer, at
   64 new tokens (``REPEAT_NEW``; phase ``async`` decodes 256 on it).
   Per iteration: generation s and tok/s, scoring ms, actor and critic
   step ms, ratio_mean, approx_kl, reward score, peak memory and launches
   per kernel.  Fails unless every number is finite, the first ratio_mean
   is 1 to 1e-3, the reference and reward checksums are unchanged by stage
   3, and the int8 iterations launched the int8 decode kernel and never
   the bf16 one (the bf16 iteration the reverse).
8. ``async``   — asynchronous stage 3 at the RLHF cell's full width and
   depth (phase ``rlhf``'s models and recipe, random weights, the
   reference and reward model copies of the start): 3 PPO iterations at
   64 new tokens (temperature 1.0), synchronous and under
   ``AsyncConfig.lockstep()`` from one state and one generator seed:
   sequences, metrics without the wall-time keys and the final actor,
   critic and EMA params bit for bit, and each consumed item's generator
   state equal to the synchronous loop's after that iteration; 4
   iterations under ``AsyncConfig(publish_every=2, max_lag=1)`` at 256
   new tokens: ``policy_lag`` exactly 0, 1, 0, 1, ``is_ratio_mean`` and
   ``is_ratio_max`` exactly 1.0 at lag 0 and finite and positive at lag
   1, ``produced`` 4, ``puts == gets + dropped + depth``, RMSNorm, both
   flash kernels and the dense decode kernel launched (per iteration:
   wall, gen, scoring, actor and critic times and the queue's waits; the
   publish seconds, retained bytes and peak memory); ``launch.train
   --rlhf --async-rlhf --max-lag 1`` at OPT-125M (2 steps a stage): its
   ``async`` summary, ``produced`` equal to the PPO steps.
9. ``disagg``  — the disaggregated split at ``1 | 1`` on the one card:
   ``torchrun --nproc-per-node 2 chip_smoke.py --disagg-worker`` (rank 0
   the rollout mesh, rank 1 the training mesh; the default group gloo for
   host tensors and NCCL for CUDA tensors, the bridge gloo through pinned
   host memory), at the RLHF cell's full width and depth (phase
   ``async``'s models, weights, blend and recipe): 3 iterations
   synchronous over the split and 3 under ``AsyncConfig.lockstep()``
   at 64 new tokens, each equal to phase ``async``'s one-device
   synchronous run bit for bit (every scored batch, the metrics without
   the wall-time keys, the final actor, critic and EMA by an exact
   fingerprint); 4 one-step-stale iterations at 256 new tokens, lags
   exactly 0, 1, 0, 1; RMSNorm, the flash forward and the dense decode
   kernel launched on the rollout rank and RMSNorm and both flash kernels
   on the training rank in every leg; then ``launch.train --rlhf
   --rollout-mesh 1 --train-mesh 1 --async-rlhf --kv-quant`` at OPT-125M
   in that world: its ``async`` summary, the int8 decode kernel (never the
   dense one) on the rollout rank.  Per leg and rank: each iteration's
   wall, generation, scoring and step times, the publish seconds, bytes
   and GB/s over the bridge, the queue's waits and each process's peak
   memory.
10. ``hybrid``  — the Hybrid Engine on a one-rank NCCL group (a
   ``FileStore`` in a temporary directory; no gloo fallback) and
   ``mesh_from_spec("1,1")``: ``to_inference`` / ``to_train`` on OPT-1.3B's
   fp32 params at full size (bitwise roundtrip, 0 bytes gathered and
   freed, seconds > 0; the analytic reshard and naive-gather bytes at dp
   2, 4 and 8 printed as bytes, not times); OPT-1.3B SFT (8 x 512, bf16 on
   fp32 masters), 3 steps of ``make_sharded_lm_step(cfg, mesh, "zero3",
   zero=1)`` against 3 of ``lm_train_step`` from the same state (losses,
   grad norms and params bit for bit; median step ms and peak GiB of
   both); PPO with ``engine=HybridEngine`` against ``engine=None``
   (OPT-1.3B actor, OPT-350M critic, 8 x 256 prompts, 64 greedy new
   tokens; one iteration on the dense bf16 arena, one on the request path
   with int8 KV on the paged pool): identical tokens, actor and critic
   params bit for bit, ``reshard_bytes`` 0 and ``reshard_s`` > 0, the
   launches of RMSNorm, both flash kernels, the dense decode and the
   paged int8 decode; PPO's scoring (``make_experience``) and one actor
   and critic step on the mesh path (compute views, the tensor-parallel
   context of a one-rank model group, ``zero3`` + ZeRO-1 states) against
   the plain path at OPT-1.3B / OPT-350M: bit for bit; last, kernel rows
   2-7 at the head counts one rank of a 2- and 4-way ``model`` axis
   launches (OPT-1.3B 16 and 8 heads at D 64, qwen3-8b 16
   / 4 and 8 / 2 at D 128) against their plain versions at phase
   ``gqa128``'s tolerances, timed (``tp`` in the ``kernels`` line).
11. ``serve_mesh`` — the launchers and the request core on a mesh at
   1 x 1.  Two ``torchrun --nproc-per-node 1`` runs start first and run
   beside the rest of the phase: ``-m repro_torch.launch.train --arch
   opt-125m --mesh 1,1 --strategy tp --zero 1`` (5 steps of 8 x 512): exit
   0, a falling loss, its losses equal to the plain launcher's run in this
   process to 1e-4; and (a) ``-m repro_torch.launch.serve --mesh 1,1``
   with phase ``serve``'s 32-request workload and seed (OPT-1.3B, full
   size, bf16): exit 0, and its summary's generated tokens and slot
   utilization equal the plain launcher's (phase ``serve``'s run, or one
   here), both tok/s printed (the mesh run's beside this process's work);
   (b) on a one-rank NCCL group, the launcher with ``--mesh 1,1``
   in this process on phase ``serve``'s greedy preempting case with int8
   KV (OPT-1.3B, the paged pool of 121 blocks): every completion by uid
   and every stat (preemptions, block high water, mean concurrency) equal
   to the plain launcher's run, at least one preemption, the paged int8
   kernel launched and no dense decode kernel; (c) deepseek-v2-lite at
   full width cut to 4 layers, bf16: greedy ``generate`` (4 x 64 + 16) and
   the request core (8 ragged requests, 4 slots, 16 new) through the mesh
   path beside the plain one, identical tokens, stats equal, RMSNorm and
   the flash forward launched on the mesh path.

12. ``ssm``     — the SSM / hybrid serving slice: ``ssd_intra_fwd`` (the
   Mamba2 SSD intra-chunk pass) against its plain version at Mamba2-370M
   (q = 256, a ragged 137, one token, four chunks, the fixed path's b = 8)
   and Zamba2-1.2B widths in fp32 (the CUDA-core kernel) and bf16 (the
   tensor-core kernel), timed, each beside two bounds (the fp32 rate's
   and the tensor cores'), plus an untimed case in each dtype whose upper
   triangle overflows; Mamba2-370M and Zamba2-1.2B at full
   width and depth in fp32, teacher-forced through the kernel path and the
   plain path (prefills of 256 and 600 tokens, then 32 decode steps; 1e-4);
   ``launch.serve`` on both in bf16 with the serve phase's 32-request
   workload at 64 new tokens (Mamba2 must launch RMSNorm and the SSD
   kernel and no attention kernel, Zamba2 also the flash prefill and the
   dense decode kernel); 8
   ragged greedy requests, one past the 256-token chunk, through the
   continuous engine against each request alone (identical, in fp32);
   one Mamba2 decode step at 16 slots eager and as a
   CUDA-graph replay.
13. ``ssm_train`` — the SSM / hybrid training slice: at the SFT shapes
   (b 8, nc 2, q 256; Mamba2-370M and Zamba2-1.2B widths) the forward
   kernel against its plain version (phase ``ssm``'s tolerances) and the
   explicit SSD backward (``ref.ssd_intra_bwd_ref``) against autograd of
   the plain forward (fp32 1e-4, bf16 2e-2), the forward kernel, the
   backward and autograd of the plain version timed by CUDA-graph replay
   beside the backward's bound, and the plain RMSNorm backward at the
   SFT rows, timed beside its bound; Mamba2-370M and Zamba2-1.2B at full width
   and depth in fp32, one SFT step through the kernel path and the plain
   path: a per-layer witness (a middle SSM layer, and Zamba2's middle
   attention layer: output and every gradient at 1e-4) and the loss and
   grad norm end to end (1e-4 or 2x the conditioning); ``launch.train`` in
   bf16 with remat, 10 Mamba2 and 5 Zamba2 steps of 8 x 512 (launch counts
   set to 0 just before each run and read just after: the SSD kernel, and
   for Zamba2 both flash kernels, must have launched, no attention kernel
   for Mamba2); 5 Mamba2 reward steps of 8 pairs x 512; ``launch.train
   --rlhf`` at Mamba2 (2 steps, 8 x 256 prompts, 64 new) and Zamba2
   with ``--kv-quant`` (1 step, 4 prompts, 32 new): every loss finite,
   the frozen models' checksums unchanged by stage 3; Zamba2
   ``--kv-quant`` on the serve workload (the int8 decode kernel, never the
   bf16 one) and the int8 gate at full width cut to 12 layers (one cache
   at 1e-4, free-running within a tenth of the int8 error, tokens
   identical, the first attention layer's int8 rows at most one step
   apart).
14. ``gqa128`` — the head-dim-128 GQA family at full size: the flash
   forward (with the LSE) at the prefills of qwen3-8b (KV 8, G 4), yi-9b
   (KV 4, G 8), llama3.2-3b (KV 8, G 3) and llama4-scout (KV 8, G 5) and
   at the llama3.2-3b SFT shape (B 8, H 24, L 512), the flash backward at
   that shape, the four decode kernels at B 16, S 512 (ragged) for the
   three dense models' groups, RMSNorm at D = 3072, 4096 and 5120 (R = 16
   and 4,096): fp32 (TF32 off, 1e-4) and bf16 (2e-2 of max |plain|, RMSNorm
   1e-2 relative) against the plain versions, bf16 timed warm and cold
   beside the bound and the library call or a yardstick; the ptxas
   registers and spills of every D = 128 instantiation (from ``build``,
   printed, not gated); qwen3-8b, yi-9b and llama3.2-3b at full width and
   depth in fp32, teacher-forced (prefill 256 + 32 decode), kernel path
   against plain path (1e-4); ``launch.serve`` of yi-9b greedy paged ==
   dense on 8 requests, llama3.2-3b greedy on dense and paged int8 KV
   (tok/s and peak memory; each run's launch set gated); ``launch.train``
   SFT at llama3.2-3b full size (5 steps of 8 x
   512, bf16 on fp32 masters, remat; fails if it does not fit), a
   qwen3-8b fp32 LM step at 2 layers kernel vs plain (loss 1e-5, grads
   1e-4 of each leaf's max); ``RLHFPipeline`` with llama3.2-3b actor and
   critic cut to 4 layers (2 SFT, 2 RM steps, 1 PPO iteration of 8 x 256
   + 64 on int8 KV) under phase ``rlhf``'s checks.
15. ``moe`` — the MoE layer at llama4-scout-17b-a16e, full width (107.8 B
   parameters whole, so cut in depth): ``launch.serve`` at 12 layers
   (``cfg=``; 28.5 B, bf16 weights only) on the 32-request workload (64
   new tokens) with
   the share of routed entries the capacity drops per decode step and per
   admission (ROADMAP Queue 3, R13), greedy paged == dense on 8 equal
   requests in 8 slots (every slot live; counted, not gated, on 8 ragged
   requests in 16 slots, whose idle slots' rows differ by layout), prefix
   cache on vs off on the shared-system-prompt mix (a share of equal
   streams, not gated: R13); an fp32 LM step at 1 layer, 2 x 256, kernel
   vs plain (loss and aux 1e-5, grads 1e-4); ``launch.train --lora 8``
   at 2 layers, 3 bf16 steps of 4 x 512 (every loss and aux finite, the
   adapters moved).
16. ``mla`` — MLA at deepseek-v2-lite-16b (16.2 B parameters, every layer
   MoE): the flash forward and backward at head dim 192 (H = KV = 16, V
   zero-padded from 128) at the prefill (B 1, L 256) and the SFT shape
   (B 8, L 512, with the LSE), fp32 and bf16 against the plain versions,
   bf16 timed warm and cold beside the bound, the plain time and SDPA;
   the bf16 D = 192 kernels' ptxas (phase ``build`` fails on a spill);
   fp32 greedy at full width and the deepest cut whose weights fit (all
   27 layers on an 80 GB card), kernel path against plain path, each
   free-running: the per-layer witness (every MLA attention through both
   paths on the same input and cache, 1e-4) and the logits gap over the
   shared steps (1e-4 or 2x the conditioning); ``launch.serve`` at full
   size on the 32-request workload at 64 new tokens, 16 slots, the dense
   latent arena, no warm-up (tok/s, peak memory, the MoE drop share per
   decode step and admission; RMSNorm and the flash forward launched, no
   decode kernel: the absorbed decode is plain products); ``launch.train``
   SFT at full width cut to 4 layers, 5 steps of 8 x 512 (bf16 on fp32
   masters): the D = 192 backward inside a step.
17. ``xattn`` — cross-attention and embedding inputs: the flash kernels
   over llama-3.2-vision's 1,601 encoder keys (D 128, H 32 / KV 8,
   non-causal; Lq 1 and 64 at B 4, and the SFT shape B 8, Lq 512 with the
   backward), checked and timed as in phase ``mla``;
   llama-3.2-vision-11b at full size (40 layers) in fp32 with its gates
   drawn from U(0.5, 1): ``GenerationEngine.generate`` with
   ``encoder_embeds`` (B 4, 1,601 x 1,280, 64-token prompts, 64 new,
   greedy; RMSNorm, the flash forward and the dense decode kernel
   launched), then the free-running gate of phase ``mla`` with a
   per-layer witness over every layer; its SFT at full width cut to the
   units that fit (3 steps of 8 x 512 with encoder embeddings);
   musicgen-medium at full size (48 layers, no embedding table): fp32
   teacher-forced prefill of 256 frame embeddings + 32 decode steps,
   kernel path against plain path (1e-4), and 5 SFT steps of 8 x 512 on
   frame embeddings (bf16 on fp32 masters; every loss finite, the training
   kernels launched).
18. ``ckpt`` — checkpoint/resume, LoRA and the torch example, under
   ``build/ckpt_phase`` (deleted at the end): the free disk (60 GB
   at least) and host RAM (2x the largest snapshot) first; two
   uninterrupted ``launch.train`` runs of OPT-1.3B (full width cut to 8
   layers, 3 steps of 8 x 512, bf16 on fp32 masters, remat), the second
   with ``--save-every 2 --ckpt-dir``, whose state SHA-256s must be equal;
   the step-3 checkpoint deleted, rerun with ``--resume``: its hash must
   be the witness's (bytes, snapshot ms, write and restore s and GB/s, the step
   that overlaps a write against one that does not); the same run on the
   mesh path at 1 x 1 (``--mesh 1,1 --strategy tp --zero 1``, a one-rank
   NCCL group in this process), whose sharded step-2 manifest must equal
   the plain run's (leaves, windows, sizes, CRCs) and final hash the
   witness, then the plain run's checkpoint resumed on the mesh path and
   the mesh run's on the plain path, each ending on the witness (the mesh
   path's snapshot ms, write and restore GB/s beside the plain path's);
   ``launch.train
   --rlhf`` at OPT-125M (3 steps a stage, 8 x 512, 64 new) with
   ``--save-every 2``, its last checkpoint deleted (a crash after
   iteration 1's commit) and rerun on the same directory: the rerun
   resumes at iteration 2, and its reward scores, per-iteration metrics
   without the wall-time keys and the actor, critic and EMA hashes equal
   the first run's; the same on ``--rlhf --mesh 1,1`` (an uninterrupted
   run with its own saves, its last checkpoint deleted, rerun): both must
   end as the plain uninterrupted run did (the engine's reshard metrics
   aside; at one rank the pipeline's trainer is the plain one);
   LoRA rank 8 at OPT-1.3B: one fp32 step at full width cut to 4 layers,
   2 x 512, loss and adapter grads kernel path against plain path (1e-4,
   ``worst``), then 5 bf16 steps of 8 x 512 with ``--ckpt`` (adapter
   count, peak memory, median step beside phase ``train``'s full SFT);
   ``launch.serve --ckpt`` of that export, greedy, whose tokens must equal
   serving the folded params from memory; ``examples/torch_rlhf_e2e.py``
   at its default scale with ``tests/test_system.py``'s learning checks.
   Launch counts are set to 0 before each leg's first run and read after
   it (SFT, mesh SFT and its resume, PPO, mesh PPO, LoRA, serve,
   example); every kernel of the leg must have launched.
19. ``profile`` — ``torch.profiler`` over the decode kernels, last, so
   that no earlier timing runs after a profiler session: the CUDA kernels
   one call of each decode row of phase ``kernels`` runs (the split
   kernel, then the combine exactly when the host's plan splits the
   rows), and the decode kernels' device time inside one CUDA-graph
   replay of the OPT-1.3B decode step of phase ``serve``, dense and
   paged, bf16 and int8 KV, per call and against the bound of the step's
   own rows.

The decode rows (dense and paged, fp and int8: one split-KV core) also
print the time with the inputs out of the L2 (``time_ms_cold``: the call
rotated over copies of its inputs that add up to four L2s) and the achieved
GB/s, the bound's bytes over that cold time.  A dense row at B = 1, S =
2048 (its inputs from a generator of its own) is where split-KV matters
most.  Each paged row also checks that the dense kernel of its kind over
the gathered rows gives its output bit for bit.

The kernel phase also holds ``decode_attention_quant_fwd`` (int8 K/V with
fp32 row scales) to its plain version at the PPO (B = 8) and serve (B = 16)
shapes, with dequant-then-SDPA as a yardstick; the parity phase adds a
greedy int8-KV decode of OPT-1.3B cut to 4 layers (kernel vs plain path),
and the serve phase a ``--kv-quant`` run of the same workload and the
OPT-1.3B decode step on the int8 arena (eager and as a CUDA-graph replay).

The paged layout (block pool, prefix cache, paged int8): the kernel phase
holds ``paged_decode_attention_fwd`` and ``paged_decode_attention_quant_fwd``
to their plain versions (fp32 and bf16 queries) at the serve (B = 16 over a
513-block pool, 1..512 rows), PPO (B = 8, 257..512 rows) and smollm-135m
(G = 3) shapes, over shuffled non-contiguous tables, with the port's dense
decode kernel on the rows gathered beforehand and gather + SDPA as
yardsticks, and checks untimed that rows no sequence may read never change
the output (they hold NaN) and that ``lens = 0`` gives zeros.  The parity
phase runs OPT-1.3B (4 layers, fp32) teacher-forced through the paged
kernel, dense kernel and paged plain paths (1e-4), and the int8 pair of
checks on a paged int8 pool.  The serve phase times a paged decode step
(bf16 and int8 pools), runs the 32-request workload with ``--kv-layout
paged --kv-quant``, then greedy on the dense arena and the paged bf16
pool (identical streams; the greedy runs skip the warm-up, their shapes
already warm, and generate 64 tokens a request), a 121-block pool that
preempts (identical streams), and
the prefix cache on a
shared-system-prompt mix, unwarmed, its tok/s cold (hit rate >= 0.5;
greedy streams on vs off
identical in fp32, counted in bf16, whose suffix GEMMs round otherwise than
the full prompt's); paged runs
must launch a paged kernel and never a dense decode kernel.  The rlhf phase
ends with one PPO iteration on the request path: 8 prompts x 4 samples of
64 tokens on the paged int8 pool with the prefix cache.

The last lines are the card's ``name, power.limit``, one JSON object with a
row per kernel, and ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("device", "build", "kernels", "parity", "serve", "train", "rlhf",
          "async", "disagg", "hybrid", "serve_mesh", "ssm", "ssm_train", "gqa128",
          "moe", "mla", "xattn", "ckpt", "profile")

# H100 SXM peaks (NVIDIA data sheet, dense): the time bound of a kernel is
# the larger of bytes / memory rate and operations / peak rate for the type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}

KERNEL_META = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:74"),
    "flash_attention_bwd": (
        "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "src/repro/kernels/flash_attention_bwd.py:126"),
    "decode_attention_fwd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:77"),
    "decode_attention_quant_fwd": (
        "src/repro_torch/kernels/csrc/decode_attention_quant.cu",
        "src/repro/kernels/decode_attention.py:162"),
    "paged_decode_attention_fwd": (
        "src/repro_torch/kernels/csrc/paged_decode_attention.cu",
        "src/repro/kernels/paged_attention.py:188"),
    "paged_decode_attention_quant_fwd": (
        "src/repro_torch/kernels/csrc/paged_decode_attention_quant.cu",
        "src/repro/kernels/paged_attention.py:141"),
    "ssd_intra_fwd": ("src/repro_torch/kernels/csrc/ssd_intra.cu",
                      "src/repro/kernels/ssd_scan.py:57"),
}

# the kernels each main path must launch
SERVE_KERNELS = ("rmsnorm", "flash_attention_fwd", "decode_attention_fwd")
SERVE_INT8_KERNELS = ("rmsnorm", "flash_attention_fwd",
                      "decode_attention_quant_fwd")
TRAIN_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd")
RLHF_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd",
                "decode_attention_quant_fwd")
SERVE_PAGED_KERNELS = ("rmsnorm", "flash_attention_fwd",
                       "paged_decode_attention_fwd")
SERVE_PAGED_INT8_KERNELS = ("rmsnorm", "flash_attention_fwd",
                            "paged_decode_attention_quant_fwd")
RLHF_PAGED_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd",
                      "paged_decode_attention_quant_fwd")
DENSE_DECODE = ("decode_attention_fwd", "decode_attention_quant_fwd")
# the sources built on the decode core (csrc/decode_core.cuh)
DECODE_LIBS = ("decode_attention", "decode_attention_quant",
               "paged_decode_attention", "paged_decode_attention_quant")
# the SSM / hybrid serve paths: Mamba2 has no attention layer, Zamba2's six
# attention layers run the dense prefill and decode kernels
SSM_SERVE_KERNELS = {
    "mamba2-370m": ("rmsnorm", "ssd_intra_fwd"),
    "zamba2-1.2b": ("rmsnorm", "ssd_intra_fwd", "flash_attention_fwd",
                    "decode_attention_fwd")}
ATTENTION_KERNELS = ("flash_attention_fwd", "decode_attention_fwd",
                     "decode_attention_quant_fwd", "paged_decode_attention_fwd",
                     "paged_decode_attention_quant_fwd")


T_START = time.perf_counter()


def log(msg: str) -> None:
    """``msg`` after the seconds since the script started."""
    print(f"{time.perf_counter() - T_START:7.1f}s {msg}", flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def capture_graph(fn, inner: int = 1):
    """``inner`` back-to-back calls of ``fn`` captured into one CUDA graph
    (after three warm-up calls outside the capture)."""
    import torch
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        for _ in range(3):                     # warm-up outside the capture
            fn()
    torch.cuda.current_stream().wait_stream(stream)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    return graph


def time_ms(fn, *, inner: int = 20, repeats: int = 7) -> float:
    """Median device time per call in ms.  ``inner`` back-to-back calls are
    captured into one CUDA graph, which is replayed ``repeats`` times
    between two CUDA events: the time is the card's, without the host's
    per-call launch overhead (which would otherwise set the pace of these
    microsecond kernels).  The calls reuse one set of inputs, so what fits
    in the L2 is read from there after the first call: see
    :func:`time_ms_cold`."""
    import torch
    graph = capture_graph(fn, inner)
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        per_call.append(start.elapsed_time(end) / inner)
    del graph
    return statistics.median(per_call)


def l2_bytes() -> int:
    import torch
    return getattr(torch.cuda.get_device_properties(0), "L2_cache_size",
                   50 * 2**20)


def cold_copies(nbytes: float) -> int:
    """Copies of a call's inputs whose ``nbytes`` each add up to four L2s
    (at least 2, at most 128)."""
    return max(2, min(128, -(-4 * l2_bytes() // max(int(nbytes), 1))))


def time_ms_cold(fns, *, rounds: int = 2) -> float:
    """:func:`time_ms` with the inputs out of the L2: ``fns`` are the same
    call on copies of its inputs at distinct addresses (``cold_copies``),
    which the graph runs in turn, ``rounds`` times each, so the copies run
    since a call's last turn have evicted its bytes."""
    import itertools
    turn = itertools.cycle(fns)
    return time_ms(lambda: next(turn)(), inner=rounds * len(fns))


def cuda_kernels_of(fn, tries: int = 3) -> list:
    """The names of the CUDA kernels one call of ``fn`` runs, in launch
    order, from ``torch.profiler``.  Each session opens with two fill
    kernels, left out of the result: on the H100 a session after an
    earlier one lost the record of its first kernel.  A session with no
    other kernel is taken again, up to ``tries`` sessions."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.autograd.DeviceType.CUDA
    marker = torch.empty(1, device="cuda")
    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            marker.fill_(0)
            marker.fill_(1)
            torch.cuda.synchronize()
            fn()
            torch.cuda.synchronize()
        kernels = sorted((e.time_range.start, e.name) for e in prof.events()
                         if e.device_type == cuda and "Fill" not in e.name)
        if kernels:
            break
    return [name for _, name in kernels]


def causal_pairs(Lq: int, Lk: int, window) -> int:
    """Unmasked (query, key) pairs of one head."""
    import torch
    qpos = torch.arange(Lq) + (Lk - Lq)
    kpos = torch.arange(Lk)
    m = qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return int(m.sum())


def bound(nbytes: float, ops: float, kind: str):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / PEAK_OPS[kind] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def phase_device(state):
    import torch
    line = nvidia_smi_line()
    state["smi"] = line
    log(f"[device] {line}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]} "
        f"kind={torch.cuda.get_device_name(0)} "
        f"count={torch.cuda.device_count()}")


def ptxas_usage(text: str) -> list:
    """(kernel, registers, bytes of stack frame, spill stores and spill
    loads) for each entry function in ``nvcc -Xptxas -v`` output; the
    kernel's name demangled by ``cu++filt`` or ``c++filt`` where one is
    found, else as ptxas gives it."""
    import re
    import shutil
    filt = shutil.which("cu++filt") or shutil.which("c++filt")
    if filt is None and Path("/usr/local/cuda/bin/cu++filt").is_file():
        filt = "/usr/local/cuda/bin/cu++filt"
    rows, fn, spill = [], None, (0, 0, 0)
    for ln in text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            fn = m.group(1)
            if filt is not None:
                fn = subprocess.run([filt, fn], capture_output=True,
                                    text=True).stdout.strip() or fn
                fn = re.sub(r"\(anonymous namespace\)::|<unnamed>::|\(int\)",
                            "", fn)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", ln)
        if m:
            spill = tuple(int(x) for x in m.groups())
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and fn is not None:
            rows.append((fn, int(m.group(1)), *spill))
            fn, spill = None, (0, 0, 0)
    return rows


def phase_build(state):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(ptxas_verbose=True)
    wall = time.perf_counter() - t0
    # the bf16 tensor-core flash kernels at D = 64 (every main path's head
    # width) must keep everything in registers: 1 forward, 2 backward; so
    # must the decode core's split and combine kernels with bf16 queries
    # at D = 64, fp and int8 rows
    mma64, split64, comb64, ssd_mma = {}, {}, {}, {}
    # the bf16 tensor-core flash kernels at D = 192 (MLA, phase mla): the
    # forward, the dV-only and dK-only dK/dV kernels and dQ, none spilling
    mma192 = state.setdefault("ptxas_d192", {})
    # every D = 128 instantiation (flash fp32 and bf16, the decode core's
    # split and combine kernels): registers and spills, printed and kept
    # for phase gqa128, not gated
    import re
    d128 = state.setdefault("ptxas_d128", {})
    for name, r in report.items():
        log(f"[build] {name}.cu: {r['seconds']:.1f}s")
        for fn, regs, stack, st, ld in ptxas_usage(r["log"]):
            log(f"[build]   {fn}: {regs} registers, {stack} bytes stack "
                f"frame, {st} bytes spill stores, {ld} bytes spill loads")
            if "ssd" not in name and re.search(r"[<,] ?128\b|Li128E", fn):
                d128[f"{name}: {fn}"] = (regs, st + ld)
            if "ssd_intra_mma_kernel" in fn:
                ssd_mma[fn] = st + ld
            elif "mma_kernel" in fn and re.search(r"<64[,>]|ILi64E", fn):
                mma64[fn] = st + ld
            elif "mma_kernel" in fn and re.search(r"<192[,>]|ILi192E", fn):
                mma192[fn] = (regs, st + ld)
            for kind, seen in (("split", split64), ("combine", comb64)):
                if (f"{kind}_kernel<__nv_bfloat16, 64," in fn
                        or f"{kind}_kernelI13__nv_bfloat16Li64E" in fn):
                    seen[f"{name}: {fn}"] = st + ld
    log(f"[build] {len(report)} sources, {wall:.1f}s wall (nvcc in "
        f"parallel)")
    want = ("flash_attention" in report) + 2 * ("flash_attention_bwd"
                                                in report)
    if len(mma64) != want or any(mma64.values()):
        raise AssertionError(f"build: D = 64 tensor-core kernels (want "
                             f"{want}, none spilling): {mma64}")
    want = ("flash_attention" in report) + 3 * ("flash_attention_bwd"
                                                in report)
    if len(mma192) != want or any(v[1] for v in mma192.values()):
        raise AssertionError(f"build: D = 192 tensor-core kernels (want "
                             f"{want}, none spilling): {mma192}")
    # one split kernel per G bucket (1, 2, 4, 8) and one combine in each
    # decode library
    libs = sum(n in report for n in DECODE_LIBS)
    if len(split64) != 4 * libs or any(split64.values()):
        raise AssertionError(f"build: bf16 D = 64 decode split kernels "
                             f"(want {4 * libs}, none spilling): {split64}")
    if len(comb64) != libs or any(comb64.values()):
        raise AssertionError(f"build: bf16 D = 64 decode combine kernels "
                             f"(want {libs}, none spilling): {comb64}")
    # the bf16 SSD kernel, one per (p, n): 2 x 3 instantiations
    if "ssd_intra" in report and (len(ssd_mma) != 6
                                  or any(ssd_mma.values())):
        raise AssertionError(f"build: bf16 SSD tensor-core kernels (want 6, "
                             f"none spilling): {ssd_mma}")


def _case_inputs(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(out, ref, rel: bool) -> float:
    d = (out.float() - ref.float()).abs()
    if rel:
        d = d / ref.float().abs().clamp(min=1.0)
    return float(d.max())


def worst(errs) -> float:
    """The largest of ``errs``, NaN if any is NaN: Python's ``max`` keeps a
    NaN only where it comes first, and a gate ``worst(errs) <= tol`` must
    fail on every NaN."""
    errs = [float(e) for e in errs]
    return float("nan") if any(e != e for e in errs) else max(errs)


def _decode_valid(gen, B, S, lo):
    """Decode masks ``(B, S)``: ``valid``, ragged with ``lo..S`` rows per
    sequence (one full), the pattern that is timed and bounded; and
    ``masked``, the same with sequence 0 fully masked (an idle slot, whose
    answer is the mean of V), checked but not timed."""
    import torch
    n_valid = torch.randint(lo, S + 1, (B,), generator=gen, device="cuda")
    n_valid[min(1, B - 1)] = S
    valid = torch.arange(S, device="cuda")[None] < n_valid[:, None]
    masked = valid.clone()
    masked[0] = False
    return valid, masked


def _decode_extra(state, name, what, main, plan, call, copies, bnd):
    """The decode kernels' row extras (fp and int8: one core): the time
    with the inputs out of the L2 (``copies``: the same call on copies of
    its inputs) and the achieved rate, the bound's bytes over that time.
    ``call`` and the host's split count ``plan`` are kept for phase
    ``profile``, which reads the CUDA kernels the call runs."""
    state.setdefault("decode_calls", []).append((name, what, main, plan,
                                                 call))
    cold = time_ms_cold(copies)
    gbs = bnd[0] * 1e-3 * HBM_BYTES_PER_S / (cold * 1e-3) / 1e9
    return {"cold_ms": cold, "achieved_gbs": gbs}


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels import flash_attention_bwd as fab
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    tol = {("rmsnorm", "fp32"): 1e-4, ("rmsnorm", "bf16"): 1e-2,
           ("attn", "fp32"): 1e-4, ("attn", "bf16"): 2e-2,
           ("lse", "fp32"): 1e-4, ("lse", "bf16"): 1e-3,
           ("bwd", "fp32"): 1e-4, ("bwd", "bf16"): 2e-2}
    failures = []
    log("kernels: rmsnorm, flash_attention_fwd (+ LSE), flash_attention_bwd, "
        "decode_attention_fwd, decode_attention_quant_fwd")

    def record(name, label, dname, err, limit, k_ms, p_ms, lib_ms, bnd,
               main, abs_err=None, ops=None, extra=None):
        ok = err <= limit
        if not ok:
            failures.append(f"{name} {label} {dname}: err {err:.3g} > "
                            f"{limit}")
        # achieved rate: the operations counted for the bound over the time
        tflops = None if ops is None else ops / (k_ms * 1e-3) / 1e12
        log(f"[kernels] {name:<21} {label:<38} {dname} err={err:.3g} "
            f"(tol {limit}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]})"
            + ("" if tflops is None else f" tflops={tflops:.2f}")
            + "".join(f" {k}={v:.4f}" if isinstance(v, float) else
                      f" {k}={v}" for k, v in (extra or {}).items())
            + f" {'ok' if ok else 'FAIL'}")
        if main:
            rows[name] = {"max_abs_err": err if abs_err is None else abs_err,
                          "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": bnd[0], "bound_by": bnd[1],
                          "library_ms": lib_ms, "shape": label,
                          "dtype": dname, **(extra or {})}
            if tflops is not None:
                rows[name]["tflops"] = tflops
        return tflops

    # ---- rmsnorm: decode (R = slots) and prefill (R = bucket) rows, the
    # SFT step's (8 x 512 rows of OPT-1.3B) and the reward step's (8 pairs x
    # 512 of OPT-350M); floor_ms: x.clone() on the same bytes, the time of
    # a launch that reads and writes them and computes nothing
    for (R, D, model) in ((16, 2048, "opt-1.3b"), (512, 2048, "opt-1.3b"),
                          (16, 576, "smollm-135m"), (512, 576, "smollm-135m"),
                          (4096, 2048, "opt-1.3b sft"),
                          (8192, 1024, "opt-350m reward")):
        for dname, dt in dtypes.items():
            x = _case_inputs(gen, (R, D), dt)
            w = (1.0 + 0.1 * _case_inputs(gen, (D,), torch.float32)).to(dt)
            out = rmsnorm_fwd(x, w, eps=1e-5)
            r = ref.rmsnorm_ref(x, w, 1e-5)
            torch.cuda.synchronize()
            err = _err(out, r, rel=dname == "bf16")   # bf16: relative
            eb = x.element_size()
            bnd = bound(2 * R * D * eb + D * w.element_size(), 4 * R * D,
                        "fp32")
            record("rmsnorm", f"{model} R={R} D={D}", dname, err,
                   tol[("rmsnorm", dname)],
                   time_ms(lambda: rmsnorm_fwd(x, w, eps=1e-5)),
                   time_ms(lambda: ref.rmsnorm_ref(x, w, 1e-5)),
                   time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)), bnd,
                   main=(R, D, dname) == (16, 2048, "bf16"),
                   abs_err=_err(out, r, rel=False),
                   extra={"floor_ms": time_ms(lambda: x.clone())})

    # ---- flash attention: admission prefill (B = 1) and the training
    # forward (B = 8, L = 512); each also writes the LSE, held to the plain
    # LSE
    for (B, KV, G, Lq, Lk, window, model) in (
            (1, 32, 1, 256, 256, None, "opt-1.3b"),
            (1, 32, 1, 300, 300, None, "opt-1.3b"),
            (1, 32, 1, 100, 300, None, "opt-1.3b"),
            (1, 32, 1, 256, 256, 96, "opt-1.3b"),
            (1, 3, 3, 256, 256, None, "smollm-135m"),
            (1, 3, 3, 300, 300, None, "smollm-135m"),
            (1, 3, 3, 77, 300, None, "smollm-135m"),
            (8, 32, 1, 512, 512, None, "opt-1.3b train")):
        D = 64
        for dname, dt in dtypes.items():
            # model layout (B, L, H, D) / (B, L, KV, D), passed as views
            qm = _case_inputs(gen, (B, Lq, KV * G, D), dt)
            km = _case_inputs(gen, (B, Lk, KV, D), dt)
            vm = _case_inputs(gen, (B, Lk, KV, D), dt)
            q5 = qm.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
            k4, v4 = km.transpose(1, 2), vm.transpose(1, 2)
            out = flash_attention_fwd(q5, k4, v4, causal=True, window=window)
            r = ref.flash_attention_ref(q5, k4, v4, causal=True,
                                        window=window)
            lse = torch.empty((B, KV, G, Lq), device="cuda")
            out2 = flash_attention_fwd(q5, k4, v4, causal=True,
                                       window=window, lse=lse)
            lse_ref = ref.flash_attention_lse_ref(q5, k4, causal=True,
                                                  window=window)
            torch.cuda.synchronize()
            err = _err(out, r, rel=False)
            lse_err = _err(lse, lse_ref, rel=False)
            win = "" if window is None else f" window={window}"
            log(f"[kernels] flash_attention_fwd LSE B={B} KV={KV} G={G} "
                f"Lq={Lq} Lk={Lk}{win} {dname}: max|lse - plain| = "
                f"{lse_err:.3g} (tol {tol[('lse', dname)]}), output with LSE "
                f"{'==' if torch.equal(out, out2) else '!='} output without")
            if lse_err > tol[("lse", dname)] or not torch.equal(out, out2):
                failures.append(f"flash LSE {model} Lq={Lq} Lk={Lk}{win} "
                                f"{dname}: err {lse_err:.3g}")
            pairs = causal_pairs(Lq, Lk, window)
            eb = qm.element_size()
            ops = 4 * B * KV * G * pairs * D
            bnd = bound((2 * B * KV * G * Lq * D + 2 * B * KV * Lk * D) * eb,
                        ops, "bf16" if dname == "bf16" else "fp32")
            lib = None
            if Lq == Lk and window is None:
                qs, ks, vs = (t.transpose(1, 2) for t in (qm, km, vm))
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=G > 1))
            k_ms = time_ms(lambda: flash_attention_fwd(
                q5, k4, v4, causal=True, window=window))
            tflops = record(
                "flash_attention_fwd",
                f"{model} B={B} KV={KV} G={G} Lq={Lq} Lk={Lk}{win}", dname,
                err, tol[("attn", dname)], k_ms,
                time_ms(lambda: ref.flash_attention_ref(
                    q5, k4, v4, causal=True, window=window)),
                lib, bnd,
                main=(B, KV, Lq, Lk, window, dname) == (
                    1, 32, 256, 256, None, "bf16"), ops=ops)
            if (B, dname) == (8, "bf16"):       # the training forward
                train_fwd = {"train_ms": k_ms, "train_library_ms": lib,
                             "train_bound_ms": bnd[0],
                             "train_tflops": tflops}

    rows["flash_attention_fwd"].update(train_fwd)

    # ---- flash attention backward at the training shapes (L = 512) ----
    for (B, KV, G, Lq, Lk, window, model) in (
            (8, 32, 1, 512, 512, None, "opt-1.3b"),
            (8, 16, 1, 512, 512, None, "opt-350m"),
            (8, 3, 3, 512, 512, None, "smollm-135m"),
            (2, 32, 1, 300, 300, None, "opt-1.3b ragged"),
            (2, 32, 1, 100, 300, None, "opt-1.3b rectangular"),
            (2, 32, 1, 512, 512, 96, "opt-1.3b window")):
        D = 64
        for dname, dt in dtypes.items():
            # model layout, passed as strided views (as ops.FlashAttention)
            qm = _case_inputs(gen, (B, Lq, KV * G, D), dt)
            km = _case_inputs(gen, (B, Lk, KV, D), dt)
            vm = _case_inputs(gen, (B, Lk, KV, D), dt)
            dom = _case_inputs(gen, (B, Lq, KV * G, D), dt)
            q5, do5 = (t.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
                       for t in (qm, dom))
            k4, v4 = km.transpose(1, 2), vm.transpose(1, 2)
            o5 = ref.flash_attention_ref(q5, k4, v4, causal=True,
                                         window=window)
            lse = ref.flash_attention_lse_ref(q5, k4, causal=True,
                                              window=window)
            delta = (do5.float() * o5.float()).sum(-1).contiguous()
            got = flash_attention_bwd(q5, k4, v4, do5, lse, delta,
                                      causal=True, window=window)
            want = ref.flash_attention_bwd_ref(q5, k4, v4, do5, lse, delta,
                                               causal=True, window=window)
            torch.cuda.synchronize()
            rel = worst(float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp(min=1e-12))
                        for a, b in zip(got, want))
            abs_err = worst(_err(a, b, rel=False) for a, b in zip(got, want))
            scale = min(float(b.float().abs().max()) for b in want)
            if not scale > 0:
                failures.append(f"flash bwd {model} {dname}: the plain "
                                f"gradients are all zero")
            log(f"[kernels] flash_attention_bwd {model} {dname}: max|ref| of "
                f"dq/dk/dv >= {scale:.3g}, max|kernel - ref| = "
                f"{abs_err:.3g} " + (
                    "(must be exactly 0: the fp32 kernels and the fp32 GEMMs "
                    "sum each output in the same order)" if dname == "fp32"
                    else "(P and dS are rounded to bf16 before the second "
                    "products)"))
            if dname == "fp32" and abs_err != 0:
                failures.append(f"flash bwd {model} fp32: max|kernel - ref| "
                                f"= {abs_err:.3g}, not exactly 0")
            pairs = causal_pairs(Lq, Lk, window)
            eb = qm.element_size()
            ops = 10 * D * B * KV * G * pairs
            bnd = bound(3 * B * KV * G * Lq * D * eb + 4 * B * KV * Lk * D * eb
                        + 2 * B * KV * G * Lq * 4, ops,
                        "bf16" if dname == "bf16" else "fp32")
            # each of the two kernels alone (launches x (time - bound) is
            # reckoned per kernel launch)
            dq_, dk_, dv_ = (torch.empty_like(t) for t in (q5, k4, v4))
            parts = {f"{part}_ms": time_ms(
                lambda part=part: fab._launch(
                    (part,), q5, k4, v4, do5, lse, delta, dq_, dk_, dv_, True,
                    window), inner=5, repeats=5) for part in ("dkv", "dq")}
            lib = None
            if Lq == Lk and window is None:
                qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                              for t in (qm, km, vm))
                dos = dom.transpose(1, 2)
                sdpa = lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=G > 1)
                both = lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
                lib = (time_ms(both, inner=5, repeats=5)
                       - time_ms(sdpa, inner=5, repeats=5))
            win = "" if window is None else f" window={window}"
            record("flash_attention_bwd",
                   f"{model} B={B} KV={KV} G={G} Lq={Lq} Lk={Lk}{win}", dname,
                   rel, tol[("bwd", dname)],
                   time_ms(lambda: flash_attention_bwd(
                       q5, k4, v4, do5, lse, delta, causal=True,
                       window=window), inner=5, repeats=5),
                   time_ms(lambda: ref.flash_attention_bwd_ref(
                       q5, k4, v4, do5, lse, delta, causal=True,
                       window=window), inner=3, repeats=5),
                   lib, bnd,
                   main=(B, KV, Lq, window, dname) == (8, 32, 512, None,
                                                       "bf16"),
                   abs_err=abs_err, ops=ops, extra=parts)
            del got, want, o5, dq_, dk_, dv_

    # ---- decode attention: 16 slots over the in-place (B, S, KV, D) arena,
    # and one sequence over a long cache (where split-KV matters most; its
    # inputs from a generator of its own, so that the rows after it draw
    # what they drew before it was added)
    gen_long = torch.Generator(device="cuda").manual_seed(2048)
    for (B, KV, G, S, model) in ((16, 32, 1, 512, "opt-1.3b"),
                                 (16, 3, 3, 512, "smollm-135m"),
                                 (16, 32, 1, 300, "opt-1.3b"),
                                 (1, 32, 1, 2048, "opt-1.3b")):
        D = 64
        g_in = gen_long if B == 1 else gen
        for dname, dt in dtypes.items():
            q = _case_inputs(g_in, (B, KV * G, D), dt)
            k_arena = _case_inputs(g_in, (B, S, KV, D), dt)
            v_arena = _case_inputs(g_in, (B, S, KV, D), dt)
            valid, masked = _decode_valid(g_in, B, S, 1)
            q4 = q.unflatten(1, (KV, G))
            k4, v4 = k_arena.transpose(1, 2), v_arena.transpose(1, 2)
            out = decode_attention_fwd(q4, k4, v4, valid)
            r = ref.decode_attention_ref(q4, k4, v4, valid)
            out_m = decode_attention_fwd(q4, k4, v4, masked)
            r_m = ref.decode_attention_ref(q4, k4, v4, masked)
            torch.cuda.synchronize()
            err = worst((_err(out, r, rel=False),
                         _err(out_m, r_m, rel=False)))
            mean_v = v4[0].float().mean(dim=1)            # (KV, D)
            err_mean = _err(out_m[0].float(),
                            mean_v[:, None].expand(KV, G, D), rel=False)
            if err_mean > tol[("attn", dname)]:
                failures.append(f"decode {dname}: fully masked row is not "
                                f"the mean of V (err {err_mean:.3g})")
            eb = q.element_size()
            need = int(valid.sum())                 # valid rows, timed case
            bnd = bound(2 * B * KV * G * D * eb + B * S
                        + 2 * need * KV * D * eb,
                        4 * KV * G * D * need,
                        "bf16" if dname == "bf16" else "fp32")
            qs = q.unflatten(1, (KV * G, 1))               # (B, H, 1, D)
            mask = valid[:, None, None, :]
            lib = time_ms(lambda: F.scaled_dot_product_attention(
                qs, k4, v4, attn_mask=mask, enable_gqa=G > 1))
            label = f"{model} B={B} KV={KV} G={G} S={S} ragged"
            k_ms = time_ms(lambda: decode_attention_fwd(q4, k4, v4, valid))
            main = (B, KV, S, dname) == (16, 32, 512, "bf16")
            copies = [(k4.clone(), v4.clone())
                      for _ in range(cold_copies(bnd[0] * 1e-3
                                                 * HBM_BYTES_PER_S))]
            extra = _decode_extra(
                state, "decode_attention_fwd", f"{label} {dname}", main,
                dec.split_plan(S, B * KV, sms=dec.sm_count(0),
                               max_chunk=dec.MAX_CHUNK)[0],
                lambda q4=q4, k4=k4, v4=v4, valid=valid:
                decode_attention_fwd(q4, k4, v4, valid),
                [lambda kc=kc, vc=vc: decode_attention_fwd(q4, kc, vc, valid)
                 for kc, vc in copies], bnd)
            extra["library_cold_ms"] = time_ms_cold(
                [lambda kc=kc, vc=vc: F.scaled_dot_product_attention(
                    qs, kc, vc, attn_mask=mask, enable_gqa=G > 1)
                 for kc, vc in copies])
            del copies
            record("decode_attention_fwd", label, dname, err,
                   tol[("attn", dname)], k_ms,
                   time_ms(lambda: ref.decode_attention_ref(q4, k4, v4,
                                                            valid)),
                   lib, bnd, main=main, extra=extra)
    # ---- int8 decode attention over the in-place int8 arena and its
    # scale planes: PPO generation (B = 8), serve (B = 16), smollm's G = 3
    from repro_torch.kernels.decode_attention import \
        decode_attention_quant_fwd
    from repro_torch.models.modules import _kv_quant
    # PPO generation attends its 256 prompt rows and the tokens so far
    for (B, KV, G, S, lo, model) in ((8, 32, 1, 512, 257, "opt-1.3b ppo"),
                                     (16, 32, 1, 512, 1, "opt-1.3b serve"),
                                     (16, 3, 3, 512, 1, "smollm-135m")):
        D = 64
        for dname, dt in dtypes.items():
            q = _case_inputs(gen, (B, KV * G, D), dt)
            k_arena, k_sc = _kv_quant(_case_inputs(gen, (B, S, KV, D), dt))
            v_arena, v_sc = _kv_quant(_case_inputs(gen, (B, S, KV, D), dt))
            valid, masked = _decode_valid(gen, B, S, lo)
            q4 = q.unflatten(1, (KV, G))
            k4, v4 = k_arena.transpose(1, 2), v_arena.transpose(1, 2)
            ks3, vs3 = k_sc.transpose(1, 2), v_sc.transpose(1, 2)
            out = decode_attention_quant_fwd(q4, k4, v4, ks3, vs3, valid)
            r = ref.decode_attention_quant_ref(q4, k4, v4, ks3, vs3, valid)
            out_m = decode_attention_quant_fwd(q4, k4, v4, ks3, vs3, masked)
            r_m = ref.decode_attention_quant_ref(q4, k4, v4, ks3, vs3,
                                                 masked)
            torch.cuda.synchronize()
            scale = float(r.float().abs().max())
            err = worst((_err(out, r, rel=False),        # of max |plain|
                         _err(out_m, r_m, rel=False))) / scale
            mean_v = (v4[0].float() * vs3[0][..., None]).mean(dim=1)
            err_mean = _err(out_m[0].float(),
                            mean_v[:, None].expand(KV, G, D),
                            rel=False) / scale
            if err_mean > tol[("attn", dname)]:
                failures.append(f"decode int8 {dname}: fully masked row is "
                                f"not the mean of V (err {err_mean:.3g})")
            eb = q.element_size()
            need = int(valid.sum())                 # valid rows, timed case
            bnd = bound(2 * B * KV * G * D * eb + B * S
                        + need * KV * (2 * D + 8),
                        4 * KV * G * D * need,
                        "bf16" if dname == "bf16" else "fp32")
            qs = q.unflatten(1, (KV * G, 1))               # (B, H, 1, D)
            mask = valid[:, None, None, :]

            def dequant_sdpa():
                kf = (k4.float() * ks3[..., None]).to(dt)
                vf = (v4.float() * vs3[..., None]).to(dt)
                return F.scaled_dot_product_attention(
                    qs, kf, vf, attn_mask=mask, enable_gqa=G > 1)

            yard = time_ms(dequant_sdpa)
            label = f"{model} B={B} KV={KV} G={G} S={S} valid {lo}-{S}"
            main = (B, KV, dname) == (8, 32, "bf16")
            k_ms = time_ms(lambda: decode_attention_quant_fwd(
                q4, k4, v4, ks3, vs3, valid))
            copies = [tuple(t.clone() for t in (k4, v4, ks3, vs3))
                      for _ in range(cold_copies(bnd[0] * 1e-3
                                                 * HBM_BYTES_PER_S))]
            extra = _decode_extra(
                state, "decode_attention_quant_fwd", f"{label} {dname}", main,
                dec.split_plan(S, B * KV, sms=dec.sm_count(0),
                               max_chunk=dec.MAX_CHUNK)[0],
                lambda q4=q4, kv=(k4, v4, ks3, vs3), valid=valid:
                decode_attention_quant_fwd(q4, *kv, valid),
                [lambda c=c: decode_attention_quant_fwd(q4, *c, valid)
                 for c in copies], bnd)
            del copies
            record("decode_attention_quant_fwd", label, dname, err,
                   tol[("attn", dname)], k_ms,
                   time_ms(lambda: ref.decode_attention_quant_ref(
                       q4, k4, v4, ks3, vs3, valid)),
                   None, bnd, main=main, extra=extra,
                   abs_err=max(_err(out, r, rel=False),
                               _err(out_m, r_m, rel=False)))
            log(f"[kernels] decode_attention_quant_fwd {label} {dname}: "
                f"dequant-then-SDPA yardstick {yard:.4f} ms (no library "
                f"call computes int8 decode)")
            if (B, KV, dname) == (8, 32, "bf16"):
                rows["decode_attention_quant_fwd"]["yardstick_ms"] = yard
    _paged_kernel_rows(state, gen, dtypes, tol, record, rows, failures)
    state["kernel_rows"] = rows
    if failures:
        raise AssertionError("kernel checks failed:\n" + "\n".join(failures))


def _paged_case(gen, B, KV, G, D, bs, nb, lo, dt, quant):
    """A paged decode case on the card: ``lens`` ragged in ``lo..nb*bs``
    (one sequence full, one ending inside a block), each sequence's
    ``ceil(lens / bs)`` blocks drawn shuffled and non-contiguous from a
    ``B * nb + 1``-block pool, the rest of its table the trash block 0."""
    import torch
    from repro_torch.models.modules import _kv_quant
    S, nblocks = nb * bs, B * nb + 1
    lens = torch.randint(lo, S + 1, (B,), generator=gen, device="cuda")
    lens[1] = S
    if int(lens[0]) % bs == 0:
        lens[0] -= 1 if int(lens[0]) > lo else -1
    perm = torch.randperm(nblocks - 1, generator=gen, device="cuda") + 1
    tables = torch.zeros((B, nb), dtype=torch.int32, device="cuda")
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tables[b, :n] = perm[b * nb:b * nb + n].int()
    q = _case_inputs(gen, (B, KV, G, D), dt)
    k = _case_inputs(gen, (nblocks, bs, KV, D), dt)
    v = _case_inputs(gen, (nblocks, bs, KV, D), dt)
    scales = ()
    if quant:
        (k, ks), (v, vs) = _kv_quant(k), _kv_quant(v)
        scales = (ks, vs)
    return q, k, v, scales, tables, lens.int()


def _paged_kernel_rows(state, gen, dtypes, tol, record, rows, failures):
    """Both paged kernels against their plain versions: the serve shape
    (OPT-1.3B, B = 16 over a 513-block pool, 1..512 rows), the PPO shape
    (B = 8, 257..512 rows) and smollm-135m's G = 3; with the port's dense
    decode kernel over the same rows gathered into an arena beforehand and
    gather + SDPA as yardsticks.  Then, untimed: the rows no sequence may
    read poisoned with NaN (the output must not change) and lens = 0 (the
    Pallas kernel's zeros, ROADMAP R8).  Each paged row, fp and int8, also
    checks that the dense kernel over the gathered rows gives its output
    bit for bit (one decode core, one split plan)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import decode_attention as dec
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_quant_fwd)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_fwd, paged_decode_attention_quant_fwd,
        paged_split_plan)

    gather = ref.gather_blocks                  # (B, nb * bs, ...) rows

    D, bs, nb = 64, 16, 32
    for quant in (False, True):
        name = ("paged_decode_attention_quant_fwd" if quant
                else "paged_decode_attention_fwd")
        for (B, KV, G, lo, model) in ((16, 32, 1, 1, "opt-1.3b serve"),
                                      (8, 32, 1, 257, "opt-1.3b ppo"),
                                      (16, 3, 3, 1, "smollm-135m")):
            for dname, dt in dtypes.items():
                q, k, v, sc, tables, lens = _paged_case(
                    gen, B, KV, G, D, bs, nb, lo, dt, quant)
                if quant:
                    kern = lambda: paged_decode_attention_quant_fwd(
                        q, k, v, *sc, tables, lens)
                    plain = lambda: ref.paged_decode_attention_quant_ref(
                        q, k, v, *sc, tables, lens)
                else:
                    kern = lambda: paged_decode_attention_fwd(
                        q, k, v, tables, lens)
                    plain = lambda: ref.paged_decode_attention_ref(
                        q, k, v, tables, lens)
                out, r = kern(), plain()
                torch.cuda.synchronize()
                abs_err = _err(out, r, rel=False)
                scale = float(r.float().abs().max())
                err = abs_err / scale if quant else abs_err
                # the dense kernel over the same rows, gathered beforehand
                ka, va = gather(k, tables), gather(v, tables)
                valid = (torch.arange(nb * bs, device="cuda")[None]
                         < lens[:, None])
                if quant:
                    ksa, vsa = (gather(t, tables).transpose(1, 2)
                                for t in sc)
                    dense = lambda: decode_attention_quant_fwd(
                        q, ka.transpose(1, 2), va.transpose(1, 2), ksa, vsa,
                        valid)
                else:
                    dense = lambda: decode_attention_fwd(
                        q, ka.transpose(1, 2), va.transpose(1, 2), valid)
                qs = q.flatten(1, 2)[:, :, None]           # (B, H, 1, D)
                mask = valid[:, None, None, :]

                def gather_sdpa():
                    kg, vg = gather(k, tables), gather(v, tables)
                    if quant:
                        kg = (kg.float() * gather(sc[0], tables)[..., None]
                              ).to(dt)
                        vg = (vg.float() * gather(sc[1], tables)[..., None]
                              ).to(dt)
                    return F.scaled_dot_product_attention(
                        qs, kg.transpose(1, 2), vg.transpose(1, 2),
                        attn_mask=mask, enable_gqa=G > 1)

                eb = q.element_size()
                need = int(lens.sum())              # valid rows
                row_bytes = (2 * D + 8) if quant else 2 * D * eb
                bnd = bound(2 * B * KV * G * D * eb + 4 * B * (nb + 1)
                            + need * KV * row_bytes,
                            4 * KV * G * D * need,
                            "bf16" if dname == "bf16" else "fp32")
                dense_ms = time_ms(dense)
                sdpa_ms = time_ms(gather_sdpa)
                label = (f"{model} B={B} KV={KV} G={G} bs={bs} nb={nb} "
                         f"lens {lo}-{nb * bs}")
                main = (B, KV, dname) == ((8, 32, "bf16") if quant
                                          else (16, 32, "bf16"))
                k_ms = time_ms(kern)
                run = (paged_decode_attention_quant_fwd if quant
                       else paged_decode_attention_fwd)
                copies = [tuple(t.clone() for t in (k, v, *sc)) for _ in range(
                    cold_copies(bnd[0] * 1e-3 * HBM_BYTES_PER_S))]
                extra = _decode_extra(
                    state, name, f"{label} {dname}", main,
                    paged_split_plan(nb, bs, B * KV, dec.sm_count(0))[0],
                    lambda q=q, kv=(k, v, *sc), t=tables, n=lens, run=run:
                    run(q, *kv, t, n),
                    [lambda c=c: run(q, *c, tables, lens) for c in copies],
                    bnd)
                del copies
                record(name, label, dname, err, tol[("attn", dname)],
                       k_ms, time_ms(plain), None, bnd, main,
                       abs_err=abs_err, extra=extra)
                log(f"[kernels] {name} {label} {dname}: yardsticks: the "
                    f"dense decode kernel over the rows gathered into an "
                    f"arena {dense_ms:.4f} ms, gather + SDPA {sdpa_ms:.4f} "
                    f"ms (no library call computes paged decode)")
                if main:
                    rows[name].update(dense_kernel_ms=dense_ms,
                                      gather_sdpa_ms=sdpa_ms)
                # one core, one split plan: the dense kernel over the
                # gathered rows gives the paged kernel's bits (what keeps
                # greedy streams over the arena and the pool identical)
                same_bits = torch.equal(dense(), out)
                log(f"[kernels] {name} {label} {dname}: the dense kernel "
                    f"over the gathered rows equals it bit for bit: "
                    f"{same_bits}")
                if not same_bits:
                    failures.append(f"{name} {label} {dname}: dense and "
                                    f"paged kernels differ")
                # untimed: poisoned rows are never read; lens = 0 gives 0
                dead = torch.ones(k.shape[:2], dtype=torch.bool,
                                  device="cuda")
                for b in range(B):
                    rr = torch.arange(int(lens[b]), device="cuda")
                    dead[tables[b].long()[rr // bs], rr % bs] = False
                if quant:
                    for t in sc:
                        t[dead] = float("nan")
                else:
                    k[dead] = float("nan")
                    v[dead] = float("nan")
                same = torch.equal(kern(), out)
                lens.zero_()
                zero = kern()
                torch.cuda.synchronize()
                zeros = torch.equal(zero, torch.zeros_like(zero))
                if not (same and zeros):
                    failures.append(f"{name} {label} {dname}: poisoned rows "
                                    f"changed the output: {not same}; "
                                    f"lens = 0 not zeros: {not zeros}")
                log(f"[kernels] {name} {label} {dname}: NaN in every row "
                    f"no sequence may read leaves the output bitwise "
                    f"unchanged: {same}; lens = 0 gives zeros (the Pallas "
                    f"kernel's answer, R8): {zeros}")
                del q, k, v, sc, ka, va


def _int8_streams(cfg, params, prompt, n_dec):
    """The int8-KV gate's runs of ``cfg`` (an int8-KV config, fp32) on one
    prompt (1, Lp): greedy prefill + ``n_dec`` steps through the kernel
    path and through the plain path (each path picks its own tokens), the
    plain path again on an fp32 cache teacher-forced on the plain path's
    tokens (the int8 cache's own error), and the witness: every decode
    step again from clones of the kernel path's int8 cache, on both paths,
    so that only the decode math differs.  Returns {run: (logits, tokens,
    cache)} and the witness's (kernel, plain) logits."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.generate import decode_step, prefill

    Lp = prompt.shape[1]
    runs = {}
    for name, c, forced in (
            ("kernel", cfg, None),
            ("plain", cfg.replace(use_kernels=False), None),
            ("plain-fp32-cache",
             cfg.replace(use_kernels=False, kv_quant=False), "plain")):
        cache = T.init_cache(c, 1, Lp + n_dec, device="cuda")
        lg, cache = prefill(c, params, prompt, cache)
        steps, toks = [lg], []
        for t in range(n_dec):
            tok = lg.argmax(-1) if forced is None else runs[forced][1][t:t + 1]
            toks.append(tok)
            pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
            lg, cache = decode_step(c, params, tok, cache, pos)
            steps.append(lg)
        runs[name] = (torch.cat(steps).float(), torch.cat(toks), cache)
    ta, kcache = runs["kernel"][1], runs["kernel"][2]
    wit = {True: [], False: []}
    for t in range(n_dec):
        pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
        for use_kernels in (True, False):
            lg, _ = decode_step(cfg.replace(use_kernels=use_kernels), params,
                                ta[t:t + 1], tree_map(torch.clone, kcache),
                                pos)
            wit[use_kernels].append(lg.float())
    return runs, (torch.cat(wit[True]), torch.cat(wit[False]))


def phase_parity(state):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("opt-1.3b").replace(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen)
    Lp, n_dec = 256, 32
    tokens = torch.randint(0, cfg.vocab_size, (1, Lp + n_dec), generator=gen,
                           device="cuda")
    logits = {}
    for use_kernels in (True, False):
        c = cfg.replace(use_kernels=use_kernels)
        cache = T.init_cache(c, 1, Lp + n_dec, device="cuda")
        t0 = time.perf_counter()
        lg, cache = prefill(c, params, tokens[:, :Lp], cache)
        steps = [lg]
        for t in range(n_dec):
            pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
            lg, cache = decode_step(c, params, tokens[:, Lp + t], cache, pos)
            steps.append(lg)
        logits[use_kernels] = torch.cat(steps).float()
        torch.cuda.synchronize()
        log(f"[parity] {'kernel' if use_kernels else 'plain'} path: "
            f"{time.perf_counter() - t0:.2f}s")
    a, b = logits[True], logits[False]
    if not (torch.isfinite(a).all() and torch.isfinite(b).all()):
        raise AssertionError("parity: non-finite logits")
    rel = float((a - b).abs().max() / b.abs().max())
    agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
    log(f"[parity] opt-1.3b fp32, {Lp} prefill + {n_dec} decode steps "
        f"(teacher-forced): max|dlogits|/max|logits| = {rel:.3g} (tol 1e-4),"
        f" argmax agreement {agree:.3f}")
    del params, cache, logits
    torch.cuda.empty_cache()
    if rel > 1e-4:
        raise AssertionError(f"parity: relative logit error {rel:.3g}")

    # int8 KV: OPT-1.3B at full width cut to 4 layers, fp32, greedy decode
    # of 32 tokens on the int8 arena, kernel path vs plain path (each path
    # picks its own tokens).  The paths' K/V rows differ by ~1e-7 before
    # the first quantization; values on a rounding edge land one int8 step
    # apart, and each such step moves later layers' rows further.  So the
    # decode math is held at 1e-4 on one shared cache (the witness below),
    # and the free-running gap to the int8 cache's own error (the plain
    # path with an fp32 cache, teacher-forced on the same tokens): at most
    # a tenth of it, with the tokens identical and no value more than one
    # step off
    cfg = get_config("opt-1.3b").replace(n_layers=4, compute_dtype="float32",
                                         kv_quant=True)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    prompt = torch.randint(0, cfg.vocab_size, (1, Lp), generator=gen,
                           device="cuda")
    runs, (wa, wb) = _int8_streams(cfg, params, prompt, n_dec)
    (a, ta, kcache), (b, tb, pcache) = runs["kernel"], runs["plain"]
    ca, cb = kcache[0][0], pcache[0][0]
    fp = runs["plain-fp32-cache"][0]
    rel_wit = float((wa - wb).abs().max() / wb.abs().max())
    wit_same = bool(torch.equal(wa.argmax(-1), wb.argmax(-1)))
    if ca["k"].dtype != torch.int8:
        raise AssertionError("parity: the int8 run did not use an int8 "
                             "cache")
    rel8 = float((a - b).abs().max() / b.abs().max())
    quant_err = float((b - fp).abs().max() / fp.abs().max())
    same = bool(torch.equal(ta, tb))
    steps_apart = max(int((ca[n].int() - cb[n].int()).abs().max())
                      for n in ("k", "v"))
    n_diff = sum(int((ca[n] != cb[n]).sum()) for n in ("k", "v"))
    n_all = ca["k"].numel() + ca["v"].numel()
    log(f"[parity] opt-1.3b 4 layers fp32, int8 KV, {n_dec} decode steps "
        f"from one int8 cache (the kernel path's): kernel vs plain "
        f"max|dlogits|/max|logits| = {rel_wit:.3g} (tol 1e-4), argmax "
        f"identical: {wit_same}")
    log(f"[parity] opt-1.3b 4 layers fp32, int8 KV, {Lp} prefill + {n_dec} "
        f"greedy steps: kernel vs plain path max|dlogits|/max|logits| = "
        f"{rel8:.3g}; int8 cache vs fp32 cache (plain path) {quant_err:.3g}; "
        f"gap / int8 error = {rel8 / quant_err:.3g} (tol 0.1); tokens "
        f"identical: {same}; int8 rows: {n_diff} of {n_all} values differ, "
        f"by at most {steps_apart} step (tol 1)")
    state["parity_int8"] = {"rel": rel8, "quant_err": quant_err,
                            "n_diff": n_diff, "n_all": n_all,
                            "rel_one_cache": rel_wit}
    del params, runs, ca, cb, kcache, pcache, wa, wb
    torch.cuda.empty_cache()
    if not (torch.isfinite(a).all() and wit_same and rel_wit <= 1e-4):
        raise AssertionError(f"parity: int8 KV decode from one cache: "
                             f"kernel vs plain rel {rel_wit:.3g} (tol 1e-4),"
                             f" argmax identical {wit_same}")
    if not (same and steps_apart <= 1 and rel8 <= 0.1 * quant_err):
        raise AssertionError(f"parity: int8 KV kernel path vs plain path: "
                             f"rel {rel8:.3g} vs int8 error {quant_err:.3g}, "
                             f"tokens identical {same}, {n_diff} int8 values "
                             f"differ by up to {steps_apart}")
    _paged_parity(state)


def _paged_stream(cfg, params, tokens, Lp, n_dec, *, layout, bs=16,
                  forced=None):
    """Prefill ``tokens[:, :Lp]`` and run ``n_dec`` decode steps, on the
    dense arena or on a paged pool (the prompt scattered into shuffled,
    non-contiguous blocks, as the engine's admission does).  Teacher-forced
    on ``tokens`` (or on ``forced``), or greedy when both run out.  Returns
    (logits (1 + n_dec, V), fed tokens, cache, block tables or None)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import _scatter_row_blocks
    from repro_torch.serving.generate import decode_step, prefill
    S = Lp + n_dec
    tables = None
    if layout == "paged":
        nb = -(-S // bs)
        perm = torch.randperm(2 * nb, generator=torch.Generator()
                              .manual_seed(nb))[:nb] + 1
        tables = perm.int().cuda()[None]
        row = T.init_cache(cfg, 1, Lp, device="cuda")
        lg, row = prefill(cfg, params, tokens[:, :Lp], row)
        cache = T.init_paged_cache(cfg, 2 * nb + 1, bs, device="cuda")
        n_pre = -(-Lp // bs)
        _scatter_row_blocks(cache, row, tables[0, :n_pre].long(), bs)
    else:
        cache = T.init_cache(cfg, 1, S, device="cuda")
        lg, cache = prefill(cfg, params, tokens[:, :Lp], cache)
    steps, fed = [lg], []
    for t in range(n_dec):
        if forced is not None:
            tok = forced[t:t + 1]
        elif tokens.shape[1] > Lp + t:
            tok = tokens[:, Lp + t]
        else:
            tok = lg.argmax(-1)
        fed.append(tok)
        pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
        lg, cache = decode_step(cfg, params, tok, cache, pos,
                                block_tables=tables)
        steps.append(lg)
    return torch.cat(steps).float(), torch.cat(fed), cache, tables


def _paged_parity(state):
    """OPT-1.3B at full width, 4 layers, fp32: one teacher-forced stream
    (prefill 256 + 32 decode steps) through the paged kernel path, the
    dense kernel path and the paged plain path (1e-4 relative on logits);
    then the dense int8 pair of checks on the paged int8 pool: each decode
    step from one int8 pool through both paths (1e-4, argmax identical),
    and the free-running greedy runs (tokens identical, no int8 value more
    than one step apart, logit gap at most 0.1 of the int8 cache's own
    error)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.generate import decode_step

    cfg = get_config("opt-1.3b").replace(n_layers=4, compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(2)
    params = T.init_params(cfg, gen)
    Lp, n_dec = 256, 32
    tokens = torch.randint(0, cfg.vocab_size, (1, Lp + n_dec), generator=gen,
                           device="cuda")
    ops_paths = {}
    from repro_torch.kernels import ops
    for name, c, layout in (("paged kernel", cfg, "paged"),
                            ("dense kernel", cfg, "dense"),
                            ("paged plain", cfg.replace(use_kernels=False),
                             "paged")):
        ops.reset_launch_counts()
        ops_paths[name] = (_paged_stream(c, params, tokens, Lp, n_dec,
                                         layout=layout)[0],
                           ops.launch_counts())
    ref_lg = ops_paths["paged plain"][0]
    rels = {n: float((lg - ref_lg).abs().max() / ref_lg.abs().max())
            for n, (lg, _) in ops_paths.items() if n != "paged plain"}
    counts = ops_paths["paged kernel"][1]
    same = torch.equal(ops_paths["paged kernel"][0],
                       ops_paths["dense kernel"][0])
    log(f"[parity] opt-1.3b 4 layers fp32, {Lp} prefill + {n_dec} decode "
        f"steps (teacher-forced), max|dlogits|/max|logits| against the "
        f"paged plain path: paged kernel {rels['paged kernel']:.3g}, dense "
        f"kernel {rels['dense kernel']:.3g} (tol 1e-4); paged kernel path "
        f"== dense kernel path bitwise: {same}; paged kernel launches "
        f"{counts}")
    if not (max(rels.values()) <= 1e-4 and torch.isfinite(ref_lg).all()
            and counts["paged_decode_attention_fwd"] == n_dec * 4
            and not any(counts[k] for k in DENSE_DECODE)):
        raise AssertionError(f"parity: paged paths {rels}, launches "
                             f"{counts}")

    # int8 paged pool: witness from one pool, then free-running greedy
    cfg8 = cfg.replace(kv_quant=True)
    prompt = tokens[:, :Lp]
    runs = {}
    for name, c, forced in (
            ("kernel", cfg8, None),
            ("plain", cfg8.replace(use_kernels=False), None),
            ("plain-fp32-cache", cfg.replace(use_kernels=False), "plain")):
        f = None if forced is None else runs[forced][1]
        runs[name] = _paged_stream(c, params, prompt, Lp, n_dec,
                                   layout="paged", forced=f)
    (a, ta, kpool, tables), (b, tb, ppool, _) = runs["kernel"], runs["plain"]
    fp = runs["plain-fp32-cache"][0]
    wit = {True: [], False: []}
    for t in range(n_dec):
        pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
        for uk in (True, False):
            lg, _ = decode_step(cfg8.replace(use_kernels=uk), params,
                                ta[t:t + 1], tree_map(torch.clone, kpool),
                                pos, block_tables=tables)
            wit[uk].append(lg.float())
    wa, wb = torch.cat(wit[True]), torch.cat(wit[False])
    rel_wit = float((wa - wb).abs().max() / wb.abs().max())
    wit_same = bool(torch.equal(wa.argmax(-1), wb.argmax(-1)))
    ka, kb = kpool[0][0], ppool[0][0]
    used = tables[0].long()
    rel8 = float((a - b).abs().max() / b.abs().max())
    quant_err = float((b - fp).abs().max() / fp.abs().max())
    same = bool(torch.equal(ta, tb))
    apart = max(int((ka[n][:, used].int() - kb[n][:, used].int()).abs().max())
                for n in ("k", "v"))
    log(f"[parity] opt-1.3b 4 layers fp32, paged int8 pool: {n_dec} decode "
        f"steps from one pool, kernel vs plain max|dlogits|/max|logits| = "
        f"{rel_wit:.3g} (tol 1e-4), argmax identical {wit_same}; free-"
        f"running greedy: gap {rel8:.3g}, int8 error {quant_err:.3g}, gap / "
        f"int8 error {rel8 / quant_err:.3g} (tol 0.1), tokens identical "
        f"{same}, int8 values at most {apart} step apart (tol 1)")
    state["parity_paged"] = {"rel": rels, "rel_int8_one_pool": rel_wit,
                             "rel_int8": rel8, "quant_err": quant_err}
    del params, runs, kpool, ppool, wit
    torch.cuda.empty_cache()
    if not (wit_same and rel_wit <= 1e-4 and same and apart <= 1
            and rel8 <= 0.1 * quant_err):
        raise AssertionError("parity: paged int8 pool checks failed")


def _opt_step_case(paged: bool, quant: bool = False) -> dict:
    """One OPT-1.3B bf16 decode step at the serve shape, random weights from
    seed 0: 16 slots at positions 64..511 over the dense (16, 512) arena,
    or over a 513-block pool of 16-row blocks, each table as long as its
    position needs; bf16 KV, or int8 KV (``quant``) with its scale planes.
    ``step`` runs it; ``decode_bytes`` is what one decode call of it must
    move (q and out, the mask or the tables, the valid K/V rows and, int8,
    their two fp32 scales)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step
    cfg = get_config("opt-1.3b").replace(kv_quant=quant)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.cast_params(cfg, T.init_params(cfg, gen))
    torch.cuda.empty_cache()
    slots, S, bs, nb = 16, 512, 16, 32
    eb, hd = 2, cfg.head_dim
    qo = 2 * slots * cfg.n_heads * hd * eb
    case = {"cfg": cfg, "params": params, "S": S}
    if not paged:
        cache = T.init_cache(cfg, slots, S, device="cuda")
        toks = torch.randint(0, cfg.vocab_size, (slots, 256), generator=gen,
                             device="cuda")
        pos = torch.randint(64, S, (slots,), generator=gen, device="cuda")
        tok = toks[:, 0]
        case.update(toks=toks, step=lambda: decode_step(cfg, params, tok,
                                                        cache, pos),
                    decode_bytes=qo + slots * S)
    else:
        pool = T.init_paged_cache(cfg, slots * nb + 1, bs, device="cuda")
        pos = torch.randint(64, nb * bs, (slots,), generator=gen,
                            device="cuda")
        tables = torch.zeros((slots, nb), dtype=torch.int32, device="cuda")
        perm = torch.randperm(slots * nb, generator=gen, device="cuda") + 1
        for b in range(slots):
            n = int(pos[b]) // bs + 1
            tables[b, :n] = perm[b * nb:b * nb + n].int()
        tok = torch.randint(0, cfg.vocab_size, (slots,), generator=gen,
                            device="cuda")
        case.update(step=lambda: decode_step(cfg, params, tok, pool, pos,
                                             block_tables=tables),
                    decode_bytes=qo + 4 * slots * (nb + 1))
    row_bytes = 2 * hd + 8 if quant else 2 * hd * eb
    case["decode_bytes"] += int((pos + 1).sum()) * cfg.n_kv_heads * row_bytes
    return case


def _step_timing(paged: bool, quant: bool, state, case=None) -> None:
    """The OPT-1.3B decode step of :func:`_opt_step_case` (or ``case``, one
    built already): its launches, eager (host clock, synchronized, median
    of 20) and as a CUDA-graph replay (device time), kept in ``state``
    under ``step[_paged][_int8]`` with its decode calls for phase
    ``profile``."""
    import torch
    from repro_torch.kernels import ops
    case = case or _opt_step_case(paged, quant)
    step = case["step"]
    ops.reset_launch_counts()
    step()
    per_step = ops.launch_counts()
    wall = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    graph_ms = time_ms(step, inner=4, repeats=5)
    eager_ms = statistics.median(wall)
    what = (f"opt-1.3b {'paged ' if paged else ''}decode step, "
            f"{'int8' if quant else 'bf16'} KV, 16 slots, "
            + ("bs 16, 513-block pool" if paged else "S=512"))
    log(f"[serve] {what}: eager {eager_ms:.3f} ms (host clock), CUDA-graph "
        f"replay {graph_ms:.3f} ms (device); the device is idle "
        f"{1 - graph_ms / eager_ms:.1%} of the eager step; launches "
        f"{per_step}")
    kernel = (("paged_" if paged else "") + "decode_attention"
              + ("_quant" if quant else "") + "_fwd")
    state[_step_key(paged, quant)] = {"eager_ms": eager_ms,
                                      "graph_ms": graph_ms,
                                      "decode_calls": per_step[kernel]}
    del case, step
    torch.cuda.empty_cache()


def _step_key(paged: bool, quant: bool) -> str:
    return "step" + ("_paged" if paged else "") + ("_int8" if quant else "")


def phase_serve(state):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import prefill

    # anatomy of one admission and one decode step at the serve shape
    # (OPT-1.3B bf16, 16 slots, S = 512): kernel launches, and the decode
    # step's time eager (host clock, synchronized) against the same step
    # replayed from a CUDA graph (device time alone; the difference is
    # the host's launch overhead)
    case = _opt_step_case(paged=False)
    cfg, params, toks, S = (case[k] for k in ("cfg", "params", "toks", "S"))
    ops.reset_launch_counts()
    prefill(cfg, params, toks[:1], T.init_cache(cfg, 1, S, device="cuda"))
    log(f"[serve] launches per admission (prefill): {ops.launch_counts()}")
    del params
    _step_timing(False, False, state, case)
    del case
    _step_timing(False, True, state)

    argv = SERVE_ARGV
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launch_counts()
    res = serve.main(argv)
    counts = ops.launch_counts()
    log(f"[serve] opt-1.3b bf16: {res['tokens']} tokens in "
        f"{res['seconds']:.3f}s = {res['tok_s']:.1f} tok/s, slot utilization "
        f"{res['slot_util']:.3f}, stats {res['stats']}")
    log(f"[serve] kernel launches during the run (warm-up included): "
        f"{counts}")
    missing = [k for k in SERVE_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"serve: kernels never launched: {missing}")
    for r in res["requests"]:
        got = res["completions"].get(r.uid)
        if got is None or len(got) != r.max_new_tokens:
            raise AssertionError(f"serve: request {r.uid} returned "
                                 f"{None if got is None else len(got)} "
                                 f"tokens, wanted {r.max_new_tokens}")
        if not all(0 <= t < cfg.vocab_size for t in got):
            raise AssertionError(f"serve: request {r.uid} token out of range")
    state.setdefault("launches", {})["serve"] = counts

    # the workload's repeat on the int8 arena
    argv8 = workload(max_new=REPEAT_NEW) + ["--kv-quant"]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv8)}")
    ops.reset_launch_counts()
    # no warm-up: its tok/s include the int8 run's first calls
    res8 = serve.main(argv8, warmup=False)
    counts8 = ops.launch_counts()
    log(f"[serve] opt-1.3b bf16, int8 KV: {res8['tokens']} tokens in "
        f"{res8['seconds']:.3f}s = {res8['tok_s']:.1f} tok/s (bf16 KV above: "
        f"{res['tok_s']:.1f}), stats {res8['stats']}")
    log(f"[serve] kernel launches during the int8 run: {counts8}")
    missing = [k for k in SERVE_INT8_KERNELS if counts8[k] == 0]
    if missing or counts8["decode_attention_fwd"]:
        raise AssertionError(f"serve --kv-quant: launches {counts8}")
    if res8["tokens"] != sum(r.max_new_tokens for r in res8["requests"]):
        raise AssertionError("serve --kv-quant: the run lost tokens")
    state["launches"]["serve_int8"] = counts8
    state["serve"] = {"tok_s": res["tok_s"], "tok_s_int8": res8["tok_s"],
                      "summary": {k: res[k] for k in ("tokens", "slot_util",
                                                      "tok_s")}}

    argv = ["--arch", "smollm-135m", "--requests", "8", "--ragged",
            "--prompt-len", "64", "--max-new", "32", "--batch", "4",
            "--temperature", "0"]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    res = serve.main(argv)
    if res["tokens"] != sum(r.max_new_tokens for r in res["requests"]):
        raise AssertionError("serve: smollm-135m run lost tokens")
    log(f"[serve] smollm-135m greedy: {res['tokens']} tokens, "
        f"{res['tok_s']:.1f} tok/s")
    _paged_serve(state)


def workload(arch: str = "opt-1.3b", max_new: int = 256) -> list:
    """The serve workload's arguments: 32 ragged requests (prompts up to
    256 tokens, up to ``max_new`` new), 16 slots, chunk 8."""
    return ["--arch", arch, "--requests", "32", "--ragged", "--prompt-len",
            "256", "--max-new", str(max_new), "--batch", "16", "--chunk", "8"]


# every run of the serve workload (phase serve's bf16 run, and its repeats
# on other KV layouts, dtypes and models) and phase hybrid's PPO generate
# up to 64 new tokens a request, to keep the whole script inside its time
# limit; their gates are the same.  The paper's 256 new tokens on OPT-1.3B
# are generated by phase rlhf's PPO iterations and phase async's stale leg
REPEAT_NEW = 64
SERVE_ARGV = workload(max_new=REPEAT_NEW)
PAGED = ["--kv-layout", "paged", "--block-size", "16"]
# greedy, the workload's 32 ragged prompts with 64 new tokens each; a pool
# of 121 blocks makes the paged layout preempt
GREEDY = ["--arch", "opt-1.3b", "--requests", "32", "--ragged",
          "--prompt-len", "256", "--max-new", "64", "--batch", "16",
          "--chunk", "8", "--temperature", "0"]
PREEMPT = PAGED + ["--num-blocks", "121"]


def _serve_run(argv, tag, must, state, warmup=True, cfg=None):
    """``serve.main(argv)`` with the launch counts set to 0 just before and
    read just after; fails unless every kernel of ``must`` launched and, on
    the paged layout, neither dense decode kernel did.  ``warmup=False``
    where an earlier run of this process served the same shapes; ``cfg``
    in place of ``--arch``'s (a cut depth)."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    ops.reset_launch_counts()
    res = serve.main(argv, warmup=warmup, cfg=cfg)
    counts = ops.launch_counts()
    st = res["stats"]
    extra = ""
    if "block_high_water" in st:
        extra = (f", block_high_water {st['block_high_water']} of "
                 f"{st['num_blocks']}, mean_concurrency "
                 f"{st['mean_concurrency']:.2f}, preemptions "
                 f"{st['preemptions']}, prefill_hit_rate "
                 f"{st['prefill_hit_rate']:.3f}")
    log(f"[serve] {tag}: {res['tokens']} tokens in {res['seconds']:.3f}s = "
        f"{res['tok_s']:.1f} tok/s{extra}; launches {counts}")
    missing = [k for k in must if counts[k] == 0]
    paged = "--kv-layout" in argv
    if missing or (paged and any(counts[k] for k in DENSE_DECODE)):
        raise AssertionError(f"serve {tag}: launches {counts}")
    for r in res["requests"]:
        got = res["completions"].get(r.uid)
        if got is None or len(got) != r.max_new_tokens:
            raise AssertionError(f"serve {tag}: request {r.uid} returned "
                                 f"{None if got is None else len(got)} "
                                 f"tokens, wanted {r.max_new_tokens}")
    state.setdefault("launches", {})[tag] = counts
    return res


def _shared_prompt_requests(vocab: int, seed: int = 0):
    """32 chat turns sharing a 192-token system prompt: each adds 16-64
    tokens of its own and asks for up to 128 new tokens."""
    import numpy as np
    from repro_torch.serving.engine import Request
    rng = np.random.default_rng(seed)
    system = rng.integers(0, vocab, 192)
    return [Request(uid=i, tokens=np.concatenate(
        [system, rng.integers(0, vocab, int(rng.integers(16, 65)))]).astype(
            np.int32), max_new_tokens=int(rng.integers(32, 129)))
            for i in range(32)]


def _paged_serve(state):
    """The paged layout at OPT-1.3B: one decode step against the dense
    one; the 32-request workload on the pool in bf16 and int8; greedy
    dense vs paged (identical streams); a pool small enough to preempt
    (identical streams again); the prefix cache on a shared-system-prompt
    mix (hit rate >= 0.5; on vs off identical greedy streams in fp32)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import GenerationEngine

    # one decode step over a 513-block pool, 16 slots at the dense step's
    # positions, each table as long as its position needs; bf16 and int8
    _step_timing(True, False, state)
    _step_timing(True, True, state)

    res8 = _serve_run(workload(max_new=REPEAT_NEW) + PAGED + ["--kv-quant"],
                      "serve_paged_int8", SERVE_PAGED_INT8_KERNELS, state,
                      warmup=False)   # its tok/s include its first calls

    # greedy: dense vs paged (the paged bf16 run of the workload), then a
    # pool that must preempt; the runs above warmed these shapes.  The 32
    # ragged prompts of the workload with 64 new tokens each (not 256: the
    # streams' identity is gated on every token either way), so the
    # preempting pool is 121 blocks
    greedy = GREEDY
    d = _serve_run(greedy, "serve_greedy_dense", SERVE_KERNELS, state,
                   warmup=False)
    p = _serve_run(greedy + PAGED, "serve_greedy_paged", SERVE_PAGED_KERNELS,
                   state, warmup=False)
    pre = _serve_run(greedy + PREEMPT, "serve_greedy_preempt",
                     SERVE_PAGED_KERNELS, state, warmup=False)
    same = d["completions"] == p["completions"]
    same_pre = pre["completions"] == p["completions"]
    n_pre = pre["stats"]["preemptions"]
    log(f"[serve] greedy streams: paged == dense {same}; a 121-block pool "
        f"preempted {n_pre} times, streams == the unconstrained paged run "
        f"{same_pre}")
    state["serve"].update(tok_s_paged_int8=res8["tok_s"],
                          tok_s_greedy_dense=d["tok_s"],
                          tok_s_greedy_paged=p["tok_s"],
                          tok_s_greedy_preempt=pre["tok_s"],
                          preemptions=n_pre)
    if not (same and same_pre and n_pre > 0):
        raise AssertionError(f"serve: greedy paged == dense {same}, "
                             f"preempted run == paged {same_pre}, "
                             f"preemptions {n_pre}")

    # the prefix cache on chat turns sharing a system prompt, in bf16 (the
    # serving dtype: tok/s and the hit rate) and in fp32 (TF32 off), where
    # cache on and off must give identical greedy streams.  In bf16 they
    # need not: the suffix prefill's GEMMs have another row count than the
    # full prompt's (64 against 256 here), so cuBLAS sums in another order
    # and the bf16 rounding of the suffix rows differs; a near-tie argmax
    # then flips.  So bf16 reports how many streams are identical
    torch.backends.cuda.matmul.allow_tf32 = False
    reqs = _shared_prompt_requests(get_config("opt-1.3b").vocab_size)
    S = max(len(r.tokens) + r.max_new_tokens for r in reqs)
    for dname in ("bfloat16", "float32"):
        cfg = get_config("opt-1.3b").replace(compute_dtype=dname)
        params = T.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
        outs = {}
        for pc in (False, True):
            eng = GenerationEngine(cfg, max_new_tokens=128, temperature=0.0,
                                   chunk=8, kv_layout="paged", block_size=16,
                                   prefix_cache=pc, device="cuda")
            kw = dict(mode="continuous", slots=16, max_seq_len=S)
            ops.reset_launch_counts()   # no warm-up: the gates are the hit
            # rate and the fp32 identity; the tok/s are cold (first calls in)
            n_tok, st, dt, fin = serve.run_schedule(
                eng, params, reqs,
                torch.Generator(device="cuda").manual_seed(1), **kw)
            counts = ops.launch_counts()
            tag = f"serve_prefix_{'on' if pc else 'off'}_{dname}"
            state["launches"][tag] = counts
            outs[pc] = (fin, st, n_tok / dt)
            log(f"[serve] shared-system-prompt mix (32 requests, 192 + "
                f"16-64 prompt tokens, 32-128 new), {tag}: {n_tok} tokens "
                f"in {dt:.3f}s = {n_tok / dt:.1f} tok/s cold (first calls "
                f"included: not a rate to compare), prefill_hit_rate "
                f"{st['prefill_hit_rate']:.3f} (cached "
                f"{st['cached_prefill_tokens']}, computed "
                f"{st['computed_prefill_tokens']} prompt tokens), "
                f"block_high_water {st['block_high_water']}, "
                f"mean_concurrency {st['mean_concurrency']:.2f}; launches "
                f"{counts}")
            if (counts["paged_decode_attention_fwd"] == 0
                    or any(counts[k] for k in DENSE_DECODE)):
                raise AssertionError(f"serve {tag}: launches {counts}")
        on, off = outs[True][0], outs[False][0]
        same = [u for u in off if on[u] == off[u]]
        first = sorted(next(i for i, (a, b) in enumerate(zip(on[u], off[u]))
                            if a != b) for u in off if u not in same)
        hit = outs[True][1]["prefill_hit_rate"]
        log(f"[serve] prefix cache on vs off, {dname}: {len(same)} of "
            f"{len(off)} greedy streams identical; the others first differ "
            f"at generated token {first}")
        state["serve"][f"prefix_{dname}"] = {
            "hit_rate": hit, "tok_s_on_cold": outs[True][2],
            "tok_s_off_cold": outs[False][2], "identical": len(same)}
        del params
        torch.cuda.empty_cache()
        if hit < 0.5 or (dname == "float32" and len(same) != len(off)):
            raise AssertionError(f"serve: prefix cache, {dname}: hit rate "
                                 f"{hit:.3f} (want >= 0.5), {len(same)} of "
                                 f"{len(off)} streams identical")


def _profile_step(step_fn, kernels=("flash_bwd", "flash_fwd", "rmsnorm")):
    """Device time of one call of ``step_fn`` by kernel, from
    ``torch.profiler``: (total device ms, {bucket: ms}, [(kernel, ms)]
    longest first), or None when the profiler sees no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step_fn()
        torch.cuda.synchronize()
    per_kernel = {}
    for evt in prof.events():
        if evt.device_type != torch.autograd.DeviceType.CUDA:
            continue
        per_kernel[evt.name] = (per_kernel.get(evt.name, 0.0)
                                + evt.time_range.elapsed_us() / 1e3)
    total = sum(per_kernel.values())
    if total <= 0:
        return None
    buckets = {k: 0.0 for k in kernels}
    buckets["gemm"] = buckets["other"] = 0.0
    for name, ms in per_kernel.items():
        low = name.lower()
        hit = next((k for k in kernels if k in low), None)
        if hit is None:
            hit = ("gemm" if any(w in low for w in (
                "gemm", "cutlass", "xmma", "nvjet", "cublas")) else "other")
        buckets[hit] += ms
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])
    return total, buckets, top


def _decode_in_step(step_fn, n_calls: int, nbytes: float, what: str):
    """The decode kernels' device time inside one decode step:
    ``torch.profiler`` over one replay of the step's CUDA graph (or, if the
    profiler sees no decode kernel there, over one eager step), summed over
    the decode core's split and combine kernels; per call, and against the
    bound of ``nbytes``, the bytes one call of the step must move."""
    keys = ("decode::split_kernel", "decode::combine_kernel")
    graph = capture_graph(step_fn)
    where, res = "graph replay", _profile_step(graph.replay, kernels=keys)
    if res is None or not sum(res[1][k] for k in keys):
        where, res = "eager step", _profile_step(step_fn, kernels=keys)
    del graph
    if res is None or not sum(res[1][k] for k in keys):
        log(f"[profile] {what}: the profiler saw no decode kernel; the "
            f"decode time inside the step is not measured")
        return None
    total, buckets = res[0], res[1]
    dec_ms = sum(buckets[k] for k in keys)
    per_call = dec_ms / n_calls
    bnd_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"where": where, "decode_ms": dec_ms, "per_call_ms": per_call,
           "bound_ms": bnd_ms, "achieved_gbs": nbytes / (per_call * 1e-3)
           / 1e9, "step_kernel_ms": total}
    log(f"[profile] {what}: torch.profiler over one {where}: {n_calls} "
        f"decode calls take {dec_ms:.4f} ms of the step's {total:.3f} ms of "
        f"kernel time, {per_call:.4f} ms a call (split "
        f"{buckets[keys[0]]:.4f}, combine {buckets[keys[1]]:.4f} ms in "
        f"all); bound {bnd_ms:.4f} ms a call, achieved "
        f"{out['achieved_gbs']:.1f} GB/s")
    return out


def phase_train(state):
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import reward as R
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.training.steps import (lm_value_and_grad,
                                            reward_train_step)
    from repro_torch.training.train_state import TrainState

    # (a) kernel path vs plain path: OPT-1.3B at full width, 4 layers, fp32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config("opt-1.3b").replace(n_layers=4, compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen)
    batch = launch_train.to_device(
        next(launch_train.lm_data(cfg, 512, 0).sft_batches(4, 1)), "cuda")
    res = {}
    for uk in (True, False):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        (loss, _), grads = lm_value_and_grad(cfg.replace(use_kernels=uk),
                                             params, batch)
        torch.cuda.synchronize()
        res[uk] = (float(loss), tree_leaves(grads), ops.launch_counts(),
                   time.perf_counter() - t0)
    (lk, gk, ck, tk), (lp, gp, _, tp) = res[True], res[False]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = worst(float((a - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(gk, gp))
    log(f"[train] opt-1.3b full width, 4 of 24 layers, fp32, batch 4 x 512, "
        f"remat on: kernel path loss {lk:.6f} ({tk:.2f}s, launches {ck}), "
        f"plain path loss {lp:.6f} ({tp:.2f}s); |dloss|/|loss| = "
        f"{loss_rel:.3g} (tol 1e-5), max over {len(gk)} grad leaves of "
        f"max|dgrad|/max|grad| = {grad_rel:.3g} (tol 1e-4)")
    del params, grads, res, gk, gp
    torch.cuda.empty_cache()
    if not (math.isfinite(lk) and loss_rel <= 1e-5 and grad_rel <= 1e-4):
        raise AssertionError(f"train: kernel path vs plain path: loss rel "
                             f"{loss_rel:.3g}, grad rel {grad_rel:.3g}")
    if min(ck[k] for k in TRAIN_KERNELS) == 0:
        raise AssertionError(f"train: kernel path skipped a kernel: {ck}")

    # (b) the SFT entry point: OPT-1.3B, full width and depth, bf16
    argv = ["--arch", "opt-1.3b", "--steps", "10", "--batch", "8",
            "--seq", "512"]
    log(f"[train] python -m repro_torch.launch.train {' '.join(argv)}")
    ops.reset_launch_counts()
    out = launch_train.main(argv)
    counts = ops.launch_counts()
    state.setdefault("launches", {})["train"] = counts
    losses = out["loss"]
    steady = out["step_ms"][1:]
    log(f"[train] opt-1.3b bf16 SFT losses: "
        f"{' '.join(f'{x:.4f}' for x in losses)}")
    log(f"[train] step ms: {' '.join(f'{x:.1f}' for x in out['step_ms'])}; "
        f"median after the first {statistics.median(steady):.1f} ms, "
        f"{out['tok_s']:.1f} tok/s, peak memory "
        f"{out['peak_mem_bytes'] / 2**30:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    log(f"[train] launches per step: {out['launches'][-1]}; in the run: "
        f"{counts}")
    state["train"] = {"step_ms": statistics.median(steady),
                      "tok_s": out["tok_s"],
                      "peak_gib": out["peak_mem_bytes"] / 2**30}
    if not all(math.isfinite(x) for x in losses) or losses[-1] >= losses[0]:
        raise AssertionError(f"train: SFT losses not finite and falling: "
                             f"{losses}")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        raise AssertionError(f"train: kernels never launched: {missing}")

    # (c) reward-model training: OPT-350M, full width and depth, bf16
    cfg = get_config("opt-350m")
    rstate = TrainState.create(R.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(2)))
    bl = launch_train.lm_data(cfg, 512, 0)
    accs, rlosses, rms = [], [], []
    for i, rb in enumerate(bl.reward_batches(8, 5)):
        rb = launch_train.to_device(rb, "cuda")
        t0 = time.perf_counter()
        rstate, m = reward_train_step(cfg, rstate, rb, 1e-5)
        rlosses.append(float(m["loss"]))
        accs.append(float(m["rm_acc"]))
        rms.append((time.perf_counter() - t0) * 1e3)
        log(f"[train] reward step {i}: loss={rlosses[-1]:.4f} "
            f"rm_acc={accs[-1]:.3f} gnorm={float(m['grad_norm']):.3f} "
            f"{rms[-1]:.1f} ms")
    log(f"[train] opt-350m reward model, 8 pairs x 512 tokens: median step "
        f"{statistics.median(rms[1:]):.1f} ms, mean rm_acc "
        f"{np.mean(accs):.3f}")
    del rstate
    torch.cuda.empty_cache()
    if not all(math.isfinite(x) for x in rlosses):
        raise AssertionError(f"train: reward losses not finite: {rlosses}")


def _checksum(params) -> float:
    """A float64 sum over every leaf, to show a frozen model did not move."""
    import torch
    from repro_torch.models.modules import tree_leaves
    return float(sum(t.double().sum() for t in tree_leaves(params)))


def phase_rlhf(state):
    import math

    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_config
    from repro_torch.core import (PPOConfig, RLHFEngine, RLHFPipeline,
                                  StageConfig)
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_data
    from repro_torch.serving.engine import GenerationEngine

    # the paper's single-GPU recipe at full width and depth: OPT-1.3B actor
    # and reference, OPT-350M critic and reward model, bf16 compute on fp32
    # masters; 256 prompt + 256 generated tokens on the copy + sort blend
    actor, critic = get_config("opt-1.3b"), get_config("opt-350m")
    bl = lm_data(actor, 512, 0)
    stages = StageConfig(sft_steps=4, sft_batch=8, rm_steps=4, rm_batch=8,
                         ppo_steps=2, ppo_batch=8)
    ppo = PPOConfig(max_new_tokens=256, temperature=1.0, ptx_coef=0.05,
                    use_ema=True, kv_quant=True)
    torch.cuda.reset_peak_memory_stats()
    eng = RLHFEngine(actor, critic,
                     torch.Generator(device="cuda").manual_seed(0))
    pipe = RLHFPipeline(eng, bl, stages, ppo)
    log(f"[rlhf] actor {actor.name} ({actor.n_params() / 1e9:.2f} B), "
        f"critic/reward {critic.name} ({critic.n_params() / 1e9:.2f} B); "
        f"SFT {stages.sft_steps} steps, RM {stages.rm_steps} steps, PPO "
        f"{stages.ppo_steps} iterations with int8 KV + 1 with bf16 KV; "
        f"batch 8, 256 + 256 tokens, ptx 0.05, EMA on")
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    pipe.run_sft()
    pipe.run_reward()
    log(f"[rlhf] stage 1 (SFT): {pipe.timings['stage1']:.2f}s, losses "
        f"{' '.join(f'{x:.4f}' for x in pipe.log['stage1'])}, step ms "
        f"{' '.join(f'{x:.1f}' for x in pipe.step_ms['stage1'])}")
    log(f"[rlhf] stage 2 (RM): {pipe.timings['stage2']:.2f}s, losses "
        f"{' '.join(f'{x:.4f}' for x in pipe.log['stage2'])}, acc "
        f"{' '.join(f'{x:.3f}' for x in pipe.rm_acc)}, step ms "
        f"{' '.join(f'{x:.1f}' for x in pipe.step_ms['stage2'])}")
    log(f"[rlhf] peak memory over stages 1-2: "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    frozen = {"ref": _checksum(eng.ref_params),
              "reward": _checksum(eng.reward_params)}

    snaps, peaks = [], []

    def iter_hook(i):
        # launches and peak memory per iteration, read at the next hook
        if snaps:
            peaks.append(torch.cuda.max_memory_allocated())
        snaps.append(ops.launch_counts())
        torch.cuda.reset_peak_memory_stats()

    pipe.iter_hook = iter_hook
    pipe.run_ppo()
    peaks.append(torch.cuda.max_memory_allocated())
    snaps.append(ops.launch_counts())
    trainer = pipe.trainer
    iters = [dict(m, kv="int8") for m in pipe.log["stage3"]]

    # one more iteration on the same trainer with a bf16 KV cache, at
    # REPEAT_NEW new tokens (phase async's stale leg decodes 256 on it)
    trainer.gen_engine = GenerationEngine(
        actor, max_new_tokens=REPEAT_NEW,
        temperature=ppo.temperature, chunk=ppo.decode_chunk, device="cuda")
    batch = next(bl.prompt_batches(8, 4, skip=3))
    ptx = to_device(next(bl.pretrain_batches(8, 4, skip=3)), "cuda")
    torch.cuda.reset_peak_memory_stats()
    exp, gm = trainer.generate_experience(
        batch["prompts"], torch.Generator(device="cuda").manual_seed(7))
    tm = trainer.train_rlhf(exp, ptx)
    peaks.append(torch.cuda.max_memory_allocated())
    snaps.append(ops.launch_counts())
    iters.append(dict(gm, **tm, kv="bf16"))
    total = ops.launch_counts()
    state.setdefault("launches", {})["rlhf"] = total
    wall = time.perf_counter() - t0

    failures = []
    for i, m in enumerate(iters):
        launches = {k: snaps[i + 1][k] - snaps[i][k] for k in total}
        m["launches"] = launches
        m["peak_gib"] = peaks[i] / 2**30
        log(f"[rlhf] PPO iteration {i} ({m['kv']} KV): gen {m['gen_s']:.2f}s "
            f"= {m['gen_tok_s']:.1f} tok/s ({m['decode_steps']:.0f} decode "
            f"steps), scoring {m['score_ms']:.1f} ms, actor step "
            f"{m['actor_ms']:.1f} ms, critic step {m['critic_ms']:.1f} ms; "
            f"ratio_mean {m['ratio_mean']:.6f} approx_kl "
            f"{m['approx_kl']:.3g} reward_score {m['reward_score']:.4f} "
            f"actor_loss {m['actor_loss']:.4f} ptx_loss {m['ptx_loss']:.4f} "
            f"v_loss {m['v_loss']:.4f}; peak {m['peak_gib']:.2f} GiB")
        log(f"[rlhf]   launches: {launches}")
        nums = [v for k, v in m.items() if isinstance(v, float)]
        if not all(math.isfinite(v) for v in nums):
            failures.append(f"iteration {i}: non-finite metric")
        used, unused = (("decode_attention_quant_fwd", "decode_attention_fwd")
                        if m["kv"] == "int8" else
                        ("decode_attention_fwd", "decode_attention_quant_fwd"))
        if launches[used] == 0 or launches[unused] != 0:
            failures.append(f"iteration {i} ({m['kv']} KV): launches "
                            f"{launches}")
    if abs(iters[0]["ratio_mean"] - 1.0) > 1e-3:
        failures.append(f"first ratio_mean {iters[0]['ratio_mean']} != 1")
    after = {"ref": _checksum(trainer.ref_params),
             "reward": _checksum(trainer.reward_params)}
    log(f"[rlhf] checksums before stage 3 {frozen}, after {after}")
    if after != frozen:
        failures.append("the frozen reference or reward model moved")
    if _checksum(trainer.actor.params) == _checksum(eng.ref_params):
        failures.append("the actor did not move")
    missing = [k for k in RLHF_KERNELS if total[k] == 0]
    if missing:
        failures.append(f"kernels never launched: {missing}")
    log(f"[rlhf] pipeline {wall:.1f}s; stage 3 ({stages.ppo_steps} int8 "
        f"iterations) "
        f"{pipe.timings['stage3']:.1f}s, gen {pipe.gen_tok_s:.1f} tok/s "
        f"mean; peak memory over the phase "
        f"{max(peaks) / 2**30:.2f} GiB; launches {total}")
    state["rlhf"] = {"iters": iters, "timings": dict(pipe.timings),
                     "step_ms": pipe.step_ms}

    failures += _paged_ppo_iteration(state, trainer, bl, ptx)
    del trainer, pipe, eng, exp
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("rlhf: " + "; ".join(failures))


def _paged_ppo_iteration(state, trainer, bl, ptx) -> list:
    """One more PPO iteration on the same trainer, on the request path
    with the reference's best-of-n recipe: 8 prompts x 4 samples of 64
    new tokens, generated on the paged int8 pool with the prefix cache.
    Returns the failed gates: every metric finite, the paged int8 kernel
    launched and neither dense decode kernel, the hit rate reported."""
    import dataclasses
    import math

    import numpy as np
    import torch
    from repro_torch.kernels import ops
    from repro_torch.serving.engine import GenerationEngine, Request

    ppo = dataclasses.replace(trainer.ppo, kv_layout="paged",
                              kv_block_size=16, kv_quant=True,
                              prefix_cache=True, n_samples_per_prompt=4,
                              max_new_tokens=64)
    trainer.ppo = ppo
    trainer.gen_engine = GenerationEngine(
        trainer.actor_cfg.replace(kv_quant=True),
        max_new_tokens=ppo.max_new_tokens, temperature=ppo.temperature,
        chunk=ppo.decode_chunk, kv_layout="paged", block_size=16,
        prefix_cache=True, device="cuda")
    prompts = next(bl.prompt_batches(8, 5, skip=4))["prompts"]
    reqs = [Request(uid=i, tokens=np.asarray(p, np.int32),
                    max_new_tokens=ppo.max_new_tokens)
            for i, p in enumerate(np.asarray(prompts))]
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    exp, gm = trainer.generate_experience(
        reqs, torch.Generator(device="cuda").manual_seed(9))
    tm = trainer.train_rlhf(exp, ptx)
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    state.setdefault("launches", {})["rlhf_paged"] = counts
    m = {**gm, **tm}
    st = trainer.gen_engine.last_stats
    log(f"[rlhf] PPO iteration on the request path, paged int8 pool + "
        f"prefix cache, 8 prompts x 4 samples x {ppo.max_new_tokens} new "
        f"tokens (8 slots): {wall:.2f}s; gen {m['gen_s']:.2f}s = "
        f"{m['gen_tok_s']:.1f} tok/s ({m['decode_steps']:.0f} decode "
        f"steps), prefill_hit_rate {m.get('prefill_hit_rate', float('nan')):.3f}"
        f", block_high_water {st['block_high_water']} of "
        f"{st['num_blocks']}, preemptions {st['preemptions']}; scoring "
        f"{m['score_ms']:.1f} ms, actor step {m['actor_ms']:.1f} ms, critic "
        f"step {m['critic_ms']:.1f} ms; ratio_mean {m['ratio_mean']:.6f} "
        f"reward_score {m['reward_score']:.4f}; peak "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    log(f"[rlhf]   launches: {counts}")
    state["rlhf_paged"] = {k: v for k, v in m.items()
                           if isinstance(v, float)}
    failures = []
    if exp.sequences.shape[0] != 32:
        failures.append(f"paged iteration: {exp.sequences.shape[0]} rows")
    if not all(math.isfinite(v) for v in state["rlhf_paged"].values()):
        failures.append("paged iteration: non-finite metric")
    if (counts["paged_decode_attention_quant_fwd"] == 0
            or any(counts[k] for k in DENSE_DECODE)
            or min(counts[k] for k in RLHF_PAGED_KERNELS) == 0):
        failures.append(f"paged iteration: launches {counts}")
    if "prefill_hit_rate" not in m:
        failures.append("paged iteration: no prefill_hit_rate")
    return failures


# --------------------------------------------------------------------- #
# asynchronous stage 3: the replay queue, the publisher, the producer
# --------------------------------------------------------------------- #
ASYNC_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd",
                 "decode_attention_fwd")
# wall-time and async-only keys: left out of the lockstep == sync gate
ASYNC_WALL = ("gen_tok_s", "gen_s", "score_ms", "actor_ms", "critic_ms",
              "publish_s", "publish_bytes", "queue_depth", "policy_lag",
              "is_ratio_mean", "is_ratio_max", "lockstep_fallback")
ASYNC_LAUNCHER = ["--arch", "opt-125m", "--rlhf", "--async-rlhf", "--max-lag",
                  "1", "--steps", "2", "--batch", "8", "--seq", "256",
                  "--max-new", "32"]


def _async_leg(tag, eng, start, bl, stages, ppo, async_cfg):
    """One stage-3 run of ``stages.ppo_steps`` iterations from ``start``
    (the actor's and critic's params, owned by the run) with the generator
    seeded 3, synchronous (``async_cfg`` None) or asynchronous.  Returns
    what the gates read: per iteration the metrics, the sequences scored,
    the generator state after it (the sync loop's, or the one the consumed
    item carried) and the wall time (top of one iteration to the next);
    the queue's cumulative waits at each get; the launches, the peak and
    ``memory_allocated`` before and after; and the final actor, critic and
    EMA params (``final``: the trainer's own trees, on the card)."""
    import torch
    from repro_torch.core import RLHFPipeline
    from repro_torch.core import ppo as tppo
    from repro_torch.core import replay
    from repro_torch.kernels import ops

    eng.actor_params, eng.critic_params = start
    del start
    pipe = RLHFPipeline(eng, bl, stages, ppo, async_cfg=async_cfg)
    generator = torch.Generator(device="cuda").manual_seed(3)
    seqs, states, waits, tops = [], [], [], []
    score, get = tppo.PPOTrainer.score_rollout, replay.ReplayQueue.get

    def recording_score(self, rollout, **kw):
        seqs.append(torch.as_tensor(rollout.sequences).cpu())
        return score(self, rollout, **kw)

    def recording_get(self, timeout=None):
        item = get(self, timeout)
        states.append(item.generator_state.clone())
        s = self.stats()
        waits.append((s["put_wait_s"], s["get_wait_s"]))
        return item

    def iter_hook(i):
        if async_cfg is None and i > 0:
            states.append(generator.get_state())
        tops.append(time.perf_counter())

    pipe.iter_hook = iter_hook
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    tppo.PPOTrainer.score_rollout = recording_score
    replay.ReplayQueue.get = recording_get
    ops.reset_launch_counts()
    try:
        pipe.run_ppo(generator)
    finally:
        tppo.PPOTrainer.score_rollout = score
        replay.ReplayQueue.get = get
    torch.cuda.synchronize()
    tops.append(time.perf_counter())
    counts = ops.launch_counts()
    if async_cfg is None:
        states.append(generator.get_state())
    tr = pipe.trainer
    out = {"log": pipe.log["stage3"], "seqs": seqs, "states": states,
           "waits": waits, "async": pipe.async_stats, "launches": counts,
           "wall_s": [b - a for a, b in zip(tops, tops[1:])],
           "stage3_s": pipe.timings["stage3"],
           "peak": torch.cuda.max_memory_allocated(), "before": before,
           "after": torch.cuda.memory_allocated(),
           "final": {"actor": tr.actor.params, "critic": tr.critic.params,
                     "ema": tr.ema}}
    for i, m in enumerate(out["log"]):
        lag = (f"; policy_lag {m['policy_lag']:.0f} is_ratio_mean "
               f"{m['is_ratio_mean']:.6f} is_ratio_max "
               f"{m['is_ratio_max']:.6f} publish_s {m['publish_s']:.4f}"
               if "policy_lag" in m else "")
        qw = (f"; queue waits so far put {waits[i][0]:.3f}s get "
              f"{waits[i][1]:.3f}s" if i < len(waits) else "")
        log(f"[async] {tag} iteration {i}: wall {out['wall_s'][i]:.2f}s, gen "
            f"{m['gen_s']:.2f}s = {m['gen_tok_s']:.1f} tok/s, scoring "
            f"{m['score_ms']:.1f} ms, actor {m['actor_ms']:.1f} ms, critic "
            f"{m['critic_ms']:.1f} ms; reward_score {m['reward_score']:.4f}"
            f"{lag}{qw}")
    log(f"[async] {tag}: stage 3 {out['stage3_s']:.2f}s; peak "
        f"{out['peak'] / 2**30:.2f} GiB; memory_allocated before "
        f"{before / 2**30:.2f} GiB, after {out['after'] / 2**30:.2f} GiB; "
        f"launches {counts}")
    if pipe.async_stats:
        a = pipe.async_stats
        log(f"[async] {tag}: produced {a['produced']}, queue {a['queue']}, "
            f"publisher {a['publisher']}, retained "
            f"{a['retained_bytes'] / 1e9:.3f} GB, fallbacks "
            f"{a['lockstep_fallbacks']}")
    eng.actor_params = eng.critic_params = None
    del pipe, tr
    torch.cuda.empty_cache()
    return out


def phase_async(state):
    """Asynchronous stage 3 at the RLHF cell's full width and depth
    (OPT-1.3B actor and reference, OPT-350M critic and reward model, bf16
    on fp32 masters, 8 x 256 prompt tokens, ptx 0.05, EMA on; random
    weights, the reference and reward model copies of the start): (1) 3
    iterations at 64 new tokens (temperature 1.0) synchronous and under
    ``AsyncConfig.lockstep()`` from one state and one generator seed:
    sequences, metrics without the wall-time keys, the final actor, critic
    and EMA params bit for bit, and each consumed item's generator state
    equal to the synchronous loop's after that iteration; (2) 4 iterations
    under ``AsyncConfig(publish_every=2, max_lag=1)`` at 256 new tokens,
    from where the synchronous leg ended:
    ``policy_lag`` exactly 0, 1, 0, 1, ``is_ratio_*`` exactly 1.0 at lag 0
    and finite and positive at lag 1, ``produced == 4``, ``puts == gets +
    dropped + depth``, RMSNorm, both flash kernels and the dense decode
    kernel launched; (3) ``launch.train --rlhf --async-rlhf --max-lag 1``
    at OPT-125M (2 steps a stage): its ``async`` summary, ``produced``
    equal to the PPO steps."""
    import dataclasses
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import AsyncConfig, PPOConfig, RLHFEngine, StageConfig
    from repro_torch.core.pipeline import clone_params
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.train import lm_data
    from repro_torch.models.modules import tree_leaves

    failures = []
    if "disagg" in state.get("phases", ()):
        # phase disagg's ranks start now and initialize beside this phase
        state["disagg_run"] = _start_disagg()
    actor, critic = get_config("opt-1.3b"), get_config("opt-350m")
    bl = lm_data(actor, 512, 0)
    eng = RLHFEngine(actor, critic,
                     torch.Generator(device="cuda").manual_seed(0))
    start = (eng.actor_params, eng.critic_params)
    eng.ref_params = clone_params(eng.actor_params)
    eng.reward_params = clone_params(eng.critic_params)
    ppo = PPOConfig(max_new_tokens=REPEAT_NEW, temperature=1.0,
                    ptx_coef=0.05, use_ema=True)
    stages = StageConfig(ppo_steps=3, ppo_batch=8)
    log(f"[async] actor {actor.name}, critic/reward {critic.name}, bf16 on "
        f"fp32 masters, 8 x 256 prompts; (1) {stages.ppo_steps} iterations "
        f"at {ppo.max_new_tokens} new tokens, sync then lockstep")

    # (1) lockstep == sync, bit for bit: sync on a copy of the start,
    # lockstep on the start itself; the final params compared on the card
    legs = {"sync": _async_leg(
        "sync", eng, tuple(clone_params(t) for t in start), bl, stages, ppo,
        None)}
    legs["lockstep"] = _async_leg("lockstep", eng, start, bl, stages, ppo,
                                  AsyncConfig.lockstep())
    del start
    s, a = legs["sync"], legs["lockstep"]
    strip = lambda m: {k: v for k, v in m.items() if k not in ASYNC_WALL}
    same = {
        "sequences": len(s["seqs"]) == len(a["seqs"]) == stages.ppo_steps
        and all(torch.equal(x, y) for x, y in zip(s["seqs"], a["seqs"])),
        "metrics": [strip(m) for m in s["log"]]
        == [strip(m) for m in a["log"]],
        "generator_states": len(a["states"]) == len(s["states"])
        and all(torch.equal(x, y) for x, y in zip(s["states"], a["states"])),
        **{k: all(torch.equal(x, y) for x, y in zip(
            tree_leaves(s["final"][k]), tree_leaves(a["final"][k])))
           for k in ("actor", "critic", "ema")}}
    log(f"[async] lockstep == sync: {same}")
    # what phase disagg holds the split's synchronous and lockstep legs to
    state["async_sync"] = _sync_record(s)
    for i, (ms, ma) in enumerate(zip(s["log"], a["log"])):
        diff = {k: (ms.get(k), ma.get(k)) for k in set(strip(ms))
                | set(strip(ma)) if ms.get(k) != ma.get(k)}
        if diff:
            log(f"[async]   iteration {i} differs: {diff}")
    if not all(same.values()):
        failures.append(f"lockstep != sync: {same}")
    if any(m["policy_lag"] != 0.0 or m["is_ratio_max"] != 1.0
           for m in a["log"]) or a["async"]["produced"] != stages.ppo_steps:
        failures.append("lockstep: not on policy, or not every batch")
    state.setdefault("launches", {})["async_lockstep"] = a["launches"]
    # (2) one step stale at the paper's 256 new tokens, from where the
    # synchronous leg ended
    start = (s["final"]["actor"], s["final"]["critic"])
    del legs, s, a
    torch.cuda.empty_cache()
    stale_ppo = dataclasses.replace(ppo, max_new_tokens=256)
    stale_cfg = AsyncConfig(publish_every=2, max_lag=1)
    st = _async_leg("stale", eng, start, bl,
                    dataclasses.replace(stages, ppo_steps=4), stale_ppo,
                    stale_cfg)
    del start
    st.pop("final")
    lags = [m["policy_lag"] for m in st["log"]]
    q = st["async"]["queue"]
    ratios_ok = all(
        (m["is_ratio_mean"] == m["is_ratio_max"] == 1.0) if lag == 0 else
        all(math.isfinite(m[k]) and m[k] > 0
            for k in ("is_ratio_mean", "is_ratio_max"))
        for lag, m in zip(lags, st["log"]))
    if lags != [0.0, 1.0, 0.0, 1.0]:
        failures.append(f"stale: policy_lag {lags}, wanted 0, 1, 0, 1")
    if not ratios_ok:
        failures.append("stale: is_ratio_* not 1.0 at lag 0 or not finite "
                        "and positive at lag 1")
    if st["async"]["produced"] != 4:
        failures.append(f"stale: produced {st['async']['produced']}")
    if q["puts"] != q["gets"] + q["dropped"] + q["depth"]:
        failures.append(f"stale: queue {q}")
    nums = [v for m in st["log"] for v in m.values() if isinstance(v, float)]
    if not all(math.isfinite(v) for v in nums):
        failures.append("stale: non-finite metric")
    _launched("async_stale", st["launches"], ASYNC_KERNELS, state, failures)
    state["async"] = {
        "lockstep_equal": same, "stale_lags": lags,
        "stale_wall_s": st["wall_s"], "stale_stage3_s": st["stage3_s"],
        "stale_peak_gib": st["peak"] / 2**30,
        "retained_gb": st["async"]["retained_bytes"] / 1e9,
        "queue": q, "publisher": st["async"]["publisher"]}
    del st
    eng = None
    torch.cuda.empty_cache()
    if "disagg_run" in state:
        # the card now has room for phase disagg's ranks (this phase's
        # launcher runs OPT-125M): they start their legs beside it
        _say_go(state["disagg_run"][0])

    # (3) the launcher
    log(f"[async] python -m repro_torch.launch.train "
        f"{' '.join(ASYNC_LAUNCHER)}")
    ops.reset_launch_counts()
    out = launch_train.main(ASYNC_LAUNCHER)
    counts = ops.launch_counts()
    summ = out.get("async")
    keys = ("produced", "max_depth", "dropped", "fallbacks", "publishes")
    log(f"[async] launcher: ppo_scores {out['ppo_scores']}, async "
        f"{ {k: summ.get(k) for k in keys} if summ else None}; launches "
        f"{counts}")
    if (summ is None or not all(k in summ for k in keys)
            or not out["ppo_scores"]
            or summ["produced"] != len(out["ppo_scores"])):
        failures.append(f"launcher: async summary {summ}")
    _launched("async_launcher", counts, ASYNC_KERNELS, state, failures)
    _free(out)
    if failures:
        raise AssertionError("async: " + "; ".join(failures))


# --------------------------------------------------------------------- #
# the disaggregated split at 1 | 1: a rollout rank and a training rank,
# two processes on the one card
# --------------------------------------------------------------------- #
# what each role's rank must launch on its main path (the rollout rank
# decodes, the training rank scores and steps); row 5 under --kv-quant
DISAGG_KERNELS = {"rollout": ("rmsnorm", "flash_attention_fwd",
                              "decode_attention_fwd"),
                  "train": ("rmsnorm", "flash_attention_fwd",
                            "flash_attention_bwd")}
DISAGG_LAUNCHER = ["--arch", "opt-125m", "--rlhf", "--rollout-mesh", "1",
                   "--train-mesh", "1", "--async-rlhf", "--max-lag", "1",
                   "--kv-quant", "--steps", "2", "--batch", "8", "--seq",
                   "256", "--max-new", "32"]


def _fingerprint(tree) -> str:
    """An exact fingerprint of a tree of tensors on the card, the same in
    any process for the same bits: each leaf's dtype and shape and two
    wrapping int64 sums of its bytes read as int32 words (plain and
    position-weighted), hashed together."""
    import hashlib

    import torch
    from repro_torch.models.modules import tree_leaves
    h = hashlib.sha256()
    for x in tree_leaves(tree):
        if x is None:
            continue
        b = x.detach().contiguous().view(-1).view(torch.uint8)
        if b.numel() % 4:
            b = torch.cat([b, b.new_zeros(4 - b.numel() % 4)])
        v = b.view(torch.int32).long()
        w = (torch.arange(v.numel(), device=v.device) * 2654435761
             + 1) & 0x7FFFFFFF
        sums = torch.stack([v.sum(), (v * w).sum()]).tolist()
        h.update(f"{x.dtype}|{tuple(x.shape)}|{sums};".encode())
        del b, v, w
    return h.hexdigest()


def _seq_sha(x) -> str:
    import hashlib

    import numpy as np
    a = np.ascontiguousarray(np.asarray(x, dtype=np.int64))
    return hashlib.sha256(a.tobytes() + str(a.shape).encode()).hexdigest()


def _disagg_leg(role, tag, eng, start, bl, stages, ppo, async_cfg):
    """One stage-3 run over the split from ``start`` (the training rank's
    actor and critic params), the generator seeded 3 on both ranks; this
    rank's record: launches, peak memory and the stage's seconds; on the
    training rank also the metrics, each scored batch's SHA-256, the wall
    of each iteration, the final actor, critic and EMA fingerprints, the
    async telemetry, and ``final`` (the actor's and critic's params, the
    next leg's start)."""
    import gc

    import torch
    from repro_torch.core import RLHFPipeline
    from repro_torch.core import ppo as tppo
    from repro_torch.kernels import ops

    if role == "train":
        eng.actor_params, eng.critic_params = start
    del start
    free, total = torch.cuda.mem_get_info()
    print(f"[disagg-worker] {role} rank, {tag}: starts with "
          f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB allocated, "
          f"{free / 2**30:.2f} of {total / 2**30:.2f} GiB free on the card",
          flush=True)
    pipe = RLHFPipeline(eng, bl, stages, ppo, async_cfg=async_cfg)
    seqs, tops = [], []
    score = tppo.PPOTrainer.score_rollout

    def recording(self, rollout, **kw):
        seqs.append(_seq_sha(torch.as_tensor(rollout.sequences).cpu()))
        return score(self, rollout, **kw)

    pipe.iter_hook = lambda i: tops.append(time.perf_counter())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    tppo.PPOTrainer.score_rollout = recording
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    try:
        pipe.run_ppo(torch.Generator(device="cuda").manual_seed(3))
    finally:
        tppo.PPOTrainer.score_rollout = score
    torch.cuda.synchronize()
    tops.append(time.perf_counter())
    rec = {"launches": ops.launch_counts(),
           "stage3_s": time.perf_counter() - t0,
           "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
           "async": pipe.async_stats}
    print(f"[disagg-worker] {role} rank, {tag}: {rec['stage3_s']:.2f}s, "
          f"peak {rec['peak_gib']:.2f} GiB", flush=True)
    if role == "train":
        tr = pipe.trainer
        rec.update(
            log=pipe.log["stage3"], seqs=seqs,
            wall_s=[b - a for a, b in zip(tops, tops[1:])],
            fingerprint={k: _fingerprint(v) for k, v in (
                ("actor", tr.actor.params), ("critic", tr.critic.params),
                ("ema", tr.ema))},
            final=(tr.actor.params, tr.critic.params))
        eng.actor_params = eng.critic_params = None
        del tr
    del pipe
    gc.collect()
    torch.cuda.empty_cache()
    return rec


def disagg_worker(out: str) -> int:
    """One rank of phase ``disagg`` (``torchrun --nproc-per-node 2
    chip_smoke.py --disagg-worker OUT``): rank 0 the rollout mesh, rank 1
    the training mesh, both on the card.  Three stage-3 legs at the RLHF
    cell's full size (phase ``async``'s models, weights, blend and
    recipe): 3 iterations synchronous over the split and 3 under
    ``AsyncConfig.lockstep()`` from the same start, at ``REPEAT_NEW`` new
    tokens, then 4 one-step-stale iterations (``publish_every=2,
    max_lag=1``) at 256 from where lockstep ended; then
    ``launch.train`` with ``DISAGG_LAUNCHER`` in this world.  Writes
    ``OUT/rank<r>.json``."""
    import json
    import os

    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.core import AsyncConfig, PPOConfig, RLHFEngine, StageConfig
    from repro_torch.core.pipeline import clone_params
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.launch.mesh import (init_distributed,
                                         make_disaggregated_meshes)
    from repro_torch.launch.train import lm_data

    init_distributed("cuda", shared_cards=True)
    rm, tm, role = make_disaggregated_meshes(rollout=1, train=1)
    rank = dist.get_rank()
    # started early (beside phase async), the ranks hold nothing on the
    # card until the phase says go
    go, t0, parent = os.path.join(out, "go"), time.perf_counter(), \
        os.getppid()
    while not os.path.exists(go):
        if time.perf_counter() - t0 > 1200 or os.getppid() != parent:
            raise SystemExit("phase disagg never said go")
        time.sleep(0.1)
    actor, critic = get_config("opt-1.3b"), get_config("opt-350m")
    bl = lm_data(actor, 512, 0)
    eng = RLHFEngine(actor, critic,
                     torch.Generator(device="cuda").manual_seed(0),
                     mesh=tm, rollout_mesh=rm)
    start = None
    if role == "train":
        start = (eng.actor_params, eng.critic_params)
        eng.ref_params = clone_params(eng.actor_params)
        eng.reward_params = clone_params(eng.critic_params)
    ppo = PPOConfig(max_new_tokens=REPEAT_NEW, temperature=1.0,
                    ptx_coef=0.05, use_ema=True)
    stages = StageConfig(ppo_steps=3, ppo_batch=8)
    rec = {"role": role, "rank": rank,
           "device": torch.cuda.get_device_name(torch.cuda.current_device())}
    copy = (tuple(clone_params(t) for t in start) if role == "train"
            else None)
    rec["sync"] = _disagg_leg(role, "sync", eng, copy, bl, stages, ppo,
                              None)
    del copy
    rec["sync"].pop("final", None)
    rec["lockstep"] = _disagg_leg(role, "lockstep", eng, start, bl, stages,
                                  ppo, AsyncConfig.lockstep())
    start = rec["lockstep"].pop("final", None)
    rec["stale"] = _disagg_leg(
        role, "stale", eng, start, bl,
        StageConfig(ppo_steps=4, ppo_batch=8),
        PPOConfig(max_new_tokens=256, temperature=1.0, ptx_coef=0.05,
                  use_ema=True), AsyncConfig(publish_every=2, max_lag=1))
    rec["stale"].pop("final", None)
    del start, eng
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    summ = launch_train.main(DISAGG_LAUNCHER)
    rec["launcher"] = {
        "launches": ops.launch_counts(), "seconds": time.perf_counter() - t0,
        "async": summ.get("async"), "ppo_scores": summ["ppo_scores"],
        "peak_gib": torch.cuda.max_memory_allocated() / 2**30}
    with open(os.path.join(out, f"rank{rank}.json"), "w") as f:
        json.dump(rec, f, default=str)
    dist.destroy_process_group()
    return 0


def phase_disagg(state):
    """The disaggregated split at ``1 | 1`` on the one card: ``torchrun
    --nproc-per-node 2 chip_smoke.py --disagg-worker`` (rank 0 rollout,
    rank 1 training; :func:`disagg_worker`), started first, then checked:
    both exit 0; the synchronous and the lockstep legs each equal phase
    ``async``'s one-device synchronous run of the same seeds bit for bit
    (each scored batch, the metrics without the wall-time keys, the final
    actor, critic and EMA; the one-device run is made here when phase
    ``async`` did not run); the stale leg's ``policy_lag`` exactly 0, 1,
    0, 1 and its ratios 1.0 at lag 0, finite and positive at lag 1; rows
    1, 2 and 4 launched on the rollout rank and rows 1-3 on the training
    rank in every leg, row 5 (and never row 4) on the rollout rank of the
    ``--kv-quant`` launcher run, whose ``async`` summary holds
    ``produced == 2``.  Logged per leg and rank: the stage's seconds,
    each iteration's wall, generation, scoring and step times, the
    publish seconds, bytes and GB/s over the host-staged gloo bridge, the
    queue's waits (the training rank's gets, the rollout rank's credit
    waits) and the peak memory of each process."""
    import json
    import math
    import os

    failures = []
    out, run = state.pop("disagg_run", None) or _start_disagg()
    _say_go(out)
    try:
        rc, text, wall = _finish(run, timeout=900.0)
    finally:
        if run[0].poll() is None:
            run[0].terminate()                   # torchrun stops its ranks
            run[0].wait()
    log(f"[disagg] torchrun --nproc-per-node 2 exit {rc} in {wall:.1f}s")
    recs = {}
    for r in (0, 1):
        path = os.path.join(out, f"rank{r}.json")
        if os.path.exists(path):
            with open(path) as f:
                recs[r] = json.load(f)
    if rc != 0 or sorted(recs) != [0, 1]:
        tail = "\n".join(text.splitlines()[-400:])
        raise AssertionError(f"disagg: the workers failed (rc {rc}):\n{tail}")
    for line in text.splitlines():
        if line.startswith("[disagg-worker]"):
            log(line)
    roll, train = recs[0], recs[1]
    if (roll["role"], train["role"]) != ("rollout", "train"):
        failures.append(f"roles {roll['role']}, {train['role']}")
    strip = lambda m: {k: v for k, v in m.items() if k not in ASYNC_WALL}
    ref = state.get("async_sync") or _one_device_sync(state)
    for leg in ("sync", "lockstep", "stale"):
        t, r = train[leg], roll[leg]
        for i, m in enumerate(t["log"]):
            gbs = (m["publish_bytes"] / m["publish_s"] / 1e9
                   if m.get("publish_s") else float("nan"))
            lag = (f", policy_lag {m['policy_lag']:.0f} is_ratio_max "
                   f"{m['is_ratio_max']:.6f}" if "policy_lag" in m else "")
            log(f"[disagg] {leg} iteration {i}: wall {t['wall_s'][i]:.2f}s, "
                f"gen {m['gen_s']:.2f}s = {m['gen_tok_s']:.1f} tok/s, scoring "
                f"{m['score_ms']:.1f} ms, actor {m['actor_ms']:.1f} ms, "
                f"critic {m['critic_ms']:.1f} ms; publish "
                f"{m.get('publish_s', float('nan')):.3f}s "
                f"{m.get('publish_bytes', 0) / 1e9:.3f} GB = {gbs:.2f} GB/s"
                f"{lag}")
        a_t, a_r = t["async"] or {}, r["async"] or {}
        log(f"[disagg] {leg}: stage 3 {t['stage3_s']:.2f}s (rollout rank "
            f"{r['stage3_s']:.2f}s); peak {r['peak_gib']:.2f} GiB rollout, "
            f"{t['peak_gib']:.2f} GiB training; queue get_wait "
            f"{(a_t.get('queue') or {}).get('get_wait_s', float('nan')):.3f}s"
            f", credit waits {(a_r.get('rollout') or {}).get('put_wait_s', float('nan')):.3f}s; "
            f"publisher {a_t.get('publisher')}; launches rollout "
            f"{r['launches']}, training {t['launches']}")
        for role, rr in (("rollout", r), ("train", t)):
            missing = [k for k in DISAGG_KERNELS[role]
                       if not rr["launches"].get(k)]
            if missing:
                failures.append(f"{leg}: {role} rank never launched "
                                f"{missing}")
        if leg == "stale":
            continue
        same = {"sequences": t["seqs"] == ref["seqs"],
                "metrics": [strip(m) for m in t["log"]] == ref["metrics"],
                **{k: t["fingerprint"][k] == ref["fingerprint"][k]
                   for k in ("actor", "critic", "ema")}}
        log(f"[disagg] {leg} over the split == one-device sync: {same}")
        if not all(same.values()):
            failures.append(f"{leg} over the split != one-device sync: "
                            f"{same}")
    st = train["stale"]
    lags = [m["policy_lag"] for m in st["log"]]
    if lags != [0.0, 1.0, 0.0, 1.0]:
        failures.append(f"stale: policy_lag {lags}, wanted 0, 1, 0, 1")
    if not all((m["is_ratio_mean"] == m["is_ratio_max"] == 1.0) if lag == 0
               else all(math.isfinite(m[k]) and m[k] > 0
                        for k in ("is_ratio_mean", "is_ratio_max"))
               for lag, m in zip(lags, st["log"])):
        failures.append("stale: is_ratio_* not 1.0 at lag 0 or not finite "
                        "and positive at lag 1")
    lr, lt = roll["launcher"], train["launcher"]
    log(f"[disagg] launcher {' '.join(DISAGG_LAUNCHER)}: {lt['seconds']:.1f}s"
        f", ppo_scores {lt['ppo_scores']}, async "
        f"{ {k: (lt['async'] or {}).get(k) for k in ('produced', 'max_depth', 'dropped', 'fallbacks', 'publishes')} }; "
        f"launches rollout {lr['launches']}, training {lt['launches']}; peak "
        f"{lr['peak_gib']:.2f} / {lt['peak_gib']:.2f} GiB")
    if (lt["async"] or {}).get("produced") != 2 or len(lt["ppo_scores"]) != 2:
        failures.append(f"launcher: async summary {lt['async']}")
    if not lr["launches"].get("decode_attention_quant_fwd") or \
            lr["launches"].get("decode_attention_fwd"):
        failures.append(f"launcher --kv-quant: rollout launches "
                        f"{lr['launches']}")
    for role, rr in (("rollout", lr), ("train", lt)):
        want = tuple(k for k in DISAGG_KERNELS[role]
                     if k != "decode_attention_fwd")
        if any(not rr["launches"].get(k) for k in want):
            failures.append(f"launcher: {role} launches {rr['launches']}")
    for leg in ("sync", "lockstep", "stale"):
        for role, rr in (("disagg_" + leg + "_rollout", roll[leg]),
                         ("disagg_" + leg + "_train", train[leg])):
            state.setdefault("launches", {})[role] = rr["launches"]
    state["disagg"] = {
        "stale_lags": lags, "wall_s": {leg: train[leg]["wall_s"]
                                       for leg in ("sync", "lockstep",
                                                   "stale")},
        "peak_gib": {leg: (roll[leg]["peak_gib"], train[leg]["peak_gib"])
                     for leg in ("sync", "lockstep", "stale")},
        "one_device_sync_wall_s": ref.get("wall_s")}
    if failures:
        raise AssertionError("disagg: " + "; ".join(failures))


def _start_disagg():
    """Start phase ``disagg``'s two ranks (they initialize, then wait for
    the phase): ``(output directory, run)``."""
    import tempfile
    out = tempfile.mkdtemp(prefix="disagg_")
    return out, _launch("disagg", None, ["--disagg-worker", out], nproc=2,
                        script=ROOT / "chip_smoke.py", env={
                            "PYTORCH_CUDA_ALLOC_CONF":
                                "expandable_segments:True"})


def _say_go(out) -> None:
    """Let phase ``disagg``'s ranks (waiting in ``out``) start their legs."""
    import os
    with open(os.path.join(out, "go"), "w"):
        pass


def _one_device_sync(state) -> dict:
    """Phase ``async``'s synchronous leg, made here (phase ``async`` did not
    run in this invocation): its record for phase ``disagg``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import PPOConfig, RLHFEngine, StageConfig
    from repro_torch.core.pipeline import clone_params
    from repro_torch.launch.train import lm_data
    actor, critic = get_config("opt-1.3b"), get_config("opt-350m")
    eng = RLHFEngine(actor, critic,
                     torch.Generator(device="cuda").manual_seed(0))
    start = (eng.actor_params, eng.critic_params)
    eng.ref_params = clone_params(eng.actor_params)
    eng.reward_params = clone_params(eng.critic_params)
    s = _async_leg("sync", eng, start, lm_data(actor, 512, 0),
                   StageConfig(ppo_steps=3, ppo_batch=8),
                   PPOConfig(max_new_tokens=REPEAT_NEW, temperature=1.0,
                             ptx_coef=0.05, use_ema=True), None)
    out = _sync_record(s)
    del s, eng, start
    torch.cuda.empty_cache()
    return out


def _sync_record(s) -> dict:
    """What phase ``disagg`` holds a split's leg to, of a one-device
    synchronous leg (:func:`_async_leg`)."""
    return {"metrics": [{k: v for k, v in m.items() if k not in ASYNC_WALL}
                        for m in s["log"]],
            "seqs": [_seq_sha(x) for x in s["seqs"]],
            "fingerprint": {k: _fingerprint(s["final"][k])
                            for k in ("actor", "critic", "ema")},
            "wall_s": s["wall_s"]}


# --------------------------------------------------------------------- #
# the Hybrid Engine and the data-parallel mesh, at 1 x 1 over NCCL
# --------------------------------------------------------------------- #
HYBRID_PPO_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd",
                      "decode_attention_fwd",
                      "paged_decode_attention_quant_fwd")


def _hybrid_reshard(state, failures, mesh):
    """``to_inference`` and ``to_train`` on OPT-1.3B's fp32 params at full
    size in the training layout: the roundtrip bitwise, 0 bytes gathered
    and freed at one rank, measured seconds > 0; the analytic bytes of
    larger meshes printed beside them."""
    from types import SimpleNamespace

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.hybrid_engine import HybridEngine
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.sharding import runtime

    cfg = get_config("opt-1.3b")
    he = HybridEngine(cfg, mesh)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    p_train = runtime.place_tree(params, he.train_shardings)
    stats = []
    for _ in range(2):                  # the first call, then a warm one
        p_inf = he.to_inference(p_train)
        stats.append(dict(he.last_reshard_stats))
        p_back = he.to_train(p_inf)
        stats.append(dict(he.last_reshard_stats))
    exact = all(torch.equal(runtime.full(b), p) and torch.equal(
        runtime.full(i), p) for b, i, p in zip(
            tree_leaves(p_back), tree_leaves(p_inf), tree_leaves(params)))
    for s in stats:
        log(f"[hybrid] {s['direction']} (first_call {s['first_call']}): "
            f"{s['seconds'] * 1e3:.3f} ms, in {s['in_bytes']} B, out "
            f"{s['out_bytes']} B, gathered {s['gathered_bytes']} B, freed "
            f"{s['freed_bytes']} B")
    log(f"[hybrid] roundtrip bitwise: {exact}")
    analytic = {}
    for dp in (2, 4, 8):
        fake = SimpleNamespace(shape={"data": dp, "model": 1},
                               axis_names=("data", "model"))
        h = HybridEngine(cfg, fake)
        analytic[dp] = {"reshard_bytes_per_phase": h.reshard_bytes_per_phase(),
                        "naive_gather_bytes_256":
                            h.naive_generation_gather_bytes(256)}
        log(f"[hybrid] analytic bytes, not times: OPT-1.3B at dp {dp}: "
            f"reshard_bytes_per_phase {analytic[dp]['reshard_bytes_per_phase']}"
            f", naive_generation_gather_bytes(256) "
            f"{analytic[dp]['naive_gather_bytes_256']}")
    state["hybrid"] = {"reshard": stats, "analytic": analytic,
                       "param_bytes": he.param_bytes()}
    if not exact:
        failures.append("reshard roundtrip is not bitwise")
    if any(s["gathered_bytes"] or s["freed_bytes"] or not s["seconds"] > 0
           for s in stats):
        failures.append(f"reshard stats at one rank: {stats}")


def _hybrid_sft(state, failures, mesh):
    """OPT-1.3B SFT, 8 x 512, bf16 on fp32 masters: 3 steps of
    ``make_sharded_lm_step(cfg, mesh, "zero3", zero=1)`` against 3 steps of
    ``lm_train_step`` from the same state.  At one rank every sum is the
    plain step's, so the losses, grad norms and final params are gated
    bit for bit; median step ms and peak GiB of both paths recorded."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.sharding import runtime
    from repro_torch.training.steps import make_sharded_lm_step
    from repro_torch.training.train_state import TrainState

    cfg = get_config("opt-1.3b")
    kw = dict(steps=3, batch=8, seq=512, lr=3e-4, seed=0, device="cuda")
    out = {}
    for path in ("plain", "mesh"):
        gc.collect()
        torch.cuda.empty_cache()
        params = T.init_params(cfg, torch.Generator(device="cuda")
                               .manual_seed(0))
        if path == "plain":
            st, step_fn = TrainState.create(params), None
        else:
            step, sh, shard_batch = make_sharded_lm_step(cfg, mesh, "zero3",
                                                         zero=1)
            st = TrainState.create(params, shardings=sh)
            step_fn = lambda s, b, lr: step(s, shard_batch(b), lr)
        del params
        torch.cuda.reset_peak_memory_stats()
        ops.reset_launch_counts()
        st, summ = launch_train.train_lm(cfg, st, step_fn=step_fn, **kw)
        counts = ops.launch_counts()
        _launched(f"hybrid_sft_{path}", counts, TRAIN_KERNELS, state,
                  failures)
        steady = summ["step_ms"][1:]
        out[path] = {"loss": summ["loss"], "grad_norm": summ["grad_norm"],
                     "step_ms": summ["step_ms"],
                     "median_step_ms": statistics.median(steady),
                     "peak_gib": _peak_gib()}
        log(f"[hybrid] SFT {path}: losses {summ['loss']}, grad norms "
            f"{summ['grad_norm']}, step ms "
            f"{' '.join(f'{x:.1f}' for x in summ['step_ms'])} (median after "
            f"the first {out[path]['median_step_ms']:.1f}), peak "
            f"{out[path]['peak_gib']:.2f} GiB")
        if path == "plain":
            keep = [p.clone() for p in tree_leaves(st.params)]
        else:
            same = all(torch.equal(runtime.full(p), q)
                       for p, q in zip(tree_leaves(st.params), keep))
        del st
    del keep
    ok = (out["plain"]["loss"] == out["mesh"]["loss"]
          and out["plain"]["grad_norm"] == out["mesh"]["grad_norm"] and same)
    log(f"[hybrid] SFT mesh path at world 1 == plain path bit for bit "
        f"(losses, grad norms, params): {ok}")
    state["hybrid"]["sft"] = out
    if not ok:
        failures.append(f"sharded SFT at one rank differs: {out}, params "
                        f"equal {same}")


def _hybrid_ppo(state, failures, mesh):
    """PPO through ``HybridEngine`` at 1 x 1 against ``engine=None``:
    OPT-1.3B actor and reference, OPT-350M critic and reward at full size,
    8 x 256 prompts, ``REPEAT_NEW`` new greedy tokens (64: it was 256
    before phases ``mla`` and ``xattn`` came in); one iteration on the
    dense bf16 arena, one on the request path with int8 KV on the paged
    pool.
    Tokens identical, actor and critic params equal bit for bit, the
    reshard measured (0 bytes, seconds > 0), kernels 1-4 and the paged
    int8 decode launched."""
    import dataclasses
    import gc

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.hybrid_engine import HybridEngine
    from repro_torch.core.pipeline import clone_params
    from repro_torch.core.ppo import PPOConfig, PPOTrainer
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_data
    from repro_torch.models import reward as R
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.serving.engine import GenerationEngine, Request

    actor_cfg, critic_cfg = get_config("opt-1.3b"), get_config("opt-350m")
    bl = lm_data(actor_cfg, 512, 0)
    batches = [b["prompts"] for b in bl.prompt_batches(8, 2)]
    ppo = PPOConfig(max_new_tokens=REPEAT_NEW, temperature=0.0, use_ema=True)
    paged = dataclasses.replace(ppo, kv_quant=True, kv_layout="paged",
                                kv_block_size=16)
    runs = {}
    for which in ("none", "engine"):
        gc.collect()
        torch.cuda.empty_cache()
        g = lambda s: torch.Generator(device="cuda").manual_seed(s)
        actor = T.init_params(actor_cfg, g(0))
        trainer = PPOTrainer(
            actor_cfg=actor_cfg, critic_cfg=critic_cfg, actor_params=actor,
            critic_params=R.init_params(critic_cfg, g(1)),
            ref_params=clone_params(actor),
            reward_params=R.init_params(critic_cfg, g(2)), ppo=ppo,
            engine=HybridEngine(actor_cfg, mesh) if which == "engine"
            else None)
        del actor
        ops.reset_launch_counts()
        iters = []
        for i, (cfg_i, prompts) in enumerate(((ppo, batches[0]),
                                              (paged, batches[1]))):
            if i == 1:                     # the paged int8 request path
                trainer.ppo = cfg_i
                trainer.gen_engine = (
                    trainer.engine.generation_engine if trainer.engine
                    else GenerationEngine)(
                    cfg=actor_cfg.replace(kv_quant=True),
                    max_new_tokens=cfg_i.max_new_tokens, temperature=0.0,
                    chunk=cfg_i.decode_chunk, kv_layout="paged",
                    block_size=16, device="cuda")
                prompts = [Request(uid=j, tokens=np.asarray(p, np.int32),
                                   max_new_tokens=cfg_i.max_new_tokens)
                           for j, p in enumerate(np.asarray(prompts))]
            exp, gm = trainer.generate_experience(prompts, g(7))
            tm = trainer.train_rlhf(exp)
            iters.append({"seqs": exp.sequences.cpu(), **gm, **tm})
        counts = ops.launch_counts()
        _launched(f"hybrid_ppo_{which}", counts, HYBRID_PPO_KERNELS, state,
                  failures)
        runs[which] = {"iters": iters, "counts": counts,
                       "actor": [p.cpu() for p in tree_leaves(
                           trainer.actor.params)],
                       "critic": [p.cpu() for p in tree_leaves(
                           trainer.critic.params)]}
        for i, m in enumerate(iters):
            log(f"[hybrid] PPO {which} iteration {i} "
                f"({'dense bf16' if i == 0 else 'paged int8'} KV): gen "
                f"{m['gen_s']:.2f}s ({m['gen_tok_s']:.1f} tok/s), scoring "
                f"{m['score_ms']:.1f} ms, actor {m['actor_ms']:.1f} ms, "
                f"critic {m['critic_ms']:.1f} ms, reward_score "
                f"{m['reward_score']:.4f}"
                + (f", reshard {m['reshard_bytes']:.0f} B in "
                   f"{m['reshard_s'] * 1e3:.3f} ms" if "reshard_s" in m
                   else ""))
        log(f"[hybrid] PPO {which} launches: {counts}")
        del trainer, exp
    a, b = runs["none"], runs["engine"]
    tokens = all(torch.equal(x["seqs"], y["seqs"])
                 for x, y in zip(a["iters"], b["iters"]))
    diffs = {k: max(float((x - y).abs().max()) for x, y in zip(a[k], b[k]))
             for k in ("actor", "critic")}
    log(f"[hybrid] engine vs none: tokens identical {tokens}; max |param "
        f"diff| {diffs}")
    keys = ("gen_s", "score_ms", "actor_ms", "critic_ms", "reward_score",
            "reshard_bytes", "reshard_s")
    state["hybrid"]["ppo"] = {w: [{k: m[k] for k in keys if k in m}
                                  for m in runs[w]["iters"]]
                              for w in runs}
    if not tokens or any(diffs.values()):
        failures.append(f"PPO with the engine differs: tokens {tokens}, "
                        f"param diffs {diffs}")
    for m in b["iters"]:
        if m["reshard_bytes"] != 0 or not m["reshard_s"] > 0:
            failures.append(f"reshard metrics {m['reshard_bytes']}, "
                            f"{m['reshard_s']}")


def _hybrid_ppo_steps(state, failures, mesh):
    """PPO's scoring and steps on the mesh path at 1 x 1 against the plain
    path, at full width: OPT-1.3B actor and reference, OPT-350M critic and
    reward model, 8 rows of 256 + 64 random tokens (the last 64 a
    response), bf16 on fp32 masters.  ``make_experience`` on the compute
    views (the tensor-parallel context of a one-rank model group) and one
    ``actor_step`` / ``critic_step`` on train states in the ``zero3`` +
    ZeRO-1 layout: the experience, the metrics and the updated params
    equal the plain path's bit for bit.  (The trainer itself takes the
    plain path at one rank.)"""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import ppo as P
    from repro_torch.core.hybrid_engine import HybridEngine
    from repro_torch.models import reward as R
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.sharding import runtime
    from repro_torch.sharding import strategy as S
    from repro_torch.training.steps import mesh_view
    from repro_torch.training.train_state import TrainState

    actor_cfg, critic_cfg = get_config("opt-1.3b"), get_config("opt-350m")
    ppo = P.PPOConfig(use_ema=False)
    g = lambda s: torch.Generator(device="cuda").manual_seed(s)
    seqs = torch.randint(0, actor_cfg.vocab_size, (8, 320), generator=g(3),
                         device="cuda")
    resp = torch.zeros((8, 320), dtype=torch.bool, device="cuda")
    resp[:, 256:] = True
    he = HybridEngine(actor_cfg, mesh)
    out = {}
    for path in ("plain", "mesh"):
        gc.collect()
        torch.cuda.empty_cache()
        models = [T.init_params(actor_cfg, g(0)), T.init_params(actor_cfg,
                                                                g(0)),
                  R.init_params(critic_cfg, g(1)),
                  R.init_params(critic_cfg, g(2))]
        if path == "plain":
            states = [TrainState.create(models[0]),
                      TrainState.create(models[2])]
            frozen, tps = [models[1], models[3]], (None,) * 4
            views = [states[0].params, frozen[0], states[1].params,
                     frozen[1]]
            batch, group = (seqs, resp), None
        else:
            crit = R.param_specs(critic_cfg)
            states = [TrainState.create(models[0],
                                        shardings=he.train_state_shardings()),
                      TrainState.create(models[2],
                                        shardings=he.train_state_shardings(
                                            critic_cfg, specs=crit))]
            frozen = [runtime.place_tree(models[1], S.param_shardings(
                          actor_cfg, mesh, "tp")),
                      runtime.place_tree(models[3], S.shardings_for_tree(
                          crit, mesh, "tp"))]
            batch = S.shard_batch((seqs, resp), mesh)
            (ls, lr_), group = runtime.batch_local(batch)
            vt = [mesh_view(c, p, group)[::2] for c, p in (
                (actor_cfg, states[0].params), (actor_cfg, frozen[0]),
                (critic_cfg, states[1].params), (critic_cfg, frozen[1]))]
            views, tps = [v for v, _ in vt], tuple(t for _, t in vt)
            batch = (ls, lr_)
        del models
        exp, score = P.make_experience(actor_cfg, critic_cfg, ppo, *views,
                                       *batch, group=group, tps=tps)
        del views
        if path == "mesh":
            exp = P.X.Experience(*S.shard_batch(tuple(exp), mesh))
        t0 = time.perf_counter()
        states[0], am = P.actor_step(actor_cfg, ppo, states[0], exp)
        states[1], cm = P.critic_step(critic_cfg, ppo, states[1], exp)
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) * 1e3
        out[path] = {
            "exp": [runtime.full(t).cpu() for t in exp] + [score.cpu()],
            "metrics": {k: float(v) for k, v in {**am, **cm}.items()},
            "params": [runtime.full(p).cpu() for st in states
                       for p in tree_leaves(st.params)],
            "steps_ms": ms}
        log(f"[hybrid] PPO scoring and steps, {path} path: actor + critic "
            f"step {ms:.1f} ms, metrics {out[path]['metrics']}")
        del states, frozen, exp
    a, b = out["plain"], out["mesh"]
    same = (a["metrics"] == b["metrics"]
            and all(torch.equal(x, y) for x, y in zip(a["exp"], b["exp"]))
            and all(torch.equal(x, y)
                    for x, y in zip(a["params"], b["params"])))
    log(f"[hybrid] PPO scoring and steps on the mesh path at 1 x 1 == plain "
        f"path bit for bit (experience, metrics, params): {same}")
    state["hybrid"]["ppo_steps"] = {p: {"metrics": out[p]["metrics"],
                                        "steps_ms": out[p]["steps_ms"]}
                                    for p in out}
    if not same:
        failures.append("PPO scoring and steps on the mesh path at one rank "
                        "differ from the plain path")


# the per-rank head counts of the kernels on a 2- and 4-way model axis
TP_FLASH64 = (("OPT-1.3B rank of tp 2 sft", 8, 16, 1, 512, 512, True, True),
              ("OPT-1.3B rank of tp 4 sft", 8, 8, 1, 512, 512, True, True))
TP_FLASH128 = (("qwen3-8b rank of tp 2 prefill", 1, 4, 4, 256, 256, True,
                False),
               ("qwen3-8b rank of tp 4 sft", 4, 2, 4, 512, 512, True, True))
TP_DECODE64 = ((16, 1, "OPT-1.3B rank of tp 2"), (8, 1, "OPT-1.3B rank of "
                                                        "tp 4"))
TP_DECODE128 = ((4, 4, "qwen3-8b rank of tp 2"), (2, 4, "qwen3-8b rank of "
                                                        "tp 4"))


# MLA at deepseek-v2-lite: 8 and 4 of its 16 heads at D 192 (V padded from
# 128); cross-attention at llama-3.2-vision: 16 / 4 and 8 / 2 of its 32 / 8
# heads over the 1,601 encoder keys
TP_FLASH192 = (("deepseek rank of tp 2 sft", 8, 8, 1, 512, 512, True, True),
               ("deepseek rank of tp 4 sft", 8, 4, 1, 512, 512, True, True))
TP_CROSS = (("vision rank of tp 2 decode", 4, 4, 4, 1, 1601, False, False),
            ("vision rank of tp 2 sft", 8, 4, 4, 512, 1601, False, True),
            ("vision rank of tp 4 decode", 4, 2, 4, 1, 1601, False, False),
            ("vision rank of tp 4 sft", 8, 2, 4, 512, 1601, False, True))
# the SSD pass at one rank's Mamba2 heads: (label, b, nc, q, h, p, n)
TP_SSD = (("mamba2-370m rank of tp 2 admission", 1, 1, 256, 16, 64, 128),
          ("mamba2-370m rank of tp 4 admission", 1, 1, 256, 8, 64, 128),
          ("mamba2-370m rank of tp 2 sft", 8, 2, 256, 16, 64, 128),
          ("mamba2-370m rank of tp 4 sft", 8, 2, 256, 8, 64, 128),
          ("zamba2-1.2b rank of tp 2 admission", 1, 1, 256, 32, 64, 64),
          ("zamba2-1.2b rank of tp 4 admission", 1, 1, 256, 16, 64, 64))


def _tp_kernel_rows(state, failures):
    """Kernel rows 2-8 at the head counts one rank of a 2- and a 4-way
    ``model`` axis launches them at (OPT-1.3B: 16 and 8 of its 32 heads at
    D 64; qwen3-8b: 16 / 4 and 8 / 2 of its 32 / 8 at D 128; MLA and
    cross-attention: :data:`TP_FLASH192`, :data:`TP_CROSS`; the SSD pass:
    :data:`TP_SSD`), against their plain versions at the script's
    tolerances, timed as phase ``gqa128``'s rows are (under ``tp`` in the
    ``kernels`` line)."""
    _flash_rows(state, failures, "tp", "hybrid", 64, TP_FLASH64, seed=261)
    _flash_rows(state, failures, "tp", "hybrid", 128, TP_FLASH128, seed=262)
    _decode_rows(state, failures, 64, TP_DECODE64, key="tp", tag="hybrid",
                 seed=263)
    _decode_rows(state, failures, 128, TP_DECODE128, key="tp", tag="hybrid",
                 seed=264)
    _flash_rows(state, failures, "tp", "hybrid", 192, TP_FLASH192, seed=265,
                pad_v=128)
    _flash_rows(state, failures, "tp", "hybrid", 128, TP_CROSS, seed=266)
    _tp_ssd_rows(state, failures)


def _tp_ssd_rows(state, failures):
    """``ssd_intra_fwd`` at :data:`TP_SSD` against its plain version: fp32
    (TF32 off) checked, bf16 checked and timed warm and cold beside the
    bound and the plain time (no single library call computes it)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_intra_fwd

    gen = torch.Generator(device="cuda").manual_seed(267)
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    for label, b, nc, q, h, p, n in TP_SSD:
        shape = f"{label} b={b} nc={nc} q={q} h={h} p={p} n={n}"
        for dname, dtype in (("fp32", torch.float32),
                             ("bf16", torch.bfloat16)):
            args = _ssd_inputs(gen, b, nc, q, h, p, n, dtype)
            y, s_c, acs = ssd_intra_fwd(*args)
            torch.cuda.synchronize()
            yr, sr, _, ar = ref.ssd_intra_ref(*args)
            ey, es, ea = rel(y, yr), rel(s_c, sr), rel(acs, ar)
            if es > 1e-4 or ea > 1e-5:
                failures.append(f"ssd_intra_fwd {shape} {dname}: S_c "
                                f"{es:.3g}, A_cs {ea:.3g}")
            extra = {"s_err": es, "acs_err": ea}
            tol = 1e-4 if dname == "fp32" else 2e-2
            if dname == "fp32":
                _row128(state, failures, "ssd_intra_fwd", shape, dname, ey,
                        tol, extra=extra, key="tp", tag="hybrid")
                continue
            esize = args[0].element_size()
            copies = [_ssd_inputs(gen, b, nc, q, h, p, n, dtype)
                      for _ in range(cold_copies(ssd_bytes(
                          b, nc, q, h, p, n, esize)))]
            cold = time_ms_cold([lambda c=c: ssd_intra_fwd(*c)
                                 for c in copies])
            del copies
            _row128(state, failures, "ssd_intra_fwd", shape, dname, ey, tol,
                    time_ms(lambda: ssd_intra_fwd(*args)),
                    time_ms(lambda: ref.ssd_intra_ref(*args), inner=5,
                            repeats=5), None,
                    ssd_bound(b, nc, q, h, p, n, esize, dname),
                    cold_ms=cold, extra=extra, key="tp", tag="hybrid")
        torch.cuda.empty_cache()


@contextlib.contextmanager
def one_rank_mesh(tag: str):
    """A one-rank NCCL group (from a FileStore) and its 1 x 1 ``data x
    model`` mesh, destroyed on exit: the mesh path at one rank."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from repro_torch.launch.mesh import init_distributed, mesh_from_spec

    tmp = tempfile.mkdtemp(prefix="one_rank_pg_")
    init_distributed("cuda", init_method=f"file://{tmp}/store", rank=0,
                     world_size=1)
    try:
        mesh = mesh_from_spec("1,1")
        log(f"[{tag}] one-rank NCCL group ({dist.get_backend()}), mesh "
            f"{dict(zip(mesh.mesh_dim_names, mesh.shape))}")
        yield mesh
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)


def phase_hybrid(state):
    failures = []
    with one_rank_mesh("hybrid") as mesh:
        _hybrid_reshard(state, failures, mesh)
        _hybrid_sft(state, failures, mesh)
        _hybrid_ppo(state, failures, mesh)
        _hybrid_ppo_steps(state, failures, mesh)
    _tp_kernel_rows(state, failures)
    if failures:
        raise AssertionError("hybrid: " + "; ".join(failures))


def mesh_identity(tag, cfg, batch, prompts, n_new, must, state, failures,
                  encoder_embeds=None):
    """The tensor-parallel path at 1 x 1 (a one-rank NCCL group) against
    the plain path at ``cfg``, bf16 on fp32 masters: one SFT step of
    ``make_sharded_lm_step(cfg, mesh, "tp", zero=1)`` beside
    ``lm_train_step`` from the same params (loss, grad norm and updated
    params bit for bit; the mesh step must launch ``must``, counts set to
    0 just before it and read just after), and one greedy
    ``GenerationEngine(mesh=).generate`` of ``prompts`` beside the plain
    engine's (tokens identical)."""
    import gc

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.serving.engine import GenerationEngine
    from repro_torch.sharding import runtime
    from repro_torch.training.steps import lm_train_step, make_sharded_lm_step
    from repro_torch.training.train_state import TrainState

    def params():
        gen = torch.Generator(device="cuda").manual_seed(11)
        p = T.init_params(cfg, gen)
        if cfg.arch_type == "vlm":
            _set_gates(p, gen)
        return p
    out = {}
    with one_rank_mesh(tag) as mesh:
        for path in ("plain", "mesh"):
            gc.collect()
            torch.cuda.empty_cache()
            if path == "plain":
                st = TrainState.create(params())
                step = lambda s: lm_train_step(cfg, s, batch, 1e-4)
            else:
                fn, sh, shard = make_sharded_lm_step(cfg, mesh, "tp", zero=1)
                st = TrainState.create(params(), shardings=sh)
                step = lambda s: fn(s, shard(batch), 1e-4)
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            st, m = step(st)
            loss, gnorm = float(m["loss"]), float(m["grad_norm"])
            ms = (time.perf_counter() - t0) * 1e3
            counts = ops.launch_counts()
            if path == "plain":
                keep = [p.clone() for p in tree_leaves(st.params)]
            else:
                _launched(f"{tag}_mesh_sft", counts, must, state, failures)
                same = all(torch.equal(runtime.full(p), q) for p, q in
                           zip(tree_leaves(st.params), keep, strict=True))
            out[path] = {"loss": loss, "grad_norm": gnorm, "step_ms": ms}
            del st
        del keep
        sft_ok = (same and out["plain"]["loss"] == out["mesh"]["loss"]
                  and out["plain"]["grad_norm"] == out["mesh"]["grad_norm"])
        log(f"[{tag}] SFT step of {tuple(batch['labels'].shape)} on the mesh "
            f"path at 1 x 1 == plain path bit for bit (loss, grad norm, "
            f"params): {sft_ok}; {out}")
        if not sft_ok:
            failures.append(f"{tag}: the mesh SFT step at one rank differs "
                            f"from the plain step: {out}, params equal "
                            f"{same}")
        gc.collect()
        torch.cuda.empty_cache()
        p = T.cast_params(cfg, params())
        seqs = {}
        for path, m in (("plain", None), ("mesh", mesh)):
            eng = GenerationEngine(cfg, mesh=m, max_new_tokens=n_new,
                                   temperature=0.0, device="cuda")
            ops.reset_launch_counts()
            seqs[path] = eng.generate(
                p, prompts, torch.Generator(device="cuda").manual_seed(7),
                encoder_embeds=encoder_embeds)["sequences"]
            if m is not None:
                _launched(f"{tag}_mesh_generate", ops.launch_counts(),
                          ("rmsnorm",), state, failures)
        del p
        gen_ok = torch.equal(seqs["plain"], seqs["mesh"])
        log(f"[{tag}] greedy generate of {tuple(prompts.shape)} + {n_new} on "
            f"the mesh path at 1 x 1 == plain engine's tokens: {gen_ok}")
        if not gen_ok:
            failures.append(f"{tag}: mesh generate at one rank differs from "
                            "the plain engine's")
    state.setdefault("mesh_identity", {})[tag] = {**out, "sft_equal": sft_ok,
                                                  "generate_equal": gen_ok}


# --------------------------------------------------------------------- #
# the request core on a mesh, at 1 x 1
# --------------------------------------------------------------------- #
SUMMARY = re.compile(r"generated (\d+) tokens in ([\d.]+)s  \(([\d.]+) "
                     r"tok/s, slot utilization ([\d.]+)%\)")


def _launch(tag: str, module, argv: list, nproc: int = 1, script=None,
            env=None):
    """``torchrun --standalone --nproc-per-node nproc -m module argv`` (or
    ``script argv``) started (not waited on) from the repository root,
    ``env`` added to the environment, its output to a file: ``(process,
    log path, start time)``."""
    import os
    import tempfile
    target = ["-m", module] if script is None else [str(script)]
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", str(nproc), *target, *argv]
    log(f"[{tag}] {' '.join(cmd[1:])}")
    fd, path = tempfile.mkstemp(prefix=f"{tag}_", suffix=".log")
    with os.fdopen(fd, "w") as f:
        proc = subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                text=True, cwd=ROOT, env=dict(
                                    os.environ, PYTHONPATH=str(ROOT / "src"),
                                    **(env or {})))
    return proc, path, time.perf_counter()


def _finish(run, timeout: float = 600.0):
    """``(exit code, output, seconds)`` of a :func:`_launch` run, killed
    if it outlives ``timeout``."""
    import os
    proc, path, t0 = run
    try:
        proc.wait(timeout=max(1.0, timeout - (time.perf_counter() - t0)))
    except subprocess.TimeoutExpired:
        proc.terminate()                 # torchrun stops its ranks
        try:
            proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    out = Path(path).read_text(errors="replace")
    os.unlink(path)
    return proc.returncode, out, time.perf_counter() - t0


# ``launch.train --mesh 1,1 --strategy tp`` (the tensor-parallel path on a
# one-rank model group) and the plain launcher on the same arguments
TRAIN_TP_ARGV = ["--arch", "opt-125m", "--steps", "5", "--batch", "8",
                 "--seq", "512"]


def _train_launcher(state, failures, run):
    """The train launcher under ``torchrun`` on a 1 x 1 mesh in the ``tp``
    layout exits 0 with a falling loss, and its losses agree with the
    plain launcher's run in this process to 1e-4.  (Its ``zero3`` twin
    went to make room for the other layer kinds' rows and gates:
    ``_hybrid_sft`` holds the zero3 mesh step to the plain one bit for
    bit.)"""
    from repro_torch.launch import train as launch_train
    out = launch_train.main(TRAIN_TP_ARGV)
    plain = [float(f"{x:.4f}") for x in out["loss"]]
    _free(out)
    log(f"[serve_mesh] the plain train launcher in this process: losses "
        f"{plain}")
    rc, text, wall = _finish(run)
    losses = [float(x) for x in re.findall(
        r"^step +\d+ +loss=([\d.]+)", text, flags=re.M)]
    log(f"[serve_mesh] torchrun train --strategy tp exit {rc} in "
        f"{wall:.1f}s; losses {losses}")
    state.setdefault("serve_mesh", {})["train_torchrun"] = {
        "rc": rc, "losses": losses, "seconds": wall, "plain_losses": plain}
    if rc != 0 or len(losses) < 2 or not losses[-1] < losses[0]:
        failures.append(f"torchrun train --strategy tp: rc {rc}, losses "
                        f"{losses}: {text[-2000:]}")
    elif len(losses) != len(plain) or any(abs(x - y) > 1e-4 * abs(x)
                                          for x, y in zip(plain, losses)):
        failures.append(f"torchrun tp losses {losses} and the plain "
                        f"launcher's {plain} differ")


def _serve_launcher(state, failures, run):
    """(a) ``torchrun --nproc-per-node 1 -m repro_torch.launch.serve --mesh
    1,1`` with phase ``serve``'s workload and seed: its summary's generated
    tokens and slot utilization against the plain launcher's (phase
    ``serve``'s run of the same arguments, or one here)."""
    from repro_torch.launch import serve
    plain = state.get("serve", {}).get("summary")
    if plain is None:
        res = serve.main(SERVE_ARGV)
        plain = {k: res[k] for k in ("tokens", "slot_util", "tok_s")}
        _free(res)
    rc, text, wall = _finish(run)
    lines = [s for s in text.splitlines() if SUMMARY.search(s)]
    log(f"[serve_mesh] torchrun serve --mesh 1,1 exit {rc} in {wall:.1f}s: "
        + " | ".join(s for s in text.splitlines()
                     if s.startswith(("mesh=", "scheduler="))))
    # (tokens, seconds, tok/s, slot utilization %) of the summary line
    got = SUMMARY.search(lines[-1]).groups() if lines else ("",) * 4
    want = (str(plain["tokens"]), f"{100 * plain['slot_util']:.1f}")
    log(f"[serve_mesh] opt-1.3b bf16 workload: mesh 1 x 1 {got[2]} tok/s "
        f"(beside this process's other runs), plain launcher "
        f"{plain['tok_s']:.1f} tok/s; generated tokens and slot utilization "
        f"{(got[0], got[3])} against {want}")
    state.setdefault("serve_mesh", {})["launcher"] = {
        "rc": rc, "seconds": wall, "tok_s": got[2],
        "plain_tok_s": plain["tok_s"]}
    if rc != 0 or len(lines) != 1 or (got[0], got[3]) != want:
        failures.append(f"torchrun serve --mesh 1,1: rc {rc}, summary "
                        f"{lines} against {want}: {text[-2000:]}")


def _mesh_preempt(state, failures):
    """(b) the launcher with ``--mesh 1,1`` in this process (the one-rank
    group of :func:`one_rank_mesh`) on phase ``serve``'s greedy preempting
    case with int8 KV, against the plain launcher's run: completions by
    uid and stats equal, at least one preemption."""
    argv = GREEDY + PREEMPT + ["--kv-quant"]
    runs = {}
    for tag, extra in (("serve_preempt_int8", []),
                       ("serve_mesh_preempt_int8", ["--mesh", "1,1"])):
        runs[tag] = _serve_run(argv + extra, tag, SERVE_PAGED_INT8_KERNELS,
                               state, warmup=False)
    plain, mesh = runs.values()
    same = plain["completions"] == mesh["completions"]
    same_st = plain["stats"] == mesh["stats"]
    n_pre = mesh["stats"]["preemptions"]
    log(f"[serve_mesh] paged int8, 121 blocks: mesh core at 1 x 1 == plain "
        f"core: completions {same}, stats {same_st} (preemptions {n_pre}, "
        f"block_high_water {mesh['stats']['block_high_water']}); tok/s "
        f"{mesh['tok_s']:.1f} mesh, {plain['tok_s']:.1f} plain")
    state.setdefault("serve_mesh", {})["preempt"] = {
        "equal": same and same_st, "preemptions": n_pre,
        "tok_s": mesh["tok_s"], "plain_tok_s": plain["tok_s"]}
    if not (same and same_st and n_pre > 0):
        failures.append(f"mesh core paged int8: completions equal {same}, "
                        f"stats equal {same_st} ({mesh['stats']} against "
                        f"{plain['stats']}), preemptions {n_pre}")
    _free(plain, mesh)


def _mesh_moe(state, failures, mesh):
    """(c) deepseek-v2-lite at full width cut to ``MLA_TRAIN_LAYERS``
    layers, bf16 weights: greedy ``generate`` of 4 x 64 + 16 and the
    request core on 8 ragged requests (4 slots, 16 new) through the mesh
    path at 1 x 1 beside the plain path: identical tokens and stats."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import GenerationEngine, Request

    cfg = get_config(MLA_ARCH).replace(n_layers=MLA_TRAIN_LAYERS)
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(
        11), cfg.cdtype)
    prompts = torch.randint(0, cfg.vocab_size, (4, 64), device="cuda",
                            generator=torch.Generator(
                                device="cuda").manual_seed(33))
    rng = np.random.default_rng(34)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, int(
        rng.integers(16, 65))).astype(np.int32), max_new_tokens=16)
        for i in range(8)]
    gen = lambda: torch.Generator(device="cuda").manual_seed(7)
    out = {}
    for path, m in (("plain", None), ("mesh", mesh)):
        eng = GenerationEngine(cfg, mesh=m, max_new_tokens=16,
                               temperature=0.0, chunk=8, device="cuda")
        ops.reset_launch_counts()
        seqs = eng.generate(params, prompts, gen())["sequences"]
        _, st, dt, fin = serve.run_schedule(eng, params, reqs, gen(),
                                            mode="continuous", slots=4,
                                            max_seq_len=80)
        counts = ops.launch_counts()
        if m is not None:
            _launched("serve_mesh_deepseek", counts,
                      ("rmsnorm", "flash_attention_fwd"), state, failures)
        out[path] = (seqs, fin, st, dt)
    del params
    gen_ok = torch.equal(out["plain"][0], out["mesh"][0])
    core_ok = out["plain"][1:3] == out["mesh"][1:3]
    log(f"[serve_mesh] deepseek-v2-lite at {MLA_TRAIN_LAYERS} layers (MLA, "
        f"MoE): mesh generate == plain {gen_ok}; mesh core == plain core "
        f"(completions, stats) {core_ok}; core {out['mesh'][3]:.2f}s mesh, "
        f"{out['plain'][3]:.2f}s plain")
    state.setdefault("serve_mesh", {})["moe"] = {"generate_equal": gen_ok,
                                                 "core_equal": core_ok}
    if not (gen_ok and core_ok):
        failures.append(f"deepseek mesh path at 1 x 1: generate equal "
                        f"{gen_ok}, core equal {core_ok}")


def phase_serve_mesh(state):
    """The launchers and the request core on a mesh at 1 x 1: the train
    launcher (``--strategy tp``) and the serve launcher (OPT-1.3B) under
    ``torchrun``, both started first and run beside this process's work:
    the mesh core on a preempting paged int8 pool and an MoE model's mesh
    ``generate`` and core, then the plain train launcher."""
    import gc

    import torch
    failures = []
    runs = {"train": _launch("train_tp", "repro_torch.launch.train", [
        *TRAIN_TP_ARGV, "--mesh", "1,1", "--strategy", "tp", "--zero", "1"]),
        "serve": _launch("serve_mesh", "repro_torch.launch.serve",
                         [*SERVE_ARGV, "--mesh", "1,1"])}
    try:
        with one_rank_mesh("serve_mesh") as mesh:
            for part in (_mesh_preempt, _mesh_moe):
                t0 = time.perf_counter()
                part(state, failures, *([mesh] if part is _mesh_moe
                                        else []))
                gc.collect()      # engines and cores refer to each other
                torch.cuda.empty_cache()
                log(f"[serve_mesh] {part.__name__}: "
                    f"{time.perf_counter() - t0:.1f}s")
        _train_launcher(state, failures, runs["train"])
        _serve_launcher(state, failures, runs["serve"])
    finally:
        for proc, _, _ in runs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    if failures:
        raise AssertionError("serve_mesh: " + "; ".join(failures))


# --------------------------------------------------------------------- #
# the SSM / hybrid serving slice
# --------------------------------------------------------------------- #
def ssd_bound(b, nc, q, h, p, n, esize, kind="fp32"):
    """Least time of one SSD intra-chunk pass, (ms, "bytes"|"operations"):
    FLOP over the causal pairs P = q (q + 1) / 2 (the C.B scores once per
    (batch, chunk), since every head shares them; Y and S_c per head) at
    the rate of ``kind`` (fp32: the CUDA cores, the fp32 kernel's math;
    bf16: the tensor cores, where bf16 inputs can go); bytes of each input
    read once and each output written once."""
    P = q * (q + 1) // 2
    flop = b * nc * (2 * n * P + h * (2 * p * P + 2 * q * p * n))
    return bound(ssd_bytes(b, nc, q, h, p, n, esize), flop, kind)


def ssd_bytes(b, nc, q, h, p, n, esize) -> int:
    """Bytes of one SSD intra-chunk pass: X, dt, B, C read, Y, S_c and
    A_cs written, A read, each once."""
    return (b * nc * (2 * q * h * p * esize + q * h * 4 + 2 * q * n * esize
                      + h * p * n * 4 + h * q * 4) + h * 4)


def _ssd_inputs(gen, b, nc, q, h, p, n, dtype, dt_scale=1.0):
    """X, B and C as strided slices of one (b, nc, q, h p + 2 n) tensor (the
    model's conv-output layout), dt = softplus(N(0, 1)), A = -exp(.)."""
    import torch
    import torch.nn.functional as F
    wide = (torch.randn((b, nc, q, h * p + 2 * n), generator=gen,
                        device="cuda") * 0.5).to(dtype)
    X = wide[..., :h * p].unflatten(-1, (h, p))
    B, C = wide[..., h * p:h * p + n], wide[..., h * p + n:]
    dt = F.softplus(torch.randn((b, nc, q, h), generator=gen,
                                device="cuda")) * dt_scale
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    return X, dt, A, B, C


def _ssd_kernel_rows(state, failures):
    """``ssd_intra_fwd`` against its plain version at the slice's shapes,
    fp32 (TF32 off) and bf16, timed; the overflow case untimed."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_intra_fwd

    gen = torch.Generator(device="cuda").manual_seed(4321)
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    cases = (("mamba2-370m admission", 1, 1, 256, 32, 64, 128),
             ("mamba2-370m ragged q", 1, 1, 137, 32, 64, 128),
             ("mamba2-370m one token", 1, 1, 1, 32, 64, 128),
             ("mamba2-370m 1024 tokens", 1, 4, 256, 32, 64, 128),
             ("mamba2-370m fixed path", 8, 1, 256, 32, 64, 128),
             ("zamba2-1.2b admission", 1, 1, 256, 64, 64, 64))
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tol_y = 1e-4 if dname == "fp32" else 2e-2
        for label, b, nc, q, h, p, n in cases:
            X, dt, A, B, C = _ssd_inputs(gen, b, nc, q, h, p, n, dtype)
            y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
            torch.cuda.synchronize()
            yr, sr, _, ar = ref.ssd_intra_ref(X, dt, A, B, C)
            ey, es, ea = rel(y, yr), rel(s, sr), rel(acs, ar)
            ok = ey <= tol_y and es <= 1e-4 and ea <= 1e-5
            k_ms = time_ms(lambda: ssd_intra_fwd(X, dt, A, B, C))
            p_ms = time_ms(lambda: ref.ssd_intra_ref(X, dt, A, B, C),
                           inner=5, repeats=5)
            # the fp32 kernel's bound at the fp32 rate; the bf16 kernel's
            # at the tensor cores' (bytes), the fp32-rate one beside it
            bnd32 = ssd_bound(b, nc, q, h, p, n, X.element_size())
            bnd = ssd_bound(b, nc, q, h, p, n, X.element_size(), dname)
            shape = f"{label} b={b} nc={nc} q={q} h={h} p={p} n={n}"
            log(f"[ssm] ssd_intra_fwd {shape} {dname}: err Y {ey:.3g} (tol "
                f"{tol_y}) S_c {es:.3g} (tol 1e-4) A_cs {ea:.3g} (tol 1e-5) "
                f"kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} library_ms=null "
                f"bound_ms={bnd[0]:.4f} ({bnd[1]}) bound_fp32_ms="
                f"{bnd32[0]:.4f} ({bnd32[1]}) {'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"ssd_intra_fwd {shape} {dname}: errors "
                                f"{ey:.3g} {es:.3g} {ea:.3g}")
            if (label, dname) == ("mamba2-370m admission", "bf16"):
                state.setdefault("kernel_rows", {})["ssd_intra_fwd"] = {
                    "max_abs_err": float((y.float() - yr.float()).abs()
                                         .max()),
                    "ms": k_ms, "plain_ms": p_ms, "bound_ms": bnd[0],
                    "bound_by": bnd[1], "bound_fp32_ms": bnd32[0],
                    "library_ms": None, "shape": shape, "dtype": dname}
    # dt |A| large: the upper triangle's exp overflows; each kernel selects
    # it away, so the outputs stay finite and equal the plain version's
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tol_y = 1e-4 if dname == "fp32" else 2e-2
        X, dt, A, B, C = _ssd_inputs(gen, 1, 1, 256, 32, 64, 128, dtype,
                                     dt_scale=100.0)
        y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
        torch.cuda.synchronize()
        yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
        span = float((acs[..., 0] - acs[..., -1]).min())
        finite = bool(torch.isfinite(y).all() and torch.isfinite(s).all())
        ey, es = rel(y, yr), rel(s, sr)
        log(f"[ssm] ssd_intra_fwd overflow case {dname} (min A_cs span "
            f"{span:.1f} > 89: exp overflows above the diagonal): finite "
            f"{finite}, err Y {ey:.3g} (tol {tol_y}) S_c {es:.3g} (tol 1e-4)")
        if not (span > 89.0 and finite and ey <= tol_y and es <= 1e-4):
            failures.append(f"ssd_intra_fwd overflow case {dname}: finite "
                            f"{finite}, errors {ey:.3g} {es:.3g}")


def _ssm_parity(failures):
    """Mamba2-370M and Zamba2-1.2B at full width and depth in fp32, random
    weights: teacher-forced streams (a 256- and a 600-token prefill, the
    latter three chunks, then 32 decode steps), every prefill position's
    logits and every step's, measured three ways:

    - end to end, the kernel path against the plain path;
    - the model's own conditioning: the plain path again with the token
      embeddings moved by a relative 1e-7 (about one fp32 rounding).  The
      SSD decays are exp of long cumsums, so each SSM layer multiplies a
      relative input change 10-30 times and 48 layers turn one rounding
      into ~1e-4 of the logits: two paths that differ by rounding alone can
      land that far apart;
    - a per-layer witness: in the plain run every layer also runs through
      the kernel path on the same input and a clone of its cache, and its
      output change (the layer's mixer plus MLP) is held to 1e-4 of the
      plain twin's, free of the amplification by the layers before it.

    Gate: the witness <= 1e-4 at every layer and step, and end to end
    <= 1e-4, or 2x the conditioning where that is larger."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.generate import decode_step

    n_dec = 32
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = get_config(arch).replace(compute_dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_params(cfg, gen)
        noisy = dict(params, embed=params["embed"] * (1 + 1e-7 * torch.randn(
            params["embed"].shape, generator=gen, device="cuda")))
        kcfg = cfg.replace(use_kernels=True)
        pcfg = cfg.replace(use_kernels=False)
        for Lp in (256, 600):
            tokens = torch.randint(0, cfg.vocab_size, (1, Lp + n_dec),
                                   generator=gen, device="cuda")

            def stream(c, p):
                cache = T.init_cache(c, 1, Lp + n_dec, device="cuda")
                hidden, cache, _ = T.forward(c, p, tokens=tokens[:, :Lp],
                                             mode="prefill", cache=cache)
                steps = [T.logits_fn(c, p, hidden)[0]]
                for t in range(n_dec):
                    pos = torch.full((1,), Lp + t, dtype=torch.long,
                                     device="cuda")
                    lg, cache = decode_step(c, p, tokens[:, Lp + t], cache,
                                            pos)
                    steps.append(lg)
                return torch.cat(steps).float()

            w_err = [0.0]
            layer = T._layer

            def witness(c, spec, lp, x, positions, mode, lc, rope,
                        block_tables=None, **kw):
                lck = tree_map(torch.clone, lc) if lc is not None else None
                yk, _ = layer(kcfg, spec, lp, x, positions, mode, lck, rope,
                              block_tables, **kw)
                y, aux = layer(c, spec, lp, x, positions, mode, lc, rope,
                               block_tables, **kw)
                w_err[0] = worst((w_err[0], float(
                    (yk - y).abs().max() / (y - x).abs().max())))
                return y, aux

            t0 = time.perf_counter()
            kern = stream(kcfg, params)
            torch.cuda.synchronize()
            dt_s = time.perf_counter() - t0
            T._layer = witness
            try:
                plain = stream(pcfg, params)
            finally:
                T._layer = layer
            moved = stream(pcfg, noisy)
            finite = bool(torch.isfinite(kern).all()
                          and torch.isfinite(plain).all())
            scale = plain.abs().max()
            rel = float((kern - plain).abs().max() / scale)
            cond = float((moved - plain).abs().max() / scale)
            limit = max(1e-4, 2 * cond)
            agree = float((kern.argmax(-1) == plain.argmax(-1)).float()
                          .mean())
            ok = finite and w_err[0] <= 1e-4 and rel <= limit
            log(f"[ssm] parity {arch} fp32 full width and depth, prefill "
                f"{Lp} + {n_dec} decode steps (teacher-forced): per-layer "
                f"witness max {w_err[0]:.3g} (tol 1e-4); end to end "
                f"max|dlogits|/max|logits| = {rel:.3g} (tol {limit:.3g}: "
                f"1e-4 or 2x the conditioning {cond:.3g}, the plain path "
                f"with embeddings moved by 1e-7); argmax agreement "
                f"{agree:.3f}; finite {finite}; kernel path {dt_s:.2f}s "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"parity {arch} prefill {Lp}: witness "
                                f"{w_err[0]:.3g}, end to end {rel:.3g} (tol "
                                f"{limit:.3g}), finite {finite}")
            del kern, plain, moved
        del params, noisy
        torch.cuda.empty_cache()


def _ssm_greedy(failures):
    """8 ragged greedy requests (one longer than the 256-token chunk)
    through the continuous engine against each request decoded alone on
    the fixed path, kernels on, fp32: identical streams.  (The bf16 runs,
    counted and not gated, went to make room for phases ``mla`` and
    ``xattn``.)"""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import GenerationEngine, Request

    lens = (300, 64, 97, 128, 180, 77, 256, 140)
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        base = get_config(arch)
        params = T.init_params(base, torch.Generator(
            device="cuda").manual_seed(5))
        rng = np.random.default_rng(7)
        reqs = [Request(uid=i, tokens=rng.integers(0, base.vocab_size, lp)
                        .astype(np.int32),
                        max_new_tokens=int(rng.integers(8, 17)))
                for i, lp in enumerate(lens)]
        for dname in ("float32",):
            cfg = base.replace(compute_dtype=dname)
            g = torch.Generator(device="cuda").manual_seed(0)
            eng = GenerationEngine(cfg, max_new_tokens=16, temperature=0.0,
                                   chunk=8)
            t0 = time.perf_counter()
            got = {c.uid: c.tokens.tolist()
                   for c in eng.serve(params, reqs, g, slots=4)}
            dt_s = time.perf_counter() - t0
            alone = {}
            for r in reqs:
                out = GenerationEngine(
                    cfg, max_new_tokens=r.max_new_tokens,
                    temperature=0.0).generate(params, r.tokens[None], g)
                alone[r.uid] = out["sequences"][0, len(r.tokens):].tolist()
            same = sum(got[u] == alone[u] for u in alone)
            log(f"[ssm] greedy {arch} {dname}: continuous engine (4 slots, "
                f"prompts {min(lens)}..{max(lens)}) vs each request alone: "
                f"{same} of {len(reqs)} streams identical (required); "
                f"engine {dt_s:.2f}s")
            if same != len(reqs):
                failures.append(f"greedy {arch} fp32: {same} of {len(reqs)} "
                                f"streams identical")
        del params
        torch.cuda.empty_cache()


def _ssm_time(state):
    """One Mamba2-370M decode step at 16 slots, eager (host clock) and as a
    CUDA-graph replay (device), and launches per admission and per step."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step, prefill

    cfg = get_config("mamba2-370m")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.cast_params(cfg, T.init_params(cfg, gen))
    slots, Lp = 16, 256
    toks = torch.randint(0, cfg.vocab_size, (slots, Lp), generator=gen,
                         device="cuda")
    cache = T.init_cache(cfg, slots, 512, device="cuda")
    prefill(cfg, params, toks, cache)
    row = T.init_cache(cfg, 1, 512, device="cuda")
    admit = lambda: prefill(cfg, params, toks[:1], row)
    pos = torch.full((slots,), Lp, dtype=torch.long, device="cuda")
    tok = toks[:, 0]
    step = lambda: decode_step(cfg, params, tok, cache, pos)
    ops.reset_launch_counts()
    admit()
    per_admit = ops.launch_counts()
    ops.reset_launch_counts()
    step()
    per_step = ops.launch_counts()
    log(f"[ssm] mamba2-370m launches per 256-token admission: {per_admit}")
    log(f"[ssm] mamba2-370m launches per decode step: {per_step}")
    wall = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    eager_ms = statistics.median(wall)
    graph_ms = time_ms(step, inner=4, repeats=5)
    log(f"[ssm] mamba2-370m decode step, 16 slots, bf16: eager "
        f"{eager_ms:.3f} ms (host clock), CUDA-graph replay {graph_ms:.3f} ms "
        f"(device); the device is idle {1 - graph_ms / eager_ms:.1%} of the "
        f"eager step")
    state["ssm_step"] = {"eager_ms": eager_ms, "graph_ms": graph_ms}
    del params, cache, row
    torch.cuda.empty_cache()


def phase_ssm(state):
    """The SSM / hybrid serving slice: the SSD kernel against its plain
    version, full-width fp32 parity of Mamba2-370M and Zamba2-1.2B, the
    32-request serve workload on both in bf16 (launch counts set to 0 just
    before each run and read just after), greedy continuous vs per-request
    streams, and where a Mamba2 decode step and admission spend their
    time."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    _ssd_kernel_rows(state, failures)
    _ssm_parity(failures)
    for arch, must in SSM_SERVE_KERNELS.items():
        res = _serve_run(workload(arch, REPEAT_NEW),
                         f"ssm_serve_{arch}", must, state)
        counts = state["launches"][f"ssm_serve_{arch}"]
        if arch == "mamba2-370m" and any(counts[k]
                                         for k in ATTENTION_KERNELS):
            failures.append(f"serve {arch}: an attention kernel launched "
                            f"{counts}")
        state.setdefault("ssm_serve", {})[arch] = res["tok_s"]
    _ssm_greedy(failures)
    _ssm_time(state)
    if failures:
        raise AssertionError("ssm: " + "; ".join(failures))


# --------------------------------------------------------------------- #
# the SSM / hybrid training slice
# --------------------------------------------------------------------- #
# the kernels each SSM training path must launch: Mamba2 has no attention
# layer; Zamba2's six attention layers train through the flash kernels
# and, under --kv-quant, generate through the int8 decode kernel
SSM_TRAIN_KERNELS = {
    "mamba2-370m": ("rmsnorm", "ssd_intra_fwd"),
    "zamba2-1.2b": ("rmsnorm", "ssd_intra_fwd", "flash_attention_fwd",
                    "flash_attention_bwd")}
SSM_RLHF_KERNELS = {
    "mamba2-370m": ("rmsnorm", "ssd_intra_fwd"),
    "zamba2-1.2b": ("rmsnorm", "ssd_intra_fwd", "flash_attention_fwd",
                    "flash_attention_bwd", "decode_attention_quant_fwd")}
SSM_INT8_SERVE_KERNELS = ("rmsnorm", "ssd_intra_fwd", "flash_attention_fwd",
                          "decode_attention_quant_fwd")


def ssd_bwd_bound(b, nc, q, h, p, n, esize, kind="fp32"):
    """Least time of the intra-chunk pass's backward
    (``ref.ssd_intra_bwd_ref``), (ms, "bytes"|"operations"), counted as
    :func:`ssd_bound` counts the forward: FLOP over the causal pairs P =
    q (q + 1) / 2, per (batch, chunk) the scores G = C B^T and dG B, dG^T C
    (3 x 2 n P, every head shares them), per head dW = dY Xd^T and W^T dY
    (2 x 2 p P), B dS^T and (w Xd)^T dS (2 x 2 q p n); bytes of X, B, C,
    dt, A_cs, dY (X's dtype), dS, dA_cs read once and dX, dB, dC, ddt
    written once."""
    P = q * (q + 1) // 2
    flop = b * nc * (6 * n * P + h * (4 * p * P + 4 * q * p * n))
    nbytes = (b * nc * (3 * q * h * p * esize + 4 * q * h * 4
                        + 4 * q * n * esize + h * p * n * 4) + 2 * h * 4)
    return bound(nbytes, flop, kind)


def _ssd_bwd_rows(state, failures):
    """The explicit SSD backward against autograd of the plain forward
    (``ref.ssd_intra_ref``) at the SFT shapes (Mamba2-370M and Zamba2-1.2B,
    8 x 512 tokens: b 8, nc 2, q 256), fp32 (TF32 off) and bf16 inputs;
    the forward kernel, the explicit backward and autograd of the plain
    forward timed by CUDA-graph replay, beside the backward's bound."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_intra_fwd

    gen = torch.Generator(device="cuda").manual_seed(2020)
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    cases = (("mamba2-370m SFT", 8, 2, 256, 32, 64, 128),
             ("zamba2-1.2b SFT", 8, 2, 256, 64, 64, 64))
    rows = state.setdefault("ssd_bwd", {})
    for dname, dtype in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        tol = 1e-4 if dname == "fp32" else 2e-2
        for label, b, nc, q, h, p, n in cases:
            X, dt, A, B, C = _ssd_inputs(gen, b, nc, q, h, p, n, dtype)
            y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
            # the forward kernel at the shape whose time is train_ms
            with torch.no_grad():
                yr, sr, _, ar = ref.ssd_intra_ref(X, dt, A, B, C)
            fwd_errs = [rel(y, yr), rel(s, sr), rel(acs, ar)]
            fwd_ok = all(e <= t for e, t in
                         zip(fwd_errs, (tol, 1e-4, 1e-5)))   # NaN fails
            del yr, sr, ar
            dY = torch.randn(y.shape, generator=gen, device="cuda").to(
                y.dtype)
            dS = torch.randn(s.shape, generator=gen, device="cuda")
            dAcs = torch.randn(acs.shape, generator=gen, device="cuda")
            got = ref.ssd_intra_bwd_ref(X, dt, A, B, C, acs, dY, dS, dAcs)
            leaves = [t.detach().clone().requires_grad_()
                      for t in (X, dt, A, B, C)]

            def plain_fwd_bwd():
                yr, sr, _, ar = ref.ssd_intra_ref(*leaves)
                return torch.autograd.grad(
                    (yr.float() * dY.float()).sum() + (sr * dS).sum()
                    + (ar * dAcs).sum(), leaves)

            want = plain_fwd_bwd()
            errs = [rel(g, w) for g, w in zip(got, want)]
            finite = all(bool(torch.isfinite(g).all()) for g in got)
            ok = finite and all(e <= tol for e in errs)    # NaN fails
            del want
            f_ms = time_ms(lambda: ssd_intra_fwd(X, dt, A, B, C))
            b_ms = time_ms(lambda: ref.ssd_intra_bwd_ref(
                X, dt, A, B, C, acs, dY, dS, dAcs), inner=3, repeats=5)
            pf_ms = time_ms(
                lambda: ref.ssd_intra_ref(*[t.detach() for t in leaves]),
                inner=3, repeats=5)
            pfb_ms = time_ms(plain_fwd_bwd, inner=2, repeats=5)
            fwd_bnd = ssd_bound(b, nc, q, h, p, n, X.element_size(), dname)
            bnd = ssd_bwd_bound(b, nc, q, h, p, n, X.element_size(), dname)
            bnd32 = ssd_bwd_bound(b, nc, q, h, p, n, X.element_size())
            shape = f"{label} b={b} nc={nc} q={q} h={h} p={p} n={n}"
            log(f"[ssm_train] ssd {shape} {dname}: forward kernel vs "
                f"plain, err Y {fwd_errs[0]:.3g} (tol {tol}) S_c "
                f"{fwd_errs[1]:.3g} (tol 1e-4) A_cs {fwd_errs[2]:.3g} (tol "
                f"1e-5) {'ok' if fwd_ok else 'FAIL'}; backward, explicit vs "
                f"autograd of the plain forward, errors dX ddt dA dB dC "
                f"{' '.join(f'{e:.3g}' for e in errs)} (tol {tol}), finite "
                f"{finite}; forward kernel {f_ms:.4f} ms (bound "
                f"{fwd_bnd[0]:.4f}, {fwd_bnd[1]}); explicit backward "
                f"{b_ms:.4f} ms; autograd of the plain version "
                f"{pfb_ms - pf_ms:.4f} ms (fwd+bwd {pfb_ms:.4f} less fwd "
                f"{pf_ms:.4f}); all by CUDA-graph replay; backward bound "
                f"{bnd[0]:.4f} ms "
                f"({bnd[1]}), at the fp32 rate {bnd32[0]:.4f} ms "
                f"({bnd32[1]}) {'ok' if ok else 'FAIL'}")
            rows[f"{label} {dname}"] = {
                "fwd_errors": fwd_errs, "errors": errs, "fwd_ms": f_ms,
                "fwd_bound_ms": fwd_bnd[0], "bwd_ms": b_ms,
                "autograd_plain_bwd_ms": pfb_ms - pf_ms,
                "plain_fwd_ms": pf_ms, "bwd_bound_ms": bnd[0],
                "bwd_bound_by": bnd[1], "bwd_bound_fp32_ms": bnd32[0]}
            if (label, dname) == ("mamba2-370m SFT", "bf16"):
                row = state.setdefault("kernel_rows", {}).setdefault(
                    "ssd_intra_fwd", {})
                row.update(train_ms=f_ms, train_bound_ms=fwd_bnd[0])
            if not fwd_ok:
                failures.append(f"ssd_intra_fwd {shape} {dname}: errors "
                                f"Y S_c A_cs {fwd_errs}")
            if not ok:
                failures.append(f"ssd backward {shape} {dname}: errors "
                                f"{errs}, finite {finite}")
            del X, dt, A, B, C, y, s, acs, dY, dS, dAcs, got, leaves
            torch.cuda.empty_cache()


def _rmsnorm_bwd_rows(state, failures):
    """The plain RMSNorm backward (``ref.rmsnorm_bwd_ref``, fp32 math: the
    reference has no backward kernel either) at the SFT steps' 8 x 512 =
    4,096 rows, D 1024 (Mamba2-370M) and 2048 (Zamba2-1.2B, OPT-1.3B), in
    bf16: against autograd of the plain forward (2e-2), timed by CUDA-graph
    replay beside its bound (bytes of x, dy and dx, w and dw; ~10 R D FLOP
    at the fp32 rate)."""
    import torch
    from repro_torch.kernels import ref

    gen = torch.Generator(device="cuda").manual_seed(2021)
    rows = state.setdefault("rmsnorm_bwd", {})
    for D in (1024, 2048):
        R = 4096
        x = torch.randn((R, D), generator=gen, device="cuda").bfloat16()
        w = (1 + 0.1 * torch.randn((D,), generator=gen, device="cuda")
             ).bfloat16()
        dy = torch.randn((R, D), generator=gen, device="cuda").bfloat16()
        dx, dw = ref.rmsnorm_bwd_ref(x, w, dy)
        xl, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
        wx, ww = torch.autograd.grad(
            (ref.rmsnorm_ref(xl, wl).float() * dy.float()).sum(), (xl, wl))
        errs = [float((a.float() - b.float()).abs().max()
                      / b.float().abs().max()) for a, b in ((dx, wx), (dw, ww))]
        finite = bool(torch.isfinite(dx).all() and torch.isfinite(dw).all())
        ms = time_ms(lambda: ref.rmsnorm_bwd_ref(x, w, dy), inner=10,
                     repeats=5)
        bnd = bound(3 * R * D * 2 + 2 * D * 2, 10 * R * D, "fp32")
        ok = finite and all(e <= 2e-2 for e in errs)    # NaN fails
        log(f"[ssm_train] rmsnorm backward (plain) R={R} D={D} bf16: errors "
            f"dx dw {' '.join(f'{e:.3g}' for e in errs)} vs autograd of the "
            f"plain forward (tol 2e-2), finite {finite}; "
            f"{ms:.4f} ms, bound {bnd[0]:.4f} ms ({bnd[1]}) "
            f"{'ok' if ok else 'FAIL'}")
        rows[f"R={R} D={D}"] = {"ms": ms, "bound_ms": bnd[0],
                                "bound_by": bnd[1], "errors": errs}
        if not ok:
            failures.append(f"rmsnorm backward D={D}: errors {errs}, "
                            f"finite {finite}")


def _ssm_train_parity(failures):
    """Kernel path against plain path on one SFT step at full width and
    depth, fp32 (TF32 off), random weights, 2 x 512 tokens, remat on:

    - a per-layer witness: the input of a middle SSM layer (and, in
      Zamba2, of a middle attention layer) as the plain forward computes
      it, through that layer on both paths, and the backward of a fixed
      random projection of its output: the output change (the layer's
      mixer) to 1e-4 of the plain twin's, the input's and every parameter's
      gradient to 1e-4 of its max;
    - end to end: the loss and the global grad norm, to 1e-4 or 2x the
      model's conditioning (the plain path with the token embeddings moved
      by a relative 1e-7), whichever is larger (R10)."""
    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_data
    from repro_torch.models import transformer as T
    from repro_torch.models.config import ATTN
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.training.steps import lm_value_and_grad

    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = get_config(arch).replace(compute_dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(0)
        params = T.init_params(cfg, gen)
        batch = to_device(next(lm_data(cfg, 512, 0).sft_batches(2, 1)),
                          "cuda")
        kcfg = cfg.replace(use_kernels=True)
        pcfg = cfg.replace(use_kernels=False)

        # the witness: record the chosen layers' inputs in a plain forward
        kinds = ("ssm", "attn") if cfg.arch_type == "hybrid" else ("ssm",)
        seen, picked = [0], {}
        layer = T._layer

        def spy(c, spec, lp, x, positions, mode, lc, rope,
                block_tables=None, **kw):
            kind = "attn" if spec.kind == ATTN else "ssm"
            if (seen[0] >= cfg.n_layers // 2 and kind in kinds
                    and kind not in picked):
                picked[kind] = (seen[0], spec, lp, x.clone(), positions,
                                rope)
            seen[0] += 1
            return layer(c, spec, lp, x, positions, mode, lc, rope,
                         block_tables, **kw)

        T._layer = spy
        try:
            with torch.no_grad():
                T.forward(pcfg, params, tokens=batch["tokens"])
        finally:
            T._layer = layer
        for kind, (idx, spec, lp, x, positions, rope) in picked.items():
            w = torch.randn(x.shape, generator=gen, device="cuda")
            res = {}
            for uk, c in ((True, kcfg), (False, pcfg)):
                lpg = tree_map(lambda t: t.detach().clone()
                               .requires_grad_(), lp)
                xg = x.detach().clone().requires_grad_()
                if uk:
                    ops.reset_launch_counts()
                out, _ = layer(c, spec, lpg, xg, positions, "full", None,
                               rope)
                (out * w).sum().backward()
                torch.cuda.synchronize()
                if uk:
                    counts = ops.launch_counts()
                # the input's grad less the residual path's (w itself)
                res[uk] = (out.detach(), [xg.grad - w] + [
                    t.grad for t in tree_leaves(lpg)])
            (ok_, gk), (op_, gp) = res[True], res[False]
            out_rel = float((ok_ - op_).abs().max() / (op_ - x).abs().max())
            grad_errs = [float((a - b).abs().max()
                               / b.abs().max().clamp(min=1e-30))
                         for a, b in zip(gk, gp)]
            # every error against its tolerance: Python's max drops a NaN
            # that is not first
            finite = all(bool(torch.isfinite(g).all()) for g in gk)
            ok = (finite and out_rel <= 1e-4
                  and all(e <= 1e-4 for e in grad_errs))
            grad_rel = max(grad_errs)
            used = [k for k, v in counts.items() if v]
            log(f"[ssm_train] witness {arch} fp32 layer {idx} ({kind}), "
                f"2 x 512 tokens: output change {out_rel:.3g}, max over "
                f"the input (less the residual) and {len(gk) - 1} "
                f"parameter grads of "
                f"max|dgrad|/max|grad| {grad_rel:.3g} (tol 1e-4, each), "
                f"kernel grads finite {finite}; kernels launched {used} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                failures.append(f"witness {arch} layer {idx}: output "
                                f"{out_rel:.3g}, grads {grad_errs}, finite "
                                f"{finite}")
            del res, gk, gp
        del picked

        def loss_gnorm(c, p):
            (loss, _), grads = lm_value_and_grad(c, p, batch)
            gn = torch.sqrt(sum((g.double() ** 2).sum()
                                for g in tree_leaves(grads)))
            return float(loss), float(gn)

        t0 = time.perf_counter()
        ops.reset_launch_counts()
        lk, gk_ = loss_gnorm(kcfg, params)
        counts = ops.launch_counts()
        dt_s = time.perf_counter() - t0
        lp_, gp_ = loss_gnorm(pcfg, params)
        noisy = dict(params, embed=params["embed"] * (1 + 1e-7 * torch.randn(
            params["embed"].shape, generator=gen, device="cuda")))
        lm_, gm_ = loss_gnorm(pcfg, noisy)
        del noisy
        r_loss, r_gn = abs(lk - lp_) / abs(lp_), abs(gk_ - gp_) / gp_
        c_loss, c_gn = abs(lm_ - lp_) / abs(lp_), abs(gm_ - gp_) / gp_
        lim_loss, lim_gn = max(1e-4, 2 * c_loss), max(1e-4, 2 * c_gn)
        import math
        ok = (math.isfinite(lk) and math.isfinite(gk_) and r_loss <= lim_loss
              and r_gn <= lim_gn)
        log(f"[ssm_train] parity {arch} fp32 full width and depth, one SFT "
            f"step of 2 x 512, remat on: loss kernel {lk:.7f} plain "
            f"{lp_:.7f} (rel {r_loss:.3g}, tol {lim_loss:.3g}: 1e-4 or 2x "
            f"the conditioning {c_loss:.3g}); grad norm kernel {gk_:.6f} "
            f"plain {gp_:.6f} (rel {r_gn:.3g}, tol {lim_gn:.3g}, "
            f"conditioning {c_gn:.3g}); kernel path {dt_s:.2f}s, launches "
            f"{ {k: v for k, v in counts.items() if v} } "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"parity {arch}: loss rel {r_loss:.3g} (tol "
                            f"{lim_loss:.3g}), grad norm rel {r_gn:.3g} (tol "
                            f"{lim_gn:.3g})")
        missing = [k for k in SSM_TRAIN_KERNELS[arch] if counts[k] == 0]
        if missing:
            failures.append(f"parity {arch}: the kernel path skipped "
                            f"{missing}")
        del params
        torch.cuda.empty_cache()


def _ssm_sft(state, failures):
    """``launch.train`` at Mamba2-370M (10 steps) and Zamba2-1.2B (5 steps),
    8 x 512, bf16 on fp32 masters, remat on, the counts set to 0 just
    before each run and read just after; then 5 Mamba2-370M reward steps of
    8 pairs x 512."""
    import math

    import torch
    from repro_torch import to_device
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import reward as R
    from repro_torch.training.steps import reward_train_step
    from repro_torch.training.train_state import TrainState

    for arch, steps in (("mamba2-370m", 10), ("zamba2-1.2b", 5)):
        argv = ["--arch", arch, "--steps", str(steps), "--batch", "8",
                "--seq", "512"]
        log(f"[ssm_train] python -m repro_torch.launch.train "
            f"{' '.join(argv)}")
        ops.reset_launch_counts()
        out = launch_train.main(argv)
        counts = ops.launch_counts()
        state.setdefault("launches", {})[f"ssm_sft_{arch}"] = counts
        losses, steady = out["loss"], out["step_ms"][1:]
        per_step = out["launches"][-1]
        log(f"[ssm_train] {arch} bf16 SFT losses "
            f"{' '.join(f'{x:.4f}' for x in losses)}; step ms "
            f"{' '.join(f'{x:.1f}' for x in out['step_ms'])}; median after "
            f"the first {statistics.median(steady):.1f} ms, "
            f"{out['tok_s']:.1f} tok/s, peak memory "
            f"{out['peak_mem_bytes'] / 2**30:.2f} GiB")
        log(f"[ssm_train] {arch} launches per step "
            f"{ {k: v for k, v in per_step.items() if v} }; in the run "
            f"{ {k: v for k, v in counts.items() if v} }")
        state.setdefault("ssm_sft", {})[arch] = {
            "step_ms": statistics.median(steady), "tok_s": out["tok_s"],
            "peak_gib": out["peak_mem_bytes"] / 2**30,
            "launches_per_step": per_step}
        if not all(math.isfinite(x) for x in losses):
            failures.append(f"sft {arch}: losses not finite {losses}")
        missing = [k for k in SSM_TRAIN_KERNELS[arch] if counts[k] == 0]
        if missing:
            failures.append(f"sft {arch}: kernels never launched {missing}")
        if arch == "mamba2-370m" and any(counts[k]
                                         for k in ATTENTION_KERNELS):
            failures.append(f"sft {arch}: an attention kernel launched")



    # reward model on the Mamba2 backbone
    cfg = get_config("mamba2-370m")
    rstate = TrainState.create(R.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(2)))
    rlosses, rms = [], []
    for i, rb in enumerate(launch_train.lm_data(cfg, 512, 0)
                           .reward_batches(8, 5)):
        rb = to_device(rb, "cuda")
        t0 = time.perf_counter()
        rstate, m = reward_train_step(cfg, rstate, rb, 1e-5)
        rlosses.append(float(m["loss"]))
        rms.append((time.perf_counter() - t0) * 1e3)
    log(f"[ssm_train] mamba2-370m reward model, 8 pairs x 512 tokens, bf16: "
        f"losses {' '.join(f'{x:.4f}' for x in rlosses)}; step ms "
        f"{' '.join(f'{x:.1f}' for x in rms)}; median after the first "
        f"{statistics.median(rms[1:]):.1f} ms")
    state.setdefault("ssm_sft", {})["reward"] = {
        "step_ms": statistics.median(rms[1:])}
    if not all(math.isfinite(x) for x in rlosses):
        failures.append(f"reward: losses not finite {rlosses}")
    del rstate
    torch.cuda.empty_cache()


def _ssm_rlhf(state, failures):
    """``launch.train --rlhf`` at Mamba2-370M (2 steps of each stage, 8 x
    256 prompts, 64 new tokens) and Zamba2-1.2B with ``--kv-quant`` (1
    step, 4 prompts, 32 new): launches, peak memory, every loss finite, and
    the frozen reference and reward models unchanged by stage 3 (checksums
    taken around ``RLHFPipeline.run_ppo``)."""
    import math

    import torch
    from repro_torch.core import pipeline
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    seen = {}
    run_ppo = pipeline.RLHFPipeline.run_ppo

    def checked_run_ppo(self, *a, **kw):
        seen["before"] = {"ref": _checksum(self.e.ref_params),
                          "reward": _checksum(self.e.reward_params)}
        out = run_ppo(self, *a, **kw)
        seen["after"] = {"ref": _checksum(self.trainer.ref_params),
                         "reward": _checksum(self.trainer.reward_params)}
        seen["rm_losses"] = list(self.log["stage2"])
        return out

    runs = (("mamba2-370m", ["--steps", "2", "--batch", "8", "--seq", "256",
                             "--max-new", "64"]),
            ("zamba2-1.2b", ["--kv-quant", "--steps", "1", "--batch", "4",
                             "--seq", "256", "--max-new", "32"]))
    pipeline.RLHFPipeline.run_ppo = checked_run_ppo
    try:
        for arch, extra in runs:
            argv = ["--arch", arch, "--rlhf", *extra]
            log(f"[ssm_train] python -m repro_torch.launch.train "
                f"{' '.join(argv)}")
            seen.clear()
            ops.reset_launch_counts()
            t0 = time.perf_counter()
            out = launch_train.main(argv)
            wall = time.perf_counter() - t0
            counts = ops.launch_counts()
            state.setdefault("launches", {})[f"ssm_rlhf_{arch}"] = counts
            iters = out["stage3"]
            for i, m in enumerate(iters):
                log(f"[ssm_train] {arch} PPO iteration {i}: gen "
                    f"{m['gen_s']:.2f}s = {m['gen_tok_s']:.1f} tok/s, "
                    f"scoring {m['score_ms']:.1f} ms, actor step "
                    f"{m['actor_ms']:.1f} ms, critic step "
                    f"{m['critic_ms']:.1f} ms; ratio_mean "
                    f"{m['ratio_mean']:.6f} actor_loss {m['actor_loss']:.4f} "
                    f"v_loss {m['v_loss']:.4f} reward {m['reward_score']:.4f}")
            peak = out["peak_mem_bytes"] / 2**30
            steps = out["step_ms"]
            log(f"[ssm_train] {arch} rlhf {wall:.1f}s: stages "
                f"{ {k: round(v, 2) for k, v in out['timings'].items()} }, "
                f"SFT losses {out['sft_loss']}, RM losses "
                f"{seen.get('rm_losses')}, SFT/RM step ms "
                f"{ {k: [round(x, 1) for x in v] for k, v in steps.items()} }; "
                f"peak memory {peak:.2f} GiB; checksums before stage 3 "
                f"{seen.get('before')}, after {seen.get('after')}; launches "
                f"{ {k: v for k, v in counts.items() if v} }")
            state.setdefault("ssm_rlhf", {})[arch] = {
                "wall_s": wall, "timings": out["timings"], "peak_gib": peak,
                "iters": iters, "step_ms": out["step_ms"]}
            nums = (list(out["sft_loss"]) + list(seen.get("rm_losses", []))
                    + [v for m in iters for v in m.values()
                       if isinstance(v, float)])
            if not nums or not all(math.isfinite(v) for v in nums):
                failures.append(f"rlhf {arch}: a non-finite loss or metric")
            if not seen.get("before") or seen["before"] != seen["after"]:
                failures.append(f"rlhf {arch}: the frozen reference or "
                                f"reward model moved: {seen}")
            missing = [k for k in SSM_RLHF_KERNELS[arch] if counts[k] == 0]
            if missing:
                failures.append(f"rlhf {arch}: kernels never launched "
                                f"{missing}")
            if arch == "zamba2-1.2b" and counts["decode_attention_fwd"]:
                failures.append("rlhf zamba2-1.2b --kv-quant: the bf16 "
                                "decode kernel launched")
            if arch == "mamba2-370m" and any(counts[k]
                                             for k in ATTENTION_KERNELS):
                failures.append("rlhf mamba2-370m: an attention kernel "
                                "launched")
            del out
            torch.cuda.empty_cache()
    finally:
        pipeline.RLHFPipeline.run_ppo = run_ppo


def _zamba2_int8(state, failures):
    """Zamba2-1.2B with ``--kv-quant``: the 32-request serve workload in
    bf16 (the int8 decode kernel launched, the bf16 one never); then the
    int8 gate of phase ``parity`` at full width cut to 12 layers (two
    hybrid units), fp32:
    a 256-token prefill and 32 greedy steps on the int8 arena, kernel path
    vs plain path, held from one cache at 1e-4 (the witness: each step
    again from clones of the kernel path's cache, so only the decode math
    differs) and, free-running, to a tenth of the int8 cache's own error
    (the plain path on an fp32 cache, teacher-forced on the same tokens),
    with the tokens identical."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves

    tag = "ssm_serve_zamba2-1.2b_int8"
    # no warm-up after phase ssm's bf16 run of this workload: the int8
    # run's first calls land in its tok/s
    res = _serve_run(workload("zamba2-1.2b", REPEAT_NEW) + ["--kv-quant"],
                     tag, SSM_INT8_SERVE_KERNELS, state,
                     warmup="zamba2-1.2b" not in state.get("ssm_serve", {}))
    if state["launches"][tag]["decode_attention_fwd"]:
        failures.append("serve zamba2-1.2b --kv-quant: the bf16 decode "
                        "kernel launched")
    state.setdefault("ssm_serve", {})["zamba2-1.2b int8"] = res["tok_s"]

    Lp, n_dec = 256, 32
    cfg = get_config("zamba2-1.2b").replace(n_layers=12,
                                            compute_dtype="float32",
                                            kv_quant=True)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = T.init_params(cfg, gen)
    prompt = torch.randint(0, cfg.vocab_size, (1, Lp), generator=gen,
                           device="cuda")
    runs, (wa, wb) = _int8_streams(cfg, params, prompt, n_dec)
    (a, ta, kcache), (b, tb, pcache) = runs["kernel"], runs["plain"]
    fp = runs["plain-fp32-cache"][0]
    rel_wit = float((wa - wb).abs().max() / wb.abs().max())
    wit_same = bool(torch.equal(wa.argmax(-1), wb.argmax(-1)))
    int8 = [t for t in tree_leaves(kcache) if t.dtype == torch.int8]
    rel8 = float((a - b).abs().max() / b.abs().max())
    quant_err = float((b - fp).abs().max() / fp.abs().max())
    same = bool(torch.equal(ta, tb))
    # the first attention layer's int8 rows (unit 0 of the stacked layer)
    ca, cb = (next(d for d in c[0] if "k" in d) for c in (kcache, pcache))
    steps_apart = max(int((ca[n][0].int() - cb[n][0].int()).abs().max())
                      for n in ("k", "v"))
    ok = (bool(torch.isfinite(a).all()) and bool(int8) and wit_same
          and rel_wit <= 1e-4 and same and rel8 <= 0.1 * quant_err
          and steps_apart <= 1)
    log(f"[ssm_train] zamba2-1.2b full width, 12 layers, fp32, int8 KV "
        f"({len(int8)} int8 leaves): {n_dec} decode steps from one int8 "
        f"cache, kernel vs plain max|dlogits|/max|logits| = {rel_wit:.3g} "
        f"(tol 1e-4), argmax identical {wit_same}; free-running {Lp} "
        f"prefill + {n_dec} greedy steps: kernel vs plain {rel8:.3g}, int8 "
        f"vs fp32 cache (plain) {quant_err:.3g}, gap / int8 error "
        f"{rel8 / max(quant_err, 1e-30):.3g} (tol 0.1), tokens identical "
        f"{same}; the first attention layer's int8 rows at most "
        f"{steps_apart} step apart (tol 1) {'ok' if ok else 'FAIL'}")
    state["ssm_int8"] = {"rel_one_cache": rel_wit, "rel": rel8,
                         "quant_err": quant_err, "tokens_same": same}
    if not ok:
        failures.append(f"zamba2 int8: witness {rel_wit:.3g} (argmax same "
                        f"{wit_same}), free-running {rel8:.3g} vs int8 error "
                        f"{quant_err:.3g}, tokens identical {same}, int8 "
                        f"rows {steps_apart} steps apart")
    del params, runs, kcache, pcache, ca, cb, wa, wb
    torch.cuda.empty_cache()


def _gate_inputs(cfg, B: int, L: int, n_prompt: int, seed: int):
    """An SFT batch of ``B`` x ``L`` tokens of the blend on the card and
    ``B`` random prompts of ``n_prompt`` tokens (with encoder embeddings
    for a VLM, the same for both)."""
    import torch
    from repro_torch.launch.train import lm_data, to_device
    gen = torch.Generator(device="cuda").manual_seed(seed)
    batch = to_device(next(iter(lm_data(cfg, L, 0).sft_batches(B, 1))),
                      "cuda")
    prompts = torch.randint(0, cfg.vocab_size, (B, n_prompt), generator=gen,
                            device="cuda")
    enc = None
    if cfg.arch_type == "vlm":
        enc = torch.randn((B, cfg.encoder_len, cfg.encoder_dim),
                          generator=gen, device="cuda")
        batch["encoder_embeds"] = enc
    return batch, prompts, enc


def _ssm_mesh_identity(state, failures):
    """The tensor-parallel path at 1 x 1 against the plain path at
    Mamba2-370M and Zamba2-1.2B, full size (:func:`mesh_identity`: one SFT
    step of 4 x 512, bit for bit; a greedy generate of 4 x 64 + 16
    tokens, token-identical)."""
    from repro_torch.configs import get_config
    for arch in ("mamba2-370m", "zamba2-1.2b"):
        cfg = get_config(arch)
        batch, prompts, _ = _gate_inputs(cfg, 4, 512, 64, seed=31)
        mesh_identity(f"ssm_train_{arch}", cfg, batch, prompts, 16,
                      SSM_TRAIN_KERNELS[arch], state, failures)


def phase_ssm_train(state):
    """The SSM / hybrid training slice: the explicit SSD backward against
    autograd of the plain forward at the SFT shapes, timed beside the
    forward kernel; kernel vs plain path on one fp32 SFT step of
    Mamba2-370M and Zamba2-1.2B (per-layer witness and end to end); the
    bf16 SFT runs through ``launch.train`` with launches per step; Mamba2
    reward steps; the 3-stage pipeline on
    both (Zamba2 with int8 KV generation); Zamba2 ``--kv-quant`` serving
    and its int8 gate."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    _ssd_bwd_rows(state, failures)
    _rmsnorm_bwd_rows(state, failures)
    _ssm_train_parity(failures)
    _ssm_sft(state, failures)
    _ssm_mesh_identity(state, failures)
    _ssm_rlhf(state, failures)
    _zamba2_int8(state, failures)
    if failures:
        raise AssertionError("ssm_train: " + "; ".join(failures))


# --------------------------------------------------------------------- #
# ckpt: checkpoint/resume, LoRA, export -> serve, the torch example
# --------------------------------------------------------------------- #
CKPT_ROOT = ROOT / "build" / "ckpt_phase"       # git-ignored
CKPT_MIN_DISK = 60e9
# wall-time keys of a PPO iteration's metrics: excluded from bit-identity
WALL_TIME = ("gen_tok_s", "gen_s", "score_ms", "actor_ms", "critic_ms")
OPT13_SFT = ["--arch", "opt-1.3b", "--steps", "3", "--batch", "8",
             "--seq", "512"]
# the SFT kill-and-resume leg's depth: OPT-1.3B at full width, 8 of its 24
# layers (a 6 GB state where the whole is 16.8 GB: the leg writes three
# and reads one, and the disk's rate sets its time)
CKPT_SFT_LAYERS = 8
PPO_ARGV = ["--arch", "opt-125m", "--rlhf", "--steps", "3", "--batch", "8",
            "--seq", "512", "--max-new", "64"]
PPO_KERNELS = TRAIN_KERNELS + ("decode_attention_fwd",)


def _free(*dicts) -> None:
    """Drop the device tensors a launcher's summary holds."""
    import gc

    import torch
    for d in dicts:
        for k in ("state", "params"):
            d.pop(k, None)
    gc.collect()
    torch.cuda.empty_cache()


def _launched(tag, counts, must, state, failures) -> None:
    state.setdefault("launches", {})[tag] = counts
    missing = [k for k in must if counts[k] == 0]
    if missing:
        failures.append(f"{tag}: kernels never launched: {missing}")


def _ckpt_sft_cfg():
    from repro_torch.configs import get_config
    return get_config("opt-1.3b").replace(n_layers=CKPT_SFT_LAYERS)


def _ckpt_room() -> None:
    """Free disk under the phase's directory and available host RAM,
    against 60 GB and 2x the largest snapshot (the SFT leg's state)."""
    import shutil
    from repro_torch.models import transformer as T
    free = shutil.disk_usage(CKPT_ROOT).free
    mem = {}
    with open("/proc/meminfo") as f:
        for line in f:
            k, v = line.split(":")
            mem[k] = int(v.split()[0]) * 1024
    snap = 12 * T.count_params(_ckpt_sft_cfg())
    log(f"[ckpt] room: {free / 1e9:.1f} GB free disk under {CKPT_ROOT} "
        f"(need {CKPT_MIN_DISK / 1e9:.0f}), host RAM "
        f"{mem['MemAvailable'] / 1e9:.1f} GB available of "
        f"{mem['MemTotal'] / 1e9:.1f} (need 2 x the largest snapshot, "
        f"{2 * snap / 1e9:.1f})")
    if free < CKPT_MIN_DISK or mem["MemAvailable"] < 2 * snap:
        raise AssertionError(
            f"ckpt: not enough room: disk {free / 1e9:.1f} GB (need "
            f"{CKPT_MIN_DISK / 1e9:.0f}), RAM {mem['MemAvailable'] / 1e9:.1f}"
            f" GB (need {2 * snap / 1e9:.1f})")


def _ckpt_sft(state, failures) -> None:
    """(2) the determinism witness, (3) SFT kill-and-resume, OPT-1.3B at
    full width cut to ``CKPT_SFT_LAYERS`` layers, bf16 on fp32 masters,
    remat on.  Two uninterrupted runs, the second with saves, must give one
    state hash, and the resumed run the same."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    cfg = _ckpt_sft_cfg()
    log(f"[ckpt] witness: python -m repro_torch.launch.train "
        f"{' '.join(OPT13_SFT)} (n_layers {CKPT_SFT_LAYERS})")
    ops.reset_launch_counts()
    out = launch_train.main(OPT13_SFT, cfg=cfg)
    _launched("ckpt_sft", ops.launch_counts(), TRAIN_KERNELS, state,
              failures)
    witness = out["state_sha256"]
    log(f"[ckpt] witness: state sha256 {witness}; step ms "
        + " ".join(f"{x:.1f}" for x in out["step_ms"]))
    _free(out)
    d = CKPT_ROOT / "sft"
    argv = [*OPT13_SFT, "--save-every", "2", "--ckpt-dir", str(d),
            "--keep", "2"]
    log(f"[ckpt] python -m repro_torch.launch.train {' '.join(argv)} "
        f"(n_layers {CKPT_SFT_LAYERS})")
    first = launch_train.main(argv, cfg=cfg)
    st, ms = first["ckpt_stats"], first["step_ms"]
    hashes = [witness, first["state_sha256"]]
    log(f"[ckpt] run with saves: state sha256 {hashes[1]}")
    if hashes[0] != hashes[1]:
        failures.append(f"ckpt: two uninterrupted OPT-1.3B runs differ: "
                        f"{hashes}")
    _free(first)
    with open(d / "step_00000002" / "manifest.json") as f:
        leaves = json.load(f)["leaves"]       # for the mesh leg
    shutil.rmtree(d / "step_00000003")         # a crash after step 2's commit
    log(f"[ckpt] deleted step_00000003; rerun with --resume")
    again = launch_train.main([*argv, "--resume"], cfg=cfg)
    rs = again["restore"]
    if again["state_sha256"] != hashes[0] or again["start"] != 2:
        failures.append(f"ckpt: SFT resumed at {again['start']} with state "
                        f"{again['state_sha256']}, the witness "
                        f"{hashes[0]}")
    st = st + again["ckpt_stats"]
    _free(again)
    for s in st:
        log(f"[ckpt] save of step {s['step']}: {s['bytes'] / 1e9:.3f} GB; "
            f"snapshot {s['snapshot_s'] * 1e3:.1f} ms (the stall); "
            f"background write {s['write_s']:.2f} s = "
            f"{s['bytes'] / 1e9 / s['write_s']:.3f} GB/s")
    log(f"[ckpt] restore of step {rs['step']}: {rs['bytes'] / 1e9:.3f} GB "
        f"in {rs['seconds']:.2f} s = {rs['bytes'] / 1e9 / rs['seconds']:.3f}"
        f" GB/s (reads, CRCs, copy to the card)")
    log(f"[ckpt] step ms: step 1 {ms[1]:.1f} (no write in flight), step 2 "
        f"{ms[2]:.1f} (overlaps the step-2 write)")
    log(f"[ckpt] SFT resume: state sha256 equal to the witness: "
        f"{again['state_sha256'] == hashes[0]}")
    state["ckpt"] = {"saves": st, "restore": rs, "step_ms": ms[1:3],
                     "witness_equal": hashes[0] == hashes[1]}
    return {"witness": witness, "dir": d, "leaves": leaves}


def _ckpt_io(tag, saves, restore) -> None:
    for s in saves:
        log(f"[ckpt] {tag} save of step {s['step']}: {s['bytes'] / 1e9:.3f} "
            f"GB; snapshot {s['snapshot_s'] * 1e3:.1f} ms; write "
            f"{s['write_s']:.2f} s = {s['bytes'] / 1e9 / s['write_s']:.3f} "
            f"GB/s")
    if restore:
        log(f"[ckpt] {tag} restore of step {restore['step']}: "
            f"{restore['bytes'] / 1e9:.3f} GB in {restore['seconds']:.2f} s "
            f"= {restore['bytes'] / 1e9 / restore['seconds']:.3f} GB/s")


def _ckpt_mesh(state, failures, sft) -> None:
    """(5) sharded checkpoints on the mesh path at 1 x 1 (a one-rank NCCL
    group in this process, as phase ``serve_mesh`` drives its launchers):
    OPT-1.3B SFT at ``CKPT_SFT_LAYERS`` layers, ``--mesh 1,1 --strategy tp
    --zero 1`` with saves, whose step-2 manifest must be the plain run's
    (leaves, windows, sizes, CRCs) and final hash the witness; then the
    plain run's checkpoint resumed on the mesh path and the mesh run's
    (its last step deleted) on the plain path, each ending on the
    witness (the resumes save nothing: their restores are the reading)."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    cfg = _ckpt_sft_cfg()
    mesh_argv = ["--mesh", "1,1", "--strategy", "tp", "--zero", "1"]
    dm = CKPT_ROOT / "sft_mesh"
    argv = [*OPT13_SFT, "--save-every", "2", "--keep", "2"]
    got = {}
    with one_rank_mesh("ckpt"):
        log(f"[ckpt] mesh: python -m repro_torch.launch.train "
            f"{' '.join(argv + mesh_argv)} --ckpt-dir {dm} (n_layers "
            f"{CKPT_SFT_LAYERS})")
        ops.reset_launch_counts()
        run = launch_train.main([*argv, *mesh_argv, "--ckpt-dir", str(dm)],
                                cfg=cfg)
        _launched("ckpt_mesh_sft", ops.launch_counts(), TRAIN_KERNELS,
                  state, failures)
        with open(dm / "step_00000002" / "manifest.json") as f:
            leaves = json.load(f)["leaves"]
        got["manifest"] = leaves == sft["leaves"]
        got["run"] = run["state_sha256"] == sft["witness"]
        saves = run["ckpt_stats"]
        _free(run)
        shutil.rmtree(sft["dir"] / "step_00000003")
        log("[ckpt] mesh: the plain run's checkpoint (step 3 deleted) "
            "resumed on the mesh path")
        ops.reset_launch_counts()
        on_mesh = launch_train.main([*OPT13_SFT, *mesh_argv, "--ckpt-dir",
                                     str(sft["dir"]), "--resume"], cfg=cfg)
        _launched("ckpt_mesh_resume", ops.launch_counts(), TRAIN_KERNELS,
                  state, failures)
        got["plain_on_mesh"] = (on_mesh["state_sha256"] == sft["witness"]
                                and on_mesh["start"] == 2)
        rs_mesh = on_mesh["restore"]
        _free(on_mesh)
    shutil.rmtree(sft["dir"], ignore_errors=True)
    shutil.rmtree(dm / "step_00000003")
    log("[ckpt] mesh: the mesh run's checkpoint (step 3 deleted) resumed on "
        "the plain path")
    on_plain = launch_train.main([*OPT13_SFT, "--ckpt-dir", str(dm),
                                  "--resume"], cfg=cfg)
    got["mesh_on_plain"] = (on_plain["state_sha256"] == sft["witness"]
                            and on_plain["start"] == 2)
    rs_plain = on_plain["restore"]
    _free(on_plain)
    shutil.rmtree(dm, ignore_errors=True)
    _ckpt_io("mesh 1 x 1", saves, rs_mesh)
    _ckpt_io("plain path, of the mesh run's", [], rs_plain)
    for k, ok in got.items():
        what = ("equal to the plain run's" if k == "manifest"
                else "ends on the witness")
        log(f"[ckpt] mesh: {k} {what}: {ok}")
        if not ok:
            failures.append(f"ckpt: mesh leg {k} differs")
    state["ckpt"]["mesh"] = {"saves": saves, "restore": rs_mesh,
                             "restore_plain": rs_plain, **got}


def _ppo_record(out, drop=()) -> dict:
    return {"scores": out["ppo_scores"],
            "stage3": [{k: v for k, v in m.items()
                        if k not in WALL_TIME + drop}
                       for m in out["stage3"]],
            "sha": out["state_sha256"]}


def _ckpt_ppo(state, failures) -> dict:
    """(4) PPO resume at OPT-125M, full width and depth: an uninterrupted
    run that checkpoints its stage boundaries, iteration 1 and the last
    (``--save-every 2 --keep 2``), its last checkpoint deleted (a crash
    after iteration 1's commit, the SFT leg's technique), then a rerun
    from a fresh engine on the same directory, which resumes at iteration
    2 and must end as the uninterrupted run did.  Returns the
    uninterrupted run's record."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    d = CKPT_ROOT / "ppo"
    argv = [*PPO_ARGV, "--ckpt-dir", str(d), "--save-every", "2", "--keep",
            "2"]
    log(f"[ckpt] uninterrupted: python -m repro_torch.launch.train "
        f"{' '.join(argv)}")
    ops.reset_launch_counts()
    first = launch_train.main(argv)
    ref = _ppo_record(first)
    saves = first["ckpt_stats"]
    _launched("ckpt_ppo", ops.launch_counts(), PPO_KERNELS, state, failures)
    _free(first)
    last = sorted(p.name for p in d.iterdir() if p.name.startswith("step_"))
    shutil.rmtree(d / last[-1])        # a crash after iteration 1's commit
    log(f"[ckpt] deleted {last[-1]}; rerun on {sorted(last[:-1])}")
    out = launch_train.main(argv)
    got = _ppo_record(out)
    resumed = len(out["ckpt_stats"]) == 1    # only the last iteration ran
    log(f"[ckpt] PPO resume: ran {len(out['ckpt_stats'])} iteration(s)")
    if not resumed:
        failures.append(f"ckpt: the PPO rerun saved {out['ckpt_stats']}")
    for k in ("scores", "stage3", "sha"):
        same = got[k] == ref[k]
        log(f"[ckpt] PPO resume: {k} equal to the uninterrupted run: {same}")
        if not same:
            failures.append(f"ckpt: PPO resume {k}: {got[k]} vs {ref[k]}")
    for s in saves:
        log(f"[ckpt] PPO save of step {s['step']}: {s['bytes'] / 1e9:.3f} GB,"
            f" snapshot {s['snapshot_s'] * 1e3:.1f} ms, write "
            f"{s['write_s']:.2f} s")
    state.setdefault("ckpt", {})["ppo_save"] = saves[-1]
    _free(out)
    shutil.rmtree(d, ignore_errors=True)
    return ref


def _ckpt_ppo_mesh(state, failures, ref) -> None:
    """(6) the PPO resume of (4) on ``--rlhf --mesh 1,1`` (the Hybrid
    Engine at one rank, on ``one_rank_mesh``): an uninterrupted run with
    its own saves, its last checkpoint deleted, and a rerun that resumes at
    iteration 2; both must end as the plain uninterrupted run did (the
    engine's reshard metrics aside).  At one rank the pipeline keeps its
    models in no mesh layout (``RLHFPipeline._layouts`` is ``None``), so
    this holds the launcher's mesh path with checkpoints, and the trainer
    it runs is the plain one."""
    import shutil

    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    d = CKPT_ROOT / "ppo_mesh"
    argv = [*PPO_ARGV, "--ckpt-dir", str(d), "--save-every", "2", "--keep",
            "2", "--mesh", "1,1"]
    drop = ("reshard_bytes", "reshard_s")
    want = dict(ref, stage3=[{k: v for k, v in m.items() if k not in drop}
                             for m in ref["stage3"]])
    runs = {}
    with one_rank_mesh("ckpt"):
        for name in ("uninterrupted", "resumed"):
            log(f"[ckpt] mesh {name}: python -m repro_torch.launch.train "
                f"{' '.join(argv)}")
            ops.reset_launch_counts()
            runs[name] = launch_train.main(argv)
            _launched(f"ckpt_ppo_mesh_{name}", ops.launch_counts(),
                      PPO_KERNELS, state, failures)
            if name == "uninterrupted":
                last = sorted(p.name for p in d.iterdir()
                              if p.name.startswith("step_"))
                shutil.rmtree(d / last[-1])   # a crash after iteration 1
                log(f"[ckpt] mesh: deleted {last[-1]}")
    saved = [len(r["ckpt_stats"]) for r in runs.values()]
    log(f"[ckpt] mesh PPO: saves {saved} (the resume runs one iteration)")
    if saved[1] != 1:
        failures.append(f"ckpt: the mesh PPO rerun saved {saved[1]} times")
    for name, out in runs.items():
        got = _ppo_record(out, drop=drop)
        for k in ("scores", "stage3", "sha"):
            same = got[k] == want[k]
            log(f"[ckpt] mesh PPO {name}: {k} equal to the uninterrupted "
                f"plain run: {same}")
            if not same:
                failures.append(f"ckpt: mesh PPO {name} {k}: {got[k]} vs "
                                f"{want[k]}")
    state["ckpt"]["ppo_mesh_save"] = runs["uninterrupted"]["ckpt_stats"][-1]
    for out in runs.values():
        _free(out)
    shutil.rmtree(d, ignore_errors=True)


def _ckpt_lora(state, failures):
    """(5) LoRA at OPT-1.3B full width: the fp32 kernel-vs-plain step gate
    (4 layers), then ``launch.train --lora 8`` in bf16 with ``--ckpt``.
    Returns the export's path and the folded params."""
    import math
    import statistics

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import lora
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.training.steps import lm_loss_fn, value_and_grad

    cfg = get_config("opt-1.3b").replace(n_layers=4, compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(5)
    params = T.init_params(cfg, gen)
    ad = lora.init(params, 8, gen)
    for v in ad.values():                    # b != 0, so dA != 0
        v["b"].normal_(0.0, 0.02, generator=gen)
    batch = launch_train.to_device(
        next(launch_train.lm_data(cfg, 512, 0).sft_batches(2, 1)), "cuda")
    res = {}
    for uk in (True, False):
        c = cfg.replace(use_kernels=uk)
        (loss, _), g = value_and_grad(
            lambda a: lm_loss_fn(c, lora.merge(params, a), batch), ad)
        res[uk] = (float(loss), tree_leaves(g))
    (lk, gk), (lp, gp) = res[True], res[False]
    loss_rel = abs(lk - lp) / abs(lp)
    grad_rel = worst(float((a - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(gk, gp))
    log(f"[ckpt] LoRA rank 8, opt-1.3b full width, 4 layers, fp32, 2 x 512: "
        f"loss kernel {lk:.6f} plain {lp:.6f}, rel {loss_rel:.3g}; worst of "
        f"{len(gk)} adapter grads max|dgrad|/max|grad| {grad_rel:.3g} "
        f"(tol 1e-4)")
    if not worst([loss_rel, grad_rel]) <= 1e-4:
        failures.append(f"ckpt: LoRA kernel vs plain: loss {loss_rel:.3g}, "
                        f"grads {grad_rel:.3g}")
    del params, ad, res, gk, gp, g
    torch.cuda.empty_cache()

    path = CKPT_ROOT / "lora.npz"
    argv = ["--arch", "opt-1.3b", "--steps", "5", "--batch", "8", "--seq",
            "512", "--lora", "8", "--ckpt", str(path)]
    log(f"[ckpt] python -m repro_torch.launch.train {' '.join(argv)}")
    ops.reset_launch_counts()
    out = launch_train.main(argv)
    _launched("ckpt_lora", ops.launch_counts(), TRAIN_KERNELS, state,
              failures)
    med = statistics.median(out["step_ms"][1:])
    peak = out["peak_mem_bytes"] / 2**30
    full = state.get("train", {}).get("peak_gib")
    log(f"[ckpt] LoRA: {out['adapter_params']:,} adapter params; losses "
        + " ".join(f"{x:.4f}" for x in out["loss"])
        + f"; median step {med:.1f} ms; peak memory {peak:.2f} GiB (full "
        f"SFT in phase train: "
        + (f"{full:.2f} GiB" if full else "not run in this call") + ")")
    if not all(math.isfinite(x) for x in out["loss"]):
        failures.append(f"ckpt: LoRA losses not finite: {out['loss']}")
    folded = lora.fold(out["params"], out["state"].params)
    state.setdefault("ckpt", {})["lora"] = {
        "adapter_params": out["adapter_params"], "median_ms": med,
        "peak_gib": peak, "export_s": out["export_s"]}
    log(f"[ckpt] --ckpt export {path.stat().st_size / 1e9:.3f} GB in "
        f"{out['export_s']:.2f} s")
    _free(out)
    return path, folded


def _ckpt_serve(state, failures, path, folded) -> None:
    """(6) ``launch.serve --ckpt`` of the LoRA export, greedy, against
    serving the folded params from memory in the same process."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    argv = ["--arch", "opt-1.3b", "--requests", "8", "--ragged",
            "--prompt-len", "64", "--max-new", "32", "--batch", "8",
            "--temperature", "0"]
    log(f"[ckpt] python -m repro_torch.launch.serve {' '.join(argv)} "
        f"--ckpt {path}")
    ops.reset_launch_counts()
    disk = serve.main([*argv, "--ckpt", str(path)])
    _launched("ckpt_serve", ops.launch_counts(), SERVE_KERNELS, state,
              failures)
    mem = serve.main(argv, params=folded, warmup=False)
    same = disk["completions"] == mem["completions"]
    log(f"[ckpt] served export vs folded params in memory: greedy tokens "
        f"identical for {len(disk['requests'])} requests: {same}; load "
        f"{disk['load_s']:.2f} s")
    state["ckpt"]["serve_load_s"] = disk["load_s"]
    if not same:
        failures.append("ckpt: served export and in-memory params differ")
    del disk, mem
    torch.cuda.empty_cache()


def _ckpt_example(state, failures) -> None:
    """(7) ``examples/torch_rlhf_e2e.py`` at its default scale (25m) on
    the card, with ``tests/test_system.py``'s learning checks."""
    import importlib.util
    import math

    import numpy as np
    from repro_torch.kernels import ops
    spec = importlib.util.spec_from_file_location(
        "torch_rlhf_e2e", ROOT / "examples" / "torch_rlhf_e2e.py")
    ex = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ex)
    log("[ckpt] python examples/torch_rlhf_e2e.py (scale 25m)")
    ops.reset_launch_counts()
    out = ex.main(["--out", str(CKPT_ROOT / "rlhf")])
    _launched("ckpt_example", ops.launch_counts(), PPO_KERNELS, state,
              failures)
    sft, acc, sc = out["sft_loss"], out["rm_acc"], out["ppo_scores"]
    drop = float(np.mean(sft[:10]) - np.mean(sft[-10:]))
    acc10 = float(np.mean(acc[-10:]))
    log(f"[ckpt] example: SFT loss drop {drop:.3f} (need > 0.3), RM acc "
        f"over the last 10 {acc10:.3f} (need > 0.7), {len(sc)} PPO scores "
        f"finite: {all(math.isfinite(x) for x in sc)}; stage s "
        + ", ".join(f"{k} {v:.1f}" for k, v in out["timings"].items()))
    state["ckpt"]["example_s"] = dict(out["timings"])
    if not (drop > 0.3 and acc10 > 0.7
            and all(math.isfinite(x) for x in sc)):
        failures.append(f"ckpt: example learning checks: drop {drop:.3f}, "
                        f"acc {acc10:.3f}, scores {sc}")


def phase_ckpt(state):
    """Checkpoint/resume, LoRA and the torch example at full width: room
    first, the determinism witness, SFT and PPO kill-and-resume, LoRA with
    its fp32 gate, export -> serve, ``examples/torch_rlhf_e2e.py``.  Every
    directory it writes is under ``build/ckpt_phase`` and deleted at
    the end."""
    import shutil

    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []
    CKPT_ROOT.mkdir(parents=True, exist_ok=True)
    try:
        _ckpt_room()
        t0 = time.perf_counter()
        sft = _ckpt_sft(state, failures)
        tm = time.perf_counter()
        _ckpt_mesh(state, failures, sft)
        t1 = time.perf_counter()
        ref = _ckpt_ppo(state, failures)
        tp = time.perf_counter()
        _ckpt_ppo_mesh(state, failures, ref)
        t2 = time.perf_counter()
        path, folded = _ckpt_lora(state, failures)
        _ckpt_serve(state, failures, path, folded)
        del folded
        torch.cuda.empty_cache()
        t3 = time.perf_counter()
        _ckpt_example(state, failures)
        log(f"[ckpt] legs: SFT {tm - t0:.1f}s, mesh SFT {t1 - tm:.1f}s, "
            f"PPO {tp - t1:.1f}s, mesh PPO {t2 - tp:.1f}s, LoRA + "
            f"serve {t3 - t2:.1f}s, example {time.perf_counter() - t3:.1f}s")
    finally:
        shutil.rmtree(CKPT_ROOT, ignore_errors=True)
    if failures:
        raise AssertionError("ckpt: " + "; ".join(failures))


def phase_profile(state):
    """``torch.profiler`` over the decode kernels, after every timed
    phase: a profiler session leaves tracing hooks behind it, which slowed
    the OPT-1.3B decode step's CUDA-graph replay by ~0.4 ms on the H100.
    (a) Each decode row of phase ``kernels``: the CUDA kernels one call
    runs, which must be one split kernel and then the combine exactly when
    the host's plan splits the rows.  A session whose records hold no
    split kernel leaves the row unmeasured (logged), not failed.
    (b) The OPT-1.3B decode steps of phase ``serve``, dense and
    paged, bf16 and int8 KV: the decode kernels' device time inside one
    replay of the step's CUDA graph, per call and against the bound of the
    step's own rows."""
    import torch
    failures = []
    rows = state.get("kernel_rows", {})
    for name, what, main, plan, call in state.pop("decode_calls", []):
        kernels = cuda_kernels_of(call)
        n_split = sum("decode::split_kernel" in n for n in kernels)
        n_comb = sum("decode::combine_kernel" in n for n in kernels)
        if not n_split:                 # a measurement gap, not a fault
            log(f"[profile] {name} {what}: the profiler saw no split kernel "
                f"({kernels}); the CUDA kernels per call are not measured")
            continue
        ok = (n_split == 1 and n_comb == (plan > 1)
              and len(kernels) == 1 + n_comb)
        log(f"[profile] {name} {what}: one call ran {len(kernels)} CUDA "
            f"kernel(s) (the host's plan: {plan} split(s)): "
            + "; ".join(n.split("(")[0] for n in kernels)
            + f" {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name} {what}: one call ran {kernels}")
        if main and name in rows:
            rows[name]["kernels_per_call"] = len(kernels)
    for paged in (False, True):
        for quant in (False, True):
            key = _step_key(paged, quant)
            if key not in state:
                continue
            case = _opt_step_case(paged, quant)
            state[key]["decode_in_step"] = _decode_in_step(
                case["step"], state[key]["decode_calls"],
                case["decode_bytes"],
                f"opt-1.3b {'paged ' if paged else ''}decode step, "
                f"{'int8' if quant else 'bf16'} KV")
            del case
            torch.cuda.empty_cache()
    if failures:
        raise AssertionError("profile checks failed:\n"
                             + "\n".join(failures))


# --------------------------------------------------------------------- #
# the head-dim-128 GQA family (qwen3-8b, yi-9b, llama3.2-3b)
# --------------------------------------------------------------------- #
GQA128_ARCHS = ("qwen3-8b", "yi-9b", "llama3.2-3b")


def _peak_gib():
    import torch
    return torch.cuda.max_memory_allocated() / 2**30


def _row128(state, failures, name, label, dname, err, limit, k_ms=None,
            p_ms=None, lib_ms=None, bnd=None, cold_ms=None, extra=None,
            key="d128", tag="gqa128"):
    """One kernel row of a later slice (D = 128 by default): logged, kept
    for the ``kernels`` line (under the kernel's ``key``: ``d128``,
    ``d192``, ``cross``) and failed when ``err`` passes ``limit``; an fp32
    row is checked, not timed."""
    ok = err <= limit
    if not ok:
        failures.append(f"{name} {label} {dname}: err {err:.3g} > {limit}")
    row = {"shape": label, "dtype": dname, "max_err": err, **(extra or {})}
    timed = ""
    if k_ms is not None:
        row.update(ms=k_ms, cold_ms=cold_ms, plain_ms=p_ms,
                   library_ms=lib_ms, bound_ms=bnd[0], bound_by=bnd[1])
        timed = (f" kernel_ms={k_ms:.4f} cold_ms={cold_ms:.4f} "
                 f"plain_ms={p_ms:.4f} library_ms="
                 f"{'null' if lib_ms is None else f'{lib_ms:.4f}'} "
                 f"bound_ms={bnd[0]:.4f} ({bnd[1]})")
    state.setdefault(key, {}).setdefault(name, []).append(row)
    log(f"[{tag}] {name} {label} {dname} err={err:.3g} (tol {limit})"
        + timed + "".join(f" {k}={v:.4f}" if isinstance(v, float) else
                          f" {k}={v}" for k, v in (extra or {}).items())
        + f" {'ok' if ok else 'FAIL'}")


def _cold(fn_of, inputs, nbytes):
    """:func:`time_ms_cold` of ``fn_of(*copy)`` over copies of
    ``inputs``."""
    copies = [tuple(t.clone() for t in inputs)
              for _ in range(cold_copies(nbytes))]
    ms = time_ms_cold([lambda c=c: fn_of(*c) for c in copies])
    del copies
    return ms


def _gqa128_flash_rows(state, failures):
    """The flash forward (with the LSE) at the prefills of the four GQA
    groups (B 1, L 256; qwen3-8b's KV 8, G 4 first) and the llama3.2-3b
    SFT shape (B 8, H 24, KV 8, L 512), the backward at that SFT shape;
    fp32 (TF32 off, 1e-4) and bf16 (2e-2 of max |plain|) against the plain
    versions; bf16 timed warm and cold beside the bound and SDPA."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    gen = torch.Generator(device="cuda").manual_seed(128)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    tol = {"fp32": 1e-4, "bf16": 2e-2}
    D = 128
    for (B, KV, G, L, model) in ((1, 8, 4, 256, "qwen3-8b prefill"),
                                 (1, 4, 8, 256, "yi-9b prefill"),
                                 (1, 8, 3, 256, "llama3.2-3b prefill"),
                                 (1, 8, 5, 256, "llama4-scout prefill"),
                                 (8, 8, 3, 512, "llama3.2-3b sft")):
        label = f"{model} B={B} KV={KV} G={G} L={L}"
        for dname, dt in dtypes.items():
            qm = _case_inputs(gen, (B, L, KV * G, D), dt)
            km = _case_inputs(gen, (B, L, KV, D), dt)
            vm = _case_inputs(gen, (B, L, KV, D), dt)
            q5 = qm.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
            k4, v4 = km.transpose(1, 2), vm.transpose(1, 2)
            lse = torch.empty((B, KV, G, L), device="cuda")
            out = flash_attention_fwd(q5, k4, v4, causal=True, lse=lse)
            r = ref.flash_attention_ref(q5, k4, v4, causal=True)
            lse_ref = ref.flash_attention_lse_ref(q5, k4, causal=True)
            torch.cuda.synchronize()
            scale = float(r.float().abs().max()) if dname == "bf16" else 1.0
            err = _err(out, r, rel=False) / scale
            lse_err = _err(lse, lse_ref, rel=False)
            if lse_err > (1e-4 if dname == "fp32" else 1e-3):
                failures.append(f"flash LSE D=128 {label} {dname}: "
                                f"{lse_err:.3g}")
            if dname == "fp32":
                _row128(state, failures, "flash_attention_fwd", label, dname,
                        err, tol[dname], extra={"lse_err": lse_err})
                continue
            pairs = causal_pairs(L, L, None)
            ops = 4 * B * KV * G * pairs * D
            nbytes = (2 * B * KV * G * L * D + 2 * B * KV * L * D) * 2
            call = lambda q5, k4, v4: flash_attention_fwd(q5, k4, v4,
                                                          causal=True)
            qs, ks, vs = (t.transpose(1, 2) for t in (qm, km, vm))
            k_ms = time_ms(lambda: call(q5, k4, v4))
            _row128(state, failures, "flash_attention_fwd", label, dname,
                    err, tol[dname], k_ms,
                    time_ms(lambda: ref.flash_attention_ref(q5, k4, v4,
                                                            causal=True)),
                    time_ms(lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=True, enable_gqa=True)),
                    bound(nbytes, ops, "bf16"),
                    cold_ms=_cold(call, (q5, k4, v4), nbytes),
                    extra={"lse_err": lse_err,
                           "tflops": ops / (k_ms * 1e-3) / 1e12})
        if B == 1:
            continue
        # the backward at the SFT shape
        for dname, dt in dtypes.items():
            qm, dom = (_case_inputs(gen, (B, L, KV * G, D), dt)
                       for _ in range(2))
            km = _case_inputs(gen, (B, L, KV, D), dt)
            vm = _case_inputs(gen, (B, L, KV, D), dt)
            q5, do5 = (t.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
                       for t in (qm, dom))
            k4, v4 = km.transpose(1, 2), vm.transpose(1, 2)
            o5 = ref.flash_attention_ref(q5, k4, v4, causal=True)
            lse = ref.flash_attention_lse_ref(q5, k4, causal=True)
            delta = (do5.float() * o5.float()).sum(-1).contiguous()
            got = flash_attention_bwd(q5, k4, v4, do5, lse, delta,
                                      causal=True)
            want = ref.flash_attention_bwd_ref(q5, k4, v4, do5, lse, delta,
                                               causal=True)
            torch.cuda.synchronize()
            rel = worst(float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp(min=1e-12))
                        for a, b in zip(got, want))
            del got, want
            if dname == "fp32":
                _row128(state, failures, "flash_attention_bwd", label, dname,
                        rel, tol[dname])
                continue
            pairs = causal_pairs(L, L, None)
            ops = 10 * D * B * KV * G * pairs
            nbytes = (3 * B * KV * G * L * D * 2 + 4 * B * KV * L * D * 2
                      + 2 * B * KV * G * L * 4)
            call = lambda *a: flash_attention_bwd(*a, causal=True)
            args = (q5, k4, v4, do5, lse, delta)
            k_ms = time_ms(lambda: call(*args), inner=5, repeats=5)
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (qm, km, vm))
            dos = dom.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=True, enable_gqa=True)
            both = lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
            lib = (time_ms(both, inner=5, repeats=5)
                   - time_ms(sdpa, inner=5, repeats=5))
            _row128(state, failures, "flash_attention_bwd", label, dname,
                    rel, tol[dname], k_ms,
                    time_ms(lambda: ref.flash_attention_bwd_ref(
                        *args, causal=True), inner=3, repeats=5), lib,
                    bound(nbytes, ops, "bf16"),
                    cold_ms=_cold(call, args, nbytes),
                    extra={"tflops": ops / (k_ms * 1e-3) / 1e12})


def _gqa128_decode_rows(state, failures):
    """The four decode kernels at D = 128 (:func:`_decode_rows`) for
    qwen3-8b (KV 8, G 4), yi-9b (KV 4, G 8) and llama3.2-3b (KV 8, G 3:
    the G = 4 instantiation with a quarter of its query lanes idle)."""
    _decode_rows(state, failures, 128, ((8, 4, "qwen3-8b"),
                                        (4, 8, "yi-9b"),
                                        (8, 3, "llama3.2-3b")),
                 key="d128", tag="gqa128", seed=129)


def _decode_rows(state, failures, D, cases, key, tag, seed):
    """The four decode kernels at head dim ``D``, B 16, S 512 (ragged,
    1..512 rows; the paged ones over a shuffled 513-block pool of 16-row
    blocks) for each ``(KV, G, model)`` of ``cases``, fp32 (1e-4) and bf16
    (2e-2), both of max |plain|; bf16 timed warm and cold beside the bound
    and SDPA (dense bf16 rows) or a yardstick (dequantize or gather, then
    SDPA).  Rows go to ``state[key]``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_quant_fwd)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_fwd, paged_decode_attention_quant_fwd)
    from repro_torch.models.modules import _kv_quant

    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    tol = {"fp32": 1e-4, "bf16": 2e-2}
    B, S, bs, nb = 16, 512, 16, 32
    row = lambda *a, **kw: _row128(state, failures, *a, key=key, tag=tag,
                                   **kw)
    for (KV, G, model) in cases:
        gm = 1 << (G - 1).bit_length()             # the instantiation's G
        for quant in (False, True):
            for dname, dt in dtypes.items():
                # the dense arena, read in place
                q = _case_inputs(gen, (B, KV * G, D), dt)
                kf = _case_inputs(gen, (B, S, KV, D), dt)
                vf = _case_inputs(gen, (B, S, KV, D), dt)
                valid, _ = _decode_valid(gen, B, S, 1)
                q4 = q.unflatten(1, (KV, G))
                eb = q.element_size()
                if quant:
                    (ka, ks), (va, vs) = _kv_quant(kf), _kv_quant(vf)
                    args = (ka.transpose(1, 2), va.transpose(1, 2),
                            ks.transpose(1, 2), vs.transpose(1, 2))
                    name = "decode_attention_quant_fwd"
                    kern = lambda *a: decode_attention_quant_fwd(q4, *a,
                                                                 valid)
                    plain = lambda: ref.decode_attention_quant_ref(
                        q4, *args, valid)
                    row_bytes = 2 * D + 8
                else:
                    args = (kf.transpose(1, 2), vf.transpose(1, 2))
                    name = "decode_attention_fwd"
                    kern = lambda *a: decode_attention_fwd(q4, *a, valid)
                    plain = lambda: ref.decode_attention_ref(q4, *args,
                                                             valid)
                    row_bytes = 2 * D * eb
                out, r = kern(*args), plain()
                torch.cuda.synchronize()
                err = _err(out, r, rel=False) / float(r.float().abs().max())
                label = f"{model} B={B} KV={KV} G={G} (GM {gm}) S={S} ragged"
                if dname == "fp32":
                    row(name, label, dname, err,
                        tol[dname])
                else:
                    need = int(valid.sum())
                    nbytes = (2 * B * KV * G * D * eb + B * S
                              + need * KV * row_bytes)
                    qs = q.unflatten(1, (KV * G, 1))
                    mask = valid[:, None, None, :]

                    def lib_fn():
                        kd, vd = args[0], args[1]
                        if quant:
                            kd = (kd.float() * args[2][..., None]).to(dt)
                            vd = (vd.float() * args[3][..., None]).to(dt)
                        return F.scaled_dot_product_attention(
                            qs, kd, vd, attn_mask=mask, enable_gqa=True)
                    lib = time_ms(lib_fn)
                    row(name, label, dname, err,
                        tol[dname], time_ms(lambda: kern(*args)),
                        time_ms(plain), None if quant else lib,
                        bound(nbytes, 4 * KV * G * D * need, "bf16"),
                        cold_ms=_cold(kern, args, nbytes),
                        extra={"yardstick_ms": lib} if quant else None)
                del q, kf, vf, args
                # the paged pool through shuffled block tables
                name = ("paged_decode_attention_quant_fwd" if quant
                        else "paged_decode_attention_fwd")
                qp, kp, vp, sc, tables, lens = _paged_case(
                    gen, B, KV, G, D, bs, nb, 1, dt, quant)
                pargs = (kp, vp, *sc)
                run = (paged_decode_attention_quant_fwd if quant
                       else paged_decode_attention_fwd)
                kern = lambda *a: run(qp, *a, tables, lens)
                plain = ((lambda: ref.paged_decode_attention_quant_ref(
                    qp, *pargs, tables, lens)) if quant else
                    (lambda: ref.paged_decode_attention_ref(
                        qp, *pargs, tables, lens)))
                out, r = kern(*pargs), plain()
                torch.cuda.synchronize()
                err = _err(out, r, rel=False) / float(r.float().abs().max())
                label = (f"{model} B={B} KV={KV} G={G} (GM {gm}) bs={bs} "
                         f"nb={nb} lens 1-{nb * bs}")
                if dname == "fp32":
                    row(name, label, dname, err,
                        tol[dname])
                    continue
                need = int(lens.sum())
                nbytes = (2 * B * KV * G * D * eb + 4 * B * (nb + 1)
                          + need * KV * row_bytes)
                valid_p = (torch.arange(nb * bs, device="cuda")[None]
                           < lens[:, None])
                qs = qp.flatten(1, 2)[:, :, None]
                mask = valid_p[:, None, None, :]

                def gather_sdpa():
                    kg = ref.gather_blocks(kp, tables)
                    vg = ref.gather_blocks(vp, tables)
                    if quant:
                        kg = (kg.float() * ref.gather_blocks(
                            sc[0], tables)[..., None]).to(dt)
                        vg = (vg.float() * ref.gather_blocks(
                            sc[1], tables)[..., None]).to(dt)
                    return F.scaled_dot_product_attention(
                        qs, kg.transpose(1, 2), vg.transpose(1, 2),
                        attn_mask=mask, enable_gqa=True)
                row(name, label, dname, err,
                    tol[dname], time_ms(lambda: kern(*pargs)),
                    time_ms(plain), None,
                    bound(nbytes, 4 * KV * G * D * need, "bf16"),
                    cold_ms=_cold(kern, pargs, nbytes),
                    extra={"yardstick_ms": time_ms(gather_sdpa)})
                del qp, kp, vp, sc, pargs
        if G == 3:
            log(f"[{tag}] {model}: G = 3 runs the decode core's G = 4 "
                f"instantiation, a quarter of its query lanes idle")


def _gqa128_rmsnorm_rows(state, failures):
    """RMSNorm at the new widths (llama3.2-3b 3072, qwen3-8b and yi-9b
    4096, llama4-scout 5120), a decode step's 16 rows and an SFT step's
    4,096; fp32 (1e-4) and bf16 (1e-2 relative); bf16 timed warm and cold
    beside the bound and ``F.rms_norm``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    gen = torch.Generator(device="cuda").manual_seed(130)
    for D in (3072, 4096, 5120):
        for R in (16, 4096):
            for dname, dt in (("fp32", torch.float32),
                              ("bf16", torch.bfloat16)):
                x = _case_inputs(gen, (R, D), dt)
                w = (1.0 + 0.1 * _case_inputs(gen, (D,), torch.float32)
                     ).to(dt)
                out = rmsnorm_fwd(x, w, eps=1e-5)
                r = ref.rmsnorm_ref(x, w, 1e-5)
                torch.cuda.synchronize()
                err = _err(out, r, rel=dname == "bf16")
                lim = 1e-4 if dname == "fp32" else 1e-2
                if dname == "fp32":
                    _row128(state, failures, "rmsnorm", f"R={R} D={D}",
                            dname, err, lim)
                    continue
                nbytes = 2 * R * D * 2 + D * 2
                call = lambda x, w: rmsnorm_fwd(x, w, eps=1e-5)
                _row128(state, failures, "rmsnorm", f"R={R} D={D}", dname,
                        err, lim, time_ms(lambda: call(x, w)),
                        time_ms(lambda: ref.rmsnorm_ref(x, w, 1e-5)),
                        time_ms(lambda: F.rms_norm(x, (D,), w, 1e-5)),
                        bound(nbytes, 4 * R * D, "fp32"),
                        cold_ms=_cold(call, (x, w), nbytes))


def _teacher_forced(cfg, params, tokens, Lp, n_dec):
    """Logits of a prefill of ``tokens[:, :Lp]`` and ``n_dec`` decode steps
    fed ``tokens``' next tokens, on the kernel path and the plain path."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step, prefill
    logits = {}
    for use_kernels in (True, False):
        c = cfg.replace(use_kernels=use_kernels)
        cache = T.init_cache(c, 1, Lp + n_dec, device="cuda")
        lg, cache = prefill(c, params, tokens[:, :Lp], cache)
        steps = [lg]
        for t in range(n_dec):
            pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
            lg, cache = decode_step(c, params, tokens[:, Lp + t], cache, pos)
            steps.append(lg)
        logits[use_kernels] = torch.cat(steps).float()
        del cache
    return logits[True], logits[False]


def _gqa128_parity(state, failures):
    """Each dense model at full width and depth in fp32 (TF32 off), random
    weights: prefill 256 + 32 decode steps teacher-forced through the
    kernel path and the plain path, max |dlogits| / max |logits| <= 1e-4."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    Lp, n_dec = 256, 32
    for arch in GQA128_ARCHS:
        cfg = get_config(arch).replace(compute_dtype="float32")
        gen = torch.Generator(device="cuda").manual_seed(0)
        t0 = time.perf_counter()
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, gen)
        tokens = torch.randint(0, cfg.vocab_size, (1, Lp + n_dec),
                               generator=gen, device="cuda")
        a, b = _teacher_forced(cfg, params, tokens, Lp, n_dec)
        torch.cuda.synchronize()
        rel = float((a - b).abs().max() / b.abs().max())
        agree = float((a.argmax(-1) == b.argmax(-1)).float().mean())
        log(f"[gqa128] parity {arch} fp32 ({cfg.n_params() / 1e9:.2f} B), "
            f"{Lp} prefill + {n_dec} decode steps (teacher-forced): "
            f"max|dlogits|/max|logits| = {rel:.3g} (tol 1e-4), argmax "
            f"agreement {agree:.3f}, {time.perf_counter() - t0:.1f}s, peak "
            f"{_peak_gib():.2f} GiB")
        state.setdefault("gqa128", {})[f"parity_{arch}"] = rel
        if not (torch.isfinite(a).all() and rel <= 1e-4):
            failures.append(f"parity {arch}: rel {rel:.3g}")
        del params, a, b
        torch.cuda.empty_cache()


# 8 greedy requests of the serve workload's prompts, up to 64 new tokens:
# the paged == dense checks of the new models
GREEDY8 = ["--requests", "8", "--max-new", "64", "--temperature", "0"]


def _serve_peak(argv, tag, must, state, warmup=True, cfg=None):
    """:func:`_serve_run` with the run's peak memory.  The last run's
    weights are collected first: the launcher's engine and core refer to
    each other, so its tree lives until the cycle collector runs."""
    import gc

    import torch
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res = _serve_run(argv, tag, must, state, warmup=warmup, cfg=cfg)
    peak = _peak_gib()
    log(f"[serve] {tag}: peak memory {peak:.2f} GiB "
        f"(torch.cuda.max_memory_allocated)")
    state.setdefault("serve_new", {})[tag] = {"tok_s": res["tok_s"],
                                              "peak_gib": peak}
    return res


def _gqa128_serve(state, failures):
    """``launch.serve`` at full width and depth, weights in bf16 only:
    yi-9b greedy paged == dense on 8 requests of up to 64 new tokens (its
    run of the whole workload on the paged pool, whose gates these two runs
    hold too, went to make room for phases ``mla`` and ``xattn``; qwen3-8b's
    run of the workload on the dense arena, whose D = 128 launch set the
    yi-9b runs hold, for phase ``serve_mesh``: yi-9b's first run now
    includes its first calls); llama3.2-3b greedy on those 8 requests on
    the dense and the paged int8 KV."""
    argv = lambda arch: workload(arch, REPEAT_NEW)
    d = _serve_peak(argv("yi-9b") + GREEDY8, "serve_yi_9b_greedy_dense",
                    SERVE_KERNELS, state, warmup=False)
    p = _serve_peak(argv("yi-9b") + GREEDY8 + PAGED,
                    "serve_yi_9b_greedy_paged", SERVE_PAGED_KERNELS, state,
                    warmup=False)
    same = d["completions"] == p["completions"]
    log(f"[gqa128] yi-9b greedy streams (8 requests): paged == dense {same}")
    if not same:
        failures.append("yi-9b greedy paged != dense")
    g = argv("llama3.2-3b") + GREEDY8 + ["--kv-quant"]
    d = _serve_peak(g, "serve_llama3_2_3b_int8", SERVE_INT8_KERNELS, state,
                    warmup=False)
    p = _serve_peak(g + PAGED, "serve_llama3_2_3b_paged_int8",
                    SERVE_PAGED_INT8_KERNELS, state, warmup=False)
    log(f"[gqa128] llama3.2-3b int8 greedy streams (8 requests): paged == "
        f"dense {d['completions'] == p['completions']} (reported, not "
        f"gated)")


def _lm_step_gate(tag, cfg, batch, failures):
    """One fp32 (TF32 off) LM step of ``cfg`` through the kernel path and
    the plain path on the same params: loss and aux to 1e-5 relative,
    every grad leaf to 1e-4 of its max; the kernel path must launch the
    three training kernels."""
    import gc
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.training.steps import lm_value_and_grad

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(3))
    res = {}
    for uk in (True, False):
        ops.reset_launch_counts()
        t0 = time.perf_counter()
        (loss, met), grads = lm_value_and_grad(cfg.replace(use_kernels=uk),
                                               params, batch)
        torch.cuda.synchronize()
        # the kernel path's grads wait in host memory: two fp32 grad trees
        # and the params would not fit the card at llama4-scout's width
        leaves = [g.cpu() if uk else g for g in tree_leaves(grads)]
        res[uk] = (float(loss), float(met["aux_loss"]), leaves,
                   ops.launch_counts(), time.perf_counter() - t0)
        del grads, leaves
    (lk, ak, gk, ck, tk), (lp, ap, gp, _, tp) = res[True], res[False]
    loss_rel = abs(lk - lp) / abs(lp)
    aux_rel = abs(ak - ap) / abs(ap) if ap else abs(ak)
    grad_rel = worst(float((a.cuda() - b).abs().max() / b.abs().max().clamp(
        min=1e-30)) for a, b in zip(gk, gp))
    B, L = batch["tokens"].shape
    log(f"[{tag}] {cfg.name} fp32 LM step ({cfg.n_layers} layers, "
        f"{cfg.n_params() / 1e9:.2f} B, batch {B} x {L}), kernel vs plain: "
        f"loss {lk:.6f} vs {lp:.6f} ({tk:.1f}s / {tp:.1f}s), |dloss|/|loss|"
        f" = {loss_rel:.3g} (tol 1e-5), aux {ak:.6g} vs {ap:.6g} (rel "
        f"{aux_rel:.3g}, tol 1e-5), max over {len(gk)} grad leaves of "
        f"max|dgrad|/max|grad| = {grad_rel:.3g} (tol 1e-4); launches {ck}; "
        f"peak {_peak_gib():.2f} GiB")
    if not (math.isfinite(lk) and loss_rel <= 1e-5 and aux_rel <= 1e-5
            and grad_rel <= 1e-4):
        failures.append(f"{tag} LM step kernel vs plain: loss {loss_rel:.3g}"
                        f" aux {aux_rel:.3g} grads {grad_rel:.3g}")
    missing = [k for k in TRAIN_KERNELS if ck[k] == 0]
    if missing:
        failures.append(f"{tag} LM step: kernels never launched {missing}")
    del params, res, gk, gp
    torch.cuda.empty_cache()


def _sft_run(tag, argv, state, failures, falling=True, cfg=None):
    """``launch.train.main(argv)`` with the launch counts set to 0 just
    before and read just after: every loss (and aux) finite, the last loss
    below the first (unless ``falling`` is off), the training kernels
    launched.  ``cfg`` in place of ``--arch``'s (a cut depth).  A run that
    does not fit the card raises: the phase fails."""
    import gc
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train

    log(f"[{tag}] python -m repro_torch.launch.train {' '.join(argv)}"
        f"{'' if cfg is None else f' (n_layers {cfg.n_layers})'}")
    gc.collect()
    torch.cuda.empty_cache()
    ops.reset_launch_counts()
    out = launch_train.main(argv, cfg=cfg)
    counts = ops.launch_counts()
    state.setdefault("launches", {})[tag] = counts
    losses, auxes = out["loss"], out["aux_loss"]
    steady = out["step_ms"][1:] or out["step_ms"]
    summary = {"argv": " ".join(argv), "loss": losses, "aux": auxes,
               "step_ms": statistics.median(steady), "tok_s": out["tok_s"],
               "peak_gib": out["peak_mem_bytes"] / 2**30,
               "adapter_params": out["adapter_params"]}
    log(f"[{tag}] losses {' '.join(f'{x:.4f}' for x in losses)}; aux "
        f"{' '.join(f'{x:.4g}' for x in auxes)}; step ms "
        f"{' '.join(f'{x:.1f}' for x in out['step_ms'])}, median after the "
        f"first {summary['step_ms']:.1f} ms, {out['tok_s']:.1f} tok/s, peak "
        f"{summary['peak_gib']:.2f} GiB; launches per step "
        f"{out['launches'][-1]}")
    if not (all(math.isfinite(x) for x in losses + auxes)
            and (losses[-1] < losses[0] or not falling)):
        failures.append(f"{tag}: losses {losses}, aux {auxes}")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        failures.append(f"{tag}: kernels never launched {missing}")
    state[tag] = summary
    return out


def _gqa128_train(state, failures):
    """``launch.train`` SFT at llama3.2-3b, full size (5 steps of 8 x 512,
    bf16 on fp32 masters, remat; the phase fails if 80 GB do not hold it),
    and the qwen3-8b fp32 LM step at full width cut to 2 layers, kernel vs
    plain (the qk-norm's grads through the flash backward)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    argv = ["--arch", "llama3.2-3b", "--steps", "5", "--batch", "8",
            "--seq", "512"]
    out = _sft_run("train_llama3_2_3b", argv, state, failures)
    del out
    torch.cuda.empty_cache()
    cfg = get_config("qwen3-8b").replace(n_layers=2, compute_dtype="float32")
    batch = launch_train.to_device(
        next(launch_train.lm_data(cfg, 512, 0).sft_batches(2, 1)), "cuda")
    _lm_step_gate("gqa128", cfg, batch, failures)


def _gqa128_rlhf(state, failures):
    """``RLHFPipeline`` with llama3.2-3b actor and critic at full width cut
    to 4 layers: 2 SFT and 2 RM steps, 1 PPO iteration of 8 x 256 prompts
    + 64 new on int8 KV; phase ``rlhf``'s checks."""
    import math

    import torch
    from repro_torch.configs import get_config
    from repro_torch.core import (PPOConfig, RLHFEngine, RLHFPipeline,
                                  StageConfig)
    from repro_torch.kernels import ops
    from repro_torch.launch.train import lm_data

    actor = get_config("llama3.2-3b").replace(n_layers=4)
    bl = lm_data(actor, 512, 0)
    stages = StageConfig(sft_steps=2, sft_batch=8, rm_steps=2, rm_batch=8,
                         ppo_steps=1, ppo_batch=8)
    ppo = PPOConfig(max_new_tokens=64, temperature=1.0, ptx_coef=0.05,
                    use_ema=True, kv_quant=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = RLHFEngine(actor, actor,
                     torch.Generator(device="cuda").manual_seed(0))
    pipe = RLHFPipeline(eng, bl, stages, ppo)
    ops.reset_launch_counts()
    pipe.run_sft()
    pipe.run_reward()
    frozen = {"ref": _checksum(eng.ref_params),
              "reward": _checksum(eng.reward_params)}
    pipe.run_ppo()
    total = ops.launch_counts()
    state.setdefault("launches", {})["rlhf_llama3_2_3b"] = total
    trainer = pipe.trainer
    m = pipe.log["stage3"][0]
    after = {"ref": _checksum(trainer.ref_params),
             "reward": _checksum(trainer.reward_params)}
    nums = ([v for v in m.values() if isinstance(v, float)]
            + list(pipe.log["stage1"]) + list(pipe.log["stage2"]))
    log(f"[gqa128] rlhf llama3.2-3b cut to 4 layers "
        f"({actor.n_params() / 1e9:.2f} B, actor and critic): SFT losses "
        f"{pipe.log['stage1']}, RM losses {pipe.log['stage2']}, PPO gen "
        f"{m['gen_s']:.2f}s = {m['gen_tok_s']:.1f} tok/s, ratio_mean "
        f"{m['ratio_mean']:.6f}, approx_kl {m['approx_kl']:.3g}, reward "
        f"{m['reward_score']:.4f}, actor_loss {m['actor_loss']:.4f}, v_loss "
        f"{m['v_loss']:.4f}; {time.perf_counter() - t0:.1f}s, peak "
        f"{_peak_gib():.2f} GiB; launches {total}; frozen checksums "
        f"{frozen} -> {after}")
    state.setdefault("gqa128", {})["rlhf"] = {
        k: v for k, v in m.items() if isinstance(v, (int, float))}
    if not all(math.isfinite(v) for v in nums):
        failures.append("rlhf llama3.2-3b: non-finite metric")
    if abs(m["ratio_mean"] - 1.0) > 1e-3:
        failures.append(f"rlhf llama3.2-3b: ratio_mean {m['ratio_mean']}")
    if after != frozen:
        failures.append("rlhf llama3.2-3b: a frozen model moved")
    if total["decode_attention_fwd"] or any(
            total[k] == 0 for k in RLHF_KERNELS):
        failures.append(f"rlhf llama3.2-3b: launches {total}")
    del trainer, pipe, eng
    torch.cuda.empty_cache()


def phase_gqa128(state):
    """The head-dim-128 GQA family on the card: the D = 128 kernel rows,
    fp32 parity of the three dense models at full size, their serve runs,
    the llama3.2-3b SFT, the qwen3-8b fp32 step gate and the llama3.2-3b
    RLHF pipeline."""
    import gc

    import torch
    failures = []
    gc.collect()              # what earlier phases left in cycles
    torch.cuda.empty_cache()
    ptx = state.get("ptxas_d128", {})
    spills = {fn: v for fn, v in ptx.items() if v[1]}
    log(f"[gqa128] ptxas at D = 128 (phase build): {len(ptx)} "
        f"instantiations, spilling: {spills or 'none'}")
    for part in (_gqa128_flash_rows, _gqa128_decode_rows,
                 _gqa128_rmsnorm_rows, _gqa128_parity, _gqa128_serve,
                 _gqa128_train, _gqa128_rlhf):
        t0 = time.perf_counter()
        part(state, failures)
        gc.collect()          # engines and cores refer to each other
        torch.cuda.empty_cache()
        log(f"[gqa128] {part.__name__}: {time.perf_counter() - t0:.1f}s")
    if failures:
        raise AssertionError("gqa128 checks failed:\n"
                             + "\n".join(failures))


# --------------------------------------------------------------------- #
# the MoE layer at llama4-scout-17b-a16e
# --------------------------------------------------------------------- #
MOE_ARCH = "llama4-scout-17b-a16e"
MOE_SERVE_LAYERS = 12        # 28.5 B parameters, 57 GB in bf16


class _DropMeter:
    """Wraps ``modules.moe_route`` (the dispatch rule ``moe_apply`` calls)
    to count the routed entries each call keeps and drops, by the call's
    row count; a call is one layer of one forward."""

    def __init__(self):
        from repro_torch.models import modules as M
        self.M, self.real, self.calls = M, M.moe_route, []

    def __enter__(self):
        def route(cfg, probs):
            out = self.real(cfg, probs)
            pos, cap = out[2], out[3]
            self.calls.append((probs.shape[0], pos, cap))
            return out
        self.M.moe_route = route
        return self

    def __exit__(self, *exc):
        self.M.moe_route = self.real

    def shares(self, decode_rows):
        """(dropped share over decode calls (``decode_rows`` rows), over
        admissions (every other call), calls of each, (rows, cap) seen)."""
        dec, adm, caps = [0, 0, 0], [0, 0, 0], set()
        for T_, pos, cap in self.calls:
            acc = dec if T_ == decode_rows else adm
            acc[0] += int((pos >= cap).sum())
            acc[1] += pos.numel()
            acc[2] += 1
            caps.add((T_, cap))
        share = lambda a: a[0] / a[1] if a[1] else float("nan")
        return share(dec), share(adm), dec[2], adm[2], sorted(caps)


def _moe_serve(state, failures):
    """llama4-scout at full width cut to 12 layers, bf16 weights only:
    the 32-request workload dense bf16 with the routing's drop share per
    decode step and per admission (R13), greedy paged == dense on 8 equal
    requests filling 8 slots (and counted on 8 ragged ones in 16 slots),
    and prefix cache on vs off on the shared-system-prompt mix (16
    requests; a share of equal streams, not gated: R13)."""
    import gc

    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.engine import GenerationEngine

    cut = get_config(MOE_ARCH).replace(n_layers=MOE_SERVE_LAYERS)
    argv = workload(MOE_ARCH, REPEAT_NEW)
    with _DropMeter() as meter:
        res = _serve_peak(argv, "serve_llama4_scout", SERVE_KERNELS, state,
                          cfg=cut)
    # the warm-up's calls and the measured run's
    dec, adm, n_dec, n_adm, caps = meter.shares(16)
    log(f"[moe] routed entries dropped (R13; cap = ceil(T K / E 1.25)): "
        f"{dec:.4f} of each decode step's ({n_dec} layer calls of 16 rows) "
        f"and {adm:.4f} of each admission's ({n_adm} layer calls); (rows, "
        f"cap) seen {caps[:8]}{' ...' if len(caps) > 8 else ''}")
    state.setdefault("moe", {}).update(
        drop_decode=dec, drop_admission=adm, tok_s=res["tok_s"])
    # paged == dense where every slot is live at every step: 8 requests of
    # 256 + 64 tokens in 8 slots, admitted together, finishing together.
    # An idle or finished slot decodes rows that differ by layout (its own
    # arena rows against the trash block), and they share the capacity
    # with the live rows (R13): with ragged requests in 16 slots the
    # streams are counted, not gated
    full = ["--arch", MOE_ARCH, "--requests", "8", "--prompt-len", "256",
            "--max-new", "64", "--batch", "8", "--chunk", "8",
            "--temperature", "0"]
    d = _serve_peak(full, "serve_llama4_greedy_dense", SERVE_KERNELS, state,
                    warmup=False, cfg=cut)
    p = _serve_peak(full + PAGED, "serve_llama4_greedy_paged",
                    SERVE_PAGED_KERNELS, state, warmup=False, cfg=cut)
    same = d["completions"] == p["completions"]
    d = _serve_peak(argv + GREEDY8, "serve_llama4_ragged_dense",
                    SERVE_KERNELS, state, warmup=False, cfg=cut)
    p = _serve_peak(argv + GREEDY8 + PAGED, "serve_llama4_ragged_paged",
                    SERVE_PAGED_KERNELS, state, warmup=False, cfg=cut)
    n_same = sum(d["completions"][u] == p["completions"][u]
                 for u in d["completions"])
    log(f"[moe] greedy streams, 8 slots all live: paged == dense {same}; "
        f"8 ragged requests in 16 slots (idle slots' rows differ by "
        f"layout, R13): {n_same} of 8 equal (reported, not gated)")
    state["moe"]["ragged_paged_equal"] = n_same
    if not same:
        failures.append("llama4-scout greedy paged != dense, every slot "
                        "live")

    gc.collect()                     # the launcher's last tree (a cycle)
    torch.cuda.empty_cache()
    cfg = cut
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(0),
                           cfg.cdtype)
    reqs = _shared_prompt_requests(cfg.vocab_size)[:16]
    S = max(len(r.tokens) + r.max_new_tokens for r in reqs)
    outs = {}
    for pc in (False, True):
        eng = GenerationEngine(cfg, max_new_tokens=128, temperature=0.0,
                               chunk=8, kv_layout="paged", block_size=16,
                               prefix_cache=pc, device="cuda")
        n_tok, st, dt, fin = serve.run_schedule(
            eng, params, reqs, torch.Generator(device="cuda").manual_seed(1),
            mode="continuous", slots=16, max_seq_len=S)
        outs[pc] = fin
        log(f"[moe] shared-system-prompt mix, 16 requests, prefix cache "
            f"{'on' if pc else 'off'}: {n_tok} tokens in {dt:.2f}s = "
            f"{n_tok / dt:.1f} tok/s, prefill_hit_rate "
            f"{st['prefill_hit_rate']:.3f}")
    same = sum(outs[True][u] == outs[False][u] for u in outs[False])
    log(f"[moe] prefix cache on vs off: {same} of {len(outs[False])} greedy "
        f"streams equal (R13: a cached prefill routes fewer rows, so the "
        f"capacity differs; reported, not gated)")
    state["moe"]["prefix_equal"] = same
    del params
    torch.cuda.empty_cache()


def _moe_train(state, failures):
    """The fp32 LM step at full width, 1 layer, 2 x 256, kernel vs plain
    (loss, aux and grads), and ``launch.train --lora 8`` in bf16 at 2
    layers, 3 steps of 4 x 512 (full SFT at even one layer needs ~68 GB of
    fp32 state): every loss and aux finite, the adapters moved."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch import train as launch_train

    cfg = get_config(MOE_ARCH).replace(n_layers=1, compute_dtype="float32")
    batch = launch_train.to_device(
        next(launch_train.lm_data(cfg, 256, 0).sft_batches(2, 1)), "cuda")
    _lm_step_gate("moe", cfg, batch, failures)
    torch.cuda.reset_peak_memory_stats()
    out = _sft_run("train_llama4_lora", [
        "--arch", MOE_ARCH, "--lora", "8", "--steps", "3", "--batch", "4",
        "--seq", "512"], state, failures, falling=False,
        cfg=get_config(MOE_ARCH).replace(n_layers=2))
    # every b starts at zero
    moved = all(bool(ad["b"].any()) for ad in out["state"].params.values())
    log(f"[moe] LoRA rank 8: {out['adapter_params']} adapter params (the "
        f"4-D expert stacks get none), the b matrices moved from zero: "
        f"{moved}")
    if not moved:
        failures.append("llama4-scout LoRA: the adapters did not move")
    del out
    torch.cuda.empty_cache()


def phase_moe(state):
    """The MoE layer at llama4-scout-17b-a16e, full width and cut depth:
    serving at 12 layers, the fp32 step gate at 1 layer and LoRA at 2."""
    import gc

    import torch
    failures = []
    for part in (_moe_serve, _moe_train):
        t0 = time.perf_counter()
        part(state, failures)
        gc.collect()          # engines and cores refer to each other
        torch.cuda.empty_cache()
        log(f"[moe] {part.__name__}: {time.perf_counter() - t0:.1f}s")
    if failures:
        raise AssertionError("moe checks failed:\n" + "\n".join(failures))


# --------------------------------------------------------------------- #
# MLA, cross-attention and embedding inputs: deepseek-v2-lite-16b,
# llama-3.2-vision-11b and musicgen-medium
# --------------------------------------------------------------------- #
MLA_ARCH = "deepseek-v2-lite-16b"
VLM_ARCH = "llama-3.2-vision-11b"
AUDIO_ARCH = "musicgen-medium"
# MLA decodes in the absorbed form (plain products, no decode kernel):
# its serve run launches RMSNorm and the flash forward only
MLA_SERVE_KERNELS = ("rmsnorm", "flash_attention_fwd")
# the SFT leg's depth: fp32 masters, AdamW moments, grads and the bf16 copy
# (18 bytes a parameter) of 4 of deepseek's 27 layers (585 M parameters
# each) and the embedding and head take ~50 GB
MLA_TRAIN_LAYERS = 4
# the VLM's self-attention decode runs the dense decode kernel; its cross-
# attention runs the flash forward at every step (one query over 1,601 keys)
VLM_GEN_KERNELS = ("rmsnorm", "flash_attention_fwd", "decode_attention_fwd")


def _flash_rows(state, failures, key, tag, D, cases, seed, pad_v=None):
    """Flash kernel rows at head dim ``D``: per case ``(label, B, KV, G, Lq,
    Lk, causal, bwd)`` the forward with the LSE (and, with ``bwd``, the
    backward from the plain LSE) in fp32 (TF32 off, 1e-4; LSE 1e-4) and
    bf16 (2e-2 of max |plain|; LSE 1e-3) against the plain versions; bf16
    timed warm and cold beside the bound, the plain time and SDPA (the
    backward's: SDPA forward + backward less its forward).  ``pad_v``
    zeroes V's dims past it, as MLA pads V to the query/key width."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention_fwd
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(seed)
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    tol = {"fp32": 1e-4, "bf16": 2e-2}
    row = lambda *a, **kw: _row128(state, failures, *a, key=key, tag=tag,
                                   **kw)
    for (model, B, KV, G, Lq, Lk, causal, with_bwd) in cases:
        label = (f"{model} B={B} KV={KV} G={G} Lq={Lq} Lk={Lk} D={D}"
                 f"{'' if causal else ' non-causal'}")
        pairs = causal_pairs(Lq, Lk, None) if causal else Lq * Lk
        H = KV * G
        for dname, dt in dtypes.items():
            qm = _case_inputs(gen, (B, Lq, H, D), dt)
            km = _case_inputs(gen, (B, Lk, KV, D), dt)
            vm = _case_inputs(gen, (B, Lk, KV, D), dt)
            if pad_v is not None:
                vm[..., pad_v:] = 0
            q5 = qm.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
            k4, v4 = km.transpose(1, 2), vm.transpose(1, 2)
            lse = torch.empty((B, KV, G, Lq), device="cuda")
            out = flash_attention_fwd(q5, k4, v4, causal=causal, lse=lse)
            r = ref.flash_attention_ref(q5, k4, v4, causal=causal)
            lse_ref = ref.flash_attention_lse_ref(q5, k4, causal=causal)
            torch.cuda.synchronize()
            scale = float(r.float().abs().max()) if dname == "bf16" else 1.0
            err = _err(out, r, rel=False) / scale
            lse_err = _err(lse, lse_ref, rel=False)
            if lse_err > (1e-4 if dname == "fp32" else 1e-3):
                failures.append(f"flash LSE {label} {dname}: {lse_err:.3g}")
            if dname == "fp32":
                row("flash_attention_fwd", label, dname, err, tol[dname],
                    extra={"lse_err": lse_err})
            else:
                ops_ = 4 * B * H * pairs * D
                nbytes = (2 * B * H * Lq * D + 2 * B * KV * Lk * D) * 2
                call = lambda q5, k4, v4: flash_attention_fwd(
                    q5, k4, v4, causal=causal)
                qs, ks, vs = (t.transpose(1, 2) for t in (qm, km, vm))
                k_ms = time_ms(lambda: call(q5, k4, v4))
                row("flash_attention_fwd", label, dname, err, tol[dname],
                    k_ms, time_ms(lambda: ref.flash_attention_ref(
                        q5, k4, v4, causal=causal), inner=3, repeats=5),
                    time_ms(lambda: F.scaled_dot_product_attention(
                        qs, ks, vs, is_causal=causal, enable_gqa=G > 1)),
                    bound(nbytes, ops_, "bf16"),
                    cold_ms=_cold(call, (q5, k4, v4), nbytes),
                    extra={"lse_err": lse_err,
                           "tflops": ops_ / (k_ms * 1e-3) / 1e12})
            if not with_bwd:
                continue
            dom = _case_inputs(gen, (B, Lq, H, D), dt)
            do5 = dom.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
            delta = (do5.float() * r.float()).sum(-1).contiguous()
            args = (q5, k4, v4, do5, lse_ref, delta)
            got = flash_attention_bwd(*args, causal=causal)
            want = ref.flash_attention_bwd_ref(*args, causal=causal)
            torch.cuda.synchronize()
            rel = worst(float((a.float() - b.float()).abs().max()
                              / b.float().abs().max().clamp(min=1e-12))
                        for a, b in zip(got, want))
            del got, want
            if dname == "fp32":
                row("flash_attention_bwd", label, dname, rel, tol[dname])
                continue
            ops_ = 10 * D * B * H * pairs
            nbytes = (3 * B * H * Lq * D * 2 + 4 * B * KV * Lk * D * 2
                      + 2 * B * H * Lq * 4)
            call = lambda *a: flash_attention_bwd(*a, causal=causal)
            k_ms = time_ms(lambda: call(*args), inner=5, repeats=5)
            qs, ks, vs = (t.transpose(1, 2).detach().requires_grad_()
                          for t in (qm, km, vm))
            dos = dom.transpose(1, 2)
            sdpa = lambda: F.scaled_dot_product_attention(
                qs, ks, vs, is_causal=causal, enable_gqa=G > 1)
            both = lambda: torch.autograd.grad(sdpa(), (qs, ks, vs), dos)
            lib = (time_ms(both, inner=5, repeats=5)
                   - time_ms(sdpa, inner=5, repeats=5))
            row("flash_attention_bwd", label, dname, rel, tol[dname], k_ms,
                time_ms(lambda: ref.flash_attention_bwd_ref(
                    *args, causal=causal), inner=2, repeats=3), lib,
                bound(nbytes, ops_, "bf16"),
                cold_ms=_cold(call, args, nbytes),
                extra={"tflops": ops_ / (k_ms * 1e-3) / 1e12})
        del qm, km, vm
        torch.cuda.empty_cache()


def _greedy_stream(cfg, params, tokens, n_new, encoder_embeds=None):
    """Greedy free-running decode of ``tokens`` (B, Lp) through
    ``serving.generate``'s prefill and decode steps: (tokens (B, n_new),
    logits (n_new, B, V) fp32; step i's logits predict token i)."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step, prefill
    B, Lp = tokens.shape
    cache = T.init_cache(cfg, B, Lp + n_new, device="cuda")
    lg, cache = prefill(cfg, params, tokens, cache,
                        encoder_embeds=encoder_embeds)
    toks, lgs = [], [lg.float()]
    for t in range(n_new):
        tok = lg.argmax(-1)
        toks.append(tok)
        if t + 1 == n_new:
            break
        pos = torch.full((B,), Lp + t, dtype=torch.long, device="cuda")
        lg, cache = decode_step(cfg, params, tok, cache, pos)
        lgs.append(lg.float())
    del cache
    return torch.stack(toks, 1), torch.stack(lgs)


def _free_running_gate(tag, what, kern, plain, moved, w_err, failures):
    """The full-depth gate of a greedy stream, kernel path against plain
    path, each free-running on its own tokens: the per-layer witness
    ``w_err`` <= 1e-4; the logits gap over the steps whose inputs are still
    the same (up to and including the first step where a row's tokens
    part) <= 1e-4, or 2x the model's conditioning (the plain path with its
    inputs moved by a relative 1e-7, over its own shared steps) where that
    is larger.  Returns the gap."""
    import torch

    def gap(a, b):
        (ta, la), (tb, lb) = a, b
        diff = (ta != tb).any(0).nonzero()
        last = int(diff[0]) if len(diff) else ta.shape[1] - 1
        n_same = int((ta == tb).all(0).long().cumprod(0).sum())
        rel = float((la[:last + 1] - lb[:last + 1]).abs().max()
                    / lb[:last + 1].abs().max())
        return rel, n_same
    finite = bool(torch.isfinite(kern[1]).all()
                  and torch.isfinite(plain[1]).all())
    rel, n_same = gap(kern, plain)
    cond, _ = gap(moved, plain)
    limit = max(1e-4, 2 * cond)
    ok = finite and w_err <= 1e-4 and rel <= limit
    n = kern[0].shape[1]
    log(f"[{tag}] {what}: per-layer witness max {w_err:.3g} (tol 1e-4); "
        f"free-running greedy streams equal for {n_same} of {n} steps in "
        f"every row; logits gap over the shared steps {rel:.3g} (tol "
        f"{limit:.3g}: 1e-4 or 2x the conditioning {cond:.3g}, the plain "
        f"path with its inputs moved by 1e-7); finite {finite} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{tag} {what}: witness {w_err:.3g}, gap {rel:.3g} "
                        f"(tol {limit:.3g}), finite {finite}")
    return {"witness": w_err, "gap": rel, "cond": cond, "same_steps": n_same}


def _mla_parity(state, failures):
    """deepseek-v2-lite-16b in fp32 (TF32 off) at full width and the
    deepest cut whose weights fit the card beside 10 GiB of room (the whole
    is ~65 GB): one greedy row, a 256-token prompt and 32 new tokens,
    kernel path and plain path each free-running; the per-layer witness is
    each MLA layer's attention run through the kernel path on the plain
    run's input and a clone of its cache (the MoE block after it is the
    same code on both paths, and a routing near-tie would only measure
    the router)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import modules as M
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    full = get_config(MLA_ARCH).replace(compute_dtype="float32")
    layer = full.replace(n_layers=2).n_params() - full.replace(
        n_layers=1).n_params()
    fixed = full.replace(n_layers=1).n_params() - layer
    free = torch.cuda.mem_get_info()[0]
    depth = int(min(full.n_layers,
                    (free - 10 * 2**30 - 4 * fixed) // (4 * layer)))
    cfg = full.replace(n_layers=depth)
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen)
    Lp, n_new = 256, 32
    tokens = torch.randint(0, cfg.vocab_size, (1, Lp), generator=gen,
                           device="cuda")
    kcfg, pcfg = cfg.replace(use_kernels=True), cfg.replace(use_kernels=False)
    kern = _greedy_stream(kcfg, params, tokens, n_new)
    w_err, real = [0.0], M.mla_apply

    def witness(c, p, x, *, cache=None, **kw):
        ck = tree_map(torch.clone, cache) if cache is not None else None
        yk, _ = real(kcfg, p, x, cache=ck, **kw)
        y, nc = real(c, p, x, cache=cache, **kw)
        w_err[0] = worst((w_err[0], float((yk - y).abs().max()
                                          / y.abs().max())))
        return y, nc
    M.mla_apply = witness
    try:
        plain = _greedy_stream(pcfg, params, tokens, n_new)
    finally:
        M.mla_apply = real
    params["embed"].mul_(1 + 1e-7 * torch.randn(
        params["embed"].shape, generator=gen, device="cuda"))
    moved = _greedy_stream(pcfg, params, tokens, n_new)
    what = (f"fp32 greedy at full width, {depth} of {full.n_layers} layers "
            f"({cfg.n_params() / 1e9:.2f} B), prompt {Lp} + {n_new} new")
    res = _free_running_gate("mla", what, kern, plain, moved, w_err[0],
                             failures)
    log(f"[mla] parity run {time.perf_counter() - t0:.1f}s, peak "
        f"{_peak_gib():.2f} GiB")
    state.setdefault("mla", {}).update(parity_depth=depth, **res)
    del params, kern, plain, moved


def _mla_serve(state, failures):
    """``launch.serve`` at full width and depth (27 layers, bf16 weights
    only) on the 32-request workload at ``REPEAT_NEW`` new tokens, 16
    slots, dense latent arena, without a warm-up (its tok/s includes the
    first calls at its shapes): tok/s, peak memory, the MoE routing's drop
    share per decode step and per admission (R13); the flash forward at
    D = 192 and RMSNorm must launch, no decode kernel (the absorbed decode
    is plain products)."""
    with _DropMeter() as meter:
        res = _serve_peak(workload(MLA_ARCH, REPEAT_NEW), "serve_deepseek",
                          MLA_SERVE_KERNELS, state, warmup=False)
    counts = state["launches"]["serve_deepseek"]
    dec, adm, n_dec, n_adm, _ = meter.shares(16)
    log(f"[mla] routed entries dropped (R13): {dec:.4f} of each decode "
        f"step's ({n_dec} layer calls of 16 rows), {adm:.4f} of each "
        f"admission's ({n_adm} layer calls)")
    state.setdefault("mla", {}).update(tok_s=res["tok_s"], drop_decode=dec,
                                       drop_admission=adm)
    if any(counts[k] for k in ATTENTION_KERNELS
           if k != "flash_attention_fwd"):
        failures.append(f"serve deepseek: a decode kernel launched {counts}")


def _mla_train(state, failures):
    """``launch.train`` SFT at full width cut to ``MLA_TRAIN_LAYERS``
    layers, 5 steps of 8 x 512 (bf16 on fp32 masters, AdamW, remat): the
    D = 192 flash backward inside a step."""
    from repro_torch.configs import get_config
    cut = get_config(MLA_ARCH).replace(n_layers=MLA_TRAIN_LAYERS)
    log(f"[mla] SFT depth {MLA_TRAIN_LAYERS} of 27 layers "
        f"({cut.n_params() / 1e9:.2f} B parameters)")
    out = _sft_run("train_deepseek", ["--arch", MLA_ARCH, "--steps", "5",
                                      "--batch", "8", "--seq", "512"],
                   state, failures, cfg=cut)
    _free(out)


def _mla_mesh_identity(state, failures):
    """The tensor-parallel path at 1 x 1 against the plain path at
    deepseek-v2-lite, full width cut to ``MLA_TRAIN_LAYERS`` layers
    (:func:`mesh_identity`: one SFT step of 4 x 512, a greedy generate of
    4 x 64 + 16 tokens)."""
    from repro_torch.configs import get_config
    cfg = get_config(MLA_ARCH).replace(n_layers=MLA_TRAIN_LAYERS)
    batch, prompts, _ = _gate_inputs(cfg, 4, 512, 64, seed=32)
    mesh_identity("mla", cfg, batch, prompts, 16, TRAIN_KERNELS, state,
                  failures)


def _mla_rows(state, failures):
    """The flash kernels at MLA's head dim 192 (H = KV = 16, V padded from
    128): prefill B 1, L 256; SFT B 8, L 512 with the LSE, and the
    backward there."""
    _flash_rows(state, failures, "d192", "mla", 192,
                (("deepseek prefill", 1, 16, 1, 256, 256, True, False),
                 ("deepseek sft", 8, 16, 1, 512, 512, True, True)),
                seed=192, pad_v=128)


def phase_mla(state):
    """MLA at deepseek-v2-lite-16b: the D = 192 kernel rows, the fp32
    free-running gate, the serve workload at full size and the SFT leg."""
    import gc

    import torch
    failures = []
    ptx = state.get("ptxas_d192", {})
    log(f"[mla] ptxas of the bf16 flash kernels at D = 192 (phase build): "
        + "; ".join(f"{fn}: {r} registers, {sp} bytes spilled"
                    for fn, (r, sp) in ptx.items()))
    for part in (_mla_rows, _mla_parity, _mla_serve, _mla_train,
                 _mla_mesh_identity):
        t0 = time.perf_counter()
        part(state, failures)
        gc.collect()          # engines and cores refer to each other
        torch.cuda.empty_cache()
        log(f"[mla] {part.__name__}: {time.perf_counter() - t0:.1f}s")
    if failures:
        raise AssertionError("mla checks failed:\n" + "\n".join(failures))


def _set_gates(params, gen):
    """Every cross-attention gate drawn from U(0.5, 1): at their init of 0,
    tanh(gate) would take cross-attention out of the model's outputs."""
    for seg in params["segments"]:
        for lp in seg:
            if "xattn" in lp:
                lp["xattn"]["gate"].uniform_(0.5, 1.0, generator=gen)


def _xattn_rows(state, failures):
    """The flash kernels over llama-3.2-vision's 1,601 encoder keys (D 128,
    H 32 / KV 8, non-causal): decode (Lq 1) and a 64-token prompt at B 4,
    and the SFT shape B 8, Lq 512 with the backward."""
    _flash_rows(state, failures, "cross", "xattn", 128,
                (("vision decode", 4, 8, 4, 1, 1601, False, False),
                 ("vision prompt", 4, 8, 4, 64, 1601, False, False),
                 ("vision sft", 8, 8, 4, 512, 1601, False, True)),
                seed=1601)


def _vlm_generate(state, failures):
    """llama-3.2-vision-11b at full width and depth (40 layers) in fp32
    (TF32 off), gates drawn from U(0.5, 1): ``GenerationEngine.generate``
    with ``encoder_embeds`` (B 4, 1,601 x 1,280, 64-token prompts, 64 new,
    greedy) on the kernel path, its launches (RMSNorm, the flash forward
    for prompts and for every cross-attention step, the dense decode
    kernel), then the free-running gate: kernel and plain path through
    prefill and decode steps, with the per-layer witness (each layer
    through the kernel path on the plain run's input and a clone of its
    cache) and the conditioning (the token embeddings moved by 1e-7)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.engine import GenerationEngine

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(VLM_ARCH).replace(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen)
    _set_gates(params, gen)
    B, Lp, n_new = 4, 64, 64
    tokens = torch.randint(0, cfg.vocab_size, (B, Lp), generator=gen,
                           device="cuda")
    enc = torch.randn((B, cfg.encoder_len, cfg.encoder_dim), generator=gen,
                      device="cuda")
    kcfg, pcfg = cfg.replace(use_kernels=True), cfg.replace(use_kernels=False)
    eng = GenerationEngine(kcfg, max_new_tokens=n_new, temperature=0.0)
    ops.reset_launch_counts()
    t1 = time.perf_counter()
    out = eng.generate(params, tokens, torch.Generator(device="cuda"),
                       encoder_embeds=enc)
    torch.cuda.synchronize()
    gen_s = time.perf_counter() - t1
    counts = ops.launch_counts()
    state.setdefault("launches", {})["generate_vision"] = counts
    missing = [k for k in VLM_GEN_KERNELS if counts[k] == 0]
    if missing:
        failures.append(f"vision generate: kernels never launched {missing}")
    log(f"[xattn] GenerationEngine.generate {VLM_ARCH} fp32 "
        f"({cfg.n_params() / 1e9:.2f} B), B {B}, encoder {cfg.encoder_len} x "
        f"{cfg.encoder_dim}, prompt {Lp} + {n_new} new: {gen_s:.2f}s = "
        f"{B * n_new / gen_s:.1f} tok/s; launches {counts}")
    kern = _greedy_stream(kcfg, params, tokens, n_new, enc)
    if not torch.equal(out["sequences"][:, Lp:], kern[0]):
        failures.append("vision: the engine's tokens differ from prefill + "
                        "decode steps on the same path")
    w_err, layer = [0.0], T._layer

    def witness(c, spec, lp, x, positions, mode, lc, rope,
                block_tables=None, **kw):
        lck = tree_map(torch.clone, lc) if lc is not None else None
        yk, _ = layer(kcfg, spec, lp, x, positions, mode, lck, rope,
                      block_tables, **kw)
        y, aux = layer(c, spec, lp, x, positions, mode, lc, rope,
                       block_tables, **kw)
        w_err[0] = worst((w_err[0], float((yk - y).abs().max()
                                          / (y - x).abs().max())))
        return y, aux
    T._layer = witness
    try:
        plain = _greedy_stream(pcfg, params, tokens, n_new, enc)
    finally:
        T._layer = layer
    params["embed"].mul_(1 + 1e-7 * torch.randn(
        params["embed"].shape, generator=gen, device="cuda"))
    moved = _greedy_stream(pcfg, params, tokens, n_new, enc)
    res = _free_running_gate(
        "xattn", f"{VLM_ARCH} fp32 greedy, full width and depth, B {B}",
        kern, plain, moved, w_err[0], failures)
    log(f"[xattn] vision generate and gate {time.perf_counter() - t0:.1f}s, "
        f"peak {_peak_gib():.2f} GiB")
    state.setdefault("xattn", {}).update(vision_gen_tok_s=B * n_new / gen_s,
                                         **{f"vision_{k}": v
                                            for k, v in res.items()})
    del params, kern, plain, moved, out


def _embed_sft(tag, cfg, steps, batch_fn, state, failures):
    """``steps`` SFT steps (``training.steps.lm_train_step``, bf16 on fp32
    masters, AdamW, remat) of ``cfg`` on ``batch_fn(i)``: every loss
    finite, the training kernels launched (counts set to 0 just before,
    read just after)."""
    import math

    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import transformer as T
    from repro_torch.training.steps import lm_train_step
    from repro_torch.training.train_state import TrainState

    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda").manual_seed(1)
    params = T.init_params(cfg, gen)
    _set_gates(params, gen)
    st = TrainState.create(params)
    del params
    losses, ms = [], []
    ops.reset_launch_counts()
    for i in range(steps):
        b = batch_fn(i)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st, m = lm_train_step(cfg, st, b, 1e-4)
        losses.append(float(m["loss"]))
        ms.append((time.perf_counter() - t0) * 1e3)
    counts = ops.launch_counts()
    state.setdefault("launches", {})[tag] = counts
    B, L = b["labels"].shape
    med = statistics.median(ms[1:] or ms)
    log(f"[xattn] {tag}: {cfg.name} ({cfg.n_layers} layers, "
        f"{cfg.n_params() / 1e9:.2f} B), {steps} steps of {B} x {L}: losses "
        f"{' '.join(f'{x:.4f}' for x in losses)}; step ms "
        f"{' '.join(f'{x:.1f}' for x in ms)} (median after the first "
        f"{med:.1f}, {B * L / med * 1e3:.1f} tok/s); peak {_peak_gib():.2f} "
        f"GiB; launches {counts}")
    state.setdefault("xattn", {})[tag] = {"loss": losses, "step_ms": med,
                                          "peak_gib": _peak_gib()}
    if not all(math.isfinite(x) for x in losses):
        failures.append(f"{tag}: losses {losses}")
    missing = [k for k in TRAIN_KERNELS if counts[k] == 0]
    if missing:
        failures.append(f"{tag}: kernels never launched {missing}")
    del st


def _vlm_train(state, failures):
    """llama-3.2-vision SFT at full width cut to the units (of 4 self- and
    1 cross-attention layer) whose train state (18 bytes a parameter) fits
    in 60% of the card: 3 steps of 8 x 512 tokens of the SFT blend, each row
    with 1,601 x 1,280 encoder embeddings."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_data, to_device

    full = get_config(VLM_ARCH)
    k = full.cross_attn_every
    unit = (full.replace(n_layers=2 * k).n_params()
            - full.replace(n_layers=k).n_params())
    fixed = full.replace(n_layers=k).n_params() - unit
    budget = 0.6 * torch.cuda.get_device_properties(0).total_memory
    units = max(1, int((budget - 18 * fixed) // (18 * unit)))
    cfg = full.replace(n_layers=k * units)
    data = lm_data(cfg, 512, 0).sft_batches(8, 3)
    gen = torch.Generator(device="cuda").manual_seed(2)

    def batch(i):
        b = to_device(next(data), "cuda")
        b["encoder_embeds"] = torch.randn(
            (8, cfg.encoder_len, cfg.encoder_dim), generator=gen,
            device="cuda")
        return b
    _embed_sft("train_vision", cfg, 3, batch, state, failures)


def _vlm_mesh_identity(state, failures):
    """The tensor-parallel path at 1 x 1 against the plain path at
    llama-3.2-vision, full width cut to one unit (4 self- and 1
    cross-attention layer; :func:`mesh_identity`: one SFT step of 4 x 512
    and a greedy generate of 4 x 64 + 16 tokens, each row with 1,601 x
    1,280 encoder embeddings)."""
    from repro_torch.configs import get_config
    full = get_config(VLM_ARCH)
    cfg = full.replace(n_layers=full.cross_attn_every)
    batch, prompts, enc = _gate_inputs(cfg, 4, 512, 64, seed=33)
    mesh_identity("xattn", cfg, batch, prompts, 16, TRAIN_KERNELS, state,
                  failures, encoder_embeds=enc)


def _audio(state, failures):
    """musicgen-medium at full size (48 layers, no embedding table): fp32
    (TF32 off) teacher-forced prefill of 256 frame embeddings and 32 decode
    steps each fed the next frame, kernel path against plain path (1e-4 of
    max |logits|); then 5 SFT steps of 8 x 512 on frames (the SFT blend's
    tokens through a fixed random table: the EnCodec front end stubbed)
    predicting the blend's labels."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.train import lm_data, to_device
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step, prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = get_config(AUDIO_ARCH).replace(compute_dtype="float32")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.init_params(cfg, gen)
    Lp, n_dec = 256, 32
    frames = torch.randn((1, Lp + n_dec, cfg.d_model), generator=gen,
                         device="cuda")
    logits = {}
    for uk in (True, False):
        c = cfg.replace(use_kernels=uk)
        cache = T.init_cache(c, 1, Lp + n_dec, device="cuda")
        lg, cache = prefill(c, params, None, cache, embeds=frames[:, :Lp])
        steps = [lg]
        for t in range(n_dec):
            pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
            lg, cache = decode_step(c, params, None, cache, pos,
                                    embeds=frames[:, Lp + t:Lp + t + 1])
            steps.append(lg)
        logits[uk] = torch.cat(steps).float()
        del cache
    a, b = logits[True], logits[False]
    rel = float((a - b).abs().max() / b.abs().max())
    log(f"[xattn] parity {AUDIO_ARCH} fp32 ({cfg.n_params() / 1e9:.2f} B), "
        f"{Lp} frames prefill + {n_dec} decode steps on frame embeddings "
        f"(teacher-forced): max|dlogits|/max|logits| = {rel:.3g} (tol 1e-4)")
    state.setdefault("xattn", {})["audio_parity"] = rel
    if not (torch.isfinite(a).all() and rel <= 1e-4):
        failures.append(f"parity {AUDIO_ARCH}: rel {rel:.3g}")
    del params, logits, a, b
    torch.cuda.empty_cache()

    cfg = get_config(AUDIO_ARCH)
    table = torch.randn((256, cfg.d_model), generator=gen, device="cuda")
    data = lm_data(cfg, 512, 0).sft_batches(8, 5)

    def batch(i):
        b = to_device(next(data), "cuda")
        return {"embeds": table[b.pop("tokens").long()], **b}
    _embed_sft("train_musicgen", cfg, 5, batch, state, failures)


def phase_xattn(state):
    """Cross-attention at llama-3.2-vision-11b and embedding inputs at
    musicgen-medium: the flash rows over 1,601 encoder keys, the VLM's
    generate and free-running gate at full size, its SFT leg, and the audio
    decoder's parity and SFT at full size."""
    import gc

    import torch
    failures = []
    for part in (_xattn_rows, _vlm_generate, _vlm_train, _vlm_mesh_identity,
                 _audio):
        t0 = time.perf_counter()
        part(state, failures)
        gc.collect()
        torch.cuda.empty_cache()
        log(f"[xattn] {part.__name__}: {time.perf_counter() - t0:.1f}s")
    if failures:
        raise AssertionError("xattn checks failed:\n" + "\n".join(failures))


PHASE_FNS = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "parity": phase_parity,
             "serve": phase_serve, "train": phase_train, "rlhf": phase_rlhf,
             "async": phase_async, "disagg": phase_disagg,
             "hybrid": phase_hybrid,
             "serve_mesh": phase_serve_mesh, "ssm": phase_ssm,
             "ssm_train": phase_ssm_train,
             "gqa128": phase_gqa128, "moe": phase_moe,
             "mla": phase_mla, "xattn": phase_xattn,
             "ckpt": phase_ckpt, "profile": phase_profile}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    ap.add_argument("--disagg-worker", default=None, metavar="OUT",
                    help=argparse.SUPPRESS)   # a rank of phase disagg
    args = ap.parse_args()
    if args.disagg_worker is not None:
        return disagg_worker(args.disagg_worker)
    phases = [p for p in args.phases.split(",") if p]
    unknown = set(phases) - set(PHASES)
    if unknown:
        ap.error(f"unknown phases {sorted(unknown)}")

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    try:
        import repro_torch  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: the port is not importable ({e}); run from the "
              f"repository root", file=sys.stderr)
        return 1

    state: dict = {"phases": phases}
    t_all = time.perf_counter()
    try:
        for name in PHASES:
            if name in phases:
                t0 = time.perf_counter()
                PHASE_FNS[name](state)
                log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s")
    finally:
        early = state.pop("disagg_run", None)      # a phase failed first
        if early is not None and early[1][0].poll() is None:
            early[1][0].terminate()                  # torchrun stops its ranks
            try:
                early[1][0].wait(timeout=30)
            except subprocess.TimeoutExpired:
                early[1][0].kill()
                early[1][0].wait()
    log(f"total {time.perf_counter() - t_all:.1f}s")

    # launches: each main path's run (serve, train), counts set to 0 just
    # before it and read just after; the total and the split by path
    by_path = state.get("launches", {})
    # the decode kernels' device time inside the OPT-1.3B decode steps
    in_step = {"decode_attention_fwd": state.get("step", {}),
               "paged_decode_attention_fwd": state.get("step_paged", {}),
               "decode_attention_quant_fwd": state.get("step_int8", {}),
               "paged_decode_attention_quant_fwd":
                   state.get("step_paged_int8", {})}
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        row = dict(state.get("kernel_rows", {}).get(name, {}))
        if in_step.get(name, {}).get("decode_in_step"):
            row["decode_in_step"] = in_step[name]["decode_in_step"]
        split = {path: c[name] for path, c in by_path.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": sum(split.values()) if split else None,
            "launches_by_path": split,
            "max_abs_err": row.get("max_abs_err"), "ms": row.get("ms"),
            "plain_ms": row.get("plain_ms"), "bound_ms": row.get("bound_ms"),
            "bound_by": row.get("bound_by"),
            "library_ms": row.get("library_ms"),
            **{k: row[k] for k in ("yardstick_ms", "dense_kernel_ms",
                                   "gather_sdpa_ms", "tflops", "dkv_ms",
                                   "dq_ms", "train_ms", "train_library_ms",
                                   "train_bound_ms", "train_tflops",
                                   "floor_ms", "bound_fp32_ms",
                                   "kernels_per_call",
                                   "cold_ms", "library_cold_ms",
                                   "achieved_gbs", "decode_in_step")
               if k in row},
            # the head-dim-128 rows of phase gqa128, the head-dim-192 rows
            # of phase mla, the cross-attention rows of phase xattn and
            # the per-rank tensor-parallel rows of phase hybrid
            **{key: state[key][name] for key in ("d128", "d192", "cross",
                                                 "tp")
               if name in state.get(key, {})},
        })
    print(state.get("smi") or nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
