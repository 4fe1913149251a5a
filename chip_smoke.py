#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py                       # every phase
    python3 chip_smoke.py --phases build,kernels

Phases (any failure raises, so the run exits non-zero):

1. ``device``  — the card (``nvidia-smi`` name and power limit), torch and
   CUDA versions.
2. ``build``   — every CUDA source of the port built with ``nvcc``, one
   process per source, all in parallel; seconds and ``ptxas`` resource use.
3. ``kernels`` — each kernel against its plain PyTorch version on the card
   at the main paths' shapes (OPT-1.3B, OPT-350M and smollm-135m widths),
   in fp32 (TF32 off) and bf16, with kernel / plain / library device times
   (medians of CUDA-graph replays timed with CUDA events) and each shape's
   lower bound on time; the flash forward's LSE against the plain LSE, and
   the flash backward (dq, dk, dv) against its plain version at the
   training shapes (OPT-1.3B: B=8, H=32, L=512), with the backward of
   ``F.scaled_dot_product_attention`` (fwd+bwd less fwd) as its yardstick.
4. ``parity``  — OPT-1.3B at full width and depth in fp32, random weights:
   one teacher-forced token stream (prefill 256 + 32 decode steps) through
   the kernel path and the plain path; max |dlogits| / max |logits|.
5. ``serve``   — ``repro_torch.launch.serve`` at OPT-1.3B in bf16: 32
   ragged requests (prompts up to 256, up to 256 new tokens), 16 slots,
   chunk 8, continuous batching, default sampling.  Launch counts are set
   to 0 just before and read just after; every kernel must have launched.
   Then a short greedy run at smollm-135m full width.
6. ``train``   — (a) OPT-1.3B at full width, cut to 4 layers, fp32 (TF32
   off): one LM step's loss and grads through the kernels against the
   plain path (loss to 1e-5 relative, every grad leaf to 1e-4 of its
   max |grad|); (b) ``repro_torch.launch.train`` at OPT-1.3B, full width
   and depth, bf16: 10 SFT steps of 8 x 512 tokens, every loss finite and
   the last below the first, with launch counts set to 0 just before and
   read just after (RMSNorm, flash forward and flash backward must all
   have launched); then one more step under ``torch.profiler`` for the
   device time by kernel; (c) 5 reward-model steps at OPT-350M, full width
   and depth, on ``DataBlender.reward_batches(8, ...)`` at seq 512.
7. ``rlhf``    — the 3-stage pipeline (``repro_torch.core.RLHFPipeline``)
   at full width and depth: OPT-1.3B actor and reference, OPT-350M critic
   and reward model, bf16 compute on fp32 masters, the copy + sort blend
   at 256 prompt + 256 response tokens, batch 8.  4 SFT steps, 4 RM steps,
   3 PPO iterations generating 256 tokens on an int8 KV cache (ptx 0.05,
   EMA on), then 1 iteration with a bf16 KV cache on the same trainer.
   Per iteration: generation s and tok/s, scoring ms, actor and critic
   step ms, ratio_mean, approx_kl, reward score, peak memory and launches
   per kernel.  Fails unless every number is finite, the first ratio_mean
   is 1 to 1e-3, the reference and reward checksums are unchanged by stage
   3, and the int8 iterations launched the int8 decode kernel and never
   the bf16 one (the bf16 iteration the reverse).  Then ``torch.profiler``
   over 8 int8 decode steps and over scoring + one actor and critic step.

The kernel phase also holds ``decode_attention_quant_fwd`` (int8 K/V with
fp32 row scales) to its plain version at the PPO (B = 8) and serve (B = 16)
shapes, with dequant-then-SDPA as a yardstick; the parity phase adds a
greedy int8-KV decode of OPT-1.3B cut to 4 layers (kernel vs plain path),
and the serve phase a ``--kv-quant`` run of the same workload.

The last lines are the card's ``name, power.limit``, one JSON object with a
row per kernel, and ``{"ok": true, "device": {...}}``.  Without CUDA, or
without the repository's ``src/`` beside this file, it exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

PHASES = ("device", "build", "kernels", "parity", "serve", "train", "rlhf")

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
}

# the kernels each main path must launch
SERVE_KERNELS = ("rmsnorm", "flash_attention_fwd", "decode_attention_fwd")
SERVE_INT8_KERNELS = ("rmsnorm", "flash_attention_fwd",
                      "decode_attention_quant_fwd")
TRAIN_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd")
RLHF_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd",
                "decode_attention_quant_fwd")


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def time_ms(fn, *, inner: int = 20, repeats: int = 7) -> float:
    """Median device time per call in ms.  ``inner`` back-to-back calls are
    captured into one CUDA graph, which is replayed ``repeats`` times
    between two CUDA events: the time is the card's, without the host's
    per-call launch overhead (which would otherwise set the pace of these
    microsecond kernels)."""
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


def phase_build(state):
    from repro_torch.kernels import build
    t0 = time.perf_counter()
    report = build.build(ptxas_verbose=True)
    wall = time.perf_counter() - t0
    for name, r in report.items():
        log(f"[build] {name}.cu: {r['seconds']:.1f}s")
        for ln in r["log"].splitlines():
            if "registers" in ln or "spill" in ln:
                log(f"[build]   {ln.strip()}")
    log(f"[build] {len(report)} sources, {wall:.1f}s wall (nvcc in "
        f"parallel)")


def _case_inputs(gen, shape, dtype):
    import torch
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


def _err(out, ref, rel: bool) -> float:
    d = (out.float() - ref.float()).abs()
    if rel:
        d = d / ref.float().abs().clamp(min=1.0)
    return float(d.max())


def _decode_valid(gen, B, S, lo):
    """Decode masks ``(B, S)``: ``valid``, ragged with ``lo..S`` rows per
    sequence (one full), the pattern that is timed and bounded; and
    ``masked``, the same with sequence 0 fully masked (an idle slot, whose
    answer is the mean of V), checked but not timed."""
    import torch
    n_valid = torch.randint(lo, S + 1, (B,), generator=gen, device="cuda")
    n_valid[1] = S
    valid = torch.arange(S, device="cuda")[None] < n_valid[:, None]
    masked = valid.clone()
    masked[0] = False
    return valid, masked


def phase_kernels(state):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.flash_attention import flash_attention_fwd
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
               main, abs_err=None):
        ok = err <= limit
        if not ok:
            failures.append(f"{name} {label} {dname}: err {err:.3g} > "
                            f"{limit}")
        log(f"[kernels] {name:<21} {label:<38} {dname} err={err:.3g} "
            f"(tol {limit}) kernel_ms={k_ms:.4f} plain_ms={p_ms:.4f} "
            f"library_ms={'null' if lib_ms is None else f'{lib_ms:.4f}'} "
            f"bound_ms={bnd[0]:.4f} ({bnd[1]}) {'ok' if ok else 'FAIL'}")
        if main:
            rows[name] = {"max_abs_err": err if abs_err is None else abs_err,
                          "ms": k_ms, "plain_ms": p_ms,
                          "bound_ms": bnd[0], "bound_by": bnd[1],
                          "library_ms": lib_ms, "shape": label,
                          "dtype": dname}

    # ---- rmsnorm: decode (R = slots) and prefill (R = bucket) rows ----
    for (R, D, model) in ((16, 2048, "opt-1.3b"), (512, 2048, "opt-1.3b"),
                          (16, 576, "smollm-135m"), (512, 576, "smollm-135m")):
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
                   abs_err=_err(out, r, rel=False))

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
            bnd = bound((2 * B * KV * G * Lq * D + 2 * B * KV * Lk * D) * eb,
                        4 * B * KV * G * pairs * D,
                        "bf16" if dname == "bf16" else "fp32")
            lib = None
            if Lq == Lk and window is None:
                qs, ks, vs = (t.transpose(1, 2) for t in (qm, km, vm))
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=G > 1))
            record("flash_attention_fwd",
                   f"{model} B={B} KV={KV} G={G} Lq={Lq} Lk={Lk}{win}", dname,
                   err,
                   tol[("attn", dname)],
                   time_ms(lambda: flash_attention_fwd(
                       q5, k4, v4, causal=True, window=window)),
                   time_ms(lambda: ref.flash_attention_ref(
                       q5, k4, v4, causal=True, window=window)),
                   lib, bnd,
                   main=(B, KV, Lq, Lk, window, dname) == (
                       1, 32, 256, 256, None, "bf16"))

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
            rel = max(float((a.float() - b.float()).abs().max()
                            / b.float().abs().max().clamp(min=1e-12))
                      for a, b in zip(got, want))
            abs_err = max(_err(a, b, rel=False) for a, b in zip(got, want))
            scale = min(float(b.float().abs().max()) for b in want)
            if not scale > 0:
                failures.append(f"flash bwd {model} {dname}: the plain "
                                f"gradients are all zero")
            log(f"[kernels] flash_attention_bwd {model} {dname}: max|ref| of "
                f"dq/dk/dv >= {scale:.3g}, max|kernel - ref| = "
                f"{abs_err:.3g} (an exact 0 is possible: the kernel and the "
                f"fp32 GEMMs sum each output in the same order)")
            pairs = causal_pairs(Lq, Lk, window)
            eb = qm.element_size()
            bnd = bound(3 * B * KV * G * Lq * D * eb + 4 * B * KV * Lk * D * eb
                        + 2 * B * KV * G * Lq * 4,
                        10 * D * B * KV * G * pairs,
                        "bf16" if dname == "bf16" else "fp32")
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
                   abs_err=abs_err)
            del got, want, o5

    # ---- decode attention: 16 slots over the in-place (B, S, KV, D) arena
    for (KV, G, S, model) in ((32, 1, 512, "opt-1.3b"),
                              (3, 3, 512, "smollm-135m"),
                              (32, 1, 300, "opt-1.3b")):
        B, D = 16, 64
        for dname, dt in dtypes.items():
            q = _case_inputs(gen, (B, KV * G, D), dt)
            k_arena = _case_inputs(gen, (B, S, KV, D), dt)
            v_arena = _case_inputs(gen, (B, S, KV, D), dt)
            valid, masked = _decode_valid(gen, B, S, 1)
            q4 = q.unflatten(1, (KV, G))
            k4, v4 = k_arena.transpose(1, 2), v_arena.transpose(1, 2)
            out = decode_attention_fwd(q4, k4, v4, valid)
            r = ref.decode_attention_ref(q4, k4, v4, valid)
            out_m = decode_attention_fwd(q4, k4, v4, masked)
            r_m = ref.decode_attention_ref(q4, k4, v4, masked)
            torch.cuda.synchronize()
            err = max(_err(out, r, rel=False), _err(out_m, r_m, rel=False))
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
            record("decode_attention_fwd",
                   f"{model} B={B} KV={KV} G={G} S={S} ragged", dname, err,
                   tol[("attn", dname)],
                   time_ms(lambda: decode_attention_fwd(q4, k4, v4, valid)),
                   time_ms(lambda: ref.decode_attention_ref(q4, k4, v4,
                                                            valid)),
                   lib, bnd,
                   main=(KV, S, dname) == (32, 512, "bf16"))
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
            err = max(_err(out, r, rel=False),           # of max |plain|
                      _err(out_m, r_m, rel=False)) / scale
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
            record("decode_attention_quant_fwd", label, dname, err,
                   tol[("attn", dname)],
                   time_ms(lambda: decode_attention_quant_fwd(
                       q4, k4, v4, ks3, vs3, valid)),
                   time_ms(lambda: ref.decode_attention_quant_ref(
                       q4, k4, v4, ks3, vs3, valid)),
                   None, bnd, main=(B, KV, dname) == (8, 32, "bf16"),
                   abs_err=max(_err(out, r, rel=False),
                               _err(out_m, r_m, rel=False)))
            log(f"[kernels] decode_attention_quant_fwd {label} {dname}: "
                f"dequant-then-SDPA yardstick {yard:.4f} ms (no library "
                f"call computes int8 decode)")
            if (B, KV, dname) == (8, 32, "bf16"):
                rows["decode_attention_quant_fwd"]["yardstick_ms"] = yard
    state["kernel_rows"] = rows
    if failures:
        raise AssertionError("kernel checks failed:\n" + "\n".join(failures))


def phase_parity(state):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
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
    (a, ta, kcache), (b, tb, pcache) = runs["kernel"], runs["plain"]
    ca, cb = kcache[0][0], pcache[0][0]
    fp = runs["plain-fp32-cache"][0]
    # witness: each decode step again, both paths from one cache (the
    # kernel path's own int8 rows, cloned per path and step), so only the
    # decode math differs; held to 1e-4 relative like the fp32 parity
    wit = {True: [], False: []}
    for t in range(n_dec):
        pos = torch.full((1,), Lp + t, dtype=torch.long, device="cuda")
        for use_kernels in (True, False):
            lg, _ = decode_step(cfg.replace(use_kernels=use_kernels), params,
                                ta[t:t + 1], tree_map(torch.clone, kcache),
                                pos)
            wit[use_kernels].append(lg.float())
    wa, wb = torch.cat(wit[True]), torch.cat(wit[False])
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
    del params, cache, runs, ca, cb, kcache, pcache, wit, wa, wb
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


def phase_serve(state):
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T
    from repro_torch.serving.generate import decode_step, prefill

    # anatomy of one admission and one decode step at the serve shape
    # (OPT-1.3B bf16, 16 slots, S = 512): kernel launches, and the decode
    # step's time eager (host clock, synchronized) against the same step
    # replayed from a CUDA graph (device time alone; the difference is
    # the host's launch overhead)
    cfg = get_config("opt-1.3b")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = T.cast_params(cfg, T.init_params(cfg, gen))
    torch.cuda.empty_cache()
    slots, S = 16, 512
    cache = T.init_cache(cfg, slots, S, device="cuda")
    toks = torch.randint(0, cfg.vocab_size, (slots, 256), generator=gen,
                         device="cuda")
    ops.reset_launch_counts()
    prefill(cfg, params, toks[:1], T.init_cache(cfg, 1, S, device="cuda"))
    per_admit = ops.launch_counts()
    pos = torch.randint(64, S, (slots,), generator=gen, device="cuda")
    tok = toks[:, 0]
    ops.reset_launch_counts()
    decode_step(cfg, params, tok, cache, pos)
    per_step = ops.launch_counts()
    log(f"[serve] launches per admission (prefill): {per_admit}")
    log(f"[serve] launches per decode step: {per_step}")
    wall = []
    for _ in range(20):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        decode_step(cfg, params, tok, cache, pos)
        torch.cuda.synchronize()
        wall.append((time.perf_counter() - t0) * 1e3)
    graph_ms = time_ms(lambda: decode_step(cfg, params, tok, cache, pos),
                       inner=4, repeats=5)
    eager_ms = statistics.median(wall)
    log(f"[serve] opt-1.3b decode step, 16 slots, S=512: eager "
        f"{eager_ms:.3f} ms (host clock), CUDA-graph replay {graph_ms:.3f} "
        f"ms (device); the device is idle {1 - graph_ms / eager_ms:.1%} of "
        f"the eager step")
    state["step"] = {"eager_ms": eager_ms, "graph_ms": graph_ms}
    del params, cache
    torch.cuda.empty_cache()

    argv = ["--arch", "opt-1.3b", "--requests", "32", "--ragged",
            "--prompt-len", "256", "--max-new", "256", "--batch", "16",
            "--chunk", "8"]
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

    # the same workload on the int8 arena
    argv8 = argv + ["--kv-quant"]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv8)}")
    ops.reset_launch_counts()
    res8 = serve.main(argv8)
    counts8 = ops.launch_counts()
    log(f"[serve] opt-1.3b bf16, int8 KV: {res8['tokens']} tokens in "
        f"{res8['seconds']:.3f}s = {res8['tok_s']:.1f} tok/s (bf16 KV above: "
        f"{res['tok_s']:.1f}), stats {res8['stats']}")
    log(f"[serve] kernel launches during the int8 run: {counts8}")
    missing = [k for k in SERVE_INT8_KERNELS if counts8[k] == 0]
    if missing or counts8["decode_attention_fwd"]:
        raise AssertionError(f"serve --kv-quant: launches {counts8}")
    if res8["tokens"] != res["tokens"]:
        raise AssertionError("serve --kv-quant: the run lost tokens")
    state["launches"]["serve_int8"] = counts8
    state["serve"] = {"tok_s": res["tok_s"], "tok_s_int8": res8["tok_s"]}

    argv = ["--arch", "smollm-135m", "--requests", "8", "--ragged",
            "--prompt-len", "64", "--max-new", "32", "--batch", "4",
            "--temperature", "0"]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    res = serve.main(argv)
    if res["tokens"] != sum(r.max_new_tokens for r in res["requests"]):
        raise AssertionError("serve: smollm-135m run lost tokens")
    log(f"[serve] smollm-135m greedy: {res['tokens']} tokens, "
        f"{res['tok_s']:.1f} tok/s")


def _profile_step(step_fn, kernels=("flash_bwd", "flash_fwd", "rmsnorm")):
    """Device time of one call of ``step_fn`` by kernel, from
    ``torch.profiler``: (total device ms, {bucket: ms}, top kernels), or
    None when the profiler sees no device time."""
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
    top = sorted(per_kernel.items(), key=lambda kv: -kv[1])[:12]
    return total, buckets, top


def phase_train(state):
    import math

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import ops
    from repro_torch.launch import train as launch_train
    from repro_torch.models import reward as R
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.training.steps import (lm_train_step, lm_value_and_grad,
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
    grad_rel = max(float((a - b).abs().max() / b.abs().max().clamp(
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

    # where the time goes in one SFT step (same shape, a fresh state)
    cfg = get_config("opt-1.3b")
    st = TrainState.create(T.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(1)))
    b = launch_train.to_device(
        next(launch_train.lm_data(cfg, 512, 0).sft_batches(8, 1)), "cuda")
    holder = [st]

    def one_step():
        holder[0], m = lm_train_step(cfg, holder[0], b, 1e-5)
        float(m["loss"])

    for _ in range(2):
        one_step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        prof = _profile_step(one_step)
    except Exception as e:             # measurement only, not a check
        prof = None
        log(f"[train] torch.profiler failed: {e!r}")
    if prof is None:
        log(f"[train] one SFT step {wall:.1f} ms (host clock); the profiler "
            f"saw no device time")
    else:
        total, buckets, top = prof
        log(f"[train] one SFT step (8 x 512, bf16): {wall:.1f} ms host "
            f"clock, {total:.1f} ms of kernel time (torch.profiler); device "
            f"idle ~{max(0.0, 1 - total / wall):.1%} of the step")
        log("[train] kernel time by kind: " + ", ".join(
            f"{k} {v:.1f} ms ({v / total:.1%})" for k, v in buckets.items()))
        for name, ms in top:
            log(f"[train]   {ms:9.2f} ms  {name[:110]}")
        state["train"].update(profile_total_ms=total, buckets=buckets)
    del st, holder, b
    torch.cuda.empty_cache()

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
    rholder = [rstate]

    def one_reward_step():
        rholder[0], m = reward_train_step(cfg, rholder[0], rb, 1e-5)
        float(m["loss"])

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one_reward_step()
    wall = (time.perf_counter() - t0) * 1e3
    try:
        prof = _profile_step(one_reward_step)
    except Exception as e:             # measurement only, not a check
        prof = None
        log(f"[train] torch.profiler failed: {e!r}")
    if prof is not None:
        total, buckets, _ = prof
        log(f"[train] one reward step: {wall:.1f} ms host clock, "
            f"{total:.1f} ms of kernel time (torch.profiler); device idle "
            f"~{max(0.0, 1 - total / wall):.1%} of the step; "
            + ", ".join(f"{k} {v:.1f} ms" for k, v in buckets.items()))
    del rstate, rholder
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
                         ppo_steps=3, ppo_batch=8)
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

    # one more iteration on the same trainer with a bf16 KV cache
    trainer.gen_engine = GenerationEngine(
        actor, max_new_tokens=ppo.max_new_tokens,
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
    log(f"[rlhf] pipeline {wall:.1f}s; stage 3 (3 int8 iterations) "
        f"{pipe.timings['stage3']:.1f}s, gen {pipe.gen_tok_s:.1f} tok/s "
        f"mean; peak memory over the phase "
        f"{max(peaks) / 2**30:.2f} GiB; launches {total}")
    state["rlhf"] = {"iters": iters, "timings": dict(pipe.timings),
                     "step_ms": pipe.step_ms}

    # where the time goes: device time by kernel over 8 decode steps of
    # the int8 generation, and over scoring + actor + critic step
    from repro_torch.serving.generate import decode_step, prefill
    from repro_torch.models import transformer as T
    gen_cfg = actor.replace(kv_quant=True)
    params = T.cast_params(gen_cfg, trainer.actor.params)
    toks = torch.as_tensor(batch["prompts"], device="cuda").long()
    cache = T.init_cache(gen_cfg, 8, 512, device="cuda")
    lg, cache = prefill(gen_cfg, params, toks, cache)
    tok = lg.argmax(-1)
    pos = torch.full((8,), 256, dtype=torch.long, device="cuda")

    def eight_steps():
        for t in range(8):
            decode_step(gen_cfg, params, tok, cache, pos + t)

    eight_steps()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    eight_steps()
    torch.cuda.synchronize()
    dec_wall = (time.perf_counter() - t1) * 1e3
    from repro_torch.core import RolloutBatch
    resp = torch.cat([torch.zeros_like(exp.mask[:, :1], dtype=torch.bool),
                      exp.mask > 0], dim=1)
    rollout = RolloutBatch(sequences=exp.sequences, response_mask=resp)

    def score_train():
        trainer.train_rlhf(trainer.score_rollout(rollout)[0], ptx)

    for name, fn, kinds, wall_ms in (
            ("8 int8 decode steps", eight_steps,
             ("decode_quant", "rmsnorm", "flash"), dec_wall),
            ("scoring + actor + critic step", score_train,
             ("flash_bwd", "flash_fwd", "rmsnorm", "decode"), None)):
        if wall_ms is None:             # unprofiled run: a fault fails
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t1) * 1e3
        try:
            prof = _profile_step(fn, kernels=kinds)
        except Exception as e:          # the profiler only, not a check
            prof = None
            log(f"[rlhf] torch.profiler failed: {e!r}")
        if prof is None:
            continue
        total_ms, buckets, top = prof
        log(f"[rlhf] {name}: {wall_ms:.1f} ms host clock, {total_ms:.1f} ms "
            f"of kernel time (torch.profiler); device idle "
            f"~{max(0.0, 1 - total_ms / wall_ms):.1%}; by kind: " + ", ".join(
                f"{k} {v:.2f} ms ({v / total_ms:.1%})"
                for k, v in buckets.items()))
        for kname, ms in top[:6]:
            log(f"[rlhf]   {ms:9.3f} ms  {kname[:100]}")
    del params, cache, trainer, pipe, eng, exp
    torch.cuda.empty_cache()
    if failures:
        raise AssertionError("rlhf: " + "; ".join(failures))


PHASE_FNS = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "parity": phase_parity,
             "serve": phase_serve, "train": phase_train, "rlhf": phase_rlhf}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
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

    state: dict = {}
    t_all = time.perf_counter()
    for name in PHASES:
        if name in phases:
            t0 = time.perf_counter()
            PHASE_FNS[name](state)
            log(f"[{name}] phase done in {time.perf_counter() - t0:.1f}s")
    log(f"total {time.perf_counter() - t_all:.1f}s")

    # launches: each main path's run (serve, train), counts set to 0 just
    # before it and read just after; the total and the split by path
    by_path = state.get("launches", {})
    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        row = state.get("kernel_rows", {}).get(name, {})
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
            **({"yardstick_ms": row["yardstick_ms"]}
               if "yardstick_ms" in row else {}),
        })
    print(state.get("smi") or nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
