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

PHASES = ("device", "build", "kernels", "parity", "serve", "train")

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
}

# the kernels each main path must launch
SERVE_KERNELS = ("rmsnorm", "flash_attention_fwd", "decode_attention_fwd")
TRAIN_KERNELS = ("rmsnorm", "flash_attention_fwd", "flash_attention_bwd")


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
        "decode_attention_fwd")

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
            n_valid = torch.randint(1, S + 1, (B,), generator=gen,
                                    device="cuda")
            n_valid[0] = 0                     # one fully masked row
            n_valid[1] = S
            valid = torch.arange(S, device="cuda")[None] < n_valid[:, None]
            q4 = q.unflatten(1, (KV, G))
            k4, v4 = k_arena.transpose(1, 2), v_arena.transpose(1, 2)
            out = decode_attention_fwd(q4, k4, v4, valid)
            r = ref.decode_attention_ref(q4, k4, v4, valid)
            torch.cuda.synchronize()
            err = _err(out, r, rel=False)
            mean_v = v4[0].float().mean(dim=1)            # (KV, D)
            err_mean = _err(out[0].float(), mean_v[:, None].expand(KV, G, D),
                            rel=False)
            if err_mean > tol[("attn", dname)]:
                failures.append(f"decode {dname}: fully masked row is not "
                                f"the mean of V (err {err_mean:.3g})")
            eb = q.element_size()
            rows_needed = torch.where(n_valid > 0, n_valid,
                                      torch.full_like(n_valid, S))
            need = int(rows_needed.sum())
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
    state["kernel_rows"] = rows
    if failures:
        raise AssertionError("kernel checks failed:\n" + "\n".join(failures))


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


PHASE_FNS = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "parity": phase_parity,
             "serve": phase_serve, "train": phase_train}


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
        })
    print(state.get("smi") or nvidia_smi_line())
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
