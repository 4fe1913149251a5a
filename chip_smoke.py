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
   at the main path's shapes (OPT-1.3B and smollm-135m widths), in fp32
   (TF32 off) and bf16, with kernel / plain / library device times
   (medians of CUDA-graph replays timed with CUDA events) and each shape's
   lower bound on time.
4. ``parity``  — OPT-1.3B at full width and depth in fp32, random weights:
   one teacher-forced token stream (prefill 256 + 32 decode steps) through
   the kernel path and the plain path; max |dlogits| / max |logits|.
5. ``serve``   — ``repro_torch.launch.serve`` at OPT-1.3B in bf16: 32
   ragged requests (prompts up to 256, up to 256 new tokens), 16 slots,
   chunk 8, continuous batching, default sampling.  Launch counts are set
   to 0 just before and read just after; every kernel must have launched.
   Then a short greedy run at smollm-135m full width.

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

PHASES = ("device", "build", "kernels", "parity", "serve")

# H100 SXM peaks (NVIDIA data sheet, dense): the time bound of a kernel is
# the larger of bytes / memory rate and operations / peak rate for the type
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"bf16": 989e12, "fp32": 67e12}

KERNEL_META = {
    "rmsnorm": ("src/repro_torch/kernels/csrc/rmsnorm.cu",
                "src/repro/kernels/rmsnorm.py:24"),
    "flash_attention_fwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:74"),
    "decode_attention_fwd": (
        "src/repro_torch/kernels/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:77"),
}


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
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gen = torch.Generator(device="cuda").manual_seed(1234)
    rows = {}
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}
    tol = {("rmsnorm", "fp32"): 1e-4, ("rmsnorm", "bf16"): 1e-2,
           ("attn", "fp32"): 1e-4, ("attn", "bf16"): 2e-2}
    failures = []
    log("kernels: rmsnorm, flash_attention_fwd, decode_attention_fwd")

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

    # ---- flash attention: admission prefill, B = 1 ----
    for (KV, G, Lq, Lk, window, model) in (
            (32, 1, 256, 256, None, "opt-1.3b"),
            (32, 1, 300, 300, None, "opt-1.3b"),
            (32, 1, 100, 300, None, "opt-1.3b"),
            (32, 1, 256, 256, 96, "opt-1.3b"),
            (3, 3, 256, 256, None, "smollm-135m"),
            (3, 3, 300, 300, None, "smollm-135m"),
            (3, 3, 77, 300, None, "smollm-135m")):
        D, B = 64, 1
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
            torch.cuda.synchronize()
            err = _err(out, r, rel=False)
            qpos = torch.arange(Lq) + (Lk - Lq)
            kpos = torch.arange(Lk)
            m = qpos[:, None] >= kpos[None, :]
            if window is not None:
                m &= (qpos[:, None] - kpos[None, :]) < window
            pairs = int(m.sum())
            eb = qm.element_size()
            bnd = bound((2 * B * KV * G * Lq * D + 2 * B * KV * Lk * D) * eb,
                        4 * B * KV * G * pairs * D,
                        "bf16" if dname == "bf16" else "fp32")
            lib = None
            if Lq == Lk and window is None:
                qs, ks, vs = (t.transpose(1, 2) for t in (qm, km, vm))
                lib = time_ms(lambda: F.scaled_dot_product_attention(
                    qs, ks, vs, is_causal=True, enable_gqa=G > 1))
            win = "" if window is None else f" window={window}"
            record("flash_attention_fwd",
                   f"{model} KV={KV} G={G} Lq={Lq} Lk={Lk}{win}", dname, err,
                   tol[("attn", dname)],
                   time_ms(lambda: flash_attention_fwd(
                       q5, k4, v4, causal=True, window=window)),
                   time_ms(lambda: ref.flash_attention_ref(
                       q5, k4, v4, causal=True, window=window)),
                   lib, bnd,
                   main=(KV, Lq, Lk, window, dname) == (32, 256, 256, None,
                                                        "bf16"))

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
    missing = [k for k, n in counts.items() if n == 0]
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
    state["launches"] = counts

    argv = ["--arch", "smollm-135m", "--requests", "8", "--ragged",
            "--prompt-len", "64", "--max-new", "32", "--batch", "4",
            "--temperature", "0"]
    log(f"[serve] python -m repro_torch.launch.serve {' '.join(argv)}")
    res = serve.main(argv)
    if res["tokens"] != sum(r.max_new_tokens for r in res["requests"]):
        raise AssertionError("serve: smollm-135m run lost tokens")
    log(f"[serve] smollm-135m greedy: {res['tokens']} tokens, "
        f"{res['tok_s']:.1f} tok/s")


PHASE_FNS = {"device": phase_device, "build": phase_build,
             "kernels": phase_kernels, "parity": phase_parity,
             "serve": phase_serve}


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

    kernels = []
    for name, (src, replaces) in KERNEL_META.items():
        row = state.get("kernel_rows", {}).get(name, {})
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces,
            "launches": state.get("launches", {}).get(name),
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
