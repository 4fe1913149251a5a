"""Time the port's decode, RMSNorm and SSD kernels with their inputs in and
out of the L2.

    python3 tools/decode_l2_bench.py [--src DIR] [--tag NAME] [--steps]
                                     [--only decode,rmsnorm,ssd]

Runs ``decode_attention_fwd``, ``paged_decode_attention_fwd`` and their
int8 variants ``decode_attention_quant_fwd`` and
``paged_decode_attention_quant_fwd`` of the ``repro_torch`` package under
``--src`` (by default this checkout's ``src/``) at ``chip_smoke.py``'s
bf16-query decode shapes, ``rmsnorm_fwd`` at the decode, prefill, SFT and
reward-step shapes, and ``ssd_intra_fwd`` at the Mamba2-370M and
Zamba2-1.2B admissions, the fixed path's b = 8, four chunks and a ragged
q, in bf16 and fp32, on inputs made from a fixed seed per row, so two
checkouts timed by this one script see the same inputs.  Each row is timed
twice with ``chip_smoke.py``'s timers:

* ``warm_ms``: ``time_ms``, back-to-back CUDA-graph replays on one set of
  inputs, so whatever of them fits in the L2 is read from there;
* ``cold_ms``: ``time_ms_cold``, the call rotated over copies of its
  inputs (K/V, x, or X/B/C) that add up to four L2s, so each call finds
  them evicted.

Dense fp rows also time one ``scaled_dot_product_attention`` call with
the bool mask both ways; RMSNorm rows ``F.rms_norm`` and ``x.clone()``
(``floor_ms``: a launch that reads and writes the same bytes); SSD rows
the plain version.  Each row's output is held to the plain version
(bf16, 2e-2; int8 of max |plain|; RMSNorm fp32 1e-4, bf16 1e-2 relative;
SSD Y 1e-4 fp32 / 2e-2 bf16 and S_c 1e-4 of max) and its bits are hashed
(``out_sha``), so two trees' outputs can be compared.  ``ssd fp32 hash``
prints the sha1 of Y, S_c and A_cs of the fp32 kernel on the numpy-seeded
case of ``tests/test_torch_cuda.py::test_ssd_intra_fp32_kernel_outputs_
unchanged``.  With ``--steps`` it also times the
OPT-1.3B decode step of ``chip_smoke.py``'s phase ``serve`` (16 slots,
random weights from seed 0) on the dense arena and the paged pool, bf16
and int8 KV, eager and as a CUDA-graph replay (``chip_smoke._step_timing``,
one JSON row each).  Any failure exits non-zero.
Prints one JSON object per row and, before them, the card's ``name,
power.limit``.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402  (puts ROOT / "src" on the path)

DENSE = ((16, 32, 1, 512, "opt-1.3b"), (16, 3, 3, 512, "smollm-135m"),
         (16, 32, 1, 300, "opt-1.3b"), (1, 32, 1, 2048, "opt-1.3b"))
PAGED = ((16, 32, 1, 1, "opt-1.3b serve"), (8, 32, 1, 257, "opt-1.3b ppo"),
         (16, 3, 3, 1, "smollm-135m"))
# int8 dense rows: (B, KV, G, S, lowest valid rows, model)
DENSE_INT8 = ((8, 32, 1, 512, 257, "opt-1.3b ppo"),
              (16, 32, 1, 512, 1, "opt-1.3b serve"),
              (16, 3, 3, 512, 1, "smollm-135m"))
D, BS, NB = 64, 16, 32
# rmsnorm rows: (R, D, dtype, label)
RMSNORM = ((16, 2048, "bf16", "opt-1.3b decode"),
           (512, 2048, "bf16", "opt-1.3b prefill"),
           (4096, 2048, "bf16", "opt-1.3b sft"),
           (8192, 1024, "bf16", "opt-350m reward"),
           (16, 576, "bf16", "smollm-135m decode"),
           (512, 576, "bf16", "smollm-135m prefill"),
           (16, 2048, "fp32", "opt-1.3b decode"),
           (512, 2048, "fp32", "opt-1.3b prefill"),
           (4096, 2048, "fp32", "opt-1.3b sft"))
# ssd rows: (label, b, nc, q, h, p, n)
SSD = (("mamba2-370m admission", 1, 1, 256, 32, 64, 128),
       ("zamba2-1.2b admission", 1, 1, 256, 64, 64, 64),
       ("mamba2-370m fixed path", 8, 1, 256, 32, 64, 128),
       ("mamba2-370m 1024 tokens", 1, 4, 256, 32, 64, 128),
       ("mamba2-370m ragged q", 1, 1, 137, 32, 64, 128))


def _sha(*ts):
    h = hashlib.sha1()
    for t in ts:
        h.update(t.float().cpu().numpy().tobytes())
    return h.hexdigest()


def _rmsnorm_rows(tag, failures):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.rmsnorm import rmsnorm_fwd
    for i, (R, D, dname, label) in enumerate(RMSNORM):
        dt = torch.bfloat16 if dname == "bf16" else torch.float32
        gen = torch.Generator(device="cuda").manual_seed(500 + i)
        x = cs._case_inputs(gen, (R, D), dt)
        w = (1.0 + 0.1 * cs._case_inputs(gen, (D,), torch.float32)).to(dt)
        out = rmsnorm_fwd(x, w, eps=1e-5)
        want = ref.rmsnorm_ref(x, w, 1e-5)
        err = cs._err(out, want, rel=dname == "bf16")
        tol = 1e-2 if dname == "bf16" else 1e-4
        eb = x.element_size()
        bnd = cs.bound(2 * R * D * eb + D * eb, 4 * R * D, "fp32")
        copies = [x.clone() for _ in range(cs.cold_copies(R * D * eb))]
        row = {"tag": tag, "kernel": "rmsnorm", "shape": f"{label} R={R} "
               f"D={D}", "dtype": dname, "max_err": err,
               "warm_ms": cs.time_ms(lambda: rmsnorm_fwd(x, w, eps=1e-5)),
               "cold_ms": cs.time_ms_cold([lambda c=c: rmsnorm_fwd(
                   c, w, eps=1e-5) for c in copies]),
               "copies": len(copies), "bound_ms": bnd[0],
               "floor_ms": cs.time_ms(lambda: x.clone()),
               "floor_cold_ms": cs.time_ms_cold([lambda c=c: c.clone()
                                                 for c in copies]),
               "library_ms": cs.time_ms(lambda: F.rms_norm(x, (D,), w,
                                                           1e-5)),
               "out_sha": _sha(out)}
        row["cold_gbs"] = bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S / (
            row["cold_ms"] * 1e-3) / 1e9
        print(json.dumps(row), flush=True)
        if err > tol:
            failures.append(f"rmsnorm {label} {dname}: err {err:.3g}")
        del copies


def _ssd_rows(tag, failures):
    import numpy as np
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssd_scan import ssd_intra_fwd
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    for i, (label, b, nc, q, h, p, n) in enumerate(SSD):
        for dname, dt in (("bf16", torch.bfloat16), ("fp32", torch.float32)):
            gen = torch.Generator(device="cuda").manual_seed(600 + i)
            X, dtv, A, B, C = cs._ssd_inputs(gen, b, nc, q, h, p, n, dt)
            y, s, acs = ssd_intra_fwd(X, dtv, A, B, C)
            yr, sr, _, ar = ref.ssd_intra_ref(X, dtv, A, B, C)
            ey, es = rel(y, yr), rel(s, sr)
            ok = (ey <= (2e-2 if dname == "bf16" else 1e-4) and es <= 1e-4
                  and torch.equal(acs, ar))
            wide = X._base if X._base is not None else X
            copies = [wide.clone() for _ in range(cs.cold_copies(
                wide.numel() * wide.element_size()))]
            views = [(c[..., :h * p].unflatten(-1, (h, p)),
                      c[..., h * p:h * p + n], c[..., h * p + n:])
                     for c in copies]
            bnd = cs.ssd_bound(b, nc, q, h, p, n, X.element_size(), dname)
            bnd32 = cs.ssd_bound(b, nc, q, h, p, n, X.element_size())
            row = {"tag": tag, "kernel": "ssd_intra_fwd",
                   "shape": f"{label} b={b} nc={nc} q={q} h={h} p={p} n={n}",
                   "dtype": dname, "err_y": ey, "err_s": es,
                   "warm_ms": cs.time_ms(lambda: ssd_intra_fwd(X, dtv, A, B,
                                                               C)),
                   "cold_ms": cs.time_ms_cold(
                       [lambda v=v: ssd_intra_fwd(v[0], dtv, A, v[1], v[2])
                        for v in views]),
                   "copies": len(copies),
                   "plain_ms": cs.time_ms(lambda: ref.ssd_intra_ref(
                       X, dtv, A, B, C), inner=5, repeats=5),
                   "bound_ms": bnd[0], "bound_by": bnd[1],
                   "bound_fp32_ms": bnd32[0], "out_sha": _sha(y, s, acs)}
            print(json.dumps(row), flush=True)
            if not ok:
                failures.append(f"ssd {label} {dname}: errors {ey:.3g} "
                                f"{es:.3g}")
            del copies, views
    # the fp32 kernel's output bits on tests/test_torch_cuda.py's
    # numpy-seeded case
    rng = np.random.default_rng(2024)
    b, nc, q, h, p, n = 1, 2, 256, 32, 64, 128
    mk = lambda shape, scale=0.5: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).cuda()
    X, B, C = mk((b, nc, q, h, p)), mk((b, nc, q, n)), mk((b, nc, q, n))
    dtv = torch.nn.functional.softplus(mk((b, nc, q, h), 1.0))
    A = -torch.exp(mk((h,), 0.3))
    y, s, acs = ssd_intra_fwd(X, dtv, A, B, C)
    torch.cuda.synchronize()
    print(json.dumps({"tag": tag, "kernel": "ssd fp32 hash", **{
        k: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()
        for k, t in (("y", y), ("s", s), ("acs", acs))}}), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a label for the rows")
    ap.add_argument("--steps", action="store_true",
                    help="also time the OPT-1.3B decode steps")
    ap.add_argument("--only", default="decode,rmsnorm,ssd",
                    help="comma-separated kernel families to time")
    args = ap.parse_args()
    only = set(args.only.split(","))
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode_l2_bench: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import (
        decode_attention_fwd, decode_attention_quant_fwd)
    from repro_torch.kernels.paged_attention import (
        paged_decode_attention_fwd, paged_decode_attention_quant_fwd)
    from repro_torch.models.modules import _kv_quant
    print(cs.nvidia_smi_line(), flush=True)
    print(f"# repro_torch from {Path(repro_torch.__file__).parent}; L2 "
          f"{cs.l2_bytes()} bytes", flush=True)

    bf16, failures = torch.bfloat16, []

    def emit(kind, label, err, bnd, warm, cold, n_copies, extra=None):
        row = {"tag": args.tag, "kernel": kind, "shape": label,
               "dtype": "bf16", "max_err": err, "warm_ms": warm,
               "cold_ms": cold, "copies": n_copies, "bound_ms": bnd[0],
               "cold_gbs": bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S
               / (cold * 1e-3) / 1e9, **(extra or {})}
        print(json.dumps(row), flush=True)
        if err > 2e-2:
            failures.append(f"{kind} {label}: err {err:.3g} > 2e-2")

    if "decode" in only:
        for i, (B, KV, G, S, model) in enumerate(DENSE):
            gen = torch.Generator(device="cuda").manual_seed(100 + i)
            q = cs._case_inputs(gen, (B, KV, G, D), bf16)
            k = cs._case_inputs(gen, (B, S, KV, D), bf16).transpose(1, 2)
            v = cs._case_inputs(gen, (B, S, KV, D), bf16).transpose(1, 2)
            valid, _ = cs._decode_valid(gen, B, S, 1)
            out = decode_attention_fwd(q, k, v, valid)
            err = cs._err(out, ref.decode_attention_ref(q, k, v, valid),
                          rel=False)
            need = int(valid.sum())
            bnd = cs.bound(2 * B * KV * G * D * 2 + B * S + 2 * need * KV * D * 2,
                           4 * KV * G * D * need, "bf16")
            copies = [(k.clone(), v.clone()) for _ in range(
                cs.cold_copies(bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S))]
            qs, mask = q.flatten(1, 2)[:, :, None], valid[:, None, None, :]
            sdpa = lambda kc, vc: F.scaled_dot_product_attention(
                qs, kc, vc, attn_mask=mask, enable_gqa=G > 1)
            emit("decode_attention_fwd",
                 f"{model} B={B} KV={KV} G={G} S={S} ragged", err, bnd,
                 cs.time_ms(lambda: decode_attention_fwd(q, k, v, valid)),
                 cs.time_ms_cold([lambda kc=kc, vc=vc: decode_attention_fwd(
                     q, kc, vc, valid) for kc, vc in copies]), len(copies),
                 {"sdpa_warm_ms": cs.time_ms(lambda: sdpa(k, v)),
                  "sdpa_cold_ms": cs.time_ms_cold(
                      [lambda kc=kc, vc=vc: sdpa(kc, vc) for kc, vc in copies]),
                  "out_sha": _sha(out)})
            del copies

        for i, (B, KV, G, S, lo, model) in enumerate(DENSE_INT8):
            gen = torch.Generator(device="cuda").manual_seed(300 + i)
            q = cs._case_inputs(gen, (B, KV, G, D), bf16)
            k, ks = _kv_quant(cs._case_inputs(gen, (B, S, KV, D), bf16))
            v, vs = _kv_quant(cs._case_inputs(gen, (B, S, KV, D), bf16))
            kv = tuple(t.transpose(1, 2) for t in (k, v, ks, vs))
            valid, _ = cs._decode_valid(gen, B, S, lo)
            out = decode_attention_quant_fwd(q, *kv, valid)
            want = ref.decode_attention_quant_ref(q, *kv, valid)
            err = cs._err(out, want, rel=False) / float(want.float().abs().max())
            need = int(valid.sum())
            bnd = cs.bound(2 * B * KV * G * D * 2 + B * S
                           + need * KV * (2 * D + 8), 4 * KV * G * D * need,
                           "bf16")
            copies = [tuple(t.clone() for t in kv) for _ in range(
                cs.cold_copies(bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S))]
            emit("decode_attention_quant_fwd",
                 f"{model} B={B} KV={KV} G={G} S={S} valid {lo}-{S}", err, bnd,
                 cs.time_ms(lambda: decode_attention_quant_fwd(q, *kv, valid)),
                 cs.time_ms_cold([lambda c=c: decode_attention_quant_fwd(
                     q, *c, valid) for c in copies]), len(copies),
                 {"out_sha": _sha(out)})
            del copies

        for quant in (False, True):
            name = ("paged_decode_attention_quant_fwd" if quant
                    else "paged_decode_attention_fwd")
            run = (paged_decode_attention_quant_fwd if quant
                   else paged_decode_attention_fwd)
            plain = (ref.paged_decode_attention_quant_ref if quant
                     else ref.paged_decode_attention_ref)
            for i, (B, KV, G, lo, model) in enumerate(PAGED):
                gen = torch.Generator(device="cuda").manual_seed(
                    (400 if quant else 200) + i)
                q, k, v, sc, tables, lens = cs._paged_case(gen, B, KV, G, D, BS,
                                                           NB, lo, bf16, quant)
                out = run(q, k, v, *sc, tables, lens)
                want = plain(q, k, v, *sc, tables, lens)
                err = cs._err(out, want, rel=False)
                if quant:
                    err /= float(want.float().abs().max())
                need = int(lens.sum())
                row_bytes = 2 * D + 8 if quant else 2 * D * 2
                bnd = cs.bound(2 * B * KV * G * D * 2 + 4 * B * (NB + 1)
                               + need * KV * row_bytes, 4 * KV * G * D * need,
                               "bf16")
                copies = [tuple(t.clone() for t in (k, v, *sc)) for _ in range(
                    cs.cold_copies(bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S))]
                emit(name,
                     f"{model} B={B} KV={KV} G={G} bs={BS} nb={NB} lens {lo}-"
                     f"{NB * BS}", err, bnd,
                     cs.time_ms(lambda: run(q, k, v, *sc, tables, lens)),
                     cs.time_ms_cold([lambda c=c: run(q, *c, tables, lens)
                                      for c in copies]),
                     len(copies), {"out_sha": _sha(out)})
                del copies

    if "rmsnorm" in only:
        _rmsnorm_rows(args.tag, failures)
    if "ssd" in only:
        _ssd_rows(args.tag, failures)

    if args.steps:
        state = {}
        for paged in (False, True):
            for quant in (False, True):
                cs._step_timing(paged, quant, state)
                key = cs._step_key(paged, quant)
                print(json.dumps({"tag": args.tag, "step": key,
                                  **state[key]}), flush=True)

    if failures:
        print("decode_l2_bench: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
