"""Time the port's fp decode kernels with their inputs in and out of the L2.

    python3 tools/decode_l2_bench.py [--src DIR] [--tag NAME]

Runs ``decode_attention_fwd`` and ``paged_decode_attention_fwd`` of the
``repro_torch`` package under ``--src`` (by default this checkout's
``src/``) at ``chip_smoke.py``'s bf16 decode shapes, on inputs made from a
fixed seed per row, so two checkouts timed by this one script see the same
inputs.  Each row is timed twice with ``chip_smoke.py``'s timers:

* ``warm_ms``: ``time_ms``, back-to-back CUDA-graph replays on one set of
  inputs, so whatever of them fits in the L2 is read from there;
* ``cold_ms``: ``time_ms_cold``, the call rotated over copies of its K/V
  that add up to four L2s, so each call finds its rows evicted.

Dense rows also time one ``scaled_dot_product_attention`` call with the
bool mask both ways.  Each row's output is held to the plain version
(bf16, 2e-2); any failure exits non-zero.  Prints one JSON object per row
and, before them, the card's ``name, power.limit``.  Needs a CUDA card.
"""
from __future__ import annotations

import argparse
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
D, BS, NB = 64, 16, 32


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a label for the rows")
    args = ap.parse_args()
    sys.path.insert(0, str(Path(args.src).resolve()))

    import torch
    import torch.nn.functional as F
    if not torch.cuda.is_available():
        print("decode_l2_bench: CUDA is not available", file=sys.stderr)
        return 1
    import repro_torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention_fwd
    from repro_torch.kernels.paged_attention import paged_decode_attention_fwd
    print(cs.nvidia_smi_line(), flush=True)
    print(f"# repro_torch from {Path(repro_torch.__file__).parent}; L2 "
          f"{cs.l2_bytes()} bytes", flush=True)

    bf16, failures = torch.bfloat16, []

    def emit(kind, label, err, bnd, warm, cold, n_copies, extra=None):
        row = {"tag": args.tag, "kernel": kind, "shape": label,
               "dtype": "bf16", "max_abs_err": err, "warm_ms": warm,
               "cold_ms": cold, "copies": n_copies, "bound_ms": bnd[0],
               "cold_gbs": bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S
               / (cold * 1e-3) / 1e9, **(extra or {})}
        print(json.dumps(row), flush=True)
        if err > 2e-2:
            failures.append(f"{kind} {label}: err {err:.3g} > 2e-2")

    for i, (B, KV, G, S, model) in enumerate(DENSE):
        gen = torch.Generator(device="cuda").manual_seed(100 + i)
        q = cs._case_inputs(gen, (B, KV, G, D), bf16)
        k = cs._case_inputs(gen, (B, S, KV, D), bf16).transpose(1, 2)
        v = cs._case_inputs(gen, (B, S, KV, D), bf16).transpose(1, 2)
        valid, _ = cs._decode_valid(gen, B, S, 1)
        err = cs._err(decode_attention_fwd(q, k, v, valid),
                      ref.decode_attention_ref(q, k, v, valid), rel=False)
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
                  [lambda kc=kc, vc=vc: sdpa(kc, vc) for kc, vc in copies])})
        del copies

    for i, (B, KV, G, lo, model) in enumerate(PAGED):
        gen = torch.Generator(device="cuda").manual_seed(200 + i)
        q, k, v, _, tables, lens = cs._paged_case(gen, B, KV, G, D, BS, NB,
                                                  lo, bf16, False)
        err = cs._err(paged_decode_attention_fwd(q, k, v, tables, lens),
                      ref.paged_decode_attention_ref(q, k, v, tables, lens),
                      rel=False)
        need = int(lens.sum())
        bnd = cs.bound(2 * B * KV * G * D * 2 + 4 * B * (NB + 1)
                       + need * KV * 2 * D * 2, 4 * KV * G * D * need, "bf16")
        copies = [(k.clone(), v.clone()) for _ in range(
            cs.cold_copies(bnd[0] * 1e-3 * cs.HBM_BYTES_PER_S))]
        emit("paged_decode_attention_fwd",
             f"{model} B={B} KV={KV} G={G} bs={BS} nb={NB} lens {lo}-"
             f"{NB * BS}", err, bnd,
             cs.time_ms(lambda: paged_decode_attention_fwd(q, k, v, tables,
                                                           lens)),
             cs.time_ms_cold([lambda kc=kc, vc=vc: paged_decode_attention_fwd(
                 q, kc, vc, tables, lens) for kc, vc in copies]),
             len(copies))
        del copies

    if failures:
        print("decode_l2_bench: " + "; ".join(failures), file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
