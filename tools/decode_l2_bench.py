"""Time the port's decode kernels with their inputs in and out of the L2.

    python3 tools/decode_l2_bench.py [--src DIR] [--tag NAME] [--steps]

Runs ``decode_attention_fwd``, ``paged_decode_attention_fwd`` and their
int8 variants ``decode_attention_quant_fwd`` and
``paged_decode_attention_quant_fwd`` of the ``repro_torch`` package under
``--src`` (by default this checkout's ``src/``) at ``chip_smoke.py``'s
bf16-query decode shapes, on inputs made from a fixed seed per row, so two
checkouts timed by this one script see the same inputs.  Each row is timed
twice with ``chip_smoke.py``'s timers:

* ``warm_ms``: ``time_ms``, back-to-back CUDA-graph replays on one set of
  inputs, so whatever of them fits in the L2 is read from there;
* ``cold_ms``: ``time_ms_cold``, the call rotated over copies of its K/V
  that add up to four L2s, so each call finds its rows evicted.

Dense fp rows also time one ``scaled_dot_product_attention`` call with
the bool mask both ways.  Each row's output is held to the plain version
(bf16, 2e-2; int8 of max |plain|) and its bits are hashed (``out_sha``),
so two trees' outputs can be compared.  With ``--steps`` it also times the
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the src/ directory whose repro_torch is timed")
    ap.add_argument("--tag", default="", help="a label for the rows")
    ap.add_argument("--steps", action="store_true",
                    help="also time the OPT-1.3B decode steps")
    args = ap.parse_args()
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

    def sha(out):
        return hashlib.sha1(out.float().cpu().numpy().tobytes()).hexdigest()

    def emit(kind, label, err, bnd, warm, cold, n_copies, extra=None):
        row = {"tag": args.tag, "kernel": kind, "shape": label,
               "dtype": "bf16", "max_err": err, "warm_ms": warm,
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
              "out_sha": sha(out)})
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
             {"out_sha": sha(out)})
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
                 len(copies), {"out_sha": sha(out)})
            del copies

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
