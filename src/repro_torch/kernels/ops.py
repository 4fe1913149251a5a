"""Dispatch wrappers over the kernels (counterpart of ``repro/kernels/ops.py``).

These are the entry points the model layer calls when
``cfg.use_kernels``.  Each adapts the model's (B, L, H, D) layout to the
kernels' grouped (B, KV, G, ...) layout with views only (permutes and
splits of the head axis, never a copy), and dispatches on the device of
its tensors: a CPU tensor gets the kernel's plain version, a CUDA tensor
the kernel or an exception — there is no fallback.

Each kernel wrapper counts its launches in a plain integer
(``<wrapper>.launches``); :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import rmsnorm as _rms

KERNELS = {
    "rmsnorm": _rms.rmsnorm_fwd,
    "flash_attention_fwd": _fa.flash_attention_fwd,
    "decode_attention_fwd": _dec.decode_attention_fwd,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, L, H, D); k, v: (B, Lk, KV, D) -> (B, L, H, D)."""
    B, Lq, H, D = q.shape
    KV = k.shape[2]
    G = H // KV
    out = torch.empty((B, Lq, H, D), dtype=q.dtype, device=q.device)
    # (B, L, KV*G, D) -> (B, KV, G, L, D) views of the same storage
    q5 = q.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    o5 = out.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    _fa.flash_attention_fwd(q5, k.transpose(1, 2), v.transpose(1, 2),
                            causal=causal, window=window, out=o5)
    return out


def decode_attention(q, k_cache, v_cache, valid):
    """q: (B, H, D); caches: (B, S, KV, D), read in place; valid: (B, S)."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    _dec.decode_attention_fwd(q.unflatten(1, (KV, G)),
                              k_cache.transpose(1, 2),
                              v_cache.transpose(1, 2), valid,
                              out=out.unflatten(1, (KV, G)))
    return out


def rmsnorm(x, w, *, eps=1e-5):
    """x: (..., D); w: (D,)."""
    shape = x.shape
    out = _rms.rmsnorm_fwd(x.reshape(-1, shape[-1]), w, eps=eps)
    return out.reshape(shape)
