"""Dispatch wrappers over the kernels (counterpart of ``repro/kernels/ops.py``).

These are the entry points the model layer calls when
``cfg.use_kernels``.  Each adapts the model's (B, L, H, D) layout to the
kernels' grouped (B, KV, G, ...) layout with views only (permutes and
splits of the head axis, never a copy), and dispatches on the device of
its tensors: a CPU tensor gets the kernel's plain version, a CUDA tensor
the kernel or an exception — there is no fallback.

Training goes through two ``torch.autograd.Function``s that take the
model layout: :class:`FlashAttention` (the counterpart of the reference's
``_flash_pallas`` custom VJP: the forward kernel writes the LSE, the
backward kernels recompute the probabilities from it) and
:class:`RMSNorm` (the forward kernel with a plain PyTorch backward: the
reference has no RMSNorm backward kernel either, XLA derives it).

Each kernel wrapper counts its launches in a plain integer
(``<wrapper>.launches``); :func:`launch_counts` reads them and
:func:`reset_launch_counts` sets them to 0, so a run can show that its
main path went through the kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms

KERNELS = {
    "rmsnorm": _rms.rmsnorm_fwd,
    "flash_attention_fwd": _fa.flash_attention_fwd,
    "flash_attention_bwd": _fab.flash_attention_bwd,
    "decode_attention_fwd": _dec.decode_attention_fwd,
    "decode_attention_quant_fwd": _dec.decode_attention_quant_fwd,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0


def _grouped(x, KV):
    """(B, L, KV*G, D) -> (B, KV, G, L, D), a view of the same storage."""
    return x.unflatten(2, (KV, x.shape[2] // KV)).permute(0, 2, 3, 1, 4)


def flash_attention(q, k, v, *, causal=True, window=None):
    """q: (B, L, H, D); k, v: (B, Lk, KV, D) -> (B, L, H, D).  Forward
    only (serving); training goes through :class:`FlashAttention`."""
    KV = k.shape[2]
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _fa.flash_attention_fwd(_grouped(q, KV), k.transpose(1, 2),
                            v.transpose(1, 2), causal=causal, window=window,
                            out=_grouped(out, KV))
    return out


class FlashAttention(torch.autograd.Function):
    """Differentiable attention in the model layout: q (B, L, H, D), k, v
    (B, Lk, KV, D) -> (B, L, H, D).  Forward: the kernel, which also
    writes the LSE (B, KV, G, L); saved: q, k, v, out, lse.  Backward:
    delta = rowsum(dO * O) in fp32 (a torch op, as the reference computes
    it outside its kernel), then the dK/dV and dQ kernels; the gradients
    come back in the model layout."""

    @staticmethod
    def forward(ctx, q, k, v, causal=True, window=None):
        B, Lq, H, D = q.shape
        KV = k.shape[2]
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        lse = torch.empty((B, KV, H // KV, Lq), dtype=torch.float32,
                          device=q.device)
        _fa.flash_attention_fwd(_grouped(q, KV), k.transpose(1, 2),
                                v.transpose(1, 2), causal=causal,
                                window=window, out=_grouped(out, KV),
                                lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        KV = k.shape[2]
        if dout.stride(-1) != 1:
            dout = dout.contiguous()
        delta = torch.sum(dout.float() * out.float(), dim=-1)   # (B, L, H)
        delta = delta.unflatten(2, (KV, -1)).permute(0, 2, 3, 1).contiguous()
        dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
        dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
        dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
        _fab.flash_attention_bwd(
            _grouped(q, KV), k.transpose(1, 2), v.transpose(1, 2),
            _grouped(dout, KV), lse, delta, causal=ctx.causal,
            window=ctx.window, dq=_grouped(dq, KV), dk=dk.transpose(1, 2),
            dv=dv.transpose(1, 2))
        return dq, dk, dv, None, None


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


def decode_attention_quant(q, k_cache, v_cache, k_scale, v_scale, valid):
    """Int8-KV decode.  q: (B, H, D); caches: (B, S, KV, D) int8 and
    scales (B, S, KV) fp32, all read in place; valid: (B, S)."""
    B, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    _dec.decode_attention_quant_fwd(
        q.unflatten(1, (KV, G)), k_cache.transpose(1, 2),
        v_cache.transpose(1, 2), k_scale.transpose(1, 2),
        v_scale.transpose(1, 2), valid, out=out.unflatten(1, (KV, G)))
    return out


class RMSNorm(torch.autograd.Function):
    """x (..., D), w (D,): the forward kernel, and a plain PyTorch backward
    (:func:`repro_torch.kernels.ref.rmsnorm_bwd_ref`, fp32)."""

    @staticmethod
    def forward(ctx, x, w, eps=1e-5):
        x2d = x.reshape(-1, x.shape[-1])
        out = _rms.rmsnorm_fwd(x2d, w, eps=eps)
        ctx.save_for_backward(x2d, w)
        ctx.eps = eps
        return out.reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        x2d, w = ctx.saved_tensors
        dx, dw = ref.rmsnorm_bwd_ref(x2d, w, dy.reshape(x2d.shape), ctx.eps)
        return dx.reshape(dy.shape), dw, None


def rmsnorm(x, w, *, eps=1e-5):
    """x: (..., D); w: (D,).  Through :class:`RMSNorm` only where autograd
    needs its backward: the serving call stays a bare kernel launch."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return RMSNorm.apply(x, w, eps)
    shape = x.shape
    out = _rms.rmsnorm_fwd(x.reshape(-1, shape[-1]), w, eps=eps)
    return out.reshape(shape)
