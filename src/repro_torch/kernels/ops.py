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

The SSD scan (:func:`ssd_scan`) trains through a third,
:class:`SSDIntra`: the intra-chunk kernel forward and an explicit plain
backward (:func:`repro_torch.kernels.ref.ssd_intra_bwd_ref`, fp32; the
reference has no SSD backward kernel: it trains SSM models on its jnp
path).  The inter-chunk recurrence around it is torch code that autograd
differentiates.

Each kernel wrapper counts its launches in an integer
(``<wrapper>.launches``, added to under a lock by
:func:`~repro_torch.kernels.build.count_launch`, so that two threads lose
none); :func:`launch_counts` reads them and :func:`reset_launch_counts`
sets them to 0, so a run can show that its main path went through the
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import build
from repro_torch.kernels import decode_attention as _dec
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import flash_attention_bwd as _fab
from repro_torch.kernels import paged_attention as _paged
from repro_torch.kernels import ref
from repro_torch.kernels import rmsnorm as _rms
from repro_torch.kernels import ssd_scan as _ssd

KERNELS = {
    "rmsnorm": _rms.rmsnorm_fwd,
    "flash_attention_fwd": _fa.flash_attention_fwd,
    "flash_attention_bwd": _fab.flash_attention_bwd,
    "decode_attention_fwd": _dec.decode_attention_fwd,
    "decode_attention_quant_fwd": _dec.decode_attention_quant_fwd,
    "paged_decode_attention_fwd": _paged.paged_decode_attention_fwd,
    "paged_decode_attention_quant_fwd":
        _paged.paged_decode_attention_quant_fwd,
    "ssd_intra_fwd": _ssd.ssd_intra_fwd,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        build.set_launch_count(fn, 0)


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


def paged_decode_attention(q, k_pool, v_pool, block_tables, lens):
    """q: (B, H, D); pools: (nblocks, bs, KV, D), the model's per-layer
    pool views, read in place; block_tables: (B, nb) int32; lens: (B,)
    int32 valid-row counts."""
    B, H, D = q.shape
    KV = k_pool.shape[2]
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    _paged.paged_decode_attention_fwd(
        q.unflatten(1, (KV, H // KV)), k_pool, v_pool, block_tables, lens,
        out=out.unflatten(1, (KV, H // KV)))
    return out


def paged_decode_attention_quant(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, lens):
    """Int8 paged decode.  q: (B, H, D); pools: (nblocks, bs, KV, D) int8
    and scale planes (nblocks, bs, KV) fp32, all read in place;
    block_tables: (B, nb) int32; lens: (B,) int32."""
    B, H, D = q.shape
    KV = k_pool.shape[2]
    out = torch.empty((B, H, D), dtype=q.dtype, device=q.device)
    _paged.paged_decode_attention_quant_fwd(
        q.unflatten(1, (KV, H // KV)), k_pool, v_pool, k_scale, v_scale,
        block_tables, lens, out=out.unflatten(1, (KV, H // KV)))
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


class SSDIntra(torch.autograd.Function):
    """The intra-chunk SSD pass under autograd: X (b, nc, q, h, p), dt (b,
    nc, q, h), A (h,), B, C (b, nc, q, n) -> (Y_diag, S_c, A_cs), the
    contract of :func:`repro_torch.kernels.ssd_scan.ssd_intra_fwd`.
    Forward: that wrapper (the kernel on CUDA, the plain version on the
    CPU); saved: the inputs and A_cs.  Backward:
    :func:`repro_torch.kernels.ref.ssd_intra_bwd_ref`, which never re-runs
    the forward.  Under remat the forward runs twice; the kernels sum in a
    fixed order (no atomics), so both runs give the same bits."""

    @staticmethod
    def forward(ctx, X, dt, A, B, C):
        Y_diag, S_c, A_cs = _ssd.ssd_intra_fwd(X, dt, A, B, C)
        ctx.save_for_backward(X, dt, A, B, C, A_cs)
        return Y_diag, S_c, A_cs

    @staticmethod
    def backward(ctx, dY, dS, dAcs):
        return ref.ssd_intra_bwd_ref(*ctx.saved_tensors, dY, dS, dAcs)


def ssd_scan(X, dt, A, B, C, chunk, initial_state=None):
    """Full SSD (counterpart of ``repro/kernels/ops.py::ssd_scan``): the
    intra-chunk kernel, then the inter-chunk recurrence (a loop over the
    ``nc`` chunks, the reference's ``lax.scan``) and the off-diagonal term
    in torch.

    X: (b, l, h, p)  dt: (b, l, h) fp32  A: (h,) fp32  B, C: (b, l, n).
    Returns (Y (b, l, h, p) in X's dtype, final_state (b, h, p, n) fp32):
    the contract of :func:`repro_torch.models.modules.ssd_chunked`.  The
    intra-chunk pass goes through :class:`SSDIntra` only where autograd
    needs its backward: the serving call stays one bare launch."""
    Xc, dtc, Bc, Cc = ref.ssd_chunks(X, dt, B, C, chunk)
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (Xc, dtc, A, Bc, Cc)):
        Y_diag, S_c, A_cs = SSDIntra.apply(Xc, dtc, A, Bc, Cc)
    else:
        Y_diag, S_c, A_cs = _ssd.ssd_intra_fwd(Xc, dtc, A, Bc, Cc)
    Y, final = ref.ssd_inter_chunk(Y_diag, S_c, A_cs, Cc, initial_state,
                                   X.shape[1])
    return Y.to(X.dtype), final
