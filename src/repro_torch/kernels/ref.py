"""Plain PyTorch versions of the ported kernels, in the kernels' grouped
layouts (counterparts of ``repro/kernels/ref.py``).

Each is the same function as its CUDA kernel, written as ordinary tensor
code: the kernel wrappers take them for CPU tensors, the CPU tests hold
them to the reference's oracles, and ``chip_smoke.py`` holds each kernel to
them on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(Lq, Lk, causal, window, device):
    """(Lq, Lk) bool: query i sits at position i + Lk - Lq."""
    qpos = torch.arange(Lq, device=device) + (Lk - Lq)
    kpos = torch.arange(Lk, device=device)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def _scores(q, k, causal, window):
    """Masked, scaled fp32 scores (B, KV, G, Lq, Lk) and the mask."""
    Lq, D = q.shape[3], q.shape[4]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float()) / math.sqrt(D)
    mask = _mask(Lq, k.shape[2], causal, window, q.device)
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, KV, G, Lq, D); k, v: (B, KV, Lk, D) -> (B, KV, G, Lq, D).
    Queries align to the end of the keys: qpos = arange(Lq) + Lk - Lq."""
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=None):
    """The forward's log-sum-exp of the masked scaled scores,
    (B, KV, G, Lq) fp32: ``m + log(l)`` of the online softmax."""
    s, _ = _scores(q, k, causal, window)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, do, lse, delta, *, causal=True,
                            window=None):
    """FlashAttention-2 backward from the saved ``lse`` and ``delta =
    rowsum(dO * O)`` (both (B, KV, G, Lq) fp32), the math of
    ``repro/kernels/flash_attention_bwd.py``: p = exp(s - lse), exactly 0
    where masked (an all-masked row's lse is taken as 0); ds = p (dp -
    delta) scale.  q, do: (B, KV, G, Lq, D); k, v: (B, KV, Lk, D).
    Returns (dq, dk, dv) in the dtypes of q, k, v; dk and dv sum over the
    G query heads of each KV group."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s, mask = _scores(q, k, causal, window)
    lse = lse.float()
    lse_safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
    do32 = do.float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do32)
    dp = torch.einsum("bkgqd,bksd->bkgqs", do32, v.float())
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps=1e-5):
    """Backward of :func:`rmsnorm_ref` in fp32: (dx in x's dtype, dw in
    w's dtype); x, dy: (R, D), w: (D,)."""
    x32, w32, dy32 = x.float(), w.float(), dy.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    dw = torch.sum(dy32 * xhat, dim=0)
    g = dy32 * w32
    dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(w.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q: (B, KV, G, D); caches: (B, KV, S, D); valid: (B, S) bool."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(),
                     k_cache.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale,
                               valid):
    """Decode over an int8 cache.  q: (B, KV, G, D) fp; caches: (B, KV, S,
    D) int8; scales: (B, KV, S) fp32; valid: (B, S) bool.  The scales
    multiply the score and probability matrices (the kernel's algebra),
    never a dequantized K/V copy."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(),
                     k_cache.float()) / math.sqrt(D)
    s = s * k_scale.float()[:, :, None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * v_scale.float()[:, :, None, :]
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def rmsnorm_ref(x, w, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
