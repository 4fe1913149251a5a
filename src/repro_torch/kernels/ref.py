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


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, KV, G, Lq, D); k, v: (B, KV, Lk, D) -> (B, KV, G, Lq, D).
    Queries align to the end of the keys: qpos = arange(Lq) + Lk - Lq."""
    Lq, D = q.shape[3], q.shape[4]
    Lk = k.shape[2]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float()) / math.sqrt(D)
    qpos = torch.arange(Lq, device=q.device) + (Lk - Lq)
    kpos = torch.arange(Lk, device=q.device)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q: (B, KV, G, D); caches: (B, KV, S, D); valid: (B, S) bool."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(),
                     k_cache.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def rmsnorm_ref(x, w, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)
