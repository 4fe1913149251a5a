"""Model primitives of the dense decoder (counterpart of
``repro/models/modules.py``): parameter specs, RMSNorm, RoPE, GQA attention
(qk-norm, sliding window, ring-buffer cache) and the SwiGLU MLP, for the
serving and the training paths.

Parameters are nested dicts/tuples of tensors whose structure comes from
``ParamSpec`` trees, the same paths as the reference's pytrees, so weights
move between the packages through numpy (``models/convert.py``).

Attention is blockwise with an online softmax (the full L x L score matrix
is never built, forward or backward).  With ``cfg.use_kernels`` RMSNorm
and attention dispatch to ``repro_torch.kernels.ops``: the CUDA kernels on
the card, their plain versions on the CPU; in ``full`` mode (training)
attention goes through the differentiable ``ops.FlashAttention``.  Without
it the model runs its own plain code below, the port of the reference's
jnp path.

The reference's sharding helpers (``wgather``, ``constrain_batch``,
``opt_barrier``) are no-ops on this single-device path and are dropped.
The dense int8 KV cache (``cfg.kv_quant``: int8 K/V rows plus fp32
per-row scale planes) is ported; the paged branch of :func:`attn_apply` and
an int8 prefix history are not yet, and raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# ===================================================================== #
# Trees (nested dicts / tuples / lists with tensor or ParamSpec leaves)
# ===================================================================== #
def tree_map(fn, tree, *rest, is_leaf=None):
    """Map ``fn`` over the leaves of ``tree`` (and the matching leaves of
    ``rest``), keeping the dict/tuple/list/NamedTuple structure."""
    if is_leaf is not None and is_leaf(tree):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest),
                            is_leaf=is_leaf) for k in tree}
    if isinstance(tree, (tuple, list)):
        kids = [tree_map(fn, t, *(r[i] for r in rest), is_leaf=is_leaf)
                for i, t in enumerate(tree)]
        if hasattr(tree, "_fields"):            # NamedTuple: fields by position
            return type(tree)(*kids)
        return type(tree)(kids)
    return fn(tree, *rest)


def tree_leaves(tree, is_leaf=None) -> list:
    out = []
    tree_map(lambda x: out.append(x), tree, is_leaf=is_leaf)
    return out


def tree_unflatten(tree, leaves, is_leaf=None):
    """``tree``'s structure with ``leaves`` (in :func:`tree_leaves` order)
    in place of its leaves."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree, is_leaf=is_leaf)


# ===================================================================== #
# Param specs
# ===================================================================== #
@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    axes: tuple              # logical axis names, None = never sharded
    init: str = "normal"     # normal | zeros | ones
    scale: float = 1.0       # multiplier on 1/sqrt(fan_in)


def _is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def materialize(spec: ParamSpec, generator: torch.Generator,
                dtype: torch.dtype) -> torch.Tensor:
    """One parameter on ``generator``'s device: zeros, ones, or normal with
    std ``scale / sqrt(fan_in)`` (fan_in excludes a leading layers axis)."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    start = 1 if (spec.axes and spec.axes[0] == "layers") else 0
    shp = spec.shape[start:]
    fan_in = shp[0] if len(shp) == 1 else int(np.prod(shp[:-1]))
    std = spec.scale / np.sqrt(max(fan_in, 1))
    x = torch.randn(spec.shape, generator=generator, dtype=torch.float32,
                    device=dev)
    return (x * std).to(dtype)


def init_tree(specs, generator: torch.Generator, dtype: torch.dtype):
    """Materialize a tree of ParamSpec, drawing the leaves one after another
    from ``generator`` (the reference splits one key per leaf; the two
    frameworks' random bits differ anyway, so weights that must match are
    carried across with ``models/convert.py``)."""
    return tree_map(lambda s: materialize(s, generator, dtype), specs,
                    is_leaf=_is_spec)


# ===================================================================== #
# Norms
# ===================================================================== #
def rmsnorm(x, weight, eps: float = 1e-5, use_kernels: bool = False):
    if use_kernels and x.ndim >= 2:
        from repro_torch.kernels import ops as kops
        return kops.rmsnorm(x, weight, eps=eps)
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)


# ===================================================================== #
# RoPE
# ===================================================================== #
def rope_freqs(head_dim: int, theta: float, device=None):
    """1 / theta^(2i / head_dim) in float64, built on ``device`` (a copy
    from host memory would synchronize the stream on every call)."""
    exps = torch.arange(0, head_dim, 2, dtype=torch.float64,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def rope_cos_sin(positions, head_dim: int, theta: float):
    """cos and sin of the rotary angles, (..., L, head_dim / 2) fp32.  The
    forward computes them once and shares them across layers."""
    inv = rope_freqs(head_dim, theta, positions.device).float()
    ang = positions.float()[..., None] * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x, positions, theta: float, cos_sin=None):
    """x: (..., L, H, D) or (..., L, D); positions: (..., L).  Rotates the
    interleaved pairs (x[..., ::2], x[..., 1::2]), as the reference does.
    ``cos_sin`` is :func:`rope_cos_sin` of ``positions``, when the caller
    has it already."""
    cos, sin = cos_sin or rope_cos_sin(positions, x.shape[-1], theta)
    if x.ndim == cos.ndim + 1:                               # heads axis
        cos, sin = cos[..., None, :], sin[..., None, :]
    x1, x2 = x[..., ::2].float(), x[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(x.shape)
    return out.to(x.dtype)


# ===================================================================== #
# Flash attention (plain, block-wise online softmax, recompute backward)
#
# The backward recomputes the probabilities block by block from the saved
# log-sum-exp (FlashAttention-2 style), the port of the reference's custom
# VJP ``_flash`` / ``_flash_bwd``: left to autograd, the loops below would
# keep every (q_block, k_block) score tile alive until the backward.
# ===================================================================== #
def _tile_mask(qpos, kpos, causal, window):
    mask = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool,
                      device=qpos.device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask                                    # (q_block, k_block)


def flash_attention(q, k, v, *, causal=True, window=None, q_block=512,
                    k_block=1024, qpos0=0):
    """Memory-efficient attention.

    q: (B, Lq, H, D); k, v: (B, Lk, KV, D) with H = KV * G.
    Never materializes (Lq, Lk): walks KV blocks with an online softmax,
    forward and backward.  ``qpos0`` offsets query positions (prefill
    continuation); ``window`` applies sliding-window masking.  The last
    block of each axis is simply shorter, so no block size has to divide
    the lengths.
    """
    Lq, Lk = q.shape[1], k.shape[1]
    return _Flash.apply(q, k, v, bool(causal), window, min(q_block, Lq),
                        min(k_block, Lk), int(qpos0))


def _flash_fwd_impl(q, k, v, causal, window, qb, kb, qpos0):
    """Returns (out (B, Lq, H, D), lse (B, KV, G, Lq) fp32)."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q5 = q.reshape(B, Lq, KV, G, D)
    outs, lses = [], []
    for q0 in range(0, Lq, qb):
        qt = q5[:, q0:q0 + qb].float()
        nq = qt.shape[1]
        qpos = qpos0 + q0 + torch.arange(nq, device=dev)
        m = torch.full((B, KV, G, nq), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros_like(m)
        acc = torch.zeros((B, KV, G, nq, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Lk, kb):
            kt, vt = k[:, k0:k0 + kb], v[:, k0:k0 + kb]
            kpos = k0 + torch.arange(kt.shape[1], device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qt, kt.float()) * scale
            s = torch.where(_tile_mask(qpos, kpos, causal, window), s,
                            NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(m - m_new)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(vt.dtype).float(), vt.float())
            m = m_new
        outs.append(acc / torch.clamp(l, min=1e-20)[..., None])
        lses.append(m + torch.log(torch.clamp(l, min=1e-20)))
    out = torch.cat(outs, dim=3)                   # (B, KV, G, Lq, D)
    out = out.permute(0, 3, 1, 2, 4).reshape(B, Lq, H, D).to(q.dtype)
    return out, torch.cat(lses, dim=3)


def _flash_bwd_impl(q, k, v, out, lse, g, causal, window, qb, kb, qpos0):
    """(dq, dk, dv) from the saved lse, block by block (the reference's
    ``_flash_bwd``): p = exp(s - lse), exactly 0 where masked."""
    B, Lq, H, D = q.shape
    Lk, KV = k.shape[1], k.shape[2]
    G = H // KV
    scale = 1.0 / math.sqrt(D)
    dev = q.device
    q5 = q.reshape(B, Lq, KV, G, D)
    g5 = g.reshape(B, Lq, KV, G, D)
    delta = torch.sum(g5.float() * out.reshape(B, Lq, KV, G, D).float(),
                      dim=-1).permute(0, 2, 3, 1)  # (B, KV, G, Lq)
    lse_safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    dk = torch.zeros((B, Lk, KV, D), dtype=torch.float32, device=dev)
    dv = torch.zeros_like(dk)
    dqs = []
    for q0 in range(0, Lq, qb):
        qt = q5[:, q0:q0 + qb].float()
        gt = g5[:, q0:q0 + qb].float()
        nq = qt.shape[1]
        qpos = qpos0 + q0 + torch.arange(nq, device=dev)
        ls = lse_safe[..., q0:q0 + nq, None]
        dl = delta[..., q0:q0 + nq, None]
        dq = torch.zeros((B, nq, KV, G, D), dtype=torch.float32, device=dev)
        for k0 in range(0, Lk, kb):
            kt, vt = k[:, k0:k0 + kb].float(), v[:, k0:k0 + kb].float()
            kpos = k0 + torch.arange(kt.shape[1], device=dev)
            s = torch.einsum("bqkgd,bskd->bkgqs", qt, kt) * scale
            p = torch.where(_tile_mask(qpos, kpos, causal, window),
                            torch.exp(s - ls), 0.0)
            dv[:, k0:k0 + kb] += torch.einsum("bkgqs,bqkgd->bskd", p, gt)
            dp = torch.einsum("bqkgd,bskd->bkgqs", gt, vt)
            ds = p * (dp - dl) * scale
            dq += torch.einsum("bkgqs,bskd->bqkgd", ds, kt)
            dk[:, k0:k0 + kb] += torch.einsum("bkgqs,bqkgd->bskd", ds, qt)
        dqs.append(dq)
    dq = torch.cat(dqs, dim=1).reshape(B, Lq, H, D)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class _Flash(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, causal, window, qb, kb, qpos0):
        out, lse = _flash_fwd_impl(q, k, v, causal, window, qb, kb, qpos0)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.meta = (causal, window, qb, kb, qpos0)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, g, *ctx.meta)
        return dq, dk, dv, None, None, None, None, None


def decode_attention(q, k_cache, v_cache, valid_mask, use_kernels=False):
    """Single-token attention over a (possibly ring-buffer) KV cache.

    q: (B, H, D); k_cache/v_cache: (B, S, KV, D); valid_mask: (B, S) bool.
    Returns (B, H, D).  RoPE is pre-applied to cached keys, so slot order
    inside the ring buffer is irrelevant (softmax is order-invariant).
    """
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.decode_attention(q, k_cache, v_cache, valid_mask)
    B, H, D = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qs = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qs.float(),
                     k_cache.float()) / math.sqrt(D)
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p.to(v_cache.dtype).float(),
                     v_cache.float())
    return o.reshape(B, H, D).to(q.dtype)


def _kv_quant(x):
    """absmax int8 quantization over the head dim.
    x: (..., hd) -> (int8 (..., hd), fp32 scale (...,)).

    The scale is *floored* at 1e-8 (a guard for all-zero rows), not
    inflated by an additive epsilon, as in the reference; ``torch.round``
    rounds half to even, like ``jnp.round``."""
    x32 = x.float()
    scale = torch.clamp(x32.abs().amax(dim=-1) / 127.0, min=1e-8)
    xi = torch.clamp(torch.round(x32 / scale[..., None]), -127, 127)
    return xi.to(torch.int8), scale


def decode_attention_quant(q, k_i8, v_i8, k_scale, v_scale, valid_mask,
                           use_kernels=False):
    """Single-token attention over an int8 KV cache.  The per-row scales
    multiply the score and probability matrices, never a dequantized copy
    of the cache (the probabilities stay fp32: unlike
    :func:`decode_attention`, they are not cast to the cache dtype).

    q: (B, H, D); k_i8/v_i8: (B, S, KV, D) int8; scales: (B, S, KV) fp32;
    valid_mask: (B, S) bool.  Returns (B, H, D)."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.decode_attention_quant(q, k_i8, v_i8, k_scale, v_scale,
                                           valid_mask)
    B, H, D = q.shape
    KV = k_i8.shape[2]
    G = H // KV
    qs = q.reshape(B, KV, G, D)
    s = torch.einsum("bkgd,bskd->bkgs", qs.float(),
                     k_i8.float()) / math.sqrt(D)
    s = s * k_scale.permute(0, 2, 1)[:, :, None, :]          # (B,KV,1,S)
    s = torch.where(valid_mask[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    pv = p * v_scale.permute(0, 2, 1)[:, :, None, :]
    o = torch.einsum("bkgs,bskd->bkgd", pv, v_i8.float())
    return o.reshape(B, H, D).to(q.dtype)


# ===================================================================== #
# GQA attention layer (qk-norm, sliding window, ring-buffer cache)
# ===================================================================== #
def attn_specs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    s = {
        "wq": ParamSpec((D, H * hd), ("embed", "heads")),
        "wk": ParamSpec((D, KV * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((D, KV * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, D), ("heads", "embed")),
    }
    if cfg.qk_norm:
        s["q_norm"] = ParamSpec((hd,), (None,), "ones")
        s["k_norm"] = ParamSpec((hd,), (None,), "ones")
    return s


def attn_cache_shape(cfg: ModelConfig, batch: int, max_len: int,
                     window: Optional[int]):
    """Per-layer arena shapes; with ``cfg.kv_quant`` the int8 K/V rows
    carry fp32 ``k_scale``/``v_scale`` planes (batch, S, KV)."""
    S = max_len if window is None else min(window, max_len)
    out = dict(k=(batch, S, cfg.n_kv_heads, cfg.head_dim),
               v=(batch, S, cfg.n_kv_heads, cfg.head_dim))
    if cfg.kv_quant:
        out["k_scale"] = (batch, S, cfg.n_kv_heads)
        out["v_scale"] = (batch, S, cfg.n_kv_heads)
    return out


def attn_apply(cfg: ModelConfig, p, x, *, positions, mode, cache=None,
               window=None, block_tables=None, rope=None):
    """mode: 'full' (train / full prefill) | 'prefill' (also fills cache) |
    'decode' (x is (B,1,D), cache holds history).

    ``cache`` holds this layer's ``k``/``v`` arena views ``(B, S, KV, hd)``
    (int8 with fp32 ``k_scale``/``v_scale`` planes ``(B, S, KV)`` under
    ``cfg.kv_quant``).  Where the reference rebuilds the (donated) arena
    with ``.at[].set``, the port writes the new rows into it in place and
    returns the same dict.  A prefill cache may also carry a read-only
    history (``hk``/``hv``) that the current tokens attend to but never
    rewrite.  ``rope`` is :func:`rope_cos_sin` of ``positions`` when the
    caller shares it across layers."""
    if block_tables is not None:
        raise NotImplementedError("paged KV cache: not yet ported")
    B = x.shape[0]
    H, KV, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(B, -1, H, hd)
    k = (x @ p["wk"]).reshape(B, -1, KV, hd)
    v = (x @ p["wv"]).reshape(B, -1, KV, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.rms_eps)
        k = rmsnorm(k, p["k_norm"], cfg.rms_eps)
    rope = rope or rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)

    new_cache = None
    if mode == "decode":
        assert cache is not None
        S = cache["k"].shape[1]
        pos = positions[:, 0]                       # (B,)
        slot = pos % S                              # ring-buffer slot
        rows = torch.arange(B, device=x.device)
        n_valid = torch.clamp(pos + 1, max=S)
        valid = (torch.arange(S, device=x.device)[None, :]
                 < n_valid[:, None])
        # in place: the arena row of each sequence gets its new K/V
        if cfg.kv_quant:
            ki, ks = _kv_quant(k[:, 0])             # (B,KV,hd), (B,KV)
            vi, vs = _kv_quant(v[:, 0])
            cache["k"][rows, slot] = ki
            cache["v"][rows, slot] = vi
            cache["k_scale"][rows, slot] = ks
            cache["v_scale"][rows, slot] = vs
            o = decode_attention_quant(
                q[:, 0], cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], valid, use_kernels=cfg.use_kernels)
        else:
            cache["k"][rows, slot] = k[:, 0]
            cache["v"][rows, slot] = v[:, 0]
            o = decode_attention(q[:, 0], cache["k"], cache["v"], valid,
                                 use_kernels=cfg.use_kernels)
        new_cache = cache
        o = o[:, None]                              # (B,1,H,hd)
    else:
        # prefix-cache suffix prefill: keys are [history; current] and the
        # queries are the LAST Lq of the Lk positions, which is exactly the
        # kernels' rectangular-causal convention (q_offset = Lk - Lq)
        k_att, v_att = k, v
        if cache is not None and "hk" in cache:
            if cfg.kv_quant:
                raise NotImplementedError(
                    "int8 prefix history: not yet ported")
            k_att = torch.cat([cache["hk"], k], dim=1)
            v_att = torch.cat([cache["hv"], v], dim=1)
        if cfg.use_kernels:
            from repro_torch.kernels import ops as kops
            if mode == "full":                      # training / scoring
                o = kops.FlashAttention.apply(q, k_att, v_att, True, window)
            else:
                o = kops.flash_attention(q, k_att, v_att, causal=True,
                                         window=window)
        else:
            o = flash_attention(q, k_att, v_att, causal=True, window=window,
                                qpos0=k_att.shape[1] - q.shape[1])
        if mode == "prefill":
            assert cache is not None
            S = cache["k"].shape[1]
            L = k.shape[1]
            rows = dict(k=k, v=v)
            if cfg.kv_quant:                        # int8 rows + scales
                rows["k"], rows["k_scale"] = _kv_quant(k)
                rows["v"], rows["v_scale"] = _kv_quant(v)
            for name, r in rows.items():
                if L <= S:
                    cache[name][:, :L] = r
                else:                               # keep last S (window)
                    # ring layout: entry for pos t lives at slot t % S
                    roll = (-(L - S)) % S
                    cache[name].copy_(torch.roll(r[:, -S:], shifts=-roll,
                                                 dims=1))
            new_cache = {name: cache[name] for name in rows}
    out = o.reshape(B, -1, H * hd) @ p["wo"]
    return out, new_cache


# ===================================================================== #
# Dense SwiGLU MLP
# ===================================================================== #
def mlp_specs(cfg: ModelConfig, d_ff=None) -> dict:
    D, Fd = cfg.d_model, d_ff or cfg.d_ff
    return {
        "w_gate": ParamSpec((D, Fd), ("embed", "mlp")),
        "w_up": ParamSpec((D, Fd), ("embed", "mlp")),
        "w_down": ParamSpec((Fd, D), ("mlp", "embed")),
    }


def mlp_apply(p, x, cfg=None):
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
