"""Model primitives (counterpart of ``repro/models/modules.py``): parameter
specs, RMSNorm, RoPE, GQA attention (qk-norm, sliding window, ring-buffer
cache), MLA (latent cache, absorbed decode), cross-attention over encoder
embeddings, the SwiGLU MLP and the MoE layer (capacity dispatch by row
index), for the serving and the training paths, and the Mamba2 (SSD) mixer.

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
The int8 KV cache (``cfg.kv_quant``: int8 K/V rows plus fp32 per-row
scale planes) and the paged layout (a shared block pool reached through
per-sequence block tables, bf16/fp32 or int8) are ported, with the prefix
cache's read-only history (``hk``/``hv``, dequantized from int8 blocks when
the pool is int8).

The Mamba2 mixer (:func:`ssm_apply`) carries a recurrent cache per layer:
``conv`` (the last ``K-1`` pre-activation conv inputs, in the compute
dtype) and ``state`` (the SSD state, **fp32** whatever the compute dtype).
The reference keeps its state in the compute dtype, but its decode step
multiplies it by the fp32 decay, so in bf16 the state it carries is fp32
from the first decode step on (ROADMAP Queue 3, R9); its step-by-step
decode runs that way, while its scanned serve chunk cannot (the scan
carry changes type).  The port computes the step-by-step path: prefill
stores the final state rounded through the compute dtype
(``final.to(cdtype)``, the reference's bf16 cache value) into the fp32
arena, and decode carries fp32.  One difference remains in bf16: the
reference's first decode step also rounds its ``dt * x * B`` update to
bf16 (cast to the bf16 cache's dtype), the port's never does.  Decode
updates ``conv`` and ``state`` in place, as attention updates its arena.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels.flash_attention import HEAD_DIMS as FLASH_HEAD_DIMS
from repro_torch.kernels.ref import (chunk_cumsum, gather_blocks, lens_mask,
                                    ssd_chunks, ssd_inter_chunk)
from repro_torch.models.config import ModelConfig

NEG_INF = -1e30


# the tensor-parallel collectives live in ``repro_torch.sharding.runtime``,
# which imports this module: reached at call time
def copy_to_model(x, tp):
    from repro_torch.sharding.runtime import copy_to_model as f
    return f(x, tp)


def reduce_from_model(x, tp):
    from repro_torch.sharding.runtime import reduce_from_model as f
    return f(x, tp)


def gather_data_rows(x, tp):
    from repro_torch.sharding.runtime import gather_data_rows as f
    return f(x, tp)


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


def flatten_with_path(tree, path=()) -> list:
    """``[(path, leaf)]`` in the order of ``jax.tree_util``'s
    ``tree_flatten_with_path``, each path a tuple of components as the
    reference's checkpoint keys spell them: dict keys in sorted order,
    NamedTuple fields as ``".name"``, sequence items by index, ``None`` an
    empty subtree.  (:func:`tree_map` keeps insertion order instead.)"""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [kv for k in sorted(tree)
                for kv in flatten_with_path(tree[k], path + (k,))]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [kv for f in tree._fields
                for kv in flatten_with_path(getattr(tree, f),
                                            path + ("." + f,))]
    if isinstance(tree, (tuple, list)):
        return [kv for i, t in enumerate(tree)
                for kv in flatten_with_path(t, path + (i,))]
    return [(path, tree)]


def tree_unflatten_paths(tree, leaves):
    """``tree``'s structure with ``leaves`` (in :func:`flatten_with_path`
    order) in place of its leaves."""
    it = iter(leaves)

    def build(t):
        if t is None:
            return None
        if isinstance(t, dict):
            new = {k: build(t[k]) for k in sorted(t)}
            return {k: new[k] for k in t}          # keep the caller's order
        if isinstance(t, tuple) and hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        if isinstance(t, (tuple, list)):
            return type(t)(build(x) for x in t)
        return next(it)
    return build(tree)


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


# a normal leaf of more elements is drawn in slices of its leading axis
# (4 GiB of fp32 each at most), so that a bf16 leaf never needs its whole
# fp32 draw at once; every leaf below it is one draw, as it always was
MAX_DRAW = 2 ** 30


def materialize(spec: ParamSpec, generator: torch.Generator,
                dtype: torch.dtype) -> torch.Tensor:
    """One parameter on ``generator``'s device: zeros, ones, or normal with
    std ``scale / sqrt(fan_in)`` (fan_in excludes a leading layers axis),
    drawn in fp32 and rounded to ``dtype`` (so a bf16 draw is the fp32
    draw's rounding, bit for bit).  A normal leaf of more than
    :data:`MAX_DRAW` elements is drawn slice by slice along its leading
    axis into the ``dtype`` result."""
    dev = generator.device
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=dev)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=dev)
    start = 1 if (spec.axes and spec.axes[0] == "layers") else 0
    shp = spec.shape[start:]
    fan_in = shp[0] if len(shp) == 1 else int(np.prod(shp[:-1]))
    std = spec.scale / np.sqrt(max(fan_in, 1))
    n = int(np.prod(spec.shape))
    if n <= MAX_DRAW:
        x = torch.randn(spec.shape, generator=generator,
                        dtype=torch.float32, device=dev)
        return (x * std).to(dtype)
    out = torch.empty(spec.shape, dtype=dtype, device=dev)
    rows = max(1, MAX_DRAW // (n // spec.shape[0]))
    for r0 in range(0, spec.shape[0], rows):
        r1 = min(r0 + rows, spec.shape[0])
        x = torch.randn((r1 - r0,) + tuple(spec.shape[1:]),
                        generator=generator, dtype=torch.float32, device=dev)
        out[r0:r1] = (x * std).to(dtype)
        del x
    return out


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


def rmsnorm_gated(x, z, weight, eps: float = 1e-5):
    """Mamba2-style gated RMSNorm: norm(x * silu(z)), always plain (the
    reference never sends it to the kernel, R3)."""
    return rmsnorm(x * F.silu(z.float()).to(x.dtype), weight, eps)


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


def paged_attn_cache_shape(cfg: ModelConfig, num_blocks: int,
                           block_size: int):
    """Paged layout: a shared pool of ``num_blocks`` fixed-size KV blocks
    (block 0 is the trash block) instead of a per-slot ``(batch, S)``
    arena; a block's rows follow the arena's ``(S, KV, D)`` convention with
    ``S -> block_size``.  With ``cfg.kv_quant`` the pool stores int8 K/V
    and fp32 scale planes ``(num_blocks, bs, KV)`` that travel with their
    blocks.  Full-context GQA only."""
    if cfg.mla:
        raise NotImplementedError("paged KV: GQA only (MLA caches latents)")
    out = dict(k=(num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim),
               v=(num_blocks, block_size, cfg.n_kv_heads, cfg.head_dim))
    if cfg.kv_quant:
        out["k_scale"] = (num_blocks, block_size, cfg.n_kv_heads)
        out["v_scale"] = (num_blocks, block_size, cfg.n_kv_heads)
    return out


def decode_attention_paged(q, k_pool, v_pool, block_tables, lens,
                           use_kernels=False):
    """Single-token attention over a block-pooled KV cache.

    q: (B, H, D); k/v pool: (nblocks, bs, KV, D); block_tables: (B, nb)
    int32 (entries past a sequence's allocated prefix point at trash block
    0); lens: (B,) int32 valid-row counts.  The plain path gathers each
    sequence's blocks into a dense (B, nb*bs, KV, D) virtual cache and
    reuses the dense decode math, bit-identical to the dense arena when
    ``nb*bs`` equals the arena length; the kernel walks the table."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.paged_decode_attention(q, k_pool, v_pool, block_tables,
                                           lens)
    k_virt = gather_blocks(k_pool, block_tables)
    v_virt = gather_blocks(v_pool, block_tables)
    return decode_attention(q, k_virt, v_virt,
                            lens_mask(lens, k_virt.shape[1]))


def decode_attention_paged_quant(q, k_pool, v_pool, k_scale, v_scale,
                                 block_tables, lens, use_kernels=False):
    """Single-token attention over an int8 block-pooled KV cache: the
    plain path gathers blocks and their scale rows into a dense virtual
    cache and reuses :func:`decode_attention_quant`; the kernel walks the
    table with dequant fused into its online softmax.

    q: (B, H, D); k/v pool: (nblocks, bs, KV, D) int8; scale pools:
    (nblocks, bs, KV) fp32; block_tables: (B, nb) int32; lens: (B,)."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.paged_decode_attention_quant(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lens)
    k_virt = gather_blocks(k_pool, block_tables)
    v_virt = gather_blocks(v_pool, block_tables)
    return decode_attention_quant(
        q, k_virt, v_virt, gather_blocks(k_scale, block_tables),
        gather_blocks(v_scale, block_tables),
        lens_mask(lens, k_virt.shape[1]))


def attn_apply(cfg: ModelConfig, p, x, *, positions, mode, cache=None,
               window=None, block_tables=None, rope=None, tp=None):
    """mode: 'full' (train / full prefill) | 'prefill' (also fills cache) |
    'decode' (x is (B,1,D), cache holds history).

    ``cache`` holds this layer's ``k``/``v`` arena views ``(B, S, KV, hd)``
    (int8 with fp32 ``k_scale``/``v_scale`` planes ``(B, S, KV)`` under
    ``cfg.kv_quant``).  Where the reference rebuilds the (donated) arena
    with ``.at[].set``, the port writes the new rows into it in place and
    returns the same dict.  A prefill cache may also carry a read-only
    history (``hk``/``hv``, int8 with ``hk_scale``/``hv_scale`` under
    ``cfg.kv_quant``) that the current tokens attend to but never rewrite.
    ``block_tables`` selects the paged decode: ``cache`` is then this
    layer's view of the shared block pool (:func:`paged_attn_cache_shape`)
    and each row's K/V is written and read through its table.  ``rope`` is
    :func:`rope_cos_sin` of ``positions`` when the caller shares it across
    layers.

    Under tensor parallelism (``tp``, a
    :class:`~repro_torch.sharding.runtime.TP` context, and ``p`` a rank's
    compute view) the weights hold the rank's heads: ``wq`` its ``H / tp``
    q heads, ``wk``/``wv`` the kv heads they read (``KV / tp``, or the one
    of ``tp > KV``), ``wo`` their rows.  The body runs on those heads as
    on a model of that many heads (the kernels, the cache and its rows
    unchanged, the cache holding the rank's kv heads), and ``wo``'s
    partial sums are all-reduced over ``model``."""
    B = x.shape[0]
    hd = cfg.head_dim
    # the heads this rank computes: all of them, or its share under
    # tensor parallelism (the layout gives the widths)
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    split = H != cfg.n_heads
    if split:
        x = copy_to_model(x, tp)
    L = x.shape[1]
    q = (x @ p["wq"]).reshape(B, L, H, hd)
    k = (x @ p["wk"]).reshape(B, L, KV, hd)
    v = (x @ p["wv"]).reshape(B, L, KV, hd)
    if cfg.qk_norm:
        # replicated weights read by the rank's heads only: their grads
        # are summed over model
        qn, kn = p["q_norm"], p["k_norm"]
        if split:
            qn, kn = copy_to_model(qn, tp), copy_to_model(kn, tp)
        q = rmsnorm(q, qn, cfg.rms_eps)
        k = rmsnorm(k, kn, cfg.rms_eps)
    rope = rope or rope_cos_sin(positions, hd, cfg.rope_theta)
    q = apply_rope(q, positions, cfg.rope_theta, rope)
    k = apply_rope(k, positions, cfg.rope_theta, rope)

    new_cache = None
    if mode == "decode" and block_tables is not None:
        # paged: write the new row at (table[pos // bs], pos % bs) and
        # attend through the table.  Rows past a slot's allocated prefix
        # resolve to the trash block (table padding = 0); with a FULLY
        # allocated table the clamped index instead wraps post-EOS writes
        # into the slot's own last block: dead for decode (a finished
        # slot's output is dropped until harvest), and the prefix cache
        # never indexes that block, so its stale rows are never reused
        assert cache is not None
        if window is not None:
            raise NotImplementedError("paged KV: full-context attention "
                                      "only")
        bs = cache["k"].shape[1]
        nb = block_tables.shape[1]
        pos = positions[:, 0]                       # (B,)
        bi = torch.clamp(pos // bs, max=nb - 1)
        blk = torch.gather(block_tables, 1, bi[:, None])[:, 0].long()
        off = pos % bs
        lens = torch.clamp(pos + 1, max=nb * bs).to(torch.int32)
        # in place: the new rows land in their pool blocks
        if cfg.kv_quant:
            ki, ks = _kv_quant(k[:, 0])             # (B,KV,hd), (B,KV)
            vi, vs = _kv_quant(v[:, 0])
            cache["k"][blk, off] = ki
            cache["v"][blk, off] = vi
            cache["k_scale"][blk, off] = ks
            cache["v_scale"][blk, off] = vs
            o = decode_attention_paged_quant(
                q[:, 0], cache["k"], cache["v"], cache["k_scale"],
                cache["v_scale"], block_tables, lens,
                use_kernels=cfg.use_kernels)
        else:
            cache["k"][blk, off] = k[:, 0]
            cache["v"][blk, off] = v[:, 0]
            o = decode_attention_paged(q[:, 0], cache["k"], cache["v"],
                                       block_tables, lens,
                                       use_kernels=cfg.use_kernels)
        new_cache = cache
        o = o[:, None]                              # (B,1,H,hd)
    elif mode == "decode":
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
            hk, hv = cache["hk"], cache["hv"]
            if cfg.kv_quant:
                # int8 history: dequantized before the concat, a
                # (B, P, KV, hd) temporary; the pool itself stays int8
                hk = (hk.float() * cache["hk_scale"][..., None]).to(k.dtype)
                hv = (hv.float() * cache["hv_scale"][..., None]).to(v.dtype)
            k_att = torch.cat([hk, k], dim=1)
            v_att = torch.cat([hv, v], dim=1)
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
    out = o.reshape(B, o.shape[1], H * hd) @ p["wo"]
    if split:                                   # wo is row-parallel
        out = reduce_from_model(out, tp)
    return out, new_cache


def _attend(cfg: ModelConfig, q, k, v, *, mode, causal, window=None):
    """Prefill / training attention of the MLA and cross-attention layers:
    q (B, Lq, H, D), k, v (B, Lk, KV, D).  With ``cfg.use_kernels`` the
    flash kernels (``ops.FlashAttention`` under ``full``, which trains
    through the backward kernels), else the plain :func:`flash_attention`;
    the reference calls its jnp ``_flash`` here in both cases (R2).  A
    head dim the kernels are not built for (a reduced MLA config's 48)
    runs the plain flash on the CPU; a CUDA tensor goes to the kernels,
    which refuse it."""
    if cfg.use_kernels and (q.is_cuda or q.shape[-1] in FLASH_HEAD_DIMS):
        from repro_torch.kernels import ops as kops
        if mode == "full":
            return kops.FlashAttention.apply(q, k, v, causal, window)
        return kops.flash_attention(q, k, v, causal=causal, window=window)
    return flash_attention(q, k, v, causal=causal, window=window)


# ===================================================================== #
# MLA (DeepSeek-V2 multi-head latent attention)
# ===================================================================== #
def mla_specs(cfg: ModelConfig) -> dict:
    D, H = cfg.d_model, cfg.n_heads
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    return {
        "wq": ParamSpec((D, H * (dn + dr)), ("embed", "heads")),
        "w_dkv": ParamSpec((D, r + dr), ("embed", None)),
        "kv_norm": ParamSpec((r,), (None,), "ones"),
        "w_uk": ParamSpec((r, H * dn), (None, "heads")),
        "w_uv": ParamSpec((r, H * dv), (None, "heads")),
        "wo": ParamSpec((H * dv, D), ("heads", "embed")),
    }


def mla_cache_shape(cfg: ModelConfig, batch: int, max_len: int):
    """The latent cache: ``ckv`` (batch, S, r), the normed compressed KV,
    and ``krope`` (batch, S, dr), the shared rotated key part; both in the
    compute dtype, ``kv_quant`` or not (it quantizes ``k``/``v`` only)."""
    return dict(ckv=(batch, max_len, cfg.kv_lora_rank),
                krope=(batch, max_len, cfg.qk_rope_head_dim))


def _mla_qkv(cfg, p, x, positions, rope=None, H=None, w_dkv=None,
             kv_norm=None):
    """(q_nope (B,L,H,dn), q_rope (B,L,H,dr), ckv (B,L,r), krope (B,L,dr));
    ``kv_norm`` runs plain, as in the reference (R3).  ``rope`` is
    :func:`rope_cos_sin` of ``positions`` over ``dr``; ``H`` the heads
    ``wq`` holds, ``w_dkv`` / ``kv_norm`` the latent weights to read in
    place of ``p``'s."""
    B, L, _ = x.shape
    H = H or cfg.n_heads
    dn, dr, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.kv_lora_rank
    rope = rope or rope_cos_sin(positions, dr, cfg.rope_theta)
    q = (x @ p["wq"]).reshape(B, L, H, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta, rope)
    dkv = x @ (p["w_dkv"] if w_dkv is None else w_dkv)      # (B,L,r+dr)
    ckv = rmsnorm(dkv[..., :r], p["kv_norm"] if kv_norm is None else kv_norm,
                  cfg.rms_eps)
    krope = apply_rope(dkv[..., r:], positions, cfg.rope_theta, rope)
    return q_nope, q_rope, ckv, krope


def mla_apply(cfg: ModelConfig, p, x, *, positions, mode, cache=None,
              window=None, block_tables=None, rope=None, tp=None):
    """MLA.  'full' / 'prefill': the latents expand to K (nope part from
    ``w_uk``, the rotated ``krope`` shared by every head) and V (``w_uv``),
    V is zero-padded from ``dv`` to the query/key width ``dn + dr`` so
    attention sees one head dim, and the output is sliced back to ``dv``
    (the reference's layout; under ``cfg.use_kernels`` the flash kernels at
    that head dim); 'prefill' also writes the latents into ``cache`` in
    place.  'decode': the *absorbed* form, plain tensor products with fp32
    accumulation as in the reference: ``w_uk`` folded into the query, the
    scores taken against the cached ``ckv`` and ``krope`` (written in place
    at ``pos % S``), ``w_uv`` applied to the attended latents; per token
    O(S (r + dr)) instead of O(S H (dn + dr)).  The absorbed scores round
    otherwise than the expanded ones (ROADMAP Queue 3, R16).

    Under tensor parallelism (``tp``, ``p`` a rank's compute view) ``wq``,
    ``w_uk``, ``w_uv`` and ``wo`` hold the rank's ``H / tp`` heads, and
    the latent weights ``w_dkv`` and ``kv_norm`` are whole: they enter the
    model region (their grads, each rank's heads' share, are summed over
    ``model``), every rank computes and caches the whole latents (they
    carry no heads) and ``wo``'s partial outputs are all-reduced."""
    if block_tables is not None:
        raise NotImplementedError("paged KV: GQA only (MLA caches latents)")
    B = x.shape[0]
    r, dn, dr, dv = (cfg.kv_lora_rank, cfg.qk_nope_head_dim,
                     cfg.qk_rope_head_dim, cfg.v_head_dim)
    H = p["wq"].shape[-1] // (dn + dr)      # the rank's heads
    split = H != cfg.n_heads
    w_dkv = kv_norm = None
    if split:
        x = copy_to_model(x, tp)
        w_dkv = copy_to_model(p["w_dkv"], tp)
        kv_norm = copy_to_model(p["kv_norm"], tp)
    q_nope, q_rope, ckv, krope = _mla_qkv(cfg, p, x, positions, rope, H,
                                          w_dkv, kv_norm)
    scale = 1.0 / math.sqrt(dn + dr)
    new_cache = None

    if mode == "decode":
        assert cache is not None
        S = cache["ckv"].shape[1]
        pos = positions[:, 0]
        rows = torch.arange(B, device=x.device)
        cache["ckv"][rows, pos % S] = ckv[:, 0]         # in place
        cache["krope"][rows, pos % S] = krope[:, 0]
        ckv_c, krope_c = cache["ckv"], cache["krope"]
        valid = (torch.arange(S, device=x.device)[None]
                 < torch.clamp(pos + 1, max=S)[:, None])
        # absorbed scores: W_UK folded into the query, in the compute dtype
        w_uk = p["w_uk"].reshape(r, H, dn)
        q_eff = torch.einsum("bhd,rhd->bhr", q_nope[:, 0], w_uk)   # (B,H,r)
        s = (torch.einsum("bhr,bsr->bhs", q_eff.float(), ckv_c.float())
             + torch.einsum("bhd,bsd->bhs", q_rope[:, 0].float(),
                            krope_c.float())) * scale
        s = torch.where(valid[:, None], s, NEG_INF)
        pr = torch.softmax(s, dim=-1)
        ctx = torch.einsum("bhs,bsr->bhr", pr.to(ckv_c.dtype).float(),
                           ckv_c.float())                         # (B,H,r)
        w_uv = p["w_uv"].reshape(r, H, dv)
        o = torch.einsum("bhr,rhd->bhd", ctx.to(x.dtype), w_uv)[:, None]
        new_cache = cache
    else:
        L = x.shape[1]
        k_nope = (ckv @ p["w_uk"]).reshape(B, L, H, dn)
        vfull = (ckv @ p["w_uv"]).reshape(B, L, H, dv)
        k = torch.cat([k_nope, krope[:, :, None].expand(B, L, H, dr)], -1)
        q = torch.cat([q_nope, q_rope], -1)
        # V padded to the qk head dim: the kernels see one head dim
        vpad = F.pad(vfull, (0, dn + dr - dv)) if dn + dr != dv else vfull
        o = _attend(cfg, q, k, vpad, mode=mode, causal=True,
                    window=window)[..., :dv]
        if mode == "prefill":
            assert cache is not None
            cache["ckv"][:, :L] = ckv
            cache["krope"][:, :L] = krope
            new_cache = cache
    out = o.reshape(B, o.shape[1], H * dv) @ p["wo"]
    if split:                                   # wo is row-parallel
        out = reduce_from_model(out, tp)
    return out, new_cache


# ===================================================================== #
# Cross-attention (VLM / audio encoder embeddings; K/V cached once)
# ===================================================================== #
def cross_attn_specs(cfg: ModelConfig) -> dict:
    D, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    return {
        "wq": ParamSpec((D, H * hd), ("embed", "heads")),
        "wk": ParamSpec((D, KV * hd), ("embed", "kv_heads")),
        "wv": ParamSpec((D, KV * hd), ("embed", "kv_heads")),
        "wo": ParamSpec((H * hd, D), ("heads", "embed")),
        "gate": ParamSpec((1,), (None,), "zeros"),   # llama3.2-v tanh gate
    }


def cross_attn_apply(cfg: ModelConfig, p, x, enc, *, mode="full",
                     cache=None, tp=None):
    """x: (B, L, D) queries; enc: (B, Le, D) projected encoder states.
    'full' / 'prefill': K/V from ``enc``; 'prefill' writes them into the
    ``xk``/``xv`` arena (``(B, encoder_len, KV, hd)``, in place, so ``Le``
    must be the config's ``encoder_len``).  'decode': K/V from the cache,
    never recomputed in the decode loop.  Attention is non-causal over all
    ``Le`` keys (the flash kernels under ``cfg.use_kernels``), the output
    gated by ``tanh(gate)``.

    Under tensor parallelism (``tp``, ``p`` a rank's compute view) ``wq``
    and ``wo`` hold the rank's heads and ``wk``/``wv`` the kv heads they
    read, as in :func:`attn_apply`; ``enc`` has entered the model region
    already (:func:`repro_torch.models.transformer.forward`), the cache
    holds the rank's kv heads, and ``tanh(gate)`` multiplies the output
    after ``wo``'s partial outputs are all-reduced, so its grad is whole
    on every rank."""
    B, L, _ = x.shape
    hd = cfg.head_dim
    H, KV = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd
    split = H != cfg.n_heads
    if split:
        x = copy_to_model(x, tp)
    q = (x @ p["wq"]).reshape(B, L, H, hd)
    if mode == "decode":
        assert cache is not None
        k, v = cache["xk"], cache["xv"]
        new_cache = cache
    else:
        k = (enc @ p["wk"]).reshape(B, enc.shape[1], KV, hd)
        v = (enc @ p["wv"]).reshape(B, enc.shape[1], KV, hd)
        if cache is not None:
            if cache["xk"].shape != k.shape:
                raise ValueError(
                    f"cross-attention cache holds {tuple(cache['xk'].shape)}"
                    f", the encoder gives {tuple(k.shape)} (encoder_len "
                    f"{cfg.encoder_len})")
            cache["xk"].copy_(k)
            cache["xv"].copy_(v)
            new_cache = cache
        else:
            new_cache = dict(xk=k, xv=v)
    o = _attend(cfg, q, k, v, mode=mode, causal=False)
    out = o.reshape(B, L, H * hd) @ p["wo"]
    if split:                                   # wo is row-parallel
        out = reduce_from_model(out, tp)
    out = torch.tanh(p["gate"].float()).to(out.dtype) * out
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


def mlp_apply(p, x, cfg=None, tp=None, d_ff=None):
    """SwiGLU.  Under tensor parallelism (``p`` a rank's compute view whose
    ``w_gate``/``w_up`` columns and ``w_down`` rows are a slice of the
    hidden width ``d_ff``, default ``cfg.d_ff``) the partial outputs are
    all-reduced over ``model``."""
    split = tp is not None and p["w_gate"].shape[-1] != (d_ff or cfg.d_ff)
    if split:
        x = copy_to_model(x, tp)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    out = h @ p["w_down"]
    return reduce_from_model(out, tp) if split else out


# ===================================================================== #
# MoE (capacity-based dispatch by row index)
# ===================================================================== #
def moe_specs(cfg: ModelConfig) -> dict:
    D, E, Fd = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    s = {
        "router": ParamSpec((D, E), ("embed", None)),
        "w_gate": ParamSpec((E, D, Fd), ("experts", "embed", "mlp")),
        "w_up": ParamSpec((E, D, Fd), ("experts", "embed", "mlp")),
        "w_down": ParamSpec((E, Fd, D), ("experts", "mlp", "embed")),
    }
    if cfg.n_shared_experts:
        s["shared"] = mlp_specs(cfg, d_ff=cfg.n_shared_experts * cfg.moe_d_ff)
    return s


def moe_route(cfg: ModelConfig, probs):
    """The dispatch rule of :func:`moe_apply` for router probabilities
    ``probs`` (T, E) fp32: ``(gates (T, K) fp32 renormalized, expert (T, K),
    pos (T*K,), cap)``.  Top-K keeps the reference's tie order, the lower
    expert index first (``jax.lax.top_k``; ``torch.topk`` promises no order,
    ROADMAP Queue 3, R14): the first K of a stable descending sort.  ``pos``
    is each (token, k) entry's place in its expert's queue, token-major and
    k-minor, so the capacity ``cap = ceil(T K / E * capacity_factor)``
    keeps the earliest rows of the call; an entry with ``pos >= cap`` is
    dropped (R13: the rows of one call share the capacity)."""
    T, E = probs.shape
    K = cfg.top_k
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates, expert = vals[:, :K], idx[:, :K]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    cap = int(np.ceil(T * K / E * cfg.capacity_factor))
    flat = F.one_hot(expert.reshape(T * K), E)                 # (T*K, E)
    pos = (torch.cumsum(flat, dim=0) * flat).sum(-1) - 1
    return gates, expert, pos, cap


class _Dispatch(torch.autograd.Function):
    """The MoE layer's dispatch: ``cat([x, 0])[inv]``, the row each
    (expert, place) reads (row ``T``, zeros, where a place is empty).  The
    backward gathers each token's ``K`` entries' grads through ``slot``
    (an entry's place; the zero row past the places where it was dropped)
    and sums them in ``k`` order: the same sum on every run, where
    ``index_select``'s backward adds a token's grads in an order the
    device picks."""

    @staticmethod
    def forward(ctx, x, inv, slot, K):
        ctx.save_for_backward(slot)
        ctx.shape = (x.shape[0], K)
        return torch.cat([x, x.new_zeros((1, x.shape[1]))]).index_select(
            0, inv)

    @staticmethod
    def backward(ctx, g):
        slot, = ctx.saved_tensors
        g_ext = torch.cat([g, g.new_zeros((1, g.shape[1]))])
        per = g_ext.index_select(0, slot).reshape(*ctx.shape, g.shape[1])
        return per.sum(1), None, None, None


def moe_apply(cfg: ModelConfig, p, x, tp=None):
    """x: (B, L, D) -> (out, aux_loss), the reference's arithmetic in its
    order: router logits in the compute dtype, then fp32 and softmax;
    :func:`moe_route`; each kept entry's row gathered into an (E, cap, D)
    buffer by index (empty places read a zero row), the experts as one
    batched product, the outputs gathered back by index and weighted by
    the gates cast to ``x.dtype`` (a dropped entry contributes zero); the
    shared expert through :func:`mlp_apply`.  The aux loss is the
    switch-style load balance plus the router z-loss.

    Under tensor parallelism (``p`` a rank's compute view) the expert
    stacks hold the rank's experts ``(E / tp, D, F)`` or its slice of
    every expert's width ``(E, D, F / tp)``, as the layout cut them.  Every
    rank routes the same rows the same way (the router is replicated),
    runs its own experts or width on them, and one all-reduce over
    ``model`` sums the outputs; the shared expert is a tensor-parallel
    MLP.  With ``tp.rows`` (a data group: the batch is sharded over it)
    the rows of every rank of that group are gathered first (``tp.counts``
    of them: a rank may hold none of a micro slice), so that the capacity
    counts the global batch's rows as the reference's does (R13);
    the rank keeps its own rows' outputs, and the aux loss, computed on
    the global rows by each rank of the group, enters each rank's loss
    divided by the group's size (the ranks' losses sum to the global
    one)."""
    B, L, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    xf = gather_data_rows(x, tp).reshape(-1, D)
    T = xf.shape[0]
    logits = (xf @ p["router"]).float()                        # (T, E)
    probs = torch.softmax(logits, dim=-1)
    gates, expert, pos, cap = moe_route(cfg, probs)
    e_flat = expert.reshape(T * K)
    keep = pos < cap
    # this rank's experts [e0, e0 + El) (all of them without a cut)
    El = p["w_gate"].shape[0]
    split = tp is not None and (El != E or p["w_gate"].shape[-1]
                                != cfg.moe_d_ff)
    e0 = tp.rank * El if El != E else 0
    mine = keep & (e_flat >= e0) & (e_flat < e0 + El)
    slot = torch.where(mine, (e_flat - e0) * cap + pos,
                       torch.full_like(pos, El * cap))          # drop -> end
    xe = copy_to_model(xf, tp) if split else xf
    # the row each (expert, place) reads: token T (a zero row) where empty
    inv = torch.full((El * cap + 1,), T, dtype=torch.long, device=x.device)
    inv[slot] = torch.arange(T * K, device=x.device) // K
    ein = _Dispatch.apply(xe, inv[:El * cap], slot, K).reshape(El, cap, D)
    h = F.silu(torch.bmm(ein, p["w_gate"])) * torch.bmm(ein, p["w_up"])
    eout = torch.bmm(h, p["w_down"]).reshape(El * cap, D)
    eout_ext = torch.cat([eout, eout.new_zeros((1, D))], dim=0)
    gathered = eout_ext.index_select(0, slot)                  # (T*K, D)
    g = gates.reshape(T * K).to(x.dtype)
    if split:   # the gates' grads, each rank's experts' share: summed
        g = copy_to_model(g, tp)
    w = (g * mine.to(x.dtype))[:, None]
    out = (gathered * w).reshape(T, K, D).sum(1)
    if split:
        out = reduce_from_model(out, tp)
    if cfg.n_shared_experts:
        out = out + mlp_apply(p["shared"], xf, cfg, tp,
                              d_ff=cfg.n_shared_experts * cfg.moe_d_ff)
    frac = F.one_hot(expert, E).sum(1).float().mean(0)         # (E,)
    imp = probs.mean(0)
    aux = (cfg.router_aux_coef * E * torch.sum(frac * imp) / K
           + cfg.router_z_coef
           * torch.mean(torch.logsumexp(logits, dim=-1) ** 2))
    if tp is not None and tp.rows is not None and tp.rows.size() > 1:
        r0 = tp.row_offset(B) * L           # the data group's rows
        out = out[r0:r0 + B * L]
        aux = aux / tp.rows.size()
    return out.reshape(B, L, D), aux


# ===================================================================== #
# Mamba2 (SSD) mixer
# ===================================================================== #
def ssm_specs(cfg: ModelConfig) -> dict:
    D = cfg.d_model
    di, nh, N, G = cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state, cfg.ssm_ngroups
    conv_dim = di + 2 * G * N
    in_dim = 2 * di + 2 * G * N + nh
    return {
        "w_in": ParamSpec((D, in_dim), ("embed", "mlp")),
        "conv_w": ParamSpec((cfg.ssm_conv, conv_dim), (None, "mlp")),
        "conv_b": ParamSpec((conv_dim,), ("mlp",), "zeros"),
        "A_log": ParamSpec((nh,), (None,), "zeros"),
        "D_skip": ParamSpec((nh,), (None,), "ones"),
        "dt_bias": ParamSpec((nh,), (None,), "zeros"),
        "out_norm": ParamSpec((di,), ("mlp",), "ones"),
        "w_out": ParamSpec((di, D), ("mlp", "embed")),
    }


def segsum(x):
    """x: (..., q) -> (..., q, q) lower-triangular segment sums, -inf above
    the diagonal (so ``exp`` of it is exactly 0 there, with a zero
    gradient).  The cumsum is the kernel's, rounded from fp64
    (:func:`repro_torch.kernels.ref.chunk_cumsum`)."""
    q = x.shape[-1]
    cs = chunk_cumsum(x)
    d = cs[..., :, None] - cs[..., None, :]
    mask = torch.ones((q, q), dtype=torch.bool, device=x.device).tril()
    return torch.where(mask, d, -math.inf)


def ssd_chunked(X, dt, A, B, C, chunk, initial_state=None,
                use_kernels=False):
    """Chunked SSD scan (Mamba2 via state-space duality).

    X: (b,l,h,p)  dt: (b,l,h) fp32  A: (h,) fp32  B,C: (b,l,n)  [ngroups=1]
    Returns (Y: (b,l,h,p), final_state: (b,h,p,n) fp32).  With
    ``use_kernels`` the intra-chunk pass is the kernel
    (:func:`repro_torch.kernels.ops.ssd_scan`, Y in X's dtype; under
    autograd its backward is the explicit plain one); the plain path below
    is differentiable torch ops throughout and, like the reference's jnp
    path, returns Y in fp32."""
    if use_kernels:
        from repro_torch.kernels import ops as kops
        return kops.ssd_scan(X, dt, A, B, C, chunk, initial_state)
    Xc, dtc, Bc, Cc = ssd_chunks(X, dt, B, C, chunk)
    dA = (dtc * A).permute(0, 1, 3, 2)                  # (b,c,h,q)
    Xd = Xc * dtc[..., None]                            # fp32: dt-discretized

    A_cs = chunk_cumsum(dA)                             # (b,c,h,q)
    Ldec = torch.exp(segsum(dA))                        # (b,c,h,q,q)
    # the scores round to the inputs' dtype, as the reference's einsum does
    scores = torch.einsum("bcqn,bckn->bcqk", Cc, Bc).float()
    Y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * Ldec,
                          Xd)

    # per-chunk end states
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)     # (b,c,h,q)
    S_c = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_states, Bc.float(),
                       Xd)
    return ssd_inter_chunk(Y_diag, S_c, A_cs, Cc, initial_state, X.shape[1])


def ssm_cache_shape(cfg: ModelConfig, batch: int):
    di, nh, N, G = (cfg.d_inner, cfg.ssm_nheads, cfg.ssm_state,
                    cfg.ssm_ngroups)
    conv_dim = di + 2 * G * N
    return dict(conv=(batch, cfg.ssm_conv - 1, conv_dim),
                state=(batch, nh, cfg.ssm_headdim, N))


def _conv_silu(win, w, b):
    """Depthwise conv taps plus bias, then SiLU: win (..., K, cd) holds each
    position's K inputs (history first), w (K, cd), b (cd,).  The taps sum
    in fp32 and round once to the input dtype, like the reference's einsum;
    prefill and decode run the same reduction."""
    acc = (win.float() * w.float()).sum(-2)
    return F.silu(acc.to(win.dtype) + b)


def ssm_apply(cfg: ModelConfig, p, x, *, mode, cache=None, tp=None):
    """Mamba2 block.  'full'/'prefill': causal depthwise conv, SiLU, the
    chunked SSD, the ``D_skip`` term and the gated norm; 'prefill' also
    writes the last ``K-1`` pre-activation conv inputs (zero-padded for a
    shorter prompt) and the final state into ``cache``.  'decode': the O(1)
    step, updating ``cache['conv']`` and ``cache['state']`` in place (see
    the module docstring for the state's fp32 arena).

    Under tensor parallelism (``tp``, ``p`` a rank's compute view, whose
    ``out_norm`` holds the rank's ``di / tp`` channels) the mixer runs on
    the rank's ``nh / tp`` heads: ``w_in`` holds its ``z``, ``x`` and
    ``dt`` columns and the whole of ``B`` and ``C``, ``conv_w`` /
    ``conv_b`` its ``x`` channels and ``B`` and ``C``
    (:func:`repro_torch.sharding.strategy.ssm_columns`), and the
    replicated per-head vectors are read at its heads.  The input enters
    the model region, so the ``B``/``C`` path's grads are each rank's
    partial sums; the gated norm's sum of squares is summed over
    ``model`` (:func:`_rms_over_model`) and ``w_out``'s partial outputs
    are all-reduced.  The cache holds the rank's heads (``state``) and
    channels (``conv``)."""
    B = x.shape[0]
    hp, N = cfg.ssm_headdim, cfg.ssm_state
    di = p["out_norm"].shape[-1]             # the rank's channels
    nh = di // hp
    split = di != cfg.d_inner
    G = cfg.ssm_ngroups
    K = cfg.ssm_conv
    conv_dim = di + 2 * G * N
    A_log, D_skip, dt_bias = p["A_log"], p["D_skip"], p["dt_bias"]
    if split:
        # replicated per-head vectors read at the rank's heads: their
        # grads are summed over model
        x = copy_to_model(x, tp)
        h0 = tp.rank * nh
        A_log, D_skip, dt_bias = (copy_to_model(t, tp)[h0:h0 + nh]
                                  for t in (A_log, D_skip, dt_bias))
    zxbcdt = x @ p["w_in"]
    z = zxbcdt[..., :di]
    xbc = zxbcdt[..., di:di + conv_dim]
    dt_raw = zxbcdt[..., di + conv_dim:]
    A = -torch.exp(A_log.float())
    dt = F.softplus(dt_raw.float() + dt_bias.float())
    new_cache = None

    if mode == "decode":
        assert cache is not None
        win = torch.cat([cache["conv"], xbc], dim=1)        # (B,K,conv_dim)
        conv_out = _conv_silu(win, p["conv_w"], p["conv_b"])
        xi = conv_out[..., :di].reshape(B, nh, hp)
        Bv = conv_out[..., di:di + N]
        Cv = conv_out[..., di + N:di + 2 * N]
        dt1 = dt[:, 0]                                      # (B,nh)
        dA = torch.exp(dt1 * A[None])                       # (B,nh)
        state = cache["state"]                              # fp32 arena
        # in place: state = state * dA + (x dt) outer B
        state.mul_(dA[..., None, None]).addcmul_(
            (xi * dt1[..., None])[..., None], Bv.float()[:, None, None, :])
        y = (state @ Cv.float()[:, None, :, None])[..., 0]  # (B,nh,hp)
        y = y + D_skip[None, :, None] * xi
        y = y.reshape(B, 1, di)
        cache["conv"].copy_(win[:, 1:])
        new_cache = cache
    else:
        L = x.shape[1]
        xp = F.pad(xbc, (0, 0, K - 1, 0))                   # (B,L+K-1,cd)
        win = xp.unfold(1, K, 1).transpose(-1, -2)          # (B,L,K,cd)
        conv_out = _conv_silu(win, p["conv_w"], p["conv_b"])
        xi = conv_out[..., :di].reshape(B, L, nh, hp)
        Bv = conv_out[..., di:di + N]
        Cv = conv_out[..., di + N:di + 2 * N]
        Y, final = ssd_chunked(xi, dt, A, Bv, Cv, cfg.ssm_chunk,
                               use_kernels=cfg.use_kernels)
        Y = Y + D_skip[None, None, :, None] * xi
        y = Y.reshape(B, L, di)
        if mode == "prefill":
            assert cache is not None
            cache["conv"].copy_(xp[:, L:])                  # last K-1 rows
            # the reference's compute-dtype cache value, kept in fp32
            cache["state"].copy_(final.to(cfg.cdtype))
            new_cache = cache
    if not split:
        y = rmsnorm_gated(y.to(x.dtype), z, p["out_norm"], cfg.rms_eps)
        return (y @ p["w_out"]).to(x.dtype), new_cache
    y = y.to(x.dtype)
    y = _rms_over_model(y * F.silu(z.float()).to(y.dtype), p["out_norm"],
                        cfg.rms_eps, cfg.d_inner, tp)
    out = reduce_from_model(y @ p["w_out"], tp)         # w_out row-parallel
    return out.to(x.dtype), new_cache


def _rms_over_model(x, weight, eps: float, width: int, tp):
    """:func:`rmsnorm` of rows whose ``width`` channels lie split over
    ``model`` (``x`` holds the rank's): the fp32 sums of squares are
    summed over ``model`` and divided by ``width``.  The sum enters every
    rank's channels, so its grad is summed over ``model`` too (an
    all-reduce both ways)."""
    x32 = x.float()
    ss = reduce_from_model(torch.sum(x32 * x32, dim=-1, keepdim=True), tp)
    var = copy_to_model(ss, tp) / width
    y = x32 * torch.rsqrt(var + eps)
    return (y * weight.float()).to(x.dtype)
