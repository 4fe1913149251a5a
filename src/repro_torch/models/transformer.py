"""Decoder transformer over dense attention segments (counterpart of
``repro/models/transformer.py``).

``param_specs(cfg)`` is the single source of truth for shapes (the same
tree paths as the reference, with the stacked leading ``layers`` axis);
``init_params`` materializes it; ``forward`` runs any of the three phases
(``full`` train/eval, ``prefill``, ``decode``).  Where the reference scans
the stacked layers, the port walks them with a Python loop over per-layer
views, and it updates the KV cache in place.  Training checkpoints each
layer when ``cfg.remat`` (the reference's ``jax.checkpoint`` of the scan
body), and :func:`lm_loss` / :func:`per_token_logprobs` never build more
than ``cfg.logit_chunk`` positions of logits at a time.

Every layer kind of the reference is ported: GQA attention layers, their
MoE form (``cfg.moe``: :func:`M.moe_apply` in place of the MLP, whose aux
losses :func:`forward` sums in fp32 in layer order), MLA attention
(``cfg.mla``: :func:`M.mla_apply`), cross-attention layers of ``vlm``
configs (:func:`M.cross_attn_apply` over ``encoder_embeds`` projected by
``projector``) and, in ``ssm`` and ``hybrid`` configs, Mamba2 (SSD) layers.
With ``embed_inputs=False`` (the ``audio`` decoder) the model has no
``embed`` table and :func:`forward` takes ``embeds``.  The cache is the
dense arena (:func:`init_cache`: K/V rows for attention layers, the latents
``ckv``/``krope`` for MLA layers, the encoder's ``xk``/``xv`` for
cross-attention layers, the recurrent ``conv`` and fp32 ``state`` for SSM
layers) or, for plain-GQA attention-only models, the paged block pool
(:func:`init_paged_cache`, decode through ``block_tables``).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import modules as M
from repro_torch.models.config import ATTN, CROSS, SSM, ModelConfig
from repro_torch.models.modules import (ParamSpec, tree_leaves, tree_map,
                                        tree_unflatten)


# ===================================================================== #
# Specs
# ===================================================================== #
def _layer_specs(cfg: ModelConfig, spec) -> dict:
    D = cfg.d_model
    out = {"ln1": ParamSpec((D,), ("embed",), "ones")}
    if spec.kind == SSM:
        out["ssm"] = M.ssm_specs(cfg)
        return out
    if spec.kind == ATTN:
        out["attn"] = M.mla_specs(cfg) if cfg.mla else M.attn_specs(cfg)
    elif spec.kind == CROSS:
        out["xattn"] = M.cross_attn_specs(cfg)
    else:
        raise ValueError(spec.kind)
    out["ln2"] = ParamSpec((D,), ("embed",), "ones")
    out["mlp"] = M.moe_specs(cfg) if spec.moe else M.mlp_specs(cfg)
    return out


def _stack(specs, n: int):
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale),
                    specs, is_leaf=lambda x: isinstance(x, ParamSpec))


def param_specs(cfg: ModelConfig) -> dict:
    D, V = cfg.d_model, cfg.vocab_size
    out = {}
    if cfg.embed_inputs:
        out["embed"] = ParamSpec((V, D), ("vocab", "embed"))
    if cfg.arch_type == "vlm":
        out["projector"] = ParamSpec((cfg.encoder_dim, D), (None, "embed"))
    out["segments"] = tuple(
        _stack(tuple(_layer_specs(cfg, ls) for ls in seg.unit_spec),
               seg.n_units)
        for seg in cfg.segments())
    out["final_norm"] = ParamSpec((D,), ("embed",), "ones")
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype: torch.dtype = None) -> dict:
    """Parameters in ``dtype`` (default ``cfg.param_dtype``) on
    ``generator``'s device.  Every leaf is drawn in fp32 and rounded, so a
    bf16 tree is the fp32 tree's rounding, bit for bit, without the fp32
    tree ever existing whole."""
    return M.init_tree(param_specs(cfg), generator, dtype or cfg.pdtype)


def count_params(cfg: ModelConfig) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(
        param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))))


# ===================================================================== #
# Caches
# ===================================================================== #
def _layer_cache_shapes(cfg: ModelConfig, spec, batch: int, max_len: int):
    if spec.kind == SSM:
        return M.ssm_cache_shape(cfg, batch)
    if spec.kind == CROSS:
        kv, hd = cfg.n_kv_heads, cfg.head_dim
        return dict(xk=(batch, cfg.encoder_len, kv, hd),
                    xv=(batch, cfg.encoder_len, kv, hd))
    if cfg.mla:
        return M.mla_cache_shape(cfg, batch, max_len)
    win = spec.sliding_window or cfg.sliding_window
    return M.attn_cache_shape(cfg, batch, max_len, win)


def _cache_dtype(cfg: ModelConfig, key: str) -> torch.dtype:
    """Scale planes and the SSM state are fp32 (the state: R9, see
    :mod:`repro_torch.models.modules`); K/V rows are int8 under
    ``cfg.kv_quant``, else in the compute dtype, like the SSM ``conv``,
    MLA's latents ``ckv``/``krope`` and the encoder's ``xk``/``xv``, which
    ``kv_quant`` leaves as they are (the reference's rule, R15)."""
    if key.endswith("_scale") or key == "state":
        return torch.float32
    if cfg.kv_quant and key in ("k", "v"):
        return torch.int8
    return cfg.cdtype


def cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    """``(shape, dtype)`` leaves of the cache tree: per segment, a tuple of
    per-unit-layer dicts whose leaves stack ``n_units`` layers."""
    return tuple(
        tuple({k: ((seg.n_units,) + shp, _cache_dtype(cfg, k))
               for k, shp in _layer_cache_shapes(cfg, ls, batch,
                                                 max_len).items()}
              for ls in seg.unit_spec)
        for seg in cfg.segments())


def _zeros_of(struct, device):
    return tree_map(
        lambda s: torch.zeros(s[0], dtype=s[1], device=device), struct,
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], torch.dtype))


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return _zeros_of(cache_struct(cfg, batch, max_len), device)


def paged_cache_struct(cfg: ModelConfig, num_blocks: int, block_size: int):
    """``(shape, dtype)`` leaves of the **paged** cache tree: each attention
    layer holds a shared ``(num_blocks, block_size, KV, D)`` block pool
    instead of a per-slot arena (block 0 is the trash block; see
    :mod:`repro_torch.serving.block_pool`), stacked over ``n_units`` like
    the arena.  The per-slot block tables are not part of the tree: they
    are the same for every layer and go to :func:`forward` beside it.
    Full-context attention layers only; with ``cfg.kv_quant`` the pools are
    int8 with fp32 ``k_scale``/``v_scale`` planes ``(num_blocks, bs,
    KV)``."""
    segs = []
    for seg in cfg.segments():
        unit = []
        for ls in seg.unit_spec:
            if ls.kind != ATTN or ls.sliding_window or cfg.sliding_window:
                raise NotImplementedError(
                    "paged KV cache supports full-context attention "
                    f"layers only (got {ls})")
            shapes = M.paged_attn_cache_shape(cfg, num_blocks, block_size)
            unit.append({k: ((seg.n_units,) + shp, _cache_dtype(cfg, k))
                         for k, shp in shapes.items()})
        segs.append(tuple(unit))
    return tuple(segs)


def init_paged_cache(cfg: ModelConfig, num_blocks: int, block_size: int,
                     device=None):
    return _zeros_of(paged_cache_struct(cfg, num_blocks, block_size), device)


# ===================================================================== #
# Forward
# ===================================================================== #
def cast_params(cfg: ModelConfig, params):
    """Compute-dtype view of the (fp32 master) params.  A leaf already in
    the compute dtype is returned as is, so casting once up front (the
    serving engine does) makes the cast inside :func:`forward` free."""
    return tree_map(lambda p: p.to(cfg.cdtype)
                    if torch.is_floating_point(p) else p, params)


def _unstack(tree, n: int) -> list:
    """Stacked-layer tree -> list of ``n`` per-layer trees of views: one
    ``unbind`` per leaf, whose backward stacks the per-layer gradients
    once (indexing each layer would add a zero-filled stacked gradient per
    layer)."""
    per_leaf = [t.unbind(0) for t in tree_leaves(tree)]
    return [tree_unflatten(tree, [u[i] for u in per_leaf]) for i in range(n)]


def _layer(cfg: ModelConfig, spec, lp, x, positions, mode, lc, rope,
           block_tables=None, *, enc=None):
    """One layer: ``(x, aux)``, ``aux`` the MoE layer's aux loss or None.
    ``enc`` is the projected encoder states a cross-attention layer
    attends (None elsewhere)."""
    h = M.rmsnorm(x, lp["ln1"], cfg.rms_eps, cfg.use_kernels)
    if spec.kind == SSM:
        s, _ = M.ssm_apply(cfg, lp["ssm"], h, mode=mode, cache=lc)
        return x + s, None
    if spec.kind == CROSS:
        if enc is None and mode != "decode":
            raise ValueError(f"{cfg.name}: a cross-attention layer needs "
                             "encoder_embeds")
        att, _ = M.cross_attn_apply(cfg, lp["xattn"], h, enc, mode=mode,
                                    cache=lc)
    else:
        win = spec.sliding_window or cfg.sliding_window
        fn = M.mla_apply if cfg.mla else M.attn_apply
        att, _ = fn(cfg, lp["attn"], h, positions=positions, mode=mode,
                    cache=lc, window=win, block_tables=block_tables,
                    rope=rope)
    x = x + att
    h2 = M.rmsnorm(x, lp["ln2"], cfg.rms_eps, cfg.use_kernels)
    if spec.moe:
        m, aux = M.moe_apply(cfg, lp["mlp"], h2)
        return x + m, aux
    return x + M.mlp_apply(lp["mlp"], h2, cfg), None


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            encoder_embeds=None, mode: str = "full", cache=None,
            positions=None, block_tables=None):
    """Returns (hidden (B,L,D), cache, aux_loss).

    mode='full'    — training / scoring, no cache.
    mode='prefill' — like full but also fills ``cache``.
    mode='decode'  — single token step; ``positions`` is (B,1) absolute.

    The input is ``tokens`` (B, L) when ``cfg.embed_inputs``, else
    ``embeds`` (B, L, D).  A ``vlm`` config's cross-attention layers attend
    ``encoder_embeds`` (B, Le, encoder_dim) @ ``projector`` in 'full' and
    'prefill'; in 'decode' they read the K/V their prefill cached, and
    ``encoder_embeds`` may be left out (the reference projects it anyway and
    never reads the result).

    ``block_tables`` ((B, nb) int32) switches decode to the paged layout:
    ``cache`` is then the pool tree of :func:`init_paged_cache`.

    ``cache`` is updated in place and returned (the reference returns a new
    tree built from its donated input)."""
    params = cast_params(cfg, params)
    x = params["embed"][tokens] if cfg.embed_inputs else embeds
    x = x.to(cfg.cdtype)
    B, L = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(L, device=x.device)[None].expand(B, L)
    # RoPE's cos / sin, shared by every layer (MLA rotates its dr dims only;
    # an SSM stack has no RoPE)
    rope = (M.rope_cos_sin(positions, cfg.qk_rope_head_dim if cfg.mla
                           else cfg.head_dim, cfg.rope_theta)
            if cfg.n_heads else None)
    enc = None
    if (cfg.arch_type == "vlm" and encoder_embeds is not None
            and mode != "decode"):
        enc = encoder_embeds.to(cfg.cdtype) @ params["projector"]
    # activation checkpointing: each layer's activations are recomputed in
    # the backward instead of kept (the reference's jax.checkpoint)
    remat = cfg.remat and mode == "full" and torch.is_grad_enabled()
    # the MoE layers' aux losses, summed in fp32 in layer order (the
    # reference's scan carry)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for si, seg in enumerate(cfg.segments()):
        layer_params = _unstack(params["segments"][si], seg.n_units)
        layer_caches = (_unstack(cache[si], seg.n_units)
                        if cache is not None else [None] * seg.n_units)
        for up, uc in zip(layer_params, layer_caches):
            for i, spec in enumerate(seg.unit_spec):
                lc = uc[i] if uc is not None else None
                if remat:
                    x, a = checkpoint(_layer, cfg, spec, up[i], x,
                                      positions, mode, lc, rope, enc=enc,
                                      use_reentrant=False)
                else:
                    x, a = _layer(cfg, spec, up[i], x, positions, mode, lc,
                                  rope, block_tables, enc=enc)
                if a is not None:
                    aux = aux + a
    x = M.rmsnorm(x, params["final_norm"], cfg.rms_eps, cfg.use_kernels)
    return x, cache, aux


def lm_head(cfg: ModelConfig, params):
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    return head.to(cfg.cdtype)


def logits_fn(cfg: ModelConfig, params, hidden):
    return (hidden @ lm_head(cfg, params)).float()


def _chunks(L: int, chunk: int):
    chunk = min(chunk or L, L)
    return [(c0, min(c0 + chunk, L)) for c0 in range(0, L, chunk)]


def _nll_chunk(h, head, labels, mask):
    """Summed masked NLL of one chunk of positions, and the mask's sum."""
    logits = (h @ head).float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    return ((lse - gold) * mask).sum(), mask.sum()


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask, count=None):
    """Chunked cross-entropy over ``cfg.logit_chunk`` positions at a time;
    each chunk is checkpointed, so its (B, chunk, V) fp32 logits are
    recomputed in the backward and never kept (vocabs reach 202k).
    ``count``, when given, divides the masked sum in place of the mask's
    own sum (a data-parallel rank divides by the global batch's)."""
    head = lm_head(cfg, params)
    labels = labels.long()
    mask = mask.float()
    remat = torch.is_grad_enabled()
    tot = torch.zeros((), dtype=torch.float32, device=hidden.device)
    cnt = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0, c1 in _chunks(hidden.shape[1], cfg.logit_chunk):
        args = (hidden[:, c0:c1], head, labels[:, c0:c1], mask[:, c0:c1])
        nll, m = (checkpoint(_nll_chunk, *args, use_reentrant=False)
                  if remat else _nll_chunk(*args))
        tot, cnt = tot + nll, cnt + m
    return tot / torch.clamp(cnt if count is None else count, min=1.0)


def per_token_logprobs(cfg: ModelConfig, params, hidden, labels):
    """log p(labels | context) per position (B, L) fp32, chunked like
    :func:`lm_loss`."""
    head = lm_head(cfg, params)
    labels = labels.long()
    out = []
    for c0, c1 in _chunks(hidden.shape[1], cfg.logit_chunk):
        logits = (hidden[:, c0:c1] @ head).float()
        lse = torch.logsumexp(logits, dim=-1)
        gold = torch.gather(logits, -1, labels[:, c0:c1, None])[..., 0]
        out.append(gold - lse)
    return torch.cat(out, dim=1)
