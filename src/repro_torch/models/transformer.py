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

Only dense attention layers are ported: SSM, cross-attention, MoE and MLA
segments raise ``NotImplementedError``.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models import modules as M
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.modules import (ParamSpec, tree_leaves, tree_map,
                                        tree_unflatten)


def _check_ported(cfg: ModelConfig) -> None:
    if cfg.mla or cfg.moe or not cfg.embed_inputs:
        raise NotImplementedError(
            f"{cfg.name}: only dense token-input GQA decoders are ported")
    for seg in cfg.segments():
        for ls in seg.unit_spec:
            if ls.kind != ATTN or ls.moe:
                raise NotImplementedError(
                    f"{cfg.name}: layer {ls} not yet ported")


# ===================================================================== #
# Specs
# ===================================================================== #
def _layer_specs(cfg: ModelConfig, spec) -> dict:
    D = cfg.d_model
    return {"ln1": ParamSpec((D,), ("embed",), "ones"),
            "attn": M.attn_specs(cfg),
            "ln2": ParamSpec((D,), ("embed",), "ones"),
            "mlp": M.mlp_specs(cfg)}


def _stack(specs, n: int):
    return tree_map(lambda s: ParamSpec((n,) + s.shape, ("layers",) + s.axes,
                                        s.init, s.scale),
                    specs, is_leaf=lambda x: isinstance(x, ParamSpec))


def param_specs(cfg: ModelConfig) -> dict:
    _check_ported(cfg)
    D, V = cfg.d_model, cfg.vocab_size
    out = {"embed": ParamSpec((V, D), ("vocab", "embed"))}
    out["segments"] = tuple(
        _stack(tuple(_layer_specs(cfg, ls) for ls in seg.unit_spec),
               seg.n_units)
        for seg in cfg.segments())
    out["final_norm"] = ParamSpec((D,), ("embed",), "ones")
    if not cfg.tie_embeddings:
        out["lm_head"] = ParamSpec((D, V), ("embed", "vocab"))
    return out


def init_params(cfg: ModelConfig, generator: torch.Generator) -> dict:
    """Parameters in ``cfg.param_dtype`` on ``generator``'s device."""
    return M.init_tree(param_specs(cfg), generator, cfg.pdtype)


def count_params(cfg: ModelConfig) -> int:
    return int(sum(np.prod(s.shape) for s in tree_leaves(
        param_specs(cfg), is_leaf=lambda x: isinstance(x, ParamSpec))))


# ===================================================================== #
# Caches
# ===================================================================== #
def _layer_cache_shapes(cfg: ModelConfig, spec, batch: int, max_len: int):
    win = spec.sliding_window or cfg.sliding_window
    return M.attn_cache_shape(cfg, batch, max_len, win)


def _cache_dtype(cfg: ModelConfig, key: str) -> torch.dtype:
    """Scale planes are fp32; K/V rows are int8 under ``cfg.kv_quant``,
    else in the compute dtype."""
    if key.endswith("_scale"):
        return torch.float32
    if cfg.kv_quant and key in ("k", "v"):
        return torch.int8
    return cfg.cdtype


def cache_struct(cfg: ModelConfig, batch: int, max_len: int):
    """``(shape, dtype)`` leaves of the cache tree: per segment, a tuple of
    per-unit-layer dicts whose leaves stack ``n_units`` layers."""
    _check_ported(cfg)
    return tuple(
        tuple({k: ((seg.n_units,) + shp, _cache_dtype(cfg, k))
               for k, shp in _layer_cache_shapes(cfg, ls, batch,
                                                 max_len).items()}
              for ls in seg.unit_spec)
        for seg in cfg.segments())


def init_cache(cfg: ModelConfig, batch: int, max_len: int, device=None):
    return tree_map(
        lambda s: torch.zeros(s[0], dtype=s[1], device=device),
        cache_struct(cfg, batch, max_len),
        is_leaf=lambda x: isinstance(x, tuple) and len(x) == 2
        and isinstance(x[1], torch.dtype))


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


def _layer(cfg: ModelConfig, spec, lp, x, positions, mode, lc, rope):
    win = spec.sliding_window or cfg.sliding_window
    h = M.rmsnorm(x, lp["ln1"], cfg.rms_eps, cfg.use_kernels)
    att, _ = M.attn_apply(cfg, lp["attn"], h, positions=positions, mode=mode,
                          cache=lc, window=win, rope=rope)
    x = x + att
    h2 = M.rmsnorm(x, lp["ln2"], cfg.rms_eps, cfg.use_kernels)
    return x + M.mlp_apply(lp["mlp"], h2, cfg)


def forward(cfg: ModelConfig, params, *, tokens=None, embeds=None,
            mode: str = "full", cache=None, positions=None,
            block_tables=None):
    """Returns (hidden (B,L,D), cache, aux_loss).

    mode='full'    — training / scoring, no cache.
    mode='prefill' — like full but also fills ``cache``.
    mode='decode'  — single token step; ``positions`` is (B,1) absolute.

    ``cache`` is updated in place and returned (the reference returns a new
    tree built from its donated input)."""
    if block_tables is not None:
        raise NotImplementedError("paged KV cache: not yet ported")
    _check_ported(cfg)
    params = cast_params(cfg, params)
    x = params["embed"][tokens] if tokens is not None else embeds
    x = x.to(cfg.cdtype)
    B, L = x.shape[0], x.shape[1]
    if positions is None:
        positions = torch.arange(L, device=x.device)[None].expand(B, L)
    rope = M.rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta)
    # activation checkpointing: each layer's activations are recomputed in
    # the backward instead of kept (the reference's jax.checkpoint)
    remat = cfg.remat and mode == "full" and torch.is_grad_enabled()
    for si, seg in enumerate(cfg.segments()):
        layer_params = _unstack(params["segments"][si], seg.n_units)
        layer_caches = (_unstack(cache[si], seg.n_units)
                        if cache is not None else [None] * seg.n_units)
        for up, uc in zip(layer_params, layer_caches):
            for i, spec in enumerate(seg.unit_spec):
                lc = uc[i] if uc is not None else None
                if remat:
                    x = checkpoint(_layer, cfg, spec, up[i], x, positions,
                                   mode, lc, rope, use_reentrant=False)
                else:
                    x = _layer(cfg, spec, up[i], x, positions, mode, lc,
                               rope)
    x = M.rmsnorm(x, params["final_norm"], cfg.rms_eps, cfg.use_kernels)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
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


def lm_loss(cfg: ModelConfig, params, hidden, labels, mask):
    """Chunked cross-entropy over ``cfg.logit_chunk`` positions at a time;
    each chunk is checkpointed, so its (B, chunk, V) fp32 logits are
    recomputed in the backward and never kept (vocabs reach 202k)."""
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
    return tot / torch.clamp(cnt, min=1.0)


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
