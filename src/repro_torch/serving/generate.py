"""Batched autoregressive generation: prefill + decode loop (counterpart of
``repro/serving/generate.py``).

This is the RLHF *experience generation* hot loop the paper identifies as
memory-bandwidth-bound: each step touches every weight once to emit one
token per sequence.  Prompts are fixed-length per batch (the paper's own
recipe: 256 prompt + 256 generated tokens); the cache is preallocated to
``prompt_len + max_new_tokens`` and updated in place.

``generate`` always runs the full ``max_new_tokens``; the serving-grade
path with early exit and continuous batching is
:mod:`repro_torch.serving.engine`, which reuses :func:`decode_scan_step`.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.serving.sampling import sample


def prefill(cfg: ModelConfig, params, tokens, cache, *, embeds=None,
            encoder_embeds=None):
    """Run the prompt through the model, filling ``cache`` in place (the
    cross-attention layers' ``xk``/``xv`` from ``encoder_embeds`` too).
    ``embeds`` (B, L, D) is the prompt of an embedding-input model.
    Returns (last-position logits (B, V), cache)."""
    hidden, cache, _ = T.forward(cfg, params, tokens=tokens, embeds=embeds,
                                 encoder_embeds=encoder_embeds,
                                 mode="prefill", cache=cache)
    logits = T.logits_fn(cfg, params, hidden[:, -1:])[:, 0]
    return logits, cache


def decode_step(cfg: ModelConfig, params, token, cache, position, *,
                embeds=None, encoder_embeds=None, block_tables=None):
    """One decode step.  token: (B,) int; position: (B,) absolute; an
    embedding-input model takes ``embeds`` (B, 1, D) in place of
    ``token``.  Cross-attention layers read the K/V their prefill cached,
    so ``encoder_embeds`` is accepted and not needed.  Returns (logits (B,
    V), cache), the cache updated in place.  With ``block_tables`` set,
    ``cache`` is the paged block pool (see
    :func:`repro_torch.models.transformer.init_paged_cache`)."""
    kw = ({"tokens": token[:, None]} if cfg.embed_inputs
          else {"embeds": embeds})
    hidden, cache, _ = T.forward(cfg, params, mode="decode", cache=cache,
                                 positions=position[:, None],
                                 encoder_embeds=encoder_embeds,
                                 block_tables=block_tables, **kw)
    logits = T.logits_fn(cfg, params, hidden)[:, 0]
    return logits, cache


def decode_scan_step(cfg: ModelConfig, params, *, temperature: float,
                     top_k: int, eos_id: Optional[int], top_p: float = 1.0,
                     noise_rows=None):
    """The per-step body shared by :func:`generate` and the chunked engine
    decode.

    Carry is ``(logits, cache, generator, pos, done)``; the per-step output
    is ``(tok, was_done)`` where ``was_done`` is the *pre-step* done flag:
    the step that emits the first EOS still records ``was_done=False``
    (the EOS token itself counts as generated), every later step forces
    ``eos_id`` out of the sampler with ``was_done=True``.  ``noise_rows``
    goes to :func:`~repro_torch.serving.sampling.sample`.
    """
    def step(carry):
        logits, cache, gen, pos, done = carry
        tok = sample(logits, gen, temperature=temperature, top_k=top_k,
                     top_p=top_p, noise_rows=noise_rows)
        if eos_id is not None:
            tok = torch.where(done, eos_id, tok)
        logits, cache = decode_step(cfg, params, tok, cache, pos)
        new_done = done | (tok == eos_id) if eos_id is not None else done
        return (logits, cache, gen, pos + 1, new_done), (tok, done)
    return step


def generate(cfg: ModelConfig, params, tokens, generator: torch.Generator,
             *, max_new_tokens: int, temperature: float = 1.0,
             top_k: int = 0, top_p: float = 1.0,
             eos_id: Optional[int] = None, encoder_embeds=None):
    """tokens: (B, Lp) fixed-length prompts on the params' device;
    ``encoder_embeds`` (B, Le, encoder_dim) for a ``vlm`` model, whose
    cross-attention K/V the prefill caches once.

    Returns a dict with ``sequences`` (B, Lp + max_new), ``response_mask``
    (B, Lp + max_new) bool — True exactly on generated tokens up to and
    including the first EOS — and the filled ``cache``.  With
    ``eos_id=None`` no sequence ever finishes."""
    B, Lp = tokens.shape
    params = T.cast_params(cfg, params)
    cache = T.init_cache(cfg, B, Lp + max_new_tokens, device=tokens.device)
    logits, cache = prefill(cfg, params, tokens, cache,
                            encoder_embeds=encoder_embeds)
    step = decode_scan_step(cfg, params, temperature=temperature,
                            top_k=top_k, top_p=top_p, eos_id=eos_id)
    carry = (logits, cache, generator,
             torch.full((B,), Lp, dtype=torch.long, device=tokens.device),
             torch.zeros((B,), dtype=torch.bool, device=tokens.device))
    toks, was = [], []
    for _ in range(max_new_tokens):
        carry, (tok, was_done) = step(carry)
        toks.append(tok)
        was.append(was_done)
    gen = (torch.stack(toks, 1) if toks
           else tokens.new_zeros((B, 0)))
    resp = (~torch.stack(was, 1) if was
            else torch.zeros((B, 0), dtype=torch.bool, device=tokens.device))
    sequences = torch.cat([tokens, gen.to(tokens.dtype)], dim=1)
    mask = torch.cat([torch.zeros((B, Lp), dtype=torch.bool,
                                  device=tokens.device), resp], dim=1)
    return {"sequences": sequences, "response_mask": mask,
            "cache": carry[1]}
