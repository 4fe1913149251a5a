"""Greedy engine streams of the head-dim-128 GQA family and the MoE
decoder (``qwen3-8b``, ``yi-9b``, ``llama3.2-3b``,
``llama4-scout-17b-a16e``) against ``jax_greedy`` at reduced size on
carried-across weights, and for ``llama3.2-3b`` also on int8 KV and the
paged pool.

A MoE call's rows share the experts' capacity (ROADMAP Queue 3, R13), so
the MoE streams are compared where both sides route the same rows: one
slot, prompts as long as their prefill bucket.  The port's own dense and
paged MoE streams route the same rows when every slot is live, and must
then be equal.
"""
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, jax_greedy, params_pair
from repro_torch.serving.engine import GenerationEngine, Request

NEW = ("qwen3-8b", "yi-9b", "llama3.2-3b", "llama4-scout-17b-a16e")


def _streams(tcfg, tparams, reqs, slots, **kw):
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0, chunk=4,
                           device="cpu", **kw)
    return {c.uid: c.tokens.tolist() for c in
            eng.serve(tparams, reqs, torch.Generator().manual_seed(0),
                      slots=slots)}


@pytest.mark.parametrize("arch", NEW)
def test_engine_greedy_matches_jax(arch):
    """One slot, prompts of 8 and 16 tokens (their own bucket widths): the
    engine's prefill and decode rows are ``jax_greedy``'s."""
    jcfg, tcfg = config_pair(arch, use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=7)
    rng = np.random.default_rng(8)
    reqs = [Request(uid=i, tokens=rng.integers(0, jcfg.vocab_size, L)
                    .astype(np.int32), max_new_tokens=6)
            for i, L in enumerate((8, 16))]
    got = _streams(tcfg, tparams, reqs, slots=1)
    for r in reqs:
        assert got[r.uid] == jax_greedy(jcfg, jparams, r.tokens, 6)


@pytest.mark.parametrize("layout,quant", [("dense", True), ("paged", False),
                                          ("paged", True)],
                         ids=["int8", "paged", "paged-int8"])
def test_llama3_2_int8_and_paged_streams_match_jax(layout, quant):
    jcfg, tcfg = config_pair("llama3.2-3b", use_kernels=True,
                             kv_quant=quant)
    jparams, tparams = params_pair(jcfg, seed=9)
    rng = np.random.default_rng(10)
    reqs = [Request(uid=i, tokens=rng.integers(0, jcfg.vocab_size, L)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (L, mn) in enumerate(((3, 6), (7, 8), (5, 4), (6, 7)))]
    kw = dict(kv_layout="paged", block_size=4) if layout == "paged" else {}
    got = _streams(tcfg, tparams, reqs, slots=3, **kw)
    for r in reqs:
        assert got[r.uid] == jax_greedy(jcfg, jparams, r.tokens,
                                        r.max_new_tokens)


def test_moe_dense_and_paged_streams_are_equal_when_every_slot_is_live():
    """Dense and paged MoE route the same rows at every call when every
    slot holds a live sequence (equal requests filling the slots, admitted
    together, finishing together), so their greedy streams are equal.  An
    idle or finished slot would decode rows that differ by layout (its own
    arena rows against the trash block), and those share the capacity
    with the live rows (R13)."""
    _, tcfg = config_pair("llama4-scout-17b-a16e", use_kernels=True,
                          capacity_factor=1.0)
    _, tparams = params_pair(config_pair("llama4-scout-17b-a16e")[0],
                             seed=11)
    rng = np.random.default_rng(12)
    reqs = [Request(uid=i, tokens=rng.integers(0, tcfg.vocab_size, 6)
                    .astype(np.int32), max_new_tokens=7) for i in range(4)]
    dense = _streams(tcfg, tparams, reqs, slots=4)
    paged = _streams(tcfg, tparams, reqs, slots=4, kv_layout="paged",
                     block_size=4)
    assert dense == paged and len(dense) == 4
