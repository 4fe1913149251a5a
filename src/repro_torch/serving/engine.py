"""Serving-grade generation: early-exit decode + a stepwise request core
(counterpart of ``repro/serving/engine.py``).

1. **Early-exit decode** (:meth:`GenerationEngine.generate`): decode runs
   in ``chunk``-token segments; after each segment the (tiny) ``done``
   vector is read on the host and no further segments run once every
   sequence has emitted EOS.  The token stream is the one
   :func:`repro_torch.serving.generate.generate` produces (same
   :func:`decode_scan_step` body, same generator draws).

2. **Stepwise continuous batching** (:class:`EngineCore`): the vLLM-style
   ``add_request() / step()`` core.  A slot scheduler admits
   variable-length prompts into a ``slots``-wide KV arena; each slot
   carries its own absolute position, stop limit, sampling parameters and
   done flag.  ``step()`` runs ``chunk`` decode steps back to back on the
   device and synchronizes with the host once, at the chunk boundary,
   where it returns :class:`StepEvent`\\ s.

Per-request sampling is vectorized over the slots: temperature / top-k /
top-p / EOS ride along as ``(slots,)`` tensors into
:func:`repro_torch.serving.sampling.sample_rows`.  Requests without a
``seed`` draw from the core's shared ``torch.Generator``; a seeded request
draws from its own generator, so its stream does not depend on the batch.

The KV cache behind the core comes in two layouts (``kv_layout``), cache
backends behind the same scheduling loop, in the compute dtype or, with
``cfg.kv_quant``, as int8 rows with fp32 per-row scale planes:

- ``"dense"``: a fixed ``(slots, S)`` arena in which every slot reserves
  ``max_seq_len`` rows for its lifetime.  Admission prefills straight into
  the slot's arena rows.
- ``"paged"``: a shared pool of ``block_size``-token blocks plus per-slot
  block tables (:mod:`repro_torch.serving.block_pool`).  A slot holds only
  the blocks its tokens occupy: prompt blocks are allocated and scattered
  at admission, decode blocks are appended at chunk boundaries (the host
  mirrors each slot's position, so a top-up never syncs the device), and
  release returns them.  Admission needs a free slot and enough free
  blocks for the prompt beyond a ``watermark`` reserve; when a top-up
  still finds the pool empty the newest slot is preempted and requeued at
  the queue front, so the oldest sequences always progress.  Decode
  attention walks the block table (the CUDA paged kernels on the card).
  With ``prefix_cache=True`` blocks are ref-counted and indexed by a
  content hash chained over their token prefix: admission maps the
  longest cached prefix into the slot's table as shared read-only blocks
  and prefills only the uncached suffix against the gathered prefix KV
  (rectangular causal masking, positions ``P0 + arange(Lb)``), and
  harvest parks a finished sequence's full blocks in an LRU, evicted
  before any preemption.  Given the same admission order, the paged
  token streams are the dense layout's.  With the cache they are the same
  up to rounding: the suffix prefill computes the full prefill's logits
  with GEMMs of another row count, so in bf16 a near-tie may flip a greedy
  token (fp32 streams are identical).

Where the reference donates the cache to each jitted call and rebinds the
result, the port updates it in place: decode writes one row per slot per
step (into the arena row, or into the block its table names).

On a mesh (``mesh=``, a ``("data", "model")`` ``DeviceMesh``; the Hybrid
Engine hands it over when the mesh has more than one rank, and
``launch/serve.py --mesh dp,tp`` builds one with a process a device) each
rank computes on the params' compute view
(:func:`repro_torch.sharding.runtime.compute_view`: gathered over
``data``, its heads, MLP width, vocabulary rows or experts over ``model``)
and its KV arena or pool holds its own kv heads.  Every rank of a model
group samples from the same logits, all-gathered over ``model``, with the
same generator.  Rows and slots are split over ``data`` in contiguous
shares (:func:`repro_torch.sharding.runtime.data_share`; a count that
does not divide ``data`` is held whole on every data rank):

- :meth:`GenerationEngine.generate` decodes the data rank's rows of the
  batch, drawing the noise the whole batch would, and returns the global
  batch's ``sequences`` and ``response_mask`` on every rank; the data
  ranks agree on every early exit (one all-reduce a chunk).
- :meth:`GenerationEngine.core` returns one mesh-wide core: every rank
  holds the same host state and takes the same host decisions
  (admission, preemption, EOS, block tables), so every rank emits the
  same events, completions and ``stats()``, those of the core on one
  device with the same ``slots`` and ``num_blocks``.  The dense arena
  holds the data rank's share of the slots; the paged pool stays whole on
  every data rank (a prefix-cache block one slot writes is read by
  others), which then computes every slot.  The one host sync of a chunk
  gathers its tokens and done flags over ``data``.
  :meth:`GenerationEngine.serve` drains that core.
- An MoE layer routes the data group's rows together, as the reference
  routes the global batch (R13): a decode step routes every slot (or row)
  in order, idle and finished ones with the pad token, and a core's
  admission routes exactly the prompt's padded bucket, the other data
  ranks joining with no rows.

At 1 x 1 the mesh paths make their collectives on one-rank groups and
compute the plain path's bits.

Ragged prefill correctness: prompts are right-padded to a shape bucket and
prefilled with causal attention, so real tokens never attend padding.  The
padded KV rows beyond the true prompt length are garbage, but decode
attention only exposes cache rows ``< pos + 1`` and the first decode steps
overwrite exactly those rows (row ``pos`` is written before ``pos`` becomes
visible), so the garbage is dead by construction.  The same holds for the
stale rows a previous occupant of the slot left behind.  In the paged
layout, padding rows past the prompt's last allocated block (and post-EOS
decode writes before harvest) fall through the table's trash padding into
block 0, which nothing reads; a finished slot with a fully allocated table
wraps such writes into its own last block instead, which the prefix cache
never indexes.

An MLA model's arena holds its latents (``ckv``, ``krope``) per slot, in
the dense layout only.  A ``vlm`` model generates through
:meth:`GenerationEngine.generate` with ``encoder_embeds``, its
cross-attention K/V cached once at prefill.  As in the reference, the paged
layout refuses MLA and VLM models, and :class:`EngineCore` refuses VLM and
embedding-input (audio) models.

Architectures with recurrent state (SSM / hybrid) cannot skip pad tokens
this way: a pad token would enter the SSM state.  So for them admission
prefills at the exact prompt length, never a bucket, and it overwrites the
slot's whole ``conv`` and ``state`` rows, so nothing of a slot's previous
occupant survives.  Those models run on the dense layout only, as in the
reference.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.kernels.paged_attention import check_tables
from repro_torch.models import transformer as T
from repro_torch.models.config import ATTN, ModelConfig
from repro_torch.models.modules import tree_map
from repro_torch.serving.block_pool import (TRASH_BLOCK, BlockAllocator,
                                            BlockTables, blocks_for)
from repro_torch.serving.generate import (decode_scan_step, decode_step,
                                          prefill)
from repro_torch.serving.sampling import sample_rows
from repro_torch.sharding import runtime


class _Unset:
    """Sentinel distinguishing "not set, use the engine default" from an
    explicit ``None`` (e.g. ``eos_id=None`` = never stop on a token)."""
    def __repr__(self):
        return "<unset>"


UNSET = _Unset()


@dataclasses.dataclass(frozen=True)
class SamplingParams:
    """Per-request sampling configuration.  Every field defaults to "use
    the engine default".

    - ``temperature``: ``<= 0`` is greedy.
    - ``top_k`` / ``top_p``: ``0`` / ``1.0`` disable the filter.
    - ``max_new_tokens``: per-request budget override.
    - ``eos_id``: stop-token override; explicit ``None`` disables
      stopping on a token for this request.
    - ``seed``: when set, the request samples from its own
      ``torch.Generator`` seeded with it, so its stream is reproducible
      whatever else is in the batch.
    """
    temperature: Optional[float] = None
    top_k: Optional[int] = None
    top_p: Optional[float] = None
    max_new_tokens: Optional[int] = None
    eos_id: Any = UNSET
    seed: Optional[int] = None


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request: a variable-length prompt plus its budget
    and (optional) sampling parameters."""
    uid: int
    tokens: np.ndarray                 # (Lp,) int32 prompt
    max_new_tokens: Optional[int] = None
    params: SamplingParams = SamplingParams()


@dataclasses.dataclass(frozen=True)
class Completion:
    uid: int
    prompt: np.ndarray                 # (Lp,) int32
    tokens: np.ndarray                 # generated tokens, EOS included
    finish_reason: str                 # "eos" | "length" | "cancelled"


def _no_tokens() -> np.ndarray:
    return np.zeros((0,), np.int32)


@dataclasses.dataclass(frozen=True)
class StepEvent:
    """One per-request occurrence at a chunk boundary.

    - ``new_tokens``: tokens decoded for this request during the step
      (empty for pure state changes).
    - ``finished`` + ``finish_reason``: the request completed; its slot is
      already reclaimed.
    - ``preempted``: the paged pool ran dry and this request was evicted
      and requeued at the queue front; every token streamed for it so far
      is invalid and will be generated again.

    (A numpy array is not a valid dataclass default; the reference's
    ``new_tokens = np.zeros(0)`` default fails on Python 3.12, so this one
    uses a factory.)
    """
    uid: int
    new_tokens: np.ndarray = dataclasses.field(default_factory=_no_tokens)
    finished: bool = False
    finish_reason: Optional[str] = None
    preempted: bool = False


def _next_bucket(n: int, lo: int = 8) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def _pad_bucket(tokens: np.ndarray, width: int) -> np.ndarray:
    """Right-pad a 1-D token array to a (1, width) prefill batch."""
    out = np.zeros((1, width), np.int64)
    out[0, :len(tokens)] = np.asarray(tokens)
    return out


def _scatter_row_blocks(pool, row, blk_ids, bs: int) -> None:
    """Scatter a single-row prefill cache (leaves ``(n_units, 1, Lb,
    ...)``) block-wise into the paged pool at ``blk_ids``, in place: the
    one pool-write primitive of both paged admission paths.  Rows past the
    last real block land in the trash entries ``blk_ids`` is padded with
    (duplicate trash indices are fine: nothing reads block 0).  Only the
    pool's own leaves are read from ``row`` (not a prefix history)."""
    nbp = blk_ids.shape[0]

    def scatter(pool_leaf, row_leaf):
        r = row_leaf[:, 0]                    # (n_units, Lb, ...)
        pad = nbp * bs - r.shape[1]
        if pad:
            r = torch.cat([r, r.new_zeros((r.shape[0], pad) + r.shape[2:])],
                          dim=1)
        pool_leaf[:, blk_ids] = r.reshape((r.shape[0], nbp, bs)
                                          + r.shape[2:])

    tree_map(scatter, pool, row)


def _with_history(row, pool, prefix_ids):
    """``row``'s per-layer dicts with the read-only prefix history gathered
    from the pool blocks ``prefix_ids``: ``hk``/``hv`` ``(n_units, 1, P0,
    KV, hd)``, and with an int8 pool their ``hk_scale``/``hv_scale``."""
    if isinstance(row, dict):
        def gather(leaf):
            h = leaf[:, prefix_ids]            # (n_units, n_pre, bs, ...)
            return h.reshape((h.shape[0], 1, h.shape[1] * h.shape[2])
                             + h.shape[3:])
        out = {**row, "hk": gather(pool["k"]), "hv": gather(pool["v"])}
        if "k_scale" in pool:                  # int8 pool: scales travel
            out["hk_scale"] = gather(pool["k_scale"])
            out["hv_scale"] = gather(pool["v_scale"])
        return out
    return tuple(_with_history(r, p, prefix_ids) for r, p in zip(row, pool))


@dataclasses.dataclass
class _Active:
    """Host-side state of one occupied slot."""
    req: Request
    max_new: int
    eos: Optional[int]
    toks: List[int] = dataclasses.field(default_factory=list)


class GenerationEngine:
    """Engine for experience generation and the serve launcher.

    Construction-time sampling settings are *defaults*: the fixed-batch
    :meth:`generate` path uses them for the whole batch (always on the
    dense arena, as in the reference), while the request-level core
    resolves them per request against each :class:`SamplingParams` and
    runs on the ``kv_layout`` backend.  Params are passed per call (fp32
    masters or already in the compute dtype); ``device`` defaults to CUDA
    and must be where the params live.
    """

    def __init__(self, cfg: ModelConfig, *, max_new_tokens: int,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 chunk: int = 32, kv_layout: str = "dense",
                 block_size: int = 16, prefix_cache: bool = False,
                 mesh=None, device=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={kv_layout!r}")
        if prefix_cache and kv_layout != "paged":
            raise ValueError("prefix_cache requires kv_layout='paged'")
        T.cache_struct(cfg, 1, 1)            # raises for unported archs
        self.kv_layout = kv_layout
        self.block_size = max(1, int(block_size))
        self.prefix_cache = bool(prefix_cache)
        # exact-length prefill for layers with recurrent state (see the
        # module docstring); pure-attention stacks use shape buckets
        self._exact_prefill = any(
            ls.kind != ATTN for seg in cfg.segments() for ls in seg.unit_spec)
        if kv_layout == "paged":
            # raises for SSM and sliding-window layers; MLA caches latents
            # (dense geometry only)
            if cfg.mla or cfg.arch_type == "vlm":
                raise NotImplementedError(
                    "paged KV cache supports plain-GQA token-input "
                    "decoder LMs (no MLA / VLM)")
            T.paged_cache_struct(cfg, 2, self.block_size)
        self.cfg = cfg
        self.mesh = mesh
        self.device = resolve_device(device)
        self.max_new_tokens = int(max_new_tokens)
        self.temperature = float(temperature)
        self.top_k = int(top_k)
        self.top_p = float(top_p)
        self.eos_id = eos_id
        self.chunk = max(1, int(chunk))
        self.last_stats: dict = {}

    # ================================================================ #
    # fixed-batch path with early exit (PPO experience generation)
    # ================================================================ #
    def generate(self, params, tokens, generator: torch.Generator, *,
                 encoder_embeds=None):
        """Same ``sequences`` / ``response_mask`` contract and tokens as
        :func:`repro_torch.serving.generate.generate`, but decode stops once
        every sequence has emitted EOS.  ``self.last_stats`` records how
        many decode steps actually ran.  Draws advance ``generator``.  A
        ``vlm`` model takes ``encoder_embeds`` (B, Le, encoder_dim): the
        prefill caches each cross-attention layer's K/V once, and decode
        reads them there.

        On a mesh each data rank decodes its share of the rows
        (:func:`~repro_torch.sharding.runtime.data_share`), drawing the
        noise the whole batch would; an MoE layer routes the data group's
        rows of the prefill and of every step together (R13), and the data
        ranks exit early together.  Every rank returns the whole batch."""
        params, tp = self._view(params)
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(device=self.device, dtype=torch.long)
        if encoder_embeds is not None:
            encoder_embeds = torch.as_tensor(encoder_embeds).to(self.device)
        B = tokens.shape[0]
        r0, r1, group = runtime.data_share(B, self.mesh)
        if group is None:          # one device, or every rank every row
            return self._generate(params, tokens, generator, encoder_embeds,
                                  tp=tp)
        out = self._generate(params, tokens[r0:r1], generator,
                             None if encoder_embeds is None
                             else encoder_embeds[r0:r1], noise_rows=(r0, B),
                             tp=tp.with_rows(group), group=group)
        seqs = runtime.gather_rows(out["sequences"], group)
        mask = runtime.gather_rows(
            out["response_mask"].to(torch.uint8), group).bool()
        steps = self.last_stats["decode_steps"]
        self.last_stats = {"decode_steps": steps,
                           "scheduled_tokens": B * steps,
                           "generated_tokens": int(mask.sum())}
        return {"sequences": seqs, "response_mask": mask}

    def _view(self, params):
        """``(the params this rank computes on, the tensor-parallel
        context)``: the whole params without a mesh, else their compute
        view (after :func:`~repro_torch.sharding.runtime.
        check_compute_mesh`)."""
        if self.mesh is None:
            return runtime.full_tree(params), None
        runtime.check_compute_mesh(self.mesh, "GenerationEngine", self.cfg)
        view, _, tp = runtime.mesh_view(self.cfg, params, self.mesh)
        return view, tp

    def _generate(self, params, tokens, generator: torch.Generator,
                  encoder_embeds=None, noise_rows=None, tp=None, group=None):
        """:meth:`generate` on one device (``noise_rows``: see
        :func:`~repro_torch.serving.sampling.sample`; ``tp``: the
        tensor-parallel context of a compute view ``params``; ``group``:
        the data group whose ranks take every early exit together)."""
        cfg = self.cfg
        B, Lp = tokens.shape
        max_new = self.max_new_tokens
        if max_new == 0:
            self.last_stats = {"decode_steps": 0, "scheduled_tokens": 0,
                               "generated_tokens": 0}
            return {"sequences": tokens,
                    "response_mask": torch.zeros((B, Lp), dtype=torch.bool,
                                                 device=self.device)}
        params = T.cast_params(cfg, params)
        cache = T.init_cache(T.local_cfg(cfg, params), B, Lp + max_new,
                             device=self.device)
        logits, cache = prefill(cfg, params, tokens, cache,
                                encoder_embeds=encoder_embeds, tp=tp)
        step = decode_scan_step(cfg, params, temperature=self.temperature,
                                top_k=self.top_k, top_p=self.top_p,
                                eos_id=self.eos_id, noise_rows=noise_rows,
                                tp=tp)
        carry = (logits, cache, generator,
                 torch.full((B,), Lp, dtype=torch.long, device=self.device),
                 torch.zeros((B,), dtype=torch.bool, device=self.device))

        # without an EOS there is nothing to exit early on: one segment,
        # no per-chunk host sync
        chunk = self.chunk if self.eos_id is not None else max_new
        tok_parts, was_parts, steps = [], [], 0
        while steps < max_new:
            n = min(chunk, max_new - steps)
            toks, was = [], []
            for _ in range(n):
                carry, (tok, was_done) = step(carry)
                toks.append(tok)
                was.append(was_done)
            tok_parts.append(torch.stack(toks).cpu().numpy())
            was_parts.append(torch.stack(was).cpu().numpy())
            steps += n
            if (self.eos_id is not None and steps < max_new
                    and runtime.all_true(carry[4], group)):
                break

        gen = np.concatenate(tok_parts, axis=0).T          # (B, steps)
        was_done = np.concatenate(was_parts, axis=0).T
        if steps < max_new:                                # early exit: pad
            pad = max_new - steps
            gen = np.concatenate(
                [gen, np.full((B, pad), self.eos_id, gen.dtype)], axis=1)
            was_done = np.concatenate(
                [was_done, np.ones((B, pad), bool)], axis=1)
        sequences = np.concatenate([tokens.cpu().numpy(), gen], axis=1)
        mask = np.concatenate([np.zeros((B, Lp), bool), ~was_done], axis=1)
        self.last_stats = {
            "decode_steps": steps,
            "scheduled_tokens": B * steps,
            "generated_tokens": int(mask.sum()),
        }
        return {"sequences": torch.as_tensor(sequences, device=self.device),
                "response_mask": torch.as_tensor(mask, device=self.device)}

    # ================================================================ #
    # admission and the serve chunk
    # ================================================================ #
    def _prefill_row(self, params, tokens, length, row, positions=None,
                     tp=None):
        """Prefill one padded prompt into the single-row cache ``row`` (in
        place); returns the logits of the TRUE last prompt token
        (``length`` is the unpadded prompt length).  A prefix-cache
        admission passes the suffix, its ``positions`` and a ``row`` that
        carries the prefix history.  A data rank that joins another rank's
        admission (an MoE layer routes the data group's rows together)
        passes ``tokens`` and ``row`` of no rows and gets ``None``."""
        cfg = self.cfg
        hidden, _, _ = T.forward(cfg, params, tokens=tokens, mode="prefill",
                                 cache=row, positions=positions, tp=tp)
        if tokens.shape[0] == 0:
            return None
        h_last = hidden[0, length - 1]
        return T.logits_fn(cfg, params, h_last[None, None], tp)[0, 0]

    def _serve_chunk(self, core: "EngineCore", cache, block_tables=None):
        """``chunk`` decode steps over the whole slot batch with per-slot
        stop limits (absolute position ``prompt_len + max_new_tokens``) and
        per-slot sampling tensors, run back to back on the device; with
        ``block_tables`` the KV is read and written through them (the same
        step body for both layouts).  Updates the core's logits/pos/done
        and returns the (chunk, slots) tokens and pre-step done flags,
        still on the device: on a mesh, of the rank's slots, which draw
        the whole slot batch's shared noise and route an MoE layer with
        the data group's slots."""
        cfg, params = self.cfg, core.params
        temp, top_k, top_p, eos = core.sampling_tensors()
        pad_tok = torch.where(eos >= 0, eos, 0)
        logits, pos, done, limit = core.logits, core.pos, core.done, \
            core.limit
        toks, was = [], []
        for _ in range(self.chunk):
            tok = sample_rows(logits, core.generator, temperature=temp,
                              top_k=top_k, top_p=top_p,
                              row_generators=core.slot_generators[
                                  core.s0:core.s1],
                              noise_rows=core.noise_rows)
            tok = torch.where(done, pad_tok, tok)
            logits, cache = decode_step(cfg, params, tok, cache, pos,
                                        block_tables=block_tables,
                                        tp=core.decode_tp)
            toks.append(tok)
            was.append(done)
            done = done | (pos + 1 >= limit) | ((eos >= 0) & (tok == eos))
            pos = pos + 1
        core.logits, core.pos, core.done = logits, pos, done
        return torch.stack(toks), torch.stack(was)

    # ================================================================ #
    # request-level API
    # ================================================================ #
    def resolve(self, r: Request):
        """Resolve a request's effective (temperature, top_k, top_p,
        max_new, eos, seed) against the engine defaults."""
        p = r.params or SamplingParams()
        temp = self.temperature if p.temperature is None else p.temperature
        top_k = self.top_k if p.top_k is None else p.top_k
        top_p = self.top_p if p.top_p is None else p.top_p
        if p.max_new_tokens is not None:
            max_new = p.max_new_tokens
        elif r.max_new_tokens is not None:
            max_new = r.max_new_tokens
        else:
            max_new = self.max_new_tokens
        eos = self.eos_id if p.eos_id is UNSET else p.eos_id
        return float(temp), int(top_k), float(top_p), int(max_new), eos, \
            p.seed

    def core(self, params, generator: torch.Generator, *, slots: int = 8,
             max_seq_len: int, num_blocks: Optional[int] = None,
             watermark: Optional[int] = None) -> "EngineCore":
        """Build a stepwise :class:`EngineCore` bound to ``params`` (on a
        mesh, the mesh-wide core over their compute view)."""
        params, tp = self._view(params)
        return EngineCore(self, params, generator, slots=slots,
                          max_seq_len=max_seq_len, num_blocks=num_blocks,
                          watermark=watermark, tp=tp)

    def serve(self, params, requests: Sequence[Request],
              generator: torch.Generator, *, slots: int = 8,
              max_seq_len: Optional[int] = None,
              num_blocks: Optional[int] = None,
              watermark: Optional[int] = None) -> List[Completion]:
        """Drain a queue of ragged requests through the stepwise core and
        return their :class:`Completion`\\ s in finish order.  Free slots
        are refilled at chunk boundaries; each slot attends only its own
        rows, so greedy results equal running each request alone.  On a
        mesh it drains the one mesh-wide core, and every rank returns the
        same completions and ``last_stats``.

        With ``kv_layout="paged"``, ``num_blocks`` sizes the shared pool
        (default: dense-arena parity, ``slots * ceil(S / block_size)``
        usable blocks plus the trash block) and ``watermark`` is the
        free-block reserve kept by admission (default: one chunk of decode
        appends per running slot).  Both are refused for the dense
        layout."""
        if self.kv_layout != "paged" and (num_blocks is not None
                                          or watermark is not None):
            raise ValueError("num_blocks/watermark require kv_layout='paged'")
        need = max((len(r.tokens) + self.resolve(r)[3] for r in requests),
                   default=1)
        S = max_seq_len or need
        if need > S:
            raise ValueError(f"max_seq_len={S} < longest request ({need})")
        core = self.core(params, generator, slots=slots, max_seq_len=S,
                         num_blocks=num_blocks, watermark=watermark)
        prompts: Dict[int, np.ndarray] = {}
        for r in requests:
            core.add_request(r)
            prompts[r.uid] = np.asarray(r.tokens)
        streams: Dict[int, List[int]] = {}
        out: List[Completion] = []
        while core.has_work():
            for ev in core.step():
                if ev.preempted:
                    streams[ev.uid] = []       # generated again from scratch
                    continue
                buf = streams.setdefault(ev.uid, [])
                buf.extend(ev.new_tokens.tolist())
                if ev.finished:
                    out.append(Completion(
                        uid=ev.uid, prompt=prompts[ev.uid],
                        tokens=np.asarray(streams.pop(ev.uid), np.int32),
                        finish_reason=ev.finish_reason))
        self.last_stats = core.stats()
        return out


# ===================================================================== #
# cache backends: the dense arena and the paged block pool present the
# same check / admit / prepare / dispatch / release surface to the core
# ===================================================================== #
class _DenseBackend:
    """Fixed ``(slots, S)`` KV arena: a slot owns ``S`` rows for life, so
    admission needs nothing beyond a free slot and release is free."""

    wants_seq_tokens = False           # release() ignores seq_tokens

    def __init__(self, core: "EngineCore"):
        self.core = core
        # the rank's slots [s0, s1) on a mesh (every slot otherwise)
        self.cache = T.init_cache(core.cache_cfg, core.s1 - core.s0, core.S,
                                  device=core.engine.device)

    def check(self, uid: int, Lp: int, max_new: int) -> None:
        if Lp + max_new > self.core.S:
            raise ValueError(
                f"request {uid} needs {Lp + max_new} KV rows > "
                f"max_seq_len={self.core.S}")

    def can_admit(self, n_prompt_tokens: int) -> bool:
        return True

    def admit(self, slot: int, tokens: np.ndarray, Lp: int,
              max_new: int) -> None:
        c, e = self.core, self.core.engine
        padded = torch.as_tensor(_pad_bucket(
            tokens, Lp if e._exact_prefill else min(_next_bucket(Lp), c.S)),
            device=e.device)
        if c.owns(slot):
            # the slot's arena rows (K/V and, with int8 KV, their scale
            # planes; an SSM layer's whole conv and state rows) as a
            # one-row cache: prefill writes in place
            i = slot - c.s0
            row = tree_map(lambda a: a[:, i:i + 1], self.cache)
            logit = e._prefill_row(c.params, padded, Lp, row,
                                   tp=c.admit_tp(slot))
            c.slot_reset(slot, logit, Lp, max_new)
        elif c.join_admissions:
            # another data rank's slot: its MoE layers gather this rank's
            # rows too, which are none
            e._prefill_row(c.params, padded[:0], Lp,
                           tree_map(lambda a: a[:, :0], self.cache),
                           tp=c.admit_tp(slot))

    def prepare_chunk(self, events: List[StepEvent]) -> None:
        pass                                   # nothing to top up

    def dispatch(self):
        return self.core.engine._serve_chunk(self.core, self.cache)

    def release(self, slot: int,
                seq_tokens: Optional[np.ndarray] = None) -> None:
        pass                                   # rows are reused in place

    def stats(self) -> dict:
        return {}


class _PagedBackend:
    """Block-pooled KV cache: admission allocates prompt blocks under a
    watermark reserve, every chunk boundary tops tables up to cover the
    next chunk (preempting the newest slot if the pool runs dry), and
    release returns a slot's blocks to the pool.

    With ``prefix_cache`` on, admission first matches the prompt against
    the allocator's content-hash index and maps the longest cached prefix
    (full blocks only) into the slot's table as shared read-only blocks;
    only the uncached suffix is prefilled, against the gathered prefix KV,
    into freshly allocated private blocks.  Tail blocks are copied, never
    shared: decode appends (positions ``>= prompt_len``) land strictly past
    the shared prefix.  Harvest indexes a finished sequence's full blocks
    instead of freeing them (they park in the allocator's LRU once
    unreferenced), and allocation evicts those before the engine ever
    preempts a running slot."""

    def __init__(self, core: "EngineCore", num_blocks: Optional[int],
                 watermark: Optional[int]):
        self.core = core
        e = core.engine
        bs = e.block_size
        self.nbmax = core.S // bs
        if num_blocks is None:
            num_blocks = core.slots * self.nbmax + 1   # arena parity + trash
        self.num_blocks = num_blocks
        self.alloc = BlockAllocator(num_blocks, bs)
        self.tables = BlockTables(self.alloc, core.slots, self.nbmax)
        self.watermark = watermark
        self.prefix_cache = e.prefix_cache
        # release() harvests into the index only with the cache on; the
        # core skips building the stream otherwise
        self.wants_seq_tokens = self.prefix_cache
        # admission reserve: ``watermark`` blocks, or one chunk of decode
        # appends per *running* slot
        self.chunk_blocks = blocks_for(e.chunk, bs)
        self.pool = T.init_paged_cache(core.cache_cfg, num_blocks, bs,
                                       device=e.device)
        # host mirror of pos/limit: admission sets them and every chunk
        # advances every slot by exactly ``chunk`` steps, so a top-up never
        # reads device state
        self.host_pos = [0] * core.slots
        self.host_limit = [0] * core.slots
        self.conc: List[int] = []
        self.used_samples: List[int] = []
        self.cached_prefill_tokens = 0         # prompt rows served by cache
        self.computed_prefill_tokens = 0       # prompt rows prefilled

    def check(self, uid: int, Lp: int, max_new: int) -> None:
        if Lp + max_new > self.core.S:
            raise ValueError(
                f"request {uid} needs {Lp + max_new} KV rows > "
                f"max_seq_len={self.core.S}")
        if not self.alloc.fits(Lp + max_new):
            raise ValueError(
                f"request {uid} needs "
                f"{self.alloc.blocks_for(Lp + max_new)} blocks; "
                f"pool holds {self.alloc.capacity}")

    def can_admit(self, n_prompt_tokens: int) -> bool:
        # the watermark is waived when nothing runs: the reserve protects
        # nobody and waiting would wedge the scheduler
        n_active = self.core.n_active
        reserve = (self.watermark if self.watermark is not None
                   else n_active * self.chunk_blocks)
        return self.alloc.can_admit(n_prompt_tokens, reserve=reserve,
                                    ignore_watermark=n_active == 0)

    def admit(self, slot: int, tokens: np.ndarray, Lp: int,
              max_new: int) -> None:
        c, e = self.core, self.core.engine
        bs, dev = e.block_size, e.device
        tokens = np.asarray(tokens, np.int32)
        # one hash pass serves both the match and the insert below
        keys = self.alloc.chunk_keys(tokens) if self.prefix_cache else None
        shared = (self.alloc.match(tokens, keys=keys)
                  if self.prefix_cache else [])
        P0 = len(shared) * bs                  # cached prefix rows
        Ls = Lp - P0                           # uncached suffix (>= 1)
        own = self.alloc.alloc(self.alloc.blocks_for(Lp) - len(shared))
        assert own is not None, "can_admit must bound admission demand"
        self.tables.assign(slot, shared + own)
        self.cached_prefill_tokens += P0
        self.computed_prefill_tokens += Ls
        padded = _pad_bucket(tokens[P0:], min(_next_bucket(Ls), c.S - P0))
        Lb = padded.shape[1]
        blk_ids = np.full((-(-Lb // bs),), TRASH_BLOCK, np.int64)
        blk_ids[:len(own)] = own
        row = T.init_cache(c.cache_cfg, 1, Lb, device=dev)
        positions = None
        if shared:
            # the suffix attends [prefix; suffix] with rectangular causal
            # masking at its absolute positions; shared blocks are read,
            # never written
            row = _with_history(row, self.pool, torch.as_tensor(
                np.asarray(shared, np.int64), device=dev))
            positions = P0 + torch.arange(Lb, device=dev)[None]
        logit = e._prefill_row(c.params, torch.as_tensor(padded, device=dev),
                               Ls, row, positions, tp=c.tp)
        _scatter_row_blocks(self.pool, row,
                            torch.as_tensor(blk_ids, device=dev), bs)
        c.slot_reset(slot, logit, Lp, max_new)
        if self.prefix_cache:
            # index the prompt's full blocks now, so batchmates (PPO's n
            # samples of one prompt, chat turns sharing a system prompt)
            # hit them before this sequence finishes; the running slot
            # never writes them (decode appends start at ``Lp``)
            self.alloc.insert(tokens, self.tables.blocks[slot], keys=keys)
        self.host_pos[slot] = Lp
        self.host_limit[slot] = Lp + max_new

    def prepare_chunk(self, events: List[StepEvent]) -> None:
        """Top up every active slot's table to cover the next chunk;
        preempt the newest slot on pool exhaustion (the oldest always
        progresses, so the scheduler cannot deadlock)."""
        c = self.core
        active = [b for b in range(c.slots) if c.active[b] is not None]
        for b in sorted(active, key=lambda x: c.stamp[x]):
            if c.active[b] is None:              # preempted this round
                continue
            cover = min(self.host_pos[b] + c.engine.chunk,
                        self.host_limit[b])
            want = min(self.alloc.blocks_for(cover), self.nbmax)
            while not self.tables.grow(b, want):
                # evict the newest sequence overall, possibly the
                # requester itself, so an older slot is never starved by
                # a younger one
                victims = [v for v in range(c.slots)
                           if c.active[v] is not None]
                if not victims:      # unreachable: check() bounds demand
                    raise RuntimeError("paged KV pool exhausted with "
                                       "no slot to preempt")
                victim = max(victims, key=lambda v: c.stamp[v])
                c.release_slot(victim, requeue=True, events=events)
                if victim == b:
                    break

    def dispatch(self):
        c, e = self.core, self.core.engine
        self.conc.append(c.n_active)
        self.used_samples.append(self.alloc.num_live)
        check_tables(self.tables.table, self.num_blocks)
        tables = torch.as_tensor(self.tables.table, device=e.device)
        out = e._serve_chunk(c, self.pool, tables)   # one upload a chunk
        for b in range(c.slots):
            self.host_pos[b] += e.chunk
        return out

    def release(self, slot: int,
                seq_tokens: Optional[np.ndarray] = None) -> None:
        """Drop the slot's block references.  On a harvest with the cache
        on (``seq_tokens`` = prompt + generated stream) the sequence's full
        blocks are indexed first, so they park in the LRU once
        unreferenced; except the last block of a FULLY allocated table,
        whose rows a finished slot's clamped post-EOS writes may have
        wrapped into: it is never indexed."""
        if self.prefix_cache and seq_tokens is not None:
            blocks = self.tables.blocks[slot]
            n_ok = len(blocks)
            if n_ok == self.nbmax:
                n_ok -= 1
            self.alloc.insert(seq_tokens, blocks[:n_ok])
        self.tables.release(slot)

    def stats(self) -> dict:
        bs = self.core.engine.block_size
        total_prefill = (self.cached_prefill_tokens
                         + self.computed_prefill_tokens)
        return {
            "preemptions": self.core.preemptions,
            "max_concurrency": max(self.conc, default=0),
            "mean_concurrency": (float(np.mean(self.conc))
                                 if self.conc else 0.0),
            "block_size": bs,
            "num_blocks": self.num_blocks,
            "block_high_water": self.alloc.high_water,
            "mean_blocks_used": (float(np.mean(self.used_samples))
                                 if self.used_samples else 0.0),
            "kv_budget_tokens": self.alloc.capacity * bs,
            "prefix_cache": self.prefix_cache,
            "cached_prefill_tokens": self.cached_prefill_tokens,
            "computed_prefill_tokens": self.computed_prefill_tokens,
            "prefill_hit_rate": (self.cached_prefill_tokens / total_prefill
                                 if total_prefill else 0.0),
            **self.alloc.cache_stats(),
        }


# ===================================================================== #
# the stepwise core
# ===================================================================== #
class EngineCore:
    """Stepwise request-level serving core::

        core = engine.core(params, generator, slots=8, max_seq_len=256)
        core.add_request(Request(uid=0, tokens=prompt,
                                 params=SamplingParams(temperature=0.7,
                                                       top_p=0.9)))
        while core.has_work():
            for ev in core.step():          # one chunk of decode
                consume(ev)                 # stream tokens / finishes

    ``add_request`` queues a request (FIFO) and returns its uid; ``step``
    admits into free slots, runs one ``chunk``-step decode over the whole
    slot batch, and harvests the boundary into :class:`StepEvent`\\ s;
    ``cancel`` marks a request so its slot is reclaimed at the next chunk
    boundary.

    The params are cast to the compute dtype once, here, so the decode
    steps never re-cast the fp32 masters.

    On a mesh (``engine.mesh``; ``params`` the rank's compute view, ``tp``
    its tensor-parallel context) the core is mesh-wide: every rank holds
    the same host state (queue, slots, block tables, counters), takes the
    same host decisions and returns the same :class:`StepEvent`\\ s.  The
    dense arena holds the data rank's contiguous share of the slots
    (:func:`~repro_torch.sharding.runtime.data_share`; every slot where
    ``data`` does not divide them), the paged pool stays whole on every
    data rank, which then computes every slot; either holds the rank's kv
    heads.  A slot's admission prefills on the rank that holds it (an MoE
    layer's other data ranks join with no rows), a decode step samples the
    rank's slots from the whole slot batch's shared noise and routes an
    MoE layer with the data group's slots, in slot order, and the one host
    sync of a chunk gathers its tokens and done flags over ``data``.
    """

    def __init__(self, engine: GenerationEngine, params,
                 generator: torch.Generator, *, slots: int = 8,
                 max_seq_len: int, num_blocks: Optional[int] = None,
                 watermark: Optional[int] = None, tp=None):
        cfg = engine.cfg
        if cfg.arch_type == "vlm" or not cfg.embed_inputs:
            raise NotImplementedError(
                "continuous batching supports token-input decoder LMs")
        if engine.kv_layout != "paged" and (num_blocks is not None
                                            or watermark is not None):
            raise ValueError("num_blocks/watermark require kv_layout='paged'")
        dev = engine.device
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {dev}")
        self.engine = engine
        self.cfg = cfg
        self.params = T.cast_params(cfg, params)
        # the tensor-parallel context of a compute view ``params``, and the
        # config of the rank's KV (its own kv heads)
        self.tp = tp
        self.cache_cfg = T.local_cfg(cfg, params)
        self.slots = int(slots)
        # this data rank's slots [s0, s1) and the data group they are
        # split over (None: every rank holds every slot; always so on the
        # paged pool); the decode step's context routes an MoE layer with
        # the group's slots, and the shared noise is drawn for every slot
        self.s0, self.s1, self.group = (
            runtime.data_share(self.slots, engine.mesh)
            if engine.kv_layout == "dense" else (0, self.slots, None))
        split = self.group is not None
        self.decode_tp = tp.with_rows(self.group) if split else tp
        self.noise_rows = (self.s0, self.slots) if split else None
        # a data rank that does not hold a slot joins its admission when
        # an MoE layer gathers the data group's rows
        self.join_admissions = (split and cfg.moe
                                and self.group.size() > 1)
        S = int(max_seq_len)
        if engine.kv_layout == "paged":        # a whole number of blocks
            S = -(-S // engine.block_size) * engine.block_size
        self.S = S

        # device state of the decode loop
        self.generator = generator
        n = self.s1 - self.s0                  # the rank's slots
        self.logits = torch.zeros((n, cfg.vocab_size), dtype=torch.float32,
                                  device=dev)
        self.pos = torch.zeros((n,), dtype=torch.long, device=dev)
        self.done = torch.ones((n,), dtype=torch.bool, device=dev)
        self.limit = torch.zeros((n,), dtype=torch.long, device=dev)
        # a seeded request's own generator, on the rank that holds its
        # slot; None = the shared one
        self.slot_generators: List[Optional[torch.Generator]] = \
            [None] * self.slots

        # host truth for the per-slot sampling tensors (uploaded each
        # chunk; they only change at admission)
        self._temp = np.full((self.slots,), 1.0, np.float32)
        self._topk = np.zeros((self.slots,), np.int64)
        self._topp = np.ones((self.slots,), np.float32)
        self._eos = np.full((self.slots,), -1, np.int64)

        self.queue: deque = deque()
        self.active: List[Optional[_Active]] = [None] * self.slots
        self.stamp = [0] * self.slots          # admission order, newest=max
        self._tick = 0
        self._live: Set[int] = set()           # uids queued or running
        self._cancelled: Set[int] = set()

        self.admitted = 0                      # includes re-admissions
        self.chunks = 0
        self.completed = 0
        self.gen_tokens = 0
        self.preemptions = 0

        self.backend = (_PagedBackend(self, num_blocks, watermark)
                        if engine.kv_layout == "paged"
                        else _DenseBackend(self))

    # ---------------------------------------------------------------- #
    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self.active)

    def has_work(self) -> bool:
        """Whether another :meth:`step` would make progress (requests
        queued or in flight)."""
        return bool(self.queue) or self.n_active > 0

    def sampling_tensors(self):
        """The per-slot (temperature, top_k, top_p, eos) tensors of the
        rank's slots."""
        dev = self.engine.device
        return tuple(torch.as_tensor(a[self.s0:self.s1], device=dev) for a in
                     (self._temp, self._topk, self._topp, self._eos))

    def owns(self, slot: int) -> bool:
        """Whether this rank holds slot ``slot``'s device state."""
        return self.s0 <= slot < self.s1

    def admit_tp(self, slot: int):
        """The tensor-parallel context of slot ``slot``'s admission: with
        the slots split over ``data``, an MoE layer routes the prompt rows
        of the rank that holds the slot, and none of the others'."""
        if self.group is None:
            return self.tp
        n = self.s1 - self.s0
        return self.tp.with_rows(self.group, tuple(
            int(r == slot // n) for r in range(self.group.size())))

    def add_request(self, r: Request) -> int:
        """Queue a request (FIFO).  Validates that it can ever run under
        this core's geometry; returns its uid (the cancel handle)."""
        if r.uid in self._live:
            raise ValueError(f"uid {r.uid} is already queued or running")
        max_new = self.engine.resolve(r)[3]
        if max_new > 0:
            self.backend.check(r.uid, len(r.tokens), max_new)
        self.queue.append(r)
        self._live.add(r.uid)
        return r.uid

    def cancel(self, uid: int) -> bool:
        """Cancel a queued or in-flight request.  Reclamation happens at
        the next chunk boundary, where :meth:`step` emits a
        ``finish_reason="cancelled"`` event.  Returns whether the uid was
        live."""
        if uid not in self._live:
            return False
        self._cancelled.add(uid)
        return True

    def slot_reset(self, slot: int, logit, Lp: int, max_new: int) -> None:
        """Reset slot ``slot``'s decode state for a fresh admission (on
        the rank that holds it)."""
        i = slot - self.s0
        self.logits[i] = logit
        self.pos[i] = Lp
        self.done[i] = False
        self.limit[i] = Lp + max_new

    # ---------------------------------------------------------------- #
    def release_slot(self, b: int, *, requeue: bool,
                     events: Optional[List[StepEvent]] = None,
                     seq_tokens: Optional[np.ndarray] = None) -> None:
        """Free slot ``b`` (under the paged backend its blocks go back to
        the pool, or on a harvest with the prefix cache into the cache
        LRU); with ``requeue`` its request goes back to the queue front
        (preemption).  The slot's device state keeps decoding garbage
        (dense: into its own arena row; paged: into the trash block) until
        the next admission resets it; nothing reads it."""
        a = self.active[b]
        self.backend.release(b, seq_tokens)
        if requeue and a is not None:
            self.queue.appendleft(a.req)
            self.preemptions += 1
            if events is not None:
                events.append(StepEvent(uid=a.req.uid, preempted=True))
        self.active[b] = None

    def _finish(self, b: int, new: np.ndarray, reason: str,
                events: List[StepEvent]) -> None:
        a = self.active[b]
        self.gen_tokens += len(a.toks)
        self.completed += 1
        self._live.discard(a.req.uid)
        events.append(StepEvent(uid=a.req.uid, new_tokens=new,
                                finished=True, finish_reason=reason))
        # harvest the finished stream into the prefix cache (a cancelled
        # stream too: its blocks hold exactly prompt + streamed rows); only
        # the prefix-caching backend reads it
        seq = None
        if self.backend.wants_seq_tokens:
            seq = np.concatenate([np.asarray(a.req.tokens, np.int32),
                                  np.asarray(a.toks, np.int32)])
        self.release_slot(b, requeue=False, seq_tokens=seq)

    def _process_cancels(self, events: List[StepEvent]) -> None:
        if not self._cancelled:
            return
        kept: deque = deque()
        for r in self.queue:                   # cancelled before admission
            if r.uid in self._cancelled:
                self._cancelled.discard(r.uid)
                self._live.discard(r.uid)
                self.completed += 1
                events.append(StepEvent(uid=r.uid, finished=True,
                                        finish_reason="cancelled"))
            else:
                kept.append(r)
        self.queue = kept
        for b in range(self.slots):            # cancelled mid-flight
            a = self.active[b]
            if a is None or a.req.uid not in self._cancelled:
                continue
            self._cancelled.discard(a.req.uid)
            # stop the lane from decoding garbage until the slot refills
            if self.owns(b):
                self.done[b - self.s0] = True
            self._finish(b, _no_tokens(), "cancelled", events)

    def _admit_phase(self, events: List[StepEvent]) -> None:
        for b in range(self.slots):
            if self.active[b] is not None:
                continue
            r = None
            while self.queue:
                cand = self.queue[0]
                max_new = self.engine.resolve(cand)[3]
                if max_new <= 0:               # zero budget: trivially done
                    self.queue.popleft()
                    self._live.discard(cand.uid)
                    self.completed += 1
                    events.append(StepEvent(uid=cand.uid, finished=True,
                                            finish_reason="length"))
                    continue
                if not self.backend.can_admit(len(cand.tokens)):
                    break                      # backpressure: head waits
                r = self.queue.popleft()
                break
            if r is None:
                if not self.queue:
                    continue                   # drained; try other slots
                break                          # FIFO: never admit past head
            self._admit(b, r)

    def _admit(self, b: int, r: Request) -> None:
        temp, top_k, top_p, max_new, eos, seed = self.engine.resolve(r)
        Lp = len(r.tokens)
        self.backend.admit(b, np.asarray(r.tokens), Lp, max_new)
        self._temp[b], self._topk[b], self._topp[b] = temp, top_k, top_p
        self._eos[b] = -1 if eos is None else eos
        self.slot_generators[b] = (
            None if seed is None or not self.owns(b)
            else torch.Generator(device=self.engine.device).manual_seed(seed))
        self.active[b] = _Active(req=r, max_new=max_new, eos=eos)
        self._tick += 1
        self.stamp[b] = self._tick
        self.admitted += 1

    def step(self) -> List[StepEvent]:
        """Advance the core by one chunk boundary: reclaim cancelled
        requests, refill free slots from the queue, run ``chunk`` decode
        steps over the slot batch, and harvest the boundary into events.
        Returns immediately (possibly with queued-state events only) when
        nothing is decodable."""
        events: List[StepEvent] = []
        self._process_cancels(events)
        self._admit_phase(events)
        if self.n_active == 0:
            return events
        self.backend.prepare_chunk(events)     # paged top-up / preemption
        if self.n_active == 0:
            return events
        toks, was = self.backend.dispatch()
        self.chunks += 1
        # the one host sync of the chunk (every data rank's slots, with
        # the slots split over data)
        toks_h, was_h, done_h = runtime.gather_chunk(toks, was, self.done,
                                                     self.group)
        for b in range(self.slots):
            a = self.active[b]
            if a is None:
                continue
            new = toks_h[~was_h[:, b], b]
            a.toks.extend(new.tolist())
            if done_h[b]:
                gen = np.asarray(a.toks, np.int32)
                by_eos = (a.eos is not None and gen.size > 0
                          and int(gen[-1]) == a.eos
                          and gen.size < a.max_new)
                self._finish(b, new, "eos" if by_eos else "length", events)
            elif new.size:
                events.append(StepEvent(uid=a.req.uid, new_tokens=new))
        return events

    def stats(self) -> dict:
        """Scheduler counters in the reference's ``last_stats`` shape."""
        e = self.engine
        d = {
            "requests": self.completed,
            "admitted": self.admitted,
            "decode_steps": self.chunks * e.chunk,
            "scheduled_tokens": self.chunks * e.chunk * self.slots,
            "generated_tokens": self.gen_tokens,
        }
        d.update(self.backend.stats())
        return d
