"""Serving-grade generation: early-exit decode + a stepwise request core
(counterpart of ``repro/serving/engine.py``, dense KV layout).

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

The KV arena is the **dense** layout: a fixed ``(slots, S)`` arena in
which every slot reserves ``max_seq_len`` rows for its lifetime, in the
compute dtype or, with ``cfg.kv_quant``, as int8 rows with fp32 per-row
scale planes.  Where the reference donates the arena to each jitted call
and rebinds the result, the port updates it in place: admission prefills
straight into the slot's arena rows (and scale rows) and decode writes one
row per slot per step.  The paged layout, the prefix cache and meshes are
not ported yet and raise ``NotImplementedError``.

Ragged prefill correctness: prompts are right-padded to a shape bucket and
prefilled with causal attention, so real tokens never attend padding.  The
padded KV rows beyond the true prompt length are garbage, but decode
attention only exposes cache rows ``< pos + 1`` and the first decode steps
overwrite exactly those rows (row ``pos`` is written before ``pos`` becomes
visible), so the garbage is dead by construction.  The same holds for the
stale rows a previous occupant of the slot left behind.
"""
from __future__ import annotations

import dataclasses
from collections import deque
from typing import Any, Dict, List, Optional, Sequence, Set

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.modules import tree_map
from repro_torch.serving.generate import (decode_scan_step, decode_step,
                                          prefill)
from repro_torch.serving.sampling import sample_rows


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
    - ``preempted``: the request was evicted and requeued (paged layout
      only; never raised by the dense layout).

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
    :meth:`generate` path uses them for the whole batch, while the
    request-level core resolves them per request against each
    :class:`SamplingParams`.  Params are passed per call (fp32 masters or
    already in the compute dtype); ``device`` defaults to CUDA and must be
    where the params live.
    """

    def __init__(self, cfg: ModelConfig, *, max_new_tokens: int,
                 temperature: float = 1.0, top_k: int = 0,
                 top_p: float = 1.0, eos_id: Optional[int] = None,
                 chunk: int = 32, kv_layout: str = "dense",
                 prefix_cache: bool = False, mesh=None, device=None):
        if kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout={kv_layout!r}")
        if prefix_cache and kv_layout != "paged":
            raise ValueError("prefix_cache requires kv_layout='paged'")
        if kv_layout == "paged" or prefix_cache:
            raise NotImplementedError("paged KV cache / prefix cache: "
                                      "not yet ported")
        if mesh is not None:
            raise NotImplementedError("device meshes: not yet ported")
        T.cache_struct(cfg, 1, 1)            # raises for unported archs
        self.cfg = cfg
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
    def generate(self, params, tokens, generator: torch.Generator):
        """Same ``sequences`` / ``response_mask`` contract and tokens as
        :func:`repro_torch.serving.generate.generate`, but decode stops once
        every sequence has emitted EOS.  ``self.last_stats`` records how
        many decode steps actually ran.  Draws advance ``generator``."""
        cfg = self.cfg
        if not isinstance(tokens, torch.Tensor):
            tokens = torch.as_tensor(np.asarray(tokens))
        tokens = tokens.to(device=self.device, dtype=torch.long)
        B, Lp = tokens.shape
        max_new = self.max_new_tokens
        if max_new == 0:
            self.last_stats = {"decode_steps": 0, "scheduled_tokens": 0,
                               "generated_tokens": 0}
            return {"sequences": tokens,
                    "response_mask": torch.zeros((B, Lp), dtype=torch.bool,
                                                 device=self.device)}
        params = T.cast_params(cfg, params)
        cache = T.init_cache(cfg, B, Lp + max_new, device=self.device)
        logits, cache = prefill(cfg, params, tokens, cache)
        step = decode_scan_step(cfg, params, temperature=self.temperature,
                                top_k=self.top_k, top_p=self.top_p,
                                eos_id=self.eos_id)
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
                    and bool(carry[4].all())):
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
    def _prefill_row(self, params, tokens, length, row):
        """Prefill one padded prompt into the single-row cache ``row`` (in
        place); returns the logits of the TRUE last prompt token
        (``length`` is the unpadded prompt length)."""
        cfg = self.cfg
        hidden, _, _ = T.forward(cfg, params, tokens=tokens, mode="prefill",
                                 cache=row)
        h_last = hidden[0, length - 1]
        return T.logits_fn(cfg, params, h_last[None, None])[0, 0]

    def _serve_chunk(self, core: "EngineCore", cache):
        """``chunk`` decode steps over the whole arena with per-slot stop
        limits (absolute position ``prompt_len + max_new_tokens``) and
        per-slot sampling tensors, run back to back on the device.  Updates
        the core's logits/pos/done and returns the (chunk, slots) tokens
        and pre-step done flags, still on the device."""
        cfg, params = self.cfg, core.params
        temp, top_k, top_p, eos = core.sampling_tensors()
        pad_tok = torch.where(eos >= 0, eos, 0)
        logits, pos, done, limit = core.logits, core.pos, core.done, \
            core.limit
        toks, was = [], []
        for _ in range(self.chunk):
            tok = sample_rows(logits, core.generator, temperature=temp,
                              top_k=top_k, top_p=top_p,
                              row_generators=core.slot_generators)
            tok = torch.where(done, pad_tok, tok)
            logits, cache = decode_step(cfg, params, tok, cache, pos)
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
        """Build a stepwise :class:`EngineCore` bound to ``params``."""
        return EngineCore(self, params, generator, slots=slots,
                          max_seq_len=max_seq_len, num_blocks=num_blocks,
                          watermark=watermark)

    def serve(self, params, requests: Sequence[Request],
              generator: torch.Generator, *, slots: int = 8,
              max_seq_len: Optional[int] = None,
              num_blocks: Optional[int] = None,
              watermark: Optional[int] = None) -> List[Completion]:
        """Drain a queue of ragged requests through the stepwise core and
        return their :class:`Completion`\\ s in finish order.  Free slots
        are refilled at chunk boundaries; each slot attends only its own
        arena rows, so greedy results equal running each request alone."""
        if num_blocks is not None or watermark is not None:
            raise ValueError("num_blocks/watermark require kv_layout='paged'")
        need = max((len(r.tokens) + self.resolve(r)[3] for r in requests),
                   default=1)
        S = max_seq_len or need
        if need > S:
            raise ValueError(f"max_seq_len={S} < longest request ({need})")
        core = self.core(params, generator, slots=slots, max_seq_len=S)
        prompts: Dict[int, np.ndarray] = {}
        for r in requests:
            core.add_request(r)
            prompts[r.uid] = np.asarray(r.tokens)
        streams: Dict[int, List[int]] = {}
        out: List[Completion] = []
        while core.has_work():
            for ev in core.step():
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
# the dense cache backend
# ===================================================================== #
class _DenseBackend:
    """Fixed ``(slots, S)`` KV arena: a slot owns ``S`` rows for life, so
    admission needs nothing beyond a free slot and release is free."""

    def __init__(self, core: "EngineCore"):
        self.core = core
        self.cache = T.init_cache(core.cfg, core.slots, core.S,
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
        padded = _pad_bucket(tokens, min(_next_bucket(Lp), c.S))
        # the slot's arena rows (K/V and, with int8 KV, their scale
        # planes) as a one-row cache: prefill writes in place
        row = tree_map(lambda a: a[:, slot:slot + 1], self.cache)
        logit = e._prefill_row(c.params, torch.as_tensor(
            padded, device=e.device), Lp, row)
        c.logits[slot] = logit
        c.pos[slot] = Lp
        c.done[slot] = False
        c.limit[slot] = Lp + max_new

    def prepare_chunk(self, events: List[StepEvent]) -> None:
        pass                                   # nothing to top up

    def dispatch(self):
        return self.core.engine._serve_chunk(self.core, self.cache)

    def release(self, slot: int) -> None:
        pass                                   # rows are reused in place

    def stats(self) -> dict:
        return {}


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
    """

    def __init__(self, engine: GenerationEngine, params,
                 generator: torch.Generator, *, slots: int = 8,
                 max_seq_len: int, num_blocks: Optional[int] = None,
                 watermark: Optional[int] = None):
        cfg = engine.cfg
        if num_blocks is not None or watermark is not None:
            raise ValueError("num_blocks/watermark require kv_layout='paged'")
        dev = engine.device
        if params["embed"].device != dev:
            raise ValueError(f"params on {params['embed'].device}, engine "
                             f"on {dev}")
        self.engine = engine
        self.cfg = cfg
        self.params = T.cast_params(cfg, params)
        self.slots = int(slots)
        self.S = int(max_seq_len)

        # device state of the decode loop
        self.generator = generator
        self.logits = torch.zeros((self.slots, cfg.vocab_size),
                                  dtype=torch.float32, device=dev)
        self.pos = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        self.done = torch.ones((self.slots,), dtype=torch.bool, device=dev)
        self.limit = torch.zeros((self.slots,), dtype=torch.long, device=dev)
        # a seeded request's own generator; None = the shared one
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
        self._live: Set[int] = set()           # uids queued or running
        self._cancelled: Set[int] = set()

        self.admitted = 0
        self.chunks = 0
        self.completed = 0
        self.gen_tokens = 0

        self.backend = _DenseBackend(self)

    # ---------------------------------------------------------------- #
    @property
    def n_active(self) -> int:
        return sum(a is not None for a in self.active)

    def has_work(self) -> bool:
        """Whether another :meth:`step` would make progress (requests
        queued or in flight)."""
        return bool(self.queue) or self.n_active > 0

    def sampling_tensors(self):
        """The per-slot (temperature, top_k, top_p, eos) tensors."""
        dev = self.engine.device
        return tuple(torch.as_tensor(a, device=dev) for a in
                     (self._temp, self._topk, self._topp, self._eos))

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

    # ---------------------------------------------------------------- #
    def release_slot(self, b: int) -> None:
        """Free slot ``b``.  The slot's device state keeps decoding garbage
        into its own arena row until the next admission resets it; nothing
        reads it."""
        self.backend.release(b)
        self.active[b] = None

    def _finish(self, b: int, new: np.ndarray, reason: str,
                events: List[StepEvent]) -> None:
        a = self.active[b]
        self.gen_tokens += len(a.toks)
        self.completed += 1
        self._live.discard(a.req.uid)
        events.append(StepEvent(uid=a.req.uid, new_tokens=new,
                                finished=True, finish_reason=reason))
        self.release_slot(b)

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
            self.done[b] = True
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
        self.slot_generators[b] = None if seed is None else \
            torch.Generator(device=self.engine.device).manual_seed(seed)
        self.active[b] = _Active(req=r, max_new=max_new, eos=eos)
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
        self.backend.prepare_chunk(events)
        toks, was = self.backend.dispatch()
        self.chunks += 1
        # the one host sync of the chunk
        toks_h = toks.cpu().numpy().astype(np.int32)
        was_h = was.cpu().numpy()
        done_h = self.done.cpu().numpy()
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
