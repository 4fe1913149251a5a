"""Asynchronous RLHF: replay queue, weight publisher, experience producer
(counterpart of ``repro/core/replay.py``, one device and the 1 x 1 mesh).

Synchronous stage 3 runs generate -> score -> train one after the other.
The asynchronous mode overlaps generation of batch N+1 with the PPO step
on batch N, so an iteration approaches ``max(gen, train) + publish``.
Three pieces, as in the reference:

- :class:`ReplayQueue` — a bounded thread-safe FIFO carrying rollouts
  from the producer thread to the PPO consumer.  A full queue blocks the
  producer (backpressure, never unbounded growth); ``close`` drains,
  ``cancel`` aborts; every blocking op takes a timeout so a wedged peer
  surfaces as :class:`ReplayTimeout`, not a silent hang.
- :class:`WeightPublisher` — versioned actor weights.  After every
  ``publish_every``-th PPO step the consumer publishes the actor's params
  and the publisher retains them per version, so each rollout is scored
  with the exact policy that sampled it (the tagged behavior policy).
- :class:`ExperienceProducer` — the generation loop on its own thread.  A
  version gate bounds staleness: batch ``i`` is generated only once a
  policy version ``>= i - max_lag`` is published.  ``max_lag=0`` is
  lockstep, bit-identical to the synchronous pipeline.

Two differences from the reference come from PyTorch:

- The reference retains a reference to the published tree, which is free
  because JAX arrays are immutable.  The port's optimizer updates the
  actor's params in place, so :meth:`WeightPublisher.publish` clones the
  tree once per version (enqueued on the publishing thread's stream, so it
  is ordered before the next in-place update).  On one device the rollout
  view and the train view of a version share that one clone; the publish
  ``seconds`` include it, and ``bytes`` keep the reference's meaning, what
  crossed to another layout: 0 here.  Publishing to another layout
  (``shardings``, the reference's ``cross_mesh_put``) is not yet ported.
- The reference's consumer mirrors the JAX key chain itself; a
  ``torch.Generator`` cannot be mirrored, so the producer owns the stage-3
  generator and each :class:`ReplayItem` carries its state right after
  that batch's draws (what a checkpoint saves).
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time
from typing import Any, Optional

import torch

from repro_torch import stream_event
from repro_torch.models.modules import tree_leaves


class ReplayClosed(Exception):
    """The queue/publisher was closed (or cancelled) under a waiter."""


class ReplayTimeout(Exception):
    """A bounded wait expired — the peer is wedged or too slow."""


@dataclasses.dataclass(frozen=True)
class AsyncConfig:
    """Knobs for the asynchronous RLHF mode.

    ``max_lag=0`` + ``publish_every=1`` is lockstep: the producer waits
    for the post-step weights before every batch, making the async
    pipeline bit-identical to the synchronous one.  ``max_lag=1`` is
    the one-step-stale overlap mode.
    """
    queue_depth: int = 2           # replay queue capacity (backpressure)
    publish_every: int = 1         # push weights every k-th PPO step
    max_lag: int = 1               # max policy-version staleness (0 = lockstep)
    is_ratio_abort: Optional[float] = None  # is_ratio_max above this ->
    #                                lockstep fallback for the rest of the run
    async_publish: bool = False    # publish on a background thread
    get_timeout_s: float = 600.0   # consumer-side queue wait bound
    put_timeout_s: float = 600.0   # producer-side queue wait bound
    publish_wait_s: float = 600.0  # producer-side version-gate wait bound

    def __post_init__(self):
        if self.queue_depth < 1:
            raise ValueError(f"queue_depth must be >= 1 "
                             f"(got {self.queue_depth})")
        if self.max_lag < 0:
            raise ValueError(f"max_lag must be >= 0 (got {self.max_lag})")
        if not 1 <= self.publish_every <= self.max_lag + 1:
            raise ValueError(
                f"publish_every={self.publish_every} outside "
                f"[1, max_lag + 1 = {self.max_lag + 1}]: the producer's "
                f"version gate would wait for a version that is never "
                f"published (deadlock)")

    @classmethod
    def lockstep(cls, **kw):
        """The bit-identical-to-sync configuration."""
        return cls(queue_depth=1, publish_every=1, max_lag=0, **kw)


@dataclasses.dataclass
class RolloutBatch:
    """One generated batch plus its behavior-policy version tag.

    The per-token behavior logprobs are not kept here: scoring recomputes
    them from the params of the policy that sampled the batch
    (``PPOTrainer.score_rollout(behavior_params=)``), with the same forward
    the synchronous path runs, so lockstep stays bit-identical and the
    importance ratio is exact."""
    sequences: Any                 # (B, W) int tokens, prompt | generated
    response_mask: Any             # (B, W) bool, True on generated tokens
    attn_mask: Any = None          # (B, W) float, None = no padding tail
    version: int = 0               # policy version that generated this


@dataclasses.dataclass
class ReplayItem:
    rollout: RolloutBatch
    seq: int                       # producer sequence number (batch index)
    gen_metrics: dict = dataclasses.field(default_factory=dict)
    # the stage-3 generator's state right after this batch's draws: what
    # the synchronous loop's generator holds after iteration ``seq``
    generator_state: Optional[torch.Tensor] = None


class ReplayQueue:
    """Bounded thread-safe FIFO for experience batches.

    Invariants (property-tested in tests/test_torch_replay.py): FIFO order,
    ``len(q) <= capacity`` always, no item is ever dropped or duplicated
    while open, ``close`` drains remaining items then raises
    :class:`ReplayClosed` on ``get``, ``cancel`` drops the backlog (counted
    in ``stats()['dropped']``) and wakes every waiter.
    """

    def __init__(self, capacity: int):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.capacity = capacity
        self._q: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closed = False
        self._cancelled = False
        self._puts = 0
        self._gets = 0
        self._dropped = 0
        self._max_depth = 0
        self._put_wait_s = 0.0
        self._get_wait_s = 0.0

    # ------------------------------------------------------------ #
    def put(self, item, timeout: Optional[float] = None) -> None:
        """Blocking put with backpressure; raises :class:`ReplayClosed`
        if the queue is closed/cancelled, :class:`ReplayTimeout` if the
        consumer does not make room within ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.monotonic()
        with self._cv:
            while True:
                if self._closed or self._cancelled:
                    raise ReplayClosed("put on closed replay queue")
                if len(self._q) < self.capacity:
                    break
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ReplayTimeout(
                        f"put timed out after {timeout}s "
                        f"(queue full at {len(self._q)}/{self.capacity}: "
                        f"consumer wedged?)")
                self._cv.wait(remaining)
            self._put_wait_s += time.monotonic() - t0
            self._q.append(item)
            self._puts += 1
            self._max_depth = max(self._max_depth, len(self._q))
            self._cv.notify_all()

    def get(self, timeout: Optional[float] = None):
        """Blocking FIFO get; drains remaining items after ``close``,
        then raises :class:`ReplayClosed`; raises immediately after
        ``cancel``; :class:`ReplayTimeout` if nothing arrives in
        ``timeout`` seconds."""
        deadline = None if timeout is None else time.monotonic() + timeout
        t0 = time.monotonic()
        with self._cv:
            while True:
                if self._cancelled:
                    raise ReplayClosed("get on cancelled replay queue")
                if self._q:
                    break
                if self._closed:
                    raise ReplayClosed("replay queue closed and drained")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ReplayTimeout(
                        f"get timed out after {timeout}s "
                        f"(queue empty: producer wedged?)")
                self._cv.wait(remaining)
            self._get_wait_s += time.monotonic() - t0
            item = self._q.popleft()
            self._gets += 1
            self._cv.notify_all()
            return item

    # ------------------------------------------------------------ #
    def close(self) -> None:
        """Graceful shutdown: no further puts; gets drain the backlog."""
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    def cancel(self) -> None:
        """Abort: drop the backlog and wake every waiter."""
        with self._cv:
            self._cancelled = True
            self._closed = True
            self._dropped += len(self._q)
            self._q.clear()
            self._cv.notify_all()

    # ------------------------------------------------------------ #
    def __len__(self) -> int:
        with self._cv:
            return len(self._q)

    qsize = __len__

    @property
    def closed(self) -> bool:
        with self._cv:
            return self._closed

    @property
    def cancelled(self) -> bool:
        with self._cv:
            return self._cancelled

    def stats(self) -> dict:
        with self._cv:
            return {"puts": self._puts, "gets": self._gets,
                    "dropped": self._dropped, "depth": len(self._q),
                    "max_depth": self._max_depth,
                    "capacity": self.capacity,
                    "put_wait_s": self._put_wait_s,
                    "get_wait_s": self._get_wait_s}


class WeightPublisher:
    """Versioned actor weights, from the consumer to the producer.

    ``shardings=None`` is the single-device mode (one device, or the
    1 x 1 mesh): ``publish`` clones the params (the consumer updates the
    live ones in place) and retains the clone as both the rollout view and
    the train view of the version, ``keep`` most recent versions.  The
    measured ``seconds`` (the clone, until its copies are done) and
    ``bytes`` (0: nothing crossed to another layout) are in
    :attr:`last_publish_stats`.  A ``shardings`` target (another mesh's
    layout) is not yet ported.
    """

    def __init__(self, shardings=None, *, keep: int = 3,
                 async_push: bool = False):
        self._shardings = shardings
        self._keep = max(int(keep), 1)
        self._cv = threading.Condition()
        # version -> (train_layout_params, rollout_layout_params)
        self._versions: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self._latest: Optional[int] = None
        self._closed = False
        self._first = True
        self.publishes = 0
        self.total_publish_s = 0.0
        self.total_publish_bytes = 0
        self.last_publish_stats: dict = {}
        self._pending = None           # coalescing slot for async pushes
        self._busy = False
        self._worker = None
        if async_push:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="weight-publisher",
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------ #
    def _transfer(self, params):
        raise NotImplementedError("WeightPublisher(shardings=) (publishing "
                                  "to another mesh's layout, "
                                  "cross_mesh_put): not yet ported")

    def _snapshot(self, params):
        """``(copy, t0, event)``: a copy of ``params`` that the consumer's
        in-place updates do not reach, the time its copy started, and an
        event on the caller's stream after the copy (``None`` on the CPU;
        :func:`repro_torch.stream_event`), which ``_push`` waits for."""
        from repro_torch.core.pipeline import clone_params
        t0 = time.perf_counter()
        if self._shardings is not None:
            self._transfer(params)
        snapshot = clone_params(params)
        return snapshot, t0, stream_event(tree_leaves(snapshot)[0].device)

    def _push(self, snapshot, t0: float, copied, version: int) -> dict:
        if copied is not None:
            copied.synchronize()
        dt = time.perf_counter() - t0
        nbytes = 0                     # one layout: nothing crossed
        with self._cv:
            self._versions[version] = (snapshot, snapshot)
            while len(self._versions) > self._keep:
                self._versions.popitem(last=False)
            if self._latest is None or version > self._latest:
                self._latest = version
            self.publishes += 1
            self.total_publish_s += dt
            self.total_publish_bytes += nbytes
            self.last_publish_stats = {
                "direction": "publish", "version": version,
                "seconds": dt, "bytes": nbytes,
                "first_call": self._first,
            }
            self._first = False
            self._cv.notify_all()
        return self.last_publish_stats

    def publish(self, params, version: int) -> dict:
        """Make ``params`` the rollout policy for ``version``.  The clone
        is enqueued here, on the caller's stream; on the async-push path
        the wait for it and the hand-over run on the worker thread and
        coalesce (only the newest pending version is pushed)."""
        if self._worker is None:
            return self._push(*self._snapshot(params), version)
        with self._cv:
            if self._closed:
                raise ReplayClosed("publish on closed publisher")
        snapshot = self._snapshot(params)
        with self._cv:
            self._pending = (*snapshot, version)
            self._cv.notify_all()
        return {}

    def _worker_loop(self):
        while True:
            with self._cv:
                while self._pending is None and not self._closed:
                    self._cv.wait()
                if self._pending is None and self._closed:
                    return
                pending = self._pending
                self._pending = None
                self._busy = True
            try:
                self._push(*pending)
            finally:
                with self._cv:
                    self._busy = False
                    self._cv.notify_all()

    def flush(self, timeout: Optional[float] = None) -> None:
        """Block until no publish is pending or in flight."""
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._pending is not None or self._busy:
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ReplayTimeout("publisher flush timed out")
                self._cv.wait(remaining)

    # ------------------------------------------------------------ #
    def wait_for(self, min_version, timeout: Optional[float] = None,
                 stop: Optional[threading.Event] = None) -> int:
        """Block until a version ``>= min_version`` is published; returns
        the latest version.  ``min_version`` may be a CALLABLE re-read on
        every wakeup — the producer's version gate passes one so a
        mid-wait ``force_lockstep`` tightens the threshold of a wait
        already in progress.  ``stop`` aborts the wait (ReplayClosed)."""
        need = min_version if callable(min_version) else lambda: min_version
        deadline = None if timeout is None else time.monotonic() + timeout
        with self._cv:
            while self._latest is None or self._latest < need():
                if self._closed:
                    raise ReplayClosed("publisher closed under waiter")
                if stop is not None and stop.is_set():
                    raise ReplayClosed("producer stopped under waiter")
                remaining = (None if deadline is None
                             else deadline - time.monotonic())
                if remaining is not None and remaining <= 0:
                    raise ReplayTimeout(
                        f"no policy version >= {need()} published "
                        f"within {timeout}s (consumer wedged?)")
                # bounded sleep so a stop event is noticed promptly
                self._cv.wait(0.05 if remaining is None
                              else min(remaining, 0.05))
            return self._latest

    def latest(self):
        """(rollout_layout_params, version) of the newest publication."""
        with self._cv:
            if self._latest is None:
                raise ReplayClosed("no version published yet")
            return self._versions[self._latest][1], self._latest

    def train_params(self, version: int):
        """The TRAIN-layout params retained for ``version`` — the exact
        behavior policy for rollouts tagged with that version."""
        with self._cv:
            if version not in self._versions:
                raise KeyError(
                    f"policy version {version} no longer retained "
                    f"(have {list(self._versions)}; raise `keep`)")
            return self._versions[version][0]

    def retained_bytes(self) -> int:
        """Bytes of the retained clones (one per version on one device)."""
        with self._cv:
            return sum(t.numel() * t.element_size()
                       for train, _ in self._versions.values()
                       for t in tree_leaves(train))

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._worker is not None:
            self._worker.join(timeout=10.0)

    def stats(self) -> dict:
        with self._cv:
            return {"publishes": self.publishes,
                    "total_publish_s": self.total_publish_s,
                    "total_publish_bytes": self.total_publish_bytes,
                    "latest_version": self._latest,
                    "retained": len(self._versions)}


class ExperienceProducer:
    """Free-running rollout loop on its own thread.

    Owns the stage-3 ``generator`` and draws from it exactly as the
    synchronous loop does (one ``generate_rollout`` per batch), and gates
    each batch on the publisher: batch ``i`` waits for a published policy
    version ``>= i - max_lag``.  ``force_lockstep`` drops the allowed lag
    to 0 for the rest of the run (the importance-ratio abort path).  Each
    :class:`ReplayItem` carries the generator's state after its batch.
    Any exception cancels the queue and is re-raised to the consumer via
    :attr:`error`.

    Grad mode and the current device are thread-local in PyTorch: the
    thread generates under ``torch.no_grad()`` on the trainer's device,
    on that device's default stream (the consumer's stream too: the two
    threads' work is ordered on the device as it is enqueued).
    """

    def __init__(self, *, trainer, batches, generator: torch.Generator,
                 start: int, steps: int, queue: ReplayQueue,
                 publisher: WeightPublisher, cfg: AsyncConfig,
                 rollout_hook=None):
        self.trainer = trainer
        self.batches = batches
        self.generator = generator
        self.start_iter, self.steps = start, steps
        self.queue, self.publisher, self.cfg = queue, publisher, cfg
        self.rollout_hook = rollout_hook
        self.error: Optional[BaseException] = None
        self.produced = 0
        self._stop = threading.Event()
        self._lockstep = threading.Event()
        if cfg.max_lag == 0:
            self._lockstep.set()
        self._thread = threading.Thread(target=self._run,
                                        name="rollout-producer",
                                        daemon=True)

    # ------------------------------------------------------------ #
    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()

    def join(self, timeout: Optional[float] = None) -> None:
        if self._thread.is_alive():
            self._thread.join(timeout)

    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def force_lockstep(self) -> None:
        """Drop to on-policy lockstep for the rest of the run."""
        self._lockstep.set()

    @property
    def lockstep_active(self) -> bool:
        return self._lockstep.is_set()

    # ------------------------------------------------------------ #
    def _run(self) -> None:
        try:
            device = self.trainer.device
            if device.type == "cuda":
                torch.cuda.set_device(device)
            for i, batch in zip(range(self.start_iter, self.steps),
                                self.batches):
                if self._stop.is_set():
                    break
                if self.rollout_hook is not None:
                    self.rollout_hook(i)

                def need(i=i):
                    # re-evaluated on every wakeup: a mid-wait lockstep
                    # fallback tightens the gate of this very wait
                    lag = (0 if self._lockstep.is_set()
                           else self.cfg.max_lag)
                    return max(i - lag, self.start_iter)

                self.publisher.wait_for(need,
                                        timeout=self.cfg.publish_wait_s,
                                        stop=self._stop)
                params, version = self.publisher.latest()
                with torch.no_grad():
                    rollout, gm = self.trainer.generate_rollout(
                        batch["prompts"], self.generator,
                        gen_params=params, version=version)
                del params
                self.queue.put(ReplayItem(
                    rollout=rollout, seq=i, gen_metrics=gm,
                    generator_state=self.generator.get_state()),
                    timeout=self.cfg.put_timeout_s)
                self.produced += 1
            self.queue.close()
        except ReplayClosed:
            pass                      # consumer shut us down: clean exit
        except BaseException as e:    # noqa: BLE001 — must wake consumer
            self.error = e
            self.queue.cancel()
