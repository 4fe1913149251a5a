"""Asynchronous RLHF: replay queue, weight publisher, experience producer
(counterpart of ``repro/core/replay.py``: one device, the 1 x 1 mesh and
the disaggregated split between processes).

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
  crossed to another layout: 0 here.
- The reference's consumer mirrors the JAX key chain itself; a
  ``torch.Generator`` cannot be mirrored, so the producer owns the stage-3
  generator and each :class:`ReplayItem` carries its state right after
  that batch's draws (what a checkpoint saves).

Disaggregated (:class:`SplitEnds`), the producer runs on the rollout
ranks and the consumer on the training ranks, in other processes, and the
reference's in-process hand-overs become two gloo groups between them
(:class:`repro_torch.launch.mesh.Bridge`):

- weights: a publish clones the params in the training layout and pushes
  the clone into the rollout mesh's layout (the reference's
  ``cross_mesh_put``: each rollout rank receives its window, piece by
  piece from the training ranks that hold it, through pinned host
  memory); the producer's gate sees a version only once its last window
  has landed, and the lockstep flip travels ahead of the version it
  guards on the same group;
- rollouts: the rollout channel keeps :class:`ReplayQueue`'s contract
  across processes (FIFO, the depth bound by credits the consumer returns
  as it takes batches, ``close`` and ``cancel``, a timeout on every
  wait).
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import threading
import time
from typing import Any, Callable, Optional

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
    :attr:`last_publish_stats`.

    With ``ends`` (this rank's :class:`SplitEnds` of a disaggregated run)
    ``shardings`` is the rollout mesh's layout, and the publisher is one
    end of the bridge:

    - on a training rank ``publish`` clones the params in the training
      layout (retained per version: the behavior policy) and hands the
      clone to the bridge's sending thread, which pushes it into
      ``shardings`` (:func:`repro_torch.sharding.strategy.push_tree`);
      without ``async_push`` it returns once the last window is sent.
      ``seconds`` runs from the call until then, ``bytes`` is what the
      rollout ranks hold of the version (the reference's
      ``_tree_device_bytes`` of the rollout tree).  Pushes are never
      coalesced: every training rank sends its pieces of every version.
    - on a rollout rank the versions land from the bridge (:meth:`land`,
      called by the receiving thread once the last window is in), and
      :meth:`wait_for`, :meth:`latest` and :meth:`at` serve the producer.
    """

    def __init__(self, shardings=None, *, keep: int = 3,
                 async_push: bool = False, ends=None):
        if shardings is not None and ends is None:
            raise ValueError("WeightPublisher(shardings=) publishes to "
                             "another mesh's layout across the bridge "
                             "between the meshes: pass ends= (SplitEnds)")
        self._shardings = shardings
        self._ends = ends
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
        self._async = bool(async_push)
        self._jobs: list = []          # the bridge's pushes not yet done
        self._worker = None
        if async_push and ends is None:
            self._worker = threading.Thread(target=self._worker_loop,
                                            name="weight-publisher",
                                            daemon=True)
            self._worker.start()

    # ------------------------------------------------------------ #
    def _snapshot(self, params):
        """``(copy, t0, event)``: a copy of ``params`` that the consumer's
        in-place updates do not reach, the time its copy started, and an
        event on the caller's stream after the copy (``None`` on the CPU;
        :func:`repro_torch.stream_event`), which ``_push`` waits for."""
        from repro_torch.core.pipeline import clone_params
        from repro_torch.sharding import runtime
        t0 = time.perf_counter()
        snapshot = clone_params(params)
        return snapshot, t0, stream_event(
            runtime.local(tree_leaves(snapshot)[0]).device)

    def _push(self, snapshot, t0: float, copied, version: int) -> dict:
        if copied is not None:
            copied.synchronize()
        dt = time.perf_counter() - t0
        self._record(version, (snapshot, snapshot), dt, 0)
        return self.last_publish_stats

    def _retain(self, version: int, views) -> None:
        """Keep ``views`` (train, rollout) for ``version``, the ``keep``
        newest versions (the caller holds the lock)."""
        self._versions[version] = views
        while len(self._versions) > self._keep:
            self._versions.popitem(last=False)
        if self._latest is None or version > self._latest:
            self._latest = version

    def _record(self, version: int, views, seconds: float,
                nbytes: int) -> None:
        """Retain ``views`` for ``version`` (``None``: already retained)
        and account for its publication."""
        with self._cv:
            if views is not None:
                self._retain(version, views)
            self.publishes += 1
            self.total_publish_s += seconds
            self.total_publish_bytes += nbytes
            self.last_publish_stats = {
                "direction": "publish", "version": version,
                "seconds": seconds, "bytes": nbytes,
                "first_call": self._first,
            }
            self._first = False
            self._cv.notify_all()

    def publish(self, params, version: int) -> dict:
        """Make ``params`` the rollout policy for ``version``.  The clone
        is enqueued here, on the caller's stream; on the async-push path
        the wait for it and the hand-over run on the worker thread and
        coalesce (only the newest pending version is pushed), or, across
        the bridge, on its sending thread (every version is pushed)."""
        if self._ends is not None:
            return self._publish_across(params, version)
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

    def _publish_across(self, params, version: int) -> dict:
        with self._cv:
            if self._closed:
                raise ReplayClosed("publish on closed publisher")
        snapshot, t0, copied = self._snapshot(params)
        with self._cv:               # the behavior policy of ``version``
            self._retain(version, (snapshot, None))

        def done(stats):
            self._record(version, None, time.perf_counter() - t0,
                         stats["bytes"])
        job = self._ends.push(snapshot, self._shardings, version,
                              ready=copied, on_done=done)
        with self._cv:
            self._jobs = [j for j in self._jobs if not j.done.is_set()]
            self._jobs.append(job)
        if self._async:
            return {}
        job.wait(self._ends.get_timeout_s)
        return self.last_publish_stats

    def land(self, tree, version: int) -> None:
        """A version received across the bridge (the rollout side)."""
        from repro_torch.sharding import runtime
        self._record(version, (None, tree), 0.0, runtime.local_bytes(tree))

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
        for job in list(self._jobs):
            job.wait(None if deadline is None
                     else max(deadline - time.monotonic(), 0.0))
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

    def at(self, version: int, timeout: Optional[float] = None,
           stop: Optional[threading.Event] = None):
        """The rollout-layout params of ``version`` once it has landed
        (another rollout rank chose it)."""
        self.wait_for(version, timeout, stop)
        with self._cv:
            if version not in self._versions:
                raise KeyError(f"policy version {version} no longer "
                               f"retained (have {list(self._versions)})")
            return self._versions[version][1]

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
        """This rank's bytes of the retained train-layout clones (one per
        version on one device)."""
        from repro_torch.sharding import runtime
        with self._cv:
            return sum(runtime.local_bytes(train)
                       for train, _ in self._versions.values()
                       if train is not None)

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._jobs = []
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
                 rollout_hook=None, lockstep=None, decide=None):
        self.trainer = trainer
        self.batches = batches
        self.generator = generator
        self.start_iter, self.steps = start, steps
        self.queue, self.publisher, self.cfg = queue, publisher, cfg
        self.rollout_hook = rollout_hook
        self.error: Optional[BaseException] = None
        self.produced = 0
        self._stop = threading.Event()
        # the lockstep flag (across the bridge, the receiving thread sets
        # it when the consumer's flip arrives)
        self._lockstep = lockstep if lockstep is not None \
            else threading.Event()
        if cfg.max_lag == 0:
            self._lockstep.set()
        self.decide = decide
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
    def _pick(self, i: int, need):
        """The params and version batch ``i`` is generated with: the
        newest published once the gate opens; on a rollout rank other than
        the first (``decide``), the version that rank chose."""
        wait = self.cfg.publish_wait_s
        if self.decide is not None and not self.decide.leader:
            version = self.decide.take(i, wait, self._stop)
            return self.publisher.at(version, wait, self._stop), version
        self.publisher.wait_for(need, timeout=wait, stop=self._stop)
        params, version = self.publisher.latest()
        if self.decide is not None:
            self.decide.post(i, version)
        return params, version

    def _run(self) -> None:
        i = self.start_iter
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

                params, version = self._pick(i, need)
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
                i += 1
            self.queue.close()
        except ReplayClosed:
            pass                      # consumer shut us down: clean exit
        except BaseException as e:    # noqa: BLE001 — must wake consumer
            self.error = e
            self.queue.cancel()
        finally:
            if self.decide is not None:
                self.decide.end(i)


# ===================================================================== #
# across processes: the disaggregated split
# ===================================================================== #
class RemoteError(Exception):
    """A failure on the other side of the bridge, as its message."""


class _Job:
    """One task of a :class:`_Sender`: ``done`` is set once it ran, with
    its ``result`` or ``error``; the task itself is dropped then, and
    with it what it held (a pushed tree)."""

    def __init__(self, fn: Callable[[], Any]):
        self.fn = fn
        self.done = threading.Event()
        self.result: Any = None
        self.error: Optional[BaseException] = None

    def wait(self, timeout: Optional[float] = None) -> None:
        if not self.done.wait(timeout):
            raise ReplayTimeout(f"bridge send not done within {timeout}s")
        if self.error is not None:
            raise self.error


class _Sender:
    """The thread that owns one bridge group for sending on this rank: it
    runs its jobs in order, and on the first rank of its role sends each
    peer a heartbeat after a quarter of the group's timeout without a
    message, so that a peer's receive times out only if this rank is
    gone or wedged.  After a failed job every later one fails with the
    same error."""

    def __init__(self, bridge, group, peers: tuple, leader: bool,
                 name: str):
        from repro_torch.sharding import strategy as S
        self._send = lambda dst, msg: S.send_header(bridge, dst, msg, group)
        self.peers, self.leader = peers, leader
        self._beat = bridge.timeout_s / 4
        self._jobs: collections.deque = collections.deque()
        self._cv = threading.Condition()
        self._closing = False
        self.error: Optional[BaseException] = None
        self._device = (torch.cuda.current_device()
                        if torch.cuda.is_available() else None)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def submit(self, fn: Callable[[], Any]) -> _Job:
        job = _Job(fn)
        with self._cv:
            if self._closing:
                raise ReplayClosed("bridge sender closed")
            self._jobs.append(job)
            self._cv.notify_all()
        return job

    def message(self, msg: dict) -> _Job:
        """``msg`` to every peer, from the first rank of the role (a no-op
        on the others)."""
        def fn():
            if self.leader:
                for r in self.peers:
                    self._send(r, msg)
        return self.submit(fn)

    def close(self, last: Optional[dict] = None,
              timeout: Optional[float] = None) -> None:
        """Send ``last`` after the queued jobs, then stop the thread."""
        if last is not None:
            try:
                self.message(last)
            except ReplayClosed:
                pass
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        self._thread.join(timeout)

    def _run(self) -> None:
        if self._device is not None:
            torch.cuda.set_device(self._device)
        while True:
            with self._cv:
                if not self._jobs and not self._closing:
                    self._cv.wait(self._beat)
                if self._jobs:
                    job = self._jobs.popleft()
                elif self._closing:
                    return
                elif self.leader and self.error is None:    # idle: a beat
                    job = _Job(lambda: [self._send(r, {"kind": "beat"})
                                        for r in self.peers])
                else:
                    continue
            if self.error is not None:
                job.error = self.error
            else:
                try:
                    job.result = job.fn()
                except BaseException as e:       # noqa: BLE001
                    job.error = self.error = e
            job.fn = None
            job.done.set()


class _Receiver:
    """The thread that owns one bridge group for receiving on this rank:
    it hands each message from ``src`` to ``handle`` until ``handle``
    returns ``True`` (the last message) or a receive fails (the peer is
    gone, or sent nothing for the group's timeout), which goes to
    ``failed``."""

    def __init__(self, bridge, group, src: int, handle, failed, name: str):
        from repro_torch.sharding import strategy as S
        self._recv = lambda: S.recv_header(bridge, src, group)
        self._handle, self._failed = handle, failed
        self._device = (torch.cuda.current_device()
                        if torch.cuda.is_available() else None)
        self._thread = threading.Thread(target=self._run, name=name,
                                        daemon=True)
        self._thread.start()

    def join(self, timeout: Optional[float] = None) -> bool:
        """Whether the thread ended within ``timeout``."""
        self._thread.join(timeout)
        return not self._thread.is_alive()

    def _run(self) -> None:
        if self._device is not None:
            torch.cuda.set_device(self._device)
        try:
            while not self._handle(self._recv()):
                pass
        except BaseException as e:                # noqa: BLE001
            self._failed(e)


class _Decisions:
    """The version each batch is generated with, when the rollout mesh has
    more than one rank: the first rollout rank chooses it (its gate opens
    on what has landed there) and writes it to the default group's store;
    the others read it, so that every rank decodes with the same weights.
    A ``None`` choice ends the others' loops (the first stopped)."""
    _runs = itertools.count()

    def __init__(self, leader: bool):
        import torch.distributed as dist
        self.leader = leader
        self._store = dist.distributed_c10d._get_default_store()
        self._prefix = f"repro_torch/disaggregated/{next(self._runs)}/"
        self._next = None

    def post(self, i: int, version: Optional[int]) -> None:
        self._store.set(self._prefix + str(i),
                        "stop" if version is None else str(version))
        self._next = i + 1

    def end(self, i: int) -> None:
        """After the loop, on the first rank: a stop for the next batch."""
        if self.leader:
            self.post(self._next if self._next is not None else i, None)

    def take(self, i: int, timeout: float, stop: threading.Event) -> int:
        key = self._prefix + str(i)
        deadline = time.monotonic() + timeout
        while not self._store.check([key]):
            if stop.is_set():
                raise ReplayClosed("producer stopped under waiter")
            if time.monotonic() > deadline:
                raise ReplayTimeout(f"no version chosen for batch {i} "
                                    f"within {timeout}s")
            time.sleep(0.02)
        v = self._store.get(key).decode()
        if v == "stop":
            raise ReplayClosed("the first rollout rank stopped")
        return int(v)


class _TrainQueue:
    """The training side's view of the rollout channel: the local
    :class:`ReplayQueue` the receiving thread fills, whose ``get`` also
    returns a credit to the producer (from the first training rank), so
    that it is never more than the queue's capacity ahead."""

    def __init__(self, ends, queue: ReplayQueue):
        self._ends, self._q = ends, queue

    def get(self, timeout: Optional[float] = None):
        item = self._q.get(timeout)
        self._ends._down.message({"kind": "credit"})
        return item

    def __len__(self) -> int:
        return len(self._q)

    def stats(self) -> dict:
        return self._q.stats()

    def cancel(self) -> None:
        self._q.cancel()


class RemoteProducer:
    """The training side's handle on the producer of the rollout ranks:
    ``force_lockstep`` sends the flip ahead of any later publish (the
    bridge keeps the order), ``error`` is the producer's failure as it
    came back (:class:`RemoteError`), ``produced`` what it sent."""

    def __init__(self, ends, cfg: AsyncConfig):
        self._ends = ends
        self._lockstep = cfg.max_lag == 0

    def force_lockstep(self) -> None:
        self._lockstep = True
        self._ends._down.message({"kind": "lockstep"})

    @property
    def lockstep_active(self) -> bool:
        return self._lockstep

    @property
    def error(self) -> Optional[BaseException]:
        return self._ends.error

    @property
    def produced(self) -> int:
        return self._ends.received

    def stop(self) -> None:
        pass

    def join(self, timeout: Optional[float] = None) -> None:
        pass


class SplitEnds:
    """This rank's ends of the bridge for one disaggregated stage-3 run
    (:class:`repro_torch.launch.mesh.Bridge`; both sides construct theirs
    at the start of the run, before stages 1 and 2, so that the
    heartbeats keep the rollout ranks' receives alive while the training
    ranks train).

    The ``weights`` group carries, from the first training rank to every
    rollout rank: the start (the first iteration and the generator state
    to draw from), each pushed version (a header, then every training
    rank's windows), the lockstep flip ahead of the version it guards,
    one credit per consumed batch, and at the end ``close`` (or
    ``cancel`` with the consumer's error).  The ``rollouts`` group
    carries, from the first rollout rank to every training rank: each
    :class:`ReplayItem` (the batch on the host, its sequence number,
    generation metrics and generator state), and at the end ``close``
    (with the producer's counts and waits) or ``error``.  One thread a
    rank sends on a group and one receives: the training ranks send on
    ``weights`` and receive on ``rollouts``, the rollout ranks the
    reverse.

    The producer starts with ``depth`` credits and spends one per batch
    it sends, so it is never more than ``depth`` batches ahead of
    consumption and the training side's queue (``depth`` places) never
    fills; a publish lands on a rollout rank (``publisher``) only once its
    last window is in, so the producer's gate sees a version only then.
    """

    def __init__(self, bridge, *, depth: int, shardings, device,
                 keep: int = 2, get_timeout_s: float = 600.0):
        import torch.distributed as dist
        self.bridge, self.role = bridge, bridge.role
        self.timeout_s = bridge.timeout_s
        self.get_timeout_s = get_timeout_s
        self.device = device
        self._shardings = shardings
        rank = dist.get_rank()
        self.error: Optional[BaseException] = None   # the producer's
        self.cancelled: Optional[dict] = None         # the consumer's end
        self.received = 0
        self.producer_stats: dict = {}
        self._started = threading.Event()
        self._ended = threading.Event()               # the peer's last msg
        self.start_msg: dict = {}
        if self.role == "train":
            self.leader = rank == bridge.train_ranks[0]
            self._local = ReplayQueue(depth)
            self.queue = _TrainQueue(self, self._local)
            self._down = _Sender(bridge, bridge.weights, bridge.rollout_ranks,
                                 self.leader, "bridge-weights-send")
            self._up = _Receiver(bridge, bridge.rollouts,
                                 bridge.rollout_ranks[0], self._on_item,
                                 self._up_failed, "bridge-rollouts-recv")
            self._sync_version = 0
        elif self.role == "rollout":
            self.leader = rank == bridge.rollout_ranks[0]
            self.publisher = WeightPublisher(shardings, keep=keep, ends=self)
            self.lockstep = threading.Event()
            self.decide = (_Decisions(self.leader)
                           if len(bridge.rollout_ranks) > 1 else None)
            self._cv = threading.Condition()
            self._credits = depth
            self._puts, self._put_wait_s, self._up_done = 0, 0.0, False
            self._down = _Receiver(bridge, bridge.weights,
                                   bridge.train_ranks[0], self._on_down,
                                   self._down_failed, "bridge-weights-recv")
            self._up = _Sender(bridge, bridge.rollouts, bridge.train_ranks,
                               self.leader, "bridge-rollouts-send")
        else:
            raise ValueError("SplitEnds: this rank is on neither mesh")

    # ------------------------- training side ------------------------ #
    def push(self, tree, shardings, version: int, ready=None,
             on_done=None) -> _Job:
        """Push ``tree`` (the training layout) into ``shardings`` as
        ``version``, on the sending thread, after the jobs before it."""
        from repro_torch.sharding import strategy as S

        def fn():
            stats = S.push_tree(tree, shardings, self.bridge, ready,
                                version=version)
            if on_done is not None:
                on_done(stats)
            return stats
        return self._down.submit(fn)

    def push_now(self, params) -> dict:
        """The synchronous loop's push of the live ``params`` as the next
        version: waits until the last window is sent (the caller updates
        ``params`` in place afterwards).  Returns ``seconds`` and
        ``bytes``."""
        from repro_torch.sharding import runtime
        t0 = time.perf_counter()
        ready = stream_event(runtime.local(tree_leaves(params)[0]).device)
        job = self.push(params, self._shardings, self._sync_version, ready)
        self._sync_version += 1
        job.wait(self.get_timeout_s)
        return {"seconds": time.perf_counter() - t0,
                "bytes": job.result["bytes"]}

    def start(self, start: int, rng: Optional[torch.Tensor]) -> None:
        """Tell the rollout ranks where stage 3 starts: the first iteration
        and the generator state to draw from (``None``: a fresh one)."""
        self._sync_version = start
        self._down.message({"kind": "start", "start": start, "rng": rng})

    def _on_item(self, msg: dict) -> bool:
        kind = msg["kind"]
        if kind == "item":
            self.received += 1
            try:
                self._local.put(msg["item"], timeout=self.timeout_s)
            except ReplayClosed:
                pass          # the consumer ended: drain until the last msg
        elif kind == "close":
            self.producer_stats = msg["stats"]
            self._local.close()
        elif kind == "error":
            self.producer_stats = msg["stats"]
            self.error = RemoteError(msg["error"])
            self._local.cancel()
        if kind in ("close", "error"):
            self._ended.set()
            return True
        return False

    def _up_failed(self, e: BaseException) -> None:
        if self.error is None:
            self.error = RemoteError(f"the rollout ranks' link failed: {e}")
        self._local.cancel()
        self._ended.set()

    def finish(self, error: Optional[BaseException] = None) -> None:
        """The training side's end: ``close`` (or ``cancel`` with
        ``error``) to the rollout ranks, then wait (at most the bridge's
        timeout) for their last message."""
        last = {"kind": "close"} if error is None else {
            "kind": "cancel", "error": repr(error),
            "producer": self.error is not None}
        self._down.close(last, timeout=self.timeout_s)
        self._up.join(self.timeout_s)

    # -------------------------- rollout side ------------------------ #
    def _on_down(self, msg: dict) -> bool:
        from repro_torch.sharding import strategy as S
        kind = msg["kind"]
        if kind == "start":
            self.start_msg = msg
            self._started.set()
        elif kind == "weights":
            tree = S.pull_tree(msg, self._shardings, self.bridge,
                               self.device)
            self.publisher.land(tree, msg["version"])
        elif kind == "lockstep":
            self.lockstep.set()
        elif kind == "credit":
            with self._cv:
                self._credits += 1
                self._cv.notify_all()
        elif kind in ("close", "cancel"):
            self.cancelled = msg if kind == "cancel" else None
            self._end_down()
            return True
        return False

    def _down_failed(self, e: BaseException) -> None:
        self.cancelled = {"kind": "cancel", "producer": False,
                          "error": f"the training ranks' link failed: {e}"}
        self._end_down()

    def _end_down(self) -> None:
        self._ended.set()
        self.publisher.close()            # wakes a version-gated producer
        with self._cv:
            self._cv.notify_all()

    def wait_start(self) -> dict:
        """The start message (waits while the link is alive: the training
        ranks may be in stages 1 and 2)."""
        while not self._started.wait(0.2):
            if self._ended.is_set():
                raise RuntimeError(self._ended_message())
        return self.start_msg

    def _ended_message(self) -> str:
        c = self.cancelled or {}
        if c.get("producer"):
            return "rollout producer failed"
        return f"training consumer failed: {c.get('error', 'closed')}"

    def put(self, item: ReplayItem, timeout: Optional[float] = None) -> None:
        """The producer's put: spends a credit (waits for one: backpressure,
        :class:`ReplayTimeout` after ``timeout``) and sends the item to
        every training rank, from the first rollout rank (a no-op on the
        others)."""
        if not self.leader:
            return
        t0 = time.monotonic()
        with self._cv:
            while self._credits == 0:
                if self._ended.is_set():
                    raise ReplayClosed("the training ranks ended the run")
                remaining = (None if timeout is None
                             else timeout - (time.monotonic() - t0))
                if remaining is not None and remaining <= 0:
                    raise ReplayTimeout(
                        f"put timed out after {timeout}s (no credit: "
                        f"consumer wedged?)")
                self._cv.wait(0.2 if remaining is None
                              else min(remaining, 0.2))
            self._credits -= 1
            self._put_wait_s += time.monotonic() - t0
            self._puts += 1
        r = item.rollout
        host = dataclasses.replace(item, rollout=dataclasses.replace(
            r, sequences=torch.as_tensor(r.sequences).cpu(),
            response_mask=torch.as_tensor(r.response_mask).cpu(),
            attn_mask=(None if r.attn_mask is None
                       else torch.as_tensor(r.attn_mask).cpu())))
        self._up.message({"kind": "item", "item": host})

    def close(self) -> None:
        """The producer's last batch is sent."""
        self.end_up()

    def cancel(self) -> None:
        """The producer failed: its main thread sends the error
        (:meth:`end_up`)."""

    def stats(self) -> dict:
        with self._cv:
            return {"puts": self._puts, "put_wait_s": self._put_wait_s}

    def end_up(self, error: Optional[BaseException] = None) -> None:
        """The rollout side's last message on ``rollouts`` (once):
        ``close``, or ``error`` with the producer's failure."""
        with self._cv:
            if self._up_done:
                return
            self._up_done = True
        msg = ({"kind": "close"} if error is None
               else {"kind": "error", "error": repr(error)})
        self._up.close(dict(msg, stats=self.stats()), self.timeout_s)

    def wait_end(self) -> None:
        """Wait (at most the bridge's timeout) for the training ranks'
        ``close`` or ``cancel``."""
        self._down.join(self.timeout_s)

    def release(self) -> None:
        """After the run: drop the landed versions and the batches left,
        and the threads' handles on this object (a cycle that would keep
        it, and the tensors it holds, until the cyclic collector runs)."""
        if self.role == "rollout":
            with self.publisher._cv:
                self.publisher._versions.clear()
        else:
            self._local.cancel()
        self._down = self._up = None
