"""The port's replay module (``repro_torch/core/replay.py``) against the
reference's (``repro/core/replay.py``, loaded by file path:
``repro/core/__init__.py`` imports the pipeline, ROADMAP Queue 3, R1):
the same operation sequences give the same items, exceptions and
``stats()`` (wait times and publish seconds excepted) for the replay queue
and the weight publisher, with and without ``async_push``; the same
``AsyncConfig`` validation.  Then the reference's queue properties
(``tests/test_replay_properties.py``) on the port's queue, and what only
the port has: a publish clones the params, so an in-place update after it
leaves the retained version unchanged; the producer's generator states;
the thread-safe launch counters.

Every test that starts a thread carries the ``async_rlhf`` marker (the
conftest's watchdog), gives each blocking call a timeout and shuts its
threads down in a ``finally``.
"""
import sys
import threading
from collections import Counter, deque

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _hyp import given, settings, st
from _torch_parity import reference_replay
from repro_torch.core import replay as R
from repro_torch.core.pipeline import clone_params
from repro_torch.kernels import build, ops

WAIT_KEYS = ("put_wait_s", "get_wait_s")


@pytest.fixture
def ref(monkeypatch):
    """The reference's replay module, with what its publisher imports at
    each publish present in ``sys.modules`` for the test's duration."""
    ns = reference_replay()
    for name, mod in ns.modules.items():
        monkeypatch.setitem(sys.modules, name, mod)
    return ns.replay


def _outcome(fn):
    """``("ok", value)`` or ``("raise", exception class name)``."""
    try:
        return ("ok", fn())
    except Exception as e:              # noqa: BLE001 — compared by name
        return ("raise", type(e).__name__)


def _no_wait(stats: dict) -> dict:
    return {k: v for k, v in stats.items() if k not in WAIT_KEYS}


# ===================================================================== #
# the port against the reference module
# ===================================================================== #
@pytest.mark.parametrize("capacity", [1, 2, 5])
@pytest.mark.parametrize("seed", range(4))
def test_queue_matches_reference_on_op_sequences(ref, seed, capacity):
    rng = np.random.default_rng(seed)
    got, want = R.ReplayQueue(capacity), ref.ReplayQueue(capacity)
    item = 0
    for _ in range(150):
        r = rng.random()
        if r < 0.45:
            ops_ = [lambda q, i=item: q.put(i, timeout=0)]
            item += 1
        elif r < 0.9:
            ops_ = [lambda q: q.get(timeout=0)]
        elif r < 0.95:
            ops_ = [lambda q: q.close()]
        else:
            ops_ = [lambda q: q.cancel()]
        for op in ops_:
            assert _outcome(lambda: op(got)) == _outcome(lambda: op(want))
        assert _no_wait(got.stats()) == _no_wait(want.stats())
        assert (len(got), got.closed, got.cancelled) == \
            (len(want), want.closed, want.cancelled)


def test_queue_errors_match_reference(ref):
    for cls in (R.ReplayQueue, ref.ReplayQueue):
        with pytest.raises(ValueError, match="capacity must be >= 1"):
            cls(0)


def _params(seed: int):
    g = torch.Generator().manual_seed(seed)
    return {"w": torch.randn(3, 4, generator=g),
            "layers": {"b": torch.randn(2, 5, generator=g)}}


def _as_jax(params):
    return {"w": jnp.asarray(params["w"].numpy()),
            "layers": {"b": jnp.asarray(params["layers"]["b"].numpy())}}


@pytest.mark.async_rlhf
@pytest.mark.parametrize("async_push", [False, True])
def test_publisher_matches_reference(ref, async_push):
    """Versions, ``keep``, ``latest``, ``train_params``, ``KeyError`` past
    ``keep``, ``last_publish_stats`` and ``stats()`` (seconds excepted),
    with and without the coalescing worker."""
    got = R.WeightPublisher(keep=2, async_push=async_push)
    want = ref.WeightPublisher(keep=2, async_push=async_push)
    try:
        for version in (0, 1, 3, 4):
            p = _params(version)
            got.publish(p, version)
            want.publish(_as_jax(p), version)
            got.flush(timeout=10.0)
            want.flush(timeout=10.0)
            assert got.wait_for(version, timeout=10.0) == \
                want.wait_for(version, timeout=10.0) == version
            sg, sw = got.stats(), want.stats()
            sg.pop("total_publish_s"), sw.pop("total_publish_s")
            assert sg == sw
            lg, lw = dict(got.last_publish_stats), \
                dict(want.last_publish_stats)
            assert lg.pop("seconds") >= 0 and lw.pop("seconds") >= 0
            assert lg == lw
            params, v = got.latest()
            wparams, wv = want.latest()
            assert v == wv == version
            np.testing.assert_array_equal(params["w"].numpy(),
                                          np.asarray(wparams["w"]))
            for old in range(version + 1):
                og = _outcome(lambda: got.train_params(old)["w"].numpy())
                ow = _outcome(lambda: np.asarray(
                    want.train_params(old)["w"]))
                assert og[0] == ow[0]
                if og[0] == "ok":
                    np.testing.assert_array_equal(og[1], ow[1])
                else:
                    assert og[1] == ow[1] == "KeyError"
    finally:
        got.close()
        want.close()
    assert got.retained_bytes() == 2 * (12 + 10) * 4
    with pytest.raises(R.ReplayClosed):
        got.wait_for(99, timeout=1.0)


@pytest.mark.parametrize("kw, match", [
    (dict(queue_depth=0), "queue_depth"),
    (dict(max_lag=-1), "max_lag"),
    (dict(publish_every=3, max_lag=1), "publish_every"),
    (dict(publish_every=0), "publish_every")])
def test_async_config_validation_matches_reference(ref, kw, match):
    msgs = []
    for cls in (R.AsyncConfig, ref.AsyncConfig):
        with pytest.raises(ValueError, match=match) as e:
            cls(**kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


def test_async_config_fields_and_lockstep_match_reference(ref):
    import dataclasses
    got, want = R.AsyncConfig(), ref.AsyncConfig()
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    lk = R.AsyncConfig.lockstep(is_ratio_abort=2.0)
    assert dataclasses.asdict(lk) == dataclasses.asdict(
        ref.AsyncConfig.lockstep(is_ratio_abort=2.0))
    assert (lk.queue_depth, lk.publish_every, lk.max_lag) == (1, 1, 0)


# ===================================================================== #
# the reference's queue properties, on the port's queue
# ===================================================================== #
def _check(q, model: deque, got: list, put_log: list, dropped: int):
    s = q.stats()
    assert len(q) == len(model) <= q.capacity
    assert s["depth"] == len(model)
    assert s["max_depth"] <= q.capacity
    assert got == put_log[:len(got)]                   # FIFO, no dup
    assert s["puts"] == len(put_log)
    assert s["gets"] == len(got)
    assert s["dropped"] == dropped
    assert s["puts"] == s["gets"] + s["dropped"] + s["depth"]


def _run_ops(seed: int, n_ops: int, capacity: int) -> Counter:
    rng = np.random.default_rng(seed)
    q = R.ReplayQueue(capacity)
    model: deque = deque()
    got, put_log = [], []
    dropped = 0
    next_item = 0
    ops_ = Counter()
    for _ in range(n_ops):
        r = rng.random()
        if r < 0.45:                                   # put
            ops_["put"] += 1
            if q.cancelled or q.closed:
                with pytest.raises(R.ReplayClosed):
                    q.put(next_item, timeout=0)
            elif len(model) >= capacity:
                ops_["put_full"] += 1
                with pytest.raises(R.ReplayTimeout):
                    q.put(next_item, timeout=0)        # backpressure
            else:
                q.put(next_item, timeout=0)
                model.append(next_item)
                put_log.append(next_item)
                next_item += 1
        elif r < 0.90:                                 # get
            ops_["get"] += 1
            if q.cancelled:
                with pytest.raises(R.ReplayClosed):
                    q.get(timeout=0)
            elif model:
                assert q.get(timeout=0) == model.popleft()
                got.append(put_log[len(got)])
            elif q.closed:
                ops_["get_drained"] += 1
                with pytest.raises(R.ReplayClosed):
                    q.get(timeout=0)
            else:
                ops_["get_empty"] += 1
                with pytest.raises(R.ReplayTimeout):
                    q.get(timeout=0)
        elif r < 0.95:                                 # close (drains)
            ops_["close"] += 1
            q.close()
        else:                                          # cancel (drops)
            ops_["cancel"] += 1
            if not q.cancelled:
                dropped += len(model)
                model.clear()
            q.cancel()
        _check(q, model, got, put_log, dropped)
    return ops_


@pytest.mark.async_rlhf
@given(st.integers(0, 10_000), st.integers(1, 6))
@settings(max_examples=40, deadline=None)
def test_arbitrary_interleavings_hold_invariants(seed, capacity):
    ops_ = _run_ops(seed, 120, capacity)
    assert ops_["put"] and ops_["get"]


@pytest.mark.async_rlhf
def test_interleavings_cover_all_transitions():
    total = Counter()
    for seed in range(25):
        total += _run_ops(seed, 160, 2)
    for op in ("put", "put_full", "get", "get_empty", "get_drained",
               "close", "cancel"):
        assert total[op] > 0, f"op {op} never exercised"


def _producer(q, n):
    try:
        for i in range(n):
            q.put(i, timeout=30.0)
        q.close()
    except R.ReplayClosed:
        pass


@pytest.mark.async_rlhf
@given(st.integers(1, 4), st.integers(5, 40))
@settings(max_examples=10, deadline=None)
def test_threaded_pipe_never_drops_or_duplicates(capacity, n):
    q = R.ReplayQueue(capacity)
    t = threading.Thread(target=_producer, args=(q, n), daemon=True)
    t.start()
    got = []
    try:
        while True:
            try:
                got.append(q.get(timeout=30.0))
            except R.ReplayClosed:
                break
    finally:
        q.cancel()
        t.join(timeout=30.0)
    assert not t.is_alive()
    assert got == list(range(n))                       # FIFO, exact
    s = q.stats()
    assert s["max_depth"] <= capacity
    assert s["puts"] == s["gets"] == n and s["dropped"] == 0


@pytest.mark.async_rlhf
@given(st.integers(0, 1000))
@settings(max_examples=10, deadline=None)
def test_threaded_cancel_wakes_producer_and_conserves(seed):
    rng = np.random.default_rng(seed)
    n, take = 30, int(rng.integers(0, 10))
    q = R.ReplayQueue(1)                 # tight bound: producer WILL block
    t = threading.Thread(target=_producer, args=(q, n), daemon=True)
    t.start()
    try:
        got = [q.get(timeout=30.0) for _ in range(take)]
    finally:
        q.cancel()
        t.join(timeout=30.0)               # a blocked put must be woken
    assert not t.is_alive()
    assert got == list(range(take))
    s = q.stats()
    assert s["gets"] + s["dropped"] <= s["puts"] <= n
    assert len(q) == 0


def test_close_then_drain_is_clean_shutdown():
    q = R.ReplayQueue(4)
    for i in range(3):
        q.put(i, timeout=1.0)
    q.close()
    with pytest.raises(R.ReplayClosed):
        q.put(99, timeout=0)
    assert [q.get(timeout=1.0) for _ in range(3)] == [0, 1, 2]
    with pytest.raises(R.ReplayClosed):
        q.get(timeout=1.0)
    s = q.stats()
    assert s["puts"] == s["gets"] == 3 and s["dropped"] == 0


@pytest.mark.async_rlhf
def test_blocked_get_wakes_on_close():
    q = R.ReplayQueue(2)
    woke = {}

    def consumer():
        try:
            q.get(timeout=30.0)
        except R.ReplayClosed:
            woke["yes"] = True

    t = threading.Thread(target=consumer, daemon=True)
    t.start()
    try:
        threading.Event().wait(0.05)
        q.close()
    finally:
        q.cancel()
        t.join(timeout=10.0)
    assert not t.is_alive() and woke.get("yes")


# ===================================================================== #
# what only the port has
# ===================================================================== #
@pytest.mark.async_rlhf
@pytest.mark.parametrize("async_push", [False, True])
def test_in_place_update_after_publish_leaves_the_version_unchanged(
        async_push):
    """The optimizer updates the live params in place; the retained
    version is a clone and must not move (the reference shares immutable
    arrays instead)."""
    params = _params(0)
    before = clone_params(params)
    pub = R.WeightPublisher(keep=2, async_push=async_push)
    try:
        pub.publish(params, 0)
        for leaf in (params["w"], params["layers"]["b"]):
            leaf.add_(1.0)                         # the next step, in place
        pub.flush(timeout=10.0)
        pub.wait_for(0, timeout=10.0)
        kept = pub.train_params(0)
        rollout, _ = pub.latest()
        assert rollout is kept                     # one clone, both views
        for a, b in ((kept["w"], before["w"]),
                     (kept["layers"]["b"], before["layers"]["b"])):
            assert torch.equal(a, b)
            assert a.untyped_storage().data_ptr() != \
                params["w"].untyped_storage().data_ptr()
        assert pub.last_publish_stats["bytes"] == 0
    finally:
        pub.close()


def test_publish_to_another_layout_is_not_yet_ported():
    """Another mesh's layout is reached across the bridge between the two
    meshes: without its ends (``SplitEnds``) the publisher is refused (the
    split: ``tests/test_torch_disaggregated.py``)."""
    with pytest.raises(ValueError, match="across the bridge"):
        R.WeightPublisher(shardings=object())


@pytest.mark.async_rlhf
def test_wait_for_callable_tightens_mid_wait():
    """A wait already in progress re-reads its callable threshold: after
    the tightening, the version that satisfied the old threshold does not
    release it."""
    pub = R.WeightPublisher(keep=4)
    tight = threading.Event()
    out = {}

    def waiter():
        try:
            out["v"] = pub.wait_for(lambda: 2 if tight.is_set() else 1,
                                    timeout=30.0)
        except R.ReplayClosed:
            out["v"] = "closed"

    t = threading.Thread(target=waiter, daemon=True)
    try:
        pub.publish(_params(0), 0)
        t.start()
        threading.Event().wait(0.1)
        tight.set()
        pub.publish(_params(1), 1)
        threading.Event().wait(0.2)
        assert t.is_alive() and "v" not in out
        pub.publish(_params(2), 2)
        t.join(timeout=10.0)
        assert out["v"] == 2
    finally:
        pub.close()
        t.join(timeout=10.0)
    assert not t.is_alive()


def test_train_params_past_keep_raises_key_error():
    pub = R.WeightPublisher(keep=2)
    for v in range(4):
        pub.publish(_params(v), v)
    assert pub.stats()["retained"] == 2
    with pytest.raises(KeyError, match="no longer retained"):
        pub.train_params(1)
    assert torch.equal(pub.train_params(3)["w"], _params(3)["w"])


class _FakeTrainer:
    """Draws what a rollout draws from the stage-3 generator and records
    the version it was given; ``fail_at`` raises on that batch."""

    device = torch.device("cpu")

    def __init__(self, fail_at=None):
        self.fail_at = fail_at
        self.versions = []

    def generate_rollout(self, prompts, generator, *, gen_params=None,
                         version=0, gen_engine=None):
        if len(self.versions) == self.fail_at:
            raise ValueError("decode failed")
        self.versions.append(version)
        noise = torch.rand(3, generator=generator)
        return R.RolloutBatch(sequences=torch.as_tensor(prompts),
                              response_mask=noise > 2,
                              version=version), {"draw": float(noise[0])}


def _producer_for(trainer, n, cfg, pub, q, gen):
    batches = ({"prompts": np.full((2, 3), i)} for i in range(n))
    return R.ExperienceProducer(trainer=trainer, batches=batches,
                                generator=gen, start=0, steps=n, queue=q,
                                publisher=pub, cfg=cfg)


@pytest.mark.async_rlhf
def test_items_carry_the_generator_state_after_their_draws():
    """The consumer never reads the live generator (the producer may be
    drawing the next batch): each item carries the state the synchronous
    loop's generator holds after that batch."""
    n = 4
    sync = torch.Generator().manual_seed(5)
    want = []
    for _ in range(n):
        torch.rand(3, generator=sync)
        want.append(sync.get_state())
    cfg = R.AsyncConfig(queue_depth=n, publish_every=1, max_lag=n)
    pub, q = R.WeightPublisher(keep=n + 2), R.ReplayQueue(n)
    prod = _producer_for(_FakeTrainer(), n, cfg, pub, q,
                         torch.Generator().manual_seed(5))
    try:
        pub.publish(_params(0), 0)
        prod.start()
        prod.join(timeout=30.0)
        items = [q.get(timeout=10.0) for _ in range(n)]
    finally:
        prod.stop()
        pub.close()
        q.cancel()
        prod.join(timeout=30.0)
    assert not prod.alive and prod.error is None
    assert [it.seq for it in items] == list(range(n))
    for it, state in zip(items, want):
        assert torch.equal(it.generator_state, state)


@pytest.mark.async_rlhf
def test_force_lockstep_tightens_the_producers_gate():
    """At ``max_lag=1`` batch 1 may go under version 0; after
    ``force_lockstep`` the gate of the wait already in progress asks for
    version 2 before batch 2."""
    cfg = R.AsyncConfig(queue_depth=1, publish_every=1, max_lag=1)
    pub, q = R.WeightPublisher(keep=4), R.ReplayQueue(1)
    tr = _FakeTrainer()
    prod = _producer_for(tr, 3, cfg, pub, q, torch.Generator())
    try:
        pub.publish(_params(0), 0)
        prod.start()
        assert q.get(timeout=10.0).rollout.version == 0
        assert q.get(timeout=10.0).rollout.version == 0   # lag 1 allowed
        threading.Event().wait(0.1)        # batch 2 waits for version 1
        prod.force_lockstep()
        pub.publish(_params(1), 1)
        threading.Event().wait(0.2)
        assert len(tr.versions) == 2       # version 1 no longer enough
        pub.publish(_params(2), 2)
        assert q.get(timeout=10.0).rollout.version == 2
    finally:
        prod.stop()
        pub.close()
        q.cancel()
        prod.join(timeout=30.0)
    assert not prod.alive and prod.lockstep_active


@pytest.mark.async_rlhf
def test_producer_exception_cancels_the_queue_and_surfaces():
    cfg = R.AsyncConfig(queue_depth=2, publish_every=1, max_lag=2)
    pub, q = R.WeightPublisher(), R.ReplayQueue(2)
    prod = _producer_for(_FakeTrainer(fail_at=1), 3, cfg, pub, q,
                         torch.Generator())
    try:
        pub.publish(_params(0), 0)
        prod.start()
        prod.join(timeout=30.0)
        with pytest.raises(R.ReplayClosed):
            q.get(timeout=10.0)            # cancelled: the backlog dropped
    finally:
        prod.stop()
        pub.close()
        q.cancel()
        prod.join(timeout=30.0)
    assert not prod.alive
    assert isinstance(prod.error, ValueError)
    assert q.cancelled and q.stats()["dropped"] == 1


# ===================================================================== #
# launch counters under threads
# ===================================================================== #
@pytest.mark.async_rlhf
def test_launch_counter_loses_no_increment_across_threads():
    """N threads x M increments of one wrapper's count read N * M, with a
    short switch interval so that an unlocked read-modify-write would lose
    some."""
    fn = ops.KERNELS["rmsnorm"]
    n_threads, m = 8, 2_000
    old = sys.getswitchinterval()
    ops.reset_launch_counts()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [build.count_launch(fn) for _ in range(m)],
            daemon=True) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    counts = ops.launch_counts()
    assert counts["rmsnorm"] == n_threads * m
    assert all(v == 0 for k, v in counts.items() if k != "rmsnorm")
    ops.reset_launch_counts()
    assert set(ops.launch_counts().values()) == {0}
