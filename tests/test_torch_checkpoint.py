"""The port's checkpoint format (``repro_torch.training.checkpoint``) held
to the reference's (``repro.training.checkpoint``, which imports here):
each package restores the other's ``CheckpointManager`` checkpoints and
``.npz`` exports bitwise; for the same tree the two write equal manifests
and byte-equal shard files, bf16 leaves included (the port writes their
16 bits under the ``'<V2'`` header an ``ml_dtypes`` array gets); the
reference cannot restore its own bf16 leaves (ROADMAP Queue 3, R12).
Then the manager's faults: missing, truncated and bit-flipped shards,
dtype mismatches, key collisions, ``keep``, stale temp directories, a
failing writer, and the snapshot surviving in-place updates."""
import json
import os
import threading

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from _torch_parity import config_pair, params_pair, state_pair
from repro.training import checkpoint as jckpt
from repro_torch.models import convert
from repro_torch.models.modules import tree_leaves
from repro_torch.training import checkpoint as tckpt
from repro_torch.training.train_state import TrainState

ARCH = "smollm-135m"


def _states(seed=0):
    """A reference TrainState (fp32 params + moments, int32 steps) with
    nonzero moments and steps, and the same state in the port."""
    jcfg, _ = config_pair(ARCH)
    jparams, _ = params_pair(jcfg, seed=seed)
    jstate, _ = state_pair(jparams)
    rng = np.random.default_rng(seed)
    bump = lambda x: jnp.asarray(rng.standard_normal(x.shape), x.dtype)
    jstate = jstate._replace(
        opt=jstate.opt._replace(m=jax.tree.map(bump, jstate.opt.m),
                                v=jax.tree.map(bump, jstate.opt.v),
                                step=jnp.asarray(7, jnp.int32)),
        step=jnp.asarray(7, jnp.int32))
    return jstate, convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu")


def _zeros_like_port(state):
    return TrainState(*[convert.params_from_numpy(jax.tree.map(
        lambda x: np.zeros_like(np.asarray(x)), t), "cpu")
        for t in (state.params, state.opt, state.step)])


def _assert_port_equals_ref(got, want):
    """Every leaf of the port tree ``got`` equals the reference tree's at
    the same path, dtype included."""
    flat = dict(tckpt._flat(got))
    ref = {jckpt._path_key(p): np.asarray(x) for p, x in
           jax.tree_util.tree_flatten_with_path(want)[0]}
    assert flat.keys() == ref.keys()
    for k, t in flat.items():
        name, arr = tckpt._host(t)
        assert name == ref[k].dtype.name, k
        np.testing.assert_array_equal(arr.view(ref[k].dtype), ref[k],
                                      err_msg=k)


def _files(step_dir):
    out = {}
    for root, _, names in os.walk(step_dir):
        for n in names:
            p = os.path.join(root, n)
            with open(p, "rb") as f:
                out[os.path.relpath(p, step_dir)] = f.read()
    return out


# --------------------------------------------------------------------- #
# format, both ways
# --------------------------------------------------------------------- #
def test_keys_follow_the_reference_pytree_order():
    jstate, tstate = _states()
    want = [jckpt._path_key(p) for p, _ in
            jax.tree_util.tree_flatten_with_path(jstate)[0]]
    got = [tckpt._path_key(p) for p, _ in tckpt.flatten_with_path(tstate)]
    assert got == want
    assert {".params/embed", ".opt/.m/embed", ".opt/.step",
            ".step"} <= set(got)
    # None is an empty subtree, as in jax
    assert tckpt.flatten_with_path({"a": None, "b": torch.ones(1)}) == [
        (("b",), tckpt.flatten_with_path({"b": torch.ones(1)})[0][1])]


def test_reference_manager_checkpoint_restores_bitwise_in_the_port(tmp_path):
    jstate, tstate = _states(1)
    jckpt.CheckpointManager(str(tmp_path)).save(3, jstate, {"k": 1},
                                                wait=True)
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.verify(3)
    got, meta = mgr.restore(_zeros_like_port(tstate))
    assert meta == {"k": 1}
    _assert_port_equals_ref(got, jstate)
    assert got.step.dtype == torch.int32 and got.step.shape == ()


def test_port_manager_checkpoint_restores_bitwise_in_the_reference(
        tmp_path):
    jstate, tstate = _states(2)
    tckpt.CheckpointManager(str(tmp_path)).save(5, tstate, {"k": 2},
                                                wait=True)
    mgr = jckpt.CheckpointManager(str(tmp_path))
    mgr.verify(5)
    got, meta = mgr.restore(jax.tree.map(jnp.zeros_like, jstate))
    assert meta == {"k": 2}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_same_tree_gives_equal_manifests_and_byte_equal_shards(tmp_path):
    jstate, tstate = _states(3)
    extra_j = {"bf16": jnp.asarray(np.linspace(-3, 3, 12).reshape(3, 4),
                                   jnp.bfloat16),
               "i8": jnp.arange(-4, 4, dtype=jnp.int8), "none": None}
    extra_t = {"bf16": torch.linspace(-3, 3, 12).reshape(3, 4).to(
        torch.bfloat16), "i8": torch.arange(-4, 4, dtype=torch.int8),
        "none": None}
    meta = {"stage": "ppo", "log": [1.5, 2.25]}
    jckpt.CheckpointManager(str(tmp_path / "j")).save(
        4, {"state": jstate, "x": extra_j}, meta, wait=True)
    tckpt.CheckpointManager(str(tmp_path / "t")).save(
        4, {"state": tstate, "x": extra_t}, meta, wait=True)
    jfiles = _files(tmp_path / "j" / "step_00000004")
    tfiles = _files(tmp_path / "t" / "step_00000004")
    assert sorted(jfiles) == sorted(tfiles)
    jman = json.loads(jfiles.pop("manifest.json"))
    tman = json.loads(tfiles.pop("manifest.json"))
    assert tman == jman
    assert jman["leaves"]["x/bf16"]["dtype"] == "bfloat16"
    for name in jfiles:
        assert tfiles[name] == jfiles[name], name
    assert b"'descr': '<V2'" in tfiles[
        jman["leaves"]["x/bf16"]["shards"][0]["file"]]


def test_legacy_npz_both_ways(tmp_path):
    jstate, tstate = _states(4)
    jckpt.save(str(tmp_path / "ref.npz"), jstate, {"arch": "a"})
    got = tckpt.load(str(tmp_path / "ref.npz"), _zeros_like_port(tstate))
    _assert_port_equals_ref(got, jstate)
    assert tckpt.load_metadata(str(tmp_path / "ref.npz")) == {"arch": "a"}

    tckpt.save(str(tmp_path / "port"), tstate, {"arch": "b"})
    assert os.path.exists(tmp_path / "port.npz")           # as np.savez
    back = jckpt.load(str(tmp_path / "port"),
                      jax.tree.map(jnp.zeros_like, jstate))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    assert jckpt.load_metadata(str(tmp_path / "port")) == {"arch": "b"}


def test_bf16_leaves_cross_by_their_bits(tmp_path):
    """A reference-written bf16 shard and ``.npz`` member restore in the
    port bitwise (by the manifest's dtype and by the 2-byte void), and a
    port-written bf16 ``.npz`` member reads back in the port."""
    bits = np.random.default_rng(5).integers(0, 2**16, (5, 7),
                                             dtype=np.uint16)
    bits[(bits & 0x7F80) == 0x7F80] = 0x3F80        # no NaN / inf patterns
    jtree = {"w": bits.view(ml_dtypes.bfloat16)}
    like = {"w": torch.zeros(5, 7, dtype=torch.bfloat16)}
    want = torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)
    jckpt.CheckpointManager(str(tmp_path / "m")).save(1, jtree, wait=True)
    got, _ = tckpt.CheckpointManager(str(tmp_path / "m")).restore(like)
    assert got["w"].dtype == torch.bfloat16
    assert torch.equal(got["w"].view(torch.int16), want.view(torch.int16))
    jckpt.save(str(tmp_path / "j.npz"), jtree)
    got = tckpt.load(str(tmp_path / "j.npz"), like)
    assert torch.equal(got["w"].view(torch.int16), want.view(torch.int16))
    tckpt.save(str(tmp_path / "t.npz"), {"w": want})
    got = tckpt.load(str(tmp_path / "t.npz"), like)
    assert torch.equal(got["w"].view(torch.int16), want.view(torch.int16))
    # a bf16 member restored into fp32 only with cast=True, exactly
    with pytest.raises(tckpt.CheckpointDtypeError):
        tckpt.load(str(tmp_path / "t.npz"), {"w": torch.zeros(5, 7)})
    got = tckpt.load(str(tmp_path / "t.npz"), {"w": torch.zeros(5, 7)},
                     cast=True)
    assert torch.equal(got["w"], want.float())


def test_r12_the_reference_cannot_restore_its_own_bf16_leaves(tmp_path):
    """R12: the reference writes bf16 leaves it cannot read back, through
    either API (the port reads them: the test above)."""
    tree = {"w": jnp.ones((2, 3), jnp.bfloat16)}
    jckpt.save(str(tmp_path / "x.npz"), tree)
    with pytest.raises(jckpt.CheckpointDtypeError, match=r"\|V2"):
        jckpt.load(str(tmp_path / "x.npz"), tree)
    mgr = jckpt.CheckpointManager(str(tmp_path / "m"))
    mgr.save(1, tree, wait=True)
    with pytest.raises(ValueError, match="cast"):
        mgr.restore(tree)


# --------------------------------------------------------------------- #
# faults
# --------------------------------------------------------------------- #
def _small_tree():
    return {"a": torch.arange(6.0), "b": torch.ones(2, 2),
            "c": torch.zeros(3, dtype=torch.int32)}


@pytest.mark.parametrize("damage", ["missing", "truncated", "bitflip"])
def test_damaged_shard_is_a_corrupt_checkpoint(tmp_path, damage):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _small_tree(), wait=True)
    shard = tmp_path / "step_00000001" / "shards" / "00001.00.npy"
    data = shard.read_bytes()
    if damage == "missing":
        shard.unlink()
    elif damage == "truncated":
        shard.write_bytes(data[:-3])
    else:
        shard.write_bytes(data[:-1] + bytes([data[-1] ^ 0x10]))
    with pytest.raises(tckpt.CheckpointCorruptError):
        mgr.restore(_small_tree())
    with pytest.raises(tckpt.CheckpointCorruptError):
        mgr.verify(1)


def test_dtype_mismatch_needs_cast(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path))
    mgr.save(1, _small_tree(), wait=True)
    like = dict(_small_tree(), a=torch.zeros(6, dtype=torch.float64))
    with pytest.raises(tckpt.CheckpointDtypeError, match="cast=True"):
        mgr.restore(like)
    got, _ = mgr.restore(like, cast=True)
    assert got["a"].dtype == torch.float64
    assert torch.equal(got["a"], torch.arange(6.0, dtype=torch.float64))
    with pytest.raises(tckpt.CheckpointError, match="shape"):
        mgr.restore(dict(_small_tree(), b=torch.ones(4)))
    with pytest.raises(tckpt.CheckpointError, match="no leaf"):
        mgr.restore(dict(_small_tree(), d=torch.ones(1)))
    with pytest.raises(NotImplementedError, match="not yet ported"):
        mgr.restore(_small_tree(), shardings=object())


class _Key(str):
    """A dict key whose printed form is not its value."""

    def __str__(self):
        return "same"


def test_key_collision_raises(tmp_path):
    tree = {_Key("x"): torch.ones(1), _Key("y"): torch.zeros(1)}
    with pytest.raises(tckpt.CheckpointError, match="collision"):
        tckpt.CheckpointManager(str(tmp_path)).save(1, tree, wait=True)
    with pytest.raises(tckpt.CheckpointError, match="collision"):
        tckpt.save(str(tmp_path / "x.npz"), tree)


def test_keep_and_stale_temp_dirs(tmp_path):
    mgr = tckpt.CheckpointManager(str(tmp_path), keep=2)
    for s in range(1, 5):
        mgr.save(s, _small_tree(), {"s": s})
    mgr.wait_for_save()
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    assert mgr.restore_metadata() == {"s": 4}
    stale = tmp_path / ".tmp-step_00000009-1"
    (stale / "shards").mkdir(parents=True)
    (tmp_path / "step_00000010").mkdir()          # no manifest: not a step
    mgr2 = tckpt.CheckpointManager(str(tmp_path))
    assert not stale.exists()
    assert mgr2.latest_step() == 4
    assert [s["step"] for s in mgr.stats] == [1, 2, 3, 4]
    assert all(s["write_s"] > 0 and s["bytes"] > 0 for s in mgr.stats)


def test_writer_failure_surfaces_and_keeps_previous(tmp_path):
    def hook(event, count):
        if event == "shard" and count > 3:      # the first save has 3
            raise RuntimeError("disk on fire")
    mgr = tckpt.CheckpointManager(str(tmp_path), fault_hook=hook)
    mgr.save(1, _small_tree(), {"i": 1})
    mgr.wait_for_save()
    mgr.save(2, _small_tree(), {"i": 2})
    with pytest.raises(RuntimeError, match="disk on fire"):
        mgr.wait_for_save()
    assert mgr.latest_step() == 1
    mgr.verify(1)
    got, meta = mgr.restore(_small_tree())
    assert meta == {"i": 1}


def test_snapshot_survives_in_place_updates(tmp_path):
    """The optimizer updates tensors in place: values changed right after
    ``save`` returns must not reach the checkpoint, even while the
    background writer is held back."""
    go = threading.Event()

    def hook(event, count):
        if event == "shard" and count == 1:
            go.wait(10)
    tree = _small_tree()
    before = {k: v.clone() for k, v in tree.items()}
    mgr = tckpt.CheckpointManager(str(tmp_path), fault_hook=hook)
    mgr.save(1, tree)
    for t in tree.values():
        t.add_(1)
    go.set()
    mgr.wait_for_save()
    got, _ = mgr.restore(_small_tree())
    for k in tree:
        assert torch.equal(got[k], before[k]), k


def test_tree_sha256_sees_every_leaf_and_the_dtype():
    _, tstate = _states(6)
    h = tckpt.tree_sha256(tstate)
    assert h == tckpt.tree_sha256(_states(6)[1])
    leaves = tree_leaves(tstate.opt.v)
    leaves[0].view(-1)[0] += 1
    assert tckpt.tree_sha256(tstate) != h
    a = {"x": torch.zeros(4, dtype=torch.int32)}
    b = {"x": torch.zeros(4, dtype=torch.float32)}
    assert tckpt.tree_sha256(a) != tckpt.tree_sha256(b)
