"""Sharded checkpoints on a ``("data", "model")`` mesh: save on one mesh,
restore on another, through the manager, the PPO trainer, the RLHF
pipeline and the launcher, on gloo ranks over the CPU, held to the
single-rank port and to the reference (``tests/test_checkpoint_resume.py``'s
cross-topology test, whose model and tolerance these are: a 2-layer dense
actor, d 64, 4 heads, 2 kv heads, V 64, fp32, a ``tp`` + ZeRO-1 trainer
after one greedy PPO step; rtol 2e-4, atol 2e-5 across layouts).

- The window of a rank (``runtime.window``) against ``chunk`` for the
  ``zero3``, ``tp`` + ZeRO-1, uneven-heads (FULL leaves) and Mamba2
  (segmented leaves) train states at 2 x 1, 1 x 2, 2 x 2 and 1 x 4, with
  no process group; and against the reference's ``addressable_shards``
  windows on the same meshes.
- Who writes each window: one rank that holds it, the replicated windows
  spread over their holders (no process group; 4 x 1 too).
- The manager's round-trip property (``tests/test_checkpoint_properties.py``)
  on ``DTensor`` trees of mixed dtypes, bf16 included, on a one-rank gloo
  group in this process: bitwise, the manifest exactly the files on disk,
  a truncated or deleted window detected as corrupt.
- Same bits in both packages: the port's 2 x 2 state saved on gloo 2 x 2
  and by the reference on its 2 x 2 mesh of simulated devices give equal
  manifest leaves (shapes, dtypes, every shard's file, window, size and
  CRC; some leaf in several shards) and byte-equal shard files.  Each
  reads the other's: the reference the port's onto 4 x 1 and one device,
  the port the reference's onto 4 x 1, 1 x 4, 1 x 1 and no mesh, bitwise.
- Cross-topology resume: saved on 2 x 2, restored and continued on 4 x 1,
  1 x 2, 1 x 4 and one device: the restored state bitwise, the greedy
  tokens equal, the continued step's metrics within the tolerance; on
  2 x 2 itself the continuation is bitwise.
- The launcher: ``torchrun ... launch.train --mesh 2,1 --strategy zero3
  --zero 1 --ckpt-dir --save-every 2``, its last step deleted, resumed on
  the same mesh (the final hash equal), on ``--mesh 1,2 --strategy tp``
  and with no mesh (the restored state's hash equal, the final losses
  within tolerance); ``--rlhf``'s pipeline (``tests/_torch_ckpt_driver.py
  --mesh 2,1``) killed after PPO iteration 1 and resumed: bitwise.
- Atomicity across ranks: ``REPRO_CKPT_FAULT=shard:30``, then
  ``before_commit:2``, at 2 x 2: each run exits non-zero, the step being
  written does not appear, the previous one verifies, the next run sweeps
  the torn temp directory, and the clean rerun ends bitwise equal to the
  uninterrupted run.  A ``fault_hook`` that raises on rank 1 alone fails
  ``save`` / ``wait_for_save`` on every rank within a second, and nothing
  commits; one that holds rank 1 up past the writers' base wait does not
  fail the save, since the wait grows with the bytes of the largest share.

The gloo launches (``tests/_torch_mesh_driver.py --cases ck_*``, one per
mesh) and the reference's ``ck`` run (``tests/_jax_mesh_reference.py``)
start together; each waits for the checkpoint it reads to commit.
"""
import filecmp
import json
import os
import pickle
import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_driver as D
from _hyp import given, settings, st
from repro_torch.models import transformer as T
from repro_torch.models.modules import flatten_with_path
from repro_torch.sharding import runtime
from repro_torch.sharding import strategy as S
from repro_torch.training import checkpoint as C
from repro_torch.training.train_state import TrainState
from test_torch_tensor_parallel import _env, _wait

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
WINDOW_MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
RESUME_MESHES = ((4, 1), (1, 2), (1, 4))
# each launch's cases; ``ck_pipe`` is the uninterrupted pipeline the
# killed (2 x 1, on the 1 x 2 launch's two ranks) and crashed (2 x 2) runs
# are held to
CK_CASES = {(2, 2): ("ck_save", "ck_fault", "ck_slow", "ck_pipe"),
            (4, 1): ("ck_resume",), (1, 2): ("ck_resume", "ck_pipe"),
            (1, 4): ("ck_resume",)}
LAYOUTS = [name for name, *_ in D.CK_LAYOUTS]
CKPT_DRIVER = str(ROOT / "tests" / "_torch_ckpt_driver.py")
# (REPRO_CKPT_FAULT, the last step committed before it): a rank dies in
# the second save's shards, then (rerun) every rank before the third's
# commit
FAULTS = (("shard:30", 1), ("before_commit:2", 2))
LM_ARGS = ("--device", "cpu", "--arch", "smollm-135m", "--reduced",
           "--steps", "6", "--batch", "4", "--seq", "16", "--save-every",
           "2")


def _mesh_id(mesh) -> str:
    return "{}x{}".format(*mesh)


def _launch(n: int, log: Path, *args, fault=None):
    """``torchrun`` of ``n`` ranks (``python`` itself for ``n == 0``),
    started, its output to ``log``; ``fault`` sets ``REPRO_CKPT_FAULT``."""
    env = _env()
    env.pop("REPRO_CKPT_FAULT", None)
    if fault is not None:
        env["REPRO_CKPT_FAULT"] = fault
    head = ([sys.executable] if n == 0 else
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", str(n)])
    with open(log, "w") as f:
        return subprocess.Popen(head + [str(a) for a in args], stdout=f,
                                stderr=subprocess.STDOUT, text=True,
                                cwd=ROOT, env=env)


def _exit_code(proc, log: Path, timeout=600) -> int:
    try:
        return proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise AssertionError(log.read_text()[-4000:])


def _json(path):
    with open(path) as f:
        return json.load(f)


def _plain(record: dict):
    """A record as its JSON file holds it."""
    return json.loads(json.dumps(record))


def _equal_keyed(a: dict, b: dict):
    """Two trees by checkpoint key: the same keys, and each leaf the same
    dtype, shape and bits."""
    assert a.keys() == b.keys()
    for k, x in a.items():
        y = np.asarray(b[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        np.testing.assert_array_equal(x, y, err_msg=k)


# --------------------------------------------------------------------- #
# every launch that needs no other's output, started at module setup
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    d = tmp_path_factory.mktemp("mck")
    ck = d / "ck"
    ck.mkdir()
    inp = {"ck": True, "layouts": D.CK_LAYOUTS, "meshes": WINDOW_MESHES,
           "state": str(ck / "state.pkl"), "port_dir": str(ck / "port"),
           "ref_dir": str(ck / "ref")}
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(d / "ref.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_mesh_reference.py"),
             str(d / "in.pkl"), str(d / "ref.pkl"), "2", "2"],
            stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    runs = {}
    for mesh in ((2, 2),) + RESUME_MESHES:
        out = d / f"run{_mesh_id(mesh)}"
        out.mkdir()
        runs[mesh] = (out, _launch(
            mesh[0] * mesh[1], out / "log", ROOT / "tests" /
            "_torch_mesh_driver.py", "--out", out, "--cases",
            ",".join(CK_CASES[mesh]),
            "--mesh", "{},{}".format(*mesh), "--ck", ck))
    lm = d / "lm"
    lm.mkdir()
    rl = d / "rlhf"
    rl.mkdir()
    other = {
        "lm": _launch(2, lm / "full.log", CKPT_DRIVER, "--out",
                      lm / "full.json", "--lm", *LM_ARGS, "--mesh", "2,1",
                      "--strategy", "zero3", "--zero", "1", "--ckpt-dir",
                      lm / "ck"),
        "rlhf_dead": _launch(2, rl / "dead.log", CKPT_DRIVER, "--out",
                             rl / "dead.json", "--mesh", "2,1",
                             "--ckpt-dir", rl / "ck", "--die-at-iter", "1")}
    fa = d / "faults"
    fa.mkdir()
    other["fault_shard"] = _launch(4, fa / "crash0.log", *_fault_args(fa),
                                   fault=FAULTS[0][0])
    yield {"dir": d, "ck": ck, "ref": ref, "runs": runs, "other": other}
    for p in [ref] + [p for _, p in runs.values()] + list(other.values()):
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def reference(started):
    p = started["ref"]
    p.wait(timeout=600)
    log = (started["dir"] / "ref.log").read_text()
    assert p.returncode == 0, log[-4000:]
    with open(started["dir"] / "ref.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def runs(started):
    out = {}
    for mesh, (d, p) in started["runs"].items():
        _wait(p, d / "log")
        out[mesh] = {c: torch.load(d / f"{c}.pt", weights_only=False)
                     for c in CK_CASES[mesh]}
    return out


# --------------------------------------------------------------------- #
# the window of a rank: no process group
# --------------------------------------------------------------------- #
class _FakeMesh:
    """What ``chunk`` and ``placements`` read of a mesh, at one
    coordinate."""

    def __init__(self, dp: int, tp: int, coord=(0, 0)):
        self.shape = {"data": dp, "model": tp}
        self.axis_names = ("data", "model")
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)

    def size(self, i: int) -> int:
        return tuple(self.shape.values())[i]


class _Box:
    """A pspec held as one leaf (a pspec is a tuple, which trees walk)."""

    def __init__(self, pspec):
        self.pspec = pspec


def _layout_leaves(name: str, mesh) -> list:
    """``(key, shape, pspec)`` of every leaf of the train state of
    :data:`D.CK_LAYOUTS` ``name`` on ``mesh``, in flattening order."""
    _, arch, over, strategy = next(c for c in D.CK_LAYOUTS if c[0] == name)
    cfg = D.tpl_config(arch, over)
    state = TrainState.create(T.init_params(cfg, D._gen(0)))
    pspecs = runtime.tree_map(_Box, S.train_state_pspecs(
        cfg, mesh, strategy, zero=1), is_leaf=S.is_pspec)
    leaves = flatten_with_path(state)
    boxes = flatten_with_path(pspecs)
    assert [p for p, _ in leaves] == [p for p, _ in boxes]
    return [(C._path_key(p), tuple(t.shape), b.pspec)
            for (p, t), (_, b) in zip(leaves, boxes)]


@pytest.mark.parametrize("mesh", WINDOW_MESHES, ids=map(_mesh_id,
                                                        WINDOW_MESHES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_inverts_chunk(layout, mesh):
    """Every rank's window of every leaf is the piece ``chunk`` cuts for
    it under the pspec's placements; the windows split each leaf evenly
    (a leaf's windows either all equal or all distinct per piece), and at
    least one leaf is cut."""
    fake = _FakeMesh(*mesh)
    axes = S.mesh_axes(fake)
    cut = 0
    for key, shape, pspec in _layout_leaves(layout, fake):
        t = torch.arange(int(np.prod(shape))).view(shape)
        pls = S.placements(pspec, fake)
        for coord in runtime.mesh_coords(axes):
            win = runtime.window(pspec, axes, shape, coord)
            fake.coord = coord
            piece = runtime.chunk(t, fake, pls)
            want = t[tuple(slice(None) if w is None else slice(*w)
                           for w in win)]
            assert torch.equal(piece, want), (key, coord, win)
            cut += any(w is not None for w in win)
    assert cut


@pytest.mark.parametrize("mesh", WINDOW_MESHES, ids=map(_mesh_id,
                                                        WINDOW_MESHES))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_window_is_the_reference_shard(reference, layout, mesh):
    """In rank order (row-major over the mesh) the windows are the
    reference's ``addressable_shards`` windows of the same leaf, on a mesh
    of simulated devices of the same shape."""
    fake = _FakeMesh(*mesh)
    axes = S.mesh_axes(fake)
    ref = reference["windows"][(layout, *mesh)]
    got = {key: [[None if w is None else list(w) for w in runtime.window(
        pspec, axes, shape, c)] for c in runtime.mesh_coords(axes)]
        for key, shape, pspec in _layout_leaves(layout, fake)}
    assert got == ref


@pytest.mark.parametrize("mesh", WINDOW_MESHES + ((4, 1),),
                         ids=map(_mesh_id, WINDOW_MESHES + ((4, 1),)))
@pytest.mark.parametrize("layout", LAYOUTS)
def test_writers_spread_the_replicated_windows(layout, mesh):
    """Who writes each window (``checkpoint._assign``, no process group):
    one rank that holds it, each distinct window once, and the windows
    several ranks hold spread over them, so that no rank's share exceeds
    another's by more than the largest such window (under ``tp`` + ZeRO-1
    at 4 x 1 the first rank would otherwise write every replicated
    param)."""
    fake = _FakeMesh(*mesh)
    axes = S.mesh_axes(fake)
    coords = runtime.mesh_coords(axes)
    layouts = [([runtime.window(pspec, axes, shape, c) for c in coords],
                shape, 4) for _, shape, pspec in _layout_leaves(layout, fake)]
    writers, loads = C._assign(layouts, len(coords))

    def nbytes(shape, win):
        return 4 * int(np.prod([n if w is None else w[1] - w[0]
                                for n, w in zip(shape, win)]))
    total, shared = 0, [0]
    for (wins, shape, _), who in zip(layouts, writers):
        distinct = list(dict.fromkeys(wins))
        assert len(who) == len(distinct)
        for win, r in zip(distinct, who):
            assert wins[r] == win
            total += nbytes(shape, win)
            if wins.count(win) > 1:
                shared.append(nbytes(shape, win))
    assert sum(loads) == total
    assert max(loads) - min(loads) <= max(shared), loads


def test_window_refuses_an_uneven_split():
    with pytest.raises(ValueError, match="evenly"):
        runtime.window(("data", None), {"data": 2, "model": 1}, (3, 4),
                       (0, 0))
    assert runtime.window((("data", "model"),), {"data": 2, "model": 2},
                          (8,), (1, 0)) == ((4, 6),)


# --------------------------------------------------------------------- #
# the round-trip property on a one-rank gloo group in this process
# --------------------------------------------------------------------- #
_ONE = {}
DTYPES = [torch.float32, torch.bfloat16, torch.float16, torch.int32,
          torch.int8, torch.uint8, torch.bool]


def _one_rank_mesh():
    """A 1 x 1 mesh on a one-rank gloo group of this process (made once;
    the module's teardown destroys the group it made)."""
    if "mesh" not in _ONE:
        import tempfile

        import torch.distributed as dist

        from repro_torch.launch.mesh import init_distributed, make_mesh
        _ONE["owned"] = not dist.is_initialized()
        _ONE["store"] = tempfile.mkdtemp()
        init_distributed("cpu", init_method="file://" + os.path.join(
            _ONE["store"], "store"), rank=0, world_size=1)
        _ONE["mesh"] = make_mesh(1, 1)
    return _ONE["mesh"]


@pytest.fixture(scope="module", autouse=True)
def _one_rank_teardown():
    yield
    if _ONE.get("owned"):
        import torch.distributed as dist
        dist.destroy_process_group()
    if "store" in _ONE:
        shutil.rmtree(_ONE["store"], ignore_errors=True)


def _leaf(z: int) -> torch.Tensor:
    """A leaf from one drawn int: 0-3 dims of sides 1-4, the dtype cycling
    through :data:`DTYPES`."""
    rng = np.random.default_rng(z)
    shape = tuple(int(n) for n in rng.integers(1, 5, z % 4))
    dtype = DTYPES[z % len(DTYPES)]
    raw = torch.from_numpy(rng.integers(-100, 100, shape))
    if dtype is torch.bool:
        return raw > 0
    if dtype.is_floating_point:
        return (raw / 7.0).to(dtype)
    return raw.to(dtype)


def _placed(zs, mesh):
    """The drawn leaves as a tree of ``DTensor``\\ s laid out by drawn
    placements (and every fourth a plain tensor), with each leaf's
    sharding (``None`` for the plain ones)."""
    from torch.distributed.tensor import Replicate, Shard
    tree, shs = {}, {}
    for i, z in enumerate(zs):
        t = _leaf(z)
        key = f"k{i}/{'x' if z % 3 else 'y%'}"
        if i % 4 == 3:
            tree[key], shs[key] = t, None
            continue
        pls = tuple(Shard((z >> (4 + j)) % t.dim()) if t.dim() and
                    (z >> (2 + j)) % 2 else Replicate() for j in range(2))
        sh = S.Sharding(mesh, pls, runtime.pspec_of(
            pls, mesh.mesh_dim_names, t.dim()))
        tree[key] = runtime.place(t, mesh, pls)
        shs[key] = sh
    return tree, shs


def _full_bitwise(tree, restored):
    for k, t in tree.items():
        a, b = runtime.full(t), runtime.full(restored[k])
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b), k


@given(st.lists(st.integers(0, 2 ** 31 - 1), min_size=1, max_size=8))
@settings(max_examples=25, deadline=None)
def test_sharded_roundtrip_bitwise_and_manifest_exact(zs):
    import tempfile
    mesh = _one_rank_mesh()
    tree, shs = _placed(zs, mesh)
    with tempfile.TemporaryDirectory() as d:
        mgr = C.CheckpointManager(d, async_write=False)
        mgr.save(1, tree, {"n": len(zs)})
        mgr.verify(1)
        step_dir = os.path.join(d, "step_00000001")
        man = _json(os.path.join(step_dir, "manifest.json"))
        listed = {s["file"] for e in man["leaves"].values()
                  for s in e["shards"]}
        on_disk = {os.path.join("shards", f) for f in
                   os.listdir(os.path.join(step_dir, "shards"))}
        assert listed == on_disk
        restored, meta = mgr.restore(C.like(tree), shardings=shs)
        assert meta == {"n": len(zs)}
        _full_bitwise(tree, restored)
        for k, t in restored.items():
            assert runtime.is_dtensor(t) == (shs[k] is not None
                                             and t.dim() > 0)
        plain, _ = mgr.restore(C.like(tree))
        _full_bitwise(tree, plain)


@given(st.lists(st.integers(0, 2 ** 31 - 1), min_size=1, max_size=8),
       st.integers(0, 10 ** 6), st.integers(0, 1))
@settings(max_examples=25, deadline=None)
def test_damaged_window_detected_as_corrupt(zs, pick, action):
    import tempfile
    tree, shs = _placed(zs, _one_rank_mesh())
    with tempfile.TemporaryDirectory() as d:
        mgr = C.CheckpointManager(d, async_write=False)
        mgr.save(1, tree)
        shards_dir = os.path.join(d, "step_00000001", "shards")
        files = sorted(os.listdir(shards_dir))
        victim = os.path.join(shards_dir, files[pick % len(files)])
        if action == 0:
            os.remove(victim)
        else:
            with open(victim, "r+b") as f:
                f.truncate(max(os.path.getsize(victim) // 2, 1))
        with pytest.raises(C.CheckpointCorruptError):
            mgr.restore(C.like(tree), shardings=shs)
        with pytest.raises(C.CheckpointCorruptError):
            mgr.verify(1)


def test_restore_refuses_a_mismatched_shardings_tree(tmp_path):
    mesh = _one_rank_mesh()
    tree, shs = _placed([5, 6, 7], mesh)
    mgr = C.CheckpointManager(str(tmp_path))
    mgr.save(1, tree, wait=True)
    for bad in (object(), {"k0/x": shs["k0/x"]},
                dict(shs, extra=shs["k0/x"]),
                {k: 1 for k in shs}):
        with pytest.raises(C.CheckpointError, match="shardings tree"):
            mgr.restore(C.like(tree), shardings=bad)


# --------------------------------------------------------------------- #
# the same bits in both packages, and each reads the other's
# --------------------------------------------------------------------- #
def _step_dir(started, which: str) -> Path:
    return started["ck"] / which / "step_00000001"


def test_manifest_and_shard_files_equal_the_reference(started, reference,
                                                      runs):
    port, ref = (_json(_step_dir(started, w) / "manifest.json")
                 for w in ("port", "ref"))
    assert port["leaves"] == ref["leaves"]
    assert port["metadata"] == ref["metadata"] == {"ppo_iter": 1}
    assert any(len(e["shards"]) > 1 for e in port["leaves"].values())
    files = sorted(os.listdir(_step_dir(started, "port") / "shards"))
    assert files == sorted(os.listdir(_step_dir(started, "ref") / "shards"))
    for f in files:
        assert filecmp.cmp(_step_dir(started, "port") / "shards" / f,
                           _step_dir(started, "ref") / "shards" / f,
                           shallow=False), f


@pytest.mark.parametrize("where", ["4x1", "1x1"])
def test_reference_restores_the_port_checkpoint(runs, reference, where):
    got = reference["restored"][where]
    assert got["meta"] == {"ppo_iter": 1}
    _equal_keyed(runs[(2, 2)]["ck_save"]["saved"], got["tree"])


@pytest.mark.parametrize("where", ["4x1", "1x4", "1x1", "plain"])
def test_port_restores_the_reference_checkpoint(started, reference, runs,
                                                where):
    """Every restored leaf is the saved one, bit for bit, and on a mesh a
    ``DTensor`` (but the 0-d step counters and the generator state)."""
    saved = runs[(2, 2)]["ck_save"]["saved"]
    ckdir = str(started["ck"] / "ref")
    if where in ("1x1", "plain"):
        got = D.ck_restore(ckdir, _one_rank_mesh() if where == "1x1"
                           else None)
    else:
        mesh = tuple(int(x) for x in where.split("x"))
        got = runs[mesh]["ck_resume"]["reference"]
    _equal_keyed(saved, got["tree"])
    assert got["dtensors"] == (0 if where == "plain" else len(saved) - 5)
    assert got["meta"] == {"ppo_iter": 1}


# --------------------------------------------------------------------- #
# cross-topology resume
# --------------------------------------------------------------------- #
def _resumed(started, runs, where):
    if where == "one_device":
        return D.ck_resume(str(started["ck"] / "port"), None)
    return runs[tuple(int(x) for x in where.split("x"))]["ck_resume"][
        "resumed"]


@pytest.mark.parametrize("where", ["4x1", "1x2", "1x4", "one_device"])
def test_cross_topology_resume(started, runs, where):
    """Saved on 2 x 2, resumed on ``where``: the restored state is the
    saved one bitwise, the greedy continuation's tokens are 2 x 2's, and
    the continued step's metrics agree within the cross-layout
    tolerance."""
    save = runs[(2, 2)]["ck_save"]
    got = _resumed(started, runs, where)
    _equal_keyed(save["saved"], got["restored"])
    cont = save["continued"]
    np.testing.assert_array_equal(got["tokens"], cont["tokens"])
    assert got["metrics"].keys() == cont["metrics"].keys()
    for k, v in cont["metrics"].items():
        np.testing.assert_allclose(got["metrics"][k], v, **TOL, err_msg=k)


def test_same_mesh_resume_is_bitwise(runs):
    """2 x 2 -> 2 x 2: the resumed continuation is the uninterrupted one,
    bit for bit (tokens, metrics, the whole state after the step)."""
    save = runs[(2, 2)]["ck_save"]
    cont, res = save["continued"], save["resumed"]
    _equal_keyed(save["saved"], res["restored"])
    np.testing.assert_array_equal(res["tokens"], cont["tokens"])
    assert res["metrics"] == cont["metrics"]
    _equal_keyed(cont["state"], res["state"])


def test_a_slow_rank_is_waited_for_by_its_bytes(runs):
    """Rank 1's writes held up 8 s, past the writers' base wait (cut to 4 s
    in the driver): the others wait for it, as the wait grows with the
    bytes of the largest share, and the save commits on every rank; at
    2 x 2 with ``tp`` params, replicated over ``data``, every rank writes
    a share."""
    ranks = runs[(2, 2)]["ck_slow"]
    assert len(ranks) == 4
    for r, res in enumerate(ranks):
        assert res["error"] is None, (r, res)
        assert res["steps"] == [1], (r, res)
        assert res["bytes"] > 0, (r, res)
        assert res["seconds"] > D.CK_SLOW_BASE_S, (r, res)


def test_a_failing_rank_fails_the_save_on_every_rank(runs):
    """A ``fault_hook`` raising on rank 1 alone: ``save(wait=True)`` and
    ``wait_for_save`` raise on all four ranks (rank 1 its own error, the
    others a ``CheckpointError`` naming rank 1), at once, and only step 1
    is committed."""
    for mode, ranks in runs[(2, 2)]["ck_fault"].items():
        assert len(ranks) == 4
        for r, res in enumerate(ranks):
            if r == 1:
                assert res["error"] == "RuntimeError: rank 1 cannot write"
            else:
                assert res["error"].startswith("CheckpointError: step 2: "
                                               "the write failed on "
                                               "rank(s) [1]"), res
            assert res["steps"] == [1], (mode, r)
            assert res["seconds"] < 10.0, (mode, r)


# --------------------------------------------------------------------- #
# the launcher and the pipeline on a mesh
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def lm_runs(started):
    """The uninterrupted 2 x 1 run; its last step deleted, resumed on
    2 x 1, on 1 x 2 with ``tp`` and (here) with no mesh."""
    lm = started["dir"] / "lm"
    assert _exit_code(started["other"]["lm"], lm / "full.log") == 0, \
        (lm / "full.log").read_text()[-4000:]
    assert C.CheckpointManager(str(lm / "ck")).all_steps() == [2, 4, 6]
    shutil.rmtree(lm / "ck" / "step_00000006")
    procs = {}
    for name, mesh in (("same", ("--mesh", "2,1", "--strategy", "zero3",
                                 "--zero", "1")),
                       ("tp", ("--mesh", "1,2", "--strategy", "tp"))):
        shutil.copytree(lm / "ck", lm / f"ck_{name}")
        procs[name] = _launch(2, lm / f"{name}.log", CKPT_DRIVER, "--out",
                              lm / f"{name}.json", "--lm", *LM_ARGS, *mesh,
                              "--ckpt-dir", lm / f"ck_{name}", "--resume")
    shutil.copytree(lm / "ck", lm / "ck_plain")
    plain = _launch(0, lm / "plain.log", CKPT_DRIVER, "--out",
                    lm / "plain.json", "--lm", *LM_ARGS, "--ckpt-dir",
                    lm / "ck_plain", "--resume")
    out = {"full": _json(lm / "full.json")}
    for name, p in dict(procs, plain=plain).items():
        assert _exit_code(p, lm / f"{name}.log") == 0, \
            (lm / f"{name}.log").read_text()[-4000:]
        out[name] = _json(lm / f"{name}.json")
    tree, _ = C.CheckpointManager(str(lm / "ck")).restore(
        C.like(TrainState.create(T.init_params(
            D.lm_config("smollm-135m"), D._gen(0)))))
    out["saved_sha"] = C.tree_sha256(tree)
    return out


@pytest.mark.parametrize("where", ["same", "tp", "plain"])
def test_launcher_resumes_on_another_mesh(lm_runs, where):
    """The restored state's hash is the checkpoint's on every layout; the
    same-mesh resume ends on the uninterrupted run's hash, the others on
    its last two losses within tolerance."""
    full, got = lm_runs["full"], lm_runs[where]
    assert got["start"] == 4
    assert got["start_sha"] == lm_runs["saved_sha"]
    if where == "same":
        assert got["state_sha256"] == full["state_sha256"]
        assert got["loss"] == full["loss"][4:]
    np.testing.assert_allclose(got["loss"], full["loss"][4:], **TOL)


def test_rlhf_on_a_mesh_resumes_bitwise(started, runs):
    """``--rlhf``'s pipeline at 2 x 1, killed at the top of PPO iteration
    1 once its checkpoint has drained, resumed on 2 x 1: the record
    (scores, stage-3 metrics, the actor's, critic's and EMA's hashes)
    equals the uninterrupted run's."""
    rl = started["dir"] / "rlhf"
    assert _exit_code(started["other"]["rlhf_dead"], rl / "dead.log") != 0
    mgr = C.CheckpointManager(str(rl / "ck"))
    assert mgr.latest_step() == 3
    mgr.verify(3)
    p = _launch(2, rl / "resume.log", CKPT_DRIVER, "--out",
                rl / "resume.json", "--mesh", "2,1", "--ckpt-dir",
                rl / "ck")
    assert _exit_code(p, rl / "resume.log") == 0, \
        (rl / "resume.log").read_text()[-4000:]
    assert _json(rl / "resume.json") == _plain(runs[(1, 2)]["ck_pipe"])


# --------------------------------------------------------------------- #
# atomicity across ranks
# --------------------------------------------------------------------- #
def _tmp_dirs(d: Path) -> set:
    return {n for n in os.listdir(d) if n.startswith(".tmp-")}


def _fault_args(fa: Path) -> tuple:
    return (CKPT_DRIVER, "--mesh", "2,2", "--ckpt-dir", fa / "ck", "--out",
            fa / "run.json")


def test_crashes_across_ranks_commit_nothing(started, runs):
    """At 2 x 2 a rank dies at its 30th shard (in the second save), then,
    rerun, every rank dies at its second ``before_commit`` (the third
    save): each time the step being written does not appear, the previous
    one verifies and its torn temp directory is left, which the next run
    sweeps; the clean rerun ends bitwise equal to the uninterrupted run."""
    fa = started["dir"] / "faults"
    ck = fa / "ck"
    p, torn = started["other"]["fault_shard"], set()
    for i, (fault, latest) in enumerate(FAULTS):
        if i:
            p = _launch(4, fa / f"crash{i}.log", *_fault_args(fa),
                        fault=fault)
        assert _exit_code(p, fa / f"crash{i}.log") != 0
        steps = sorted(n for n in os.listdir(ck) if n.startswith("step_"))
        assert steps == [f"step_{s:08d}" for s in range(1, latest + 1)]
        copy = fa / f"verify{latest}"            # a manager here would
        shutil.copytree(ck / steps[-1], copy / steps[-1])   # sweep them
        C.CheckpointManager(str(copy)).verify(latest)
        tmps = _tmp_dirs(ck)
        assert not tmps & torn, "a rerun left an old temp directory"
        assert any(t.startswith(f".tmp-step_{latest + 1:08d}-")
                   for t in tmps), (fault, tmps)
        torn |= tmps
    p = _launch(4, fa / "clean.log", *_fault_args(fa))
    assert _exit_code(p, fa / "clean.log") == 0, \
        (fa / "clean.log").read_text()[-4000:]
    assert not _tmp_dirs(ck)
    assert _json(fa / "run.json") == _plain(runs[(2, 2)]["ck_pipe"])
