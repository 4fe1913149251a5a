"""Checkpointing: async TrainState snapshots and legacy ``.npz`` trees
(counterpart of ``repro/training/checkpoint.py``, the same
``repro-ckpt-v1`` format on disk, so each package reads the other's files).

Two layers live here:

- The legacy single-file API (:func:`save` / :func:`load` /
  :func:`load_metadata`): tree <-> ``.npz`` with path-flattened keys, for
  exporting final params (``--ckpt`` in the launchers).

- :class:`CheckpointManager`: the fault-tolerance subsystem.  A save is
  a synchronous device-to-host snapshot of every leaf followed by a
  background write of one ``.npy`` shard per leaf plus a JSON manifest,
  committed atomically: everything lands in a dot-prefixed temp
  directory, every file and the directory entry are fsynced, and one
  ``os.replace`` publishes the checkpoint.  A crash at any point of the
  write leaves at worst a stale temp directory, never a loadable but
  corrupt checkpoint.  Restore reads the shards back (checking sizes and
  CRCs against the manifest) onto the device of the restore target.

Disk layout::

    <dir>/step_00000010/
        manifest.json                 # leaves, shard index map, CRCs
        shards/00000.00.npy           # leaf 0, shard 0
        ...
    <dir>/.tmp-step_00000010-<pid>/   # in-flight write (ignored by scans)

Trees are nested dicts, tuples, lists and NamedTuples of tensors (numpy
arrays and Python scalars are taken too).  They flatten as the
reference's pytrees do
(:func:`repro_torch.models.modules.flatten_with_path`: dict keys in
sorted order, a NamedTuple field as ``.name``, a sequence index as the
index, ``None`` an empty subtree), each path component escaped (``%``
and ``/``) and joined by ``/``.  So a tree and its JAX twin give the same
keys, the same shard file names (``{leaf:05d}.{shard:02d}.npy``) and the
same bytes.

A tree with ``DTensor`` leaves (a state on a ``("data", "model")`` mesh)
is saved by every rank of the mesh at once, each writing its own pieces:
a leaf's shards are the distinct windows the ranks hold
(:func:`repro_torch.sharding.runtime.window`), numbered in rank order
(row-major over the mesh, the reference's ``addressable_shards`` order),
and each is written once, by one of the ranks that hold it (a plain
leaf of such a tree, which every rank holds whole, is one window): the
one given the fewest bytes so far, so that replicated windows spread
over their holders, and every rank derives the same assignment.  So the
files and the manifest are the reference's for the same state on the
same mesh, and file names need no communication.  All ranks write into
one temp directory, whose name the first rank chooses; the ranks'
background writers then exchange their shard entries and whether they
succeeded, over a gloo group of their own (made at the first save of a
multi-rank tree, so that they never interleave with the training's
collectives, whose timeout is 60 s plus the time the largest rank's
share takes at a floor rate, so that a rank that writes more is not
taken for a hung one).  The first rank writes the manifest and
commits, and every rank learns the outcome.  A failure on any rank
fails the save on every rank, and nothing commits.  The directory must be one that every rank
sees (one host's disk, or a shared file system).  ``restore(like,
shardings=)`` has each rank read only the shards that overlap its own
piece and returns ``DTensor``\\ s in the target layout, which need not be
the one the checkpoint was saved in (another mesh, strategy or ZeRO
stage, or one device with ``shardings=None``).

bfloat16 leaves go by their 16 bits: a shard's ``.npy`` header says
``'<V2'`` (as ``np.save`` of an ``ml_dtypes`` bfloat16 array writes it)
and the manifest says ``"bfloat16"``; reading takes the bits back as
uint16 viewed as ``torch.bfloat16``.  A ``.npz`` member with a 2-byte
void dtype is such a leaf too.

Saves copy every leaf to host memory before they return (pinned memory
for a CUDA tensor, a clone for a CPU one), because the optimizer and the
EMA update their tensors in place: the background writer must not see a
later step's values.

Fault injection for crash tests: pass ``fault_hook`` (called as
``fault_hook(event, count)`` with events ``"shard"``, ``"before_commit"``,
``"after_commit"``) or set ``REPRO_CKPT_FAULT=<event>:<n>`` in the
environment to ``os._exit(41)`` on the n-th occurrence of the event in
this process.  In a multi-rank save ``"shard"`` fires after each file
this rank writes, ``"before_commit"`` on the other ranks once their
files are synced (before the exchange) and on the first rank just
before its commit, and ``"after_commit"`` on every rank once the commit
is known.
"""
from __future__ import annotations

import dataclasses
import datetime
import hashlib
import json
import math
import os
import re
import shutil
import threading
import time
import zipfile
import zlib
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.models.modules import (flatten_with_path,
                                        tree_unflatten_paths)
from repro_torch.sharding import runtime

FORMAT = "repro-ckpt-v1"
_STEP_RE = re.compile(r"^step_(\d{8})$")
FAULT_EXIT_CODE = 41
_BF16 = "bfloat16"
_IO_THREADS = 8
# the timeout of a multi-rank save's writers' group: that of every mesh
# group, plus the time the largest rank's share takes at a floor rate far
# below a disk's
_WRITERS_TIMEOUT_S = 60.0
_WRITE_FLOOR_BPS = 64 << 20


class CheckpointError(Exception):
    """Base class for checkpoint failures."""


class CheckpointCorruptError(CheckpointError):
    """A committed checkpoint disagrees with its manifest (truncated,
    missing, or bit-flipped shard files)."""


class CheckpointDtypeError(CheckpointError):
    """Saved leaf dtype differs from the restore target's dtype and no
    explicit ``cast=True`` was given."""


# ===================================================================== #
# tree path <-> flat string keys
# ===================================================================== #
def _esc(component: str) -> str:
    """Escape the ``/`` separator (and the escape char itself) so no two
    distinct tree paths can flatten to the same joined key."""
    return component.replace("%", "%25").replace("/", "%2F")


def _path_key(path) -> str:
    return "/".join(_esc(str(p)) for p in path)


def _flat(tree) -> dict:
    """``{key: leaf}``; raises on key collisions (two dict keys that print
    alike, say) instead of dropping a leaf."""
    flat: dict = {}
    for path, leaf in flatten_with_path(tree):
        key = _path_key(path)
        if key in flat:
            raise CheckpointError(
                f"tree key collision: two leaves flatten to {key!r}")
        flat[key] = leaf
    return flat


# ===================================================================== #
# leaves <-> host arrays
# ===================================================================== #
def _dtype_name(x) -> str:
    """``"float32"``, ``"bfloat16"``, ``"int32"``, ... of a tensor, a numpy
    array (an ``ml_dtypes`` bfloat16 included), a :class:`Like` or a
    scalar."""
    dt = getattr(x, "dtype", None)
    if dt is None:
        return str(np.asarray(x).dtype)
    if isinstance(dt, torch.dtype):
        return str(dt).removeprefix("torch.")
    return np.dtype(dt).name


def _torch_dtype(name: str) -> torch.dtype:
    dt = getattr(torch, name, None)
    if not isinstance(dt, torch.dtype):
        raise CheckpointError(f"dtype {name!r} has no torch counterpart")
    return dt


def _host(leaf):
    """``(dtype name, host ndarray)``: a copy of ``leaf`` that shares no
    memory with it (bfloat16 as its uint16 bits)."""
    name = _dtype_name(leaf)
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.device.type == "cuda":
            h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            h.copy_(t)
        else:
            h = t.clone(memory_format=torch.contiguous_format)
        if h.dtype == torch.bfloat16:
            return name, h.view(torch.int16).numpy().view(np.uint16)
        return name, h.numpy()
    arr = np.array(leaf, copy=True)
    if name == _BF16:                       # an ml_dtypes array
        arr = arr.view(np.uint16)
    return name, arr


def _bytes(arr: np.ndarray) -> np.ndarray:
    """The array's bytes in C order, as a flat uint8 view (a copy only
    when the array is not C-contiguous)."""
    return arr.reshape(-1, order="C").view(np.uint8)


def _crc(arr: np.ndarray) -> int:
    return zlib.crc32(_bytes(arr)) & 0xFFFFFFFF


def _write_npy(f, name: str, arr: np.ndarray) -> None:
    """``np.save`` of the array, except that bfloat16 bits get the header
    ``np.save`` writes for an ``ml_dtypes`` bfloat16 array (descr
    ``'<V2'``), so the file is byte for byte the reference's."""
    if name != _BF16:
        np.save(f, arr)
        return
    header = {"descr": "<V2", "fortran_order": False, "shape": arr.shape}
    try:
        np.lib.format.write_array_header_1_0(f, header)
    except ValueError:                      # a header past 64 KiB
        np.lib.format.write_array_header_2_0(f, header)
    f.write(_bytes(arr))


def _as_bits(arr: np.ndarray, name: str) -> np.ndarray:
    """A read-back array in a dtype torch takes: bfloat16 leaves (a 2-byte
    void dtype on disk) as uint16 bits."""
    if name == _BF16:
        return arr.view(np.uint16)
    return arr


def _to_tensor(arr: np.ndarray, name: str) -> torch.Tensor:
    """A CPU tensor over ``arr``'s memory (bfloat16 from its bits)."""
    if name == _BF16:
        return torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    if not arr.flags.c_contiguous:   # (ascontiguousarray makes 0-d 1-d)
        arr = arr.copy(order="C")
    return torch.from_numpy(arr)


@dataclasses.dataclass(frozen=True)
class Like:
    """A restore target's leaf without memory: shape, dtype and device
    (the counterpart of a ``jax.ShapeDtypeStruct``)."""
    shape: tuple
    dtype: torch.dtype
    device: torch.device


def like(tree, device=None):
    """``tree`` with each tensor replaced by its :class:`Like` (on
    ``device`` if given): a restore target that allocates nothing."""
    def one(x):
        if not isinstance(x, torch.Tensor):
            return x
        return Like(tuple(x.shape), x.dtype,
                    torch.device(device) if device is not None
                    else x.device)
    return tree_unflatten_paths(
        tree, [one(x) for _, x in flatten_with_path(tree)])


def _place(t: torch.Tensor, key: str, saved: str, target, cast: bool):
    """The restored CPU tensor ``t`` in the dtype of ``target`` and on its
    device (a CPU tensor for a numpy or scalar target)."""
    want = _dtype_name(target)
    if saved != want:
        if not cast:
            raise CheckpointDtypeError(
                f"leaf {key!r} was saved as {saved} but the restore "
                f"target is {want}; pass cast=True to convert explicitly")
        t = t.to(_torch_dtype(want))
    dev = getattr(target, "device", None)
    if isinstance(dev, torch.device) and dev.type != "cpu":
        return t.to(dev)
    return t


def _target_shape(leaf) -> tuple:
    return tuple(int(d) for d in getattr(leaf, "shape", np.shape(leaf)))


# ===================================================================== #
# legacy single-file .npz API
# ===================================================================== #
def save(path: str, tree, metadata: dict | None = None) -> None:
    """``tree`` as one ``.npz`` (``.npz`` appended to ``path`` unless it
    ends so, as ``np.savez`` does), with ``metadata`` beside it in
    ``path + ".meta.json"``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = {k: _host(v) for k, v in _flat(tree).items()}
    fname = path if path.endswith(".npz") else path + ".npz"
    with zipfile.ZipFile(fname, mode="w", compression=zipfile.ZIP_STORED,
                         allowZip64=True) as zf:
        for key, (name, arr) in flat.items():
            with zf.open(key + ".npy", "w", force_zip64=True) as f:
                _write_npy(f, name, arr)
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2)


def load(path: str, like_tree, *, cast: bool = False) -> Any:
    """Restore into the structure of ``like_tree`` (tensors or
    :class:`Like` leaves), each leaf on its target's device.

    Shapes must match exactly; dtypes must match unless ``cast=True``
    explicitly opts into conversion (a silent fp32 -> bf16 round-trip is
    a precision bug, not a convenience)."""
    data = np.load(path if path.endswith(".npz") else path + ".npz")
    out = []
    for p, leaf in flatten_with_path(like_tree):
        key = _path_key(p)
        arr = data[key]
        if arr.shape != _target_shape(leaf):
            raise CheckpointError(
                f"leaf {key!r}: saved shape {arr.shape} != target "
                f"shape {_target_shape(leaf)}")
        saved = (_BF16 if arr.dtype.kind == "V" and arr.dtype.itemsize == 2
                 else arr.dtype.name)
        out.append(_place(_to_tensor(_as_bits(arr, saved), saved), key,
                          saved, leaf, cast))
    return tree_unflatten_paths(like_tree, out)


def load_metadata(path: str) -> dict:
    with open(path + ".meta.json") as f:
        return json.load(f)


def tree_sha256(tree) -> str:
    """SHA-256 over each leaf's key, dtype, shape and the SHA-256 of its
    bytes, in flattening order (the leaves hashed on host threads).  A
    ``DTensor`` leaf is hashed as its full tensor, gathered on this
    thread, so the hash of a state on a mesh is the hash of the same
    state on one device; the gathers are collectives, and every rank of
    the mesh calls this."""
    def digest(key, leaf):
        name, arr = _host(leaf)
        return (f"{key}|{name}|{tuple(arr.shape)}|"
                + hashlib.sha256(_bytes(arr)).hexdigest())

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        futs = []
        for key, leaf in _flat(tree).items():
            if runtime.is_dtensor(leaf):
                for f in futs[:-_IO_THREADS]:   # bound the gathered leaves
                    f.result()                  # waiting to be hashed
                leaf = runtime.full(leaf)
            futs.append(pool.submit(digest, key, leaf))
        lines = [f.result() for f in futs]
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


# ===================================================================== #
# helpers of the manager
# ===================================================================== #
def _fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _env_fault_hook() -> Optional[Callable[[str, int], None]]:
    """``REPRO_CKPT_FAULT=<event>:<n>`` -> hook that hard-exits the
    process on the n-th occurrence of ``event`` (crash injection for the
    subprocess fault-tolerance suite)."""
    spec = os.environ.get("REPRO_CKPT_FAULT")
    if not spec:
        return None
    event, n = spec.split(":")
    n = int(n)

    def hook(ev: str, count: int) -> None:
        if ev == event and count >= n:
            os._exit(FAULT_EXIT_CODE)
    return hook


# ===================================================================== #
# the shards of a tree on a mesh
# ===================================================================== #
def _index(win) -> list:
    """A :func:`repro_torch.sharding.runtime.window` as the manifest
    spells it: ``[start, stop]`` or ``None`` per dim."""
    return [None if w is None else list(w) for w in win]


def _itemsize(name: str) -> int:
    return 2 if name == _BF16 else np.dtype(name).itemsize


@dataclasses.dataclass(frozen=True)
class _Writers:
    """The ranks that save a tree together: those of the mesh its
    ``DTensor`` leaves lie on (``axes`` ``{name: size}``, global ``ranks``
    in row-major order), or this process alone for a tree without (no
    axes, one rank); ``index`` is this rank's place among them.  Their
    background writers' collectives run over ``group`` (``None`` for one
    rank, where each is the identity)."""
    axes: dict
    ranks: tuple
    index: int
    group: Any = None

    def all_gather(self, obj) -> list:
        if self.group is None:
            return [obj]
        import torch.distributed as dist
        out = [None] * len(self.ranks)
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def broadcast(self, obj):
        if self.group is None:
            return obj
        import torch.distributed as dist
        box = [obj]
        dist.broadcast_object_list(box, src=self.ranks[0], group=self.group)
        return box[0]


def _writers_of(flat: dict) -> _Writers:
    """The ranks that save ``flat`` together (no group yet): those of the
    mesh its ``DTensor`` leaves lie on (they must all lie on one), or
    this process alone."""
    import torch.distributed as dist
    found = None
    for key, leaf in flat.items():
        if not runtime.is_dtensor(leaf):
            continue
        m = leaf.device_mesh
        mesh = (dict(zip(m.mesh_dim_names, (int(n) for n in m.mesh.shape))),
                tuple(m.mesh.flatten().tolist()))
        if found is None:
            found = mesh
        elif mesh != found:
            raise CheckpointError(f"leaf {key!r} lies on another mesh than "
                                  f"the tree's other DTensor leaves")
    if found is None:
        return _Writers({}, (0,), 0)
    axes, ranks = found
    if dist.get_rank() not in ranks:
        raise CheckpointError("this rank holds no part of the tree's mesh")
    return _Writers(axes, ranks, ranks.index(dist.get_rank()))


def _assign(layouts: list, size: int) -> tuple:
    """Who writes what: for each leaf's ``(windows, global shape, item
    size)``, ``windows`` the window of each of ``size`` ranks in rank
    order, the writer (a rank's index) of each distinct window, in the
    order of first appearance; and the bytes each rank writes.  A window
    goes to the rank that holds it and has been given the fewest bytes so
    far (the lowest on a tie), so that the replicated windows (a leaf
    replicated over ``data``, a FULL leaf, a plain leaf) spread over
    their holders and every rank derives the same assignment on its
    own."""
    loads = [0] * size
    writers = []
    for wins, shape, itemsize in layouts:
        who = []
        for win in dict.fromkeys(wins):
            r = min((r for r, x in enumerate(wins) if x == win),
                    key=loads.__getitem__)
            loads[r] += itemsize * math.prod(
                n if w is None else w[1] - w[0] for n, w in zip(shape, win))
            who.append(r)
        writers.append(who)
    return writers, loads


def _piece(leaf, win) -> np.ndarray:
    """This rank's host copy of ``leaf`` in the window ``win``: a plain
    leaf whole, a ``DTensor``'s local piece (checked against ``win``)."""
    if not runtime.is_dtensor(leaf):
        return _host(leaf)[1]
    loc = runtime.local(leaf)
    want = tuple(n if w is None else w[1] - w[0]
                 for n, w in zip(leaf.shape, win))
    if tuple(loc.shape) != want:
        raise CheckpointError(f"a local piece of {tuple(loc.shape)} where "
                              f"the layout gives the window {win}")
    return _host(loc)[1]


def _plan(flat: dict, w: _Writers) -> tuple:
    """``({key: (dtype name, global shape, number of shards, pieces)},
    the bytes each rank writes)``, ``pieces`` the ``(shard, index, host
    array)`` this rank writes.  A leaf's shards are its distinct windows
    in rank order (a ``DTensor``'s by its layout; a plain leaf, which
    every rank holds whole, is one), each written by the rank
    :func:`_assign` gives it."""
    layouts = []
    for leaf in flat.values():
        shape = _target_shape(leaf)
        wins = [(None,) * len(shape)] * len(w.ranks)
        if runtime.is_dtensor(leaf):
            pspec = runtime.pspec_of(leaf.placements,
                                     leaf.device_mesh.mesh_dim_names,
                                     len(shape))
            wins = [runtime.window(pspec, w.axes, shape, c)
                    for c in runtime.mesh_coords(w.axes)]
        layouts.append((wins, shape, _itemsize(_dtype_name(leaf))))
    writers, loads = _assign(layouts, len(w.ranks))
    plan = {}
    for (key, leaf), (wins, shape, _), who in zip(flat.items(), layouts,
                                                  writers):
        distinct = list(dict.fromkeys(wins))
        plan[key] = (_dtype_name(leaf), list(shape), len(distinct),
                     [(j, _index(win), _piece(leaf, win))
                      for j, (win, r) in enumerate(zip(distinct, who))
                      if r == w.index])
    return plan, loads


def _box(shape, win) -> list:
    return [(0, n) if w is None else (w[0], w[1]) for n, w in zip(shape, win)]


def _match_shardings(like_tree, shardings) -> list:
    """The leaf of ``shardings`` at each leaf of ``like_tree``, in
    :func:`flatten_with_path` order: a
    :class:`~repro_torch.sharding.strategy.Sharding` or ``None``.  Any
    other structure raises :class:`CheckpointError`."""
    paths = [p for p, _ in flatten_with_path(like_tree)]

    def at(tree, path):
        for c in path:
            if isinstance(tree, dict):
                tree = tree[c]
            elif hasattr(tree, "_fields") and isinstance(c, str):
                tree = getattr(tree, c[1:])
            elif isinstance(tree, (tuple, list)):
                tree = tree[c]
            else:
                raise TypeError(c)
        return tree
    try:
        got = [at(shardings, p) for p in paths]
    except (KeyError, IndexError, TypeError, AttributeError) as e:
        raise CheckpointError("shardings tree does not match the restore "
                              "target") from e
    extra = {p for p, _ in flatten_with_path(shardings)} - set(paths)
    if extra or not all(s is None or runtime.is_sharding(s) for s in got):
        raise CheckpointError("shardings tree does not match the restore "
                              "target")
    return got


# ===================================================================== #
# CheckpointManager
# ===================================================================== #
class CheckpointManager:
    """Async, atomically committed checkpoints under ``directory``.

    One write may be in flight at a time; :meth:`save` waits for the
    previous write, snapshots to host memory synchronously (so training
    may mutate its tensors at once), then hands the host arrays to a
    background thread, which writes the shards in order while one more
    thread CRCs them.  Two threads leave the host's other cores to the
    training loop: on an 8-core H100 host, CRCs spread over 8 threads made
    the OPT-1.3B SFT step that overlapped a write 474 ms against 222 ms.
    ``async_write=False`` makes every save synchronous.  A tree with
    ``DTensor`` leaves is saved by every rank of its mesh together (see
    the module's docstring): every rank of the default process group
    constructs the manager (the first sweeps stale temp directories while
    the others wait at a barrier) and calls :meth:`save` and
    :meth:`wait_for_save` alike.

    ``stats`` holds one dict per save: ``step``, ``bytes`` (the shard
    files), ``snapshot_s`` (the synchronous copy, the stall training
    sees) and, once the write has committed, ``write_s`` (shards, CRCs,
    manifest, fsyncs and the commit).  ``last_restore`` holds ``step``,
    ``bytes`` and ``seconds`` of the latest :meth:`restore` (reads, CRCs
    and the copy to the device)."""

    def __init__(self, directory: str, *, keep: int = 3,
                 async_write: bool = True,
                 fault_hook: Optional[Callable[[str, int], None]] = None):
        self.directory = directory
        self.keep = keep
        self.async_write = async_write
        self.fault_hook = fault_hook or _env_fault_hook()
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._fault_counts: dict = {}
        self._groups: dict = {}   # mesh ranks -> (writers' group, timeout)
        self.stats: list = []
        self.last_restore: dict = {}
        os.makedirs(directory, exist_ok=True)
        import torch.distributed as dist
        ranks = dist.is_initialized() and dist.get_world_size() > 1
        # stale temp dirs from a previous crashed writer are dead weight
        for name in os.listdir(directory) if not ranks or (
                dist.get_rank() == 0) else ():
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)
        if ranks:
            dist.barrier()

    # ------------------------- bookkeeping ------------------------- #
    def _step_dir(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}")

    def all_steps(self) -> list:
        """Committed steps (a manifest exists and parses), ascending."""
        steps = []
        for name in sorted(os.listdir(self.directory)):
            m = _STEP_RE.match(name)
            if not m:
                continue
            man = os.path.join(self.directory, name, "manifest.json")
            try:
                with open(man) as f:
                    json.load(f)
            except (OSError, ValueError):
                continue              # uncommitted/damaged: not a candidate
            steps.append(int(m.group(1)))
        return steps

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _fire(self, event: str) -> None:
        if self.fault_hook is None:
            return
        n = self._fault_counts.get(event, 0) + 1
        self._fault_counts[event] = n
        self.fault_hook(event, n)

    # ---------------------------- save ----------------------------- #
    def save(self, step: int, tree, metadata: dict | None = None, *,
             wait: bool = False) -> str:
        """Snapshot ``tree`` and commit it as ``step``.

        Returns the final checkpoint directory (which exists only once
        the background write commits; call :meth:`wait_for_save` or pass
        ``wait=True`` to block on durability)."""
        self.wait_for_save()          # one in-flight write at a time
        # deep-copy metadata NOW (json round-trip): the caller keeps
        # mutating its metrics log while the background thread writes
        metadata = json.loads(json.dumps(metadata or {}))
        t0 = time.perf_counter()
        flat = _flat(tree)
        writers = _writers_of(flat)
        plan, loads = _plan(flat, writers)
        # the ranks' writes end apart by up to the largest share's time
        writers = self._grouped(writers, _WRITERS_TIMEOUT_S
                                + max(loads) / _WRITE_FLOOR_BPS)
        stat = {"step": step, "snapshot_s": time.perf_counter() - t0,
                "bytes": 0}
        self.stats.append(stat)
        if self.async_write and not wait:
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(step, plan, metadata, stat, writers), daemon=True)
            self._thread.start()
        else:
            self._write(step, plan, metadata, stat, writers)
        return self._step_dir(step)

    def _grouped(self, w: _Writers, timeout: float) -> _Writers:
        """``w`` with its writers' gloo group, made here, on the main
        thread, at the first save on its ranks, and made again with a
        longer ``timeout`` (seconds) when a save needs one."""
        if len(w.ranks) == 1:
            return w
        group, had = self._groups.get(w.ranks, (None, 0.0))
        if had < timeout:
            import torch.distributed as dist
            group = dist.new_group(
                list(w.ranks), backend="gloo",
                timeout=datetime.timedelta(seconds=timeout),
                use_local_synchronization=True)
            self._groups[w.ranks] = (group, timeout)
        return dataclasses.replace(w, group=group)

    def _write_guarded(self, *args):
        try:
            self._write(*args)
        except BaseException as e:                # surfaced on next wait
            self._error = e

    def _write(self, step: int, plan: dict, metadata: dict, stat: dict,
               w: _Writers) -> None:
        """The first rank makes the temp directory and sends its name;
        every rank writes its pieces; the ranks exchange their entries and
        whether they succeeded; the first commits and sends the outcome.
        Any failure raises on every rank (its own exception on the rank
        that failed) and nothing commits.  With one rank each exchange is
        the identity."""
        t0 = time.perf_counter()
        tmp, failure = None, None
        if w.index == 0:
            try:
                tmp = self._fresh_tmp(step)
            except Exception as e:                  # noqa: BLE001
                failure = e
        tmp, msg = w.broadcast((tmp, None if failure is None
                                else repr(failure)))
        if failure is not None:
            raise failure
        if msg is not None:
            raise CheckpointError(f"step {step}: the first rank could not "
                                  f"make the temp directory ({msg})")
        entries = {}
        try:
            entries = self._write_shards(tmp, plan, stat)
            if w.index:
                self._fire("before_commit")
        except Exception as e:                      # noqa: BLE001
            failure = e
        got = w.all_gather((w.ranks[w.index], entries,
                            None if failure is None else repr(failure)))
        failed = {r: m for r, _, m in got if m is not None}
        if failure is not None:
            raise failure
        if failed:
            raise CheckpointError(
                f"step {step}: the write failed on rank(s) "
                f"{sorted(failed)}: {failed}; nothing was committed")
        if w.index == 0:
            try:
                self._commit(step, tmp, plan,
                             {k: v for _, e, _ in got for k, v in e.items()},
                             metadata)
            except Exception as e:                  # noqa: BLE001
                failure = e
        msg = w.broadcast(None if failure is None else repr(failure))
        if failure is not None:
            raise failure
        if msg is not None:
            raise CheckpointError(f"step {step}: the first rank could not "
                                  f"commit ({msg})")
        if w.index:
            self._fire("after_commit")
        stat["write_s"] = time.perf_counter() - t0

    def _fresh_tmp(self, step: int) -> str:
        tmp = os.path.join(self.directory,
                           f".tmp-step_{step:08d}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        os.makedirs(os.path.join(tmp, "shards"))
        return tmp

    def _write_shards(self, tmp: str, plan: dict, stat: dict) -> dict:
        """Write this process's pieces of ``plan`` into ``tmp``, each file
        fsynced, while one more thread CRCs them; returns their manifest
        entries by ``(leaf, shard)``."""
        shards_dir = os.path.join(tmp, "shards")
        mine = [(i, j, index, name, arr)
                for i, (name, _, _, pieces) in enumerate(plan.values())
                for j, index, arr in pieces]
        entries = {}
        with ThreadPoolExecutor(1) as crc_thread:
            crcs = [crc_thread.submit(_crc, p[-1]) for p in mine]
            for (i, j, index, name, arr), crc in zip(mine, crcs):
                fname = f"{i:05d}.{j:02d}.npy"
                fpath = os.path.join(shards_dir, fname)
                with open(fpath, "wb") as f:
                    _write_npy(f, name, arr)
                    f.flush()
                    os.fsync(f.fileno())
                nbytes = os.path.getsize(fpath)
                stat["bytes"] += nbytes
                entries[(i, j)] = {"file": f"shards/{fname}", "index": index,
                                   "nbytes": nbytes,
                                   "crc32": crc.result()}
                self._fire("shard")
        _fsync_dir(shards_dir)
        return entries

    def _commit(self, step: int, tmp: str, plan: dict, entries: dict,
                metadata: dict) -> None:
        """The manifest of ``plan`` from every piece's entry, then the
        atomic publication of ``tmp`` as ``step`` and the old steps'
        collection."""
        leaves = {}
        for i, (key, (name, shape, n, _)) in enumerate(plan.items()):
            missing = [j for j in range(n) if (i, j) not in entries]
            if missing:
                raise CheckpointError(f"leaf {key!r}: no rank wrote "
                                      f"shard(s) {missing}")
            leaves[key] = {"shape": shape, "dtype": name,
                           "shards": [entries[(i, j)] for j in range(n)]}
        manifest = {"format": FORMAT, "step": step, "leaves": leaves,
                    "metadata": metadata}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(os.path.join(tmp, "shards"))
        _fsync_dir(tmp)
        self._fire("before_commit")
        final = self._step_dir(step)
        if os.path.isdir(final):      # overwrite of a committed step
            shutil.rmtree(final)
        os.replace(tmp, final)        # THE commit point
        _fsync_dir(self.directory)
        self._fire("after_commit")
        self._gc()

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep] if self.keep else []:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def wait_for_save(self) -> None:
        """Block until the in-flight background write (if any) commits;
        re-raise its failure here rather than losing it in the thread."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    # --------------------------- restore --------------------------- #
    def _manifest(self, step: int) -> dict:
        man = os.path.join(self._step_dir(step), "manifest.json")
        try:
            with open(man) as f:
                return json.load(f)
        except OSError as e:
            raise CheckpointError(
                f"no committed checkpoint at step {step} "
                f"under {self.directory}") from e

    def restore_metadata(self, step: Optional[int] = None) -> dict:
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.directory}")
        return self._manifest(step).get("metadata", {})

    @staticmethod
    def _read_shard(step_dir: str, key: str, sh: dict,
                    name: str) -> np.ndarray:
        """One shard file's array (bfloat16 as uint16 bits), checked
        against the manifest's size and CRC."""
        fpath = os.path.join(step_dir, sh["file"])
        if not os.path.exists(fpath):
            raise CheckpointCorruptError(
                f"leaf {key!r}: shard file {sh['file']} is missing")
        if os.path.getsize(fpath) != sh["nbytes"]:
            raise CheckpointCorruptError(
                f"leaf {key!r}: shard file {sh['file']} is "
                f"{os.path.getsize(fpath)} bytes, manifest says "
                f"{sh['nbytes']} (torn write?)")
        piece = _as_bits(np.load(fpath), name)
        if _crc(piece) != sh["crc32"]:
            raise CheckpointCorruptError(
                f"leaf {key!r}: shard file {sh['file']} fails its "
                f"manifest CRC")
        return piece

    def _read_window(self, step_dir: str, key: str, entry: dict,
                     win: tuple) -> np.ndarray:
        """The leaf's host array in the window ``win``
        (:func:`repro_torch.sharding.runtime.window`; all ``None`` for
        the whole leaf; bfloat16 as uint16 bits), from the shards that
        overlap it: each read whole and checked against its size, CRC and
        window, and the piece checked to be covered."""
        shape, name = tuple(entry["shape"]), entry["dtype"]
        box = _box(shape, win)
        want = tuple(b - a for a, b in box)
        out, covered = None, 0
        for sh in entry["shards"]:
            sbox = _box(shape, sh["index"])
            cut = [(max(a, c), min(b, d)) for (a, b), (c, d) in zip(box, sbox)]
            if any(lo >= hi for lo, hi in cut):
                continue
            piece = self._read_shard(step_dir, key, sh, name)
            if piece.shape != tuple(d - c for c, d in sbox):
                raise CheckpointCorruptError(
                    f"leaf {key!r}: shard file {sh['file']} holds "
                    f"{piece.shape}, its window {sh['index']}")
            if out is None and sbox == box:
                out = piece               # the rank's very window: no copy
            else:
                if out is None:
                    out = np.empty(want, piece.dtype)
                out[tuple(slice(lo - a, hi - a) for (lo, hi), (a, _)
                          in zip(cut, box))] = piece[tuple(
                              slice(lo - c, hi - c) for (lo, hi), (c, _)
                              in zip(cut, sbox))]
            covered += math.prod(hi - lo for lo, hi in cut)
        if covered != math.prod(want):
            raise CheckpointCorruptError(
                f"leaf {key!r}: shards cover {covered} of the "
                f"{math.prod(want)} elements of this rank's window {win}")
        if out is None:                   # an empty window
            out = np.empty(want, np.uint16 if name == _BF16
                           else np.dtype(name))
        return out

    def restore(self, like_tree, *, step: Optional[int] = None,
                shardings=None, cast: bool = False):
        """Load a checkpoint into the structure of ``like_tree``.

        ``like_tree`` supplies the structure and the expected shapes,
        dtypes and devices (live tensors, or :class:`Like` leaves from
        :func:`like`); each restored leaf is a tensor on its target's
        device (a CPU tensor for a numpy or scalar target).

        ``shardings`` — a tree matching ``like_tree`` of
        :class:`~repro_torch.sharding.strategy.Sharding` (or ``None``
        leaves) on the *target* mesh, which need not be the one the
        checkpoint was saved on — makes each leaf a ``DTensor`` in that
        layout: each rank reads only the shards that overlap its own
        piece, and nothing is communicated.  A ``None`` leaf, and a 0-d
        leaf (the host step counters of a TrainState, which the port
        keeps off the mesh), comes back as with ``shardings=None``.
        Returns ``(tree, metadata)``."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.directory}")
        t0 = time.perf_counter()
        manifest = self._manifest(step)
        step_dir = self._step_dir(step)
        leaves_meta = manifest["leaves"]
        targets = [(_path_key(p), leaf)
                   for p, leaf in flatten_with_path(like_tree)]
        layouts = ([None] * len(targets) if shardings is None
                   else _match_shardings(like_tree, shardings))
        for key, _ in targets:
            if key not in leaves_meta:
                raise CheckpointError(
                    f"checkpoint at step {step} has no leaf {key!r} "
                    f"(saved tree structure differs)")

        def one(item):
            (key, leaf), sh = item
            entry = leaves_meta[key]
            shape = tuple(entry["shape"])
            if shape != _target_shape(leaf):
                raise CheckpointError(
                    f"leaf {key!r}: saved shape {shape} != target "
                    f"shape {_target_shape(leaf)}")
            win = (None,) * len(shape)
            if sh is not None and shape:
                coord = sh.mesh.get_coordinate()
                if coord is None:
                    raise CheckpointError("this rank holds no part of the "
                                          "target mesh")
                axes = dict(zip(sh.mesh.mesh_dim_names,
                                (int(n) for n in sh.mesh.mesh.shape)))
                pspec = runtime.pspec_of(sh.placements,
                                         sh.mesh.mesh_dim_names, len(shape))
                win = runtime.window(pspec, axes, shape, coord)
            arr = self._read_window(step_dir, key, entry, win)
            return (_place(_to_tensor(arr, entry["dtype"]), key,
                           entry["dtype"], leaf, cast), arr.nbytes)

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            got = list(pool.map(one, zip(targets, layouts)))
        out = [t if sh is None or t.dim() == 0 else runtime.from_local(
                   t, sh.mesh, sh.placements, _target_shape(leaf))
               for (t, _), sh, (_, leaf) in zip(got, layouts, targets)]
        for t in out:
            if t.device.type == "cuda":
                torch.cuda.synchronize(t.device)
                break
        self.last_restore = {"step": step,
                             "bytes": sum(n for _, n in got),
                             "seconds": time.perf_counter() - t0}
        return (tree_unflatten_paths(like_tree, out),
                manifest.get("metadata", {}))

    def verify(self, step: Optional[int] = None) -> None:
        """Integrity-check a committed checkpoint: every manifest shard
        exists with the recorded size and CRC, and the shard directory
        holds nothing the manifest doesn't list."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.directory}")
        manifest = self._manifest(step)
        step_dir = self._step_dir(step)
        listed = set()
        for key, entry in manifest["leaves"].items():
            self._read_window(step_dir, key, entry,
                              (None,) * len(entry["shape"]))
            listed.update(sh["file"] for sh in entry["shards"])
        on_disk = {os.path.join("shards", f)
                   for f in os.listdir(os.path.join(step_dir, "shards"))}
        if on_disk != listed:
            raise CheckpointCorruptError(
                f"step {step}: shard files on disk {sorted(on_disk)} != "
                f"manifest listing {sorted(listed)}")
