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
same bytes.  This package runs on one device, so every leaf is one
full-window shard; ``restore(shardings=)`` is not ported yet.

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
environment to ``os._exit(41)`` on the n-th occurrence of the event.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
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

FORMAT = "repro-ckpt-v1"
_STEP_RE = re.compile(r"^step_(\d{8})$")
FAULT_EXIT_CODE = 41
_BF16 = "bfloat16"
_IO_THREADS = 8


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
    bytes, in flattening order (the leaves hashed on host threads)."""
    flat = list(_flat(tree).items())

    def digest(item):
        key, leaf = item
        name, arr = _host(leaf)
        return (f"{key}|{name}|{tuple(arr.shape)}|"
                + hashlib.sha256(_bytes(arr)).hexdigest())

    with ThreadPoolExecutor(_IO_THREADS) as pool:
        lines = list(pool.map(digest, flat))
    return hashlib.sha256("\n".join(lines).encode()).hexdigest()


# ===================================================================== #
# helpers of the manager
# ===================================================================== #
def _index_to_slices(index) -> tuple:
    return tuple(slice(None) if w is None else slice(w[0], w[1])
                 for w in index)


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
    ``async_write=False`` makes every save synchronous.

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
        self.stats: list = []
        self.last_restore: dict = {}
        os.makedirs(directory, exist_ok=True)
        # stale temp dirs from a previous crashed writer are dead weight
        for name in os.listdir(directory):
            if name.startswith(".tmp-"):
                shutil.rmtree(os.path.join(directory, name),
                              ignore_errors=True)

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
        flat = {k: _host(v) for k, v in _flat(tree).items()}
        stat = {"step": step, "snapshot_s": time.perf_counter() - t0,
                "bytes": 0}
        self.stats.append(stat)
        if self.async_write and not wait:
            self._thread = threading.Thread(
                target=self._write_guarded,
                args=(step, flat, metadata, stat), daemon=True)
            self._thread.start()
        else:
            self._write(step, flat, metadata, stat)
        return self._step_dir(step)

    def _write_guarded(self, step, flat, metadata, stat):
        try:
            self._write(step, flat, metadata, stat)
        except BaseException as e:                # surfaced on next wait
            self._error = e

    def _write(self, step: int, flat: dict, metadata: dict,
               stat: dict) -> None:
        t0 = time.perf_counter()
        final = self._step_dir(step)
        tmp = os.path.join(self.directory,
                           f".tmp-step_{step:08d}-{os.getpid()}")
        shutil.rmtree(tmp, ignore_errors=True)
        shards_dir = os.path.join(tmp, "shards")
        os.makedirs(shards_dir)
        leaves = {}
        with ThreadPoolExecutor(1) as crc_thread:
            crcs = [crc_thread.submit(_crc, arr) for _, arr in flat.values()]
            for i, (key, (name, arr)) in enumerate(flat.items()):
                fname = f"{i:05d}.00.npy"
                fpath = os.path.join(shards_dir, fname)
                with open(fpath, "wb") as f:
                    _write_npy(f, name, arr)
                    f.flush()
                    os.fsync(f.fileno())
                nbytes = os.path.getsize(fpath)
                stat["bytes"] += nbytes
                entry = {"file": f"shards/{fname}",
                         "index": [None] * arr.ndim,
                         "nbytes": nbytes,
                         "crc32": crcs[i].result()}
                self._fire("shard")
                leaves[key] = {"shape": list(arr.shape), "dtype": name,
                               "shards": [entry]}
        manifest = {"format": FORMAT, "step": step, "leaves": leaves,
                    "metadata": metadata}
        man_path = os.path.join(tmp, "manifest.json")
        with open(man_path, "w") as f:
            json.dump(manifest, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        _fsync_dir(shards_dir)
        _fsync_dir(tmp)
        self._fire("before_commit")
        if os.path.isdir(final):      # overwrite of a committed step
            shutil.rmtree(final)
        os.replace(tmp, final)        # THE commit point
        _fsync_dir(self.directory)
        self._fire("after_commit")
        self._gc()
        stat["write_s"] = time.perf_counter() - t0

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

    def _assemble_leaf(self, step_dir: str, key: str,
                       entry: dict) -> np.ndarray:
        """The leaf's host array from its shards (bfloat16 as uint16
        bits), each checked against the manifest's size and CRC."""
        shape, name = tuple(entry["shape"]), entry["dtype"]
        dtype = np.uint16 if name == _BF16 else np.dtype(name)
        arr, covered = None, 0
        for sh in entry["shards"]:
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
            if all(w is None for w in sh["index"]) and \
                    len(entry["shards"]) == 1 and piece.shape == shape:
                arr = piece           # one full-window shard: no copy
            else:
                if arr is None:
                    arr = np.empty(shape, dtype)
                arr[_index_to_slices(sh["index"])] = piece
            covered += piece.size
        size = int(np.prod(shape, dtype=np.int64))
        if arr is None or covered != size:
            raise CheckpointCorruptError(
                f"leaf {key!r}: shards cover {covered} of {size} elements")
        return arr

    def restore(self, like_tree, *, step: Optional[int] = None,
                shardings=None, cast: bool = False):
        """Load a checkpoint into the structure of ``like_tree``.

        ``like_tree`` supplies the structure and the expected shapes,
        dtypes and devices (live tensors, or :class:`Like` leaves from
        :func:`like`); each restored leaf is a tensor on its target's
        device (a CPU tensor for a numpy or scalar target).  Returns
        ``(tree, metadata)``."""
        if shardings is not None:
            raise NotImplementedError(
                "CheckpointManager.restore(shardings=...): not yet ported")
        step = self.latest_step() if step is None else step
        if step is None:
            raise CheckpointError(f"no checkpoints in {self.directory}")
        t0 = time.perf_counter()
        manifest = self._manifest(step)
        step_dir = self._step_dir(step)
        leaves_meta = manifest["leaves"]
        targets = [(_path_key(p), leaf)
                   for p, leaf in flatten_with_path(like_tree)]
        for key, _ in targets:
            if key not in leaves_meta:
                raise CheckpointError(
                    f"checkpoint at step {step} has no leaf {key!r} "
                    f"(saved tree structure differs)")

        def one(item):
            key, leaf = item
            entry = leaves_meta[key]
            arr = self._assemble_leaf(step_dir, key, entry)
            if arr.shape != _target_shape(leaf):
                raise CheckpointError(
                    f"leaf {key!r}: saved shape {arr.shape} != target "
                    f"shape {_target_shape(leaf)}")
            return (_place(_to_tensor(arr, entry["dtype"]), key,
                           entry["dtype"], leaf, cast), arr.nbytes)

        with ThreadPoolExecutor(_IO_THREADS) as pool:
            got = list(pool.map(one, targets))
        out = [t for t, _ in got]
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
            self._assemble_leaf(step_dir, key, entry)
            listed.update(sh["file"] for sh in entry["shards"])
        on_disk = {os.path.join("shards", f)
                   for f in os.listdir(os.path.join(step_dir, "shards"))}
        if on_disk != listed:
            raise CheckpointCorruptError(
                f"step {step}: shard files on disk {sorted(on_disk)} != "
                f"manifest listing {sorted(listed)}")
