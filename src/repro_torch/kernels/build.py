"""Build the CUDA sources in ``csrc/`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` into a shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes) for Hopper::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o _build/<name>-<hash>.so csrc/<name>.cu

The library lands in ``kernels/_build/`` (listed in ``.gitignore``) under a
name that hashes the sources and flags, so an edited source is rebuilt and
an unchanged one is reused.  :func:`build` starts one ``nvcc`` per missing
library, all at once, and waits for them; :func:`load` builds on first use.
Any failure raises.

Every C entry point returns ``cudaGetLastError()`` after its launch;
:func:`check` turns a non-zero code into an exception, and each wrapper
then counts the launch with :func:`count_launch`.  Both :func:`load` and
the counts take a lock: asynchronous RLHF launches kernels from two
threads (the producer's decode and the consumer's training).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
SOURCES = ("rmsnorm", "flash_attention", "flash_attention_bwd",
           "decode_attention", "decode_attention_quant",
           "paged_decode_attention", "paged_decode_attention_quant",
           "ssd_intra")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
# dtype codes of csrc/common.cuh (repro::DtypeCode)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_libs: dict = {}
_load_lock = threading.Lock()
_count_lock = threading.Lock()


def nvcc_path() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and Path(cand).is_file():
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels are built from "
                       "source with the CUDA toolkit's nvcc")


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.read_bytes())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def build(names=SOURCES, *, ptxas_verbose: bool = False) -> dict:
    """Compile the libraries of ``names`` that are not built yet, one
    ``nvcc`` each, all in parallel.  Returns ``{name: {"seconds": s,
    "log": compiler stderr}}`` for the ones it built; raises if any
    failed."""
    todo = {n: lib_path(n) for n in names if not lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, out in todo.items():
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if ptxas_verbose
                                    else ()),
               "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.PIPE, text=True),
                       tmp, out, time.perf_counter())
    report, errors = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        _, err = proc.communicate()
        report[name] = {"seconds": time.perf_counter() - t0, "log": err}
        if proc.returncode != 0:
            errors.append(f"{name}.cu: nvcc exited {proc.returncode}\n{err}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)   # atomic: a concurrent build sees all or none
    if errors:
        raise RuntimeError("kernel build failed:\n" + "\n".join(errors))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    with _load_lock:
        if name not in _libs:
            build((name,))
            lib = ctypes.CDLL(str(lib_path(name)))
            lib.repro_error_string.argtypes = [ctypes.c_int]
            lib.repro_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
        return _libs[name]


def count_launch(fn) -> None:
    """Add one to the wrapper ``fn``'s launch count (``fn.launches``),
    under a lock, so that no increment is lost between threads."""
    with _count_lock:
        fn.launches += 1


def set_launch_count(fn, n: int = 0) -> None:
    """Set ``fn.launches`` to ``n`` under the same lock."""
    with _count_lock:
        fn.launches = n


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    if code != 0:
        msg = lib.repro_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def stream_handle(t: torch.Tensor) -> int:
    """PyTorch's current stream on ``t``'s device, as a C pointer value.
    The tensor must be on the current device: the C side launches on the
    current device."""
    if t.device.index != torch.cuda.current_device():
        raise RuntimeError(f"tensor on {t.device}, current device is "
                           f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(t.device).cuda_stream


def strides(t: torch.Tensor, n: int) -> tuple:
    """The first ``n`` strides of ``t`` in elements, 0 for a dimension of
    size 1 (whose stride no index ever multiplies)."""
    return tuple(s if d > 1 else 0 for s, d in zip(t.stride()[:n],
                                                   t.shape[:n]))


def check_aligned(what: str, *tensors: torch.Tensor) -> None:
    """The bf16 tensor-core kernels copy 16-byte chunks (``cp.async``):
    each tensor must start on a 16-byte boundary, and every stride but the
    last (unit) one must be a multiple of 8 elements.  Raises
    ``ValueError`` otherwise, before anything is launched."""
    for t in tensors:
        if t.data_ptr() % 16 or any(s % 8 for s in strides(t, t.ndim - 1)):
            raise ValueError(
                f"{what}: the bf16 kernel needs 16-byte aligned data and "
                f"strides that are multiples of 8 elements, got data_ptr % "
                f"16 = {t.data_ptr() % 16}, strides {tuple(t.stride())}")


def dtype_code(t: torch.Tensor) -> int:
    if t.dtype not in DTYPE_CODES:
        raise TypeError(f"kernels take float32 or bfloat16, got {t.dtype}")
    return DTYPE_CODES[t.dtype]
