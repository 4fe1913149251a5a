"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` beside its plain
version :func:`repro_torch.kernels.ref.rmsnorm_ref`.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_fwd``.  The source note in
``csrc/rmsnorm.cu`` says what bounds the kernel on the H100 and how its
design answers that; :func:`plan` picks its geometry on the host.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

MAX_THREADS = 256          # threads of a block (csrc kMaxThreads)
MAX_VECS = 8               # vectors a thread holds in registers (kMaxVecs)
MAX_STAGED_BYTES = 220 * 1024   # shared memory of a staged row, at most
THREADS_PER_SM = 1024      # resident threads an SM should get at large R


class Plan(NamedTuple):
    vec: int              # elements a load (<= 16 bytes)
    tpr: int              # threads a row; 0: one staged row a block
    nv: int               # vectors a thread (rows kernel)
    rows_per_block: int
    threads: int          # threads a block
    blocks: int
    staged_bytes: int     # shared memory of the staged kernel (0: re-read)


def _pow2_at_least(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def lane_width(D, x_esize, w_esize, *, x_ptr=0, w_ptr=0, out_ptr=0,
               x_stride=0, out_stride=0):
    """Elements a load: the widest of 16, 8, 4, 2 bytes (down to one
    element) that divides D, both row strides and the alignment of every
    pointer (w's loads are ``vec`` of its own elements, at most 16 bytes
    at a time)."""
    vec = 16 // x_esize
    while vec > 1:
        xb = vec * x_esize
        if (D % vec == 0 and x_ptr % xb == 0 and out_ptr % xb == 0
                and w_ptr % min(16, vec * w_esize) == 0
                and x_stride % vec == 0 and out_stride % vec == 0):
            break
        vec //= 2
    return vec


def plan(R, D, x_esize, w_esize, *, x_ptr=0, w_ptr=0, out_ptr=0, x_stride=0,
         out_stride=0, sms=132) -> Plan:
    """The kernel's geometry for R rows of D, from shapes, strides (in
    elements; 0 where R = 1) and pointer values alone.  Each thread gets
    ``nv`` vectors: one while the rows x vectors fit ``THREADS_PER_SM``
    threads an SM, more (up to ``MAX_VECS``) at large R; ``tpr``, the
    threads a row, is the power of two that covers the row with them (at
    most ``MAX_THREADS``), and a block holds ``MAX_THREADS // tpr`` rows.
    A row past ``MAX_THREADS * MAX_VECS`` vectors goes to the staged
    kernel, one row a block."""
    vec = lane_width(D, x_esize, w_esize, x_ptr=x_ptr, w_ptr=w_ptr,
                     out_ptr=out_ptr, x_stride=x_stride,
                     out_stride=out_stride)
    nvec = D // vec
    if nvec > MAX_THREADS * MAX_VECS:
        row = -(-D * x_esize // 16) * 16 + D * w_esize
        return Plan(vec, 0, -(-nvec // MAX_THREADS), 1, MAX_THREADS, R,
                    row if row <= MAX_STAGED_BYTES else 0)
    nv = min(MAX_VECS, max(1, -(-R * nvec // (sms * THREADS_PER_SM))))
    tpr = min(MAX_THREADS, _pow2_at_least(-(-nvec // nv)))
    nv = -(-nvec // tpr)
    rows_per_block = MAX_THREADS // tpr
    threads = tpr * rows_per_block
    return Plan(vec, tpr, nv, rows_per_block, threads,
                -(-R // rows_per_block), 0)


def _fn():
    f = build.load("rmsnorm").rmsnorm_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_float] + [ctypes.c_int] * 6 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def rmsnorm_fwd(x2d, w, *, eps=1e-5, out=None):
    """x2d: (R, D); w: (D,) -> (R, D) in x2d's dtype (fp32 math).

    A CPU tensor gets the plain version; a CUDA tensor gets the kernel (or
    an exception for what the kernel does not take)."""
    if x2d.ndim != 2 or tuple(w.shape) != (x2d.shape[1],):
        raise ValueError(f"rmsnorm_fwd: x2d {tuple(x2d.shape)}, "
                         f"w {tuple(w.shape)}")
    R, D = x2d.shape
    if out is None:
        out = torch.empty((R, D), dtype=x2d.dtype, device=x2d.device)
    if tuple(out.shape) != (R, D) or out.dtype != x2d.dtype:
        raise ValueError("rmsnorm_fwd: out must match x2d")
    for t in (x2d, w, out):
        build.dtype_code(t)
        if t.device != x2d.device:
            raise ValueError("rmsnorm_fwd: tensors on different devices")
        if t.shape[-1] > 1 and t.stride(-1) != 1:
            raise ValueError("rmsnorm_fwd: D must have unit stride")
    if x2d.device.type == "cpu":
        return out.copy_(ref.rmsnorm_ref(x2d, w, eps))
    if x2d.device.type != "cuda":
        raise ValueError(f"rmsnorm_fwd: no kernel for {x2d.device}")
    if R == 0 or D == 0:
        return out
    xs, os_ = build.strides(x2d, 1)[0], build.strides(out, 1)[0]
    p = plan(R, D, x2d.element_size(), w.element_size(),
             x_ptr=x2d.data_ptr(), w_ptr=w.data_ptr(),
             out_ptr=out.data_ptr(), x_stride=xs, out_stride=os_)
    code = _fn()(x2d.data_ptr(), w.data_ptr(), out.data_ptr(), R, D, xs, os_,
                 float(eps), build.dtype_code(x2d), build.dtype_code(w),
                 p.vec, p.tpr, p.rows_per_block, p.staged_bytes,
                 build.stream_handle(x2d))
    build.check(build.load("rmsnorm"), code, "rmsnorm_fwd")
    build.count_launch(rmsnorm_fwd)
    return out


rmsnorm_fwd.launches = 0    # kernel launches since the last reset
