"""RMSNorm forward: the CUDA kernel ``csrc/rmsnorm.cu`` beside its plain
version :func:`repro_torch.kernels.ref.rmsnorm_ref`.

Replaces ``repro/kernels/rmsnorm.py::rmsnorm_fwd``.  The source note in
``csrc/rmsnorm.cu`` says what bounds the kernel on the H100 and how its
design answers that.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build, ref


def _fn():
    f = build.load("rmsnorm").rmsnorm_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                      ctypes.c_int, ctypes.c_int, ctypes.c_int64,
                      ctypes.c_int64, ctypes.c_float, ctypes.c_int,
                      ctypes.c_int, ctypes.c_void_p]
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
    if R == 0:
        return out
    f = _fn()
    code = f(x2d.data_ptr(), w.data_ptr(), out.data_ptr(), R, D,
             x2d.stride(0), out.stride(0), float(eps),
             build.dtype_code(x2d), build.dtype_code(w),
             build.stream_handle(x2d))
    build.check(build.load("rmsnorm"), code, "rmsnorm_fwd")
    rmsnorm_fwd.launches += 1
    return out


rmsnorm_fwd.launches = 0    # kernel launches since the last reset
