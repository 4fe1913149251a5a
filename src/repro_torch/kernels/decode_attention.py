"""Decode attention forward: the CUDA kernel ``csrc/decode_attention.cu``
beside its plain version :func:`repro_torch.kernels.ref.decode_attention_ref`.

Replaces ``repro/kernels/decode_attention.py::decode_attention_fwd``.  The
source note in ``csrc/decode_attention.cu`` says what bounds the kernel on
the H100 and how its design answers that.

Layout contract::

    q: (B, KV, G, D)   k_cache, v_cache: (B, KV, S, D)   valid: (B, S) bool

The caches are taken through their strides (unit stride along D, rows on
16-byte boundaries), so the model's (B, S, KV, D) arena is passed as a
transposed view and read in place: the decode step never copies the cache.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8          # query heads per KV head (csrc kMaxG)


def _fn():
    f = build.load("decode_attention").decode_attention_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 5 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _check(q, k_cache, v_cache, valid, out):
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError(f"decode_attention_fwd: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}")
    B, KV, G, D = q.shape
    S = k_cache.shape[2]
    if (tuple(k_cache.shape) != (B, KV, S, D) or v_cache.shape != k_cache.shape
            or tuple(valid.shape) != (B, S) or out.shape != q.shape):
        raise ValueError("decode_attention_fwd: shape mismatch")
    if D not in HEAD_DIMS:
        raise ValueError(f"decode_attention_fwd: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"decode_attention_fwd: group size {G} not in "
                         f"1..{MAX_GROUP}")
    if valid.dtype != torch.bool or valid.device != q.device:
        raise ValueError("decode_attention_fwd: valid must be a bool mask "
                         "on q's device")
    for t in (q, k_cache, v_cache, out):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("decode_attention_fwd: q/k/v/out must share "
                             "dtype and device")
        if t.stride(-1) != 1:
            raise ValueError("decode_attention_fwd: D must have unit stride")
    vec = 16 // q.element_size()          # the kernel's 16-byte row loads
    for t in (k_cache, v_cache):
        if t.data_ptr() % 16 or any(s % vec for s in t.stride()[:3]):
            raise ValueError("decode_attention_fwd: K/V rows must start on "
                             "16-byte boundaries")
    build.dtype_code(q)


def decode_attention_fwd(q, k_cache, v_cache, valid, *, out=None):
    """One-token GQA attention over a dense cache (see the module
    docstring).  A CPU tensor gets the plain version; a CUDA tensor gets
    the kernel (or an exception for what the kernel does not take)."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check(q, k_cache, v_cache, valid, out)
    if q.device.type == "cpu":
        return out.copy_(ref.decode_attention_ref(q, k_cache, v_cache, valid))
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_fwd: no kernel for {q.device}")
    B, KV, G, D = q.shape
    S = k_cache.shape[2]
    if q.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 14)(
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *valid.stride(), *out.stride()[:3])
    code = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 valid.data_ptr(), out.data_ptr(), strides, B, KV, G, S, D,
                 1.0 / math.sqrt(D), build.dtype_code(q),
                 build.stream_handle(q))
    build.check(build.load("decode_attention"), code, "decode_attention_fwd")
    decode_attention_fwd.launches += 1
    return out


decode_attention_fwd.launches = 0    # kernel launches since the last reset
