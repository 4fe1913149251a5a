"""Flash attention backward: the CUDA kernels ``csrc/flash_attention_bwd.cu``
(one for dK/dV, one for dQ) beside their plain version
:func:`repro_torch.kernels.ref.flash_attention_bwd_ref`.

Replaces ``repro/kernels/flash_attention_bwd.py::flash_attention_bwd``.
The source note in ``csrc/flash_attention_bwd.cu`` says what bounds the
kernels on the H100 and how their design answers that.

Layout contract (see ``ops.py`` for the (B, L, H, D) adapter)::

    q, do, dq: (B, KV, G, Lq, D)   k, v, dk, dv: (B, KV, Lk, D)
    lse, delta: (B, KV, G, Lq) float32, contiguous

Any strides with a unit stride along D, as the forward, and for bf16 the
forward's alignment (16-byte starts, strides in multiples of 8 elements):
bf16 runs on the tensor cores, fp32 on the CUDA cores.  Unlike the
reference, no block size has to divide Lq or Lk: the kernels mask both
ragged edges.  Query positions align to the end of the keys
(q_offset = Lk - Lq).
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.flash_attention import HEAD_DIMS


def _fns():
    lib = build.load("flash_attention_bwd")
    fns = lib.flash_attention_bwd_dkv, lib.flash_attention_bwd_dq
    for f in fns:
        if f.argtypes is None:
            f.argtypes = [ctypes.c_void_p] * 9 + [
                ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 8 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
            f.restype = ctypes.c_int
    return lib, fns


def _check(q, k, v, do, lse, delta, dq, dk, dv, causal, window):
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"flash_attention_bwd: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    B, KV, G, Lq, D = q.shape
    Lk = k.shape[2]
    if (tuple(k.shape) != (B, KV, Lk, D) or v.shape != k.shape
            or do.shape != q.shape or dq.shape != q.shape
            or dk.shape != k.shape or dv.shape != k.shape):
        raise ValueError("flash_attention_bwd: shape mismatch")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if causal and Lq > Lk:          # a query would precede every key
        raise ValueError(f"flash_attention_bwd: causal with Lq={Lq} > Lk={Lk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_bwd: window={window}")
    for t in (q, k, v, do, dq, dk, dv):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_bwd: q/k/v/do/dq/dk/dv must "
                             "share dtype and device")
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_bwd: D must have unit stride")
    for t in (lse, delta):
        if (tuple(t.shape) != (B, KV, G, Lq) or t.dtype != torch.float32
                or t.device != q.device or not t.is_contiguous()):
            raise ValueError("flash_attention_bwd: lse and delta must be "
                             "contiguous (B, KV, G, Lq) float32 tensors "
                             "beside q")
    build.dtype_code(q)
    if q.dtype == torch.bfloat16:   # the tensor-core kernels' cp.async
        build.check_aligned("flash_attention_bwd", q, k, v, do, dq, dk, dv)


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal=True,
                        window=None, dq=None, dk=None, dv=None):
    """(dq, dk, dv) of grouped-layout attention from the forward's ``lse``
    and ``delta = rowsum(do * out)``.  A CPU tensor gets the plain
    version; a CUDA tensor gets the two kernels (or an exception for what
    they do not take).  Writes into ``dq``/``dk``/``dv`` when given."""
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device) \
        if dq is None else dq
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device) \
        if dk is None else dk
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device) \
        if dv is None else dv
    _check(q, k, v, do, lse, delta, dq, dk, dv, causal, window)
    if q.device.type == "cpu":
        for out, r in zip((dq, dk, dv), ref.flash_attention_bwd_ref(
                q, k, v, do, lse, delta, causal=causal, window=window)):
            out.copy_(r)
        return dq, dk, dv
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_bwd: no kernel for {q.device}")
    if q.numel() == 0 or k.numel() == 0:
        return dq.zero_(), dk.zero_(), dv.zero_()
    _launch(("dkv", "dq"), q, k, v, do, lse, delta, dq, dk, dv, causal,
            window)
    return dq, dk, dv


def _launch(parts, q, k, v, do, lse, delta, dq, dk, dv, causal, window):
    """Launch the kernels named in ``parts`` ("dkv" writes dk and dv, "dq"
    writes dq) on checked CUDA tensors, counting each launch.  The
    measurement script times the two apart through this."""
    B, KV, G, Lq, D = q.shape
    Lk = k.shape[2]
    strides = (ctypes.c_int64 * 24)(
        *build.strides(q, 4), *build.strides(k, 3), *build.strides(v, 3),
        *build.strides(do, 4), *build.strides(dq, 4), *build.strides(dk, 3),
        *build.strides(dv, 3))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), strides, B, KV, G, Lq, Lk, D, int(bool(causal)),
            -1 if window is None else int(window), 1.0 / math.sqrt(D),
            build.dtype_code(q), build.stream_handle(q))
    lib, fns = _fns()
    for part, fn, what in zip(("dkv", "dq"), fns, ("dK/dV", "dQ")):
        if part in parts:
            build.check(lib, fn(*args), f"flash_attention_bwd ({what})")
            flash_attention_bwd.launches += 1


flash_attention_bwd.launches = 0    # kernel launches since the last reset
