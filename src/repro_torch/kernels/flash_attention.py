"""Flash attention forward (prefill): the CUDA kernel
``csrc/flash_attention.cu`` beside its plain version
:func:`repro_torch.kernels.ref.flash_attention_ref`.

Replaces ``repro/kernels/flash_attention.py::flash_attention_fwd``.  The
source note in ``csrc/flash_attention.cu`` says what bounds the kernel on
the H100 and how its design answers that.

Layout contract (see ``ops.py`` for the (B, L, H, D) adapter)::

    q: (B, KV, G, Lq, D)   k, v: (B, KV, Lk, D)   out: like q

Any strides with a unit stride along D: the adapter passes permuted views
of the model's activations, so nothing is copied.  Query positions align to
the END of the key axis: qpos = arange(Lq) + (Lk - Lq).

On a CUDA tensor the dtype chooses between two hand-written kernels:
bf16 runs on the tensor cores (``mma.sync``, tiles copied by ``cp.async``,
so every operand must start on a 16-byte boundary and every stride but
D's be a multiple of 8 elements; a call that is not raises ``ValueError``),
fp32 on the CUDA cores.

With ``lse`` (a contiguous ``(B, KV, G, Lq)`` fp32 tensor) the kernel also
writes each row's log-sum-exp ``m + log(l)`` from the registers that hold
the online softmax's running max and sum: the residual the backward kernel
(``flash_attention_bwd.py``) recomputes the probabilities from.  The
reference recovers it with a second, jnp pass.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128, 192)


def _fn():
    f = build.load("flash_attention").flash_attention_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 5 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 8 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _check(q, k, v, out, causal, window, lse=None):
    if q.ndim != 5 or k.ndim != 4:
        raise ValueError(f"flash_attention_fwd: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    B, KV, G, Lq, D = q.shape
    Lk = k.shape[2]
    if (tuple(k.shape) != (B, KV, Lk, D) or v.shape != k.shape
            or out.shape != q.shape):
        raise ValueError("flash_attention_fwd: shape mismatch")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attention_fwd: head_dim {D} not in "
                         f"{HEAD_DIMS}")
    if causal and Lq > Lk:          # a query would precede every key
        raise ValueError(f"flash_attention_fwd: causal with Lq={Lq} > Lk={Lk}")
    if window is not None and window < 1:
        raise ValueError(f"flash_attention_fwd: window={window}")
    for t in (q, k, v, out):
        if t.dtype != q.dtype or t.device != q.device:
            raise ValueError("flash_attention_fwd: q/k/v/out must share "
                             "dtype and device")
        if t.stride(-1) != 1:
            raise ValueError("flash_attention_fwd: D must have unit stride")
    if lse is not None and (tuple(lse.shape) != (B, KV, G, Lq)
                            or lse.dtype != torch.float32
                            or lse.device != q.device
                            or not lse.is_contiguous()):
        raise ValueError("flash_attention_fwd: lse must be a contiguous "
                         "(B, KV, G, Lq) float32 tensor beside q")
    build.dtype_code(q)
    if q.dtype == torch.bfloat16:   # the tensor-core kernel's cp.async
        build.check_aligned("flash_attention_fwd", q, k, v, out)


def flash_attention_fwd(q, k, v, *, causal=True, window=None, out=None,
                        lse=None):
    """Grouped-layout attention (see the module docstring).  A CPU tensor
    gets the plain version; a CUDA tensor gets the kernel (or an exception
    for what the kernel does not take).  Writes into ``out`` when given,
    and the rows' log-sum-exp into ``lse`` when given."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check(q, k, v, out, causal, window, lse)
    if q.device.type == "cpu":
        if lse is not None:
            lse.copy_(ref.flash_attention_lse_ref(q, k, causal=causal,
                                                  window=window))
        return out.copy_(ref.flash_attention_ref(q, k, v, causal=causal,
                                                 window=window))
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention_fwd: no kernel for {q.device}")
    B, KV, G, Lq, D = q.shape
    Lk = k.shape[2]
    if q.numel() == 0:
        return out
    strides = (ctypes.c_int64 * 14)(
        *build.strides(q, 4), *build.strides(k, 3), *build.strides(v, 3),
        *build.strides(out, 4))
    code = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                 None if lse is None else lse.data_ptr(), strides,
                 B, KV, G, Lq, Lk, D, int(bool(causal)),
                 -1 if window is None else int(window),
                 1.0 / math.sqrt(D), build.dtype_code(q),
                 build.stream_handle(q))
    build.check(build.load("flash_attention"), code, "flash_attention_fwd")
    flash_attention_fwd.launches += 1
    return out


flash_attention_fwd.launches = 0    # kernel launches since the last reset
