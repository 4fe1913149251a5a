"""Mamba2 SSD intra-chunk pass: the CUDA kernel ``csrc/ssd_intra.cu`` beside
its plain version :func:`repro_torch.kernels.ref.ssd_intra_ref`.

Replaces ``repro/kernels/ssd_scan.py::ssd_intra_fwd``.  The source note in
``csrc/ssd_intra.cu`` says what bounds its two kernels on the H100 (fp32 on
the CUDA cores, bf16 on the tensor cores) and how their designs answer
that; :func:`ssd_plan` picks the bf16 kernel's grid on the host.  Layout
contract (ngroups = 1)::

    X: (b, nc, q, h, p)   dt: (b, nc, q, h) fp32   A: (h,) fp32
    B, C: (b, nc, q, n) in X's dtype (fp32 or bf16); on the card p is 32
    or 64 and n is 32, 64 or 128
    -> Y_diag (b, nc, q, h, p) in X's dtype, S_c (b, nc, h, p, n) fp32,
       A_cs (b, nc, h, q) fp32

The inputs are read through their strides (X, B and C are slices of the
model's conv output), so nothing is copied before the launch.  The kernel
computes the forward only, like the Pallas kernel.  Training reaches it
through :class:`repro_torch.kernels.ops.SSDIntra`, which
:func:`repro_torch.kernels.ops.ssd_scan` takes where autograd needs a
backward: its forward is this wrapper, its backward the explicit plain
:func:`repro_torch.kernels.ref.ssd_intra_bwd_ref` (the reference has no
backward kernel).  Remat runs each layer's forward twice, so the kernel
must repeat its bits: neither kernel has an order-dependent sum (no
atomics; every output element is summed by one thread or one warp's
``mma`` chain in a fixed order, and A_cs is a fixed fp64 scan), so two
calls on the same inputs give the same bits.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build, ref

# the head dims (p) and state sizes (n) the kernel is built for (templates)
HEADDIMS = (32, 64)
STATES = (32, 64, 128)
TILE = 64                  # query rows of a Y block, keys of a tile (kT)
HEADS = 2                  # heads a block, one per warp group (kHeads):
                           # a Y block's two heads share its scores


class SsdPlan(NamedTuple):
    n_qtiles: int         # 64-row tiles of the chunk
    n_pairs: int          # head pairs: a Y or state block owns one
    n_slices: int         # state blocks per pair (columns of n)
    y_blocks: int         # per (batch, chunk)
    s_blocks: int         # per (batch, chunk)


def state_width(n: int) -> int:
    """Columns of S_c a state block owns (csrc state_width)."""
    return min(n, 64)


def ssd_plan(q, h, n) -> SsdPlan:
    """The bf16 kernel's grid per (batch, chunk), from shapes alone: a Y
    block per (query tile, head pair), heaviest tiles first, and
    ``n / state_width(n)`` state blocks per head pair.  Any q: the blocks
    stream the keys tile by tile, and their shared memory does not grow
    with q."""
    n_qtiles = -(-q // TILE)
    n_pairs = -(-h // HEADS)
    n_slices = n // state_width(n)
    return SsdPlan(n_qtiles, n_pairs, n_slices, n_qtiles * n_pairs,
                   n_pairs * n_slices)


def aligned16(*tensors) -> bool:
    """Whether the bf16 kernel may copy the rows of ``tensors`` by 16-byte
    ``cp.async``: 16-byte aligned data, unit stride along the last
    dimension and every other stride a multiple of 8 elements (dimensions
    of size 1 aside).  Otherwise it loads element by element."""
    return all(t.data_ptr() % 16 == 0
               and build.strides(t, t.ndim)[-1] in (0, 1)
               and all(s % 8 == 0 for s in build.strides(t, t.ndim - 1))
               for t in tensors)


def _fn():
    f = build.load("ssd_intra").ssd_intra_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 9 + [
            ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _check(X, dt, A, B, C):
    if X.ndim != 5 or dt.ndim != 4 or A.ndim != 1 or B.ndim != 4:
        raise ValueError(f"ssd_intra_fwd: X {tuple(X.shape)}, dt "
                         f"{tuple(dt.shape)}, A {tuple(A.shape)}, B "
                         f"{tuple(B.shape)}")
    b, nc, q, h, p = X.shape
    n = B.shape[-1]
    if (tuple(dt.shape) != (b, nc, q, h) or tuple(A.shape) != (h,)
            or tuple(B.shape) != (b, nc, q, n) or C.shape != B.shape):
        raise ValueError("ssd_intra_fwd: shape mismatch")
    if dt.dtype != torch.float32 or A.dtype != torch.float32:
        raise TypeError(f"ssd_intra_fwd: dt and A must be float32, got "
                        f"{dt.dtype} and {A.dtype}")
    build.dtype_code(X)
    if B.dtype != X.dtype or C.dtype != X.dtype:
        raise TypeError(f"ssd_intra_fwd: X, B, C must share a dtype, got "
                        f"{X.dtype}, {B.dtype}, {C.dtype}")
    if h > 1 and A.stride(0) != 1:
        raise ValueError("ssd_intra_fwd: A must have unit stride")
    for t in (dt, A, B, C):
        if t.device != X.device:
            raise ValueError("ssd_intra_fwd: every tensor must be on X's "
                             "device")


def ssd_intra_fwd(X, dt, A, B, C):
    """Intra-chunk SSD (see the module docstring): returns (Y_diag, S_c,
    A_cs).  A CPU tensor gets the plain version; a CUDA tensor gets the
    kernel of its dtype (or an exception for what the kernel does not
    take)."""
    _check(X, dt, A, B, C)
    if X.device.type == "cpu":
        y, s_c, _, a_cs = ref.ssd_intra_ref(X, dt, A, B, C)
        return y, s_c, a_cs
    if X.device.type != "cuda":
        raise ValueError(f"ssd_intra_fwd: no kernel for {X.device}")
    b, nc, q, h, p = X.shape
    n = B.shape[-1]
    if p not in HEADDIMS or n not in STATES:
        raise ValueError(f"ssd_intra_fwd: headdim {p} not in {HEADDIMS} or "
                         f"state {n} not in {STATES}")
    dev = X.device
    y = torch.empty((b, nc, q, h, p), dtype=X.dtype, device=dev)
    s_c = torch.empty((b, nc, h, p, n), dtype=torch.float32, device=dev)
    a_cs = torch.empty((b, nc, h, q), dtype=torch.float32, device=dev)
    if X.numel() == 0:
        return y, s_c, a_cs
    pl = ssd_plan(q, h, n)
    strides = (ctypes.c_int64 * 17)(*(s for t in (X, dt, B, C)
                                      for s in build.strides(t, t.ndim)))
    code = _fn()(X.data_ptr(), dt.data_ptr(), A.data_ptr(), B.data_ptr(),
                 C.data_ptr(), y.data_ptr(), s_c.data_ptr(), a_cs.data_ptr(),
                 strides, b, nc, q, h, p, n, build.dtype_code(X),
                 pl.n_slices, int(aligned16(X, B, C)), build.stream_handle(X))
    build.check(build.load("ssd_intra"), code, "ssd_intra_fwd")
    ssd_intra_fwd.launches += 1
    return y, s_c, a_cs


ssd_intra_fwd.launches = 0    # kernel launches since the last reset
