"""Paged decode attention forward over a shared block pool, in two variants,
each a CUDA kernel beside its plain version in :mod:`repro_torch.kernels.ref`:

- :func:`paged_decode_attention_fwd` (``csrc/paged_decode_attention.cu``)
  replaces ``repro/kernels/paged_attention.py::paged_decode_attention_fwd``;
- :func:`paged_decode_attention_quant_fwd`
  (``csrc/paged_decode_attention_quant.cu``) replaces
  ``paged_decode_attention_quant_fwd`` of the same file: int8 pools with
  fp32 per-row scale planes reached through the same table lookup.

Both kernels run the decode core of the dense ones
(``csrc/decode_core.cuh``, see :mod:`repro_torch.kernels.decode_attention`)
with their split ranges from :func:`paged_split_plan`; over the same rows
and split plan each gives the bits of its dense counterpart.  The source
notes say what bounds each kernel on the H100 and how its design answers
that.  Layout contract::

    q: (B, KV, G, D)   k_pool, v_pool: (nblocks, bs, KV, D)
    block_tables: (B, nb) int32   lens: (B,) int32
    (int8 variant)     k_scale, v_scale: (nblocks, bs, KV) fp32

Row ``r`` of sequence ``b`` lives at ``pool[block_tables[b, r // bs],
r % bs]``; only its first ``lens[b]`` rows count.  The pools (and scale
planes) are taken through their strides, so a per-layer view of the
model's stacked pool is read in place.  Block 0 is the trash block that
pads every table.

``lens = 0`` (which the engine never produces): the kernels give 0, as the
Pallas kernel does; the plain versions give the reference oracle's answer,
the mean of V (ROADMAP R8).
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from repro_torch.kernels import build, ref
from repro_torch.kernels.decode_attention import (HEAD_DIMS, MAX_GROUP, TILE,
                                                  scratch, sm_count,
                                                  split_plan)

MAX_BLOCKS = 2048      # table entries a sequence may use (a split's
                       # entries sit in shared memory)


def check_tables(block_tables, nblocks: int) -> None:
    """Every table entry in ``[0, nblocks)``, checked on the host: a numpy
    table (the engine's host truth) or a CPU tensor.  A table already on
    the card is not read back (no device sync); the kernels give a NaN
    output for a sequence whose entries fall outside the pool instead of
    reading past it."""
    t = (block_tables.numpy() if isinstance(block_tables, torch.Tensor)
         else np.asarray(block_tables))
    if t.size and (t.min() < 0 or t.max() >= nblocks):
        raise ValueError(f"block table entries outside [0, {nblocks}): "
                         f"min {t.min()}, max {t.max()}")


def _check(what, q, k_pool, v_pool, block_tables, lens, out, scales=()):
    """The layout contract of both kernels (that of the dense wrappers,
    ``decode_attention._check``, over a pool).  With ``scales`` (the int8
    variant's k_scale, v_scale) the pools must be int8 and the scales fp32
    (nblocks, bs, KV); without, the pools share q's dtype."""
    if q.ndim != 4 or k_pool.ndim != 4 or block_tables.ndim != 2:
        raise ValueError(f"{what}: q {tuple(q.shape)}, pool "
                         f"{tuple(k_pool.shape)}, tables "
                         f"{tuple(block_tables.shape)}")
    B, KV, G, D = q.shape
    nblocks, bs = k_pool.shape[:2]
    nb = block_tables.shape[1]
    if (tuple(k_pool.shape) != (nblocks, bs, KV, D)
            or v_pool.shape != k_pool.shape
            or block_tables.shape[0] != B or tuple(lens.shape) != (B,)
            or out.shape != q.shape
            or any(tuple(t.shape) != (nblocks, bs, KV) for t in scales)):
        raise ValueError(f"{what}: shape mismatch")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{what}: group size {G} not in 1..{MAX_GROUP}")
    if not 1 <= nb <= MAX_BLOCKS:
        raise ValueError(f"{what}: {nb} table entries, not in "
                         f"1..{MAX_BLOCKS}")
    if block_tables.dtype != torch.int32 or lens.dtype != torch.int32:
        raise ValueError(f"{what}: block_tables and lens must be int32")
    if not (block_tables.is_contiguous() and lens.is_contiguous()):
        raise ValueError(f"{what}: block_tables and lens must be "
                         "contiguous")
    kv_dtype = torch.int8 if scales else q.dtype
    if (k_pool.dtype != kv_dtype or v_pool.dtype != kv_dtype
            or out.dtype != q.dtype
            or any(t.dtype != torch.float32 for t in scales)):
        raise ValueError(f"{what}: dtypes: q/out {q.dtype}/{out.dtype}, "
                         f"pools {k_pool.dtype}/{v_pool.dtype} (want "
                         f"{kv_dtype}), scales float32")
    for t in (k_pool, v_pool, block_tables, lens, out, *scales):
        if t.device != q.device:
            raise ValueError(f"{what}: every tensor must be on q's device")
    for t in (q, k_pool, v_pool, out):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: D must have unit stride")
    for t in (k_pool, v_pool):              # the kernels' 16-byte row loads
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{what}: K/V rows must start on 16-byte "
                             "boundaries")
    build.dtype_code(q)
    if block_tables.device.type == "cpu":
        check_tables(block_tables, nblocks)


def _fn(name: str, n_ptrs: int):
    f = getattr(build.load(name), name + "_fwd")
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * n_ptrs + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 9 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def paged_split_plan(nb: int, bs: int, heads: int, sms: int = 132):
    """The split plan of :func:`paged_decode_attention_fwd` over the ``nb *
    bs`` virtual rows: chunks a multiple of 64 and of ``bs``
    (``decode_attention.split_plan``)."""
    return split_plan(nb * bs, heads, align=math.lcm(TILE, bs), sms=sms)


def paged_decode_attention_fwd(q, k_pool, v_pool, block_tables, lens, *,
                               out=None):
    """One-token GQA attention over a block pool (see the module
    docstring).  A CPU tensor gets the plain version; a CUDA tensor gets
    the kernel (or an exception for what the kernel does not take)."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check("paged_decode_attention_fwd", q, k_pool, v_pool, block_tables,
           lens, out)
    if q.device.type == "cpu":
        return out.copy_(ref.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, lens))
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_fwd: no kernel for "
                         f"{q.device}")
    if q.numel() == 0:
        return out
    B, KV, G, D = q.shape
    nblocks, bs = k_pool.shape[:2]
    splits, chunk = paged_split_plan(block_tables.shape[1], bs, B * KV,
                                     sm_count(q.device.index))
    part = scratch(B, KV, G, D, splits, q.device)
    strides = (ctypes.c_int64 * 12)(
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *out.stride()[:3])
    name = "paged_decode_attention"
    code = _fn(name, 7)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        block_tables.data_ptr(), lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), strides, B, KV, G,
        block_tables.shape[1], bs, nblocks, D, splits, chunk,
        1.0 / math.sqrt(D), build.dtype_code(q), build.stream_handle(q))
    build.check(build.load(name), code, "paged_decode_attention_fwd")
    build.count_launch(paged_decode_attention_fwd)
    return out


paged_decode_attention_fwd.launches = 0   # calls that ran the kernels, since
                                          # the reset (1 or 2 CUDA kernels)


def paged_decode_attention_quant_fwd(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lens, *, out=None):
    """One-token GQA attention over an int8 block pool with fp32 per-row
    scale planes (see the module docstring); output in q's dtype.  A CPU
    tensor gets the plain version; a CUDA tensor gets the kernel (or an
    exception for what the kernel does not take)."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check("paged_decode_attention_quant_fwd", q, k_pool, v_pool,
           block_tables, lens, out, scales=(k_scale, v_scale))
    if q.device.type == "cpu":
        return out.copy_(ref.paged_decode_attention_quant_ref(
            q, k_pool, v_pool, k_scale, v_scale, block_tables, lens))
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_quant_fwd: no kernel for "
                         f"{q.device}")
    if q.numel() == 0:
        return out
    B, KV, G, D = q.shape
    nblocks, bs = k_pool.shape[:2]
    splits, chunk = paged_split_plan(block_tables.shape[1], bs, B * KV,
                                     sm_count(q.device.index))
    part = scratch(B, KV, G, D, splits, q.device)
    strides = (ctypes.c_int64 * 18)(
        *q.stride()[:3], *k_pool.stride()[:3], *v_pool.stride()[:3],
        *k_scale.stride(), *v_scale.stride(), *out.stride()[:3])
    name = "paged_decode_attention_quant"
    code = _fn(name, 9)(
        q.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
        k_scale.data_ptr(), v_scale.data_ptr(), block_tables.data_ptr(),
        lens.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), strides, B, KV, G,
        block_tables.shape[1], bs, nblocks, D, splits, chunk,
        1.0 / math.sqrt(D), build.dtype_code(q), build.stream_handle(q))
    build.check(build.load(name), code, "paged_decode_attention_quant_fwd")
    build.count_launch(paged_decode_attention_quant_fwd)
    return out


paged_decode_attention_quant_fwd.launches = 0   # calls that ran the kernels,
                                                # since the reset (1 or 2
                                                # CUDA kernels)
