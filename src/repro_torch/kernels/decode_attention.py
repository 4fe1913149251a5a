"""Decode attention forward over a dense KV arena, in two variants, each a
CUDA kernel beside its plain version in :mod:`repro_torch.kernels.ref`:

- :func:`decode_attention_fwd` (``csrc/decode_attention.cu``) replaces
  ``repro/kernels/decode_attention.py::decode_attention_fwd``;
- :func:`decode_attention_quant_fwd` (``csrc/decode_attention_quant.cu``)
  replaces ``decode_attention_quant_fwd`` of the same file: int8 K/V with
  fp32 per-row scales, dequantized on the score and probability tiles.

Both kernels here and both of :mod:`repro_torch.kernels.paged_attention`
run one decode core (``csrc/decode_core.cuh``): split-KV over ``(splits,
KV, B)`` blocks, then a combine kernel when ``splits > 1``, with the split
ranges chosen on the host by :func:`split_plan`.  The source notes say what
bounds each kernel on the H100 and how its design answers that.  Layout
contract::

    q: (B, KV, G, D)   k_cache, v_cache: (B, KV, S, D)   valid: (B, S) bool
    (int8 variant)     k_scale, v_scale: (B, KV, S) fp32

The caches (and scale planes) are taken through their strides (unit stride
along D, rows on 16-byte boundaries), so the model's (B, S, KV, D) arena is
passed as a transposed view and read in place: the decode step never
copies the cache.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from repro_torch.kernels import build, ref

HEAD_DIMS = (32, 64, 128)
MAX_GROUP = 8          # query heads per KV head (csrc kMaxG)
TILE = 64              # split ranges are multiples of this (csrc kTile)
WAVES = 2              # blocks per SM that the split choice aims for
MAX_SPLITS = 64        # csrc kMaxSplits
MAX_CHUNK = 16384      # dense rows per split: their mask bytes sit in
                       # shared memory


def split_plan(n_rows: int, heads: int, *, align: int = TILE,
               sms: int = 132, max_chunk: int | None = None):
    """``(splits, chunk)`` of the decode kernels (``csrc/decode_core.cuh``),
    chosen on the host from shapes alone (no device read, so a call can be
    captured in a CUDA graph).  ``heads = B * KV`` blocks per split; each
    split ``chunk`` rows, a multiple of ``align``; split ``s`` covers rows
    ``[s * chunk, min((s + 1) * chunk, n_rows))``, none empty.

    A split costs a second kernel, the combine (3-6 us on the H100), so
    the rows are split only when ``heads < sms`` leaves SMs without a
    block, and then into at least enough splits that ``heads * splits``
    reaches ``WAVES * sms`` blocks (at most ``MAX_SPLITS``, at least one
    ``align`` unit each), the rows spread evenly."""
    units = max(1, -(-n_rows // align))         # align-row units
    want = (1 if heads >= sms else
            min(MAX_SPLITS, -(-WAVES * sms // max(heads, 1))))
    per = max(1, units // want, -(-units // MAX_SPLITS))
    if max_chunk is not None:
        per = min(per, max(1, max_chunk // align))
    chunk = per * align
    return max(1, -(-n_rows // chunk)), chunk


def record_floats(G: int, D: int) -> int:
    """fp32 values of one split's partial record (csrc record_floats):
    acc (G, D), m (G), l (G) and a state, rounded up to 4."""
    return (G * D + 2 * G + 1 + 3) // 4 * 4


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Streaming multiprocessors of CUDA device ``index`` (cached)."""
    return torch.cuda.get_device_properties(index).multi_processor_count


def scratch(B, KV, G, D, splits, device):
    """The split partials' scratch (None for one split): one allocation."""
    if splits == 1:
        return None
    return torch.empty(B * KV * splits * record_floats(G, D),
                       dtype=torch.float32, device=device)


def _fn():
    f = build.load("decode_attention").decode_attention_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def _check(what, q, k_cache, v_cache, valid, out, scales=()):
    """The layout contract of both kernels.  With ``scales`` (the int8
    variant's k_scale, v_scale) the caches must be int8 and the scales
    fp32 (B, KV, S); without, the caches share q's dtype."""
    if q.ndim != 4 or k_cache.ndim != 4:
        raise ValueError(f"{what}: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}")
    B, KV, G, D = q.shape
    S = k_cache.shape[2]
    if (tuple(k_cache.shape) != (B, KV, S, D) or v_cache.shape != k_cache.shape
            or tuple(valid.shape) != (B, S) or out.shape != q.shape
            or any(tuple(t.shape) != (B, KV, S) for t in scales)):
        raise ValueError(f"{what}: shape mismatch")
    if D not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"{what}: group size {G} not in 1..{MAX_GROUP}")
    if valid.dtype != torch.bool:
        raise ValueError(f"{what}: valid must be a bool mask")
    kv_dtype = torch.int8 if scales else q.dtype
    if (k_cache.dtype != kv_dtype or v_cache.dtype != kv_dtype
            or out.dtype != q.dtype
            or any(t.dtype != torch.float32 for t in scales)):
        raise ValueError(f"{what}: dtypes: q/out {q.dtype}/{out.dtype}, "
                         f"k/v {k_cache.dtype}/{v_cache.dtype} (want "
                         f"{kv_dtype}), scales float32")
    for t in (k_cache, v_cache, valid, out, *scales):
        if t.device != q.device:
            raise ValueError(f"{what}: every tensor must be on q's device")
    for t in (q, k_cache, v_cache, out):
        if t.stride(-1) != 1:
            raise ValueError(f"{what}: D must have unit stride")
    for t in (k_cache, v_cache):            # the kernels' 16-byte row loads
        if t.data_ptr() % 16 or any(s * t.element_size() % 16
                                    for s in t.stride()[:3]):
            raise ValueError(f"{what}: K/V rows must start on 16-byte "
                             "boundaries")
    build.dtype_code(q)


def decode_attention_fwd(q, k_cache, v_cache, valid, *, out=None):
    """One-token GQA attention over a dense cache (see the module
    docstring).  A CPU tensor gets the plain version; a CUDA tensor gets
    the kernel (or an exception for what the kernel does not take)."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check("decode_attention_fwd", q, k_cache, v_cache, valid, out)
    if q.device.type == "cpu":
        return out.copy_(ref.decode_attention_ref(q, k_cache, v_cache, valid))
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_fwd: no kernel for {q.device}")
    if q.numel() == 0:
        return out
    B, KV, G, D = q.shape
    S = k_cache.shape[2]
    splits, chunk = split_plan(S, B * KV, sms=sm_count(q.device.index),
                               max_chunk=MAX_CHUNK)
    part = scratch(B, KV, G, D, splits, q.device)
    strides = (ctypes.c_int64 * 14)(
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *valid.stride(), *out.stride()[:3])
    code = _fn()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                 valid.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), strides, B, KV,
                 G, S, D, splits, chunk, 1.0 / math.sqrt(D),
                 build.dtype_code(q), build.stream_handle(q))
    build.check(build.load("decode_attention"), code, "decode_attention_fwd")
    build.count_launch(decode_attention_fwd)
    return out


decode_attention_fwd.launches = 0    # calls that ran the kernels, since
                                     # the last reset (1 or 2 CUDA kernels)


# --------------------------------------------------------------------- #
# int8 KV
# --------------------------------------------------------------------- #
def _fn_quant():
    f = build.load("decode_attention_quant").decode_attention_quant_fwd
    if f.argtypes is None:
        f.argtypes = [ctypes.c_void_p] * 8 + [
            ctypes.POINTER(ctypes.c_int64)] + [ctypes.c_int] * 7 + [
            ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def decode_attention_quant_fwd(q, k_cache, v_cache, k_scale, v_scale, valid,
                               *, out=None):
    """One-token GQA attention over an int8 dense cache with fp32 per-row
    scales (see the module docstring); output in q's dtype.  A CPU tensor
    gets the plain version; a CUDA tensor gets the kernel (or an exception
    for what the kernel does not take)."""
    if out is None:
        out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _check("decode_attention_quant_fwd", q, k_cache, v_cache, valid, out,
           scales=(k_scale, v_scale))
    if q.device.type == "cpu":
        return out.copy_(ref.decode_attention_quant_ref(
            q, k_cache, v_cache, k_scale, v_scale, valid))
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention_quant_fwd: no kernel for "
                         f"{q.device}")
    if q.numel() == 0:
        return out
    B, KV, G, D = q.shape
    S = k_cache.shape[2]
    splits, chunk = split_plan(S, B * KV, sms=sm_count(q.device.index),
                               max_chunk=MAX_CHUNK)
    part = scratch(B, KV, G, D, splits, q.device)
    strides = (ctypes.c_int64 * 20)(
        *q.stride()[:3], *k_cache.stride()[:3], *v_cache.stride()[:3],
        *k_scale.stride(), *v_scale.stride(), *valid.stride(),
        *out.stride()[:3])
    code = _fn_quant()(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                       k_scale.data_ptr(), v_scale.data_ptr(),
                       valid.data_ptr(), out.data_ptr(),
                       None if part is None else part.data_ptr(), strides, B,
                       KV, G, S, D, splits, chunk, 1.0 / math.sqrt(D),
                       build.dtype_code(q), build.stream_handle(q))
    build.check(build.load("decode_attention_quant"), code,
                "decode_attention_quant_fwd")
    build.count_launch(decode_attention_quant_fwd)
    return out


decode_attention_quant_fwd.launches = 0   # calls that ran the kernels, since
                                          # the reset (1 or 2 CUDA kernels)
