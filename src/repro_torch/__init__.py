"""PyTorch/CUDA port of the ``repro`` package (DeepSpeed-Chat reproduction).

The port mirrors ``repro``'s layout module by module
(``repro_torch/models/modules.py`` is the counterpart of
``repro/models/modules.py``) and imports only ``torch``, ``numpy`` and the
standard library.  Plain tensor code is PyTorch; every Pallas TPU kernel on
a ported path is a CUDA C++ kernel for Hopper (``sm_90a``) under
``repro_torch/kernels/csrc``, with a plain PyTorch version beside it.

Entry points run on CUDA unless the caller asks for the CPU, where every
kernel wrapper takes its plain version.  There is no silent fallback: a
CUDA run without a card raises.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None``/``"cuda"`` -> the current CUDA device (raises without one);
    ``"cpu"`` -> the CPU.  Anything else raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' (--device cpu) "
                "to run on the CPU with the kernels' plain versions")
        return dev if dev.index is not None else torch.device(
            "cuda", torch.cuda.current_device())
    if dev.type == "cpu":
        return dev
    raise ValueError(f"unsupported device {device!r}: use 'cuda' or 'cpu'")


def to_device(batch: dict, device) -> dict:
    """A batch of numpy arrays as tensors on ``device`` (token ids and
    other integers as int64)."""
    out = {}
    for k, v in batch.items():
        t = torch.from_numpy(v)
        if not torch.is_floating_point(t):
            t = t.long()
        out[k] = t.to(device, non_blocking=True)
    return out


def stream_event(device: torch.device):
    """A CUDA event recorded on the calling thread's current stream of
    ``device`` (``None`` on the CPU, whose work is done on return).  Its
    ``synchronize()`` waits for the work enqueued so far on that stream
    only: with asynchronous RLHF's producer and consumer on two threads, a
    device-wide synchronize would wait for both."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record(torch.cuda.current_stream(device))
    return ev


__all__ = ["resolve_device", "stream_event", "to_device"]
