"""Hand-written Hopper kernels for the port's hot spots.

Each TPU kernel of ``repro/kernels`` on a ported path gets a CUDA C++
kernel for ``sm_90a`` under ``csrc/`` (built with ``nvcc`` on first use,
see ``build.py``), a Python wrapper that checks its inputs and launches it,
and a plain PyTorch version in ``ref.py``:

- ``rmsnorm``          — fused normalization (bandwidth-bound)
- ``flash_attention``  — prefill attention, online softmax in registers
- ``decode_attention`` — single-token GQA attention over the dense KV arena,
                         read in place, with bf16/fp32 or int8 K/V
                         (``decode_attention_quant_fwd``)

``ops.py`` adapts the model's layout and dispatches on the tensors' device.
"""
from repro_torch.kernels import ops, ref

__all__ = ["ops", "ref"]
