"""The port's CUDA kernels against their plain versions, and the serving
path on the card against the same path on the CPU.  Needs an NVIDIA GPU
with nvcc (Hopper, sm_90a): marked ``cuda`` and skipped without one.  Run
on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

fp32 with TF32 off: kernel vs plain at 1e-4 (another summation order);
bf16 attention at 2e-2 (about one bf16 ulp of outputs of magnitude 2-4)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator(device="cuda").manual_seed(0)


def _randn(gen, shape, dtype):
    return torch.randn(shape, generator=gen, device="cuda").to(dtype)


TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D", [(1, 32), (7, 576), (33, 2048)])
def test_rmsnorm_kernel_matches_plain(cuda, R, D, dtype):
    x, w = _randn(cuda, (R, D), dtype), _randn(cuda, (D,), dtype)
    before = rmsnorm_fwd.launches
    got = rmsnorm_fwd(x, w)
    assert rmsnorm_fwd.launches == before + 1
    want = ref.rmsnorm_ref(x, w)
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1)).max()
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,Lq,Lk,window,D", [
    (2, 1, 37, 37, None, 64), (3, 3, 50, 50, 17, 64),
    (2, 3, 13, 70, None, 32), (1, 2, 33, 33, None, 128)])
def test_flash_kernel_matches_plain(cuda, KV, G, Lq, Lk, window, D, dtype):
    q = _randn(cuda, (2, Lq, KV * G, D), dtype)
    k, v = _randn(cuda, (2, Lk, KV, D), dtype), _randn(cuda, (2, Lk, KV, D),
                                                         dtype)
    got = ops.flash_attention(q, k, v, causal=True, window=window)
    q5 = q.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    want = ref.flash_attention_ref(q5, k.transpose(1, 2), v.transpose(1, 2),
                                   window=window).permute(0, 3, 1, 2, 4)
    assert (got.float() - want.reshape(got.shape).float()).abs().max() \
        <= TOL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,S,D", [(2, 1, 37, 64), (3, 3, 100, 64),
                                      (1, 8, 64, 32), (2, 2, 45, 128)])
def test_decode_kernel_reads_arena_in_place(cuda, KV, G, S, D, dtype):
    B = 3
    q = _randn(cuda, (B, KV * G, D), dtype)
    k, v = _randn(cuda, (B, S, KV, D), dtype), _randn(cuda, (B, S, KV, D),
                                                        dtype)
    nv = torch.tensor([0, S // 2, S], device="cuda")
    valid = torch.arange(S, device="cuda")[None] < nv[:, None]
    got = ops.decode_attention(q, k, v, valid)
    want = ref.decode_attention_ref(q.unflatten(1, (KV, G)), k.transpose(1, 2),
                                    v.transpose(1, 2), valid)
    assert (got.float() - want.reshape(got.shape).float()).abs().max() \
        <= TOL[dtype]
    # the fully masked row is the mean of V, not NaN
    mean_v = v[0].float().mean(0).repeat_interleave(G, 0)
    assert (got[0].float() - mean_v).abs().max() <= TOL[dtype]


def test_kernels_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 2, 9, 64, device="cuda")          # G = 9 > 8
    k = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(ValueError):
        decode_attention_fwd(q, k, k, torch.ones(1, 16, dtype=torch.bool,
                                                 device="cuda"))
    with pytest.raises(ValueError):
        flash_attention_fwd(torch.randn(1, 1, 1, 4, 48, device="cuda"),
                            torch.randn(1, 1, 4, 48, device="cuda"),
                            torch.randn(1, 1, 4, 48, device="cuda"))


def test_serving_on_the_card_matches_the_cpu(cuda):
    """Greedy continuous batching at the reduced OPT-1.3B config in fp32:
    the card (kernels) and the CPU (plain versions) emit the same tokens,
    and every kernel launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.engine import GenerationEngine, Request

    cfg = reduced(get_config("opt-1.3b"))
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate([(5, 6), (11, 4), (3, 8), (9, 5)])]
    outs = {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        eng = GenerationEngine(cfg, max_new_tokens=8, temperature=0.0,
                               chunk=3, device=dev)
        p = tree_map(lambda t: t.to(dev), params)
        outs[dev] = {c.uid: c.tokens.tolist() for c in eng.serve(
            p, reqs, torch.Generator(device=dev).manual_seed(0), slots=2)}
    assert outs["cpu"] == outs["cuda"]
    assert all(n > 0 for n in ops.launch_counts().values())
