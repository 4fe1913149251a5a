"""The port's CUDA kernels against their plain versions, and the serving
and training paths on the card against the same paths on the CPU or the
plain path.  Needs an NVIDIA GPU
with nvcc (Hopper, sm_90a): marked ``cuda`` and skipped without one.  Run
on the card with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

fp32 with TF32 off: kernel vs plain at 1e-4 (another summation order);
bf16 attention at 2e-2 (about one bf16 ulp of outputs of magnitude 2-4)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref
from repro_torch.kernels.decode_attention import (decode_attention_fwd,
                                                  decode_attention_quant_fwd)
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,S,D", [(2, 1, 37, 64), (3, 3, 100, 64),
                                      (1, 8, 64, 32), (2, 2, 45, 128),
                                      (32, 1, 512, 64)])
def test_decode_quant_kernel_reads_int8_arena_in_place(cuda, KV, G, S, D,
                                                       dtype):
    """The int8 decode kernel over a (B, S, KV, D) int8 arena and its
    (B, S, KV) scale planes, read in place, against its plain version:
    fp32 1e-4, bf16 2e-2 of max |plain|."""
    from repro_torch.models.modules import _kv_quant
    B = 3
    q = _randn(cuda, (B, KV * G, D), dtype)
    k, ks = _kv_quant(_randn(cuda, (B, S, KV, D), dtype))
    v, vs = _kv_quant(_randn(cuda, (B, S, KV, D), dtype))
    nv = torch.tensor([0, S // 2, S], device="cuda")
    valid = torch.arange(S, device="cuda")[None] < nv[:, None]
    before = decode_attention_quant_fwd.launches
    got = ops.decode_attention_quant(q, k, v, ks, vs, valid)
    torch.cuda.synchronize()
    assert decode_attention_quant_fwd.launches == before + 1
    want = ref.decode_attention_quant_ref(
        q.unflatten(1, (KV, G)), k.transpose(1, 2), v.transpose(1, 2),
        ks.transpose(1, 2), vs.transpose(1, 2), valid).reshape(got.shape)
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= TOL[dtype] * scale
    # the fully masked row is the mean of the dequantized V, not NaN
    mean_v = (v[0].float() * vs[0][..., None]).mean(0)
    assert (got[0].float() - mean_v.repeat_interleave(G, 0)).abs().max() \
        <= TOL[dtype] * scale


def test_kernels_raise_instead_of_falling_back(cuda):
    q = torch.randn(1, 2, 9, 64, device="cuda")          # G = 9 > 8
    k = torch.randn(1, 2, 16, 64, device="cuda")
    with pytest.raises(ValueError):
        decode_attention_fwd(q, k, k, torch.ones(1, 16, dtype=torch.bool,
                                                 device="cuda"))
    i8 = torch.zeros(1, 2, 16, 64, dtype=torch.int8, device="cuda")
    sc = torch.ones(1, 2, 16, device="cuda")
    with pytest.raises(ValueError):
        decode_attention_quant_fwd(q, i8, i8, sc, sc, torch.ones(
            1, 16, dtype=torch.bool, device="cuda"))
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
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("rmsnorm", "flash_attention_fwd",
                                       "decode_attention_fwd"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,Lq,Lk,window,D", [
    (2, 1, 37, 37, None, 64), (3, 3, 50, 50, 17, 64),
    (2, 3, 13, 70, None, 32), (1, 2, 33, 33, None, 128),
    (2, 1, 130, 130, 40, 64)])
def test_flash_lse_kernel_matches_plain(cuda, KV, G, Lq, Lk, window, D,
                                        dtype):
    q = _randn(cuda, (2, KV, G, Lq, D), dtype)
    k = _randn(cuda, (2, KV, Lk, D), dtype)
    lse = torch.empty((2, KV, G, Lq), device="cuda")
    flash_attention_fwd(q, k, k, window=window, lse=lse)
    want = ref.flash_attention_lse_ref(q, k, window=window)
    assert (lse - want).abs().max() <= 1e-4


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,Lq,Lk,window,D", [
    (2, 1, 37, 37, None, 64), (3, 3, 50, 50, 17, 64),
    (2, 3, 13, 70, None, 32), (1, 2, 33, 33, None, 128),
    (2, 1, 130, 130, 40, 64), (1, 4, 100, 300, None, 64)])
def test_flash_bwd_kernel_matches_plain(cuda, KV, G, Lq, Lk, window, D,
                                        dtype):
    """Through ``ops.FlashAttention`` in the model layout (strided views,
    a non-contiguous dO): dq, dk, dv against the plain backward fed the
    same lse and delta, relative to max |ref|."""
    B = 2
    q = _randn(cuda, (B, Lq, KV * G, D), dtype).requires_grad_()
    k = _randn(cuda, (B, Lk, KV, D), dtype).requires_grad_()
    v = _randn(cuda, (B, Lk, KV, D), dtype).requires_grad_()
    dout = _randn(cuda, (B, KV * G, Lq, D), dtype).transpose(1, 2)
    before = flash_attention_bwd.launches
    out = ops.FlashAttention.apply(q, k, v, True, window)
    out.backward(dout)
    assert flash_attention_bwd.launches == before + 2
    q5 = q.detach().unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    k4, v4 = k.detach().transpose(1, 2), v.detach().transpose(1, 2)
    do5 = dout.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    o5 = out.detach().unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    lse = ref.flash_attention_lse_ref(q5, k4, window=window)
    delta = (do5.float() * o5.float()).sum(-1)
    wq, wk, wv = ref.flash_attention_bwd_ref(q5, k4, v4, do5, lse, delta,
                                             window=window)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    for got, want in ((q.grad.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4),
                       wq), (k.grad.transpose(1, 2), wk),
                      (v.grad.transpose(1, 2), wv)):
        scale = want.float().abs().max().clamp(min=1e-6)
        assert (got.float() - want.float()).abs().max() / scale <= tol


def test_train_step_on_the_card_matches_the_plain_path(cuda):
    """One reduced OPT-1.3B LM step in fp32: the kernel path (RMSNorm and
    flash forward/backward kernels) against the plain path on the card,
    and against the CPU; every training kernel launched."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import lm_data, to_device
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.training.steps import lm_value_and_grad

    cfg = reduced(get_config("opt-1.3b")).replace(remat=True,
                                                  logit_chunk=16)
    params = T.init_params(cfg, torch.Generator().manual_seed(7))
    batch = next(lm_data(cfg, 40, 0).sft_batches(4, 1))
    runs = {}
    ops.reset_launch_counts()
    for name, dev, uk in (("kernels", "cuda", True), ("plain", "cuda", False),
                          ("cpu", "cpu", True)):
        (loss, _), grads = lm_value_and_grad(
            cfg.replace(use_kernels=uk), tree_map(lambda t: t.to(dev),
                                                  params),
            to_device(batch, dev))
        runs[name] = (float(loss), [g.cpu() for g in tree_leaves(grads)])
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("rmsnorm", "flash_attention_fwd",
                                       "flash_attention_bwd"))
    ref_loss, ref_grads = runs["kernels"]
    for name in ("plain", "cpu"):
        loss, grads = runs[name]
        assert abs(loss - ref_loss) <= 1e-5 * abs(ref_loss)
        for a, b in zip(ref_grads, grads):
            assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp(min=1e-9)


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16kv", "int8kv"])
def test_ppo_iteration_on_the_card_matches_the_cpu(cuda, kv_quant):
    """One greedy PPO iteration (generate, score, actor + critic steps,
    EMA) at the reduced OPT-1.3B actor / smollm-135m critic in fp32: the
    card (kernels) and the CPU (plain versions) give the same tokens and
    the same experience and metrics to 1e-4; generation launched the
    decode kernel of its cache's dtype and only that one."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.ppo import PPOConfig, PPOTrainer
    from repro_torch.models import reward as R
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map

    actor = reduced(get_config("opt-1.3b"))
    critic = reduced(get_config("smollm-135m"))
    g = torch.Generator().manual_seed(5)
    weights = [T.init_params(actor, g), T.init_params(actor, g),
               R.init_params(critic, g), R.init_params(critic, g)]
    prompts = torch.randint(0, actor.vocab_size, (3, 9), generator=g)
    ppo = PPOConfig(max_new_tokens=7, temperature=0.0, ptx_coef=0.0,
                    kv_quant=kv_quant)
    runs = {}
    for dev in ("cpu", "cuda"):
        # copies: the trainer updates the actor and critic in place
        w = [tree_map(lambda t: t.to(dev, copy=True), x) for x in weights]
        trainer = PPOTrainer(actor_cfg=actor, critic_cfg=critic,
                             actor_params=w[0], ref_params=w[1],
                             critic_params=w[2], reward_params=w[3], ppo=ppo)
        ops.reset_launch_counts()
        exp, gm = trainer.generate_experience(
            prompts, torch.Generator(device=dev).manual_seed(0))
        counts = ops.launch_counts()
        tm = trainer.train_rlhf(exp)
        runs[dev] = (exp, {**gm, **tm}, counts)
    (ce, cm, _), (ge, gm, counts) = runs["cpu"], runs["cuda"]
    assert torch.equal(ce.sequences, ge.sequences.cpu())
    for a, b in zip(ge, ce):
        assert (a.cpu().float() - b.float()).abs().max() \
            <= 1e-4 * max(1.0, float(b.float().abs().max()))
    for k in ("reward_score", "pg_loss", "ratio_mean", "approx_kl",
              "v_loss", "actor_gnorm", "critic_gnorm"):
        assert abs(gm[k] - cm[k]) <= 1e-4 * max(1.0, abs(cm[k])), k
    used, unused = (("decode_attention_quant_fwd", "decode_attention_fwd")
                    if kv_quant else
                    ("decode_attention_fwd", "decode_attention_quant_fwd"))
    assert counts[used] > 0 and counts[unused] == 0
