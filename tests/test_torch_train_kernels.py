"""The training path's kernels on CPU tensors (their plain versions)
against the reference: the flash backward against the Pallas backward run
in interpret mode, the differentiable attention against the reference's
``ops.flash_attention_grouped`` custom VJP, the forward's LSE against the
reference's ``_flash_fwd_impl``, the model's plain attention against the
reference's ``_flash`` custom VJP, and RMSNorm's backward against JAX
autodiff.  fp32, atol = rtol = 1e-5: the same math, summed in another
order.  Shapes cover GQA groups of 1 to 4, rectangular (Lq < Lk) causal
attention, sliding windows and lengths that no block divides."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels.flash_attention_bwd import flash_attention_bwd as j_bwd
from repro.models import modules as JM
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
from repro_torch.models import modules as TM

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def _t(*arrays):
    return [torch.from_numpy(a) for a in arrays]


# B, KV, G, Lq, Lk, D, causal, window, q_block, k_block (the reference's
# blocks divide its lengths; the port's kernels need no such thing)
BWD_CASES = [
    (2, 2, 1, 32, 32, 32, True, None, 16, 16),
    (1, 2, 3, 48, 48, 32, True, 20, 16, 16),
    (1, 2, 2, 16, 48, 32, True, None, 16, 16),     # rectangular: offset 32
    (2, 1, 4, 32, 64, 64, True, 24, 16, 32),       # rectangular + window
    (1, 1, 2, 32, 32, 32, False, None, 32, 16),
]


def _bwd_inputs(B, KV, G, Lq, Lk, D, causal, window, seed):
    rng = np.random.default_rng(seed)
    q, do = _normal(rng, (B, KV, G, Lq, D)), _normal(rng, (B, KV, G, Lq, D))
    k, v = _normal(rng, (B, KV, Lk, D)), _normal(rng, (B, KV, Lk, D))
    tq, tk, tv, tdo = _t(q, k, v, do)
    out = ref.flash_attention_ref(tq, tk, tv, causal=causal, window=window)
    lse = ref.flash_attention_lse_ref(tq, tk, causal=causal, window=window)
    delta = (tdo * out).sum(-1)
    return q, k, v, do, lse.numpy(), delta.numpy()


@pytest.mark.parametrize("B,KV,G,Lq,Lk,D,causal,window,qb,kb", BWD_CASES)
def test_flash_bwd_plain_matches_pallas_interpret(B, KV, G, Lq, Lk, D,
                                                  causal, window, qb, kb):
    q, k, v, do, lse, delta = _bwd_inputs(B, KV, G, Lq, Lk, D, causal,
                                          window, seed=Lq * 7 + Lk)
    got = flash_attention_bwd(*_t(q, k, v, do, lse, delta), causal=causal,
                              window=window)
    want = j_bwd(*(jnp.asarray(a) for a in (q, k, v, do, lse, delta)),
                 causal=causal, window=window, q_block=qb, k_block=kb,
                 interpret=True)
    for name, a, b in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL,
                                   err_msg=name)


def test_flash_bwd_masks_an_all_masked_row_to_zero():
    """A row whose lse is the finite mask value takes lse = 0 and gets no
    gradient (the reference's ``lse_safe``), and rows keep exact zeros
    where the mask removes every key of a pair."""
    q, k, v, do, lse, delta = _bwd_inputs(1, 1, 2, 8, 8, 32, True, None, 3)
    lse[0, 0, 1, 5] = -1e30
    got = flash_attention_bwd(*_t(q, k, v, do, lse, delta))
    want = j_bwd(*(jnp.asarray(a) for a in (q, k, v, do, lse, delta)),
                 q_block=8, k_block=8, interpret=True)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize("B,KV,G,Lq,Lk,window", [
    (2, 2, 1, 24, 24, None), (1, 2, 3, 40, 40, 9), (2, 1, 3, 12, 40, None),
    (1, 3, 2, 20, 44, 13)])
def test_forward_lse_matches_reference(B, KV, G, Lq, Lk, window):
    rng = np.random.default_rng(Lq + Lk)
    D = 32
    q = _normal(rng, (B, KV, G, Lq, D))
    k, v = _normal(rng, (B, KV, Lk, D)), _normal(rng, (B, KV, Lk, D))
    lse = torch.empty((B, KV, G, Lq))
    out = flash_attention_fwd(*_t(q, k, v), window=window, lse=lse)
    # the reference's jnp pass that recovers the LSE (model layout)
    qm = np.moveaxis(q, 3, 1).reshape(B, Lq, KV * G, D)
    j_out, j_lse = JM._flash_fwd_impl(
        (True, window, 8, 16, Lk - Lq), jnp.asarray(qm),
        jnp.asarray(np.moveaxis(k, 2, 1)), jnp.asarray(np.moveaxis(v, 2, 1)))
    np.testing.assert_allclose(lse.numpy(), np.asarray(j_lse), **TOL)
    np.testing.assert_allclose(
        out.permute(0, 3, 1, 2, 4).reshape(B, Lq, KV * G, D).numpy(),
        np.asarray(j_out), **TOL)


@pytest.mark.parametrize("B,KV,G,Lq,Lk,window", [
    (2, 2, 2, 32, 32, None), (1, 2, 3, 24, 40, None), (1, 1, 4, 48, 48, 16),
    (2, 3, 1, 20, 20, 7)])
def test_flash_attention_function_grads_match_reference(B, KV, G, Lq, Lk,
                                                        window):
    """``ops.FlashAttention`` (model layout, CPU: plain forward with LSE
    and plain backward) against the reference's Pallas fwd+bwd pair
    through its custom VJP, ``ops.flash_attention_grouped``."""
    rng = np.random.default_rng(B * 100 + Lq + Lk)
    D = 32
    q = _normal(rng, (B, Lq, KV * G, D))
    k, v = _normal(rng, (B, Lk, KV, D)), _normal(rng, (B, Lk, KV, D))
    cot = _normal(rng, (B, Lq, KV * G, D))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = tops.FlashAttention.apply(tq, tk, tv, True, window)
    (out * torch.from_numpy(cot)).sum().backward()

    def j_loss(q, k, v):
        q5 = jnp.moveaxis(q.reshape(B, Lq, KV, G, D), 1, 3)
        o = jops.flash_attention_grouped(q5, jnp.moveaxis(k, 1, 2),
                                         jnp.moveaxis(v, 1, 2), window=window,
                                         q_block=8, k_block=8)
        o = jnp.moveaxis(o, 3, 1).reshape(B, Lq, KV * G, D)
        return (o * cot).sum(), o

    (_, j_out), grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for name, t, g in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=f"d{name}")


@pytest.mark.parametrize("B,KV,G,Lq,Lk,window,qb,kb", [
    (2, 2, 2, 30, 30, None, 8, 16), (1, 2, 3, 20, 45, None, 16, 8),
    (1, 1, 2, 40, 40, 11, 16, 16), (2, 2, 1, 13, 13, None, 512, 1024)])
def test_plain_flash_grads_match_reference_custom_vjp(B, KV, G, Lq, Lk,
                                                      window, qb, kb):
    """The model's plain ``flash_attention`` (its recompute backward)
    against the reference's ``_flash`` custom VJP, ragged last blocks and
    a rectangular causal offset included."""
    rng = np.random.default_rng(Lq * 31 + Lk)
    D = 32
    q = _normal(rng, (B, Lq, KV * G, D))
    k, v = _normal(rng, (B, Lk, KV, D)), _normal(rng, (B, Lk, KV, D))
    cot = _normal(rng, (B, Lq, KV * G, D))
    tq, tk, tv = (t.requires_grad_() for t in _t(q, k, v))
    out = TM.flash_attention(tq, tk, tv, window=window, q_block=qb,
                             k_block=kb, qpos0=Lk - Lq)
    (out * torch.from_numpy(cot)).sum().backward()

    def j_loss(q, k, v):
        o = JM.flash_attention(q, k, v, window=window, q_block=qb,
                               k_block=kb, qpos0=Lk - Lq)
        return (o * cot).sum(), o

    (_, j_out), grads = jax.value_and_grad(j_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(j_out),
                               **TOL)
    for name, t, g in zip("qkv", (tq, tk, tv), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), **TOL,
                                   err_msg=f"d{name}")


def test_plain_flash_keeps_no_score_tiles_for_the_backward():
    """The recompute backward saves q, k, v, out and the LSE only: no
    (q_block, k_block) tile stays alive between forward and backward."""
    q = torch.randn(1, 64, 2, 32, requires_grad=True)
    k = torch.randn(1, 64, 2, 32, requires_grad=True)
    v = torch.randn(1, 64, 2, 32, requires_grad=True)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(
            lambda t: saved.append(tuple(t.shape)) or t, lambda t: t):
        TM.flash_attention(q, k, v, q_block=16, k_block=16)
    assert sorted(saved) == sorted([(1, 64, 2, 32)] * 4 + [(1, 2, 1, 64)])


@pytest.mark.parametrize("shape", [(3, 7, 256), (5, 576)])
def test_rmsnorm_function_grads_match_reference(shape):
    rng = np.random.default_rng(len(shape))
    x, w = _normal(rng, shape), 1 + 0.1 * _normal(rng, shape[-1:])
    cot = _normal(rng, shape)
    tx, tw = (t.requires_grad_() for t in _t(x, w))
    out = tops.rmsnorm(tx, tw, eps=1e-5)
    (out * torch.from_numpy(cot)).sum().backward()
    grads = jax.grad(lambda x, w: (JM.rmsnorm(x, w, 1e-5) * cot).sum(),
                     argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(grads[0]), **TOL)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(grads[1]),
                               rtol=1e-5, atol=1e-4)


def test_bwd_wrapper_checks_its_inputs():
    q = torch.randn(1, 1, 1, 8, 32)
    k = torch.randn(1, 1, 8, 32)
    lse = torch.zeros(1, 1, 1, 8)
    with pytest.raises(ValueError, match="lse and delta"):
        flash_attention_bwd(q, k, k, q, lse.double(), lse)
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_bwd(torch.randn(1, 1, 1, 8, 48),
                            torch.randn(1, 1, 8, 48),
                            torch.randn(1, 1, 8, 48),
                            torch.randn(1, 1, 1, 8, 48), lse, lse)
    with pytest.raises(ValueError, match="Lq"):
        flash_attention_bwd(torch.randn(1, 1, 1, 9, 32),
                            torch.randn(1, 1, 8, 32),
                            torch.randn(1, 1, 8, 32),
                            torch.randn(1, 1, 1, 9, 32),
                            torch.zeros(1, 1, 1, 9), torch.zeros(1, 1, 1, 9))


def test_backward_kernel_is_counted_with_the_others():
    assert "flash_attention_bwd" in tops.launch_counts()
    tops.reset_launch_counts()
    assert set(tops.launch_counts().values()) == {0}
