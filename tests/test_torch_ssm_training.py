"""The port's SSM / hybrid training slice against the reference, on the CPU
(part 1 of 3): the SSD pass under autograd (the intra-chunk kernel's plain
version forward, the explicit backward ``ref.ssd_intra_bwd_ref``) against
``jax.grad`` of the reference's jnp ``ssd_chunked`` and against autograd
of the plain forward; ``lm_train_step`` at the reduced Mamba2-370M,
Zamba2-1.2B and a two-segment hybrid, on the port's plain path and its
kernel path, against the reference's jnp path (``use_pallas=False``, the
path it trains SSM models on); remat.  The reward and PPO steps are
``test_torch_ssm_reward_ppo.py``, the pipeline, the launcher and int8 KV
``test_torch_ssm_rlhf.py`` (three files, so that a parallel test run
spreads them over its workers).  Same weights (carried across through
numpy), same numpy-seeded inputs, fp32.

Tolerances: SSD gradients to 1e-4 of each one's max |grad| (2e-2 with bf16
inputs); train steps at ``STEP_TOL`` (``test_torch_training.py``'s: loss,
grad norm and the new params at rtol/atol 1e-4, every grad leaf to 1e-4 of
its max |grad|); remat bit-for-bit equal losses and grads.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.data import CopyTaskDataset as JCopy, DataBlender as JBlender
from repro.data import SortTaskDataset as JSort
from repro.models import modules as JM
from repro.training import steps as jsteps
from repro.training.train_state import TrainState as JTrainState
from repro_torch.kernels import ops, ref
from repro_torch.launch import train as tlaunch
from repro_torch.models import modules as TM
from repro_torch.training import steps as tsteps

from _torch_parity import (SSM_TRAIN_ARCHS, STEP_TOL, assert_grads_close,
                           assert_params_moved_alike, close_rel, params_pair,
                           ssm_pair, state_pair)

LR = 1e-3


def _batch_j(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _batch_t(batch):
    return tlaunch.to_device(batch, "cpu")


# ------------------------------------------------------------------ #
# the SSD pass under autograd
# ------------------------------------------------------------------ #
def _scan_inputs(seed, b, L, h, p, n, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    arrs = [(rng.standard_normal((b, L, h, p)) * 0.5).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, L, h)))).astype(
                np.float32) * np.float32(dt_scale),
            (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32),
            (rng.standard_normal((b, L, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, L, n)) * 0.5).astype(np.float32)]
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    wy = rng.standard_normal((b, L, h, p)).astype(np.float32)
    wf = rng.standard_normal((b, h, p, n)).astype(np.float32)
    return arrs, s0, wy, wf


def _scan_grads(arrs, s0, wy, wf, chunk, bf16=False):
    """Gradients of sum(Y wy) + sum(final wf) w.r.t. X, dt, A, B, C (and
    the initial state, when given) through ``ops.ssd_scan`` and through
    the reference's jnp ``ssd_chunked``; X, B and C in bf16 if asked."""
    t = [torch.from_numpy(a) for a in arrs]
    j = [jnp.asarray(a) for a in arrs]
    if bf16:
        for i in (0, 3, 4):
            t[i] = t[i].to(torch.bfloat16)
            j[i] = j[i].astype(jnp.bfloat16)
    t = [x.requires_grad_() for x in t]
    ts0 = None if s0 is None else torch.from_numpy(s0).requires_grad_()
    y, f = ops.ssd_scan(*t, chunk, ts0)
    ((y.float() * torch.from_numpy(wy)).sum()
     + (f * torch.from_numpy(wf)).sum()).backward()
    got = [x.grad for x in t] + ([] if ts0 is None else [ts0.grad])

    def jloss(*a):
        yy, ff = JM.ssd_chunked(*a[:5], chunk,
                                None if s0 is None else a[5])
        return (yy.astype(jnp.float32) * wy).sum() + (ff * wf).sum()

    extra = [] if s0 is None else [jnp.asarray(s0)]
    want = jax.grad(jloss, argnums=tuple(range(5 + len(extra))))(*j, *extra)
    return got, want


@pytest.mark.parametrize("L,init", [(48, False), (45, True), (7, True)],
                         ids=["two-chunks", "ragged+s0", "short+s0"])
def test_ssd_scan_grads_match_jax(L, init):
    """Through ``SSDIntra``: the ragged L pads the last chunk, and the
    initial state's gradient comes from the inter-chunk recurrence."""
    arrs, s0, wy, wf = _scan_inputs(L, 2, L, 4, 8, 16)
    got, want = _scan_grads(arrs, s0 if init else None, wy, wf, chunk=16)
    assert len(got) == len(want) == 5 + init
    for g, w in zip(got, want):
        close_rel(g, w, 1e-4)


def test_ssd_scan_grads_bf16_inputs():
    """bf16 X, B, C with fp32 dt and A (the model's bf16 training): the
    gradients in the inputs' dtypes, to 2e-2 of each max |grad|."""
    arrs, s0, wy, wf = _scan_inputs(3, 1, 40, 4, 16, 16)
    got, want = _scan_grads(arrs, s0, wy, wf, chunk=16, bf16=True)
    assert [g.dtype for g in got[:5]] == [torch.bfloat16, torch.float32,
                                          torch.float32, torch.bfloat16,
                                          torch.bfloat16]
    for g, w in zip(got, want):
        close_rel(g.float(), np.asarray(w, np.float32), 2e-2)


def test_ssd_intra_bwd_overflowing_upper_triangle_gives_no_nan():
    """The backward twin of ``test_ssd_intra_overflowing_upper_triangle_
    gives_no_nan``: dt |A| large, so exp of the upper triangle's positive
    segment sums overflows (dt scaled by 4, not 100: the A_cs span is
    ~160, and dA, a sum of products with dt, stays well conditioned; at
    100 both fp32 paths land ~7% from an fp64 evaluation).  The explicit
    backward selects it away: its gradients are finite and equal the
    reference's through ``ops.ssd_scan``, and autograd of the plain
    forward's directly."""
    arrs, _, wy, wf = _scan_inputs(5, 1, 64, 4, 8, 16, dt_scale=4.0)
    got, want = _scan_grads(arrs, None, wy, wf, chunk=64)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        close_rel(g, w, 1e-4)
    X, dt, A, B, C = [torch.from_numpy(a) for a in arrs]
    Xc, dtc, Bc, Cc = ref.ssd_chunks(X, dt, B, C, 64)
    leaves = [t.clone().requires_grad_() for t in (Xc, dtc, A, Bc, Cc)]
    y, s, _, acs = ref.ssd_intra_ref(*leaves)
    span = acs.detach()[..., 0] - acs.detach()[..., -1]
    assert float(span.min()) > 89.0                  # exp overflows
    want = torch.autograd.grad(y.sum() + s.sum(), leaves)
    got = ref.ssd_intra_bwd_ref(Xc, dtc, A, Bc, Cc, acs.detach(),
                                torch.ones_like(y), torch.ones_like(s),
                                torch.zeros_like(acs))
    for g, w in zip(got, want):
        assert torch.isfinite(w).all()
        close_rel(g, w.numpy(), 1e-4)


SSD_SHAPES = [(2, 3, 16, 4, 8, 16), (1, 2, 37, 3, 16, 8), (2, 1, 1, 4, 8, 16)]


@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_bwd_matches_autograd_of_the_plain_forward(shape):
    """The explicit backward against autograd of ``ssd_intra_ref``, for
    cotangents on all three outputs."""
    b, nc, q, h, p, n = shape
    g = torch.Generator().manual_seed(q)
    X = torch.randn((b, nc, q, h, p), generator=g) * 0.5
    dt = torch.nn.functional.softplus(torch.randn((b, nc, q, h), generator=g))
    A = -torch.exp(torch.randn((h,), generator=g) * 0.3)
    B, C = torch.randn((2, b, nc, q, n), generator=g) * 0.5
    leaves = [t.clone().requires_grad_() for t in (X, dt, A, B, C)]
    y, s, _, acs = ref.ssd_intra_ref(*leaves)
    dY, dS, dAcs = (torch.randn(t.shape, generator=g) for t in (y, s, acs))
    want = torch.autograd.grad((y * dY).sum() + (s * dS).sum()
                               + (acs * dAcs).sum(), leaves)
    got = ref.ssd_intra_bwd_ref(X, dt, A, B, C, acs.detach(), dY, dS, dAcs)
    for a, w in zip(got, want):
        assert a.shape == w.shape and a.dtype == w.dtype
        close_rel(a, w.numpy(), 1e-5)


# ------------------------------------------------------------------ #
# train steps
# ------------------------------------------------------------------ #
def _sft_batch(seed, B, half=20):
    """Sequences of 40 tokens: past the reduced ssm_chunk (32), so the
    SSD pass runs two chunks, the last one padded."""
    ds = [JCopy(100, half, half, 256, seed=1),
          JSort(100, half, half, 256, seed=2)]
    return next(JBlender(ds, seed=seed).sft_batches(B, 1))


@functools.lru_cache(maxsize=None)
def _jax_lm_grad_fn(arch):
    jcfg, _ = ssm_pair(arch)
    return jax.jit(jax.value_and_grad(
        lambda p, b: jsteps.lm_loss_fn(jcfg, p, b), has_aux=True))


@functools.lru_cache(maxsize=None)
def _jax_apply_fn():
    return jax.jit(lambda s, g: s.apply_gradients(g, lr=LR))


@functools.lru_cache(maxsize=None)
def _jax_lm_step(arch, micro):
    """The reference's LM step from one state on one batch: loss, grads
    (the micro average), grad norm and the new state.  Every micro slice
    has 2 rows, so one compile serves micro 1 and 2."""
    jcfg, _ = ssm_pair(arch)
    jparams, _ = params_pair(jcfg, seed=1)
    batch = _sft_batch(seed=micro, B=2 * micro)
    fn = _jax_lm_grad_fn(arch)
    outs = [fn(jparams, _batch_j({k: v[2 * i:2 * i + 2]
                                  for k, v in batch.items()}))
            for i in range(micro)]
    loss = float(np.mean([float(o[0][0]) for o in outs]))
    grads = jax.tree.map(lambda *g: sum(g) / micro, *[o[1] for o in outs])
    jstate2, gnorm = _jax_apply_fn()(JTrainState.create(jparams), grads)
    return jparams, batch, loss, grads, float(gnorm), jstate2


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("micro", [1, 2])
@pytest.mark.parametrize("arch", SSM_TRAIN_ARCHS)
def test_lm_train_step_matches_reference(arch, micro, use_kernels):
    """The port's grads, loss, grad norm and new params against the
    reference's ``lm_loss_fn`` gradients and ``apply_gradients`` (the body
    of its ``lm_train_step``)."""
    jparams, batch, jl, jg, jgn, jstate2 = _jax_lm_step(arch, micro)
    _, tcfg = ssm_pair(arch, use_kernels=use_kernels)
    _, tstate = state_pair(jparams)
    (tl, _), tg = tsteps.lm_value_and_grad(tcfg, tstate.params,
                                           _batch_t(batch), micro)
    assert_grads_close(tg, jg)
    np.testing.assert_allclose(float(tl), jl, **STEP_TOL)
    tstate2, tm = tsteps.lm_train_step(tcfg, tstate, _batch_t(batch), LR,
                                       micro=micro)
    np.testing.assert_allclose(float(tm["loss"]), jl, **STEP_TOL)
    np.testing.assert_allclose(float(tm["grad_norm"]), jgn, **STEP_TOL)
    assert int(tstate2.step) == int(jstate2.step) == 1
    assert_params_moved_alike(tstate2.params, jstate2.params, jg, LR)


def test_composed_reference_step_is_the_reference_lm_train_step():
    """The composition above (grads per micro slice, averaged, then
    ``apply_gradients``) is the reference's jitted ``lm_train_step``."""
    jparams, batch, jl, _, jgn, jstate2 = _jax_lm_step("mamba2-370m", 2)
    jcfg, _ = ssm_pair("mamba2-370m")
    s, m = jax.jit(lambda s, b: jsteps.lm_train_step(jcfg, s, b, LR,
                                                     micro=2))(
        JTrainState.create(jparams), _batch_j(batch))
    np.testing.assert_allclose(float(m["loss"]), jl, rtol=1e-6)
    np.testing.assert_allclose(float(m["grad_norm"]), jgn, rtol=1e-6)
    for a, b in zip(jax.tree.leaves(s.params),
                    jax.tree.leaves(jstate2.params)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=1e-7)


@pytest.mark.parametrize("arch", SSM_TRAIN_ARCHS)
def test_remat_gives_the_same_grads(arch):
    """Checkpointing each layer (the SSD pass recomputed in the backward)
    gives the same loss and grads, bit for bit, on the kernel path."""
    jcfg, tcfg = ssm_pair(arch, use_kernels=True)
    _, tparams = params_pair(jcfg, seed=2)
    batch = _batch_t(_sft_batch(seed=0, B=2))
    got = [tsteps.lm_value_and_grad(tcfg.replace(remat=r), tparams, batch)
           for r in (False, True)]
    assert float(got[0][0][0]) == float(got[1][0][0])
    for a, b in zip(TM.tree_leaves(got[0][1]), TM.tree_leaves(got[1][1])):
        assert torch.equal(a, b)
