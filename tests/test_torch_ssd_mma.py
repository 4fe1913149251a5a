"""The bf16 SSD intra-chunk kernel (``csrc/ssd_intra.cu``,
``ssd_intra_mma_kernel``) on the CPU.

* The host's plan (``ssd_scan.ssd_plan``): its Y blocks cover every
  (head, query row) once, two heads a block sharing the block's scores,
  and its state blocks every (head, column of S_c) once, for any q (the
  blocks stream the keys, so nothing grows with q); and at the Mamba2-370M and Zamba2-1.2B admissions the grid spreads over
  most of the H100's 132 SMs.
* A plain torch model of the kernel's numerics, kept here and nowhere on
  the main path: C . B^T from the bf16 values with fp32 sums, the decays
  selected below the diagonal, and W and x dt decay each split into a bf16
  hi + lo pair whose two products are summed in fp32.  At the reduced
  shapes of ``tests/test_torch_ssm.py`` it is held to the port's plain
  version and to the reference's oracle and Pallas kernel (interpret mode)
  on the same bf16-valued inputs: Y and S_c to 1e-4 of their max, A_cs
  bitwise.  The split keeps ~16 significant bits (what hi leaves is below
  2^-9 of the value, and lo rounds it to 2^-9 of itself, so hi + lo is
  within 2^-18), so the model lands within ~1e-5 of the fp32 result; one
  bf16 rounding (2^-9) would not meet 1e-4, and the test shows it.  The
  overflow case (exp above the diagonal overflows) stays finite.  Inputs
  are made with numpy from a seed."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_intra_fwd as j_ssd_intra_fwd
from repro_torch.kernels import ref
from repro_torch.kernels.ssd_scan import HEADS, TILE, ssd_plan, state_width

SMS = 132                              # the H100's streaming multiprocessors
SSD_SHAPES = [(2, 3, 16, 4, 8, 16), (1, 2, 32, 2, 16, 8),
              (1, 4, 64, 8, 32, 32), (1, 2, 37, 3, 16, 16),
              (2, 1, 1, 4, 8, 16)]    # tests/test_torch_ssm.py's
TOL = 1e-4                             # of max |ref|, Y and S_c


# ------------------------------------------------------------------ #
# the host's plan
# ------------------------------------------------------------------ #
def _check_plan(q, h, n):
    pl = ssd_plan(q, h, n)
    assert pl.n_qtiles == -(-q // TILE) and pl.n_pairs == -(-h // HEADS)
    # Y blocks as the kernel decodes blockIdx.x: (query tile, head pair)
    rows = np.zeros((h, pl.n_qtiles * TILE), int)
    for bx in range(pl.y_blocks):
        qt = pl.n_qtiles - 1 - bx // pl.n_pairs
        head0 = (bx % pl.n_pairs) * HEADS
        assert head0 < h
        rows[head0:head0 + HEADS, qt * TILE:(qt + 1) * TILE] += 1
    assert (rows == 1).all()
    # state blocks: (head pair, slice of state_width(n) columns)
    cols = np.zeros((h, n), int)
    for sb in range(pl.s_blocks):
        pair, sl = divmod(sb, pl.n_slices)
        w = state_width(n)
        cols[pair * HEADS:(pair + 1) * HEADS, sl * w:(sl + 1) * w] += 1
    assert (cols == 1).all()
    return pl


@pytest.mark.parametrize("n", [32, 64, 128])
def test_plan_covers_every_head_and_row_once(n):
    for q in (1, 37, 63, 64, 65, 137, 256, 600, 1024, 20_000):
        for h in (1, 3, 5, 32, 64):
            _check_plan(q, h, n)


def test_plan_spreads_the_admissions_over_the_card():
    """Mamba2-370M (h 32, p 64, n 128) and Zamba2-1.2B (h 64, p 64, n 64)
    at a 256-token admission: a block for most of the SMs (one block an
    SM: 8 warps and the ring take its registers and shared memory), every
    Y block sharing its scores between two heads."""
    for h, n in ((32, 128), (64, 64)):
        pl = _check_plan(256, h, n)
        assert 0.7 * SMS <= pl.y_blocks + pl.s_blocks <= 2 * SMS
    assert HEADS == 2


# ------------------------------------------------------------------ #
# a plain model of the kernel's numerics
# ------------------------------------------------------------------ #
def _split(v):
    hi = v.to(torch.bfloat16).float()
    return hi, (v - hi).to(torch.bfloat16).float()


def mma_model(X, dt, A, B, C, *, split=True):
    """The bf16 kernel's arithmetic in plain torch, fp32 out: X, B, C hold
    bf16 values (any float dtype); dt, A fp32.  ``split=False`` rounds W
    and x dt decay to bf16 once instead (what the kernel must not do)."""
    X, B, C = (t.to(torch.bfloat16).float() for t in (X, B, C))
    q = X.shape[2]
    a_cs = ref.chunk_cumsum((dt * A).permute(0, 1, 3, 2))   # (b,nc,h,q)
    scores = torch.einsum("bcin,bcjn->bcij", C, B)          # exact products
    tri = torch.ones((q, q), dtype=torch.bool).tril()
    d = a_cs[..., :, None] - a_cs[..., None, :]
    dtj = dt.permute(0, 1, 3, 2)[..., None, :]              # (b,nc,h,1,q)
    W = torch.where(tri, scores[:, :, None] * torch.exp(d) * dtj, 0.0)
    u = X * (dt * torch.exp(a_cs[..., -1:] - a_cs).permute(0, 1, 3, 2)
             )[..., None]                                   # (b,nc,q,h,p)
    parts = _split if split else (lambda v: (v.to(torch.bfloat16).float(),
                                             torch.zeros_like(v)))
    Y = sum(torch.einsum("bchij,bcjhp->bcihp", w, X) for w in parts(W))
    S = sum(torch.einsum("bcjhp,bcjn->bchpn", v, B) for v in parts(u))
    return Y, S, a_cs


def _bf16_inputs(b, nc, q, h, p, n, seed=0, dt_scale=1.0):
    """numpy inputs whose X, B, C are bf16 values, held in fp32."""
    rng = np.random.default_rng(seed)
    rb = lambda shape: torch.from_numpy(
        (rng.standard_normal(shape) * 0.5).astype(np.float32)).to(
        torch.bfloat16).float().numpy()
    X, B, C = rb((b, nc, q, h, p)), rb((b, nc, q, n)), rb((b, nc, q, n))
    dt = (np.log1p(np.exp(rng.standard_normal((b, nc, q, h))))
          * dt_scale).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    return X, dt, A, B, C


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.mark.parametrize("against", ["plain", "oracle", "pallas"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_mma_numerics_match_the_reference(shape, against):
    X, dt, A, B, C = _bf16_inputs(*shape)
    t = [torch.from_numpy(a) for a in (X, dt, A, B, C)]
    y, s, a_cs = mma_model(*t)
    if against == "plain":
        yr, sr, _, acsr = ref.ssd_intra_ref(*t)
    elif against == "oracle":
        yr, sr, _, acsr = jref.ssd_intra_ref(*[jnp.asarray(a) for a in
                                               (X, dt, A, B, C)])
    else:
        yr, sr, acsr = j_ssd_intra_fwd(*[jnp.asarray(a) for a in
                                         (X, dt, A, B, C)], interpret=True)
    assert _rel(y, yr) <= TOL and _rel(s, sr) <= TOL
    if against == "plain":
        assert torch.equal(a_cs, acsr)          # the same rounded fp64 scan
    else:
        assert _rel(a_cs, acsr) <= 1e-5


def test_one_bf16_rounding_would_miss_the_gate():
    """W and x dt decay rounded to bf16 once (no lo half) land ~1e-3 off:
    the hi + lo split is what meets 1e-4."""
    X, dt, A, B, C = [torch.from_numpy(a) for a in
                      _bf16_inputs(1, 2, 64, 8, 32, 32, seed=7)]
    yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
    y1, s1, _ = mma_model(X, dt, A, B, C, split=False)
    y2, s2, _ = mma_model(X, dt, A, B, C)
    assert _rel(s1, sr) > 3 * TOL and _rel(y1, yr) > 3 * TOL
    assert _rel(s2, sr) <= TOL / 3 and _rel(y2, yr) <= TOL / 3


def test_mma_numerics_stay_finite_when_the_upper_triangle_overflows():
    X, dt, A, B, C = [torch.from_numpy(a) for a in
                      _bf16_inputs(1, 1, 64, 4, 8, 16, seed=5,
                                   dt_scale=100.0)]
    y, s, a_cs = mma_model(X, dt, A, B, C)
    assert float((a_cs[..., 0] - a_cs[..., -1]).min()) > 89.0
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
    assert _rel(y, yr) <= TOL and _rel(s, sr) <= TOL
