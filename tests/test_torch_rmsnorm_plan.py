"""The RMSNorm kernel's host-side geometry (``rmsnorm.plan``) on the CPU:
the lane width follows the actual alignment of the pointers, the row
strides and D (16 bytes where they allow it, narrower otherwise, never a
refusal); the threads of a row and their vectors cover the row exactly;
small R spreads a row over up to 256 threads, one load each where the row
allows; large R keeps several (up to 8) vectors in flight a thread and
fills the SMs; rows past
the register tile take the staged kernel.  Every D of the port's configs,
aligned and misaligned."""
import pytest

from repro_torch.configs import get_config, list_archs
from repro_torch.configs.opt_family import OPT_CONFIGS
from repro_torch.kernels.rmsnorm import (MAX_STAGED_BYTES, MAX_THREADS,
                                         MAX_VECS, lane_width, plan)

SMS = 132
CONFIG_DS = sorted({get_config(a).d_model for a in list_archs()}
                   | {c.d_model for c in OPT_CONFIGS.values()})
ESIZES = [(4, 4), (2, 2), (2, 4), (4, 2)]       # x, w element sizes


def _check(R, D, xe, we, **kw):
    p = plan(R, D, xe, we, **kw)
    assert p.vec >= 1 and p.vec * xe <= 16 and D % p.vec == 0
    for key in ("x_ptr", "out_ptr"):
        assert kw.get(key, 0) % (p.vec * xe) == 0
    assert kw.get("w_ptr", 0) % min(16, p.vec * we) == 0
    for key in ("x_stride", "out_stride"):
        assert kw.get(key, 0) % p.vec == 0
    nvec = D // p.vec
    assert p.blocks * p.rows_per_block >= R > (p.blocks - 1) * p.rows_per_block
    if p.tpr == 0:                                  # the staged kernel
        assert nvec > MAX_THREADS * MAX_VECS and p.rows_per_block == 1
        row = -(-D * xe // 16) * 16 + D * we
        assert p.staged_bytes == (row if row <= MAX_STAGED_BYTES else 0)
        return p
    assert p.tpr & (p.tpr - 1) == 0 and p.tpr <= MAX_THREADS
    assert p.threads == p.tpr * p.rows_per_block <= MAX_THREADS
    assert p.threads % 32 == 0
    assert 1 <= p.nv <= MAX_VECS
    assert p.tpr * p.nv >= nvec > p.tpr * (p.nv - 1)   # covers the row
    assert p.staged_bytes == 0
    return p


@pytest.mark.parametrize("xe,we", ESIZES)
@pytest.mark.parametrize("D", CONFIG_DS)
def test_every_config_width(D, xe, we):
    """Aligned (fresh tensors) the loads are 16 bytes; the decode rows
    spread a row thinly, the training rows keep several vectors in flight
    and fill the card."""
    for R in (1, 16, 512, 4096, 8192):
        p = _check(R, D, xe, we, x_stride=D if R > 1 else 0,
                   out_stride=D if R > 1 else 0)
        assert p.vec == 16 // xe
        if p.tpr and R <= 16:       # one load a thread, or every thread
            assert p.nv == 1 or p.tpr == MAX_THREADS
        if p.tpr and R >= 4096:
            assert p.blocks >= SMS and p.nv >= 2


@pytest.mark.parametrize("xe,we", ESIZES)
def test_misaligned_and_ragged_rows_take_narrower_loads(xe, we):
    cases = [  # (D, x_ptr offset in elements, row stride, want vec * xe)
        (2048, 0, 2048, 16), (2048, 1, 2056, xe), (2048, 2, 2056,
                                                   min(16, 2 * xe)),
        (33, 0, 33, xe), (1000, 0, 1000, 16 if 1000 * xe % 16 == 0 else 8),
        (1002, 0, 1002, 2 * xe), (12288, 3, 12296, xe),
        (576, 0, 580, 8 if xe == 2 else 16)]
    for D, off, stride, want in cases:
        kw = dict(x_ptr=256 + off * xe, out_ptr=512, w_ptr=1024,
                  x_stride=stride, out_stride=D)
        assert lane_width(D, xe, we, **kw) * xe == want, (D, off, stride)
        for R in (1, 16, 4096):
            _check(R, D, xe, we, **kw)


def test_a_misaligned_weight_narrows_the_loads():
    assert lane_width(2048, 2, 2, w_ptr=2) == 1
    assert lane_width(2048, 2, 4, w_ptr=16) == 8       # 32-byte w vectors
    assert lane_width(2048, 2, 4, w_ptr=8) == 2        # w loads of 8 bytes


def test_geometry_by_rows():
    """Decode (R = 16, D = 2048 bf16): a row over 256 threads, one 16-byte
    load each.  SFT (R = 4,096): a warp per row, 8 vectors a lane.  Reward
    (R = 8,192, D = 1024): 16 lanes a row.  D = 12,288 fp32 past the
    register tile: the staged kernel, through shared memory."""
    p = plan(16, 2048, 2, 2)
    assert (p.tpr, p.nv, p.blocks) == (256, 1, 16)
    p = plan(4096, 2048, 2, 2)
    assert (p.tpr, p.nv, p.rows_per_block) == (32, 8, 8)
    p = plan(8192, 1024, 2, 2)
    assert (p.tpr, p.nv) == (16, 8)
    p = plan(16, 12288, 4, 4)
    assert p.tpr == 0 and p.staged_bytes == 12288 * 8
    p = plan(16, 12288, 2, 2)
    assert p.tpr == 256 and p.nv == 6
    p = _check(4, 40_000, 4, 4)
    assert p.tpr == 0 and p.staged_bytes == 0       # re-reads from the L2
