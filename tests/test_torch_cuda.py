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
from repro_torch.kernels.paged_attention import (
    paged_decode_attention_fwd, paged_decode_attention_quant_fwd)
from repro_torch.kernels.rmsnorm import rmsnorm_fwd
from repro_torch.kernels.ssd_scan import ssd_intra_fwd

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


# the rows kernel at the training shapes, the staged kernel (D = 12,288 in
# fp32), ragged D that takes narrower loads, and x a slice at an odd
# element offset (2-byte aligned rows in bf16), every x / w dtype pair
@pytest.mark.parametrize("wdt", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R,D,offset", [(4096, 2048, 0), (8192, 1024, 0),
                                        (16, 12288, 0), (3, 12288, 1),
                                        (16, 33, 0), (16, 1000, 0),
                                        (33, 2048, 1), (512, 576, 3)])
def test_rmsnorm_kernel_geometries(cuda, R, D, offset, dtype, wdt):
    from repro_torch.kernels import rmsnorm as rms
    wide = _randn(cuda, (R, D + 8), dtype)
    x = wide[:, offset:offset + D]
    w = (1.0 + 0.1 * _randn(cuda, (D,), torch.float32)).to(wdt)
    p = rms.plan(R, D, x.element_size(), w.element_size(),
                 x_ptr=x.data_ptr(), w_ptr=w.data_ptr(), x_stride=D + 8)
    assert offset == 0 or p.vec < 16 // x.element_size()
    before = rmsnorm_fwd.launches
    got = rmsnorm_fwd(x, w)
    torch.cuda.synchronize()
    assert rmsnorm_fwd.launches == before + 1
    want = ref.rmsnorm_ref(x, w)
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1)).max()
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2)


# the edges of the bf16 kernels' 64-row tiles (32 keys at D = 128 in the
# backward): one short of and one past 64 and 128, a single query, G = 3
FLASH_EDGES = [(1, 3, 63, 65, None, 64), (2, 1, 65, 129, None, 64),
               (1, 1, 127, 129, 65, 128), (2, 1, 1, 63, None, 64),
               (1, 3, 1, 129, None, 32), (1, 2, 129, 129, None, 64),
               (1, 3, 64, 128, 63, 32)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,Lq,Lk,window,D", [
    (2, 1, 37, 37, None, 64), (3, 3, 50, 50, 17, 64),
    (2, 3, 13, 70, None, 32), (1, 2, 33, 33, None, 128)] + FLASH_EDGES)
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


def _paged_pool(gen, nblocks, bs, KV, D, kind):
    """Pools (and int8 scale planes) on the card; fp pools in ``kind``."""
    from repro_torch.models.modules import _kv_quant
    x = [_randn(gen, (nblocks, bs, KV, D), torch.float32) for _ in "kv"]
    if kind == "int8":
        (k, ks), (v, vs) = _kv_quant(x[0]), _kv_quant(x[1])
        return k, v, (ks, vs)
    return x[0].to(kind), x[1].to(kind), ()


@pytest.mark.parametrize("kind", [torch.float32, torch.bfloat16, "int8"])
@pytest.mark.parametrize("KV,G,D,bs,nb", [(2, 1, 64, 16, 6), (3, 3, 64, 4, 9),
                                          (1, 8, 32, 8, 5),
                                          (2, 2, 128, 16, 3)])
def test_paged_kernels_walk_the_table(cuda, KV, G, D, bs, nb, kind):
    """Both paged kernels against their plain versions over shuffled,
    non-contiguous tables with ragged lens (one row, a partial last block,
    a full table): fp32 1e-4, bf16 2e-2 of max |plain|.  Rows the kernel
    must never read (the trash block, blocks past lens, rows past lens in
    the last block) hold NaN and leave the output unchanged; lens = 0
    gives 0 (the Pallas kernel's answer, ROADMAP R8); an entry outside the
    pool gives NaN instead of a read past it."""
    B, nblocks = 3, 3 * nb + 2
    dt = torch.float32 if kind == "int8" else kind
    q = _randn(cuda, (B, KV, G, D), dt)
    k, v, scales = _paged_pool(cuda, nblocks, bs, KV, D, kind)
    perm = torch.randperm(nblocks - 1, generator=torch.Generator()
                          .manual_seed(nb)) + 1
    tables = torch.zeros(B, nb, dtype=torch.int32)
    lens = torch.tensor([1, bs * (nb // 2) + bs // 2 + 1, nb * bs],
                        dtype=torch.int32)
    for b in range(B):
        n = -(-int(lens[b]) // bs)
        tables[b, :n] = perm[b * nb:b * nb + n]
    tables, lens = tables.cuda(), lens.cuda()
    run = ((lambda *a: paged_decode_attention_quant_fwd(
        q, a[0], a[1], *scales, *a[2:])) if kind == "int8" else
        (lambda *a: paged_decode_attention_fwd(q, *a)))
    plain = ((lambda *a: ref.paged_decode_attention_quant_ref(
        q, a[0], a[1], *scales, *a[2:])) if kind == "int8" else
        (lambda *a: ref.paged_decode_attention_ref(q, *a)))
    launches = (paged_decode_attention_quant_fwd if kind == "int8"
                else paged_decode_attention_fwd)
    before = launches.launches
    got = run(k, v, tables, lens)
    torch.cuda.synchronize()
    assert launches.launches == before + 1
    want = plain(k, v, tables, lens)
    scale = want.float().abs().max()
    assert (got.float() - want.float()).abs().max() <= TOL[dt] * scale
    # poison every row no sequence may read (int8: its scales)
    dead = torch.ones(nblocks, bs, dtype=torch.bool, device="cuda")
    for b in range(B):
        n = int(lens[b])
        rows = torch.arange(n, device="cuda")
        dead[tables[b].long()[rows // bs], rows % bs] = False
    if kind == "int8":
        for s in scales:
            s[dead] = float("nan")
    else:
        k[dead], v[dead] = float("nan"), float("nan")
    assert torch.equal(run(k, v, tables, lens), got)
    zero = run(k, v, tables, torch.zeros_like(lens))
    assert torch.equal(zero, torch.zeros_like(zero))
    bad = tables.clone()
    bad[1, 0] = nblocks
    out = run(k, v, bad, lens)
    torch.cuda.synchronize()
    assert torch.isnan(out[1].float()).all()
    assert torch.equal(out[0], got[0]) and torch.equal(out[2], got[2])


# split-KV edges of the decode kernels: rows around the 64-row split
# granularity and a long cache, at B * KV = 2 (the most splits)
SPLIT_ROWS = [1, 63, 64, 65, 511, 513, 2048]
# (nb, bs) with nb * bs in SPLIT_ROWS: odd block sizes take the kernel's
# division path, powers of two its shift path
SPLIT_TABLES = [(1, 1), (21, 3), (4, 16), (13, 5), (73, 7), (27, 19),
                (128, 16)]
# the K/V rows: q's dtype, or int8 with fp32 per-row scales
KINDS = ["fp", "int8"]


def _dense_plan(S, heads):
    from repro_torch.kernels import decode_attention as da
    return da.split_plan(S, heads, sms=da.sm_count(0),
                         max_chunk=da.MAX_CHUNK)


def _paged_plan(nb, bs, heads):
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels.paged_attention import paged_split_plan
    return paged_split_plan(nb, bs, heads, da.sm_count(0))


def _kv(gen, shape, dtype, kind):
    """K and V rows of ``shape`` (D last): in ``dtype`` with no scales
    (fp), or int8 with their fp32 scales (k_scale, v_scale) of
    ``shape[:-1]`` from the model's quantizer (int8)."""
    from repro_torch.models.modules import _kv_quant
    k, v = _randn(gen, shape, dtype), _randn(gen, shape, dtype)
    if kind == "fp":
        return k, v, ()
    (k, ks), (v, vs) = _kv_quant(k), _kv_quant(v)
    return k, v, (ks, vs)


def _dense(kind):
    """The dense wrapper of ``kind`` and its plain version, both called as
    (q, k, v, scales, valid) over (B, KV, S, D) views."""
    if kind == "fp":
        return (lambda q, k, v, sc, m: decode_attention_fwd(q, k, v, m),
                lambda q, k, v, sc, m: ref.decode_attention_ref(q, k, v, m),
                decode_attention_fwd)
    return (lambda q, k, v, sc, m: decode_attention_quant_fwd(q, k, v, *sc, m),
            lambda q, k, v, sc, m: ref.decode_attention_quant_ref(
                q, k, v, *sc, m), decode_attention_quant_fwd)


def _paged(kind):
    """The paged wrapper of ``kind`` and its plain version, both called as
    (q, k_pool, v_pool, scales, tables, lens)."""
    if kind == "fp":
        return (lambda q, k, v, sc, t, n: paged_decode_attention_fwd(
                    q, k, v, t, n),
                lambda q, k, v, sc, t, n: ref.paged_decode_attention_ref(
                    q, k, v, t, n), paged_decode_attention_fwd)
    return (lambda q, k, v, sc, t, n: paged_decode_attention_quant_fwd(
                q, k, v, *sc, t, n),
            lambda q, k, v, sc, t, n: ref.paged_decode_attention_quant_ref(
                q, k, v, *sc, t, n), paged_decode_attention_quant_fwd)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("S", SPLIT_ROWS)
def test_decode_kernel_split_edges(cuda, S, G, D, dtype, kind):
    """The split-KV edges of :func:`test_decode_kernel_reads_arena_in_place`
    (the in-place (B, S, KV, D) arena, and its (B, S, KV) scale planes for
    int8, through ``ops``): a mask with holes whose second split is all
    masked, prefixes ending one row inside and one row past a split
    boundary, a fully masked row (the mean of V over all S rows, int8: of
    the dequantized V).  fp32 1e-4, bf16 2e-2 (int8: of max |plain|); one
    count a call."""
    B, KV = 2, 1
    q = _randn(cuda, (B, KV * G, D), dtype)
    k, v, sc = _kv(cuda, (B, S, KV, D), dtype, kind)
    _, plain, fn = _dense(kind)
    splits, chunk = _dense_plan(S, B * KV)
    ar = torch.arange(S, device="cuda")
    holes = torch.rand(S, generator=cuda, device="cuda") < 0.5
    holes[chunk:2 * chunk] = False           # a split with no valid row
    holes[0] = True
    masks = [torch.stack([holes, ar < S]),
             torch.stack([ar < min(chunk + 1, S), ar < max(chunk - 1, 1)]),
             torch.stack([ar < 0, holes])]
    for valid in masks:
        before = fn.launches
        got = (ops.decode_attention(q, k, v, valid) if kind == "fp" else
               ops.decode_attention_quant(q, k, v, *sc, valid))
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(q.unflatten(1, (KV, G)), k.transpose(1, 2),
                     v.transpose(1, 2), [t.transpose(1, 2) for t in sc],
                     valid).reshape(got.shape)
        scale = 1.0 if kind == "fp" else float(want.float().abs().max())
        err = (got.float() - want.float()).abs().max()
        assert err <= TOL[dtype] * scale, (float(err), splits, chunk)
    vd = v[0].float() * (sc[1][0][..., None] if sc else 1)
    mean_v = vd.mean(0).repeat_interleave(G, 0)
    assert (got[0].float() - mean_v).abs().max() <= TOL[dtype] * scale


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", [32, 64, 128])
@pytest.mark.parametrize("G", [1, 3, 8])
@pytest.mark.parametrize("nb,bs", SPLIT_TABLES)
def test_paged_kernel_split_edges(cuda, nb, bs, G, D, dtype, kind):
    """The split-KV edges of :func:`test_paged_kernels_walk_the_table`, at
    its tolerance (fp32 1e-4, bf16 2e-2 of max |plain|): shuffled full
    tables, lens ending one row inside and one row past a split boundary,
    a full table and lens = 0 (zeros); rows no sequence may read hold NaN
    (fp: in K/V; int8: in K/V's scales) and leave the output bitwise
    unchanged; a table entry outside the pool in the last split makes that
    sequence's output NaN and leaves the other's bitwise unchanged."""
    B, KV = 2, 1
    n_rows, nblocks = nb * bs, B * nb + 1
    q = _randn(cuda, (B, KV, G, D), dtype)
    k, v, sc = _kv(cuda, (nblocks, bs, KV, D), dtype, kind)
    run, plain, fn = _paged(kind)
    tables = (torch.randperm(nblocks - 1, generator=torch.Generator()
                             .manual_seed(nb * bs)) + 1)[:B * nb]
    tables = tables.view(B, nb).int().cuda()
    splits, chunk = _paged_plan(nb, bs, B * KV)
    for lens in ([n_rows, min(chunk + 1, n_rows)],
                 [max(min(chunk - 1, n_rows), 1), 1], [0, n_rows]):
        lens = torch.tensor(lens, dtype=torch.int32, device="cuda")
        before = fn.launches
        got = run(q, k, v, sc, tables, lens)
        torch.cuda.synchronize()
        assert fn.launches == before + 1
        want = plain(q, k, v, sc, tables, lens)
        live = lens > 0                      # lens = 0: the kernel's zeros
        err = (got[live].float() - want[live].float()).abs().max()
        scale = want[live].float().abs().max()
        assert err <= TOL[dtype] * scale, (float(err), float(scale), splits,
                                           chunk)
        assert torch.equal(got[~live], torch.zeros_like(got[~live]))
        dead = torch.ones(nblocks, bs, dtype=torch.bool, device="cuda")
        for b in range(B):
            rows = torch.arange(int(lens[b]), device="cuda")
            dead[tables[b].long()[rows // bs], rows % bs] = False
        if kind == "fp":
            kp, vp, scp = k.clone(), v.clone(), ()
            kp[dead], vp[dead] = float("nan"), float("nan")
        else:                                # int8 holds no NaN: the scales
            kp, vp, scp = k, v, tuple(t.clone() for t in sc)
            for t in scp:
                t[dead] = float("nan")
        assert torch.equal(run(q, kp, vp, scp, tables, lens), got)
    bad = tables.clone()
    bad[1, (splits - 1) * chunk // bs] = nblocks     # lens[1] = n_rows
    out = run(q, k, v, sc, bad, lens)
    torch.cuda.synchronize()
    assert torch.isnan(out[1].float()).all()
    assert torch.equal(out[0], got[0])


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("B,KV,G,bs,nb", [(16, 32, 1, 16, 32),
                                          (16, 3, 3, 16, 32),
                                          (8, 32, 1, 16, 32),
                                          (2, 1, 2, 8, 130)])
def test_dense_and_paged_kernels_agree_bitwise(cuda, B, KV, G, bs, nb,
                                               dtype, kind):
    """One core, one split plan: the dense kernel over a pool's rows (and
    int8 scales) gathered into an arena gives the paged kernel's output bit
    for bit (one split at the OPT-1.3B serve and PPO shapes, eight at
    smollm-135m's, many at B * KV = 2), so greedy streams over the arena
    and over the pool agree."""
    S, nblocks = nb * bs, B * nb + 1
    q = _randn(cuda, (B, KV, G, 64), dtype)
    k, v, sc = _kv(cuda, (nblocks, bs, KV, 64), dtype, kind)
    tables = (torch.randperm(nblocks - 1, device="cuda") + 1).view(B, nb)
    tables = tables.int()
    lens = torch.randint(1, S + 1, (B,), generator=cuda, device="cuda")
    lens = lens.int()
    valid = torch.arange(S, device="cuda")[None] < lens[:, None]
    ka, va, *sca = (ref.gather_blocks(t, tables).transpose(1, 2)
                    for t in (k, v, *sc))
    assert _dense_plan(S, B * KV) == _paged_plan(nb, bs, B * KV)
    assert torch.equal(_dense(kind)[0](q, ka, va, sca, valid),
                       _paged(kind)[0](q, k, v, sc, tables, lens))


def _split_cases(gen, kind="fp", dtype=torch.bfloat16):
    """A dense and a paged case of ``kind`` at B * KV = 2 over 1,000 rows
    (several splits), as (name, zero-argument call)."""
    B, KV, G, D, S = 2, 1, 3, 64, 1000
    q = _randn(gen, (B, KV, G, D), dtype)
    k, v, sc = _kv(gen, (B, KV, S, D), dtype, kind)
    valid = torch.arange(S, device="cuda")[None] < torch.tensor(
        [[S], [700]], device="cuda")
    bs, nb = 8, S // 8
    pk, pv, psc = _kv(gen, (B * nb + 1, bs, KV, D), dtype, kind)
    tables = (torch.randperm(B * nb, device="cuda") + 1).view(B, nb).int()
    lens = torch.tensor([S, 613], dtype=torch.int32, device="cuda")
    dense, paged = _dense(kind)[0], _paged(kind)[0]
    return [("dense", lambda: dense(q, k, v, sc, valid)),
            ("paged", lambda: paged(q, pk, pv, psc, tables, lens))]


@pytest.mark.parametrize("kind", KINDS)
def test_decode_kernels_are_bitwise_repeatable(cuda, kind):
    """No atomics: two calls of each decode kernel over several splits
    give bitwise-equal outputs."""
    for _, call in _split_cases(cuda, kind):
        assert torch.equal(call(), call())


@pytest.mark.parametrize("kind", KINDS)
def test_decode_combine_reads_only_what_the_splits_wrote(cuda, monkeypatch,
                                                         kind):
    """An empty split writes only its state: with the partials' scratch
    filled with NaN before every call, each wrapper still gives its output
    bit for bit (dense: a prefix mask with empty tail splits and a fully
    masked sequence; paged: empty splits past lens and lens = 0)."""
    from repro_torch.kernels import decode_attention as da
    from repro_torch.kernels import paged_attention as pa
    B, KV, G, D, S, bs = 3, 1, 3, 64, 1000, 8
    q = _randn(cuda, (B, KV, G, D), torch.float32)
    k, v, sc = _kv(cuda, (B, KV, S, D), torch.float32, kind)
    valid = torch.arange(S, device="cuda")[None] < torch.tensor(
        [[S], [70], [0]], device="cuda")
    pk, pv, psc = _kv(cuda, (B * S // bs + 1, bs, KV, D), torch.float32,
                      kind)
    tables = (torch.randperm(B * S // bs, device="cuda") + 1).view(B, -1)
    tables = tables.int()
    lens = torch.tensor([S, 70, 0], dtype=torch.int32, device="cuda")
    dense, paged = _dense(kind)[0], _paged(kind)[0]
    calls = (lambda: dense(q, k, v, sc, valid),
             lambda: paged(q, pk, pv, psc, tables, lens))
    want = [call() for call in calls]
    plain = da.scratch

    def poisoned(*args):
        t = plain(*args)
        return None if t is None else t.fill_(float("nan"))

    monkeypatch.setattr(da, "scratch", poisoned)
    monkeypatch.setattr(pa, "scratch", poisoned)
    assert _dense_plan(S, B * KV)[0] > 1
    for call, w in zip(calls, want):
        assert torch.equal(call(), w)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_kernels_replay_from_a_cuda_graph(cuda, kind):
    """Each wrapper picks its splits and allocates its scratch on the host
    without reading the device, so a call captured in a CUDA graph replays
    to the eager output bit for bit."""
    for _, call in _split_cases(cuda, kind):
        eager = call()
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            call()
        torch.cuda.current_stream().wait_stream(stream)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            captured = call()
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(captured, eager)


@pytest.mark.parametrize("kind", KINDS)
def test_decode_combine_runs_only_when_split(cuda, kind):
    """``torch.profiler``'s kernel names: one split kernel per call, and the
    combine kernel only when the call splits the rows (one call at B * KV =
    2 over 1,000 rows, one at 512 blocks over 64 rows)."""
    from torch.profiler import ProfilerActivity, profile
    q1 = _randn(cuda, (16, 32, 1, 64), torch.bfloat16)
    k1, v1, sc1 = _kv(cuda, (16, 32, 64, 64), torch.bfloat16, kind)
    valid = torch.ones(16, 64, dtype=torch.bool, device="cuda")
    dense = _dense(kind)[0]
    cases = _split_cases(cuda, kind) + [
        ("one split", lambda: dense(q1, k1, v1, sc1, valid))]
    assert _dense_plan(64, 16 * 32)[0] == 1
    with profile(activities=[ProfilerActivity.CUDA]):   # CUPTI warm-up
        torch.cuda.synchronize()
    for name, call in cases:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        names = [e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA]
        assert sum("split_kernel" in n for n in names) == 1, (name, names)
        assert sum("combine_kernel" in n for n in names) == (
            0 if name == "one split" else 1), (name, names)


def test_int8_to_float_matches_static_cast(cuda):
    """The decode core's int8 -> fp32 (a byte permute into the mantissa of
    2^23 and one subtraction, ``VecI8`` in ``csrc/decode_core.cuh``), 8 and
    16 values at a time, gives ``static_cast<float>``'s bits for all 256
    values."""
    import ctypes

    from repro_torch.kernels import build
    x = torch.arange(-128, 128, dtype=torch.int16).to(torch.int8).cuda()
    out = torch.empty(3, 256, device="cuda")
    lib = build.load("decode_attention_quant")
    fn = lib.decode_int8_to_float
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    build.check(lib, fn(x.data_ptr(), out.data_ptr(), 256,
                        build.stream_handle(x)), "decode_int8_to_float")
    torch.cuda.synchronize()
    bits = out.view(torch.int32)
    assert torch.equal(bits[0], bits[2]) and torch.equal(bits[1], bits[2])
    assert torch.equal(out[2], torch.arange(-128, 128, device="cuda").float())


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


@pytest.mark.parametrize("kv_quant", [False, True], ids=["bf16kv", "int8kv"])
def test_paged_serving_on_the_card_matches_the_cpu(cuda, kv_quant):
    """Greedy serving on the paged pool with the prefix cache and
    preemption (a small pool) at the reduced OPT-1.3B config in fp32: the
    card (kernels) and the CPU (plain versions) emit the same tokens, the
    same as the dense layout's, and the card launched the paged kernel of
    its cache's dtype and never a dense decode kernel."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.engine import GenerationEngine, Request

    cfg = reduced(get_config("opt-1.3b")).replace(kv_quant=kv_quant)
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    shared = rng.integers(0, cfg.vocab_size, 9)
    reqs = [Request(uid=i, tokens=np.concatenate(
        [shared, rng.integers(0, cfg.vocab_size, n)]).astype(np.int32),
        max_new_tokens=mn)
        for i, (n, mn) in enumerate([(2, 6), (5, 4), (1, 8), (4, 5),
                                      (3, 7)])]
    outs = {}
    for dev, layout in (("cpu", "dense"), ("cpu", "paged"),
                        ("cuda", "paged")):
        eng = GenerationEngine(cfg, max_new_tokens=8, temperature=0.0,
                               chunk=2, kv_layout=layout, block_size=4,
                               prefix_cache=layout == "paged", device=dev)
        p = tree_map(lambda t: t.to(dev), params)
        kw = dict(num_blocks=8, watermark=0) if layout == "paged" else {}
        ops.reset_launch_counts()
        outs[dev, layout] = {c.uid: c.tokens.tolist() for c in eng.serve(
            p, reqs, torch.Generator(device=dev).manual_seed(0), slots=3,
            **kw)}
        if layout == "paged":
            assert eng.last_stats["preemptions"] > 0
            assert eng.last_stats["prefill_hit_rate"] > 0
    assert outs["cpu", "dense"] == outs["cpu", "paged"] == outs["cuda",
                                                                "paged"]
    counts = ops.launch_counts()
    used = ("paged_decode_attention_quant_fwd" if kv_quant
            else "paged_decode_attention_fwd")
    assert counts[used] > 0 and counts["flash_attention_fwd"] > 0
    assert counts["decode_attention_fwd"] == 0
    assert counts["decode_attention_quant_fwd"] == 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G,Lq,Lk,window,D", [
    (2, 1, 37, 37, None, 64), (3, 3, 50, 50, 17, 64),
    (2, 3, 13, 70, None, 32), (1, 2, 33, 33, None, 128),
    (2, 1, 130, 130, 40, 64)] + FLASH_EDGES)
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
    (2, 1, 130, 130, 40, 64), (1, 4, 100, 300, None, 64)] + FLASH_EDGES)
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


def _bwd_inputs(gen, B, KV, G, L, D, dtype):
    """Model-layout q, k, v, dO passed as grouped views (as
    ``ops.FlashAttention`` passes them), with the plain lse and delta."""
    qm, dom = (_randn(gen, (B, L, KV * G, D), dtype) for _ in range(2))
    km, vm = (_randn(gen, (B, L, KV, D), dtype) for _ in range(2))
    q5, do5 = (t.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
               for t in (qm, dom))
    k4, v4 = km.transpose(1, 2), vm.transpose(1, 2)
    o5 = ref.flash_attention_ref(q5, k4, v4)
    lse = ref.flash_attention_lse_ref(q5, k4)
    delta = (do5.float() * o5.float()).sum(-1).contiguous()
    return q5, k4, v4, do5, lse, delta


def test_flash_bwd_bf16_is_deterministic(cuda):
    """No atomics: two bf16 backward calls give bitwise-equal dq, dk, dv
    (G = 3 query heads summed into each dK / dV inside one block)."""
    args = _bwd_inputs(cuda, 2, 2, 3, 129, 64, torch.bfloat16)
    first = flash_attention_bwd(*args)
    second = flash_attention_bwd(*args)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_bwd_fp32_equals_plain_exactly(cuda):
    """fp32 runs the SIMT kernels, which sum every output in the order of
    the plain version's fp32 GEMMs: equal bit for bit at the ragged OPT-1.3B
    shape of ``chip_smoke.py``."""
    args = _bwd_inputs(cuda, 2, 32, 1, 300, 64, torch.float32)
    for got, want in zip(flash_attention_bwd(*args),
                         ref.flash_attention_bwd_ref(*args)):
        assert torch.equal(got, want)


def test_flash_bf16_refuses_what_its_copies_cannot_take(cuda):
    """A bf16 view off a 16-byte boundary, or with a row stride that is not
    a multiple of 8 elements, raises ``ValueError`` and launches nothing:
    there is no fallback to the fp32 kernels."""
    bf16 = torch.bfloat16
    k = _randn(cuda, (1, 2, 64, 64), bf16)
    lse = torch.zeros((1, 2, 1, 64), device="cuda")
    odd_start = _randn(cuda, (1, 2, 1, 64, 65), bf16)[..., 1:]
    odd_stride = _randn(cuda, (1, 2, 1, 64, 68), bf16)[..., :64]
    before = ops.launch_counts()
    for q in (odd_start, odd_stride):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_fwd(q, k, k)
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_bwd(q, k, k, q, lse, lse)
        out = torch.empty(q.shape[:-1] + (q.shape[-1] + 1,), dtype=bf16,
                          device="cuda")[..., 1:]
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_fwd(q.contiguous(), k, k, out=out)
    assert ops.launch_counts() == before


def test_flash_kernels_dispatch_by_dtype(cuda):
    """bf16 runs only the tensor-core kernels and fp32 only the SIMT ones:
    the kernel names ``torch.profiler`` sees for one forward and backward
    through ``ops.FlashAttention``."""
    from torch.profiler import ProfilerActivity, profile
    seen = {}
    for dtype in (torch.float32, torch.bfloat16):
        q = _randn(cuda, (1, 65, 4, 64), dtype).requires_grad_()
        k = _randn(cuda, (1, 65, 2, 64), dtype).requires_grad_()
        v = _randn(cuda, (1, 65, 2, 64), dtype).requires_grad_()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            ops.FlashAttention.apply(q, k, v, True, None).sum().backward()
            torch.cuda.synchronize()
        seen[dtype] = {e.name for e in prof.events()
                       if e.device_type == torch.autograd.DeviceType.CUDA
                       and "flash_" in e.name}
    for name in ("flash_fwd_mma_kernel", "flash_bwd_dkv_mma_kernel",
                 "flash_bwd_dq_mma_kernel"):
        assert sum(name in n for n in seen[torch.bfloat16]) == 1
    assert len(seen[torch.bfloat16]) == 3
    for name in ("flash_fwd_kernel<float", "flash_bwd_dkv_kernel<float",
                 "flash_bwd_dq_kernel<float"):
        assert sum(name in n for n in seen[torch.float32]) == 1
    assert not any("mma" in n for n in seen[torch.float32])


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


def _ssd_case(gen, b, nc, q, h, p, n, dtype, dt_scale=1.0, strided=False):
    """SSD intra-chunk inputs; with ``strided`` X, B and C are slices of
    one wider tensor, as in the model (slices of the conv output)."""
    dt = torch.nn.functional.softplus(
        torch.randn((b, nc, q, h), generator=gen, device="cuda")) * dt_scale
    A = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.3)
    if strided:
        wide = torch.randn((b, nc, q, h * p + 2 * n + 5), generator=gen,
                           device="cuda").to(dtype) * 0.5
        X = wide[..., 3:3 + h * p].unflatten(-1, (h, p))
        B = wide[..., 3 + h * p:3 + h * p + n]
        C = wide[..., 3 + h * p + n:3 + h * p + 2 * n]
    else:
        X = _randn(gen, (b, nc, q, h, p), dtype) * 0.5
        B = _randn(gen, (b, nc, q, n), dtype) * 0.5
        C = _randn(gen, (b, nc, q, n), dtype) * 0.5
    return X, dt, A, B, C


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nc,q,h,p,n,strided", [
    (1, 1, 256, 32, 64, 128, False),      # Mamba2-370M admission
    (1, 1, 137, 32, 64, 128, True),       # ragged q, strided inputs
    (1, 1, 1, 32, 64, 128, False),        # one-token prompt
    (1, 4, 256, 32, 64, 128, True),       # several chunks
    (1, 1, 256, 64, 64, 64, False),       # Zamba2-1.2B
    (2, 3, 45, 3, 32, 32, True),          # reduced widths
    (1, 2, 100, 3, 64, 32, False)])       # ragged q, narrowest n
def test_ssd_intra_kernel_matches_plain(cuda, b, nc, q, h, p, n, strided,
                                        dtype):
    X, dt, A, B, C = _ssd_case(cuda, b, nc, q, h, p, n, dtype,
                               strided=strided)
    before = ssd_intra_fwd.launches
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    torch.cuda.synchronize()
    assert ssd_intra_fwd.launches == before + 1
    yr, sr, _, ar = ref.ssd_intra_ref(X, dt, A, B, C)
    assert y.dtype == dtype and s.dtype == acs.dtype == torch.float32
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    assert rel(y, yr) <= (1e-4 if dtype == torch.float32 else 2e-2)
    assert rel(s, sr) <= 1e-4
    assert rel(acs, ar) <= 1e-5


def _acs_plain(dt, A):
    return ref.chunk_cumsum((dt * A).permute(0, 1, 3, 2))


# the bf16 tensor-core kernel at its 64-row tile edges, the fixed path's
# b = 8, several chunks, the strided slices at an element offset of 3 (6
# bytes: element loads), reduced widths; A_cs bitwise the plain version's
@pytest.mark.parametrize("b,nc,q,h,p,n,strided", [
    (1, 1, 63, 32, 64, 128, False), (1, 1, 65, 32, 64, 128, True),
    (1, 1, 127, 32, 64, 128, False), (1, 1, 129, 64, 64, 64, False),
    (8, 1, 256, 32, 64, 128, False), (1, 4, 256, 32, 64, 128, False),
    (1, 2, 129, 5, 32, 128, True), (2, 1, 65, 3, 32, 32, False),
    (1, 1, 600, 4, 64, 128, False)])
def test_ssd_intra_bf16_kernel_tile_edges(cuda, b, nc, q, h, p, n, strided):
    X, dt, A, B, C = _ssd_case(cuda, b, nc, q, h, p, n, torch.bfloat16,
                               strided=strided)
    before = ssd_intra_fwd.launches
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    torch.cuda.synchronize()
    assert ssd_intra_fwd.launches == before + 1
    yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
    rel = lambda a, b: float((a.float() - b.float()).abs().max()
                             / b.float().abs().max().clamp(min=1e-30))
    assert rel(y, yr) <= 2e-2
    assert rel(s, sr) <= 1e-4
    assert torch.equal(acs, _acs_plain(dt, A))


@pytest.mark.parametrize("q,h", [(1000, 3), (2048, 1)])
def test_ssd_intra_bf16_kernel_long_chunks(cuda, q, h):
    """Chunks far past the model's 256 rows (the blocks stream the keys, so
    any q is taken) and a head pair whose second head does not exist."""
    X, dt, A, B, C = _ssd_case(cuda, 1, 1, q, h, 64, 128, torch.bfloat16)
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    torch.cuda.synchronize()
    yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
    assert float((y.float() - yr.float()).abs().max()) <= 2e-2 * float(
        yr.float().abs().max())
    assert float((s - sr).abs().max()) <= 1e-4 * float(sr.abs().max())
    assert torch.equal(acs, _acs_plain(dt, A))


# fp32 outputs of the SIMT kernel at a fixed seed, as PR 15's kernel wrote
# them (sha1 of Y, S_c, A_cs), and A_cs bitwise the plain version's
FP32_SHA = {"y": "9c4bf9181c4c34c18b1c162dfcffc86c19abf7da",
            "s": "96ca18f042dc31e6748a7fe3d64c98309656630d",
            "acs": "c54a6b8dbc46b56a4c9ec452d85537afe6b5938a"}


def test_ssd_intra_fp32_kernel_outputs_unchanged(cuda):
    import hashlib
    rng = np.random.default_rng(2024)
    b, nc, q, h, p, n = 1, 2, 256, 32, 64, 128
    mk = lambda shape, scale=0.5: torch.from_numpy(
        (rng.standard_normal(shape) * scale).astype(np.float32)).cuda()
    X, B, C = mk((b, nc, q, h, p)), mk((b, nc, q, n)), mk((b, nc, q, n))
    dt = torch.nn.functional.softplus(mk((b, nc, q, h), 1.0))
    A = -torch.exp(mk((h,), 0.3))
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    torch.cuda.synchronize()
    assert torch.equal(acs, _acs_plain(dt, A))
    got = {k: hashlib.sha1(t.cpu().numpy().tobytes()).hexdigest()
           for k, t in (("y", y), ("s", s), ("acs", acs))}
    assert got == FP32_SHA


def test_ssd_intra_kernel_selects_the_overflowing_upper_triangle(cuda):
    """dt * |A| large: the upper triangle's exp overflows, the outputs stay
    finite and equal the plain version's."""
    X, dt, A, B, C = _ssd_case(cuda, 1, 1, 256, 32, 64, 128, torch.float32,
                               dt_scale=100.0)
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    assert float((acs[..., 0] - acs[..., -1]).min()) > 89.0
    yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert (y - yr).abs().max() <= 1e-4 * yr.abs().max()
    assert (s - sr).abs().max() <= 1e-4 * sr.abs().max()


def test_ssd_intra_bf16_kernel_selects_the_overflowing_upper_triangle(cuda):
    """The same in bf16, on the tensor-core kernel: finite, Y within the
    bf16 gate, S_c within 1e-4, A_cs bitwise."""
    X, dt, A, B, C = _ssd_case(cuda, 1, 1, 256, 32, 64, 128, torch.bfloat16,
                               dt_scale=100.0)
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    assert float((acs[..., 0] - acs[..., -1]).min()) > 89.0
    yr, sr, _, _ = ref.ssd_intra_ref(X, dt, A, B, C)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    assert (y.float() - yr.float()).abs().max() <= 2e-2 * yr.float().abs(
        ).max()
    assert (s - sr).abs().max() <= 1e-4 * sr.abs().max()
    assert torch.equal(acs, _acs_plain(dt, A))


def test_ssd_intra_kernel_raises_instead_of_falling_back(cuda):
    X, dt, A, B, C = _ssd_case(cuda, 1, 1, 8, 2, 128, 32, torch.float32)
    with pytest.raises(ValueError):                  # p not 32 or 64
        ssd_intra_fwd(X, dt, A, B, C)
    X, dt, A, B, C = _ssd_case(cuda, 1, 1, 8, 2, 32, 32, torch.float32)
    with pytest.raises(TypeError):
        ssd_intra_fwd(X, dt.bfloat16(), A, B, C)


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_serving_on_the_card_matches_the_cpu(cuda, arch):
    """Greedy continuous batching at the reduced Mamba2 / Zamba2 in fp32,
    one prompt longer than the chunk: the card (kernels) and the CPU
    (plain versions) emit the same tokens; the SSD kernel launched, and
    the hybrid's attention kernels too."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_map
    from repro_torch.serving.engine import GenerationEngine, Request

    cfg = reduced(get_config(arch))
    params = T.init_params(cfg, torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate([(5, 6), (47, 4), (1, 8), (9, 5)])]
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
    must = ["rmsnorm", "ssd_intra_fwd"] + (
        ["flash_attention_fwd", "decode_attention_fwd"]
        if cfg.arch_type == "hybrid" else [])
    assert all(counts[k] > 0 for k in must), counts
    if cfg.arch_type == "ssm":
        assert counts["flash_attention_fwd"] == counts[
            "decode_attention_fwd"] == 0


# --------------------------------------------------------------------- #
# the SSD pass under autograd (training)
# --------------------------------------------------------------------- #
# the explicit backward at a tile edge (q = 137) and on strided X, B, C
# slices at an element offset of 3, both dtypes, against autograd of the
# plain forward (at these q the upper triangle's exp overflows)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,nc,q,h,p,n,strided", [
    (1, 1, 137, 32, 64, 128, False), (1, 2, 137, 32, 64, 128, True),
    (2, 2, 256, 64, 64, 64, True)])
def test_ssd_intra_backward_matches_autograd_of_plain(cuda, b, nc, q, h, p,
                                                      n, strided, dtype):
    X, dt, A, B, C = _ssd_case(cuda, b, nc, q, h, p, n, dtype,
                               strided=strided)
    y, s, acs = ssd_intra_fwd(X, dt, A, B, C)
    dY, dS, dAcs = (torch.randn(t.shape, generator=cuda, device="cuda")
                    for t in (y, s, acs))
    dY = dY.to(y.dtype)
    got = ref.ssd_intra_bwd_ref(X, dt, A, B, C, acs, dY, dS, dAcs)
    leaves = [t.detach().clone().requires_grad_() for t in (X, dt, A, B, C)]
    yr, sr, _, ar = ref.ssd_intra_ref(*leaves)
    want = torch.autograd.grad((yr.float() * dY.float()).sum()
                               + (sr * dS).sum() + (ar * dAcs).sum(), leaves)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.isfinite(g).all()
        err = float((g.float() - w.float()).abs().max()
                    / w.float().abs().max().clamp(min=1e-30))
        assert err <= (1e-4 if dtype == torch.float32 else 2e-2)


def test_ssd_scan_under_autograd_launches_the_kernel(cuda, monkeypatch):
    """On CUDA tensors under autograd ``ops.ssd_scan`` launches
    ``ssd_intra_fwd`` once per forward and never the plain forward; the
    backward is the explicit one."""
    calls = {"plain": 0}
    plain = ref.ssd_intra_ref

    def spy(*a):
        calls["plain"] += 1
        return plain(*a)

    monkeypatch.setattr(ref, "ssd_intra_ref", spy)
    X, dt, A, B, C = _ssd_case(cuda, 2, 1, 300, 32, 64, 128, torch.bfloat16)
    X, B, C = (t.reshape(2, 300, *t.shape[3:]).requires_grad_()
               for t in (X, B, C))
    dt = dt.reshape(2, 300, 32).requires_grad_()
    before = ssd_intra_fwd.launches
    y, f = ops.ssd_scan(X, dt, A, B, C, 256)
    (y.float().sum() + f.sum()).backward()
    torch.cuda.synchronize()
    assert ssd_intra_fwd.launches == before + 1
    assert calls["plain"] == 0
    assert all(torch.isfinite(t.grad).all() for t in (X, dt, B, C))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_intra_kernel_is_deterministic_for_remat(cuda, dtype):
    """Remat runs each layer's forward twice; the kernel sums in a fixed
    order (no atomics), so two calls give the same bits."""
    X, dt, A, B, C = _ssd_case(cuda, 8, 2, 256, 32, 64, 128, dtype,
                               strided=True)
    first = ssd_intra_fwd(X, dt, A, B, C)
    for _ in range(3):
        again = ssd_intra_fwd(X, dt, A, B, C)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


@pytest.mark.parametrize("arch", ["mamba2-370m", "zamba2-1.2b"])
def test_ssm_train_step_remat_on_the_card_gives_the_same_grads(cuda, arch):
    """One LM step at the reduced model in bf16 on the kernel path: with
    and without remat the loss and every grad are bit for bit equal (the
    recomputed forward launches the kernels again and gives the same
    bits), and the SSD kernel launched twice per layer with remat."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import lm_data
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves
    from repro_torch.training.steps import lm_value_and_grad

    cfg = reduced(get_config(arch)).replace(compute_dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device="cuda").manual_seed(1))
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             next(lm_data(cfg, 80, 0).sft_batches(4, 1)).items()}
    got = {}
    for remat in (False, True):
        ops.reset_launch_counts()
        (loss, _), grads = lm_value_and_grad(cfg.replace(remat=remat),
                                             params, batch)
        got[remat] = (float(loss), tree_leaves(grads), ops.launch_counts())
    n_ssm = sum(ls.kind != "attn" for seg in cfg.segments()
                for ls in seg.unit_spec for _ in range(seg.n_units))
    assert got[False][0] == got[True][0]
    assert all(torch.equal(a, b) for a, b in zip(got[False][1],
                                                 got[True][1]))
    assert got[False][2]["ssd_intra_fwd"] == n_ssm
    assert got[True][2]["ssd_intra_fwd"] == 2 * n_ssm
    if cfg.arch_type == "hybrid":
        assert got[True][2]["flash_attention_bwd"] > 0


# ------------------------------------------------------------------ #
# head_dim 128 at the GQA groups of llama3.2-3b (G 3), qwen3-8b (G 4),
# llama4-scout (G 5) and yi-9b (G 8); RMSNorm at their widths
# ------------------------------------------------------------------ #
GQA128 = [(8, 3), (8, 4), (8, 5), (4, 8)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G", GQA128)
def test_flash_forward_and_backward_at_head_dim_128(cuda, KV, G, dtype):
    """``ops.FlashAttention`` forward and backward at D = 128 over 200
    rows (a partial tile) in the model layout, against the plain versions
    (relative to max |plain|)."""
    B, L, D = 2, 200, 128
    q = _randn(cuda, (B, L, KV * G, D), dtype).requires_grad_()
    k = _randn(cuda, (B, L, KV, D), dtype).requires_grad_()
    v = _randn(cuda, (B, L, KV, D), dtype).requires_grad_()
    dout = _randn(cuda, (B, L, KV * G, D), dtype)
    out = ops.FlashAttention.apply(q, k, v, True, None)
    out.backward(dout)
    q5 = q.detach().unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    k4, v4 = k.detach().transpose(1, 2), v.detach().transpose(1, 2)
    o5 = ref.flash_attention_ref(q5, k4, v4)
    do5 = dout.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    lse = ref.flash_attention_lse_ref(q5, k4)
    delta = (do5.float() * o5.float()).sum(-1)
    wq, wk, wv = ref.flash_attention_bwd_ref(q5, k4, v4, do5, lse, delta)
    got_o = out.detach().unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4)
    for got, want in ((got_o, o5),
                      (q.grad.unflatten(2, (KV, G)).permute(0, 2, 3, 1, 4),
                       wq), (k.grad.transpose(1, 2), wk),
                      (v.grad.transpose(1, 2), wv)):
        scale = want.float().abs().max().clamp(min=1e-6)
        assert (got.float() - want.float()).abs().max() / scale \
            <= TOL[dtype]


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("KV,G", GQA128)
def test_decode_kernels_at_head_dim_128(cuda, KV, G, dtype, kind):
    """The dense and paged decode kernels (fp or int8 rows) at D = 128
    against their plain versions over 16 ragged slots, and dense == paged
    bit for bit over the same rows."""
    from repro_torch.models.modules import _kv_quant
    B, D, bs, nb = 16, 128, 16, 20
    S = nb * bs
    q = _randn(cuda, (B, KV, G, D), dtype)
    lens = torch.randint(1, S + 1, (B,), generator=cuda, device="cuda")
    lens[1] = S
    valid = torch.arange(S, device="cuda")[None] < lens[:, None]
    kv = [_randn(cuda, (B, S, KV, D), torch.float32) for _ in "kv"]
    if kind == "int8":
        (k, ks), (v, vs) = _kv_quant(kv[0]), _kv_quant(kv[1])
        dense = decode_attention_quant_fwd(
            q, k.transpose(1, 2), v.transpose(1, 2), ks.transpose(1, 2),
            vs.transpose(1, 2), valid)
        want = ref.decode_attention_quant_ref(
            q, k.transpose(1, 2), v.transpose(1, 2), ks.transpose(1, 2),
            vs.transpose(1, 2), valid)
    else:
        k, v = kv[0].to(dtype), kv[1].to(dtype)
        dense = decode_attention_fwd(q, k.transpose(1, 2), v.transpose(1, 2),
                                     valid)
        want = ref.decode_attention_ref(q, k.transpose(1, 2),
                                        v.transpose(1, 2), valid)
    scale = want.float().abs().max()
    assert (dense.float() - want.float()).abs().max() <= TOL[dtype] * scale
    # the same rows as a pool: slot b's blocks b * nb + 1 .. (b + 1) * nb
    pool = lambda t: torch.cat([t[:1, :bs] * 0, t.reshape(
        (B * nb, bs) + t.shape[2:])])
    tables = (torch.arange(B * nb, device="cuda", dtype=torch.int32)
              .reshape(B, nb) + 1)
    lens32 = lens.to(torch.int32)
    if kind == "int8":
        paged = paged_decode_attention_quant_fwd(
            q, pool(k), pool(v), pool(ks), pool(vs), tables, lens32)
    else:
        paged = paged_decode_attention_fwd(q, pool(k), pool(v), tables,
                                           lens32)
    assert torch.equal(paged, dense)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("R", [16, 4096])
@pytest.mark.parametrize("D", [3072, 4096, 5120])
def test_rmsnorm_kernel_at_the_new_widths(cuda, D, R, dtype):
    x = _randn(cuda, (R, D), dtype)
    w = (1.0 + 0.1 * _randn(cuda, (D,), torch.float32)).to(dtype)
    got = rmsnorm_fwd(x, w)
    want = ref.rmsnorm_ref(x, w)
    err = ((got.float() - want.float()).abs()
           / want.float().abs().clamp(min=1)).max()
    assert err <= (1e-4 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("arch", ["qwen3-8b", "llama4-scout-17b-a16e"])
def test_head_dim_128_models_on_the_card_match_the_cpu(cuda, arch):
    """The reduced config at head_dim 128 in fp32: one LM step (loss, aux
    and grads) and greedy serving on the card (kernels) against the CPU
    (plain versions); the MoE layer's routing included."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.launch.train import lm_data, to_device
    from repro_torch.models import transformer as T
    from repro_torch.models.modules import tree_leaves, tree_map
    from repro_torch.serving.engine import GenerationEngine, Request
    from repro_torch.training.steps import lm_value_and_grad

    cfg = reduced(get_config(arch)).replace(head_dim=128, remat=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(5))
    batch = next(lm_data(cfg, 40, 0).sft_batches(4, 1))
    rng = np.random.default_rng(6)
    reqs = [Request(uid=i, tokens=rng.integers(0, cfg.vocab_size, lp)
                    .astype(np.int32), max_new_tokens=mn)
            for i, (lp, mn) in enumerate([(8, 6), (16, 4)])]
    runs, streams = {}, {}
    ops.reset_launch_counts()
    for dev in ("cpu", "cuda"):
        p = tree_map(lambda t: t.to(dev), params)
        (loss, met), grads = lm_value_and_grad(cfg, p, to_device(batch, dev))
        runs[dev] = (float(loss), float(met["aux_loss"]),
                     [g.cpu() for g in tree_leaves(grads)])
        eng = GenerationEngine(cfg, max_new_tokens=6, temperature=0.0,
                               chunk=3, device=dev)
        streams[dev] = {c.uid: c.tokens.tolist() for c in eng.serve(
            p, reqs, torch.Generator(device=dev).manual_seed(0), slots=1)}
    counts = ops.launch_counts()
    assert all(counts[k] > 0 for k in ("rmsnorm", "flash_attention_fwd",
                                       "flash_attention_bwd",
                                       "decode_attention_fwd"))
    assert streams["cpu"] == streams["cuda"]
    (lc, ac, gc), (lg, ag, gg) = runs["cpu"], runs["cuda"]
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    assert abs(ag - ac) <= 1e-5 * max(abs(ac), 1e-6)
    for a, b in zip(gg, gc):
        assert (a - b).abs().max() <= 1e-4 * b.abs().max().clamp(min=1e-9)
