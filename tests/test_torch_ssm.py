"""The port's SSM / hybrid serving slice against the reference, on the CPU:
the SSD intra-chunk pass (the kernel's plain version) against the
reference's oracle and its Pallas kernel in interpret mode, the chunked
scan, the Mamba2 mixer, the whole model at the reduced Mamba2-370M,
Zamba2-1.2B and a two-segment hybrid, and serving (exact-length
admission, slot reuse, the fixed and continuous schedulers) against the
reference's greedy decode, on the same weights (carried across through
numpy) and the same numpy-seeded inputs.

Tolerances: the SSD pieces at 1e-4 on Y and S_c and 1e-5 on A_cs (the
reference's own kernel test; sums in another order); a layer in fp32 at
1e-5 of the largest reference value, the model at 2e-5: its decays are
exp of differences of fp32 cumsums reaching ~100 in a 40-token chunk, which
XLA sums as a reduce_window and torch in sequence, each ~5e-6 off, and six
to eight layers compound them (measured: 1.08e-5 at the reduced Zamba2).  bf16 follows R9 (ROADMAP
Queue 3): the port keeps the SSM state in fp32, holding after prefill the
reference's bf16 value."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.ssd_scan import ssd_intra_fwd as j_ssd_intra_fwd
from repro.models import modules as JM
from repro.models import transformer as JT
from repro_torch import configs as tconfigs
from repro_torch.kernels import ops, ref
from repro_torch.kernels.ssd_scan import ssd_intra_fwd
from repro_torch.launch import serve, train
from repro_torch.models import convert
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import GenerationEngine, Request

from _torch_parity import config_pair, jax_greedy, params_pair, to_np

SSD_TOL = dict(y=1e-4, s=1e-4, acs=1e-5)
LAYER_TOL = 1e-5
MODEL_TOL = 2e-5
ARCHS = ("mamba2-370m", "zamba2-1.2b")


def _close(got, want, rel):
    """max |got - want| <= rel * max |want| (fp32 comparison)."""
    got = np.asarray(to_np(got), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def _layout(cfg):
    """A config's segments as plain tuples (the two packages' Segment
    classes differ)."""
    return [(tuple((ls.kind, ls.moe, ls.sliding_window)
                   for ls in seg.unit_spec), seg.n_units)
            for seg in cfg.segments()]


def _ssd_inputs(b, nc, q, h, p, n, seed=0, dt_scale=1.0):
    rng = np.random.default_rng(seed)
    X = (rng.standard_normal((b, nc, q, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, nc, q, h)))).astype(
        np.float32) * np.float32(dt_scale)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, nc, q, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, nc, q, n)) * 0.5).astype(np.float32)
    return X, dt, A, B, C


SSD_SHAPES = [(2, 3, 16, 4, 8, 16), (1, 2, 32, 2, 16, 8),
              (1, 4, 64, 8, 32, 32), (1, 2, 37, 3, 16, 16),
              (2, 1, 1, 4, 8, 16)]


# ------------------------------------------------------------------ #
# the intra-chunk pass
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("against", ["oracle", "pallas"])
@pytest.mark.parametrize("shape", SSD_SHAPES)
def test_ssd_intra_plain_matches_reference(shape, against):
    """The plain version (and the wrapper, which takes it on a CPU tensor)
    against the reference's oracle and its Pallas kernel (interpret)."""
    X, dt, A, B, C = _ssd_inputs(*shape)
    j = [jnp.asarray(a) for a in (X, dt, A, B, C)]
    if against == "oracle":
        yr, sr, cdr, acsr = jref.ssd_intra_ref(*j)
    else:
        yr, sr, acsr = j_ssd_intra_fwd(*j, interpret=True)
        cdr = jnp.exp(acsr[..., -1])
    t = [torch.from_numpy(a) for a in (X, dt, A, B, C)]
    y, s, cd, acs = ref.ssd_intra_ref(*t)
    _close(y, yr, SSD_TOL["y"])
    _close(s, sr, SSD_TOL["s"])
    _close(acs, acsr, SSD_TOL["acs"])
    _close(cd, cdr, SSD_TOL["acs"])
    wy, ws, wacs = ssd_intra_fwd(*t)
    assert torch.equal(wy, y) and torch.equal(ws, s) and torch.equal(wacs,
                                                                     acs)


def test_ssd_intra_bf16_inputs_fp32_dt():
    """bf16 X, B, C with fp32 dt and A: fp32 math, Y back in bf16."""
    X, dt, A, B, C = _ssd_inputs(1, 2, 32, 4, 16, 16, seed=3)
    jb = lambda a: jnp.asarray(a, jnp.bfloat16)
    yr, sr, _, acsr = jref.ssd_intra_ref(jb(X), jnp.asarray(dt),
                                         jnp.asarray(A), jb(B), jb(C))
    tb = lambda a: torch.from_numpy(a).to(torch.bfloat16)
    y, s, _, acs = ref.ssd_intra_ref(tb(X), torch.from_numpy(dt),
                                     torch.from_numpy(A), tb(B), tb(C))
    assert y.dtype == torch.bfloat16 and s.dtype == torch.float32
    assert yr.dtype == jnp.bfloat16
    _close(y.float(), np.asarray(yr, np.float32), SSD_TOL["y"])
    _close(s, sr, SSD_TOL["s"])
    _close(acs, acsr, SSD_TOL["acs"])


def test_ssd_intra_overflowing_upper_triangle_gives_no_nan():
    """dt * |A| large: exp of the upper triangle's positive segment sums
    overflows to inf, which the select drops (a mask multiply would give
    inf * 0 = NaN)."""
    X, dt, A, B, C = _ssd_inputs(1, 1, 64, 4, 8, 16, seed=5, dt_scale=100.0)
    t = [torch.from_numpy(a) for a in (X, dt, A, B, C)]
    acs = ref.ssd_intra_ref(*t)[3]
    assert float((acs[..., 0] - acs[..., -1]).min()) > 89.0   # exp overflows
    y, s, acs = ssd_intra_fwd(*t)
    assert torch.isfinite(y).all() and torch.isfinite(s).all()
    yr, sr, _, acsr = jref.ssd_intra_ref(*[jnp.asarray(a) for a in
                                           (X, dt, A, B, C)])
    _close(y, yr, SSD_TOL["y"])
    _close(s, sr, SSD_TOL["s"])


def test_ssd_intra_refuses_wrong_dtypes():
    X, dt, A, B, C = [torch.from_numpy(a) for a in _ssd_inputs(1, 1, 8, 2,
                                                                4, 8)]
    with pytest.raises(TypeError):
        ssd_intra_fwd(X, dt.double(), A, B, C)
    with pytest.raises(TypeError):
        ssd_intra_fwd(X.bfloat16(), dt, A, B, C)


# ------------------------------------------------------------------ #
# the chunked scan
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("L", [48, 45, 7])
@pytest.mark.parametrize("port", ["ops.ssd_scan", "ssd_chunked"])
def test_ssd_scan_matches_reference(port, L):
    """Ragged L (not a multiple of the chunk) from a nonzero initial state,
    against the reference's jnp ``ssd_chunked`` and its kernel path
    ``kops.ssd_scan`` (Pallas in interpret mode)."""
    rng = np.random.default_rng(L)
    b, h, p, n, chunk = 2, 4, 8, 16, 16
    X = (rng.standard_normal((b, L, h, p)) * 0.5).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, L, h)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32)
    B = (rng.standard_normal((b, L, n)) * 0.5).astype(np.float32)
    C = (rng.standard_normal((b, L, n)) * 0.5).astype(np.float32)
    s0 = rng.standard_normal((b, h, p, n)).astype(np.float32)
    j = [jnp.asarray(a) for a in (X, dt, A, B, C)]
    t = [torch.from_numpy(a) for a in (X, dt, A, B, C)]
    fn = (ops.ssd_scan if port == "ops.ssd_scan"
          else TM.ssd_chunked)
    y, f = fn(*t, chunk, torch.from_numpy(s0))
    assert f.dtype == torch.float32
    for want in (JM.ssd_chunked(*j, chunk, jnp.asarray(s0)),
                 jops.ssd_scan(*j, chunk, jnp.asarray(s0))):
        _close(y, want[0], 1e-4)
        _close(f, want[1], 1e-4)


def test_plain_ssd_chunked_is_differentiable_and_matches_jax_grads():
    """The plain scan is torch ops throughout, so autograd differentiates
    it (the training slice starts from it); its gradients equal JAX's."""
    rng = np.random.default_rng(9)
    b, L, h, p, n, chunk = 1, 20, 2, 4, 8, 8
    arrs = [(rng.standard_normal((b, L, h, p)) * 0.5).astype(np.float32),
            np.log1p(np.exp(rng.standard_normal((b, L, h)))).astype(
                np.float32),
            (-np.exp(rng.standard_normal(h) * 0.3)).astype(np.float32),
            (rng.standard_normal((b, L, n)) * 0.5).astype(np.float32),
            (rng.standard_normal((b, L, n)) * 0.5).astype(np.float32)]
    w = rng.standard_normal((b, L, h, p)).astype(np.float32)
    t = [torch.from_numpy(a).requires_grad_() for a in arrs]
    y, f = TM.ssd_chunked(*t, chunk)
    ((y * torch.from_numpy(w)).sum() + f.sum()).backward()

    def jloss(*a):
        yy, ff = JM.ssd_chunked(*a, chunk)
        return (yy * w).sum() + ff.sum()

    jg = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(
        *[jnp.asarray(a) for a in arrs])
    for tt, g in zip(t, jg):
        _close(tt.grad, g, 1e-4)


def test_kernel_scan_refuses_autograd(monkeypatch):
    """Under autograd the kernel path does not refuse, and does not fall
    back either: ``ops.ssd_scan`` goes through ``SSDIntra``, whose forward
    is the kernel wrapper (on a CPU tensor its plain version, called once
    per pass) and whose backward is the explicit ``ssd_intra_bwd_ref``,
    which never re-runs the forward.  Its gradients, and those of a
    kernel-path model, equal the plain path's."""
    calls = {"fwd": 0, "bwd": 0}
    fwd, bwd = ref.ssd_intra_ref, ref.ssd_intra_bwd_ref

    def spy_fwd(*a):
        calls["fwd"] += 1
        return fwd(*a)

    def spy_bwd(*a):
        calls["bwd"] += 1
        return bwd(*a)

    monkeypatch.setattr(ref, "ssd_intra_ref", spy_fwd)
    monkeypatch.setattr(ref, "ssd_intra_bwd_ref", spy_bwd)
    g = torch.Generator().manual_seed(0)
    X = torch.randn((1, 8, 2, 4), generator=g)
    dt = torch.rand((1, 8, 2), generator=g)
    A = -torch.rand((2,), generator=g) - 0.1
    B, C = torch.randn((2, 1, 8, 8), generator=g)
    leaves = [t.clone().requires_grad_() for t in (X, dt, A, B, C)]
    y, f = ops.ssd_scan(*leaves, 8)
    (y.sum() + f.sum()).backward()
    assert calls == {"fwd": 1, "bwd": 1}
    plain = [t.clone().requires_grad_() for t in (X, dt, A, B, C)]
    yp, fp = TM.ssd_chunked(*plain, 8)
    (yp.sum() + fp.sum()).backward()
    for a, b in zip(leaves, plain):
        _close(a.grad, to_np(b.grad), 1e-5)
    with torch.no_grad():
        ops.ssd_scan(X, dt, A, B, C, 8)
    assert calls == {"fwd": 2, "bwd": 1}

    jcfg, tcfg = config_pair("mamba2-370m", use_kernels=True)
    _, tparams = params_pair(jcfg, seed=0)
    toks = torch.randint(0, jcfg.vocab_size, (1, 40), generator=g)
    w = torch.randn((1, 40, jcfg.d_model), generator=g)
    grads = []
    for c in (tcfg, tcfg.replace(use_kernels=False)):
        p = TM.tree_map(lambda t: t.clone().requires_grad_(), tparams)
        (TT.forward(c, p, tokens=toks)[0] * w).sum().backward()
        grads.append([t.grad for t in TM.tree_leaves(p)])
    assert calls["bwd"] == 1 + jcfg.n_layers
    for a, b in zip(*grads):
        if b is None:                       # the LM head: hidden only
            assert a is None
        else:
            _close(a, to_np(b), 1e-4)


# ------------------------------------------------------------------ #
# the Mamba2 mixer
# ------------------------------------------------------------------ #
def _ssm_layer0(tree):
    return tree["segments"][0][0]["ssm"]


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("mode,L", [("full", 45), ("prefill", 45),
                                    ("prefill", 2), ("decode", 1)])
def test_ssm_apply_matches_reference(mode, L, use_kernels):
    """Full, prefill (a prompt shorter than K-1 zero-pads the conv window)
    and the decode step from a random cache, updated in place."""
    jcfg, tcfg = config_pair("mamba2-370m", use_kernels=use_kernels)
    jparams, tparams = params_pair(jcfg, seed=1)
    jp = jax.tree.map(lambda a: a[0], _ssm_layer0(jparams))
    tp = TM.tree_map(lambda a: a[0], _ssm_layer0(tparams))
    rng = np.random.default_rng(2)
    B = 3
    x = rng.standard_normal((B, L, jcfg.d_model)).astype(np.float32)
    shapes = JM.ssm_cache_shape(jcfg, B)
    cache = {k: rng.standard_normal(s).astype(np.float32)
             for k, s in shapes.items()}
    jout, jc = JM.ssm_apply(jcfg, jp, jnp.asarray(x), mode=mode,
                            cache=None if mode == "full" else
                            {k: jnp.asarray(v) for k, v in cache.items()})
    tcache = None if mode == "full" else {
        k: torch.from_numpy(v.copy()) for k, v in cache.items()}
    tout, tc = TM.ssm_apply(tcfg, tp, torch.from_numpy(x), mode=mode,
                            cache=tcache)
    _close(tout, jout, LAYER_TOL)
    if mode != "full":
        for k in ("conv", "state"):
            _close(tc[k], jc[k], LAYER_TOL)
            assert tc[k] is tcache[k]              # written in place
    if mode == "prefill" and L < jcfg.ssm_conv - 1:
        assert not tc["conv"][:, :jcfg.ssm_conv - 1 - L].any()


# ------------------------------------------------------------------ #
# the model
# ------------------------------------------------------------------ #
def _pair(arch, **kw):
    if arch == "hybrid-2seg":   # 2 units of (2 SSD + attn), then 2 SSD
        return config_pair("zamba2-1.2b", attn_every=3, n_layers=8, **kw)
    return config_pair(arch, **kw)


FWD_B, FWD_LP, FWD_N = 2, 40, 3      # Lp > the reduced ssm_chunk (32)


@functools.lru_cache(maxsize=None)
def _jax_forward_run(arch):
    """The reference's jnp path (jitted) on one token batch: the full
    forward's hidden states, then a prefill and FWD_N decode steps, with
    the final cache; computed once per arch and shared by both port
    variants (kernels on and off)."""
    jcfg, _ = _pair(arch)
    jparams, _ = params_pair(jcfg, seed=3)
    toks = np.random.default_rng(4).integers(
        0, jcfg.vocab_size, (FWD_B, FWD_LP + FWD_N)).astype(np.int32)
    full = jax.jit(lambda p, t: JT.forward(jcfg, p, tokens=t)[0])
    pre = jax.jit(lambda p, t, c: JT.forward(jcfg, p, tokens=t,
                                             mode="prefill", cache=c)[:2])
    dec = jax.jit(lambda p, t, c, pos: JT.forward(
        jcfg, p, tokens=t, mode="decode", cache=c, positions=pos)[:2])
    out = {"full": np.asarray(full(jparams, jnp.asarray(toks)))}
    h, cache = pre(jparams, jnp.asarray(toks[:, :FWD_LP]),
                   JT.init_cache(jcfg, FWD_B, FWD_LP + FWD_N))
    out["prefill"] = np.asarray(h)
    for t in range(FWD_N):
        pos = np.full((FWD_B, 1), FWD_LP + t, np.int32)
        h, cache = dec(jparams, jnp.asarray(toks[:, FWD_LP + t:FWD_LP + t + 1]),
                       cache, jnp.asarray(pos))
        out[f"decode{t}"] = np.asarray(h)
    out["cache"] = [np.asarray(a) for a in jax.tree.leaves(cache)]
    return jcfg, jparams, toks, out


@pytest.mark.parametrize("use_kernels", [False, True])
@pytest.mark.parametrize("arch", [*ARCHS, "hybrid-2seg"])
def test_forward_full_prefill_decode_match_reference(arch, use_kernels):
    """The port (plain code, or the kernel path through the kernels' plain
    versions) against the reference's jnp path: full, prefill, decode and
    the cache they leave."""
    jcfg, jparams, toks, want = _jax_forward_run(arch)
    _, tcfg = _pair(arch, use_kernels=use_kernels)
    if arch == "hybrid-2seg":
        assert [s.n_units for s in tcfg.segments()] == [2, 2]
        assert _layout(tcfg) == _layout(jcfg)
    tparams = convert.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                        "cpu")
    th, _, _ = TT.forward(tcfg, tparams, tokens=torch.from_numpy(toks))
    _close(th, want["full"], MODEL_TOL)
    tcache = TT.init_cache(tcfg, FWD_B, FWD_LP + FWD_N)
    th, tcache, _ = TT.forward(tcfg, tparams,
                               tokens=torch.from_numpy(toks[:, :FWD_LP]),
                               mode="prefill", cache=tcache)
    _close(th, want["prefill"], MODEL_TOL)
    for t in range(FWD_N):
        pos = np.full((FWD_B, 1), FWD_LP + t, np.int32)
        th, tcache, _ = TT.forward(
            tcfg, tparams,
            tokens=torch.from_numpy(toks[:, FWD_LP + t:FWD_LP + t + 1]),
            mode="decode", cache=tcache, positions=torch.from_numpy(pos))
        _close(th, want[f"decode{t}"], MODEL_TOL)
    for a, b in zip(want["cache"], TM.tree_leaves(tcache)):
        _close(b, a, MODEL_TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_greedy_decode_matches_jax(arch):
    """The fixed path (exact-length prefill, then decode) with the kernel
    path on, against the reference's greedy decode (jnp path)."""
    jcfg, tcfg = config_pair(arch)
    tcfg = tcfg.replace(use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=5)
    prompt = np.random.default_rng(6).integers(0, jcfg.vocab_size,
                                               37).astype(np.int32)
    eng = GenerationEngine(tcfg, max_new_tokens=10, temperature=0.0,
                           device="cpu")
    out = eng.generate(tparams, prompt[None], torch.Generator())
    got = out["sequences"][0, 37:].tolist()
    assert got == jax_greedy(jcfg, jparams, prompt, 10)


def test_bf16_state_follows_r9():
    """bf16: the reference's state is bf16 after prefill and fp32 after one
    decode step (its bf16 state times the fp32 decay).  The port's arena is
    fp32 throughout and holds, after prefill, the reference's bf16 value;
    after the decode step both carry fp32."""
    jcfg, tcfg = config_pair("mamba2-370m", use_kernels=True,
                             compute_dtype="bfloat16")
    jparams, tparams = params_pair(jcfg, seed=7)
    B, Lp = 2, 40
    toks = np.random.default_rng(8).integers(0, jcfg.vocab_size,
                                             (B, Lp + 1)).astype(np.int32)
    jcache = JT.init_cache(jcfg, B, Lp + 1)
    tcache = TT.init_cache(tcfg, B, Lp + 1)
    _, jcache, _ = JT.forward(jcfg, jparams, tokens=jnp.asarray(toks[:, :Lp]),
                              mode="prefill", cache=jcache)
    th, tcache, _ = TT.forward(tcfg, tparams,
                               tokens=torch.from_numpy(toks[:, :Lp]),
                               mode="prefill", cache=tcache)
    js, ts = jcache[0][0]["state"], tcache[0][0]["state"]
    assert js.dtype == jnp.bfloat16 and ts.dtype == torch.float32
    assert tcache[0][0]["conv"].dtype == torch.bfloat16
    assert torch.equal(ts, ts.to(torch.bfloat16).float())  # a bf16 value
    _close(ts, np.asarray(js, np.float32), 2e-2)
    pos = np.full((B, 1), Lp, np.int32)
    jh, jcache, _ = JT.forward(jcfg, jparams,
                               tokens=jnp.asarray(toks[:, Lp:]),
                               mode="decode", cache=jcache,
                               positions=jnp.asarray(pos))
    th, tcache, _ = TT.forward(tcfg, tparams,
                               tokens=torch.from_numpy(toks[:, Lp:]),
                               mode="decode", cache=tcache,
                               positions=torch.from_numpy(pos))
    js, ts = jcache[0][0]["state"], tcache[0][0]["state"]
    assert js.dtype == jnp.float32 and ts.dtype == torch.float32
    _close(ts, np.asarray(js), 2e-2)
    _close(th.float(), np.asarray(jh, np.float32), 5e-2)


# ------------------------------------------------------------------ #
# serving
# ------------------------------------------------------------------ #
def _requests(vocab, lens, budgets, seed=11):
    rng = np.random.default_rng(seed)
    return [Request(uid=i, tokens=rng.integers(0, vocab, lp).astype(np.int32),
                    max_new_tokens=mn)
            for i, (lp, mn) in enumerate(zip(lens, budgets))]


@pytest.fixture(scope="module", params=ARCHS)
def served(request):
    """The port with its kernel path on, the reference's greedy decode on
    its jnp path (their agreement with the Pallas path is the reference's
    own test)."""
    jcfg, tcfg = config_pair(request.param)
    tcfg = tcfg.replace(use_kernels=True)
    jparams, tparams = params_pair(jcfg, seed=12)
    # ragged, one prompt longer than the reduced ssm_chunk (32), one token
    reqs = _requests(jcfg.vocab_size, [5, 47, 1, 20, 33, 9],
                     [6, 4, 7, 5, 3, 6])
    want = {r.uid: jax_greedy(jcfg, jparams, r.tokens, r.max_new_tokens)
            for r in reqs}
    return tcfg, tparams, reqs, want


@pytest.mark.parametrize("mode", ["continuous", "fixed"])
def test_serve_ragged_matches_per_request_greedy(served, mode):
    tcfg, tparams, reqs, want = served
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0,
                           chunk=3, device="cpu")
    S = max(len(r.tokens) + r.max_new_tokens for r in reqs)
    n_tok, stats, _, done = serve.run_schedule(
        eng, tparams, reqs, torch.Generator(), mode=mode, slots=2,
        max_seq_len=S)
    assert {u: t for u, t in done.items()} == want
    assert n_tok == sum(r.max_new_tokens for r in reqs)


def test_reused_slot_does_not_leak_state(served):
    """One slot serves the requests one after another: each admission
    overwrites the slot's conv and state rows, so every stream equals the
    request served alone on a fresh core."""
    tcfg, tparams, reqs, want = served
    eng = GenerationEngine(tcfg, max_new_tokens=8, temperature=0.0,
                           chunk=4, device="cpu")
    outs = eng.serve(tparams, reqs, torch.Generator(), slots=1)
    assert {o.uid: o.tokens.tolist() for o in outs} == want
    alone = eng.serve(tparams, reqs[3:4], torch.Generator(), slots=1)
    assert alone[0].tokens.tolist() == want[3]


def test_admission_prefills_at_the_exact_length(served, monkeypatch):
    tcfg, tparams, reqs, _ = served
    eng = GenerationEngine(tcfg, max_new_tokens=4, temperature=0.0,
                           device="cpu")
    assert eng._exact_prefill
    seen = []
    orig = eng._prefill_row

    def spy(params, tokens, length, row, positions=None, **kw):
        seen.append((tokens.shape[1], length))
        return orig(params, tokens, length, row, positions, **kw)

    monkeypatch.setattr(eng, "_prefill_row", spy)
    eng.serve(tparams, reqs, torch.Generator(), slots=2)
    assert seen and all(w == n for w, n in seen)


# ------------------------------------------------------------------ #
# refusals, configs, launchers
# ------------------------------------------------------------------ #
@pytest.mark.parametrize("arch", ARCHS)
def test_paged_and_prefix_cache_are_refused(arch):
    _, tcfg = config_pair(arch)
    with pytest.raises(NotImplementedError):
        GenerationEngine(tcfg, max_new_tokens=4, kv_layout="paged",
                         device="cpu")
    with pytest.raises(NotImplementedError):
        GenerationEngine(tcfg, max_new_tokens=4, kv_layout="paged",
                         prefix_cache=True, device="cpu")
    with pytest.raises(NotImplementedError):
        TT.paged_cache_struct(tcfg, 4, 16)
    with pytest.raises(NotImplementedError):
        serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                    "--requests", "2", "--max-new", "2", "--kv-layout",
                    "paged"])


@pytest.mark.parametrize("launcher,argv", [
    ("serve", ["--kv-quant"]),
    ("train", ["--steps", "1"]),
])
@pytest.mark.parametrize("arch", ARCHS)
def test_launchers_refuse_what_is_not_ported(arch, launcher, argv, capsys):
    """Both launchers take the SSM and hybrid ids as the reference does:
    ``serve --kv-quant`` serves (int8 K/V rows for the hybrid's attention
    layers), on a 1 x 1 mesh too (a one-rank group in this process: the
    same completions), and ``train`` trains.  ``train`` refuses
    ``--rollout-mesh`` without ``--train-mesh`` (they go together);
    ``serve`` refuses a malformed ``--mesh``."""
    base = ["--device", "cpu", "--arch", arch, "--reduced", *argv]
    if launcher == "serve":
        run = [*base, "--requests", "3", "--max-new", "3", "--prompt-len",
               "12"]
        res = serve.main(run)
        assert res["tokens"] == 9
        on_mesh = serve.main([*run, "--mesh", "1,1"])
        assert on_mesh["completions"] == res["completions"]
        assert on_mesh["stats"] == res["stats"]
        capsys.readouterr()
        with pytest.raises(SystemExit) as e:
            serve.main([*base, "--mesh", "1x1"])
        assert e.value.code == 2
        assert "expects 'dp,tp'" in capsys.readouterr().err
        return
    res = train.main([*base, "--batch", "2", "--seq", "16"])
    assert len(res["loss"]) == 1 and np.isfinite(res["loss"]).all()
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        train.main([*base, "--rollout-mesh", "2"])
    assert e.value.code == 2
    assert "--rollout-mesh and --train-mesh go together" in \
        capsys.readouterr().err


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    j, t = jconfigs.get_config(arch), tconfigs.get_config(arch)
    for cj, ct in ((j, t), (jconfigs.reduced(j), tconfigs.reduced(t))):
        for f in ("name", "arch_type", "n_layers", "d_model", "n_heads",
                  "n_kv_heads", "head_dim", "d_ff", "vocab_size",
                  "ssm_state", "ssm_expand", "ssm_headdim", "ssm_conv",
                  "ssm_chunk", "ssm_ngroups", "attn_every", "logit_chunk",
                  "compute_dtype", "param_dtype", "rms_eps", "rope_theta"):
            assert getattr(cj, f) == getattr(ct, f), f
        assert cj.n_params() == ct.n_params()
        assert _layout(cj) == _layout(ct)
    expect = {"mamba2-370m": 419_825_152, "zamba2-1.2b": 1_352_519_680}
    assert t.n_params() == expect[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_ssm_params_cross_bitwise(arch):
    jcfg, _ = config_pair(arch)
    jparams, tparams = params_pair(jcfg, seed=13)
    back = convert.params_to_numpy(tparams)
    jl = jax.tree_util.tree_leaves_with_path(
        jax.tree.map(np.asarray, jparams))
    tl = jax.tree.leaves(back)
    names = set()
    for (path, a), b in zip(jl, tl):
        names.add(str(path[-1]))
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a.view(np.uint32), b.view(np.uint32))
    for leaf in ("A_log", "D_skip", "dt_bias", "conv_w", "conv_b",
                 "out_norm", "w_in", "w_out"):
        assert f"['{leaf}']" in names


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_cli_runs_on_cpu(arch, capsys):
    res = serve.main(["--device", "cpu", "--arch", arch, "--reduced",
                      "--requests", "5", "--ragged", "--prompt-len", "40",
                      "--max-new", "6", "--batch", "2"])
    assert res["tokens"] == sum(r.max_new_tokens for r in res["requests"])
    assert "tok/s" in capsys.readouterr().out
