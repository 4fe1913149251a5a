"""The port's kernel wrappers on CPU tensors (their plain versions) against
the reference's Pallas kernels run in interpret mode, and against the
reference's jnp oracles in ``repro/kernels/ref.py``.  fp32, atol = rtol =
1e-5: the same math, summed in another order.  Shapes cover GQA groups of
1 and 3, lengths that are not powers of two, rectangular (Lq < Lk) causal
attention and ragged decode masks with a fully masked row."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention_fwd as j_decode
from repro.kernels.flash_attention import flash_attention_fwd as j_flash
from repro.kernels.rmsnorm import rmsnorm_fwd as j_rmsnorm
from repro_torch.kernels import ops as tops
from repro_torch.kernels.decode_attention import decode_attention_fwd
from repro_torch.kernels.flash_attention import flash_attention_fwd
from repro_torch.kernels.rmsnorm import rmsnorm_fwd

TOL = dict(rtol=1e-5, atol=1e-5)


def _normal(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("R", [1, 7, 256])
@pytest.mark.parametrize("D", [256, 576])
def test_rmsnorm_plain_matches_pallas_and_ref(R, D):
    rng = np.random.default_rng(R * 1000 + D)
    x, w = _normal(rng, (R, D)), _normal(rng, (D,))
    got = rmsnorm_fwd(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    pallas = j_rmsnorm(jnp.asarray(x), jnp.asarray(w), row_block=R,
                       interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.rmsnorm_ref(jnp.asarray(x), jnp.asarray(w))),
        **TOL)


FLASH_CASES = [
    # B, KV, G, Lq, Lk, causal, window
    (2, 2, 1, 24, 24, True, None),
    (1, 2, 3, 40, 40, True, 9),
    (2, 1, 3, 12, 40, True, None),        # rectangular: q_offset = 28
    (1, 3, 1, 20, 44, True, 13),          # rectangular + window
    (1, 2, 3, 24, 24, False, None),
    (1, 1, 3, 28, 28, False, 7),
]


@pytest.mark.parametrize("B,KV,G,Lq,Lk,causal,window", FLASH_CASES)
def test_flash_attention_plain_matches_pallas_and_ref(B, KV, G, Lq, Lk,
                                                      causal, window):
    rng = np.random.default_rng(Lq * 100 + Lk)
    D = 32
    q = _normal(rng, (B, KV, G, Lq, D))
    k, v = _normal(rng, (B, KV, Lk, D)), _normal(rng, (B, KV, Lk, D))
    got = flash_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=causal,
                              window=window).numpy()
    jq, jk, jv = map(jnp.asarray, (q, k, v))
    pallas = j_flash(jq, jk, jv, causal=causal, window=window, q_block=Lq,
                     k_block=Lk, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.flash_attention_ref(jq, jk, jv, causal=causal,
                                                 window=window)), **TOL)


DECODE_CASES = [
    # B, KV, G, S
    (3, 2, 1, 37),
    (4, 1, 3, 53),
    (2, 3, 3, 29),
]


def _ragged_valid(rng, B, S):
    nv = rng.integers(1, S + 1, size=B)
    nv[0] = 0                            # fully masked: mean of V
    nv[-1] = S
    return np.arange(S)[None] < nv[:, None]


@pytest.mark.parametrize("B,KV,G,S", DECODE_CASES)
def test_decode_attention_plain_matches_pallas_and_ref(B, KV, G, S):
    rng = np.random.default_rng(B * 100 + S)
    D = 32
    q = _normal(rng, (B, KV, G, D))
    k, v = _normal(rng, (B, KV, S, D)), _normal(rng, (B, KV, S, D))
    valid = _ragged_valid(rng, B, S)
    got = decode_attention_fwd(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v),
                               torch.from_numpy(valid)).numpy()
    jq, jk, jv, jvalid = map(jnp.asarray, (q, k, v, valid))
    pallas = j_decode(jq, jk, jv, jvalid, s_block=S, interpret=True)
    np.testing.assert_allclose(got, np.asarray(pallas), **TOL)
    np.testing.assert_allclose(
        got, np.asarray(jref.decode_attention_ref(jq, jk, jv, jvalid)),
        **TOL)
    # the fully masked row averages V (the reference's finite -1e30 mask)
    np.testing.assert_allclose(got[0], np.broadcast_to(
        v[0].mean(axis=1)[:, None], (KV, G, D)), **TOL)


@pytest.mark.parametrize("B,KV,G,Lq,Lk,causal,window",
                         [c for c in FLASH_CASES if c[5]])
def test_ops_flash_adapter_matches_reference_ops(B, KV, G, Lq, Lk, causal,
                                                 window):
    """Model layout (B, L, H, D) through the port's view-only adapter vs
    the reference's transposing adapter (Pallas, interpret mode)."""
    rng = np.random.default_rng(7 + Lq)
    D = 32
    q = _normal(rng, (B, Lq, KV * G, D))
    k, v = _normal(rng, (B, Lk, KV, D)), _normal(rng, (B, Lk, KV, D))
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=True,
                               window=window).numpy()
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                jnp.asarray(v), causal=True, window=window)
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


@pytest.mark.parametrize("B,KV,G,S", DECODE_CASES)
def test_ops_decode_adapter_reads_arena_in_place(B, KV, G, S):
    """q (B, H, D) and the (B, S, KV, D) arena through the port's adapter
    (strided views, no copy) vs the reference's adapter."""
    rng = np.random.default_rng(11 + S)
    D = 32
    q = _normal(rng, (B, KV * G, D))
    k, v = _normal(rng, (B, S, KV, D)), _normal(rng, (B, S, KV, D))
    valid = _ragged_valid(rng, B, S)
    tk, tv = torch.from_numpy(k), torch.from_numpy(v)
    got = tops.decode_attention(torch.from_numpy(q), tk, tv,
                                torch.from_numpy(valid)).numpy()
    want = jops.decode_attention(*map(jnp.asarray, (q, k, v, valid)))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)
    # the views the kernel gets share the arena's storage
    assert tk.transpose(1, 2).data_ptr() == tk.data_ptr()


@pytest.mark.parametrize("shape", [(2, 5, 256), (3, 576)])
def test_ops_rmsnorm_matches_reference_ops(shape):
    rng = np.random.default_rng(len(shape))
    x, w = _normal(rng, shape), _normal(rng, shape[-1:])
    got = tops.rmsnorm(torch.from_numpy(x), torch.from_numpy(w)).numpy()
    want = jops.rmsnorm(jnp.asarray(x), jnp.asarray(w))
    np.testing.assert_allclose(got, np.asarray(want), **TOL)


def test_cpu_tensors_never_launch_a_kernel():
    """The plain versions run only because the tensors lie on the CPU, and
    they do not count as launches."""
    tops.reset_launch_counts()
    x = torch.randn(4, 64)
    tops.rmsnorm(x, torch.ones(64))
    tops.flash_attention(torch.randn(1, 8, 2, 32), torch.randn(1, 8, 2, 32),
                         torch.randn(1, 8, 2, 32))
    tops.decode_attention(torch.randn(1, 2, 32), torch.randn(1, 8, 2, 32),
                          torch.randn(1, 8, 2, 32),
                          torch.ones(1, 8, dtype=torch.bool))
    tops.decode_attention_quant(
        torch.randn(1, 2, 32), torch.zeros(1, 8, 2, 32, dtype=torch.int8),
        torch.zeros(1, 8, 2, 32, dtype=torch.int8), torch.ones(1, 8, 2),
        torch.ones(1, 8, 2), torch.ones(1, 8, dtype=torch.bool))
    tables = torch.tensor([[1, 2]], dtype=torch.int32)
    lens = torch.tensor([7], dtype=torch.int32)
    tops.paged_decode_attention(torch.randn(1, 2, 32),
                                torch.randn(3, 4, 2, 32),
                                torch.randn(3, 4, 2, 32), tables, lens)
    tops.paged_decode_attention_quant(
        torch.randn(1, 2, 32), torch.zeros(3, 4, 2, 32, dtype=torch.int8),
        torch.zeros(3, 4, 2, 32, dtype=torch.int8), torch.ones(3, 4, 2),
        torch.ones(3, 4, 2), tables, lens)
    q = torch.randn(1, 8, 2, 32, requires_grad=True)
    tops.FlashAttention.apply(q, torch.randn(1, 8, 2, 32),
                              torch.randn(1, 8, 2, 32)).sum().backward()
    tops.ssd_scan(torch.randn(1, 9, 2, 4), torch.rand(1, 9, 2),
                  -torch.rand(2), torch.randn(1, 9, 8), torch.randn(1, 9, 8),
                  4)
    assert tops.launch_counts() == {"rmsnorm": 0, "flash_attention_fwd": 0,
                                    "flash_attention_bwd": 0,
                                    "decode_attention_fwd": 0,
                                    "decode_attention_quant_fwd": 0,
                                    "paged_decode_attention_fwd": 0,
                                    "paged_decode_attention_quant_fwd": 0,
                                    "ssd_intra_fwd": 0}


@pytest.mark.parametrize("bad", ["head_dim", "group", "dtype", "device",
                                 "misaligned"])
def test_wrappers_reject_what_the_kernels_do_not_take(bad):
    """The checks run before the device dispatch, so the CPU path refuses
    exactly what the CUDA kernels would."""
    B, KV, G, S, D = 2, 2, 1, 16, 32
    q = torch.randn(B, KV, G, D)
    k, v = torch.randn(B, KV, S, D), torch.randn(B, KV, S, D)
    valid = torch.ones(B, S, dtype=torch.bool)
    if bad == "head_dim":
        q, k, v = q[..., :24], k[..., :24], v[..., :24]
    elif bad == "group":
        q = torch.randn(B, 1, 9, D)
        k, v = torch.randn(B, 1, S, D), torch.randn(B, 1, S, D)
    elif bad == "dtype":
        q, k, v = q.half(), k.half(), v.half()
    elif bad == "device":
        q, k, v = (t.to("meta") for t in (q, k, v))
        valid = valid.to("meta")
    elif bad == "misaligned":                 # rows off 16-byte boundaries
        k = torch.randn(B, KV, S, D + 1)[..., 1:]
    with pytest.raises((ValueError, TypeError)):
        decode_attention_fwd(q, k, v, valid)


@pytest.mark.parametrize("case", ["model_layout", "size1_dims", "fp32",
                                  "odd_start", "odd_row_stride",
                                  "odd_head_stride"])
def test_bf16_flash_needs_what_its_copies_take(case):
    """The bf16 flash kernels copy 16-byte chunks: the wrappers refuse a
    bf16 operand that does not start on a 16-byte boundary or has a stride
    (but D's) off a multiple of 8 elements, before the device dispatch, as
    the kernels would; strides of size-1 dimensions do not count, and fp32
    (the CUDA-core kernels) takes any start."""
    from repro_torch.kernels.flash_attention_bwd import flash_attention_bwd
    dt = torch.float32 if case == "fp32" else torch.bfloat16
    B, L, KV, G, D = 1, 9, 2, 2, 32
    q = torch.randn(B, L, KV * G, D).to(dt).unflatten(2, (KV, G)).permute(
        0, 2, 3, 1, 4)                               # the adapter's view
    if case == "size1_dims":
        q = torch.randn(KV * G * L * D).to(dt).as_strided(
            (1, KV, G, L, D), (3, G * L * D, L * D, D, 1))
    elif case in ("odd_start", "fp32"):
        q = torch.randn(B, KV, G, L, D + 1).to(dt)[..., 1:]
    elif case == "odd_row_stride":
        q = torch.randn(B, KV, G, L, D + 4).to(dt)[..., :D]
    elif case == "odd_head_stride":
        q = torch.randn(B, KV, G * L * D + 4).to(dt)[..., :G * L * D]
        q = q.unflatten(2, (G, L, D))
    k = torch.randn(B, KV, L, D).to(dt)
    lse = torch.zeros(B, KV, G, L)
    if case in ("model_layout", "size1_dims", "fp32"):
        flash_attention_fwd(q, k, k)
        flash_attention_bwd(q, k, k, q, lse, lse)
        return
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_fwd(q, k, k)
    with pytest.raises(ValueError, match="16-byte"):
        flash_attention_bwd(q, k, k, q, lse, lse)


def test_kernel_build_failures_raise(monkeypatch, tmp_path):
    """No nvcc, or an nvcc that fails, is an exception, never a silent
    fallback; a failed build leaves no library behind."""
    from repro_torch.kernels import build
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build, "nvcc_path", lambda: "false")  # exits 1
    with pytest.raises(RuntimeError, match="kernel build failed"):
        build.build(("rmsnorm", "decode_attention"))
    assert not list(tmp_path.iterdir())
    monkeypatch.undo()
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.Path, "is_file", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.build(("rmsnorm",))


def test_kernel_library_name_tracks_its_sources():
    from repro_torch.kernels import build
    paths = {n: build.lib_path(n) for n in build.SOURCES}
    assert len(set(paths.values())) == len(build.SOURCES)
    assert all(p.parent == build.BUILD_DIR and p.suffix == ".so"
               for p in paths.values())
