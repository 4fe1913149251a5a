"""Plain PyTorch versions of the ported kernels, in the kernels' grouped
layouts (counterparts of ``repro/kernels/ref.py``).

Each is the same function as its CUDA kernel, written as ordinary tensor
code: the kernel wrappers take them for CPU tensors, the CPU tests hold
them to the reference's oracles, and ``chip_smoke.py`` holds each kernel to
them on the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def _mask(Lq, Lk, causal, window, device):
    """(Lq, Lk) bool: query i sits at position i + Lk - Lq."""
    qpos = torch.arange(Lq, device=device) + (Lk - Lq)
    kpos = torch.arange(Lk, device=device)
    mask = torch.ones((Lq, Lk), dtype=torch.bool, device=device)
    if causal:
        mask &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        mask &= (qpos[:, None] - kpos[None, :]) < window
    return mask


def _scores(q, k, causal, window):
    """Masked, scaled fp32 scores (B, KV, G, Lq, Lk) and the mask."""
    Lq, D = q.shape[3], q.shape[4]
    s = torch.einsum("bkgqd,bksd->bkgqs", q.float(), k.float()) / math.sqrt(D)
    mask = _mask(Lq, k.shape[2], causal, window, q.device)
    return torch.where(mask, s, NEG_INF), mask


def flash_attention_ref(q, k, v, *, causal=True, window=None):
    """q: (B, KV, G, Lq, D); k, v: (B, KV, Lk, D) -> (B, KV, G, Lq, D).
    Queries align to the end of the keys: qpos = arange(Lq) + Lk - Lq."""
    s, _ = _scores(q, k, causal, window)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bksd->bkgqd", p, v.float())
    return o.to(q.dtype)


def flash_attention_lse_ref(q, k, *, causal=True, window=None):
    """The forward's log-sum-exp of the masked scaled scores,
    (B, KV, G, Lq) fp32: ``m + log(l)`` of the online softmax."""
    s, _ = _scores(q, k, causal, window)
    return torch.logsumexp(s, dim=-1)


def flash_attention_bwd_ref(q, k, v, do, lse, delta, *, causal=True,
                            window=None):
    """FlashAttention-2 backward from the saved ``lse`` and ``delta =
    rowsum(dO * O)`` (both (B, KV, G, Lq) fp32), the math of
    ``repro/kernels/flash_attention_bwd.py``: p = exp(s - lse), exactly 0
    where masked (an all-masked row's lse is taken as 0); ds = p (dp -
    delta) scale.  q, do: (B, KV, G, Lq, D); k, v: (B, KV, Lk, D).
    Returns (dq, dk, dv) in the dtypes of q, k, v; dk and dv sum over the
    G query heads of each KV group."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    s, mask = _scores(q, k, causal, window)
    lse = lse.float()
    lse_safe = torch.where(lse <= NEG_INF / 2, 0.0, lse)
    p = torch.where(mask, torch.exp(s - lse_safe[..., None]), 0.0)
    do32 = do.float()
    dv = torch.einsum("bkgqs,bkgqd->bksd", p, do32)
    dp = torch.einsum("bkgqd,bksd->bkgqs", do32, v.float())
    ds = p * (dp - delta.float()[..., None]) * scale
    dq = torch.einsum("bkgqs,bksd->bkgqd", ds, k.float())
    dk = torch.einsum("bkgqs,bkgqd->bksd", ds, q.float())
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def rmsnorm_bwd_ref(x, w, dy, eps=1e-5):
    """Backward of :func:`rmsnorm_ref` in fp32: (dx in x's dtype, dw in
    w's dtype); x, dy: (R, D), w: (D,)."""
    x32, w32, dy32 = x.float(), w.float(), dy.float()
    r = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    xhat = x32 * r
    dw = torch.sum(dy32 * xhat, dim=0)
    g = dy32 * w32
    dx = r * (g - xhat * torch.mean(g * xhat, dim=-1, keepdim=True))
    return dx.to(x.dtype), dw.to(w.dtype)


def decode_attention_ref(q, k_cache, v_cache, valid):
    """q: (B, KV, G, D); caches: (B, KV, S, D); valid: (B, S) bool."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(),
                     k_cache.float()) / math.sqrt(D)
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def decode_attention_quant_ref(q, k_cache, v_cache, k_scale, v_scale,
                               valid):
    """Decode over an int8 cache.  q: (B, KV, G, D) fp; caches: (B, KV, S,
    D) int8; scales: (B, KV, S) fp32; valid: (B, S) bool.  The scales
    multiply the score and probability matrices (the kernel's algebra),
    never a dequantized K/V copy."""
    D = q.shape[-1]
    s = torch.einsum("bkgd,bksd->bkgs", q.float(),
                     k_cache.float()) / math.sqrt(D)
    s = s * k_scale.float()[:, :, None, :]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1) * v_scale.float()[:, :, None, :]
    o = torch.einsum("bkgs,bksd->bkgd", p, v_cache.float())
    return o.to(q.dtype)


def gather_blocks(pool, block_tables):
    """(nblocks, bs, ...) pool rows of each sequence's table, as a dense
    virtual cache (B, nb * bs, ...)."""
    B, nb = block_tables.shape
    g = pool[block_tables.long()]                 # (B, nb, bs, ...)
    return g.reshape(B, nb * pool.shape[1], *pool.shape[2:])


def lens_mask(lens, S):
    """(B, S) bool: the first ``lens[b]`` rows of each sequence."""
    return torch.arange(S, device=lens.device)[None, :] < lens[:, None]


def paged_decode_attention_ref(q, k_pool, v_pool, block_tables, lens):
    """q: (B, KV, G, D); pools: (nblocks, bs, KV, D); block_tables: (B, nb)
    int32; lens: (B,) int32.  Gathers each sequence's blocks into a dense
    virtual cache and reuses the dense decode (the reference oracle's
    answer, including ``lens = 0``: the mean of V, where the kernels return
    zeros)."""
    k_virt = gather_blocks(k_pool, block_tables)     # (B, S, KV, D)
    v_virt = gather_blocks(v_pool, block_tables)
    valid = lens_mask(lens, k_virt.shape[1])
    return decode_attention_ref(q, k_virt.transpose(1, 2),
                                v_virt.transpose(1, 2), valid)


def paged_decode_attention_quant_ref(q, k_pool, v_pool, k_scale, v_scale,
                                     block_tables, lens):
    """Int8 paged decode.  q: (B, KV, G, D); pools: (nblocks, bs, KV, D)
    int8; scale planes: (nblocks, bs, KV) fp32, gathered through the same
    tables; block_tables: (B, nb) int32; lens: (B,) int32."""
    k_virt = gather_blocks(k_pool, block_tables)
    v_virt = gather_blocks(v_pool, block_tables)
    ks_virt = gather_blocks(k_scale, block_tables)   # (B, S, KV)
    vs_virt = gather_blocks(v_scale, block_tables)
    valid = lens_mask(lens, k_virt.shape[1])
    return decode_attention_quant_ref(
        q, k_virt.transpose(1, 2), v_virt.transpose(1, 2),
        ks_virt.transpose(1, 2), vs_virt.transpose(1, 2), valid)


def rmsnorm_ref(x, w, eps=1e-5):
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps) * w.float()).to(x.dtype)


def chunk_cumsum(dA):
    """Cumulative sum over the last axis, accumulated in fp64 and rounded
    once to fp32: the correctly rounded cumsum, whatever order a kernel
    sums in (``csrc/ssd_intra.cu`` rounds a fp64 scan the same way).  The
    SSD decays are exp of differences of these sums, which reach ~100 in a
    chunk, so an ulp here is 1e-5 of a decay; an fp32 scan in another
    order moves a 48-layer model's logits by ~2e-4.  Differentiable."""
    return torch.cumsum(dA.double(), -1).to(dA.dtype)


def _lower_decay(A_cs):
    """(..., q) -> (..., q, q): exp(A_cs[i] - A_cs[j]) for i >= j, else 0.
    The segment sums above the diagonal are set to -inf before the
    ``exp``: never a 0/1 mask multiply, nor a select after the ``exp`` (a
    positive segment sum may overflow, and inf * 0 is NaN, in a product
    or in autograd's gradient of the select)."""
    q = A_cs.shape[-1]
    tri = torch.ones((q, q), dtype=torch.bool, device=A_cs.device).tril()
    d = A_cs[..., :, None] - A_cs[..., None, :]
    return torch.exp(torch.where(tri, d, -math.inf))


def ssd_intra_ref(X, dt, A, B, C):
    """Intra-chunk SSD (the oracle of ``repro/kernels/ref.py``), in fp32.

    X: (b, nc, q, h, p)  dt: (b, nc, q, h) fp32  A: (h,) fp32
    B, C: (b, nc, q, n) (ngroups = 1: shared by every head).
    Returns (Y_diag (b,nc,q,h,p) in X's dtype, S_c (b,nc,h,p,n),
    chunk_decay (b,nc,h), A_cs (b,nc,h,q)), the last three fp32.  The
    decay above the diagonal is exactly 0, with a zero gradient
    (:func:`_lower_decay`)."""
    dA = (dt * A).permute(0, 1, 3, 2)                    # (b,nc,h,q)
    Xd = X.float() * dt[..., None]
    A_cs = chunk_cumsum(dA)
    Ldec = _lower_decay(A_cs)                            # (b,nc,h,q,q)
    scores = torch.einsum("bcqn,bckn->bcqk", C.float(), B.float())
    Y_diag = torch.einsum("bchqk,bckhp->bcqhp", scores[:, :, None] * Ldec,
                          Xd)
    decay_states = torch.exp(A_cs[..., -1:] - A_cs)      # (b,nc,h,q)
    S_c = torch.einsum("bchq,bcqn,bcqhp->bchpn", decay_states, B.float(),
                       Xd)
    chunk_decay = torch.exp(A_cs[..., -1])
    return Y_diag.to(X.dtype), S_c, chunk_decay, A_cs


def ssd_intra_bwd_ref(X, dt, A, B, C, A_cs, dY, dS, dAcs):
    """Backward of the intra-chunk pass (:func:`ssd_intra_ref`), written
    out in fp32 as batched products: it never re-runs the forward.

    Inputs as :func:`ssd_intra_ref`'s, with the forward's ``A_cs`` and the
    gradients of its three outputs: dY (b,nc,q,h,p), dS (b,nc,h,p,n), dAcs
    (b,nc,h,q).  Returns (dX in X's dtype, ddt fp32, dA fp32, dB and dC in
    B's dtype).  Per (batch, chunk, head), with Xd = X dt, G = C B^T, L[i,j]
    = exp(A_cs[i] - A_cs[j]) for i >= j (else 0), W = G L and w =
    exp(A_cs[q-1] - A_cs):

        dW  = dY Xd^T                 dXd = W^T dY + w (B dS^T)
        dC  = (dW L) B                dB  = (dW L)^T C + (w Xd) dS
        dA_cs = rowsum(E) - colsum(E) + the w terms + dAcs, E = dW G L

    then a reverse cumsum takes dA_cs to d(dt A); B and C are shared by
    every head, so their gradients sum over h.  L is the forward's
    (:func:`_lower_decay`), so an overflowing upper triangle gives no
    NaN."""
    Xd = X.float() * dt[..., None]                       # (b,nc,q,h,p)
    B32, C32, dY32 = B.float(), C.float(), dY.float()
    dS32, A_cs = dS.float(), A_cs.float()
    L = _lower_decay(A_cs)                               # (b,nc,h,q,q)
    G = torch.einsum("bcqn,bckn->bcqk", C32, B32)        # (b,nc,q,q)
    w = torch.exp(A_cs[..., -1:] - A_cs)                 # (b,nc,h,q)
    BdS = torch.einsum("bckn,bchpn->bckhp", B32, dS32)   # B dS^T per head
    dXd = (torch.einsum("bcqk,bchqk,bcqhp->bckhp", G, L, dY32)
           + w.permute(0, 1, 3, 2)[..., None] * BdS)
    dWL = torch.einsum("bcqhp,bckhp->bchqk", dY32, Xd).mul_(L)   # dW * L
    dG = dWL.sum(2)                                      # (b,nc,q,q)
    dC = torch.einsum("bcqk,bckn->bcqn", dG, B32)
    dB = (torch.einsum("bcqk,bcqn->bckn", dG, C32)
          + torch.einsum("bchk,bckhp,bchpn->bckn", w, Xd, dS32))
    E = dWL.mul_(G[:, :, None])                          # dW * G * L
    dw_w = w * torch.einsum("bckhp,bckhp->bchk", Xd, BdS)  # dL/dw * w
    d_acs = E.sum(-1) - E.sum(-2) - dw_w + dAcs.float()
    d_acs[..., -1] += dw_w.sum(-1)
    d_dA = torch.flip(torch.cumsum(torch.flip(d_acs, (-1,)), -1), (-1,))
    d_dA = d_dA.permute(0, 1, 3, 2)                      # (b,nc,q,h)
    ddt = d_dA * A + (dXd * X.float()).sum(-1)
    dA = (d_dA * dt).sum((0, 1, 2))
    dX = dXd * dt[..., None]
    return dX.to(X.dtype), ddt, dA, dB.to(B.dtype), dC.to(C.dtype)


def ssd_chunks(X, dt, B, C, chunk):
    """Split the sequence into ``nc`` chunks of ``q = min(chunk, l)`` rows,
    zero-padding the last (a padded row has dt = 0, so it adds nothing):
    X (b,l,h,p), dt (b,l,h), B, C (b,l,n) -> (b,nc,q,...) views."""
    b, l, h, p = X.shape
    n = B.shape[-1]
    q = min(chunk, l)
    nc = -(-l // q)
    pad = nc * q - l
    if pad:
        X = torch.nn.functional.pad(X, (0, 0, 0, 0, 0, pad))
        dt = torch.nn.functional.pad(dt, (0, 0, 0, pad))
        B = torch.nn.functional.pad(B, (0, 0, 0, pad))
        C = torch.nn.functional.pad(C, (0, 0, 0, pad))
    return (X.reshape(b, nc, q, h, p), dt.reshape(b, nc, q, h),
            B.reshape(b, nc, q, n), C.reshape(b, nc, q, n))


def ssd_inter_chunk(Y_diag, S_c, A_cs, Cc, initial_state, l):
    """The SSD pass outside the intra-chunk kernel: the state recurrence
    over the chunks (a loop, the reference's ``lax.scan``) and the
    off-diagonal term.  Returns (Y (b, l, h, p) fp32, final state (b, h, p,
    n) fp32)."""
    b, nc, q, h, p = Y_diag.shape
    chunk_decay = torch.exp(A_cs[..., -1])                    # (b, nc, h)
    s = (initial_state.float() if initial_state is not None
         else torch.zeros(S_c.shape[:1] + S_c.shape[2:], dtype=torch.float32,
                          device=S_c.device))
    states_in = []
    for c in range(nc):                      # the state entering each chunk
        states_in.append(s)
        s = s * chunk_decay[:, c, :, None, None] + S_c[:, c]
    states_in = torch.stack(states_in, dim=1)                 # (b,nc,h,p,n)
    Y_off = (torch.einsum("bcqn,bchpn->bcqhp", Cc.float(), states_in)
             * torch.exp(A_cs).permute(0, 1, 3, 2)[..., None])
    Y = (Y_diag.float() + Y_off).reshape(b, nc * q, h, p)[:, :l]
    return Y, s
