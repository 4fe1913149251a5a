"""The port's MoE layer (``repro_torch.models.modules.moe_apply``) held to
the reference's ``moe_apply`` on the same weights: capacity overflow, exact
router ties (ROADMAP Queue 3, R14: the lower expert index first), the
token counts where ``cap`` changes, bf16, the aux loss and every gradient;
the capacity coupling of a call's rows (R13) witnessed in both packages;
LoRA leaving the 4-D expert stacks alone; a MoE tree across ``convert.py``
and a checkpoint; the sliced draw of a large leaf and the serve launcher's
weights in the compute dtype, and the launchers' config cut in depth."""
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_parity import close_rel, config_pair, params_pair, to_np
from repro.models import modules as JM
from repro.training import checkpoint as jckpt
from repro_torch.core import lora
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as ttrain
from repro_torch.models import convert
from repro_torch.models import modules as TM
from repro_torch.models import transformer as TT
from repro_torch.models.modules import ParamSpec, flatten_with_path
from repro_torch.serving.engine import GenerationEngine, Request
from repro_torch.training import checkpoint as tckpt

ARCH = "llama4-scout-17b-a16e"
ROOT = Path(__file__).resolve().parents[1]


def _cfgs(**kw):
    """The reduced llama4-scout pair (4 experts, top-1, one shared expert,
    d 256, expert width 128), fp32 unless overridden."""
    return config_pair(ARCH, **kw)


def _moe_params(jcfg, seed=0, router_scale=1.0):
    """One MoE layer's weights from numpy, as a JAX and a port tree."""
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = s.shape[-2] if len(s.shape) > 1 else s.shape[0]
        return (rng.standard_normal(s.shape) / np.sqrt(fan_in)).astype(
            np.float32)
    tree = jax.tree.map(draw, JM.moe_specs(jcfg),
                        is_leaf=lambda x: isinstance(x, JM.ParamSpec))
    tree["router"] = tree["router"] * np.float32(router_scale)
    return (jax.tree.map(jnp.asarray, tree),
            convert.params_from_numpy(tree, "cpu"))


def _cast(jp, tp, jdt, tdt):
    return (jax.tree.map(lambda a: a.astype(jdt), jp),
            TM.tree_map(lambda t: t.to(tdt), tp))


def _both(jcfg, tcfg, jp, tp, x):
    jout, jaux = JM.moe_apply(jcfg, jp, jnp.asarray(x))
    tout, taux = TM.moe_apply(tcfg, tp, torch.from_numpy(np.asarray(x)))
    return (np.asarray(jout.astype(jnp.float32)), float(jaux),
            to_np(tout.float()), float(taux))


def _dropped(tcfg, tp, x):
    """Entries the port's routing drops for the rows of ``x``."""
    xf = torch.from_numpy(np.asarray(x)).reshape(-1, x.shape[-1])
    probs = torch.softmax((xf @ tp["router"].to(xf.dtype)).float(), -1)
    _, _, pos, cap = TM.moe_route(tcfg, probs)
    return int((pos >= cap).sum()), cap


def test_moe_specs_match_reference():
    jcfg, tcfg = _cfgs()
    j = jax.tree_util.tree_flatten_with_path(
        JM.moe_specs(jcfg), is_leaf=lambda x: isinstance(x, JM.ParamSpec))[0]
    t = flatten_with_path(TM.moe_specs(tcfg))
    assert [(tuple(getattr(c, "key", c) for c in p), s.shape, s.axes)
            for p, s in j] == [(p, s.shape, s.axes) for p, s in t]


# (B, L, top_k, capacity_factor, router_scale): cap = ceil(T K / E cf)
# changes between T = 5 and 6 and between 8 and 9 at cf 1.25; a large
# router scale piles the rows onto few experts (overflow)
CASES = [(1, 5, 1, 1.25, 1.0), (1, 6, 1, 1.25, 1.0), (1, 8, 1, 1.25, 1.0),
         (3, 3, 1, 1.25, 1.0), (2, 8, 2, 1.25, 1.0), (2, 8, 1, 0.5, 8.0),
         (1, 16, 2, 0.75, 8.0), (4, 1, 1, 1.25, 1.0)]


@pytest.mark.parametrize("B,L,K,cf,rs", CASES)
def test_moe_apply_matches_reference(B, L, K, cf, rs):
    jcfg, tcfg = _cfgs(top_k=K, capacity_factor=cf)
    jp, tp = _moe_params(jcfg, seed=B * 100 + L, router_scale=rs)
    x = np.random.default_rng(L).standard_normal(
        (B, L, jcfg.d_model)).astype(np.float32)
    jo, ja, to, ta = _both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)
    if cf < 1:                                   # the overflow cases drop
        assert _dropped(tcfg, tp, x)[0] > 0


def test_moe_apply_bf16_matches_reference():
    jcfg, tcfg = _cfgs(top_k=2, compute_dtype="bfloat16")
    jp, tp = _moe_params(jcfg, seed=5)
    jp, tp = _cast(jp, tp, jnp.bfloat16, torch.bfloat16)
    x = np.random.default_rng(6).standard_normal((2, 8, jcfg.d_model))
    jo, ja = JM.moe_apply(jcfg, jp, jnp.asarray(x, jnp.bfloat16))
    to, ta = TM.moe_apply(tcfg, tp, torch.from_numpy(x).to(torch.bfloat16))
    assert to.dtype == torch.bfloat16
    close_rel(to.float(), np.asarray(jo.astype(jnp.float32)), 2e-2)
    np.testing.assert_allclose(float(ta), float(ja), rtol=1e-3)


@pytest.mark.parametrize("K", [1, 2])
def test_router_ties_keep_the_lower_expert_first(K):
    """R14: with experts 1, 2 and 3 tied at the top, the reference's
    ``lax.top_k`` keeps expert 1 (then 2); the port keeps the same."""
    assert int(torch.topk(torch.tensor([0.1, 0.3, 0.3, 0.3]), 1)[1]) in (
        1, 2, 3)                                  # no promised order
    jcfg, tcfg = _cfgs(top_k=K)
    jp, tp = _moe_params(jcfg, seed=7)
    r = np.asarray(jp["router"]).copy()
    r[:, 2] = r[:, 1]
    r[:, 3] = r[:, 1]
    r[:, 0] = -r[:, 1]               # expert 0 below the tie on most rows
    jp["router"] = jnp.asarray(r)
    tp["router"] = torch.from_numpy(r)
    x = np.random.default_rng(8).standard_normal(
        (1, 6, jcfg.d_model)).astype(np.float32)
    xf = torch.from_numpy(x[0])
    probs = torch.softmax(xf @ tp["router"], -1)
    _, expert, _, _ = TM.moe_route(tcfg, probs)
    _, jexp = jax.lax.top_k(jax.nn.softmax(jnp.asarray(x[0]) @ jp["router"]),
                            K)
    np.testing.assert_array_equal(expert.numpy(), np.asarray(jexp))
    tied = probs[:, 1] > probs[:, 0]
    assert tied.any() and (expert[tied, 0] == 1).all()
    jo, ja, to, ta = _both(jcfg, tcfg, jp, tp, x)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ta, ja, rtol=1e-5)


@pytest.mark.parametrize("K,cf", [(1, 1.25), (2, 0.75)])
def test_moe_grads_match_jax_grad(K, cf):
    """Grads of out and aux with respect to x and every weight, a dropping
    case among them, against ``jax.grad`` (1e-4 of each leaf's max)."""
    jcfg, tcfg = _cfgs(top_k=K, capacity_factor=cf)
    jp, tp = _moe_params(jcfg, seed=9, router_scale=4.0)
    rng = np.random.default_rng(10)
    x = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal((2, 6, jcfg.d_model)).astype(np.float32)

    def jobj(p, xx):
        out, aux = JM.moe_apply(jcfg, p, xx)
        return jnp.sum(out * r) + 10.0 * aux
    jgp, jgx = jax.grad(jobj, argnums=(0, 1))(jp, jnp.asarray(x))
    tpl = TM.tree_map(lambda t: t.clone().requires_grad_(), tp)
    tx = torch.from_numpy(x).requires_grad_()
    out, aux = TM.moe_apply(tcfg, tpl, tx)
    (torch.sum(out * torch.from_numpy(r)) + 10.0 * aux).backward()
    close_rel(tx.grad, np.asarray(jgx), 1e-4)
    jflat = {tuple(getattr(c, "key", c) for c in p): np.asarray(g) for p, g
             in jax.tree_util.tree_flatten_with_path(jgp)[0]}
    tflat = dict(flatten_with_path(tpl))
    assert jflat.keys() == tflat.keys()
    for k, g in jflat.items():
        close_rel(tflat[k].grad, g, 1e-4)
    assert _dropped(tcfg, tp, x)[0] > 0 or cf > 1


def test_r13_capacity_couples_the_rows_of_a_call():
    """R13, at reduced llama4-scout with capacity_factor 1.25, in both
    packages: five identical rows (cap 2 at T = 5) keep two and drop three
    to the shared expert alone; padded to a 16-row bucket (cap 5) all five
    are kept; a live decode row after an idle row of the same routing is
    dropped, while alone it is kept."""
    jcfg, tcfg = _cfgs(capacity_factor=1.25)
    jp, tp = _moe_params(jcfg, seed=11)
    rng = np.random.default_rng(12)
    row = rng.standard_normal(jcfg.d_model).astype(np.float32)
    shared_only = to_np(TM.mlp_apply(tp["shared"], torch.from_numpy(row)))

    five = np.tile(row, (1, 5, 1))
    jo, _, to, _ = _both(jcfg, tcfg, jp, tp, five)
    for o in (jo, to):
        np.testing.assert_array_equal(o[0, 0], o[0, 1])
        np.testing.assert_array_equal(o[0, 2], o[0, 4])
        assert np.abs(o[0, 0] - o[0, 2]).max() > 1e-3
        np.testing.assert_allclose(o[0, 3], shared_only, rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-5)
    assert _dropped(tcfg, tp, five) == (3, 2)

    bucket = np.concatenate(
        [five, rng.standard_normal((1, 11, jcfg.d_model))], 1).astype(
            np.float32)
    jb, _, tb, _ = _both(jcfg, tcfg, jp, tp, bucket)
    for o, o5 in ((jb, jo), (tb, to)):
        for i in range(5):
            np.testing.assert_allclose(o[0, i], o5[0, 0], rtol=1e-5,
                                       atol=1e-6)
    np.testing.assert_allclose(tb, jb, rtol=1e-5, atol=1e-5)

    idle_then_live = np.stack([row, row])[:, None]       # (2 slots, 1, D)
    jd, _, td, _ = _both(jcfg, tcfg, jp, tp, idle_then_live)
    ja, _, ta, _ = _both(jcfg, tcfg, jp, tp, row[None, None])
    for o, alone in ((jd, ja), (td, ta)):
        np.testing.assert_allclose(o[1, 0], shared_only, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(o[0, 0], alone[0, 0], rtol=1e-5,
                                   atol=1e-6)
    np.testing.assert_allclose(td, jd, rtol=1e-5, atol=1e-5)


def _ref_lora():
    spec = importlib.util.spec_from_file_location(
        "_reference_lora_moe", ROOT / "src" / "repro" / "core" / "lora.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_lora_skips_the_expert_stacks_as_the_reference_does():
    """Adapters on the 2-D and layer-stacked 3-D matrices only: the
    attention, the shared expert and the router pattern's misses follow
    the reference, and the (layers, E, D, F) expert stacks get none."""
    jcfg, _ = _cfgs()
    jparams, tparams = params_pair(jcfg, seed=13)
    jl = _ref_lora()
    want = [k for k, _, _ in jl._target_paths(jparams, jl.DEFAULT_TARGETS)]
    got = lora.init(tparams, 4, torch.Generator().manual_seed(0))
    assert list(got) == want
    assert "segments/0/0/mlp/shared/w_gate" in got
    assert "segments/0/0/attn/wq" in got
    assert not any(k.endswith(("mlp/w_gate", "mlp/w_up", "mlp/w_down"))
                   for k in got)
    stacks = [p for p, t in flatten_with_path(tparams) if t.ndim == 4]
    assert len(stacks) == 3
    merged = lora.merge(tparams, got)
    for (p, a), (_, b) in zip(flatten_with_path(merged),
                              flatten_with_path(tparams)):
        if a.ndim == 4:
            assert torch.equal(a, b), p


def test_moe_tree_crosses_convert_and_a_checkpoint(tmp_path):
    jcfg, _ = _cfgs()
    jparams, tparams = params_pair(jcfg, seed=14)
    back = convert.params_to_numpy(tparams)
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jparams)),
                    jax.tree.leaves(back)):
        np.testing.assert_array_equal(a, b)
    tckpt.CheckpointManager(str(tmp_path)).save(1, tparams, {"moe": 1},
                                                wait=True)
    got, meta = jckpt.CheckpointManager(str(tmp_path)).restore(
        jax.tree.map(jnp.zeros_like, jparams))
    assert meta == {"moe": 1}
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    jckpt.CheckpointManager(str(tmp_path / "j")).save(2, jparams, {},
                                                      wait=True)
    zeros = TM.tree_map(torch.zeros_like, tparams)
    got, _ = tckpt.CheckpointManager(str(tmp_path / "j")).restore(zeros)
    for (p, a), (_, b) in zip(flatten_with_path(got),
                              flatten_with_path(tparams)):
        assert torch.equal(a, b), p


# --------------------------------------------------------------------- #
# weights at 8-30 B parameters
# --------------------------------------------------------------------- #
def test_sliced_draw_lands_in_the_dtype_and_shape(monkeypatch):
    """A leaf above ``MAX_DRAW`` elements is drawn slice by slice into its
    dtype: the bf16 draw is the fp32 draw's rounding bit for bit, and its
    spread is the spec's; a leaf at or below it keeps its single draw."""
    spec = ParamSpec((3, 4, 64, 48), ("layers", "experts", "embed", "mlp"))
    small = ParamSpec((64, 48), ("embed", "mlp"))
    one = TM.materialize(small, torch.Generator().manual_seed(0),
                         torch.float32)
    want = torch.randn((64, 48), generator=torch.Generator().manual_seed(0))
    assert torch.equal(one, want * (1.0 / np.sqrt(64)))
    monkeypatch.setattr(TM, "MAX_DRAW", 2 * 4 * 64 * 48 - 1)  # 1 row a draw
    draws = {dt: TM.materialize(spec, torch.Generator().manual_seed(1), dt)
             for dt in (torch.float32, torch.bfloat16)}
    for dt, t in draws.items():
        assert t.dtype == dt and tuple(t.shape) == spec.shape
    assert torch.equal(draws[torch.float32].to(torch.bfloat16),
                       draws[torch.bfloat16])
    std = float(draws[torch.float32].std()) * np.sqrt(4 * 64)
    assert abs(std - 1) < 0.05
    # the first slice is the first draw of the generator
    first = torch.randn((1, 4, 64, 48),
                        generator=torch.Generator().manual_seed(1))
    assert torch.equal(draws[torch.float32][:1],
                       first * (1.0 / np.sqrt(4 * 64)))
    assert not torch.equal(draws[torch.float32][1], draws[torch.float32][0])


def test_served_stream_without_the_fp32_tree_equals_todays(monkeypatch):
    """The serve launcher draws its own weights in the compute dtype (no
    fp32 tree beside the engine's copy); the stream equals serving the
    fp32 draw, which the engine casts, as the launcher did before."""
    _, tcfg = _cfgs(compute_dtype="bfloat16")
    monkeypatch.setattr(tserve, "reduced", lambda c: tcfg)
    seen = []
    real = TT.init_params
    monkeypatch.setattr(TT, "init_params", lambda c, g, dtype=None: seen.append(
        dtype) or real(c, g, dtype))
    argv = ["--device", "cpu", "--arch", ARCH, "--reduced", "--requests",
            "3", "--batch", "2", "--ragged", "--max-new", "5",
            "--temperature", "0"]
    new = tserve.main(argv, warmup=False)
    assert seen == [torch.bfloat16]
    fp32 = real(tcfg, torch.Generator().manual_seed(0))
    assert fp32["embed"].dtype == torch.float32
    old = tserve.main(argv, params=fp32, warmup=False)
    assert new["completions"] == old["completions"]
    assert len(new["completions"]) == 3


def test_launchers_take_a_config_cut_in_depth():
    """``serve.main`` and ``train.main`` take ``cfg=`` in place of
    ``--arch``'s config (how a model one card cannot hold whole is run at
    a cut depth): the served stream equals serving that config's own draw,
    and the trained state has that config's depth."""
    _, tcfg = _cfgs()
    cut = tcfg.replace(n_layers=1)
    argv = ["--device", "cpu", "--arch", ARCH, "--requests", "2",
            "--max-new", "4", "--temperature", "0"]
    got = tserve.main(argv, warmup=False, cfg=cut)
    own = TT.init_params(cut, torch.Generator().manual_seed(0), cut.cdtype)
    want = tserve.main(argv, params=own, warmup=False, cfg=cut)
    assert got["completions"] == want["completions"]
    assert len(got["completions"]) == 2
    out = ttrain.main(["--device", "cpu", "--arch", ARCH, "--steps", "1",
                       "--batch", "2", "--seq", "16"], cfg=cut)
    depths = {tuple(k): v.shape[0] for k, v in
              flatten_with_path(out["state"].params) if k[0] == "segments"}
    assert depths and set(depths.values()) == {1}
    assert out["arch"] == cut.name and len(out["loss"]) == 1


@pytest.mark.parametrize("layout", ["dense", "paged"])
def test_engine_hands_moe_the_reference_rows(monkeypatch, layout):
    """R13: the engine routes exactly what the reference's engine routes:
    a prefill of one prompt right-padded with zeros to its bucket
    (``serving/engine.py:707-708`` of the reference), and decode steps
    over every slot in slot order, an idle slot's token the pad token
    (``where(eos >= 0, eos, 0)``, ``:540``, with a never-admitted slot's
    EOS at -1, ``:988``); the paged layout's prefill pads its suffix the
    same way (``:821``)."""
    _, tcfg = _cfgs()
    _, tparams = params_pair(_cfgs()[0], seed=15)
    calls = []
    real = TT.forward

    def spy(cfg, params, *, tokens=None, mode="full", **kw):
        calls.append((mode, tokens.clone()))
        return real(cfg, params, tokens=tokens, mode=mode, **kw)
    monkeypatch.setattr(TT, "forward", spy)
    kw = dict(kv_layout="paged", block_size=4) if layout == "paged" else {}
    eng = GenerationEngine(tcfg, max_new_tokens=4, temperature=0.0, chunk=2,
                           eos_id=3, device="cpu", **kw)
    rng = np.random.default_rng(16)
    prompt = rng.integers(4, tcfg.vocab_size, 5).astype(np.int32)
    eng.serve(tparams, [Request(uid=0, tokens=prompt, max_new_tokens=4)],
              torch.Generator().manual_seed(0), slots=3, max_seq_len=16)
    mode, toks = calls[0]
    assert mode == "prefill" and toks.shape == (1, 8)
    assert toks[0, :5].tolist() == prompt.tolist() and not toks[0, 5:].any()
    decode = [t for m, t in calls if m == "decode"]
    assert decode and all(t.shape == (3, 1) for t in decode)
    # slots 1 and 2 never held a request: their EOS is -1, their token 0
    assert all(t[1:, 0].tolist() == [0, 0] for t in decode)


def test_optimizer_groups_keep_the_update_bits(monkeypatch):
    """AdamW makes its two fp32 temporaries for a group of leaves at a
    time (at most ``GROUP_ELEMENTS`` elements): the params and moments it
    writes are bit for bit those of one group holding every leaf."""
    from repro_torch.training import optimizer as topt
    _, tparams = params_pair(_cfgs()[0], seed=17)
    gen = torch.Generator().manual_seed(18)
    grads = TM.tree_map(lambda p: torch.randn(p.shape, generator=gen),
                        tparams)
    runs = []
    for limit in (2 ** 40, 5000):
        monkeypatch.setattr(topt, "GROUP_ELEMENTS", limit)
        p = TM.tree_map(torch.clone, tparams)
        st = topt.init(p)
        for _ in range(2):
            p, st, _ = topt.update(p, TM.tree_map(torch.clone, grads), st,
                                   lr=1e-3, weight_decay=0.1)
        runs.append((p, st))
    assert len(topt._groups(TM.tree_leaves(tparams))) > 10
    for a, b in zip(TM.tree_leaves(runs[0]), TM.tree_leaves(runs[1])):
        assert torch.equal(a, b)
