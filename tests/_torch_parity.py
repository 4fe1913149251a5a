"""Helpers shared by the ``test_torch_*`` parity tests: matching config
pairs, weights carried from the JAX package to the port through numpy, a
greedy JAX reference built from ``repro.models.transformer`` alone (the
reference's ``repro.serving`` does not import on Python 3.12: its
``StepEvent`` has a numpy dataclass default), the reference's SFT loop
built from ``repro.training`` and ``repro.data`` (its
``repro.launch.train`` does not import either: it imports ``repro.core``),
the reference's PPO modules and its replay module loaded by file path
(:func:`reference_core`, :func:`reference_replay`), and the SSM / hybrid
training tests' configs and comparisons.
"""
from __future__ import annotations

import functools
import importlib
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro import configs as jconfigs
from repro.data import CopyTaskDataset, DataBlender, SortTaskDataset
from repro.models import transformer as JT
from repro.training import schedules as jschedules
from repro.training.steps import lm_train_step as j_lm_train_step
from repro.training.train_state import TrainState as JTrainState
from repro_torch import configs as tconfigs
from repro_torch.models import convert

# One torch intra-op thread in every process that imports these helpers,
# which every worker of a parallel test run does when it collects the
# suite.  The reduced models' ops are tiny, so alone this costs nothing;
# under ``-n 6`` each worker's default OpenMP threads spin-wait for cores
# the other workers hold (on 8 cores, six port test files in 6 workers
# took 1,017 s with the default threads and 191 s with one).
torch.set_num_threads(1)

ARCHS = ("opt-1.3b", "smollm-135m")
SSM_ARCHS = ("mamba2-370m", "zamba2-1.2b")
SSM_TRAIN_ARCHS = (*SSM_ARCHS, "hybrid-2seg")
STEP_TOL = dict(rtol=1e-4, atol=1e-4)       # the train steps' tolerance


def config_pair(arch: str, **kw):
    """(JAX cfg, port cfg) of ``reduced(arch)`` with the same overrides;
    the port runs its own plain code (``use_kernels=False``) unless
    ``use_kernels`` is given."""
    use_kernels = kw.pop("use_kernels", False)
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        use_pallas=use_kernels, **kw)
    tcfg = tconfigs.reduced(tconfigs.get_config(arch)).replace(
        use_kernels=use_kernels, **kw)
    return jcfg, tcfg


def params_pair(jcfg, seed: int = 0):
    """JAX params from ``init_params`` and the same weights as tensors."""
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    tparams = convert.params_from_numpy(
        jax.tree.map(np.asarray, jparams), "cpu")
    return jparams, tparams


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


@functools.lru_cache(maxsize=None)
def _jax_step_fns(jcfg):
    """The jitted prefill, decode and logits functions of ``jcfg``, built
    once per config so that repeated greedy decodes reuse their compiles."""
    fwd_prefill = jax.jit(lambda p, t, c, e: JT.forward(
        jcfg, p, tokens=t, encoder_embeds=e, mode="prefill", cache=c))
    fwd_decode = jax.jit(lambda p, t, c, pos: JT.forward(
        jcfg, p, tokens=t, mode="decode", cache=c, positions=pos))
    logits_fn = jax.jit(lambda p, h: JT.logits_fn(jcfg, p, h))
    return fwd_prefill, fwd_decode, logits_fn


def jax_greedy(jcfg, jparams, prompt, max_new: int, eos_id=None,
               encoder_embeds=None):
    """Greedy decode of one prompt with the JAX model, mirroring
    ``repro/serving/generate.py`` (prefill, then one decode step per token,
    EOS forced after the first EOS).  With ``jcfg.kv_quant`` the cache is
    the reference's int8 arena with its scale planes.  A ``vlm`` model
    takes the prompt's ``encoder_embeds`` (Le, encoder_dim), which the
    prefill caches as each cross-attention layer's K/V.  Returns the
    generated tokens."""
    Lp = len(prompt)
    fwd_prefill, fwd_decode, logits_fn = _jax_step_fns(jcfg)
    cache = JT.init_cache(jcfg, 1, Lp + max_new)
    enc = (None if encoder_embeds is None
           else jnp.asarray(encoder_embeds)[None])
    hidden, cache, _ = fwd_prefill(jparams, jnp.asarray(prompt)[None], cache,
                                   enc)
    logits = logits_fn(jparams, hidden[:, -1:])[0, 0]
    toks, done = [], False
    for t in range(max_new):
        tok = eos_id if done else int(jnp.argmax(logits))
        toks.append(tok)
        done = done or (eos_id is not None and tok == eos_id)
        hidden, cache, _ = fwd_decode(
            jparams, jnp.asarray([[tok]], jnp.int32), cache,
            jnp.asarray([[Lp + t]], jnp.int32))
        logits = logits_fn(jparams, hidden)[0, 0]
    return toks


def state_pair(jparams):
    """A fresh JAX TrainState and the same state in the port."""
    jstate = JTrainState.create(jparams)
    return jstate, convert.train_state_from_numpy(
        jax.tree.map(np.asarray, jstate), "cpu")


def jax_lm_loop(jcfg, jstate, *, steps, batch, seq, lr, seed=0, micro=1):
    """The LM loop of ``repro/launch/train.py`` (lines 222-279: the copy +
    sort blend, ``cosine_warmup(lr, steps // 10 + 1, steps)``, a jitted
    ``lm_train_step``), from ``jstate``.  Returns (state, losses,
    grad norms)."""
    half = seq // 2
    V = min(jcfg.vocab_size, 256)
    ds = [CopyTaskDataset(10_000, half, seq - half, V, seed=1),
          SortTaskDataset(10_000, half, seq - half, V, seed=2)]
    bl = DataBlender(ds, seed=seed)
    lr_fn = jschedules.cosine_warmup(lr, steps // 10 + 1, steps)
    step = jax.jit(lambda s, b, lr: j_lm_train_step(jcfg, s, b, lr,
                                                    micro=micro))
    losses, gnorms = [], []
    for i, b in enumerate(bl.sft_batches(batch, steps)):
        jstate, m = step(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                         lr_fn(i))
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    return jstate, losses, gnorms


class _NoEngine:
    """Stands in for ``repro.serving.engine.GenerationEngine``, which does
    not import here; the reference's PPO functions never call it."""

    def __init__(self, *args, **kwargs):
        pass


_REF_CORE = None


def reference_core():
    """The reference's ``repro/core/{experience,ema,ppo}.py``, loaded by
    file path: ``repro.core`` and ``repro.serving.engine`` do not import on
    Python 3.12 (ROADMAP Queue 3, R1).  A bare ``repro.core`` package and a
    stub ``repro.serving.engine`` stand in while the three modules load;
    then ``sys.modules`` is restored to exactly what it was, so other tests
    in the same process see what they saw before.  Returns a namespace with
    ``experience``, ``ema`` and ``ppo``."""
    global _REF_CORE
    if _REF_CORE is not None:
        return _REF_CORE
    # what the modules import and does import here, loaded for good
    for name in ("jax.sharding", "repro.models.reward",
                 "repro.models.transformer", "repro.sharding.strategy",
                 "repro.training.steps", "repro.training.train_state"):
        importlib.import_module(name)
    saved = dict(sys.modules)
    core_dir = Path(__file__).resolve().parents[1] / "src" / "repro" / "core"
    try:
        core = types.ModuleType("repro.core")
        core.__path__ = [str(core_dir)]
        engine = types.ModuleType("repro.serving.engine")
        engine.GenerationEngine = _NoEngine
        sys.modules["repro.core"] = core
        sys.modules["repro.serving.engine"] = engine
        mods = {n: importlib.import_module(f"repro.core.{n}")
                for n in ("experience", "ema", "ppo")}
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    _REF_CORE = types.SimpleNamespace(**mods)
    return _REF_CORE


_REF_REPLAY = None


def reference_replay():
    """The reference's ``repro/core/replay.py``, loaded by file path as
    :func:`reference_core` loads its modules, with ``hybrid_engine.py``
    beside it: ``WeightPublisher._push`` imports
    ``repro.core.hybrid_engine._tree_device_bytes`` at every publish.
    ``sys.modules`` is restored afterwards; a test that publishes puts
    ``modules`` (the bare ``repro.core`` package and its
    ``hybrid_engine``) back for its duration (``monkeypatch.setitem``).
    Returns a namespace with ``replay`` and ``modules``."""
    global _REF_REPLAY
    if _REF_REPLAY is not None:
        return _REF_REPLAY
    for name in ("jax.sharding", "repro.models.transformer",
                 "repro.sharding.strategy"):
        importlib.import_module(name)
    saved = dict(sys.modules)
    core_dir = Path(__file__).resolve().parents[1] / "src" / "repro" / "core"
    try:
        core = types.ModuleType("repro.core")
        core.__path__ = [str(core_dir)]
        sys.modules["repro.core"] = core
        mods = {n: importlib.import_module(f"repro.core.{n}")
                for n in ("replay", "hybrid_engine")}
    finally:
        sys.modules.clear()
        sys.modules.update(saved)
    _REF_REPLAY = types.SimpleNamespace(
        replay=mods["replay"],
        modules={"repro.core": core,
                 "repro.core.hybrid_engine": mods["hybrid_engine"]})
    return _REF_REPLAY


# --------------------------------------------------------------------- #
# SSM / hybrid training
# --------------------------------------------------------------------- #
def ssm_pair(arch: str, **kw):
    """:func:`config_pair` of an SSM or hybrid id; ``"hybrid-2seg"`` is the
    reduced Zamba2-1.2B cut to two segments (2 units of (2 SSD + attention),
    then 2 SSD)."""
    if arch == "hybrid-2seg":
        return config_pair("zamba2-1.2b", attn_every=3, n_layers=8, **kw)
    return config_pair(arch, **kw)


def close_rel(got, want, rel):
    """max |got - want| <= rel * max |want|, and ``got`` finite."""
    got = np.asarray(to_np(got), np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= rel * scale, (err, scale)


def leaf_pairs(got, *want):
    """The port tree's leaves beside the reference trees' at the same paths
    (JAX orders dict keys, the port keeps insertion order)."""
    from repro_torch.models.modules import tree_map
    out = []
    tree_map(lambda *xs: out.append(xs), got, *want)
    assert len(out) == len(jax.tree.leaves(want[0]))
    return out


def assert_grads_close(got, want, rel=1e-4):
    """Each leaf to ``rel`` of its largest |grad|."""
    for a, b in leaf_pairs(got, want):
        close_rel(a, b, rel)


def assert_params_moved_alike(got, want, grads, lr):
    """New params match at :data:`STEP_TOL` where |grad| is well above the
    noise; elsewhere they stay within one Adam step (``lr``: its first
    step is about ``lr * sign(g)``, and a grad near 0 may flip sign between
    frameworks)."""
    for a, b, g in leaf_pairs(got, want, grads):
        a, b, g = to_np(a), np.asarray(b), np.abs(np.asarray(g))
        big = g > 1e-3 * max(float(g.max()), 1e-12)
        np.testing.assert_allclose(a[big], b[big], **STEP_TOL)
        assert float(np.abs(a - b).max()) <= 2.5 * lr
