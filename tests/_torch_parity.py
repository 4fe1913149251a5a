"""Helpers shared by the ``test_torch_*`` parity tests: matching config
pairs, weights carried from the JAX package to the port through numpy, a
greedy JAX reference built from ``repro.models.transformer`` alone (the
reference's ``repro.serving`` does not import on Python 3.12: its
``StepEvent`` has a numpy dataclass default), the reference's SFT loop
built from ``repro.training`` and ``repro.data`` (its
``repro.launch.train`` does not import either: it imports ``repro.core``),
and the reference's PPO modules loaded by file path
(:func:`reference_core`).
"""
from __future__ import annotations

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

ARCHS = ("opt-1.3b", "smollm-135m")


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


def jax_greedy(jcfg, jparams, prompt, max_new: int, eos_id=None):
    """Greedy decode of one prompt with the JAX model, mirroring
    ``repro/serving/generate.py`` (prefill, then one decode step per token,
    EOS forced after the first EOS).  With ``jcfg.kv_quant`` the cache is
    the reference's int8 arena with its scale planes.  Returns the
    generated tokens."""
    Lp = len(prompt)
    fwd_prefill = jax.jit(lambda p, t, c: JT.forward(
        jcfg, p, tokens=t, mode="prefill", cache=c))
    fwd_decode = jax.jit(lambda p, t, c, pos: JT.forward(
        jcfg, p, tokens=t, mode="decode", cache=c, positions=pos))
    logits_fn = jax.jit(lambda p, h: JT.logits_fn(jcfg, p, h))
    cache = JT.init_cache(jcfg, 1, Lp + max_new)
    hidden, cache, _ = fwd_prefill(jparams, jnp.asarray(prompt)[None], cache)
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
