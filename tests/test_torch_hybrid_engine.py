"""The port's Hybrid Engine (``repro_torch.core.hybrid_engine``) against the
reference's (``repro/core/hybrid_engine.py``, loaded by file path: it
imports only ``repro.models`` and ``repro.sharding`` at the top).

- The analytics (param bytes, reshard bytes per phase, the naive ZeRO-3
  generation's gather bytes, the speedup estimate) on every mesh.
- The phase roundtrip and its measured bytes on gloo meshes (1,1), (2,1),
  (4,1), (2,2) and (1,2) over four CPU ranks (``tests/_torch_mesh_driver.py``),
  against the reference run in a subprocess on eight simulated host
  devices: ``in_bytes``, ``out_bytes``, ``gathered_bytes`` and
  ``freed_bytes`` of both directions are equal.
- ``tests/test_system.py``'s two Hybrid-Engine checks, and the one-rank
  mesh: the trainer with an engine runs as without one (bit for bit, the
  reshard measured), and the sharded LM step equals the plain one bit for
  bit.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_driver as D
from repro_torch.core.hybrid_engine import HybridEngine
from repro_torch.core.pipeline import StageConfig
from repro_torch.launch.mesh import init_distributed, make_local_mesh, \
    make_mesh
from repro_torch.models import transformer as T
from repro_torch.models.modules import flatten_with_path, tree_leaves
from repro_torch.sharding import runtime
from repro_torch.training.steps import lm_train_step, make_sharded_lm_step
from repro_torch.training.train_state import TrainState

ROOT = Path(__file__).resolve().parents[1]
MESHES = D.RESHARD_MESHES
STATS = ("in_bytes", "out_bytes", "gathered_bytes", "freed_bytes")
N_TOK = 256

# the reference on 8 simulated host devices: for each mesh, the measured
# stats of to_inference and to_train and the analytics
_REF_SCRIPT = r"""
import importlib.util, json, sys
import jax
from repro.launch.mesh import make_mesh
from repro.models.config import ModelConfig
from repro.models import transformer as T
spec = importlib.util.spec_from_file_location("_ref_he", sys.argv[1])
he_mod = importlib.util.module_from_spec(spec)
sys.modules["_ref_he"] = he_mod           # dataclasses look the module up
spec.loader.exec_module(he_mod)
A = ModelConfig(name="a", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=64,
                compute_dtype="float32", remat=False)
out = {}
for dp, tp in json.loads(sys.argv[2]):
    he = he_mod.HybridEngine(A, make_mesh(dp, tp))
    p = jax.device_put(T.init_params(A, jax.random.PRNGKey(2)),
                       he.train_shardings)
    pi = he.to_inference(p)
    s_in = {k: v for k, v in he.last_reshard_stats.items()
            if k.endswith("bytes")}
    he.to_train(pi)
    s_back = {k: v for k, v in he.last_reshard_stats.items()
              if k.endswith("bytes")}
    out[f"{dp},{tp}"] = {
        "to_inference": s_in, "to_train": s_back,
        "param_bytes": he.param_bytes(),
        "reshard_bytes_per_phase": he.reshard_bytes_per_phase(),
        "naive": he.naive_generation_gather_bytes(%d),
        "speedup": he.hybrid_speedup_estimate(%d)}
print("RESULT " + json.dumps(out))
""" % (N_TOK, N_TOK)


class FakeMesh:
    def __init__(self, shape_dict):
        self.shape = shape_dict
        self.axis_names = tuple(shape_dict)


def _env(**kw):
    return dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}",
                **kw)


@pytest.fixture(scope="module")
def reference():
    res = subprocess.run(
        [sys.executable, "-c", _REF_SCRIPT,
         str(ROOT / "src" / "repro" / "core" / "hybrid_engine.py"),
         json.dumps(MESHES)],
        capture_output=True, text=True, cwd=ROOT, timeout=300,
        env=_env(XLA_FLAGS="--xla_force_host_platform_device_count=8",
                 JAX_PLATFORMS="cpu"))
    assert res.returncode == 0, res.stderr[-3000:]
    line = [ln for ln in res.stdout.splitlines() if ln.startswith("RESULT ")]
    raw = json.loads(line[-1][len("RESULT "):])
    return {tuple(int(x) for x in k.split(",")): v for k, v in raw.items()}


@pytest.fixture(scope="module")
def port_reshard(tmp_path_factory):
    out = tmp_path_factory.mktemp("mesh4")
    res = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", str(ROOT / "tests" / "_torch_mesh_driver.py"),
         "--out", str(out), "--cases", "reshard"],
        capture_output=True, text=True, cwd=ROOT, timeout=300, env=_env())
    assert res.returncode == 0, res.stderr[-3000:]
    return torch.load(out / "reshard.pt", weights_only=False)


@pytest.mark.parametrize("dp,tp", MESHES, ids=[f"dp{d}_tp{t}"
                                               for d, t in MESHES])
def test_measured_reshard_bytes_equal_the_reference(reference,
                                                    port_reshard, dp, tp):
    """The layouts hold exactly the reference's bytes on every rank:
    to_inference gathers what to_train frees, and the roundtrip is exact
    and lands back in the training layout."""
    got, want = port_reshard[(dp, tp)], reference[(dp, tp)]
    for direction in ("to_inference", "to_train"):
        for k in STATS:
            assert got[direction][k] == want[direction][k], (direction, k)
    assert (got["to_inference"]["gathered_bytes"]
            == got["to_train"]["freed_bytes"])
    assert got["to_inference"]["seconds"] > 0
    assert got["to_inference"]["first_call"] and got["exact"]
    assert got["same_layout"]
    assert (got["to_inference"]["gathered_bytes"] > 0) == (dp > 1)


@pytest.mark.parametrize("dp,tp", MESHES + ((16, 16),),
                         ids=[f"dp{d}_tp{t}" for d, t in MESHES + ((16, 16),)])
def test_analytics_equal_the_reference(reference, dp, tp):
    """param_bytes, reshard_bytes_per_phase, the naive gather bytes and the
    speedup estimate, from the mesh's shape alone (the production 16 x 16
    mesh included, against the reference's formula at dp = 16)."""
    he = HybridEngine(D.ACTOR, FakeMesh({"data": dp, "model": tp}))
    want = reference.get((dp, tp))
    if want is None:             # more devices than the reference has here
        want = reference[(1, 1)]
        assert he.param_bytes() == want["param_bytes"]
        assert he.reshard_bytes_per_phase() == want["param_bytes"] * (dp - 1)
        return
    assert he.param_bytes() == want["param_bytes"]
    assert he.reshard_bytes_per_phase() == want["reshard_bytes_per_phase"]
    assert he.naive_generation_gather_bytes(N_TOK) == want["naive"]
    assert he.hybrid_speedup_estimate(N_TOK) == pytest.approx(
        want["speedup"], rel=1e-12)


# --------------------------------------------------------------------- #
# one rank: tests/test_system.py's checks, and the world-1 identities
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process, destroyed afterwards."""
    import torch.distributed as dist
    store = tmp_path_factory.mktemp("pg") / "store"
    owned = not dist.is_initialized()
    init_distributed("cpu", init_method=f"file://{store}", rank=0,
                     world_size=1)
    yield
    if owned:
        dist.destroy_process_group()


def test_hybrid_engine_roundtrip_exact(one_rank):
    mesh = make_local_mesh()
    he = HybridEngine(D.ACTOR, mesh)
    params = T.init_params(D.ACTOR, D._gen(1))
    pi = he.to_inference(params)
    pt = he.to_train(pi)
    for a, b in zip(tree_leaves(params), tree_leaves(pt)):
        assert torch.equal(a, runtime.full(b))
    assert he.last_reshard_stats["freed_bytes"] == 0


def test_hybrid_engine_analytics(one_rank):
    mesh = make_local_mesh()
    he = HybridEngine(D.ACTOR, mesh)
    # HE gathers once per phase; naive ZeRO-3 generation gathers per token
    assert (he.naive_generation_gather_bytes(N_TOK)
            == N_TOK * he.reshard_bytes_per_phase())
    assert he.param_bytes() > 0


def test_one_rank_trainer_runs_as_without_an_engine(one_rank):
    """At one rank the trainer with an engine equals the one without, bit
    for bit; only the reshard is added to the metrics (0 bytes, measured
    seconds)."""
    he = HybridEngine(D.ACTOR, make_mesh(1, 1))
    got = D.ppo_run(D.trainer(he), D.PROMPTS)
    want = D.ppo_run(D.trainer(None), D.PROMPTS)
    for k in want["exp"]:
        np.testing.assert_array_equal(got["exp"][k], want["exp"][k])
    assert got["metrics"]["reshard_bytes"] == 0
    assert got["metrics"]["reshard_s"] > 0
    for a, b in zip(got["steps"], want["steps"]):
        assert {k: v for k, v in a.items() if not k.endswith("_ms")} == {
            k: v for k, v in b.items() if not k.endswith("_ms")}
    for name in ("actor", "critic", "ema"):
        for a, b in zip(got[name], want[name]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("micro", [1, 2])
def test_one_rank_sharded_lm_step_is_the_plain_step(one_rank, micro):
    """make_sharded_lm_step on a one-rank mesh: the same loss, grad norm,
    params and moments as lm_train_step, bit for bit."""
    cfg = D.lm_config("smollm-135m")
    step, sh, shard_batch = make_sharded_lm_step(cfg, make_mesh(1, 1),
                                                 "zero3", zero=1, micro=micro)
    sharded = TrainState.create(T.init_params(cfg, D._gen(5)), shardings=sh)
    plain = TrainState.create(T.init_params(cfg, D._gen(5)))
    rng = np.random.RandomState(0)
    for i in range(2):
        batch = {"tokens": torch.as_tensor(rng.randint(0, 64, (4, 16))),
                 "labels": torch.as_tensor(rng.randint(0, 64, (4, 16))),
                 "mask": torch.as_tensor(rng.rand(4, 16) > 0.3).float()}
        sharded, ms = step(sharded, shard_batch(batch), 1e-3)
        plain, mp = lm_train_step(cfg, plain, batch, 1e-3, micro=micro)
        for k in ("loss", "grad_norm", "lm_loss"):
            assert torch.equal(ms[k], mp[k]), (i, k)
    for a, b in zip(tree_leaves(sharded), tree_leaves(plain)):
        assert torch.equal(runtime.full(a), b)


def test_one_rank_gather_pspecs_step_matches_the_reference(one_rank):
    """``lm_train_step(gather_pspecs=, grad_pspecs=)`` at micro 2 (the
    reference's phase-amortized gather: the tp layout gathered once a
    step, the grads reduced into the zero3 layout) on a one-rank mesh,
    against the reference's step on a one-device mesh: loss, grad norm
    and params after two steps, at the pipeline's SFT LR (Adam turns an
    ulp of a grad whose second moment is near 0 into up to an LR-sized
    step, so the params' agreement scales with the LR)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from repro import configs as jconfigs
    from repro.sharding import strategy as JS
    from repro.training.steps import lm_train_step as j_step
    from repro.training.train_state import TrainState as JTrainState
    from repro_torch.models import convert
    from repro_torch.sharding import strategy as S

    arch, tol = "smollm-135m", dict(rtol=2e-4, atol=2e-5)
    tcfg = D.lm_config(arch)
    jcfg = jconfigs.reduced(jconfigs.get_config(arch)).replace(
        use_pallas=False)
    params = T.init_params(tcfg, D._gen(5))
    # copies: the port's optimizer updates ``params`` in place, while the
    # reference's asynchronous step may still read a buffer it aliases
    jstate = JTrainState.create(jax.tree.map(
        lambda a: jnp.array(a, copy=True), convert.params_to_numpy(params)))
    jmesh = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                 ("data", "model"))
    lr = StageConfig.sft_lr
    jstep = jax.jit(lambda s, b: j_step(
        jcfg, s, b, lr, micro=2,
        gather_pspecs=JS.param_pspecs(jcfg, jmesh, "tp"),
        grad_pspecs=JS.param_pspecs(jcfg, jmesh, "zero3")))

    mesh = make_mesh(1, 1)
    step, sh, shard_batch = make_sharded_lm_step(tcfg, mesh, "zero3", zero=1)
    state = TrainState.create(params, shardings=sh)
    rng = np.random.RandomState(3)
    for _ in range(2):
        b = {"tokens": rng.randint(0, 64, (4, 16)),
             "labels": rng.randint(0, 64, (4, 16)),
             "mask": (rng.rand(4, 16) > 0.3).astype(np.float32)}
        with jmesh:
            jstate, jm = jstep(jstate, {k: jnp.asarray(v)
                                        for k, v in b.items()})
        state, m = lm_train_step(
            tcfg, state, shard_batch({k: torch.as_tensor(v)
                                      for k, v in b.items()}), lr,
            micro=2, gather_pspecs=S.param_pspecs(tcfg, mesh, "tp"),
            grad_pspecs=S.param_pspecs(tcfg, mesh, "zero3"))
        for k in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), **tol)
    got = convert.params_to_numpy(runtime.full_tree(state.params))
    for (_, a), b in zip(flatten_with_path(got),   # jax's leaf order
                         jax.tree.leaves(jstate.params)):
        np.testing.assert_allclose(a, np.asarray(b), **tol)
