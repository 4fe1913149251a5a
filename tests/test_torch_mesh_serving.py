"""The request core on a mesh: ``GenerationEngine.core()`` and ``serve`` over
slots split on ``data``, MoE generation whose decode routes the data
group's rows together, and ``launch.serve --mesh``, on gloo ranks over the
CPU, held to the single-rank port and to the reference on the same mesh.

One launch of ``tests/_torch_mesh_driver.py`` per mesh (2 x 1, 1 x 2,
2 x 2 and 1 x 4) runs the ``ms_*`` cases, and the reference runs the same
weights and requests on the 2 x 1 and 2 x 2 meshes of simulated host
devices, in one subprocess of ``tests/_jax_mesh_reference.py`` per mesh,
started with the launches.  The rule is the reference's under GSPMD: one
core drains the whole mesh, so with the same ``slots`` and ``num_blocks``
everything a rank returns is the one-device core's.

- ``serve`` and ``core()`` (the serve launcher's drain loop) on a 2-slot
  and a 4-slot dense arena, the paged int8 pool and a paged int8 pool
  that preempts: completions by uid and finish reason equal to the
  single-rank port's and to the reference's ``serve`` on the same mesh,
  and ``last_stats`` / ``stats()`` equal to the single-rank port's,
  counter for counter.  (A ``serve`` that splits the requests over
  ``data``, each data rank on a core of its own with the full slots and
  pool, fails this: at 2 x 1 it read 22 decode steps on the tight pool
  where one rank reads 30.)
- Sampled runs (temperature 0.8, top-k 40, one request with a seed of its
  own), dense and paged: the single-rank port's tokens on every mesh.
- Reduced llama4-scout-17b-a16e (dense arena and paged pool) and
  deepseek-v2-lite-16b (dense arena) at 2 x 1 and 2 x 2: greedy
  ``generate``, ``serve`` and ``core()`` equal the single-rank port's and
  the reference's on the same mesh, and the rows every MoE call routes
  (its router probabilities), gathered over the data group, are the
  single-rank engine's at every admission and decode step (R13); one
  stage-3 experience with that llama4-scout actor at 2 x 1 equals the
  single-rank port's.
- The mesh path at 1 x 1, on a one-rank gloo group in this process: the
  core's completions and stats bit for bit the plain core's.
- ``torchrun --nproc-per-node 2 -m repro_torch.launch.serve --device cpu
  --mesh 2,1``: exit 0, one summary line (rank 0's) whose tokens, slot
  utilization and pool statistics equal ``--mesh 1,1``'s and the plain
  launcher's; ``--chat`` on that mesh answers a piped conversation as the
  plain launcher does.
"""
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_mesh_driver as D
from repro_torch.models import convert
from repro_torch.models import transformer as T
from repro_torch.serving.engine import GenerationEngine
from repro_torch.serving.sampling import sample_rows
from repro_torch.sharding import runtime
from test_torch_tensor_parallel import _env, _torchrun, _wait

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=2e-4, atol=2e-5)
MESHES = ((2, 1), (1, 2), (2, 2), (1, 4))
IDS = [f"{dp}x{tp}" for dp, tp in MESHES]
MOE_MESHES = ((2, 1), (2, 2))
MOE_IDS = [f"{dp}x{tp}" for dp, tp in MOE_MESHES]
PATHS = [p[0] for p in D.MS_PATHS]
GREEDY = [p for p in PATHS if not p.startswith("sampled")]
MOE = [(name, layout) for name, _, layouts in D.MS_MOE
       for layout in ("generate", *layouts)]
MOE_CASE_IDS = [f"{n}-{w}" for n, w in MOE]


def _popen(cmd, log: Path):
    """``cmd`` started (not waited on), its output to ``log``."""
    with open(log, "w") as f:
        return subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT,
                                text=True, cwd=ROOT, env=_env())


def _cases(mesh) -> str:
    return ",".join(["ms_engine"] + (["ms_moe"] if mesh in MOE_MESHES
                                     else [])
                    + (["ms_ppo"] if mesh == (2, 1) else []))


def _reference_inputs():
    """``_torch_mesh_driver``'s weights and requests, as numpy."""
    np_ = convert.params_to_numpy
    moe = {}
    for name, arch, layouts in D.MS_MOE:
        cfg = D.lm_config(arch)
        moe[name] = (arch, np_(T.init_params(cfg, D._gen(1))), layouts)
    return {"ms": True, "ppo_kw": D.PPO_KW, "prompts": D.PROMPTS,
            "reqs": [r.tokens for r in D.ms_requests()],
            "engine_params": np_(T.init_params(D.ACTOR, D._gen(1))),
            "paths": {name: (over, kw, skw)
                      for name, over, kw, skw in D.MS_PATHS
                      if name in GREEDY},
            "moe": moe}


@pytest.fixture(scope="module")
def launches(tmp_path_factory):
    """The reference's runs and the gloo launches, all started together."""
    d = tmp_path_factory.mktemp("ms")
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(_reference_inputs(), f)
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    script = ROOT / "tests" / "_jax_mesh_reference.py"
    refs, runs = {}, {}
    for dp, tp in MOE_MESHES:
        with open(d / f"ref{dp}x{tp}.log", "w") as log:
            refs[(dp, tp)] = subprocess.Popen(
                [sys.executable, str(script), str(d / "in.pkl"),
                 str(d / f"ref{dp}x{tp}.pkl"), str(dp), str(tp)],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    for mesh in MESHES:
        out = d / "run{}x{}".format(*mesh)
        out.mkdir()
        runs[mesh] = (out, _torchrun(
            mesh[0] * mesh[1], out / "log",
            str(ROOT / "tests" / "_torch_mesh_driver.py"), "--out",
            str(out), "--cases", _cases(mesh), "--mesh", "{},{}".format(
                *mesh)))
    yield d, refs, runs
    for p in list(refs.values()) + [p for _, p in runs.values()]:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def runs(launches):
    _, _, procs = launches
    out = {}
    for mesh, (d, p) in procs.items():
        _wait(p, d / "log")
        out[mesh] = {c: torch.load(d / f"{c}.pt", weights_only=False)
                     for c in _cases(mesh).split(",")}
    return out


@pytest.fixture(scope="module")
def reference(launches):
    d, procs, _ = launches
    out = {}
    for (dp, tp), p in procs.items():
        _wait(p, d / f"ref{dp}x{tp}.log")
        with open(d / f"ref{dp}x{tp}.pkl", "rb") as f:
            out[(dp, tp)] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def single():
    """The single-rank port on the same weights and requests."""
    return {"ms_engine": D.ms_serve(), "ms_moe": D.ms_moe(),
            "ms_ppo": D.ms_ppo_moe()}


def _comps_equal(got: dict, want: dict):
    """Completions by uid: tokens and, where both carry it, the finish
    reason."""
    assert sorted(got) == sorted(want)
    for uid, w in want.items():
        g = got[uid]
        if isinstance(w, tuple):
            np.testing.assert_array_equal(g[0], w[0], err_msg=str(uid))
            assert g[1] == w[1], uid
        else:
            np.testing.assert_array_equal(g, w, err_msg=str(uid))


def _run_equal(got: dict, want: dict):
    _comps_equal(got["serve"], want["serve"])
    _comps_equal(got["core"], want["core"])
    assert got["serve_stats"] == want["serve_stats"]
    assert got["core_stats"] == want["core_stats"]


# --------------------------------------------------------------------- #
# serve and core() over the slots
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_mesh_serve_stats_equal_single_rank(runs, single, mesh, path):
    """``last_stats`` of ``serve`` and ``stats()`` of ``core()``: the
    one-device core's, counter for counter (decode steps, scheduled
    tokens, concurrency, preemptions, block high water)."""
    got = runs[mesh]["ms_engine"][path]
    want = single["ms_engine"][path]
    assert got["serve_stats"] == want["serve_stats"]
    assert got["core_stats"] == want["core_stats"]
    if path == "paged_int8_tight":       # the pool preempts
        assert want["serve_stats"]["preemptions"] > 0


@pytest.mark.parametrize("path", PATHS)
@pytest.mark.parametrize("mesh", MESHES, ids=IDS)
def test_mesh_core_and_serve_equal_single_rank(runs, single, mesh, path):
    """Completions by uid and finish reason through ``serve`` and
    ``core()``, greedy and sampled (the shared generator's draws and the
    seeded request's own are the one-device core's)."""
    got = runs[mesh]["ms_engine"][path]
    want = single["ms_engine"][path]
    _comps_equal(got["serve"], want["serve"])
    _comps_equal(got["core"], want["core"])
    _comps_equal(got["core"], {u: t for u, (t, _) in want["serve"].items()})


def test_sampled_runs_sample(single):
    """The sampled paths are not greedy's, and the seeded request's stream
    does not depend on the batch (it is request 2's alone)."""
    runs = single["ms_engine"]
    for greedy, sampled in (("dense", "sampled"),
                            ("paged_int8", "sampled_paged")):
        assert any(not np.array_equal(runs[greedy]["serve"][u][0], t)
                   for u, (t, _) in runs[sampled]["serve"].items())
    eng = GenerationEngine(D.ACTOR, device="cpu",
                           **{**D.PPO_KW, **D.SAMPLED_KW})
    params = T.init_params(D.ACTOR, D._gen(1))
    alone = eng.serve(params, D.ms_requests(True)[2:3], D._gen(99), slots=2)
    np.testing.assert_array_equal(alone[0].tokens,
                                  runs["sampled"]["serve"][2][0])


@pytest.mark.parametrize("path", GREEDY)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=MOE_IDS)
def test_mesh_serve_matches_the_reference(runs, reference, mesh, path):
    """The reference's ``serve`` on the same mesh (one GSPMD core):
    completions by uid and finish reason, through ``serve`` and
    ``core()``."""
    got = runs[mesh]["ms_engine"][path]
    want = reference[mesh]["paths"][path]
    _comps_equal(got["serve"], want)
    _comps_equal(got["core"], {u: t for u, (t, _) in want.items()})


# --------------------------------------------------------------------- #
# MoE generation over data
# --------------------------------------------------------------------- #
def _moe_equal(got, want, what):
    if what == "generate":
        for k in ("sequences", "response_mask"):
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert got["steps"] == want["steps"]
    else:
        _run_equal(got, want)


@pytest.mark.parametrize("case", MOE, ids=MOE_CASE_IDS)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=MOE_IDS)
def test_moe_generation_over_data_equals_single_rank(runs, single, mesh,
                                                     case):
    name, what = case
    _moe_equal(runs[mesh]["ms_moe"][name][what],
               single["ms_moe"][name][what], what)


@pytest.mark.parametrize("case", MOE, ids=MOE_CASE_IDS)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=MOE_IDS)
def test_moe_routes_the_data_groups_rows_together(runs, single, mesh,
                                                  case):
    """R13: every MoE call of the mesh run routes the rows the single-rank
    engine's does, in its order (prefill buckets, then every slot or row
    of each decode step, idle and finished ones included): the same row
    count, and router probabilities equal to the cross-layout tolerance."""
    name, what = case
    got = runs[mesh]["ms_moe"][name][what]["routes"]
    want = single["ms_moe"][name][what]["routes"]
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, i
        np.testing.assert_allclose(g.numpy(), w.numpy(), err_msg=str(i),
                                   **TOL)


@pytest.mark.parametrize("case", MOE, ids=MOE_CASE_IDS)
@pytest.mark.parametrize("mesh", MOE_MESHES, ids=MOE_IDS)
def test_moe_generation_over_data_matches_the_reference(runs, reference,
                                                        mesh, case):
    name, what = case
    got = runs[mesh]["ms_moe"][name][what]
    want = reference[mesh]["moe"][name][what]
    if what == "generate":
        _moe_equal(got, want, what)
        return
    _comps_equal(got["serve"], want)
    _comps_equal(got["core"], {u: t for u, (t, _) in want.items()})


def test_moe_stage3_experience_equals_single_rank(runs, single):
    """One stage-3 experience through the Hybrid Engine (zero3 + ZeRO-1) at
    2 x 1 with a reduced llama4-scout actor and critic: its MoE decode
    routes the data group's rows together, so the greedy sequences are
    the single-rank port's and the rest agrees to the cross-layout
    tolerance."""
    got, want = runs[(2, 1)]["ms_ppo"], single["ms_ppo"]
    for k, v in want["exp"].items():
        if k in ("sequences", "mask"):
            np.testing.assert_array_equal(got["exp"][k], v, err_msg=k)
        else:
            np.testing.assert_allclose(got["exp"][k], v, err_msg=k, **TOL)
    for k in ("reward_score", "gen_len", "decode_steps"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k],
                                   err_msg=k, **TOL)


# --------------------------------------------------------------------- #
# one rank: the mesh path at 1 x 1, and the pieces it is made of
# --------------------------------------------------------------------- #
@pytest.fixture(scope="module")
def one_rank(tmp_path_factory):
    """A one-rank gloo group in this process and its 1 x 1 mesh."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import init_distributed, make_mesh
    store = tmp_path_factory.mktemp("pg") / "store"
    owned = not dist.is_initialized()
    init_distributed("cpu", init_method=f"file://{store}", rank=0,
                     world_size=1)
    yield make_mesh(1, 1)
    if owned:
        dist.destroy_process_group()


@pytest.mark.parametrize("path", PATHS)
def test_one_rank_mesh_core_is_the_plain_core(one_rank, path):
    """At 1 x 1 the core takes the mesh branch (the slots split over a
    one-rank data group, the chunk gathered over it, the shared noise
    drawn by rows): completions and stats bit for bit the plain core's."""
    name, over, kw, skw = next(p for p in D.MS_PATHS if p[0] == path)
    cfg = D.ACTOR.replace(**over)
    params = T.init_params(D.ACTOR, D._gen(1))
    outs = []
    for mesh in (None, one_rank):
        eng = GenerationEngine(cfg, mesh=mesh, device="cpu",
                               **{**D.PPO_KW, **kw})
        outs.append(D._drain(eng, params, D.ms_requests(
            path.startswith("sampled")), skw))
    _run_equal(outs[1], outs[0])
    core = GenerationEngine(cfg, mesh=one_rank, device="cpu",
                            **{**D.PPO_KW, **kw}).core(
        params, D._gen(0), max_seq_len=16,
        **{k: v for k, v in skw.items() if k != "max_seq_len"})
    assert (core.group is not None) == (kw.get("kv_layout") != "paged")


def test_one_rank_mesh_moe_generate_is_the_plain_generate(one_rank):
    """An MoE model's ``generate`` at 1 x 1 routes through the data group
    of one rank: the plain engine's tokens and routed rows, bit for bit."""
    cfg = D.lm_config("llama4-scout-17b-a16e")
    params = T.init_params(cfg, D._gen(1))
    outs = []
    for mesh in (None, one_rank):
        with D.routed_rows([]) as log:
            o = GenerationEngine(cfg, mesh=mesh, device="cpu",
                                 **D.PPO_KW).generate(
                params, torch.as_tensor(D.PROMPTS), D._gen(7))
        outs.append((o, log))
    for k in ("sequences", "response_mask"):
        assert torch.equal(outs[0][0][k], outs[1][0][k])
    assert all(torch.equal(a, b) for a, b in zip(outs[0][1], outs[1][1],
                                                 strict=True))


def test_gather_chunk_and_all_true_on_one_rank(one_rank):
    """The core's host sync: the chunk's tokens and done flags in slot
    order, as host arrays; ``all_true`` is ``flags.all()``."""
    toks = torch.tensor([[5, 6, 7], [8, 9, 10]])
    was = torch.tensor([[False, True, False], [True, True, False]])
    done = torch.tensor([True, False, True])
    group = runtime.data_group(one_rank)
    for g in (None, group):
        t, w, d = runtime.gather_chunk(toks, was, done, g)
        np.testing.assert_array_equal(t, toks.numpy())
        assert t.dtype == np.int32
        np.testing.assert_array_equal(w, was.numpy())
        np.testing.assert_array_equal(d, done.numpy())
        assert runtime.all_true(done, g) is False
        assert runtime.all_true(done | True, g) is True


class _FakeMesh:
    """``data_share``'s view of a ``DeviceMesh``: axes, this rank's
    coordinate, a data group."""
    mesh_dim_names = ("data", "model")

    def __init__(self, dp, tp, coord):
        self.shape = {"data": dp, "model": tp}
        self.axis_names = self.mesh_dim_names
        self.coord = coord

    def get_coordinate(self):
        return list(self.coord)

    def get_group(self, name):
        return f"group:{name}"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 6, 8])
def test_data_share_is_contiguous_in_rank_order(n):
    """Each data rank's share of ``n`` rows: contiguous, in rank order,
    covering every row once when ``data`` divides ``n``; every row on every
    rank (no group) otherwise, and without a mesh."""
    assert runtime.data_share(n, None) == (0, n, None)
    for dp in (1, 2, 4):
        shares = [runtime.data_share(n, _FakeMesh(dp, 2, (r, 1)))
                  for r in range(dp)]
        if n % dp:
            assert shares == [(0, n, None)] * dp
            continue
        assert [s[:2] for s in shares] == [(r * n // dp, (r + 1) * n // dp)
                                           for r in range(dp)]
        assert all(s[2] == "group:data" for s in shares)


@pytest.mark.parametrize("n,rows", [(4, (0, 4)), (4, (1, 3)), (6, (2, 5))])
def test_sample_rows_draws_the_whole_batch_noise(n, rows):
    """``noise_rows=(r0, n)``: a rank's rows sample what the same rows of
    the whole batch sample from the same generator, which advances as the
    whole batch's draw advances it; a row's own generator replaces its
    shared noise."""
    g = torch.Generator().manual_seed(0)
    logits = torch.randn((n, 50), generator=g)
    full = lambda v: torch.full((n,), v)
    kw = dict(temperature=full(0.9), top_k=full(0).long(), top_p=full(1.0))
    own = [None] * n
    own[rows[0]] = torch.Generator().manual_seed(3)
    want_g, got_g = D._gen(5), D._gen(5)
    want = sample_rows(logits, want_g, row_generators=own, **kw)
    own[rows[0]] = torch.Generator().manual_seed(3)
    r0, r1 = rows
    got = sample_rows(logits[r0:r1], got_g,
                      row_generators=own[r0:r1], noise_rows=(r0, n),
                      **{k: v[r0:r1] for k, v in kw.items()})
    assert torch.equal(got, want[r0:r1])
    assert torch.equal(torch.rand(4, generator=got_g),
                       torch.rand(4, generator=want_g))


# --------------------------------------------------------------------- #
# the serve launcher on a mesh
# --------------------------------------------------------------------- #
SERVE = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
         "smollm-135m", "--reduced", "--requests", "6", "--ragged",
         "--prompt-len", "12", "--max-new", "8", "--batch", "4", "--chunk",
         "4"]
PAGED_INT8 = ["--kv-layout", "paged", "--block-size", "4", "--num-blocks",
              "9", "--kv-quant"]


def _summary(out: str) -> list:
    """The summary lines without their time and rate."""
    return [re.sub(r"in [0-9.]+s  \([0-9.]+ tok/s", "in - (- tok/s", s)
            for s in out.splitlines() if s.startswith("scheduler=")]


@pytest.mark.parametrize("layout", [[], PAGED_INT8], ids=["dense",
                                                           "paged_int8"])
def test_torchrun_serve_on_a_mesh(layout, tmp_path):
    """``--mesh 2,1`` under ``torchrun`` exits 0; rank 0 alone prints the
    mesh and one summary line, which (times aside) is ``--mesh 1,1``'s
    and the plain launcher's: the same tokens, slot utilization and pool
    statistics (preemptions included: 9 blocks preempt)."""
    procs = {
        "2,1": _torchrun(2, tmp_path / "m21", *SERVE, *layout,
                         "--mesh", "2,1"),
        "1,1": _popen([sys.executable, *SERVE, *layout, "--mesh", "1,1"],
                      tmp_path / "m11"),
        "plain": _popen([sys.executable, *SERVE, *layout],
                        tmp_path / "plain")}
    outs = {k: _wait(p, tmp_path / {"2,1": "m21", "1,1": "m11",
                                    "plain": "plain"}[k], timeout=300)
            for k, p in procs.items()}
    assert outs["2,1"].count("mesh={'data': 2, 'model': 1} params=tp "
                             "layout") == 1, outs["2,1"]
    lines = {k: _summary(v) for k, v in outs.items()}
    assert len(lines["plain"]) == 1, outs["plain"]
    assert lines["2,1"] == lines["1,1"] == lines["plain"]
    if layout:
        assert "preempt=0" not in lines["plain"][0], lines["plain"]


def test_torchrun_serve_chat_on_a_mesh(tmp_path):
    """``--chat --mesh 2,1``: rank 0 reads the piped lines and every rank
    drives the same core; the replies are the plain launcher's."""
    chat = ["-m", "repro_torch.launch.serve", "--device", "cpu", "--arch",
            "smollm-135m", "--reduced", "--max-new", "8", "--chat"]
    lines = "hello there\nhow are you\n\n"
    outs = {}
    for name, cmd in (("mesh", [sys.executable, "-m",
                                "torch.distributed.run", "--standalone",
                                "--nproc-per-node", "2", *chat, "--mesh",
                                "2,1"]),
                      ("plain", [sys.executable, *chat])):
        res = subprocess.run(cmd, input=lines, capture_output=True,
                             text=True, cwd=ROOT, env=_env(), timeout=300,
                             errors="replace")
        assert res.returncode == 0, res.stderr[-4000:]
        outs[name] = [s for s in res.stdout.splitlines()
                      if "Assistant:" in s]
    assert len(outs["plain"]) == 2 and outs["mesh"] == outs["plain"]
