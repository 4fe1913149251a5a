"""Asynchronous stage 3 on a shared ``data x model`` mesh, on gloo ranks over
the CPU: the Hybrid Engine's mesh runs both the producer (generation) and
the consumer (scoring and the PPO steps) on every rank, the producer on a
twin of the mesh (the same ranks on process groups of its own).  The
reference's ``tests/test_async_rlhf.py`` runs one device or the split
only; its ``run_ppo`` on the shared mesh is run here in a subprocess.

Without a process group: the refusals of this mode are gone from the
pipeline and the launcher.

One 2-rank gloo launch per mesh, ``2 x 1`` and ``1 x 2``
(``tests/_torch_async_mesh_driver.py``, each rank its own process), beside
the reference's ``run_ppo`` on the same mesh of 2 simulated host devices
(``tests/_jax_async_reference.py`` with ``mesh``, stage 3 from the same
weights: a 2-layer dense actor and critic, d 64, greedy fp32 PPO), all
started at module setup:

- the twin's groups are none of the mesh's (nor the default group);
- lockstep, with and without ``async_publish``, is the synchronous loop bit
  for bit on every rank, and so are the last checkpoint's shards;
- sync, lockstep, stale (``publish_every=2, max_lag=1``) and abort
  (``is_ratio_abort``) give the reference's sequences, ``policy_lag`` and
  ``lockstep_fallback`` exactly, its publish counts and bytes, and its
  ratios, scores, losses and final params at ``REF_TOL`` (rtol / atol
  1e-4, as the split and the one-device runs are held);
- the ordering guard: the producer's thread issued collectives on the
  twin's groups only, the consumer's on the mesh's and the default group
  only, the publisher's worker none; a stale run with rank 1 slowed ends
  with the same lags and sequences on every rank;
- ``launch.train --rlhf --mesh 2,1 --async-rlhf --max-lag 1`` (2 x 1
  launch);
- last, a producer failure injected on rank 1 ends both ranks non-zero
  with ``RuntimeError("rollout producer failed")``.
"""
import pickle
import re
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_disagg_driver as D
from _torch_parity import leaf_pairs
from repro_torch.core import (AsyncConfig, PPOConfig, RLHFPipeline,
                              StageConfig)
from repro_torch.data import CopyTaskDataset, DataBlender
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from test_torch_disaggregated import (COMPARED, REF_TOL, _codes, _env,
                                      _free_port, _logs, strip_wall)

pytestmark = pytest.mark.async_rlhf

ROOT = Path(__file__).resolve().parents[1]
DRIVER = str(ROOT / "tests" / "_torch_async_mesh_driver.py")
MESHES = {"2x1": (2, 1), "1x2": (1, 2)}
CASES = ("groups", "sync", "lockstep", "lockstep_ap", "stale", "abort",
         "skew", "launcher", "fail")
REFERENCE_MODES = ("sync", "lockstep", "stale", "abort")
LAGS = {"sync": [None] * 4, "lockstep": [0.0] * 4, "lockstep_ap": [0.0] * 4,
        "stale": [0.0, 1.0] * 2, "skew": [0.0, 1.0] * 2,
        "abort": [0.0, 1.0, 0.0, 0.0]}


def _spawn(out: Path, mesh: str, cases) -> list:
    """The 2 ranks of one gloo world, each its own process, started."""
    out.mkdir(parents=True, exist_ok=True)
    port, procs = _free_port(), []
    for r in range(2):
        env = dict(_env(), RANK=str(r), WORLD_SIZE="2", LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")
        log = out / f"rank{r}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, DRIVER, "--out", str(out), "--mesh", mesh,
                 "--cases", ",".join(cases)], stdout=f,
                stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env),
                log))
    return procs


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    d = tmp_path_factory.mktemp("async_mesh")
    _, models = D.ref_models()
    inp = {k: convert.params_to_numpy(v) for k, v in models.items()}
    inp.update(model=D.MODEL, width=6, stages=D.STAGES, ppo_kw=D.PPO,
               modes={m: D.MODES[m] for m in REFERENCE_MODES})
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    refs, worlds = {}, {}
    for name, (dp, tp) in MESHES.items():
        with open(d / f"in_{name}.pkl", "wb") as f:
            pickle.dump(dict(inp, mesh=(dp, tp)), f)
        with open(d / f"ref_{name}.log", "w") as log:
            refs[name] = subprocess.Popen(
                [sys.executable,
                 str(ROOT / "tests" / "_jax_async_reference.py"),
                 str(d / f"in_{name}.pkl"), str(d / f"ref_{name}.pkl")],
                stdout=log, stderr=subprocess.STDOUT, cwd=ROOT, env=env)
        cases = [c for c in CASES if c != "launcher" or name == "2x1"]
        worlds[name] = _spawn(d / name, f"{dp},{tp}", cases)
    yield {"dir": d, "refs": refs, "worlds": worlds}
    for p in list(refs.values()) + [p for w in worlds.values()
                                     for p, _ in w]:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def reference(started):
    out = {}
    for name, p in started["refs"].items():
        try:
            p.wait(timeout=600)
        except subprocess.TimeoutExpired:
            pass                          # returncode None: fails below
        log = started["dir"] / f"ref_{name}.log"
        assert p.returncode == 0, log.read_text()[-4000:]
        with open(started["dir"] / f"ref_{name}.pkl", "rb") as f:
            out[name] = pickle.load(f)
    return out


@pytest.fixture(scope="module")
def worlds(started):
    """Each launch's records, exit codes and logs (its last case fails on
    purpose)."""
    out = {}
    for name, procs in started["worlds"].items():
        codes = _codes(procs)
        d = started["dir"] / name
        recs = {c: {r: torch.load(d / f"{c}.{r}.pt", weights_only=False)
                    for r in range(2) if (d / f"{c}.{r}.pt").exists()}
                for c in CASES}
        out[name] = {"codes": codes, "recs": recs,
                     "logs": [log.read_text() for _, log in procs],
                     "all_logs": _logs(procs)}
    return out


def _records(worlds, mesh: str, case: str) -> dict:
    recs = worlds[mesh]["recs"][case]
    assert sorted(recs) == [0, 1], (mesh, case, worlds[mesh]["all_logs"])
    return recs


# --------------------------------------------------------------------- #
# no process group
# --------------------------------------------------------------------- #
def test_the_refusals_are_gone(capsys):
    """The pipeline takes ``async_cfg`` with a Hybrid Engine over 2 ranks (a
    stand-in: nothing is read before the run), and the launcher passes
    ``--async-rlhf`` on a ``--mesh`` of 2 ranks to the mesh, which one
    process cannot hold; no module of the port says the mode is not
    ported."""
    bl = DataBlender([CopyTaskDataset(50, 4, 4, 64, seed=1)])
    two = types.SimpleNamespace(hybrid=types.SimpleNamespace(
        mesh=types.SimpleNamespace(shape={"data": 2, "model": 1})))
    pipe = RLHFPipeline(two, bl, StageConfig(), PPOConfig(),
                        async_cfg=AsyncConfig.lockstep())
    assert pipe.async_cfg == AsyncConfig.lockstep()
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", "--rlhf", "--mesh", "2,1",
                      "--async-rlhf"])
    assert e.value.code == 2
    assert "mesh 2x1 needs 2 ranks, have 1" in capsys.readouterr().err
    import torch.distributed as dist
    assert not dist.is_initialized()
    src = ROOT / "src" / "repro_torch"
    for path in src.rglob("*.py"):
        assert "shared mesh of more than one rank" not in \
            " ".join(path.read_text().split()), path


# --------------------------------------------------------------------- #
# the launches
# --------------------------------------------------------------------- #
@pytest.mark.parametrize("mesh", list(MESHES))
def test_the_twin_groups_are_the_producers_own(worlds, mesh):
    for r, rec in _records(worlds, mesh, "groups").items():
        assert rec["coords"][0] is not None
        assert rec["coords"][1:] == [rec["coords"][0]] * 2
        taken = set(rec["mesh"].values()) | {rec["world"]}
        seen = set()
        for twin in rec["twins"]:
            assert list(twin) == ["data", "model"]
            assert not set(twin.values()) & (taken | seen), (rec, r)
            seen |= set(twin.values())


@pytest.mark.parametrize("mode", ["lockstep", "lockstep_ap"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_lockstep_is_sync_bit_for_bit(worlds, mesh, mode):
    sync, lock = (_records(worlds, mesh, c) for c in ("sync", mode))
    for r in (0, 1):
        s, a = sync[r], lock[r]
        assert len(s["sequences"]) == len(a["sequences"]) == 4
        for x, y in zip(s["sequences"], a["sequences"]):
            np.testing.assert_array_equal(x, y)
        assert [strip_wall(m) for m in s["log"]] == \
            [strip_wall(m) for m in a["log"]]
        assert s["sha"] == a["sha"]
        assert a["async_stats"]["produced"] == 4
        assert a["async_stats"]["producer_stream"] is False   # the CPU
        if mode == "lockstep":
            # the last checkpoint (every iteration saved), shard by shard
            sd, ad = Path(s["ckpt"]) / "shards", Path(a["ckpt"]) / "shards"
            names = sorted(p.name for p in sd.iterdir())
            assert names and names == sorted(p.name for p in ad.iterdir())
            for n in names:
                assert (sd / n).read_bytes() == (ad / n).read_bytes(), n


@pytest.mark.parametrize("mode", REFERENCE_MODES)
@pytest.mark.parametrize("mesh", list(MESHES))
def test_matches_the_reference(worlds, reference, mesh, mode):
    recs, want = _records(worlds, mesh, mode), reference[mesh][mode]
    got = recs[0]
    assert recs[1]["sha"] == got["sha"]
    assert [strip_wall(m) for m in recs[1]["log"]] == \
        [strip_wall(m) for m in got["log"]]
    assert len(got["sequences"]) == len(want["sequences"]) == 4
    for a, b in zip(got["sequences"], want["sequences"]):
        np.testing.assert_array_equal(a, b)
    lags = [m.get("policy_lag") for m in got["log"]]
    assert lags == [m.get("policy_lag") for m in want["log"]] == LAGS[mode]
    assert [m.get("lockstep_fallback") for m in got["log"]] == \
        [m.get("lockstep_fallback") for m in want["log"]]
    for mg, mw in zip(got["log"], want["log"]):
        for k in COMPARED:
            if k in mw:
                np.testing.assert_allclose(mg[k], mw[k], err_msg=k,
                                           **REF_TOL)
    for name in ("actor", "critic", "ema"):
        for a, b in leaf_pairs(got[name], want[name]):
            np.testing.assert_allclose(a, b, err_msg=name, **REF_TOL)
    if mode == "sync":
        return
    a, w = got["async_stats"], want["async_stats"]
    for k in ("produced", "lockstep_fallbacks"):
        assert a[k] == w[k], k
    for k in ("publishes", "total_publish_bytes"):
        assert a["publisher"][k] == w["publisher"][k], k


@pytest.mark.parametrize("mode", ["lockstep_ap", "stale"])
@pytest.mark.parametrize("mesh", list(MESHES))
def test_each_thread_issues_collectives_on_its_own_groups(worlds, mesh,
                                                          mode):
    """The ordering guard: every collective of the run, by thread and
    group.  The producer used only the twin's groups, the consumer only
    the mesh's and the default group, the publisher's worker none."""
    for r, rec in _records(worlds, mesh, mode).items():
        twin = set(rec["async_stats"]["producer_groups"].values())
        mine = set(rec["mesh_groups"].values()) | {rec["world"]}
        assert not twin & mine
        by = {}
        for thread, group in rec["calls"]:
            by.setdefault(thread, set()).add(group)
        assert set(by) == {"MainThread", "rollout-producer"}, (r, by)
        assert by["rollout-producer"] <= twin, (r, by)
        assert by["MainThread"] <= mine, (r, by)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_slowed_rank_decodes_the_same_versions(worlds, mesh):
    skew, stale = (_records(worlds, mesh, c) for c in ("skew", "stale"))
    for r in (0, 1):
        assert [m["policy_lag"] for m in skew[r]["log"]] == LAGS["skew"]
        for x, y, z in zip(skew[r]["sequences"], skew[1 - r]["sequences"],
                           stale[r]["sequences"]):
            np.testing.assert_array_equal(x, y)
            np.testing.assert_array_equal(x, z)
        assert skew[r]["sha"] == stale[r]["sha"]


def test_launcher_runs_async_rlhf_on_the_mesh(worlds):
    recs = _records(worlds, "2x1", "launcher")
    first = recs[0]
    assert "mesh={'data': 2, 'model': 1}" in first["stdout"]
    assert re.search(r"^async: produced=2 max_depth=\d dropped=0 "
                     r"fallbacks=0 publishes=3$", first["stdout"],
                     flags=re.M), first["stdout"]
    for rec in recs.values():
        a = rec["async"]
        assert a["produced"] == len(rec["ppo_scores"]) == 2
        assert list(a["producer_groups"]) == ["data", "model"]
        assert np.isfinite(rec["ppo_scores"]).all()
    assert recs[1]["stdout"] == ""
    assert recs[1]["sha"] == first["sha"]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_a_producer_failure_on_rank_1_ends_both_ranks(worlds, mesh):
    w = worlds[mesh]
    assert all(c not in (0, None) for c in w["codes"]), \
        (w["codes"], w["all_logs"])
    for log in w["logs"]:
        assert "RuntimeError: rollout producer failed" in log, log[-3000:]
    assert "ValueError: decode failed" in w["logs"][1]
