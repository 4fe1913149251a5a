"""The disaggregated rollout / training split on gloo ranks over the CPU,
the counterpart of ``tests/test_async_rlhf.py``'s split tests (which fail
on Python 3.12: they import ``repro.core``, ROADMAP Queue 3, R1).

Without a process group: the sub-mesh specs, a split larger than the
world, the card check, the launcher's refusals.

One 4-rank gloo world at rollout ``1 x 2`` | train ``2 x 1``
(``tests/_torch_disagg_driver.py``, every rank started on its own), beside
the reference's run of the same split on 4 simulated host devices
(``tests/_jax_async_reference.py`` with ``split``, stage 3 from the same
weights: a 2-layer dense actor and critic, d 64, greedy fp32 PPO): the
meshes are disjoint; ``cross_mesh_put`` leaves each rollout rank holding
the reference's shard for that device, bit for bit, and the publishes
count the reference's ``total_publish_bytes``; sync, lockstep, stale and
abort over the split give the reference's sequences, lags and
``lockstep_fallback`` exactly and its ratios, scores, losses and final
params at ``REF_TOL`` (rtol / atol 1e-4, as
``tests/test_torch_async_rlhf.py`` holds the one-device runs); lockstep
over the split is sync over the split bit for bit; the launcher's
``--rlhf --rollout-mesh 2 --train-mesh 2 --async-rlhf`` summary; and, last,
a producer failure injected on the first rollout rank ends every rank
non-zero with ``RuntimeError("rollout producer failed")``.  Two more
4-rank worlds: lockstep with a checkpoint each iteration, its training
ranks killed at the top of iteration 2, then the same run again, which
resumes there and ends on the uninterrupted lockstep run's states.

One 2-rank world at ``1 | 1`` (the card's layout): sync and lockstep over
the split at temperature 1.0 (the stage-3 generator draws on the rollout
rank) are the port's one-device synchronous run bit for bit.

Every process starts at module setup; each waits for nothing but its own
world (the resumed run for the killed one).
"""
import os
import pickle
import re
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import _torch_disagg_driver as D
from _torch_parity import leaf_pairs
from repro_torch.core import PPOConfig, RLHFEngine, RLHFPipeline, StageConfig
from repro_torch.launch import mesh as M
from repro_torch.launch import train as tlaunch
from repro_torch.models import convert
from repro_torch.training.checkpoint import tree_sha256

pytestmark = pytest.mark.async_rlhf

ROOT = Path(__file__).resolve().parents[1]
DRIVER = str(ROOT / "tests" / "_torch_disagg_driver.py")
REF_TOL = dict(rtol=1e-4, atol=1e-4)
COMPARED = ("is_ratio_mean", "is_ratio_max", "reward_score", "actor_loss",
            "pg_loss", "v_loss", "ratio_mean")
# wall-time and topology telemetry, and the async-only keys
WALL_KEYS = ("gen_tok_s", "gen_s", "score_ms", "actor_ms", "critic_ms",
             "publish_s", "publish_bytes", "queue_depth", "policy_lag",
             "is_ratio_mean", "is_ratio_max", "lockstep_fallback",
             "reshard_s", "reshard_bytes")
MAIN_CASES = ("meshes", "put", "sync", "lockstep", "stale", "abort",
              "launcher", "fail")
ROLLOUT, TRAIN = (0, 1), (2, 3)


def strip_wall(m: dict) -> dict:
    return {k: v for k, v in m.items() if k not in WALL_KEYS}


def _env():
    env = dict(os.environ, PYTHONPATH=f"{ROOT / 'src'}:{ROOT / 'tests'}")
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
              "MASTER_PORT"):
        env.pop(k, None)
    return env


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawn(n: int, out: Path, *args) -> list:
    """``n`` ranks of one gloo world, each its own process (a rank that
    fails ends on its own; none is stopped by another's exit), started:
    ``[(process, log)]``."""
    out.mkdir(parents=True, exist_ok=True)
    port, procs = _free_port(), []
    for r in range(n):
        env = dict(_env(), RANK=str(r), WORLD_SIZE=str(n), LOCAL_RANK=str(r),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port),
                   OMP_NUM_THREADS="1")       # as torchrun sets it
        log = out / f"rank{r}.log"
        with open(log, "w") as f:
            procs.append((subprocess.Popen(
                [sys.executable, DRIVER, "--out", str(out),
                 *(str(a) for a in args)], stdout=f,
                stderr=subprocess.STDOUT, text=True, cwd=ROOT, env=env),
                log))
    return procs


def _codes(procs, timeout=300) -> list:
    """Each rank's exit code (``None``: killed at ``timeout``)."""
    out = []
    for p, _ in procs:
        try:
            out.append(p.wait(timeout=timeout))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
            out.append(None)
    return out


def _logs(procs) -> str:
    return "\n".join(log.read_text()[-3000:] for _, log in procs)


@pytest.fixture(scope="module", autouse=True)
def started(tmp_path_factory):
    d = tmp_path_factory.mktemp("disagg")
    _, models = D.ref_models()
    inp = {k: convert.params_to_numpy(v) for k, v in models.items()}
    inp.update(model=D.MODEL, width=6, stages=D.STAGES, ppo_kw=D.PPO,
               modes=D.MODES, split=(2, 2))
    with open(d / "in.pkl", "wb") as f:
        pickle.dump(inp, f)
    env = dict(_env(), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    with open(d / "ref.log", "w") as log:
        ref = subprocess.Popen(
            [sys.executable, str(ROOT / "tests" / "_jax_async_reference.py"),
             str(d / "in.pkl"), str(d / "ref.pkl")], stdout=log,
            stderr=subprocess.STDOUT, cwd=ROOT, env=env)
    worlds = {
        "main": _spawn(4, d / "main", "--cases", ",".join(MAIN_CASES)),
        "one": _spawn(2, d / "one", "--rollout", "1", "--train", "1",
                      "--cases", "one_sync,one_lockstep"),
        "die": _spawn(4, d / "die", "--cases", "die", "--ckpt", d / "ck")}
    yield {"dir": d, "ref": ref, "worlds": worlds}
    for p in [ref] + [p for w in worlds.values() for p, _ in w]:
        p.kill()
        p.wait()


@pytest.fixture(scope="module")
def reference(started):
    p = started["ref"]
    try:
        p.wait(timeout=600)
    except subprocess.TimeoutExpired:
        pass                              # returncode None: fails below
    assert p.returncode == 0, (started["dir"] / "ref.log").read_text()[-4000:]
    with open(started["dir"] / "ref.pkl", "rb") as f:
        return pickle.load(f)


@pytest.fixture(scope="module")
def main_world(started):
    """The main world's records and each rank's exit code and log (its
    last case fails on purpose)."""
    procs = started["worlds"]["main"]
    codes = _codes(procs)
    d = started["dir"] / "main"
    recs = {c: {r: torch.load(d / f"{c}.{r}.pt", weights_only=False)
                for r in range(4) if (d / f"{c}.{r}.pt").exists()}
            for c in MAIN_CASES}
    return {"codes": codes, "recs": recs,
            "logs": [log.read_text() for _, log in procs],
            "all_logs": _logs(procs)}


def _records(main_world, case: str) -> dict:
    recs = main_world["recs"][case]
    assert sorted(recs) == [0, 1, 2, 3], (case, main_world["all_logs"])
    return recs


# --------------------------------------------------------------------- #
# no process group
# --------------------------------------------------------------------- #
def test_submesh_spec_parsing():
    assert M._submesh_shape(6, "model", "--rollout-mesh") == (1, 6)
    assert M._submesh_shape(2, "data", "--train-mesh") == (2, 1)
    assert M._submesh_shape("4", "model", "--rollout-mesh") == (1, 4)
    assert M._submesh_shape("2,3", "model", "--rollout-mesh") == (2, 3)
    assert M._submesh_shape((2, 2), "data", "--train-mesh") == (2, 2)
    for bad in ("0", "1,2,3", "0,1", -1):
        with pytest.raises(ValueError, match="--rollout-mesh"):
            M._submesh_shape(bad, "model", "--rollout-mesh")


def test_a_split_larger_than_the_world_raises():
    import torch.distributed as dist
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="disaggregated meshes need 1 "
                       "rollout \\+ 1 train = 2 ranks, have 1"):
        M.make_disaggregated_meshes(rollout=1, train=1)


def test_two_ranks_of_one_role_mesh_on_one_card_are_refused():
    """The card check (on ``cuda``, over every rank's ``(host, card)``):
    one card holds one rank of each role, never two of one."""
    roles = {"rollout": (0,), "train": (1,)}
    M.check_cards([("h", 0), ("h", 0)], roles)           # 1 | 1, one card
    M.check_cards([("h", 0), ("h", 1), ("h", 0), ("h", 1)],
                  {"rollout": (0, 1), "train": (2, 3)})
    M.check_cards([("a", 0), ("b", 0)], {"train": (0, 1)})  # two hosts
    with pytest.raises(ValueError, match="of the train mesh share card 1"):
        M.check_cards([("h", 0), ("h", 1), ("h", 1)],
                      {"rollout": (0,), "train": (1, 2)})


@pytest.mark.parametrize("flag, msg", [
    (["--rollout-mesh", "2"], "go together"),
    (["--train-mesh", "2"], "go together"),
    (["--rollout-mesh", "1", "--train-mesh", "1", "--mesh", "1,1"],
     "give the training mesh as --train-mesh"),
    (["--rollout-mesh", "1,2,3", "--train-mesh", "1"], "expects 'n' or"),
], ids=["rollout-alone", "train-alone", "with-mesh", "bad-spec"])
def test_train_cli_refuses_a_malformed_split(flag, msg, capsys):
    with pytest.raises(SystemExit) as e:
        tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", "--rlhf", *flag])
    assert e.value.code == 2
    assert msg in capsys.readouterr().err


def test_train_cli_refuses_a_split_larger_than_the_world():
    """One process is a world of one rank; the split needs two."""
    with pytest.raises(SystemExit, match="needs exactly 2 ranks"):
        tlaunch.main(["--device", "cpu", "--arch", "smollm-135m",
                      "--reduced", "--rlhf", "--rollout-mesh", "1",
                      "--train-mesh", "1"])
    import torch.distributed as dist
    assert not dist.is_initialized()


# --------------------------------------------------------------------- #
# the 4-rank world: 1 x 2 | 2 x 1
# --------------------------------------------------------------------- #
def test_meshes_are_disjoint(main_world):
    recs = _records(main_world, "meshes")
    for r, rec in recs.items():
        assert rec["role"] == ("rollout" if r in ROLLOUT else "train")
        assert rec["rollout"]["ranks"] == [0, 1]
        assert rec["train"]["ranks"] == [2, 3]
        assert rec["rollout"]["shape"] == {"data": 1, "model": 2}
        assert rec["train"]["shape"] == {"data": 2, "model": 1}
        mine, other = (("rollout", "train") if r in ROLLOUT
                       else ("train", "rollout"))
        assert rec[mine]["coord"] is not None
        assert rec[other]["coord"] is None
        assert "need 2 rollout + 4 train = 6 ranks, have 4" in \
            rec["oversubscribed"]


def test_cross_mesh_put_equals_the_reference_shards(main_world, reference):
    recs = _records(main_world, "put")
    for r in ROLLOUT:
        rec = recs[r]
        assert tuple(rec["coord"]) == (0, r) and rec["dtensor"]
        for a, b in leaf_pairs(rec["tree"], reference["put"][r]):
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)
    total = sum(recs[r]["local_bytes"] for r in ROLLOUT)
    for r in TRAIN:
        assert recs[r]["result"] is None and recs[r]["bytes"] == total
    assert total == reference["lockstep"]["async_stats"]["publisher"][
        "total_publish_bytes"] // 5         # one version


@pytest.mark.parametrize("mode", list(D.MODES))
def test_split_matches_the_reference(main_world, reference, mode):
    recs, want = _records(main_world, mode), reference[mode]
    got = recs[TRAIN[0]]
    for r in TRAIN[1:]:
        assert recs[r]["sha"] == got["sha"]
        assert [strip_wall(m) for m in recs[r]["log"]] == \
            [strip_wall(m) for m in got["log"]]
    assert len(got["sequences"]) == len(want["sequences"]) == 4
    for a, b in zip(got["sequences"], want["sequences"]):
        np.testing.assert_array_equal(a, b)
    lags = [m.get("policy_lag") for m in got["log"]]
    assert lags == [m.get("policy_lag") for m in want["log"]]
    assert lags == {"sync": [None] * 4, "lockstep": [0.0] * 4,
                    "stale": [0.0, 1.0] * 2,
                    "abort": [0.0, 1.0, 0.0, 0.0]}[mode]
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
        assert a[k] == w[k]
    for k in ("publishes", "total_publish_bytes"):
        assert a["publisher"][k] == w["publisher"][k], k
    assert a["queue"]["max_depth"] <= MODES_DEPTH[mode]
    assert recs[ROLLOUT[0]]["async_stats"]["produced"] == 4


MODES_DEPTH = {m: (kw or {}).get("queue_depth", 1)
               for m, kw in D.MODES.items()}


def test_lockstep_over_the_split_is_sync_bit_for_bit(main_world):
    s, a = _records(main_world, "sync"), _records(main_world, "lockstep")
    for r in TRAIN:
        assert len(s[r]["sequences"]) == len(a[r]["sequences"]) == 4
        for x, y in zip(s[r]["sequences"], a[r]["sequences"]):
            np.testing.assert_array_equal(x, y)
        assert [strip_wall(m) for m in s[r]["log"]] == \
            [strip_wall(m) for m in a[r]["log"]]
        assert s[r]["sha"] == a[r]["sha"]
        # the synchronous loop pushes the live actor every iteration
        assert all(m["publish_bytes"] > 0 and m["publish_s"] > 0
                   for m in s[r]["log"])


def test_launcher_runs_the_split_with_async_rlhf(main_world):
    recs = _records(main_world, "launcher")
    first = recs[TRAIN[0]]
    assert "disaggregated: rollout={'data': 1, 'model': 2} " \
           "train={'data': 2, 'model': 1}" in first["stdout"]
    assert re.search(r"^async: produced=2 max_depth=\d dropped=0 "
                     r"fallbacks=0 publishes=3$", first["stdout"],
                     flags=re.M), first["stdout"]
    assert first["async"]["produced"] == len(first["ppo_scores"]) == 2
    assert np.isfinite(first["ppo_scores"]).all()
    assert recs[TRAIN[1]]["sha"] == first["sha"]
    for r in (0, 1, 3):                  # only the first training rank
        assert recs[r]["stdout"] == ""
    for r in ROLLOUT:
        assert recs[r]["sha"] is None and recs[r]["async"]["produced"] == 2


def test_a_producer_failure_ends_every_rank(main_world):
    """The main world's last case: every rank exits non-zero, each with
    ``RuntimeError("rollout producer failed")`` (the first rollout rank's
    from the injected error)."""
    assert all(c not in (0, None) for c in main_world["codes"]), \
        (main_world["codes"], main_world["all_logs"])
    for log in main_world["logs"]:
        assert "RuntimeError: rollout producer failed" in log, log[-3000:]
    assert "ValueError: decode failed" in main_world["logs"][0]


def test_a_killed_run_resumes_on_the_uninterrupted_one(started, main_world):
    procs = started["worlds"]["die"]
    codes = _codes(procs)
    assert [codes[r] for r in TRAIN] == [D.DIE_EXIT_CODE] * 2, \
        (codes, _logs(procs))
    assert all(codes[r] not in (0, None) for r in ROLLOUT), codes
    d = started["dir"]
    resumed = _spawn(4, d / "resume", "--cases", "resume", "--ckpt",
                     d / "ck")
    assert _codes(resumed) == [0] * 4, _logs(resumed)
    want = _records(main_world, "lockstep")
    for r in TRAIN:
        rec = torch.load(d / "resume" / f"resume.{r}.pt", weights_only=False)
        assert rec["sha"] == want[r]["sha"]
        # iterations 0-1 came back from the checkpoint's log
        assert [strip_wall(m) for m in rec["log"]] == \
            [strip_wall(m) for m in want[r]["log"]]
        assert rec["steps"][-1] == RLHFPipeline.RM_STEP + 4


# --------------------------------------------------------------------- #
# the 2-rank world: 1 | 1, the card's layout
# --------------------------------------------------------------------- #
def _one_device_sync():
    cfg, models = D.ref_models()
    eng = RLHFEngine(cfg, cfg.replace(name="c"),
                     torch.Generator().manual_seed(0))
    for k, v in models.items():
        setattr(eng, f"{k}_params", v)
    pipe = RLHFPipeline(eng, D.blender(), StageConfig(**D.STAGES),
                        PPOConfig(**dict(D.PPO, temperature=1.0)))
    pipe.run_ppo()
    return pipe


@pytest.mark.parametrize("mode", ["sync", "lockstep"])
def test_one_to_one_split_is_the_one_device_run(started, mode):
    procs = started["worlds"]["one"]
    assert _codes(procs) == [0, 0], _logs(procs)
    pipe = _one_device_sync()
    rec = torch.load(started["dir"] / "one" / f"one_{mode}.1.pt",
                     weights_only=False)
    assert rec["role"] == "train"
    assert [strip_wall(m) for m in rec["log"]] == \
        [strip_wall(m) for m in pipe.log["stage3"]]
    tr = pipe.trainer
    assert rec["sha"] == {k: tree_sha256(getattr(tr, k))
                          for k in ("actor", "critic", "ema")}
    roll = torch.load(started["dir"] / "one" / f"one_{mode}.0.pt",
                      weights_only=False)
    assert roll["role"] == "rollout" and roll["async_stats"]["produced"] == 4
    if mode == "lockstep":
        assert all(m["policy_lag"] == 0.0 for m in rec["log"])
