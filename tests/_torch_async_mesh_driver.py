"""Rank driver for ``tests/test_torch_async_mesh.py``: asynchronous stage 3
on a shared ``data x model`` mesh of gloo ranks over the CPU::

    PYTHONPATH=src:tests python -m torch.distributed.run --standalone \\
        --nproc-per-node 2 tests/_torch_async_mesh_driver.py --out DIR \\
        --mesh 2,1 --cases groups,sync,lockstep,stale,abort

(or each rank started alone with ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR`` and ``MASTER_PORT`` set, as the test does, so that a
failing rank ends on its own).  Every rank joins one gloo world, makes the
``dp x tp`` mesh and runs the cases in order, each writing
``DIR/CASE.RANK.pt`` when it is done:

- ``groups``: the name of each dim's group of the mesh, of two twins of it
  (:func:`repro_torch.launch.mesh.twin_mesh`) and of the default group;
- ``sync``, ``lockstep``, ``lockstep_ap`` (lockstep with
  ``async_publish``), ``stale``, ``abort``: stage 3 alone from the
  split's test weights (``tests/_torch_disagg_driver.py``: a 2-layer dense
  actor and critic at d 64, greedy fp32 PPO, 4 iterations) on
  ``RLHFEngine(mesh=)``, synchronous or under ``AsyncConfig``: the
  sequences each scored batch held, the per-iteration metrics,
  ``async_stats``, the final actor, critic and EMA params (full, numpy)
  and their SHA-256.  ``sync`` and ``lockstep`` save a checkpoint every
  iteration (under ``DIR/ck_CASE``); ``lockstep_ap`` and ``stale`` record
  every collective each thread issued (:func:`recording`);
- ``skew``: ``stale`` with a ``rollout_hook`` that sleeps 0.3 s on rank 1
  only;
- ``launcher``: ``launch.train --rlhf --mesh DP,TP --async-rlhf --max-lag
  1`` in this world, its output and summary;
- ``fail``: a producer failure injected on rank 1 before batch 2, not
  caught: every rank must end with ``RuntimeError("rollout producer
  failed")``.

It is launched by the test; it is not a pytest module.
"""
from __future__ import annotations

import argparse
import contextlib
import functools
import inspect
import io
import os
import threading
import time

import torch
import torch.distributed as dist

import _torch_disagg_driver as D
from repro_torch.core import (AsyncConfig, PPOConfig, RLHFEngine,
                              RLHFPipeline, StageConfig)
from repro_torch.core import ppo as tppo
from repro_torch.launch import train as tlaunch
from repro_torch.launch.mesh import init_distributed, make_mesh, twin_mesh
from repro_torch.sharding import runtime
from repro_torch.training.checkpoint import CheckpointManager

MODES = dict(D.MODES, lockstep_ap=dict(D.MODES["lockstep"],
                                       async_publish=True),
             skew=D.STALE)
RECORDED = ("lockstep_ap", "stale")
SAVED = ("sync", "lockstep")
COLLECTIVES = ("all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_object", "reduce_scatter_tensor", "broadcast",
               "broadcast_object_list", "all_to_all_single", "barrier",
               "reduce", "gather", "scatter", "send", "recv", "isend",
               "irecv")


@contextlib.contextmanager
def recording():
    """Every collective issued while open, as a set of ``(thread name,
    group name)``: ``torch.distributed``'s collectives (by their ``group``
    argument, the default group without one), and ``DTensor.redistribute``
    and ``full_tensor`` (by every group of the tensor's mesh)."""
    from torch.distributed.tensor import DTensor
    seen, lock = set(), threading.Lock()

    def note(names):
        me = threading.current_thread().name
        with lock:
            seen.update((me, n) for n in names)

    def wrap(fn):
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def call(*a, **kw):
            group = sig.bind_partial(*a, **kw).arguments.get("group")
            note([(group or dist.group.WORLD).group_name])
            return fn(*a, **kw)
        return call

    def wrap_dtensor(fn):
        @functools.wraps(fn)
        def call(self, *a, **kw):
            note(runtime.group_names(self.device_mesh).values())
            return fn(self, *a, **kw)
        return call

    kept = {n: getattr(dist, n) for n in COLLECTIVES}
    kept_dt = {n: getattr(DTensor, n) for n in ("redistribute",
                                                "full_tensor")}
    for n, fn in kept.items():
        setattr(dist, n, wrap(fn))
    for n, fn in kept_dt.items():
        setattr(DTensor, n, wrap_dtensor(fn))
    try:
        yield seen
    finally:
        for n, fn in kept.items():
            setattr(dist, n, fn)
        for n, fn in kept_dt.items():
            setattr(DTensor, n, fn)


def stage3(mesh, async_kw, *, ckpt=None, rollout_hook=None) -> dict:
    """Stage 3 from the split's test weights on ``RLHFEngine(mesh=)``; its
    record."""
    cfg, models = D.ref_models()
    eng = RLHFEngine(cfg, cfg.replace(name="c"),
                     torch.Generator().manual_seed(0), mesh=mesh)
    for k, v in models.items():
        setattr(eng, f"{k}_params", v)
    pipe = RLHFPipeline(eng, D.blender(), StageConfig(**D.STAGES),
                        PPOConfig(**D.PPO), checkpointer=ckpt,
                        async_cfg=None if async_kw is None
                        else AsyncConfig(**async_kw))
    pipe.rollout_hook = rollout_hook
    seen, score = [], tppo.PPOTrainer.score_rollout

    def scoring(self, rollout, **kw):
        seen.append(torch.as_tensor(rollout.sequences).numpy().copy())
        return score(self, rollout, **kw)

    tppo.PPOTrainer.score_rollout = scoring
    try:
        pipe.run_ppo()
    finally:
        tppo.PPOTrainer.score_rollout = score
    tr = pipe.trainer
    return {"sequences": seen, "log": pipe.log["stage3"],
            "async_stats": pipe.async_stats,
            "actor": D._np_tree(tr.actor.params),
            "critic": D._np_tree(tr.critic.params),
            "ema": D._np_tree(tr.ema_params()),
            "sha": {k: D._sha(getattr(tr, k))
                    for k in ("actor", "critic", "ema")}}


def case_groups(mesh) -> dict:
    twins = [twin_mesh(mesh) for _ in range(2)]
    return {"mesh": runtime.group_names(mesh),
            "twins": [runtime.group_names(t) for t in twins],
            "world": dist.group.WORLD.group_name,
            "coords": [mesh.get_coordinate()]
            + [t.get_coordinate() for t in twins]}


def case_mode(case: str, mesh, out: str) -> dict:
    rank = dist.get_rank()
    ckpt = hook = None
    if case in SAVED:
        ckpt = CheckpointManager(os.path.join(out, f"ck_{case}"), keep=1)
    if case == "skew":
        hook = (lambda i: time.sleep(0.3)) if rank == 1 else None
    with (recording() if case in RECORDED
          else contextlib.nullcontext(set())) as seen:
        rec = stage3(mesh, MODES[case], ckpt=ckpt, rollout_hook=hook)
    rec["calls"] = sorted(seen)
    rec["mesh_groups"] = runtime.group_names(mesh)
    rec["world"] = dist.group.WORLD.group_name
    if ckpt is not None:
        rec["ckpt"] = ckpt._step_dir(ckpt.latest_step())
    return rec


def case_launcher(spec: str) -> dict:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        summ = tlaunch.main([
            "--device", "cpu", "--arch", "smollm-135m", "--reduced",
            "--rlhf", "--steps", "2", "--batch", "4", "--seq", "16",
            "--max-new", "4", "--mesh", spec, "--async-rlhf", "--max-lag",
            "1"])
    return {"stdout": buf.getvalue(), "async": summ["async"],
            "ppo_scores": summ["ppo_scores"], "sha": summ["state_sha256"]}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", required=True)
    ap.add_argument("--mesh", required=True)
    ap.add_argument("--cases", required=True)
    args = ap.parse_args()
    init_distributed("cpu", timeout_s=60.0)
    rank = dist.get_rank()
    dp, tp = (int(x) for x in args.mesh.split(","))
    mesh = make_mesh(dp, tp)
    for case in args.cases.split(","):
        if case == "groups":
            rec = case_groups(mesh)
        elif case in MODES:
            rec = case_mode(case, mesh, args.out)
        elif case == "launcher":
            rec = case_launcher(args.mesh)
        elif case == "fail":
            def fail(i):
                if i == 2:
                    raise ValueError("decode failed")
            stage3(mesh, D.STALE, rollout_hook=fail if rank == 1 else None)
            rec = {}
        else:
            raise ValueError(f"unknown case {case!r}")
        torch.save(rec, os.path.join(args.out, f"{case}.{rank}.pt"))
    dist.destroy_process_group()


if __name__ == "__main__":
    main()
