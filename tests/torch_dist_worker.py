"""Rank functions of tests/test_torch_parallel.py and
tests/test_torch_viewer_ranks.py, run in processes of their own
(``torch.multiprocessing``, start method ``spawn``), one per rank of a
gloo process group on the CPU.

Imports neither JAX nor the test module: a rank imports torch and the port
alone.  The test writes each case (the port's field, octree, cameras,
batch and draws, built from the JAX package's) with ``torch.save``; each
rank writes what it computed to ``OUT/rank{k}.pt``.  :func:`run_ranks`
bounds every run: the group's timeout bounds each collective and the
rendezvous, and the join has its own deadline, after which the ranks are
killed and the run fails.
"""

from __future__ import annotations

import socket
import time
from pathlib import Path

import numpy as np
import torch

# seconds a collective or the rendezvous may wait for a rank
GROUP_TIMEOUT = 60.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _entry(rank, fn, world, port, args, group_timeout):
    torch.set_num_threads(1)
    from gfnerf_tpu_torch.parallel import comm

    world_comm = comm.initialize_multihost(
        f"tcp://127.0.0.1:{port}", world, rank, "gloo",
        timeout_s=GROUP_TIMEOUT)
    if group_timeout is not None:
        # the rendezvous waits GROUP_TIMEOUT (the ranks start unevenly);
        # every collective of the run, on a world group of its own and the
        # groups made from it, waits at most group_timeout
        import datetime

        import torch.distributed as dist

        timeout = datetime.timedelta(seconds=group_timeout)
        comm._WORLD = comm.Comm(range(world),
                                dist.new_group(list(range(world)),
                                               timeout=timeout),
                                "gloo", timeout, world_comm.n_hosts)
    try:
        fn(rank, world, *args)
    finally:
        comm.shutdown()


def run_ranks(fn, world: int, *args, timeout: float = 120.0,
              group_timeout=None) -> None:
    """``fn(rank, world, *args)`` in ``world`` spawned ranks of one gloo
    group; raises if a rank fails or the ranks outlast ``timeout``.
    ``group_timeout``: the seconds each collective of ``fn`` may wait
    (GROUP_TIMEOUT by default)."""
    import torch.multiprocessing as mp

    ctx = mp.start_processes(_entry, args=(fn, world, free_port(), args,
                                           group_timeout),
                             nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(5)
            raise TimeoutError(f"{world} ranks outlasted {timeout} s")


def load_results(out: Path, world: int) -> list:
    return [torch.load(Path(out) / f"rank{k}.pt", weights_only=False)
            for k in range(world)]


def _cameras(case):
    from gfnerf_tpu_torch.cameras.cameras import Cameras

    w, h = case["img_wh"]
    return Cameras.from_numpy(*case["cameras"], w, h, device="cpu")


def _stats(oct_dev) -> dict:
    return {k: getattr(oct_dev, k).clone() for k in
            ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")}


def dp_step(rank, world, case_path, out):
    """One data-parallel train step (``make_dp_train_step``) at the case's
    stage and active block on this rank's slice of the case's batch, with
    the whole batch's draws."""
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer,
                                                    field_param_groups)
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                init_train_state)
    from gfnerf_tpu_torch.parallel import comm, make_dp_train_step
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    case = torch.load(case_path, weights_only=False)
    field, oct_dev = case["field"], case["oct"]
    tx = build_optimizer(OptimizersConfig())
    state = init_train_state(field, tx)
    step = make_dp_train_step(GFNeRFModelConfig(**case["model"]),
                              SamplerConfig(**case["sampler"]), tx,
                              comm.world(), case.get("stage", 0))
    r = len(case["batch"]["image"]) // world
    sl = slice(rank * r, (rank + 1) * r)
    batch = {k: torch.as_tensor(v[sl]) for k, v in case["batch"].items()}
    for k in ("camera_indices", "rel_camera_indices"):
        batch[k] = batch[k].long()
    state, oct_dev, metrics, err = step(
        state, oct_dev, _cameras(case), batch, 1.0,
        noise=torch.as_tensor(case["noise"]),
        s3im_perms=torch.as_tensor(case["perms"]).long(),
        active_block=case.get("active_block", 0))
    groups = field_param_groups(field)
    torch.save({"params": {k: [p.detach().clone() for p in ps]
                           for k, ps in groups.items()},
                "grads": {k: [None if p.grad is None else p.grad.clone()
                              for p in ps] for k, ps in groups.items()},
                "metrics": {k: float(v) for k, v in metrics.items()},
                "oct": _stats(oct_dev), "err": err,
                "mu": state.opt_state.mu, "count": state.opt_state.count},
               Path(out) / f"rank{rank}.pt")


def block_steps(rank, world, case_path, out):
    """Concurrent focal steps (``make_parallel_block_step``) on a (data,
    block) grid: at each of the case's phases, block group g trains block
    g * B + phase on its share of its group's rays, from a fresh block
    Adam; the tables synced from each group's data rank 0 after each
    phase.  Saves the block stack after every phase, each group's loss
    and every rank's errors."""
    from gfnerf_tpu_torch.engine.optimizers import active_block_table
    from gfnerf_tpu_torch.models.gfnerf import GFNeRFModelConfig
    from gfnerf_tpu_torch.parallel import (block_optimizer, comm, make_grid,
                                           make_parallel_block_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    case = torch.load(case_path, weights_only=False)
    field, oct_dev = case["field"], case["oct"]
    world_comm = comm.world()
    n_data, n_block = case["grid"]
    grid = make_grid(n_data, n_block)
    groups = [world_comm.new_group(grid.data_ranks(g))
              for g in range(n_block)]
    d, g = grid.coords(rank)
    tx = block_optimizer()
    step = make_parallel_block_step(GFNeRFModelConfig(**case["model"]),
                                    SamplerConfig(**case["sampler"]), tx,
                                    groups[g])
    n_blocks = field.block_feats.shape[0]
    bps = n_blocks // n_block
    cams = _cameras(case)
    records = []
    for phase, draws in enumerate(case["phases"]):
        batch = draws["batch"]
        r_group = len(batch["image"]) // n_block
        r = r_group // n_data
        lo = g * r_group + d * r
        shard = {k: torch.as_tensor(v[lo:lo + r]) for k, v in batch.items()}
        for k in ("camera_indices", "rel_camera_indices"):
            shard[k] = shard[k].long()
        block = g * bps + phase % bps
        opt = tx.init({"block": [active_block_table(field, block)]})
        kw = {}
        if draws.get("noise") is not None:
            kw = dict(noise=torch.as_tensor(draws["noise"]),
                      s3im_perms=torch.as_tensor(draws["perms"]).long())
        else:
            kw = dict(generator=torch.Generator().manual_seed(phase))
        before = field.block_feats.detach().clone()
        opt, loss, err = step(field, opt, oct_dev, cams, shard, 1.0, block,
                              **kw)
        local = field.block_feats.detach().clone()
        # each group's table from its data rank 0, to every rank
        with torch.no_grad():
            for gi in range(n_block):
                b = gi * bps + phase % bps
                t = field.block_feats[b].detach().clone()
                world_comm.broadcast(t, src=grid.data_ranks(gi)[0])
                field.block_feats[b].copy_(t)
        records.append({"before": before, "local": local,
                        "synced": field.block_feats.detach().clone(),
                        "loss": float(loss), "err": err,
                        "noise": kw.get("noise"),
                        "count": opt.count})
    torch.save({"records": records, "coords": (d, g),
                "global_feat": field.global_feat.detach().clone()},
               Path(out) / f"rank{rank}.pt")


def trainer_run(rank, world, scene, out, overrides):
    """``gf-nerf-tiny`` through the Trainer (``train.build_trainer``'s
    path) over the group, with ``overrides``; records every step's
    metrics, the counts of steps in K-step windows and single steps, the
    block stack after every step and at the end, the digests
    of the parameters, the octree statistics and the error maps after
    every step, and the block tables' digests after every sync (with the
    last step trained)."""
    from gfnerf_tpu_torch.train import build_trainer

    argv = ["gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
            "--output-dir", str(Path(out) / "runs"),
            "--experiment-name", "parallel", *overrides]
    trainer = build_trainer(argv)
    p = trainer.pipeline
    rec = {"metrics": {}, "digests": {}, "blocks": {}}
    get_loss = p.get_train_loss_dict

    def get_loss_w(step):
        m = get_loss(step)
        rec["metrics"][step] = m
        return m

    after = p.after_train_iteration

    def after_w(step):
        after(step)
        rec["digests"][step] = digest(p)
        rec["blocks"][step] = p.field.block_feats.detach().clone()

    sync = p.sync_block_tables
    rec["syncs"] = []

    def sync_w():
        sync()
        rec["syncs"].append((max(rec["metrics"], default=-1),
                             digest(p)["blocks"]))

    p.get_train_loss_dict, p.after_train_iteration = get_loss_w, after_w
    p.sync_block_tables = sync_w
    rec["boundaries"] = count_boundary_collectives(trainer)
    rec["start_blocks"] = p.field.block_feats.detach().clone()
    trainer.train()
    rec["end"] = {k: v.detach().clone()
                  for k, v in p.field.state_dict().items()}
    rec["base_dir"] = str(trainer.base_dir)
    rec["n_block_axis"] = p.n_block_axis
    # the steps trained in K-step windows and as single steps
    rec["windows"] = (p._k_steps_scanned, p._k_steps_fallback)
    torch.save(rec, Path(out) / f"rank{rank}.pt")


def count_collectives() -> dict:
    """Counts every collective this process runs through ``Comm`` (the
    outermost call: a gather under gloo is one, not its all-reduce):
    ``{"n": calls so far}``."""
    from gfnerf_tpu_torch.parallel.comm import Comm

    counter = {"n": 0, "depth": 0}
    if getattr(Comm, "_counted", None) is not None:
        return Comm._counted
    for name in ("all_reduce", "all_gather", "broadcast",
                 "broadcast_object"):
        def counted(self, *a, _fn=getattr(Comm, name), **k):
            counter["depth"] += 1
            try:
                if counter["depth"] == 1 and self.size > 1:
                    counter["n"] += 1
                return _fn(self, *a, **k)
            finally:
                counter["depth"] -= 1
        setattr(Comm, name, counted)
    Comm._counted = counter
    return counter


def count_boundary_collectives(trainer) -> list:
    """Wraps the Trainer's step boundary (``_stop_requested``): the list
    it returns gets, for each boundary, the collectives run in it, the
    control broadcasts among them and the table syncs it called."""
    counter = count_collectives()
    out = []
    p = trainer.pipeline
    boundary = trainer._stop_requested
    agree = trainer.control.agree

    def agree_w(comm):
        out[-1]["agrees"] += 1
        return agree(comm)

    def boundary_w():
        n0 = counter["n"]
        syncs = p.sync_block_tables
        box = {"collectives": 0, "agrees": 0, "syncs": 0}
        out.append(box)

        def sync_w():
            box["syncs"] += 1
            return syncs()

        p.sync_block_tables = sync_w
        try:
            return boundary()
        finally:
            p.sync_block_tables = syncs
            box["collectives"] = counter["n"] - n0

    trainer._stop_requested = boundary_w
    trainer.control.agree = agree_w
    return out


def viewer_run(rank, world, scene, out, overrides):
    """``gf-nerf-tiny`` through the Trainer with ``--vis viewer
    viewer_port=0`` over the group: rank 0 writes its viewer's port and
    its grid coordinates to OUT/viewer.json; every rank records each step
    (its wall-clock start and end, its metrics), each sync of the block
    tables (the step in flight or last taken, the tables' digests; rank 0
    also the tables at the sync inside a step, a phase's first), each
    step boundary's collectives, and its final state."""
    import json
    import os
    import time as clock

    from gfnerf_tpu_torch.train import build_trainer

    argv = ["gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
            "--output-dir", str(Path(out) / "runs"),
            "--experiment-name", "viewer", "--vis", "viewer",
            "viewer_port=0", *overrides]
    trainer = build_trainer(argv)
    p = trainer.pipeline
    rec = {"steps": {}, "syncs": [], "phase_start_blocks": []}
    state = {"in_step": None, "last": -1}
    get_loss = p.get_train_loss_dict

    def get_loss_w(step):
        t0 = clock.time()
        state["in_step"] = step
        m = get_loss(step)
        state["in_step"], state["last"] = None, step
        rec["steps"][step] = {"t0": t0, "t1": clock.time(), "metrics": m}
        return m

    sync = p.sync_block_tables

    def sync_w():
        sync()
        inside = state["in_step"] is not None
        rec["syncs"].append((state["in_step"] if inside else state["last"],
                             inside, digest(p)["blocks"]))
        if rank == 0 and inside:
            rec["phase_start_blocks"].append(
                (state["in_step"], p.field.block_feats.detach().clone()))

    p.get_train_loss_dict, p.sync_block_tables = get_loss_w, sync_w
    rec["boundaries"] = count_boundary_collectives(trainer)
    if rank == 0:
        info = Path(out) / "viewer.json"
        info.with_suffix(".tmp").write_text(json.dumps({
            "port": trainer.viewer.port, "coords": p.grid.coords(0),
            "n_block_axis": p.n_block_axis,
            "n_blocks": p.config.model.n_blocks}))
        os.replace(info.with_suffix(".tmp"), info)
    else:
        rec["viewer"] = trainer.viewer
    trainer.train()
    rec["end"] = {k: v.detach().clone()
                  for k, v in p.field.state_dict().items()}
    rec["base_dir"] = str(trainer.base_dir)
    torch.save(rec, Path(out) / f"rank{rank}.pt")


def digest(p) -> dict:
    """Hashes of a pipeline's state: "shared", its parameters but the
    block tables, its octree (nodes, block indices, statistics) and every
    error map its caches hold (equal on every rank after every step);
    "frozen", the parameters but the block tables alone; "blocks", one per
    block table (equal on a block group's data ranks after every step,
    and on every rank after ``sync_block_tables``)."""
    import hashlib

    def sha(arrays) -> str:
        h = hashlib.sha256()
        for a in arrays:
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()

    state = p.field.state_dict()
    blocks = state.pop("block_feats").cpu().numpy()
    arrays = [v.detach().cpu().numpy() for _, v in sorted(state.items())]
    frozen = sha(arrays)
    arrays += [getattr(p.sampler.oct_dev, k).cpu().numpy() for k in
               ("centers", "side_lens", "childs", "trans_idx", "block_idx",
                "weight_stats", "alpha_stats", "visit_cnt")]
    dm = p.datamanager
    caches = [dm.init_cache, dm.split_cache] + [
        v[2] for _, v in sorted(getattr(dm, "_parallel_splits", {}).items())]
    arrays += [c.error_maps for c in caches
               if c is not None and c.error_maps is not None]
    return {"shared": sha(arrays), "frozen": frozen,
            "blocks": [sha([b]) for b in blocks]}
