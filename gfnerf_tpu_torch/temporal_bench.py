"""Time the temporal-grid kernels T1 and T2 at the NeRFPlayer pair's step
shapes, by part, over groupings of levels and, with ``--parent DIR``, in
turns against the kernels of another checkout of this repository.

    python -m gfnerf_tpu_torch.temporal_bench [--steps N] [--parent DIR]
        [--methods nerfplayer-nerfacto,nerfplayer-ngp] [--out FILE]

Each method trains ``--steps`` steps through the ``Trainer`` at its
registered width on a D-NeRF scene written to a temporary directory (24 +
4 RGBA PNGs at 200x200, as ``chip_smoke.py`` writes it), then records the
arguments of every encode of one step (nerfplayer-nerfacto: proposal 0,
proposal 1, the field; nerfplayer-ngp: the step and its occupancy pass).
At each shape, with CUDA events (``time_ms``: the median of 7 samples of
10 calls):

- T1 and T2 against their plain versions bit for bit (T2 also called
  again and on the points permuted), and each grouping of levels (1, 2,
  4, 8, 16 a launch); T2's records per level against the host's
  reckoning, beside the corners; T2's device time by kernel (a profiled
  call);
- by part, on three forms of the same points: as the step gives them;
  every 32nd point and time repeated 32 times ("runs of 32": each warp
  one cell and one time); the points in a random order ("shuffled": no
  run longer than one lane); T2's call on no points (a zero-fill of the
  gradient) beside ``torch.zeros`` of it; the library's sums of the plain
  terms into a zeroed flat table: ``index_add_`` (float atomics) and
  ``index_put_(..., accumulate=True)`` under
  ``torch.use_deterministic_algorithms(True)`` (a sort and a segmented
  sum: the same bits every call);
- with ``--parent DIR``: DIR's ``gfnerf_tpu_torch/csrc/temporal_grid_{fwd,
  bwd}.cu`` built into a library of their own under ``_build/parent`` and
  called through their C interface (the float-atomic T2: each group's
  rows zeroed, then float reductions), in turns parent, change, change,
  parent, on the same inputs and by part; the parent's T2 distance from
  the plain version; and the method's train steps through its pipeline,
  T2 this tree's or the parent's, in turns, with the peak memory
  allocated and reserved of each turn.

Prints one line a measurement and the card's name and power limit, and
writes every number to ``--out`` (JSON).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gfnerf_tpu_torch.ops import build
from gfnerf_tpu_torch.ops.temporal_grid import _launch_args

GROUPS = (1, 2, 4, 8, 16)
# train steps a turn when the steps are timed in turns with the parent
STEPS_A_TURN = 20


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int = 7, reps: int = 10) -> float:
    """Median CUDA-event time of fn() in ms after a warm-up: n samples of
    reps calls between two events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def in_turns(forms: dict, order) -> dict:
    """Each form's times in the given order of turns (forms alternating)."""
    turns = {name: [] for name in forms}
    for name in order:
        turns[name].append(time_ms(forms[name]))
    return turns


class ParentKernels:
    """T1 and T2 of another checkout, built from its sources and called
    through the C interface they had before T2's fixed point: T1 (table,
    xyz, times, offsets, resolutions, hashed, out, launches, n_points,
    n_levels, level_dim, width, n_rows, time_scale, levels_per_launch,
    stream) and T2 (g, xyz, times, offsets, resolutions, hashed, grad,
    red_ops, launches, n_points, n_grad_rows, n_levels, level_dim, width,
    n_rows, time_scale, levels_per_launch, stream), each at the levels a
    launch it took then (T1 8, T2 2)."""

    FWD_LEVELS, BWD_LEVELS = 8, 2

    def __init__(self, root: Path):
        csrc = root / "gfnerf_tpu_torch" / "csrc"
        out = build.BUILD_DIR / "parent"
        out.mkdir(parents=True, exist_ok=True)
        lib = out / "libparent_temporal.so"
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(lib),
               str(csrc / "temporal_grid_fwd.cu"),
               str(csrc / "temporal_grid_bwd.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {csrc}:\n{proc.stdout}"
                               f"{proc.stderr}")
        self.lib = ctypes.CDLL(str(lib))
        p, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        tail = [i32] * 4 + [ctypes.c_float, i32, p]
        for name, head in (("gfnerf_temporal_grid_fwd", [p] * 8 + [i64]),
                           ("gfnerf_temporal_grid_bwd",
                            [p] * 9 + [i64, i64])):
            fn = getattr(self.lib, name)
            fn.argtypes = head + tail
            fn.restype = ctypes.c_int

    def _tail(self, tables, per):
        return (tables.resolutions.shape[0], tables.level_dim, tables.width,
                tables.n_rows, tables.time_scale, per,
                torch.cuda.current_stream().cuda_stream)

    def fwd(self, table, tables, xyz, times):
        out = torch.empty((xyz.shape[0], tables.resolutions.shape[0]
                           * tables.level_dim), device=xyz.device)
        launches = ctypes.c_int(0)
        build.check(self.lib.gfnerf_temporal_grid_fwd(
            table.data_ptr(), *_launch_args(tables, xyz, times),
            out.data_ptr(), ctypes.addressof(launches), xyz.shape[0],
            *self._tail(tables, self.FWD_LEVELS)), "parent T1")
        return out

    def bwd(self, g, tables, xyz, times, n_rows, **_):
        grad = torch.empty((n_rows, tables.width), device=xyz.device)
        launches = ctypes.c_int(0)
        build.check(self.lib.gfnerf_temporal_grid_bwd(
            g.contiguous().data_ptr(), *_launch_args(tables, xyz, times),
            grad.data_ptr(), None, ctypes.addressof(launches), xyz.shape[0],
            n_rows, *self._tail(tables, self.BWD_LEVELS)), "parent T2")
        return grad


def by_kernel(fn, calls: int = 5) -> dict:
    """{kernel or "memset": [launches, device ms] a call} of fn() from a
    torch.profiler trace of ``calls`` calls (the empty dict if the trace
    holds no device time)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        hit = re.search(r"(\w+_kernel(<[^>]*>)?)", e.key)
        key = "memset" if "memset" in e.key.lower() else (
            hit.group(1) if hit else e.key[:60])
        n, us = out.get(key, (0, 0.0))
        out[key] = (n + e.count, us + e.self_device_time_total)
    return {k: [n / calls, us / 1e3 / calls] for k, (n, us) in out.items()}


def step_encodes(method: str, scene: Path, out_dir: Path, steps: int,
                 parent=None):
    """Train ``method`` ``steps`` steps at its registered width and return
    ([(name, table, statics, xyz, times)] for every encode of one step,
    the steps' report).  With ``parent``, the report holds the pipeline's
    train steps timed in turns with T2 this tree's and the parent's."""
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.pixel_samplers import (PixelSampler,
                                                      collate_batch)
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.models import nerfplayer as npl

    cfg = get_method(method)
    for key, value in {"steps_per_log": "100",
                       "steps_per_eval_batch": "100000",
                       "max_num_iterations": str(steps),
                       "steps_per_eval_image": str(steps + 1),
                       "steps_per_save": str(steps + 1),
                       "output_dir": str(out_dir)}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    trainer = Trainer(cfg, build_dataparser("dnerf", scene))
    trainer.setup()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    log(f"[{method}] {steps} steps in {time.perf_counter() - t0:.1f}s")
    p = trainer.pipeline
    report = {} if parent is None else time_steps(method, p, steps, parent)
    mc = p.model_cfg
    rays = p.config.train_num_rays_per_batch
    batch = p._device_batch(collate_batch(
        p.cache, PixelSampler(rays, seed=700).sample_indices(p.cache)))
    gen = torch.Generator(device=p.device).manual_seed(700)
    draws = [torch.rand((rays, n + 1), generator=gen, device=p.device)
             for n in p.spec.draw_counts(mc)]
    draws += p.spec.extra_draws(p.model, rays, gen, p.device)
    ngp = method == "nerfplayer-ngp"
    calls, encode = [], npl.temporal_grid_encode

    def rec(table, st, xyz, times, *a, **kw):
        calls.append((table.detach(), st, xyz.detach().clone(),
                      times.detach().clone()))
        return encode(table, st, xyz, times, *a, **kw)

    npl.temporal_grid_encode = rec
    try:
        with torch.no_grad():
            p.loss(batch, draws)
            if ngp:
                npl.update_ngp_occupancy(
                    p.model, *npl.occupancy_draws(mc, gen, p.device))
    finally:
        npl.temporal_grid_encode = encode
    names = (["step", "occupancy pass"] if ngp else
             [f"proposal {i}" for i in range(len(calls) - 1)] + ["field"])
    del trainer, p, batch, draws
    torch.cuda.empty_cache()
    return [(f"{method} {n}", *c) for n, c in zip(names, calls)], report


def time_steps(method: str, p, done: int, parent) -> dict:
    """The pipeline's train steps (``get_train_loss_dict``, each ending in
    a synchronize), STEPS_A_TURN a turn, with T2 this tree's ("change") or
    the parent's patched into the encode's backward ("parent"), in turns
    parent, change, change, parent: each turn's mean s/step and its peak
    memory allocated and reserved (the cache emptied and the peaks reset
    before each turn)."""
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    ours = ops.temporal_grid_bwd
    p.reserve_steps(done + 4 * STEPS_A_TURN + 1)
    step = done
    turns = {"parent": [], "change": []}
    for form in ("parent", "change", "change", "parent"):
        ops.temporal_grid_bwd = parent.bwd if form == "parent" else ours
        try:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            for _ in range(STEPS_A_TURN):
                p.get_train_loss_dict(step)
                step += 1
            torch.cuda.synchronize()
            turns[form].append({
                "s_per_step": (time.perf_counter() - t0) / STEPS_A_TURN,
                "peak_allocated_bytes": torch.cuda.max_memory_allocated(),
                "peak_reserved_bytes": torch.cuda.max_memory_reserved()})
        finally:
            ops.temporal_grid_bwd = ours
    log(f"[{method}] train steps in turns with the parent's T2 "
        f"({STEPS_A_TURN} a turn): {json.dumps(turns)}")
    return {"steps_in_turns": turns}


def forms(xyz, times, seed=5):
    """The by-part forms of the step's points: as given; "runs of 32"
    (every 32nd point and its time repeated 32 times in a row: each warp
    one cell and one time, the warps spread as the step's points are);
    and "shuffled" (a random order: no runs)."""
    p = xyz.shape[0]
    perm = torch.randperm(p, device=xyz.device,
                          generator=torch.Generator(xyz.device).manual_seed(
                              seed))
    return {"step": (xyz, times),
            "runs of 32": (xyz[::32].repeat_interleave(32, 0)[:p]
                           .contiguous(),
                           times[::32].repeat_interleave(32)[:p]
                           .contiguous()),
            "shuffled": (xyz[perm].contiguous(), times[perm].contiguous())}


def bench_shape(name, table, st, xyz, times, parent, backward) -> dict:
    from gfnerf_tpu_torch.fields import temporal_grid as tg
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    tables = st.tables(xyz.device)
    rows = table.shape[0]
    p, n_levels, c = xyz.shape[0], st.n_levels, st.level_dim
    rep = {"points": p, "levels": n_levels, "C": c, "T": st.temporal_dim,
           "rows": rows}
    want = tg.temporal_grid_encode_raw(table, st, xyz, times)
    for grp in GROUPS:
        if not torch.equal(ops.temporal_grid_fwd(
                table, tables, xyz, times, levels_per_launch=grp), want):
            raise AssertionError(f"{name}: T1 at {grp} levels a launch "
                                 f"differs from the plain encode")
    if parent is not None and not torch.equal(
            parent.fwd(table, tables, xyz, times), want):
        raise AssertionError(f"{name}: the parent's T1 differs")
    del want
    rep["t1_groups_ms"] = {grp: time_ms(lambda g=grp: ops.temporal_grid_fwd(
        table, tables, xyz, times, levels_per_launch=g)) for grp in GROUPS}
    for form, (x, t) in forms(xyz, times).items():
        fns = {} if parent is None else {
            "parent": lambda: parent.fwd(table, tables, x, t)}
        fns["change"] = lambda: ops.temporal_grid_fwd(table, tables, x, t)
        rep[f"t1 {form}"] = in_turns(fns, [*fns, *reversed(fns)])
    t1 = {k: v for k, v in rep.items() if k.startswith("t1")}
    log(f"[{name}] T1 {json.dumps(t1)}")
    if not backward:
        return rep

    g = torch.randn((p, n_levels * c), device=xyz.device,
                    generator=torch.Generator(xyz.device).manual_seed(9))
    gp = tg.temporal_backward_reference(g, st, xyz, times, rows)
    perm = torch.randperm(p, device=xyz.device,
                          generator=torch.Generator(xyz.device).manual_seed(
                              0))
    moved = [x[perm].contiguous() for x in (g, xyz, times)]
    reckoned = tg.temporal_bwd_records(g, st, xyz, times)
    for grp in GROUPS:
        red = torch.zeros(n_levels, dtype=torch.int64, device=xyz.device)
        for got in (ops.temporal_grid_bwd(g, tables, xyz, times, rows,
                                          level_records=red,
                                          levels_per_launch=grp),
                    ops.temporal_grid_bwd(g, tables, xyz, times, rows,
                                          levels_per_launch=grp),
                    ops.temporal_grid_bwd(moved[0], tables, *moved[1:],
                                          rows, levels_per_launch=grp)):
            if not torch.equal(got, gp):
                raise AssertionError(f"{name}: T2 at {grp} levels a launch "
                                     f"differs from the plain version")
        if not torch.equal(red, reckoned):
            raise AssertionError(f"{name}: T2's records {red.tolist()}, "
                                 f"reckoned {reckoned.tolist()}")
    rep["t2_equal_bit_for_bit"] = True
    rep["t2_records_per_level"] = reckoned.tolist()
    rep["t2_corners_per_level"] = p * 8
    if parent is not None:
        rep["t2_parent_max_abs_err"] = float(
            (parent.bwd(g, tables, xyz, times, rows) - gp).abs().max())
    del gp, moved
    terms = list(tg.temporal_scatter_terms(g, st, xyz, times))
    idx = torch.cat([i.reshape(-1) for i, _, _ in terms])
    vals = torch.cat([v.reshape(-1) for _, v, _ in terms])
    del terms
    rep["t2_index_add_ms"] = time_ms(lambda: torch.zeros(
        rows * st.width, device=xyz.device).index_add_(0, idx, vals))
    torch.use_deterministic_algorithms(True)
    try:
        rep["t2_deterministic_index_put_ms"] = time_ms(
            lambda: torch.zeros(rows * st.width,
                                device=xyz.device).index_put_(
                (idx,), vals, accumulate=True), n=5, reps=2)
    finally:
        torch.use_deterministic_algorithms(False)
    del idx, vals
    empty = torch.empty((0, 3), device=xyz.device)
    rep["t2_zero_fill_ms"] = {
        "torch.zeros": time_ms(lambda: torch.zeros(
            (rows, st.width), device=xyz.device)),
        "the kernel on no points": time_ms(lambda: ops.temporal_grid_bwd(
            g[:0], tables, empty, times[:0], rows))}
    rep["t2_groups_ms"] = {grp: time_ms(lambda gr=grp: ops.temporal_grid_bwd(
        g, tables, xyz, times, rows, levels_per_launch=gr))
        for grp in GROUPS}
    rep["t2_by_kernel"] = by_kernel(lambda: ops.temporal_grid_bwd(
        g, tables, xyz, times, rows))
    for form, (x, t) in forms(xyz, times).items():
        fns = {} if parent is None else {
            "parent": lambda: parent.bwd(g, tables, x, t, rows)}
        fns["change"] = lambda: ops.temporal_grid_bwd(g, tables, x, t, rows)
        rep[f"t2 {form}"] = in_turns(fns, [*fns, *reversed(fns)])
    t2 = {k: v for k, v in rep.items() if k.startswith("t2")}
    log(f"[{name}] T2 {json.dumps(t2)}")
    torch.cuda.empty_cache()
    return rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=400)
    ap.add_argument("--parent", type=Path, default=None)
    ap.add_argument("--methods",
                    default="nerfplayer-nerfacto,nerfplayer-ngp")
    ap.add_argument("--out", type=Path,
                    default=Path("chiprun_out/temporal_bench.json"))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("temporal_bench: needs a CUDA card", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    log(f"[device] {torch.cuda.get_device_name(0)}; {card}")
    res = build.build_library(verbose=True)
    ours = False   # ptxas's lines of the temporal kernels
    for line in res["log"].splitlines():
        if "Compiling entry function" in line:
            ours = "temporal" in line
        if ours:
            log(f"[build] {line.strip()}")
    parent = ParentKernels(args.parent) if args.parent else None
    from gfnerf_tpu_torch.utils.synthetic import make_dnerf_fixture

    report = {"card": card, "steps": args.steps, "shapes": {}}
    with tempfile.TemporaryDirectory(prefix="temporal_bench_") as tmp:
        scene = make_dnerf_fixture(Path(tmp) / "scene", 24, 4,
                                   img_wh=(200, 200), focal=180.0)
        for method in args.methods.split(","):
            encodes, report[method] = step_encodes(
                method, scene, Path(tmp) / method, args.steps, parent)
            for name, table, st, xyz, times in encodes:
                report["shapes"][name] = bench_shape(
                    name, table, st, xyz, times, parent,
                    backward="occupancy" not in name)
                del table
                torch.cuda.empty_cache()
            del encodes
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
