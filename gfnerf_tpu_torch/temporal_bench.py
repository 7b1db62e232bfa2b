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

- T1 and T2 against their plain versions (T1 bit for bit, T2 to 1e-5 of
  the largest entry), and each grouping of levels (1, 2, 4, 8, 16 a
  launch); T2's reductions per level against its terms;
- by part, on three forms of the same points: as the step gives them;
  every 32nd point and time repeated 32 times ("runs of 32": each warp
  reads or reduces one cell's sectors once, so what is left is the
  addressing, the instructions and a 32nd of the memory traffic); the
  points in a random order ("shuffled": no run longer than one lane); and
  T2's zero-fill alone (the kernel on no points, which only zeroes the
  gradient) beside ``torch.zeros`` of it; ``index_add_`` of the plain
  terms into a zeroed flat table (the zero-fill included);
- with ``--parent DIR``: DIR's ``gfnerf_tpu_torch/csrc/temporal_grid_{fwd,
  bwd}.cu`` built into a library of their own under ``_build/parent`` and
  called through their C interface as it stood before the redesign (the
  window table as an argument, the gradient zeroed by ``torch.zeros``), in
  turns parent, change, change, parent, on the same inputs and by part.

Prints one line a measurement and the card's name and power limit, and
writes every number to ``--out`` (JSON).  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

from gfnerf_tpu_torch.ops import build

GROUPS = (1, 2, 4, 8, 16)
T2_ATOL_REL = 1e-5


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
    through the C interface they had before the redesign: (table or g,
    xyz, times, window, offsets, resolutions, hashed, out, n_points,
    n_levels, level_dim, width, n_rows, time_scale, stream)."""

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
        args = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [
            ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p]
        for name in ("gfnerf_temporal_grid_fwd", "gfnerf_temporal_grid_bwd"):
            fn = getattr(self.lib, name)
            fn.argtypes = args
            fn.restype = ctypes.c_int

    def _call(self, name, first, tables, xyz, times, out):
        err = getattr(self.lib, name)(
            first.data_ptr(), xyz.data_ptr(), times.data_ptr(),
            tables.window.data_ptr(), tables.offsets.data_ptr(),
            tables.resolutions.data_ptr(), tables.hashed.data_ptr(),
            out.data_ptr(), xyz.shape[0], tables.resolutions.shape[0],
            tables.level_dim, tables.width, tables.n_rows,
            tables.time_scale, torch.cuda.current_stream().cuda_stream)
        build.check(err, f"parent {name}")

    def fwd(self, table, tables, xyz, times):
        out = torch.empty((xyz.shape[0], tables.resolutions.shape[0]
                           * tables.level_dim), device=xyz.device)
        self._call("gfnerf_temporal_grid_fwd", table, tables, xyz, times,
                   out)
        return out

    def bwd(self, g, tables, xyz, times, n_rows):
        grad = torch.zeros((n_rows, tables.width), device=xyz.device)
        self._call("gfnerf_temporal_grid_bwd", g, tables, xyz, times, grad)
        return grad


def step_encodes(method: str, scene: Path, out_dir: Path, steps: int):
    """Train ``method`` ``steps`` steps at its registered width and return
    [(name, table, statics, xyz, times)] for every encode of one step."""
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
    return [(f"{method} {n}", *c) for n, c in zip(names, calls)]


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
    scale = float(gp.abs().max())
    rep["t2_max_abs_err"] = 0.0
    for grp in GROUPS:
        red = torch.zeros(n_levels, dtype=torch.int64, device=xyz.device)
        gk = ops.temporal_grid_bwd(g, tables, xyz, times, rows, red_ops=red,
                                   levels_per_launch=grp)
        err = float((gk - gp).abs().max())
        if not err <= T2_ATOL_REL * scale:
            raise AssertionError(f"{name}: T2 at {grp} levels a launch: "
                                 f"{err} of {scale}")
        rep["t2_max_abs_err"] = max(rep["t2_max_abs_err"], err)
    rep["t2_reductions_per_level"] = red.tolist()
    rep["t2_terms_per_level"] = p * 8 * (c + 1)
    if parent is not None:
        err = float((parent.bwd(g, tables, xyz, times, rows) - gp)
                    .abs().max())
        if not err <= T2_ATOL_REL * scale:
            raise AssertionError(f"{name}: the parent's T2: {err}")
    del gp
    terms = list(tg.temporal_scatter_terms(g, st, xyz, times))
    idx = torch.cat([i.reshape(-1) for i, _ in terms])
    vals = torch.cat([v.reshape(-1) for _, v in terms])
    del terms
    rep["t2_index_add_ms"] = time_ms(lambda: torch.zeros(
        rows * st.width, device=xyz.device).index_add_(0, idx, vals))
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
            ours = "temporal" in line or "zero_levels" in line
        if ours:
            log(f"[build] {line.strip()}")
    parent = ParentKernels(args.parent) if args.parent else None
    from gfnerf_tpu_torch.utils.synthetic import make_dnerf_fixture

    report = {"card": card, "steps": args.steps, "shapes": {}}
    with tempfile.TemporaryDirectory(prefix="temporal_bench_") as tmp:
        scene = make_dnerf_fixture(Path(tmp) / "scene", 24, 4,
                                   img_wh=(200, 200), focal=180.0)
        for method in args.methods.split(","):
            for name, table, st, xyz, times in step_encodes(
                    method, scene, Path(tmp) / method, args.steps):
                report["shapes"][name] = bench_shape(
                    name, table, st, xyz, times, parent,
                    backward="occupancy" not in name)
                del table
                torch.cuda.empty_cache()
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(report, indent=1))
    log(f"[card] {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
