#!/usr/bin/env python3
"""Smoke run of the PyTorch port's render and train paths on one CUDA card.

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — compiles gfnerf_tpu_torch/csrc/*.cu with nvcc for sm_90a,
                one process per source, into gfnerf_tpu_torch/_build/ and
                prints each kernel's registers.
  3. kernels  — each hand-written kernel against its plain PyTorch version
                on the card, at the main paths' shapes and at ragged and
                edge cases (the composite backward where transmittance
                underflows mid-ray; the hash backward's padding columns and
                masked anchors); the composites timed against their plain
                versions with CUDA events (median).
  4. workload — the bench's quality workload: 48 ring cameras and their
                sphere-scene images, depth-8 octree, 8x4-level packed hash
                field with random weights from seed 0, 384 march slots,
                per-group Adam with the default config.
  5. render   — with the launch counters reset: 4 training views and one
                1920x1080 frame in chunks of 32768 rays; outputs checked;
                each forward kernel launched once per chunk; one chunk
                against the plain versions; the hash encode timed against
                its plain version on one chunk's real inputs, and level by
                level.
  6. train    — with the counters reset: 20 init-stage steps of 8192 rays
                through make_train_step (one warm-up, 5 timed: s/step,
                rays/s, peak memory); each kernel called once per step,
                the hash backward's call launching once per group of
                levels; loss and gradients finite, the loss falling, the
                global table and every MLP changed, the block tables not,
                the occupancy statistics moved; one step from a common
                state with the kernels against the plain autograd pairs
                (no kernel may launch in it); on a train batch's points,
                the hash encode timed against its plain version and level
                by level, and the hash backward against its plain version
                and index_add_, at 1, 2, 4 and 8 levels per launch, then
                level by level (its vector reductions per level, counted
                by the kernel and held against the same runs reckoned on
                the host, and a launch per level timed); the host syncs of
                one encode forward and backward.
Before the last line come a JSON object with each kernel's launches, error,
times and bound, and the card's name and power limit; the last line is
{"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
COMPARE_RAYS = 8192
# kernel vs plain, f32 (the JAX tests' composite tolerance)
K1_TOL = dict(rtol=1e-4, atol=1e-5)
H1_ATOL = 1e-5
# K2 vs plain: the suffix and prefix sums run in other orders (warp scans
# against cumsum), so an output that nearly cancels keeps an absolute error
# of a few f32 ulps of the ray's largest term: rtol 1e-4 plus an atol of
# 1e-6 of the output's largest magnitude
K2_RTOL, K2_ATOL_REL = 1e-4, 1e-6
# H2 vs plain: both sum the same f32 terms with atomics, in different
# orders; a row sums up to thousands of terms: 1e-5 of the largest entry
H2_ATOL_REL = 1e-5
# one chunk, kernels vs plain versions: the encodes agree bit for bit (so
# the bf16 MLPs see the same inputs), the composites to f32 rounding
SLICE_ATOL = 2e-3
# the train path: steps taken (one warm-up, TIMED_STEPS timed, the rest for
# the loss check), and one step from a common state, kernels vs the plain
# autograd pairs: the kernels' f32 sums run in other orders.  On the H100
# the step's gradients differed by at most 1.2e-4 of the group's largest
# (MLPs) and 7e-5 (table); the limit, 2e-3 of the largest, is over 10x that
TRAIN_STEPS = 20
TIMED_STEPS = 5
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
# the card's peak memory rate (H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int = 7, reps: int = 1) -> float:
    """Median CUDA-event time of fn() in milliseconds, after one warm-up:
    n samples, each of reps calls in a row between two events, so that
    with reps > 1 the host's launch overhead overlaps the device's work."""
    import numpy as np
    import torch

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


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def assert_close(got, want, what, rtol=0.0, atol=0.0, atol_rel=0.0):
    """|got - want| <= rtol |want| + atol + atol_rel max|want|, per
    tensor."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        tol = atol + atol_rel * float(w.abs().max())
        if not torch.allclose(g, w, rtol=rtol, atol=tol):
            err = float((g - w).abs().max())
            raise AssertionError(f"{what}[{i}]: max abs err {err} over "
                                 f"rtol {rtol} atol {tol}")


def phase_device():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); using "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return card


def phase_build():
    from gfnerf_tpu_torch.ops import build

    res = build.build_library(verbose=True)
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)} -> "
        f"{build.LIB_PATH.relative_to(REPO)} in {res['seconds']:.2f}s")
    for line in res["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")
    build.library()


def _composite_inputs(r, s, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = [(rng.random((r, s)) * 5), rng.random((r, s)) * 0.01 + 1e-3,
         np.cumsum(rng.random((r, s)), -1), rng.random((r, s, 3))]
    return [torch.as_tensor(a.astype(np.float32), device="cuda") for a in x]


def _hash_inputs(p, n_channels, n_volumes, seed, n_levels=8, rows_log2=15):
    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    _, prim, bias = init_packed_hash_params(seed, rows_log2, n_volumes,
                                            n_levels, n_channels)
    rng = np.random.default_rng(seed)
    feat = rng.uniform(-0.5, 0.5, (n_levels, 1 << rows_log2, 128))
    pts = rng.uniform(0.17, 0.83, (p, 3))
    anc = rng.integers(0, n_volumes, p)
    anc[rng.random(p) < 0.05] = -1
    dev = "cuda"
    return (torch.as_tensor(feat.astype(np.float32), device=dev),
            torch.as_tensor(prim.astype(np.int64), device=dev),
            torch.as_tensor(bias, device=dev),
            torch.as_tensor(pts.astype(np.float32), device=dev),
            torch.as_tensor(anc.astype(np.int32), device=dev))


def _cotangents(r, s, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shapes = ((r, s), (r, s), (r, 3), (r, 1), (r, 1))
    return [torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                            device="cuda") for sh in shapes]


def composite_fwd_bytes(r, s) -> int:
    """Bytes the composite must move: each input (sigma, dt, t, rgb) read
    once, each output (w, alpha, rgb, acc, depth) written once (f32)."""
    return 4 * (6 * r * s + 2 * r * s + 5 * r)


def f32_bytes(*tensors) -> int:
    """Bytes of the given f32 tensors (None counts as none)."""
    return 4 * sum(t.numel() for t in tensors if t is not None)


def check_composite_bwd() -> dict:
    """K2 against its plain version at the train step's shape, a ragged
    one, a tiny one and one whose transmittance underflows mid-ray, with
    every cotangent and gradient; then as the train step calls it, through
    autograd: cotangents of rgb and acc only, gradients of densities and
    colours only.  Timed against the plain version in both forms at the
    train step's shape; the train step's form is the one reported."""
    import torch

    from gfnerf_tpu_torch.ops.composite import (
        _composite_bwd_cuda, composite_backward_reference, fused_composite)

    errs = []
    for r, s, opaque in ((8192, 384, False), (1000, 48, False),
                         (7, 33, False), (1000, 48, True)):
        x = _composite_inputs(r, s, seed=r + s + 7)
        if opaque:   # sigma*dt up to 10: T underflows to 0 mid-ray
            x[0] = x[0] * 200.0
        g = _cotangents(r, s, seed=r + s)
        got = _composite_bwd_cuda(*x, g)
        want = composite_backward_reference(*x, g)
        torch.cuda.synchronize()
        assert_close(got, want, f"composite_bwd R={r} S={s} opaque={opaque}",
                     rtol=K2_RTOL, atol_rel=K2_ATOL_REL)
        errs.append(max_err(got, want))
        log(f"[kernels] composite_bwd R={r} S={s} opaque={opaque}: max abs "
            f"err {errs[-1]:.3g}")
    r, s = 8192, 384
    x = _composite_inputs(r, s, seed=2)
    g = _cotangents(r, s, seed=3)
    need = (True, False, False, True)
    cots = [None, None, g[2], g[3], None]
    xs = [t.clone().requires_grad_(n) for t, n in zip(x, need)]
    out = fused_composite(*xs)
    torch.autograd.backward([out[2], out[3]], [g[2], g[3]])
    want = composite_backward_reference(*x, cots, need)
    torch.cuda.synchronize()
    if xs[1].grad is not None or xs[2].grad is not None:
        raise AssertionError("composite_bwd: a gradient nobody asked for")
    got = [xs[0].grad, xs[3].grad]
    assert_close(got, [want[0], want[3]],
                 f"composite_bwd R={r} S={s} through autograd, train form",
                 rtol=K2_RTOL, atol_rel=K2_ATOL_REL)
    errs.append(max_err(got, [want[0], want[3]]))
    log(f"[kernels] composite_bwd R={r} S={s} through autograd, cotangents "
        f"of rgb and acc, gradients of sigma and rgb: max abs err "
        f"{errs[-1]:.3g}")
    del xs, out, got
    # bytes: the inputs K2 reads (t only with a depth cotangent) and the
    # outputs it writes, (R, S) for sigma, dt, t and (R, S, 3) for rgb
    for form, args, n_bytes in (
            ("all cotangents and gradients", (*x, g),
             f32_bytes(*x, *g) + 4 * 6 * r * s),
            ("train form", (*x, cots, need),
             f32_bytes(x[0], x[1], x[3], *cots) + 4 * 4 * r * s)):
        ms = time_ms(lambda: _composite_bwd_cuda(*args), n=21)
        plain_ms = time_ms(lambda: composite_backward_reference(*args))
        bound = n_bytes / HBM_BYTES_PER_S * 1e3
        log(f"[kernels] composite_bwd R={r} S={s}, {form}: kernel {ms:.4f} "
            f"ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB)")
    return dict(max_abs_err=max(errs), ms=ms, plain_ms=plain_ms,
                bound_ms=bound, bound_by="bytes", library_ms=None)


def check_hash_bwd() -> float:
    """H2 against its plain version at 2^20 points (C = 4 with and without
    dense levels, C = 2, C = 8) and at 1000 points with masked anchors;
    the padding columns must stay exactly 0.  Returns the max error."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, pack_for_channels,
        packed_hash_backward_reference)

    errs = []
    for p, c, dense in ((1 << 20, 4, 0), (1 << 20, 4, 2), (1 << 20, 2, 0),
                        (1 << 20, 8, 0), (1000, 4, 0)):
        feat, prim, bias, pts, anc = _hash_inputs(p, c, n_volumes=16,
                                                  seed=p + c + dense + 1)
        n_levels, n_rows, width = feat.shape
        gen = torch.Generator(device="cuda").manual_seed(p + c)
        g = torch.randn((p, n_levels * c), generator=gen, device="cuda")
        pack = pack_for_channels(c)
        args = (g, prim, bias, pts, anc, n_rows, width, c, pack, dense)
        got = _packed_hash_backward_cuda(*args)
        want = packed_hash_backward_reference(*args)
        torch.cuda.synchronize()
        assert_close([got], [want], f"packed_hash_bwd P={p} C={c} "
                     f"dense={dense}", atol_rel=H2_ATOL_REL)
        live = (pack + 1) ** 3 * c
        if not bool((got[..., live:] == 0).all()):
            raise AssertionError("packed_hash_bwd: padding columns written")
        errs.append(max_err([got], [want]))
        log(f"[kernels] packed_hash_bwd P={p} C={c} dense_levels={dense}: "
            f"max abs err {errs[-1]:.3g} (largest entry "
            f"{float(want.abs().max()):.3g}); columns {live}.. exactly 0")
        del got, want, g, args
    torch.cuda.empty_cache()
    return max(errs)


def phase_kernels(n_samples: int):
    import torch

    from gfnerf_tpu_torch.render_bench import CHUNK

    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode,
                                                     packed_hash_encode_raw)
    from gfnerf_tpu_torch.ops.composite import (composite_reference,
                                                fused_composite)

    report = {}
    # K1: the render chunk's shape, and a ragged one
    errs = []
    for r, s in ((CHUNK, n_samples), (1000, 48), (7, 33)):
        x = _composite_inputs(r, s, seed=r + s)
        got = fused_composite(*x)
        want = composite_reference(*x)
        torch.cuda.synchronize()
        assert_close(got, want, f"composite R={r} S={s}", **K1_TOL)
        errs.append(max_err(got, want))
        log(f"[kernels] composite_fwd R={r} S={s}: max abs err {errs[-1]:.3g}")
    x = _composite_inputs(CHUNK, n_samples, seed=1)
    ms = time_ms(lambda: fused_composite(*x))
    plain_ms = time_ms(lambda: composite_reference(*x))
    log(f"[kernels] composite_fwd R={CHUNK} S={n_samples}: kernel {ms:.4f} ms,"
        f" plain {plain_ms:.4f} ms")
    bound = composite_fwd_bytes(CHUNK, n_samples) / HBM_BYTES_PER_S * 1e3
    report["composite_fwd"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by="bytes", library_ms=None)
    del x
    report["composite_bwd"] = check_composite_bwd()

    # H1: 2^20 points at the slice's field shape (8 levels x 4 channels,
    # 2^15 x 128 rows), dense levels, the other two lattice shapes, anchors
    # < 0 throughout
    errs = []
    for p, c, dense in ((1 << 20, 4, 0), (1 << 20, 4, 2), (1 << 18, 2, 0),
                        (1 << 18, 8, 0), (1000, 4, 0)):
        args = _hash_inputs(p, c, n_volumes=16, seed=p + c + dense)
        pack = pack_for_channels(c)
        got = packed_hash_encode(*args, c, pack, dense)
        want = packed_hash_encode_raw(*args, c, pack, dense)
        torch.cuda.synchronize()
        assert_close([got], [want], f"packed hash P={p} C={c} dense={dense}",
                     atol=H1_ATOL)
        if not bool((got[args[4] < 0] == 0).all()):
            raise AssertionError("packed hash: masked anchors not zeroed")
        errs.append(max_err([got], [want]))
        log(f"[kernels] packed_hash_fwd P={p} C={c} dense_levels={dense}: "
            f"max abs err {errs[-1]:.3g}")
    del got, want, args
    torch.cuda.empty_cache()
    report["packed_hash_fwd"] = dict(max_abs_err=max(errs))
    report["packed_hash_bwd"] = dict(max_abs_err=check_hash_bwd())
    return report


def launch_counts() -> dict:
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.ops.composite import fused_composite

    return {"composite_fwd": fused_composite.launches,
            "composite_bwd": fused_composite.bwd_launches,
            "packed_hash_fwd": packed_hash_encode.launches,
            "packed_hash_bwd": packed_hash_encode.bwd_launches}


def reset_launch_counts() -> None:
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.ops.composite import fused_composite

    fused_composite.launches = fused_composite.bwd_launches = 0
    packed_hash_encode.launches = packed_hash_encode.bwd_launches = 0
    packed_hash_encode.bwd_calls = 0


class plain_wrappers:
    """Within the block the model runs the plain autograd pairs (plain
    forward and plain backward) in place of the kernel wrappers; on exit
    it fails if any kernel launched meanwhile."""

    def __enter__(self):
        from gfnerf_tpu_torch.fields import field as field_mod
        from gfnerf_tpu_torch.fields.packed_hash import \
            plain_packed_hash_encode
        from gfnerf_tpu_torch.models import gfnerf as model_mod
        from gfnerf_tpu_torch.ops.composite import plain_fused_composite

        self.mods = (model_mod, field_mod)
        self.saved = (model_mod.fused_composite, field_mod.packed_hash_encode)
        model_mod.fused_composite = plain_fused_composite
        field_mod.packed_hash_encode = plain_packed_hash_encode
        self.before = launch_counts()
        return self

    def __exit__(self, *exc):
        model_mod, field_mod = self.mods
        model_mod.fused_composite, field_mod.packed_hash_encode = self.saved
        after = launch_counts()
        if exc[0] is None and after != self.before:
            raise AssertionError(f"plain run launched kernels: launch counts "
                                 f"{self.before} -> {after}")
        return False


def phase_render(wl):
    """The render path: 4 training views and one 1920x1080 frame, counted;
    one chunk against the plain versions; H1 timed on a frame chunk."""
    import torch

    from gfnerf_tpu_torch.models.gfnerf import make_render_fn
    from gfnerf_tpu_torch.render_bench import (CHUNK, FRAME_WH, N_VIEWS,
                                               frame_rays, render_camera,
                                               render_rays)

    dev = torch.device("cuda")
    scfg = wl["scfg"]
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    cams = wl["cams"]
    field, oct_dev = wl["field"], wl["oct_dev"]
    render_fn = make_render_fn(wl["mcfg"], scfg)
    fo, fd = frame_rays(c2w[0], *FRAME_WH, dev)
    n_frame = fo.shape[0]
    n_view_chunks = N_VIEWS * -(-(w * h) // CHUNK)
    n_frame_chunks = -(-n_frame // CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the render path, counted ----
    reset_launch_counts()
    t0 = time.perf_counter()
    views = [render_camera(render_fn, field, oct_dev, cams,
                           i * len(c2w) // N_VIEWS, CHUNK)
             for i in range(N_VIEWS)]
    torch.cuda.synchronize()
    t_views = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = render_rays(render_fn, field, oct_dev, fo, fd, 0, CHUNK)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    expected = n_view_chunks + n_frame_chunks
    log(f"[render] {N_VIEWS} views {w}x{h} in {t_views:.3f}s; frame "
        f"{FRAME_WH[0]}x{FRAME_WH[1]} ({n_frame_chunks} chunks of {CHUNK}) "
        f"in {t_frame:.3f}s = {t_frame:.4f} s/frame, "
        f"{n_frame / t_frame:.1f} rays/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[render] launches {launches}, expected {expected} of each forward "
        f"and no backward")
    for name, n in launches.items():
        if n != (0 if name.endswith("_bwd") else expected):
            raise AssertionError(f"{name}: {n} launches on the render path")
    for out, what in [(v, f"view {i}") for i, v in enumerate(views)] + [
            (frame, "frame")]:
        for k, v in out.items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"{what}: non-finite {k}")
        acc = out["accumulation"]
        if float(acc.min()) < 0 or float(acc.max()) > 1 + 1e-5:
            raise AssertionError(f"{what}: accumulation outside [0, 1]")
        if what != "frame" and tuple(out["rgb"].shape) != (h, w, 3):
            raise AssertionError(
                f"{what}: rgb shape {tuple(out['rgb'].shape)}")
    if tuple(frame["rgb"].shape) != (n_frame, 3):
        raise AssertionError(f"frame rgb shape {tuple(frame['rgb'].shape)}")
    hit = float((frame["accumulation"] > 1e-3).float().mean())
    log(f"[render] outputs finite, accumulation in [0, 1]; frame rays with "
        f"accumulation > 1e-3: {hit:.4f}; mean rgb "
        f"{frame['rgb'].mean(0).tolist()}")
    if hit <= 0.0:
        raise AssertionError("frame: no ray reached the scene")

    # ---- one chunk through the plain versions ----
    mid = n_frame // 2 - COMPARE_RAYS // 2
    o, d = fo[mid:mid + COMPARE_RAYS], fd[mid:mid + COMPARE_RAYS]
    got = render_fn(field, oct_dev, o, d, 0)
    with plain_wrappers():
        want = render_fn(field, oct_dev, o, d, 0)
    torch.cuda.synchronize()
    errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
    log(f"[render] {COMPARE_RAYS}-ray chunk, kernels vs plain versions: max "
        f"abs err {errs} (atol {SLICE_ATOL})")
    for k, e in errs.items():
        if not e <= SLICE_ATOL:
            raise AssertionError(f"render chunk {k}: kernels vs plain {e}")
    stats = {"s_per_frame": t_frame, "rays_per_s": n_frame / t_frame,
             "peak_bytes": peak}
    return launches, stats, time_encode_on_chunk(wl, fo, fd)


def _marched_points(wl, o, d, noise):
    """The encode's inputs for one ray batch: normalized warped points and
    anchors (P,), as field_density forms them."""
    import torch

    from gfnerf_tpu_torch.models.gfnerf import sample_rays
    from gfnerf_tpu_torch.sampler.perssampler import warp_points

    oct_dev, scfg = wl["oct_dev"], wl["scfg"]
    with torch.no_grad():
        samples = sample_rays(oct_dev, o, d, noise, 1.0, scfg)
        anc = samples.trans_idx.reshape(-1)
        warp = warp_points(oct_dev, anc.clamp(0, oct_dev.w2xz.shape[0] - 1),
                           samples.world_pts.reshape(-1, 3))
    return (warp + 1.5) * (1.0 / 3.0), anc


def hash_fwd_bytes(p, n_levels, n_channels, table_numel) -> int:
    """H1: output, points, anchors, and one read of the f32 table (the
    bf16 copy that the wrapper writes is not work the function needs)."""
    return 4 * p * n_levels * n_channels + 12 * p + 4 * p + 4 * table_numel


def hash_bwd_bytes(p, n_levels, n_channels, table_numel) -> int:
    """H2: upstream gradient, points, anchors, and the f32 gradient's
    zero-fill."""
    return 4 * p * n_levels * n_channels + 12 * p + 4 * p + 4 * table_numel


def time_encode_on_chunk(wl, fo, fd) -> dict:
    """The hash encode, kernel and plain version, on the inputs one frame
    chunk gives it: 32768 rays x 384 samples of marched, warped points."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (_packed_hash_encode_cuda,
                                                     pack_for_channels,
                                                     packed_hash_encode_raw)
    from gfnerf_tpu_torch.render_bench import CHUNK

    field, scfg = wl["field"], wl["scfg"]
    c = wl["fcfg"].features_per_level
    mid = (fo.shape[0] - CHUNK) // 2
    o, d = fo[mid:mid + CHUNK], fd[mid:mid + CHUNK]
    pts, anc = _marched_points(
        wl, o, d, torch.ones((CHUNK, scfg.max_samples), device=o.device))
    with torch.no_grad():
        args = (field.global_feat, field.global_prim, field.global_bias, pts,
                anc, c, pack_for_channels(c), 0)
        got = _packed_hash_encode_cuda(*args)
        want = packed_hash_encode_raw(*args)
        torch.cuda.synchronize()
        assert_close([got], [want], "packed hash on a frame chunk",
                     atol=H1_ATOL)
        if not torch.equal(got, want):
            raise AssertionError("packed hash on a frame chunk: not equal to "
                                 "the plain version bit for bit")
        err = max_err([got], [want])
        del got, want
        ms = time_ms(lambda: _packed_hash_encode_cuda(*args))
        plain_ms = time_ms(lambda: packed_hash_encode_raw(*args), n=3)
        kernel_ms, levels = hash_fwd_levels(args)
    p = pts.shape[0]
    table = field.global_feat
    bound = hash_fwd_bytes(p, table.shape[0], c, table.numel()) \
        / HBM_BYTES_PER_S * 1e3
    log(f"[render] packed_hash_fwd on a frame chunk (P={p}, "
        f"{int((anc >= 0).sum())} valid): max abs err {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms")
    log(f"[render] packed_hash_fwd on a frame chunk, given the kernel's "
        f"input types (no copies): {kernel_ms:.4f} ms; each level alone: "
        f"{[round(t, 4) for t in levels]} ms (sum {sum(levels):.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "frame_chunk_kernel_typed_ms": kernel_ms,
            "frame_chunk_level_ms": levels}


def kernel_typed(args, table=None) -> tuple:
    """The hash wrappers' arguments with the tensors the kernels read
    already in their types (int32 primes and anchors, and the table
    ``table`` of H1 in bf16), so that the wrapper copies nothing: a time
    taken on them is the kernel's alone."""
    import torch

    a = list(args)
    a[1], a[4] = a[1].to(torch.int32), a[4].to(torch.int32)
    if table is not None:
        a[0] = table.detach().to(torch.bfloat16)
    return tuple(a)


def hash_fwd_levels(args) -> tuple:
    """H1 on the given inputs in the kernel's types (10 launches per
    sample): whole, and level by level, each launch over one level alone
    held against that level's columns of the whole.  Returns (whole ms,
    per-level ms)."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import _packed_hash_encode_cuda

    typed = kernel_typed(args, table=args[0])
    c = args[5]
    full = _packed_hash_encode_cuda(*typed)
    whole_ms = time_ms(lambda: _packed_hash_encode_cuda(*typed), reps=10)
    times = []
    for l in range(args[0].shape[0]):
        out = _packed_hash_encode_cuda(*typed, level=l)
        torch.cuda.synchronize()
        if not torch.equal(out, full[:, l * c:(l + 1) * c]):
            raise AssertionError(f"packed_hash_fwd level {l} alone differs")
        times.append(time_ms(
            lambda: _packed_hash_encode_cuda(*typed, level=l), reps=10))
    return whole_ms, times


def hash_bwd_levels(args) -> list:
    """H2 level by level on the given inputs: the vector reductions the
    kernel counted at each level, held against packed_hash_bwd_reductions
    (the same runs reckoned on the host), and the time of a launch over
    that level alone (its 16 MB zero-fill included; 10 launches per
    sample; inputs in the kernel's types), whose result is held against
    that level of the whole kernel's."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, packed_hash_bwd_reductions)

    g, prim, bias, pts, anc, n_rows, width, c, pack, dense = args
    n_levels = prim.shape[0]
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    full = _packed_hash_backward_cuda(*args, red_ops=ops)
    want = packed_hash_bwd_reductions(prim, bias, pts, anc, n_rows, c, pack,
                                      dense)
    torch.cuda.synchronize()
    if ops.tolist() != want.tolist():
        raise AssertionError(f"packed_hash_bwd: reductions per level "
                             f"{ops.tolist()}, runs reckoned on the host "
                             f"{want.tolist()}")
    per_level = []
    typed = kernel_typed(args)
    for l in range(n_levels):
        largs = (g[:, l * c:(l + 1) * c].contiguous(), *typed[1:])
        grad = _packed_hash_backward_cuda(*largs, level=l)
        torch.cuda.synchronize()
        assert_close([grad[0]], [full[l]], f"packed_hash_bwd level {l} alone",
                     atol_rel=H2_ATOL_REL)
        ms = time_ms(lambda: _packed_hash_backward_cuda(*largs, level=l),
                     reps=10)
        per_level.append({"level": l, "reductions": int(ops[l]),
                          "ms": ms})
        log(f"[train] packed_hash_bwd level {l} alone: {int(ops[l])} vector "
            f"reductions (host reckoning agrees), {ms:.4f} ms")
    return per_level


def hash_bwd_groupings(args, want) -> dict:
    """H2 on the given inputs, in the kernel's types, with each launch
    covering 1, 2, 4 and 8 levels (the kernel's own choice is 8 / C): per
    levels-per-launch, the launches of one call and the time of the call;
    each result held against ``want``."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, packed_hash_encode)

    args = kernel_typed(args)
    out = {}
    for n in (1, 2, 4, 8):
        before = packed_hash_encode.bwd_launches
        got = _packed_hash_backward_cuda(*args, levels_per_launch=n)
        launches = packed_hash_encode.bwd_launches - before
        torch.cuda.synchronize()
        assert_close([got], [want], f"packed_hash_bwd at {n} levels per "
                     f"launch", atol_rel=H2_ATOL_REL)
        del got
        ms = time_ms(lambda: _packed_hash_backward_cuda(
            *args, levels_per_launch=n), n=11)
        out[n] = {"launches": launches, "ms": ms}
    return out


def host_syncs(fn) -> dict:
    """Counts of the CUDA runtime calls that wait for the device
    (profiling.HOST_WAITS) that fn() makes, from a torch.profiler trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from gfnerf_tpu_torch.utils.profiling import HOST_WAITS

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
    return {e.key: e.count for e in prof.key_averages()
            if e.key in HOST_WAITS}


def time_hash_on_batch(wl, batch, noise) -> tuple:
    """H1 and H2 on the points one train batch gives them (8192 rays x 384
    samples): H1 against its plain version; H2 against its plain version
    and index_add_ of the same precomputed (rows, payload) terms, with a
    random upstream gradient, and level by level; the host syncs of one
    encode forward and backward with the level constants built at every
    launch (the cache bypassed) and reused.  Returns (H1's, H2's report)."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.fields import packed_hash as ph

    field = wl["field"]
    c = wl["fcfg"].features_per_level
    pack = ph.pack_for_channels(c)
    rays = generate_rays_multi(wl["cams"], batch["camera_indices"],
                               batch["coords"])
    pts, anc = _marched_points(wl, rays["origins"], rays["directions"], noise)
    n_levels, n_rows, width = field.global_feat.shape
    p = pts.shape[0]
    n_valid = int((anc >= 0).sum())

    # ---- H1 ----
    with torch.no_grad():
        fargs = (field.global_feat, field.global_prim, field.global_bias,
                 pts, anc, c, pack, 0)
        got = ph._packed_hash_encode_cuda(*fargs)
        want = ph.packed_hash_encode_raw(*fargs)
        torch.cuda.synchronize()
        assert_close([got], [want], "packed hash on a train batch",
                     atol=H1_ATOL)
        if not torch.equal(got, want):
            raise AssertionError("packed hash on a train batch: not equal "
                                 "to the plain version bit for bit")
        if not bool((got[anc < 0] == 0).all()):
            raise AssertionError("packed hash: masked anchors not zeroed")
        fwd_err = max_err([got], [want])
        del want
        fwd_ms = time_ms(lambda: ph._packed_hash_encode_cuda(*fargs), n=21)
        fwd_plain_ms = time_ms(lambda: ph.packed_hash_encode_raw(*fargs), n=3)
        fwd_kernel_ms, fwd_levels = hash_fwd_levels(fargs)
        del got
    fwd_bound = hash_fwd_bytes(p, n_levels, c, field.global_feat.numel()) \
        / HBM_BYTES_PER_S * 1e3
    log(f"[train] packed_hash_fwd on a train batch (P={p}, {n_valid} valid): "
        f"max abs err {fwd_err:.3g}; kernel {fwd_ms:.4f} ms, plain "
        f"{fwd_plain_ms:.4f} ms, bound {fwd_bound:.4f} ms; given the "
        f"kernel's input types: {fwd_kernel_ms:.4f} ms; each level alone: "
        f"{[round(t, 4) for t in fwd_levels]} ms (sum {sum(fwd_levels):.4f})")

    # ---- H2 ----
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((p, n_levels * c), generator=gen, device="cuda")
    args = (g, field.global_prim, field.global_bias, pts, anc, n_rows, width,
            c, pack, 0)
    got = ph._packed_hash_backward_cuda(*args)
    want = ph.packed_hash_backward_reference(*args)
    torch.cuda.synchronize()
    assert_close([got], [want], "packed_hash_bwd on a train batch",
                 atol_rel=H2_ATOL_REL)
    err = max_err([got], [want])
    groupings = hash_bwd_groupings(args, want)
    del want
    ms = time_ms(lambda: ph._packed_hash_backward_cuda(*args), n=11)
    del got
    plain_ms = time_ms(lambda: ph.packed_hash_backward_reference(*args), n=3)
    terms = list(ph.packed_hash_scatter_terms(*args))
    rows = torch.cat([t[0] for t in terms])
    payload = torch.cat([t[1] for t in terms])
    del terms
    n_out = n_levels * n_rows * width // c
    library_ms = time_ms(lambda: torch.zeros(
        (n_out, c), device="cuda").index_add_(0, rows, payload), n=5)
    del rows, payload
    torch.cuda.empty_cache()
    bound = hash_bwd_bytes(p, n_levels, c, field.global_feat.numel()) \
        / HBM_BYTES_PER_S * 1e3
    log(f"[train] packed_hash_bwd on a train batch (P={p}, {n_valid} valid): "
        f"max abs err {err:.3g}; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" index_add_ {library_ms:.4f} ms, bound {bound:.4f} ms")
    by_group = "; ".join(f"{n}: {x['launches']} launches, {x['ms']:.4f} ms"
                         for n, x in groupings.items())
    log(f"[train] packed_hash_bwd by levels per launch: {by_group}")
    levels = hash_bwd_levels(args)
    n_red = sum(x["reductions"] for x in levels)
    log(f"[train] packed_hash_bwd: {n_red} vector reductions in all "
        f"({8 * n_valid * n_levels} corners of valid (point, level) pairs); "
        f"levels alone sum to {sum(x['ms'] for x in levels):.4f} ms")

    # ---- host syncs of one encode forward and backward ----
    feat = field.global_feat.detach().clone().requires_grad_(True)
    gout = torch.ones((p, n_levels * c), device="cuda")

    def encode_fwd_bwd():
        out = ph.packed_hash_encode(feat, field.global_prim,
                                    field.global_bias, pts, anc, c, pack)
        out.backward(gout)
        torch.cuda.synchronize()

    encode_fwd_bwd()
    ph._level_constants.cache_clear()   # the next launch builds them anew
    syncs = {"cold": host_syncs(encode_fwd_bwd),
             "cached": host_syncs(encode_fwd_bwd)}
    log(f"[train] host calls in one encode forward + backward (one final "
        f"cudaDeviceSynchronize included): level constants built at its "
        f"first launch {syncs['cold']}, cached {syncs['cached']}")
    del feat, gout
    fwd = {"max_abs_err": fwd_err, "train_batch_ms": fwd_ms,
           "train_batch_plain_ms": fwd_plain_ms,
           "train_batch_bound_ms": fwd_bound,
           "train_batch_kernel_typed_ms": fwd_kernel_ms,
           "train_batch_level_ms": fwd_levels}
    bwd = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
           "per_level": levels, "by_levels_per_launch": groupings,
           "host_syncs": syncs}
    return fwd, bwd


def phase_train(wl):
    """The train path: TRAIN_STEPS init-stage steps at 8192 rays through
    make_train_step, counted (one warm-up, TIMED_STEPS timed, the rest for
    the loss check); the state checked; one step from a common state
    against the plain autograd pairs; H2 timed on a train batch."""
    import copy

    import numpy as np
    import torch

    from gfnerf_tpu_torch.engine.optimizers import (field_param_grads,
                                                    field_param_groups)
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.model_components.losses import s3im_permutations
    from gfnerf_tpu_torch.models.gfnerf import TrainState
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch, run_steps

    dev = torch.device("cuda")
    field = wl["field"]
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [make_batch(wl["images"], RAYS, seed, dev)
               for seed in range(TRAIN_STEPS + 1)]
    groups0 = {k: [p.detach().clone() for p in ps]
               for k, ps in field_param_groups(field).items()}
    block0 = field.block_feats.detach().clone()
    oct0 = {k: getattr(wl["oct_dev"], k).clone()
            for k in ("weight_stats", "alpha_stats", "visit_cnt")}
    torch.cuda.synchronize()

    # ---- the train path, counted ----
    reset_launch_counts()
    warm, losses = run_steps(wl, batches[:1], gen)
    torch.cuda.reset_peak_memory_stats()
    times, more = run_steps(wl, batches[1:1 + TIMED_STEPS], gen)
    peak = torch.cuda.max_memory_allocated()
    _, rest = run_steps(wl, batches[1 + TIMED_STEPS:TRAIN_STEPS], gen)
    launches = launch_counts()
    bwd_calls = packed_hash_encode.bwd_calls
    losses += more + rest
    dt = float(np.mean(times))
    log(f"[train] warm-up step {warm[0]:.3f}s; {TIMED_STEPS} steps of {RAYS} "
        f"rays: {dt:.4f} s/step (mean; {', '.join(f'{t:.4f}' for t in times)})"
        f" = {RAYS / dt:.1f} rays/s; peak memory {peak / 2**30:.2f} GiB")
    # H2's C entry point launches once per group of 8 / C levels
    # (csrc/packed_hash_bwd.cu), each after a zero-fill of its group
    n_levels = field.global_feat.shape[0]
    h2_groups = -(-n_levels // max(1, 8 // wl["fcfg"].features_per_level))
    expected = {name: TRAIN_STEPS * (h2_groups if name == "packed_hash_bwd"
                                     else 1) for name in launches}
    log(f"[train] launches {launches}, expected {expected}: each kernel once "
        f"per step, H2 in {bwd_calls} calls of {h2_groups} launches")
    if launches != expected or bwd_calls != TRAIN_STEPS:
        raise AssertionError(f"launches {launches} (H2 calls {bwd_calls}) in "
                             f"{TRAIN_STEPS} train steps, expected {expected}")

    # ---- the state after training ----
    log(f"[train] losses {[round(x, 5) for x in losses]}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    first, last = losses[0], float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> mean of the last "
                             f"5 {last}")
    for name, gs in field_param_grads(field).items():
        for i, g in enumerate(gs):
            if g is not None and not bool(torch.isfinite(g).all()):
                raise AssertionError(f"non-finite gradient {name}[{i}]")
    for name, ps in field_param_groups(field).items():
        if name == "block":
            continue
        for i, (p, p0) in enumerate(zip(ps, groups0[name])):
            if torch.equal(p, p0):
                raise AssertionError(f"{name}[{i}] did not change")
    if not torch.equal(field.block_feats, block0):
        raise AssertionError("block_feats changed at the init stage")
    moved = {k: int((getattr(wl["oct_dev"], k) != v).sum())
             for k, v in oct0.items()}
    log(f"[train] loss {first:.5f} -> {last:.5f} (mean of the last 5); "
        f"global_feat and all {len(groups0['fields'])} MLP/appearance "
        f"tensors changed, block_feats unchanged; octree nodes whose stats "
        f"moved: {moved}")
    if not any(moved.values()):
        raise AssertionError("the occupancy statistics did not move")

    # ---- one step, kernels vs the plain autograd pairs ----
    batch = batches[TRAIN_STEPS]
    noise = torch.rand((RAYS, wl["scfg"].max_samples), generator=gen,
                       device=dev) + 0.5
    perms = s3im_permutations(RAYS, generator=gen, device=dev)
    outs = {}
    for kind in ("kernels", "plain"):
        state = TrainState(field=copy.deepcopy(field),
                           opt_state=copy.deepcopy(wl["state"].opt_state),
                           step=wl["state"].step)
        oct_dev = copy.deepcopy(wl["oct_dev"])
        if kind == "plain":
            with plain_wrappers():
                _, _, metrics, _ = wl["step_fn"](
                    state, oct_dev, wl["cams"], batch, 1.0, noise=noise,
                    s3im_perms=perms)
        else:
            _, _, metrics, _ = wl["step_fn"](
                state, oct_dev, wl["cams"], batch, 1.0, noise=noise,
                s3im_perms=perms)
        torch.cuda.synchronize()
        outs[kind] = (float(metrics["loss"]), field_param_grads(state.field))
    (loss_k, grads_k), (loss_p, grads_p) = outs["kernels"], outs["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[train] one step, kernels vs plain: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (rel {rel:.3g}, tol {TRAIN_LOSS_RTOL})")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"train step loss: kernels vs plain rel {rel}")
    for name in ("fields", "base_encoding_init"):
        scale = max(float(g.abs().max()) for g in grads_p[name])
        err = max(float((a - b).abs().max())
                  for a, b in zip(grads_k[name], grads_p[name]))
        log(f"[train] {name} gradients, kernels vs plain: max abs err "
            f"{err:.3g}, largest {scale:.3g} (tol {TRAIN_GRAD_TOL} of it)")
        if not err <= TRAIN_GRAD_TOL * scale:
            raise AssertionError(f"{name} gradients: kernels vs plain {err}")
    if grads_k["block"][0] is not None or grads_p["block"][0] is not None:
        raise AssertionError("the block table got a gradient at init")
    del outs, grads_k, grads_p
    torch.cuda.empty_cache()
    stats = {"s_per_step": dt, "rays_per_s": RAYS / dt, "peak_bytes": peak,
             "step_seconds": times, "first_loss": first, "last_loss": last,
             "packed_hash_bwd_calls": bwd_calls}
    return launches, stats, time_hash_on_batch(wl, batch, noise)


def main() -> int:
    if not (REPO / "gfnerf_tpu_torch").is_dir():
        print("chip_smoke: gfnerf_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    card = phase_device()
    phase_build()
    report = phase_kernels(n_samples=384)
    import torch

    from gfnerf_tpu_torch.train_bench import build_train_workload

    t0 = time.perf_counter()
    wl = build_train_workload(torch.device("cuda"), seed=0)
    tree, scfg = wl["tree"], wl["scfg"]
    log(f"[workload] in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in wl['timings'].items())}):"
        f" {tree.n_nodes} nodes, {int(wl['oct_dev'].n_leaves)} valid leaves, "
        f"{tree.n_volumes} volumes; S={scfg.max_samples}, sample_l "
        f"{scfg.sample_l:.6f}")
    render_launches, render_stats, encode = phase_render(wl)
    train_launches, train_stats, (hash_fwd, hash_bwd) = phase_train(wl)
    for name, *parts in (("packed_hash_fwd", encode, hash_fwd),
                         ("packed_hash_bwd", hash_bwd)):
        for part in parts:
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              part.pop("max_abs_err"))
            report[name].update(part)

    sources = {
        "composite_fwd": ("gfnerf_tpu_torch/csrc/composite_fwd.cu",
                          "gfnerf_tpu/ops/pallas/composite.py:80"),
        "composite_bwd": ("gfnerf_tpu_torch/csrc/composite_bwd.cu",
                          "gfnerf_tpu/ops/pallas/composite.py:112"),
        "packed_hash_fwd": ("gfnerf_tpu_torch/csrc/packed_hash_fwd.cu",
                            "gfnerf_tpu/fields/packed_hash.py:202"),
        "packed_hash_bwd": ("gfnerf_tpu_torch/csrc/packed_hash_bwd.cu",
                            "gfnerf_tpu/fields/packed_hash.py:490"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep,
                "launches": render_launches[name] + train_launches[name],
                "launches_by_path": {"render": render_launches[name],
                                     "train": train_launches[name]},
                **report[name]}
               for name, (src, rep) in sources.items()]
    log(f"[render] {json.dumps(render_stats)}")
    log(f"[train] {json.dumps(train_stats)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
