#!/usr/bin/env python3
"""Smoke run of the PyTorch port's render path on one CUDA card.

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device  — a CUDA card must be present; prints nvidia-smi's name and
               power limit.
  2. build   — compiles gfnerf_tpu_torch/csrc/*.cu with nvcc for sm_90a into
               gfnerf_tpu_torch/_build/ and prints each kernel's registers.
  3. kernels — each hand-written kernel against its plain PyTorch version on
               the card, at the render path's shapes and at ragged/edge
               cases; the composite timed against its plain version with
               CUDA events (median).
  4. slice   — builds the bench's quality workload (48 ring cameras, depth-8
               octree, 8x4-level packed hash field with random weights from
               seed 0, 384 march slots), then with the kernels' launch
               counters reset renders 4 training views and one 1920x1080
               frame in chunks of 32768 rays, checks the outputs, checks
               that every kernel ran once per chunk, and compares one chunk
               with the same chunk rendered through the plain versions;
               times the hash encode against its plain version on one
               chunk's real inputs (32768 rays x 384 samples).
The line before the last is a JSON object with each kernel's launches,
error and times; the last line is {"ok": true, "device": {...}}.

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
# one chunk, kernels vs plain versions: the encodes agree to f32 rounding,
# which can flip a bf16 rounding of a hidden activation (2^-8 relative)
SLICE_ATOL = 2e-3


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int = 7) -> float:
    """Median CUDA-event time of fn() in milliseconds, after one warm-up."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def assert_close(got, want, rtol, atol, what):
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        if not torch.allclose(g, w, rtol=rtol, atol=atol):
            err = float((g - w).abs().max())
            raise AssertionError(f"{what}[{i}]: max abs err {err} over "
                                 f"rtol {rtol} atol {atol}")


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
        assert_close(got, want, what=f"composite R={r} S={s}", **K1_TOL)
        errs.append(max_err(got, want))
        log(f"[kernels] composite_fwd R={r} S={s}: max abs err {errs[-1]:.3g}")
    x = _composite_inputs(CHUNK, n_samples, seed=1)
    ms = time_ms(lambda: fused_composite(*x))
    plain_ms = time_ms(lambda: composite_reference(*x))
    log(f"[kernels] composite_fwd R={CHUNK} S={n_samples}: kernel {ms:.4f} ms,"
        f" plain {plain_ms:.4f} ms")
    report["composite_fwd"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms)
    del x

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
        assert_close([got], [want], rtol=0, atol=H1_ATOL,
                     what=f"packed hash P={p} C={c} dense={dense}")
        if not bool((got[args[4] < 0] == 0).all()):
            raise AssertionError("packed hash: masked anchors not zeroed")
        errs.append(max_err([got], [want]))
        log(f"[kernels] packed_hash_fwd P={p} C={c} dense_levels={dense}: "
            f"max abs err {errs[-1]:.3g}")
    del got, want, args
    torch.cuda.empty_cache()
    report["packed_hash_fwd"] = dict(max_abs_err=max(errs))
    return report


def _plain_render(render_fn, field, oct_dev, o, d):
    """The same render with every kernel wrapper swapped for its plain
    version (the wrappers launch kernels for CUDA tensors).  Fails if a
    kernel launched all the same, so the comparison is kernel vs plain."""
    from gfnerf_tpu_torch.fields import field as field_mod
    from gfnerf_tpu_torch.fields.packed_hash import (packed_hash_encode,
                                                     packed_hash_encode_raw)
    from gfnerf_tpu_torch.models import gfnerf as model_mod
    from gfnerf_tpu_torch.ops.composite import (composite_reference,
                                                fused_composite)

    before = (fused_composite.launches, packed_hash_encode.launches)
    saved = (model_mod.fused_composite, field_mod.packed_hash_encode)
    model_mod.fused_composite = composite_reference
    field_mod.packed_hash_encode = packed_hash_encode_raw
    try:
        out = render_fn(field, oct_dev, o, d, 0)
    finally:
        model_mod.fused_composite, field_mod.packed_hash_encode = saved
    after = (fused_composite.launches, packed_hash_encode.launches)
    if after != before:
        raise AssertionError(f"plain render launched kernels: launch counts "
                             f"{before} -> {after}")
    return out


def phase_slice():
    import torch

    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.models.gfnerf import make_render_fn
    from gfnerf_tpu_torch.ops.composite import fused_composite
    from gfnerf_tpu_torch.render_bench import (CHUNK, FRAME_WH, N_VIEWS,
                                               build_workload, frame_rays,
                                               render_camera, render_rays)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    wl = build_workload(dev, seed=0)
    tree, scfg = wl["tree"], wl["scfg"]
    log(f"[slice] workload in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in wl['timings'].items())}):"
        f" {tree.n_nodes} nodes, {int(wl['oct_dev'].n_leaves)} valid leaves, "
        f"{tree.n_volumes} volumes; S={scfg.max_samples}, sample_l "
        f"{scfg.sample_l:.6f}")
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    cams = Cameras.from_numpy(c2w, fx, fy, cx, cy, w, h, device=dev)
    field, oct_dev = wl["field"], wl["oct_dev"]
    render_fn = make_render_fn(wl["mcfg"], scfg)
    fo, fd = frame_rays(c2w[0], *FRAME_WH, dev)
    n_frame = fo.shape[0]
    n_view_chunks = N_VIEWS * -(-(w * h) // CHUNK)
    n_frame_chunks = -(-n_frame // CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the main path, counted ----
    fused_composite.launches = 0
    packed_hash_encode.launches = 0
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
    launches = {"composite_fwd": fused_composite.launches,
                "packed_hash_fwd": packed_hash_encode.launches}
    peak = torch.cuda.max_memory_allocated()

    expected = n_view_chunks + n_frame_chunks
    log(f"[slice] {N_VIEWS} views {w}x{h} in {t_views:.3f}s; frame "
        f"{FRAME_WH[0]}x{FRAME_WH[1]} ({n_frame_chunks} chunks of {CHUNK}) "
        f"in {t_frame:.3f}s = {t_frame:.4f} s/frame, "
        f"{n_frame / t_frame:.1f} rays/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    log(f"[slice] launches {launches}, expected {expected} each")
    for name, n in launches.items():
        if n != expected:
            raise AssertionError(f"{name}: {n} launches on the main path, "
                                 f"expected {expected}")
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
    log(f"[slice] outputs finite, accumulation in [0, 1]; frame rays with "
        f"accumulation > 1e-3: {hit:.4f}; mean rgb "
        f"{frame['rgb'].mean(0).tolist()}")
    if hit <= 0.0:
        raise AssertionError("frame: no ray reached the scene")

    # ---- one chunk through the plain versions ----
    mid = n_frame // 2 - COMPARE_RAYS // 2
    o, d = fo[mid:mid + COMPARE_RAYS], fd[mid:mid + COMPARE_RAYS]
    got = render_fn(field, oct_dev, o, d, 0)
    want = _plain_render(render_fn, field, oct_dev, o, d)
    torch.cuda.synchronize()
    errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
    log(f"[slice] {COMPARE_RAYS}-ray chunk, kernels vs plain versions: max "
        f"abs err {errs} (atol {SLICE_ATOL})")
    for k, e in errs.items():
        if not e <= SLICE_ATOL:
            raise AssertionError(f"slice chunk {k}: kernels vs plain {e}")
    stats = {"s_per_frame": t_frame, "rays_per_s": n_frame / t_frame,
             "peak_bytes": peak}
    return launches, stats, time_encode_on_chunk(wl, fo, fd)


def time_encode_on_chunk(wl, fo, fd) -> dict:
    """The hash encode, kernel and plain version, on the inputs one frame
    chunk gives it: 32768 rays x 384 samples of marched, warped points."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode,
                                                     packed_hash_encode_raw)
    from gfnerf_tpu_torch.models.gfnerf import sample_rays
    from gfnerf_tpu_torch.render_bench import CHUNK
    from gfnerf_tpu_torch.sampler.perssampler import warp_points

    field, oct_dev, scfg = wl["field"], wl["oct_dev"], wl["scfg"]
    c = wl["fcfg"].features_per_level
    mid = (fo.shape[0] - CHUNK) // 2
    with torch.no_grad():
        o, d = fo[mid:mid + CHUNK], fd[mid:mid + CHUNK]
        ones = torch.ones((CHUNK, scfg.max_samples), device=o.device)
        samples = sample_rays(oct_dev, o, d, ones, 1.0, scfg)
        anc = samples.trans_idx.reshape(-1)
        warp = warp_points(oct_dev, anc.clamp(0, oct_dev.w2xz.shape[0] - 1),
                           samples.world_pts.reshape(-1, 3))
        pts = (warp + 1.5) * (1.0 / 3.0)        # as field_density normalizes
        args = (field.global_feat, field.global_prim, field.global_bias, pts,
                anc, c, pack_for_channels(c))
        got = packed_hash_encode(*args)
        want = packed_hash_encode_raw(*args)
        torch.cuda.synchronize()
        assert_close([got], [want], rtol=0, atol=H1_ATOL,
                     what="packed hash on a frame chunk")
        err = max_err([got], [want])
        del got, want
        ms = time_ms(lambda: packed_hash_encode(*args))
        plain_ms = time_ms(lambda: packed_hash_encode_raw(*args), n=3)
    log(f"[slice] packed_hash_fwd on a frame chunk (P={pts.shape[0]}, "
        f"{int((anc >= 0).sum())} valid): max abs err {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


def main() -> int:
    if not (REPO / "gfnerf_tpu_torch").is_dir():
        print("chip_smoke: gfnerf_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    card = phase_device()
    phase_build()
    report = phase_kernels(n_samples=384)
    launches, slice_stats, encode = phase_slice()
    report["packed_hash_fwd"]["max_abs_err"] = max(
        report["packed_hash_fwd"]["max_abs_err"], encode.pop("max_abs_err"))
    report["packed_hash_fwd"].update(encode)
    import torch

    sources = {
        "composite_fwd": ("gfnerf_tpu_torch/csrc/composite_fwd.cu",
                          "gfnerf_tpu/ops/pallas/composite.py:80"),
        "packed_hash_fwd": ("gfnerf_tpu_torch/csrc/packed_hash_fwd.cu",
                            "gfnerf_tpu/fields/packed_hash.py:202"),
    }
    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": rep, "launches": launches[name], **report[name]}
               for name, (src, rep) in sources.items()]
    log(f"[slice] {json.dumps(slice_stats)}")
    log(json.dumps({"kernels": kernels}))
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
