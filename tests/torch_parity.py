"""Shared set-up for the JAX-versus-PyTorch parity tests (tests/test_torch_*).

Builds the tiny scene of tests/test_render_early.py once per process (six
ring cameras, a depth-5 tree), and hands the JAX package and the PyTorch port
the same numpy inputs: the same octree, the same ``init_field_params`` seed,
the same random tables; and runs one train step of either package on the
same batch, march noise and S3IM permutations.  Torch runs on the CPU with
two threads, because the suite runs several pytest-xdist workers side by
side.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

torch.set_num_threads(2)

N_CAMS = 6
IMG_WH = (32, 24)
TREE_KW = dict(max_depth=5, bbox_levels=3, n_rand_pts=512, vis_res_w=16,
               seed=0)


def jax_minimal_parser(data):
    """The JAX package's minimal npz parser with its images named as the
    port's parser names them (image i of ``train.npz`` is ``train.npz#i``):
    the JAX parser names every image after the npz, so its error maps would
    share one file."""
    from gfnerf_tpu.data.dataparsers.minimal_parser import (
        MinimalDataParser, MinimalDataParserConfig)

    class PerImageNames(MinimalDataParser):
        def _generate_dataparser_outputs(self, split="train"):
            out = super()._generate_dataparser_outputs(split)
            out.image_filenames = [f.with_name(f"{f.name}#{i}") for i, f
                                   in enumerate(out.image_filenames)]
            return out

    return PerImageNames(MinimalDataParserConfig(data=data))


def tiny_cameras():
    """(c2w (6, 3, 4), intri (6, 3, 3), bounds (6, 2)) of the tiny scene."""
    from tests.conftest import make_ring_cameras

    c2w, intri = make_ring_cameras(N_CAMS, img_wh=IMG_WH)
    bounds = np.tile(np.array([[0.01, 50.0]], np.float32), (N_CAMS, 1))
    return c2w, intri, bounds


@functools.lru_cache(maxsize=1)
def tiny_tree():
    """The tiny scene's octree, built once by the JAX package's builder."""
    from gfnerf_tpu.sampler.octree import build_octree

    c2w, intri, bounds = tiny_cameras()
    return build_octree(c2w, intri, bounds, **TREE_KW)


def octree_pair(capacity: int = 4096):
    """(JAX OctreeDevice, port OctreeDevice) of the same tree."""
    from gfnerf_tpu.sampler.perssampler import octree_to_device as jax_upload
    from gfnerf_tpu_torch.sampler.perssampler import octree_to_device

    tree = tiny_tree()
    return jax_upload(tree, capacity), octree_to_device(tree, capacity,
                                                         device="cpu")


def tiny_rays(n_rays: int = 64, seed: int = 3):
    """Rays from four of the cameras toward the scene, jittered (numpy)."""
    c2w, _, _ = tiny_cameras()
    rng = np.random.default_rng(seed)
    o = np.repeat(c2w[:4, :, 3], n_rays // 4, axis=0).astype(np.float32)
    d = -o / np.linalg.norm(o, axis=-1, keepdims=True)
    o = o + rng.normal(0, 0.05, o.shape).astype(np.float32)
    d = d + rng.normal(0, 0.08, d.shape).astype(np.float32)
    d = (d / np.linalg.norm(d, axis=-1, keepdims=True)).astype(np.float32)
    return o, d


def field_kwargs(**over):
    """FieldConfig arguments of the tiny packed field."""
    kw = dict(num_images=N_CAMS, n_volumes=tiny_tree().n_volumes,
              num_levels=4, features_per_level=4, hash_layout="packed",
              packed_rows_log2=10, n_blocks=2, hidden_dim=32,
              hidden_dim_color=32)
    kw.update(over)
    return kw


def field_pair(seed: int = 0, table_scale: float = 0.5,
               block_scale: float = 0.0, **over):
    """The same field in both packages.

    Both start from ``init_field_params(seed)``; with ``table_scale`` > 0
    the global table is then replaced, in both, by one numpy draw of
    uniform(-table_scale, table_scale), so renders are not near-constant;
    with ``block_scale`` > 0 the block tables likewise, so the blocks
    differ.  Returns (jax_cfg, jax_params, jax_statics, port_field).
    """
    import jax.numpy as jnp

    from gfnerf_tpu.fields.field import FieldConfig as JaxFieldConfig
    from gfnerf_tpu.fields.field import init_field_params as jax_init
    from gfnerf_tpu_torch.fields.field import FieldConfig, params_from_jax

    kw = field_kwargs(**over)
    jcfg = JaxFieldConfig(**kw)
    params, statics = jax_init(jcfg, seed=seed)
    if table_scale > 0:
        rng = np.random.default_rng(seed + 100)
        table = rng.uniform(-table_scale, table_scale,
                            params.global_feat.shape).astype(np.float32)
        params = params.replace(global_feat=jnp.asarray(table))
    if block_scale > 0:
        rng = np.random.default_rng(seed + 200)
        tables = rng.uniform(-block_scale, block_scale,
                             params.block_feats.shape).astype(np.float32)
        params = params.replace(block_feats=jnp.asarray(tables))
    field = params_from_jax(params, statics, FieldConfig(**kw),
                            device="cpu")
    return jcfg, params, statics, field


def to_np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def asdict_np(obj) -> dict:
    """Fields of a dataclass as numpy arrays (None kept)."""
    return {f.name: (None if getattr(obj, f.name) is None
                     else np.asarray(to_np(getattr(obj, f.name))))
            for f in dataclasses.fields(obj)}


# ---- sample batches for model_forward in either package ----


def samples_np(valid, n_volumes, seed=0):
    """Samples (numpy) as tests/test_compaction.py makes them: world points
    in [-0.5, 0.5], dt 0.01, anchors (a random volume) where valid, else
    -1."""
    r, s = valid.shape
    rng = np.random.default_rng(seed)
    anc = rng.integers(0, n_volumes, (r, s))
    return {
        "world_pts": rng.uniform(-0.5, 0.5, (r, s, 3)).astype(np.float32),
        "dists": np.full((r, s), 0.01, np.float32),
        "ts": np.cumsum(np.full((r, s), 0.01, np.float32), axis=1),
        "trans_idx": np.where(valid, anc, -1),
        "valid": valid,
        "first_oct_dis": np.zeros(r, np.float32),
    }


def marched_np(n_rays=32, s=64, seed=3):
    """The port's march of the tiny scene's rays (``tiny_rays(n_rays,
    seed)``, eval noise) as numpy samples, and the rays' directions."""
    from gfnerf_tpu_torch.models.gfnerf import sample_rays
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    _, toct = octree_pair()
    o, d = tiny_rays(n_rays=n_rays, seed=seed)
    smp = sample_rays(toct, torch.as_tensor(o), torch.as_tensor(d),
                      torch.ones((n_rays, s)), 1.0,
                      SamplerConfig(max_samples=s, sample_l=1.0 / 64))
    return {k: to_np(getattr(smp, k)) for k in
            ("world_pts", "dists", "ts", "trans_idx", "valid",
             "first_oct_dis")}, d


def jax_samples(x):
    """Numpy samples as the JAX package's WarpedSamples (``warp_pts`` zero
    unless ``x`` has them: then the model warps, ``warp_deferred``)."""
    import jax.numpy as jnp
    from gfnerf_tpu.cameras.rays import WarpedSamples

    r, s = x["valid"].shape
    z = jnp.zeros((r, s), jnp.int32)
    return WarpedSamples(
        world_pts=jnp.asarray(x["world_pts"]),
        warp_pts=jnp.asarray(x.get("warp_pts", np.zeros((r, s, 3),
                                                        np.float32))),
        dists=jnp.asarray(x["dists"]),
        ts=jnp.asarray(x["ts"]),
        trans_idx=jnp.asarray(x["trans_idx"], jnp.int32), oct_idx=z,
        block_idx=z, valid=jnp.asarray(x["valid"]),
        num_valid=jnp.asarray(x["valid"].sum(1), jnp.int32),
        first_oct_dis=jnp.asarray(x["first_oct_dis"]))


def port_samples(x):
    """Numpy samples as the port's WarpedSamples."""
    from gfnerf_tpu_torch.cameras.rays import WarpedSamples

    r, s = x["valid"].shape
    z = torch.zeros((r, s), dtype=torch.int64)
    valid = torch.as_tensor(x["valid"])
    return WarpedSamples(
        world_pts=torch.as_tensor(x["world_pts"]),
        dists=torch.as_tensor(x["dists"]), ts=torch.as_tensor(x["ts"]),
        trans_idx=torch.as_tensor(x["trans_idx"]).long(), oct_idx=z,
        block_idx=z, valid=valid, num_valid=valid.sum(1),
        first_oct_dis=torch.as_tensor(x["first_oct_dis"]),
        warp_pts=(torch.as_tensor(x["warp_pts"]) if "warp_pts" in x
                  else None))


# ---- one train step of either package on the tiny scene ----

TRAIN_R = 128
TRAIN_S = 64
TRAIN_SAMPLE_L = 1.0 / 32


def train_batch(seed=0):
    """A numpy batch of TRAIN_R random pixels with random colours."""
    rng = np.random.default_rng(seed)
    w, h = IMG_WH
    ki = rng.integers(0, N_CAMS, TRAIN_R).astype(np.int32)
    coords = np.stack([rng.integers(0, h, TRAIN_R) + 0.5,
                       rng.integers(0, w, TRAIN_R) + 0.5], -1
                      ).astype(np.float32)
    image = rng.uniform(0.2, 0.9, (TRAIN_R, 3)).astype(np.float32)
    return {"camera_indices": ki, "rel_camera_indices": ki,
            "coords": coords, "image": image}


def train_cameras_np():
    from tests.conftest import make_ring_cameras

    c2w, intri = make_ring_cameras(N_CAMS, img_wh=IMG_WH)
    return (c2w, intri[:, 0, 0], intri[:, 1, 1], intri[:, 0, 2],
            intri[:, 1, 2])


def jax_train_step(jcfg, params, statics, joct, batch, mkw, key_seed,
                   stage=0, active_block=0, state=None, march="fast"):
    """One jitted JAX train step at ``stage``, from ``state`` (a fresh one
    of ``params`` if None), marching with ``march``.  Returns its outputs (state, octree, metrics,
    per-ray error), and the march noise and S3IM permutations it drew."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.data.dataparsers.base import CamerasHost
    from gfnerf_tpu.engine.optimizers import (OptimizersConfig,
                                              build_optimizer, optimizer_arg)
    from gfnerf_tpu.models.gfnerf import (GFNeRFModelConfig, TrainState,
                                          make_train_step)
    from gfnerf_tpu.sampler.perssampler import SamplerConfig

    c2w, fx, fy, cx, cy = train_cameras_np()
    w, h = IMG_WH
    cams = CamerasHost(camera_to_worlds=c2w, fx=fx, fy=fy, cx=cx, cy=cy,
                       width=np.full(N_CAMS, w, np.int32),
                       height=np.full(N_CAMS, h, np.int32)).to_device()
    tx = build_optimizer(OptimizersConfig(), params)
    if state is None:
        state = TrainState(params=params,
                           opt_state=tx.init(optimizer_arg(params)),
                           step=jnp.asarray(0, jnp.int32))
    mcfg = GFNeRFModelConfig(n_blocks=2, **mkw)
    step = make_train_step(jcfg, mcfg,
                           SamplerConfig(max_samples=TRAIN_S,
                                         sample_l=TRAIN_SAMPLE_L,
                                         march=march),
                           tx, stage)
    key = jax.random.PRNGKey(key_seed)
    out = step(state, statics, joct, cams,
               {k: jnp.asarray(v) for k, v in batch.items()},
               jnp.asarray(1.0, jnp.float32),
               jnp.asarray(active_block, jnp.int32), key)
    # the step's own draws (gfnerf.py:512-514, losses.py:70-73)
    k_noise, k_s3im, _ = jax.random.split(key, 3)
    noise = (jax.random.uniform(k_noise, (TRAIN_R, TRAIN_S)) - 0.5) + 1.0
    perms = [jax.random.permutation(k, TRAIN_R) for k in
             jax.random.split(k_s3im, mcfg.s3im_repeat_time - 1)]
    return out, np.array(noise), np.stack([np.asarray(p) for p in perms])


def jax_prop_u(key_seed, n_resamples, r=TRAIN_R):
    """The proposal resampling's uniform draws (r, n_resamples + 1) of the
    JAX train step with key ``key_seed`` (its third stream,
    gfnerf.py:512, ray_samplers.py:86)."""
    import jax

    k_prop = jax.random.split(jax.random.PRNGKey(key_seed), 3)[2]
    return np.array(jax.random.uniform(k_prop, (r, n_resamples + 1)))


def port_train_step(field, toct, batch, mkw, noise, perms, stage=0,
                    active_block=0, state=None, prop_u=None, march="fast"):
    """One train step of the port at ``stage`` on the CPU, from ``state``
    (a fresh one of ``field`` if None), with the given noise and
    permutations (drawn by the step where ``perms`` is None; and, on the
    proposal branch, resampling draws), marching with ``march``."""
    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer)
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                init_train_state,
                                                make_train_step)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    w, h = IMG_WH
    cams = Cameras.from_numpy(*train_cameras_np(), w, h, device="cpu")
    tx = build_optimizer(OptimizersConfig())
    if state is None:
        state = init_train_state(field, tx)
    step = make_train_step(GFNeRFModelConfig(**mkw),
                           SamplerConfig(max_samples=TRAIN_S,
                                         sample_l=TRAIN_SAMPLE_L,
                                         march=march),
                           tx, stage)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    for k in ("camera_indices", "rel_camera_indices"):
        tb[k] = tb[k].long()
    return step(state, toct, cams, tb, 1.0, noise=torch.as_tensor(noise),
                s3im_perms=(None if perms is None
                            else torch.as_tensor(perms).long()),
                active_block=active_block,
                prop_u=None if prop_u is None else torch.as_tensor(prop_u))


def jax_groups(tree):
    """A JAX FieldParams-shaped tree as the port's group lists (the
    semantics heads and the camera tangents where the tree has them)."""
    semantics = [] if tree.mlp_semantics is None else [
        *tree.mlp_semantics["w"], *tree.mlp_semantics["b"],
        *tree.semantics_head["w"], *tree.semantics_head["b"]]
    probe = [] if tree.prop_feat is None else [
        tree.prop_feat, *tree.prop_net["w"], *tree.prop_net["b"]]
    groups = {
        "fields": [*tree.base_net["w"], *tree.base_net["b"],
                   *tree.mlp_head["w"], *tree.mlp_head["b"],
                   tree.appearance_embedding, *semantics, *probe],
        "base_encoding_init": [tree.global_feat],
    }
    if tree.camera_adjustment is not None:
        groups["camera_opt"] = [tree.camera_adjustment]
    return groups


def scan_coverage_case(path) -> dict:
    """The scan against the fast march on the octree and rays that
    ``chip_smoke.py --coverage-case PATH`` wrote from the card: the JAX
    package's pair and the port's plain pair, each on the CPU with the
    case's sampler config (1024 slots, eval noise), measured by
    ``chip_smoke.coverage_figures``.  Returns {"card": ..., "jax": ...,
    "port_cpu": ...}."""
    import json
    import sys
    from pathlib import Path

    import jax.numpy as jnp

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from chip_smoke import coverage_figures
    from gfnerf_tpu.sampler import perssampler as J
    from gfnerf_tpu.sampler.fast_march import get_samples_fast as jax_fast
    from gfnerf_tpu_torch.sampler import perssampler as T
    from gfnerf_tpu_torch.sampler.fast_march import get_samples_fast

    case = np.load(path)
    cfg = json.loads(str(case["sampler_config"]))
    tables = {k[4:]: case[k] for k in case.files if k.startswith("oct_")}
    o, d = case["rays_o"], case["rays_d"]
    noise = np.ones((o.shape[0], cfg["max_samples"]), np.float32)
    keys = ("valid", "ts", "oct_idx", "first_oct_dis")

    def host(x):
        return {k: np.asarray(getattr(x, k)) for k in keys}

    joct = J.OctreeDevice(**{k: jnp.asarray(v) for k, v in tables.items()})
    jcfg = J.SamplerConfig(**cfg)
    jo, jd, jn = jnp.asarray(o), jnp.asarray(d), jnp.asarray(noise)
    out = {"card": json.loads(str(case["card"]))}
    out["jax"] = coverage_figures(
        host(jax_fast(joct, jo, jd, jn, jnp.asarray(1.0),
                      dataclasses.replace(jcfg, march="fast"))),
        host(J.get_samples(joct, jo, jd, jn,
                           dataclasses.replace(jcfg, march="scan"))))
    toct = T.OctreeDevice(**{
        k: (int(v) if v.ndim == 0 else torch.as_tensor(v))
        for k, v in tables.items()})
    tcfg = T.SamplerConfig(**cfg)
    to, td, tn = (torch.as_tensor(x) for x in (o, d, noise))
    with torch.no_grad():
        out["port_cpu"] = coverage_figures(
            host(get_samples_fast(toct, to, td, tn, 1.0,
                                  dataclasses.replace(tcfg, march="fast"))),
            host(T.get_samples(toct, to, td, tn,
                               dataclasses.replace(tcfg, march="scan"))))
    return out


if __name__ == "__main__":
    # python tests/torch_parity.py scan-coverage CASE.npz
    import json
    import sys

    if sys.argv[1:2] != ["scan-coverage"] or len(sys.argv) != 3:
        sys.exit("usage: python tests/torch_parity.py scan-coverage CASE.npz")
    for name, figures in scan_coverage_case(sys.argv[2]).items():
        print(name, json.dumps(figures))
