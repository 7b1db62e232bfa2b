"""Method registry.

Port of ``gfnerf_tpu/configs/method_configs.py`` for the GF-NeRF methods
whose paths are ported: ``gf-nerf`` (the paper's defaults), ``gf-nerf-tiny``
(smoke tests), ``gf-nerf-perf`` (packed supercell tables, 8 levels x 4
channels, bf16 MLPs, 160 march slots) and ``gf-nerf-prop`` (``gf-nerf-perf``
with proposal-guided resampling: a 256-slot march feeds the probe, whose
weights resample 64 fine samples a ray), and on the vanilla pipeline
``nerfacto``, ``semantic-nerfw``, ``instant-ngp``, ``mipnerf``,
``tensorf``, ``neus``, ``vanilla-nerf``, ``nerfplayer-nerfacto`` and
``nerfplayer-ngp`` with the JAX package's settings: all 13 of its
methods.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict

from gfnerf_tpu_torch.data.datamanager import GFNerfDataManagerConfig
from gfnerf_tpu_torch.engine.optimizers import OptimizersConfig
from gfnerf_tpu_torch.engine.trainer import TrainerConfig
from gfnerf_tpu_torch.models.gfnerf import GFNeRFModelConfig
from gfnerf_tpu_torch.pipelines.pipeline import GFNerfPipelineConfig
from gfnerf_tpu_torch.pipelines.vanilla_pipeline import VanillaPipelineConfig
from gfnerf_tpu_torch.sampler.manager import PersSamplerManagerConfig

# the JAX package's registered methods that have no port yet
NOT_PORTED = ()

# the entry-point group a package names its methods in (its
# ``entry_points.txt``: ``[gfnerf_tpu_torch.method_configs]`` then ``name =
# module:attribute``, the attribute a MethodSpecification or a callable
# returning one)
ENTRY_POINT_GROUP = "gfnerf_tpu_torch.method_configs"


@dataclasses.dataclass
class MethodSpecification:
    """A method registered by another package (nerfstudio's
    ``plugins/types.py``)."""

    config: TrainerConfig
    description: str = ""


def gf_nerf_config() -> TrainerConfig:
    """The paper method, defaults from gfnerf/config.py:43-148."""
    n_blocks = 10
    n_split_dataset = 10
    n_dataset_circles = 1
    steps_init = 30000
    steps_per_split = 10000
    return TrainerConfig(
        method_name="gf-nerf",
        steps_per_eval_batch=1000,
        steps_per_save=2000,
        max_num_iterations=steps_init
        + n_dataset_circles * steps_per_split * n_split_dataset,
        pipeline=GFNerfPipelineConfig(
            datamanager=GFNerfDataManagerConfig(
                n_split_dataset=n_split_dataset,
                steps_per_split_dataset=steps_per_split,
                steps_perssampler_init=steps_init,
                train_num_rays_per_batch=2048 * 4,
                eval_num_rays_per_batch=2048,
                train_num_images_to_sample_from=500,
                train_num_times_to_repeat_images=1000,
                patch_size=1,
            ),
            model=GFNeRFModelConfig(
                n_blocks=n_blocks,
                n_split_dataset=n_split_dataset,
                steps_per_split_dataset=steps_per_split,
                steps_perssampler_init=steps_init,
                scale_factor=10.0,
                s3im_patch_height=32,
                background_color="black",
            ),
            sampler=PersSamplerManagerConfig(),
            optimizers=OptimizersConfig(
                fields_lr_init=1e-2,
                fields_lr_final=1e-4,
                steps_perssampler_init=steps_init,
                steps_per_split_dataset=steps_per_split,
                n_split_dataset=n_split_dataset,
                n_dataset_circles=n_dataset_circles,
            ),
            field_log2_hashmap_size=21,
            field_num_levels=16,
            field_hidden_dim=128,
            field_hidden_dim_color=128,
            eval_num_rays_per_chunk=2048,
        ),
    )


def gf_nerf_tiny_config() -> TrainerConfig:
    """Shrunk config for smoke tests and small scenes."""
    cfg = gf_nerf_config()
    cfg.method_name = "gf-nerf-tiny"
    cfg.max_num_iterations = 30
    p = cfg.pipeline
    p.datamanager.train_num_rays_per_batch = 256
    p.datamanager.eval_num_rays_per_batch = 256
    p.datamanager.n_split_dataset = 2
    p.datamanager.steps_per_split_dataset = 10
    p.datamanager.steps_perssampler_init = 10
    p.model.n_blocks = 2
    p.model.n_split_dataset = 2
    p.model.steps_per_split_dataset = 10
    p.model.steps_perssampler_init = 10
    p.model.s3im_patch_height = 16
    p.model.scale_factor = 1.0
    p.sampler.bbox_levels = 4
    p.sampler.max_level = 6
    p.sampler.max_samples = 64
    p.sampler.sample_l = 1.0 / 32
    p.sampler.sub_div_milestones = (4, 8)
    p.sampler.compact_freq = 10
    p.sampler.node_capacity = 16384
    p.sampler.n_rand_pts = 512
    p.sampler.vis_res_w = 32
    p.sampler.ray_march_fineness_decay_end_iter = 10
    p.field_log2_hashmap_size = 12
    p.eval_num_rays_per_chunk = 512
    p.optimizers.steps_perssampler_init = 10
    p.optimizers.steps_per_split_dataset = 10
    p.optimizers.n_split_dataset = 2
    cfg.steps_per_eval_batch = 10
    cfg.steps_per_eval_image = 10 ** 9
    cfg.steps_per_save = 10 ** 9
    return cfg


def gf_nerf_perf_config() -> TrainerConfig:
    """Throughput-tuned gf-nerf: supercell-packed hash tables, 8 levels x 4
    channels of 2^15 rows of 128, bf16 MLPs, and the march at the sample
    budget (160 slots, so that no compaction runs)."""
    cfg = gf_nerf_config()
    cfg.method_name = "gf-nerf-perf"
    p = cfg.pipeline
    p.field_num_levels = 8
    p.field_features_per_level = 4
    p.field_hash_layout = "packed"
    p.field_mlp_dtype = "bfloat16"
    p.field_packed_rows_log2 = 15
    p.model.samples_budget_per_ray = 160
    p.sampler.max_samples = 160
    # the JAX package's K steps per dispatch; the port runs one step per
    # dispatch (the pipeline says so once)
    p.steps_per_dispatch = 8
    return cfg


def gf_nerf_prop_config() -> TrainerConfig:
    """``gf-nerf-perf`` with proposal-guided resampling: the probe's weights
    on a dense 256-slot march (the budget equals the slots, so nothing is
    compacted) importance-resample 64 fine samples a ray for the main
    field."""
    cfg = gf_nerf_perf_config()
    cfg.method_name = "gf-nerf-prop"
    p = cfg.pipeline
    p.field_use_proposal = True
    p.model.num_proposal_resamples = 64
    p.sampler.max_samples = 256
    p.model.samples_budget_per_ray = 256
    return cfg


def nerfacto_config() -> TrainerConfig:
    """Stock nerfacto: the proposal sampler and a hash field."""
    return TrainerConfig(
        method_name="nerfacto",
        max_num_iterations=30000,
        steps_per_eval_image=5000,
        steps_per_save=2000,
        pipeline=VanillaPipelineConfig(model_kind="nerfacto",
                                       train_num_rays_per_batch=4096),
    )


def semantic_nerfw_config() -> TrainerConfig:
    """Semantic NeRF-W: nerfacto, a semantics head and its
    cross-entropy."""
    return TrainerConfig(
        method_name="semantic-nerfw",
        max_num_iterations=30000,
        steps_per_eval_image=5000,
        steps_per_save=2000,
        pipeline=VanillaPipelineConfig(model_kind="semantic-nerfw",
                                       train_num_rays_per_batch=4096),
    )


def instant_ngp_config() -> TrainerConfig:
    """Instant-NGP: a hash field sampled through an occupancy grid."""
    return TrainerConfig(
        method_name="instant-ngp",
        max_num_iterations=30000,
        steps_per_eval_image=5000,
        steps_per_save=2000,
        pipeline=VanillaPipelineConfig(model_kind="instant-ngp",
                                       train_num_rays_per_batch=4096),
    )


def nerfplayer_nerfacto_config() -> TrainerConfig:
    """NeRFPlayer on the nerfacto pipeline: time-conditioned temporal grids
    and the temporal TV term."""
    return TrainerConfig(
        method_name="nerfplayer-nerfacto",
        max_num_iterations=30000,
        steps_per_eval_image=5000,
        steps_per_save=2000,
        pipeline=VanillaPipelineConfig(model_kind="nerfplayer-nerfacto",
                                       train_num_rays_per_batch=4096),
    )


def nerfplayer_ngp_config() -> TrainerConfig:
    """NeRFPlayer on the instant-ngp pipeline: an occupancy grid updated at
    random times and a temporal field."""
    return TrainerConfig(
        method_name="nerfplayer-ngp",
        max_num_iterations=30000,
        steps_per_eval_image=5000,
        steps_per_save=2000,
        pipeline=VanillaPipelineConfig(model_kind="nerfplayer-ngp",
                                       train_num_rays_per_batch=4096),
    )


def mipnerf_config() -> TrainerConfig:
    """mip-NeRF: the integrated positional encoding over conical
    frustums."""
    return TrainerConfig(
        method_name="mipnerf",
        max_num_iterations=100000,
        steps_per_eval_image=10000,
        steps_per_save=5000,
        pipeline=VanillaPipelineConfig(model_kind="mipnerf",
                                       train_num_rays_per_batch=1024,
                                       lr_init=5e-4, lr_final=5e-6,
                                       max_steps=100000),
    )


def tensorf_config() -> TrainerConfig:
    """TensoRF with the vector-matrix factorization."""
    return TrainerConfig(
        method_name="tensorf",
        max_num_iterations=30000,
        steps_per_eval_image=5000,
        steps_per_save=2000,
        pipeline=VanillaPipelineConfig(model_kind="tensorf",
                                       train_num_rays_per_batch=4096,
                                       lr_init=2e-2, lr_final=2e-3),
    )


def neus_config() -> TrainerConfig:
    """NeuS surface reconstruction: an SDF field and the eikonal term."""
    return TrainerConfig(
        method_name="neus",
        max_num_iterations=100000,
        steps_per_eval_image=10000,
        steps_per_save=5000,
        pipeline=VanillaPipelineConfig(model_kind="neus",
                                       train_num_rays_per_batch=1024,
                                       lr_init=5e-4, lr_final=2.5e-5,
                                       max_steps=100000),
    )


def vanilla_nerf_config() -> TrainerConfig:
    """The original NeRF: the frequency encoding, coarse and fine MLPs."""
    return TrainerConfig(
        method_name="vanilla-nerf",
        max_num_iterations=100000,
        steps_per_eval_image=10000,
        steps_per_save=5000,
        pipeline=VanillaPipelineConfig(model_kind="vanilla-nerf",
                                       train_num_rays_per_batch=1024,
                                       lr_init=5e-4, lr_final=5e-5,
                                       max_steps=100000),
    )


method_configs: Dict[str, Callable[[], TrainerConfig]] = {
    "gf-nerf": gf_nerf_config,
    "gf-nerf-tiny": gf_nerf_tiny_config,
    "gf-nerf-perf": gf_nerf_perf_config,
    "gf-nerf-prop": gf_nerf_prop_config,
    "nerfacto": nerfacto_config,
    "semantic-nerfw": semantic_nerfw_config,
    "instant-ngp": instant_ngp_config,
    "mipnerf": mipnerf_config,
    "tensorf": tensorf_config,
    "neus": neus_config,
    "vanilla-nerf": vanilla_nerf_config,
    "nerfplayer-nerfacto": nerfplayer_nerfacto_config,
    "nerfplayer-ngp": nerfplayer_ngp_config,
}

descriptions = {
    "gf-nerf": "Global-guided Focal NeRF (two-stage).",
    "gf-nerf-tiny": "Shrunk gf-nerf for smoke tests.",
    "gf-nerf-perf": "Throughput-tuned gf-nerf (8 levels x 4 channels).",
    "nerfacto": "Proposal-sampler + hash-field model (nerfstudio nerfacto).",
    "instant-ngp": "Hash field + occupancy-grid sampler (instant-ngp).",
    "mipnerf": "mip-NeRF (integrated positional encoding, coarse/fine).",
    "tensorf": "TensoRF (vector-matrix factorized field).",
    "neus": "NeuS surface reconstruction (SDF field + eikonal).",
    "vanilla-nerf": "Original NeRF (frequency encoding, coarse/fine MLPs).",
}


def discover_methods() -> Dict[str, Callable[[], TrainerConfig]]:
    """The registered methods and those other packages name in the
    ``ENTRY_POINT_GROUP`` entry points (plugins/registry.py:34-50); a
    plugin's method is a shallow copy of its spec's config.  A plugin
    that fails to load prints a line and leaves the registry as it is."""
    methods = dict(method_configs)
    try:
        from importlib.metadata import entry_points

        for ep in entry_points(group=ENTRY_POINT_GROUP):
            spec = ep.load()
            if callable(spec) and not isinstance(spec, MethodSpecification):
                spec = spec()
            if isinstance(spec, MethodSpecification):
                methods[spec.config.method_name] = (
                    lambda s=spec: dataclasses.replace(s.config))
                descriptions[spec.config.method_name] = spec.description
    except Exception as e:
        print(f"[plugins] discovery failed: {e}")
    return methods


def get_method(name: str) -> TrainerConfig:
    """A fresh config of the registered method ``name``."""
    if name in NOT_PORTED:
        raise NotImplementedError(f"method {name!r} is not ported; ported: "
                                  f"{sorted(method_configs)}")
    if name not in method_configs:
        raise KeyError(f"unknown method {name!r}; available: "
                       f"{sorted(method_configs)}")
    return method_configs[name]()
