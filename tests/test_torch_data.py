"""The port's configs and data layer against the JAX package's, on the CPU.

- ``make_synthetic_npz``, the minimal parser, ``InputDataset``,
  ``ImageCache`` (with a resampled subset and with error maps),
  ``PixelSampler`` (uniform and patches), ``ErrorPixelSampler`` and the
  datamanager (init batches, a focal split with error maps and
  ``focal_uniform_fraction``'s mixed rays, eval batches and images): equal
  arrays for the same seeds; all of it is numpy in both packages.
- ``apply_override`` and the JSON round trip of a config.
- The four gf-nerf method configs: every field that both packages' config
  classes have holds the same value, and every JAX field is the port's
  but the listed few (``JAX_ONLY_FIELDS``).
- The eval metrics: ``compute_ssim`` equal, the LPIPS proxy to 1e-5.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)


@pytest.fixture(scope="module")
def scenes(tmp_path_factory):
    """The same scene written by either package."""
    from gfnerf_tpu.utils.synthetic import make_synthetic_npz as jax_make
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    jdir = jax_make(tmp_path_factory.mktemp("jax"), n_train=10, n_val=2,
                    img_wh=(24, 16), seed=3)
    tdir = make_synthetic_npz(tmp_path_factory.mktemp("port"), n_train=10,
                              n_val=2, img_wh=(24, 16), seed=3)
    return jdir, tdir


def parsers(scenes):
    """(the JAX parser with the port's image names, the port's parser)."""
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser

    jdir, tdir = scenes
    return (torch_parity.jax_minimal_parser(jdir),
            build_dataparser("minimal", tdir))


def assert_batches_equal(got: dict, want: dict):
    keys = [k for k in want if not k.startswith("_")]
    assert sorted(k for k in got if not k.startswith("_")) == sorted(keys)
    for k in keys:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)


def test_synthetic_scene_and_parser(scenes):
    jdir, tdir = scenes
    for split in ("train", "val"):
        a, b = np.load(jdir / f"{split}.npz"), np.load(tdir / f"{split}.npz")
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jp, tp = parsers(scenes)
    for split in ("train", "val"):
        jo = jp.get_dataparser_outputs(split)
        to = tp.get_dataparser_outputs(split)
        for f in ("camera_to_worlds", "fx", "fy", "cx", "cy", "width",
                  "height"):
            np.testing.assert_array_equal(getattr(to.cameras, f),
                                          getattr(jo.cameras, f), err_msg=f)
        np.testing.assert_array_equal(to.cameras.intrinsics_matrices(),
                                      jo.cameras.intrinsics_matrices())
        np.testing.assert_array_equal(to.scene_box.aabb, jo.scene_box.aabb)
        np.testing.assert_array_equal(to.metadata["images_array"],
                                      jo.metadata["images_array"])
        assert (to.metadata["global_image_indices"]
                == jo.metadata["global_image_indices"])
        # a name of its own for each image (and so for its error map)
        assert [Path(f).name for f in to.image_filenames] == \
            [f"{split}.npz#{i}" for i in range(len(to.image_filenames))]
        assert [Path(f).name for f in to.image_filenames] == \
            [Path(f).name for f in jo.image_filenames]
        sel = [1, 0]
        np.testing.assert_array_equal(
            to.select(sel).cameras.camera_to_worlds,
            jo.select(sel).cameras.camera_to_worlds)
        assert (to.select(sel).metadata["global_image_indices"]
                == jo.select(sel).metadata["global_image_indices"])
        cams = to.cameras.to_device("cpu")
        np.testing.assert_array_equal(cams.camera_to_worlds.numpy(),
                                      jo.cameras.camera_to_worlds)
        assert cams.width.dtype == torch.int32


def _error_map_dir(tmp_path, outputs, seed=0):
    """One random error map per image file, as the pipelines write them."""
    rng = np.random.default_rng(seed)
    npy = tmp_path / "npy"
    npy.mkdir()
    h, w = outputs.metadata["images_array"].shape[1:3]
    for f in outputs.image_filenames:
        np.save(npy / (Path(f).name + ".npy"),
                rng.random((h, w)).astype(np.float32))
    return tmp_path


@pytest.mark.parametrize("subset", [-1, 4])
def test_dataset_cache_and_samplers(scenes, tmp_path, subset):
    from gfnerf_tpu.data.dataset import ImageCache as JaxCache
    from gfnerf_tpu.data.dataset import InputDataset as JaxDataset
    from gfnerf_tpu.data.pixel_samplers import (
        ErrorPixelSampler as JaxErrorSampler)
    from gfnerf_tpu.data.pixel_samplers import PixelSampler as JaxSampler
    from gfnerf_tpu_torch.data.dataset import ImageCache, InputDataset
    from gfnerf_tpu_torch.data.pixel_samplers import (ErrorPixelSampler,
                                                      PixelSampler)

    jp, tp = parsers(scenes)
    jo, to = jp.get_dataparser_outputs("train"), tp.get_dataparser_outputs(
        "train")
    err_dir = _error_map_dir(tmp_path, to)
    files = [err_dir / "npy" / (Path(f).name + ".npy")
             for f in to.image_filenames]
    jo.metadata["error_map_filenames"] = files
    to.metadata["error_map_filenames"] = files
    jd, td = JaxDataset(jo), InputDataset(to)
    for i in (0, 7):
        want, got = jd.get_data(i), td.get_data(i)
        assert sorted(got) == sorted(k for k in want if k != "road_mask")
        for k in got:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)

    jc = JaxCache(jd, num_images_to_sample_from=subset,
                  num_times_to_repeat=2, seed=5)
    tc = ImageCache(td, num_images_to_sample_from=subset,
                    num_times_to_repeat=2, seed=5)
    samplers = [(JaxSampler(64, seed=1), PixelSampler(64, seed=1)),
                (JaxSampler(64, patch_size=3, seed=2),
                 PixelSampler(64, patch_size=3, seed=2)),
                (JaxErrorSampler(64, seed=3), ErrorPixelSampler(64, seed=3))]
    for _ in range(3):   # the subset is resampled every 2 steps
        jc.step()
        tc.step()
        for name in ("indices", "images", "rel_camera_idx", "error_maps"):
            np.testing.assert_array_equal(getattr(tc, name),
                                          getattr(jc, name), err_msg=name)
        for js, ts in samplers:
            assert_batches_equal(ts.sample(tc), js.sample(jc))
    idx = np.array([[0, 1, 2], [1, 3, 4]])
    vals = np.array([0.25, 0.5], np.float32)
    jc.update_error_map(idx, vals)
    tc.update_error_map(idx, vals)
    np.testing.assert_array_equal(tc.error_maps, jc.error_maps)
    assert tc.error_maps[1, 3, 4] == 0.5


def test_datamanager(scenes, tmp_path):
    from gfnerf_tpu.data.datamanager import GFNerfDataManager as JaxDM
    from gfnerf_tpu.data.datamanager import (
        GFNerfDataManagerConfig as JaxDMConfig)
    from gfnerf_tpu_torch.data.datamanager import (GFNerfDataManager,
                                                   GFNerfDataManagerConfig)

    kw = dict(train_num_rays_per_batch=96, eval_num_rays_per_batch=40,
              steps_perssampler_init=3, max_init_images=7,
              train_num_images_to_sample_from=5,
              train_num_times_to_repeat_images=3,
              focal_uniform_fraction=0.25)
    jp, tp = parsers(scenes)
    jdm = JaxDM(JaxDMConfig(**kw), jp, seed=11)
    tdm = GFNerfDataManager(GFNerfDataManagerConfig(**kw), tp, seed=11)
    for step in range(3):
        assert_batches_equal(tdm.next_train(step), jdm.next_train(step))
    labels = np.arange(10) % 3
    sample_tmp = _error_map_dir(tmp_path, tdm.train_dataparser_outputs)
    for split, steps in ((1, range(3, 6)), (2, range(6, 8))):
        jdm.setup_train_split_oct(labels, split, str(sample_tmp))
        tdm.setup_train_split_oct(labels, split, str(sample_tmp))
        for step in steps:
            got, want = tdm.next_train(step), jdm.next_train(step)
            assert_batches_equal(got, want)
            assert int(got["n_split_rays"]) == 96 - 24
            assert got["_cache"].error_maps is not None
    for step in range(2):
        assert_batches_equal(tdm.next_eval(step), jdm.next_eval(step))
    ti, td = tdm.next_eval_image(3)
    ji, jd = jdm.next_eval_image(3)
    assert ti == ji
    np.testing.assert_array_equal(td["image"], jd["image"])


def _fields(obj, prefix=""):
    """{dotted name: value} of a nested config dataclass's leaves."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_fields(v, f"{prefix}{f.name}."))
        else:
            out[prefix + f.name] = v
    return out


# the JAX config field the port leaves out: mixed precision (the JAX
# trainer's, which nothing reads; the perf methods' bf16 MLPs are the
# field's ``mlp_dtype``)
JAX_ONLY_FIELDS = {"mixed_precision"}


@pytest.mark.parametrize("method", ["gf-nerf", "gf-nerf-tiny",
                                    "gf-nerf-perf", "gf-nerf-prop"])
def test_method_configs_match_jax(method):
    from gfnerf_tpu.configs.method_configs import method_configs
    from gfnerf_tpu_torch.configs.method_configs import get_method

    got, want = _fields(get_method(method)), _fields(method_configs[method]())
    shared = sorted(set(got) & set(want) - {"vis"})
    assert len(shared) > 60
    for k in shared:
        assert got[k] == want[k], (k, got[k], want[k])
    # every JAX field but the listed ones is the port's too
    assert set(want) - set(got) == JAX_ONLY_FIELDS
    # the port's own fields: the device, "local" logging (TensorBoard is
    # not ported), and the march, which the JAX manager leaves at
    # SamplerConfig's default (the port carries it through config.json)
    from gfnerf_tpu.sampler.perssampler import SamplerConfig

    assert set(got) - set(want) == {"device", "pipeline.sampler.march"}
    assert got["vis"] == "local" and got["device"] == "cuda"
    assert got["pipeline.sampler.march"] == SamplerConfig().march


def test_unported_methods_raise():
    from gfnerf_tpu.configs.method_configs import method_configs
    from gfnerf_tpu_torch.configs.method_configs import (get_method,
                                                         method_configs as
                                                         ported)

    for name in set(method_configs) - set(ported):
        with pytest.raises(NotImplementedError, match="not ported"):
            get_method(name)
    with pytest.raises(KeyError):
        get_method("no-such-method")
    from gfnerf_tpu_torch.utils.writer import EventWriter

    with pytest.raises(NotImplementedError, match="not ported"):
        EventWriter("tensorboard")


def test_overrides_and_json_round_trip():
    from gfnerf_tpu.configs.config_io import apply_override as jax_override
    from gfnerf_tpu.configs.method_configs import gf_nerf_perf_config
    from gfnerf_tpu_torch.configs.config_io import (apply_override,
                                                    config_from_json,
                                                    config_to_json)
    from gfnerf_tpu_torch.configs.method_configs import get_method

    cfg, jcfg = get_method("gf-nerf-perf"), gf_nerf_perf_config()
    overrides = {"pipeline.model.steps_perssampler_init": "24",
                 "pipeline.sampler.sub_div_milestones": "8,16",
                 "pipeline.sampler.sample_l": "0.01",
                 "pipeline.field_block_dense_levels": "2",
                 "pipeline.use_error_sampling": "false",
                 "pipeline.optimizers.max_norm": "0.5",
                 "pipeline.datamanager.camera_res_scale_factor": "0.5",
                 "pipeline.model.use_ch_loss": "false",
                 "pipeline.model.s3im_loss_mult": "0.25",
                 "pipeline.model.s3im_kernel_size": "2",
                 "pipeline.model.s3im_stride": "3",
                 "pipeline.model.s3im_repeat_time": "5",
                 "pipeline.parallel_blocks": "true",
                 "pipeline.parallel_block_axis": "2",
                 "output-dir": "runs", "steps_per_save": "44"}
    for k, v in overrides.items():
        apply_override(cfg, k, v)
        jax_override(jcfg, k, v)
    got, want = _fields(cfg), _fields(jcfg)
    for k in overrides:
        k = k.replace("-", "_")
        assert got[k] == want[k], k
    assert cfg.pipeline.sampler.sub_div_milestones == (8, 16)
    assert cfg.output_dir == Path("runs")
    assert cfg.pipeline.optimizers.max_norm == 0.5
    assert cfg.pipeline.model.use_ch_loss is False
    assert cfg.pipeline.parallel_blocks is True
    assert cfg.pipeline.parallel_block_axis == 2
    # the class weights become a list of floats in the port; the JAX
    # package's override keeps the text (its sampler never reads them)
    key = "pipeline.datamanager.semantic_sample_weights"
    apply_override(cfg, key, "0.5,2")
    jax_override(jcfg, key, "0.5,2")
    assert cfg.pipeline.datamanager.semantic_sample_weights == [0.5, 2.0]
    assert jcfg.pipeline.datamanager.semantic_sample_weights == "0.5,2"
    apply_override(cfg, "pipeline.field_block_rows_log2", "13")
    assert cfg.pipeline.field_block_rows_log2 == 13
    with pytest.raises(AttributeError):
        apply_override(cfg, "pipeline.model.no_such_field", "1")
    back = config_from_json(config_to_json(cfg))
    assert back == cfg
    assert isinstance(back.pipeline.sampler.sub_div_milestones, tuple)
    with pytest.raises(ValueError, match="not one of"):
        config_from_json('{"__dataclass__": "os.path.Foo"}')


def test_eval_metrics_match_jax():
    import jax.numpy as jnp

    from gfnerf_tpu.model_components.lpips import lpips as jax_lpips
    from gfnerf_tpu.pipelines.pipeline import compute_ssim as jax_ssim
    from gfnerf_tpu_torch.model_components.lpips import lpips
    from gfnerf_tpu_torch.pipelines.pipeline import compute_ssim

    rng = np.random.default_rng(0)
    a = rng.random((24, 32, 3)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    assert compute_ssim(a, b) == jax_ssim(a, b)
    got = float(lpips(torch.as_tensor(a), torch.as_tensor(b)))
    want = float(jax_lpips(jnp.asarray(a), jnp.asarray(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert float(lpips(torch.as_tensor(a), torch.as_tensor(a))) == 0.0
