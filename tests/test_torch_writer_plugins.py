"""The trainer's last surfaces against the JAX package's, on the CPU: the
event writer's TensorBoard and W&B backends and ``--vis``
(``gfnerf_tpu_torch/utils/writer.py``), method plugins
(``configs/method_configs.discover_methods``), the octree's .obj dumps
(``sampler/octree.py``) and LPIPS with installed weights
(``model_components/lpips.load_weights``).

Tolerances: exact for the event records (tags, steps, scalars as the f32
``simple_value`` both write, decoded image pixels, the config text), the
writers' backends and messages, and the .obj bytes; LPIPS within 1e-5 of
the JAX package's.
"""

from __future__ import annotations

import dataclasses
import struct
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)

# the calls both writers get: scalars at two steps, an eval image, the
# config
SCALARS = [("Train Iter (time)", 0.0123, 0), ("loss", 1.5, 0),
           ("Eval Images/psnr", 17.25, 10), ("loss", 0.75, 10)]
CONFIG = "method_name: gf-nerf\nmax_num_iterations: 30"


def _image():
    rng = np.random.default_rng(0)
    return rng.random((12, 20, 3)).astype(np.float32)


def _drive(writer):
    for name, value, step in SCALARS:
        writer.put_scalar(name, value, step)
    writer.put_image("Eval Images/img", _image(), 10)
    writer.put_config(CONFIG)
    writer.flush(10)


def _records(path: Path) -> list:
    """The event file's records as tensorboardX's protos, each record's
    two CRCs checked with tensorboardX's own."""
    from tensorboardX.proto import event_pb2
    from tensorboardX.record_writer import masked_crc32c

    data, out, i = path.read_bytes(), [], 0
    while i < len(data):
        (n,) = struct.unpack("<Q", data[i:i + 8])
        assert struct.unpack("<I", data[i + 8:i + 12])[0] == masked_crc32c(
            data[i:i + 8])
        body = data[i + 12:i + 12 + n]
        assert struct.unpack("<I", data[i + 12 + n:i + 16 + n])[0] == \
            masked_crc32c(body)
        ev = event_pb2.Event()
        ev.ParseFromString(body)
        out.append(ev)
        i += 16 + n
    return out


def _summaries(events) -> list:
    """(step, tag, payload) of every summary value: the scalar, the
    decoded image with its header fields, or the text's strings."""
    import imageio.v2 as imageio

    out = []
    for ev in events:
        for v in ev.summary.value:
            kind = v.WhichOneof("value")
            if kind == "simple_value":
                payload = v.simple_value
            elif kind == "image":
                payload = (v.image.height, v.image.width, v.image.colorspace,
                           imageio.imread(v.image.encoded_image_string)
                           .tobytes())
            else:
                payload = (v.metadata.plugin_data.plugin_name,
                           list(v.tensor.string_val),
                           list(v.tensor.tensor_shape.dim))
            out.append((ev.step, v.tag, payload))
    return out


def test_tensorboard_events_match_tensorboardx(tmp_path):
    """The port's event file against the JAX package's TensorboardWriter
    (tensorboardX) for the same calls, both read through tensorboardX's
    protos; the port's own reader gives the same records."""
    pytest.importorskip("tensorboardX")
    from gfnerf_tpu.utils.writer import EventWriter as JaxWriter
    from gfnerf_tpu_torch.utils.writer import EventWriter, read_events

    jw = JaxWriter("tensorboard", tmp_path / "jax")
    _drive(jw)
    jw.backends[0].tb.close()
    pw = EventWriter("tensorboard", tmp_path / "port")
    _drive(pw)
    (jfile,) = (tmp_path / "jax").glob("events.out.tfevents.*")
    (pfile,) = (tmp_path / "port").glob("events.out.tfevents.*")
    jev, pev = _records(jfile), _records(pfile)
    assert pev[0].file_version == jev[0].file_version == "brain.Event:2"
    got, want = _summaries(pev), _summaries(jev)
    assert got == want
    assert len(got) == len(SCALARS) + 2
    # the port's reader: the same records, CRCs checked
    mine = read_events(pfile)
    assert [e.get("file_version") for e in mine][:1] == ["brain.Event:2"]
    flat = [(e["step"], v) for e in mine for v in e.get("values", [])]
    assert [(s, v["tag"]) for s, v in flat] == [(s, t) for s, t, _ in want]
    scalars = [v["simple_value"] for _, v in flat if "simple_value" in v]
    assert scalars == [p for _, _, p in want if isinstance(p, float)]
    (img,) = [v["image"] for _, v in flat if "image" in v]
    assert (img["height"], img["width"], img["colorspace"]) == (12, 20, 3)
    from gfnerf_tpu_torch.utils.image_io import decode_png

    np.testing.assert_array_equal(
        decode_png(img["png"]), (_image() * 255.0).astype(np.uint8))
    (text,) = [v["text"] for _, v in flat if "text" in v]
    assert text == [f"```\n{CONFIG}\n```"]


def test_read_events_refuses_a_torn_record(tmp_path):
    from gfnerf_tpu_torch.utils.writer import EventWriter, read_events

    w = EventWriter("tensorboard", tmp_path)
    _drive(w)
    (f,) = tmp_path.glob("events.out.tfevents.*")
    assert len(read_events(f)) == len(SCALARS) + 3
    data = bytearray(f.read_bytes())
    data[40] ^= 0xFF
    f.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="CRC"):
        read_events(f)


@pytest.mark.parametrize("vis", ["tensorboard", "wandb", "local", "viewer",
                                 "viewer+tensorboard"])
def test_vis_selects_the_jax_backends(tmp_path, monkeypatch, capsys, vis):
    """``vis`` picks the JAX EventWriter's backends by the same substrings
    (W&B absent here: both print the same line and go on)."""
    pytest.importorskip("tensorboardX")
    monkeypatch.setitem(sys.modules, "wandb", None)
    from gfnerf_tpu.utils.writer import EventWriter as JaxWriter
    from gfnerf_tpu_torch.utils.writer import EventWriter

    want = [type(b).__name__ for b in JaxWriter(vis, tmp_path / "j")
            .backends]
    jax_out = capsys.readouterr().out
    got = [type(b).__name__ for b in EventWriter(vis, tmp_path / "p")
           .backends]
    assert got == want
    assert capsys.readouterr().out == jax_out
    assert ("[writer] wandb unavailable" in jax_out) == ("wandb" in vis)


def test_wandb_writer_when_wandb_imports(tmp_path, monkeypatch):
    """With a ``wandb`` module the W&B backend buffers a step's scalars
    and images and logs them at the flush."""
    import types

    logged = []
    fake = types.SimpleNamespace(
        init=lambda **kw: logged.append(("init", kw)),
        Image=lambda a: ("image", a.shape),
        log=lambda d, step: logged.append(("log", step, dict(d))))
    monkeypatch.setitem(sys.modules, "wandb", fake)
    from gfnerf_tpu_torch.utils.writer import EventWriter, WandbWriter

    w = EventWriter("wandb", tmp_path)
    assert [type(b) for b in w.backends][:1] == [WandbWriter]
    w.put_scalar("loss", 0.5, 3)
    w.put_image("img", np.zeros((4, 5, 3)), 3)
    w.flush(3)
    w.flush(4)
    assert logged == [("init", {"project": "gfnerf-tpu",
                                "dir": str(tmp_path)}),
                      ("log", 3, {"loss": 0.5,
                                  "img": ("image", (4, 5, 3))})]


def test_train_writes_tensorboard_events(tmp_path):
    """``train`` on the CPU with the default ``--vis`` (TensorBoard, as
    the JAX script's): the run's event file holds the config, the logged
    scalars and the eval image."""
    from gfnerf_tpu_torch.train import main
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz
    from gfnerf_tpu_torch.utils.writer import read_events

    make_synthetic_npz(tmp_path / "scene", n_train=8, n_val=2,
                       img_wh=(32, 24))
    assert main(["gf-nerf-tiny", "--data", str(tmp_path / "scene"),
                 "--device", "cpu", "--max-num-iterations", "4",
                 "--output-dir", str(tmp_path / "runs"),
                 "pipeline.datamanager.train_num_rays_per_batch=64",
                 "pipeline.model.s3im_patch_height=8", "steps_per_log=2",
                 "steps_per_eval_image=4"]) == 0
    (f,) = (tmp_path / "runs").rglob("events.out.tfevents.*")
    events = read_events(f)
    values = [(e["step"], v) for e in events for v in e.get("values", [])]
    tags = {v["tag"] for _, v in values}
    assert {"config/text_summary", "loss", "Train_Iter__time_",
            "Eval_Images/img", "Eval_Images/psnr"} <= tags
    assert sorted({s for s, v in values if v["tag"] == "loss"}) == [0, 2]
    (cfg_text,) = [v["text"][0] for _, v in values if "text" in v]
    assert '"method_name": "gf-nerf-tiny"' in cfg_text


# ------------------------------------------------------------- plugins ----


PLUGIN = '''
import dataclasses
from gfnerf_tpu_torch.configs.method_configs import (MethodSpecification,
                                                     gf_nerf_tiny_config)


def _config(name):
    cfg = gf_nerf_tiny_config()
    cfg.method_name = name
    cfg.max_num_iterations = 7
    return cfg


spec = MethodSpecification(config=_config("my-method"),
                           description="a plugin's method")


def make_spec():
    return MethodSpecification(config=_config("my-other-method"))
'''


@pytest.fixture
def plugin_path(tmp_path, monkeypatch):
    """A package on ``sys.path`` whose dist-info names two methods in the
    port's entry-point group (a spec, and a callable returning one)."""
    (tmp_path / "my_gfnerf_plugin.py").write_text(PLUGIN)
    info = tmp_path / "my_gfnerf_plugin-0.1.dist-info"
    info.mkdir()
    (info / "METADATA").write_text(
        "Metadata-Version: 2.1\nName: my-gfnerf-plugin\nVersion: 0.1\n")
    (info / "entry_points.txt").write_text(
        "[gfnerf_tpu_torch.method_configs]\n"
        "my-method = my_gfnerf_plugin:spec\n"
        "my-other-method = my_gfnerf_plugin:make_spec\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    return tmp_path


def test_plugin_methods_are_discovered(plugin_path):
    from gfnerf_tpu_torch.configs import method_configs as mc

    methods = mc.discover_methods()
    assert set(mc.method_configs) < set(methods)
    assert {"my-method", "my-other-method"} <= set(methods)
    cfg = methods["my-method"]()
    assert cfg.method_name == "my-method" and cfg.max_num_iterations == 7
    assert mc.descriptions["my-method"] == "a plugin's method"
    assert methods["my-other-method"]().method_name == "my-other-method"
    # a fresh copy each time: a run's changes leave the spec as it was
    cfg.max_num_iterations = 99
    assert methods["my-method"]().max_num_iterations == 7


def test_train_resolves_a_plugin_method(plugin_path, tmp_path, monkeypatch):
    import gfnerf_tpu_torch.engine.trainer as trainer_mod
    from gfnerf_tpu_torch import train
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    seen = []

    class Recorder:
        def __init__(self, config, dataparser):
            seen.append(config)

        def setup(self):
            pass

    monkeypatch.setattr(trainer_mod, "Trainer", Recorder)
    make_synthetic_npz(tmp_path / "scene", n_train=4, n_val=1,
                       img_wh=(16, 12))
    train.build_trainer(["my-method", "--data", str(tmp_path / "scene"),
                         "--device", "cpu"])
    (cfg,) = seen
    assert cfg.method_name == "my-method" and cfg.device == "cpu"
    assert cfg.vis == "tensorboard"
    with pytest.raises(SystemExit):
        train.build_trainer(["no-such-method", "--data",
                             str(tmp_path / "scene"), "--device", "cpu"])


def test_broken_plugin_leaves_the_registry(tmp_path, monkeypatch, capsys):
    """A plugin that fails to load prints a line, as in the JAX package,
    and the registered methods stay."""
    info = tmp_path / "broken_plugin-0.1.dist-info"
    info.mkdir()
    (info / "METADATA").write_text(
        "Metadata-Version: 2.1\nName: broken-plugin\nVersion: 0.1\n")
    (info / "entry_points.txt").write_text(
        "[gfnerf_tpu_torch.method_configs]\n"
        "broken = no_such_module_here:spec\n")
    monkeypatch.syspath_prepend(str(tmp_path))
    from gfnerf_tpu_torch.configs import method_configs as mc

    assert set(mc.discover_methods()) == set(mc.method_configs)
    assert "[plugins] discovery failed" in capsys.readouterr().out


def test_method_specification_matches_jax():
    from gfnerf_tpu.configs.method_configs import \
        MethodSpecification as JaxSpec
    from gfnerf_tpu_torch.configs.method_configs import MethodSpecification

    assert [f.name for f in dataclasses.fields(MethodSpecification)] == [
        f.name for f in dataclasses.fields(JaxSpec)]


# ---------------------------------------------------------- .obj dumps ----


@pytest.fixture(scope="module")
def tree():
    """The tiny scene's octree (numpy), built by the JAX package's
    builder and grown by one milestone subdivision, so that it has inner
    nodes and leaves."""
    from gfnerf_tpu.sampler.octree import proc_octree

    return proc_octree(torch_parity.tiny_tree(), compact=True,
                       subdivide=True, brute_force=False)


def test_vis_octree_obj_matches_jax(tree, tmp_path):
    from gfnerf_tpu.sampler.octree import vis_octree_obj as jax_vis
    from gfnerf_tpu_torch.sampler.octree import vis_octree_obj

    assert 0 < int(tree.is_leaf[:tree.n_nodes].sum()) < tree.n_nodes
    vis_octree_obj(tree, tmp_path / "port.obj")
    jax_vis(tree, tmp_path / "jax.obj")
    got = (tmp_path / "port.obj").read_bytes()
    assert got == (tmp_path / "jax.obj").read_bytes()
    lines = got.decode().splitlines()
    assert sum(ln.startswith("v ") for ln in lines) == 8 * tree.n_nodes
    assert sum(ln.startswith("l ") for ln in lines) == 12 * int(
        tree.is_leaf[:tree.n_nodes].sum())


def test_vis_cameras_obj_matches_jax(tmp_path):
    from gfnerf_tpu.sampler.octree import vis_cameras_obj as jax_vis
    from gfnerf_tpu_torch.sampler.octree import vis_cameras_obj

    c2w = torch_parity.tiny_cameras()[0]
    vis_cameras_obj(c2w, tmp_path / "port.obj")
    jax_vis(c2w, tmp_path / "jax.obj")
    got = (tmp_path / "port.obj").read_bytes()
    assert got == (tmp_path / "jax.obj").read_bytes()
    assert len(got.splitlines()) == len(c2w)


# ------------------------------------------------------------- LPIPS ----


def test_lpips_with_loaded_weights_matches_jax(monkeypatch):
    """Installed kernels (a smaller stack: the function takes any list of
    (3, 3, c_in, c_out) stages) give the JAX package's distance within
    1e-5; loading None restores the random features."""
    import gfnerf_tpu.model_components.lpips as jax_lpips
    import gfnerf_tpu_torch.model_components.lpips as port_lpips

    monkeypatch.setattr(jax_lpips, "_loaded_weights", None)
    monkeypatch.setattr(port_lpips, "_loaded_weights", None)
    rng = np.random.default_rng(7)
    stages, c_in = [], 3
    for c_out, n in ((8, 2), (16, 1), (16, 2)):
        stage = []
        for _ in range(n):
            stage.append((rng.standard_normal((3, 3, c_in, c_out)) *
                          np.sqrt(2.0 / (9 * c_in))).astype(np.float32))
            c_in = c_out
        stages.append(stage)
    a = rng.random((2, 20, 28, 3)).astype(np.float32)
    b = np.clip(a + 0.1 * rng.standard_normal(a.shape), 0, 1).astype(
        np.float32)
    default = float(port_lpips.lpips(torch.from_numpy(a),
                                     torch.from_numpy(b)))

    jax_lpips.load_weights(stages)
    port_lpips.load_weights(stages)
    # the JAX function traced afresh (its jit would reuse a trace made
    # with other weights at these shapes)
    want = float(jax_lpips.lpips.__wrapped__(a, b))
    got = float(port_lpips.lpips(torch.from_numpy(a), torch.from_numpy(b)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert abs(got - default) > 1e-3
    port_lpips.load_weights(None)
    assert float(port_lpips.lpips(torch.from_numpy(a),
                                  torch.from_numpy(b))) == default
