"""The web viewer over several ranks (engine/trainer.py, viewer/server.py)
on the CPU: 4 spawned ranks of one gloo group (tests/torch_dist_worker.py)
train gf-nerf-tiny with ``--vis viewer viewer_port=0 --parallel-blocks``
(data 2 x block 2) into the concurrent focal stage, and this process
drives rank 0's viewer over HTTP: pause, render A, a second check of the
pause (8 s in all, longer than the group's 5 s timeout), resume, a render
while training, two more steps, pause, render B (a training camera of a
block that rank 0's group does not train), stop.

Checked: during the pause no rank takes a step; every rank records the
same steps and the same syncs of the block tables; the stop leaves one
checkpoint, rank 0's, which every rank's final state equals bit for bit;
render B equals, pixel for pixel, the one-process render of that
checkpoint at the same request, and differs from a render with that
block's table as it was at the phase's start (so that the sync is what
makes it right); only rank 0 serves; each step boundary of the run runs
one control broadcast (plus the syncs it calls), and none without the
viewer (tests/test_torch_parallel.py's run).  A vanilla pipeline over
several ranks is still refused.

The ranks run under ``run_ranks``' deadline of 120 s (about 40 s on one
CPU core a rank).
"""

import json
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as tdw

WORLD = 4
GROUP_TIMEOUT_S = 5.0
PAUSE_S = 8.0           # the first pause, longer than the group's timeout
NO_STEP_S = 1.0         # the window in which no rank may take a step
REQ = {"width": 32, "height": 24, "downscale": 1}
TINY = ["pipeline.datamanager.train_num_rays_per_batch=128",
        "pipeline.model.s3im_patch_height=8", "steps_per_eval_batch=1000",
        "steps_per_log=1", "--max-num-iterations", "500",
        "--parallel-blocks"]


def _get(url):
    return urllib.request.urlopen(url, timeout=60).read()


def _post(url, doc):
    req = urllib.request.Request(url, data=json.dumps(doc).encode())
    return urllib.request.urlopen(req, timeout=120).read()


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


@pytest.fixture(scope="module")
def viewed(tmp_path_factory, scene):
    """The ranks' records and what this process saw over HTTP."""
    from gfnerf_tpu_torch.utils.image_io import decode_png

    out = tmp_path_factory.mktemp("viewer_ranks")
    failed = []

    def ranks():
        try:
            tdw.run_ranks(tdw.viewer_run, WORLD, str(scene), str(out), TINY,
                          timeout=120.0, group_timeout=GROUP_TIMEOUT_S)
        except BaseException as e:   # raised in the HTTP drive below
            failed.append(e)

    thread = threading.Thread(target=ranks, daemon=True)
    thread.start()
    seen = {}

    def alive():
        if failed:
            raise failed[0]
        assert thread.is_alive(), "the ranks ended before the stop"

    def until(cond, limit=90.0):
        t0 = time.monotonic()
        while not cond():
            alive()
            assert time.monotonic() - t0 < limit
            time.sleep(0.05)

    info = out / "viewer.json"
    until(info.exists)
    doc = json.loads(info.read_text())
    base = f"http://127.0.0.1:{doc['port']}"

    def status():
        return json.loads(_get(base + "/status"))

    # into the concurrent focal stage: its steps start at 11
    until(lambda: status().get("step", -1) >= 12)
    scene_doc = json.loads(_get(base + "/scene"))
    _post(base + "/control", {"action": "pause"})
    t_pause = time.time()
    until(lambda: status()["held"])
    held_at = status()["step"]
    t0 = time.time()
    time.sleep(NO_STEP_S)
    seen["no_step_window"] = (t0, time.time())
    cams = scene_doc["cameras"]
    seen["render_a"] = decode_png(_post(base + "/render", {
        **REQ, "c2w": cams[0]["c2w"]}))
    time.sleep(max(PAUSE_S - (time.time() - t_pause), 0.0))
    st = status()
    seen["pause"] = {"held_at": held_at, "step_after": st["step"],
                     "held": st["held"], "paused": st["paused"],
                     "seconds": time.time() - t_pause}
    _post(base + "/control", {"action": "resume"})
    # a render while training, after a concurrent step has moved the
    # tables: it waits for the ranks' sync at the next step boundary
    until(lambda: status()["step"] > held_at)
    seen["render_c"] = decode_png(_post(base + "/render", {
        **REQ, "c2w": cams[1]["c2w"]}))
    resumed = status()["step"]
    until(lambda: status()["step"] >= resumed + 2)
    # render B: a camera of a block that rank 0's group does not train
    _, g = doc["coords"]
    bps = doc["n_blocks"] // doc["n_block_axis"]
    other = [c for c in cams if c["cluster"] // bps != g]
    assert other, scene_doc
    seen["pose_b"] = other[0]
    _post(base + "/control", {"action": "pause"})
    until(lambda: status()["held"])
    seen["req_b"] = {**REQ, "c2w": other[0]["c2w"]}
    seen["render_b"] = decode_png(_post(base + "/render", seen["req_b"]))
    seen["step_b"] = status()["step"]
    _post(base + "/control", {"action": "stop"})
    thread.join(timeout=120)
    if failed:
        raise failed[0]
    assert not thread.is_alive()
    return {"ranks": tdw.load_results(out, WORLD), "seen": seen,
            "doc": doc}


def test_pause_holds_every_rank(viewed):
    """No rank starts a step in the held window, nor while paused at all
    (8 s, past the group's 5 s timeout); every rank took the same steps,
    0 .. N - 1, and resumed after the pause."""
    seen, ranks = viewed["seen"], viewed["ranks"]
    t0, t1 = seen["no_step_window"]
    pause = seen["pause"]
    assert pause["held"] and pause["paused"]
    assert pause["seconds"] >= PAUSE_S > GROUP_TIMEOUT_S
    assert pause["step_after"] == pause["held_at"]
    steps = sorted(ranks[0]["steps"])
    assert steps == list(range(len(steps)))
    for rk in ranks:
        assert sorted(rk["steps"]) == steps
        assert not [s for s, r in rk["steps"].items() if t0 <= r["t0"] <= t1]
    assert steps[-1] >= pause["held_at"] + 3
    for rk in ranks[1:]:
        assert rk["viewer"] is None   # rank 0 alone serves


def test_ranks_agree_on_syncs_and_final_state(viewed):
    """Every rank called the sync as often, after the same steps, and
    holds the same tables after each; the stop left one checkpoint, rank
    0's, equal bit for bit to every rank's final state."""
    ranks = viewed["ranks"]
    syncs = [rk["syncs"] for rk in ranks]
    for other in syncs[1:]:
        assert other == syncs[0]
    # the phase's sync inside step 11; at boundaries the first pause's,
    # the render's while training, the second pause's; the checkpoint's
    assert [(s, inner) for s, inner, _ in syncs[0]][0] == (11, True)
    assert [inner for _, inner, _ in syncs[0]] == [True] + [False] * 4
    held_at = viewed["seen"]["pause"]["held_at"]
    assert syncs[0][1][0] == held_at and syncs[0][2][0] > held_at
    base = Path(ranks[0]["base_dir"])
    ckpts = sorted(p.name for p in (base / "nerfstudio_models").iterdir())
    last = max(ranks[0]["steps"])
    assert ckpts == [f"step-{last:09d}"]
    saved = torch.load(base / "nerfstudio_models" / ckpts[0] / "state.pt",
                       weights_only=True)["field"]
    for rk in ranks:
        assert rk["base_dir"] == str(base)
        assert set(rk["end"]) == set(saved)
        for k, v in saved.items():
            assert torch.equal(rk["end"][k], v), k


def test_boundary_runs_one_control_broadcast(viewed):
    """Each step boundary that neither paused nor synced ran exactly one
    collective, its control broadcast; a boundary that synced ran it and
    the sync's broadcasts; the paused boundaries one broadcast a poll."""
    for rk in viewed["ranks"]:
        plain = [b for b in rk["boundaries"] if b["syncs"] == 0]
        assert all(b["agrees"] >= 1 for b in rk["boundaries"])
        assert all(b["collectives"] == b["agrees"] for b in plain), plain
        assert len(plain) >= 10
        polls = [b for b in rk["boundaries"] if b["agrees"] > 1]
        # the first pause polled every 0.2 s for 8 s
        assert max(b["agrees"] for b in polls) >= 20
    assert viewed["ranks"][0]["boundaries"] == \
        viewed["ranks"][1]["boundaries"]


def _one_process_render(base: Path, req: dict, table=None):
    """Render ``req`` on the stop's checkpoint in one process, through a
    ViewerServer of its own (on one thread, as a rank renders); with
    ``table`` = (block, tensor), that block's table replaced first."""
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.utils.image_io import decode_png
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    _, trainer = eval_setup(base / "config.json")
    p = trainer.pipeline
    assert p.comm is None and not p.tables_stale()
    if table is not None:
        with torch.no_grad():
            p.field.block_feats[table[0]].copy_(table[1])
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return decode_png(ViewerServer(p, port=0)._render(req))
    finally:
        torch.set_num_threads(threads)


def test_render_b_sees_the_other_groups_block(viewed):
    """Render B (paused, a camera of the other group's block) equals the
    one-process render of the stop's checkpoint pixel for pixel; with
    that block's table as it was at the phase's first step it differs,
    so it is the sync that made rank 0's copy right."""
    ranks, seen = viewed["ranks"], viewed["seen"]
    base = Path(ranks[0]["base_dir"])
    want = _one_process_render(base, seen["req_b"])
    got = seen["render_b"]
    assert got.shape == (24, 32, 3) and got.std() > 0
    np.testing.assert_array_equal(got, want)
    (step, start), = ranks[0]["phase_start_blocks"]
    assert step == 11
    block = seen["pose_b"]["cluster"]
    assert not torch.equal(start[block], ranks[0]["end"]["block_feats"][
        block])
    stale = _one_process_render(base, seen["req_b"],
                                (block, start[block]))
    assert not np.array_equal(stale, got)


def test_renders_paused_and_while_training(viewed):
    for key in ("render_a", "render_c"):
        img = viewed["seen"][key]
        assert img.shape == (24, 32, 3) and img.dtype == np.uint8
        assert img.std() > 0


def test_vanilla_pipeline_over_ranks_still_refused(tmp_path, monkeypatch):
    """The vanilla pipelines stay one-rank, as in the JAX package (its
    vanilla pipeline builds no mesh): a Trainer over a group refuses one,
    with or without the viewer."""
    from types import SimpleNamespace

    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.engine import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod.parallel_comm, "world",
                        lambda: SimpleNamespace(rank=0, size=2))
    for vis in ("local", "viewer"):
        cfg = get_method("nerfacto")
        cfg.vis, cfg.device, cfg.output_dir = vis, "cpu", tmp_path
        with pytest.raises(ValueError, match="GF-NeRF pipeline only"):
            trainer_mod.Trainer(cfg, None).setup()
