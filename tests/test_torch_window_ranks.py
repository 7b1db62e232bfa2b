"""K steps a dispatch over several ranks: ``gf-nerf-tiny`` through the
Trainer at K = 4 over 2 ranks of a gloo group on the CPU (the data-parallel
step; the ranks are processes of ``tests/torch_dist_worker.py``, as in
``tests/test_torch_parallel.py``), 16 steps: the windows [0, 4) and
[10, 14), 8 single steps.

- Against the same 2 ranks at K = 1, through the init stage (steps 0-9:
  the window [0, 4), then single steps): every step's metrics, and the
  state after each of steps 3-9, bit for bit (a window over ranks runs
  its data-parallel steps eagerly: it changes when the host copies, not
  what is computed).  The focal window [10, 14) draws its 4 batches
  before the transition writes the error maps, as the JAX package's
  does, so from step 10 on the runs part.  Both ranks hold the same
  metrics and state after every step.
- Against one process on the union batch at K = 4 (its windows replay
  nothing on the CPU either): the same counts of steps in windows and
  single steps; every step's losses to 1e-4 relative and the final
  parameters at the pipeline parity test's shares (at most 10% of a
  tensor's entries apart by more than 1e-4, none by more than 2e-2),
  since the ranks' gradient sums round apart from the one process's
  (tests/test_torch_parallel.py holds one step of them to 1e-5).
- How a window runs (``window_mode``): one CUDA graph on a card alone or
  over NCCL ranks; eagerly over gloo ranks, on the CPU or when the
  caller passes ``graph=False``.
- The bounded wait for a window's replayed collectives
  (``comm.wait_bounded``): an event that never completes raises past the
  group's timeout, naming the window's steps, the ranks and the timeout;
  one that completes returns.
- ``comm.shutdown`` calls what ``before_shutdown`` registered (a window
  function's ``reset``, which drops a graph of NCCL collectives) before it
  destroys the process group, and skips what is gone; after a wait that
  timed out under NCCL it aborts the communicators and calls, synchronizes
  and destroys nothing.
"""

from __future__ import annotations

import datetime
import gc
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_dist_worker as tdw
import torch_parity  # noqa: F401  (two CPU threads per worker)

STEPS = 16
K = 4
INIT = 10   # gf-nerf-tiny's init steps
TINY = ["pipeline.datamanager.train_num_rays_per_batch=128",
        "pipeline.model.s3im_patch_height=8", "steps_per_eval_batch=1000",
        "--max-num-iterations", str(STEPS)]


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    path = tmp_path_factory.mktemp("scene")
    make_synthetic_npz(path, n_train=12, n_val=2, img_wh=(32, 24))
    return path


@pytest.fixture(scope="module")
def rank_runs(tmp_path_factory, scene):
    """{K: [rank 0's record, rank 1's]} at K = 4 and K = 1."""
    runs = {}
    for k in (K, 1):
        out = tmp_path_factory.mktemp(f"ranks_k{k}")
        tdw.run_ranks(tdw.trainer_run, 2, str(scene), str(out),
                      [*TINY, f"pipeline.steps_per_dispatch={k}"])
        runs[k] = tdw.load_results(out, 2)
    return runs


@pytest.mark.parametrize("rank", [0, 1])
def test_window_over_ranks_equals_single_steps(rank_runs, rank):
    win, one = rank_runs[K][rank], rank_runs[1][rank]
    assert sorted(win["metrics"]) == list(range(STEPS))
    assert win["windows"] == (2 * K, STEPS - 2 * K)
    assert one["windows"] == (0, 0)
    for step in range(INIT):
        assert win["metrics"][step] == one["metrics"][step], step
    for step in range(K - 1, INIT):   # after the window: its end state
        assert win["digests"][step] == one["digests"][step], step
    other = rank_runs[K][1 - rank]
    assert other["metrics"] == win["metrics"]
    assert other["digests"] == win["digests"]
    for name, v in other["end"].items():
        assert torch.equal(win["end"][name], v), name


def test_window_over_ranks_matches_one_process(rank_runs, scene, tmp_path):
    from gfnerf_tpu_torch.train import build_trainer

    trainer = build_trainer(
        ["gf-nerf-tiny", "--data", str(scene), "--device", "cpu",
         "--output-dir", str(tmp_path / "runs"), "--experiment-name", "one",
         *TINY, f"pipeline.steps_per_dispatch={K}"])
    p = trainer.pipeline
    metrics, get_loss = {}, p.get_train_loss_dict

    def recording(step):
        metrics[step] = get_loss(step)
        return metrics[step]

    p.get_train_loss_dict = recording
    trainer.train()
    ranks = rank_runs[K][0]
    assert (p._k_steps_scanned, p._k_steps_fallback) == ranks["windows"]
    for step in range(STEPS):
        for key in ("loss", "rgb_loss", "s3im_loss"):
            np.testing.assert_allclose(ranks["metrics"][step][key],
                                       metrics[step][key], rtol=1e-4,
                                       err_msg=f"step {step} {key}")
    for name, v in p.field.state_dict().items():
        diff = (ranks["end"][name] - v).abs()
        assert (diff > 1e-4).float().mean() <= 0.1, name
        assert float(diff.max()) <= 2e-2, name


# ---- graph or eager, and the bounded wait ----


@pytest.mark.parametrize("device, backend, graph, want", [
    ("cuda", "nccl", True, "graph"),
    ("cuda", None, True, "graph"),
    ("cuda", "gloo", True, "eager"),
    ("cpu", "gloo", True, "eager"),
    ("cpu", None, True, "eager"),
    ("cuda", "nccl", False, "eager"),
    ("cuda", None, False, "eager"),
])
def test_window_mode(device, backend, graph, want):
    from gfnerf_tpu_torch.models.gfnerf import window_mode

    comm = None if backend is None else SimpleNamespace(backend=backend)
    assert window_mode(torch.device(device), comm, graph) == want


class _Event:
    """A stand-in for a CUDA event: done after ``polls`` queries (None:
    never)."""

    def __init__(self, polls=None):
        self.polls, self.queries = polls, 0

    def query(self):
        self.queries += 1
        return self.polls is not None and self.queries > self.polls


def _comm(timeout_s):
    return SimpleNamespace(ranks=[0, 1, 2, 3], backend="nccl",
                           timeout=datetime.timedelta(seconds=timeout_s))


def test_window_wait_raises_past_the_timeout(monkeypatch):
    from gfnerf_tpu_torch.parallel import comm as pcomm

    monkeypatch.setattr(pcomm, "_TIMED_OUT", [])
    event = _Event()
    t0 = time.monotonic()
    with pytest.raises(TimeoutError) as err:
        pcomm.wait_bounded(event, _comm(0.25), "the window of steps 16-23")
    waited = time.monotonic() - t0
    assert 0.25 <= waited < 5.0
    assert event.queries > 1
    msg = str(err.value)
    assert "steps 16-23" in msg and "[0, 1, 2, 3]" in msg and "0.25 s" in msg
    assert pcomm._TIMED_OUT == ["the window of steps 16-23"]


def test_window_wait_returns_when_done(monkeypatch):
    from gfnerf_tpu_torch.parallel import comm as pcomm

    monkeypatch.setattr(pcomm, "_TIMED_OUT", [])
    event = _Event(polls=3)
    pcomm.wait_bounded(event, _comm(5.0), "the window of steps 0-7")
    assert event.queries == 4
    assert pcomm._TIMED_OUT == []


def test_shutdown_drops_what_registered_first(monkeypatch):
    from gfnerf_tpu_torch.parallel import comm as pcomm

    order = []

    def drop():
        order.append("drop")

    def gone():
        order.append("gone")

    pcomm.before_shutdown(drop)
    pcomm.before_shutdown(gone)
    del gone
    gc.collect()
    monkeypatch.setattr(pcomm.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pcomm.dist, "destroy_process_group",
                        lambda: order.append("destroy"))
    pcomm.shutdown()
    assert order == ["drop", "destroy"]
    pcomm.shutdown()   # nothing registered any more
    assert order == ["drop", "destroy", "destroy"]


def test_shutdown_after_a_timed_out_wait_aborts(monkeypatch):
    from gfnerf_tpu_torch.parallel import comm as pcomm

    order = []

    def refused(what):
        def fn(*a, **k):
            raise AssertionError(f"{what} after a timed-out wait")
        return fn

    def drop():
        order.append("drop")

    monkeypatch.setattr(pcomm, "_TIMED_OUT", [])
    monkeypatch.setattr(pcomm, "_BEFORE_SHUTDOWN", [])
    monkeypatch.setattr(pcomm, "_WORLD", _comm(0.1))
    monkeypatch.setattr(pcomm.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pcomm.dist, "destroy_process_group",
                        refused("destroy_process_group"))
    monkeypatch.setattr(pcomm.dist.distributed_c10d, "_abort_process_group",
                        lambda group=None: order.append("abort"))
    monkeypatch.setattr(pcomm.torch.cuda, "synchronize",
                        refused("synchronize"))
    pcomm.before_shutdown(drop)
    with pytest.raises(TimeoutError):
        pcomm.wait_bounded(_Event(), pcomm._WORLD, "the window of steps 8-15")
    pcomm.shutdown()
    assert order == ["abort"]
    assert pcomm._WORLD is None and pcomm._TIMED_OUT == []
    assert pcomm._BEFORE_SHUTDOWN == []
