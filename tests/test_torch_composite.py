"""Parity of the ported fused composite (gfnerf_tpu_torch/ops/composite.py)
with the JAX package's plain reference and its Pallas forward kernel (run in
interpret mode on the CPU).  Tolerances are the JAX tests' own
(tests/test_pallas_ops.py): rtol 1e-4, atol 1e-5."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch threads)

NAMES = ("weights", "alphas", "rgb", "acc", "depth")


def _inputs(r, s, seed):
    rng = np.random.default_rng(seed)
    dens = (rng.random((r, s)) * 5).astype(np.float32)
    dts = (rng.random((r, s)) * 0.01 + 1e-3).astype(np.float32)
    ts = np.cumsum(rng.random((r, s)), -1).astype(np.float32)
    rgbs = rng.random((r, s, 3)).astype(np.float32)
    return dens, dts, ts, rgbs


def _close(got, want, tag):
    for name, a, b in zip(NAMES, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (tag, name, a.shape, b.shape)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{tag} {name}")


@pytest.mark.parametrize("s", [48, 64, 384])
def test_composite_reference_matches_jax(s):
    import jax.numpy as jnp
    from gfnerf_tpu.ops.pallas.composite import _composite_reference
    from gfnerf_tpu_torch.ops.composite import composite_reference

    x = _inputs(16, s, seed=s)
    want = _composite_reference(*(jnp.asarray(a) for a in x))
    got = composite_reference(*(torch.as_tensor(a) for a in x))
    _close([g.numpy() for g in got], want, f"S={s}")


@pytest.mark.parametrize("s", [48, 64, 384])
def test_composite_reference_matches_pallas_kernel(s):
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from gfnerf_tpu.ops.pallas import composite as C
    from gfnerf_tpu_torch.ops.composite import composite_reference

    x = _inputs(16, s, seed=10 + s)
    orig = pl.pallas_call
    try:  # interpret=True runs the TPU kernel on the CPU
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        want = C._composite_pallas(*(jnp.asarray(a) for a in x))
    finally:
        pl.pallas_call = orig
    got = composite_reference(*(torch.as_tensor(a) for a in x))
    _close([g.numpy() for g in got], want, f"S={s}")


def test_get_weights_f2nerf_matches_jax():
    import jax.numpy as jnp
    from gfnerf_tpu.cameras.rays import get_weights_f2nerf as jweights
    from gfnerf_tpu_torch.cameras.rays import get_weights_f2nerf

    dens, dts, _, _ = _inputs(16, 64, seed=3)
    want = jweights(jnp.asarray(dts), jnp.asarray(dens))
    got = get_weights_f2nerf(torch.as_tensor(dts), torch.as_tensor(dens))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)


def test_fused_composite_cpu_takes_plain_path():
    from gfnerf_tpu_torch.ops.composite import (composite_reference,
                                                fused_composite)

    x = [torch.as_tensor(a) for a in _inputs(16, 48, seed=5)]
    before = fused_composite.launches
    got = fused_composite(*x)
    assert fused_composite.launches == before
    for a, b in zip(got, composite_reference(*x)):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s", [(1000, 48), (64, 384)])
def test_fused_composite_kernel_matches_plain_on_card(r, s):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.ops.composite import (composite_reference,
                                                fused_composite)

    x = [torch.as_tensor(a, device="cuda") for a in _inputs(r, s, seed=7)]
    before = fused_composite.launches
    got = fused_composite(*x)
    torch.cuda.synchronize()
    assert fused_composite.launches == before + 1
    _close([g.cpu().numpy() for g in got],
           [w.cpu().numpy() for w in composite_reference(*x)], f"R={r} S={s}")
