"""Parity of the ported losses (gfnerf_tpu_torch/model_components/losses.py)
with the JAX package's: Charbonnier, MSE and S3IM, values and gradients.
S3IM's permutations are drawn from the JAX key as the JAX loss draws them
(losses.py:70-73) and handed to the port.  Tolerance rtol 1e-5 (f32 sums
in other orders; the S3IM convolutions sum 16 taps)."""

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch threads)

RTOL = 1e-5


def _pred_target(r=256, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.random((r, 3)).astype(np.float32),
            rng.random((r, 3)).astype(np.float32))


@pytest.mark.parametrize("name", ["charbonnier_loss", "mse_loss"])
def test_pixel_losses_match_jax(name):
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components import losses as J
    from gfnerf_tpu_torch.model_components import losses as T

    pred, target = _pred_target()
    want, want_g = jax.value_and_grad(getattr(J, name))(
        jnp.asarray(pred), jnp.asarray(target))
    p = torch.tensor(pred, requires_grad=True)
    got = getattr(T, name)(p, torch.as_tensor(target))
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=RTOL,
                               atol=1e-9)


@pytest.mark.parametrize("r,patch_height,kernel,stride",
                         [(256, 32, 4, 4), (128, 16, 3, 2)])
def test_s3im_matches_jax(r, patch_height, kernel, stride):
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.model_components.losses import s3im_loss as jloss
    from gfnerf_tpu_torch.model_components.losses import s3im_loss

    pred, target = _pred_target(r, seed=r)
    key = jax.random.PRNGKey(r)
    kw = dict(kernel_size=kernel, stride=stride, patch_height=patch_height)
    want, want_g = jax.value_and_grad(
        lambda p: jloss(key, p, jnp.asarray(target), repeat_time=10, **kw))(
            jnp.asarray(pred))
    perms = np.stack([np.asarray(jax.random.permutation(k, r))
                      for k in jax.random.split(key, 9)])
    p = torch.tensor(pred, requires_grad=True)
    got = s3im_loss(p, torch.as_tensor(target), torch.as_tensor(perms), **kw)
    got.backward()
    assert 0.05 < float(want) < 1.5
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(want_g), rtol=1e-4,
                               atol=1e-7 * float(np.abs(want_g).max()))


def test_s3im_permutations_from_generator():
    from gfnerf_tpu_torch.model_components.losses import s3im_permutations

    a = s3im_permutations(64, 10, torch.Generator().manual_seed(1))
    b = s3im_permutations(64, 10, torch.Generator().manual_seed(1))
    assert a.shape == (9, 64) and torch.equal(a, b)
    assert all(torch.equal(row.sort().values, torch.arange(64)) for row in a)
