"""Parity of the ported fused composite (gfnerf_tpu_torch/ops/composite.py),
forward and backward, with the JAX package's plain reference, its autodiff,
and its Pallas forward and backward kernels (run in interpret mode on the
CPU).  Tolerances are the JAX tests' own (tests/test_pallas_ops.py): rtol
1e-4, atol 1e-5."""

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


def _cotangents(r, s, seed, depth_scale=0.01):
    """Random cotangents of (weights, alphas, rgb, acc, depth).  The depth
    cotangent is scaled down: it multiplies t - depth, which reaches S/2."""
    rng = np.random.default_rng(seed)
    g = [rng.standard_normal(sh).astype(np.float32)
         for sh in ((r, s), (r, s), (r, 3), (r, 1), (r, 1))]
    g[4] *= depth_scale
    return g


BWD_NAMES = ("g_densities", "g_dts", "g_ts", "g_rgbs")


def _close_bwd(got, want, tag, names=BWD_NAMES):
    """rtol 1e-4 and atol 1e-5, or 1e-6 of the output's largest magnitude
    where that is larger: an output that nearly cancels keeps a few f32
    ulps of its ray's largest term, and sigma reaches 2000 in the opaque
    case."""
    for name, a, b in zip(names, got, want):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, (tag, name, a.shape, b.shape)
        np.testing.assert_allclose(
            a, b, rtol=1e-4, atol=max(1e-5, 1e-6 * float(np.abs(b).max())),
            err_msg=f"{tag} {name}")


@pytest.mark.parametrize("s,opaque", [(48, False), (64, False), (384, False),
                                      (64, True)])
def test_composite_backward_reference_matches_jax_vjp(s, opaque):
    """The plain backward against JAX's autodiff of the plain forward; the
    opaque case makes sigma*dt large enough that T underflows to 0 mid-ray,
    where a suffix taken as total minus prefix would cancel."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.ops.pallas.composite import _composite_reference
    from gfnerf_tpu_torch.ops.composite import composite_backward_reference

    x = list(_inputs(16, s, seed=20 + s))
    if opaque:
        x[0] = x[0] * 400.0
    g = _cotangents(16, s, seed=s)
    _, vjp = jax.vjp(_composite_reference, *(jnp.asarray(a) for a in x))
    want = vjp(tuple(jnp.asarray(a) for a in g))
    got = composite_backward_reference(*(torch.as_tensor(a) for a in x),
                                       [torch.as_tensor(a) for a in g])
    if opaque:
        assert float(np.exp(-np.cumsum(x[0] * x[1], -1))[:, -1].max()) == 0
    _close_bwd([t.numpy() for t in got], want, f"S={s} opaque={opaque}")


@pytest.mark.parametrize("s", [48, 64, 384])
def test_composite_backward_reference_matches_pallas_kernel(s):
    import jax.experimental.pallas as pl
    import jax.numpy as jnp
    from gfnerf_tpu.ops.pallas import composite as C
    from gfnerf_tpu_torch.ops.composite import composite_backward_reference

    x = _inputs(16, s, seed=30 + s)
    g = _cotangents(16, s, seed=40 + s)
    orig = pl.pallas_call
    try:  # interpret=True runs the TPU kernel on the CPU
        pl.pallas_call = lambda *a, **k: orig(*a, **{**k, "interpret": True})
        want = C._composite_bwd_pallas(*(jnp.asarray(a) for a in x),
                                       tuple(jnp.asarray(a) for a in g))
    finally:
        pl.pallas_call = orig
    got = composite_backward_reference(*(torch.as_tensor(a) for a in x),
                                       [torch.as_tensor(a) for a in g])
    _close_bwd([t.numpy() for t in got], want, f"S={s}")


def test_fused_composite_autograd_cpu_takes_plain_pair():
    """Autograd through the wrapper on CPU tensors is the plain backward,
    with absent cotangents as zeros, and launches nothing."""
    from gfnerf_tpu_torch.ops.composite import (composite_backward_reference,
                                                fused_composite)

    x = [torch.tensor(a, requires_grad=True) for a in _inputs(16, 48, 9)]
    g = [torch.as_tensor(a) for a in _cotangents(16, 48, seed=9)]
    before = (fused_composite.launches, fused_composite.bwd_launches)
    out = fused_composite(*x)
    torch.autograd.backward([out[2], out[4]], [g[2], g[4]])
    assert (fused_composite.launches, fused_composite.bwd_launches) == before
    want = composite_backward_reference(*(t.detach() for t in x),
                                        [None, None, g[2], None, g[4]])
    for t, w in zip(x, want):
        torch.testing.assert_close(t.grad, w, rtol=0, atol=0)


def test_fused_composite_autograd_computes_only_needed_grads():
    """As the train step calls it: only densities and colours need a
    gradient and only rgb and acc get a cotangent.  The backward forms no
    gradient for the step sizes and distances, and the two it forms are the
    plain backward's."""
    from gfnerf_tpu_torch.ops.composite import (composite_backward_reference,
                                                fused_composite)

    need = (True, False, False, True)
    x = [torch.tensor(a, requires_grad=n)
         for a, n in zip(_inputs(16, 48, 11), need)]
    g = [torch.as_tensor(a) for a in _cotangents(16, 48, seed=11)]
    out = fused_composite(*x)
    torch.autograd.backward([out[2], out[3]], [g[2], g[3]])
    cots = [None, None, g[2], g[3], None]
    want = composite_backward_reference(*(t.detach() for t in x), cots,
                                        need)
    assert [w is None for w in want] == [not n for n in need]
    for t, w in zip(x, want):
        if w is None:
            assert t.grad is None
        else:
            torch.testing.assert_close(t.grad, w, rtol=0, atol=0)
    full = composite_backward_reference(*(t.detach() for t in x), cots)
    torch.testing.assert_close(want[0], full[0], rtol=0, atol=0)
    torch.testing.assert_close(want[3], full[3], rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("r,s,opaque,train", [
    (1000, 48, False, False), (64, 384, False, False), (256, 64, True, False),
    (1000, 384, False, True)])
def test_composite_backward_kernel_matches_plain_on_card(r, s, opaque, train):
    """All cotangents and gradients, or (``train``) the train step's call:
    cotangents of rgb and acc only, gradients of densities and colours
    only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.ops.composite import (composite_backward_reference,
                                                fused_composite)

    need = (True, False, False, True) if train else (True,) * 4
    x = list(_inputs(r, s, seed=8))
    if opaque:
        x[0] = x[0] * 400.0
    x = [torch.tensor(a, device="cuda", requires_grad=n)
         for a, n in zip(x, need)]
    g = [torch.as_tensor(a, device="cuda") for a in _cotangents(r, s, 8)]
    if train:
        g = [None, None, g[2], g[3], None]
    before = fused_composite.bwd_launches
    out = fused_composite(*x)
    torch.autograd.backward([o for o, c in zip(out, g) if c is not None],
                            [c for c in g if c is not None])
    torch.cuda.synchronize()
    assert fused_composite.bwd_launches == before + 1
    want = composite_backward_reference(*(t.detach() for t in x), g)
    assert all(t.grad is None for t, k in zip(x, need) if not k)
    _close_bwd([t.grad.cpu().numpy() for t, k in zip(x, need) if k],
               [w.cpu().numpy() for w, k in zip(want, need) if k],
               f"R={r} S={s}", [n for n, k in zip(BWD_NAMES, need) if k])


# rays around the warp width, the two train configs' lengths (192, 384),
# the register kernel's longest ray (512) and the tiled kernel's shortest
K2_LENGTHS = [1, 31, 32, 33, 192, 384, 512, 513]
# cotangents given and gradients asked for: each cotangent present in two
# forms and absent in two; "train" is the train step's call
K2_FORMS = {
    "all": ((True,) * 5, (True,) * 4),
    "train": ((False, False, True, True, False), (True, False, False, True)),
    "depth": ((False, False, False, False, True), (True,) * 4),
    "weights": ((True, True, False, False, False), (True, True, False, True)),
}


def _k2_case(r, s, seed, form, opaque=False):
    """Inputs, cotangents (None where absent) and needs on the card."""
    x = list(_inputs(r, s, seed=seed))
    if opaque:
        x[0] = x[0] * 400.0
    given, needs = K2_FORMS[form]
    g = [torch.as_tensor(a, device="cuda") if k else None
         for a, k in zip(_cotangents(r, s, seed), given)]
    return [torch.as_tensor(a, device="cuda") for a in x], g, needs


def _check_k2(x, g, needs, tag, tiled=False):
    from gfnerf_tpu_torch.ops.composite import (_composite_bwd_cuda,
                                                composite_backward_reference,
                                                fused_composite)

    before = fused_composite.bwd_launches
    got = _composite_bwd_cuda(*x, g, needs, tiled=tiled)
    torch.cuda.synchronize()
    assert fused_composite.bwd_launches == before + 1
    want = composite_backward_reference(*x, g, needs)
    assert [a is None for a in got] == [b is None for b in want]
    _close_bwd([a.cpu().numpy() for a in got if a is not None],
               [b.cpu().numpy() for b in want if b is not None], tag,
               [n for n, k in zip(BWD_NAMES, needs) if k])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("form", sorted(K2_FORMS))
@pytest.mark.parametrize("s", K2_LENGTHS)
def test_composite_backward_kernel_lengths_on_card(s, form):
    """K2 against the plain backward at each ray length and cotangent form,
    at the tolerance of ``_close_bwd``: up to 512 samples the ray is held
    in registers (a lane's serial sums, then warp scans of the lane totals),
    above it the tiled kernel runs; both sum in another order than the
    plain cumulative sums, so they agree to f32 rounding.  203 rays: the
    last block is short."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, g, needs = _k2_case(203, s, seed=s + 1, form=form)
    _check_k2(x, g, needs, f"S={s} {form}")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [64, 384, 513])
def test_composite_backward_kernel_opaque_on_card(s):
    """Seed 84's rays with sigma x 400 (T underflows to 0 mid-ray: the
    suffix must be summed from the later samples alone), every cotangent,
    on the register kernel (64, 384) and the tiled one (513)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, g, needs = _k2_case(64, s, seed=84, form="all", opaque=True)
    assert float(torch.exp(-torch.cumsum(x[0] * x[1], -1))[:, -1].max()) == 0
    _check_k2(x, g, needs, f"S={s} opaque")


@pytest.mark.cuda
@pytest.mark.parametrize("s", [192, 384])
def test_composite_backward_tiled_matches_register_on_card(s):
    """At the train configs' lengths the tiled kernel (``tiled=True``) and
    the register kernel both agree with the plain backward, and the register
    kernel also takes inputs whose addresses allow no vector loads (a view
    4 bytes into its storage)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    x, g, needs = _k2_case(1000, s, seed=3, form="train")
    _check_k2(x, g, needs, f"S={s} tiled", tiled=True)
    _check_k2(x, g, needs, f"S={s} register")
    shifted = []
    for t in x:
        flat = torch.empty(t.numel() + 1, device="cuda")[1:]
        shifted.append(flat.view(t.shape).copy_(t))
    assert shifted[0].data_ptr() % 16 == 4
    _check_k2(shifted, g, needs, f"S={s} unaligned")
