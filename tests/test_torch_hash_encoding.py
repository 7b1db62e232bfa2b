"""Parity of the ported anchored hash encode and its table gradient
(gfnerf_tpu_torch/fields/hash_encoding.py) with the JAX package's, and of
the anchored layout through the field and one train step.

The JAX side runs jitted, as the train step runs it: XLA then fuses
``p * scale + bias`` into one multiply-add, and the port reproduces that
rounding, so the corner indices (the uint32 hash) must match exactly.
Values: both sum the same 8 bf16 table values times f32 weights, in the
same order; XLA also contracts ``acc + w * v``, the port rounds the product
first, so sums of order 0.5 differ by a few f32 ulps: atol 1e-6.
"""

import numpy as np
import pytest
import torch

from torch_parity import field_pair, octree_pair, to_np
from torch_parity import jax_groups, jax_train_step, port_train_step
from torch_parity import TRAIN_S, train_batch

LOG2 = 10
N_LEVELS = 4
N_VOLUMES = 3


def _tables(c, seed=7):
    """(prim, bias) from the port's init and a non-trivial table (init's
    +-1e-2 is too flat to exercise the sums)."""
    from gfnerf_tpu_torch.fields.hash_encoding import init_hash_params

    _, prim, bias = init_hash_params(seed, LOG2, N_VOLUMES, N_LEVELS, c)
    feat = np.random.default_rng(seed).uniform(
        -0.5, 0.5, (N_LEVELS, 1 << LOG2, c)).astype(np.float32)
    return feat, prim, bias


def _points(p=4096, seed=1, n_invalid=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.17, 0.83, (p, 3)).astype(np.float32)
    anc = rng.integers(0, N_VOLUMES, p).astype(np.int32)
    anc[rng.choice(p, n_invalid, replace=False)] = -1
    return pts, anc


def _targs(prim, bias, pts, anc):
    return (torch.as_tensor(prim.astype(np.int64)), torch.as_tensor(bias),
            torch.as_tensor(pts), torch.as_tensor(anc))


@pytest.mark.parametrize("c,mode,rand_bias", [(2, "reset", True),
                                              (4, "zero", True),
                                              (2, "reset", False)])
def test_init_hash_params_bit_identical(c, mode, rand_bias):
    from gfnerf_tpu.fields.hash_encoding import init_hash_params as jinit
    from gfnerf_tpu_torch.fields.hash_encoding import init_hash_params

    kw = dict(seed=11, log2_table_size=LOG2, n_volumes=N_VOLUMES,
              n_levels=N_LEVELS, n_channels=c, init_mode=mode,
              rand_bias=rand_bias)
    want = jinit(**kw)
    got = init_hash_params(**kw)
    for a, b in zip((want.feat_pool, want.prim_pool, want.bias_pool), got):
        a = np.asarray(a)
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    # a size that is not a multiple of 16 rounds down (Hash3DAnchored.cpp:66)
    assert init_hash_params(0, 3, 1, 2, 2)[0].shape == (2, 0, 2)


@pytest.mark.parametrize("n_invalid", [0, 300])
def test_corner_indices_exact(n_invalid):
    """Every (level, corner, point) table entry equals the jitted JAX
    addressing's (``_corner_data_flat``, which the JAX backward uses and
    which repeats the forward's expressions)."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.hash_encoding import (_corner_data_flat,
                                                 _level_scales)
    from gfnerf_tpu_torch.fields.hash_encoding import hash_corner_indices

    _, prim, bias = _tables(2)
    pts, anc = _points(n_invalid=n_invalid)
    local = 1 << LOG2
    vol = jnp.clip(jnp.asarray(anc), 0, N_VOLUMES - 1)
    corner = jax.jit(_corner_data_flat, static_argnums=(0,))
    scales = _level_scales(N_LEVELS)
    got = hash_corner_indices(*_targs(prim, bias, pts, anc), local).numpy()
    assert got.shape == (N_LEVELS, 8, len(pts))
    for l in range(N_LEVELS):
        idx, _ = corner(local, jnp.asarray(prim[l]), jnp.asarray(bias[l]),
                        jnp.asarray(scales[l]), jnp.asarray(pts), vol,
                        jnp.ones(len(pts), jnp.float32))
        np.testing.assert_array_equal(
            got[l], np.asarray(idx).reshape(8, len(pts)), err_msg=str(l))
    assert 0 <= got.min() and got.max() < local


@pytest.mark.parametrize("c,n_invalid", [(2, 0), (4, 0), (2, 300), (4, 300)])
def test_encode_raw_matches_jax_sorted_forward(c, n_invalid):
    """The plain forward against the jitted forward of
    ``hash_encode_sorted`` (bf16 table), atol 1e-6; masked points zero."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.hash_encoding import hash_encode_sorted
    from gfnerf_tpu_torch.fields.hash_encoding import hash_encode_raw

    feat, prim, bias = _tables(c)
    pts, anc = _points(n_invalid=n_invalid, seed=c)
    j = np.asarray(jax.jit(hash_encode_sorted)(
        jnp.asarray(feat), jnp.asarray(prim), jnp.asarray(bias),
        jnp.asarray(pts), jnp.asarray(anc)))
    t = hash_encode_raw(torch.as_tensor(feat),
                        *_targs(prim, bias, pts, anc)).numpy()
    assert t.shape == j.shape == (len(pts), N_LEVELS * c)
    assert np.abs(t).max() > 0.05
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert np.all(t[anc < 0] == 0)


@pytest.mark.parametrize("c", [2, 4])
def test_backward_matches_jax_autodiff(c):
    """The plain table gradient against JAX's autodiff of the f32 encode
    ``hash_encode_raw``.  In that graph XLA does not contract ``p * scale +
    bias``, so its coordinates, of size up to 1100, differ from the port's
    fused ones by up to one f32 ulp (1.2e-4) and the corner weights with
    them: sums of some 32 terms of |g| up to 4 differ by up to 3e-4 (seen
    2.9e-4): atol 1e-3 on entries up to 10.  With the port's coordinates
    rounded JAX's way here, the same comparison holds to 1e-5."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.hash_encoding import hash_encode_raw as jenc
    from gfnerf_tpu_torch.fields import hash_encoding as T

    feat, prim, bias = _tables(c)
    pts, anc = _points(n_invalid=200, seed=3 + c)
    g = np.random.default_rng(3).standard_normal(
        (len(pts), N_LEVELS * c)).astype(np.float32)

    @jax.jit
    def table_grad(table, g):
        _, vjp = jax.vjp(lambda t: jenc(t, jnp.asarray(prim),
                                        jnp.asarray(bias), jnp.asarray(pts),
                                        jnp.asarray(anc)), table)
        return vjp(g)[0]

    jg = np.asarray(table_grad(jnp.asarray(feat), jnp.asarray(g)))
    args = (torch.as_tensor(g), *_targs(prim, bias, pts, anc), 1 << LOG2, c)
    tg = T.hash_backward_reference(*args).numpy()
    assert tg.shape == jg.shape and np.abs(tg).max() > 1.0
    np.testing.assert_allclose(tg, jg, rtol=1e-4, atol=1e-3)
    fma = T._fma
    T._fma = lambda a, s, b: a * float(s) + b   # two roundings
    try:
        unfused = T.hash_backward_reference(*args).numpy()
    finally:
        T._fma = fma
    np.testing.assert_allclose(unfused, jg, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("c", [2, 4])
def test_backward_matches_f64_autograd(c):
    """The plain table gradient against autograd of the plain forward's sum
    over a float64 table (no bf16 read), to 1e-5."""
    from gfnerf_tpu_torch.fields import hash_encoding as T

    _, prim, bias = _tables(c)
    pts, anc = _points(n_invalid=100, seed=9 + c)
    g = torch.as_tensor(np.random.default_rng(9).standard_normal(
        (len(pts), N_LEVELS * c)).astype(np.float32))
    tprim, tbias, tp, ta = _targs(prim, bias, pts, anc)
    local = 1 << LOG2
    table = torch.zeros((N_LEVELS, local, c), dtype=torch.float64,
                        requires_grad=True)
    prims, biases = T._anchor_rows(tprim, tbias, ta)
    scales = T._level_scales(N_LEVELS)
    cols = []
    for l in range(N_LEVELS):
        acc = 0.0
        for idx, w in T._level_corners(tp, prims[l], biases[l], scales[l],
                                       local):
            acc = acc + w.double()[:, None] * table[l][idx]
        cols.append(acc * (ta >= 0)[:, None])
    (ref,) = torch.autograd.grad(torch.cat(cols, -1), table, g.double())
    got = T.hash_backward_reference(g, tprim, tbias, tp, ta, local, c)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("c", [2, 4])
def test_backward_matches_jax_sorted_vjp(c):
    """The plain table gradient against the JAX package's custom VJP
    (``_hes_bwd``), at the JAX tests' tolerance for its bf16 payload (rtol
    2e-2, atol 2e-2)."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.hash_encoding import hash_encode_sorted
    from gfnerf_tpu_torch.fields.hash_encoding import hash_backward_reference

    feat, prim, bias = _tables(c)
    pts, anc = _points(n_invalid=200, seed=5 + c)
    g = np.random.default_rng(5).standard_normal(
        (len(pts), N_LEVELS * c)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: hash_encode_sorted(
        t, jnp.asarray(prim), jnp.asarray(bias), jnp.asarray(pts),
        jnp.asarray(anc)), jnp.asarray(feat))
    (jg,) = vjp(jnp.asarray(g))
    tg = hash_backward_reference(torch.as_tensor(g),
                                 *_targs(prim, bias, pts, anc), 1 << LOG2,
                                 c).numpy()
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=2e-2, atol=2e-2)


def test_autograd_cpu_takes_plain_pair():
    """Autograd through the wrapper on CPU tensors gives the plain forward
    and table gradient, nothing for the other inputs, and launches no
    kernel; ``plain_hash_encode`` is the same function."""
    from gfnerf_tpu_torch.fields.hash_encoding import (
        hash_backward_reference, hash_encode, hash_encode_raw,
        plain_hash_encode)

    feat, prim, bias = _tables(2)
    pts, anc = _points(p=512, n_invalid=50)
    g = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (512, N_LEVELS * 2)).astype(np.float32))
    args = list(_targs(prim, bias, pts, anc))
    args[2].requires_grad_(True)
    before = (hash_encode.launches, hash_encode.bwd_launches)
    grads = []
    for fn in (hash_encode, plain_hash_encode):
        table = torch.tensor(feat, requires_grad=True)
        out = fn(table, *args)
        assert torch.equal(out, hash_encode_raw(table.detach(), *args))
        out.backward(g)
        grads.append(table.grad)
    assert (hash_encode.launches, hash_encode.bwd_launches) == before
    assert args[2].grad is None
    ref = hash_backward_reference(g, args[0], args[1], args[2].detach(),
                                  args[3], 1 << LOG2, 2)
    torch.testing.assert_close(grads[0], ref, rtol=0, atol=0)
    torch.testing.assert_close(grads[1], ref, rtol=0, atol=0)


@pytest.mark.parametrize("c,in_place", [(2, False), (2, True), (4, False),
                                        (4, True)])
def test_encode_with_base_is_the_sum(c, in_place):
    """``hash_encode`` and ``plain_hash_encode`` given a base return ``base +
    hash_encode`` bit for bit; out of place the base is unchanged, in place
    the result is the base's own storage.  Masked points add exact zeros."""
    from gfnerf_tpu_torch.fields.hash_encoding import (hash_encode,
                                                       hash_encode_raw,
                                                       plain_hash_encode)

    feat, prim, bias = _tables(c)
    pts, anc = _points(p=1000, n_invalid=100, seed=c)
    args = _targs(prim, bias, pts, anc)
    table = torch.as_tensor(feat)
    base0 = torch.as_tensor(np.random.default_rng(c).standard_normal(
        (1000, N_LEVELS * c)).astype(np.float32))
    want = base0 + hash_encode_raw(table, *args)
    assert torch.equal(hash_encode_raw(table, *args, base=base0), want)
    for fn in (hash_encode, plain_hash_encode):
        base = base0.clone()
        got = fn(table, *args, base, in_place)
        assert torch.equal(got, want)
        assert (got.data_ptr() == base.data_ptr()) == in_place
        if not in_place:
            assert torch.equal(base, base0)
    assert torch.equal(want[args[3] < 0], base0[args[3] < 0])


def test_encode_base_checks():
    """A base that requires a gradient raises, as does ``in_place`` without
    a base, a base of the wrong shape, or a base with gaps written in place;
    a base with gaps out of place is copied and gives the same sum."""
    from gfnerf_tpu_torch.fields.hash_encoding import hash_encode

    feat, prim, bias = _tables(2)
    pts, anc = _points(p=64)
    args = _targs(prim, bias, pts, anc)
    table = torch.as_tensor(feat)
    cols = N_LEVELS * 2
    with pytest.raises(ValueError, match="gradient"):
        hash_encode(table, *args, torch.zeros((64, cols), requires_grad=True))
    with pytest.raises(ValueError, match="needs a base"):
        hash_encode(table, *args, None, True)
    with pytest.raises(ValueError, match="base must be"):
        hash_encode(table, *args, torch.zeros((64, cols + 1)))
    wide = torch.ones((64, 2 * cols))
    gaps = wide[:, ::2]
    assert not gaps.is_contiguous()
    with pytest.raises(ValueError, match="contiguous"):
        hash_encode(table, *args, gaps, True)
    assert torch.equal(hash_encode(table, *args, gaps),
                       gaps.contiguous() + hash_encode(table, *args))


@pytest.mark.parametrize("in_place", [False, True])
def test_table_gradient_unchanged_with_base(in_place):
    """The table's gradient through ``hash_encode`` given a base is the
    gradient without one (the base is a constant of the sum); in place, the
    base becomes the output of the table's graph."""
    from gfnerf_tpu_torch.fields.hash_encoding import hash_encode

    feat, prim, bias = _tables(2)
    pts, anc = _points(p=512, n_invalid=50)
    args = _targs(prim, bias, pts, anc)
    g = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (512, N_LEVELS * 2)).astype(np.float32))
    grads = []
    for base in (None, torch.full((512, N_LEVELS * 2), 0.25)):
        table = torch.tensor(feat, requires_grad=True)
        out = hash_encode(table, *args, base, in_place and base is not None)
        out.backward(g)
        grads.append(table.grad)
        if base is not None:
            assert base.requires_grad == in_place
    torch.testing.assert_close(grads[1], grads[0], rtol=0, atol=0)


def test_wrapper_rejects_what_the_kernels_do_not_take():
    from gfnerf_tpu_torch.fields import hash_encoding as T

    feat, prim, bias = _tables(2)
    pts, anc = _points(p=64)
    args = _targs(prim, bias, pts, anc)
    with pytest.raises(ValueError):   # the kernels run on CUDA tensors only
        T._hash_encode_cuda(torch.as_tensor(feat), *args)
    with pytest.raises(ValueError):   # a table size that is no power of two
        T.hash_encode_raw(torch.zeros((N_LEVELS, 48, 2)), *args)


@pytest.mark.cuda
@pytest.mark.parametrize("c,n_levels,log2", [(2, 4, 10), (4, 4, 10),
                                             (2, 16, 14), (4, 5, 12)])
def test_kernels_match_plain_on_card(c, n_levels, log2):
    """H4 against the plain forward (bit for bit) and H5 through autograd
    against the plain table gradient (1e-5 of its largest entry: the same
    f32 terms, added by atomics in another order): one call of each, H4
    launching once per group of ``FWD_LEVEL_GROUP`` levels, H5 once per
    group of 8 / C levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields.hash_encoding import (
        encode_launches, hash_backward_reference, hash_encode,
        hash_encode_raw, init_hash_params, table_grad_launches)

    _, prim, bias = init_hash_params(7, log2, N_VOLUMES, n_levels, c)
    feat = np.random.default_rng(7).uniform(
        -0.5, 0.5, (n_levels, 1 << log2, c)).astype(np.float32)
    pts, anc = _points(p=(1 << 16) + 37, n_invalid=1000)
    args = [a.cuda() for a in _targs(prim, bias, pts, anc)]
    table = torch.tensor(feat, device="cuda", requires_grad=True)
    before = (hash_encode.calls, hash_encode.launches,
              hash_encode.bwd_launches)
    out = hash_encode(table, *args)
    g = torch.randn(out.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    out.backward(g)
    torch.cuda.synchronize()
    assert (hash_encode.calls, hash_encode.launches,
            hash_encode.bwd_launches) == (
        before[0] + 1, before[1] + encode_launches(n_levels),
        before[2] + table_grad_launches(n_levels, c))
    assert torch.equal(out.detach(), hash_encode_raw(table.detach(), *args))
    assert bool((out[args[3] < 0] == 0).all())
    ref = hash_backward_reference(g, *args, 1 << log2, c)
    np.testing.assert_allclose(table.grad.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("c,n_levels", [(2, 16), (4, 5)])
@pytest.mark.parametrize("table_type", ["f32", "bf16"])
@pytest.mark.parametrize("per_launch", [1, 2, 4, 8, 16])
def test_encode_groupings_and_base_on_card(per_launch, table_type, c,
                                           n_levels):
    """H4 at 1, 2, 4, 8 and 16 levels a launch, from the f32 table (each
    value rounded to bf16 as it is read) and from its bf16 copy, without a
    base, on a base out of place and in place: each equal to the plain
    version bit for bit, masked points exactly 0 (or the base's), one
    launch per group of levels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields import hash_encoding as T

    log2 = 14
    _, prim, bias = T.init_hash_params(7, log2, N_VOLUMES, n_levels, c)
    feat = np.random.default_rng(7).uniform(
        -0.5, 0.5, (n_levels, 1 << log2, c)).astype(np.float32)
    pts, anc = _points(p=(1 << 15) + 37, n_invalid=1000)
    args = [a.cuda() for a in _targs(prim, bias, pts, anc)]
    f32 = torch.as_tensor(feat, device="cuda")
    table = f32 if table_type == "f32" else f32.to(torch.bfloat16)
    want = T.hash_encode_raw(f32, *args)
    base = torch.randn(want.shape, device="cuda",
                       generator=torch.Generator("cuda").manual_seed(c))
    for form in ("alone", "base", "in_place"):
        before = T.hash_encode.launches
        buf = base.clone()
        got = T._hash_encode_cuda(table, *args,
                                  base=None if form == "alone" else buf,
                                  in_place=form == "in_place",
                                  levels_per_launch=per_launch)
        torch.cuda.synchronize()
        assert T.hash_encode.launches - before == \
            T.encode_launches(n_levels, per_launch)
        expect = want if form == "alone" else base + want
        assert torch.equal(got, expect), form
        assert (got.data_ptr() == buf.data_ptr()) == (form == "in_place")
        if form == "base":
            assert torch.equal(buf, base)
        masked = args[3] < 0
        assert torch.equal(got[masked], torch.zeros_like(got[masked])
                           if form == "alone" else base[masked])


def _one_cell(p, anchors, shared_bias=False):
    """Hand-made inputs of the reduction count: ``p`` points within 1e-7 of
    one point (one cell at every level) with the given anchors; with
    ``shared_bias`` volumes 0 and 1 have equal biases, so their cells are
    equal too, under other primes."""
    _, prim, bias = _tables(2)
    if shared_bias:
        bias = bias.copy()
        bias[:, 1] = bias[:, 0]
    pts = np.full((p, 3), 0.4371, np.float32)
    pts += np.random.default_rng(0).uniform(0, 1e-7, (p, 3)).astype(
        np.float32)
    return _targs(prim, bias, pts, np.asarray(anchors, np.int32))


# case -> (points, anchors, shared bias, reductions per level)
REDUCTION_CASES = {
    # one run of 32 points is one contributor of 8 corners
    "one_warp": (32, [1] * 32, False, 8),
    # a run that crosses a 32-point boundary counts once in each warp
    "crosses_boundary": (64, [1] * 64, False, 16),
    # a masked anchor splits its run in two and adds nothing itself
    "masked_splits": (32, [1] * 10 + [-1] + [1] * 21, False, 16),
    # masked points at a run's ends shorten it, no more
    "masked_ends": (32, [-1] + [1] * 30 + [-1], False, 8),
    # equal cells in two volumes (other primes) do not merge
    "two_volumes": (32, [0, 1] * 16, True, 8 * 32),
    # the same points in one volume do
    "one_volume": (32, [0] * 32, True, 8),
    # P not a multiple of 32: the last warp is short
    "ragged": (45, [2] * 45, False, 16),
    # nothing valid, nothing added
    "all_masked": (40, [-1] * 40, False, 0),
}


@pytest.mark.parametrize("case", sorted(REDUCTION_CASES))
def test_bwd_reduction_count(case):
    """``hash_bwd_reductions`` on hand-made inputs: one contributor of 8
    corners per run of equal (volume, cell) among a warp's 32 consecutive
    points; with warps of one point, 8 per valid point."""
    from gfnerf_tpu_torch.fields.hash_encoding import (hash_bwd_reductions,
                                                       hash_corner_indices)

    p, anchors, shared, want = REDUCTION_CASES[case]
    args = _one_cell(p, anchors, shared)
    cells = hash_corner_indices(*args, 1 << LOG2)
    if case in ("one_warp", "crosses_boundary", "ragged"):
        assert bool((cells == cells[..., :1]).all())   # one cell indeed
    ops = hash_bwd_reductions(*args)
    assert ops.dtype == torch.int64
    assert ops.tolist() == [want] * N_LEVELS
    n_valid = sum(a >= 0 for a in anchors)
    assert hash_bwd_reductions(*args, warp=1).tolist() == \
        [8 * n_valid] * N_LEVELS


def _run_inputs(n_rays=40, n_samples=97, seed=5):
    """(points, anchors, bias) with runs of equal cells: rays of points
    2e-4 apart in t order, one anchor per ray; anchors < 0 inside the runs
    of the odd rays; volumes 0 and 1 with equal biases and every fourth ray
    alternating between them."""
    _, prim, bias = _tables(2)
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.arange(n_samples)[None, :, None] * 2e-4
    pts = (rng.uniform(0.3, 0.7, (n_rays, 1, 3)) + t * d).reshape(-1, 3)
    anc = np.repeat(rng.integers(0, N_VOLUMES, n_rays), n_samples).reshape(
        n_rays, n_samples)
    anc[::4] = np.arange(n_samples) % 2
    for i in (5, 21, 22, 23, 24, 25, 31, 32, 64, 65, 90):
        anc[1::2, i] = -1
    bias = bias.copy()
    bias[:, 1] = bias[:, 0]
    return prim, bias, pts.astype(np.float32), anc.reshape(-1).astype(
        np.int32)


def test_bwd_reduction_count_on_runs():
    """On rays of close points the count lies between one contributor per
    warp and one per valid point, rises with the level (shorter runs on
    finer grids), and equals a plain loop over the points."""
    from gfnerf_tpu_torch.fields import hash_encoding as T

    prim, bias, pts, anc = _run_inputs()
    args = _targs(prim, bias, pts, anc)
    ops = T.hash_bwd_reductions(*args).tolist()
    single = T.hash_bwd_reductions(*args, warp=1).tolist()
    assert single == [8 * int((anc >= 0).sum())] * N_LEVELS
    assert all(8 * -(-len(pts) // 32) <= o < s for o, s in zip(ops, single))
    assert ops[0] < ops[-1]
    # the same count by a loop over the points, from the corner addressing's
    # own cells
    vol = np.clip(anc, 0, N_VOLUMES - 1)
    scales = T._level_scales(N_LEVELS)
    for l in range(N_LEVELS):
        cells = T._level_cells(args[2], args[1][l][torch.as_tensor(vol).long()],
                               scales[l])
        key = np.stack([vol, *(x0.numpy() for x0, _ in cells)], -1)
        heads = 0
        for i in range(len(pts)):
            if anc[i] < 0:
                continue
            joins = (i % 32 != 0 and anc[i - 1] >= 0
                     and np.array_equal(key[i], key[i - 1]))
            heads += not joins
        assert ops[l] == 8 * heads, l


@pytest.mark.cuda
@pytest.mark.parametrize("c,n_levels,log2", [(2, 4, 10), (4, 4, 10),
                                             (2, 16, 14)])
def test_backward_kernel_merges_runs_on_card(c, n_levels, log2):
    """H5 on runs of equal cells (masked anchors inside, two volumes sharing
    cells) against the plain table gradient (1e-5 of its largest entry),
    its reductions per level against ``hash_bwd_reductions``, and the same
    gradient at 1, 2, 4 and 16 levels per launch, one launch per group."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields import hash_encoding as T

    _, prim, _ = T.init_hash_params(7, log2, N_VOLUMES, n_levels, c)
    _, bias, pts, anc = _run_inputs(n_rays=300)
    bias = np.tile(bias, (n_levels // N_LEVELS + 1, 1, 1))[:n_levels]
    args = [a.cuda() for a in _targs(prim, bias, pts, anc)]
    g = torch.randn((len(pts), n_levels * c), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    before = (T.hash_encode.bwd_calls, T.hash_encode.bwd_launches)
    grad = T._hash_backward_cuda(g, *args, 1 << log2, c, red_ops=ops)
    torch.cuda.synchronize()
    # one call, whose C entry point launches once per group of 8 / C levels
    assert (T.hash_encode.bwd_calls, T.hash_encode.bwd_launches) == (
        before[0] + 1, before[1] + -(-n_levels // (8 // c)))
    ref = T.hash_backward_reference(g, *args, 1 << log2, c)
    tol = 1e-5 * float(ref.abs().max())
    np.testing.assert_allclose(grad.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=tol)
    want = T.hash_bwd_reductions(*args)
    assert ops.tolist() == want.tolist()
    assert int(ops.sum()) < 8 * n_levels * int((args[3] >= 0).sum())
    for per_launch in (1, 2, 4, 16):
        before = T.hash_encode.bwd_launches
        got = T._hash_backward_cuda(g, *args, 1 << log2, c,
                                    levels_per_launch=per_launch)
        assert T.hash_encode.bwd_launches - before == \
            -(-n_levels // min(per_launch, n_levels))
        np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                                   rtol=0, atol=tol)


# ---- the anchored layout through the field and the train step ----

ANCHORED = dict(hash_layout="anchored", log2_hashmap_size=12, num_levels=4,
                features_per_level=2)


@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
def test_anchored_init_and_round_trip(focal_mode):
    """``init_field_params`` draws the anchored tables as the JAX package
    does, and ``params_from_jax`` / ``to_numpy`` carry them across."""
    from gfnerf_tpu.fields.field import FieldConfig as JCfg
    from gfnerf_tpu.fields.field import init_field_params as jinit
    from gfnerf_tpu_torch.fields.field import FieldConfig, init_field_params
    from torch_parity import field_kwargs

    kw = field_kwargs(focal_mode=focal_mode, block_rows_log2=10, **ANCHORED)
    jp, js = jinit(JCfg(**kw), seed=4)
    tp, ts = init_field_params(FieldConfig(**kw), seed=4)
    for name in ("global_feat", "block_feats"):
        np.testing.assert_array_equal(getattr(tp, name),
                                      np.asarray(getattr(jp, name)), name)
    for name in ("global_prim", "global_bias", "block_prims",
                 "block_biases"):
        np.testing.assert_array_equal(getattr(ts, name),
                                      np.asarray(getattr(js, name)), name)
    assert tp.global_feat.shape == (4, 1 << 12, 2)
    rows = 12 if focal_mode == "finetune" else 10
    assert tp.block_feats.shape == (2, 4, 1 << rows, 2)
    _, params, _, field = field_pair(seed=1, block_scale=0.3, **ANCHORED)
    back, _ = field.to_numpy()
    np.testing.assert_array_equal(back.block_feats,
                                  np.asarray(params.block_feats))


@pytest.mark.parametrize("stage,focal_mode,fused",
                         [(0, "residual", True), (1, "residual", False),
                          (1, "finetune", True)])
def test_anchored_field_density_matches_jax(stage, focal_mode, fused,
                                            monkeypatch):
    """``field_density`` with the anchored layout at both stages, f32 MLPs:
    1e-5 relative to the output's scale (tests/test_torch_field.py).

    XLA:CPU contracts ``p * scale + bias`` in the init-stage and finetune
    graphs but not in the residual one (two encodes): there the JAX
    coordinates carry two roundings, its fractions differ from the port's
    by up to one ulp of a coordinate near 1100 (1.2e-4), and densities of
    about 3 by up to 1.3e-4.  ``fused=False`` holds the port to 2e-4 as it
    is, and to 1e-5 with its plain version rounding the same way."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import field as J
    from gfnerf_tpu_torch.fields import field as T
    from gfnerf_tpu_torch.fields import hash_encoding as H

    jcfg, params, statics, field = field_pair(
        seed=2, block_scale=0.3, focal_mode=focal_mode, **ANCHORED)
    rng = np.random.default_rng(0)
    warp = rng.uniform(-1.0, 1.0, (32, 24, 3)).astype(np.float32)
    anc = rng.integers(0, jcfg.n_volumes, (32, 24)).astype(np.int32)
    anc[rng.random((32, 24)) < 0.2] = -1
    want = jax.jit(lambda p, s, w, a: J.field_density(
        p, s, jcfg, w, a, stage, 1))(params, statics, jnp.asarray(warp),
                                     jnp.asarray(anc))

    def check(tol):
        with torch.no_grad():
            got = T.field_density(field, torch.as_tensor(warp),
                                  torch.as_tensor(anc), stage, 1)
        for name, g, w in zip(("density", "geo"), got, want):
            w = np.asarray(w)
            scale = max(1.0, float(np.abs(w).max()))
            np.testing.assert_allclose(g.numpy(), w, rtol=tol,
                                       atol=tol * scale, err_msg=name)
        assert np.all(got[0].numpy()[anc < 0] == 0)

    if not fused:
        check(2e-4)
        monkeypatch.setattr(H, "_fma", lambda a, s, b: a * float(s) + b)
    check(1e-5)


def test_anchored_train_step_matches_jax():
    """One init-stage train step of a tiny anchored field against the JAX
    step (f32 MLPs): losses to 1e-5; MLP gradients to 3e-3 of the group's
    largest (sums over the R * S samples in other orders, and a ReLU input
    within rounding of zero gates a sample in one package and not the
    other: seen 1.1e-3 in one of a layer's 1024 entries); the table gradient
    to 2e-2 of its largest (the JAX backward's bf16 payload); parameters to
    1e-5 where the gradient is sure; the updated octree equal."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    jcfg, params, statics, field = field_pair(mlp_dtype="float32", **ANCHORED)
    joct, toct = octree_pair()
    batch = train_batch()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S)
    (jstate, jo, jm, jerr), noise, perms = jax_train_step(
        jcfg, params, statics, joct, batch, mkw, key_seed=5)
    state, to, tm, terr = port_train_step(field, toct, batch, mkw, noise,
                                          perms)
    for k in ("loss", "rgb_loss", "s3im_loss", "psnr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-5)
    inner = jstate.opt_state.inner_state.inner_states
    groups = field_param_groups(field)
    jp = jax_groups(jstate.params)
    for name, tol in (("fields", 3e-3), ("base_encoding_init", 2e-2)):
        jg = [np.asarray(m) / 0.1 for m in jax_groups(
            inner[name].inner_state[0].mu[0])[name]]   # mu = (1 - b1) g
        scale = max(float(np.abs(g).max()) for g in jg)
        assert scale > 0
        for i, (p, g, want) in enumerate(zip(groups[name], jg, jp[name])):
            np.testing.assert_allclose(to_np(p.grad), g, rtol=tol,
                                       atol=tol * scale,
                                       err_msg=f"{name}[{i}] grad")
            sure = np.abs(g) > 2 * tol * scale
            np.testing.assert_allclose(to_np(p)[sure],
                                       np.asarray(want)[sure], rtol=0,
                                       atol=1e-5, err_msg=f"{name}[{i}]")
    assert field.global_feat.grad.shape == (4, 1 << 12, 2)
    for k in ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx"):
        np.testing.assert_array_equal(to_np(getattr(to, k)),
                                      np.asarray(getattr(jo, k)), err_msg=k)


@pytest.mark.parametrize("penalty", [0.0, 0.1])
def test_anchored_focal_train_step_matches_jax(penalty):
    """One focal (block-stage, residual) train step on block 1 of a tiny
    anchored field against the JAX package's jitted step, from identical
    parameters, batch, noise and permutations, f32 MLPs.  The block's encode
    is added to the frozen global one by the encode itself (in place
    without the empty-space penalty; beside the shared branch's global
    features with it).

    Held: the losses and per-ray errors to 1e-5 (the one-ulp coordinate
    differences of ``test_anchored_field_density_matches_jax``'s residual
    graph stay below that in a step's means); the active table's gradient
    to 2e-2 of its largest (the JAX backward's bf16 payload) and its update
    to 1e-5 where the gradient is sure; every frozen parameter and block 0
    bit-unchanged."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK

    jcfg, params, statics, field = field_pair(
        mlp_dtype="float32", block_scale=0.3, focal_mode="residual",
        block_rows_log2=10, **ANCHORED)
    joct, toct = octree_pair()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S,
               empty_space_penalty_mult=penalty, empty_space_tau=0.5)
    before = {k: [to_np(p).copy() for p in ps]
              for k, ps in field_param_groups(field).items()}
    blocks_before = to_np(field.block_feats).copy()
    (jstate, _, jm, jerr), noise, perms = jax_train_step(
        jcfg, params, statics, joct, train_batch(1), mkw, key_seed=6,
        stage=STAGE_BLOCK, active_block=1)
    state, _, tm, terr = port_train_step(
        field, toct, train_batch(1), mkw, noise, perms, stage=STAGE_BLOCK,
        active_block=1)
    keys = ["loss", "rgb_loss", "s3im_loss", "psnr"]
    if penalty:
        keys.append("empty_space_loss")
        assert float(jm["empty_space_loss"]) > 1e-6
    for k in keys:
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-5)
    adam = jstate.opt_state.inner_state.inner_states["block"].inner_state[0]
    jg = np.asarray(adam.mu[1]) / 0.1   # mu was zero: mu = (1 - b1) g
    scale = float(np.abs(jg).max())
    assert scale > 0
    mu = state.opt_state.mu["block"][0]
    np.testing.assert_allclose(to_np(mu) / 0.1, jg, rtol=2e-2,
                               atol=2e-2 * scale)
    sure = np.abs(jg) > 4e-2 * scale
    assert sure.sum() > 100
    got = to_np(field.block_feats)
    np.testing.assert_allclose(got[1][sure],
                               np.asarray(jstate.params.block_feats)[1][sure],
                               rtol=0, atol=1e-5)
    assert not np.array_equal(got[1], blocks_before[1])
    np.testing.assert_array_equal(got[0], blocks_before[0])
    for name, ps in field_param_groups(field).items():
        if name == "block":
            continue
        for i, p in enumerate(ps):
            np.testing.assert_array_equal(to_np(p), before[name][i],
                                          err_msg=f"{name}[{i}]")
