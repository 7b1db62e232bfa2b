"""Parity of the ported packed hash encode and its table gradient
(gfnerf_tpu_torch/fields/packed_hash.py) with the JAX package's.

The JAX side runs jitted, as the render path runs it: XLA then fuses
``p * scale + bias`` into one multiply-add, and the port reproduces that
rounding.  Row indices (the uint32 hash and the dense addressing) must match
exactly; features to atol 1e-6 (both sum the same bf16 table values in f32,
in the same order, up to multiply-add contraction).
"""

import itertools

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (caps torch threads)

ROWS_LOG2 = 12
N_LEVELS = 4
N_VOLUMES = 3     # small enough that dense levels fit 2^12 rows


def _tables(c, seed=7):
    """The same (feat, prim, bias) from both packages' init."""
    from gfnerf_tpu.fields.packed_hash import init_packed_hash_params as jinit
    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    kw = dict(seed=seed, n_rows_log2=ROWS_LOG2, n_volumes=N_VOLUMES,
              n_levels=N_LEVELS, n_channels=c)
    want = [np.array(x) for x in jinit(**kw)]
    got = init_packed_hash_params(**kw)
    # a non-trivial table: init's +-1e-2 is too flat to exercise the sums
    rng = np.random.default_rng(seed)
    feat = rng.uniform(-0.5, 0.5, want[0].shape).astype(np.float32)
    return want, got, feat


def _points(p=4096, seed=1, n_invalid=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.17, 0.83, (p, 3)).astype(np.float32)
    anc = rng.integers(0, N_VOLUMES, p).astype(np.int32)
    anc[rng.choice(p, n_invalid, replace=False)] = -1
    return pts, anc


# Inputs the kernels' level-major warps make risky: H2 merges runs of
# consecutive points in one cell into one contributor, and both kernels
# take tiles of several 32-point slices of consecutive points.
RUN_CASES = ("one_cell", "runs", "runs_masked")


def _run_points(case, n_rays=10, n_samples=97, seed=5):
    """(points, anchors) of ``n_rays`` rays of ``n_samples`` consecutive
    points (P is not a multiple of 32):
    'one_cell': every point within 1e-6 of one point, one anchor: one cell
        at every level;
    'runs': each ray's points 2e-4 apart in t order from a random origin, one
        anchor per ray: runs of equal cells cross the 32-point warps and the
        tiles on the coarse levels;
    'runs_masked': 'runs' with anchors < 0 inside the runs (single points,
        a stretch, and the two points around a 32-point boundary)."""
    rng = np.random.default_rng(seed)
    p = n_rays * n_samples
    if case == "one_cell":
        pts = rng.uniform(0.45, 0.55, 3) + rng.uniform(0, 1e-6, (p, 3))
        anc = np.full(p, 1)
    else:
        d = rng.standard_normal((n_rays, 1, 3))
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        t = np.arange(n_samples)[None, :, None] * 2e-4
        pts = (rng.uniform(0.3, 0.7, (n_rays, 1, 3)) + t * d).reshape(p, 3)
        anc = np.repeat(rng.integers(0, N_VOLUMES, n_rays), n_samples)
        if case == "runs_masked":
            for i in (5, 21, 22, 23, 24, 25, 31, 32, 64, 65, 90):
                anc[i::n_samples] = -1
    return pts.astype(np.float32), anc.astype(np.int32)


def _jax_rows(prim_pool, bias_pool, points, anchors, n_rows, pack,
              dense_levels):
    """The JAX encode's addressing (packed_hash.py:230-253), level by level;
    the caller jits it, as the render path runs the encode jitted."""
    import jax.numpy as jnp
    from gfnerf_tpu.fields.hash_encoding import (_anchor_slices,
                                                 _anchor_table, _level_scales)
    from gfnerf_tpu.fields.packed_hash import (_decompose_dim, _hash_flat,
                                               dense_level_extents)

    n_levels, n_volumes = prim_pool.shape[:2]
    vol = jnp.clip(anchors, 0, n_volumes - 1).astype(jnp.int32)
    scales = _level_scales(n_levels)
    dm, duse = dense_level_extents(n_levels, pack, n_volumes, n_rows,
                                   dense_levels)
    ar = _anchor_table(prim_pool, bias_pool)[vol]
    px0, py0, pz0 = points[:, 0], points[:, 1], points[:, 2]
    out = []
    for l in range(n_levels):
        (ux, uy, uz), (bx, by, bz) = _anchor_slices(ar, l * 8)
        sx, _, _ = _decompose_dim(px0 * scales[l] + bx, pack)
        sy, _, _ = _decompose_dim(py0 * scales[l] + by, pack)
        sz, _, _ = _decompose_dim(pz0 * scales[l] + bz, pack)
        if duse[l]:
            ml = int(dm[l])
            h = jnp.minimum(vol * ml ** 3 + jnp.remainder(sx, ml) * ml * ml
                            + jnp.remainder(sy, ml) * ml
                            + jnp.remainder(sz, ml), n_rows - 1)
        else:
            h = _hash_flat(sx, sy, sz, ux, uy, uz, n_rows)
        out.append(h)
    return jnp.stack(out)


@pytest.mark.parametrize("c", [2, 4, 8])
def test_init_and_layout_helpers_match(c):
    from gfnerf_tpu.fields import packed_hash as J
    from gfnerf_tpu_torch.fields import packed_hash as T

    want, got, _ = _tables(c)
    for a, b in zip(want, got):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)
    assert T.pack_for_channels(c) == J.pack_for_channels(c)
    pack = J.pack_for_channels(c)
    for dense in (0, 2, 4):
        for x, y in zip(T.dense_level_extents(N_LEVELS, pack, N_VOLUMES,
                                              1 << ROWS_LOG2, dense),
                        J.dense_level_extents(N_LEVELS, pack, N_VOLUMES,
                                              1 << ROWS_LOG2, dense)):
            assert np.array_equal(x, y)


@pytest.mark.parametrize("c,dense", [(2, 0), (4, 0), (8, 0), (4, 2)])
def test_row_indices_exact(c, dense):
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_rows)

    want, _, _ = _tables(c)
    pts, anc = _points(n_invalid=64)
    pack = pack_for_channels(c)
    rows = jax.jit(_jax_rows, static_argnums=(4, 5, 6))
    j = np.asarray(rows(jnp.asarray(want[1]), jnp.asarray(want[2]),
                        jnp.asarray(pts), jnp.asarray(anc), 1 << ROWS_LOG2,
                        pack, dense))
    t = packed_hash_rows(torch.as_tensor(want[1].astype(np.int64)),
                         torch.as_tensor(want[2]), torch.as_tensor(pts),
                         torch.as_tensor(anc), 1 << ROWS_LOG2, pack,
                         dense).numpy()
    np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("c,n_invalid,dense",
                         [(2, 0, 0), (4, 0, 0), (8, 0, 0), (4, 300, 0),
                          (4, 0, 2), (2, 300, 2)])
def test_encode_raw_matches_jax(c, n_invalid, dense):
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.packed_hash import packed_hash_encode_raw as jenc
    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode_raw)

    want, _, feat = _tables(c)
    pts, anc = _points(n_invalid=n_invalid, seed=c + dense)
    pack = pack_for_channels(c)
    j = np.asarray(jax.jit(jenc, static_argnums=(5, 6, 7))(
        jnp.asarray(feat), jnp.asarray(want[1]), jnp.asarray(want[2]),
        jnp.asarray(pts), jnp.asarray(anc), c, pack, dense))
    t = packed_hash_encode_raw(
        torch.as_tensor(feat), torch.as_tensor(want[1].astype(np.int64)),
        torch.as_tensor(want[2]), torch.as_tensor(pts), torch.as_tensor(anc),
        c, pack, dense).numpy()
    assert t.shape == j.shape == (len(pts), N_LEVELS * c)
    assert np.abs(t).max() > 0.05
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert np.all(t[anc < 0] == 0)


@pytest.mark.parametrize("case,dense", [("one_cell", 0), ("runs", 0),
                                        ("runs_masked", 0), ("runs", 2)])
def test_encode_raw_matches_jax_on_runs(case, dense):
    """The plain forward against the jitted JAX encode on runs of equal
    cells (atol 1e-6, as above); masked points exactly zero."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.packed_hash import packed_hash_encode_raw as jenc
    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode_raw,
                                                     packed_hash_rows)

    want, _, feat = _tables(4)
    pts, anc = _run_points(case)
    pack = pack_for_channels(4)
    targs = (torch.as_tensor(want[1].astype(np.int64)),
             torch.as_tensor(want[2]), torch.as_tensor(pts),
             torch.as_tensor(anc))
    if case == "one_cell":
        rows = packed_hash_rows(*targs, 1 << ROWS_LOG2, pack)
        assert bool((rows == rows[:, :1]).all())
    j = np.asarray(jax.jit(jenc, static_argnums=(5, 6, 7))(
        jnp.asarray(feat), jnp.asarray(want[1]), jnp.asarray(want[2]),
        jnp.asarray(pts), jnp.asarray(anc), 4, pack, dense))
    t = packed_hash_encode_raw(torch.as_tensor(feat), *targs, 4, pack,
                               dense).numpy()
    assert np.abs(t).max() > 0.05
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    assert np.all(t[anc < 0] == 0)


def test_wrapper_cpu_takes_plain_path():
    from gfnerf_tpu_torch.fields.packed_hash import (packed_hash_encode,
                                                     packed_hash_encode_raw)

    want, _, feat = _tables(4)
    pts, anc = _points(p=512, n_invalid=10)
    args = (torch.as_tensor(feat), torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.as_tensor(pts),
            torch.as_tensor(anc), 4, 2)
    before = packed_hash_encode.launches
    got = packed_hash_encode(*args)
    assert packed_hash_encode.launches == before
    assert torch.equal(got, packed_hash_encode_raw(*args))


# (channels, dense levels, inputs) of the kernel-vs-plain tests on the card:
# random points at each lattice shape, and the run cases
CARD_CASES = [(2, 0, "random"), (4, 0, "random"), (8, 0, "random"),
              (4, 2, "random"), (4, 0, "one_cell"), (4, 0, "runs"),
              (4, 0, "runs_masked"), (4, 2, "runs"), (2, 0, "runs_masked"),
              (8, 0, "runs_masked")]


def _card_inputs(c, case):
    """(prim, bias, points, anchors) numpy for one card case: 2^16 random
    points with 1000 masked, or 300 rays of 97 points."""
    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    _, prim, bias = init_packed_hash_params(7, ROWS_LOG2, N_VOLUMES,
                                            N_LEVELS, c)
    if case == "random":
        pts, anc = _points(p=1 << 16, n_invalid=1000)
    else:
        pts, anc = _run_points(case, n_rays=300)
    return prim.astype(np.int64), bias, pts, anc


@pytest.mark.cuda
@pytest.mark.parametrize("c,dense,case", CARD_CASES)
def test_kernel_matches_plain_on_card(c, dense, case):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode,
                                                     packed_hash_encode_raw)

    feat = np.random.default_rng(7).uniform(
        -0.5, 0.5, (N_LEVELS, 1 << ROWS_LOG2, 128)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in
            (feat, *_card_inputs(c, case))]
    pack = pack_for_channels(c)
    before = packed_hash_encode.launches
    got = packed_hash_encode(*args, c, pack, dense)
    torch.cuda.synchronize()
    assert packed_hash_encode.launches == before + 1
    ref = packed_hash_encode_raw(*args, c, pack, dense)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5)
    assert bool((got[args[4] < 0] == 0).all())


def _bwd_args(c, dense, n_invalid, p=4096, seed=3):
    """(want tables, torch args of the backward, numpy g) for one case."""
    want, _, _ = _tables(c)
    pts, anc = _points(p=p, n_invalid=n_invalid, seed=seed + c + dense)
    g = np.random.default_rng(seed).standard_normal(
        (p, N_LEVELS * c)).astype(np.float32)
    return want, pts, anc, g


@pytest.mark.parametrize("c,n_invalid,dense",
                         [(2, 0, 0), (4, 300, 0), (8, 0, 0), (4, 0, 2)])
def test_backward_matches_jax_vjp(c, n_invalid, dense):
    """The plain table gradient against the JAX package's custom VJP
    (``_phe_bwd``), at the JAX tests' tolerance (rtol 2e-2, atol 2e-2:
    the JAX backward rounds its payload to bf16); columns past the lattice
    exactly zero."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.packed_hash import packed_hash_encode as jenc
    from gfnerf_tpu_torch.fields.packed_hash import (
        pack_for_channels, packed_hash_backward_reference)

    want, pts, anc, g = _bwd_args(c, dense, n_invalid)
    pack = pack_for_channels(c)
    _, vjp = jax.vjp(lambda t: jenc(t, jnp.asarray(want[1]),
                                    jnp.asarray(want[2]), jnp.asarray(pts),
                                    jnp.asarray(anc), c, pack, dense),
                     jnp.asarray(want[0]))
    (jg,) = vjp(jnp.asarray(g))
    tg = packed_hash_backward_reference(
        torch.as_tensor(g), torch.as_tensor(want[1].astype(np.int64)),
        torch.as_tensor(want[2]), torch.as_tensor(pts), torch.as_tensor(anc),
        1 << ROWS_LOG2, 128, c, pack, dense).numpy()
    live = (pack + 1) ** 3 * c
    assert np.all(tg[..., live:] == 0)
    assert np.abs(tg).max() > 1.0
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case,dense", [("one_cell", 0), ("runs", 0),
                                        ("runs_masked", 0), ("runs", 2)])
def test_backward_matches_jax_vjp_on_runs(case, dense):
    """The plain table gradient against ``_phe_bwd``'s VJP on runs of equal
    cells, at the tolerance above; columns past the lattice exactly zero."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.packed_hash import packed_hash_encode as jenc
    from gfnerf_tpu_torch.fields.packed_hash import (
        pack_for_channels, packed_hash_backward_reference)

    want, _, _ = _tables(4)
    pts, anc = _run_points(case)
    g = np.random.default_rng(11).standard_normal(
        (len(pts), N_LEVELS * 4)).astype(np.float32)
    pack = pack_for_channels(4)
    _, vjp = jax.vjp(lambda t: jenc(t, jnp.asarray(want[1]),
                                    jnp.asarray(want[2]), jnp.asarray(pts),
                                    jnp.asarray(anc), 4, pack, dense),
                     jnp.asarray(want[0]))
    (jg,) = vjp(jnp.asarray(g))
    tg = packed_hash_backward_reference(
        torch.as_tensor(g), torch.as_tensor(want[1].astype(np.int64)),
        torch.as_tensor(want[2]), torch.as_tensor(pts), torch.as_tensor(anc),
        1 << ROWS_LOG2, 128, 4, pack, dense).numpy()
    assert np.all(tg[..., (pack + 1) ** 3 * 4:] == 0)
    assert np.abs(tg).max() > 1.0
    np.testing.assert_allclose(tg, np.asarray(jg), rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("case", RUN_CASES)
def test_bwd_reduction_count(case):
    """The atomics H2 issues: a counter and a cursor atomic per run of
    consecutive points in one row within a 32-point warp (no row of these
    inputs holds more than BWD_CHUNK records, so no 64-bit reduction);
    with warps of one point, two per valid point.  The count does not
    depend on the channels."""
    from gfnerf_tpu_torch.fields.packed_hash import (
        BWD_CHUNK, pack_for_channels, packed_hash_bwd_reductions)

    want, _, _ = _tables(4)
    pts, anc = _run_points(case)
    assert len(pts) <= BWD_CHUNK
    args = (torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.as_tensor(pts),
            torch.as_tensor(anc), 1 << ROWS_LOG2)
    pack = pack_for_channels(4)
    ops = packed_hash_bwd_reductions(*args, 4, pack).numpy()
    n_valid = int((anc >= 0).sum())
    single = packed_hash_bwd_reductions(*args, 4, pack, warp=1).numpy()
    assert np.array_equal(single, np.full(N_LEVELS, 2 * n_valid))
    assert np.all(ops <= single)
    assert np.array_equal(
        packed_hash_bwd_reductions(*args, 8, pack).numpy(), ops)
    if case == "one_cell":
        assert np.array_equal(ops, np.full(N_LEVELS,
                                           2 * -(-len(pts) // 32)))
    else:   # runs are longer on the coarse levels
        assert ops[0] < ops[-1]
    if case == "runs_masked":
        # no run continues across a masked point: more runs on the coarsest
        # level than with the same points unmasked
        unmasked = packed_hash_bwd_reductions(
            *args[:3], torch.as_tensor(_run_points("runs")[1]), args[4], 4,
            pack).numpy()
        assert ops[0] > unmasked[0]


@pytest.mark.parametrize("c", [2, 4, 8])
def test_bwd_reduction_count_long_rows(c):
    """A row of more than BWD_CHUNK records is summed in chunks of
    BWD_CHUNK, each adding the row's (pack + 1)^3 C lattice columns into
    the row's slot with one 64-bit reduction apiece: 2910 points in one
    cell are 3 chunks of their row at every level, besides the counter and
    cursor atomics of the warps' runs; 970 points, one chunk and no
    reduction."""
    from gfnerf_tpu_torch.fields.packed_hash import (
        BWD_CHUNK, pack_for_channels, packed_hash_bwd_reductions)

    want, _, _ = _tables(c)
    pack = pack_for_channels(c)
    live = (pack + 1) ** 3 * c
    for n_rays, chunks in ((30, 3), (10, 0)):
        pts, anc = _run_points("one_cell", n_rays=n_rays)
        assert -(-len(pts) // BWD_CHUNK) == max(chunks, 1)
        ops = packed_hash_bwd_reductions(
            torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.as_tensor(pts),
            torch.as_tensor(anc), 1 << ROWS_LOG2, c, pack).numpy()
        runs = 2 * -(-len(pts) // 32)
        assert np.array_equal(ops, np.full(N_LEVELS, runs + chunks * live))


def _bucket_case(case, c=4, dense=0):
    """(g, prim, bias, points, anchors) torch inputs for the record tests."""
    want, _, _ = _tables(c)
    if case == "random":
        pts, anc = _points(p=1500, n_invalid=100)
    else:
        pts, anc = _run_points(case, n_rays=30)
    g = np.random.default_rng(11).standard_normal(
        (len(pts), N_LEVELS * c)).astype(np.float32)
    return (torch.as_tensor(g), torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.as_tensor(pts),
            torch.as_tensor(anc))


@pytest.mark.parametrize("case,c,dense", [("random", 4, 0), ("random", 2, 2),
                                          ("one_cell", 4, 0), ("runs", 8, 0),
                                          ("runs_masked", 4, 2)])
def test_bwd_records_match_argsort_by_row(case, c, dense):
    """H2's row buckets (``packed_hash_bwd_records``: the count, the scan,
    the scatter) against a torch.argsort of the valid (point, level) pairs
    by (level, row): each bucket's start is the exclusive scan of the
    counts and holds exactly the pairs of its row; every record carries its
    pair's clamped local cell, fraction and level columns of g, as the
    plain gradient's addressing forms them."""
    from gfnerf_tpu_torch.fields.packed_hash import (_level_coords,
                                                     _anchor_rows,
                                                     dense_level_extents,
                                                     pack_for_channels,
                                                     packed_hash_bwd_records)
    from gfnerf_tpu_torch.fields.hash_encoding import _level_scales

    g, prim, bias, pts, anc = _bucket_case(case, c, dense)
    pack = pack_for_channels(c)
    n_rows = 1 << ROWS_LOG2
    rec = packed_hash_bwd_records(g, prim, bias, pts, anc, n_rows, c, pack,
                                  dense)
    vol, prims, biases = _anchor_rows(prim, bias, anc)
    dm, _ = dense_level_extents(N_LEVELS, pack, N_VOLUMES, n_rows, dense)
    scales = _level_scales(N_LEVELS)
    valid = np.flatnonzero(anc.numpy() >= 0)
    key, point, loc, frac, gcol = [], [], [], [], []
    for l in range(N_LEVELS):
        h, lo, fr = _level_coords(pts, prims[l], biases[l], scales[l], vol,
                                  pack, n_rows, int(dm[l]))
        key.append(l * n_rows + h[valid])
        point.append(torch.as_tensor(valid))
        loc.append(torch.stack([x.clamp(-2, pack + 1) for x in lo], -1)[valid])
        frac.append(torch.stack(fr, -1)[valid])
        gcol.append(g[valid, l * c:(l + 1) * c])
    key = torch.cat(key)
    order = torch.argsort(key, stable=True)
    counts = torch.bincount(key, minlength=N_LEVELS * n_rows)
    assert torch.equal(rec["counts"], counts)
    assert torch.equal(rec["starts"][1:], torch.cumsum(counts, 0))
    assert int(rec["starts"][0]) == 0
    assert torch.equal(rec["key"], key[order])
    for name, want in (("point", torch.cat(point)), ("loc", torch.cat(loc)),
                       ("frac", torch.cat(frac)), ("g", torch.cat(gcol))):
        assert torch.equal(rec[name], want[order]), name
    if case == "one_cell":   # every level's records in one row
        assert int((counts > 0).sum()) == N_LEVELS


@pytest.mark.parametrize("case,c,dense", [("random", 4, 0), ("one_cell", 4, 0),
                                          ("one_cell", 8, 0), ("runs", 2, 2),
                                          ("runs_masked", 4, 0)])
def test_bwd_records_summed_by_row_chunks(case, c, dense):
    """The owner pass on the plain records: each row's records summed in
    chunks of BWD_CHUNK, the chunks' int64 partial sums added (as a long
    row's chunks add into its slot), then converted: the plain table
    gradient bit for bit (one_cell's rows hold 2910 records, three
    chunks)."""
    from gfnerf_tpu_torch.fields.hash_encoding import _pow2, fixed_point_shifts
    from gfnerf_tpu_torch.fields.packed_hash import (
        BWD_CHUNK, pack_for_channels, packed_hash_backward_reference,
        packed_hash_bwd_records)

    g, prim, bias, pts, anc = _bucket_case(case, c, dense)
    pack = pack_for_channels(c)
    e = pack + 1
    n_rows = 1 << ROWS_LOG2
    rec = packed_hash_bwd_records(g, prim, bias, pts, anc, n_rows, c, pack,
                                  dense)
    shift, finite = fixed_point_shifts(g, N_LEVELS, c)
    assert bool(finite.all())
    level = torch.div(rec["key"], n_rows, rounding_mode="floor")
    corner_cols, qs = [], []
    for corner in itertools.product((0, 1), repeat=3):
        pos = rec["loc"] + torch.tensor(corner)
        inside = ((pos >= 0) & (pos < e)).all(-1)
        wt = [torch.where(torch.tensor(bool(u)), rec["frac"][:, a],
                          1.0 - rec["frac"][:, a])
              for a, u in enumerate(corner)]
        w = wt[0] * wt[1] * wt[2]
        t = (w[:, None] * rec["g"]).to(torch.float64) \
            * _pow2(shift)[level][:, None]
        q = torch.where(inside[:, None], torch.round(t).to(torch.int64), 0)
        col = ((pos[:, 0] * e + pos[:, 1]) * e + pos[:, 2]).clamp(0, e ** 3
                                                                   - 1)
        corner_cols.append(col)
        qs.append(q)
    width = 128
    total = torch.zeros((N_LEVELS * n_rows, width), dtype=torch.int64)
    n = len(rec["key"])
    chunk = (torch.arange(n) - rec["starts"][rec["key"]]) // BWD_CHUNK
    if case == "one_cell":
        assert int(chunk.max()) == 2
    for k in range(int(chunk.max()) + 1 if n else 0):
        part = torch.zeros_like(total)
        sel = chunk == k
        for col, q in zip(corner_cols, qs):
            for ch in range(c):
                part.index_put_((rec["key"][sel], col[sel] * c + ch),
                                q[sel, ch], accumulate=True)
        total += part
    inv = _pow2(-shift)
    got = (total.view(N_LEVELS, n_rows, width).to(torch.float64)
           * inv[:, None, None]).to(torch.float32)
    want = packed_hash_backward_reference(g, prim, bias, pts, anc, n_rows,
                                          width, c, pack, dense)
    assert torch.equal(got, want)


def test_bwd_constants_match_the_kernel():
    """The host's sizes of H2's scratch and its reckonings read the
    kernel's own constants: the chunk of a row a warp sums and the scan's
    tile (csrc/packed_hash_bwd.cu, csrc/bucket_scan.cuh)."""
    import re
    from pathlib import Path

    from gfnerf_tpu_torch.fields.packed_hash import BWD_CHUNK, BWD_SCAN_TILE

    csrc = Path(__file__).resolve().parents[1] / "gfnerf_tpu_torch" / "csrc"
    src = "".join((csrc / name).read_text() for name in (
        "packed_hash_bwd.cu", "bucket_scan.cuh"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kChunk") == BWD_CHUNK
    assert const("kScanThreads") * const("kScanPer") == BWD_SCAN_TILE


def test_table_grad_launches():
    """H2's launches a call: the count, the scan, the scatter and the owner
    pass, whatever the levels, after two zero-fills (the counters, the long
    rows' slots); without points none, and the gradient's zero-fill."""
    from gfnerf_tpu_torch.fields.packed_hash import (BWD_LAUNCHES,
                                                     table_grad_launches,
                                                     table_grad_memsets)

    assert BWD_LAUNCHES == 4
    assert [table_grad_launches(p) for p in (0, 1, 3_145_728)] == [0, 4, 4]
    assert [table_grad_memsets(p) for p in (0, 1, 3_145_728)] == [1, 2, 2]


# ---- the table gradient's fixed-point sum (H2's function) ----

def _fixed_case(case, c=4, dense=0):
    """(torch args of the plain backward, numpy g) on one of RUN_CASES'
    inputs (runs of equal cells, masked anchors inside) or 'random'."""
    from gfnerf_tpu_torch.fields.packed_hash import pack_for_channels

    want, _, _ = _tables(c)
    if case == "random":
        pts, anc = _points(p=1500, n_invalid=100)
    else:
        pts, anc = _run_points(case, n_rays=6)
    g = np.random.default_rng(17).standard_normal(
        (len(pts), N_LEVELS * c)).astype(np.float32)
    args = (torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.as_tensor(pts),
            torch.as_tensor(anc), 1 << ROWS_LOG2, 128, c,
            pack_for_channels(c), dense)
    return args, g


def _backward(g, args):
    from gfnerf_tpu_torch.fields.packed_hash import (
        packed_hash_backward_reference)
    return packed_hash_backward_reference(torch.as_tensor(g), *args)


@pytest.mark.parametrize("case,c,dense", [("one_cell", 4, 0), ("runs", 4, 0),
                                          ("runs_masked", 4, 0),
                                          ("random", 4, 2), ("random", 2, 0),
                                          ("random", 8, 0)])
def test_backward_order_independent(case, c, dense):
    """The plain table gradient of the points in another order (their rows
    of g with them) is the same bit for bit: the fixed-point terms are
    summed exactly, in int64, whatever the order (an f32 sum of the same
    terms is not)."""
    args, g = _fixed_case(case, c, dense)
    got = _backward(g, args)
    perm = np.random.default_rng(3).permutation(len(g))
    for order in (perm, perm[::-1].copy()):
        moved = (*args[:2], args[2][order], args[3][order], *args[4:])
        assert torch.equal(_backward(g[order], moved), got)
    assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0.5


def _f64_sums(g, args):
    """(f64 sum, count of nonzero terms, shift s per entry) of the table
    gradient's terms (``packed_hash_scatter_terms``); the shift from numpy:
    62 - ceil(log2 P) - frexp's exponent of the level's largest |g|."""
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_scatter_terms

    n_levels = args[0].shape[0]
    c = args[6]
    n_out = n_levels * args[4] * args[5] // c
    total = torch.zeros((n_out, c), dtype=torch.float64)
    count = torch.zeros((n_out, c), dtype=torch.int64)
    for rows, payload in packed_hash_scatter_terms(torch.as_tensor(g),
                                                   *args):
        total.index_add_(0, rows, payload.double())
        count.index_add_(0, rows, (payload != 0).long())
    p = len(g)
    e = np.frexp(np.abs(g).reshape(p, n_levels, c).max(axis=(0, 2)))[1]
    shift = 62 - int(np.ceil(np.log2(p))) - e
    per_entry = np.repeat(shift, n_out // n_levels)[:, None]
    return total.numpy(), count.numpy(), per_entry


@pytest.mark.parametrize("case", ["runs_masked", "random"])
def test_backward_within_an_ulp_of_f64_sum(case):
    """Each entry of the plain table gradient against the f64 sum S of the
    same f32 terms: within one f32 ulp of S plus the terms' rounding to the
    level's fixed point (half a step 2^-s each, s = 62 - ceil(log2 P) - E:
    2^-(62 + E - ceil(log2 P)) of 2^E > max|g|); within one ulp alone
    wherever that rounding is below half an ulp (|S| >= n 2^(24 - s)),
    which is most entries."""
    args, g = _fixed_case(case)
    got = _backward(g, args).numpy().reshape(-1, 4).astype(np.float64)
    total, count, shift = _f64_sums(g, args)
    err = np.abs(got - total)
    ulp = np.spacing(np.abs(total).astype(np.float32)).astype(np.float64)
    step = np.ldexp(1.0, -shift.astype(np.int64))
    assert np.all(err <= ulp + count * step / 2)
    big = np.abs(total) >= count * step * 2.0 ** 24
    assert np.all(err[big] <= ulp[big])
    assert big[count > 0].mean() > 0.9
    assert np.all(got[count == 0] == 0)


@pytest.mark.parametrize("edge", ["nan", "inf", "zero", "tiny", "huge"])
def test_backward_edge_levels(edge):
    """Levels of the plain table gradient at the edges of the fixed point:
    a NaN or an inf in a level's upstream gradient makes that level NaN
    throughout (the others as without it) and the optimizer skips the
    update; a level of zeros gives exact zeros; g scaled by 2^-100 (about
    1e-30: shifts past 127) and 2^100 (about 1e30: shifts below 0) gives
    finite results at the same scale: 2^100 times the unscaled gradient
    exactly, and 2^-100 times it to 1e-6 of the largest entry (the scaled
    terms that fall below f32's normal range round apart)."""
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    PerGroupAdam,
                                                    apply_updates)
    from gfnerf_tpu_torch.fields.hash_encoding import fixed_point_shifts

    args, g = _fixed_case("random")
    plain = _backward(g, args)
    c, lev = 4, 1
    cols = slice(lev * c, (lev + 1) * c)
    if edge in ("nan", "inf", "zero"):
        g2 = g.copy()
        if edge == "zero":
            g2[:, cols] = 0.0
        else:
            g2[7, lev * c + 2] = np.nan if edge == "nan" else -np.inf
        got = _backward(g2, args)
        others = [l for l in range(N_LEVELS) if l != lev]
        assert torch.equal(got[others], plain[others])
        if edge == "zero":
            assert torch.equal(got[lev], torch.zeros_like(got[lev]))
            assert not bool(torch.signbit(got[lev]).any())
            return
        assert bool(torch.isnan(got[lev]).all())
        table = torch.zeros_like(got, requires_grad=True)
        params = {"base_encoding_init": [table]}
        opt = PerGroupAdam(OptimizersConfig())
        updates, state = opt.update({"base_encoding_init": [got]},
                                    opt.init(params), params)
        apply_updates(params, updates)
        assert torch.equal(table, torch.zeros_like(table))
        assert int(state.total_notfinite) == 1 and int(state.count) == 0
        assert not bool(state.last_finite)
        return
    k = -100 if edge == "tiny" else 100
    shift, finite = fixed_point_shifts(torch.as_tensor(g), N_LEVELS, c)
    scaled_shift, _ = fixed_point_shifts(torch.as_tensor(np.ldexp(g, k)),
                                         N_LEVELS, c)
    assert bool(finite.all()) and torch.equal(scaled_shift, shift - k)
    assert bool((scaled_shift > 127).all() if k < 0
                else (scaled_shift < 0).all())
    got = _backward(np.ldexp(g, k), args)
    assert bool(torch.isfinite(got).all())
    want = torch.ldexp(plain, torch.tensor(float(k)))
    if k > 0:
        assert torch.equal(got, want)
    else:
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-6 * float(want.abs().max()))


@pytest.mark.parametrize("c,dense", [(2, 0), (4, 2), (8, 0)])
def test_backward_matches_f64_autograd(c, dense):
    """The plain table gradient against autograd of the plain forward's
    interpolation in float64 (no bf16 table read), to 1e-5."""
    from gfnerf_tpu_torch.fields import packed_hash as T

    want, pts, anc, g = _bwd_args(c, dense, n_invalid=100)
    pack = T.pack_for_channels(c)
    n_rows = 1 << ROWS_LOG2
    prim = torch.as_tensor(want[1].astype(np.int64))
    bias, tp, ta = (torch.as_tensor(x) for x in (want[2], pts, anc))
    table = torch.zeros((N_LEVELS, n_rows, 128), dtype=torch.float64,
                        requires_grad=True)
    vol, prims, biases = T._anchor_rows(prim, bias, ta)
    dm, _ = T.dense_level_extents(N_LEVELS, pack, N_VOLUMES, n_rows, dense)
    scales = T._level_scales(N_LEVELS)
    flat = table.reshape(N_LEVELS * n_rows, 128)
    outs = []
    for l in range(N_LEVELS):
        h, loc, frac = T._level_coords(tp, prims[l], biases[l], scales[l],
                                       vol, pack, n_rows, int(dm[l]))
        outs.extend(T._interp_level(flat[h + l * n_rows],
                                    *(f.double() for f in frac), *loc,
                                    pack + 1, c))
    out = torch.stack(outs, -1) * (ta >= 0)[:, None]
    (ref,) = torch.autograd.grad(out, table, torch.as_tensor(g).double())
    got = T.packed_hash_backward_reference(torch.as_tensor(g), prim, bias,
                                           tp, ta, n_rows, 128, c, pack,
                                           dense)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_autograd_cpu_takes_plain_pair():
    """Autograd through the wrapper on CPU tensors gives the plain table
    gradient, nothing for the other inputs, and launches no kernel."""
    from gfnerf_tpu_torch.fields.packed_hash import (
        packed_hash_backward_reference, packed_hash_encode)

    want, pts, anc, g = _bwd_args(4, 0, n_invalid=50, p=512)
    feat = torch.tensor(_tables(4)[2], requires_grad=True)
    args = [torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.tensor(pts, requires_grad=True),
            torch.as_tensor(anc)]
    before = (packed_hash_encode.launches, packed_hash_encode.bwd_launches)
    out = packed_hash_encode(feat, *args, 4, 2)
    out.backward(torch.as_tensor(g))
    assert (packed_hash_encode.launches,
            packed_hash_encode.bwd_launches) == before
    assert args[2].grad is None
    ref = packed_hash_backward_reference(torch.as_tensor(g), args[0],
                                         args[1], args[2].detach(), args[3],
                                         1 << ROWS_LOG2, 128, 4, 2)
    torch.testing.assert_close(feat.grad, ref, rtol=0, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,dense,case", CARD_CASES)
def test_backward_kernel_matches_plain_on_card(c, dense, case):
    """H2 through autograd against the plain table gradient, bit for bit
    (padding columns exactly 0), and the reductions it counts per level
    against packed_hash_bwd_reductions: a counter and a cursor atomic per
    run of one row in a warp, and the long rows' reductions (one_cell's
    29,100 points in one row a level: 29 chunks).  One call makes four
    launches and two zero-fills."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, pack_for_channels,
        packed_hash_backward_reference, packed_hash_bwd_reductions,
        packed_hash_encode, table_grad_launches, table_grad_memsets)

    args = [torch.as_tensor(a, device="cuda") for a in _card_inputs(c, case)]
    feat = torch.zeros((N_LEVELS, 1 << ROWS_LOG2, 128), device="cuda",
                       requires_grad=True)
    g = torch.randn((len(args[2]), N_LEVELS * c), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    pack = pack_for_channels(c)
    before = (packed_hash_encode.bwd_calls, packed_hash_encode.bwd_launches,
              packed_hash_encode.bwd_memsets)
    packed_hash_encode(feat, *args, c, pack, dense).backward(g)
    torch.cuda.synchronize()
    # one call: the count, the scan, the scatter and the owner pass
    assert (packed_hash_encode.bwd_calls, packed_hash_encode.bwd_launches,
            packed_hash_encode.bwd_memsets) == (
        before[0] + 1, before[1] + table_grad_launches(len(g)),
        before[2] + table_grad_memsets(len(g)))
    ref = packed_hash_backward_reference(g, *args, 1 << ROWS_LOG2, 128, c,
                                         pack, dense)
    assert torch.equal(feat.grad, ref)
    live = (pack + 1) ** 3 * c
    assert bool((feat.grad[..., live:] == 0).all())
    ops = torch.zeros(N_LEVELS, dtype=torch.int64, device="cuda")
    _packed_hash_backward_cuda(g, *args, 1 << ROWS_LOG2, 128, c, pack, dense,
                               red_ops=ops)
    want = packed_hash_bwd_reductions(*args, 1 << ROWS_LOG2, c, pack, dense)
    assert ops.tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("n_levels,c", [(5, 4), (3, 2), (3, 8), (16, 4)])
def test_kernels_at_other_level_counts(n_levels, c):
    """H1 and H2 against their plain versions where the level count is not
    the main path's (H1's tile shrinks to fit 16 levels), H2 bit for bit;
    H2's reduction count as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, _packed_hash_encode_cuda,
        init_packed_hash_params, pack_for_channels,
        packed_hash_backward_reference, packed_hash_bwd_reductions,
        packed_hash_encode_raw)

    _, prim, bias = init_packed_hash_params(7, ROWS_LOG2, N_VOLUMES,
                                            n_levels, c)
    pts, anc = _run_points("runs_masked", n_rays=300)
    feat = np.random.default_rng(7).uniform(
        -0.5, 0.5, (n_levels, 1 << ROWS_LOG2, 128)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in
            (feat, prim.astype(np.int64), bias, pts, anc)]
    pack = pack_for_channels(c)
    got = _packed_hash_encode_cuda(*args, c, pack, 0)
    ref = packed_hash_encode_raw(*args, c, pack)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5)
    g = torch.randn(got.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(3))
    bargs = (g, *args[1:], 1 << ROWS_LOG2, 128, c, pack, 0)
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    grad = _packed_hash_backward_cuda(*bargs, red_ops=ops)
    assert torch.equal(grad, packed_hash_backward_reference(*bargs))
    want = packed_hash_bwd_reductions(*args[1:], 1 << ROWS_LOG2, c, pack)
    assert ops.tolist() == want.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [2, 4, 8])
def test_kernels_level_alone_and_launch_groups(c):
    """Each kernel run over one level (``level``) gives that level of the
    whole bit for bit: H1 its columns, H2 its gradient (a level's scale is
    its own).  H2 called again, and on the points (and their rows of g) in
    another order, gives the same gradient bit for bit; H1 given a bf16
    table gives the output of its f32 copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, _packed_hash_encode_cuda,
        pack_for_channels)

    feat = torch.as_tensor(np.random.default_rng(7).uniform(
        -0.5, 0.5, (N_LEVELS, 1 << ROWS_LOG2, 128)).astype(np.float32),
        device="cuda")
    args = [torch.as_tensor(a, device="cuda")
            for a in _card_inputs(c, "runs_masked")]
    pack = pack_for_channels(c)
    full = _packed_hash_encode_cuda(feat, *args, c, pack, 0)
    assert torch.equal(_packed_hash_encode_cuda(
        feat.to(torch.bfloat16), *args, c, pack, 0), full)
    g = torch.randn(full.shape, device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    bargs = (*args, 1 << ROWS_LOG2, 128, c, pack, 0)
    grad = _packed_hash_backward_cuda(g, *bargs)
    for l in range(N_LEVELS):
        cols = slice(l * c, (l + 1) * c)
        assert torch.equal(_packed_hash_encode_cuda(feat, *args, c, pack, 0,
                                                    level=l), full[:, cols])
        one = _packed_hash_backward_cuda(g[:, cols].contiguous(), *bargs,
                                         level=l)
        assert one.shape == (1, 1 << ROWS_LOG2, 128)
        assert torch.equal(one[0], grad[l])
    assert torch.equal(_packed_hash_backward_cuda(g, *bargs), grad)
    perm = torch.randperm(len(g), device="cuda",
                          generator=torch.Generator("cuda").manual_seed(1))
    moved = (*args[:2], args[2][perm], args[3][perm], *bargs[4:])
    assert torch.equal(_packed_hash_backward_cuda(g[perm], *moved), grad)


# ---- the encodes added to a base (the focal stage's residual sum) ----

N_BLOCKS = 3


def _stacked(c, seed=7):
    """(tables (B, L, rows, 128), primes (B, L, V, 3) uint32, biases) with
    each block's own draws and random table values."""
    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    pools = [init_packed_hash_params(seed + b, ROWS_LOG2, N_VOLUMES, N_LEVELS,
                                     c) for b in range(N_BLOCKS)]
    tables = np.random.default_rng(seed).uniform(
        -0.5, 0.5, (N_BLOCKS, N_LEVELS, 1 << ROWS_LOG2, 128)
    ).astype(np.float32)
    return (tables, np.stack([x[1] for x in pools]),
            np.stack([x[2] for x in pools]))


def _blocks(p, seed=2):
    """A block per point, some -1 and one past the last (clipped)."""
    rng = np.random.default_rng(seed)
    blk = rng.integers(0, N_BLOCKS, p).astype(np.int32)
    blk[rng.choice(p, p // 20, replace=False)] = -1
    blk[0] = N_BLOCKS + 2
    return blk


def _base_like(p, c, seed=3):
    return np.random.default_rng(seed).uniform(
        -0.5, 0.5, (p, N_LEVELS * c)).astype(np.float32)


@pytest.mark.parametrize("c,dense,in_place", [(4, 0, False), (4, 0, True),
                                              (2, 2, False), (8, 0, True)])
def test_encode_with_base_is_base_plus_encode(c, dense, in_place):
    """``packed_hash_encode(..., base=)`` and its plain twin on CPU tensors
    equal ``base + encode`` bit for bit; out of place the base is left as
    it was, in place the result is the base itself."""
    from gfnerf_tpu_torch.fields.packed_hash import (
        pack_for_channels, packed_hash_encode, packed_hash_encode_raw,
        plain_packed_hash_encode)

    want_tables, _, feat = _tables(c)
    pts, anc = _points(p=777, n_invalid=60, seed=c)
    pack = pack_for_channels(c)
    args = (torch.as_tensor(feat),
            torch.as_tensor(want_tables[1].astype(np.int64)),
            torch.as_tensor(want_tables[2]), torch.as_tensor(pts),
            torch.as_tensor(anc), c, pack, dense)
    base0 = torch.as_tensor(_base_like(len(pts), c))
    want = base0 + packed_hash_encode_raw(*args)
    assert torch.equal(packed_hash_encode_raw(*args, base=base0), want)
    for fn in (packed_hash_encode, plain_packed_hash_encode):
        base = base0.clone()
        got = fn(*args, base=base, in_place=in_place)
        assert torch.equal(got, want)
        if in_place:
            assert got.data_ptr() == base.data_ptr()
        else:
            assert torch.equal(base, base0)
    # masked points keep the base
    assert torch.equal(want[torch.as_tensor(anc) < 0],
                       base0[torch.as_tensor(anc) < 0])
    # a view with gaps is copied out of place and refused in place
    wide = torch.zeros((len(pts), 2 * N_LEVELS * c))
    wide[:, ::2] = base0
    assert torch.equal(packed_hash_encode(*args, base=wide[:, ::2]), want)
    with pytest.raises(ValueError):
        packed_hash_encode(*args, base=wide[:, ::2], in_place=True)
    with pytest.raises(ValueError):   # in place over nothing
        packed_hash_encode(*args, in_place=True)
    with pytest.raises(ValueError):   # not (P, L * C)
        packed_hash_encode(*args, base=base0[:, :-1])


@pytest.mark.parametrize("c,dense", [(4, 0), (4, 2), (2, 0), (8, 0)])
def test_routed_on_base_matches_jax_residual_sum(c, dense):
    """``packed_hash_encode_routed(..., base=global encode)`` against the
    JAX package's eval residual ``packed_hash_encode(...) +
    packed_hash_encode_routed(...)`` (fields/field.py:407-413) from the
    same inputs: atol 1e-6, the routed encode's own tolerance; and equal to
    ``base + routed`` of the plain versions bit for bit, in place and not.
    Each JAX encode is jitted on its own, as the encode tests above run
    them, and the two are added in f32: whether XLA:CPU contracts ``p *
    scale + bias`` is decided per graph, and in one graph of both encodes
    it does not at every lattice shape."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import packed_hash as J
    from gfnerf_tpu_torch.fields import packed_hash as T

    gtab, _, gfeat = _tables(c)
    tables, prims, biases = _stacked(c)
    pts, anc = _points(p=2048, n_invalid=100, seed=c + dense)
    blk = _blocks(len(pts))
    pack = T.pack_for_channels(c)
    jpts, janc = jnp.asarray(pts), jnp.asarray(anc)
    j = np.asarray(jax.jit(J.packed_hash_encode, static_argnums=(5, 6))(
        jnp.asarray(gfeat), jnp.asarray(gtab[1]), jnp.asarray(gtab[2]), jpts,
        janc, c, pack)) + np.asarray(
            jax.jit(J.packed_hash_encode_routed, static_argnums=(6, 7, 8))(
                jnp.asarray(tables), jnp.asarray(prims), jnp.asarray(biases),
                jpts, janc, jnp.asarray(blk), c, pack, dense))
    assert j.dtype == np.float32
    tpts, tanc, tblk = (torch.as_tensor(x) for x in (pts, anc, blk))
    glob = T.packed_hash_encode_raw(
        torch.as_tensor(gfeat), torch.as_tensor(gtab[1].astype(np.int64)),
        torch.as_tensor(gtab[2]), tpts, tanc, c, pack)
    rargs = (torch.as_tensor(tables), torch.as_tensor(prims.astype(np.int64)),
             torch.as_tensor(biases), tpts, tanc, tblk, c, pack, dense)
    want = glob + T.packed_hash_encode_routed_raw(*rargs)
    assert torch.equal(T.packed_hash_encode_routed_raw(*rargs, base=glob),
                       want)
    for fn in (T.packed_hash_encode_routed,
               T.plain_packed_hash_encode_routed):
        assert torch.equal(fn(*rargs, base=glob), want)
        buf = glob.clone()
        got = fn(*rargs, base=buf, in_place=True)
        assert got.data_ptr() == buf.data_ptr() and torch.equal(got, want)
    assert np.abs(want.numpy()).max() > 0.05
    np.testing.assert_allclose(want.numpy(), j, rtol=0, atol=1e-6)
    masked = (anc < 0) | (blk < 0)
    assert masked.sum() > 100 and torch.equal(want[masked], glob[masked])


def test_base_with_a_gradient_is_refused():
    """The base is a constant of the sum: one that requires a gradient
    raises, for both encodes, on any device's path."""
    from gfnerf_tpu_torch.fields import packed_hash as T

    want_tables, _, feat = _tables(4)
    pts, anc = _points(p=64)
    args = (torch.as_tensor(feat),
            torch.as_tensor(want_tables[1].astype(np.int64)),
            torch.as_tensor(want_tables[2]), torch.as_tensor(pts),
            torch.as_tensor(anc), 4, 2)
    base = torch.zeros((64, N_LEVELS * 4), requires_grad=True)
    for fn in (T.packed_hash_encode, T.plain_packed_hash_encode):
        with pytest.raises(ValueError, match="gradient"):
            fn(*args, base=base)
    tables, prims, biases = _stacked(4)
    rargs = (torch.as_tensor(tables), torch.as_tensor(prims.astype(np.int64)),
             torch.as_tensor(biases), args[3], args[4],
             torch.as_tensor(_blocks(64)), 4, 2)
    for fn in (T.packed_hash_encode_routed,
               T.plain_packed_hash_encode_routed):
        with pytest.raises(ValueError, match="gradient"):
            fn(*rargs, base=base)


@pytest.mark.parametrize("in_place", [False, True])
def test_table_gradient_is_the_same_with_a_base(in_place):
    """The table's gradient through ``packed_hash_encode(..., base=)``
    equals the one without a base, bit for bit (the base adds a constant),
    and nothing flows to the base."""
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode

    want, pts, anc, g = _bwd_args(4, 0, n_invalid=50, p=512)
    args = [torch.as_tensor(want[1].astype(np.int64)),
            torch.as_tensor(want[2]), torch.as_tensor(pts),
            torch.as_tensor(anc)]
    grads = []
    for with_base in (False, True):
        feat = torch.tensor(_tables(4)[2], requires_grad=True)
        base = torch.as_tensor(_base_like(512, 4)) if with_base else None
        out = packed_hash_encode(feat, *args, 4, 2, 0, base,
                                 in_place and with_base)
        assert out.requires_grad
        out.backward(torch.as_tensor(g))
        grads.append(feat.grad)
        if with_base:
            assert base.is_leaf != in_place   # in place: the output
    assert float(grads[0].abs().max()) > 0
    assert torch.equal(grads[0], grads[1])


@pytest.mark.cuda
@pytest.mark.parametrize("c,dense,case", [(4, 0, "random"), (2, 0, "random"),
                                          (8, 0, "random"), (4, 2, "runs"),
                                          (4, 0, "runs_masked")])
def test_kernels_with_base_match_plain_on_card(c, dense, case):
    """H1 and H3 given a base against ``base + plain``, bit for bit, out of
    place (the base unchanged) and in place (P is no multiple of the
    tile), one launch each; H2 through a based encode gives the table
    gradient of the encode without a base."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields import packed_hash as T

    prim, bias, pts, anc = _card_inputs(c, case)
    pts, anc = pts[:len(pts) - 37], anc[:len(anc) - 37]
    feat = np.random.default_rng(7).uniform(
        -0.5, 0.5, (N_LEVELS, 1 << ROWS_LOG2, 128)).astype(np.float32)
    args = [torch.as_tensor(a, device="cuda") for a in
            (feat, prim, bias, pts, anc)]
    pack = T.pack_for_channels(c)
    base0 = torch.as_tensor(_base_like(len(pts), c), device="cuda")
    tables, prims, biases = _stacked(c)
    rargs = [torch.as_tensor(a, device="cuda") for a in
             (tables, prims.astype(np.int64), biases, pts, anc,
              _blocks(len(pts)))]
    for fn, fargs, plain, counter in (
            (T.packed_hash_encode, (*args, c, pack, dense),
             T.packed_hash_encode_raw, T.packed_hash_encode),
            (T.packed_hash_encode_routed, (*rargs, c, pack, dense),
             T.packed_hash_encode_routed_raw, T.packed_hash_encode_routed)):
        want = base0 + plain(*fargs)
        base = base0.clone()
        before = counter.launches
        got = fn(*fargs, base=base)
        torch.cuda.synchronize()
        assert counter.launches == before + 1
        assert torch.equal(got, want) and torch.equal(base, base0)
        got = fn(*fargs, base=base, in_place=True)
        torch.cuda.synchronize()
        assert got.data_ptr() == base.data_ptr() and torch.equal(got, want)
    g = torch.randn((len(pts), N_LEVELS * c), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    grads = []
    for base in (None, base0.clone()):
        table = args[0].clone().requires_grad_(True)
        T.packed_hash_encode(table, *args[1:], c, pack, dense, base,
                             base is not None).backward(g)
        grads.append(table.grad)
    tol = 1e-5 * float(grads[0].abs().max())   # atomics in another order
    np.testing.assert_allclose(grads[1].cpu().numpy(), grads[0].cpu().numpy(),
                               rtol=0, atol=tol)


def test_signatures_match_entry_points():
    """SIGNATURES, the argument types ctypes passes, agrees with every C
    entry point's prototype: a pointer for each pointer, c_longlong for
    long long, c_int for int, c_float for float, in order."""
    import ctypes
    import re

    from gfnerf_tpu_torch.ops import build

    proto = re.compile(r'extern "C" int (\w+)\(([^)]*)\)')
    found = {}
    for src in build._sources():
        for name, params in proto.findall(src.read_text()):
            kinds = []
            for param in params.split(","):
                if "*" in param:
                    kinds.append(ctypes.c_void_p)
                elif "long long" in param:
                    kinds.append(ctypes.c_longlong)
                elif re.fullmatch(r"\s*float \w+\s*", param):
                    kinds.append(ctypes.c_float)
                else:
                    assert re.fullmatch(r"\s*int \w+\s*", param), param
                    kinds.append(ctypes.c_int)
            found[name] = kinds
    assert found == build.SIGNATURES


def test_build_stamp_covers_headers(tmp_path, monkeypatch):
    """H1 and H2 share their addressing through a header: a change to any
    csrc/*.cuh must change the build stamp, as a change to a .cu does, so
    the card never runs a stale library.  Also: every C entry point of the
    sources is declared in SIGNATURES."""
    import re

    from gfnerf_tpu_torch.ops import build

    entry = re.compile(r'extern "C" int (\w+)\(')
    declared = {m for src in build._sources()
                for m in entry.findall(src.read_text())}
    assert declared == set(build.SIGNATURES)
    assert any(p.suffix == ".cuh" for p in build._stamped_files())

    (tmp_path / "k.cu").write_text('#include "k.cuh"\n')
    (tmp_path / "k.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "CSRC_DIR", tmp_path)
    first = build._source_hash()
    (tmp_path / "k.cuh").write_text("// v2\n")
    assert build._source_hash() != first
    assert [p.name for p in build._sources()] == ["k.cu"]
