"""The port's temporal grid and NeRFPlayer pair against the JAX package's on
the CPU: ``make_temporal_grid``'s table and window tables, the plain encode
(dense and hashed levels, points on the faces 0.0 and 1.0, times at the
window rows' boundaries), its table gradient against ``jax.vjp``,
``temporal_tv_loss`` at the rows ``jax.random.randint`` draws; both models'
parameters, forward, loss and gradients through ``params_from_jax`` with
the JAX package's draws handed over; ``update_ngp_occupancy``; a few
``VanillaPipeline`` steps of each kind against the JAX pipeline on a small
D-NeRF scene; the two reference traits the port keeps or repairs (eval
rays at camera 0's time; the nerfplayer-ngp checkpoint holding the grid);
the entry points; ``tables()``'s checks of what T1 and T2 assume (a
contiguous window, hashed levels of a power of two of rows), and every
registered grid passing them; the plain table gradient on ray-major
samples; the plain table gradient's exact fixed-point sum (bit for bit on
the points permuted, within an ulp of the f64 sum, NaN and zero levels)
and T2's records per level.  On a card (``cuda``): T1 and T2 against the
plain pair bit for bit (also on ray-major samples whose runs T2 merges, T2
also on the points permuted), and each model's step through the kernels
against the plain pair.

Sizes: 3-4 levels, T = 4-6, 2^6-2^10 rows; 32 rays.  Tolerances, and why:
- the tables, the window tables and the parameters at the start: bit for
  bit;
- the plain encode against the JAX package's (eager, op by op): bit for
  bit (measured: equal); against the jitted one, 1e-6 of the largest
  (XLA contracts ``(1 - frac) * old + frac * new`` and ``acc + w * feat``
  into multiply-adds; measured 1.2e-7);
- the table gradient against ``jax.vjp``: 1e-6 of its largest (the same
  f32 terms, summed exactly in fixed point here and by XLA's f32 scatter
  there; measured 1.5e-7);
- the TV term: 1e-6 relative (torch and XLA sum the mean in other orders;
  measured equal);
- the models' losses 1e-5 relative (measured 2.6e-6, the distortion
  loss); their outputs 2e-5 of the largest (measured 5.4e-6, the weights
  of the jitted step); every gradient against the eager JAX step 2e-5 of
  its largest (measured 3.1e-6), against the jitted one 5e-3 (measured
  1.9e-3, nerfplayer-ngp's field table; nerfplayer-nerfacto's 2.9e-5):
  XLA contracts ``u + (x - 0.5) / S``, ``near + (far - near)
  u`` and ``o + t d`` into multiply-adds, 35% of the positions land an ulp
  or two away, the occupancy cells stay the same, and the gradients of
  samples the rays barely reach move by more than the outputs do;
- ``update_ngp_occupancy`` against the jitted JAX update: 1e-5 relative
  (measured 2.7e-6: XLA fuses ``(grid + jitter) * cell - aabb``);
- the pipelines: see test_vanilla_pipeline_matches_jax.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest
import torch

import torch_parity  # noqa: F401  (two CPU threads per worker)
from torch_parity import to_np

R = 32
PROPS = (16, 12)
NERF = 8
SMALL = dict(num_proposal_samples=PROPS, num_nerf_samples=NERF,
             num_levels=4, log2_hashmap_size=10, prop_num_levels=3,
             prop_log2_hashmap_size=8, temporal_dim=6, prop_temporal_dim=4,
             desired_resolution=64, prop_max_res=(16, 32))
SMALL_NGP = dict(num_samples=32, num_levels=4, log2_hashmap_size=10,
                 temporal_dim=6, grid_resolution=16, desired_resolution=64)
TIMES = np.array([0.0, 0.3, 0.71, 1.0], np.float32)
MODEL_TOL = 2e-5
# the gradients against the jitted JAX step (see the docstring)
JIT_GRAD_TOL = 5e-3
# the grids the encode tests take: (levels, T, log2 rows, base, finest)
GRIDS = {"hashed": (3, 6, 6, 4, None), "mixed": (4, 5, 10, 4, 64),
         "dense": (3, 4, 12, 4, 16)}


def grid_pair(name, seed=1, level_dim=2):
    """(JAX table, JAX statics, port table, port statics) of one grid."""
    from gfnerf_tpu.fields import temporal_grid as J
    from gfnerf_tpu_torch.fields import temporal_grid as T

    levels, t, log2, base, finest = GRIDS[name]
    kw = dict(temporal_dim=t, num_levels=levels, level_dim=level_dim,
              base_resolution=base, log2_hashmap_size=log2,
              desired_resolution=finest)
    return (*J.make_temporal_grid(seed, **kw),
            *T.make_temporal_grid(seed, **kw))


def encode_inputs(st, n=257, seed=0):
    """Points in [0, 1]^3 with some on the faces 0.0 and 1.0 and on the
    coarsest level's cell edges; times with 0, 1 and every window row's
    boundary; a table of uniform(-1, 1) (numpy)."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    xyz[:8] = np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                        for c in (0, 1)], np.float32)
    xyz[8:16] = rng.integers(0, int(st.resolutions[0]) + 1, (8, 3)) \
        / np.float32(st.resolutions[0])
    t = rng.uniform(0, 1, n).astype(np.float32)
    bounds = np.arange(st.n_rows + 1, dtype=np.float32) / np.float32(
        max(st.temporal_dim - 2, 1))
    t[16:16 + len(bounds)] = np.clip(bounds, 0, 1)
    t[:2] = [0.0, 1.0]
    table = rng.uniform(-1, 1, (int(st.offsets[-1]), st.width)).astype(
        np.float32)
    return xyz, t, table


def ray_major_inputs(st, n_rays=6, n_samples=40, lead=0, seed=7):
    """Samples as a step gives them: ray-major, in t order, one time a
    ray (its camera's), after ``lead`` scattered points.  Each ray crosses
    a short segment (its samples a few hundredths of the cube apart), so
    consecutive samples share the coarse levels' cells: the runs T2 merges.
    Ray 1 retraces ray 0 at a time one window row later, so the two share
    their coarse cells at different window rows (numpy)."""
    rng = np.random.default_rng(seed)
    o = rng.uniform(0.3, 0.7, (n_rays, 3))
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    scale = np.float32(max(st.temporal_dim - 2, 1))
    rows = rng.integers(0, st.n_rows, n_rays)
    t_ray = (rows + rng.uniform(0.1, 0.9, n_rays)) / scale
    if n_rays > 1:
        o[1], d[1] = o[0], d[0]
        t_ray[1] = t_ray[0] + 1 / scale if rows[0] + 1 < st.n_rows \
            else t_ray[0] - 1 / scale
    step = np.linspace(0.0, 0.1, n_samples)
    xyz = np.clip(o[:, None] + step[None, :, None] * d[:, None], 0, 1)
    xyz = np.concatenate([rng.uniform(0, 1, (lead, 3)),
                          xyz.reshape(-1, 3)]).astype(np.float32)
    t = np.concatenate([rng.uniform(0, 1, lead),
                        np.repeat(t_ray, n_samples)]).astype(np.float32)
    table = rng.uniform(-1, 1, (int(st.offsets[-1]), st.width)).astype(
        np.float32)
    return xyz, t, table


# ---- the grid ----


@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_grid_and_window_tables_match_jax(level_dim):
    """make_temporal_grid: the table, the level offsets, resolutions and
    hashed flags, and the window tables equal the JAX package's bit for bit;
    each window row's old channel is its interpolating slot's passthrough;
    the registered widths' row counts."""
    from gfnerf_tpu_torch.fields.temporal_grid import make_temporal_grid

    for name in GRIDS:
        je, js, te, ts = grid_pair(name, level_dim=level_dim)
        np.testing.assert_array_equal(te, np.asarray(je))
        for f in ("offsets", "resolutions", "hashed", "sel_pass", "sel_old",
                  "sel_new", "interp_pos"):
            np.testing.assert_array_equal(getattr(ts, f), getattr(js, f))
        assert (ts.sel_pass[np.arange(ts.n_rows), ts.interp_pos]
                == ts.sel_old).all()
        assert ts.tables("cpu").window.shape == (ts.n_rows, level_dim + 2)
    if level_dim == 2:
        _, mixed = make_temporal_grid(0, 5, 4, 2, 4, 10, 64)
        assert mixed.hashed.tolist() == [False, True, True, True]


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_encode_matches_jax(grid):
    """The plain encode against the JAX package's, eager and jitted, on
    faces, cell edges and window-row boundaries."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import temporal_grid as J
    from gfnerf_tpu_torch.fields.temporal_grid import (
        temporal_grid_encode, temporal_grid_encode_raw)

    _, js, _, ts = grid_pair(grid)
    xyz, t, table = encode_inputs(ts)
    args = (jnp.asarray(xyz), jnp.asarray(t))
    eager = np.asarray(J.temporal_grid_encode(jnp.asarray(table), js, *args))
    jitted = np.asarray(jax.jit(lambda e, x, tt: J.temporal_grid_encode(
        e, js, x, tt))(jnp.asarray(table), *args))
    targs = (torch.from_numpy(table), ts, torch.from_numpy(xyz),
             torch.from_numpy(t))
    got = temporal_grid_encode_raw(*targs).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=0,
                               atol=1e-6 * np.abs(jitted).max())
    np.testing.assert_array_equal(temporal_grid_encode(*targs).detach()
                                  .numpy(), got)
    assert got.shape == (len(xyz), ts.n_levels * ts.level_dim)


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_table_gradient_matches_jax_vjp(grid):
    """The plain table gradient (one scatter of the used channels) against
    jax.vjp of the JAX encode, and against autograd through the plain
    forward's gathers (the dense route it replaces)."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import temporal_grid as J
    from gfnerf_tpu_torch.fields.temporal_grid import (
        plain_temporal_grid_encode, temporal_grid_encode_raw)

    _, js, _, ts = grid_pair(grid)
    xyz, t, table = encode_inputs(ts, seed=3)
    g = np.random.default_rng(4).standard_normal(
        (len(xyz), ts.n_levels * ts.level_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda e: J.temporal_grid_encode(
        e, js, jnp.asarray(xyz), jnp.asarray(t)), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    emb = torch.tensor(table, requires_grad=True)
    plain_temporal_grid_encode(emb, ts, torch.from_numpy(xyz),
                               torch.from_numpy(t)).backward(
        torch.from_numpy(g))
    scale = np.abs(want).max()
    np.testing.assert_allclose(emb.grad.numpy(), want, rtol=0,
                               atol=1e-6 * scale)
    dense = torch.tensor(table, requires_grad=True)
    temporal_grid_encode_raw(dense, ts, torch.from_numpy(xyz),
                             torch.from_numpy(t)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(emb.grad.numpy(), dense.grad.numpy(), rtol=0,
                               atol=1e-6 * scale)
    # the passthrough value at the interpolating slot gets no gradient:
    # a row's channels beyond its window stay zero
    assert (emb.grad.numpy() != 0).sum() < emb.grad.numel()


def test_tv_loss_matches_jax():
    """temporal_tv_loss at the row jax.random.randint draws from the JAX
    key, for two grids of other row counts from one key; and its
    gradient."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import temporal_grid as J
    from gfnerf_tpu_torch.fields.temporal_grid import temporal_tv_loss

    for seed, name in enumerate(("mixed", "dense")):
        _, js, _, ts = grid_pair(name)
        table = np.random.default_rng(seed).uniform(
            -1, 1, (int(ts.offsets[-1]), ts.width)).astype(np.float32)
        key = jax.random.PRNGKey(11)
        want, jg = jax.value_and_grad(
            lambda e: J.temporal_tv_loss(e, js, key))(jnp.asarray(table))
        row = int(jax.random.randint(key, (), 0, js.sel_old.shape[0]))
        emb = torch.tensor(table, requires_grad=True)
        got = temporal_tv_loss(emb, ts, torch.tensor(row))
        got.backward()
        np.testing.assert_allclose(float(got.detach()), float(want),
                                   rtol=1e-6)
        np.testing.assert_allclose(emb.grad.numpy(), np.asarray(jg),
                                   rtol=1e-6, atol=0)



@pytest.mark.parametrize("fault", ["window-order", "window-new",
                                   "hashed-rows", "offsets"])
def test_tables_check_the_kernels_assumptions(fault):
    """tables() raises on a grid that breaks what T1 and T2 assume: the
    window rows' closed form (slots in another order; another new
    channel), hashed levels of a power of two of rows, offsets that are
    multiples of 8 rows."""
    from gfnerf_tpu_torch.fields.temporal_grid import make_temporal_grid

    _, st = make_temporal_grid(0, 6, 4, 2, 4, 10, 64)
    st.tables("cpu")   # the grid as built passes
    if fault == "window-order":
        bad = dict(sel_pass=st.sel_pass[:, ::-1].copy(),
                   interp_pos=(1 - st.interp_pos).astype(np.int32))
    elif fault == "window-new":
        bad = dict(sel_new=st.sel_new[::-1].copy())
    elif fault == "hashed-rows":
        assert st.hashed.any()
        offsets = st.offsets.copy()
        offsets[-1] -= 8   # the last, hashed level 8 rows short
        bad = dict(offsets=offsets)
    else:
        offsets = st.offsets.copy()
        offsets[1:] += 4
        bad = dict(offsets=offsets)
    broken = dataclasses.replace(st, _device={}, **bad)
    with pytest.raises(ValueError, match="temporal grid"):
        broken.tables("cpu")


@pytest.mark.parametrize("level_dim", [1, 2, 4])
def test_registered_grids_hold_the_kernels_assumptions(level_dim):
    """Every grid of the registered nerfplayer widths (nerfplayer-nerfacto's
    field and both proposals, nerfplayer-ngp's field), at C = 1, 2 and 4,
    holds what T1 and T2 assume; the hashed levels are 2^log2 rows."""
    from gfnerf_tpu_torch.fields.temporal_grid import temporal_grid_statics
    from gfnerf_tpu_torch.models.nerfplayer import (NerfplayerConfig,
                                                    NerfplayerNGPConfig)

    a, b = NerfplayerConfig(), NerfplayerNGPConfig()
    grids = [(a.temporal_dim, a.num_levels, a.base_resolution,
              a.log2_hashmap_size, a.desired_resolution),
             (b.temporal_dim, b.num_levels, b.base_resolution,
              b.log2_hashmap_size, b.desired_resolution)]
    grids += [(a.prop_temporal_dim, a.prop_num_levels, a.base_resolution,
               a.prop_log2_hashmap_size, res) for res in a.prop_max_res]
    for t, levels, base, log2, finest in grids:
        st = temporal_grid_statics(t, levels, level_dim, base, log2, finest)
        st.check_kernel_facts()
        sizes = np.diff(st.offsets)
        assert st.hashed.any()
        assert (sizes[st.hashed] == 1 << log2).all()


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_table_gradient_on_ray_major_samples_matches_jax_vjp(grid):
    """The plain table gradient against jax.vjp of the JAX encode on the
    samples a step gives (ray-major, in t order, one time a ray), two
    rays sharing their coarse cells at different window rows: the pattern
    T2's run merging targets."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import temporal_grid as J
    from gfnerf_tpu_torch.fields.temporal_grid import (
        plain_temporal_grid_encode)

    _, js, _, ts = grid_pair(grid)
    xyz, t, table = ray_major_inputs(ts, lead=5)
    row = np.minimum((t * np.float32(ts.time_scale)).astype(np.int64),
                     ts.n_rows - 1)
    first = 5 + np.arange(2) * 40
    assert row[first[0]] != row[first[1]]
    cell = np.floor(xyz * np.float32(ts.resolutions[0])).astype(np.int64)
    assert (cell[first[0]:first[0] + 40] == cell[first[1]:first[1] + 40]
            ).all()
    g = np.random.default_rng(8).standard_normal(
        (len(xyz), ts.n_levels * ts.level_dim)).astype(np.float32)
    _, vjp = jax.vjp(lambda e: J.temporal_grid_encode(
        e, js, jnp.asarray(xyz), jnp.asarray(t)), jnp.asarray(table))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    emb = torch.tensor(table, requires_grad=True)
    plain_temporal_grid_encode(emb, ts, torch.from_numpy(xyz),
                               torch.from_numpy(t)).backward(
        torch.from_numpy(g))
    np.testing.assert_allclose(emb.grad.numpy(), want, rtol=0,
                               atol=1e-6 * np.abs(want).max())

def _plain_grad(st, xyz, t, table, g):
    from gfnerf_tpu_torch.fields.temporal_grid import (
        temporal_backward_reference)

    return temporal_backward_reference(torch.as_tensor(g), st,
                                       torch.as_tensor(xyz),
                                       torch.as_tensor(t), table.shape[0])


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_table_gradient_order_independent(grid):
    """The plain table gradient of the points in another order (their
    times and rows of g with them) is the same bit for bit: each term is
    rounded once to its level's fixed point and the int64 sums are exact,
    whatever the order; on ray-major samples too (T2's runs)."""
    _, _, _, ts = grid_pair(grid)
    for xyz, t, table in (encode_inputs(ts, seed=5),
                          ray_major_inputs(ts, lead=7)):
        g = np.random.default_rng(6).standard_normal(
            (len(xyz), ts.n_levels * ts.level_dim)).astype(np.float32)
        got = _plain_grad(ts, xyz, t, table, g)
        perm = np.random.default_rng(3).permutation(len(xyz))
        for order in (perm, perm[::-1].copy()):
            assert torch.equal(_plain_grad(ts, xyz[order], t[order], table,
                                           g[order]), got)
        assert bool(torch.isfinite(got).all()) and float(got.abs().max()) > 0


@pytest.mark.parametrize("grid", sorted(GRIDS))
def test_table_gradient_within_an_ulp_of_f64_sum(grid):
    """Each entry of the plain table gradient against the f64 sum S of the
    same f32 terms (``temporal_scatter_terms``), and against the f32
    ``index_add_`` of them: within one f32 ulp of S plus the terms'
    rounding to their row's fixed point (half a step 2^-s each, s = 59 -
    ceil(log2 P) - E, 2^E > the row's largest |term|: ``row_shifts``);
    within one ulp alone wherever that rounding is below half an ulp (|S|
    >= n 2^(24 - s)), which is most entries; the f32 sum no nearer to S
    than that."""
    from gfnerf_tpu_torch.fields.temporal_grid import (row_shifts,
                                                       temporal_scatter_terms)

    _, _, _, ts = grid_pair(grid)
    xyz, t, table = encode_inputs(ts, seed=9)
    g = np.random.default_rng(10).standard_normal(
        (len(xyz), ts.n_levels * ts.level_dim)).astype(np.float32)
    got = _plain_grad(ts, xyz, t, table, g).numpy().reshape(-1)
    n = table.size
    total = torch.zeros(n, dtype=torch.float64)
    count = torch.zeros(n, dtype=torch.int64)
    f32 = torch.zeros(n, dtype=torch.float32)
    shift = torch.zeros(table.shape[0], dtype=torch.int64)
    by_level = {}
    for idx, vals, level in temporal_scatter_terms(
            torch.as_tensor(g), ts, torch.as_tensor(xyz), torch.as_tensor(t)):
        by_level.setdefault(level, []).append((idx, vals))
        idx, vals = idx.reshape(-1), vals.reshape(-1)
        total.index_add_(0, idx, vals.double())
        f32.index_add_(0, idx, vals)
        count.index_add_(0, idx, (vals != 0).long())
    for level, terms in by_level.items():
        a, b = int(ts.offsets[level]), int(ts.offsets[level + 1])
        rows = torch.cat([i for i, _ in terms], 1) // ts.width - a
        shift[a:b] = row_shifts(rows, torch.cat([v for _, v in terms], 1),
                                b - a, len(xyz))
    step = np.repeat(np.ldexp(1.0, -shift.numpy()), ts.width)
    total, count, f32 = total.numpy(), count.numpy(), f32.numpy()
    err = np.abs(got - total)
    ulp = np.spacing(np.abs(total).astype(np.float32)).astype(np.float64)
    assert np.all(err <= ulp + count * step / 2)
    big = np.abs(total) >= count * step * 2.0 ** 24
    assert np.all(err[big] <= ulp[big])
    assert big[count > 0].mean() > 0.9
    assert np.all(got[count == 0] == 0)
    assert np.all(err[big] <= np.abs(f32 - total)[big] + ulp[big])


@pytest.mark.parametrize("edge", ["nan", "inf", "zero"])
def test_table_gradient_edge_levels(edge):
    """A NaN or an inf in a level's upstream gradient makes that level's
    rows NaN throughout (the other levels as without it), and a level of
    zeros gives exact zeros, +0.0; such levels make no records."""
    from gfnerf_tpu_torch.fields.temporal_grid import temporal_bwd_records

    _, _, _, ts = grid_pair("mixed")
    xyz, t, table = encode_inputs(ts, seed=11)
    g = np.random.default_rng(12).standard_normal(
        (len(xyz), ts.n_levels * ts.level_dim)).astype(np.float32)
    plain = _plain_grad(ts, xyz, t, table, g)
    c, lev = ts.level_dim, 2
    g2 = g.copy()
    if edge == "zero":
        g2[:, lev * c:(lev + 1) * c] = 0.0
    else:
        g2[11, lev * c + 1] = np.nan if edge == "nan" else np.inf
    got = _plain_grad(ts, xyz, t, table, g2)
    rows = slice(int(ts.offsets[lev]), int(ts.offsets[lev + 1]))
    others = torch.ones(got.shape[0], dtype=torch.bool)
    others[rows] = False
    assert torch.equal(got[others], plain[others])
    if edge == "zero":
        assert torch.equal(got[rows], torch.zeros_like(got[rows]))
        assert not bool(torch.signbit(got[rows]).any())
    else:
        assert bool(torch.isnan(got[rows]).all())
    records = temporal_bwd_records(torch.as_tensor(g2), ts,
                                   torch.as_tensor(xyz), torch.as_tensor(t))
    assert int(records[lev]) == 0
    assert bool((records[[l for l in range(ts.n_levels) if l != lev]] > 0)
                .all())


def test_bwd_records_reckoning():
    """T2's records per level (``temporal_bwd_records``) on hand-made
    inputs: warps of 32 points of one cell and time make one record per
    corner and level (8, a weight of 0 excepted); every point its own run
    (warp 1) makes one per live (point, corner); ray-major samples fewer
    than that at the coarse levels; a time one window row later is a run
    of its own; a run whose terms are all 0 makes none."""
    from gfnerf_tpu_torch.fields.temporal_grid import temporal_bwd_records

    _, _, _, ts = grid_pair("mixed")
    c = ts.level_dim
    rng = np.random.default_rng(14)
    one = np.tile(np.float32([[0.31, 0.52, 0.73]]), (64, 1))
    t1 = np.full(64, 0.4, np.float32)
    g = rng.standard_normal((64, ts.n_levels * c)).astype(np.float32)

    def rec(x, t, gg, warp=32):
        return temporal_bwd_records(torch.as_tensor(gg), ts,
                                    torch.as_tensor(x), torch.as_tensor(t),
                                    warp).tolist()

    assert rec(one, t1, g) == [2 * 8] * ts.n_levels
    assert rec(one, t1, g, warp=1) == [64 * 8] * ts.n_levels
    t2 = t1.copy()
    t2[40] += np.float32(1 / ts.time_scale)  # another window row: 3 runs
    assert rec(one, t2, g) == [4 * 8] * ts.n_levels
    g0 = g.copy()
    g0[1:32] = 0.0   # the first warp's run holds lane 0's terms alone
    assert rec(one, t1, g0) == [2 * 8] * ts.n_levels
    g0[0] = 0.0
    assert rec(one, t1, g0) == [8] * ts.n_levels
    xyz, t, _ = ray_major_inputs(ts, n_rays=4, n_samples=40)
    gg = rng.standard_normal((len(xyz), ts.n_levels * c)).astype(np.float32)
    runs, single = rec(xyz, t, gg), rec(xyz, t, gg, warp=1)
    assert all(0 < a <= b for a, b in zip(runs, single))
    assert runs[0] < single[0] and single[0] <= len(xyz) * 8


def test_t2_constants_match_the_kernel():
    """The host's sizes of T2's scratch and its reckonings read the
    kernel's own constants: the table rows a bucket, the records a warp
    sums of a bucket (csrc/temporal_grid_bwd.cu) and the scan's tile
    (csrc/bucket_scan.cuh)."""
    import re
    from pathlib import Path

    from gfnerf_tpu_torch.ops import temporal_grid as ops

    csrc = Path(__file__).resolve().parents[1] / "gfnerf_tpu_torch" / "csrc"
    src = "".join((csrc / name).read_text() for name in (
        "temporal_grid_bwd.cu", "bucket_scan.cuh"))

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const("kBucketRows") == ops.BUCKET_ROWS
    assert const("kChunk") == ops.BWD_CHUNK
    assert const("kScanThreads") * const("kScanPer") == ops.BWD_SCAN_TILE


@pytest.mark.parametrize("levels,per,points,want", [
    (16, 0, 196_608, 5), (16, 2, 196_608, 19), (5, 8, 1_048_576, 5),
    (5, 1, 3, 13), (16, 0, 0, 0)])
def test_t2_launches_a_call(levels, per, points, want):
    """T2's launches a call: the level maxima, a count and a scatter per
    group of levels, the scan and the owner pass (none without points);
    one zero-fill either way."""
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    assert ops.bwd_launches(levels, per, points) == want
    assert ops.bwd_memsets(points) == 1


# ---- the models ----


def rays(seed=0, n=R):
    """Rays near (0, 0, 3) looking down into the box, targets and
    appearance indices over the 4 cameras (numpy)."""
    rng = np.random.default_rng(seed)
    o = (rng.standard_normal((n, 3)) * 0.1 + [0, 0, 3]).astype(np.float32)
    d = rng.standard_normal((n, 3)).astype(np.float32)
    d[:, 2] = -np.abs(d[:, 2]) - 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    tgt = rng.random((n, 3)).astype(np.float32)
    rel = (np.arange(n) % 4).astype(np.int32)
    return o, d, tgt, rel


@functools.lru_cache(maxsize=None)
def model_pair(kind):
    """(JAX cfg, params, statics, model_state, the port's cfg) of one small
    model with TIMES as its cameras' times, the grids replaced by
    uniform(-1, 1) from seed 5 so renders are not near-constant; ngp's
    occupancy grid uniform(0, 0.02) from seed 6, so the threshold culls
    about half the samples."""
    import jax.numpy as jnp
    from gfnerf_tpu.models import nerfplayer as J
    from gfnerf_tpu_torch.models import nerfplayer as T

    rng = np.random.default_rng(5)

    def table(x):
        return jnp.asarray(rng.uniform(-1, 1, x.shape).astype(np.float32))

    if kind == "nerfacto":
        jcfg = J.NerfplayerConfig(**SMALL, num_images=4)
        tcfg = T.NerfplayerConfig(**SMALL, num_images=4)
        jp, js = J.init_nerfplayer_params(jcfg, 0, TIMES)
        jp = dict(jp, field_emb=table(jp["field_emb"]),
                  prop_embs=[table(e) for e in jp["prop_embs"]])
        return jcfg, jp, js, None, tcfg
    jcfg = J.NerfplayerNGPConfig(**SMALL_NGP, num_images=4)
    tcfg = T.NerfplayerNGPConfig(**SMALL_NGP, num_images=4)
    jp, js, _ = J.init_nerfplayer_ngp_params(jcfg, 0, TIMES)
    jp = dict(jp, field_emb=table(jp["field_emb"]))
    occ = np.random.default_rng(6).uniform(0, 0.02, (16,) * 3).astype(
        np.float32)
    return jcfg, jp, js, {"occ": jnp.asarray(occ)}, tcfg


def port_model(kind, device="cpu"):
    from gfnerf_tpu_torch.models.nerfplayer import params_from_jax

    _, jp, js, ms, tcfg = model_pair(kind)
    return params_from_jax(jp, js, ms, tcfg, device=device)


def jax_draws(kind, key, n_rays=R):
    """The port's draws from the JAX loss's key: ``k_fwd, k_tv =
    split(key)``; nerfacto's sampler draws ``split(k_fwd, L + 1)`` (one
    (R, n + 1) uniform a level and one for the final resample), ngp's one
    (R, S) uniform from ``k_fwd``; then each grid's TV row,
    ``randint(k_tv, (), 0, rows)`` (field first)."""
    import jax

    jcfg, _, js, _, _ = model_pair(kind)
    k_fwd, k_tv = jax.random.split(key)
    sts = [js["field_st"], *js.get("prop_sts", [])]
    rows = torch.tensor([int(jax.random.randint(k_tv, (), 0,
                                                st.sel_old.shape[0]))
                         for st in sts])
    if kind == "nerfacto":
        keys = jax.random.split(k_fwd, len(PROPS) + 1)
        draws = [torch.tensor(np.array(jax.random.uniform(k, (n_rays,
                                                               n + 1))))
                 for k, n in zip(keys, [*PROPS, NERF])]
        return draws, rows
    return torch.tensor(np.array(jax.random.uniform(
        k_fwd, (n_rays, jcfg.num_samples)))), rows


def close(got, want, what, atol_rel=MODEL_TOL):
    want = np.asarray(want)
    np.testing.assert_allclose(to_np(got), want, rtol=0,
                               atol=atol_rel * max(float(np.abs(want).max()),
                                                   1e-30), err_msg=what)


@pytest.mark.parametrize("kind", ["nerfacto", "ngp"])
def test_init_params_match_jax(kind):
    """Both models' parameters, statics and grid at a registered width's
    layout (cut tables) equal the JAX package's bit for bit; the model
    holds them, its cameras' times and (ngp) the grid as buffers."""
    import jax
    from gfnerf_tpu.models import nerfplayer as J
    from gfnerf_tpu_torch.models import nerfplayer as T

    if kind == "nerfacto":
        jout = J.init_nerfplayer_params(J.NerfplayerConfig(**SMALL), 3, TIMES)
        tout = T.init_nerfplayer_params(T.NerfplayerConfig(**SMALL), 3, TIMES)
        buffers = {"camera_times"}
    else:
        jout = J.init_nerfplayer_ngp_params(J.NerfplayerNGPConfig(
            **SMALL_NGP), 3)
        tout = T.init_nerfplayer_ngp_params(T.NerfplayerNGPConfig(
            **SMALL_NGP), 3)
        buffers = {"camera_times", "occ"}
    jl, tl = jax.tree_util.tree_leaves(jout), jax.tree_util.tree_leaves(tout)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        if dataclasses.is_dataclass(a):
            for f in ("offsets", "sel_pass", "hashed"):
                np.testing.assert_array_equal(getattr(a, f), getattr(b, f))
        else:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    model = port_model(kind)
    assert {n for n, _ in model.named_buffers()} == buffers
    np.testing.assert_array_equal(model.camera_times.numpy(), TIMES)


@pytest.mark.parametrize("case", ["nerfacto-train", "nerfacto-eval",
                                  "ngp-train", "ngp-eval"])
def test_forward_loss_and_grads_match_jax(case):
    """Each model's loss and gradients against the JAX package's
    value_and_grad, eager and jitted, on the same rays (their cameras at
    four times) and, in training, the same draws and TV rows; in eval the
    jitted forward alone (no jitter).  The outputs depend on the time:
    camera 0's time renders otherwise than camera 3's."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.models import nerfplayer as J
    from gfnerf_tpu_torch.models import nerfplayer as T

    kind, mode = case.split("-")
    jcfg, jp, js, ms, _ = model_pair(kind)
    o, d, tgt, rel = rays()
    jargs = tuple(jnp.asarray(x) for x in (o, d, rel, tgt))
    targs = (torch.from_numpy(o), torch.from_numpy(d),
             torch.from_numpy(rel).long(), torch.from_numpy(tgt))
    model = port_model(kind)
    key = jax.random.PRNGKey(7)
    if mode == "eval":
        if kind == "nerfacto":
            jout = jax.jit(lambda p: J.nerfplayer_forward(
                p, js, jcfg, key, *jargs[:3], train=False))(jp)
            out = T.nerfplayer_forward(model, *targs[:3])
        else:
            jout = jax.jit(lambda p: J.nerfplayer_ngp_forward(
                p, js, ms, jcfg, key, *jargs[:3], train=False))(jp)
            out = T.nerfplayer_ngp_forward(model, *targs[:3])
        for k in ("rgb", "accumulation", "depth", "weights"):
            close(out[k], jout[k], k)
        zero = (T.nerfplayer_forward if kind == "nerfacto"
                else T.nerfplayer_ngp_forward)(
            model, *targs[:2], torch.zeros_like(targs[2]))
        assert float((zero["rgb"] - out["rgb"]).abs().max()) > 1e-3
        return

    def jloss(p):
        if kind == "nerfacto":
            return J.nerfplayer_loss(p, js, jcfg, key, *jargs)
        return J.nerfplayer_ngp_loss(p, js, ms, jcfg, key, *jargs)

    draws, rows = jax_draws(kind, key)
    loss = T.nerfplayer_loss if kind == "nerfacto" else T.nerfplayer_ngp_loss
    total, (losses, out) = loss(model, *targs, draws, rows)
    total.backward()
    grads = [("field_emb", model.field_emb.grad, "field_emb")]
    mlps = [("base_net", model.base_net), ("mlp_head", model.mlp_head)]
    if kind == "nerfacto":
        grads += [(f"prop_embs[{i}]", e.grad, ("prop_embs", i))
                  for i, e in enumerate(model.prop_embs)]
        grads.append(("appearance", model.appearance.grad, "appearance"))
        mlps += [(f"prop_mlps[{i}]", m) for i, m in enumerate(model.prop_mlps)]
    for name, m in mlps:
        key_of = (("prop_mlps", int(name[-2])) if name.startswith("prop")
                  else (name,))
        for part in ("w", "b"):
            grads += [(f"{name}.{part}[{i}]", p.grad, (*key_of, part, i))
                      for i, p in enumerate(getattr(m, part))]

    def leaf(tree, path):
        for k in (path if isinstance(path, tuple) else (path,)):
            tree = tree[k]
        return np.asarray(tree)

    for jit, tol in ((False, MODEL_TOL), (True, JIT_GRAD_TOL)):
        step = jax.value_and_grad(jloss, has_aux=True)
        (jt, (jl, jo)), jg = (jax.jit(step) if jit else step)(jp)
        assert set(losses) == set(jl)
        for k in jl:
            np.testing.assert_allclose(float(losses[k].detach()),
                                       float(jl[k]), rtol=1e-5, err_msg=k)
        np.testing.assert_allclose(float(total.detach()), float(jt),
                                   rtol=1e-5)
        for k in ("rgb", "accumulation", "depth", "weights"):
            close(out[k], jo[k], k)
        errs = {}
        for name, got, path in grads:
            want = leaf(jg, path)
            scale = float(np.abs(want).max())
            assert scale > 0, name
            errs[name] = float(np.abs(to_np(got) - want).max()) / scale
        assert max(errs.values()) <= tol, (jit, errs)


def test_update_ngp_occupancy_matches_jax():
    """Two EMA updates with the JAX key's jitter and times handed over
    (``k1, k2 = split(key)``): 1e-5 relative; the grid stays above the
    decayed one and moves off its start; the lookup of marched points
    equals the JAX forward's cull (the same kept share)."""
    import jax
    from gfnerf_tpu.models import nerfplayer as J
    from gfnerf_tpu_torch.models import nerfplayer as T

    jcfg, jp, js, ms, _ = model_pair("ngp")
    g = jcfg.grid_resolution
    update = jax.jit(lambda p, m, k: J.update_ngp_occupancy(p, js, m, jcfg,
                                                            k))
    model = port_model("ngp")
    for seed in (3, 4):
        key = jax.random.PRNGKey(seed)
        k1, k2 = jax.random.split(key)
        before = model.occ.clone()
        ms = update(jp, ms, key)
        T.update_ngp_occupancy(
            model, torch.tensor(np.array(jax.random.uniform(k1, (g ** 3,
                                                                3)))),
            torch.tensor(np.array(jax.random.uniform(k2, (g ** 3,)))))
        np.testing.assert_allclose(model.occ.numpy(), np.asarray(ms["occ"]),
                                   rtol=1e-5, atol=0)
        assert bool((model.occ >= before * T.OCC_DECAY).all())
        assert not torch.equal(model.occ, before)


# ---- the pipeline ----

PIPE_RAYS = 64
# the scene's train cameras' times
TRAIN_TIMES = np.float32(np.arange(8) % 4) / np.float32(3)
PIPE_STEPS = {"nerfplayer-nerfacto": (0, 1, 2, 3),
              "nerfplayer-ngp": (0, 1, 2, 16, 17)}


@pytest.fixture(scope="module")
def scene(tmp_path_factory):
    """A D-NeRF scene of RGBA PNGs at 24x16: 8 train views at times (i mod
    4) / 3 and 2 val views at times 0 and 1/3."""
    from gfnerf_tpu_torch.utils.synthetic import make_dnerf_fixture

    return make_dnerf_fixture(tmp_path_factory.mktemp("dnerf") / "scene", 8,
                              2, img_wh=(24, 16), focal=22.0)


def small_pipeline(cfg, kind):
    """``cfg`` (either package's VanillaPipelineConfig) cut to the small
    model."""
    cfg.train_num_rays_per_batch = PIPE_RAYS
    cfg.eval_num_rays_per_chunk = 96
    sub, small = ((cfg.nerfplayer, SMALL) if kind == "nerfplayer-nerfacto"
                  else (cfg.nerfplayer_ngp, SMALL_NGP))
    for k, v in small.items():
        setattr(sub, k, v)
    return cfg


def jax_parser(scene):
    from gfnerf_tpu.data.dataparsers.extra_parsers import (
        DNeRFDataParser, DNeRFDataParserConfig)

    return DNeRFDataParser(DNeRFDataParserConfig(data=scene))


@functools.lru_cache(maxsize=None)
def _pipelines(scene, kind, tmp):
    """The JAX and the port's pipelines of ``kind`` after its PIPE_STEPS,
    the port's draws taken from the JAX pipeline's key chain (each step
    ``rng, key = split(rng)``, then for ngp at every 16th step ``rng, okey
    = split(rng)``), and both runs' metrics."""
    import jax
    from gfnerf_tpu.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig as JaxConfig)
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    jcfg = small_pipeline(JaxConfig(model_kind=kind), kind)
    jpipe = jcfg.build(jax_parser(scene), tmp / "jax")
    steps = PIPE_STEPS[kind]
    rng, keys, okeys = jax.random.PRNGKey(jcfg.seed), {}, {}
    for step in steps:
        rng, keys[step] = jax.random.split(rng)
        if kind == "nerfplayer-ngp" and step % 16 == 0:
            rng, okeys[step] = jax.random.split(rng)
    sts = jpipe.statics
    sts = [sts["field_st"], *sts.get("prop_sts", [])]

    def draws(step, r):
        k_fwd, k_tv = jax.random.split(keys[step])
        rows = np.array([int(jax.random.randint(k_tv, (), 0,
                                                st.sel_old.shape[0]))
                         for st in sts])
        if kind == "nerfplayer-nerfacto":
            ks = jax.random.split(k_fwd, len(PROPS) + 1)
            return [np.array(jax.random.uniform(k, (r, n + 1)))
                    for k, n in zip(ks, [*PROPS, NERF])] + [rows]
        return [np.array(jax.random.uniform(
            k_fwd, (r, SMALL_NGP["num_samples"]))), rows]

    def occupancy(step):
        k1, k2 = jax.random.split(okeys[step])
        n = SMALL_NGP["grid_resolution"] ** 3
        return [np.array(jax.random.uniform(k1, (n, 3))),
                np.array(jax.random.uniform(k2, (n,)))]

    pcfg = small_pipeline(VanillaPipelineConfig(model_kind=kind), kind)
    pipe = pcfg.build(build_dataparser("dnerf", scene), tmp / "port", "cpu",
                      draws=draws, occupancy_draws=occupancy)
    jm = [jpipe.get_train_loss_dict(s) for s in steps]
    tm = [pipe.get_train_loss_dict(s) for s in steps]
    return jpipe, pipe, jm, tm


@pytest.fixture(scope="module")
def pipelines(scene, tmp_path_factory):
    return lambda kind: _pipelines(scene, kind,
                                   tmp_path_factory.mktemp(kind))


@pytest.mark.parametrize("kind", ["nerfplayer-nerfacto", "nerfplayer-ngp"])
def test_vanilla_pipeline_matches_jax(pipelines, kind):
    """A few steps of the port's VanillaPipeline of each kind against the
    JAX package's on the same D-NeRF scene, seed, batches and draws (ngp:
    the grid updated before steps 0 and 16); then the eval PSNR.  The
    cameras' times are the parser's.

    Tolerances (relative; measured over both kinds' steps): every loss and
    the train PSNR 1e-4 (1.6e-5, nerfacto's TV term; its interlevel loss
    1.3e-5); the grid after its update at step 16 1e-5 (measured equal);
    the eval PSNR 1e-5 and its SSIM 1e-4 (2.0e-6).  The bins move by the
    CDF's rounding (test_torch_nerfacto's finding); the few steps keep
    Adam's sign flips small."""
    jpipe, pipe, jm, tm = pipelines(kind)
    np.testing.assert_array_equal(pipe.model.camera_times.numpy(),
                                  TRAIN_TIMES)
    assert pipe.state.step == len(PIPE_STEPS[kind])
    for step, a, b in zip(PIPE_STEPS[kind], tm, jm):
        assert set(a) == set(b)
        assert "temporal_tv_loss" in a
        for k in a:
            np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                       err_msg=f"step {step} {k}")
    if kind == "nerfplayer-ngp":
        np.testing.assert_allclose(pipe.model.occ.numpy(),
                                   np.asarray(jpipe.model_state["occ"]),
                                   rtol=1e-5, atol=0)
        assert not bool((pipe.model.occ == 1.0).any())
    want = jpipe.get_eval_image_metrics_and_images(0)[0]
    got, images = pipe.get_eval_image_metrics_and_images(0)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=1e-5)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=1e-4)
    assert images["img"].shape == (16, 48, 3)


@pytest.mark.parametrize("kind", ["nerfplayer-nerfacto", "nerfplayer-ngp"])
def test_eval_rays_take_camera_0_time_as_in_jax(pipelines, kind):
    """A reference trait the port keeps: both packages render every eval
    and render ray with ``rel = 0``, so the second val view (time 1/3) is
    rendered at train camera 0's time (0) and with its appearance.  In
    each package the pipeline's render equals the model's forward with rel
    0 and differs from the forward with the train camera whose time is the
    view's own (camera 1, time 1/3); the two packages' renders agree."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.cameras.cameras import generate_rays as jax_rays
    from gfnerf_tpu.models import nerfplayer as J
    from gfnerf_tpu_torch.cameras.cameras import generate_rays
    from gfnerf_tpu_torch.cameras.cameras import get_image_coords
    from gfnerf_tpu_torch.models import nerfplayer as T

    jpipe, pipe, *_ = pipelines(kind)
    assert float(pipe.eval_outputs.metadata["times"][1]) == float(
        pipe.model.camera_times[1]) > 0
    h, w = 16, 24
    coords = get_image_coords(h, w)
    jr = jax_rays(jpipe.eval_outputs.cameras.to_device(), 1,
                  jnp.asarray(coords))
    tr = generate_rays(pipe.eval_cameras_dev, 1, torch.from_numpy(coords))
    jo, jd = (jnp.asarray(np.asarray(jr[k]).reshape(-1, 3))
              for k in ("origins", "directions"))
    to, td = (tr[k].reshape(-1, 3) for k in ("origins", "directions"))
    jrend = jpipe.render_camera(jpipe.eval_outputs.cameras, 1)["rgb"]
    trend = pipe.render_camera(pipe.eval_outputs.cameras,
                               pipe.eval_cameras_dev, 1)["rgb"]
    n = h * w
    jcfg, key = jpipe.model_cfg, jax.random.PRNGKey(0)
    for rel in (0, 1):
        jrel = jnp.full((n,), rel, jnp.int32)
        trel = torch.full((n,), rel, dtype=torch.int64)
        if kind == "nerfplayer-nerfacto":
            jout = J.nerfplayer_forward(jpipe.params, jpipe.statics, jcfg,
                                        key, jo, jd, jrel, train=False)
            tout = T.nerfplayer_forward(pipe.model, to, td, trel)
        else:
            jout = J.nerfplayer_ngp_forward(
                jpipe.params, jpipe.statics, jpipe.model_state, jcfg, key,
                jo, jd, jrel, train=False)
            tout = T.nerfplayer_ngp_forward(pipe.model, to, td, trel)
        jrgb = np.asarray(jout["rgb"]).reshape(h, w, 3)
        trgb = tout["rgb"].detach().numpy().reshape(h, w, 3)
        same = (np.abs(jrend - jrgb).max() <= 1e-5
                and np.abs(trend - trgb).max() <= 1e-5)
        assert same == (rel == 0), rel
    # the renders agree to 1e-4 (measured 6.8e-6, after the steps)
    np.testing.assert_allclose(trend, jrend, rtol=0, atol=1e-4)


def test_ngp_checkpoint_holds_the_grid_unlike_jax(pipelines, tmp_path,
                                                  monkeypatch):
    """A repair: the JAX package's checkpoint holds params, optimizer state
    and statics but not ``model_state``, so a resumed or evaluated
    nerfplayer-ngp starts from an all-ones grid; the port's holds the grid
    (and the cameras' times) as buffers of the model, and a pipeline
    loaded from it renders the same eval image."""
    import orbax.checkpoint as ocp

    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.pipelines.vanilla_pipeline import (
        VanillaPipelineConfig)

    jpipe, pipe, *_ = pipelines("nerfplayer-ngp")
    saved = {}

    class Capture:
        def save(self, path, tree):
            saved.update(tree)

    monkeypatch.setattr(ocp, "PyTreeCheckpointer", Capture)
    (tmp_path / "jax_ckpt").mkdir()
    jpipe.save_checkpoint_state(tmp_path / "jax_ckpt", 17)
    assert set(saved) == {"params", "opt_state", "statics"}
    assert not bool((np.asarray(jpipe.model_state["occ"]) == 1.0).any())
    ckpt = tmp_path / "port_ckpt"
    ckpt.mkdir()
    pipe.save_checkpoint_state(ckpt, 17)
    scene = pipe.train_outputs.image_filenames[0].parent.parent
    fresh = small_pipeline(VanillaPipelineConfig(model_kind="nerfplayer-ngp"),
                           "nerfplayer-ngp").build(
        build_dataparser("dnerf", scene), tmp_path / "fresh", "cpu")
    assert bool((fresh.model.occ == 1.0).all())
    assert fresh.load_checkpoint_state(ckpt) == 17
    assert torch.equal(fresh.model.occ, pipe.model.occ)
    assert torch.equal(fresh.model.camera_times, pipe.model.camera_times)
    a = fresh.render_camera(fresh.eval_outputs.cameras,
                            fresh.eval_cameras_dev, 0)["rgb"]
    b = pipe.render_camera(pipe.eval_outputs.cameras, pipe.eval_cameras_dev,
                           0)["rgb"]
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind", ["nerfplayer-nerfacto", "nerfplayer-ngp"])
def test_trainer_runs_on_a_dnerf_scene(scene, tmp_path, kind):
    """``python -m gfnerf_tpu_torch.train nerfplayer-* --dataparser dnerf``
    on the CPU from the generator's draws, then ``eval`` (the dnerf parser
    guessed from the frames' times) and ``render`` on its checkpoint."""
    import json

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch import train as train_entry
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup, guess_dataparser
    from gfnerf_tpu_torch.utils.image_io import read_png

    sub = "nerfplayer" if kind == "nerfplayer-nerfacto" else "nerfplayer_ngp"
    small = SMALL if kind == "nerfplayer-nerfacto" else SMALL_NGP
    overrides = [f"pipeline.{sub}.{k}="
                 + (",".join(map(str, v)) if isinstance(v, tuple) else str(v))
                 for k, v in small.items()]
    out = tmp_path / "out"
    assert train_entry.main([
        kind, "--data", str(scene), "--dataparser", "dnerf", "--device",
        "cpu", "--max-num-iterations", "17", "--output-dir", str(out),
        "pipeline.train_num_rays_per_batch=64", *overrides]) == 0
    assert guess_dataparser(scene) == "dnerf"
    config = next(out.rglob("config.json"))
    _, trainer = eval_setup(config)
    model = trainer.pipeline.model
    np.testing.assert_array_equal(model.camera_times.numpy(), TRAIN_TIMES)
    if kind == "nerfplayer-ngp":
        assert not bool((model.occ == 1.0).any())   # two updates
    assert eval_entry.main(["--load-config", str(config), "--output-path",
                            str(tmp_path / "ev.json")]) == 0
    res = json.loads((tmp_path / "ev.json").read_text())["results"]
    assert np.isfinite(res["psnr"])
    assert render_entry.main(["--load-config", str(config), "--spiral-steps",
                              "2", "--output-path", str(tmp_path / "fr")]) \
        == 0
    frames = sorted((tmp_path / "fr").glob("*.png"))
    assert [read_png(f).shape for f in frames] == [(16, 24, 3)] * 2


# ---- on the card ----


# ray-major cases of the card test: (rays, samples a ray, scattered points
# before them).  "ray-runs": runs within warps; "breaks": a run broken at a
# window-row change (ray 1 retraces ray 0 one row later) and at cell
# changes; "warp-boundary": two long rays from lane 16 on, their runs
# across warp boundaries; "ragged-runs": 161 points, a ray's run in the
# last, ragged warp.
RAY_CASES = {"ray-runs": (16, 24, 0), "breaks": (4, 40, 3),
             "warp-boundary": (2, 64, 16), "ragged-runs": (7, 23, 0)}


@pytest.mark.parametrize("case", sorted(RAY_CASES))
def test_ray_major_cases_hold_their_patterns(case):
    """Each ray-major case of the card test holds, on the coarsest level,
    what T2's merge must handle: consecutive samples of one cell that a
    window-row change splits, samples of one row that a cell change
    splits, and runs that cross a warp boundary (lane 31 to lane 0)."""
    from gfnerf_tpu_torch.fields import temporal_grid as T

    levels, t, log2, base, finest = GRIDS["mixed"]
    _, st = T.make_temporal_grid(1, t, levels, 2, base, log2, finest)
    xyz, times, _ = ray_major_inputs(st, *RAY_CASES[case])
    row = np.minimum((times * np.float32(st.time_scale)).astype(np.int64),
                     st.n_rows - 1)
    cell = np.floor(xyz * np.float32(st.resolutions[0])).astype(np.int64)
    same_cell = (cell[1:] == cell[:-1]).all(1)
    same_row = row[1:] == row[:-1]
    warp_start = np.arange(1, len(xyz)) % 32 == 0
    assert (same_cell & ~same_row).any()
    assert (~same_cell & same_row).any()
    assert (same_cell & same_row & warp_start).any()
    if case == "ragged-runs":
        assert len(xyz) % 32 != 0


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hashed", "mixed", "dense", "c4", "c1",
                                  "one-point", "ragged", *RAY_CASES])
def test_t1_t2_match_plain_on_card(case):
    """T1 equals the plain encode and T2 the plain table gradient bit for
    bit (both exact: T2 sums in int64 fixed point), T2 also called again
    and on the points permuted, on faces, cell edges and window-row
    boundaries, and on ray-major samples whose runs T2 merges; T2's records
    per level as reckoned (fewer than the corners at the coarsest level of
    the ray-major cases); at one and at all levels a launch; launches and
    zero-fills counted."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields import temporal_grid as T
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    grid = case if case in GRIDS else "mixed"
    levels, t, log2, base, finest = GRIDS[grid]
    _, st = T.make_temporal_grid(1, t, levels,
                                 {"c4": 4, "c1": 1}.get(case, 2), base, log2,
                                 finest)
    if case in RAY_CASES:
        n_rays, n_samples, lead = RAY_CASES[case]
        xyz, times, table = ray_major_inputs(st, n_rays, n_samples, lead)
    else:
        n = {"one-point": 1, "ragged": 1025}.get(case, 257)
        xyz, times, table = encode_inputs(st, n=max(n, 24))
        xyz, times = xyz[:n], times[:n]
    dev = "cuda"
    args = (torch.tensor(table, device=dev), st,
            torch.tensor(xyz, device=dev), torch.tensor(times, device=dev))
    tables = st.tables(dev)
    rows = table.shape[0]
    want = T.temporal_grid_encode_raw(*args)
    g = torch.randn(want.shape, generator=torch.Generator(
        device=dev).manual_seed(2), device=dev)
    gp = T.temporal_backward_reference(g, st, *args[2:], rows)
    records = T.temporal_bwd_records(g, st, *args[2:])
    perm = torch.randperm(len(xyz), generator=torch.Generator(
        device=dev).manual_seed(3), device=dev)
    moved_args = (args[2][perm].contiguous(), args[3][perm].contiguous())
    for group in (None, 1):
        bwd = ops.temporal_grid_bwd
        before = (ops.temporal_grid_fwd.launches, bwd.launches, bwd.memsets)
        got = ops.temporal_grid_fwd(args[0], tables, *args[2:],
                                    levels_per_launch=group)
        assert torch.equal(got, want)
        red = torch.zeros(levels, dtype=torch.int64, device=dev)
        gk = bwd(g, tables, *args[2:], rows, level_records=red,
                 levels_per_launch=group)
        again = bwd(g, tables, *args[2:], rows, levels_per_launch=group)
        moved = bwd(g[perm].contiguous(), tables, *moved_args, rows,
                    levels_per_launch=group)
        torch.cuda.synchronize()
        for other in (gp, again, moved):
            assert torch.equal(gk, other)
        assert torch.equal(red, records)
        per = ops.FWD_LEVELS_PER_LAUNCH if group is None else group
        per_b = ops.BWD_LEVELS_PER_LAUNCH if group is None else group
        assert (ops.temporal_grid_fwd.launches - before[0],
                bwd.launches - before[1], bwd.memsets - before[2]) == (
            ops.n_launches(levels, per),
            3 * ops.bwd_launches(levels, per_b, len(xyz)),
            3 * ops.bwd_memsets(len(xyz)))
        # every lane a run of its own: at most 8 records a point and level
        assert 0 < int(red[0]) <= 8 * len(xyz)
        if case in RAY_CASES:
            assert int(red[0]) < 8 * len(xyz)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["nerfacto", "ngp"])
def test_model_kernels_match_plain_on_card(kind):
    """One loss and backward of each small model on the card through T1
    and T2 (nerfacto: three calls each; ngp: one, and T1 once more in the
    occupancy update; a launch per group of levels a call) and through the
    plain pairs, on the same draws:
    losses to 1e-5 relative, every gradient to 1e-5 of its largest; the
    occupancy update equal bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from gfnerf_tpu_torch.fields import temporal_grid as tg
    from gfnerf_tpu_torch.models import nerfplayer as T
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    # numpy only: the CUDA tests run without JAX (--noconftest)
    rng = np.random.default_rng(5)
    if kind == "nerfacto":
        cfg = T.NerfplayerConfig(**SMALL, num_images=4)
        params, statics = T.init_nerfplayer_params(cfg, 0, TIMES)
        params["field_emb"] = rng.uniform(-1, 1, params["field_emb"].shape)
        params["prop_embs"] = [rng.uniform(-1, 1, e.shape)
                               for e in params["prop_embs"]]
        state, loss = None, T.nerfplayer_loss
        levels = [cfg.prop_num_levels] * 2 + [cfg.num_levels]
        calls = (levels, levels)
    else:
        cfg = T.NerfplayerNGPConfig(**SMALL_NGP, num_images=4)
        params, statics, state = T.init_nerfplayer_ngp_params(cfg, 0, TIMES)
        params["field_emb"] = rng.uniform(-1, 1, params["field_emb"].shape)
        state["occ"] = np.random.default_rng(6).uniform(0, 0.02, (16,) * 3)
        loss = T.nerfplayer_ngp_loss
        calls = ([cfg.num_levels] * 2, [cfg.num_levels])
    o, d, tgt, rel = rays()
    gen = torch.Generator(device="cuda").manual_seed(0)
    runs = []
    for plain in (False, True):
        model = (T.NerfplayerModel(cfg, params, statics, "cuda")
                 if kind == "nerfacto" else
                 T.NerfplayerNGPModel(cfg, params, statics, state, "cuda"))
        gen.manual_seed(0)
        if kind == "nerfacto":
            draws = [torch.rand((R, n + 1), generator=gen, device="cuda")
                     for n in (*PROPS, NERF)]
        else:
            draws = torch.rand((R, cfg.num_samples), generator=gen,
                               device="cuda")
            occ_draws = T.occupancy_draws(cfg, gen, "cuda")
        rows = T.tv_rows(model, gen, "cuda")
        encode = T.temporal_grid_encode
        T.temporal_grid_encode = (tg.plain_temporal_grid_encode if plain
                                  else encode)
        before = (ops.temporal_grid_fwd.launches,
                  ops.temporal_grid_bwd.launches)
        try:
            total, (losses, _) = loss(
                model, *(torch.as_tensor(x, device="cuda") for x in (
                    o, d, rel.astype(np.int64), tgt)), draws, rows)
            total.backward()
            if kind == "ngp":
                T.update_ngp_occupancy(model, *occ_draws)
        finally:
            T.temporal_grid_encode = encode
        want = (0, 0) if plain else (
            sum(ops.n_launches(n, ops.FWD_LEVELS_PER_LAUNCH)
                for n in calls[0]),
            sum(ops.bwd_launches(n, ops.BWD_LEVELS_PER_LAUNCH, R)
                for n in calls[1]))
        assert (ops.temporal_grid_fwd.launches - before[0],
                ops.temporal_grid_bwd.launches - before[1]) == want
        runs.append((losses, [p.grad.clone() for p in model.parameters()],
                     None if state is None else model.occ.clone()))
    (kl, kg, ko), (pl, pg, po) = runs
    for k in kl:
        torch.testing.assert_close(kl[k], pl[k], rtol=1e-5, atol=0)
    for a, b in zip(kg, pg):
        torch.testing.assert_close(a, b, rtol=0,
                                   atol=1e-5 * float(b.abs().max()))
    if state is not None:
        assert torch.equal(ko, po)
