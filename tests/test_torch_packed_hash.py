"""Parity of the ported packed hash encode and its table gradient
(gfnerf_tpu_torch/fields/packed_hash.py) with the JAX package's.

The JAX side runs jitted, as the render path runs it: XLA then fuses
``p * scale + bias`` into one multiply-add, and the port reproduces that
rounding.  Row indices (the uint32 hash and the dense addressing) must match
exactly; features to atol 1e-6 (both sum the same bf16 table values in f32,
in the same order, up to multiply-add contraction).
"""

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


@pytest.mark.cuda
@pytest.mark.parametrize("c,dense", [(2, 0), (4, 0), (8, 0), (4, 2)])
def test_kernel_matches_plain_on_card(c, dense):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode,
                                                     packed_hash_encode_raw)

    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    _, prim, bias = init_packed_hash_params(7, ROWS_LOG2, N_VOLUMES,
                                            N_LEVELS, c)
    feat = np.random.default_rng(7).uniform(
        -0.5, 0.5, (N_LEVELS, 1 << ROWS_LOG2, 128)).astype(np.float32)
    pts, anc = _points(p=1 << 16, n_invalid=1000)
    args = [torch.as_tensor(a, device="cuda") for a in
            (feat, prim.astype(np.int64), bias, pts, anc)]
    pack = pack_for_channels(c)
    before = packed_hash_encode.launches
    got = packed_hash_encode(*args, c, pack, dense)
    torch.cuda.synchronize()
    assert packed_hash_encode.launches == before + 1
    ref = packed_hash_encode_raw(*args, c, pack, dense)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(), rtol=0,
                               atol=1e-5)


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
@pytest.mark.parametrize("c,dense", [(2, 0), (4, 0), (8, 0), (4, 2)])
def test_backward_kernel_matches_plain_on_card(c, dense):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (
        init_packed_hash_params, pack_for_channels,
        packed_hash_backward_reference, packed_hash_encode)

    _, prim, bias = init_packed_hash_params(7, ROWS_LOG2, N_VOLUMES,
                                            N_LEVELS, c)
    pts, anc = _points(p=1 << 16, n_invalid=1000)
    feat = torch.zeros((N_LEVELS, 1 << ROWS_LOG2, 128), device="cuda",
                       requires_grad=True)
    args = [torch.as_tensor(a, device="cuda") for a in
            (prim.astype(np.int64), bias, pts, anc)]
    g = torch.randn((len(pts), N_LEVELS * c), device="cuda",
                    generator=torch.Generator("cuda").manual_seed(c))
    pack = pack_for_channels(c)
    before = packed_hash_encode.bwd_launches
    packed_hash_encode(feat, *args, c, pack, dense).backward(g)
    torch.cuda.synchronize()
    assert packed_hash_encode.bwd_launches == before + 1
    ref = packed_hash_backward_reference(g, *args, 1 << ROWS_LOG2, 128, c,
                                         pack, dense)
    scale = float(ref.abs().max())
    np.testing.assert_allclose(feat.grad.cpu().numpy(), ref.cpu().numpy(),
                               rtol=0, atol=1e-5 * scale)
    live = (pack + 1) ** 3 * c
    assert bool((feat.grad[..., live:] == 0).all())


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
