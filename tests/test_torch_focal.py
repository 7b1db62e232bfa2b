"""The focal (block) stage of the port against the JAX package's: the
block-routed packed encode, ``field_density`` at ``STAGE_BLOCK`` in both
focal modes, ``field_density_routed``, one whole focal train step, and
block-routed rendering.

The JAX side runs jitted, as its train and render paths run it.  Tolerances
as in the init-stage tests: the encode to atol 1e-6 (the same bf16 table
values summed in f32 in the same order, up to multiply-add contraction);
f32 MLP outputs to 1e-5 of their scale; a train step's losses to 1e-5, its
table gradient to 2e-2 of the largest entry (the JAX backward rounds its
payload to bf16, the port sums in f32).
"""

import numpy as np
import pytest
import torch

from torch_parity import (TRAIN_S, field_pair, jax_groups, jax_train_step,
                          octree_pair, port_train_step, tiny_rays, to_np,
                          train_batch)

ROWS_LOG2 = 12
N_LEVELS = 4
N_VOLUMES = 3     # small enough that dense levels fit 2^12 rows
N_BLOCKS = 3


def _stacked(c, rows_log2=ROWS_LOG2, seed=7):
    """(tables (B, L, rows, 128), primes (B, L, V, 3) uint32, biases) with
    each block's own draws, as ``init_field_params`` makes them in residual
    mode, and random table values."""
    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    pools = [init_packed_hash_params(seed + b, rows_log2, N_VOLUMES, N_LEVELS,
                                     c) for b in range(N_BLOCKS)]
    prims = np.stack([p[1] for p in pools])
    biases = np.stack([p[2] for p in pools])
    tables = np.random.default_rng(seed).uniform(
        -0.5, 0.5, (N_BLOCKS, N_LEVELS, 1 << rows_log2, 128)
    ).astype(np.float32)
    return tables, prims, biases


def _routed_points(p=4096, seed=1, n_bad_anchor=200, n_bad_block=200):
    """Random points, anchors and mixed blocks; some anchors and some
    blocks are -1 (not the same points), and one block index lies past the
    last (it is clipped)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(0.17, 0.83, (p, 3)).astype(np.float32)
    anc = rng.integers(0, N_VOLUMES, p).astype(np.int32)
    blk = rng.integers(0, N_BLOCKS, p).astype(np.int32)
    anc[rng.choice(p, n_bad_anchor, replace=False)] = -1
    blk[rng.choice(p, n_bad_block, replace=False)] = -1
    blk[0] = N_BLOCKS + 2
    anc[0] = 1
    return pts, anc, blk


def _t(tables, prims, biases, pts, anc, blk, device="cpu"):
    return [torch.as_tensor(x, device=device) for x in
            (tables, prims.astype(np.int64), biases, pts, anc, blk)]


@pytest.mark.parametrize("c,dense", [(4, 0), (4, 2), (2, 0), (8, 0), (2, 2)])
def test_routed_encode_raw_matches_jax(c, dense):
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields.packed_hash import packed_hash_encode_routed
    from gfnerf_tpu_torch.fields.packed_hash import (
        pack_for_channels, packed_hash_encode_routed_raw)

    tables, prims, biases = _stacked(c)
    pts, anc, blk = _routed_points(seed=c + dense)
    pack = pack_for_channels(c)
    j = np.asarray(jax.jit(packed_hash_encode_routed,
                           static_argnums=(6, 7, 8))(
        *(jnp.asarray(x) for x in (tables, prims, biases, pts, anc, blk)),
        c, pack, dense))
    t = packed_hash_encode_routed_raw(
        *_t(tables, prims, biases, pts, anc, blk), c, pack, dense).numpy()
    assert t.shape == j.shape == (len(pts), N_LEVELS * c)
    assert np.abs(t).max() > 0.05
    np.testing.assert_allclose(t, j, rtol=0, atol=1e-6)
    masked = (anc < 0) | (blk < 0)
    assert masked.sum() > 300 and np.all(t[masked] == 0)
    assert np.all(np.abs(t[~masked]).max(-1) > 0)


@pytest.mark.parametrize("dense", [0, 2])
def test_routed_equals_scalar_block_and_mixes_rowwise(dense):
    """With one block for all points the routed encode is that block's
    unrouted encode, with its own primes and biases, bit for bit; with
    mixed blocks each row is the row of its block's encode."""
    from gfnerf_tpu_torch.fields.packed_hash import (
        packed_hash_encode_raw, packed_hash_encode_routed_raw)

    tables, prims, biases = _stacked(4)
    pts, anc, blk = _routed_points(p=1024, n_bad_block=0)
    blk[0] = 0
    tt, tp, tb, tpts, tanc, tblk = _t(tables, prims, biases, pts, anc, blk)
    per_block = []
    for b in range(N_BLOCKS):
        scalar = packed_hash_encode_raw(tt[b], tp[b], tb[b], tpts, tanc, 4,
                                        2, dense)
        routed = packed_hash_encode_routed_raw(
            tt, tp, tb, tpts, tanc, torch.full_like(tblk, b), 4, 2, dense)
        assert torch.equal(routed, scalar)
        per_block.append(scalar)
    assert not torch.equal(per_block[0], per_block[1])
    mixed = packed_hash_encode_routed_raw(tt, tp, tb, tpts, tanc, tblk, 4, 2,
                                          dense)
    want = torch.stack(per_block)[tblk.long(), torch.arange(len(pts))]
    assert torch.equal(mixed, want)


def test_routed_wrapper_cpu_takes_plain_path():
    """On CPU tensors the wrapper is the plain version: no launch, no
    graph (forward only), a bf16 stack gives the f32 stack's result."""
    from gfnerf_tpu_torch.fields.packed_hash import (
        packed_hash_encode_routed, packed_hash_encode_routed_raw,
        plain_packed_hash_encode_routed)

    args = _t(*_stacked(4), *_routed_points(p=512))
    args[0].requires_grad_(True)
    before = packed_hash_encode_routed.launches
    got = packed_hash_encode_routed(*args, 4, 2)
    assert packed_hash_encode_routed.launches == before
    assert not got.requires_grad
    want = packed_hash_encode_routed_raw(*args, 4, 2).detach()
    assert torch.equal(got, want)
    assert torch.equal(plain_packed_hash_encode_routed(*args, 4, 2), want)
    bf16 = [args[0].detach().to(torch.bfloat16), *args[1:]]
    assert torch.equal(packed_hash_encode_routed(*bf16, 4, 2), want)
    with pytest.raises(ValueError):   # the kernel runs on CUDA tensors only
        from gfnerf_tpu_torch.fields.packed_hash import \
            _packed_hash_routed_cuda
        _packed_hash_routed_cuda(*args, 4, 2, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c,dense,rows_log2", [(4, 0, 12), (4, 2, 12),
                                               (2, 0, 12), (8, 0, 12),
                                               (4, 2, 9)])
def test_routed_kernel_matches_plain_on_card(c, dense, rows_log2):
    """H3 against its plain version, bit for bit, on mixed blocks with
    masked anchors and blocks, one launch; given a bf16 stack as well."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gfnerf_tpu_torch.fields.packed_hash import (
        pack_for_channels, packed_hash_encode_routed,
        packed_hash_encode_routed_raw)

    pts, anc, blk = _routed_points(p=(1 << 16) + 37, n_bad_anchor=1000,
                                   n_bad_block=1000)
    # runs of one block, as rays give them, with single odd ones between
    blk[1000:30000] = np.repeat(np.arange(29000 // 97 + 1) % N_BLOCKS,
                                97)[:29000]
    args = _t(*_stacked(c, rows_log2), pts, anc, blk, device="cuda")
    pack = pack_for_channels(c)
    before = packed_hash_encode_routed.launches
    got = packed_hash_encode_routed(*args, c, pack, dense)
    torch.cuda.synchronize()
    assert packed_hash_encode_routed.launches == before + 1
    want = packed_hash_encode_routed_raw(*args, c, pack, dense)
    assert torch.equal(got, want)
    masked = (args[4] < 0) | (args[5] < 0)
    assert bool((got[masked] == 0).all())
    bf16 = [args[0].to(torch.bfloat16), *args[1:]]
    assert torch.equal(packed_hash_encode_routed(*bf16, c, pack, dense),
                       want)


# ---- the field at the block stage ----

FOCAL = {
    "residual": dict(focal_mode="residual", packed_rows_log2=13,
                     block_rows_log2=12, block_dense_levels=2),
    "finetune": dict(focal_mode="finetune"),
}


def _field_inputs(n_volumes, r=32, s=24, seed=0):
    rng = np.random.default_rng(seed)
    warp = rng.uniform(-1.0, 1.0, (r, s, 3)).astype(np.float32)
    anc = rng.integers(0, n_volumes, (r, s)).astype(np.int32)
    anc[rng.random((r, s)) < 0.2] = -1
    return warp, anc


def _assert_mlp_close(got, want, names):
    for name, g, w in zip(names, got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        scale = max(1.0, float(np.abs(w).max()))
        np.testing.assert_allclose(to_np(g), w, rtol=1e-5, atol=1e-5 * scale,
                                   err_msg=name)


@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
@pytest.mark.parametrize("with_shared", [False, True])
def test_field_density_block_stage_matches_jax(focal_mode, with_shared):
    """``field_density`` at ``STAGE_BLOCK`` with block 1 active, read from
    the stack and given as ``active_table``, with and without the shared
    branch's density; the block's table takes a gradient and the global
    table none."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import field as J
    from gfnerf_tpu_torch.fields import field as T

    jcfg, params, statics, field = field_pair(seed=2, block_scale=0.3,
                                              **FOCAL[focal_mode])
    if focal_mode == "residual":   # the first level is addressed densely
        from gfnerf_tpu_torch.fields.packed_hash import dense_level_extents
        assert dense_level_extents(4, 2, jcfg.n_volumes, 1 << 12, 2)[1][0]
        assert field.block_feats.shape[2] == 1 << 12
    warp, anc = _field_inputs(jcfg.n_volumes)
    want = jax.jit(lambda p, s, w, a: J.field_density(
        p, s, jcfg, w, a, J.STAGE_BLOCK, 1, with_shared=with_shared))(
            params, statics, jnp.asarray(warp), jnp.asarray(anc))
    names = ("density", "geo", "shared")[:len(want)]
    tw, ta = torch.as_tensor(warp), torch.as_tensor(anc)
    with torch.no_grad():
        got = T.field_density(field, tw, ta, T.STAGE_BLOCK, 1,
                              with_shared=with_shared)
    assert len(got) == len(want)
    _assert_mlp_close(got, want, names)
    assert np.all(to_np(got[0])[anc < 0] == 0)

    table = field.block_feats.detach()[1].clone().requires_grad_(True)
    field.zero_grad()
    again = T.field_density(field, tw, ta, T.STAGE_BLOCK, 1, table,
                            with_shared)
    for g, a in zip(got, again):
        assert torch.equal(g, a.detach())
    if with_shared:
        assert not again[2].requires_grad
    again[0].sum().backward()
    assert float(table.grad.abs().max()) > 0
    assert field.global_feat.grad is None and field.block_feats.grad is None


@pytest.mark.parametrize("layout", ["packed", "anchored"])
@pytest.mark.parametrize("with_shared", [False, True])
def test_residual_sum_is_the_encodes_own(layout, with_shared, monkeypatch):
    """At ``STAGE_BLOCK`` in residual mode, in either hash layout, the
    block's encode is given the frozen global encode as its base (over it
    in place unless the shared branch reads the global features again), so
    the field adds no pass of its own; the densities equal those of the
    separate sum bit for bit."""
    from gfnerf_tpu_torch.fields import field as T

    extra = (dict(hash_layout="anchored", log2_hashmap_size=12,
                  features_per_level=2, block_rows_log2=10)
             if layout == "anchored" else FOCAL["residual"])
    _, _, _, field = field_pair(seed=2, block_scale=0.3,
                                **{**extra, "focal_mode": "residual"})
    warp, anc = _field_inputs(field.cfg.n_volumes)
    tw, ta = torch.as_tensor(warp), torch.as_tensor(anc)
    name = "hash_encode" if layout == "anchored" else "packed_hash_encode"
    encode = getattr(T, name)
    calls = []

    def spy(*args):
        calls.append(args)
        return encode(*args)

    monkeypatch.setattr(T, name, spy)
    with torch.no_grad():
        got = T.field_density(field, tw, ta, T.STAGE_BLOCK, 1,
                              with_shared=with_shared)
        monkeypatch.setattr(T, name, encode)
        pts = T._normalized(tw)
        glob = T._encode(field.cfg, field.global_feat, field.global_prim,
                         field.global_bias, pts, ta.reshape(-1))
        dense = 0 if layout == "anchored" else field.cfg.block_dense_levels
        blk = T._encode(field.cfg, field.block_feats[1], field.block_prims[1],
                        field.block_biases[1], pts, ta.reshape(-1), dense)
        want = T._density_head(field, glob + blk, ta.reshape(-1))[0]
    assert len(calls) == 2
    base, in_place = calls[1][-2:]
    assert torch.equal(base, glob) if with_shared else base is not None
    assert in_place == (not with_shared)
    assert torch.equal(got[0].reshape(-1), want)


def test_field_density_init_stage_ignores_blocks():
    """At the init stage ``with_shared`` adds None and the block arguments
    change nothing."""
    from gfnerf_tpu_torch.fields import field as T

    _, _, _, field = field_pair(seed=2, block_scale=0.3)
    warp, anc = _field_inputs(field.cfg.n_volumes)
    tw, ta = torch.as_tensor(warp), torch.as_tensor(anc)
    with torch.no_grad():
        base = T.field_density(field, tw, ta)
        other = T.field_density(field, tw, ta, T.STAGE_INIT, 1,
                                with_shared=True)
    assert other[2] is None
    assert torch.equal(base[0], other[0]) and torch.equal(base[1], other[1])


@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
def test_field_density_routed_matches_jax(focal_mode):
    """Mixed blocks, some -1, against the JAX package; and row-wise the
    scalar-block densities."""
    import jax
    import jax.numpy as jnp
    from gfnerf_tpu.fields import field as J
    from gfnerf_tpu_torch.fields import field as T

    jcfg, params, statics, field = field_pair(seed=3, block_scale=0.3,
                                              **FOCAL[focal_mode])
    warp, anc = _field_inputs(jcfg.n_volumes, seed=1)
    rng = np.random.default_rng(2)
    blk = np.broadcast_to(rng.integers(0, 2, (anc.shape[0], 1)),
                          anc.shape).astype(np.int32).copy()
    blk[3] = -1
    want = jax.jit(lambda p, s, w, a, b: J.field_density_routed(
        p, s, jcfg, w, a, b))(params, statics, jnp.asarray(warp),
                              jnp.asarray(anc), jnp.asarray(blk))
    tw, ta, tb = (torch.as_tensor(x) for x in (warp, anc, blk))
    got = T.field_density_routed(field, tw, ta, tb)
    _assert_mlp_close(got, want, ("density", "geo"))
    assert not got[0].requires_grad
    with torch.no_grad():
        scalar = [T.field_density(field, tw, ta, T.STAGE_BLOCK, b)
                  for b in range(2)]
    for b in range(2):
        rows = blk[:, 0] == b
        assert rows.any()
        # the same sums in the same order: equal to f32 rounding of the add
        np.testing.assert_allclose(to_np(got[0])[rows],
                                   to_np(scalar[b][0])[rows], rtol=1e-6,
                                   atol=1e-6)
    assert float((scalar[0][0] - scalar[1][0]).abs().max()) > 1e-3


def test_block_tables_bf16_follow_updates():
    """The routed encode's bf16 copy of the stack is made once and again
    after an in-place update through the train step's leaf."""
    from gfnerf_tpu_torch.engine.optimizers import active_block_table

    _, _, _, field = field_pair(block_scale=0.3)
    first = field.block_tables_bf16()
    assert first.dtype == torch.bfloat16
    assert first is field.block_tables_bf16()
    table = active_block_table(field, 1, requires_grad=True)
    assert table.is_leaf and table.shape == field.block_feats.shape[1:]
    with torch.no_grad():
        table.add_(1.0)
    second = field.block_tables_bf16()
    assert second is not first
    assert torch.equal(second, field.block_feats.detach().to(torch.bfloat16))
    assert torch.equal(second[0], first[0])
    assert not torch.equal(second[1], first[1])


# ---- one whole focal train step ----

def _state_np(opt_state, name):
    """(mu, nu) of a group of the JAX optimizer state: FieldParams-shaped
    trees for "fields" and "base_encoding_init", the table for "block"."""
    adam = opt_state.inner_state.inner_states[name].inner_state[0]
    if name == "block":
        return [np.asarray(adam.mu[1])], [np.asarray(adam.nu[1])]
    return ([np.asarray(x) for x in jax_groups(adam.mu[0])[name]],
            [np.asarray(x) for x in jax_groups(adam.nu[0])[name]])


@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
def test_focal_train_step_matches_jax(focal_mode):
    """One init step, then one focal step on block 1, both against the JAX
    package's jitted steps from identical parameters, batches, noise and
    permutations, f32 MLPs.  Residual mode runs with the empty-space
    penalty, two dense residual levels and block tables smaller than the
    global one; finetune mode with the trust region.

    Held: the losses (1e-5); the active table's gradient (2e-2 of its
    largest; the JAX backward's bf16 payload) and its update where the
    gradient's sign is sure (1e-5: Adam moves an entry by about lr *
    sign(g)); the frozen groups and block 0 bit-unchanged in both packages;
    the occupancy statistics untouched; the optimizer's state: two updates
    counted, the frozen groups' moments decayed by b1 and b2 exactly and
    equal to the JAX state's to the init step's gradient tolerance, the
    block's moments those of its first gradient."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK

    jcfg, params, statics, field = field_pair(
        mlp_dtype="float32", block_scale=0.3, **FOCAL[focal_mode])
    joct, toct = octree_pair()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S)
    extra = "empty_space_loss"
    if focal_mode == "residual":
        mkw.update(empty_space_penalty_mult=0.1, empty_space_tau=0.5)
    else:
        mkw.update(finetune_trust_mult=10.0)
        extra = "trust_loss"

    # the init step
    (jstate1, joct1, _, _), noise, perms = jax_train_step(
        jcfg, params, statics, joct, train_batch(0), mkw, key_seed=5)
    state1, toct1, _, _ = port_train_step(field, toct, train_batch(0), mkw,
                                          noise, perms)
    jparams1 = {**{k: [np.array(x) for x in v]
                   for k, v in jax_groups(jstate1.params).items()},
                "block": [np.array(jstate1.params.block_feats)]}
    jmoments1 = {k: _state_np(jstate1.opt_state, k)
                 for k in ("fields", "base_encoding_init")}
    oct_keys = ("weight_stats", "alpha_stats", "visit_cnt", "trans_idx")
    joct1_np = {k: np.array(getattr(joct1, k)) for k in oct_keys}   # donated
    before = {k: [to_np(p).copy() for p in ps]
              for k, ps in field_param_groups(field).items()}
    blocks_before = to_np(field.block_feats).copy()
    moments1 = {k: ([m.clone() for m in state1.opt_state.mu[k]],
                    [n.clone() for n in state1.opt_state.nu[k]])
                for k in ("fields", "base_encoding_init")}
    assert state1.opt_state.mu["block"] == [None]

    # the focal step on block 1
    (jstate2, joct2, jm, jerr), noise, perms = jax_train_step(
        jcfg, jstate1.params, statics, joct1, train_batch(1), mkw,
        key_seed=6, stage=STAGE_BLOCK, active_block=1, state=jstate1)
    state2, toct2, tm, terr = port_train_step(
        field, toct1, train_batch(1), mkw, noise, perms, stage=STAGE_BLOCK,
        active_block=1, state=state1)

    assert set(tm) == set(jm)
    assert float(jm[extra]) > 1e-4
    for k in ("loss", "rgb_loss", "s3im_loss", extra, "psnr",
              "num_samples_per_ray"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    np.testing.assert_allclose(terr.numpy(), np.asarray(jerr), rtol=1e-5,
                               atol=1e-5)

    # the active table's gradient, moments and update
    (jmu,), (jnu,) = _state_np(jstate2.opt_state, "block")
    jg = jmu / 0.1   # mu was zero: mu = (1 - b1) g
    scale = float(np.abs(jg).max())
    assert scale > 0
    (mu,), (nu,) = state2.opt_state.mu["block"], state2.opt_state.nu["block"]
    assert mu.shape == field.block_feats.shape[1:]
    np.testing.assert_allclose(to_np(mu) / 0.1, jg, rtol=2e-2,
                               atol=2e-2 * scale)
    torch.testing.assert_close(nu, 0.001 * (mu / 0.1) ** 2, rtol=1e-5,
                               atol=0)
    sure = np.abs(jg) > 4e-2 * scale
    assert sure.sum() > 100
    got_blocks = to_np(field.block_feats)
    jblocks = np.asarray(jstate2.params.block_feats)
    np.testing.assert_allclose(got_blocks[1][sure], jblocks[1][sure], rtol=0,
                               atol=1e-5)
    assert not np.array_equal(got_blocks[1], blocks_before[1])
    assert field.block_feats.grad is None and field.global_feat.grad is None

    # what the stage freezes did not move, in either package
    np.testing.assert_array_equal(got_blocks[0], blocks_before[0])
    np.testing.assert_array_equal(jblocks[0], jparams1["block"][0][0])
    after = field_param_groups(field)
    jafter = jax_groups(jstate2.params)
    for name in ("fields", "base_encoding_init"):
        for i, p in enumerate(after[name]):
            np.testing.assert_array_equal(to_np(p), before[name][i],
                                          err_msg=f"{name}[{i}]")
            np.testing.assert_array_equal(np.asarray(jafter[name][i]),
                                          jparams1[name][i])
    for k in oct_keys:
        assert torch.equal(getattr(toct2, k), getattr(toct1, k)), k
        np.testing.assert_array_equal(np.asarray(getattr(joct2, k)),
                                      joct1_np[k])

    # the optimizer's state
    assert state2.opt_state.count == 2 and state2.step == 2
    for name, tol in (("fields", 3e-3), ("base_encoding_init", 2e-2)):
        jmu2, jnu2 = _state_np(jstate2.opt_state, name)
        # of the group's largest, as the init step's gradients are held
        mscale = max(float(np.abs(x).max()) for x in jmu2)
        nscale = max(float(np.abs(x).max()) for x in jnu2)
        for i, (m, n) in enumerate(zip(state2.opt_state.mu[name],
                                       state2.opt_state.nu[name])):
            assert torch.equal(m, 0.9 * moments1[name][0][i]), (name, i)
            assert torch.equal(n, 0.999 * moments1[name][1][i]), (name, i)
            np.testing.assert_allclose(jmu2[i], 0.9 * jmoments1[name][0][i],
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(to_np(m), jmu2[i], rtol=tol,
                                       atol=tol * mscale,
                                       err_msg=f"{name}[{i}] mu")
            np.testing.assert_allclose(
                to_np(n), jnu2[i], rtol=2 * tol, atol=2 * tol * nscale,
                err_msg=f"{name}[{i}] nu")


def test_focal_steps_switch_blocks():
    """Focal steps on block 0, then, with a fresh optimizer state, on block
    1: each changes its own block only, and the frozen parameters never."""
    from gfnerf_tpu_torch.engine.optimizers import (OptimizersConfig,
                                                    build_optimizer,
                                                    field_param_groups)
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK
    from gfnerf_tpu_torch.models.gfnerf import init_train_state

    _, _, _, field = field_pair(mlp_dtype="bfloat16")
    _, toct = octree_pair()
    mkw = dict(scale_factor=1.0, samples_budget_per_ray=TRAIN_S)
    rng = np.random.default_rng(0)
    frozen = [p.detach().clone() for name, ps in
              field_param_groups(field).items() if name != "block"
              for p in ps]
    assert not field.block_feats.any()
    state = None
    for block in (0, 1):
        state = init_train_state(field, build_optimizer(OptimizersConfig()))
        stack = field.block_feats.detach().clone()
        losses = []
        for i in range(3):
            noise = rng.uniform(0.5, 1.5, (128, TRAIN_S)).astype(np.float32)
            perms = np.stack([rng.permutation(128) for _ in range(9)])
            state, _, metrics, err = port_train_step(
                field, toct, train_batch(7), mkw, noise, perms,
                stage=STAGE_BLOCK, active_block=block, state=state)
            losses.append(float(metrics["loss"]))
        assert np.all(np.isfinite(losses)) and err.shape == (128,)
        assert not torch.equal(field.block_feats[block], stack[block])
        assert torch.equal(field.block_feats[1 - block], stack[1 - block])
        assert state.opt_state.count == 3
    now = [p for name, ps in field_param_groups(field).items()
           if name != "block" for p in ps]
    assert all(torch.equal(a, b) for a, b in zip(now, frozen))


# ---- block-routed rendering ----

@pytest.mark.parametrize("focal_mode", ["residual", "finetune"])
def test_render_chunk_with_blocks_matches_jax(focal_mode):
    """``render_chunk(..., stage_is_block=True)`` with one block, and with a
    block per ray, against the JAX render (f32 MLPs, 1e-5); the per-ray
    render equals the two one-block renders row by row."""
    import jax.numpy as jnp
    from gfnerf_tpu.models.gfnerf import GFNeRFModelConfig as JModel
    from gfnerf_tpu.models.gfnerf import make_render_fn as jax_render_fn
    from gfnerf_tpu.sampler.perssampler import SamplerConfig as JSampler
    from gfnerf_tpu_torch.models.gfnerf import (GFNeRFModelConfig,
                                                make_render_fn)
    from gfnerf_tpu_torch.sampler.perssampler import SamplerConfig

    joct, toct = octree_pair()
    jcfg, params, statics, field = field_pair(
        mlp_dtype="float32", block_scale=0.3, **FOCAL[focal_mode])
    s, r = 64, 64
    mkw = dict(scale_factor=2.0, samples_budget_per_ray=s)
    skw = dict(max_samples=s, sample_l=1.0 / 64)
    o, d = tiny_rays(n_rays=r)
    blocks = (np.arange(r) % 2).astype(np.int32)
    jrender = jax_render_fn(jcfg, JModel(n_blocks=2, **mkw), JSampler(**skw))
    render = make_render_fn(GFNeRFModelConfig(**mkw), SamplerConfig(**skw))
    to, td = torch.as_tensor(o), torch.as_tensor(d)
    outs = {}
    for name, jb, tb in (("block 0", jnp.asarray(0, jnp.int32), 0),
                         ("block 1", jnp.asarray(1, jnp.int32), 1),
                         ("per ray", jnp.asarray(blocks),
                          torch.as_tensor(blocks))):
        want = jrender(params, statics, joct, jnp.asarray(o), jnp.asarray(d),
                       jnp.asarray(2, jnp.int32), jb, True)
        got = render(field, toct, to, td, 2, tb, stage_is_block=True)
        assert float(np.asarray(want["accumulation"]).max()) > 0.3
        for k in ("rgb", "accumulation", "depth", "oct_depth"):
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name} {k}")
        outs[name] = got
    assert float((outs["block 0"]["rgb"] - outs["block 1"]["rgb"]
                  ).abs().max()) > 1e-3
    even = torch.as_tensor(blocks == 0)[:, None]
    for k in ("rgb", "accumulation", "depth"):
        want = torch.where(even, outs["block 0"][k], outs["block 1"][k])
        torch.testing.assert_close(outs["per ray"][k], want, rtol=1e-5,
                                   atol=1e-6)
    # without block tables the stage flag changes nothing
    init = render(field, toct, to, td, 2)
    assert float((init["rgb"] - outs["block 0"]["rgb"]).abs().max()) > 1e-3
