"""GF-NeRF field: anchored hash encoding + density/colour MLPs.

Port of ``gfnerf_tpu/fields/field.py`` for both hash layouts ("packed"
supercell rows and the reference's "anchored" per-corner tables) and both
stages.  At the init stage the global hash table feeds the shared
``base_network`` (``density = trunc_exp(x + density_bias)`` masked by anchor
validity); at the focal (block) stage the active block's table is added to
the frozen global encode (``focal_mode="residual"``) or replaces it
(``"finetune"``), and :func:`field_density_routed` picks the block per
point for mixed eval chunks.  The colour head runs with its first layer
split into a per-ray part (SH(direction) and appearance embedding) and a
per-sample part (geometry features).  With ``use_proposal`` the field also
holds the proposal probe (a small packed table and a 16-wide MLP), whose
:func:`proposal_density` guides the resampling of ``models/gfnerf.py``;
with ``use_semantics`` the semantics heads (two MLPs on the detached
geometry features, logits per sample beside the colour); with a
``camera_opt_mode`` other than "off" the cameras' pose tangents
(``camera_adjustment``, zero at the start), which ``models/gfnerf.py``
applies to the rays.

The JAX package's trainable/fixed pytrees become one ``nn.Module``
(:class:`GFNeRFField`): tables, MLP weights and the appearance embedding are
``nn.Parameter``s; the hash primes (int64 holding uint32 values) and biases
are buffers.  :func:`init_field_params` draws the numpy parameters exactly
as the JAX package does, so both start from the same bits.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
from torch import nn

from gfnerf_tpu_torch.fields.activations import trunc_exp
from gfnerf_tpu_torch.fields.hash_encoding import (
    N_CHANNELS,
    N_LEVELS,
    hash_encode,
    init_hash_params,
)
from gfnerf_tpu_torch.fields.mlp import MLP, apply_mlp, init_mlp
from gfnerf_tpu_torch.fields.packed_hash import (
    init_packed_hash_params,
    pack_for_channels,
    packed_hash_encode,
    packed_hash_encode_routed,
)
from gfnerf_tpu_torch.fields.sh_encoding import sh_encode_deg4
from gfnerf_tpu_torch.utils.profiling import span

STAGE_INIT = 0
STAGE_BLOCK = 1


@dataclasses.dataclass
class FieldConfig:
    """Field hyper-parameters (reference gfnerf/config.py:119-127): the JAX
    package's ``FieldConfig`` fields that the port reads or checks
    (``_check_supported``), with its defaults."""

    num_images: int = 1
    geo_feat_dim: int = 15
    hidden_dim: int = 128
    num_layers: int = 2
    hidden_dim_color: int = 128
    num_layers_color: int = 3
    appearance_embedding_dim: int = 32
    use_appearance_embedding: bool = True
    log2_hashmap_size: int = 21     # anchored layout: table entries (log2)
    num_levels: int = N_LEVELS
    features_per_level: int = N_CHANNELS
    n_blocks: int = 10
    n_volumes: int = 1
    use_semantics: bool = False
    num_semantic_classes: int = 2
    camera_opt_mode: str = "off"    # "off" | "SO3xR3" | "SE3"
    hash_layout: str = "anchored"   # "anchored" | "packed"
    mlp_dtype: str = "float32"      # "float32" | "bfloat16"
    packed_rows_log2: int = 15
    packed_row_width: int = 128
    block_rows_log2: Optional[int] = None
    # first k residual levels addressed linearly where the per-volume grid
    # fits the table (packed layout, residual mode only)
    block_dense_levels: int = 0
    focal_mode: str = "residual"    # "residual" | "finetune"
    # the proposal probe: a packed table of proposal_levels x 4 channels of
    # 2^proposal_rows_log2 rows, and a 16-wide MLP
    use_proposal: bool = False
    proposal_levels: int = 4
    proposal_rows_log2: int = 12
    # "pers": the per-leaf perspective warp; "identity" (ablation): world
    # coordinates / identity_warp_scale, clipped to [-1.5, 1.5]
    warp_mode: str = "pers"
    identity_warp_scale: float = 6.0
    density_bias: float = 1.0


def _mlp_dt(cfg: FieldConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.mlp_dtype == "bfloat16" else torch.float32


@dataclasses.dataclass
class FieldParams:
    """Trainable parameters as numpy arrays (the JAX ``FieldParams``)."""

    global_feat: np.ndarray              # (L, rows, W) | (L, local, C)
    block_feats: Optional[np.ndarray]    # (n_blocks,) + a table's shape
    base_net: dict
    mlp_head: dict
    appearance_embedding: np.ndarray     # (num_images, D)
    mlp_semantics: Optional[dict] = None     # geo -> 64
    semantics_head: Optional[dict] = None    # 64 -> classes
    camera_adjustment: Optional[np.ndarray] = None   # (num_images, 6)
    prop_feat: Optional[np.ndarray] = None   # (L_p, rows, W) probe table
    prop_net: Optional[dict] = None          # probe MLP


@dataclasses.dataclass
class FieldStatics:
    """Fixed hash state as numpy arrays (the JAX ``FieldStatics``)."""

    global_prim: np.ndarray              # (L, V, 3) uint32
    global_bias: np.ndarray              # (L, V, 3) f32
    block_prims: Optional[np.ndarray]    # (n_blocks, L, V, 3) uint32
    block_biases: Optional[np.ndarray]   # (n_blocks, L, V, 3) f32
    prop_prim: Optional[np.ndarray] = None   # (L_p, V, 3) uint32
    prop_bias: Optional[np.ndarray] = None   # (L_p, V, 3) f32


def _check_supported(cfg: FieldConfig) -> None:
    if cfg.hash_layout not in ("packed", "anchored"):
        raise ValueError(f"unknown hash layout {cfg.hash_layout!r}")
    if cfg.focal_mode not in ("residual", "finetune"):
        raise ValueError(f"unknown focal mode {cfg.focal_mode!r}")
    if cfg.warp_mode not in ("pers", "identity"):
        raise ValueError(f"unknown warp mode {cfg.warp_mode!r}")
    if cfg.camera_opt_mode not in ("off", "SO3xR3", "SE3"):
        raise ValueError(f"unknown camera optimizer mode "
                         f"{cfg.camera_opt_mode!r}")


def init_field_params(cfg: FieldConfig, seed: int = 0):
    """(FieldParams, FieldStatics) in numpy, bit-identical to the JAX
    package's ``init_field_params`` (field.py:163-274): the same generator
    draws in the same order.  The block tables, zero at the start, are a
    read-only broadcast of one zero."""
    _check_supported(cfg)
    rng = np.random.default_rng(seed)
    feat_in = cfg.num_levels * cfg.features_per_level

    def make_table(mode, rows_log2=None):
        kw = dict(seed=int(rng.integers(1 << 31)), n_volumes=cfg.n_volumes,
                  n_levels=cfg.num_levels,
                  n_channels=cfg.features_per_level, init_mode=mode)
        if cfg.hash_layout == "packed":
            return init_packed_hash_params(
                n_rows_log2=(rows_log2 if rows_log2 is not None
                             else cfg.packed_rows_log2),
                row_width=cfg.packed_row_width, **kw)
        return init_hash_params(
            log2_table_size=(rows_log2 if rows_log2 is not None
                             else cfg.log2_hashmap_size), **kw)

    def zeros(shape):
        # one zero broadcast: GFNeRFField makes the table on its device
        return np.broadcast_to(np.zeros((), np.float32), shape)

    g_feat, g_prim, g_bias = make_table("reset")
    if cfg.n_blocks > 0 and cfg.focal_mode == "finetune":
        block_feats = zeros((cfg.n_blocks,) + g_feat.shape)
        block_prims = np.broadcast_to(
            g_prim[None], (cfg.n_blocks,) + g_prim.shape).copy()
        block_biases = np.broadcast_to(
            g_bias[None], (cfg.n_blocks,) + g_bias.shape).copy()
    elif cfg.n_blocks > 0:
        bts = [make_table("zero", cfg.block_rows_log2)
               for _ in range(cfg.n_blocks)]
        block_feats = zeros((cfg.n_blocks,) + bts[0][0].shape)
        block_prims = np.stack([b[1] for b in bts], axis=0)
        block_biases = np.stack([b[2] for b in bts], axis=0)
    else:
        block_feats = block_prims = block_biases = None

    base_net = init_mlp(
        rng, feat_in, 1 + cfg.geo_feat_dim, cfg.hidden_dim, cfg.num_layers - 1)
    head_in = 16 + cfg.geo_feat_dim + cfg.appearance_embedding_dim
    mlp_head = init_mlp(
        rng, head_in, 3, cfg.hidden_dim_color, cfg.num_layers_color - 1)
    appearance = rng.standard_normal(
        (cfg.num_images, cfg.appearance_embedding_dim)).astype(np.float32)
    mlp_semantics = semantics_head = None
    if cfg.use_semantics:
        mlp_semantics = init_mlp(rng, cfg.geo_feat_dim, 64, 64, 1)
        semantics_head = init_mlp(rng, 64, cfg.num_semantic_classes, 64, 0)
    prop_feat = prop_net = prop_prim = prop_bias = None
    if cfg.use_proposal:
        # the table's own default row width, whatever packed_row_width says
        # (field.py:236-247 of the JAX package)
        prop_feat, prop_prim, prop_bias = init_packed_hash_params(
            seed=int(rng.integers(1 << 31)),
            n_rows_log2=cfg.proposal_rows_log2, n_volumes=cfg.n_volumes,
            n_levels=cfg.proposal_levels, n_channels=4, init_mode="reset")
        prop_net = init_mlp(rng, cfg.proposal_levels * 4, 1, 16, 1)
    # zero tangents: no draw
    camera_adjustment = (None if cfg.camera_opt_mode == "off" else
                         np.zeros((cfg.num_images, 6), np.float32))
    params = FieldParams(
        global_feat=g_feat, block_feats=block_feats, base_net=base_net,
        mlp_head=mlp_head, appearance_embedding=appearance,
        mlp_semantics=mlp_semantics, semantics_head=semantics_head,
        camera_adjustment=camera_adjustment, prop_feat=prop_feat,
        prop_net=prop_net)
    statics = FieldStatics(
        global_prim=g_prim, global_bias=g_bias, block_prims=block_prims,
        block_biases=block_biases, prop_prim=prop_prim, prop_bias=prop_bias)
    return params, statics


class GFNeRFField(nn.Module):
    """The field's parameters (``nn.Parameter``) and hash state (buffers)."""

    def __init__(self, cfg: FieldConfig, params: FieldParams,
                 statics: FieldStatics, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        self.cfg = cfg

        def param(x):
            x = np.asarray(x, np.float32)
            if x.size and not any(x.strides):   # one value broadcast
                return nn.Parameter(torch.full(x.shape, float(x.flat[0]),
                                               device=device))
            return nn.Parameter(torch.tensor(x, device=device))

        def buf(x, dtype):
            return (None if x is None else torch.tensor(
                np.asarray(x).astype(dtype), device=device))

        self.global_feat = param(params.global_feat)
        self.block_feats = (None if params.block_feats is None
                            else param(params.block_feats))
        self.base_net = MLP(params.base_net, device)
        self.mlp_head = MLP(params.mlp_head, device)
        self.appearance_embedding = param(params.appearance_embedding)
        self.mlp_semantics = (None if params.mlp_semantics is None
                              else MLP(params.mlp_semantics, device))
        self.semantics_head = (None if params.semantics_head is None
                               else MLP(params.semantics_head, device))
        self.camera_adjustment = (None if params.camera_adjustment is None
                                  else param(params.camera_adjustment))
        self.register_buffer("global_prim", buf(statics.global_prim, np.int64))
        self.register_buffer("global_bias",
                             buf(statics.global_bias, np.float32))
        self.register_buffer("block_prims", buf(statics.block_prims, np.int64))
        self.register_buffer("block_biases",
                             buf(statics.block_biases, np.float32))
        self.prop_feat = (None if params.prop_feat is None
                          else param(params.prop_feat))
        self.prop_net = (None if params.prop_net is None
                         else MLP(params.prop_net, device))
        self.register_buffer("prop_prim", buf(statics.prop_prim, np.int64))
        self.register_buffer("prop_bias", buf(statics.prop_bias, np.float32))
        self._block_tables_bf16 = None   # (key, copy), see the method

    def block_tables_bf16(self) -> torch.Tensor:
        """The stacked block tables in bf16, the type the routed encode
        reads, copied anew only after ``block_feats`` has changed (its
        version counter counts every in-place update, the train step's
        included): a render copies them once, not once per chunk.  An
        assignment to ``block_feats.data`` is not counted: update the
        tables in place (``copy_``), as the train step does."""
        t = self.block_feats
        key = (t._version, t.data_ptr(), t.device)
        if self._block_tables_bf16 is None \
                or self._block_tables_bf16[0] != key:
            self._block_tables_bf16 = (key, t.detach().to(torch.bfloat16))
        return self._block_tables_bf16[1]

    def to_numpy(self):
        """(FieldParams, FieldStatics) in numpy, primes back as uint32."""

        def arr(t):
            return None if t is None else t.detach().cpu().numpy()

        def u32(t):
            return None if t is None else arr(t).astype(np.uint32)

        params = FieldParams(
            global_feat=arr(self.global_feat),
            block_feats=arr(self.block_feats),
            base_net=self.base_net.to_numpy(),
            mlp_head=self.mlp_head.to_numpy(),
            appearance_embedding=arr(self.appearance_embedding),
            mlp_semantics=(None if self.mlp_semantics is None
                           else self.mlp_semantics.to_numpy()),
            semantics_head=(None if self.semantics_head is None
                            else self.semantics_head.to_numpy()),
            camera_adjustment=arr(self.camera_adjustment),
            prop_feat=arr(self.prop_feat),
            prop_net=(None if self.prop_net is None
                      else self.prop_net.to_numpy()))
        statics = FieldStatics(
            global_prim=u32(self.global_prim),
            global_bias=arr(self.global_bias),
            block_prims=u32(self.block_prims),
            block_biases=arr(self.block_biases),
            prop_prim=u32(self.prop_prim), prop_bias=arr(self.prop_bias))
        return params, statics


def params_from_jax(params, statics, cfg: FieldConfig,
                    device="cuda") -> GFNeRFField:
    """A :class:`GFNeRFField` holding the JAX package's ``FieldParams`` and
    ``FieldStatics`` (any objects with those attributes whose leaves convert
    with ``np.asarray``)."""

    def arr(x):
        return None if x is None else np.asarray(x)

    def mlp(d):
        if d is None:
            return None
        return {"w": [arr(w) for w in d["w"]], "b": [arr(b) for b in d["b"]]}

    p = FieldParams(
        global_feat=arr(params.global_feat),
        block_feats=arr(params.block_feats),
        base_net=mlp(params.base_net),
        mlp_head=mlp(params.mlp_head),
        appearance_embedding=arr(params.appearance_embedding),
        mlp_semantics=mlp(params.mlp_semantics),
        semantics_head=mlp(params.semantics_head),
        camera_adjustment=arr(params.camera_adjustment),
        prop_feat=arr(params.prop_feat), prop_net=mlp(params.prop_net))
    s = FieldStatics(
        global_prim=arr(statics.global_prim),
        global_bias=arr(statics.global_bias),
        block_prims=arr(statics.block_prims),
        block_biases=arr(statics.block_biases),
        prop_prim=arr(statics.prop_prim), prop_bias=arr(statics.prop_bias))
    return GFNeRFField(cfg, p, s, device)


def _normalized(warp_pts: torch.Tensor) -> torch.Tensor:
    """Normalized points (warp + 1.5) / 3 (nerfacto_field.py:431) as (P, 3),
    with the division rounded as XLA compiles it: a multiply by f32(1/3)."""
    return ((warp_pts + 1.5) * (1.0 / 3.0)).reshape(-1, 3)


def _encode(cfg: FieldConfig, table, prim, bias, pts, anc,
            dense_levels: int = 0, base: Optional[torch.Tensor] = None,
            in_place: bool = False) -> torch.Tensor:
    """One table's encode (P, L * C) in the configured layout;
    ``dense_levels`` applies to the packed layout only.  With ``base``,
    another table's encode without a graph, the sum of the two: either
    layout's kernel adds it as it writes (over the base with
    ``in_place``)."""
    if cfg.hash_layout == "packed":
        pack = pack_for_channels(cfg.features_per_level, cfg.packed_row_width)
        return packed_hash_encode(table, prim, bias, pts, anc,
                                  cfg.features_per_level, pack, dense_levels,
                                  base, in_place)
    return hash_encode(table, prim, bias, pts, anc, base, in_place)


def _density_head(field: GFNeRFField, feats: torch.Tensor,
                  anc: torch.Tensor):
    """(density (P,), base MLP output (P, 1 + G)) of encoded features."""
    cfg = field.cfg
    h = apply_mlp(field.base_net, feats, compute_dtype=_mlp_dt(cfg))
    return trunc_exp(h[:, 0] + cfg.density_bias) * (anc >= 0), h


def field_density(field: GFNeRFField, warp_pts: torch.Tensor,
                  anchors: torch.Tensor, stage: int = STAGE_INIT,
                  active_block: int = 0,
                  active_table: Optional[torch.Tensor] = None,
                  with_shared: bool = False):
    """Density (...,) and geometry features (..., geo_feat_dim) at warped
    points (..., 3) with anchors (...,) (-1 invalid).

    At ``STAGE_BLOCK`` the block ``active_block``'s table joins: added to
    the global encode, which is frozen and computed without a graph
    (``focal_mode="residual"``), or in its place (``"finetune"``).
    ``active_table``: the focal train step passes the active table as a
    leaf of its own, so that the gradient and Adam's moments exist for one
    table; when None the table is block ``active_block`` of
    ``field.block_feats`` (eval).  ``with_shared`` adds a third value: at
    the block stage the density of the frozen shared branch alone (no
    gradient), which the empty-space penalty reads; None at the init stage.
    """
    cfg = field.cfg
    lead_shape = anchors.shape
    pts = _normalized(warp_pts)
    anc = anchors.reshape(-1)
    block_stage = stage != STAGE_INIT
    finetune = cfg.focal_mode == "finetune"
    if block_stage and field.block_feats is None:
        raise ValueError("the block stage needs block tables (n_blocks > 0)")
    with span("encode"):
        gfeats = None
        # in finetune mode the block table replaces the global encode, which
        # then runs only for the shared density
        if not block_stage or not finetune or with_shared:
            # frozen at the block stage: no graph, so no table gradient
            with torch.set_grad_enabled(not block_stage
                                        and torch.is_grad_enabled()):
                gfeats = _encode(cfg, field.global_feat, field.global_prim,
                                 field.global_bias, pts, anc)
        if block_stage:
            table = (active_table if active_table is not None
                     else field.block_feats[active_block])
            # dense levels change the addressing: residual tables only (a
            # fine-tuned copy must hash like the global table).  The
            # residual sum is the encode's own: added to the global
            # features, over them unless the shared branch reads them again
            feats = _encode(cfg, table, field.block_prims[active_block],
                            field.block_biases[active_block], pts, anc,
                            0 if finetune else cfg.block_dense_levels,
                            None if finetune else gfeats,
                            not finetune and not with_shared)
        else:
            feats = gfeats
    with span("base_mlp"):
        shared = None
        if block_stage and with_shared:
            with torch.no_grad():
                shared = _density_head(field, gfeats, anc)[0].reshape(
                    lead_shape)
        density, h = _density_head(field, feats, anc)
    out = (density.reshape(lead_shape),
           h[:, 1:].reshape(*lead_shape, cfg.geo_feat_dim))
    return out + (shared,) if with_shared else out


def proposal_density(field: GFNeRFField, warp_pts: torch.Tensor,
                     anchors: torch.Tensor) -> torch.Tensor:
    """The proposal probe's density (...,) at warped points (..., 3) with
    anchors (...,) (-1 masked), in the caller's span: the probe table's
    packed encode (4
    channels a level, read with the field's ``packed_row_width``, as the
    JAX package reads it), the 16-wide MLP in the field's MLP type, and
    ``trunc_exp(h + 1)`` (a fixed bias, not ``density_bias``).  The same
    warped space and anchors as the main field (field.py:533-556)."""
    cfg = field.cfg
    lead_shape = anchors.shape
    pts = _normalized(warp_pts)
    anc = anchors.reshape(-1)
    feats = packed_hash_encode(field.prop_feat, field.prop_prim,
                               field.prop_bias, pts, anc, 4,
                               pack_for_channels(4, cfg.packed_row_width))
    h = apply_mlp(field.prop_net, feats, compute_dtype=_mlp_dt(cfg))
    density = trunc_exp(h[:, 0] + 1.0) * (anc >= 0)
    return density.reshape(lead_shape)


def field_density_routed(field: GFNeRFField, warp_pts: torch.Tensor,
                         anchors: torch.Tensor, blocks: torch.Tensor):
    """Focal density with a block per point (..., ) (-1 masked), packed
    layout, eval only: the global encode plus each point's own block's
    residual (or, in finetune mode, that block's table alone), so that one
    render chunk can mix rays of every cluster.  No gradient flows."""
    cfg = field.cfg
    if cfg.hash_layout != "packed":
        raise ValueError("routed eval needs the packed layout")
    if field.block_feats is None:
        raise ValueError("routed eval needs block tables (n_blocks > 0)")
    lead_shape = anchors.shape
    pts = _normalized(warp_pts)
    anc = anchors.reshape(-1)
    pack = pack_for_channels(cfg.features_per_level, cfg.packed_row_width)
    finetune = cfg.focal_mode == "finetune"
    with torch.no_grad():
        with span("encode"):
            # the routed residual is added to the global features as it is
            # written, over them
            gfeats = None if finetune else packed_hash_encode(
                field.global_feat, field.global_prim, field.global_bias,
                pts, anc, cfg.features_per_level, pack)
            feats = packed_hash_encode_routed(
                field.block_tables_bf16(), field.block_prims,
                field.block_biases, pts, anc, blocks.reshape(-1),
                cfg.features_per_level, pack,
                0 if finetune else cfg.block_dense_levels, gfeats,
                gfeats is not None)
        with span("base_mlp"):
            density, h = _density_head(field, feats, anc)
    return (density.reshape(lead_shape),
            h[:, 1:].reshape(*lead_shape, cfg.geo_feat_dim))


def _head_ray_pre(field: GFNeRFField, dirs_ray: torch.Tensor,
                  rel_ray: torch.Tensor) -> torch.Tensor:
    """Per-ray part of the colour head's first layer:
    ``sh(dir) @ W0[:16] + emb @ W0[16+G:] + b0`` in the MLP dtype, (R, H)."""
    cfg = field.cfg
    dt = _mlp_dt(cfg)
    g = cfg.geo_feat_dim
    w0 = field.mlp_head.w[0]
    pre = torch.matmul(sh_encode_deg4(dirs_ray).to(dt), w0[:16].to(dt))
    if cfg.use_appearance_embedding:
        emb = field.appearance_embedding[rel_ray]
        pre = pre + torch.matmul(emb.to(dt), w0[16 + g:].to(dt))
    return pre + field.mlp_head.b[0].to(dt)


def _head_from_pre(field: GFNeRFField, geo: torch.Tensor,
                   ray_pre: torch.Tensor) -> torch.Tensor:
    """Finish the colour head from the split first layer: geo (..., G) and
    ray_pre broadcastable to (..., H).  Returns rgb (prod(...), 3)."""
    cfg = field.cfg
    dt = _mlp_dt(cfg)
    g = cfg.geo_feat_dim
    w0 = field.mlp_head.w[0]
    h = w0.shape[1]
    geo_pre = torch.matmul(geo.reshape(-1, g).to(dt),
                           w0[16:16 + g].to(dt)).reshape(geo.shape[:-1] + (h,))
    h1 = geo_pre + ray_pre
    return apply_mlp(field.mlp_head, h1.reshape(-1, h),
                     output_activation="sigmoid", compute_dtype=dt,
                     start_layer=1)


def _semantics_heads(field: GFNeRFField, geo: torch.Tensor) -> torch.Tensor:
    """Semantic logits (P, classes) of geometry features (P, G), detached
    (``pass_semantic_gradients=False``): the semantics loss trains the
    two semantics MLPs alone."""
    dt = _mlp_dt(field.cfg)
    x = apply_mlp(field.mlp_semantics, geo.detach(), compute_dtype=dt)
    return apply_mlp(field.semantics_head, x, compute_dtype=dt)


def _with_semantics(field: GFNeRFField, out: dict, geo: torch.Tensor,
                    lead_shape) -> dict:
    """``out`` with "semantics" (lead_shape + (classes,)) added when the
    field has the semantics heads."""
    if field.cfg.use_semantics:
        logits = _semantics_heads(field,
                                  geo.reshape(-1, field.cfg.geo_feat_dim))
        out["semantics"] = logits.reshape(*lead_shape,
                                          field.cfg.num_semantic_classes)
    return out


def field_rgb(field: GFNeRFField, directions: torch.Tensor,
              geo_feat: torch.Tensor, rel_camera_indices: torch.Tensor,
              stage: int = STAGE_INIT):
    """Colour head per point: unit view directions (..., 3), geometry
    features (..., G) and appearance indices (...,), each point's own.
    Returns {"rgb": (..., 3)} (and with the semantics heads "semantics"
    (..., classes))."""
    lead_shape = directions.shape[:-1]
    geo = geo_feat.reshape(-1, field.cfg.geo_feat_dim)
    ray_pre = _head_ray_pre(field, directions.reshape(-1, 3),
                            rel_camera_indices.reshape(-1))
    rgb = _head_from_pre(field, geo, ray_pre)
    return _with_semantics(field, {"rgb": rgb.reshape(*lead_shape, 3)}, geo,
                           lead_shape)


def field_rgb_compact(field: GFNeRFField, ray_pre: torch.Tensor,
                      geo_k: torch.Tensor, ray_k: torch.Tensor):
    """Colour head for the compacted path: ``ray_pre`` (R, H) from
    :func:`_head_ray_pre`, computed once on the R rays, gathered to the K
    kept samples' rays ``ray_k`` (K,).  Returns {"rgb": (K, 3)} (and
    "semantics" (K, classes))."""
    out = {"rgb": _head_from_pre(field, geo_k, ray_pre[ray_k])}
    return _with_semantics(field, out, geo_k, geo_k.shape[:1])


def field_rgb_per_ray(field: GFNeRFField, dirs_ray: torch.Tensor,
                      geo_feat: torch.Tensor, rel_ray: torch.Tensor,
                      stage: int = STAGE_INIT):
    """Colour head for the dense (R, S) path: the per-ray first-layer part
    is computed once per ray and broadcast over its samples."""
    r, s, _ = geo_feat.shape
    ray_pre = _head_ray_pre(field, dirs_ray, rel_ray)
    rgb = _head_from_pre(field, geo_feat, ray_pre[:, None, :])
    return _with_semantics(field, {"rgb": rgb.reshape(r, s, 3)}, geo_feat,
                           (r, s))
