"""Per-group Adam over the field's parameters.

Port of ``gfnerf_tpu/engine/optimizers.py`` (nerfstudio's per-group
optimizers with GF-NeRF's optimizer swapping, nerfacto.py:448-489).  The
parameters fall into four groups: "fields" (the MLPs, the semantics heads,
the appearance embedding and the proposal probe's table and MLP),
"base_encoding_init" (the global hash table), "block" (the active focal
residual table) and "camera_opt" (the cameras' pose tangents, at
``camera_opt_lr``).  Each group runs the chain
the JAX package builds with optax, in its order:

    [clip by the group's global norm] -> Adam scaling (b1, b2, eps 1e-15)
    -> + weight_decay * param -> * schedule(count) -> * -1

with its own Adam moments.  The clip (``max_norm``; None, the default of
every registered method, leaves it out) is optax's
``clip_by_global_norm`` inside each group's chain: the norm is the
group's, sqrt of the sum over its gradients of sum(g^2), and where it is
not below ``max_norm`` every gradient of the group becomes (g / norm) *
max_norm.  Adam's bias correction and the schedule read
the count of applied updates, not the train step; the groups share it,
since an update is applied to all groups or to none: it is skipped,
moments and count left where they were, when any gradient is not finite
(``optax.apply_if_finite``, which reads the gradients before the clip).
The update waits for nothing on the host: the finite check is a
select on the device (parameters, moments and count kept where any
gradient is not finite), the count and the skip counters are device
tensors, and each group's learning rate and Adam's bias corrections are
read from device tables indexed by the count, so that a step can be
replayed as a CUDA graph (``models/gfnerf.make_multi_train_step``).  In a
data-parallel step the
gradients are summed over the ranks first (``all_reduce_grads``).  A
gradient of None is a
structural zero (a group that is not in the step's graph: the block
table at the init stage, the frozen groups at the block stage): its moments
stay unallocated while they are zero and decay once they are not, as
optax's do on a zero gradient, and its update is then Adam's on those
moments plus the weight decay.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, List, Optional, Union

import numpy as np
import torch

from gfnerf_tpu_torch.engine.schedulers import (
    GFNerfExponentialDecaySchedulerConfig, gfnerf_exponential_decay_schedule)
from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, GFNeRFField

GROUPS = ("fields", "base_encoding_init", "block", "camera_opt")


@dataclasses.dataclass
class OptimizersConfig:
    fields_lr_init: float = 1e-2
    fields_lr_final: float = 1e-4
    block_lr_init: float = 5e-3          # nerfacto.py:481
    block_weight_decay: float = 0.0
    adam_eps: float = 1e-15
    adam_b1: float = 0.9
    adam_b2: float = 0.999
    camera_opt_lr: float = 6e-4          # config.py:84
    max_norm: Optional[float] = None
    steps_perssampler_init: int = 30000
    steps_per_split_dataset: int = 10000
    n_split_dataset: int = 10
    n_dataset_circles: int = 1


def active_block_table(field: GFNeRFField, active_block: int = 0,
                       requires_grad: bool = False) -> torch.Tensor:
    """Block ``active_block``'s table (L, rows, W) as a tensor of its own
    that shares the storage of ``field.block_feats``: a leaf for autograd
    (``field.block_feats[b]`` is a view of a parameter, whose ``.grad``
    would be the whole stack's), so that the focal step's gradient and
    Adam's moments exist for one table, and an in-place update of it is the
    write-back into the stack (gfnerf.py:632-637 of the JAX package)."""
    return field.block_feats.detach()[active_block].requires_grad_(
        requires_grad)


def field_param_groups(field: GFNeRFField,
                       active_table: Optional[torch.Tensor] = None
                       ) -> Dict[str, List[torch.Tensor]]:
    """The optimizer's parameters by group.  The "block" group holds the
    active block's table, ``active_table`` (:func:`active_block_table`);
    without one, block 0's, the placeholder the JAX package's
    ``optimizer_arg`` passes to build the state.  "fields" holds the
    semantics heads and the proposal probe, if the field has them, and
    "camera_opt" the camera tangents (optimizers.py:74-84)."""
    if field.block_feats is None:
        block = []
    elif active_table is not None:
        block = [active_table]
    else:
        block = [active_block_table(field)]
    semantics = [] if field.mlp_semantics is None else [
        *field.mlp_semantics.w, *field.mlp_semantics.b,
        *field.semantics_head.w, *field.semantics_head.b]
    probe = [] if field.prop_feat is None else [
        field.prop_feat, *field.prop_net.w, *field.prop_net.b]
    return {
        "fields": [*field.base_net.w, *field.base_net.b, *field.mlp_head.w,
                   *field.mlp_head.b, field.appearance_embedding,
                   *semantics, *probe],
        "base_encoding_init": [field.global_feat],
        "block": block,
        "camera_opt": ([] if field.camera_adjustment is None
                       else [field.camera_adjustment]),
    }


def field_param_grads(field: GFNeRFField,
                      active_table: Optional[torch.Tensor] = None
                      ) -> Dict[str, list]:
    """The gradients of :func:`field_param_groups`' parameters (None where
    the backward reached none)."""
    return {name: [p.grad for p in ps]
            for name, ps in field_param_groups(field, active_table).items()}


def all_reduce_grads(grads: Dict[str, list], comm) -> Dict[str, list]:
    """The gradients summed over the ranks of ``comm`` (a
    :class:`~gfnerf_tpu_torch.parallel.comm.Comm`), written back in place,
    in one all-reduce per group of its gradients flattened into one
    bucket.  A None (a group out of the step's graph: the block table at
    the init stage, the frozen groups at the block stage) stays None: the
    graph's structure is the stage's, the same on every rank.  Every rank
    gets the same sums, so the clip and Adam that follow apply the same
    update everywhere."""
    for gs in grads.values():
        given = [g for g in gs if g is not None]
        if not given:
            continue
        bucket = comm.all_reduce(torch.cat([g.reshape(-1) for g in given]))
        at = 0
        for g in given:
            g.copy_(bucket[at:at + g.numel()].view_as(g))
            at += g.numel()
    return grads


@dataclasses.dataclass
class OptState:
    """Adam's moments by group (None: all zero), the count of applied
    updates, the count of skipped ones and whether the last update was
    applied: 0-d device tensors (int64, int64, bool) after an update; a
    checkpoint written with host numbers loads as it is (the first update
    moves them to the device)."""

    count: Union[int, torch.Tensor]
    mu: Dict[str, List[Optional[torch.Tensor]]]
    nu: Dict[str, List[Optional[torch.Tensor]]]
    total_notfinite: Union[int, torch.Tensor] = 0
    last_finite: Union[bool, torch.Tensor] = True


def frozen_groups(stage: int) -> tuple:
    """The groups a stage freezes: none at the init stage; all but "block"
    at the block stage (nerfacto_field.py:459-461, 527-529, 548-551)."""
    return (tuple(g for g in GROUPS if g != "block")
            if stage == STAGE_BLOCK else ())


def mask_frozen_grads(grads: Dict[str, list], stage: int) -> Dict[str, list]:
    """Zero the gradients (or updates) of the groups the stage freezes."""
    frozen = frozen_groups(stage)
    if not frozen:
        return grads
    return {name: ([None if g is None else torch.zeros_like(g) for g in gs]
                   if name in frozen else gs)
            for name, gs in grads.items()}


def clip_by_global_norm(grads: List[Optional[torch.Tensor]],
                        max_norm: float) -> tuple:
    """(clipped gradients, norm) of one group, as optax's
    ``clip_by_global_norm``: norm = sqrt(sum of sum(g^2)) over the given
    gradients (a None is a structural zero: it adds nothing and stays
    None), then each g kept where norm < max_norm, else (g / norm) *
    max_norm.  A NaN gradient gives a NaN norm and NaN gradients.  The
    norm is a 0-d tensor on the gradients' device (None without any)."""
    given = [g for g in grads if g is not None]
    if not given:
        return grads, None
    norm = torch.sqrt(sum(torch.sum(g * g) for g in given))
    keep = norm < max_norm
    return [None if g is None else torch.where(keep, g, (g / norm) * max_norm)
            for g in grads], norm


def _bias_corrections(decay: float, n: int) -> torch.Tensor:
    """(n,) float32: 1 - b ** (c + 1) for c = 0 .. n - 1, b = f32(decay),
    as ``1.0 - torch.tensor(decay, dtype=torch.float32) ** (c + 1)``
    rounds it on the CPU (a Python int exponent: b * b and b * b * b for
    2 and 3, else the double ``pow`` rounded to f32), which optax's f32
    ``1 - decay ** count`` is held to."""
    b = np.float32(decay)
    powers = np.array([np.float32(math.pow(float(b), k))
                       for k in range(1, n + 1)], np.float32)
    powers[1:3] = [b * b, b * b * b][:max(n - 1, 0)]
    return torch.from_numpy(np.float32(1.0) - powers)


def _on(x, dtype, device) -> torch.Tensor:
    """``x`` (a host number or a 0-d tensor) as a 0-d tensor of ``dtype``
    on ``device``."""
    if isinstance(x, torch.Tensor) and x.dtype == dtype \
            and x.device == device:
        return x
    return torch.as_tensor(x, dtype=dtype).to(device)


class PerGroupAdam:
    """``build_optimizer``'s transformation: ``init`` the state for a dict
    of parameter groups, ``update`` it with a dict of gradients.

    ``schedules`` (group -> count -> lr) replaces the GF-NeRF groups and
    their schedules (the vanilla pipeline's one group, on optax's
    ``exponential_decay``); ``skip_nonfinite=False`` applies every update,
    as optax's plain ``adam`` does.  With ``cfg.max_norm`` each group's
    gradients are clipped by their norm first, and ``grad_norms`` holds
    each group's norm before the clip (0-d tensors, for the groups that had
    a gradient) after every update.

    The learning rates ``schedules[name](c)`` and the bias corrections
    ``1 - b ** (c + 1)`` are tables on the device over the counts c = 0 ..
    ``max_count`` (the whole GF-NeRF schedule by default; ``reserve``
    raises it, as the Trainer does to its iteration count), built once in
    float32 as the host numbers were (so the update is the one a host
    float gave, bit for bit, on the CPU); a count past the last entry reads
    the last entry."""

    def __init__(self, cfg: OptimizersConfig,
                 schedules: Optional[Dict[str, Callable]] = None,
                 skip_nonfinite: bool = True):
        self.cfg = cfg
        self.skip_nonfinite = skip_nonfinite
        self.grad_norms: Dict[str, torch.Tensor] = {}
        self.max_count = (cfg.steps_perssampler_init + cfg.n_dataset_circles
                          * cfg.n_split_dataset * cfg.steps_per_split_dataset)
        self._tables: Dict[tuple, torch.Tensor] = {}
        if schedules is not None:
            self.schedules = schedules
            self.weight_decay = {name: 0.0 for name in schedules}
            return
        sched_cfg = GFNerfExponentialDecaySchedulerConfig(
            lr_final=cfg.fields_lr_final,
            max_steps=cfg.steps_perssampler_init,
            n_split_dataset=cfg.n_split_dataset,
            n_dataset_circles=cfg.n_dataset_circles,
            steps_per_split_dataset=cfg.steps_per_split_dataset,
            steps_perssampler_init=cfg.steps_perssampler_init)
        lr = {"fields": cfg.fields_lr_init,
              "base_encoding_init": cfg.fields_lr_init,
              "block": cfg.block_lr_init, "camera_opt": cfg.camera_opt_lr}
        self.schedules = {name: gfnerf_exponential_decay_schedule(
            sched_cfg, lr[name]) for name in GROUPS}
        self.weight_decay = {name: 0.0 for name in GROUPS}
        self.weight_decay["block"] = cfg.block_weight_decay

    def reserve(self, n: int) -> None:
        """Make the tables cover the counts up to ``n``."""
        if n > self.max_count:
            self.max_count = n
            self._tables.clear()

    def table(self, what: str, device) -> torch.Tensor:
        """The (max_count + 1,) float32 table ``what`` on ``device``: a
        group's name (its learning rate at each count), or "bc1" / "bc2"
        (Adam's bias corrections 1 - b1 ** (c + 1), 1 - b2 ** (c + 1),
        the f32 powers optax takes).  Built on the host once per length
        and device."""
        key = (what, self.max_count, torch.device(device))
        got = self._tables.get(key)
        if got is None:
            if what in ("bc1", "bc2"):
                host = _bias_corrections(
                    self.cfg.adam_b1 if what == "bc1" else self.cfg.adam_b2,
                    self.max_count + 1)
            else:
                n = self.max_count + 1
                host = torch.broadcast_to(torch.as_tensor(
                    self.schedules[what](torch.arange(n)),
                    dtype=torch.float32), (n,)).contiguous()
            got = self._tables[key] = host.to(device)
        return got

    def init(self, params: Dict[str, list]) -> OptState:
        return OptState(count=0,
                        mu={name: [None] * len(ps)
                            for name, ps in params.items()},
                        nu={name: [None] * len(ps)
                            for name, ps in params.items()})

    def update(self, grads: Dict[str, list], state: OptState,
               params: Dict[str, list]):
        """(updates, new state): one update per parameter (None where it is
        exactly zero).  With ``skip_nonfinite`` the new state's
        ``last_finite`` says whether every gradient was finite; where it
        is False the updates are zeros (so :func:`apply_updates` leaves the
        parameters where they were, as optax's ``apply_if_finite`` does)
        and the moments and count stay as they were (selects on the
        device: nothing here waits for it)."""
        given = [g for gs in grads.values() for g in gs if g is not None]
        dev = next(p.device for ps in params.values() for p in ps)
        count = _on(state.count, torch.int64, dev)
        if self.skip_nonfinite and given:
            finite = torch.stack([torch.isfinite(g).all()
                                  for g in given]).all()
        else:
            finite = None
        self.grad_norms = {}
        idx = count.clamp(max=self.max_count).reshape(1)
        bc = [torch.index_select(self.table(t, dev), 0, idx).reshape(())
              for t in ("bc1", "bc2")]
        new = OptState(count=None, mu={}, nu={})
        updates = {}
        for name, gs in grads.items():
            updates[name], new.mu[name], new.nu[name] = self._update_group(
                name, gs, state.mu[name], state.nu[name], params[name],
                idx, bc, finite)
        skipped = _on(state.total_notfinite, torch.int64, dev)
        if finite is None:
            new.count = count + 1
            new.total_notfinite = skipped
            new.last_finite = torch.ones((), dtype=torch.bool, device=dev)
        else:
            new.count = count + finite.to(torch.int64)
            new.total_notfinite = skipped + (~finite).to(torch.int64)
            new.last_finite = finite
        return updates, new

    def _update_group(self, name, grads, mus, nus, params, idx, bc, finite):
        """(updates, mu, nu) of one group; ``idx`` (1,) is the count of the
        updates that came before, ``bc`` its bias corrections; where
        ``finite`` (a 0-d device bool, or None) is False the old moments
        are kept and the updates are zeros: the gradients read as zeros,
        the moments' decays as 1 and the step size as 0 (0-d selects, one
        select over each gradient)."""
        cfg = self.cfg
        b1, b2, eps = cfg.adam_b1, cfg.adam_b2, cfg.adam_eps
        wd = self.weight_decay[name]
        if cfg.max_norm is not None:
            grads, norm = clip_by_global_norm(
                [None if g is None else g.to(torch.float32) for g in grads],
                cfg.max_norm)
            if norm is not None:
                self.grad_norms[name] = norm
        d1, c1, d2, c2 = b1, 1 - b1, b2, 1 - b2
        if finite is not None:
            zero = torch.zeros((), dtype=torch.float32, device=finite.device)
            d1, c1, d2, c2 = (torch.where(finite, zero + a, zero + b)
                              for a, b in ((b1, 1.0), (1 - b1, 0.0),
                                           (b2, 1.0), (1 - b2, 0.0)))
        step_size = None
        updates, new_mu, new_nu = [], [], []
        for g, mu, nu, p in zip(grads, mus, nus, params):
            if g is None and mu is None:
                # Adam of a zero gradient with zero moments is exactly 0
                u = None
            else:
                if g is None:   # a zero gradient: the moments decay
                    mu, nu = d1 * mu, d2 * nu
                else:
                    g = g.to(torch.float32)
                    if finite is not None:
                        g = torch.where(finite, g, 0.0)
                    mu = c1 * g + (d1 * mu if mu is not None else 0.0)
                    nu = c2 * (g * g) + (d2 * nu if nu is not None else 0.0)
                u = (mu / bc[0]) / (torch.sqrt(nu / bc[1]) + eps)
            if wd:
                u = (wd * p.detach()) if u is None else u + wd * p.detach()
            if u is not None:
                if step_size is None:
                    step_size = torch.index_select(
                        self.table(name, u.device), 0, idx).reshape(())
                    if finite is not None:   # optax's skipped update: 0
                        step_size = torch.where(finite, step_size, 0.0)
                u = -(u * step_size)
            updates.append(u)
            new_mu.append(mu)
            new_nu.append(nu)
        return updates, new_mu, new_nu


def build_optimizer(cfg: OptimizersConfig) -> PerGroupAdam:
    """The per-group Adam of ``gfnerf_tpu``'s ``build_optimizer``."""
    return PerGroupAdam(cfg)


@torch.no_grad()
def apply_updates(params: Dict[str, list], updates: Dict[str, list]) -> None:
    """Add each update to its parameter in place."""
    for name, ps in params.items():
        for p, u in zip(ps, updates[name]):
            if u is not None:
                p.add_(u)
