"""The JAX package's pipeline on a scene, recorded for the port's parity test.

Run as a script in a process of its own, with one JAX CPU device (the test
process forces eight, under which the JAX pipeline shards its batches over a
mesh, compiles more and is slower; the single-device run is the one-card
reference).  Usage:

  python tests/torch_pipeline_ref.py SCENE_DIR OUT_DIR STEPS RAYS PATCH_H \
      LAYOUT [diag] [phototourism] [k=K] [remat=N]

Drives ``GFNerfPipeline`` of ``gf-nerf-tiny`` (with LAYOUT's overrides,
``FIELD_OVERRIDES``, ``PROP_OVERRIDES`` or ``CLIP_OVERRIDES``, and the port
parser's image names) as the
Trainer does (the train step, then the after-iteration callbacks; the eval
batch every ``steps_per_eval_batch`` and after the last step) for STEPS
steps and writes OUT_DIR/ref.npz: each
step's march noise and S3IM permutations (drawn from the pipeline's own key
chain; with the proposal probe also the resampling's draws), its batch
indices, losses, split index and whether its update was applied (finite
gradients); the calibrated
``sample_l`` and ``max_hits``; the host tree after every milestone rebuild;
the camera labels, error maps and block indices at the transition; the eval
PSNR; and the final field parameters.  With ``k=K`` (K > 1) the pipeline
trains K steps a dispatch where its ``_k_window_ok`` allows (as the
Trainer runs it: ``total_train_steps`` = STEPS), and each step's draws
come from the window's key chain (one split of the pipeline's key a
window, one split of the window's key a step: pipeline.py:456 and
gfnerf.py:693-696 of the JAX package); the record adds the counts of
steps in windows and single steps.  With ``remat=N`` the model
recomputes its field in the backward in N chunks (``remat_chunks``).
With ``diag``, also
``scripts/quality_run.py``'s ``diag_eval`` after the last step (as JSON,
``diag``).  With ``phototourism``, SCENE_DIR is a Phototourism capture read
by the JAX package's Phototourism parser (its images through ``imageio``).
"""

from __future__ import annotations

import os
import sys

TREE_KEYS = ("centers", "side_lens", "parents", "childs", "is_leaf",
             "trans_idx", "block_idx", "weight_stats", "alpha_stats")
# the pipeline's field fields per hash layout: gf-nerf-tiny's own, and the
# packed layout of gf-nerf-perf (8 levels x 4 channels) at 2^10 rows; the
# MLPs stay f32 in both
FIELD_OVERRIDES = {
    "anchored": {},
    "packed": {"field_hash_layout": "packed", "field_num_levels": 8,
               "field_features_per_level": 4, "field_packed_rows_log2": 10},
}
# gf-nerf-tiny with the proposal probe (3 levels of 2^9 rows) and 16 fine
# samples a ray resampled from its 64-slot march
PROP_OVERRIDES = {
    "prop": {"field_use_proposal": True, "field_proposal_levels": 3,
             "field_proposal_rows_log2": 9,
             "model.num_proposal_resamples": 16},
}
# gf-nerf-tiny's anchored layout with gradient clipping (a limit between
# the groups' norms, so each is clipped on some steps and not on others)
# and the loss switches: MSE, and S3IM at half weight with kernel 2,
# stride 2 and 4 repeats
CLIP_OVERRIDES = {
    "clip": {"optimizers.max_norm": 0.003, "model.use_ch_loss": False,
             "model.s3im_loss_mult": 0.5, "model.s3im_kernel_size": 2,
             "model.s3im_stride": 2, "model.s3im_repeat_time": 4},
}
LOSS_KEYS = ("loss", "rgb_loss", "s3im_loss")


def main(scene, out_dir, steps, rays, patch_h, layout, diag=False,
         dataparser="minimal", k_steps=1, remat_chunks=0):
    import jax
    import numpy as np

    jax.config.update("jax_platforms", "cpu")
    from gfnerf_tpu.configs.method_configs import gf_nerf_tiny_config
    from torch_parity import jax_minimal_parser

    cfg = gf_nerf_tiny_config()
    cfg.pipeline.datamanager.train_num_rays_per_batch = rays
    cfg.pipeline.model.s3im_patch_height = patch_h
    for key, value in {**FIELD_OVERRIDES, **PROP_OVERRIDES,
                       **CLIP_OVERRIDES}[layout].items():
        *path, leaf = key.split(".")
        obj = cfg.pipeline
        for part in path:
            obj = getattr(obj, part)
        setattr(obj, leaf, value)
    if dataparser == "minimal":
        parser = jax_minimal_parser(scene)
    else:
        from gfnerf_tpu.data.dataparsers import registry

        parser_cls, parser_cfg = registry()[dataparser]
        parser = parser_cls(parser_cfg(data=scene))
    cfg.pipeline.steps_per_dispatch = k_steps
    cfg.pipeline.model.remat_chunks = remat_chunks
    p = cfg.pipeline.build(parser, out_dir)
    p.total_train_steps = steps
    n_prop = cfg.pipeline.model.num_proposal_resamples
    rec = {"sample_l": p.sampler.sampler_config.sample_l,
           "max_hits0": p.sampler.sampler_config.max_hits}
    n_rep = cfg.pipeline.model.s3im_repeat_time
    s = p.sampler.sampler_config.max_samples

    batches = []
    next_train = p.datamanager.next_train

    def recording_next_train(step):
        batch = next_train(step)
        batches.append(np.asarray(batch["indices"]))
        return batch

    p.datamanager.next_train = recording_next_train
    noise, perms, prop_u, losses, splits, rebuilt, applied = (
        [], [], [], [], [], [], [])
    loss_keys = LOSS_KEYS + (("interlevel_loss",) if n_prop else ())
    step_keys = {}
    for step in range(steps):
        # the step's own key: the pipeline's next (pipeline.py:516), or in
        # a window the window key's next (pipeline.py:456, gfnerf.py:693)
        if step not in p._pending_metrics:
            _, key = jax.random.split(p._rng)
            if k_steps > 1 and p._k_window_ok(step, k_steps):
                for i in range(k_steps):
                    key, step_keys[step + i] = jax.random.split(key)
            else:
                step_keys[step] = key
        # its draws (gfnerf.py:512-514, losses.py:70-73,
        # ray_samplers.py:86)
        k_noise, k_s3im, k_prop = jax.random.split(step_keys.pop(step), 3)
        noise.append(np.asarray(
            (jax.random.uniform(k_noise, (rays, s)) - 0.5) + 1.0))
        perms.append(np.stack([np.asarray(jax.random.permutation(q, rays))
                               for q in jax.random.split(k_s3im,
                                                         n_rep - 1)]))
        prop_u.append(np.asarray(jax.random.uniform(k_prop,
                                                    (rays, n_prop + 1))))
        n_nodes = p.sampler.tree.n_nodes
        m = p.get_train_loss_dict(step)
        losses.append([m[k] for k in loss_keys])
        applied.append(bool(p.state.opt_state.last_finite))
        if p.sampler.tree.n_nodes != n_nodes:
            rebuilt.append(step)
            for k in TREE_KEYS:
                rec[f"tree{step}_{k}"] = getattr(p.sampler.tree, k)
        labelled = p.sampler.cameras_labels is not None
        p.after_train_iteration(step)
        if not labelled and p.sampler.cameras_labels is not None:
            rec["transition"] = step
            rec["labels"] = p.sampler.cameras_labels
            rec["block_idx"] = p.sampler.tree.block_idx
            npy = os.path.join(p.sample_tmp_dir, "npy")
            rec["error_map_files"] = np.stack(
                [np.load(os.path.join(npy, f)) for f in sorted(
                    os.listdir(npy))])
        splits.append(p.datamanager.split_idx)
        if (step + 1) % cfg.steps_per_eval_batch == 0 or step == steps - 1:
            rec[f"eval_psnr{step}"] = p.get_eval_loss_dict(step)["eval_psnr"]
    cache = p.datamanager.split_cache
    rec.update(
        k_scanned=p._k_steps_scanned, k_fallback=p._k_steps_fallback,
        pending=len(p._pending_metrics), final_step=int(p.state.step),
        noise=np.stack(noise), perms=np.stack(perms),
        prop_u=np.stack(prop_u), applied=np.asarray(applied),
        indices=np.stack(batches), losses=np.asarray(losses),
        splits=np.asarray(splits), rebuilt=np.asarray(rebuilt),
        max_hits=p.sampler.sampler_config.max_hits,
        split_error_maps=cache.error_maps if cache else np.zeros(0),
        split_cache_indices=cache.indices if cache else np.zeros(0))
    params = p.state.params
    rec["global_feat"] = np.asarray(params.global_feat)
    rec["block_feats"] = np.asarray(params.block_feats)
    for name in ("base_net", "mlp_head"):
        for part in ("w", "b"):
            for i, x in enumerate(getattr(params, name)[part]):
                rec[f"{name}_{part}{i}"] = np.asarray(x)
    rec["appearance_embedding"] = np.asarray(params.appearance_embedding)
    if params.prop_feat is not None:
        rec["prop_feat"] = np.asarray(params.prop_feat)
    if diag:
        import importlib.util
        import json

        script = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "..", "scripts", "quality_run.py")
        spec = importlib.util.spec_from_file_location("jax_quality_run",
                                                      script)
        quality_run = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(quality_run)
        rec["diag"] = np.array(json.dumps(quality_run.diag_eval(
            p, steps, cfg.pipeline.model.n_blocks)))
    np.savez(os.path.join(out_dir, "ref.npz"), **rec)


if __name__ == "__main__":
    # set before JAX starts; the test module imports FIELD_OVERRIDES only
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.abspath(__file__)), ".."))
    extra = sys.argv[7:]
    main(sys.argv[1], sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
         int(sys.argv[5]), sys.argv[6], "diag" in extra,
         "phototourism" if "phototourism" in extra else "minimal",
         next((int(a[2:]) for a in extra if a.startswith("k=")), 1),
         next((int(a[6:]) for a in extra if a.startswith("remat=")), 0))
