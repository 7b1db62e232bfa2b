#!/usr/bin/env python3
"""Smoke run of the PyTorch port's render and train paths on one CUDA card.

Phases (each prints its own lines; any failure raises and exits non-zero):
  1. device   — a CUDA card must be present; prints nvidia-smi's name and
                power limit.
  2. build    — compiles gfnerf_tpu_torch/csrc/*.cu with nvcc for sm_90a,
                one process per source, into gfnerf_tpu_torch/_build/ and
                prints each kernel's registers; then the JPEG codec
                (csrc/jpeg/*.cpp, host code) with g++.
  3. jpeg     — the codec: the fixtures of tests/data/jpeg (Pillow's and
                cv2's files: baseline, optimized, progressive, restarts,
                4:2:2, grey) decoded equal to the imageio decodes stored
                beside them and to the plain numpy decoder; the encoder
                equal to its plain version byte for byte; a 4000x3000
                image at quality 90 decoded on one host thread (under
                JPEG_DECODE_LIMIT_S) and 16 of them on a thread pool
                (Mpixel/s), a 1920x1080 frame encoded at 4:4:4 and 4:2:0.
  4. kernels  — seven of the hand-written kernels against their plain
                PyTorch version on the card, at the main paths' shapes (K2
                also at gf-nerf's 1024 slots) and
                at ragged and edge cases (the composite backward where
                transmittance underflows mid-ray; the hash backward's
                padding columns and masked anchors; dense levels in a small
                table; the routed encode's masked and out-of-range blocks;
                the anchored table gradient on runs of equal cells with
                masked anchors inside and two volumes sharing cells; both
                table gradients H2 and H5 bit for bit, also called again
                and on the points permuted);
                the composites timed against their plain versions with CUDA
                events (median); the composite backward in the train
                step's form at 384 and 192 samples, its register kernel
                and its tiled kernel in turns, 20 calls per event pair, and
                their device time from the profiler; K1 at the render
                chunk timed 20 calls an event pair, by the profiler's
                device time and one call an event pair.
  5. workload — the bench's quality workload: 48 ring cameras and their
                sphere-scene images, depth-8 octree, 8x4-level packed hash
                field with random weights from seed 0, 384 march slots,
                per-group Adam with the default config.
  6. render   — with the launch counters reset: 4 training views and one
                1920x1080 frame in chunks of 32768 rays; outputs checked;
                each forward kernel launched once per chunk; one chunk
                against the plain versions; the hash encode timed against
                its plain version on one chunk's real inputs, and level by
                level.
  7. train    — with the counters reset: 20 init-stage steps of 8192 rays
                through make_train_step (one warm-up, 5 timed: s/step,
                rays/s, peak memory); each kernel called once per step,
                the hash backward's call launching its count, scan,
                scatter and owner passes; loss and gradients
                finite, the loss falling, the
                global table and every MLP changed, the block tables not,
                the occupancy statistics moved; one step from a common
                state with the kernels against the plain autograd pairs
                (no kernel may launch in it); on a train batch's points,
                the hash encode timed against its plain version and level
                by level, and added to a base (bit for bit; timed beside
                the encode and a separate add); the hash backward against
                its plain version (bit for bit, also called again and on
                the points permuted) and index_add_, then level by level
                (its counter and cursor atomics and long rows' reductions
                per level, counted by the kernel and held against the same
                reckoned on the host, and a call per level timed);
                the host syncs of one encode forward and backward.
  8. focal    — with the counters reset per block: 10 block-stage steps
                (residual mode) on block 0, then 10 on block 1 from a new
                optimizer state; launches per step (two encodes, one table
                gradient into the block's table, no routed encode); frozen
                parameters and the other block bit-unchanged, the active
                table changed; a fixed batch's loss lower after each
                block's steps; one step, kernels against the plain pairs
                (loss and the active table's gradient); no addition in
                the encode span (the block's encode adds itself to the
                global one as it writes).
  9. focal    — with the counters reset: the 4 views as one mixed chunk
     render     (view i in block i mod 2) and one 1920x1080 frame with a
                block per ray, through render_chunk(..., stage_is_block=
                True) with the trained tables; the composite, the encode
                and the routed encode once per chunk; the mixed chunk's
                rows against one-block renders; a routed chunk against the
                plain path, and no addition in its encode span; the routed
                encode on a frame chunk against its plain version, alone
                and added to a base (bit for bit, in place and not), timed
                in place on a base beside the encode followed by a
                separate add, the stack's bf16 copy and the add alone.
 9a. window   — K = 8 steps a dispatch (gf-nerf-perf's and gf-nerf-prop's
                steps_per_dispatch): on the quality workload at the init
                and focal stages and on the prop workload, at 8192 rays,
                make_multi_train_step's window (one CUDA graph of the step
                replayed 8 times): one step twice from one state (loss,
                gradients and parameters bit for bit); a replayed window's
                launches 8 times a step's; a replayed window against the
                same window run eagerly from deep copies of the state, and
                two eager windows, from the same injected draws, and a
                replayed window against an eager one from the same
                generator state: every loss and parameter bit for bit
                (gf-nerf-perf's init, focal and remat 8 windows and
                gf-nerf-prop's); the generator at the same Philox offset;
                with --parent, the quality windows in turns with windows
                over the parent's H2; no host sync under
                set_sync_debug_mode("error") around a replayed window;
                single steps and windows timed in turns (s/step,
                peak memory, the capture's peak) and a window profiled
                (the device's busy share).
 10. parity   — the bench's parity workload (anchored layout, 16 levels x
                2 channels of 2^19 entries, 192 slots, fineness 4) built
                anew; with the counters reset, 20 init-stage steps: the
                composites and the anchored encode and table gradient one
                call per step (a launch per group of levels; H5 its maxima
                and per level its sums and conversion), the packed
                kernels never; loss falls; one step against the plain
                pairs; both anchored kernels timed on a train batch against
                their plain versions: the encode from the f32 table against
                the bf16 copy + kernel in turns, at 1, 2, 4, 8 and 16 levels
                per launch, on a base (in place and not) against the encode
                followed by a separate add, with the memory both forms hold,
                and its sector requests per level; the table gradient bit
                for bit (also called again and on the points permuted),
                against index_add_, with its reductions per level (held
                against the host's reckoning).
 11. parity   — with the counters reset: 5 block-stage steps (residual
     focal      mode) on block 0 of the parity workload from a fresh
                optimizer state: the anchored encode twice a step, the
                second on a base (the block's encode adds itself to the
                frozen global one as it writes), the table gradient once,
                into the block's table; no addition in the encode span;
                frozen parameters and block 1 bit-unchanged; one step
                against the plain pairs.
 12. pipeline — with the counters reset: gf-nerf-perf through the Trainer
                (python -m gfnerf_tpu_torch.train's path) on the 48-view
                synthetic scene: 24 init steps with milestone rebuilds at
                8 and 16, the transition (48 error-map renders, 10 camera
                clusters), 2 focal steps on each of the 10 blocks, eval
                batches (the focal one block-routed), an eval image and a
                checkpoint, at K = 8 (8 steps in the window [0, 8), 36
                single: as the JAX package's rule predicts); then a fresh
                Trainer resumed from it for 2 steps (its first equal to
                the continuing run's bit for bit, every tensor; see
                phase_pipeline for the checks); s/step through the
                Trainer against train_bench's loop on the same steps, the
                host work around
                the step, host syncs of a focal step and of a window
                against 8 single steps (one against 8 or more); the
                Trainer on init steps 0-8 again at K = 1 and K = 8 in
                turns (the second K = 8 run captures nothing), and a
                window taken apart on the host and profiled.
 13. gfnerf   — with the counters reset: gf-nerf, the paper's method, at
                its full width through the Trainer (8192 rays, 1024 march
                slots, a budget of 256 field samples a ray: the compacted
                branch; anchored 16 levels x 2 of 2^21; 10 blocks; f32
                MLPs): 10 init steps with a milestone rebuild at 8, the
                transition, 2 focal steps on each of blocks 0 and 1, eval
                batches, an eval image and a checkpoint; per step K1, K2
                and H5 once, H4 once at init and twice at the focal stage;
                a second Trainer's first 8 steps from the same seed equal
                to the run's bit for bit (losses, every field tensor);
                then the compaction of a train batch under
                set_sync_debug_mode("error"), H4 and H5 at the compacted
                points (K = 2,097,152) against their plain versions, one
                step against the plain pairs (with --parent, init steps in
                turns over the parent's H5), one step at remat_chunks 8
                against 0 (loss, gradients, peak memory), init steps at
                fineness 1 and 16 and a focal step profiled (spans, busy
                time, idle share), the
                early-termination renderer against the single pass, and
                python -m gfnerf_tpu_torch.eval and .render on the
                checkpoint (PNG frames).
 14. prop     — with the counters reset: gf-nerf-prop (proposal-guided
                resampling) at its full width through the Trainer (8192
                rays, a dense 256-slot march, the probe's 4 levels x 4
                channels of 2^12 rows on 2,097,152 lattice points, 64 fine
                samples a ray for the packed 8 x 4 of 2^15, bf16 MLPs, 10
                blocks), 24 init steps and 2 on each of blocks 0 and 1:
                per step K1 and K2 once at (8192, 64), H1 twice at init
                (probe, global) and three times at the focal stage (the
                probe without a graph), H2
                in two calls at init and one at the focal stage (the
                block's table), H3-H5 never; the probe changed by the init
                steps and bit-unchanged by the focal ones; the rgb loss
                falling; eval PSNR above the mean image's; one step
                against the plain pairs; K1, K2, H1 and H2 at these shapes
                against their plain versions (H2 also against
                index_add_, and bit for bit at the field's table on a
                quarter of the probe's points); an init and a focal step
                profiled (the gfnerf/proposal span); eval and render on
                the checkpoint, render --early-term refused.
 15. nerfacto — with the counters reset: the stock nerfacto on the vanilla
                pipeline through the Trainer at its full width (4096 rays,
                proposal samples (256, 96) on two fields of 5 x 2 of 2^17,
                48 field samples on 16 x 2 of 2^19, the pipeline phase's
                scene), NERFACTO_STEPS steps: per step H4 and H5 three calls
                each (1,048,576, 393,216 and 196,608 points), no other
                kernel; losses finite, the rgb loss falling, every table
                and MLP changed; the eval image's PSNR above its mean
                image's; the checkpoint; one step against the plain pairs
                (the loss and the three tables' gradients); H4 and H5 at
                the three shapes against their plain versions (H5 also
                against index_add_), H4 at points contracted onto the
                hash's faces (exactly 0.0 and 1.0); s/step, rays/s, peak
                memory, a profiled step's busy time and idle share; eval
                and render on the checkpoint; then SEMANTIC_NERFW_STEPS
                steps of semantic-nerfw on the scene with road masks.
 16. semantics — with the counters reset: gf-nerf-perf with semantics and
                the SO3xR3 camera optimizer through the Trainer, on the
                scene with road masks and on the pipeline phase's
                checkpointed octree (not built again): 10 init steps, the
                transition, 2 focal steps on block 0; launches per step
                (K1, K2, H1, H2 as gf-nerf-perf's); the semantics loss and
                the camera regularizer finite; the camera tangents moved by
                the init steps, bit-unchanged by the focal ones; one step
                against the plain pairs (K2 given the semantics' weights
                cotangent), the tangents' gradient included.
 17. instant- — with the counters reset: instant-ngp at its full width
     ngp        through the Trainer (4096 rays, 192 samples, 16 x 2 of
                2^19, grid 96) on a Blender scene written to disk as RGBA
                PNGs with a transparent sky and read back by the blender
                parser, NGP_STEPS steps: per step H4 once (786,432 samples)
                and H5 once, H4 once more at every 16th (the occupancy
                update, 884,736 points), no other kernel; losses finite,
                the rgb loss falling, every tensor changed, the grid off
                all ones and keeping fewer than all samples; the eval PSNR
                above the mean image's; the checkpoint reloads to the same
                grid and eval image; one step and one occupancy update
                against the plain pairs; H4 at both shapes and H5 against
                their plain versions (H5 also against index_add_); s/step,
                rays/s, peak memory, a profiled step, the occupancy
                update's time; eval and render on the checkpoint; a few
                steps with dynamic_batch and on an instant-ngp-format scene
                with distortion (its rays on the card against the CPU's);
                PNG round trips of every colour type, depth and filter.
 18. scan     — with the counters reset: gf-nerf-perf with the scan march
                (pipeline.sampler.march=scan, kernel M1) through the Trainer
                on the pipeline phase's scene and schedule, 24 init + 2
                focal steps on each of blocks 0 and 1: per step M1, K1 and
                K2 once, H1 once at init and twice at the focal stage, H2
                one call; the routed eval batch (H3) and the eval PSNR above
                the mean image's; an init and a focal step profiled (the
                gfnerf/march span); M1 against the plain scan (rows that
                differ, errors) on the train batch (8192 x 160), gf-nerf's
                march (8192 x 1024) and a render chunk (32768 x 384), the
                plain scan timed on each; the scan against the fast march
                (coverage, held to the JAX package's pair's figures); one
                step against the plain pairs (M1 among them); M1 timed on
                the train batch, gf-nerf's march and a render chunk
                against its bound, and by part (one line: the train
                rays each repeated 32 times in a row, rays that miss the
                root, 8192 to 65536 train rays); M1 bit for bit with the
                plain scan at the edge shapes (R = 1, 3, 8193; S = 1,
                1024, 33; rays that miss the root; an anchor change at
                nearly every emitted slot); three gf-nerf init steps with
                the scan (1024 slots, budget 256: the compacted branch at
                gf-nerf's width); a 1920x1080 frame of the quality
                workload through the scan.
 19. stock    — vanilla-nerf, mipnerf, tensorf and neus, each at its
                registered width through the Trainer on the instant-ngp
                phase's Blender scene (STOCK_STEPS steps): no kernel
                launches; finite losses, the rgb loss falling, every
                parameter changed, the eval PSNR above the mean image's, the
                checkpoint; s/step, rays/s, peak memory, a profiled step;
                one step on the card against the same step on the CPU.
 20. nerfplayer — with the counters reset per method: nerfplayer-nerfacto
                and nerfplayer-ngp at their registered widths through the
                Trainer (NPL_STEPS steps each) on a D-NeRF scene written
                to disk (24 + 4 RGBA PNGs at 200x200, a sphere moving with
                the frame's time) and read back by the dnerf parser: per
                step T1 and T2 three calls each (nerfacto: proposals at
                1,048,576 and 393,216 points on 5 x 2 levels with T = 32,
                the field at 196,608 on 16 x 2 with T = 64) or once each
                and T1 once more at every 16th step (ngp: 786,432 points,
                the occupancy update's 262,144), each call a launch per
                group of levels (ops.temporal_grid's
                FWD_LEVELS_PER_LAUNCH: T1 one per 8 levels; T2 the level
                maxima, a count and a scatter per BWD_LEVELS_PER_LAUNCH
                levels (all), the scan and the owner pass: 4 + 15
                launches a nerfacto step, 2 + 5 an ngp step), no other
                kernel; finite losses, the rgb loss falling, every tensor
                changed, ngp's grid off all ones; every val frame's PSNR
                with its time beside its mean image's (eval rays take
                train camera 0's time: the frame at that time must beat
                its mean image); the checkpoint reloaded to the same eval
                image (and grid); one step against the plain pairs (and
                one occupancy update); one step twice from one state, the
                loss, every gradient and parameter after Adam bit for bit;
                T1 and T2 bit for bit against their plain versions at
                every step shape (T2 also called again and on the points
                permuted, its records per level as reckoned), timed (T2
                also against index_add_ and the deterministic index_put_;
                both at 1, 2, 4, 8 and 16 levels a launch at the field),
                and at the edge inputs (t = 0, 1 and every window-row
                boundary, the faces 0.0 and 1.0, dense and hashed levels);
                s/step, rays/s, peak memory allocated and reserved, a
                profiled step; eval and render on each checkpoint.
 21. captures — the six remaining capture formats (scannet, sdfstudio,
                phototourism, sitcoms3d, arkitscenes, nuscenes) written
                from the ring scene and parsed through build_dataparser
                (split sizes, finite poses, the auto-scaled translations,
                metadata, files: a [captures] line each); then, with the
                counters reset, gf-nerf-perf at its registered width
                through gfnerf_tpu_torch.train's command line on a
                Phototourism capture of 54 JPEGs at 192x144 (the sky
                gradient; the port's encoder at quality 95, 4:2:0, decoded
                by the port's codec on the datamanager's pool) read at half
                size (camera_res_scale_factor 0.5: the cameras scaled with
                the images), clipped at CAPTURE_MAX_NORM, with MSE, the
                march's near plane at 1, on the config's octree,
                CAPTURE_STEPS init steps: per step K1, K2 and H1 once, H2
                one call; the loss
                falling, every val frame above its mean image's PSNR, each
                group's pre-clip norm a step and the steps it was clipped
                on (at least one), one step's profiler records of K1, K2,
                H1 and H2, one step against the plain pairs under the clip
                (the norms and the clipped moments too); s/step through the
                Trainer and the phase's own peak memory.
 22. tools    — the exporter, the viewer and the live viewer on the
                pipeline phase's run (its focal stage), the counters reset
                for each part: gfnerf_tpu_torch.export's point cloud (48
                views at downscale 4), poses (python -m, a process of its
                own), density mesh (64^3, the threshold a quantile of the
                grid's densities), TSDF (8 views, 64^3) and texture;
                per render chunk K1 once and H1 twice, per density chunk H1
                once; every file finite inside the octree's root cube; the
                point cloud and the mesh against the plain versions;
                gfnerf_tpu_torch.render along a spiral of 8 frames as
                render.mp4 (K1 once and H1 twice a chunk): the MP4's
                boxes, 24 fps, each sample decoded by the codec against
                the frame's PNG pixels; a ViewerServer on an ephemeral
                port: the page, /scene,
                /render at 640x480 (rgb, depth, accumulation) and at
                downscale 4, its rgb PNG equal to render_camera's image, a
                camera path read back; a Trainer with vis viewer resumed
                for up to 12 steps: pause, resume, a render while training,
                stop and its checkpoint, /status (see phase_tools).
 23. parallel — gf-nerf-perf over 4 ranks, launched as
                torch.distributed.run launches gfnerf_tpu_torch.train
                (spawned processes, each through train.build_trainer),
                with parallel_blocks on a (data 2, block 2) grid: under
                gloo on one card and, where the machine has 4 cards, under
                NCCL with a card per rank.  At the initial state one
                data-parallel init step against one process on the union
                batch (gradients within 1e-5 of each group's largest, the
                loss to 1e-5 relative); then the Trainer's 8 init steps
                (a milestone rebuild at 4), the transition (the error-map
                renders split over the ranks), 5 phases x 2 steps of the
                rotation; after every step the digests of the frozen
                tensors, the octree and the error maps equal on every
                rank, each block table on its group's data ranks, every
                table on every rank after each sync; each phase moves
                exactly blocks {p, p + 5}; per rank and step K1, K2 and H2
                once, H1 once at init and twice at the focal stage; rank
                0's checkpoint loaded into a one-card Trainer (the ranks'
                final state bit for bit), resumed 2 steps, an eval image
                beside its mean image's PSNR; s/step at world 4 against one
                process, peak memory per rank, the backend.  Then, under
                each backend, the same 4 ranks with --vis viewer
                viewer_port=0: rank 0 serves, this process drives it over
                HTTP in the concurrent stage (pause, a 640x480 render, 1 s
                in which no rank steps, resume, a render while training,
                pause, render B of a camera of the other group's block,
                stop): the ranks' steps and syncs equal, one checkpoint
                holding every rank's final state, render B equal pixel for
                pixel to the one-card render of that checkpoint and unlike
                one with the block's table as its phase began, K1, K2, H1
                and H2 launched and no other kernel; a render's seconds
                paused and while training, a control broadcast's seconds a
                step (see phase_parallel).
 24. quality  — with the counters reset: gf-nerf's quality run through
                gfnerf_tpu_torch.quality_run's own functions (--config
                perf --diag --n-blocks 2: packed 8 x 4 of 2^15, 4096 rays,
                384 samples) on the textured scene of 72 + 6 views at
                160x120, QUALITY_INIT_STEPS init steps and
                QUALITY_SPLIT_STEPS a block: K1, K2, H1 and H2 launched,
                no other kernel; after init the eval PSNR at least
                QUALITY_INIT_MARGIN_DB above the mean image's; after the
                first split the shared field's renders within
                QUALITY_FROZEN_DB of after init's and the untrained block's
                within QUALITY_UNTRAINED_DB of the shared field's (the
                difference printed); the routed PSNR against after init's
                printed, not checked.
 25. midscale — gfnerf_tpu_torch.midscale_run at reduced steps and scene
                (MIDSCALE_ARGS: 48 views at 100x75 in the nerfstudio
                layout, 60 init steps with rebuilds at 7, 15 and 30, 4
                blocks of 40, 1024 rays of 192 samples, a checkpoint every
                120 steps), its train and eval processes run through
                ``chip_smoke.py --counted`` (each writes its launch counts
                as it exits or is killed), train with --vis tensorboard: phase 1 at least 2 rebuilds and
                killed past kill_at, phase 2 resumed at its checkpoint's
                step + 1 with no rebuild, rc 0 and the last step's
                checkpoint, eval rc 0 with a finite PSNR above the black
                image's (the mean image's beside it), each run's event file
                read back (CRCs, scalars, the config); K1, K2, H1 and H2
                launched over the three processes, no other kernel.
Each phase ends with a [clock] line.  The script builds each octree and
draws each hash table's primes once (SetupReuse): a later phase that asks
for the same gets a copy, and its setup line counts the reuses.  Before
the last line come a JSON
object with each kernel's launches, error, times and bound (K1, K2, H1 and
H2 also at the prop phase's shapes, under "prop"; H4 and H5 at nerfacto's
three, under "nerfacto", and at instant-ngp's, under "instant_ngp"; M1 at
the train batch, with its render chunk, gf-nerf's march and the by-part
inputs under "render_chunk", "gfnerf_march" and "by_part", each with its
bound; T1 and T2 at nerfplayer-nerfacto's field, with every shape of the
pair's steps under "nerfplayer", T2's records per level and both
kernels' times at 1-16 levels a launch at the field), and the
card's name and power limit; the last line is
{"ok": true, "device": {...}}.

Run from the repository root:  python3 chip_smoke.py
To work on one phase of the pipeline family (pipeline, gfnerf, prop,
nerfacto, semantics, instant-ngp, scan, stock, nerfplayer, captures,
tools, parallel, quality, midscale, window; nerfacto, semantics and tools read
the pipeline phase's
scene and checkpoint),
or to train the captures phase's capture once a variant
(capture-variants: reported, not checked):
python3 chip_smoke.py --only pipeline,nerfacto,semantics
python3 chip_smoke.py --only scan,stock
python3 chip_smoke.py --only nerfplayer
python3 chip_smoke.py --only captures
python3 chip_smoke.py --only capture-variants
python3 chip_smoke.py --only pipeline,tools
python3 chip_smoke.py --only parallel
python3 chip_smoke.py --only quality,midscale
python3 chip_smoke.py --only jpeg
python3 chip_smoke.py --only window,pipeline
Either form takes ``--parent DIR`` first: DIR is another checkout of this
repository (the parent commit unpacked with git archive under _trees/,
which .gitignore lists), whose table gradients H2 and H5 are then built
from its sources and timed in turns with this tree's, alone (H2 at the
train batch and the probe, H5 at the parity batch and instant-ngp's step)
and in steps (the quality workload's K = 8 windows at the init and focal
stages, gf-nerf's init steps):
python3 chip_smoke.py --parent _trees/parent
Either form takes ``--coverage-case PATH`` last: the scan phase then writes
the octree and rays of its coverage check there, for
``python tests/torch_parity.py scan-coverage PATH`` (the JAX package's
scan and fast march on the same case, on the CPU).
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
COMPARE_RAYS = 8192
# kernel vs plain, f32 (the JAX tests' composite tolerance)
K1_TOL = dict(rtol=1e-4, atol=1e-5)
H1_ATOL = 1e-5
# K2 vs plain: the suffix and prefix sums run in other orders (warp scans
# against cumsum), so an output that nearly cancels keeps an absolute error
# of a few f32 ulps of the ray's largest term: rtol 1e-4 plus an atol of
# 1e-6 of the output's largest magnitude
K2_RTOL, K2_ATOL_REL = 1e-4, 1e-6
# H2 and H5 vs plain: both sum the same terms exactly in int64 fixed point
# (csrc/fixed_point.cuh), so they are held bit for bit (check_table_grad)
# one chunk, kernels vs plain versions: the encodes agree bit for bit (so
# the bf16 MLPs see the same inputs), the composites to f32 rounding
SLICE_ATOL = 2e-3
# the train path: steps taken (one warm-up, TIMED_STEPS timed, the rest for
# the loss check), and one step from a common state, kernels vs the plain
# autograd pairs: the kernels' f32 sums run in other orders.  On the H100
# the step's gradients differed by at most 1.2e-4 of the group's largest
# (MLPs) and 7e-5 (table); the limit, 2e-3 of the largest, is over 10x that
TRAIN_STEPS = 20
TIMED_STEPS = 5
FOCAL_STEPS = 10   # focal steps per block
PARITY_FOCAL_STEPS = 5   # anchored focal steps on block 0
TRAIN_LOSS_RTOL = 1e-4
TRAIN_GRAD_TOL = 2e-3
# the card's peak memory rate (H100 SXM data sheet), for the bounds
HBM_BYTES_PER_S = 3.35e12


class SetupReuse:
    """The octrees and the hash tables' primes this script has built,
    handed out again (copies) when a later phase asks for the same ones.
    Both are functions of their arguments (the cameras, bounds and sampler
    settings; the generator's state and count), and the smoke builds the
    pipeline phase's tree again in the gfnerf, prop and scan phases and
    draws the same primes in many pipelines; a process that serves users
    builds one pipeline and pays both.  So the pipeline phase's setup (the
    first build) and the tools phase's first ``eval_setup`` (its primes
    drawn anew, ``forget_primes``) are what one process pays; the other
    phases' setup seconds are on reused builds, and their lines say so
    (``note``)."""

    def __init__(self):
        self.trees, self.primes = {}, {}
        self.hits = {"trees": 0, "primes": 0}

    def install(self) -> None:
        import copy
        import hashlib

        import numpy as np

        from gfnerf_tpu_torch.fields import hash_encoding, packed_hash
        from gfnerf_tpu_torch.sampler import manager

        build, draw = manager.build_octree, hash_encoding._random_primes

        def build_octree(*arrays, **kw):
            h = hashlib.sha256(repr(sorted(
                (k, str(v)) for k, v in kw.items())).encode())
            for a in arrays:
                a = np.ascontiguousarray(a)
                h.update(repr((a.dtype.str, a.shape)).encode())
                h.update(a.tobytes())
            key = h.hexdigest()
            if key in self.trees:
                self.hits["trees"] += 1
            else:
                self.trees[key] = build(*arrays, **kw)
            return copy.deepcopy(self.trees[key])

        def random_primes(rng, count):
            key = (repr(rng.bit_generator.state), count)
            if key in self.primes:
                self.hits["primes"] += 1
                out, after = self.primes[key]
                rng.bit_generator.state = after
                return out.copy()
            out = draw(rng, count)
            self.primes[key] = (out.copy(), rng.bit_generator.state)
            return out

        manager.build_octree = build_octree
        hash_encoding._random_primes = random_primes
        packed_hash._random_primes = random_primes

    def forget_primes(self) -> None:
        self.primes.clear()

    def note(self) -> str:
        """The reuses since the last note, as a line's words."""
        got, self.hits = self.hits, {"trees": 0, "primes": 0}
        return (f"reused from earlier phases: {got['trees']} octree(s), "
                f"{got['primes']} prime draw(s)")


SETUP_REUSE = SetupReuse()


def log(msg: str) -> None:
    print(msg, flush=True)


def time_ms(fn, n: int = 7, reps: int = 1) -> float:
    """Median CUDA-event time of fn() in milliseconds, after one warm-up:
    n samples, each of reps calls in a row between two events, so that
    with reps > 1 the host's launch overhead overlaps the device's work."""
    import numpy as np
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / reps)
    return float(np.median(times))


def in_turns(forms: dict, order, **kw) -> dict:
    """Each form's time: time_ms of each in the given order (the forms
    alternating), the smaller median of its turns."""
    turns = {name: [] for name in forms}
    for name in order:
        turns[name].append(time_ms(forms[name], **kw))
    return {name: min(t) for name, t in turns.items()}


def queued_device_ms(fn, calls: int = 20) -> float:
    """The device time of one call of fn(), from CUDA events around
    ``calls`` calls queued behind a spin kernel: the host has launched them
    all before the device reaches the first, so the span holds the calls'
    kernels and the gaps between launches, and no host time."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(100_000_000)   # about 50 ms at the H100's clock
    start.record()
    for _ in range(calls):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / calls


def profiled_counts(fn, key, done=None, tries: int = 3):
    """({name: (records, device us)} summed over the events of a
    torch.profiler trace of fn() that ``key(event)`` names (None: left
    out), whether ``done(counts)`` held): the trace is taken again, up to
    ``tries`` times, while ``done`` does not hold, since the profiler's
    CUDA tracing now and then loses kernel records (none, or a part of a
    trace).  fn() synchronizes where the trace must hold its kernels."""
    from torch.profiler import ProfilerActivity, profile

    for attempt in range(1, tries + 1):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
        counts = {}
        for e in prof.key_averages():
            name = key(e)
            if name is not None:
                n, us = counts.get(name, (0, 0.0))
                counts[name] = (n + e.count, us + e.self_device_time_total)
        if done is None or done(counts):
            return counts, True
        log(f"[profiler] the trace holds "
            f"{ {k: n for k, (n, _) in counts.items()} } records (try "
            f"{attempt} of {tries})")
    return counts, False


def kernel_device_ms(fn, match: str, calls: int = 20, launches: int = 1,
                     tries: int = 3) -> float:
    """The mean device time of the kernels whose names contain ``match``
    per call of fn() (``launches`` of them a call), from a torch.profiler
    trace of ``calls`` calls (the kernels alone: no launch gaps, no host
    time), taken again while it does not hold all calls x launches
    (profiled_counts); if none does, the time is queued_device_ms's (the
    whole call, from CUDA events)."""
    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()
    want = calls * launches

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    counts, whole = profiled_counts(
        run, lambda e: match if (e.device_type == DeviceType.CUDA
                                 and match in e.key) else None,
        lambda got: got.get(match, (0, 0.0))[0] == want
        and got[match][1] > 0, tries)
    if whole:
        return counts[match][1] / 1e3 / calls
    ms = queued_device_ms(fn, calls)
    log(f"[profiler] {match}: no whole trace of {want} kernel records; "
        f"{ms:.4f} ms per call from CUDA events around {calls} queued calls "
        f"instead")
    return ms


def max_err(got, want) -> float:
    return max(float((g - w).abs().max()) for g, w in zip(got, want))


def assert_close(got, want, what, rtol=0.0, atol=0.0, atol_rel=0.0):
    """|got - want| <= rtol |want| + atol + atol_rel max|want|, per
    tensor."""
    import torch

    for i, (g, w) in enumerate(zip(got, want)):
        tol = atol + atol_rel * float(w.abs().max())
        if not torch.allclose(g, w, rtol=rtol, atol=tol):
            err = float((g - w).abs().max())
            raise AssertionError(f"{what}[{i}]: max abs err {err} over "
                                 f"rtol {rtol} atol {tol}")


def check_table_grad(what, backward, plain, args, permute=None):
    """A table gradient (H2, H5 or T2: ``backward``) on ``args`` against
    its plain version ``plain``, bit for bit; called again, and on the
    points (their rows of g and their anchors or times with them) in
    another order, the same bits: the fixed-point sum does not depend on
    the order in which the warps land.  ``args`` are (g, primes, biases,
    points, anchors, then the table's shape), or any that start with g (P,
    ...) and come with ``permute(args, perm)``, the args of the points in
    the order ``perm``.  Returns the kernel's gradient."""
    import torch

    got = backward(*args)
    want = plain(*args)
    again = backward(*args)
    g = args[0]
    perm = torch.randperm(g.shape[0], device=g.device,
                          generator=torch.Generator(
                              device=g.device).manual_seed(0))
    if permute is None:
        _, prim, bias, pts, anc, *rest = args
        moved = backward(g[perm], prim, bias, pts[perm], anc[perm], *rest)
    else:
        moved = backward(*permute(args, perm))
    torch.cuda.synchronize()
    for name, other in (("the plain version", want), ("a second call", again),
                        ("a call on the points permuted", moved)):
        if not torch.equal(got, other):
            raise AssertionError(
                f"{what}: not equal bit for bit to {name}: "
                f"{int((got != other).sum())} entries apart, at most "
                f"{max_err([got], [other])}")
    return got


def library_sums_ms(terms, n_out: int) -> dict:
    """The PyTorch calls that sum the same f32 terms as a table gradient,
    timed here as yardsticks and used nowhere in the port: ``index_add_``
    into a zeroed flat (n_out,) tensor (float atomics, an order that
    varies), and ``index_put_(..., accumulate=True)`` under
    ``torch.use_deterministic_algorithms(True)`` (a sort of the indices,
    then a segmented sum: the same bits every call), the zero-fill in
    both.  ``terms``: (flat index, value) pairs of one shape each."""
    import torch

    idx = torch.cat([i.reshape(-1) for i, _ in terms])
    vals = torch.cat([v.reshape(-1) for _, v in terms])
    del terms
    out = {"index_add_ms": time_ms(lambda: torch.zeros(
        n_out, device=idx.device).index_add_(0, idx, vals), n=5, reps=2)}
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        out["deterministic_index_put_ms"] = time_ms(lambda: torch.zeros(
            n_out, device=idx.device).index_put_((idx,), vals,
                                                 accumulate=True),
            n=5, reps=2)
    finally:
        torch.use_deterministic_algorithms(before)
    out["terms"] = int(idx.numel())
    return out


def phase_device():
    global CARD
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke "
                           "run needs a CUDA card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = CARD = smi.stdout.strip().splitlines()[0]
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.device_count()} card(s); using "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    return card


# ``--parent DIR``: another checkout of this repository (the parent tree,
# unpacked from git under _trees/): its table gradients H2 and H5 are timed
# in turns with this tree's (parent, this, this, parent) on the same inputs
# and in the same steps; set by main, loaded by load_parent
PARENT_DIR = None
PARENT = None
# the card's name and power limit (nvidia-smi), set by phase_device: the
# lines that time this tree against the parent carry it
CARD = ""


def load_parent(parent: Path):
    """The parent checkout's H2 and H5 wrappers: its fields/packed_hash.py
    and fields/hash_encoding.py loaded as modules of their own, over its
    ops/build.py, which builds its csrc/ into its own _build/ (on a thread:
    the build runs beside this tree's).  Returns a namespace with
    ``h2``/``h5`` (its _packed_hash_backward_cuda, _hash_backward_cuda)
    and ``join()``, which waits for the build."""
    import importlib.util
    import threading
    from types import SimpleNamespace

    # this tree's modules first: they bind this tree's build
    import gfnerf_tpu_torch.fields.packed_hash  # noqa: F401
    import gfnerf_tpu_torch.ops as ops_pkg
    from gfnerf_tpu_torch.ops import build as ours

    pkg = parent.resolve() / "gfnerf_tpu_torch"

    def load(name, path):
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    build = load("parent_gfnerf_build", pkg / "ops" / "build.py")
    ops_pkg.build = build   # what the parent's modules import as build
    try:
        he = load("parent_gfnerf_hash_encoding",
                  pkg / "fields" / "hash_encoding.py")
        ph = load("parent_gfnerf_packed_hash",
                  pkg / "fields" / "packed_hash.py")
    finally:
        ops_pkg.build = ours
    box = {}

    def run():
        try:
            box["res"] = build.build_library()
            build.library()
        except BaseException as e:   # raised again by join()
            box["err"] = e

    thread = threading.Thread(target=run, name="parent build", daemon=True)
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["res"]

    return SimpleNamespace(dir=parent, h2=ph._packed_hash_backward_cuda,
                           h5=he._hash_backward_cuda, join=join)


class parent_table_grads:
    """Within the block the port's train steps call the parent checkout's
    H2 and H5 (PARENT) in place of this tree's."""

    def __enter__(self):
        from gfnerf_tpu_torch.fields import hash_encoding, packed_hash

        self.saved = (packed_hash._packed_hash_backward_cuda,
                      hash_encoding._hash_backward_cuda)
        packed_hash._packed_hash_backward_cuda = PARENT.h2
        hash_encoding._hash_backward_cuda = PARENT.h5
        return self

    def __exit__(self, *exc):
        from gfnerf_tpu_torch.fields import hash_encoding, packed_hash

        (packed_hash._packed_hash_backward_cuda,
         hash_encoding._hash_backward_cuda) = self.saved
        return False


def against_parent(what, name, kernel, args) -> dict:
    """A table gradient (``kernel``: "h2" or "h5") of this tree and of the
    parent's on ``args``, timed in turns (parent, this, this, parent; 11
    samples each, the smaller median of each one's turns), or {} without a
    parent.  The parent's gradient, the same exact fixed-point sum, must
    equal this one's bit for bit."""
    import torch

    from gfnerf_tpu_torch.fields import hash_encoding, packed_hash

    if PARENT is None:
        return {}
    ours = {"h2": packed_hash._packed_hash_backward_cuda,
            "h5": hash_encoding._hash_backward_cuda}[kernel]
    theirs = getattr(PARENT, kernel)
    got, old = ours(*args), theirs(*args)
    torch.cuda.synchronize()
    if not torch.equal(got, old):
        raise AssertionError(f"{what} {name}: not equal bit for bit to the "
                             f"parent's: {int((got != old).sum())} entries "
                             f"apart, at most {max_err([got], [old])}")
    del got, old
    out = in_turns({"parent": lambda: theirs(*args),
                    "this": lambda: ours(*args)},
                   ("parent", "this", "this", "parent"), n=11)
    log(f"[{what}] {name} in turns with the parent tree's "
        f"({PARENT.dir}), on {CARD}: this {out['this']:.4f} ms, the "
        f"parent's {out['parent']:.4f} ms")
    return {"parent_turns_ms": out}


def start_parent() -> None:
    """With ``--parent DIR``: load the parent's wrappers and start its
    build (load_parent)."""
    global PARENT
    if PARENT_DIR is not None:
        PARENT = load_parent(PARENT_DIR)


def join_parent() -> None:
    """Wait for the parent's build, if there is a parent."""
    if PARENT is not None:
        res = PARENT.join()
        log(f"[build] the parent tree's kernels ({PARENT.dir}) in "
            f"{res['seconds']:.2f}s")


def phase_build():
    from gfnerf_tpu_torch.ops import build

    res = build.build_library(verbose=True)
    log(f"[build] nvcc {' '.join(build.NVCC_FLAGS)} -> "
        f"{build.LIB_PATH.relative_to(REPO)} in {res['seconds']:.2f}s")
    for line in res["log"].splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log(f"[build]   {line.strip()}")
    build.library()
    res = build.build_jpeg_library()
    log(f"[build] g++ {' '.join(build.CXX_FLAGS)} -> "
        f"{build.JPEG_LIB_PATH.relative_to(REPO)} in {res['seconds']:.2f}s")
    build.jpeg_library()


# the JPEG codec (gfnerf_tpu_torch/csrc/jpeg/, host code): the committed
# fixtures of tests/data/jpeg (Pillow's and cv2's files, one progressive,
# one with restarts, one grey) against imageio's decodes stored beside
# them and against the plain numpy versions; the rates on a 4000x3000
# photo-sized image and a 1920x1080 frame
JPEG_FIXTURES = REPO / "tests" / "data" / "jpeg"
JPEG_BIG_WH = (4000, 3000)
JPEG_FRAME_WH = (1920, 1080)
JPEG_POOL_IMAGES = 16
JPEG_DECODE_LIMIT_S = 1.0      # a 4000x3000 decode on one host thread


def jpeg_test_image(w: int, h: int, seed: int):
    """(h, w, 3) uint8 with a photo's mix: smooth gradients, sharp-edged
    rectangles and sensor-like noise (sigma 4)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    img = np.empty((h, w, 3), np.float32)
    for c in range(3):
        img[..., c] = 128 + 60 * np.sin(6.0 * x + 2 * c) * np.cos(
            4.0 * y - c) + 40 * (x - y)
    for _ in range(40):
        x0, y0 = int(rng.integers(0, w)), int(rng.integers(0, h))
        img[y0:y0 + int(rng.integers(8, h // 4)),
            x0:x0 + int(rng.integers(8, w // 4))] = rng.uniform(0, 255, 3)
    img += rng.normal(0.0, 4.0, (h, w, 1)).astype(np.float32)
    return np.clip(img, 0, 255).astype(np.uint8)


def phase_jpeg(card: str) -> dict:
    """The codec against the committed fixtures and its plain versions,
    and its rates: decode on one thread and on a pool, encode."""
    import concurrent.futures
    import os

    import numpy as np

    from gfnerf_tpu_torch.utils.jpeg import (decode_jpeg,
                                             decode_jpeg_reference,
                                             encode_jpeg,
                                             encode_jpeg_reference)

    want = np.load(JPEG_FIXTURES / "decodes.npz")
    files = sorted(JPEG_FIXTURES.glob("*.jpg"))
    if not files or sorted(f.stem for f in files) != sorted(want.files):
        raise AssertionError(f"jpeg: fixtures {[f.name for f in files]} "
                             f"against decodes {sorted(want.files)}")
    for f in files:
        data = f.read_bytes()
        got = decode_jpeg(data)
        plain = decode_jpeg_reference(data)
        if not (np.array_equal(got, want[f.stem])
                and np.array_equal(plain, got)):
            raise AssertionError(f"jpeg: {f.name} differs from imageio's "
                                 "decode or from the plain version")
        kind = ("progressive" if b"\xff\xc2" in data else "baseline") + (
            ", restarts" if b"\xff\xdd" in data else "")
        log(f"[jpeg] {f.name} ({len(data)} bytes, {kind}) {got.shape}: "
            f"equal to imageio's decode and to the plain version")
    small = jpeg_test_image(96, 72, 1)
    for src, sub in ((small, "4:2:0"), (small, "4:4:4"),
                     (small[..., 1], "4:2:0")):
        data = encode_jpeg(src, 90, sub)
        if data != encode_jpeg_reference(src, 90, sub):
            raise AssertionError(f"jpeg: the encoder at {sub} "
                                 f"{src.shape} differs from the plain one")
        if decode_jpeg(data).shape != src.shape:
            raise AssertionError("jpeg: an encoded image decodes to "
                                 "another shape")
    log("[jpeg] encode_jpeg at 96x72 (4:2:0, 4:4:4, grey, quality 90) "
        "equal to the plain version byte for byte")

    w, h = JPEG_BIG_WH
    big = jpeg_test_image(w, h, 2)
    t0 = time.perf_counter()
    data = encode_jpeg(big, 90, "4:2:0")
    enc_big_s = time.perf_counter() - t0
    one = []
    for _ in range(3):
        t0 = time.perf_counter()
        out = decode_jpeg(data)
        one.append(time.perf_counter() - t0)
    psnr = float(10 * np.log10(255.0 ** 2 / np.mean(
        (out.astype(np.float32) - big) ** 2)))
    threads = os.cpu_count() or 1
    with concurrent.futures.ThreadPoolExecutor(threads) as ex:
        list(ex.map(decode_jpeg, [data] * threads))
        t0 = time.perf_counter()
        list(ex.map(decode_jpeg, [data] * JPEG_POOL_IMAGES))
        pool_s = time.perf_counter() - t0
    mpix = w * h / 1e6
    one_s = float(np.median(one))
    fw, fh = JPEG_FRAME_WH
    frame = jpeg_test_image(fw, fh, 3)
    enc = {}
    for sub in ("4:4:4", "4:2:0"):
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            encode_jpeg(frame, 90, sub)
            ts.append(time.perf_counter() - t0)
        enc[sub] = float(np.median(ts))
    stats = {"card": card, "decode_4000x3000_s": one_s,
             "decode_mpix_per_s_one_thread": mpix / one_s,
             "decode_mpix_per_s_pool": JPEG_POOL_IMAGES * mpix / pool_s,
             "pool_threads": threads, "jpeg_bytes": len(data),
             "encode_4000x3000_s": enc_big_s, "round_trip_psnr": psnr,
             "encode_1920x1080_s": enc,
             "encode_mpix_per_s_1920x1080": {
                 k: fw * fh / 1e6 / v for k, v in enc.items()}}
    log(f"[jpeg] {card}: a {w}x{h} JPEG (quality 90, 4:2:0, "
        f"{len(data) / 1e6:.3f} MB, PSNR {psnr:.2f} dB) decodes in "
        f"{one_s:.4f} s on one host thread ({mpix / one_s:.2f} Mpixel/s; "
        f"runs {[round(t, 4) for t in one]}), "
        f"{stats['decode_mpix_per_s_pool']:.2f} Mpixel/s over "
        f"{JPEG_POOL_IMAGES} images on a pool of {threads} threads; "
        f"encoded in {enc_big_s:.4f} s; a {fw}x{fh} frame encodes in "
        f"{enc['4:4:4']:.4f} s at 4:4:4 (the video's), {enc['4:2:0']:.4f} "
        f"s at 4:2:0")
    if one_s >= JPEG_DECODE_LIMIT_S:
        raise AssertionError(f"jpeg: a {w}x{h} decode took {one_s:.3f} s "
                             f"on one thread (limit {JPEG_DECODE_LIMIT_S})")
    return stats


def _composite_inputs(r, s, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    x = [(rng.random((r, s)) * 5), rng.random((r, s)) * 0.01 + 1e-3,
         np.cumsum(rng.random((r, s)), -1), rng.random((r, s, 3))]
    return [torch.as_tensor(a.astype(np.float32), device="cuda") for a in x]


def _hash_inputs(p, n_channels, n_volumes, seed, n_levels=8, rows_log2=15):
    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import init_packed_hash_params

    _, prim, bias = init_packed_hash_params(seed, rows_log2, n_volumes,
                                            n_levels, n_channels)
    rng = np.random.default_rng(seed)
    feat = rng.uniform(-0.5, 0.5, (n_levels, 1 << rows_log2, 128))
    pts = rng.uniform(0.17, 0.83, (p, 3))
    anc = rng.integers(0, n_volumes, p)
    anc[rng.random(p) < 0.05] = -1
    dev = "cuda"
    return (torch.as_tensor(feat.astype(np.float32), device=dev),
            torch.as_tensor(prim.astype(np.int64), device=dev),
            torch.as_tensor(bias, device=dev),
            torch.as_tensor(pts.astype(np.float32), device=dev),
            torch.as_tensor(anc.astype(np.int32), device=dev))


def _cotangents(r, s, seed):
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    shapes = ((r, s), (r, s), (r, 3), (r, 1), (r, 1))
    return [torch.as_tensor(rng.standard_normal(sh).astype(np.float32),
                            device="cuda") for sh in shapes]


def composite_fwd_bytes(r, s) -> int:
    """Bytes the composite must move: each input (sigma, dt, t, rgb) read
    once, each output (w, alpha, rgb, acc, depth) written once (f32)."""
    return 4 * (6 * r * s + 2 * r * s + 5 * r)


def f32_bytes(*tensors) -> int:
    """Bytes of the given f32 tensors (None counts as none)."""
    return 4 * sum(t.numel() for t in tensors if t is not None)


def check_composite_bwd() -> dict:
    """K2 against its plain version at both train configs' shapes (S = 384
    and 192) and gf-nerf's (S = 1024), a ragged one, a tiny one, one whose
    transmittance underflows mid-ray, and past the register kernel's 512
    samples (the tiled kernel), with every cotangent and gradient; then as
    the train step calls it, through autograd: cotangents of rgb and acc
    only, gradients of densities and colours only.  Timed against the plain
    version in both forms at S = 384, and in the train step's form at S =
    384 and 192: the register kernel and the tiled kernel in turns, each as
    the kernels' device time from the profiler and as the wrapper's, 20
    calls per event pair; at S = 1024 the tiled kernel alone.  The train
    step's form at S = 384 is the one reported, by its device time."""
    import torch

    from gfnerf_tpu_torch.ops.composite import (
        _composite_bwd_cuda, composite_backward_reference, fused_composite)

    errs = []
    for r, s, opaque in ((8192, 384, False), (8192, 192, False),
                         (8192, 1024, False), (1000, 48, False),
                         (7, 33, False), (1000, 48, True),
                         (1000, 513, False), (1000, 513, True)):
        x = _composite_inputs(r, s, seed=r + s + 7)
        if opaque:   # sigma*dt up to 10: T underflows to 0 mid-ray
            x[0] = x[0] * 200.0
        g = _cotangents(r, s, seed=r + s)
        got = _composite_bwd_cuda(*x, g)
        want = composite_backward_reference(*x, g)
        torch.cuda.synchronize()
        assert_close(got, want, f"composite_bwd R={r} S={s} opaque={opaque}",
                     rtol=K2_RTOL, atol_rel=K2_ATOL_REL)
        errs.append(max_err(got, want))
        log(f"[kernels] composite_bwd R={r} S={s} opaque={opaque}: max abs "
            f"err {errs[-1]:.3g}")
    r, s = 8192, 384
    x = _composite_inputs(r, s, seed=2)
    g = _cotangents(r, s, seed=3)
    need = (True, False, False, True)
    cots = [None, None, g[2], g[3], None]
    xs = [t.clone().requires_grad_(n) for t, n in zip(x, need)]
    out = fused_composite(*xs)
    torch.autograd.backward([out[2], out[3]], [g[2], g[3]])
    want = composite_backward_reference(*x, cots, need)
    torch.cuda.synchronize()
    if xs[1].grad is not None or xs[2].grad is not None:
        raise AssertionError("composite_bwd: a gradient nobody asked for")
    got = [xs[0].grad, xs[3].grad]
    assert_close(got, [want[0], want[3]],
                 f"composite_bwd R={r} S={s} through autograd, train form",
                 rtol=K2_RTOL, atol_rel=K2_ATOL_REL)
    errs.append(max_err(got, [want[0], want[3]]))
    log(f"[kernels] composite_bwd R={r} S={s} through autograd, cotangents "
        f"of rgb and acc, gradients of sigma and rgb: max abs err "
        f"{errs[-1]:.3g}")
    del xs, out, got
    # bytes: the inputs K2 reads (t only with a depth cotangent) and the
    # outputs it writes, (R, S) for sigma, dt, t and (R, S, 3) for rgb
    args = (*x, g)
    n_bytes = f32_bytes(*x, *g) + 4 * 6 * r * s
    all_ms = kernel_device_ms(lambda: _composite_bwd_cuda(*args),
                              "composite_bwd_ray")
    all_plain_ms = time_ms(lambda: composite_backward_reference(*args))
    log(f"[kernels] composite_bwd R={r} S={s}, all cotangents and gradients:"
        f" kernel {all_ms:.4f} ms (device time), plain {all_plain_ms:.4f} ms,"
        f" bound {n_bytes / HBM_BYTES_PER_S * 1e3:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB)")
    train = {}
    for s in (384, 192):
        x = _composite_inputs(r, s, seed=2)
        g = _cotangents(r, s, seed=3)
        cots = [None, None, g[2], g[3], None]
        args = (*x, cots, need)
        n_bytes = f32_bytes(x[0], x[1], x[3], *cots) + 4 * 4 * r * s
        # register, tiled, tiled, register: the smaller of each's turns
        turns = {False: [], True: []}
        device = {False: [], True: []}
        for tiled in (False, True, True, False):
            turns[tiled].append(time_ms(
                lambda: _composite_bwd_cuda(*args, tiled=tiled), n=21,
                reps=20))
            device[tiled].append(kernel_device_ms(
                lambda: _composite_bwd_cuda(*args, tiled=tiled),
                "composite_bwd_tiled" if tiled else "composite_bwd_ray"))
        row = {"ms": min(device[False]), "tiled_ms": min(device[True]),
               "wrapper_ms": min(turns[False]),
               "tiled_wrapper_ms": min(turns[True]),
               "plain_ms": time_ms(
                   lambda: composite_backward_reference(*args)),
               "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
        train[s] = row
        log(f"[kernels] composite_bwd R={r} S={s}, train form: device time "
            f"per call from the profiler (20 calls), register kernel "
            f"{row['ms']:.4f} ms (turns {device[False]}), tiled kernel "
            f"{row['tiled_ms']:.4f} ms (turns {device[True]}); the wrapper, "
            f"20 calls per event pair: register {row['wrapper_ms']:.4f} ms, "
            f"tiled {row['tiled_wrapper_ms']:.4f} ms; plain "
            f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
            f"({n_bytes / 1e6:.1f} MB)")
    # gf-nerf's 1024 slots: past the register kernel's 512, the tiled
    # kernel alone
    s = 1024
    x = _composite_inputs(r, s, seed=2)
    g = _cotangents(r, s, seed=3)
    cots = [None, None, g[2], g[3], None]
    args = (*x, cots, need)
    n_bytes = f32_bytes(x[0], x[1], x[3], *cots) + 4 * 4 * r * s
    row = {"ms": kernel_device_ms(lambda: _composite_bwd_cuda(*args),
                                  "composite_bwd_tiled"),
           "wrapper_ms": time_ms(lambda: _composite_bwd_cuda(*args), n=21,
                                 reps=20),
           "plain_ms": time_ms(lambda: composite_backward_reference(*args)),
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3}
    train[s] = row
    log(f"[kernels] composite_bwd R={r} S={s}, train form (the tiled "
        f"kernel): device time {row['ms']:.4f} ms, the wrapper, 20 calls "
        f"per event pair, {row['wrapper_ms']:.4f} ms; plain "
        f"{row['plain_ms']:.4f} ms, bound {row['bound_ms']:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB)")
    del x, g, cots, args
    # the kernels line: the kernel's own time (a wrapper call's host work
    # is about as long as the kernel, so 20 calls per event pair time the
    # host in part)
    main = train[384]
    return dict(max_abs_err=max(errs), ms=main["ms"],
                plain_ms=main["plain_ms"], bound_ms=main["bound_ms"],
                bound_by="bytes", library_ms=None,
                wrapper_ms=main["wrapper_ms"], tiled_ms=main["tiled_ms"],
                tiled_wrapper_ms=main["tiled_wrapper_ms"],
                all_cotangents_ms=all_ms, s192=train[192],
                s1024=train[1024])


def check_hash_bwd() -> float:
    """H2 against its plain version at 2^20 points (C = 4 with and without
    dense levels, and with a dense level in a table of 2^13 rows, as a
    focal block's may be; C = 2, C = 8) and at 1000 points with masked
    anchors, bit for bit, also called again and on the points permuted
    (check_table_grad); the padding columns must stay exactly 0.  Returns
    the max error (0.0)."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, pack_for_channels,
        packed_hash_backward_reference)

    errs = []
    for p, c, dense, rows_log2 in (
            (1 << 20, 4, 0, 15), (1 << 20, 4, 2, 15), (1 << 20, 4, 2, 13),
            (1 << 20, 2, 0, 15), (1 << 20, 8, 0, 15), (1000, 4, 0, 15)):
        feat, prim, bias, pts, anc = _hash_inputs(
            p, c, n_volumes=16, seed=p + c + dense + 1, rows_log2=rows_log2)
        n_levels, n_rows, width = feat.shape
        gen = torch.Generator(device="cuda").manual_seed(p + c)
        g = torch.randn((p, n_levels * c), generator=gen, device="cuda")
        pack = pack_for_channels(c)
        args = (g, prim, bias, pts, anc, n_rows, width, c, pack, dense)
        got = check_table_grad(f"packed_hash_bwd P={p} C={c} dense={dense}",
                               _packed_hash_backward_cuda,
                               packed_hash_backward_reference, args)
        live = (pack + 1) ** 3 * c
        if not bool((got[..., live:] == 0).all()):
            raise AssertionError("packed_hash_bwd: padding columns written")
        errs.append(0.0)
        log(f"[kernels] packed_hash_bwd P={p} C={c} dense_levels={dense} "
            f"rows=2^{rows_log2}: equal to the plain version bit for bit, "
            f"also called again and on the points permuted (largest entry "
            f"{float(got.abs().max()):.3g}); columns {live}.. exactly 0")
        del got, g, args
    torch.cuda.empty_cache()
    return max(errs)


def check_hash_routed() -> float:
    """H3 against its plain version, bit for bit, on 3 stacked tables with
    each block's own primes and biases, a block per run of 384 points (a
    ray's samples), some blocks and some anchors -1 and one block past the
    last: C = 4 with and without dense levels, and with a dense level in
    tables of 2^13 rows; C = 2; C = 8; 1000 points.  Returns the max
    error."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        init_packed_hash_params, pack_for_channels, packed_hash_encode_routed,
        packed_hash_encode_routed_raw)

    n_blocks, n_volumes, n_levels = 3, 16, 8
    errs = []
    for p, c, dense, rows_log2 in (
            (1 << 20, 4, 0, 15), (1 << 20, 4, 2, 15), (1 << 20, 4, 2, 13),
            (1 << 18, 2, 0, 15), (1 << 18, 8, 0, 15), (1000, 4, 0, 15)):
        seed = p + c + dense + rows_log2
        _, prim, bias, pts, anc = _hash_inputs(p, c, n_volumes, seed,
                                               n_levels, rows_log2)
        pools = [init_packed_hash_params(seed + b, rows_log2, n_volumes,
                                         n_levels, c)[1:]
                 for b in range(n_blocks)]
        prims = torch.as_tensor(np.stack([x[0] for x in pools]).astype(
            np.int64), device="cuda")
        biases = torch.as_tensor(np.stack([x[1] for x in pools]),
                                 device="cuda")
        gen = torch.Generator(device="cuda").manual_seed(seed)
        tables = torch.rand((n_blocks, n_levels, 1 << rows_log2, 128),
                            generator=gen, device="cuda") - 0.5
        rng = np.random.default_rng(seed)
        ray_blk = rng.integers(0, n_blocks, -(-p // 384))
        ray_blk[rng.random(len(ray_blk)) < 0.05] = -1
        blk = np.repeat(ray_blk, 384)[:p].astype(np.int32)
        blk[p // 2] = n_blocks + 2   # clipped to the last block
        blk = torch.as_tensor(blk, device="cuda")
        pack = pack_for_channels(c)
        tail = (prims, biases, pts, anc, blk, c, pack, dense)
        got = packed_hash_encode_routed(tables, *tail)
        want = packed_hash_encode_routed_raw(tables, *tail)
        torch.cuda.synchronize()
        errs.append(max_err([got], [want]))
        if not torch.equal(got, want):
            raise AssertionError(f"packed_hash_routed P={p} C={c} "
                                 f"dense={dense}: max abs err {errs[-1]}, "
                                 f"not equal bit for bit")
        masked = (anc < 0) | (blk < 0)
        if not bool((got[masked] == 0).all()) \
                or not bool((got[~masked] != 0).any(-1).all()):
            raise AssertionError("packed_hash_routed: masking is off")
        log(f"[kernels] packed_hash_routed P={p} C={c} dense_levels={dense} "
            f"rows=2^{rows_log2} B={n_blocks}: equal to the plain version; "
            f"{int(masked.sum())} masked points exactly 0")
        del got, want, tables, tail
    torch.cuda.empty_cache()
    return max(errs)


def anchored_run_inputs(n_volumes, bias, n_rays=3000, n_samples=97, seed=5):
    """(points, anchors, bias) that H5's merging of runs makes risky:
    ``n_rays`` rays of ``n_samples`` points 2e-4 apart in t order (a fifth
    of a cell at scale 2^10, so runs of equal cells at every level, which
    cross the 32-point warps: 97 is odd), one anchor per ray; anchors < 0
    inside the runs (single points, a stretch, the two points around a
    32-point boundary); volumes 0 and 1 given equal biases, and every
    fourth ray alternating between them from point to point: equal cells
    under other primes, which must not merge."""
    import numpy as np

    rng = np.random.default_rng(seed)
    d = rng.standard_normal((n_rays, 1, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t = np.arange(n_samples)[None, :, None] * 2e-4
    pts = (rng.uniform(0.3, 0.7, (n_rays, 1, 3)) + t * d).reshape(-1, 3)
    anc = np.repeat(rng.integers(0, n_volumes, n_rays), n_samples).reshape(
        n_rays, n_samples)
    anc[::4] = np.arange(n_samples) % 2
    for i in (5, 21, 22, 23, 24, 25, 31, 32, 64, 65, 90):
        anc[1::2, i] = -1
    bias = bias.copy()
    bias[:, 1] = bias[:, 0]
    return pts.astype(np.float32), anc.reshape(-1).astype(np.int32), bias


def check_hash_anchored() -> tuple:
    """H4 against its plain version and H5 against its plain version, bit
    for bit (H5 also called again and on the points permuted:
    check_table_grad), with masked anchors: L = 16, C = 2, 2^19 entries a
    level at 2^20 points; L = 8, C = 4, 2^16 entries; L = 5, C = 2 at 1000
    points; and, at both channel counts, on runs of equal cells with
    masked anchors inside and two volumes sharing cells
    (anchored_run_inputs).  H5's reductions per level, counted by the
    kernel, must equal the runs reckoned on the host
    (hash_bwd_reductions: the runs' corner channels of non-zero sums).
    Returns (H4's,
    H5's max error)."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields import hash_encoding as he

    fwd_errs, bwd_errs = [], []
    for p, c, n_levels, log2 in ((1 << 20, 2, 16, 19), (1 << 18, 4, 8, 16),
                                 (1000, 2, 5, 12), ("runs", 2, 16, 19),
                                 ("runs", 4, 8, 16)):
        runs = p == "runs"
        seed = c + n_levels + (0 if runs else p)
        n_volumes = 16
        _, prim, bias = he.init_hash_params(seed, log2, n_volumes, n_levels,
                                            c)
        rng = np.random.default_rng(seed)
        if runs:
            pts, anc, bias = anchored_run_inputs(n_volumes, bias)
            p = len(pts)
        else:
            pts = rng.uniform(0.17, 0.83, (p, 3)).astype(np.float32)
            anc = rng.integers(0, n_volumes, p).astype(np.int32)
            anc[rng.random(p) < 0.05] = -1
        addr = tuple(torch.as_tensor(x, device="cuda") for x in
                     (prim.astype(np.int64), bias, pts, anc))
        gen = torch.Generator(device="cuda").manual_seed(seed)
        table = torch.rand((n_levels, 1 << log2, c), generator=gen,
                           device="cuda") - 0.5
        got = he._hash_encode_cuda(table, *addr)
        want = he.hash_encode_raw(table, *addr)
        torch.cuda.synchronize()
        fwd_errs.append(max_err([got], [want]))
        if not torch.equal(got, want):
            raise AssertionError(f"hash_anchored_fwd P={p} C={c}: max abs "
                                 f"err {fwd_errs[-1]}, not equal bit for bit")
        if not bool((got[addr[3] < 0] == 0).all()):
            raise AssertionError("hash_anchored_fwd: masked anchors not "
                                 "zeroed")
        g = torch.randn(got.shape, generator=gen, device="cuda")
        args = (g, *addr, 1 << log2, c)
        ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
        he._hash_backward_cuda(*args, red_ops=ops)
        reckoned = he.hash_bwd_reductions(*args)
        got = check_table_grad(f"hash_anchored_bwd P={p} C={c}",
                               he._hash_backward_cuda,
                               he.hash_backward_reference, args)
        if ops.tolist() != reckoned.tolist():
            raise AssertionError(
                f"hash_anchored_bwd P={p} C={c}: reductions per level "
                f"{ops.tolist()}, runs reckoned on the host "
                f"{reckoned.tolist()}")
        every = 8 * c * n_levels * int((addr[3] >= 0).sum())
        if runs and not int(ops.sum()) < every // 2:
            raise AssertionError("hash_anchored_bwd: the run inputs did not "
                                 "merge")
        bwd_errs.append(0.0)
        log(f"[kernels] hash_anchored P={p}{' (runs)' if runs else ''} "
            f"L={n_levels} C={c} local=2^{log2}: forward and table gradient "
            f"equal to the plain versions bit for bit, the gradient also "
            f"called again and on the points permuted (largest entry "
            f"{float(got.abs().max()):.3g}); {int(ops.sum())} global "
            f"reductions after the warps' runs for {every} corner channels "
            f"(host reckoning agrees)")
        del got, g, args, table
    torch.cuda.empty_cache()
    return max(fwd_errs), max(bwd_errs)


def phase_kernels(n_samples: int):
    import torch

    from gfnerf_tpu_torch.render_bench import CHUNK

    from gfnerf_tpu_torch.fields.packed_hash import (pack_for_channels,
                                                     packed_hash_encode,
                                                     packed_hash_encode_raw)
    from gfnerf_tpu_torch.ops.composite import (composite_reference,
                                                fused_composite)

    report = {}
    # K1: the render chunk's shape, and a ragged one
    errs = []
    for r, s in ((CHUNK, n_samples), (1000, 48), (7, 33)):
        x = _composite_inputs(r, s, seed=r + s)
        got = fused_composite(*x)
        want = composite_reference(*x)
        torch.cuda.synchronize()
        assert_close(got, want, f"composite R={r} S={s}", **K1_TOL)
        errs.append(max_err(got, want))
        log(f"[kernels] composite_fwd R={r} S={s}: max abs err {errs[-1]:.3g}")
    x = _composite_inputs(CHUNK, n_samples, seed=1)
    # one call an event pair times the wrapper's host work in part; 20
    # calls a pair (as the other kernels are timed) and the profiler's
    # device time read the kernel
    one_call_ms = time_ms(lambda: fused_composite(*x))
    ms = time_ms(lambda: fused_composite(*x), n=21, reps=20)
    device_ms = kernel_device_ms(lambda: fused_composite(*x),
                                 "composite_fwd_kernel")
    plain_ms = time_ms(lambda: composite_reference(*x))
    bound = composite_fwd_bytes(CHUNK, n_samples) / HBM_BYTES_PER_S * 1e3
    log(f"[kernels] composite_fwd R={CHUNK} S={n_samples}: kernel "
        f"{ms:.4f} ms (20 calls an event pair), device time {device_ms:.4f}"
        f" ms, one call an event pair {one_call_ms:.4f} ms; plain "
        f"{plain_ms:.4f} ms; bound {bound:.4f} ms, half the bound's rate "
        f"{2 * bound:.4f} ms")
    report["composite_fwd"] = dict(max_abs_err=max(errs), ms=ms,
                                   plain_ms=plain_ms, bound_ms=bound,
                                   bound_by="bytes", library_ms=None,
                                   device_ms=device_ms,
                                   one_call_ms=one_call_ms)
    del x
    report["composite_bwd"] = check_composite_bwd()

    # H1: 2^20 points at the slice's field shape (8 levels x 4 channels,
    # 2^15 x 128 rows), dense levels, the other two lattice shapes, anchors
    # < 0 throughout
    errs = []
    for p, c, dense, rows_log2 in (
            (1 << 20, 4, 0, 15), (1 << 20, 4, 2, 15), (1 << 20, 4, 2, 13),
            (1 << 18, 2, 0, 15), (1 << 18, 8, 0, 15), (1000, 4, 0, 15)):
        args = _hash_inputs(p, c, n_volumes=16, seed=p + c + dense,
                            rows_log2=rows_log2)
        pack = pack_for_channels(c)
        got = packed_hash_encode(*args, c, pack, dense)
        want = packed_hash_encode_raw(*args, c, pack, dense)
        torch.cuda.synchronize()
        assert_close([got], [want], f"packed hash P={p} C={c} dense={dense}",
                     atol=H1_ATOL)
        if not bool((got[args[4] < 0] == 0).all()):
            raise AssertionError("packed hash: masked anchors not zeroed")
        errs.append(max_err([got], [want]))
        log(f"[kernels] packed_hash_fwd P={p} C={c} dense_levels={dense} "
            f"rows=2^{rows_log2}: max abs err {errs[-1]:.3g}")
    del got, want, args
    torch.cuda.empty_cache()
    report["packed_hash_fwd"] = dict(max_abs_err=max(errs))
    report["packed_hash_bwd"] = dict(max_abs_err=check_hash_bwd())
    report["packed_hash_routed"] = dict(max_abs_err=check_hash_routed())
    fwd_err, bwd_err = check_hash_anchored()
    report["hash_anchored_fwd"] = dict(max_abs_err=fwd_err)
    report["hash_anchored_bwd"] = dict(max_abs_err=bwd_err)
    return report


def _counted():
    """The wrappers that carry launch counters."""
    from gfnerf_tpu_torch.fields.hash_encoding import hash_encode
    from gfnerf_tpu_torch.fields.packed_hash import (
        packed_hash_encode, packed_hash_encode_routed)
    from gfnerf_tpu_torch.ops.composite import fused_composite
    from gfnerf_tpu_torch.ops.scan_march import scan_march
    from gfnerf_tpu_torch.ops.temporal_grid import (temporal_grid_bwd,
                                                    temporal_grid_fwd)

    return fused_composite, packed_hash_encode, packed_hash_encode_routed, \
        hash_encode, scan_march, temporal_grid_fwd, temporal_grid_bwd


def launch_counts() -> dict:
    composite, packed, routed, anchored, march, t_fwd, t_bwd = _counted()
    return {"composite_fwd": composite.launches,
            "composite_bwd": composite.bwd_launches,
            "packed_hash_fwd": packed.launches,
            "packed_hash_bwd": packed.bwd_launches,
            "packed_hash_routed": routed.launches,
            "hash_anchored_fwd": anchored.launches,
            "hash_anchored_bwd": anchored.bwd_launches,
            "scan_march": march.launches,
            "temporal_grid_fwd": t_fwd.launches,
            "temporal_grid_bwd": t_bwd.launches}


def reset_launch_counts() -> None:
    composite, packed, routed, anchored, march, t_fwd, t_bwd = _counted()
    march.launches = t_fwd.launches = t_bwd.launches = 0
    composite.launches = composite.bwd_launches = 0
    packed.launches = packed.bwd_launches = packed.bwd_calls = 0
    routed.launches = 0
    anchored.launches = anchored.bwd_launches = anchored.bwd_calls = 0
    anchored.calls = anchored.base_calls = 0


def check_launches(what: str, launches: dict, expected: dict) -> None:
    """Fail unless every kernel launched as often as ``expected`` says (a
    kernel it does not name: never)."""
    want = {name: expected.get(name, 0) for name in launches}
    log(f"[{what}] launches {launches}")
    if launches != want:
        raise AssertionError(f"{what}: launches {launches}, expected {want}")


class plain_wrappers:
    """Within the block the model runs the plain autograd pairs (plain
    forward and plain backward) in place of the kernel wrappers; on exit
    it fails if any kernel launched meanwhile."""

    def __enter__(self):
        from gfnerf_tpu_torch.fields import field as field_mod
        from gfnerf_tpu_torch.fields.hash_encoding import plain_hash_encode
        from gfnerf_tpu_torch.fields.packed_hash import (
            plain_packed_hash_encode, plain_packed_hash_encode_routed)
        from gfnerf_tpu_torch.models import gfnerf as model_mod
        from gfnerf_tpu_torch.ops.composite import plain_fused_composite
        from gfnerf_tpu_torch.sampler.perssampler import get_samples

        self.patched = [
            (model_mod, "fused_composite", plain_fused_composite),
            (model_mod, "scan_march", get_samples),
            (field_mod, "packed_hash_encode", plain_packed_hash_encode),
            (field_mod, "packed_hash_encode_routed",
             plain_packed_hash_encode_routed),
            (field_mod, "hash_encode", plain_hash_encode)]
        self.saved = [getattr(mod, name) for mod, name, _ in self.patched]
        for mod, name, plain in self.patched:
            setattr(mod, name, plain)
        self.before = launch_counts()
        return self

    def __exit__(self, *exc):
        for (mod, name, _), saved in zip(self.patched, self.saved):
            setattr(mod, name, saved)
        after = launch_counts()
        if exc[0] is None and after != self.before:
            raise AssertionError(f"plain run launched kernels: launch counts "
                                 f"{self.before} -> {after}")
        return False


def check_rendered(out: dict, what: str, rgb_shape: tuple) -> float:
    """A render's outputs: finite, accumulation in [0, 1], rgb of the
    given shape.  Returns the share of rays with accumulation > 1e-3."""
    import torch

    for k, v in out.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"{what}: non-finite {k}")
    acc = out["accumulation"]
    if float(acc.min()) < 0 or float(acc.max()) > 1 + 1e-5:
        raise AssertionError(f"{what}: accumulation outside [0, 1]")
    if tuple(out["rgb"].shape) != rgb_shape:
        raise AssertionError(f"{what}: rgb shape {tuple(out['rgb'].shape)}")
    return float((acc > 1e-3).float().mean())


def phase_render(wl):
    """The render path: 4 training views and one 1920x1080 frame, counted;
    one chunk against the plain versions; H1 timed on a frame chunk."""
    import torch

    from gfnerf_tpu_torch.models.gfnerf import make_render_fn
    from gfnerf_tpu_torch.render_bench import (CHUNK, FRAME_WH, N_VIEWS,
                                               frame_rays, render_camera,
                                               render_rays)

    dev = torch.device("cuda")
    scfg = wl["scfg"]
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    cams = wl["cams"]
    field, oct_dev = wl["field"], wl["oct_dev"]
    render_fn = make_render_fn(wl["mcfg"], scfg)
    fo, fd = frame_rays(c2w[0], *FRAME_WH, dev)
    n_frame = fo.shape[0]
    n_view_chunks = N_VIEWS * -(-(w * h) // CHUNK)
    n_frame_chunks = -(-n_frame // CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the render path, counted ----
    reset_launch_counts()
    t0 = time.perf_counter()
    views = [render_camera(render_fn, field, oct_dev, cams,
                           i * len(c2w) // N_VIEWS, CHUNK)
             for i in range(N_VIEWS)]
    torch.cuda.synchronize()
    t_views = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = render_rays(render_fn, field, oct_dev, fo, fd, 0, CHUNK)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()

    expected = n_view_chunks + n_frame_chunks
    log(f"[render] {N_VIEWS} views {w}x{h} in {t_views:.3f}s; frame "
        f"{FRAME_WH[0]}x{FRAME_WH[1]} ({n_frame_chunks} chunks of {CHUNK}) "
        f"in {t_frame:.3f}s = {t_frame:.4f} s/frame, "
        f"{n_frame / t_frame:.1f} rays/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    check_launches("render", launches, {"composite_fwd": expected,
                                        "packed_hash_fwd": expected})
    for i, out in enumerate(views):
        check_rendered(out, f"view {i}", (h, w, 3))
    hit = check_rendered(frame, "frame", (n_frame, 3))
    log(f"[render] outputs finite, accumulation in [0, 1]; frame rays with "
        f"accumulation > 1e-3: {hit:.4f}; mean rgb "
        f"{frame['rgb'].mean(0).tolist()}")
    if hit <= 0.0:
        raise AssertionError("frame: no ray reached the scene")

    # ---- one chunk through the plain versions ----
    mid = n_frame // 2 - COMPARE_RAYS // 2
    o, d = fo[mid:mid + COMPARE_RAYS], fd[mid:mid + COMPARE_RAYS]
    got = render_fn(field, oct_dev, o, d, 0)
    with plain_wrappers():
        want = render_fn(field, oct_dev, o, d, 0)
    torch.cuda.synchronize()
    errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
    log(f"[render] {COMPARE_RAYS}-ray chunk, kernels vs plain versions: max "
        f"abs err {errs} (atol {SLICE_ATOL})")
    for k, e in errs.items():
        if not e <= SLICE_ATOL:
            raise AssertionError(f"render chunk {k}: kernels vs plain {e}")
    stats = {"s_per_frame": t_frame, "rays_per_s": n_frame / t_frame,
             "peak_bytes": peak}
    return launches, stats, time_encode_on_chunk(wl, fo, fd)


def _marched_points(wl, o, d, noise, fineness: float = 1.0):
    """The encode's inputs for one ray batch: normalized warped points and
    anchors (P,), as field_density forms them."""
    import torch

    from gfnerf_tpu_torch.models.gfnerf import sample_rays
    from gfnerf_tpu_torch.sampler.perssampler import warp_points

    oct_dev, scfg = wl["oct_dev"], wl["scfg"]
    with torch.no_grad():
        samples = sample_rays(oct_dev, o, d, noise, fineness, scfg)
        anc = samples.trans_idx.reshape(-1)
        warp = warp_points(oct_dev, anc.clamp(0, oct_dev.w2xz.shape[0] - 1),
                           samples.world_pts.reshape(-1, 3))
    return (warp + 1.5) * (1.0 / 3.0), anc


def hash_fwd_bytes(p, n_levels, n_channels, table_numel) -> int:
    """H1: output, points, anchors, and one read of the f32 table (the
    bf16 copy that the wrapper writes is not work the function needs)."""
    return 4 * p * n_levels * n_channels + 12 * p + 4 * p + 4 * table_numel


def hash_bwd_bytes(p, n_levels, n_channels, table_numel) -> int:
    """H2 (and H5): upstream gradient, points, anchors, and the f32
    gradient written once."""
    return 4 * p * n_levels * n_channels + 12 * p + 4 * p + 4 * table_numel


def time_encode_on_chunk(wl, fo, fd) -> dict:
    """The hash encode, kernel and plain version, on the inputs one frame
    chunk gives it: 32768 rays x 384 samples of marched, warped points."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (_packed_hash_encode_cuda,
                                                     pack_for_channels,
                                                     packed_hash_encode_raw)
    from gfnerf_tpu_torch.render_bench import CHUNK

    field, scfg = wl["field"], wl["scfg"]
    c = wl["fcfg"].features_per_level
    mid = (fo.shape[0] - CHUNK) // 2
    o, d = fo[mid:mid + CHUNK], fd[mid:mid + CHUNK]
    pts, anc = _marched_points(
        wl, o, d, torch.ones((CHUNK, scfg.max_samples), device=o.device))
    with torch.no_grad():
        args = (field.global_feat, field.global_prim, field.global_bias, pts,
                anc, c, pack_for_channels(c), 0)
        got = _packed_hash_encode_cuda(*args)
        want = packed_hash_encode_raw(*args)
        torch.cuda.synchronize()
        assert_close([got], [want], "packed hash on a frame chunk",
                     atol=H1_ATOL)
        if not torch.equal(got, want):
            raise AssertionError("packed hash on a frame chunk: not equal to "
                                 "the plain version bit for bit")
        err = max_err([got], [want])
        del got, want
        ms = time_ms(lambda: _packed_hash_encode_cuda(*args))
        plain_ms = time_ms(lambda: packed_hash_encode_raw(*args), n=3)
        kernel_ms, levels = hash_fwd_levels(args)
    p = pts.shape[0]
    table = field.global_feat
    bound = hash_fwd_bytes(p, table.shape[0], c, table.numel()) \
        / HBM_BYTES_PER_S * 1e3
    log(f"[render] packed_hash_fwd on a frame chunk (P={p}, "
        f"{int((anc >= 0).sum())} valid): max abs err {err:.3g}; kernel "
        f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound:.4f} ms")
    log(f"[render] packed_hash_fwd on a frame chunk, given the kernel's "
        f"input types (no copies): {kernel_ms:.4f} ms; each level alone: "
        f"{[round(t, 4) for t in levels]} ms (sum {sum(levels):.4f})")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "frame_chunk_kernel_typed_ms": kernel_ms,
            "frame_chunk_level_ms": levels}


def kernel_typed(args, table=None) -> tuple:
    """The hash wrappers' arguments with the tensors the kernels read
    already in their types (int32 primes and anchors, and the table
    ``table`` of H1 in bf16), so that the wrapper copies nothing: a time
    taken on them is the kernel's alone."""
    import torch

    a = list(args)
    a[1], a[4] = a[1].to(torch.int32), a[4].to(torch.int32)
    if table is not None:
        a[0] = table.detach().to(torch.bfloat16)
    return tuple(a)


def hash_fwd_levels(args) -> tuple:
    """H1 on the given inputs in the kernel's types (10 launches per
    sample): whole, and level by level, each launch over one level alone
    held against that level's columns of the whole.  Returns (whole ms,
    per-level ms)."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import _packed_hash_encode_cuda

    typed = kernel_typed(args, table=args[0])
    c = args[5]
    full = _packed_hash_encode_cuda(*typed)
    whole_ms = time_ms(lambda: _packed_hash_encode_cuda(*typed), reps=10)
    times = []
    for l in range(args[0].shape[0]):
        out = _packed_hash_encode_cuda(*typed, level=l)
        torch.cuda.synchronize()
        if not torch.equal(out, full[:, l * c:(l + 1) * c]):
            raise AssertionError(f"packed_hash_fwd level {l} alone differs")
        times.append(time_ms(
            lambda: _packed_hash_encode_cuda(*typed, level=l), reps=10))
    return whole_ms, times


def hash_bwd_levels(args) -> list:
    """H2 level by level on the given inputs: the atomics the kernel
    counted at each level (the counters', the cursors' and the long rows'
    64-bit reductions), held against packed_hash_bwd_reductions (the same
    reckoned on the host), and the time of a call over that level alone
    (its four passes and zero-fill; 10 calls per sample; inputs in the
    kernel's types), whose result must equal that level of the whole
    call's bit for bit."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        _packed_hash_backward_cuda, packed_hash_bwd_reductions)

    g, prim, bias, pts, anc, n_rows, width, c, pack, dense = args
    n_levels = prim.shape[0]
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    full = _packed_hash_backward_cuda(*args, red_ops=ops)
    want = packed_hash_bwd_reductions(prim, bias, pts, anc, n_rows, c, pack,
                                      dense)
    torch.cuda.synchronize()
    if ops.tolist() != want.tolist():
        raise AssertionError(f"packed_hash_bwd: atomics per level "
                             f"{ops.tolist()}, reckoned on the host "
                             f"{want.tolist()}")
    per_level = []
    typed = kernel_typed(args)
    for l in range(n_levels):
        largs = (g[:, l * c:(l + 1) * c].contiguous(), *typed[1:])
        grad = _packed_hash_backward_cuda(*largs, level=l)
        torch.cuda.synchronize()
        if not torch.equal(grad[0], full[l]):
            raise AssertionError(f"packed_hash_bwd level {l} alone differs "
                                 f"from the whole call's")
        ms = time_ms(lambda: _packed_hash_backward_cuda(*largs, level=l),
                     reps=10)
        per_level.append({"level": l, "reductions": int(ops[l]),
                          "ms": ms})
        log(f"[train] packed_hash_bwd level {l} alone: {int(ops[l])} "
            f"atomics (host reckoning agrees), {ms:.4f} ms")
    return per_level


def host_syncs(fn) -> dict:
    """Counts of the CUDA runtime calls that wait for the device
    (profiling.HOST_WAITS) that fn() makes, from a torch.profiler trace."""
    import torch

    from gfnerf_tpu_torch.utils.profiling import HOST_WAITS

    torch.cuda.synchronize()
    counts, _ = profiled_counts(
        fn, lambda e: e.key if e.key in HOST_WAITS else None)
    return {k: n for k, (n, _) in counts.items()}


def encode_span_adds(fn) -> list:
    """The names of the PyTorch additions (aten::add, aten::add_) that fn()
    runs inside the model's ``gfnerf/encode`` spans, from a torch.profiler
    trace of the host: the residual sum of two encodes is the encode
    kernel's own, so there must be none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
        torch.cuda.synchronize()
    events = list(prof.events())
    spans = [e.time_range for e in events if e.name == "gfnerf/encode"]
    if not spans:
        raise AssertionError("no gfnerf/encode span in the trace")
    return [e.name for e in events if e.name in ("aten::add", "aten::add_")
            and any(sp.start <= e.time_range.start
                    and e.time_range.end <= sp.end for sp in spans)]


def check_fused_residual(what, fn) -> None:
    """Fail if fn(), a call of the model at the block stage, adds its two
    encodes in a pass of its own."""
    adds = encode_span_adds(fn)
    log(f"[{what}] additions inside the encode span: {adds or 'none'} (the "
        f"residual sum is the encode kernel's write-back)")
    if adds:
        raise AssertionError(f"{what}: a separate add in the encode span")


def peak_extra_bytes(fn) -> int:
    """The device memory fn() holds at its peak beyond what was allocated
    before it."""
    import torch

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    del out
    return peak - before


def check_encode_with_base(what, encode, plain, base) -> None:
    """An encode given a base against ``base + plain()``, bit for bit: out
    of place (the base unchanged) and in place (the result is the base's
    own storage).  ``encode(base, in_place)`` runs the kernel."""
    import torch

    want = base + plain()
    keep = base.clone()
    got = encode(keep, False)
    torch.cuda.synchronize()
    if not torch.equal(keep, base):
        raise AssertionError(f"{what}: the base changed out of place")
    err = max_err([got], [want])
    if not torch.equal(got, want):
        raise AssertionError(f"{what} with a base: max abs err {err}, not "
                             f"equal to base + plain bit for bit")
    del got
    got = encode(keep, True)
    torch.cuda.synchronize()
    if got.data_ptr() != keep.data_ptr() or not torch.equal(got, want):
        raise AssertionError(f"{what} with a base, in place: not base + "
                             f"plain in the base's storage")
    log(f"[kernels] {what} with a base: equal to base + plain bit for bit "
        f"(max abs err {err}), out of place and in place")


def time_hash_on_batch(wl, batch, noise) -> tuple:
    """H1 and H2 on the points one train batch gives them (8192 rays x 384
    samples): H1 against its plain version; H2 against its plain version
    and index_add_ of the same precomputed (rows, payload) terms, with a
    random upstream gradient, and level by level; the host syncs of one
    encode forward and backward with the level constants built at every
    launch (the cache bypassed) and reused.  Returns (H1's, H2's report)."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.fields import packed_hash as ph

    field = wl["field"]
    c = wl["fcfg"].features_per_level
    pack = ph.pack_for_channels(c)
    rays = generate_rays_multi(wl["cams"], batch["camera_indices"],
                               batch["coords"])
    pts, anc = _marched_points(wl, rays["origins"], rays["directions"], noise)
    n_levels, n_rows, width = field.global_feat.shape
    p = pts.shape[0]
    n_valid = int((anc >= 0).sum())

    # ---- H1 ----
    with torch.no_grad():
        fargs = (field.global_feat, field.global_prim, field.global_bias,
                 pts, anc, c, pack, 0)
        got = ph._packed_hash_encode_cuda(*fargs)
        want = ph.packed_hash_encode_raw(*fargs)
        torch.cuda.synchronize()
        assert_close([got], [want], "packed hash on a train batch",
                     atol=H1_ATOL)
        if not torch.equal(got, want):
            raise AssertionError("packed hash on a train batch: not equal "
                                 "to the plain version bit for bit")
        if not bool((got[anc < 0] == 0).all()):
            raise AssertionError("packed hash: masked anchors not zeroed")
        fwd_err = max_err([got], [want])
        del want
        fwd_ms = time_ms(lambda: ph._packed_hash_encode_cuda(*fargs), n=21)
        fwd_plain_ms = time_ms(lambda: ph.packed_hash_encode_raw(*fargs), n=3)
        fwd_kernel_ms, fwd_levels = hash_fwd_levels(fargs)
        # the focal step's second encode: added to the first (here: got)
        check_encode_with_base(
            "packed_hash_fwd on a train batch",
            lambda b, in_place: ph.packed_hash_encode(*fargs, b, in_place),
            lambda: ph.packed_hash_encode_raw(*fargs), got)
        typed = kernel_typed(fargs, table=fargs[0])
        sum_ms = time_ms(lambda: got + ph.packed_hash_encode(*typed), n=21)
        based_ms = time_ms(lambda: ph.packed_hash_encode(*typed, got), n=21)
        buf = got.clone()
        inplace_ms = time_ms(lambda: ph.packed_hash_encode(*typed, buf, True),
                             n=21)
        del got, buf
    fwd_bound = hash_fwd_bytes(p, n_levels, c, field.global_feat.numel()) \
        / HBM_BYTES_PER_S * 1e3
    based_bound = fwd_bound + 4 * p * n_levels * c / HBM_BYTES_PER_S * 1e3
    log(f"[train] packed_hash_fwd on a train batch, added to a base (P, "
        f"{n_levels * c}) f32, in the kernel's input types: encode then a "
        f"separate add {sum_ms:.4f} ms; the kernel given the base "
        f"{based_ms:.4f} ms, in place {inplace_ms:.4f} ms; bound of either "
        f"{based_bound:.4f} ms")
    log(f"[train] packed_hash_fwd on a train batch (P={p}, {n_valid} valid): "
        f"max abs err {fwd_err:.3g}; kernel {fwd_ms:.4f} ms, plain "
        f"{fwd_plain_ms:.4f} ms, bound {fwd_bound:.4f} ms; given the "
        f"kernel's input types: {fwd_kernel_ms:.4f} ms; each level alone: "
        f"{[round(t, 4) for t in fwd_levels]} ms (sum {sum(fwd_levels):.4f})")

    # ---- H2 ----
    gen = torch.Generator(device="cuda").manual_seed(5)
    g = torch.randn((p, n_levels * c), generator=gen, device="cuda")
    args = (g, field.global_prim, field.global_bias, pts, anc, n_rows, width,
            c, pack, 0)
    check_table_grad("packed_hash_bwd on a train batch",
                     ph._packed_hash_backward_cuda,
                     ph.packed_hash_backward_reference, args)
    err = 0.0
    parts = check_call_counts(
        "train", lambda: ph._packed_hash_backward_cuda(*args),
        ph.packed_hash_encode, "packed_hash_bwd",
        ph.table_grad_launches(p), ph.table_grad_memsets(p))
    ms = time_ms(lambda: ph._packed_hash_backward_cuda(*args), n=11)
    turns = against_parent("train", "packed_hash_bwd on a train batch",
                           "h2", args)
    plain_ms = time_ms(lambda: ph.packed_hash_backward_reference(*args), n=3)
    terms = list(ph.packed_hash_scatter_terms(*args))
    rows = torch.cat([t[0] for t in terms])
    payload = torch.cat([t[1] for t in terms])
    del terms
    n_out = n_levels * n_rows * width // c
    library_ms = time_ms(lambda: torch.zeros(
        (n_out, c), device="cuda").index_add_(0, rows, payload), n=5)
    del rows, payload
    torch.cuda.empty_cache()
    bound = hash_bwd_bytes(p, n_levels, c, field.global_feat.numel()) \
        / HBM_BYTES_PER_S * 1e3
    log(f"[train] packed_hash_bwd on a train batch (P={p}, {n_valid} valid): "
        f"equal to the plain version bit for bit, also called again and on "
        f"the points permuted; kernel {ms:.4f} ms, plain {plain_ms:.4f} ms,"
        f" index_add_ {library_ms:.4f} ms, bound {bound:.4f} ms")
    levels = hash_bwd_levels(args)
    n_red = sum(x["reductions"] for x in levels)
    log(f"[train] packed_hash_bwd: {n_red} atomics in all (counters, "
        f"cursors, long rows' 64-bit reductions; {n_valid * n_levels} "
        f"records of valid (point, level) pairs); levels alone sum to "
        f"{sum(x['ms'] for x in levels):.4f} ms")

    # ---- host syncs of one encode forward and backward ----
    feat = field.global_feat.detach().clone().requires_grad_(True)
    gout = torch.ones((p, n_levels * c), device="cuda")

    def encode_fwd_bwd():
        out = ph.packed_hash_encode(feat, field.global_prim,
                                    field.global_bias, pts, anc, c, pack)
        out.backward(gout)
        torch.cuda.synchronize()

    encode_fwd_bwd()
    ph._level_constants.cache_clear()   # the next launch builds them anew
    syncs = {"cold": host_syncs(encode_fwd_bwd),
             "cached": host_syncs(encode_fwd_bwd)}
    log(f"[train] host calls in one encode forward + backward (one final "
        f"cudaDeviceSynchronize included): level constants built at its "
        f"first launch {syncs['cold']}, cached {syncs['cached']}")
    del feat, gout
    fwd = {"max_abs_err": fwd_err, "train_batch_ms": fwd_ms,
           "train_batch_plain_ms": fwd_plain_ms,
           "train_batch_bound_ms": fwd_bound,
           "train_batch_kernel_typed_ms": fwd_kernel_ms,
           "train_batch_level_ms": fwd_levels,
           "train_batch_then_add_ms": sum_ms,
           "train_batch_with_base_ms": based_ms,
           "train_batch_with_base_in_place_ms": inplace_ms,
           "train_batch_with_base_bound_ms": based_bound}
    bwd = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
           "per_level": levels, "host_syncs": syncs, "parts": parts,
           **turns}
    return fwd, bwd


def table_grad_launches(wl, n_points: int = 1) -> int:
    """Launches of one table-gradient call of the workload's field on
    ``n_points`` points: H2's four (the count, the scan, the scatter, the
    owner pass) in the packed layout; in the anchored layout H5's, the
    level maxima, then the merge and the conversion of all levels at once
    (a small call) or of each level in turn."""
    from gfnerf_tpu_torch.fields import hash_encoding, packed_hash

    fc = wl["fcfg"]
    if fc.hash_layout == "packed":
        return packed_hash.table_grad_launches(n_points)
    return hash_encoding.table_grad_launches(
        fc.num_levels, n_points, 1 << fc.log2_hashmap_size,
        fc.features_per_level)


def step_draws(wl, gen):
    """March noise and S3IM permutations for one step, drawn once so that
    two steps can share them."""
    import torch

    from gfnerf_tpu_torch.model_components.losses import s3im_permutations
    from gfnerf_tpu_torch.train_bench import RAYS

    noise = torch.rand((RAYS, wl["scfg"].max_samples), generator=gen,
                       device="cuda") + 0.5
    return noise, s3im_permutations(RAYS, generator=gen, device="cuda")


def step_from_copy(wl, batch, noise, perms, focal_block=None, plain=False,
                   prop_u=None):
    """One train step from a deep copy of the workload's field, optimizer
    state and octree (the workload stays as it is): an init-stage step, or
    with ``focal_block`` a block-stage step on that block from a fresh
    optimizer state; with ``plain`` through the plain autograd pairs;
    ``prop_u``: the proposal branch's resampling draws.
    Returns (the loss, computed before the update; the new TrainState)."""
    import contextlib
    import copy

    import torch

    from gfnerf_tpu_torch.models.gfnerf import TrainState, init_train_state

    focal = focal_block is not None
    field = copy.deepcopy(wl["field"])
    state = (init_train_state(field, wl["tx"]) if focal else
             TrainState(field=field,
                        opt_state=copy.deepcopy(wl["state"].opt_state),
                        step=wl["state"].step))
    with plain_wrappers() if plain else contextlib.nullcontext():
        state, _, metrics, _ = wl["focal_step_fn" if focal else "step_fn"](
            state, copy.deepcopy(wl["oct_dev"]), wl["cams"], batch,
            wl["fineness"], noise=noise, s3im_perms=perms,
            active_block=focal_block or 0, prop_u=prop_u)
    torch.cuda.synchronize()
    return float(metrics["loss"]), state


def compare_step(wl, what, batch, noise, perms, focal_block=None,
                 prop_u=None) -> float:
    """One step from a common state with the kernels and with the plain
    autograd pairs (no kernel may launch in it): the loss to
    TRAIN_LOSS_RTOL and the gradients to TRAIN_GRAD_TOL of the group's
    largest.  Init stage: the MLPs' (the semantics heads' included) and
    the global table's gradients, and the camera tangents' where the field
    has them; none for the block tables.  Block stage: the active table's
    gradient, read from Adam's first moment of a fresh state (mu = (1 -
    b1) g), none for any frozen parameter.  On the proposal branch the
    probe is in "fields", and ``prop_u`` gives both steps the same
    resampling draws.  Under a clip (the optimizer's ``max_norm``) also
    each group's pre-clip norm and Adam's new first moments (the clipped
    gradients' mix), to TRAIN_GRAD_TOL of their largest.
    Returns the kernels' loss."""
    import torch

    from gfnerf_tpu_torch.engine.optimizers import field_param_grads

    focal = focal_block is not None
    clip = wl["tx"].cfg.max_norm is not None
    outs, clipped = {}, {}
    for kind in ("kernels", "plain"):
        loss, state = step_from_copy(wl, batch, noise, perms, focal_block,
                                     plain=kind == "plain", prop_u=prop_u)
        if clip:
            clipped[kind] = ({g: float(v) for g, v in
                              wl["tx"].grad_norms.items()},
                             state.opt_state.mu)
        grads = field_param_grads(state.field)
        if focal:
            if any(g is not None for gs in grads.values() for g in gs):
                raise AssertionError(f"{what}: a frozen parameter got a "
                                     f"gradient")
            b1 = wl["tx"].cfg.adam_b1
            grads = {"block": [state.opt_state.mu["block"][0] / (1.0 - b1)]}
        elif grads["block"][0] is not None:
            raise AssertionError("the block table got a gradient at init")
        outs[kind] = (loss, grads)
    (loss_k, grads_k), (loss_p, grads_p) = outs["kernels"], outs["plain"]
    rel = abs(loss_k - loss_p) / abs(loss_p)
    log(f"[{what}] one step, kernels vs plain: loss {loss_k:.7f} vs "
        f"{loss_p:.7f} (rel {rel:.3g}, tol {TRAIN_LOSS_RTOL})")
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{what} step loss: kernels vs plain rel {rel}")
    names = ("block",) if focal else (
        "fields", "base_encoding_init",
        *(("camera_opt",) if grads_p["camera_opt"] else ()))
    for name in names:
        scale = max(float(g.abs().max()) for g in grads_p[name])
        err = max(float((a - b).abs().max())
                  for a, b in zip(grads_k[name], grads_p[name]))
        log(f"[{what}] {name} gradients, kernels vs plain: max abs err "
            f"{err:.3g}, largest {scale:.3g} (tol {TRAIN_GRAD_TOL} of it)")
        if not (scale > 0 and err <= TRAIN_GRAD_TOL * scale):
            raise AssertionError(f"{what} {name} gradients: kernels vs "
                                 f"plain {err} of {scale}")
    if clip:
        (norms_k, mu_k), (norms_p, mu_p) = clipped["kernels"], \
            clipped["plain"]
        for name in names:
            rel = abs(norms_k[name] - norms_p[name]) / norms_p[name]
            scale = max(float(m.abs().max()) for m in mu_p[name])
            err = max(float((a - b).abs().max())
                      for a, b in zip(mu_k[name], mu_p[name]))
            log(f"[{what}] {name} under the clip at "
                f"{wl['tx'].cfg.max_norm}: pre-clip norm {norms_k[name]:.6g}"
                f" vs {norms_p[name]:.6g} (rel {rel:.3g}); Adam's first "
                f"moments max abs err {err:.3g}, largest {scale:.3g}")
            if not (rel <= TRAIN_GRAD_TOL and scale > 0
                    and err <= TRAIN_GRAD_TOL * scale):
                raise AssertionError(f"{what} {name} under the clip: norms "
                                     f"rel {rel}, moments {err} of {scale}")
    del outs, grads_k, grads_p, clipped
    torch.cuda.empty_cache()
    return loss_k


def phase_train(wl):
    """The train path: TRAIN_STEPS init-stage steps at 8192 rays through
    make_train_step, counted (one warm-up, TIMED_STEPS timed, the rest for
    the loss check); the state checked; one step from a common state
    against the plain autograd pairs; H2 timed on a train batch."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.engine.optimizers import (field_param_grads,
                                                    field_param_groups)
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch, run_steps

    dev = torch.device("cuda")
    field = wl["field"]
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [make_batch(wl["images"], RAYS, seed, dev)
               for seed in range(TRAIN_STEPS + 1)]
    groups0 = {k: [p.detach().clone() for p in ps]
               for k, ps in field_param_groups(field).items()}
    block0 = field.block_feats.detach().clone()
    oct0 = {k: getattr(wl["oct_dev"], k).clone()
            for k in ("weight_stats", "alpha_stats", "visit_cnt")}
    torch.cuda.synchronize()

    # ---- the train path, counted ----
    reset_launch_counts()
    warm, losses = run_steps(wl, batches[:1], gen)
    torch.cuda.reset_peak_memory_stats()
    times, more = run_steps(wl, batches[1:1 + TIMED_STEPS], gen)
    peak = torch.cuda.max_memory_allocated()
    _, rest = run_steps(wl, batches[1 + TIMED_STEPS:TRAIN_STEPS], gen)
    launches = launch_counts()
    bwd_calls = packed_hash_encode.bwd_calls
    losses += more + rest
    dt = float(np.mean(times))
    log(f"[train] warm-up step {warm[0]:.3f}s; {TIMED_STEPS} steps of {RAYS} "
        f"rays: {dt:.4f} s/step (mean; {', '.join(f'{t:.4f}' for t in times)})"
        f" = {RAYS / dt:.1f} rays/s; peak memory {peak / 2**30:.2f} GiB")
    # H2's C entry point: the count, the scan, the scatter and the owner
    # pass (csrc/packed_hash_bwd.cu), after two zero-fills
    h2_groups = table_grad_launches(wl)
    check_launches("train", launches, {
        "composite_fwd": TRAIN_STEPS, "composite_bwd": TRAIN_STEPS,
        "packed_hash_fwd": TRAIN_STEPS,
        "packed_hash_bwd": TRAIN_STEPS * h2_groups})
    log(f"[train] each kernel once per step, H2 in {bwd_calls} calls of "
        f"{h2_groups} launches")
    if bwd_calls != TRAIN_STEPS:
        raise AssertionError(f"H2: {bwd_calls} calls in {TRAIN_STEPS} steps")

    # ---- the state after training ----
    log(f"[train] losses {[round(x, 5) for x in losses]}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite training loss")
    first, last = losses[0], float(np.mean(losses[-5:]))
    if not last < first:
        raise AssertionError(f"loss did not fall: {first} -> mean of the last "
                             f"5 {last}")
    for name, gs in field_param_grads(field).items():
        for i, g in enumerate(gs):
            if g is not None and not bool(torch.isfinite(g).all()):
                raise AssertionError(f"non-finite gradient {name}[{i}]")
    for name, ps in field_param_groups(field).items():
        if name == "block":
            continue
        for i, (p, p0) in enumerate(zip(ps, groups0[name])):
            if torch.equal(p, p0):
                raise AssertionError(f"{name}[{i}] did not change")
    if not torch.equal(field.block_feats, block0):
        raise AssertionError("block_feats changed at the init stage")
    moved = {k: int((getattr(wl["oct_dev"], k) != v).sum())
             for k, v in oct0.items()}
    log(f"[train] loss {first:.5f} -> {last:.5f} (mean of the last 5); "
        f"global_feat and all {len(groups0['fields'])} MLP/appearance "
        f"tensors changed, block_feats unchanged; octree nodes whose stats "
        f"moved: {moved}")
    if not any(moved.values()):
        raise AssertionError("the occupancy statistics did not move")

    # ---- one step, kernels vs the plain autograd pairs ----
    batch = batches[TRAIN_STEPS]
    noise, perms = step_draws(wl, gen)
    compare_step(wl, "train", batch, noise, perms)
    stats = {"s_per_step": dt, "rays_per_s": RAYS / dt, "peak_bytes": peak,
             "step_seconds": times, "first_loss": first, "last_loss": last,
             "packed_hash_bwd_calls": bwd_calls}
    return launches, stats, time_hash_on_batch(wl, batch, noise)


def phase_focal(wl):
    """The focal (block) stage's train path at the quality configuration,
    residual mode, after the init phase's steps (the frozen groups' Adam
    moments are live): FOCAL_STEPS steps on block 0 from the init phase's
    optimizer state, then, the state made anew as at a split switch,
    FOCAL_STEPS on block 1; counted per block.  Checked: launches per step
    (K1 1, K2 1, H1 2: the frozen global encode and the block's; H2 one
    call of its launches, into the block's table; H3 none); every frozen
    parameter and the other block's table bit-unchanged, the active table
    changed; losses finite; the loss of one fixed batch lower after a
    block's steps than before; one step on block 1, kernels against the
    plain autograd pairs."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.models.gfnerf import init_train_state
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch, run_steps

    dev = torch.device("cuda")
    field = wl["field"]
    gen = torch.Generator(device=dev).manual_seed(1)
    batches = [make_batch(wl["images"], RAYS, 100 + seed, dev)
               for seed in range(2 * FOCAL_STEPS + 1)]
    probe = batches[-1]
    noise, perms = step_draws(wl, gen)
    frozen0 = [p.detach().clone() for name, ps in
               field_param_groups(field).items() if name != "block"
               for p in ps]
    compare_step(wl, "focal", probe, noise, perms, focal_block=1)
    check_fused_residual("focal", lambda: step_from_copy(
        wl, probe, noise, perms, focal_block=1))

    h2_groups = table_grad_launches(wl)
    total, all_times = {}, []
    for block in range(2):
        if block:   # the optimizer state is made anew at a split switch
            wl["state"] = init_train_state(field, wl["tx"])
        stack0 = field.block_feats.detach().clone()
        before, _ = step_from_copy(wl, probe, noise, perms, block)
        reset_launch_counts()
        times, losses = run_steps(
            wl, batches[block * FOCAL_STEPS:(block + 1) * FOCAL_STEPS], gen,
            focal_block=block)
        launches = launch_counts()
        bwd_calls = packed_hash_encode.bwd_calls
        after, _ = step_from_copy(wl, probe, noise, perms, block)
        check_launches(f"focal block {block}", launches, {
            "composite_fwd": FOCAL_STEPS, "composite_bwd": FOCAL_STEPS,
            "packed_hash_fwd": 2 * FOCAL_STEPS,
            "packed_hash_bwd": FOCAL_STEPS * h2_groups})
        if bwd_calls != FOCAL_STEPS:
            raise AssertionError(f"H2: {bwd_calls} calls in {FOCAL_STEPS} "
                                 f"focal steps")
        for name, n in launches.items():
            total[name] = total.get(name, 0) + n
        all_times += times[1:]
        log(f"[focal] block {block}: losses {[round(x, 5) for x in losses]}; "
            f"the probe batch's loss {before:.6f} -> {after:.6f}")
        if not all(np.isfinite(losses)):
            raise AssertionError("non-finite focal loss")
        if not after < before:
            raise AssertionError(f"focal block {block}: the probe batch's "
                                 f"loss did not fall: {before} -> {after}")
        if torch.equal(field.block_feats[block], stack0[block]):
            raise AssertionError(f"block {block}'s table did not change")
        if not torch.equal(field.block_feats[1 - block], stack0[1 - block]):
            raise AssertionError(f"block {1 - block}'s table changed during "
                                 f"block {block}'s steps")
    now = [p for name, ps in field_param_groups(field).items()
           if name != "block" for p in ps]
    if not all(torch.equal(a, b) for a, b in zip(now, frozen0)):
        raise AssertionError("a frozen parameter changed at the block stage")
    dt = float(np.mean(all_times))
    log(f"[focal] {2 * FOCAL_STEPS} steps of {RAYS} rays, {FOCAL_STEPS} per "
        f"block; all {len(frozen0)} frozen tensors and each step's other "
        f"block bit-unchanged, the active tables changed; {dt:.4f} s/step "
        f"(mean without each block's first) = {RAYS / dt:.1f} rays/s")
    return total, {"s_per_step": dt, "rays_per_s": RAYS / dt}


def phase_focal_render(wl):
    """Block-routed rendering with the tables the focal phase trained,
    counted: the 4 training views as ONE mixed chunk (view i in block i mod
    2) and one 1920x1080 frame with a block per ray (one camera, one
    block).  Checked: outputs; K1, H1 and H3 one launch a chunk, nothing
    backward; the mixed chunk's rows against the two one-block renders; a
    chunk of mixed blocks, some -1, against the plain path.  Then H3 timed
    on a frame chunk."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import Cameras
    from gfnerf_tpu_torch.models.gfnerf import make_render_fn
    from gfnerf_tpu_torch.render_bench import (CHUNK, FRAME_WH, N_VIEWS,
                                               frame_rays, mixed_view_rays,
                                               render_rays)

    dev = torch.device("cuda")
    c2w, fx, fy, cx, cy, w, h = wl["cameras"]
    field, oct_dev = wl["field"], wl["oct_dev"]
    n_blocks = wl["fcfg"].n_blocks
    render_fn = make_render_fn(wl["mcfg"], wl["scfg"])
    views = [i * len(c2w) // N_VIEWS for i in range(N_VIEWS)]
    vo, vd, vcam, vblk = mixed_view_rays(wl["cams"], views, n_blocks)
    fo, fd = frame_rays(c2w[0], *FRAME_WH, dev)
    n_frame = fo.shape[0]
    fblk = torch.zeros(n_frame, dtype=torch.int32, device=dev)
    n_chunks = -(-vo.shape[0] // CHUNK) + -(-n_frame // CHUNK)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    # ---- the routed render path, counted ----
    reset_launch_counts()
    t0 = time.perf_counter()
    mixed = render_rays(render_fn, field, oct_dev, vo, vd, vcam, CHUNK, vblk)
    torch.cuda.synchronize()
    t_mixed = time.perf_counter() - t0
    t0 = time.perf_counter()
    frame = render_rays(render_fn, field, oct_dev, fo, fd, 0, CHUNK, fblk)
    torch.cuda.synchronize()
    t_frame = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    log(f"[focal render] {N_VIEWS} views as one mixed chunk of "
        f"{vo.shape[0]} rays in {t_mixed:.3f}s; routed frame "
        f"{FRAME_WH[0]}x{FRAME_WH[1]} in {t_frame:.4f} s/frame, "
        f"{n_frame / t_frame:.1f} rays/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    check_launches("focal render", launches, {
        "composite_fwd": n_chunks, "packed_hash_fwd": n_chunks,
        "packed_hash_routed": n_chunks})
    check_rendered(mixed, "mixed chunk", (vo.shape[0], 3))
    if not check_rendered(frame, "routed frame", (n_frame, 3)) > 0.0:
        raise AssertionError("routed frame: no ray reached the scene")

    # ---- the mixed chunk's rows are the one-block renders' ----
    for b in range(n_blocks):
        one = render_fn(field, oct_dev, vo, vd, vcam, b, True)
        rows = vblk == b
        err = max(float((mixed[k][rows] - one[k][rows]).abs().max())
                  for k in mixed)
        other = float((mixed["rgb"][~rows] - one["rgb"][~rows]).abs().max())
        log(f"[focal render] mixed chunk, block {b}'s rays vs a render with "
            f"that block alone: max abs err {err:.3g} (the other rays "
            f"differ by up to {other:.3g})")
        if not err <= SLICE_ATOL:
            raise AssertionError(f"mixed chunk vs block {b}'s render: {err}")

    # ---- one routed chunk through the plain versions ----
    mid = n_frame // 2 - COMPARE_RAYS // 2
    o, d = fo[mid:mid + COMPARE_RAYS], fd[mid:mid + COMPARE_RAYS]
    blk = (torch.arange(COMPARE_RAYS, device=dev) % n_blocks).to(torch.int32)
    blk[::17] = -1
    got = render_fn(field, oct_dev, o, d, 0, blk, True)
    with plain_wrappers():
        want = render_fn(field, oct_dev, o, d, 0, blk, True)
    torch.cuda.synchronize()
    check_fused_residual("focal render", lambda: render_fn(
        field, oct_dev, o, d, 0, blk, True))
    errs = {k: float((got[k] - want[k]).abs().max()) for k in got}
    log(f"[focal render] {COMPARE_RAYS}-ray routed chunk (mixed blocks, "
        f"some -1), kernels vs plain versions: max abs err {errs} (atol "
        f"{SLICE_ATOL})")
    for k, e in errs.items():
        if not e <= SLICE_ATOL:
            raise AssertionError(f"routed chunk {k}: kernels vs plain {e}")
    stats = {"s_per_frame": t_frame, "rays_per_s": n_frame / t_frame,
             "mixed_chunk_s": t_mixed, "peak_bytes": peak}
    return launches, stats, time_routed_on_chunk(wl, fo, fd)


def time_routed_on_chunk(wl, fo, fd) -> dict:
    """H3, kernel and plain version, on the inputs one frame chunk gives
    it (32768 rays x 384 samples), with the trained tables of both blocks,
    a block per ray (ray i in block i mod 2, every 17th ray -1): equal bit
    for bit, alone and given the global encode as base (the render's form:
    in place).  Timed given the bf16 stack the field keeps: in place on a
    base (its bound reads the base as well), out of place on a base, and
    alone followed by the separate add ``global + routed`` that the base
    replaces, in turns; alone (its bound reads that stack once, 2 bytes
    an element) and given the f32 stack (a bf16 copy per call; its bound
    reads 4 bytes an element); beside them the copy alone, at this stack
    and at the default 10 blocks, the add alone, and the memory the two
    encodes hold at their peak in either form."""
    import torch

    from gfnerf_tpu_torch.fields.packed_hash import (
        pack_for_channels, packed_hash_encode, packed_hash_encode_routed,
        packed_hash_encode_routed_raw)
    from gfnerf_tpu_torch.render_bench import CHUNK

    field, scfg = wl["field"], wl["scfg"]
    c = wl["fcfg"].features_per_level
    mid = (fo.shape[0] - CHUNK) // 2
    o, d = fo[mid:mid + CHUNK], fd[mid:mid + CHUNK]
    s = scfg.max_samples
    pts, anc = _marched_points(wl, o, d,
                               torch.ones((CHUNK, s), device=o.device))
    n_blocks = field.block_feats.shape[0]
    ray_blk = (torch.arange(CHUNK, device=o.device) % n_blocks).to(
        torch.int32)
    ray_blk[::17] = -1
    blk = ray_blk[:, None].expand(CHUNK, s).reshape(-1).contiguous()
    with torch.no_grad():
        stack = field.block_feats.detach()
        bf16 = field.block_tables_bf16()
        tail = (field.block_prims, field.block_biases, pts, anc, blk, c,
                pack_for_channels(c), wl["fcfg"].block_dense_levels)
        got = packed_hash_encode_routed(bf16, *tail)
        want = packed_hash_encode_routed_raw(stack, *tail)
        torch.cuda.synchronize()
        err = max_err([got], [want])
        if not torch.equal(got, want):
            raise AssertionError(
                f"routed encode on a frame chunk: not equal to the plain "
                f"version bit for bit (max abs err {err})")
        masked = (anc < 0) | (blk < 0)
        if not bool((got[masked] == 0).all()):
            raise AssertionError("routed encode: masked points not zeroed")
        if not torch.equal(packed_hash_encode_routed(stack, *tail), want):
            raise AssertionError("routed encode: f32 stack differs")
        largest = float(want.abs().max())
        del want
        ms = time_ms(lambda: packed_hash_encode_routed(bf16, *tail))
        f32_ms = time_ms(lambda: packed_hash_encode_routed(stack, *tail))
        gargs = (field.global_feat, field.global_prim, field.global_bias,
                 pts, anc, c, pack_for_channels(c))
        base = packed_hash_encode(*gargs)
        check_encode_with_base(
            "packed_hash_routed on a frame chunk",
            lambda b, in_place: packed_hash_encode_routed(bf16, *tail, b,
                                                          in_place),
            lambda: packed_hash_encode_routed_raw(stack, *tail), base)
        # separate, fused, fused, separate: the smaller median of each
        buf = base.clone()
        forms = {
            "then_add": lambda: base + packed_hash_encode_routed(bf16, *tail),
            "in_place": lambda: packed_hash_encode_routed(bf16, *tail, buf,
                                                          True),
            "out_of_place": lambda: packed_hash_encode_routed(bf16, *tail,
                                                              base)}
        turns = in_turns(forms, ("then_add", "in_place", "out_of_place",
                                 "in_place", "then_add"))
        then_add_ms, inplace_ms, based_ms = (
            turns[name] for name in ("then_add", "in_place", "out_of_place"))
        based_plain_ms = time_ms(
            lambda: packed_hash_encode_routed_raw(stack, *tail, base), n=3)
        del buf, base
        torch.cuda.empty_cache()
        separate_peak = peak_extra_bytes(
            lambda: packed_hash_encode(*gargs)
            + packed_hash_encode_routed(bf16, *tail))
        fused_peak = peak_extra_bytes(
            lambda: packed_hash_encode_routed(
                bf16, *tail, packed_hash_encode(*gargs), True))
        copy_ms = time_ms(lambda: stack.to(torch.bfloat16))
        ten = stack[:1].expand(10, *stack.shape[1:]).contiguous()
        copy10_ms = time_ms(lambda: ten.to(torch.bfloat16))
        del ten
        plain_ms = time_ms(
            lambda: packed_hash_encode_routed_raw(stack, *tail), n=3)
        other = got.clone()   # two inputs, as the field's sum has
        add_ms = time_ms(lambda: got + other)
        del other
    p = pts.shape[0]
    n_levels = stack.shape[1]
    # output, points, anchors, blocks, and one read of each table in the
    # type the timed call was given
    point_bytes = 4 * p * n_levels * c + 12 * p + 4 * p + 4 * p
    n_bytes = point_bytes + bf16.element_size() * bf16.numel()
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    f32_bytes = point_bytes + stack.element_size() * stack.numel()
    f32_bound = f32_bytes / HBM_BYTES_PER_S * 1e3
    # with a base: its (P, L * C) f32 rows read once as well
    based_bytes = n_bytes + 4 * p * n_levels * c
    based_bound = based_bytes / HBM_BYTES_PER_S * 1e3
    log(f"[focal render] packed_hash_routed on a frame chunk, added to the "
        f"global encode: in place on the base {inplace_ms:.4f} ms (the "
        f"render's form), out of place {based_ms:.4f} ms, alone and then a "
        f"separate add {then_add_ms:.4f} ms; bound of each {based_bound:.4f}"
        f" ms ({based_bytes / 1e6:.1f} MB); plain with a base "
        f"{based_plain_ms:.4f} ms; memory held at the peak of both encodes: "
        f"separate {separate_peak / 2**20:.1f} MiB, fused in place "
        f"{fused_peak / 2**20:.1f} MiB")
    log(f"[focal render] packed_hash_routed on a frame chunk (P={p}, "
        f"{int((~masked).sum())} unmasked, B={n_blocks}, largest output "
        f"{largest:.3g}): equal to the plain version (max abs err {err}); "
        f"kernel alone {ms:.4f} ms given the bf16 stack, bound {bound:.4f} ms "
        f"({n_bytes / 1e6:.1f} MB); {f32_ms:.4f} ms given the f32 stack, "
        f"bound {f32_bound:.4f} ms ({f32_bytes / 1e6:.1f} MB); the bf16 copy "
        f"alone {copy_ms:.4f} ms, of a 10-block stack {copy10_ms:.4f} ms; "
        f"plain {plain_ms:.4f} ms; the residual add of two (P, "
        f"{n_levels * c}) f32 encodes alone {add_ms:.4f} ms")
    # the kernels line reports the render's form: in place on a base
    return {"max_abs_err": err, "ms": inplace_ms, "plain_ms": based_plain_ms,
            "bound_ms": based_bound, "bound_by": "bytes", "library_ms": None,
            "with_base_out_of_place_ms": based_ms,
            "then_separate_add_ms": then_add_ms,
            "no_base_ms": ms, "no_base_plain_ms": plain_ms,
            "no_base_bound_ms": bound,
            "f32_stack_ms": f32_ms, "f32_stack_bound_ms": f32_bound,
            "bf16_copy_ms": copy_ms, "bf16_copy_10_blocks_ms": copy10_ms,
            "residual_add_ms": add_ms,
            "encodes_peak_separate_bytes": separate_peak,
            "encodes_peak_fused_bytes": fused_peak}


def time_anchored_fwd(table, addr) -> dict:
    """H4 on one parity train batch: equal to the plain version bit for bit
    from the f32 table and from its bf16 copy, alone and on a base (in
    place and not), and at 1, 2, 4, 8 and 16 levels a launch.  Timed, 10
    calls per event pair: the wrapper call on the f32 table as the train
    step makes it, against the bf16 copy followed by the kernel on it and
    against the form before the redesign (the copy, then all levels in one
    launch), in turns, and each one's kernel device time from the profiler;
    each grouping; on a base in place and out of place against the encode
    followed by a separate add, in turns, with the memory each form holds
    at its peak; the sector requests per level (one 32-byte sector per
    corner of each run of equal cells in a warp, the runs hash_run_heads
    reckons) and the rate they imply.  Returns
    the report of the kernels line."""
    import torch

    from gfnerf_tpu_torch.fields import hash_encoding as he

    n_levels, local, c = table.shape
    pts, anc = addr[2], addr[3]
    p = pts.shape[0]
    bf16 = table.to(torch.bfloat16)
    want = he.hash_encode_raw(table, *addr)
    got = he._hash_encode_cuda(table, *addr)
    torch.cuda.synchronize()
    err = max_err([got], [want])
    if not torch.equal(got, want):
        raise AssertionError(f"anchored encode on a train batch: not equal "
                             f"to the plain version bit for bit (max abs "
                             f"err {err})")
    if not bool((got[anc < 0] == 0).all()):
        raise AssertionError("anchored encode: masked anchors not zeroed")
    if not torch.equal(he._hash_encode_cuda(bf16, *addr), want):
        raise AssertionError("anchored encode: the bf16 table differs")
    base = got
    check_encode_with_base(
        "hash_anchored_fwd on a train batch",
        lambda b, in_place: he.hash_encode(table, *addr, b, in_place),
        lambda: he.hash_encode_raw(table, *addr), base)
    # 10 calls per event pair: a call's host work then overlaps the
    # kernels, as in a train step
    groupings = {}
    for n in (1, 2, 4, 8, 16):
        before = he.hash_encode.launches
        out = he._hash_encode_cuda(table, *addr, levels_per_launch=n)
        launches = he.hash_encode.launches - before
        torch.cuda.synchronize()
        if not torch.equal(out, want) or launches != he.encode_launches(
                n_levels, n):
            raise AssertionError(f"anchored encode at {n} levels a launch: "
                                 f"{launches} launches, equal "
                                 f"{torch.equal(out, want)}")
        del out
        groupings[n] = {"launches": launches, "ms": time_ms(
            lambda: he._hash_encode_cuda(table, *addr, levels_per_launch=n),
            n=11, reps=10)}
    del want
    # the f32 read against the bf16 copy + kernel, and against the form
    # before the redesign (the copy, then all 16 levels in one launch), in
    # turns
    fns = {
        "f32": lambda: he._hash_encode_cuda(table, *addr),
        "bf16_copy": lambda: he._hash_encode_cuda(table.to(torch.bfloat16),
                                                  *addr),
        "one_launch": lambda: he._hash_encode_cuda(
            table.to(torch.bfloat16), *addr, levels_per_launch=n_levels)}
    forms = in_turns(fns, ("f32", "bf16_copy", "one_launch", "one_launch",
                           "bf16_copy", "f32"), n=11, reps=10)
    per_call = {"f32": he.encode_launches(n_levels),
                "bf16_copy": he.encode_launches(n_levels),
                "one_launch": 1}
    device = {name: kernel_device_ms(fn, "hash_anchored_fwd", calls=10,
                                     launches=per_call[name])
              for name, fn in fns.items()}
    single_ms = time_ms(fns["f32"], n=21)
    typed = kernel_typed((table, *addr))
    typed_ms = time_ms(lambda: he._hash_encode_cuda(*typed), n=11, reps=10)
    copy_ms = time_ms(lambda: table.to(torch.bfloat16), n=11, reps=10)
    plain_ms = time_ms(lambda: he.hash_encode_raw(table, *addr), n=3)
    # on a base: separate, fused, fused, separate
    buf = base.clone()
    based = in_turns({
        "then_add": lambda: base + he.hash_encode(table, *addr),
        "in_place": lambda: he.hash_encode(table, *addr, buf, True),
        "out_of_place": lambda: he.hash_encode(table, *addr, base)},
        ("then_add", "in_place", "out_of_place", "in_place", "then_add"),
        n=11, reps=10)
    based_plain_ms = time_ms(lambda: he.hash_encode_raw(table, *addr, base),
                             n=3)
    del buf
    separate_peak = peak_extra_bytes(
        lambda: base.clone() + he.hash_encode(table, *addr))
    fused_peak = peak_extra_bytes(
        lambda: he.hash_encode(table, *addr, base.clone(), True))
    sectors = (8 * he.hash_run_heads(*addr)).tolist()
    del base
    torch.cuda.empty_cache()
    # output, points, anchors, and the f32 table read once
    n_bytes = 4 * p * n_levels * c + 12 * p + 4 * p + 4 * table.numel()
    bound = n_bytes / HBM_BYTES_PER_S * 1e3
    based_bound = (n_bytes + 4 * p * n_levels * c) / HBM_BYTES_PER_S * 1e3
    sector_rate = sum(sectors) / (device["f32"] * 1e-3)
    log(f"[parity] hash_anchored_fwd on a train batch (P={p}, "
        f"{int((anc >= 0).sum())} valid, L={n_levels}, C={c}, "
        f"local={local}): equal to the plain version from the f32 table and "
        f"its bf16 copy (max abs err {err}); 10 calls per event pair, in "
        f"turns: the wrapper on the f32 table {forms['f32']:.4f} ms, the "
        f"bf16 copy + kernel {forms['bf16_copy']:.4f} ms, the copy + all "
        f"{n_levels} levels in one launch {forms['one_launch']:.4f} ms; "
        f"kernel device time {device['f32']:.4f}, {device['bf16_copy']:.4f},"
        f" {device['one_launch']:.4f} ms; one call per event pair "
        f"{single_ms:.4f} ms; given the kernel's input types {typed_ms:.4f}"
        f" ms; the copy alone {copy_ms:.4f} ms; plain {plain_ms:.4f} ms; "
        f"bound {bound:.4f} ms ({n_bytes / 1e6:.1f} MB)")
    by_group = "; ".join(f"{n}: {x['launches']} launches, {x['ms']:.4f} ms"
                         for n, x in groupings.items())
    log(f"[parity] hash_anchored_fwd by levels per launch (f32 table): "
        f"{by_group}")
    log(f"[parity] hash_anchored_fwd sector requests per level (one 32-byte "
        f"sector per corner of each run of equal cells in a warp): "
        f"{sectors}, {sum(sectors)} in all ({32 * sum(sectors) / 1e9:.3f} "
        f"GB): {sector_rate / 1e9:.1f} G sectors/s at the kernel's device "
        f"time")
    log(f"[parity] hash_anchored_fwd added to a base (P, {n_levels * c}) "
        f"f32, 10 calls per event pair: in place {based['in_place']:.4f} ms,"
        f" out of place {based['out_of_place']:.4f} ms, the encode then a "
        f"separate add {based['then_add']:.4f} ms; bound {based_bound:.4f} "
        f"ms; plain {based_plain_ms:.4f} ms; memory held at the peak beyond "
        f"the base: separate {separate_peak / 2**20:.1f} MiB, in place "
        f"{fused_peak / 2**20:.1f} MiB")
    return {"max_abs_err": err, "ms": forms["f32"], "plain_ms": plain_ms,
            "bound_ms": bound, "bound_by": "bytes", "library_ms": None,
            "device_ms": device["f32"], "one_call_ms": single_ms,
            "kernel_typed_ms": typed_ms, "bf16_copy_ms": forms["bf16_copy"],
            "one_launch_ms": forms["one_launch"],
            "bf16_copy_device_ms": device["bf16_copy"],
            "one_launch_device_ms": device["one_launch"],
            "copy_alone_ms": copy_ms,
            "by_levels_per_launch": groupings,
            "sectors_per_level": sectors, "sectors_per_s": sector_rate,
            "with_base_in_place_ms": based["in_place"],
            "with_base_out_of_place_ms": based["out_of_place"],
            "then_separate_add_ms": based["then_add"],
            "with_base_bound_ms": based_bound,
            "with_base_plain_ms": based_plain_ms,
            "encodes_peak_separate_bytes": separate_peak,
            "encodes_peak_fused_bytes": fused_peak}


def time_anchored_on_batch(wl, batch, noise) -> tuple:
    """H4 and H5 on the points one parity train batch gives them (8192 rays
    x 192 samples, L = 16, C = 2, 2^19 entries a level): H4 as
    time_anchored_fwd says; H5 against its plain version bit for bit (also
    called again and on the points permuted: check_table_grad) and timed
    against it and index_add_ of the same precomputed (rows, payload)
    terms, with a random upstream gradient, with its global reductions per
    level (counted by the kernel, held against the runs' corner channels
    of non-zero sums reckoned on the host).  Returns (H4's, H5's report)."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.fields import hash_encoding as he

    field = wl["field"]
    rays = generate_rays_multi(wl["cams"], batch["camera_indices"],
                               batch["coords"])
    pts, anc = _marched_points(wl, rays["origins"], rays["directions"], noise,
                               wl["fineness"])
    table = field.global_feat.detach()
    n_levels, local, c = table.shape
    p = pts.shape[0]
    n_valid = int((anc >= 0).sum())
    addr = (field.global_prim, field.global_bias, pts, anc)
    with torch.no_grad():
        fwd = time_anchored_fwd(table, addr)
    # the upstream gradient, points, anchors, and the f32 gradient
    # zero-filled and written once: the bytes of H4's bound
    bound = fwd["bound_ms"]

    gen = torch.Generator(device="cuda").manual_seed(6)
    g = torch.randn((p, n_levels * c), generator=gen, device="cuda")
    args = (g, *addr, local, c)
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    he._hash_backward_cuda(*args, red_ops=ops)
    reckoned = he.hash_bwd_reductions(*args)
    got = check_table_grad("hash_anchored_bwd on a train batch",
                           he._hash_backward_cuda, he.hash_backward_reference,
                           args)
    if ops.tolist() != reckoned.tolist():
        raise AssertionError(f"hash_anchored_bwd: reductions per level "
                             f"{ops.tolist()}, reckoned on the host "
                             f"{reckoned.tolist()}")
    reductions = ops.tolist()
    err = 0.0
    largest = float(got.abs().max())
    del got, reckoned
    shape = (n_levels, p, local, c)
    parts = check_call_counts(
        "parity", lambda: he._hash_backward_cuda(*args), he.hash_encode,
        "hash_anchored_bwd", he.table_grad_launches(*shape),
        he.table_grad_memsets(*shape))
    ms = time_ms(lambda: he._hash_backward_cuda(*args), n=11)
    turns = against_parent("parity", "hash_anchored_bwd on a train batch",
                           "h5", args)
    plain_ms = time_ms(lambda: he.hash_backward_reference(*args), n=3)
    terms = list(he.hash_scatter_terms(*args))
    rows = torch.cat([t[0] for t in terms])
    payload = torch.cat([t[1] for t in terms])
    del terms
    library_ms = time_ms(lambda: torch.zeros(
        (n_levels * local, c), device="cuda").index_add_(0, rows, payload),
        n=5)
    del rows, payload
    torch.cuda.empty_cache()
    log(f"[parity] hash_anchored_bwd on a train batch: equal to the plain "
        f"version bit for bit, also called again and on the points permuted"
        f" (largest entry {largest:.3g}); kernel {ms:.4f} ms, plain "
        f"{plain_ms:.4f} ms, index_add_ {library_ms:.4f} ms, bound "
        f"{bound:.4f} ms")
    log(f"[parity] hash_anchored_bwd: {sum(reductions)} global reductions "
        f"for {8 * c * n_valid * n_levels} corner channels of valid (point,"
        f" level) pairs; per level {reductions} (host reckoning agrees)")
    bwd = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bound, "bound_by": "bytes", "library_ms": library_ms,
           "reductions_per_level": reductions, "parts": parts, **turns}
    return fwd, bwd


def phase_parity():
    """The anchored layout's train path: the bench's parity workload (16
    levels x 2 channels of 2^19 entries, 192 march slots, sample_l 1/256,
    fineness 4) built anew, then TRAIN_STEPS init-stage steps of 8192 rays,
    counted: K1, K2, H4 and H5 one call per step (H4 and H5 a launch per
    group of levels), the packed kernels never; losses finite and falling,
    the global table changed, the block tables not; one step against the
    plain autograd pairs; H4 and H5 timed on a train batch.  Returns the
    workload too, for the parity focal phase."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields.hash_encoding import (encode_launches,
                                                       hash_encode)
    from gfnerf_tpu_torch.train_bench import (RAYS, build_train_workload,
                                              make_batch, run_steps)

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    wl = build_train_workload(dev, seed=0, config="parity")
    field, scfg = wl["field"], wl["scfg"]
    log(f"[parity] workload in {time.perf_counter() - t0:.1f}s: table "
        f"{tuple(field.global_feat.shape)}, S={scfg.max_samples}, sample_l "
        f"{scfg.sample_l:.6f}, fineness {wl['fineness']}")
    gen = torch.Generator(device=dev).manual_seed(2)
    batches = [make_batch(wl["images"], RAYS, 200 + seed, dev)
               for seed in range(TRAIN_STEPS + 1)]
    table0 = field.global_feat.detach().clone()
    block0 = field.block_feats.detach().clone()
    torch.cuda.synchronize()

    reset_launch_counts()
    warm, losses = run_steps(wl, batches[:1], gen)
    torch.cuda.reset_peak_memory_stats()
    times, more = run_steps(wl, batches[1:TRAIN_STEPS], gen)
    peak = torch.cuda.max_memory_allocated()
    launches = launch_counts()
    calls = (hash_encode.calls, hash_encode.bwd_calls)
    losses += more
    dt = float(np.mean(times))
    log(f"[parity] warm-up step {warm[0]:.3f}s; {len(times)} steps of {RAYS} "
        f"rays: {dt:.4f} s/step (mean) = {RAYS / dt:.1f} rays/s; peak memory "
        f"{peak / 2**30:.2f} GiB")
    # H4's C entry point launches once per group of levels, H5's once per
    # level after the level maxima (csrc/hash_anchored_{fwd,bwd}.cu)
    h4_groups = encode_launches(field.global_feat.shape[0])
    h5_groups = table_grad_launches(wl, RAYS * scfg.max_samples)
    check_launches("parity", launches, {
        "composite_fwd": TRAIN_STEPS, "composite_bwd": TRAIN_STEPS,
        "hash_anchored_fwd": TRAIN_STEPS * h4_groups,
        "hash_anchored_bwd": TRAIN_STEPS * h5_groups})
    log(f"[parity] each kernel once per step, H4 in {calls[0]} calls of "
        f"{h4_groups} launches, H5 in {calls[1]} calls of {h5_groups}")
    if calls != (TRAIN_STEPS, TRAIN_STEPS):
        raise AssertionError(f"H4, H5: {calls} calls in {TRAIN_STEPS} steps")
    log(f"[parity] losses {[round(x, 5) for x in losses]}")
    first, last = losses[0], float(np.mean(losses[-5:]))
    if not all(np.isfinite(losses)) or not last < first:
        raise AssertionError(f"parity loss did not fall: {first} -> mean of "
                             f"the last 5 {last}")
    if torch.equal(field.global_feat, table0):
        raise AssertionError("the anchored table did not change")
    if not torch.equal(field.block_feats, block0):
        raise AssertionError("block_feats changed at the init stage")
    batch = batches[TRAIN_STEPS]
    noise, perms = step_draws(wl, gen)
    compare_step(wl, "parity", batch, noise, perms)
    stats = {"s_per_step": dt, "rays_per_s": RAYS / dt, "peak_bytes": peak,
             "first_loss": first, "last_loss": last,
             "hash_anchored_bwd_calls": calls[1]}
    return launches, stats, time_anchored_on_batch(wl, batch, noise), wl


def phase_parity_focal(wl):
    """The anchored layout's focal (block) stage, residual mode, after the
    parity phase's init steps: PARITY_FOCAL_STEPS steps on block 0 from a
    fresh optimizer state, counted.  Checked: H4 two calls a step, the
    second on a base (the frozen global encode, which the block's encode
    is added to as it writes); H5 one call a step, into the active block's
    table only; no addition inside the encode span; every frozen parameter
    and block 1 bit-unchanged, block 0 changed; losses finite; one step
    from a common state, kernels against the plain autograd pairs."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from gfnerf_tpu_torch.fields.hash_encoding import (encode_launches,
                                                       hash_encode)
    from gfnerf_tpu_torch.models.gfnerf import init_train_state
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch, run_steps

    dev = torch.device("cuda")
    field = wl["field"]
    n = PARITY_FOCAL_STEPS
    gen = torch.Generator(device=dev).manual_seed(3)
    batches = [make_batch(wl["images"], RAYS, 300 + seed, dev)
               for seed in range(n + 1)]
    noise, perms = step_draws(wl, gen)
    compare_step(wl, "parity focal", batches[n], noise, perms, focal_block=0)
    check_fused_residual("parity focal", lambda: step_from_copy(
        wl, batches[n], noise, perms, focal_block=0))
    frozen0 = [p.detach().clone() for name, ps in
               field_param_groups(field).items() if name != "block"
               for p in ps]
    stack0 = field.block_feats.detach().clone()
    wl["state"] = init_train_state(field, wl["tx"])   # a split switch
    torch.cuda.synchronize()

    reset_launch_counts()
    times, losses = run_steps(wl, batches[:n], gen, focal_block=0)
    launches = launch_counts()
    calls = (hash_encode.calls, hash_encode.base_calls, hash_encode.bwd_calls)
    h4_groups = encode_launches(field.global_feat.shape[0])
    check_launches("parity focal", launches, {
        "composite_fwd": n, "composite_bwd": n,
        "hash_anchored_fwd": 2 * n * h4_groups,
        "hash_anchored_bwd": n * table_grad_launches(
            wl, RAYS * wl["scfg"].max_samples)})
    log(f"[parity focal] H4 in {calls[0]} calls ({calls[1]} on a base), H5 "
        f"in {calls[2]} calls")
    if calls != (2 * n, n, n):
        raise AssertionError(f"parity focal: H4 calls, H4 calls on a base, "
                             f"H5 calls {calls}; expected {(2 * n, n, n)}")
    log(f"[parity focal] losses {[round(x, 5) for x in losses]}")
    if not all(np.isfinite(losses)):
        raise AssertionError("non-finite parity focal loss")
    if torch.equal(field.block_feats[0], stack0[0]):
        raise AssertionError("block 0's table did not change")
    if not torch.equal(field.block_feats[1], stack0[1]):
        raise AssertionError("block 1's table changed during block 0's steps")
    now = [p for name, ps in field_param_groups(field).items()
           if name != "block" for p in ps]
    if not all(torch.equal(a, b) for a, b in zip(now, frozen0)):
        raise AssertionError("a frozen parameter changed at the block stage")
    dt = float(np.mean(times[1:]))
    log(f"[parity focal] {n} steps of {RAYS} rays on block 0: all "
        f"{len(frozen0)} frozen tensors and block 1 bit-unchanged, block 0 "
        f"changed; {dt:.4f} s/step (mean without the first) = "
        f"{RAYS / dt:.1f} rays/s")
    return launches, {"s_per_step": dt, "rays_per_s": RAYS / dt}


# the pipeline phase: gf-nerf-perf through the Trainer with these overrides
# (apply_override, as the CLI applies them): 24 init steps, then 2 on each
# of the 10 blocks; milestones at 8 and 16, compaction at 12; the eval
# batch at steps 21 and 43, an eval image and the checkpoint at 43.  The
# octree is the config's (max_level 16, bbox_levels 10, 32768 points a
# leaf, a 128-wide visibility grid: on an H100's host 30.5 s, python -m
# gfnerf_tpu_torch.octree_bench), and so are the field's widths.
PIPELINE_INIT_STEPS = 24
PIPELINE_STEPS = 44
# the phases that hold each step's launches through the Trainer on
# gf-nerf-perf or gf-nerf-prop (whose steps_per_dispatch is 8) take one
# step a dispatch: a window's launches fall in its first step; the window
# is checked by the window and pipeline phases
ONE_STEP_A_DISPATCH = {"pipeline.steps_per_dispatch": "1"}
PIPELINE_OVERRIDES = {
    **{f"pipeline.{part}.{key}": value
       for part in ("model", "datamanager", "optimizers")
       for key, value in (("steps_perssampler_init", "24"),
                          ("steps_per_split_dataset", "2"))},
    "pipeline.sampler.sub_div_milestones": "8,16",
    "pipeline.sampler.compact_freq": "12",
    "pipeline.sampler.ray_march_fineness_decay_end_iter": "16",
    "steps_per_eval_batch": "22",
    "steps_per_eval_image": "44",
    "steps_per_save": "44",
}


def _mean(xs) -> float:
    import numpy as np

    return float(np.mean(xs)) if len(xs) else float("nan")


class _timed_calls:
    """fn with the host seconds of its calls summed in ``s`` (its other
    attributes passed through)."""

    def __init__(self, fn):
        self.fn, self.s = fn, 0.0

    def __call__(self, *args, **kw):
        t = time.perf_counter()
        try:
            return self.fn(*args, **kw)
        finally:
            self.s += time.perf_counter() - t

    def __getattr__(self, name):
        return getattr(self.fn, name)


def trainer_at_both_k(trainer, get_loss, after, what: str) -> dict:
    """A phase's Trainer (the pipeline phase's schedule: 24 init steps) on
    its init steps 0 to WINDOW_TRAINER_STEPS - 1 again (the milestones
    passed, compaction off, no eval and no save), at K = 1 and at K =
    WINDOW_K in turns, twice each (``get_loss`` and ``after``: the
    pipeline's own methods), from no kept graph and the card's cache
    emptied.  Checked: each K = WINDOW_K run's steps in windows and single
    steps as ``predict_windows`` says, no buffered metric left; the first
    K = WINDOW_K run captures once, the second not at all (it replays the
    kept graph).  Then two more K = WINDOW_K runs of one window each: the
    first taken apart on the host (the batches drawn, their staging, the
    calls that enqueue the replays, the rest: the copy back's wait for the
    card, and the rows), the second profiled (the card's busy share).
    Returns the s/step of each run over its first WINDOW_K steps (the
    window's calls), each run's peak allocated and reserved bytes and captures, and
    the window's parts."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.utils.profiling import profile_device

    p = trainer.pipeline
    k = WINDOW_K
    p.sampler.cfg.compact_freq = 10 ** 6
    trainer.config.max_num_iterations = WINDOW_TRAINER_STEPS
    trainer._start_step = 0
    trainer.save_checkpoint = lambda step: None
    trainer.eval_iteration = lambda step: None
    spans, runs, mem, caps = [], {}, {}, {}
    profiled = {}

    def captures():
        return sum(f.captures for f in p._multi_step_fns.values())

    def get_loss_w(step):
        t = time.perf_counter()
        if profiled.get("at") == step:   # the window's wall inside
            got = []

            def window():
                t_in = time.perf_counter()
                got.append(get_loss(step))
                torch.cuda.synchronize()
                got.append(time.perf_counter() - t_in)

            profiled["prof"] = profile_device(window)
            m, profiled["wall_s"] = got
        else:
            m = get_loss(step)
        torch.cuda.synchronize()
        spans[-1].append(time.perf_counter() - t)
        return m

    p.get_train_loss_dict, p.after_train_iteration = get_loss_w, after
    want = predict_windows(WINDOW_TRAINER_STEPS, k, PIPELINE_INIT_STEPS, 2,
                           10, (), 10 ** 6)

    def run(kk):
        p.config.steps_per_dispatch = kk
        before = (p._k_steps_scanned, p._k_steps_fallback, captures())
        spans.append([])
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        got = (p._k_steps_scanned - before[0],
               p._k_steps_fallback - before[1])
        if (kk == k and got != want) or p._pending_metrics:
            raise AssertionError(f"{what}: K={kk} Trainer run: coverage "
                                 f"{got}, predicted {want}; metrics left "
                                 f"{sorted(p._pending_metrics)}")
        runs.setdefault(kk, []).append(float(np.mean(spans[-1][:k])))
        mem.setdefault(kk, []).append((torch.cuda.max_memory_allocated(),
                                       torch.cuda.max_memory_reserved()))
        caps.setdefault(kk, []).append(captures() - before[2])

    for fn in p._multi_step_fns.values():
        fn.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    for kk in (1, k, 1, k):
        run(kk)
    if caps[k] != [1, 0] or any(caps[1]):
        raise AssertionError(f"{what}: captures in the Trainer's runs: K={k}"
                             f" {caps[k]}, K=1 {caps[1]} (want [1, 0] and "
                             f"none)")
    # one window taken apart on the host, then one window profiled
    dm = p.datamanager
    draw, stage = (_timed_calls(dm.next_train),
                   _timed_calls(p._stage_window))
    key = (0, k)
    enqueue = p._multi_step_fns[key] = _timed_calls(p._multi_step_fns[key])
    dm.next_train, p._stage_window = draw, stage
    c0 = captures()
    trainer.config.max_num_iterations = k   # one window
    p.config.steps_per_dispatch = k
    try:
        spans.append([])
        trainer.train()
        win_s = spans[-1][0]
        del dm.next_train, p._stage_window
        p._multi_step_fns[key] = enqueue.fn
        profiled["at"] = 0
        spans.append([])
        trainer.train()
    finally:
        dm.__dict__.pop("next_train", None)
        p.__dict__.pop("_stage_window", None)
        p._multi_step_fns[key] = enqueue.fn
        profiled.pop("at", None)
        trainer.config.max_num_iterations = WINDOW_TRAINER_STEPS
    if captures() != c0:
        raise AssertionError(f"{what}: the last Trainer windows captured")
    prof = profiled["prof"]
    parts = {"window_s": win_s, "draw_s": draw.s, "stage_s": stage.s,
             "enqueue_s": enqueue.s,
             "rest_s": win_s - draw.s - stage.s - enqueue.s,
             "profiled_window_s": profiled["wall_s"],
             "device_busy_ms": prof["device_busy_ms"],
             "busy_share": prof["device_busy_ms"] / (profiled["wall_s"]
                                                     * 1e3),
             "host_waits": prof["host_waits"],
             "top_kernels": [(t["name"][:60], round(t["device_ms"], 2))
                             for t in prof["top_kernels"][:6]]}
    gib = {kk: [(round(a / 2**30, 3), round(r / 2**30, 3)) for a, r in v]
           for kk, v in mem.items()}
    log(f"[{what}] the Trainer on steps 0-{WINDOW_TRAINER_STEPS - 1} "
        f"again, in turns from no kept graph, s/step over steps 0-{k - 1}: "
        f"K=1 "
        f"{runs[1]} vs K={k} {runs[k]} (captures {caps[k]}; {want[0]} steps "
        f"in windows, {want[1]} single); peak GiB (allocated, reserved): "
        f"K=1 {gib[1]}, K={k} {gib[k]}; a window {win_s:.4f} s: the "
        f"batches drawn {draw.s:.4f}, staged {stage.s:.4f}, the replays "
        f"enqueued {enqueue.s:.4f}, the rest (the copy back, its wait for "
        f"the card) {parts['rest_s']:.4f}; a window under the profiler "
        f"{profiled['wall_s']:.4f} s, device busy "
        f"{prof['device_busy_ms']:.2f} ms ({parts['busy_share']:.1%}), "
        f"host waits {prof['host_waits']}, busiest kernels "
        f"{parts['top_kernels']}")
    p.config.steps_per_dispatch = k
    return {"trainer_s_per_step_k8": runs[k], "trainer_s_per_step_k1": runs[1],
            "trainer_peak_bytes_k1": mem[1], "trainer_peak_bytes_k8": mem[k],
            "trainer_captures_k8": caps[k], "trainer_window_parts": parts}


def phase_pipeline(tmp: Path):
    """gf-nerf-perf trained through the Trainer on the synthetic scene (48
    train and 4 val views at 96x72), counted: 24 init steps, the transition
    (48 error maps, 10 camera clusters, block indices), 20 focal steps over
    the 10 blocks, eval batches, an eval image and a checkpoint; then a
    fresh Trainer resumed from the checkpoint for 2 more steps.  Checked:
    finite losses; both milestone rebuilds grew the tree; 48 error-map
    renders; 10 clusters; a fresh optimizer state at each of the 10 split
    switches; during split k only block k's table changed; the eval image's
    PSNR above its mean-image PSNR; the checkpoint written; the resumed
    state equal to the saved one bit for bit, its start step 44, and its
    first step equal to the continuing run's (the loss and every tensor,
    the active table included, bit for bit: H2 sums its gradient exactly,
    in fixed point); at K = 8 (gf-nerf-perf's steps_per_dispatch) the steps in
    windows and the single steps as ``predict_windows`` says, no buffered
    metric left, the state at step 44; a window's host syncs one, K single
    steps' at least K.  Timed: single steps through the Trainer, the same
    step through train_bench's loop, the rebuilds, the transition, an eval
    batch, the checkpoint's save and load; peak memory; host syncs of a
    focal step, a window and K single steps; ``trainer_at_both_k``."""
    import copy

    import numpy as np
    import torch

    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
    from gfnerf_tpu_torch.pipelines.pipeline import GFNerfPipeline
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch, run_steps
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = make_synthetic_npz(tmp / "scene", n_train=48, n_val=4,
                               img_wh=(96, 72))

    def make_trainer(iterations, **extra):
        cfg = get_method("gf-nerf-perf")
        for key, value in {**PIPELINE_OVERRIDES,
                           "max_num_iterations": str(iterations),
                           "output_dir": str(tmp / "out"),
                           **extra}.items():
            apply_override(cfg, key, value)
        cfg.data = scene
        return Trainer(cfg, build_dataparser("minimal", scene))

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SETUP_REUSE.note()   # this setup's reuses alone
    t0 = time.perf_counter()
    trainer = make_trainer(PIPELINE_STEPS)
    trainer.setup()
    p = trainer.pipeline
    setup_s = time.perf_counter() - t0
    scfg = p.sampler.sampler_config
    reused = SETUP_REUSE.note()
    log(f"[pipeline] setup {setup_s:.2f}s ({reused})"
        f": {p.sampler.tree.n_nodes} nodes, "
        f"{p.sampler.oct_dev.n_leaves} valid leaves; sample_l "
        f"{scfg.sample_l:.6f}, max_hits {scfg.max_hits}, "
        f"S={scfg.max_samples}; n_blocks {p.field_cfg.n_blocks}, "
        f"{p.field_cfg.num_levels} levels x "
        f"{p.field_cfg.features_per_level}, 2^"
        f"{p.field_cfg.packed_rows_log2} rows, hidden "
        f"{p.field_cfg.hidden_dim}, {p.field_cfg.mlp_dtype} MLPs, "
        f"{p.config.datamanager.train_num_rays_per_batch} rays a batch")

    # instrument the pipeline's callbacks on the instance
    rec = {"steps": {}, "rebuilds": [], "switches": [], "error_map_renders":
           0, "evals": [], "saves": [], "split_checks": []}
    snap = {}
    get_loss, after = p.get_train_loss_dict, p.after_train_iteration
    rebuild, render = p.sampler.maybe_rebuild, p.render_camera
    eval_batch, eval_image = (p.get_eval_loss_dict,
                              p.get_eval_image_metrics_and_images)
    save = p.save_checkpoint_state

    def split_of(step):
        return p.sampler.cur_split_idx(step)

    def get_loss_w(step):
        k = split_of(step)
        if k >= 0 and (step == 0 or split_of(step - 1) != k):
            snap["k"], snap["stack"] = k, p.field.block_feats.detach().clone()
        t = time.perf_counter()
        m = get_loss(step)
        rec["steps"][step] = {"s": time.perf_counter() - t, **m}
        if k >= 0 and split_of(step + 1) != k:
            now = p.field.block_feats.detach()
            changed = [b for b in range(now.shape[0])
                       if not torch.equal(now[b], snap["stack"][b])]
            rec["split_checks"].append((snap["k"], changed))
            del snap["stack"]
        return m

    def after_w(step):
        last = p._last_split_idx
        t = time.perf_counter()
        after(step)
        rec["steps"][step]["after_s"] = time.perf_counter() - t
        if p._last_split_idx != last:
            rec["switches"].append((step, p._last_split_idx,
                                    p.state.opt_state.count,
                                    p.datamanager.split_idx))

    def rebuild_w(step):
        n = p.sampler.tree.n_nodes
        t = time.perf_counter()
        done = rebuild(step)
        if done:
            rec["rebuilds"].append((step, n, p.sampler.tree.n_nodes,
                                    time.perf_counter() - t))
        return done

    def render_w(*args, **kw):
        if kw.get("downscale") == 8:
            rec["error_map_renders"] += 1
        return render(*args, **kw)

    def eval_batch_w(step):
        t = time.perf_counter()
        m = eval_batch(step)
        torch.cuda.synchronize()
        rec["evals"].append((step, time.perf_counter() - t,
                             float(m["eval_psnr"])))
        return m

    def eval_image_w(step, idx=0):
        metrics, images = eval_image(step, idx)
        rec["eval_image"] = (step, idx, metrics)
        return metrics, images

    def save_w(ckpt_dir, step):
        t = time.perf_counter()
        save(ckpt_dir, step)
        rec["saves"].append((step, time.perf_counter() - t))

    p.get_train_loss_dict, p.after_train_iteration = get_loss_w, after_w
    p.sampler.maybe_rebuild, p.render_camera = rebuild_w, render_w
    p.get_eval_loss_dict = eval_batch_w
    p.get_eval_image_metrics_and_images = eval_image_w
    p.save_checkpoint_state = save_w

    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    # K = 8 windows where the JAX package's rule lets them fit
    k = p.config.steps_per_dispatch
    coverage = (p._k_steps_scanned, p._k_steps_fallback)
    want = predict_windows(PIPELINE_STEPS, k, PIPELINE_INIT_STEPS, 2, 10,
                           (8, 16), 12)
    log(f"[pipeline] K={k}: {coverage[0]} steps in windows, {coverage[1]} "
        f"single (predicted {want}); metrics left {p._pending_metrics}")
    if k != WINDOW_K or coverage != want or p._pending_metrics \
            or p.state.step != PIPELINE_STEPS:
        raise AssertionError(f"pipeline: K {k}, coverage {coverage}, "
                             f"predicted {want}, step {p.state.step}")

    # the checks
    steps = rec["steps"]
    losses = [steps[i]["loss"] for i in range(PIPELINE_STEPS)]
    if sorted(steps) != list(range(PIPELINE_STEPS)):
        raise AssertionError(f"pipeline: steps run {sorted(steps)}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"pipeline: non-finite losses {losses}")
    log(f"[pipeline] losses {[round(x, 5) for x in losses]}")
    log(f"[pipeline] rebuilds (step, nodes before, after, s): "
        f"{[(s, a, b, round(t, 3)) for s, a, b, t in rec['rebuilds']]}")
    grown = [s for s, a, b, _ in rec["rebuilds"] if b > a]
    if grown != [8, 16]:
        raise AssertionError(f"pipeline: the milestone rebuilds grew the "
                             f"tree at steps {grown}, expected [8, 16]")
    maps = sorted((Path(p.sample_tmp_dir) / "npy").glob("*.npy"))
    log(f"[pipeline] error maps: {rec['error_map_renders']} renders, "
        f"{len(maps)} files ({maps[0].name} ... {maps[-1].name})")
    if rec["error_map_renders"] != 48 or len(maps) != 48:
        raise AssertionError(f"pipeline: {rec['error_map_renders']} "
                             f"error-map renders and {len(maps)} maps, "
                             f"expected 48 of each")
    labels = p.sampler.cameras_labels
    sizes = np.bincount(labels, minlength=10)
    log(f"[pipeline] camera clusters: sizes {sizes.tolist()}")
    if labels.shape != (48,) or len(np.unique(labels)) != 10:
        raise AssertionError(f"pipeline: camera labels {labels}")
    log(f"[pipeline] split switches (step, split, optimizer count after, "
        f"datamanager split): {rec['switches']}")
    want = [(PIPELINE_INIT_STEPS + 2 * k, k, 0, k) for k in range(10)]
    if rec["switches"] != want:
        raise AssertionError(f"pipeline: split switches {rec['switches']}, "
                             f"expected {want}")
    log(f"[pipeline] blocks changed during each split: "
        f"{rec['split_checks']}")
    if rec["split_checks"] != [(k, [k]) for k in range(10)]:
        raise AssertionError(f"pipeline: blocks changed by split "
                             f"{rec['split_checks']}")
    step, idx, metrics = rec["eval_image"]
    gt = p.datamanager.next_eval_image(idx)[1]["image"]
    trivial = float(-10.0 * np.log10(np.mean((gt - gt.mean(axis=(0, 1)))
                                             ** 2)))
    log(f"[pipeline] eval image {idx} at step {step}: "
        f"{json.dumps(metrics)}; mean-image PSNR {trivial:.4f}")
    if not metrics["psnr"] > trivial:
        raise AssertionError(f"pipeline: eval PSNR {metrics['psnr']} not "
                             f"above the mean image's {trivial}")
    log(f"[pipeline] eval batches (step, s, PSNR): {rec['evals']}")
    ckpt = trainer.checkpoint_dir / f"step-{PIPELINE_STEPS - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"pipeline: no checkpoint at {ckpt}")
    h1, h2 = launches["packed_hash_fwd"], launches["packed_hash_bwd"]
    log(f"[pipeline] launches in the run: {launches}")
    wl = {"fcfg": p.field_cfg}
    focal = PIPELINE_STEPS - PIPELINE_INIT_STEPS
    if (launches["composite_bwd"] != PIPELINE_STEPS
            or h2 != PIPELINE_STEPS * table_grad_launches(wl)
            or h1 < PIPELINE_INIT_STEPS + 2 * focal
            or launches["composite_fwd"] < PIPELINE_STEPS
            or launches["packed_hash_routed"] < 1
            or launches["hash_anchored_fwd"] or launches["hash_anchored_bwd"]):
        raise AssertionError(f"pipeline: launches {launches}")

    # resume from the checkpoint: the Trainer's setup builds the pipeline
    # on the checkpoint's octree and march config, then loads the rest
    load = GFNerfPipeline.load_checkpoint_state
    loads = []

    def load_w(self, ckpt_dir):
        t = time.perf_counter()
        out = load(self, ckpt_dir)
        torch.cuda.synchronize()
        loads.append(time.perf_counter() - t)
        return out

    GFNerfPipeline.load_checkpoint_state = load_w
    try:
        t0 = time.perf_counter()
        trainer2 = make_trainer(PIPELINE_STEPS + 2, load_dir=str(
            trainer.checkpoint_dir))
        trainer2.setup()
        torch.cuda.synchronize()
        resume_setup_s = time.perf_counter() - t0
    finally:
        GFNerfPipeline.load_checkpoint_state = load
    p2 = trainer2.pipeline
    if trainer2._start_step != PIPELINE_STEPS or len(loads) != 1:
        raise AssertionError(f"resumed at {trainer2._start_step} after "
                             f"{len(loads)} loads")
    for (name, a), b in zip(p.field.state_dict().items(),
                            p2.field.state_dict().values()):
        if not torch.equal(a, b):
            raise AssertionError(f"resumed {name} differs from the saved")
    for part in ("mu", "nu"):
        for name, xs in getattr(p.state.opt_state, part).items():
            for a, b in zip(xs, getattr(p2.state.opt_state, part)[name]):
                if not ((a is None and b is None) or torch.equal(a, b)):
                    raise AssertionError(f"resumed Adam {part} of {name}")
    if (p2.state.opt_state.count, p2.state.step) != \
            (p.state.opt_state.count, p.state.step):
        raise AssertionError("resumed optimizer count or step differs")
    if not (torch.equal(p2.generator.get_state(), p.generator.get_state())
            and p2.sampler.tree.n_nodes == p.sampler.tree.n_nodes
            and p2.sampler.sampler_config == p.sampler.sampler_config
            and np.array_equal(p2.sampler.cameras_labels, labels)):
        raise AssertionError("resumed generator, tree, march config or "
                             "labels differ")
    # one step each from the same state on the same batch: the continuing
    # run's first, then the resumed Trainer's 2 steps, held against it
    # after its first
    p2.datamanager = copy.deepcopy(p.datamanager)
    m1 = get_loss(PIPELINE_STEPS)
    active = p.sampler.cur_split_idx(PIPELINE_STEPS)
    resumed, diff = {}, {}
    get_loss2 = p2.get_train_loss_dict

    def get_loss2_w(step):
        resumed[step] = get_loss2(step)
        if step == PIPELINE_STEPS:
            for (name, a), b in zip(p.field.state_dict().items(),
                                    p2.field.state_dict().values()):
                if not torch.equal(a, b):
                    d = (a - b).abs()
                    diff[name] = (float((d > 0).float().mean()),
                                  float(d.max()))
        return resumed[step]

    p2.get_train_loss_dict = get_loss2_w
    trainer2.train()
    m2 = resumed[PIPELINE_STEPS]
    log(f"[pipeline] resumed at step {trainer2._start_step}: state, march "
        f"config and tree equal to the saved ones; its step "
        f"{PIPELINE_STEPS} (block {active} active) against the continuing "
        f"run's: loss {m2['loss']!r} vs {m1['loss']!r}, tensors apart "
        f"(share of entries, largest difference) {diff or 'none'}")
    if m1["loss"] != m2["loss"] or diff:
        raise AssertionError("the resumed step differs from the continuing "
                             "run's")
    if sorted(resumed) != [PIPELINE_STEPS, PIPELINE_STEPS + 1] or not all(
            np.isfinite(m["loss"]) for m in resumed.values()):
        raise AssertionError(f"resumed steps {resumed}")
    load_s = loads[0]

    # times: the Trainer's single steps (without the window [0, 8), the
    # first single step and the rebuild steps), the same step through
    # train_bench's loop
    rebuild_steps = {s for s, *_ in rec["rebuilds"]}
    init_s = [steps[i]["s"] for i in range(9, PIPELINE_INIT_STEPS)
              if i not in rebuild_steps]
    init1_s = [steps[i]["s"] for i in range(16, PIPELINE_INIT_STEPS)
               if i not in rebuild_steps]
    focal_s = [steps[i]["s"] for i in range(PIPELINE_INIT_STEPS + 2,
                                            PIPELINE_STEPS)]
    switch_s = [steps[s]["after_s"] for s, *_ in rec["switches"][1:]]
    images = np.asarray(p.datamanager.train_dataset.metadata[
        "images_array"], np.float32) / 255.0
    dev = p.device
    gen = torch.Generator(device=dev).manual_seed(0)
    bench = {"step_fn": p._train_step[STAGE_INIT],
             "focal_step_fn": p._train_step[STAGE_BLOCK],
             "state": p.state, "oct_dev": p.sampler.oct_dev,
             "cams": p.cameras_dev, "fineness": 1.0}
    batches = [make_batch(images, RAYS, 400 + i, dev) for i in range(6)]
    run_steps(bench, batches[:1], gen)
    bench_init, _ = run_steps(bench, batches[1:], gen)
    run_steps(bench, batches[:1], gen, focal_block=0)
    bench_focal, _ = run_steps(bench, batches[1:], gen, focal_block=0)
    p.state = bench["state"]
    p.sampler.oct_dev = bench["oct_dev"]
    # host syncs: a focal step; at the init stage a window of K steps (its
    # graph captured by a first window) against K single steps
    syncs = {"focal": host_syncs(lambda: get_loss(PIPELINE_STEPS + 2))}
    p.total_train_steps = None
    get_loss(1)   # the window [1, 9): no compaction step (12) in it
    p._pending_metrics.clear()
    syncs["init_window"] = host_syncs(lambda: get_loss(13))   # [13, 21)
    p._pending_metrics.clear()
    p.config.steps_per_dispatch = 1
    syncs["init_singles"] = host_syncs(
        lambda: [get_loss(1 + i) for i in range(k)])
    p.config.steps_per_dispatch = k

    # (the profiler's stop adds one cudaDeviceSynchronize to each trace)
    waits = {key: n.get("cudaStreamSynchronize", 0)
             for key, n in syncs.items()}
    if waits["init_window"] != 1 or waits["init_singles"] < k:
        raise AssertionError(f"pipeline: host syncs {syncs}")
    trainer_k = trainer_at_both_k(trainer, get_loss, after, "pipeline")
    stats = {
        "setup_s": setup_s, "train_s": train_s,
        "init_s_per_step": _mean(init_s),
        "init_s_per_step_fineness_1": _mean(init1_s),
        "focal_s_per_step": _mean(focal_s),
        "bench_init_s_per_step": _mean(bench_init),
        "bench_focal_s_per_step": _mean(bench_focal),
        "rebuilds_s": {s: t for s, _, _, t in rec["rebuilds"]},
        "transition_s": steps[PIPELINE_INIT_STEPS]["after_s"],
        "split_switch_s": _mean(switch_s),
        "eval_batch_s": [t for _, t, _ in rec["evals"]],
        "checkpoint_save_s": [t for _, t in rec["saves"]],
        "checkpoint_load_s": load_s, "resume_setup_s": resume_setup_s,
        "peak_bytes": peak, "host_syncs": syncs, "k_coverage": coverage,
        **trainer_k,
        "eval_psnr": float(metrics["psnr"]), "mean_image_psnr": trivial,
        "nodes": p.sampler.tree.n_nodes,
        "max_hits": p.sampler.sampler_config.max_hits,
    }
    log(f"[pipeline] Trainer: {_mean(init_s):.4f} s/init step "
        f"({_mean(init1_s):.4f} at fineness 1), {_mean(focal_s):.4f} s/focal"
        f" step; train_bench's loop on the same steps: "
        f"{_mean(bench_init):.4f} init, {_mean(bench_focal):.4f} focal; "
        f"host syncs a step: {syncs}; peak {peak / 2**30:.3f} GiB")
    return launches, stats


# K steps a dispatch: the window of gf-nerf-perf and gf-nerf-prop
# (steps_per_dispatch, bench.py:415)
WINDOW_K = 8
# on one card a window replayed from its CUDA graph equals the same window
# run eagerly from the same state and draws, and two eager runs equal each
# other, in every loss and parameter bit for bit: H2 sums the table
# gradient exactly, in fixed point, and no other op of the step depends on
# an order that varies; so does a window over NCCL ranks
# (check_parallel_window).  Against one process on the union batch the
# ranks' sums take another order: the parameters at the pipeline parity
# test's share (at most 10% of a tensor's entries apart by more than 1e-4)
# and none apart by more than one step of the largest learning rate
# (1e-2) for each step of the window (an Adam update of a near-zero
# gradient may flip its sign at any of them)
WINDOW_SHARE, WINDOW_ENTRY_ATOL, WINDOW_MAX = 0.10, 1e-4, 8 * 1e-2
# the counters' names -> a piece of the names of their kernels in a trace
# (H2: its count, scan, scatter and owner kernels)
WINDOW_KERNEL_NAMES = {"composite_fwd": "composite_fwd_kernel",
                       "composite_bwd": "composite_bwd_",
                       "packed_hash_fwd": "packed_hash_encode_kernel",
                       "packed_hash_bwd": "packed_hash_bwd_"}
# timed in turns: single steps against windows, twice each
WINDOW_SINGLE_STEPS = 8
WINDOW_TIMED = 2
# gf-nerf-perf through the Trainer at both K: the pipeline phase's run
# takes its init steps 0-8 again (its milestones passed, compaction off):
# the window [0, 8), then one single step
WINDOW_TRAINER_STEPS = 9


def predict_windows(total: int, k: int, init_steps: int, split_steps: int,
                    n_splits: int, milestones, compact_freq: int) -> tuple:
    """(steps in windows, single steps) of a run of ``total`` steps at K =
    ``k`` by the JAX pipeline's rule (``_k_window_ok``,
    gfnerf_tpu/pipelines/pipeline.py:399-426), written out on its own: a
    window fits if it ends by ``total``, stays in one stage, at the focal
    stage in one split, and at the init stage has no milestone at or
    before its last step and no compaction step; a single step at the init
    stage passes the milestones it reaches (the rebuild)."""
    ms = sorted(milestones)

    def stage(s):
        return 0 if s < init_steps else 1

    def split(s):
        return -1 if s < init_steps else \
            ((s - init_steps) // split_steps) % n_splits

    scanned = single = step = 0
    while step < total:
        span = range(step, step + k)
        ok = step + k <= total and len({stage(s) for s in span}) == 1
        if ok and stage(step) == 1:
            ok = len({split(s) for s in span}) == 1
        elif ok:
            ok = not (ms and ms[0] <= step + k - 1) and not any(
                s > 0 and s % compact_freq == 0 for s in span)
        if ok:
            scanned += k
            step += k
            continue
        single += 1
        if stage(step) == 0:
            while ms and ms[0] <= step:
                ms.pop(0)
        step += 1
    return scanned, single


def _apart(a, b) -> tuple:
    """(share of entries apart by more than WINDOW_ENTRY_ATOL, largest
    difference) of two tensors."""
    d = (a.float() - b.float()).abs()
    return float((d > WINDOW_ENTRY_ATOL).float().mean()), float(d.max())


def _params_apart(a, b) -> dict:
    """``_apart`` of each parameter of two fields, by group."""
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    out = {}
    for name, ps in field_param_groups(a).items():
        for i, (x, y) in enumerate(zip(ps, field_param_groups(b)[name])):
            out[f"{name}[{i}]"] = _apart(x.detach(), y.detach())
    return out


def _params_differ(a, b) -> list:
    """The parameters of two fields that are not equal bit for bit."""
    import torch

    from gfnerf_tpu_torch.engine.optimizers import field_param_groups

    return [f"{name}[{i}]" for name, ps in field_param_groups(a).items()
            for i, (x, y) in enumerate(zip(ps, field_param_groups(b)[name]))
            if not torch.equal(x.detach(), y.detach())]


def step_repeats(wl, batch, noise, perms, focal_block=None,
                 prop_u=None) -> dict:
    """One train step twice from deep copies of one state, on one batch
    and one set of draws: the loss, and each parameter's gradient (the
    active table's at the block stage, from Adam's first moment) and
    value after the update, bit for bit.  Returns {"loss": equal,
    "gradients": [those that differ], "parameters": [those that
    differ]}."""
    import torch

    from gfnerf_tpu_torch.engine.optimizers import field_param_grads

    runs = [step_from_copy(wl, batch, noise, perms, focal_block,
                           prop_u=prop_u) for _ in range(2)]
    (l1, s1), (l2, s2) = runs
    if focal_block is None:
        g1, g2 = field_param_grads(s1.field), field_param_grads(s2.field)
    else:
        g1, g2 = ({"block": s.opt_state.mu["block"]} for s in (s1, s2))
    grads = [f"{name}[{i}]" for name, gs in g1.items()
             for i, (x, y) in enumerate(zip(gs, g2[name]))
             if not (x is None and y is None or torch.equal(x, y))]
    return {"loss": l1 == l2, "gradients": grads,
            "parameters": _params_differ(s1.field, s2.field)}


def workload_copy(wl) -> dict:
    """A train_bench workload with deep copies of its field, optimizer
    state and octree, and no window functions of its own yet."""
    import copy

    from gfnerf_tpu_torch.models.gfnerf import TrainState

    field = copy.deepcopy(wl["state"].field)
    return {**wl, "state": TrainState(
        field=field, opt_state=copy.deepcopy(wl["state"].opt_state),
        step=wl["state"].step), "oct_dev": copy.deepcopy(wl["oct_dev"]),
            "window_fns": {}}


def _philox_offset(gen) -> int:
    """A CUDA generator's Philox offset (its state's second 8 bytes)."""
    state = gen.get_state()
    return int.from_bytes(bytes(state[8:16].tolist()), "little")


def traced_window_launches(what: str, one_window, expected: dict):
    """Profile ``one_window()``, which runs one replayed window, and count
    the records of WINDOW_KERNEL_NAMES' kernels in its trace by name: what
    the counters add for a replayed window (``expected``: K times a
    step's) must be what the graph ran.  The trace is taken again if it
    lost records, 3 times at most; raises past them.  Returns the profile
    and the counts."""
    from gfnerf_tpu_torch.utils.profiling import profile_device

    for attempt in range(1, 4):
        prof = profile_device(one_window)
        traced = {name: sum(c for key, c in prof["kernel_counts"].items()
                            if pattern in key)
                  for name, pattern in WINDOW_KERNEL_NAMES.items()}
        if traced == expected:
            return prof, traced
        log(f"[profiler] window {what}: the trace holds {traced} kernel "
            f"records (try {attempt} of 3)")
    raise AssertionError(f"window {what}: a replayed window's trace holds "
                         f"{traced} launches, not {expected}")


def window_checks(wl, what: str, focal_block=None) -> dict:
    """A K = WINDOW_K window of the train_bench workload ``wl`` at 8192
    rays, on the card: captured by a first window, then checked and timed.
    Checked: one step twice from one state (``step_repeats``: the loss,
    every gradient and every parameter bit for bit); the launches of a
    replayed window (K times a step's, by the counters and by the kernels'
    records in a profiled window's trace); a replayed window against the
    same window run eagerly from deep copies of the state, and two eager
    windows against each other, from the same injected draws, and a
    replayed window against an eager one from the same generator state
    (every loss and every parameter bit for bit), the generator at the
    same Philox offset, which every replay moved; no host sync under
    ``torch.cuda.set_sync_debug_mode("error")`` around a replayed window.
    Timed in turns: single steps (K = 1) and windows, s/step and peak
    memory (with a parent tree also against windows over its H2:
    parent_window_turns); the device's busy share of a profiled
    window."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.model_components.losses import s3im_permutations
    from gfnerf_tpu_torch.train_bench import (RAYS, make_batch, run_steps,
                                              run_windows, stack_window)

    k = WINDOW_K
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(7)
    seed = 900 if focal_block is None else 1900
    n_windows = 4 + 2 * WINDOW_TIMED + 1
    flat = [make_batch(wl["images"], RAYS, seed + i, dev)
            for i in range(n_windows * k + 1 + WINDOW_SINGLE_STEPS)]
    windows = [stack_window(flat[i * k:(i + 1) * k])
               for i in range(n_windows)]
    singles = flat[n_windows * k:]
    n_prop = wl["mcfg"].num_proposal_resamples
    per_step = {"composite_fwd": 1, "composite_bwd": 1,
                "packed_hash_fwd": 1 if focal_block is None else 2,
                "packed_hash_bwd": table_grad_launches(wl)}
    if n_prop:   # the probe's table: H1 once more, H2 at its levels
        per_step["packed_hash_fwd"] += 1
        per_step["packed_hash_bwd"] += table_grad_launches(wl)

    def draws():
        d = {"noise": torch.rand((k, RAYS, wl["scfg"].max_samples),
                                 generator=gen, device=dev) + 0.5,
             "s3im_perms": torch.stack([s3im_permutations(
                 RAYS, generator=gen, device=dev) for _ in range(k)])}
        if n_prop:
            d["prop_u"] = torch.rand((k, RAYS, n_prop + 1), generator=gen,
                                     device=dev)
        return d

    def copy_of():
        return workload_copy(wl)

    d = draws()
    repeats = step_repeats(
        wl, flat[0], d["noise"][0], d["s3im_perms"][0], focal_block,
        prop_u=d["prop_u"][0] if n_prop else None)
    log(f"[window] {what}: one step twice from one state, the same batch and "
        f"draws: loss equal {repeats['loss']}, gradients apart "
        f"{repeats['gradients']}, parameters apart {repeats['parameters']}")
    if not repeats["loss"] or repeats["gradients"] or repeats["parameters"]:
        raise AssertionError(f"window {what}: one step repeated differs: "
                             f"{repeats}")

    # single steps from no kept graph and an emptied cache, then the
    # capture (the window's first step eager, then 7 replays): its peak
    # holds the graph's pool, which later replays reuse
    for fn in wl.get("window_fns", {}).values():
        fn.reset()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    run_steps(wl, singles[:2], gen, focal_block)
    k1_peak = (torch.cuda.max_memory_allocated(),
               torch.cuda.max_memory_reserved())
    torch.cuda.reset_peak_memory_stats()
    cap_s, _ = run_windows(wl, windows[:1], gen, k, focal_block)
    cap_peak = (torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved())
    reset_launch_counts()
    run_windows(wl, windows[1:2], gen, k, focal_block)
    check_launches(f"window {what}", launch_counts(),
                   {n: k * v for n, v in per_step.items()})

    # the same generator state, eager and replayed (the graph the first
    # windows captured: all 8 steps replayed)
    eager_wl = copy_of()
    gen2 = torch.Generator(device=dev)
    gen2.set_state(gen.get_state())
    offset0 = _philox_offset(gen)
    _, eager_gen_losses = run_windows(eager_wl, windows[3:4], gen2, k,
                                      focal_block, graph=False)
    _, graph_gen_losses = run_windows(wl, windows[3:4], gen, k, focal_block)
    offsets = (offset0, _philox_offset(gen), _philox_offset(gen2))
    del eager_wl
    # the same draws, eager twice and replayed (a graph of its own: the
    # window's first step eager, 7 replayed)
    d = draws()
    eager_wl, eager2_wl = copy_of(), copy_of()
    _, eager_losses = run_windows(eager_wl, windows[2:3], None, k,
                                  focal_block, draws=[d], graph=False)
    _, eager2_losses = run_windows(eager2_wl, windows[2:3], None, k,
                                   focal_block, draws=[d], graph=False)
    _, graph_losses = run_windows(wl, windows[2:3], None, k, focal_block,
                                  draws=[d])
    differ = {"replayed": _params_differ(wl["state"].field,
                                         eager_wl["state"].field),
              "eager": _params_differ(eager2_wl["state"].field,
                                      eager_wl["state"].field)}
    equal = {"replayed": graph_losses[0] == eager_losses[0]
             and graph_gen_losses[0] == eager_gen_losses[0]
             and not differ["replayed"],
             "eager": eager2_losses[0] == eager_losses[0]
             and not differ["eager"]}
    del eager_wl, eager2_wl
    log(f"[window] {what}: replayed against eager, the same draws: losses "
        f"{graph_losses[0]} vs {eager_losses[0]} (two eager windows: "
        f"{eager2_losses[0]}); the same generator: losses "
        f"{graph_gen_losses[0]} vs {eager_gen_losses[0]}, Philox offset "
        f"{offsets[0]} -> {offsets[1]} (eager {offsets[2]}); every loss and "
        f"parameter bit for bit: replayed against eager "
        f"{equal['replayed']}, two eager windows {equal['eager']} "
        f"(parameters apart: {differ})")
    if not all(equal.values()):
        raise AssertionError(f"window {what}: not bit for bit: {equal}, "
                             f"parameters apart {differ}")
    if offsets[1] != offsets[2] or offsets[1] == offsets[0]:
        raise AssertionError(f"window {what}: the replays left the "
                             f"generator at {offsets[1]}, eager steps at "
                             f"{offsets[2]} (from {offsets[0]})")

    # no host sync in a replayed window (the same-draws graph)
    fn = wl["window_fns"][(0 if focal_block is None else 1, k)]
    fine = torch.full((k,), float(wl["fineness"]), device=dev)
    d = draws()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        wl["state"], wl["oct_dev"], _, _ = fn(
            wl["state"], wl["oct_dev"], wl["cams"], windows[4], fine,
            active_block=focal_block or 0, draws=d)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    # the generator's graph again before the timed windows
    run_windows(wl, windows[7:8], gen, k, focal_block)

    # timed in turns
    turns = {"k1": [], "k8": [], "k1_peak": [], "k8_peak": []}
    run_steps(wl, singles[:1], gen, focal_block)
    for t in range(WINDOW_TIMED):
        torch.cuda.reset_peak_memory_stats()
        times, _ = run_steps(wl, singles[1:], gen, focal_block)
        turns["k1"].append(float(np.mean(times)))
        turns["k1_peak"].append(torch.cuda.max_memory_allocated())
        torch.cuda.reset_peak_memory_stats()
        times, _ = run_windows(wl, windows[5 + t:6 + t], gen, k,
                               focal_block)
        turns["k8"].append(float(np.sum(times)) / k)
        turns["k8_peak"].append(torch.cuda.max_memory_allocated())
    reserved = torch.cuda.memory_reserved()
    parent_turns = parent_window_turns(wl, windows[5:7], gen, focal_block)
    if parent_turns:
        log(f"[window] {what}: replayed windows in turns with the parent "
            f"tree's H2 ({PARENT.dir}), on {CARD}, s/step: this "
            f"{parent_turns['this']}, the parent's {parent_turns['parent']}")
    win_s = []

    def one_window():
        t0 = time.perf_counter()
        run_windows(wl, windows[-1:], gen, k, focal_block)
        win_s.append(time.perf_counter() - t0)

    prof, traced = traced_window_launches(
        what, one_window, {n: k * v for n, v in per_step.items()})
    win_s[:] = win_s[-1:]
    busy = prof["device_busy_ms"] / (win_s[0] * 1e3)
    out = {"capture_window_s": cap_s[0], "s_per_step_k1": turns["k1"],
           "s_per_step_k8": turns["k8"], "peak_bytes_k1": turns["k1_peak"],
           "peak_bytes_k8_replays": turns["k8_peak"],
           "k1_peak_bytes_fresh": k1_peak[0],
           "k1_peak_reserved_bytes_fresh": k1_peak[1],
           "capture_peak_bytes": cap_peak[0],
           "capture_peak_reserved_bytes": cap_peak[1],
           "reserved_bytes_after": reserved,
           "profiled_window_s": win_s[0],
           "window_device_busy_ms": prof["device_busy_ms"],
           "window_busy_share": busy, "window_traced_launches": traced,
           "step_repeats": repeats, "bit_for_bit": equal,
           **({"parent_turns_s_per_step_k8": parent_turns}
              if parent_turns else {})}
    log(f"[window] {what}: s/step K=1 {turns['k1']} vs K={k} "
        f"{turns['k8']}; peak GiB allocated: K=1 "
        f"{[round(x / 2**30, 3) for x in turns['k1_peak']]} (from an "
        f"emptied cache and no graph {k1_peak[0] / 2**30:.3f}, reserved "
        f"{k1_peak[1] / 2**30:.3f}), the capture "
        f"window {cap_peak[0] / 2**30:.3f} (reserved "
        f"{cap_peak[1] / 2**30:.3f}), replayed windows outside the graph's "
        f"pool {[round(x / 2**30, 3) for x in turns['k8_peak']]}; a window "
        f"{win_s[0]:.4f} s, device busy {prof['device_busy_ms']:.2f} ms "
        f"({busy:.1%}), its launches in the trace {traced}; the capture's "
        f"window {cap_s[0]:.2f} s")
    return out


def parent_step_turns(wl, batches, gen, focal_block=None) -> dict:
    """With a parent tree: single train steps (``run_steps``, each ending
    in a synchronize) on ``batches`` from a copy of ``wl``'s state, in
    turns over this tree's and the parent's H2 and H5 (parent, this, this,
    parent, after a warm-up step of each); {form: [mean s/step of each
    turn]}, or {} without a parent."""
    import contextlib

    import numpy as np

    from gfnerf_tpu_torch.train_bench import run_steps

    if PARENT is None:
        return {}
    cwl = workload_copy(wl)
    turns = {"parent": [], "this": []}
    for form in ("parent", "this", "parent", "this", "this", "parent"):
        with (parent_table_grads() if form == "parent"
              else contextlib.nullcontext()):
            times, _ = run_steps(cwl, batches, gen, focal_block)
        turns[form].append(float(np.mean(times)))
    # the first turn of each warmed its form up
    return {form: ts[1:] for form, ts in turns.items()}


def parent_window_turns(wl, windows, gen, focal_block=None) -> dict:
    """With a parent tree: the K = WINDOW_K windows ``windows`` replayed
    in turns (parent, this, this, parent) from ``wl``'s state and from a
    copy of it whose graph was captured over the parent's H2 and H5;
    {form: [s/step of each turn]}, or {} without a parent."""
    import contextlib

    import numpy as np

    from gfnerf_tpu_torch.train_bench import run_windows

    if PARENT is None:
        return {}
    pwl = workload_copy(wl)
    with parent_table_grads():
        run_windows(pwl, windows[:1], gen, WINDOW_K, focal_block)  # capture
    turns = {"parent": [], "this": []}
    for form in ("parent", "this", "this", "parent"):
        with (parent_table_grads() if form == "parent"
              else contextlib.nullcontext()):
            times, _ = run_windows(pwl if form == "parent" else wl, windows,
                                   gen, WINDOW_K, focal_block)
        turns[form].append(float(np.sum(times)) / (WINDOW_K * len(times)))
    for fn in pwl["window_fns"].values():
        fn.reset()
    return turns


# gf-nerf-perf's window with the field recomputed in the backward:
# train_bench's "perf160" workload (gf-nerf-perf's field and its 160-slot
# march) at remat_chunks 8 (the mid-scale run's override,
# midscale_run.py), its windows compared in turns with single steps at
# remat 8, and its memory with the same window at remat 0
WINDOW_REMAT_CHUNKS = 8
WINDOW_REMAT_CONFIG = "perf160"


def remat_window_checks() -> dict:
    """A K = WINDOW_K window of gf-nerf-perf at remat_chunks
    WINDOW_REMAT_CHUNKS on the card (``torch.utils.checkpoint`` inside the
    captured step).  Checked: the window captured and replayed against the
    same window run eagerly from deep copies of the state and the same
    injected draws (every loss and parameter bit for bit); a
    replayed window's launches, K times an eager step's, by the counters
    and by the kernels' records in a profiled replayed window's trace (the
    recomputed encode launches H1 again in the backward).  Timed in turns:
    8 single steps and replayed windows at remat 8, s/step; peak memory
    allocated and reserved of the replays at remat 8 and of the capture
    window at remat 8 and, from the same emptied cache, at remat 0."""
    import dataclasses

    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields.field import STAGE_INIT
    from gfnerf_tpu_torch.model_components.losses import s3im_permutations
    from gfnerf_tpu_torch.models.gfnerf import make_train_step
    from gfnerf_tpu_torch.train_bench import (RAYS, build_train_workload,
                                              make_batch, run_steps,
                                              run_windows, stack_window)

    k = WINDOW_K
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    base = build_train_workload(dev, seed=0, config=WINDOW_REMAT_CONFIG)
    setup_s = time.perf_counter() - t0
    gen = torch.Generator(device=dev).manual_seed(11)

    def at(chunks):
        mcfg = dataclasses.replace(base["mcfg"], remat_chunks=chunks)
        return {**base, "mcfg": mcfg, "window_fns": {},
                "step_fn": make_train_step(mcfg, base["scfg"], base["tx"],
                                           STAGE_INIT)}

    def draws():
        return {"noise": torch.rand((k, RAYS, base["scfg"].max_samples),
                                    generator=gen, device=dev) + 0.5,
                "s3im_perms": torch.stack([s3im_permutations(
                    RAYS, generator=gen, device=dev) for _ in range(k)])}

    n_windows = 4 + WINDOW_TIMED
    flat = [make_batch(base["images"], RAYS, 2900 + i, dev)
            for i in range(n_windows * k + 1 + WINDOW_SINGLE_STEPS)]
    windows = [stack_window(flat[i * k:(i + 1) * k])
               for i in range(n_windows)]
    singles = flat[n_windows * k:]

    def peaks():
        return (torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved())

    def fresh():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()

    # remat 0: the capture window from an emptied cache and no graph, a
    # copy of the state held (as at remat 8 below)
    plain = at(0)
    held = workload_copy(plain)
    fresh()
    run_windows(plain, windows[:1], None, k, draws=[draws()])
    plain_capture = peaks()
    for fn in plain["window_fns"].values():
        fn.reset()
    del held, plain

    # remat 8: the same draws captured and, from a copy, eager
    rwl = at(WINDOW_REMAT_CHUNKS)
    d = draws()
    eager_wl = workload_copy(rwl)
    fresh()
    cap_s, graph_losses = run_windows(rwl, windows[2:3], None, k, draws=[d])
    remat_capture = peaks()
    _, eager_losses = run_windows(eager_wl, windows[2:3], None, k,
                                  draws=[d], graph=False)
    fn = rwl["window_fns"][(STAGE_INIT, k)]
    if fn.captures != 1:
        raise AssertionError(f"window remat: {fn.captures} captures")
    differ = _params_differ(rwl["state"].field, eager_wl["state"].field)
    equal = graph_losses[0] == eager_losses[0] and not differ
    del eager_wl
    log(f"[window] remat {WINDOW_REMAT_CHUNKS} ({WINDOW_REMAT_CONFIG}): "
        f"replayed against eager, the same draws: losses {graph_losses[0]} "
        f"vs {eager_losses[0]}; every loss and parameter bit for bit: "
        f"{equal} (apart: {differ})")
    if not equal:
        raise AssertionError(f"window remat: not bit for bit, parameters "
                             f"apart {differ}")

    # a replayed window launches K times what an eager step launches: by
    # the counters, and by the kernels' records in a replayed window's
    # trace (the checkpoint's recompute launches H1 again in the backward)
    before = launch_counts()
    run_steps(rwl, singles[:1], gen)
    mid = launch_counts()
    run_windows(rwl, windows[3:4], None, k, draws=[draws()])
    after = launch_counts()
    step_launches = {n: mid[n] - before[n] for n in mid}
    window_launches = {n: after[n] - mid[n] for n in mid}
    if window_launches != {n: k * v for n, v in step_launches.items()} \
            or step_launches["packed_hash_fwd"] != 2 * WINDOW_REMAT_CHUNKS:
        raise AssertionError(f"window remat: a replayed window launched "
                             f"{window_launches}, a step {step_launches}")
    prof, traced = traced_window_launches(
        "remat", lambda: run_windows(rwl, windows[1:2], None, k,
                                     draws=[draws()]),
        {n: k * step_launches[n] for n in WINDOW_KERNEL_NAMES})

    # timed in turns: single steps at remat 8 against replayed windows
    turns = {"k1": [], "k8": [], "k1_peak": [], "k8_peak": []}
    for t in range(WINDOW_TIMED):
        torch.cuda.reset_peak_memory_stats()
        times, _ = run_steps(rwl, singles[1:], gen)
        turns["k1"].append(float(np.mean(times)))
        turns["k1_peak"].append(peaks())
        torch.cuda.reset_peak_memory_stats()
        times, _ = run_windows(rwl, windows[4 + t:5 + t], None, k,
                               draws=[draws()])
        turns["k8"].append(float(np.sum(times)) / k)
        turns["k8_peak"].append(peaks())
    for fn in rwl["window_fns"].values():
        fn.reset()
    del rwl, base
    torch.cuda.empty_cache()
    gib = 2.0 ** 30
    out = {"config": WINDOW_REMAT_CONFIG,
           "remat_chunks": WINDOW_REMAT_CHUNKS, "setup_s": setup_s,
           "capture_window_s": cap_s[0],
           "s_per_step_k1": turns["k1"], "s_per_step_k8": turns["k8"],
           "peak_bytes_k1": [a for a, _ in turns["k1_peak"]],
           "peak_reserved_bytes_k1": [r for _, r in turns["k1_peak"]],
           "peak_bytes_k8_replays": [a for a, _ in turns["k8_peak"]],
           "peak_reserved_bytes_k8_replays": [r for _, r in
                                              turns["k8_peak"]],
           "capture_peak_bytes": remat_capture[0],
           "capture_peak_reserved_bytes": remat_capture[1],
           "remat0_capture_peak_bytes": plain_capture[0],
           "remat0_capture_peak_reserved_bytes": plain_capture[1],
           "step_launches": step_launches, "window_traced_launches": traced,
           "window_device_busy_ms": prof["device_busy_ms"],
           "bit_for_bit": equal}
    log(f"[window] remat {WINDOW_REMAT_CHUNKS}: s/step K=1 {turns['k1']} "
        f"vs K={k} {turns['k8']}; "
        f"peak GiB allocated / reserved: the capture window "
        f"{remat_capture[0] / gib:.3f} / {remat_capture[1] / gib:.3f} at "
        f"remat {WINDOW_REMAT_CHUNKS}, {plain_capture[0] / gib:.3f} / "
        f"{plain_capture[1] / gib:.3f} at remat 0; replayed windows "
        f"{[round(a / gib, 3) for a, _ in turns['k8_peak']]} / "
        f"{[round(r / gib, 3) for _, r in turns['k8_peak']]}; single "
        f"steps {[round(a / gib, 3) for a, _ in turns['k1_peak']]} / "
        f"{[round(r / gib, 3) for _, r in turns['k1_peak']]}; a step's "
        f"launches {step_launches}, a replayed window's in its trace "
        f"{traced}; the workload in {setup_s:.1f}s")
    return out


def phase_window(tmp: Path, wl=None):
    """K = 8 steps a dispatch on the card: ``window_checks`` on the
    quality workload (``wl``, the main flow's, or built here) at the init
    and focal stages and on the prop workload at the init stage, all at
    8192 rays (the Trainer's windows: ``phase_pipeline``), and
    ``remat_window_checks``: gf-nerf-perf's window at remat_chunks 8
    replayed against the same window eager, its launches counted and
    traced, timed against single steps, its memory against the window at
    remat 0.  Counted: every
    launch of the phase (the replays', the eager windows', the single
    steps')."""
    import torch

    from gfnerf_tpu_torch.models.gfnerf import init_train_state
    from gfnerf_tpu_torch.train_bench import build_train_workload

    dev = torch.device("cuda")
    reset_launch_counts()
    stats = {}
    if wl is None:
        wl = build_train_workload(dev, seed=0, config="quality")
    stats["quality_init"] = window_checks(wl, "quality init")
    wl["state"] = init_train_state(wl["field"], wl["tx"])
    stats["quality_focal"] = window_checks(wl, "quality focal",
                                           focal_block=0)
    wl.pop("window_fns", None)
    launches = launch_counts()
    prop = build_train_workload(dev, seed=0, config="prop")
    reset_launch_counts()
    stats["prop_init"] = window_checks(prop, "prop init")
    del prop
    torch.cuda.empty_cache()
    for name, n in launch_counts().items():
        launches[name] += n
    reset_launch_counts()
    stats["remat"] = remat_window_checks()
    for name, n in launch_counts().items():
        launches[name] += n
    return launches, stats


# gf-nerf, the paper's registered method, through the Trainer at its full
# width: 8192 rays, 1024 march slots and a budget of 256 field samples a
# ray (the compacted branch), the anchored layout of 16 levels x 2
# channels of 2^21 entries, 10 blocks, f32 MLPs of width 128.  Cut: 10 init
# steps (the config's 30 k) with the milestone rebuild at 8 (2000) and the
# fineness anneal over 8 steps (10 k), then 2 steps on each of the first 2
# of the 10 blocks (10 k each); an eval batch every 7 steps, an eval image
# and the checkpoint at 14.  The octree and the widths are the config's.
GFNERF_INIT_STEPS = 10
GFNERF_FOCAL_BLOCKS = 2
GFNERF_STEPS = GFNERF_INIT_STEPS + 2 * GFNERF_FOCAL_BLOCKS
GFNERF_OVERRIDES = {
    **{f"pipeline.{part}.{key}": value
       for part in ("model", "datamanager", "optimizers")
       for key, value in (("steps_perssampler_init", str(GFNERF_INIT_STEPS)),
                          ("steps_per_split_dataset", "2"))},
    "pipeline.sampler.sub_div_milestones": "8",
    "pipeline.sampler.ray_march_fineness_decay_end_iter": "8",
    "steps_per_eval_batch": "7",
    "steps_per_eval_image": str(GFNERF_STEPS),
    "steps_per_save": str(GFNERF_STEPS),
}
# (slots, budget, levels, channels, log2 entries, blocks, hidden width,
# MLP type, layout, rays a step)
GFNERF_WIDTH = (1024, 256, 16, 2, 21, 10, 128, "float32", "anchored", 8192)
GFNERF_REMAT_CHUNKS = 8
# the steps a second Trainer runs again from the same seed (before the
# milestone rebuild), held bit for bit against the run's
GFNERF_REPEAT_STEPS = 8
# early termination at eps = 0 against the single pass: the JAX tests'
# tolerance (tests/test_render_early.py), the head and tail composited
# apart
ET_RTOL, ET_ATOL = 1e-4, 1e-5
ET_EPS = 5e-3


def _step_counts() -> dict:
    """The launch counters and H4's and H5's call counters."""
    from gfnerf_tpu_torch.fields.hash_encoding import hash_encode

    return {**launch_counts(), "hash_anchored_fwd_calls": hash_encode.calls,
            "hash_anchored_bwd_calls": hash_encode.bwd_calls}


def compacted_points(p, batch, noise, fineness):
    """A train batch's marched samples compacted as model_forward does at
    the pipeline's budget, without a host sync: compact_samples and a
    scatter back run under torch.cuda.set_sync_debug_mode("error"), where
    a sync raises.  Returns the normalized points (K, 3), their anchors
    (K,) and the number of kept samples."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.models.gfnerf import (compact_samples, sample_rays,
                                                scatter_slots)

    budget = p.config.model.samples_budget_per_ray
    with torch.no_grad():
        rays = generate_rays_multi(p.cameras_dev, batch["camera_indices"],
                                   batch["coords"])
        smp = sample_rays(p.sampler.oct_dev, rays["origins"],
                          rays["directions"], noise, fineness,
                          p.sampler.sampler_config)
        torch.cuda.synchronize()
        r, s = smp.valid.shape
        torch.cuda.set_sync_debug_mode("error")
        try:
            idx, anc, _, warp = compact_samples(smp, budget,
                                                p.sampler.oct_dev,
                                                p.field_cfg)
            back = scatter_slots(idx, torch.ones_like(warp[:, 0]), r, s)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        keep = smp.valid & (torch.cumsum(smp.valid.int(), 1) <= budget)
        n_kept = int(keep.sum())
        if not (torch.equal(back != 0, keep)
                and int((idx < r * s).sum()) == n_kept):
            raise AssertionError("compaction: the kept slots are not each "
                                 "ray's first budget valid samples")
    return (warp + 1.5) * (1.0 / 3.0), anc, n_kept


def time_anchored_at(table, addr, what, parent=False) -> tuple:
    """H4 and H5 at one shape: each equal to its plain version bit for bit
    (H5 also called again and on the points permuted: check_table_grad),
    H5's reductions per level held against the host's reckoning; each
    timed (10 calls per event pair) against its plain version, H5 also
    against index_add_ of the same terms (and with ``parent`` in turns
    with the parent tree's: against_parent); bounds from the bytes.
    Returns (H4's, H5's report)."""
    import torch

    from gfnerf_tpu_torch.fields import hash_encoding as he

    n_levels, local, c = table.shape
    p = addr[2].shape[0]
    want = he.hash_encode_raw(table, *addr)
    got = he._hash_encode_cuda(table, *addr)
    torch.cuda.synchronize()
    fwd_err = max_err([got], [want])
    if not torch.equal(got, want):
        raise AssertionError(f"{what} hash_anchored_fwd: max abs err "
                             f"{fwd_err}, not equal bit for bit")
    del got, want
    n_bytes = hash_fwd_bytes(p, n_levels, c, table.numel())
    fwd = {"max_abs_err": fwd_err,
           "ms": time_ms(lambda: he._hash_encode_cuda(table, *addr), n=11,
                         reps=10),
           "plain_ms": time_ms(lambda: he.hash_encode_raw(table, *addr),
                               n=3),
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": None, "points": p}
    gen = torch.Generator(device="cuda").manual_seed(8)
    g = torch.randn((p, n_levels * c), generator=gen, device="cuda")
    args = (g, *addr, local, c)
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    he._hash_backward_cuda(*args, red_ops=ops)
    reckoned = he.hash_bwd_reductions(*args)
    check_table_grad(f"{what} hash_anchored_bwd", he._hash_backward_cuda,
                     he.hash_backward_reference, args)
    if ops.tolist() != reckoned.tolist():
        raise AssertionError(f"{what} hash_anchored_bwd: reductions "
                             f"{ops.tolist()}, reckoned {reckoned.tolist()}")
    shape = (n_levels, p, local, c)
    parts = check_call_counts(
        what, lambda: he._hash_backward_cuda(*args), he.hash_encode,
        "hash_anchored_bwd", he.table_grad_launches(*shape),
        he.table_grad_memsets(*shape))
    bwd_err = 0.0
    terms = list(he.hash_scatter_terms(*args))
    rows = torch.cat([t[0] for t in terms])
    payload = torch.cat([t[1] for t in terms])
    del terms
    n_bytes = hash_bwd_bytes(p, n_levels, c, table.numel())
    bwd = {**(against_parent(what, "hash_anchored_bwd", "h5", args)
              if parent else {}),
           "max_abs_err": bwd_err,
           "ms": time_ms(lambda: he._hash_backward_cuda(*args), n=11),
           "plain_ms": time_ms(lambda: he.hash_backward_reference(*args),
                               n=3),
           "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
           "library_ms": time_ms(lambda: torch.zeros(
               (n_levels * local, c), device="cuda").index_add_(
                   0, rows, payload), n=5),
           "points": p, "reductions": int(ops.sum()),
           "small": he.small_table_grad(n_levels, local, c),
           "parts": parts}
    del rows, payload, g
    torch.cuda.empty_cache()
    for name, x in (("hash_anchored_fwd", fwd), ("hash_anchored_bwd", bwd)):
        log(f"[{what}] {name} at K={p}, L={n_levels}, C={c}, local={local}:"
            f" max abs err {x['max_abs_err']:.3g}; kernel {x['ms']:.4f} ms, "
            f"plain {x['plain_ms']:.4f} ms, "
            + (f"index_add_ {x['library_ms']:.4f} ms, "
               if x["library_ms"] is not None else "")
            + f"bound {x['bound_ms']:.4f} ms")
    return fwd, bwd


def table_grad_breakdown(fn, match: str, calls: int = 5, want=None) -> dict:
    """{kernel: [launches, device ms] a call} of a table gradient's call
    fn(), the kernels whose names hold ``match`` and the zero-fills
    ("memset"), from a torch.profiler trace of ``calls`` calls; with
    ``want`` (launches, zero-fills) a call, traced again (profiled_counts)
    while the trace holds other counts."""
    import re

    import torch
    from torch.autograd import DeviceType

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()

    def key(e):
        if e.device_type != DeviceType.CUDA:
            return None
        if "memset" in e.key.lower():
            return "memset"
        hit = re.search(r"(\w*%s\w*)" % match, e.key)
        return hit.group(1) if hit else None

    def done(counts):
        n = sum(c for k, (c, _) in counts.items() if k != "memset")
        return (n, counts.get("memset", (0, 0.0))[0]) == (
            want[0] * calls, want[1] * calls)

    counts, _ = profiled_counts(run, key, done if want else None)
    return {k: [n / calls, us / 1e3 / calls]
            for k, (n, us) in sorted(counts.items())}


def check_call_counts(what, fn, counter, match, launches, memsets) -> dict:
    """One call of a table gradient fn() (H2's wrapper: ``counter`` is
    packed_hash_encode; H5's: hash_encode): the launches and zero-fills its
    C entry point counted must equal the host's reckoning, and so must the
    kernels whose names hold ``match`` and the memsets of a profiled call
    (table_grad_breakdown) unless the profiler loses records in every try
    (then logged, as kernel_device_ms does).  Returns the breakdown."""
    import torch

    before = (counter.bwd_launches, counter.bwd_memsets)
    fn()
    torch.cuda.synchronize()
    counted = (counter.bwd_launches - before[0],
               counter.bwd_memsets - before[1])
    if counted != (launches, memsets):
        raise AssertionError(
            f"{what}: (launches, zero-fills) a call counted {counted}, "
            f"reckoned {(launches, memsets)}")
    parts = table_grad_breakdown(fn, match, want=(launches, memsets))
    traced = (sum(n for k, (n, _) in parts.items() if k != "memset"),
              parts.get("memset", [0, 0.0])[0])
    if traced != (launches, memsets):
        log(f"[profiler] {what}: no whole trace of a table gradient's "
            f"{(launches, memsets)} launches and zero-fills a call "
            f"(traced {traced}); the counted ones stand")
    log(f"[{what}] a call: {launches} launches and {memsets} zero-fills, "
        f"counted as reckoned, traced {traced}; device ms a call by kernel "
        f"{json.dumps(parts)}")
    return parts


def table_grad_shapes(quality, parity) -> tuple:
    """The inputs of H2 and H5 at the shapes of their PERF.md rows, from one
    march of each workload ((wl, points, anchors) of a quality and a parity
    train batch): H2 at the quality train batch (8192 x 384 samples) and at
    the probe's shape (its first 256 slots a ray, 4 levels of 2^12 rows);
    H5 at the parity train batch, and at gf-nerf's (2,097,152 points: the
    quality batch's first 256 slots, 16 x 2^21), nerfacto's three and
    instant-ngp's step (4096 rays of the quality batch: 256 slots, every
    4th's first 96, every 8th's first 48; every 2nd's first 192) on tables
    of one volume, every point valid.  Returns ({name: H2 args}, {name: H5
    args})."""
    import torch

    from gfnerf_tpu_torch.fields import hash_encoding as he
    from gfnerf_tpu_torch.fields import packed_hash as ph
    from gfnerf_tpu_torch.train_bench import RAYS

    gen = torch.Generator(device="cuda").manual_seed(21)

    def grad(p, cols):
        return torch.randn((p, cols), generator=gen, device="cuda")

    wl, pts, anc = quality
    field = wl["field"]
    n_levels, n_rows, width = field.global_feat.shape
    c = wl["fcfg"].features_per_level
    pack = ph.pack_for_channels(c)
    n_vol = field.global_prim.shape[1]
    s = pts.shape[0] // RAYS
    slots = pts.view(RAYS, s, 3)
    slot_anc = anc.view(RAYS, s)
    h2 = {"train batch": (grad(pts.shape[0], n_levels * c),
                          field.global_prim, field.global_bias, pts, anc,
                          n_rows, width, c, pack, 0)}
    _, prim, bias = ph.init_packed_hash_params(3, 12, n_vol, 4, c)
    probe = (slots[:, :256].reshape(-1, 3), slot_anc[:, :256].reshape(-1))
    h2["probe"] = (grad(probe[0].shape[0], 4 * c),
                   torch.as_tensor(prim.astype("int64"), device="cuda"),
                   torch.as_tensor(bias, device="cuda"), *probe, 1 << 12,
                   width, c, pack, 0)

    pwl, ppts, panc = parity
    pf = pwl["field"]
    n_lev, local, pc = pf.global_feat.shape
    h5 = {"parity batch": (grad(ppts.shape[0], n_lev * pc), pf.global_prim,
                           pf.global_bias, ppts, panc, local, pc)}

    def anchored(name, x, a, levels, log2, volumes):
        _, prim, bias = he.init_hash_params(5, log2, volumes, levels, 2)
        x = x.reshape(-1, 3).contiguous()
        a = a.reshape(-1).contiguous()
        h5[name] = (grad(x.shape[0], levels * 2),
                    torch.as_tensor(prim.astype("int64"), device="cuda"),
                    torch.as_tensor(bias, device="cuda"), x, a, 1 << log2, 2)

    anchored("gf-nerf", slots[:, :256], slot_anc[:, :256], 16, 21, n_vol)
    half = slots[:4096]
    zero = torch.zeros(half.shape[:2], dtype=torch.int32, device="cuda")
    anchored("nerfacto proposal 0", half[:, :256], zero[:, :256], 5, 17, 1)
    anchored("nerfacto proposal 1", half[:, ::4][:, :96],
             zero[:, ::4][:, :96], 5, 17, 1)
    anchored("nerfacto field", half[:, ::8][:, :48], zero[:, ::8][:, :48],
             16, 19, 1)
    anchored("instant-ngp step", half[:, ::2][:, :192],
             zero[:, ::2][:, :192], 16, 19, 1)
    return h2, h5


def phase_table_grads(tmp: Path):
    """H2 and H5 alone at the shapes of their PERF.md rows
    (table_grad_shapes), for work on the two kernels (``--only
    table-grads``; the whole script times them where its phases meet
    them): each equal to its plain version bit for bit (also called again
    and on the points permuted), its atomics or reductions per level
    against the host's reckoning, its time (11 samples) beside the
    library's sums of the same terms (library_sums_ms: index_add_ and the
    deterministic index_put_), its kernels' and zero-fills' device time a
    call (table_grad_breakdown); H5 at 1, 2, 4,
    8 and 16 levels a launch of its sums, in turns and equal bit for bit;
    with --parent, each in turns with the parent tree's."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.fields import hash_encoding as he
    from gfnerf_tpu_torch.fields import packed_hash as ph
    from gfnerf_tpu_torch.train_bench import (RAYS, build_train_workload,
                                              make_batch)

    dev = torch.device("cuda")

    def march(config):
        wl = build_train_workload(dev, seed=0, config=config)
        batch = make_batch(wl["images"], RAYS, 7, dev)
        noise, _ = step_draws(wl, torch.Generator(device=dev).manual_seed(3))
        rays = generate_rays_multi(wl["cams"], batch["camera_indices"],
                                   batch["coords"])
        pts, anc = _marched_points(wl, rays["origins"], rays["directions"],
                                   noise, wl.get("fineness", 1.0))
        return wl, pts, anc

    reset_launch_counts()
    h2, h5 = table_grad_shapes(march("quality"), march("parity"))
    stats = {}
    for name, args in h2.items():
        check_table_grad(f"[table-grads] H2 {name}",
                         ph._packed_hash_backward_cuda,
                         ph.packed_hash_backward_reference, args)
        g, prim, bias, pts, anc, n_rows, width, c, pack, dense = args
        ops = torch.zeros(prim.shape[0], dtype=torch.int64, device="cuda")
        ph._packed_hash_backward_cuda(*args, red_ops=ops)
        want = ph.packed_hash_bwd_reductions(prim, bias, pts, anc, n_rows, c,
                                             pack, dense)
        if ops.tolist() != want.tolist():
            raise AssertionError(f"H2 {name}: atomics {ops.tolist()}, "
                                 f"reckoned {want.tolist()}")
        rows = []   # per level: rows with records, the largest, long ones
        for h, _, _ in ph._level_rows(prim, bias, pts, anc, n_rows, pack,
                                      dense):
            cnt = torch.bincount(h[anc >= 0], minlength=n_rows)
            long_rows = cnt > ph.BWD_CHUNK
            rows.append([int((cnt > 0).sum()), int(cnt.max()),
                         int(long_rows.sum()), int(cnt[long_rows].sum())])
        st = {"points": pts.shape[0], "atomics": ops.tolist(),
              "rows_used_largest_long_records_in_long": rows,
              "ms": time_ms(lambda: ph._packed_hash_backward_cuda(*args),
                            n=11),
              **library_sums_ms(
                  [(rw[:, None] * c + torch.arange(c, device="cuda"), v)
                   for rw, v in ph.packed_hash_scatter_terms(*args)],
                  prim.shape[0] * n_rows * width),
              "parts": table_grad_breakdown(
                  lambda: ph._packed_hash_backward_cuda(*args),
                  "packed_hash_bwd"),
              **against_parent("table-grads", f"H2 {name}", "h2", args)}
        log(f"[table-grads] H2 {name} on {CARD}: {json.dumps(st)}")
        stats[f"h2 {name}"] = st
    for name, args in h5.items():
        g, prim, bias, pts, anc, local, c = args
        n_levels = prim.shape[0]
        got = check_table_grad(f"[table-grads] H5 {name}",
                               he._hash_backward_cuda,
                               he.hash_backward_reference, args)
        want = he.hash_bwd_reductions(*args)
        groups = sorted({min(k, n_levels) for k in (1, 2, 4, 8, 16)})
        for k in groups:
            ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
            other = he._hash_backward_cuda(*args, red_ops=ops,
                                           levels_per_launch=k)
            if not torch.equal(other, got):
                raise AssertionError(f"H5 {name}: {k} levels a launch "
                                     f"differs")
            if ops.tolist() != want.tolist():
                raise AssertionError(f"H5 {name} at {k} levels a launch: "
                                     f"reductions {ops.tolist()}, reckoned "
                                     f"{want.tolist()}")
        del got, other
        by_group = in_turns(
            {k: (lambda k=k: he._hash_backward_cuda(
                *args, levels_per_launch=k)) for k in groups},
            groups + groups[::-1], n=11)
        st = {"points": pts.shape[0], "levels": n_levels, "entries": local,
              "group": he.table_grad_group(n_levels, local, c),
              "reductions": want.tolist(),
              "terms": 8 * c * n_levels * int((anc >= 0).sum()),
              "ms": time_ms(lambda: he._hash_backward_cuda(*args), n=11),
              **library_sums_ms(
                  [(rw[:, None] * c + torch.arange(c, device="cuda"), v)
                   for rw, v in he.hash_scatter_terms(*args)],
                  n_levels * local * c),
              "levels_a_launch_ms": by_group,
              "parts": {k: table_grad_breakdown(
                  lambda: he._hash_backward_cuda(*args, levels_per_launch=k),
                  "hash_anchored_bwd") for k in (groups[0], groups[-1])},
              **against_parent("table-grads", f"H5 {name}", "h5", args)}
        log(f"[table-grads] H5 {name} on {CARD}: {json.dumps(st)}")
        stats[f"h5 {name}"] = st
    return launch_counts(), stats


def remat_step(p, chunks, batch, noise, perms) -> tuple:
    """One init-stage step at ``remat_chunks = chunks`` from a copy of the
    pipeline's field, optimizer state and octree.  Returns (the loss, the
    MLP and table gradients, the device memory the step held at its peak
    beyond what was allocated before it)."""
    import copy
    import dataclasses

    import torch

    from gfnerf_tpu_torch.engine.optimizers import field_param_grads
    from gfnerf_tpu_torch.models.gfnerf import TrainState, make_train_step

    step_fn = make_train_step(
        dataclasses.replace(p.config.model, remat_chunks=chunks),
        p.sampler.sampler_config, p.tx)
    field = copy.deepcopy(p.field)
    state = TrainState(field=field,
                       opt_state=copy.deepcopy(p.state.opt_state),
                       step=p.state.step)
    oct_dev = copy.deepcopy(p.sampler.oct_dev)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    before = torch.cuda.memory_allocated()
    state, _, metrics, _ = step_fn(state, oct_dev, p.cameras_dev, batch,
                                   1.0, noise=noise, s3im_perms=perms)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - before
    grads = field_param_grads(state.field)
    return float(metrics["loss"]), grads, peak


def profiled_step(p, wl, batch, noise, perms, focal_block=None,
                  fineness=1.0) -> dict:
    """One train step at ``fineness`` from a copy of the pipeline's state
    (an init-stage step, or with ``focal_block`` a block-stage step on
    that block from a fresh optimizer state), timed on the host clock to
    its synchronize, then the same step again under profile_device: the
    stages' device spans, the device's busy time and idle share, the
    busiest kernels, the host waits."""
    import copy

    import torch

    from gfnerf_tpu_torch.models.gfnerf import TrainState, init_train_state
    from gfnerf_tpu_torch.utils.profiling import profile_device

    focal = focal_block is not None
    step_fn = wl["focal_step_fn" if focal else "step_fn"]

    def fresh():
        field = copy.deepcopy(p.field)
        state = (init_train_state(field, p.tx) if focal else
                 TrainState(field=field,
                            opt_state=copy.deepcopy(p.state.opt_state),
                            step=p.state.step))
        return state, copy.deepcopy(p.sampler.oct_dev)

    def step(state, oct_dev):
        return step_fn(state, oct_dev, p.cameras_dev, batch, fineness,
                       noise=noise, s3im_perms=perms,
                       active_block=focal_block or 0)

    times = []
    for _ in range(2):
        state, oct_dev = fresh()
        torch.cuda.synchronize()
        t = time.perf_counter()
        step(state, oct_dev)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
        del state, oct_dev
    state, oct_dev = fresh()
    prof = profile_device(lambda: step(state, oct_dev))
    del state, oct_dev
    torch.cuda.empty_cache()
    step_ms = min(times) * 1e3
    prof["step_ms"] = step_ms
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / step_ms
    return prof


def check_early_term(p, what) -> dict:
    """The early-termination renderer on the trained field against the
    single pass, both through the kernels, on eval view 0's rays in one
    chunk.  Without compaction (budget 0): at eps = 0 equal (ET_RTOL,
    ET_ATOL), at eps = ET_EPS every ray within eps.  With the config's
    budget each phase caps its own segment's samples (the JAX package's
    ``_seg_cfg``), which the single pass does not, so there the difference
    is reported, not held.  The share of rays that survive phase 1 at
    each."""
    import dataclasses

    import torch

    from gfnerf_tpu_torch.cameras.cameras import (generate_rays,
                                                  get_image_coords)
    from gfnerf_tpu_torch.models.gfnerf import make_render_fn
    from gfnerf_tpu_torch.models.render_early import EarlyTermRenderer

    cams = p.datamanager.eval_dataparser_outputs.cameras
    h, w = int(cams.height[0]), int(cams.width[0])
    rays = generate_rays(p.eval_cameras_dev, 0, torch.as_tensor(
        get_image_coords(h, w), device=p.device))
    o = rays["origins"].reshape(-1, 3)
    d = rays["directions"].reshape(-1, 3)
    scfg = p.sampler.sampler_config
    args = (p.field, p.sampler.oct_dev, o, d, 0, 0,
            p.stage_of(int(p.state.step)) == 1)
    out = {}
    for budget in (0, p.config.model.samples_budget_per_ray):
        mcfg = dataclasses.replace(p.config.model,
                                   samples_budget_per_ray=budget)
        single = make_render_fn(mcfg, scfg)(*args)
        for eps in (0.0, ET_EPS):
            et = EarlyTermRenderer(mcfg, scfg, eps=eps)
            got = et.render_chunk(*args)
            torch.cuda.synchronize()
            errs = {k: float((got[k] - single[k]).abs().max())
                    for k in ("rgb", "accumulation", "depth")}
            out[f"budget {budget}, eps {eps}"] = {
                "survivors": et.last_survivor_frac, "errs": errs}
            log(f"[{what}] early termination, budget {budget}, eps {eps}: "
                f"s1 {et.s1} of {scfg.max_samples} slots, "
                f"{et.last_survivor_frac:.4f} of {o.shape[0]} rays survive "
                f"phase 1; max abs difference from the single pass {errs}")
            if budget:
                continue
            if eps == 0.0:
                for k in ("rgb", "accumulation", "depth"):
                    if not torch.allclose(got[k], single[k], rtol=ET_RTOL,
                                          atol=ET_ATOL):
                        raise AssertionError(
                            f"early termination at eps 0: {k} differs from "
                            f"the single pass")
            elif max(errs["rgb"], errs["accumulation"]) > eps + ET_ATOL:
                raise AssertionError(f"early termination at eps {eps}: a "
                                     f"ray off by {errs}")
    return out


def phase_gfnerf(tmp: Path):
    """gf-nerf through the Trainer at its full width (GFNERF_OVERRIDES) on
    the pipeline phase's synthetic scene, counted: every init and focal
    step launches K1, K2 and H5 once (H5 in one call of a launch per group
    of levels) and H4 once at the init stage, twice at the focal stage
    (the block's encode on the global one); the packed kernels never.
    Checked: finite losses; the milestone rebuild ran; 48 error-map
    renders; 10 clusters; each focal block's table alone changed in its
    split; eval batches, the eval image and the checkpoint.  Then, from
    the trained state: the compaction without a host sync; H4 and H5 at
    the compacted points (K = 8192 x 256) timed; one step against the
    plain autograd pairs; one step at remat_chunks 8 against one without
    (loss and gradients, and the peak memory of each); init steps at
    fineness 1 and 16 and a focal step profiled (profiled_step); the
    early termination renderer
    against the single pass (check_early_term); python -m
    gfnerf_tpu_torch.eval and .render on the checkpoint.  Timed: s/step
    (init, focal) and rays/s through the Trainer, peak memory, eval
    s/image, s/frame with and without early termination."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
    from gfnerf_tpu_torch.fields.hash_encoding import encode_launches
    from gfnerf_tpu_torch.render import read_png, spiral_cameras
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = tmp / "scene"
    if not scene.is_dir():
        make_synthetic_npz(scene, n_train=48, n_val=4, img_wh=(96, 72))

    def make_trainer(steps, out):
        cfg = get_method("gf-nerf")
        for key, value in {**GFNERF_OVERRIDES,
                           "max_num_iterations": str(steps),
                           "output_dir": str(tmp / out)}.items():
            apply_override(cfg, key, value)
        cfg.data = scene
        return Trainer(cfg, build_dataparser("minimal", scene))

    trainer = make_trainer(GFNERF_STEPS, "gfnerf_out")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SETUP_REUSE.note()   # this setup's reuses alone
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    fc, scfg, mcfg = p.field_cfg, p.sampler.sampler_config, p.config.model
    reused = SETUP_REUSE.note()
    log(f"[gfnerf] setup {setup_s:.2f}s ({reused})"
        f": {p.sampler.tree.n_nodes} nodes, "
        f"{p.sampler.n_volumes} volumes; S={scfg.max_samples}, budget "
        f"{mcfg.samples_budget_per_ray}, sample_l {scfg.sample_l:.6f}, "
        f"max_hits {scfg.max_hits}; {fc.hash_layout} {fc.num_levels} levels "
        f"x {fc.features_per_level} of 2^{fc.log2_hashmap_size}, "
        f"{fc.n_blocks} blocks, hidden {fc.hidden_dim}, {fc.mlp_dtype} MLPs,"
        f" {p.config.datamanager.train_num_rays_per_batch} rays a batch")
    width = (scfg.max_samples, mcfg.samples_budget_per_ray, fc.num_levels,
             fc.features_per_level, fc.log2_hashmap_size, fc.n_blocks,
             fc.hidden_dim, fc.mlp_dtype, fc.hash_layout,
             p.config.datamanager.train_num_rays_per_batch)
    if width != GFNERF_WIDTH:
        raise AssertionError(f"gf-nerf is not at its full width: {width}")

    rec = {"steps": {}, "rebuilds": [], "maps": 0, "evals": [],
           "split_checks": []}
    snap = {}
    get_loss, rebuild, render = (p.get_train_loss_dict,
                                 p.sampler.maybe_rebuild, p.render_camera)
    eval_batch, eval_image = (p.get_eval_loss_dict,
                              p.get_eval_image_metrics_and_images)

    def get_loss_w(step):
        k = p.sampler.cur_split_idx(step)
        if k >= 0 and (step == 0 or p.sampler.cur_split_idx(step - 1) != k):
            snap["k"], snap["stack"] = k, p.field.block_feats.detach().clone()
        before = _step_counts()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        if step == GFNERF_REPEAT_STEPS - 1:
            snap["repeat"] = {name: x.detach().clone() for name, x in
                              p.field.state_dict().items()}
        after = _step_counts()
        rec["steps"][step] = {"s": dt, "counts": {
            name: after[name] - before[name] for name in after}, **m}
        if k >= 0 and p.sampler.cur_split_idx(step + 1) != k:
            now = p.field.block_feats.detach()
            rec["split_checks"].append((snap.pop("k"), [
                b for b in range(now.shape[0])
                if not torch.equal(now[b], snap["stack"][b])]))
            del snap["stack"]
        return m

    def rebuild_w(step):
        n = p.sampler.tree.n_nodes
        t = time.perf_counter()
        done = rebuild(step)
        if done:
            rec["rebuilds"].append((step, n, p.sampler.tree.n_nodes,
                                    time.perf_counter() - t))
        return done

    def render_w(*args, **kw):
        rec["maps"] += kw.get("downscale") == 8
        return render(*args, **kw)

    def eval_batch_w(step):
        t = time.perf_counter()
        m = eval_batch(step)
        torch.cuda.synchronize()
        rec["evals"].append((step, time.perf_counter() - t,
                             float(m["eval_psnr"])))
        return m

    def eval_image_w(step, idx=0):
        t = time.perf_counter()
        metrics, images = eval_image(step, idx)
        rec["eval_image"] = (step, time.perf_counter() - t, metrics)
        return metrics, images

    p.get_train_loss_dict, p.sampler.maybe_rebuild = get_loss_w, rebuild_w
    p.render_camera, p.get_eval_loss_dict = render_w, eval_batch_w
    p.get_eval_image_metrics_and_images = eval_image_w

    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    p.get_train_loss_dict, p.sampler.maybe_rebuild = get_loss, rebuild
    p.render_camera = render
    p.get_eval_loss_dict, p.get_eval_image_metrics_and_images = \
        eval_batch, eval_image

    steps = rec["steps"]
    if sorted(steps) != list(range(GFNERF_STEPS)):
        raise AssertionError(f"gf-nerf: steps run {sorted(steps)}")
    losses = [steps[i]["loss"] for i in range(GFNERF_STEPS)]
    log(f"[gfnerf] losses {[round(x, 5) for x in losses]}; samples per ray "
        f"{[round(steps[i]['num_samples_per_ray'], 1) for i in steps]}")
    if not all(np.isfinite(losses)):
        raise AssertionError(f"gf-nerf: non-finite losses {losses}")
    h4_groups = encode_launches(fc.num_levels)
    h5_groups = table_grad_launches({"fcfg": fc},
                                    RAYS * mcfg.samples_budget_per_ray)
    for i in range(GFNERF_STEPS):
        h4 = 1 if i < GFNERF_INIT_STEPS else 2
        want = {"composite_fwd": 1, "composite_bwd": 1,
                "hash_anchored_fwd_calls": h4,
                "hash_anchored_fwd": h4 * h4_groups,
                "hash_anchored_bwd_calls": 1,
                "hash_anchored_bwd": h5_groups}
        got = steps[i]["counts"]
        if got != {name: want.get(name, 0) for name in got}:
            raise AssertionError(f"gf-nerf step {i}: launches {got}, "
                                 f"expected {want}")
    log(f"[gfnerf] launches per step as expected: K1, K2 and H5 (a call of "
        f"{h5_groups} launches) once, H4 once at init and twice at the "
        f"focal stage ({h4_groups} launches a call), packed kernels never; "
        f"in the whole run {launches}")
    log(f"[gfnerf] rebuilds (step, nodes before, after, s): "
        f"{[(s, a, b, round(t, 3)) for s, a, b, t in rec['rebuilds']]}")
    if [s for s, *_ in rec["rebuilds"]] != [8]:
        raise AssertionError(f"gf-nerf: rebuilds {rec['rebuilds']}")
    labels = p.sampler.cameras_labels
    if (rec["maps"] != 48 or labels is None
            or len(np.unique(labels)) != fc.n_blocks):
        raise AssertionError(f"gf-nerf transition: {rec['maps']} error maps,"
                             f" labels {labels}")
    log(f"[gfnerf] transition: 48 error-map renders, clusters "
        f"{np.bincount(labels, minlength=fc.n_blocks).tolist()}; blocks "
        f"changed in each split {rec['split_checks']}")
    if rec["split_checks"] != [(k, [k]) for k in range(GFNERF_FOCAL_BLOCKS)]:
        raise AssertionError(f"gf-nerf: blocks changed {rec['split_checks']}")
    step, image_s, metrics = rec["eval_image"]
    log(f"[gfnerf] eval batches (step, s, PSNR) {rec['evals']}; eval image "
        f"at step {step} in {image_s:.3f}s: {json.dumps(metrics)}")
    if len(rec["evals"]) != 2 or not np.isfinite(metrics["psnr"]):
        raise AssertionError("gf-nerf: eval batches or image missing")
    ckpt = trainer.checkpoint_dir / f"step-{GFNERF_STEPS - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"gf-nerf: no checkpoint at {ckpt}")
    rebuild_steps = {s for s, *_ in rec["rebuilds"]}
    init_s = [steps[i]["s"] for i in range(2, GFNERF_INIT_STEPS)
              if i not in rebuild_steps]
    focal_s = [steps[i]["s"] for i in range(GFNERF_INIT_STEPS + 1,
                                            GFNERF_STEPS, 2)]
    log(f"[gfnerf] s a step through the Trainer: "
        f"{[round(steps[i]['s'], 4) for i in range(GFNERF_STEPS)]}")
    log(f"[gfnerf] Trainer: {_mean(init_s):.4f} s/init step "
        f"({RAYS / _mean(init_s):.1f} rays/s), {_mean(focal_s):.4f} s/focal "
        f"step ({RAYS / _mean(focal_s):.1f} rays/s; the second of each "
        f"block's); peak {peak / 2**30:.3f} GiB; the run {train_s:.1f}s")

    # the first GFNERF_REPEAT_STEPS steps again, by a second Trainer from
    # the same config and seed (its setup reuses the tree and primes, and
    # it writes no checkpoint): every loss and every tensor of the field
    # bit for bit (H5 sums the table gradient exactly, in fixed point)
    again = make_trainer(GFNERF_REPEAT_STEPS, "gfnerf_again")
    again.setup()
    again.save_checkpoint = lambda step: None
    p_again, losses_again = again.pipeline, {}
    get_loss_again = p_again.get_train_loss_dict

    def get_loss_again_w(step):
        m = get_loss_again(step)
        losses_again[step] = float(m["loss"])
        return m

    p_again.get_train_loss_dict = get_loss_again_w
    again.train()
    repeat_apart = [name for name, x in p_again.field.state_dict().items()
                    if not torch.equal(x, snap["repeat"][name])]
    repeat_losses = [losses_again[i] == losses[i]
                     for i in range(GFNERF_REPEAT_STEPS)]
    del again, p_again, get_loss_again, snap["repeat"]
    torch.cuda.empty_cache()
    log(f"[gfnerf] a second Trainer's first {GFNERF_REPEAT_STEPS} steps "
        f"against the run's: losses equal {repeat_losses}, field tensors "
        f"apart {repeat_apart or 'none'}")
    if not all(repeat_losses) or repeat_apart:
        raise AssertionError("gf-nerf: a second run of the first steps "
                             "differs")

    # from the trained state
    images = np.asarray(p.datamanager.train_dataset.metadata[
        "images_array"], np.float32) / 255.0
    gen = torch.Generator(device=p.device).manual_seed(5)
    wl = {"field": p.field, "state": p.state, "tx": p.tx,
          "step_fn": p._train_step[STAGE_INIT],
          "focal_step_fn": p._train_step[STAGE_BLOCK],
          "oct_dev": p.sampler.oct_dev, "cams": p.cameras_dev,
          "fineness": 1.0, "scfg": scfg, "fcfg": fc}
    batch = make_batch(images, RAYS, 600, p.device)
    noise, perms = step_draws(wl, gen)
    pts, anc, n_kept = compacted_points(p, batch, noise, 1.0)
    log(f"[gfnerf] compaction of a train batch without a host sync "
        f"(set_sync_debug_mode error): {n_kept} of {RAYS} x "
        f"{scfg.max_samples} slots kept into K = {pts.shape[0]}")
    if pts.shape[0] != RAYS * mcfg.samples_budget_per_ray:
        raise AssertionError(f"compaction: K = {pts.shape[0]}")
    kernels = time_anchored_at(
        p.field.global_feat.detach(),
        (p.field.global_prim, p.field.global_bias, pts, anc), "gfnerf",
        parent=True)
    del pts, anc
    compare_step(wl, "gfnerf", batch, noise, perms)
    parent_steps = parent_step_turns(
        wl, [make_batch(images, RAYS, 610 + i, p.device) for i in range(4)],
        gen)
    if parent_steps:
        log(f"[gfnerf] init steps (eager, from a copy of the state) in turns "
            f"with the parent tree's H5 ({PARENT.dir}), on {CARD}, s/step: "
            f"this {parent_steps['this']}, the parent's "
            f"{parent_steps['parent']}")
    remat = {}
    for chunks in (0, GFNERF_REMAT_CHUNKS):
        remat[chunks] = remat_step(p, chunks, batch, noise, perms)
    (l0, g0, peak0), (l8, g8, peak8) = remat[0], remat[GFNERF_REMAT_CHUNKS]
    rel = abs(l8 - l0) / abs(l0)
    errs = {}
    for name in ("fields", "base_encoding_init"):
        scale = max(float(g.abs().max()) for g in g0[name])
        errs[name] = max(float((a - b).abs().max())
                         for a, b in zip(g8[name], g0[name])) / scale
    log(f"[gfnerf] one init step at remat_chunks {GFNERF_REMAT_CHUNKS} "
        f"against 0 from the same state: loss {l8:.7f} vs {l0:.7f} (rel "
        f"{rel:.3g}, tol {TRAIN_LOSS_RTOL}); gradients apart by {errs} of "
        f"the group's largest (tol {TRAIN_GRAD_TOL}); peak memory beyond "
        f"the state {peak8 / 2**30:.3f} GiB against {peak0 / 2**30:.3f} "
        f"GiB")
    if rel > TRAIN_LOSS_RTOL or max(errs.values()) > TRAIN_GRAD_TOL:
        raise AssertionError("remat: the step differs from the one without")
    del remat, g0, g8
    torch.cuda.empty_cache()
    # fineness 16: the first init steps' (the anneal starts there)
    profiles = {"init step": profiled_step(p, wl, batch, noise, perms),
                "init step at fineness 16": profiled_step(
                    p, wl, batch, noise, perms, fineness=16.0),
                "focal step": profiled_step(p, wl, batch, noise, perms, 0)}
    for stage, prof in profiles.items():
        spans = {k: round(v, 2)
                 for k, v in prof["stage_device_span_ms"].items()}
        top = [(k["name"][:60], round(k["device_ms"], 3), k["count"])
               for k in prof["top_kernels"][:8]]
        log(f"[gfnerf] one {stage}, profiled: {prof['step_ms']:.1f} ms "
            f"on the host clock (the faster of 2), device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}; stage device spans (ms) {spans}; "
            f"busiest kernels {top}; host waits {prof['host_waits']}")
    et = check_early_term(p, "gfnerf")

    # s/frame along a spiral of 3 frames at the eval views' size, without
    # and with early termination, in turns
    cams = spiral_cameras(p.datamanager.eval_dataparser_outputs.cameras,
                          steps=3)
    cams_dev = cams.to_device(p.device)
    frame_s = {False: [], True: []}
    for early in (False, True, True, False):
        p.config.eval_early_term = early
        p._build_early_renderer()
        for i in range(len(cams)):
            t = time.perf_counter()
            render(cams, cams_dev, i, int(p.state.step))
            torch.cuda.synchronize()
            frame_s[early].append(time.perf_counter() - t)
    p.config.eval_early_term = False
    p._build_early_renderer()
    log(f"[gfnerf] s/frame at {int(cams.width[0])}x{int(cams.height[0])} "
        f"along the spiral: {_mean(frame_s[False]):.4f} single pass, "
        f"{_mean(frame_s[True]):.4f} with early termination (eps "
        f"{p.config.eval_early_term_eps})")

    # the entry points on the checkpoint
    config_path = trainer.base_dir / "config.json"
    del trainer, p, wl, render, get_loss, rebuild, eval_batch, eval_image
    torch.cuda.empty_cache()
    t = time.perf_counter()
    eval_entry.main(["--load-config", str(config_path), "--output-path",
                     str(tmp / "gfnerf_eval.json")])
    eval_s = time.perf_counter() - t
    doc = json.loads((tmp / "gfnerf_eval.json").read_text())
    res = doc["results"]
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"gfnerf_tpu_torch.eval: {res}")
    torch.cuda.empty_cache()
    t = time.perf_counter()
    render_entry.main(["--load-config", str(config_path), "--traj",
                       "spiral", "--spiral-steps", "3", "--output-path",
                       str(tmp / "gfnerf_frames")])
    render_s = time.perf_counter() - t
    frames = sorted((tmp / "gfnerf_frames").glob("*.png"))
    shapes = [read_png(f).shape for f in frames]
    if len(frames) != 3 or any(s != (72, 96, 3) for s in shapes):
        raise AssertionError(f"gfnerf_tpu_torch.render wrote {frames} "
                             f"{shapes}")
    log(f"[gfnerf] python -m gfnerf_tpu_torch.eval on the checkpoint in "
        f"{eval_s:.2f}s: {json.dumps(res)} (s/image "
        f"{1.0 / res['fps']:.4f}); python -m gfnerf_tpu_torch.render --traj "
        f"spiral --spiral-steps 3 in {render_s:.2f}s: "
        f"{[f.name for f in frames]}, each 96x72 RGB")
    torch.cuda.empty_cache()
    stats = {
        "setup_s": setup_s, "train_s": train_s,
        "init_s_per_step": _mean(init_s), "focal_s_per_step": _mean(focal_s),
        "init_rays_per_s": RAYS / _mean(init_s),
        "focal_rays_per_s": RAYS / _mean(focal_s),
        "peak_bytes": peak, "remat_peak_bytes": {0: peak0, 8: peak8},
        "rebuilds_s": {s: t for s, _, _, t in rec["rebuilds"]},
        "eval_batch_s": [t for _, t, _ in rec["evals"]],
        "eval_image_s": image_s, "eval_s_per_image": 1.0 / res["fps"],
        "eval_entry_s": eval_s, "render_entry_s": render_s,
        "frame_s": _mean(frame_s[False]),
        "frame_s_early_term": _mean(frame_s[True]),
        "early_term": {str(k): v for k, v in et.items()},
        "kept_samples": n_kept, "losses": losses,
        **({"parent_turns_s_per_step": parent_steps} if parent_steps
           else {}),
        "step_s": [steps[i]["s"] for i in range(GFNERF_STEPS)],
        "profiles": {k: {n: v[n] for n in ("step_ms", "device_busy_ms",
                                           "idle_share",
                                           "stage_device_span_ms")}
                     for k, v in profiles.items()},
    }
    return launches, stats, kernels


# the pipeline phase's schedule (24 init steps, milestones at 8 and 16,
# compaction at 12, the fineness anneal over 16), then 2 steps on each of
# blocks 0 and 1: gf-nerf's 10 init steps left the eval image below the
# mean image's PSNR (16.23 against 16.87 on an H100)
PROP_INIT_STEPS = 24
PROP_FOCAL_BLOCKS = 2
PROP_STEPS = PROP_INIT_STEPS + 2 * PROP_FOCAL_BLOCKS
PROP_OVERRIDES = {**PIPELINE_OVERRIDES, **ONE_STEP_A_DISPATCH,
                  "steps_per_eval_batch": str(PROP_STEPS // 2),
                  "steps_per_eval_image": str(PROP_STEPS),
                  "steps_per_save": str(PROP_STEPS)}
# (slots, budget, fine samples a ray, levels, channels, log2 rows, probe
# levels, probe log2 rows, blocks, MLP type, layout, rays a step)
PROP_WIDTH = (256, 256, 64, 8, 4, 15, 4, 12, 10, "bfloat16", "packed", 8192)


class record_shapes:
    """Within the block, the model's calls of K1 (the composite's (R, S))
    and of H1 (the table's shape, the points, and whether the table is in
    the graph, so that H2 will run on it), in call order; the counted
    wrappers underneath launch as before."""

    def __enter__(self):
        import torch

        from gfnerf_tpu_torch.fields import field as field_mod
        from gfnerf_tpu_torch.models import gfnerf as model_mod

        self.composite, self.encode = [], []
        self.saved = (model_mod.fused_composite,
                      field_mod.packed_hash_encode)
        composite, encode = self.saved

        def counted_composite(density, *args, **kw):
            self.composite.append(tuple(density.shape))
            return composite(density, *args, **kw)

        def counted_encode(table, *args, **kw):
            self.encode.append((tuple(table.shape), args[2].shape[0],
                                table.requires_grad
                                and torch.is_grad_enabled()))
            return encode(table, *args, **kw)

        model_mod.fused_composite = counted_composite
        field_mod.packed_hash_encode = counted_encode
        return self

    def __exit__(self, *exc):
        from gfnerf_tpu_torch.fields import field as field_mod
        from gfnerf_tpu_torch.models import gfnerf as model_mod

        model_mod.fused_composite, field_mod.packed_hash_encode = self.saved
        return False


def probe_points(p, batch, noise):
    """The points and anchors the probe's encode gets on a train batch
    (8192 rays x 256 slots), made as the proposal branch makes them: the
    march, each ray's samples sorted by t, warped, normalized."""
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.fields.field import _normalized
    from gfnerf_tpu_torch.models.gfnerf import sample_rays, warp_or_identity

    oct_dev = p.sampler.oct_dev
    with torch.no_grad():
        rays = generate_rays_multi(p.cameras_dev, batch["camera_indices"],
                                   batch["coords"])
        smp = sample_rays(oct_dev, rays["origins"], rays["directions"],
                          noise, 1.0, p.sampler.sampler_config)
        order = torch.argsort(torch.where(smp.valid, smp.ts, float("inf")),
                              dim=1, stable=True)
        anc = torch.gather(smp.trans_idx, 1, order).reshape(-1)
        world = torch.gather(smp.world_pts, 1, order[..., None].expand(
            *order.shape, 3)).reshape(-1, 3)
        warp = warp_or_identity(p.field_cfg, oct_dev,
                                anc.clamp(0, oct_dev.w2xz.shape[0] - 1),
                                world)
    return _normalized(warp), anc


def check_prop_kernels(p, batch, noise) -> dict:
    """K1 and K2 at the proposal branch's (8192, 64) and H1 and H2 on the
    probe's table (4 levels x 4 channels of 2^12 rows) at a train batch's
    2,097,152 probe points, each against its plain version and timed
    (K2 and H2 also at the main path's tolerances; H2 also against
    index_add_ of the same terms); bounds from the bytes.  Returns
    {kernel: its report at these shapes}."""
    import torch

    from gfnerf_tpu_torch.fields import packed_hash as ph
    from gfnerf_tpu_torch.ops.composite import (
        _composite_bwd_cuda, composite_backward_reference,
        composite_reference, fused_composite)

    out = {}
    r, s = batch["image"].shape[0], p.config.model.num_proposal_resamples
    # ---- K1 ----
    x = _composite_inputs(r, s, seed=64)
    got, want = fused_composite(*x), composite_reference(*x)
    torch.cuda.synchronize()
    assert_close(got, want, f"[prop] composite R={r} S={s}", **K1_TOL)
    out["composite_fwd"] = {
        "shape": [r, s], "max_abs_err": max_err(got, want),
        "ms": kernel_device_ms(lambda: fused_composite(*x),
                               "composite_fwd_kernel"),
        "wrapper_ms": time_ms(lambda: fused_composite(*x), n=21, reps=20),
        "plain_ms": time_ms(lambda: composite_reference(*x)),
        "bound_ms": composite_fwd_bytes(r, s) / HBM_BYTES_PER_S * 1e3,
        "bound_by": "bytes", "library_ms": None}
    # ---- K2, the train step's form and every cotangent ----
    g = _cotangents(r, s, seed=65)
    need = (True, False, False, True)
    cots = [None, None, g[2], g[3], None]
    args = (*x, cots, need)
    got = _composite_bwd_cuda(*args)
    want = composite_backward_reference(*args)
    got_all = _composite_bwd_cuda(*x, g)
    want_all = composite_backward_reference(*x, g)
    torch.cuda.synchronize()
    pairs = [(a, b) for a, b in zip(got, want) if b is not None]
    assert_close([a for a, _ in pairs], [b for _, b in pairs],
                 f"[prop] composite_bwd R={r} S={s}, train form",
                 rtol=K2_RTOL, atol_rel=K2_ATOL_REL)
    assert_close(got_all, want_all, f"[prop] composite_bwd R={r} S={s}",
                 rtol=K2_RTOL, atol_rel=K2_ATOL_REL)
    n_bytes = f32_bytes(x[0], x[1], x[3], *cots) + 4 * 4 * r * s
    out["composite_bwd"] = {
        "shape": [r, s],
        "max_abs_err": max(max_err(*zip(*pairs)), max_err(got_all,
                                                            want_all)),
        "ms": kernel_device_ms(lambda: _composite_bwd_cuda(*args),
                               "composite_bwd_ray"),
        "wrapper_ms": time_ms(lambda: _composite_bwd_cuda(*args), n=21,
                              reps=20),
        "plain_ms": time_ms(lambda: composite_backward_reference(*args)),
        "bound_ms": n_bytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "library_ms": None}
    del x, g, got, want, got_all, want_all, pairs, args
    # ---- H1 and H2 on the probe's table ----
    field = p.field
    pts, anc = probe_points(p, batch, noise)
    n_levels, n_rows, width = field.prop_feat.shape
    c = 4
    pack = ph.pack_for_channels(c, p.field_cfg.packed_row_width)
    n_points, n_valid = pts.shape[0], int((anc >= 0).sum())
    with torch.no_grad():
        fargs = (field.prop_feat, field.prop_prim, field.prop_bias, pts, anc,
                 c, pack, 0)
        got = ph._packed_hash_encode_cuda(*fargs)
        want = ph.packed_hash_encode_raw(*fargs)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"[prop] packed_hash_fwd on the probe: max "
                                 f"abs err {max_err([got], [want])}, not "
                                 f"equal bit for bit")
        del got, want
        out["packed_hash_fwd"] = {
            "shape": [pts.shape[0], n_levels, c, n_rows], "max_abs_err": 0.0,
            "ms": time_ms(lambda: ph._packed_hash_encode_cuda(*fargs), n=21),
            "plain_ms": time_ms(lambda: ph.packed_hash_encode_raw(*fargs),
                                n=3),
            "bound_ms": hash_fwd_bytes(pts.shape[0], n_levels, c,
                                       field.prop_feat.numel())
            / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
            "library_ms": None}
    gen = torch.Generator(device="cuda").manual_seed(66)
    gout = torch.randn((pts.shape[0], n_levels * c), generator=gen,
                       device="cuda")
    bargs = (gout, field.prop_prim, field.prop_bias, pts, anc, n_rows, width,
             c, pack, 0)
    check_table_grad("[prop] packed_hash_bwd on the probe",
                     ph._packed_hash_backward_cuda,
                     ph.packed_hash_backward_reference, bargs)
    err = 0.0
    ops = torch.zeros(n_levels, dtype=torch.int64, device="cuda")
    ph._packed_hash_backward_cuda(*bargs, red_ops=ops)
    terms = list(ph.packed_hash_scatter_terms(*bargs))
    rows = torch.cat([t[0] for t in terms])
    payload = torch.cat([t[1] for t in terms])
    del terms
    n_out = n_levels * n_rows * width // c
    turns = against_parent("prop", "packed_hash_bwd on the probe", "h2",
                           bargs)
    out["packed_hash_bwd"] = {
        **turns,
        "shape": [pts.shape[0], n_levels, c, n_rows], "max_abs_err": err,
        "ms": time_ms(lambda: ph._packed_hash_backward_cuda(*bargs), n=11),
        "plain_ms": time_ms(lambda: ph.packed_hash_backward_reference(
            *bargs), n=3),
        "library_ms": time_ms(lambda: torch.zeros(
            (n_out, c), device="cuda").index_add_(0, rows, payload), n=5),
        "bound_ms": hash_bwd_bytes(pts.shape[0], n_levels, c,
                                   field.prop_feat.numel())
        / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes",
        "launches_per_call": ph.table_grad_launches(pts.shape[0]),
        "reductions_per_level": ops.tolist()}
    del rows, payload, gout
    # H2 at the field's table and the fine samples' count (64 a ray): every
    # 4th probe point, in ray and t order as the fine samples are
    fc = p.field_cfg
    fine = (pts[::4].contiguous(), anc[::4].contiguous())
    _, f_rows, f_width = field.global_feat.shape
    gout = torch.randn((fine[0].shape[0], fc.num_levels
                        * fc.features_per_level), generator=gen,
                       device="cuda")
    check_table_grad(
        "[prop] packed_hash_bwd at the field", ph._packed_hash_backward_cuda,
        ph.packed_hash_backward_reference,
        (gout, field.global_prim, field.global_bias, *fine, f_rows, f_width,
         fc.features_per_level, ph.pack_for_channels(
             fc.features_per_level, fc.packed_row_width), 0))
    log(f"[prop] packed_hash_bwd at the field ({fine[0].shape[0]} points, "
        f"{fc.num_levels} x {fc.features_per_level} of {f_rows} rows): "
        f"equal to the plain version bit for bit, also called again and on "
        f"the points permuted")
    del gout, fine, pts, anc
    torch.cuda.empty_cache()
    for name, k in out.items():
        log(f"[prop] {name} at {k['shape']}: max abs err "
            f"{k['max_abs_err']:.3g}; kernel {k['ms']:.4f} ms"
            + (f" (the wrapper, 20 calls per event pair, "
               f"{k['wrapper_ms']:.4f} ms)" if "wrapper_ms" in k else "")
            + f", plain {k['plain_ms']:.4f} ms, "
            + (f"index_add_ {k['library_ms']:.4f} ms, "
               if k["library_ms"] is not None else "")
            + f"bound {k['bound_ms']:.4f} ms")
    log(f"[prop] the probe's points: {n_valid} of {n_points} valid; "
        f"H2's atomics per level "
        f"{out['packed_hash_bwd']['reductions_per_level']} into "
        f"{n_levels} x {n_rows} rows")
    return out


def phase_prop(tmp: Path):
    """gf-nerf-prop (proposal-guided resampling) through the Trainer at its
    full width (PROP_WIDTH) on the pipeline phase's synthetic scene, with
    the pipeline phase's schedule cut to 2 focal blocks (PROP_OVERRIDES),
    counted: every init step
    launches K1 and K2 once at (8192, 64), H1 twice (the probe's 4 x 4 of
    2^12 on 2,097,152 lattice points, then the main field's 8 x 4 of 2^15
    on 524,288 fine points) and H2 in two calls (the probe's table and the
    global one); every focal step K1 and K2 once, H1 three times (the
    probe without a graph, the global encode, the block's on it) and H2
    once, into the block's table; H3, H4 and H5 never.  Checked: the
    probe's table and MLP changed by the init steps that reached it and
    bit-unchanged by the focal steps; finite losses, the interlevel loss
    included; the rgb loss falling over the init stage; the milestone
    rebuilds and the compaction; 48 error-map renders; 10 clusters; eval
    batches (a stream per block), the eval image's PSNR above its mean
    image's, and the checkpoint.  Then, from the trained state: one step against the plain
    autograd pairs; K1, K2, H1 and H2 at the new shapes
    (check_prop_kernels); an init and a focal step profiled (the
    gfnerf/proposal span among the stages); a step's peak memory beyond
    its state; python -m gfnerf_tpu_torch.eval and .render on the
    checkpoint, and .render --early-term refused.  The counted run takes
    one step a dispatch; then ``trainer_at_both_k`` trains the Trainer's
    init steps again in gf-nerf-prop's K = 8 windows and at K = 1."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.render import read_png
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = tmp / "scene"
    if not scene.is_dir():
        make_synthetic_npz(scene, n_train=48, n_val=4, img_wh=(96, 72))
    cfg = get_method("gf-nerf-prop")
    for key, value in {**PROP_OVERRIDES,
                       "max_num_iterations": str(PROP_STEPS),
                       "output_dir": str(tmp / "prop_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    trainer = Trainer(cfg, build_dataparser("minimal", scene))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SETUP_REUSE.note()   # this setup's reuses alone
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    fc, scfg, mcfg = p.field_cfg, p.sampler.sampler_config, p.config.model
    rays = p.config.datamanager.train_num_rays_per_batch
    width = (scfg.max_samples, mcfg.samples_budget_per_ray,
             mcfg.num_proposal_resamples, fc.num_levels,
             fc.features_per_level, fc.packed_rows_log2, fc.proposal_levels,
             fc.proposal_rows_log2, fc.n_blocks, fc.mlp_dtype,
             fc.hash_layout, rays)
    reused = SETUP_REUSE.note()
    log(f"[prop] setup {setup_s:.2f}s ({reused})"
        f": {p.sampler.tree.n_nodes} nodes, "
        f"{p.sampler.n_volumes} volumes; sample_l {scfg.sample_l:.6f}, "
        f"max_hits {scfg.max_hits}; (slots, budget, fine samples, levels, "
        f"channels, log2 rows, probe levels, probe log2 rows, blocks, MLPs,"
        f" layout, rays) {width}")
    if width != PROP_WIDTH:
        raise AssertionError(f"gf-nerf-prop is not at its full width: "
                             f"{width}")
    k, s_march = mcfg.num_proposal_resamples, scfg.max_samples

    def probe_params():
        return [p.field.prop_feat, *p.field.prop_net.w, *p.field.prop_net.b]

    rec = {"steps": {}, "rebuilds": [], "maps": 0, "evals": []}
    get_loss, rebuild, render = (p.get_train_loss_dict,
                                 p.sampler.maybe_rebuild, p.render_camera)
    eval_batch, eval_image = (p.get_eval_loss_dict,
                              p.get_eval_image_metrics_and_images)
    shapes = record_shapes()

    def counts():
        return {**launch_counts(),
                "packed_hash_bwd_calls": packed_hash_encode.bwd_calls}

    def get_loss_w(step):
        before = counts()
        probe = [t.detach().clone() for t in probe_params()]
        n_c, n_e = len(shapes.composite), len(shapes.encode)
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = counts()
        rec["steps"][step] = {
            "s": dt, "counts": {name: after[name] - before[name]
                                for name in after},
            "composite": shapes.composite[n_c:], "encode": shapes.encode[n_e:],
            "probe_changed": [not torch.equal(a, b) for a, b in
                              zip(probe, probe_params())], **m}
        return m

    def rebuild_w(step):
        n = p.sampler.tree.n_nodes
        t = time.perf_counter()
        done = rebuild(step)
        if done:
            rec["rebuilds"].append((step, n, p.sampler.tree.n_nodes,
                                    time.perf_counter() - t))
        return done

    def render_w(*args, **kw):
        rec["maps"] += kw.get("downscale") == 8
        return render(*args, **kw)

    def eval_batch_w(step):
        t = time.perf_counter()
        m = eval_batch(step)
        torch.cuda.synchronize()
        rec["evals"].append((step, time.perf_counter() - t,
                             float(m["eval_psnr"])))
        return m

    def eval_image_w(step, idx=0):
        t = time.perf_counter()
        metrics, images = eval_image(step, idx)
        rec["eval_image"] = (step, idx, time.perf_counter() - t, metrics)
        return metrics, images

    p.get_train_loss_dict, p.sampler.maybe_rebuild = get_loss_w, rebuild_w
    p.render_camera, p.get_eval_loss_dict = render_w, eval_batch_w
    p.get_eval_image_metrics_and_images = eval_image_w
    reset_launch_counts()
    t0 = time.perf_counter()
    with shapes:
        trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    p.get_train_loss_dict, p.sampler.maybe_rebuild = get_loss, rebuild
    p.render_camera = render
    p.get_eval_loss_dict, p.get_eval_image_metrics_and_images = \
        eval_batch, eval_image

    steps = rec["steps"]
    if sorted(steps) != list(range(PROP_STEPS)):
        raise AssertionError(f"gf-nerf-prop: steps run {sorted(steps)}")
    losses = [steps[i]["loss"] for i in range(PROP_STEPS)]
    inter = [steps[i]["interlevel_loss"] for i in range(PROP_STEPS)]
    rgb = [steps[i]["rgb_loss"] for i in range(PROP_STEPS)]
    log(f"[prop] losses {[round(x, 5) for x in losses]}; interlevel "
        f"{[round(x, 5) for x in inter]}; rgb {[round(x, 5) for x in rgb]};"
        f" marched samples per ray "
        f"{[round(steps[i]['num_samples_per_ray'], 1) for i in steps]}")
    if not (all(np.isfinite(losses)) and all(np.isfinite(inter))):
        raise AssertionError(f"gf-nerf-prop: non-finite losses {losses} "
                             f"{inter}")
    if not _mean(rgb[PROP_INIT_STEPS - 3:PROP_INIT_STEPS]) < _mean(rgb[:3]):
        raise AssertionError(f"gf-nerf-prop: the rgb loss did not fall over "
                             f"the init stage: {rgb}")
    probe_shape = tuple(p.field.prop_feat.shape)
    main_shape = tuple(p.field.global_feat.shape)
    n_probe, n_fine = rays * s_march, rays * k
    h2_probe = h2_main = table_grad_launches({"fcfg": fc})
    for i in range(PROP_STEPS):
        init = i < PROP_INIT_STEPS
        want = ({"composite_fwd": 1, "composite_bwd": 1,
                 "packed_hash_fwd": 2, "packed_hash_bwd": h2_probe + h2_main,
                 "packed_hash_bwd_calls": 2} if init else
                {"composite_fwd": 1, "composite_bwd": 1,
                 "packed_hash_fwd": 3, "packed_hash_bwd": h2_main,
                 "packed_hash_bwd_calls": 1})
        want_encode = ([(probe_shape, n_probe, True),
                        (main_shape, n_fine, True)] if init else
                       [(probe_shape, n_probe, False),
                        (main_shape, n_fine, False),
                        (main_shape, n_fine, True)])
        st = steps[i]
        got = st["counts"]
        if got != {name: want.get(name, 0) for name in got}:
            raise AssertionError(f"gf-nerf-prop step {i}: launches {got}, "
                                 f"expected {want}")
        if st["composite"] != [(rays, k)] or st["encode"] != want_encode:
            raise AssertionError(f"gf-nerf-prop step {i}: K1 at "
                                 f"{st['composite']}, H1 at {st['encode']}")
        if not init and any(st["probe_changed"]):
            raise AssertionError(f"gf-nerf-prop focal step {i}: the probe "
                                 f"changed {st['probe_changed']}")
    changed = [steps[i]["probe_changed"] for i in range(PROP_INIT_STEPS)]
    log(f"[prop] launches per step as expected: init K1 and K2 once at "
        f"({rays}, {k}), H1 on the probe {probe_shape} at {n_probe} points "
        f"and on the global table {main_shape} at {n_fine}, H2 in two calls"
        f" ({h2_probe} + {h2_main} launches); focal K1 and K2 once, H1 "
        f"three times (the probe without a graph), H2 once ({h2_main} "
        f"launches, the block's table); H3, H4, H5 never; in the whole run "
        f"{launches}")
    log(f"[prop] the probe's table and MLP changed by init step (table, "
        f"then the MLP's weights and biases): {changed}; bit-unchanged by "
        f"every focal step")
    if not all(any(c) for c in changed[2:]) or not all(
            any(steps[i]["probe_changed"][j] for i in range(PROP_INIT_STEPS))
            for j in range(len(changed[0]))):
        raise AssertionError(f"gf-nerf-prop: the probe did not train at the "
                             f"init stage: {changed}")
    for name in ("packed_hash_routed", "hash_anchored_fwd",
                 "hash_anchored_bwd"):
        if launches[name]:
            raise AssertionError(f"gf-nerf-prop: {name} launched")
    log(f"[prop] rebuilds (step, nodes before, after, s): "
        f"{[(s, a, b, round(t, 3)) for s, a, b, t in rec['rebuilds']]}")
    if [s for s, *_ in rec["rebuilds"]] != [8, 12, 16]:
        raise AssertionError(f"gf-nerf-prop: rebuilds {rec['rebuilds']}")
    labels = p.sampler.cameras_labels
    if (rec["maps"] != 48 or labels is None
            or len(np.unique(labels)) != fc.n_blocks):
        raise AssertionError(f"gf-nerf-prop transition: {rec['maps']} error "
                             f"maps, labels {labels}")
    step, idx, image_s, metrics = rec["eval_image"]
    gt = p.datamanager.next_eval_image(idx)[1]["image"]
    trivial = float(-10.0 * np.log10(np.mean((gt - gt.mean(axis=(0, 1)))
                                             ** 2)))
    log(f"[prop] eval batches (step, s, PSNR) {rec['evals']}; eval image "
        f"{idx} at step {step} in {image_s:.3f}s: {json.dumps(metrics)}; "
        f"mean-image PSNR {trivial:.4f}")
    if len(rec["evals"]) != 2 or not metrics["psnr"] > trivial:
        raise AssertionError(f"gf-nerf-prop: eval batches {rec['evals']}, "
                             f"eval PSNR {metrics['psnr']} against the mean "
                             f"image's {trivial}")
    ckpt = trainer.checkpoint_dir / f"step-{PROP_STEPS - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"gf-nerf-prop: no checkpoint at {ckpt}")
    rebuild_steps = {s for s, *_ in rec["rebuilds"]}
    init_s = [steps[i]["s"] for i in range(2, PROP_INIT_STEPS)
              if i not in rebuild_steps]
    focal_s = [steps[i]["s"] for i in range(PROP_INIT_STEPS + 1,
                                            PROP_STEPS, 2)]
    log(f"[prop] s a step through the Trainer: "
        f"{[round(steps[i]['s'], 4) for i in range(PROP_STEPS)]}")
    log(f"[prop] Trainer: {_mean(init_s):.4f} s/init step "
        f"({RAYS / _mean(init_s):.1f} rays/s), {_mean(focal_s):.4f} s/focal "
        f"step ({RAYS / _mean(focal_s):.1f} rays/s; the second of each "
        f"block's); peak {peak / 2**30:.3f} GiB; the run {train_s:.1f}s")

    # from the trained state
    images = np.asarray(p.datamanager.train_dataset.metadata[
        "images_array"], np.float32) / 255.0
    gen = torch.Generator(device=p.device).manual_seed(9)
    wl = {"field": p.field, "state": p.state, "tx": p.tx,
          "step_fn": p._train_step[STAGE_INIT],
          "focal_step_fn": p._train_step[STAGE_BLOCK],
          "oct_dev": p.sampler.oct_dev, "cams": p.cameras_dev,
          "fineness": 1.0, "scfg": scfg, "fcfg": fc}
    batch = make_batch(images, RAYS, 700, p.device)
    noise, perms = step_draws(wl, gen)
    prop_u = torch.rand((RAYS, k + 1), generator=gen, device=p.device)
    compare_step(wl, "prop", batch, noise, perms, prop_u=prop_u)
    kernels = check_prop_kernels(p, batch, noise)
    _, _, step_peak = remat_step(p, 0, batch, noise, perms)
    log(f"[prop] one init step's peak memory beyond its state "
        f"{step_peak / 2**30:.3f} GiB")
    profiles = {"init step": profiled_step(p, wl, batch, noise, perms),
                "focal step": profiled_step(p, wl, batch, noise, perms, 0)}
    for stage, prof in profiles.items():
        spans = {k: round(v, 2)
                 for k, v in prof["stage_device_span_ms"].items()}
        top = [(k["name"][:60], round(k["device_ms"], 3), k["count"])
               for k in prof["top_kernels"][:8]]
        log(f"[prop] one {stage}, profiled: {prof['step_ms']:.1f} ms on the "
            f"host clock (the faster of 2), device busy "
            f"{prof['device_busy_ms']:.2f} ms, idle share "
            f"{prof['idle_share']:.3f}; stage device spans (ms) {spans}; "
            f"busiest kernels {top}; host waits {prof['host_waits']}")
        if "proposal" not in spans:
            raise AssertionError(f"[prop] {stage}: no gfnerf/proposal span")

    # the entry points on the checkpoint
    config_path = trainer.base_dir / "config.json"
    # gf-nerf-prop's own K = 8 windows through the Trainer
    trainer_k = trainer_at_both_k(trainer, get_loss,
                                  p.after_train_iteration, "prop")
    del trainer, p, wl, render, get_loss, rebuild, eval_batch, eval_image
    torch.cuda.empty_cache()
    t = time.perf_counter()
    eval_entry.main(["--load-config", str(config_path), "--output-path",
                     str(tmp / "prop_eval.json")])
    eval_s = time.perf_counter() - t
    res = json.loads((tmp / "prop_eval.json").read_text())["results"]
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"gfnerf_tpu_torch.eval: {res}")
    torch.cuda.empty_cache()
    frames_dir = tmp / "prop_frames"
    render_args = ["--load-config", str(config_path), "--traj", "spiral",
                   "--spiral-steps", "3", "--output-path", str(frames_dir)]
    try:
        render_entry.main(render_args + ["--early-term"])
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("render --early-term ran on a proposal run")
    if "proposal" not in refused or frames_dir.exists():
        raise AssertionError(f"render --early-term: {refused}")
    t = time.perf_counter()
    render_entry.main(render_args)
    render_s = time.perf_counter() - t
    frames = sorted(frames_dir.glob("*.png"))
    shapes_ = [read_png(f).shape for f in frames]
    if len(frames) != 3 or any(s != (72, 96, 3) for s in shapes_):
        raise AssertionError(f"gfnerf_tpu_torch.render wrote {frames} "
                             f"{shapes_}")
    log(f"[prop] python -m gfnerf_tpu_torch.eval on the checkpoint in "
        f"{eval_s:.2f}s: {json.dumps(res)}; .render --early-term refused "
        f"({refused}); .render --traj spiral --spiral-steps 3 in "
        f"{render_s:.2f}s: {[f.name for f in frames]}, each 96x72 RGB")
    torch.cuda.empty_cache()
    stats = {
        **trainer_k, "setup_s": setup_s, "train_s": train_s,
        "init_s_per_step": _mean(init_s), "focal_s_per_step": _mean(focal_s),
        "init_rays_per_s": RAYS / _mean(init_s),
        "focal_rays_per_s": RAYS / _mean(focal_s),
        "peak_bytes": peak, "step_peak_extra_bytes": step_peak,
        "rebuilds_s": {s: t for s, _, _, t in rec["rebuilds"]},
        "eval_batch_s": [t for _, t, _ in rec["evals"]],
        "eval_image_s": image_s, "eval_psnr": metrics["psnr"],
        "mean_image_psnr": trivial, "eval_entry_s": eval_s,
        "render_entry_s": render_s, "losses": losses,
        "interlevel_losses": inter,
        "step_s": [steps[i]["s"] for i in range(PROP_STEPS)],
        "profiles": {k: {n: v[n] for n in ("step_ms", "device_busy_ms",
                                           "idle_share",
                                           "stage_device_span_ms")}
                     for k, v in profiles.items()},
    }
    return launches, stats, kernels


# nerfacto at its full width (the registered config, NERFACTO_WIDTH) on the
# pipeline phase's scene: the steps a run takes (chosen so that the eval
# image beats its mean image's PSNR; PERF.md section 6) and the first ones
# the timing skips
NERFACTO_STEPS = 300
NERFACTO_WARMUP = 5
NERFACTO_EVAL_EVERY = NERFACTO_STEPS
NERFACTO_OVERRIDES = {
    "steps_per_eval_image": str(NERFACTO_EVAL_EVERY),
    "steps_per_save": str(NERFACTO_STEPS),
    "steps_per_log": "100",
}
# (rays, proposal samples, field samples, levels, log2 entries, hidden,
# geo features, colour hidden, appearance, proposal levels, proposal log2
# entries, near, far, background)
NERFACTO_WIDTH = (4096, (256, 96), 48, 16, 19, 64, 15, 64, 32, 5, 17, 0.05,
                  1000.0, "last_sample")
SEMANTIC_NERFW_STEPS = 4
# nerfacto's step from a common state, kernels vs the plain pairs: the
# forward is the same bit for bit (H4 equals its plain version), so the
# loss is; the tables' gradients are H5's f32 atomics against index_add_,
# the same terms in another order
NERFACTO_TABLE_GRAD_TOL = 1e-4
# gf-nerf-perf with semantics and the camera optimizer: 10 init steps and 2
# focal steps on block 0, on the pipeline phase's octree and march config
# (no tree built); no milestone rebuild, no eval batch
SEMANTICS_INIT_STEPS = 10
SEMANTICS_STEPS = SEMANTICS_INIT_STEPS + 2
SEMANTICS_OVERRIDES = {
    **ONE_STEP_A_DISPATCH,
    **{f"pipeline.{part}.{key}": value
       for part in ("model", "datamanager", "optimizers")
       for key, value in (("steps_perssampler_init",
                           str(SEMANTICS_INIT_STEPS)),
                          ("steps_per_split_dataset", "2"))},
    "pipeline.sampler.sub_div_milestones": "1000",
    "pipeline.sampler.ray_march_fineness_decay_end_iter": "8",
    "pipeline.camera_opt_mode": "SO3xR3",
    "pipeline.model.use_semantics": "true",
    "pipeline.model.semantic_loss_weight": "0.5",
    "steps_per_eval_batch": "1000",
    "steps_per_eval_image": "1000",
    "steps_per_save": "1000",
}


def road_scene(tmp: Path) -> Path:
    """The pipeline phase's scene with road masks as its labels: the lower
    half of each image is class 1 (tests/test_train_smoke.py's)."""
    import numpy as np

    src, dst = tmp / "scene", tmp / "scene_roads"
    dst.mkdir(exist_ok=True)
    for split in ("train", "val"):
        d = dict(np.load(src / f"{split}.npz"))
        n, h, w = d["images"].shape[:3]
        masks = np.zeros((n, h, w), np.float32)
        masks[:, h // 2:, :] = 1.0
        d["road_masks"] = masks
        np.savez(dst / f"{split}.npz", **d)
    return dst


class record_encodes:
    """Within the block, the arguments of every hash_encode call that
    nerfacto's model makes, in order (points and anchors cloned)."""

    def __enter__(self):
        from gfnerf_tpu_torch.models import nerfacto as nerfacto_mod

        self.mod, self.saved, self.calls = (nerfacto_mod,
                                            nerfacto_mod.hash_encode, [])

        def rec(table, prim, bias, pts, anc, *a, **kw):
            self.calls.append((table.detach(), prim, bias,
                               pts.detach().clone(), anc.clone()))
            return self.saved(table, prim, bias, pts, anc, *a, **kw)

        nerfacto_mod.hash_encode = rec
        return self

    def __exit__(self, *exc):
        self.mod.hash_encode = self.saved
        return False


def nerfacto_step_pair(p, batch, draws) -> dict:
    """nerfacto's loss and backward from two copies of the pipeline's model
    on one batch and its draws, through the kernels and through the plain
    pairs (no kernel may launch in the plain one): the loss to
    TRAIN_LOSS_RTOL, the three tables' gradients to
    NERFACTO_TABLE_GRAD_TOL of their largest, the MLPs' to TRAIN_GRAD_TOL
    of their largest.  Returns the errors."""
    import copy

    import torch

    from gfnerf_tpu_torch.fields.hash_encoding import plain_hash_encode
    from gfnerf_tpu_torch.models import nerfacto as nerfacto_mod

    runs, model0, encode = {}, p.model, nerfacto_mod.hash_encode
    for kind in ("kernels", "plain"):
        p.model = copy.deepcopy(model0)
        before = launch_counts()
        if kind == "plain":
            nerfacto_mod.hash_encode = plain_hash_encode
        try:
            total, _ = p.loss(batch, draws)
            total.backward()
            torch.cuda.synchronize()
            runs[kind] = (total.item(), p.model)
        finally:
            nerfacto_mod.hash_encode = encode
            p.model = model0
        if kind == "plain" and launch_counts() != before:
            raise AssertionError("nerfacto: the plain step launched kernels")
    (lk, mk), (lp, mp) = runs["kernels"], runs["plain"]
    rel = abs(lk - lp) / abs(lp)
    out = {"loss": (lk, lp, rel)}
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"nerfacto step loss: kernels {lk} vs plain "
                             f"{lp}")
    tables = [("field", mk.field_feat, mp.field_feat)] + [
        (f"proposal {i}", a, b)
        for i, (a, b) in enumerate(zip(mk.prop_feats, mp.prop_feats))]
    for name, a, b in tables:
        scale = float(b.grad.abs().max())
        err = float((a.grad - b.grad).abs().max())
        out[name] = (err, scale)
        if not (scale > 0 and err <= NERFACTO_TABLE_GRAD_TOL * scale):
            raise AssertionError(f"nerfacto {name} table gradient: kernels "
                                 f"vs plain {err} of {scale}")
    mlps = [(a, b) for (n, a), b in zip(mk.named_parameters(),
                                        mp.parameters()) if "feat" not in n]
    scale = max(float(b.grad.abs().max()) for _, b in mlps)
    err = max(float((a.grad - b.grad).abs().max()) for a, b in mlps)
    out["mlps"] = (err, scale)
    if not err <= TRAIN_GRAD_TOL * scale:
        raise AssertionError(f"nerfacto MLP gradients: kernels vs plain "
                             f"{err} of {scale}")
    log(f"[nerfacto] one step, kernels vs plain: loss {lk:.7f} vs {lp:.7f} "
        f"(rel {rel:.3g}, tol {TRAIN_LOSS_RTOL}); gradients (max abs err, "
        f"largest): {({k: v for k, v in out.items() if k != 'loss'})}")
    del runs, mk, mp
    torch.cuda.empty_cache()
    return out


def nerfacto_batch(p, seed):
    """A device batch of the vanilla pipeline's train views, and its
    proposal draws, from ``seed`` (the pipeline's own sampler untouched)."""
    import torch

    from gfnerf_tpu_torch.data.pixel_samplers import (PixelSampler,
                                                      collate_batch)

    sampler = PixelSampler(p.config.train_num_rays_per_batch, seed=seed)
    batch = p._device_batch(collate_batch(p.cache,
                                          sampler.sample_indices(p.cache)))
    gen = torch.Generator(device=p.device).manual_seed(seed)
    counts = [*p.model_cfg.num_proposal_samples, p.model_cfg.num_nerf_samples]
    r = batch["image"].shape[0]
    draws = [torch.rand((r, n + 1), generator=gen, device=p.device)
             for n in counts]
    return batch, draws


def phase_nerfacto(tmp: Path):
    """nerfacto (the stock model family on the vanilla pipeline) through the
    Trainer at its full width (NERFACTO_WIDTH) on the pipeline phase's
    48-view scene, counted: every step calls H4 three times (the two
    proposal levels' 5 x 2 of 2^17 at 1,048,576 and 393,216 points, then
    the field's 16 x 2 of 2^19 at 196,608) and H5 three times, into the
    same tables; no other kernel.  Checked: finite losses, the rgb loss
    falling, every table and MLP changed; the eval image's PSNR above its
    mean image's; the checkpoint.  Then from the trained model: one step
    against the plain pairs; H4 and H5 at the three shapes against their
    plain versions (H5 also against index_add_); s/step, rays/s, peak
    memory; one profiled step (busy time, idle share);
    python -m gfnerf_tpu_torch.eval and .render on the checkpoint; and
    SEMANTIC_NERFW_STEPS steps of semantic-nerfw on the scene with road
    masks, its semantics loss finite."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.hash_encoding import (_hash_encode_cuda,
                                                       encode_launches,
                                                       hash_encode,
                                                       hash_encode_raw,
                                                       table_grad_launches)
    from gfnerf_tpu_torch.models.nerfacto import normalize_positions
    from gfnerf_tpu_torch.render import read_png
    from gfnerf_tpu_torch.utils.profiling import profile_device

    scene = tmp / "scene"
    cfg = get_method("nerfacto")
    for key, value in {**NERFACTO_OVERRIDES,
                       "max_num_iterations": str(NERFACTO_STEPS),
                       "output_dir": str(tmp / "nerfacto_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    trainer = Trainer(cfg, build_dataparser("minimal", scene))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    mc = p.model_cfg
    width = (p.config.train_num_rays_per_batch,
             tuple(mc.num_proposal_samples), mc.num_nerf_samples,
             mc.num_levels, mc.log2_hashmap_size, mc.hidden_dim,
             mc.geo_feat_dim, mc.hidden_dim_color,
             mc.appearance_embedding_dim, mc.proposal_num_levels,
             mc.proposal_log2_hashmap_size, mc.near_plane, mc.far_plane,
             mc.background_color)
    log(f"[nerfacto] setup {setup_s:.2f}s; (rays, proposal samples, field "
        f"samples, levels, log2 entries, hidden, geo, colour hidden, "
        f"appearance, proposal levels, proposal log2 entries, near, far, "
        f"background) {width}; {len(p.train_dataset)} train views")
    if width != NERFACTO_WIDTH:
        raise AssertionError(f"nerfacto is not at its full width: {width}")
    rays = p.config.train_num_rays_per_batch
    start = {n: t.detach().clone() for n, t in p.model.named_parameters()}
    rec = {"steps": {}}
    get_loss, eval_image = (p.get_train_loss_dict,
                            p.get_eval_image_metrics_and_images)

    def counts():
        return {**launch_counts(), "hash_anchored_fwd_calls":
                hash_encode.calls,
                "hash_anchored_bwd_calls": hash_encode.bwd_calls}

    def get_loss_w(step):
        before = counts()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = counts()
        rec["steps"][step] = {"s": dt, "counts": {
            k: after[k] - before[k] for k in after}, **m}
        return m

    def eval_image_w(step, idx=0):
        t = time.perf_counter()
        metrics, images = eval_image(step, idx)
        rec.setdefault("eval_images", []).append(
            (step, idx, time.perf_counter() - t, metrics))
        return metrics, images

    p.get_train_loss_dict = get_loss_w
    p.get_eval_image_metrics_and_images = eval_image_w
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    p.get_train_loss_dict = get_loss
    p.get_eval_image_metrics_and_images = eval_image

    steps = rec["steps"]
    if sorted(steps) != list(range(NERFACTO_STEPS)):
        raise AssertionError(f"nerfacto: steps run {sorted(steps)}")
    h4 = 2 * encode_launches(mc.proposal_num_levels) + encode_launches(
        mc.num_levels)
    h5 = sum(table_grad_launches(
        mc.proposal_num_levels, p.config.train_num_rays_per_batch * n,
        1 << mc.proposal_log2_hashmap_size, 2)
        for n in mc.num_proposal_samples) + table_grad_launches(
            mc.num_levels, p.config.train_num_rays_per_batch
            * mc.num_nerf_samples, 1 << mc.log2_hashmap_size, 2)
    want = {"hash_anchored_fwd": h4, "hash_anchored_bwd": h5,
            "hash_anchored_fwd_calls": 3, "hash_anchored_bwd_calls": 3}
    for i in range(NERFACTO_STEPS):
        got = steps[i]["counts"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"nerfacto step {i}: launches {got}, "
                                 f"expected {want}")
    log(f"[nerfacto] launches per step as expected: H4 in 3 calls ({h4} "
        f"launches), H5 in 3 calls ({h5} launches), no other kernel; in the "
        f"whole run {launches}")
    keys = [k for k in steps[0] if k not in ("s", "counts")]
    hist = {k: [steps[i][k] for i in range(NERFACTO_STEPS)] for k in keys}
    every = max(NERFACTO_STEPS // 12, 1)
    log(f"[nerfacto] losses every {every} steps: "
        f"{ {k: [round(v, 5) for v in hist[k][::every]] for k in keys} }")
    if not all(np.isfinite(v).all() for v in hist.values()):
        raise AssertionError("nerfacto: a non-finite loss")
    rgb = hist["rgb_loss"]
    if not _mean(rgb[-10:]) < _mean(rgb[:10]):
        raise AssertionError(f"nerfacto: the rgb loss did not fall: {rgb}")
    unchanged = [n for n, t in p.model.named_parameters()
                 if torch.equal(t.detach(), start[n])]
    if unchanged:
        raise AssertionError(f"nerfacto: unchanged parameters {unchanged}")
    log(f"[nerfacto] every one of the {len(start)} parameter tensors "
        f"changed (3 tables, 4 MLPs, the appearance embedding)")
    step, idx, image_s, metrics = rec["eval_images"][-1]
    gt = p.eval_dataset.get_image(idx)
    trivial = float(-10.0 * np.log10(np.mean((gt - gt.mean(axis=(0, 1)))
                                             ** 2)))
    log(f"[nerfacto] eval image {idx} PSNR by step: "
        f"{[(s, round(m['psnr'], 4)) for s, _, _, m in rec['eval_images']]}")
    log(f"[nerfacto] eval image {idx} at step {step} in {image_s:.3f}s: "
        f"{json.dumps(metrics)}; mean-image PSNR {trivial:.4f}")
    if not metrics["psnr"] > trivial:
        raise AssertionError(f"nerfacto: eval PSNR {metrics['psnr']} not "
                             f"above the mean image's {trivial}")
    ckpt = trainer.checkpoint_dir / f"step-{NERFACTO_STEPS - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"nerfacto: no checkpoint at {ckpt}")
    step_s = [steps[i]["s"] for i in range(NERFACTO_WARMUP, NERFACTO_STEPS)]
    log(f"[nerfacto] Trainer: {_mean(step_s):.4f} s/step (median "
        f"{float(np.median(step_s)):.4f}, after {NERFACTO_WARMUP} warm-up "
        f"steps), {rays / _mean(step_s):.1f} rays/s; peak "
        f"{peak / 2**30:.3f} GiB; the run {train_s:.1f}s")

    # from the trained model: a step against the plain pairs, the kernels at
    # the step's shapes, a profiled step
    batch, draws = nerfacto_batch(p, 700)
    pair = nerfacto_step_pair(p, batch, draws)
    with torch.no_grad(), record_encodes() as enc:
        p.loss(batch, draws)
    shapes = [(tuple(c[0].shape), c[3].shape[0]) for c in enc.calls]
    want_shapes = [((mc.proposal_num_levels,
                     1 << mc.proposal_log2_hashmap_size, 2), rays * n)
                   for n in mc.num_proposal_samples] + [
        ((mc.num_levels, 1 << mc.log2_hashmap_size, 2),
         rays * mc.num_nerf_samples)]
    log(f"[nerfacto] H4's calls in a step (table, points): {shapes}")
    if shapes != want_shapes:
        raise AssertionError(f"nerfacto: encodes at {shapes}, expected "
                             f"{want_shapes}")
    kernels = {}
    for name, (table, prim, bias, pts, anc) in zip(
            ("proposal 0", "proposal 1", "field"), enc.calls):
        far = int(((pts - 0.5).abs() > 0.25).any(-1).sum())
        log(f"[nerfacto] {name}: {far} of {pts.shape[0]} points contracted "
            f"(beyond the unit box), coordinates in "
            f"[{float(pts.min()):.6f}, {float(pts.max()):.6f}]")
        kernels[name] = time_anchored_at(table, (prim, bias, pts, anc),
                                         f"nerfacto {name}", parent=True)
    # points so far that the contraction puts them on the hash's faces,
    # exactly 0.0 or 1.0: H4's cell there equal to the plain _level_cells'
    edge = normalize_positions(torch.tensor(
        [[0.0, 0.0, 1e9], [-1e9, 3.0, 0.0], [5.0, 1e8, -1e12]],
        device=p.device), mc)
    table, prim, bias, _, _ = enc.calls[-1]
    anc = torch.zeros(3, dtype=torch.int32, device=p.device)
    if not (float(edge.max()) == 1.0 and float(edge.min()) == 0.0
            and torch.equal(_hash_encode_cuda(table, prim, bias, edge, anc),
                            hash_encode_raw(table, prim, bias, edge, anc))):
        raise AssertionError("nerfacto: H4 at the contracted faces differs "
                             "from the plain encode")
    log("[nerfacto] H4 at points contracted onto the faces (coordinates "
        "exactly 0.0 and 1.0) equal to the plain encode bit for bit")
    del enc
    torch.cuda.empty_cache()
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p.get_train_loss_dict(NERFACTO_STEPS + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    prof = profile_device(lambda: p.get_train_loss_dict(NERFACTO_STEPS + 2))
    prof["step_ms"] = min(times) * 1e3
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["step_ms"]
    spans = {k: round(v, 2) for k, v in prof["stage_device_span_ms"].items()}
    top = [(k["name"][:60], round(k["device_ms"], 3), k["count"])
           for k in prof["top_kernels"][:8]]
    log(f"[nerfacto] one step, profiled: {prof['step_ms']:.1f} ms on the "
        f"host clock (the faster of 2), device busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}; stage device spans (ms) {spans}; "
        f"busiest kernels {top}; host waits {prof['host_waits']}")

    # the entry points on the checkpoint
    config_path = trainer.base_dir / "config.json"
    del trainer, p, get_loss, eval_image, batch, draws
    torch.cuda.empty_cache()
    t = time.perf_counter()
    eval_entry.main(["--load-config", str(config_path), "--output-path",
                     str(tmp / "nerfacto_eval.json")])
    eval_s = time.perf_counter() - t
    res = json.loads((tmp / "nerfacto_eval.json").read_text())["results"]
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"gfnerf_tpu_torch.eval on nerfacto: {res}")
    frames_dir = tmp / "nerfacto_frames"
    t = time.perf_counter()
    render_entry.main(["--load-config", str(config_path), "--traj", "spiral",
                       "--spiral-steps", "2", "--output-path",
                       str(frames_dir)])
    render_s = time.perf_counter() - t
    frames = sorted(frames_dir.glob("*.png"))
    if len(frames) != 2 or any(read_png(f).shape != (72, 96, 3)
                               for f in frames):
        raise AssertionError(f"gfnerf_tpu_torch.render wrote {frames}")
    log(f"[nerfacto] python -m gfnerf_tpu_torch.eval on the checkpoint in "
        f"{eval_s:.2f}s: {json.dumps(res)}; .render --traj spiral "
        f"--spiral-steps 2 in {render_s:.2f}s: {[f.name for f in frames]}, "
        f"each 96x72 RGB")

    # semantic-nerfw: a few steps on the scene with road masks
    roads = road_scene(tmp)
    cfg = get_method("semantic-nerfw")
    for key, value in {"max_num_iterations": str(SEMANTIC_NERFW_STEPS),
                       "steps_per_log": "1",
                       "output_dir": str(tmp / "semantic_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = roads
    sem = Trainer(cfg, build_dataparser("minimal", roads))
    sem.setup()
    sem_losses = []
    get_sem = sem.pipeline.get_train_loss_dict

    def get_sem_w(step):
        m = get_sem(step)
        sem_losses.append(m)
        return m

    sem.pipeline.get_train_loss_dict = get_sem_w
    before = counts()
    t = time.perf_counter()
    sem.train()
    torch.cuda.synchronize()
    sem_s = time.perf_counter() - t
    after = counts()
    sem_counts = {k: after[k] - before[k] for k in after}
    sl = [m["semantics_loss"] for m in sem_losses]
    log(f"[nerfacto] semantic-nerfw: {SEMANTIC_NERFW_STEPS} steps in "
        f"{sem_s:.2f}s; semantics losses {sl}; losses "
        f"{[round(m['loss'], 4) for m in sem_losses]}; launches {sem_counts}")
    if len(sl) != SEMANTIC_NERFW_STEPS or not np.isfinite(sl).all() \
            or sem_counts["hash_anchored_fwd_calls"] != \
            3 * SEMANTIC_NERFW_STEPS:
        raise AssertionError(f"semantic-nerfw: {sem_losses} {sem_counts}")
    launches = {k: launches[k] + sem_counts[k] for k in launches}
    del sem
    torch.cuda.empty_cache()
    stats = {
        "setup_s": setup_s, "train_s": train_s,
        "s_per_step": _mean(step_s),
        "median_s_per_step": float(np.median(step_s)),
        "rays_per_s": rays / _mean(step_s), "peak_bytes": peak,
        "eval_image_s": image_s, "eval_psnr": metrics["psnr"],
        "mean_image_psnr": trivial, "eval_entry": res,
        "eval_entry_s": eval_s, "render_entry_s": render_s,
        "losses_every_25_steps": {k: v[::25] for k, v in hist.items()},
        "semantic_nerfw_losses": sem_losses,
        "step_pair": pair,
        "profile": {n: prof[n] for n in ("step_ms", "device_busy_ms",
                                         "idle_share",
                                         "stage_device_span_ms")},
    }
    return launches, stats, kernels


def phase_semantics(tmp: Path):
    """gf-nerf-perf with semantics (weight 0.5, 2 classes from the road
    masks) and the camera optimizer (SO3xR3) through the Trainer at its
    full width, on the pipeline phase's scene with road masks and on its
    checkpoint's octree and march config (the config's tree is not built
    again): SEMANTICS_INIT_STEPS init steps, the transition (48 error maps,
    10 clusters), 2 focal steps on block 0.  Counted: every init step K1
    and K2 once, H1 once and H2 in one call; every focal step K1 and K2
    once, H1 twice (the block's encode on the global one) and H2 once;
    H3-H5 never.  Checked: the semantics loss and the camera regularizer
    finite at every step; the camera tangents moved by the init steps and
    bit-unchanged by the focal ones (a step whose march finds no sample,
    at the first steps' fineness, moves them not at all); one init step
    from the trained state
    against the plain pairs (K2 given the semantics' nonzero weights
    cotangent), the camera tangents' gradient included."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.pipelines.pipeline import GFNerfPipeline
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch

    roads = tmp / "scene_roads"
    if not roads.is_dir():
        roads = road_scene(tmp)
    tree_ckpt = sorted((tmp / "out").glob(
        "scene/gf-nerf-perf/*/nerfstudio_models/step-*"))[-1]
    cfg = get_method("gf-nerf-perf")
    for key, value in {**SEMANTICS_OVERRIDES,
                       "max_num_iterations": str(SEMANTICS_STEPS),
                       "output_dir": str(tmp / "semantics_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = roads

    def build_on_tree(dataparser, base_dir, device="cuda", draws=None,
                      checkpoint=None):
        # the pipeline phase's tree and march config, no field state
        return GFNerfPipeline(cfg.pipeline, dataparser, base_dir, device,
                              draws, tree_ckpt)

    cfg.pipeline.build = build_on_tree
    trainer = Trainer(cfg, build_dataparser("minimal", roads))
    SETUP_REUSE.note()   # this setup's reuses alone
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    fc = p.field_cfg
    reused = SETUP_REUSE.note()
    log(f"[semantics] setup {setup_s:.2f}s ({reused})"
        f" on {tree_ckpt.name}'s tree "
        f"({p.sampler.tree.n_nodes} nodes); camera_opt_mode "
        f"{fc.camera_opt_mode}, use_semantics {fc.use_semantics} "
        f"({fc.num_semantic_classes} classes), {fc.num_levels} x "
        f"{fc.features_per_level} levels of 2^{fc.packed_rows_log2}, "
        f"{p.config.datamanager.train_num_rays_per_batch} rays, "
        f"{p.sampler.sampler_config.max_samples} slots")
    if not (fc.use_semantics and fc.camera_opt_mode == "SO3xR3"):
        raise AssertionError(f"semantics phase config: {fc}")
    rec = {}
    get_loss = p.get_train_loss_dict

    def counts():
        return {**launch_counts(),
                "packed_hash_bwd_calls": packed_hash_encode.bwd_calls}

    def get_loss_w(step):
        before = counts()
        adj = p.field.camera_adjustment.detach().clone()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        after = counts()
        rec[step] = {"s": time.perf_counter() - t, **m,
                     "counts": {k: after[k] - before[k] for k in after},
                     "moved": not torch.equal(
                         adj, p.field.camera_adjustment.detach())}
        return m

    p.get_train_loss_dict = get_loss_w
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    p.get_train_loss_dict = get_loss
    if sorted(rec) != list(range(SEMANTICS_STEPS)):
        raise AssertionError(f"semantics: steps run {sorted(rec)}")
    h2 = table_grad_launches({"fcfg": fc})
    for i in range(SEMANTICS_STEPS):
        init = i < SEMANTICS_INIT_STEPS
        want = {"composite_fwd": 1, "composite_bwd": 1,
                "packed_hash_fwd": 1 if init else 2,
                "packed_hash_bwd": h2, "packed_hash_bwd_calls": 1}
        st = rec[i]
        if st["counts"] != {k: want.get(k, 0) for k in st["counts"]}:
            raise AssertionError(f"semantics step {i}: launches "
                                 f"{st['counts']}, expected {want}")
        for k in ("semantics_loss", "camera_opt_regularizer", "loss"):
            if not np.isfinite(st[k]):
                raise AssertionError(f"semantics step {i}: {k} {st[k]}")
    moved = [rec[i]["moved"] for i in range(SEMANTICS_STEPS)]
    # a step whose march found no sample (the first steps' fineness of 16)
    # renders the background alone: no gradient reaches the tangents
    sampled = [rec[i]["num_samples_per_ray"] > 0
               for i in range(SEMANTICS_INIT_STEPS)]
    per_step = [(round(rec[i]["semantics_loss"], 5),
                 rec[i]["camera_opt_regularizer"], round(rec[i]["loss"], 5),
                 round(rec[i]["num_samples_per_ray"], 1))
                for i in range(SEMANTICS_STEPS)]
    log(f"[semantics] per step (semantics loss, camera regularizer, loss, "
        f"samples a ray): {per_step}")
    log(f"[semantics] the camera tangents moved by step: {moved}; largest "
        f"|tangent| "
        f"{float(p.field.camera_adjustment.detach().abs().max()):.3g}; "
        f"launches per step as expected (init K1, K2, H1 once, H2 one call "
        f"of {h2}; focal H1 twice); in the whole run {launches}")
    if not (any(sampled) and moved[:SEMANTICS_INIT_STEPS] == sampled
            and not any(moved[SEMANTICS_INIT_STEPS:])):
        raise AssertionError(f"semantics: the tangents moved {moved}, the "
                             f"init steps that sampled {sampled}")
    if p.sampler.cameras_labels is None or len(
            np.unique(p.sampler.cameras_labels)) != fc.n_blocks:
        raise AssertionError("semantics: no transition")
    images = np.asarray(p.datamanager.train_dataset.metadata[
        "images_array"], np.float32) / 255.0
    wl = {"field": p.field, "state": p.state, "tx": p.tx,
          "step_fn": p._train_step[STAGE_INIT],
          "focal_step_fn": p._train_step[STAGE_BLOCK],
          "oct_dev": p.sampler.oct_dev, "cams": p.cameras_dev,
          "fineness": 1.0, "scfg": p.sampler.sampler_config, "fcfg": fc}
    batch = make_batch(images, RAYS, 700, p.device)
    h = images.shape[1]
    batch["semantics"] = (batch["coords"][:, 0] >= h // 2).long()
    gen = torch.Generator(device=p.device).manual_seed(9)
    noise, perms = step_draws(wl, gen)
    loss = compare_step(wl, "semantics", batch, noise, perms)
    init_s = [rec[i]["s"] for i in range(2, SEMANTICS_INIT_STEPS)]
    stats = {"setup_s": setup_s, "train_s": train_s,
             "init_s_per_step": _mean(init_s),
             "semantics_losses": [rec[i]["semantics_loss"]
                                  for i in range(SEMANTICS_STEPS)],
             "camera_opt_regularizers": [
                 rec[i]["camera_opt_regularizer"]
                 for i in range(SEMANTICS_STEPS)],
             "compare_step_loss": loss}
    del trainer, p, wl
    torch.cuda.empty_cache()
    return launches, stats


# instant-ngp on a Blender scene read from disk: 1500 steps, so that the
# grid's empty cells fall below the threshold (0.95^k < 0.01 needs k >= 90
# EMA updates, one every 16 steps)
NGP_STEPS = 1500
NGP_WARMUP = 5
NGP_OVERRIDES = {
    "steps_per_eval_image": str(NGP_STEPS),
    "steps_per_save": str(NGP_STEPS),
    "steps_per_log": "250",
}
# the scene: RGBA PNGs with a transparent sky (train views, val views,
# width and height, focal length: a 58-degree field of view)
NGP_SCENE = (24, 4, (200, 200), 180.0)
# (rays, samples, levels, log2 entries, hidden, geo features, grid, EMA
# decay, threshold, aabb_scale, background)
INSTANT_NGP_WIDTH = (4096, 192, 16, 19, 64, 15, 96, 0.95, 0.01, 1.5, "white")
NGP_DYNAMIC_STEPS = 4
NGP_DISTORTED_STEPS = 4


class record_ngp_encodes:
    """Within the block, the arguments of every hash_encode call that
    instant-ngp's model makes, in order (points and anchors cloned)."""

    def __enter__(self):
        from gfnerf_tpu_torch.models import instant_ngp as ngp_mod

        self.mod, self.saved, self.calls = ngp_mod, ngp_mod.hash_encode, []

        def rec(table, prim, bias, pts, anc, *a, **kw):
            self.calls.append((table.detach(), prim, bias,
                               pts.detach().clone(), anc.clone()))
            return self.saved(table, prim, bias, pts, anc, *a, **kw)

        ngp_mod.hash_encode = rec
        return self

    def __exit__(self, *exc):
        self.mod.hash_encode = self.saved
        return False


def ngp_step_pair(p, batch, draws) -> dict:
    """instant-ngp's loss and backward from two copies of the pipeline's
    model on one batch and its draws, through H4/H5 and through the plain
    pairs (no kernel may launch in the plain one): the loss to
    TRAIN_LOSS_RTOL, the table's gradient to NERFACTO_TABLE_GRAD_TOL of its
    largest, the MLPs' to TRAIN_GRAD_TOL of their largest; then the
    occupancy update from each copy with the same jitter, equal bit for
    bit (H4 equals its plain version).  Returns the errors."""
    import copy

    import torch

    from gfnerf_tpu_torch.fields.hash_encoding import plain_hash_encode
    from gfnerf_tpu_torch.models import instant_ngp as ngp_mod

    gen = torch.Generator(device=p.device).manual_seed(11)
    jitter = ngp_mod.occupancy_jitter(p.model_cfg, gen, p.device)
    runs, model0, encode = {}, p.model, ngp_mod.hash_encode
    for kind in ("kernels", "plain"):
        p.model = copy.deepcopy(model0)
        before = launch_counts()
        if kind == "plain":
            ngp_mod.hash_encode = plain_hash_encode
        try:
            total, _ = p.loss(batch, draws)
            total.backward()
            ngp_mod.update_occupancy(p.model, jitter)
            torch.cuda.synchronize()
            runs[kind] = (total.item(), p.model)
        finally:
            ngp_mod.hash_encode = encode
            p.model = model0
        if kind == "plain" and launch_counts() != before:
            raise AssertionError("instant-ngp: the plain step launched "
                                 "kernels")
    (lk, mk), (lp, mp) = runs["kernels"], runs["plain"]
    rel = abs(lk - lp) / abs(lp)
    out = {"loss": (lk, lp, rel)}
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"instant-ngp step loss: kernels {lk} vs plain "
                             f"{lp}")
    scale = float(mp.feat.grad.abs().max())
    err = float((mk.feat.grad - mp.feat.grad).abs().max())
    out["table"] = (err, scale)
    if not (scale > 0 and err <= NERFACTO_TABLE_GRAD_TOL * scale):
        raise AssertionError(f"instant-ngp table gradient: kernels vs plain "
                             f"{err} of {scale}")
    mlps = [(a, b) for (n, a), b in zip(mk.named_parameters(),
                                        mp.parameters()) if n != "feat"]
    scale = max(float(b.grad.abs().max()) for _, b in mlps)
    err = max(float((a.grad - b.grad).abs().max()) for a, b in mlps)
    out["mlps"] = (err, scale)
    if not err <= TRAIN_GRAD_TOL * scale:
        raise AssertionError(f"instant-ngp MLP gradients: kernels vs plain "
                             f"{err} of {scale}")
    if not torch.equal(mk.occ, mp.occ):
        raise AssertionError("instant-ngp: the occupancy update through H4 "
                             "differs from the plain one")
    log(f"[instant-ngp] one step, kernels vs plain: loss {lk:.7f} vs "
        f"{lp:.7f} (rel {rel:.3g}, tol {TRAIN_LOSS_RTOL}); gradients (max "
        f"abs err, largest): table {out['table']}, MLPs {out['mlps']}; the "
        f"occupancy update equal bit for bit")
    del runs, mk, mp
    torch.cuda.empty_cache()
    return out


def png_round_trips(tmp: Path) -> int:
    """Every PNG colour type and bit depth under every filter type through
    write_png and read_png (this machine has no imageio to read them
    with): grey at 1, 2, 4, 8, 16 bits, palette at 1, 2, 4, 8 with and
    without tRNS, grey-alpha, RGB and RGBA at 8 and 16; a file split into
    several IDAT chunks.  Returns the files checked."""
    import struct
    import zlib

    import numpy as np

    from gfnerf_tpu_torch.utils.image_io import png_size, read_png, write_png

    rng = np.random.default_rng(21)
    h, w = 13, 29
    n = 0
    for ftype in (0, 1, 2, 3, 4, [y % 5 for y in range(h)]):
        cases = []
        for depth in (1, 2, 4, 8):
            idx = rng.integers(0, 1 << depth, (h, w)).astype(np.uint8)
            want = (idx.astype(np.uint16) * 255 // ((1 << depth) - 1)
                    ).astype(np.uint8)
            cases.append((f"grey{depth}", idx, dict(bit_depth=depth), want))
            for cols in (3, 4):
                pal = rng.integers(0, 256, (1 << depth, cols)).astype(
                    np.uint8)
                cases.append((f"palette{depth}x{cols}", idx,
                              dict(palette=pal, bit_depth=depth), pal[idx]))
        for dtype in (np.uint8, np.uint16):
            for c in (1, 2, 3, 4):
                img = rng.integers(0, np.iinfo(dtype).max + 1, (h, w, c),
                                   dtype=dtype)
                img = img[..., 0] if c == 1 else img
                cases.append((f"{c}ch{dtype.__name__}", img, {}, img))
        for name, img, kw, want in cases:
            path = tmp / f"rt_{name}.png"
            write_png(path, img, filter_type=ftype, **kw)
            got = read_png(path)
            if got.dtype != want.dtype or not np.array_equal(got, want):
                raise AssertionError(f"PNG round trip {name} filter {ftype}")
            if png_size(path) != (w, h):
                raise AssertionError(f"png_size {name}")
            n += 1
    # one image's stream split over several IDAT chunks
    big = rng.integers(0, 256, (300, 400, 3), dtype=np.uint8)
    write_png(tmp / "split.png", big, filter_type=4)
    data = (tmp / "split.png").read_bytes()
    pos, chunks = 8, []
    while pos < len(data):
        (k,) = struct.unpack(">I", data[pos:pos + 4])
        chunks.append((data[pos + 4:pos + 8], data[pos + 8:pos + 8 + k]))
        pos += 12 + k
    idat = b"".join(b for t, b in chunks if t == b"IDAT")
    parts = [idat[i:i + 8192] for i in range(0, len(idat), 8192)]

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))

    (tmp / "split.png").write_bytes(
        data[:8] + chunk(b"IHDR", chunks[0][1])
        + b"".join(chunk(b"IDAT", q) for q in parts) + chunk(b"IEND", b""))
    if not np.array_equal(read_png(tmp / "split.png"), big):
        raise AssertionError(f"PNG of {len(parts)} IDAT chunks")
    return n + 1


def distorted_ngp_scene(scene: Path, dst: Path) -> Path:
    """An instant-ngp-format scene (one transforms.json with top-level
    intrinsics, k1, k2 and p1, p2) over the Blender scene's train PNGs."""
    import numpy as np

    meta = json.loads((scene / "transforms_train.json").read_text())
    dst.mkdir(exist_ok=True)
    frames = [{"file_path": str((scene / fr["file_path"]).resolve())
               + ".png", "transform_matrix": fr["transform_matrix"]}
              for fr in meta["frames"]]
    w, h = NGP_SCENE[2]
    fl = 0.5 * w / np.tan(0.5 * meta["camera_angle_x"])
    (dst / "transforms.json").write_text(json.dumps({
        "fl_x": fl, "fl_y": fl, "cx": w / 2.0, "cy": h / 2.0,
        "k1": 0.02, "k2": -0.005, "p1": 0.001, "p2": -0.0005,
        "aabb_scale": 4, "frames": frames}))
    return dst


def phase_instant_ngp(tmp: Path):
    """instant-ngp through the Trainer at its full width
    (INSTANT_NGP_WIDTH) on a Blender scene written to disk as RGBA PNGs
    (NGP_SCENE, the sky transparent) and read back by the blender parser,
    counted: every step calls H4 once (the field at 4096 x 192 = 786,432
    samples) and H5 once, and the steps at which the grid is updated (every
    16th) call H4 once more (96^3 = 884,736 jittered points, forward only);
    no other kernel.  Checked: finite losses, the rgb loss falling, every
    tensor changed, the grid off all ones and the share of samples it
    keeps below 1 at the end; the eval PSNR above the mean image's; the
    checkpoint reloads to the same eval image, grid included.  Then from
    the trained model: one step against the plain pairs; H4 at both shapes
    and H5 at the train shape against their plain versions (H5 also
    against index_add_); s/step, rays/s, peak memory; one profiled step
    and the occupancy update's time; the eval and render entry points on
    the checkpoint; NGP_DYNAMIC_STEPS steps with dynamic_batch (the batch
    moves to a power of two at or below 4096); NGP_DISTORTED_STEPS steps
    on an instant-ngp-format scene with distortion, its undistorted rays
    against the same function on the CPU; PNG round trips of every colour
    type, bit depth and filter."""
    import dataclasses

    import numpy as np
    import torch

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.pixel_samplers import (PixelSampler,
                                                      collate_batch)
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.hash_encoding import (encode_launches,
                                                       hash_encode,
                                                       table_grad_launches)
    from gfnerf_tpu_torch.models import instant_ngp as ngp_mod
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.utils.image_io import read_png
    from gfnerf_tpu_torch.utils.profiling import profile_device
    from gfnerf_tpu_torch.utils.synthetic import make_blender_fixture

    n_train, n_val, wh, focal = NGP_SCENE
    t0 = time.perf_counter()
    scene = make_blender_fixture(tmp / "ngp_scene", n_train, n_val,
                                 img_wh=wh, rgba=True, focal=focal)
    scene_s = time.perf_counter() - t0
    alpha = read_png(scene / "train" / "r_0.png")[..., 3]
    log(f"[instant-ngp] Blender scene of {n_train} + {n_val} RGBA PNGs at "
        f"{wh[0]}x{wh[1]} written in {scene_s:.2f}s; view 0's alpha: "
        f"{float((alpha == 0).mean()):.3f} of the pixels transparent")
    cfg = get_method("instant-ngp")
    for key, value in {**NGP_OVERRIDES,
                       "max_num_iterations": str(NGP_STEPS),
                       "output_dir": str(tmp / "ngp_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    trainer = Trainer(cfg, build_dataparser("blender", scene))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    mc = p.model_cfg
    width = (p.config.train_num_rays_per_batch, mc.num_samples,
             mc.num_levels, mc.log2_hashmap_size, mc.hidden_dim,
             mc.geo_feat_dim, mc.grid_resolution, mc.occ_ema_decay,
             mc.occ_threshold, mc.aabb_scale, mc.background_color)
    log(f"[instant-ngp] setup {setup_s:.2f}s (the images decoded from disk "
        f"by the port's PNG reader); (rays, samples, levels, log2 entries, "
        f"hidden, geo, grid, EMA decay, threshold, aabb_scale, background) "
        f"{width}; {len(p.train_dataset)} train views")
    if width != INSTANT_NGP_WIDTH:
        raise AssertionError(f"instant-ngp is not at its full width: {width}")
    rays = p.config.train_num_rays_per_batch
    samples = rays * mc.num_samples
    start = {n: t.detach().clone() for n, t in p.model.named_parameters()}
    rec = {"steps": {}}
    get_loss, eval_image = (p.get_train_loss_dict,
                            p.get_eval_image_metrics_and_images)

    def counts():
        return {**launch_counts(), "hash_anchored_fwd_calls":
                hash_encode.calls,
                "hash_anchored_bwd_calls": hash_encode.bwd_calls}

    def get_loss_w(step):
        before = counts()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = counts()
        rec["steps"][step] = {"s": dt, "counts": {
            k: after[k] - before[k] for k in after}, **m}
        return m

    def eval_image_w(step, idx=0):
        t = time.perf_counter()
        metrics, images = eval_image(step, idx)
        rec.setdefault("eval_images", []).append(
            (step, idx, time.perf_counter() - t, metrics, images))
        return metrics, images

    p.get_train_loss_dict = get_loss_w
    p.get_eval_image_metrics_and_images = eval_image_w
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    p.get_train_loss_dict = get_loss
    p.get_eval_image_metrics_and_images = eval_image

    steps = rec["steps"]
    if sorted(steps) != list(range(NGP_STEPS)):
        raise AssertionError(f"instant-ngp: steps run {sorted(steps)}")
    h4, h5 = encode_launches(mc.num_levels), table_grad_launches(
        mc.num_levels, samples, 1 << mc.log2_hashmap_size, 2)
    for i in range(NGP_STEPS):
        extra = int(i % ngp_mod.OCC_UPDATE_EVERY == 0)
        want = {"hash_anchored_fwd": h4 * (1 + extra),
                "hash_anchored_bwd": h5,
                "hash_anchored_fwd_calls": 1 + extra,
                "hash_anchored_bwd_calls": 1}
        got = steps[i]["counts"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"instant-ngp step {i}: launches {got}, "
                                 f"expected {want}")
    log(f"[instant-ngp] launches per step as expected: H4 once ({h4} "
        f"launches), twice at every {ngp_mod.OCC_UPDATE_EVERY}th step (the "
        f"occupancy update), H5 once ({h5} launches), no other kernel; in "
        f"the whole run {launches}")
    keys = [k for k in steps[0] if k not in ("s", "counts")]
    hist = {k: [steps[i][k] for i in range(NGP_STEPS)] for k in keys}
    every = max(NGP_STEPS // 12, 1)
    log(f"[instant-ngp] metrics every {every} steps: "
        f"{ {k: [round(v, 5) for v in hist[k][::every]] for k in keys} }")
    if not all(np.isfinite(v).all() for v in hist.values()):
        raise AssertionError("instant-ngp: a non-finite loss")
    rgb = hist["rgb_loss"]
    if not _mean(rgb[-10:]) < _mean(rgb[:10]):
        raise AssertionError(f"instant-ngp: the rgb loss did not fall: "
                             f"{rgb[::every]}")
    unchanged = [n for n, t in p.model.named_parameters()
                 if torch.equal(t.detach(), start[n])]
    if unchanged:
        raise AssertionError(f"instant-ngp: unchanged parameters {unchanged}")
    occ = p.model.occ
    keep_end = hist["num_samples_per_batch"][-1] / samples
    occ_stats = {"min": float(occ.min()), "max": float(occ.max()),
                 "ones": int((occ == 1.0).sum()),
                 "below_threshold": float((occ <= mc.occ_threshold)
                                          .float().mean()),
                 "keep_frac_last_step": keep_end}
    log(f"[instant-ngp] every one of the {len(start)} parameter tensors "
        f"changed; the grid after {NGP_STEPS} steps: {occ_stats}")
    if occ_stats["ones"] or not keep_end < 1.0:
        raise AssertionError(f"instant-ngp: the grid {occ_stats}")
    step, idx, image_s, metrics, images = rec["eval_images"][-1]
    gt = p.eval_dataset.get_image(idx)
    trivial = float(-10.0 * np.log10(np.mean((gt - gt.mean(axis=(0, 1)))
                                             ** 2)))
    log(f"[instant-ngp] eval image {idx} at step {step} in {image_s:.3f}s: "
        f"{json.dumps(metrics)}; mean-image PSNR {trivial:.4f}")
    if not metrics["psnr"] > trivial:
        raise AssertionError(f"instant-ngp: eval PSNR {metrics['psnr']} not "
                             f"above the mean image's {trivial}")
    ckpt = trainer.checkpoint_dir / f"step-{NGP_STEPS - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"instant-ngp: no checkpoint at {ckpt}")
    step_s = [steps[i]["s"] for i in range(NGP_WARMUP, NGP_STEPS)]
    occ_steps = [steps[i]["s"] for i in range(NGP_WARMUP, NGP_STEPS)
                 if i % ngp_mod.OCC_UPDATE_EVERY == 0]
    log(f"[instant-ngp] Trainer: {_mean(step_s):.4f} s/step (median "
        f"{float(np.median(step_s)):.4f}, after {NGP_WARMUP} warm-up steps; "
        f"the steps with an occupancy update {_mean(occ_steps):.4f}), "
        f"{rays / _mean(step_s):.1f} rays/s; peak {peak / 2**30:.3f} GiB; "
        f"the run {train_s:.1f}s")

    # the checkpoint: a pipeline rebuilt from it renders the same eval image
    config_path = trainer.base_dir / "config.json"
    t = time.perf_counter()
    _, loaded = eval_setup(config_path, "blender")
    lp = loaded.pipeline
    same_grid = torch.equal(lp.model.occ, p.model.occ)
    again = lp.get_eval_image_metrics_and_images(step, idx)[1]["img"]
    load_s = time.perf_counter() - t
    if not (same_grid and np.array_equal(again, images["img"])):
        raise AssertionError("instant-ngp: the checkpoint did not restore "
                             "the grid and the eval image")
    log(f"[instant-ngp] the checkpoint reloaded in {load_s:.2f}s: the grid "
        f"equal, the eval image equal bit for bit")
    del loaded, lp
    torch.cuda.empty_cache()

    # from the trained model: a step against the plain pairs, the kernels
    # at the step's and the occupancy update's shapes, a profiled step
    sampler = PixelSampler(rays, seed=700)
    batch = p._device_batch(collate_batch(p.cache,
                                          sampler.sample_indices(p.cache)))
    gen = torch.Generator(device=p.device).manual_seed(700)
    draws = [torch.rand((rays, mc.num_samples + 1), generator=gen,
                        device=p.device)]
    pair = ngp_step_pair(p, batch, draws)
    jitter = ngp_mod.occupancy_jitter(mc, gen, p.device)
    saved_occ = p.model.occ.clone()
    with torch.no_grad(), record_ngp_encodes() as enc:
        p.loss(batch, draws)
        ngp_mod.update_occupancy(p.model, jitter)
    p.model.occ.copy_(saved_occ)
    shapes = [(tuple(c[0].shape), c[3].shape[0]) for c in enc.calls]
    table_shape = (mc.num_levels, 1 << mc.log2_hashmap_size, 2)
    want_shapes = [(table_shape, samples),
                   (table_shape, mc.grid_resolution ** 3)]
    log(f"[instant-ngp] H4's calls (table, points): {shapes}")
    if shapes != want_shapes:
        raise AssertionError(f"instant-ngp: encodes at {shapes}, expected "
                             f"{want_shapes}")
    kernels = {}
    for name, (table, prim, bias, pts, anc) in zip(
            ("train step", "occupancy update"), enc.calls):
        kernels[name] = time_anchored_at(table, (prim, bias, pts, anc),
                                         f"instant-ngp {name}",
                                         parent=name == "train step")
    del enc
    torch.cuda.empty_cache()
    occ_ms = time_ms(lambda: ngp_mod.update_occupancy(p.model, jitter), n=7)
    p.model.occ.copy_(saved_occ)
    log(f"[instant-ngp] the occupancy update (96^3 points, H4 and the base "
        f"MLP, no graph): {occ_ms:.4f} ms, once every "
        f"{ngp_mod.OCC_UPDATE_EVERY} steps")
    times = []
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p.get_train_loss_dict(NGP_STEPS + 1 + i)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    prof = profile_device(lambda: p.get_train_loss_dict(NGP_STEPS + 3))
    prof["step_ms"] = min(times) * 1e3
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["step_ms"]
    spans = {k: round(v, 2) for k, v in prof["stage_device_span_ms"].items()}
    top = [(k["name"][:60], round(k["device_ms"], 3), k["count"])
           for k in prof["top_kernels"][:8]]
    log(f"[instant-ngp] one step, profiled: {prof['step_ms']:.1f} ms on the "
        f"host clock (the faster of 2), device busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}; stage device spans (ms) {spans}; "
        f"busiest kernels {top}; host waits {prof['host_waits']}")

    # the entry points on the checkpoint
    del trainer, p, get_loss, eval_image, batch, draws, images
    torch.cuda.empty_cache()
    t = time.perf_counter()
    eval_entry.main(["--load-config", str(config_path), "--output-path",
                     str(tmp / "ngp_eval.json")])
    eval_s = time.perf_counter() - t
    res = json.loads((tmp / "ngp_eval.json").read_text())["results"]
    if not all(np.isfinite(v) for v in res.values()):
        raise AssertionError(f"gfnerf_tpu_torch.eval on instant-ngp: {res}")
    frames_dir = tmp / "ngp_frames"
    t = time.perf_counter()
    render_entry.main(["--load-config", str(config_path), "--traj", "spiral",
                       "--spiral-steps", "2", "--output-path",
                       str(frames_dir)])
    render_s = time.perf_counter() - t
    frames = sorted(frames_dir.glob("*.png"))
    if len(frames) != 2 or any(read_png(f).shape != (wh[1], wh[0], 3)
                               for f in frames):
        raise AssertionError(f"gfnerf_tpu_torch.render wrote {frames}")
    log(f"[instant-ngp] python -m gfnerf_tpu_torch.eval on the checkpoint "
        f"(the blender parser guessed from the scene) in {eval_s:.2f}s: "
        f"{json.dumps(res)}; .render --traj spiral --spiral-steps 2 in "
        f"{render_s:.2f}s: {[f.name for f in frames]}")

    def short_run(name, parser, overrides, n_steps):
        run_cfg = get_method("instant-ngp")
        for key, value in {"max_num_iterations": str(n_steps),
                           "steps_per_log": "1", "steps_per_save": "1000",
                           "steps_per_eval_image": "1000",
                           "output_dir": str(tmp / name), **overrides
                           }.items():
            apply_override(run_cfg, key, value)
        run_cfg.data = parser.config.data
        run = Trainer(run_cfg, parser)
        run.setup()
        got = []
        inner = run.pipeline.get_train_loss_dict

        def wrapped(step):
            m = inner(step)
            got.append(m)
            return m

        run.pipeline.get_train_loss_dict = wrapped
        before = counts()
        t = time.perf_counter()
        run.train()
        torch.cuda.synchronize()
        after = counts()
        return run, got, time.perf_counter() - t, {
            k: after[k] - before[k] for k in after}

    # dynamic_batch: the kept samples retarget the rays a batch
    run, dyn, dyn_s, dyn_counts = short_run(
        "ngp_dynamic", build_dataparser("blender", scene),
        {"pipeline.dynamic_batch": "true"}, NGP_DYNAMIC_STEPS)
    sizes = [m["num_rays_per_batch"] for m in dyn]
    log(f"[instant-ngp] dynamic_batch, {NGP_DYNAMIC_STEPS} steps in "
        f"{dyn_s:.2f}s: rays a batch after each {sizes}, kept samples "
        f"{[m['num_samples_per_batch'] for m in dyn]} (target "
        f"{run.pipeline.config.target_num_samples}); launches {dyn_counts}")
    if not (all(n & (n - 1) == 0 and 256 <= n <= rays for n in sizes)
            and sizes[0] < rays):
        raise AssertionError(f"instant-ngp dynamic_batch: {sizes}")
    del run
    torch.cuda.empty_cache()

    # an instant-ngp-format scene with distortion: a few steps, and the
    # undistorted rays on the card against the CPU's
    ngp_dir = distorted_ngp_scene(scene, tmp / "ngp_distorted")
    parser = build_dataparser("instant-ngp", ngp_dir)
    run, dist, dist_s, dist_counts = short_run(
        "ngp_distorted_out", parser, {}, NGP_DISTORTED_STEPS)
    host = run.pipeline.train_outputs.cameras
    rng = np.random.default_rng(5)
    n_rays = 65536
    idx = rng.integers(0, len(host), n_rays)
    coords = np.stack([rng.uniform(0, wh[1], n_rays),
                       rng.uniform(0, wh[0], n_rays)], -1).astype(np.float32)
    outs = {}
    for dev in ("cuda", "cpu"):
        outs[dev] = generate_rays_multi(
            host.to_device(dev), torch.as_tensor(idx, device=dev),
            torch.as_tensor(coords, device=dev))
    ray_err = max(float((outs["cuda"][k].cpu() - outs["cpu"][k]).abs().max())
                  for k in ("directions", "origins", "pixel_area"))
    pinhole = float((outs["cpu"]["directions"] - generate_rays_multi(
        dataclasses.replace(host, distortion_params=None).to_device("cpu"),
        torch.as_tensor(idx), torch.as_tensor(coords))["directions"]
        ).abs().max())
    log(f"[instant-ngp] instant-ngp-format scene (k1 k2 p1 p2, "
        f"{len(host)} train views): {NGP_DISTORTED_STEPS} steps in "
        f"{dist_s:.2f}s, losses {[round(m['loss'], 5) for m in dist]}, "
        f"launches {dist_counts}; generate_rays_multi on the card vs the "
        f"CPU over {n_rays} rays: max abs err {ray_err:.3g} (the "
        f"undistortion moves directions by up to {pinhole:.3g})")
    if not (ray_err <= 1e-6 and pinhole > 1e-4
            and all(np.isfinite(m["loss"]) for m in dist)
            and dist_counts["hash_anchored_bwd_calls"]
            == NGP_DISTORTED_STEPS):
        raise AssertionError(f"instant-ngp distorted: {ray_err} {pinhole} "
                             f"{dist} {dist_counts}")
    del run
    torch.cuda.empty_cache()
    n_png = png_round_trips(tmp)
    log(f"[instant-ngp] {n_png} PNGs round-tripped through write_png and "
        f"read_png: every colour type, bit depth and filter type, and one "
        f"file of several IDAT chunks")
    launches = {k: launches[k] + dyn_counts[k] + dist_counts[k]
                for k in launches}
    stats = {
        "scene_s": scene_s, "setup_s": setup_s, "train_s": train_s,
        "s_per_step": _mean(step_s),
        "median_s_per_step": float(np.median(step_s)),
        "occupancy_step_s": _mean(occ_steps), "occupancy_update_ms": occ_ms,
        "rays_per_s": rays / _mean(step_s), "peak_bytes": peak,
        "eval_image_s": image_s, "eval_psnr": metrics["psnr"],
        "mean_image_psnr": trivial, "eval_entry": res,
        "eval_entry_s": eval_s, "render_entry_s": render_s,
        "grid": occ_stats, "dynamic_batch_sizes": sizes,
        "distorted_ray_err": ray_err, "png_files": n_png,
        "losses_every_125_steps": {k: v[::125] for k, v in hist.items()},
        "step_pair": pair,
        "profile": {n: prof[n] for n in ("step_ms", "device_busy_ms",
                                         "idle_share",
                                         "stage_device_span_ms")},
    }
    return launches, stats, kernels


# gf-nerf-perf with the scan march (kernel M1) through the Trainer, on the
# pipeline phase's scene and schedule: 24 init steps (milestone rebuilds at
# 8 and 16), the transition, 2 focal steps on each of blocks 0 and 1.  The
# octree and the widths are the config's; only the march differs.
SCAN_STEPS = PIPELINE_INIT_STEPS + 4
SCAN_OVERRIDES = {**PIPELINE_OVERRIDES, **ONE_STEP_A_DISPATCH,
                  "pipeline.sampler.march": "scan",
                  "steps_per_eval_batch": "1000",
                  "steps_per_eval_image": "1000",
                  "steps_per_save": "1000"}
# M1 against the plain scan on the same rays and noise, at the main
# path's shapes (the train batch at S = 160, gf-nerf's march at S = 1024,
# a render chunk at S = 384): the share of rays whose valid, trans, oct or
# block rows may differ (M1 repeats the plain version's roundings, so none
# is expected), and the relative error of t, dt and the points on the rest
M1_DIFFER_SHARE = 1e-3
M1_RTOL = 1e-5
# the scan against the fast march: rays, and where to write the case (the
# octree and the rays) for the JAX package's pair on the CPU
# (``--coverage-case PATH``; tests/torch_parity.py scan-coverage PATH)
COVERAGE_RAYS = 512
COVERAGE_CASE = None
# Past the scene the trained octree's leaves grow shorter than a step: the
# fast march places floor(length / step) = 0 samples in such a leaf, the
# scan steps into it and emits one, so their last t and leaves differ there.
# The JAX package's own pair does the same: on this check's octree and rays
# from an H100 run of this script (``--coverage-case``, then
# ``tests/torch_parity.py scan-coverage``) it gave the figures below, equal
# to the port's on the card and on the CPU.  The port's pair is held to
# them: the shares and the leaf coverage within COVERAGE_SHARE_TOL, the
# median last-t gap within COVERAGE_GAP_RTOL of it.
COVERAGE_JAX = {"last_t_share": 0.0, "median_last_t_diff": 105.59359741210938,
                "leaf_coverage": 0.7964599747003611}
COVERAGE_SHARE_TOL = 0.05
COVERAGE_GAP_RTOL = 0.1
# the compacted branch: gf-nerf's march of 1024 slots, budget 256
SCAN_GFNERF_SLOTS, SCAN_GFNERF_BUDGET = 1024, 256
# M1 by part: the train batch's rays at these counts (the first also the
# count of the repeated and the missing rays), each of the first count /
# SCAN_PART_REPEAT rays repeated SCAN_PART_REPEAT times in a row
SCAN_PART_RAYS = (8192, 16384, 32768, 65536)
SCAN_PART_REPEAT = 32
# the edge case whose anchor changes at nearly every slot: the train
# noise times this, and the least share of its emitted slots whose anchor
# differs from the previous emitted slot's
SCAN_EDGE_NOISE = 16.0
SCAN_EDGE_CHANGES = 0.8


def check_scan_march(oct_dev, scfg, o, d, s, seed, what,
                     eval_noise=False, noise_scale=1.0, edge=False) -> dict:
    """M1 against the plain scan (``perssampler.get_samples``) on rays o, d
    at S = s with the same noise (a render's, all ones, with
    ``eval_noise``; train noise times ``noise_scale``): the rays whose rows
    differ (at most M1_DIFFER_SHARE of them), the largest error of t, dt,
    the world and the warped points on the others relative to each one's
    largest value (at most M1_RTOL), num_valid and the first-hit distance.
    Also the plain scan's time for the call (CUDA events around it), and
    the share of a ray's emitted slots whose anchor differs from the
    previous emitted slot's.  An ``edge`` case (an edge shape, rays that
    miss) must be equal bit for bit and need not emit a sample a ray."""
    import dataclasses

    import torch

    from gfnerf_tpu_torch.ops.scan_march import scan_march
    from gfnerf_tpu_torch.sampler.perssampler import get_samples

    gen = torch.Generator(device="cuda").manual_seed(seed)
    r = o.shape[0]
    noise = (torch.ones((r, s), device="cuda") if eval_noise else
             (torch.rand((r, s), generator=gen, device="cuda") + 0.5)
             * noise_scale)
    cfg = dataclasses.replace(scfg, max_samples=s, march="scan")
    got = scan_march(oct_dev, o, d, noise, cfg)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = get_samples(oct_dev, o, d, noise, cfg)
    end.record()
    torch.cuda.synchronize()
    plain_ms = start.elapsed_time(end)
    bad = torch.zeros(r, dtype=torch.bool, device="cuda")
    for k in ("valid", "trans_idx", "oct_idx", "block_idx"):
        bad |= (getattr(got, k) != getattr(want, k)).reshape(r, -1).any(1)
    ok = ~bad
    errs = {}
    for k in ("ts", "dists", "world_pts", "warp_pts"):
        g, w = getattr(got, k)[ok], getattr(want, k)[ok]
        errs[k] = float((g - w).abs().max()) / max(float(w.abs().max()),
                                                   1e-30)
    same = bool(torch.equal(got.num_valid[ok], want.num_valid[ok])
                and torch.equal(got.first_oct_dis[ok], want.first_oct_dis[ok]))
    bitwise = all(torch.equal(getattr(got, k), getattr(want, k)) for k in (
        "ts", "dists", "world_pts", "warp_pts", "valid", "trans_idx",
        "oct_idx", "block_idx", "num_valid", "first_oct_dis"))
    trans, valid = want.trans_idx.cpu().numpy(), want.valid.cpu().numpy()
    runs = [row[v] for row, v in zip(trans, valid)]
    pairs = sum(max(len(x) - 1, 0) for x in runs)
    out = {"what": what, "rays": r, "S": s,
           "differing_rays": int(bad.sum()),
           "anchor_change_share": sum(int((x[1:] != x[:-1]).sum())
                                      for x in runs) / max(pairs, 1),
           "max_rel_err": max(errs.values()), "rel_errs": errs,
           "bit_for_bit": bitwise,
           "valid_samples": int(want.valid.sum()),
           "max_abs_err": max(float((getattr(got, k) - getattr(want, k))
                                    .abs().max()) for k in
                              ("ts", "dists", "world_pts", "warp_pts")),
           "plain_ms": plain_ms}
    log(f"[scan] M1 vs the plain scan on {what}, {r} rays at S={s}: {out}")
    if not (out["differing_rays"] <= M1_DIFFER_SHARE * r
            and out["max_rel_err"] <= M1_RTOL and same
            and (out["bit_for_bit"] if edge else out["valid_samples"] > r)):
        raise AssertionError(f"scan: M1 against the plain scan on {what}: "
                             f"{out}, num_valid and first hits equal: {same}")
    return out


def coverage_figures(fast, scan) -> dict:
    """The scan against the fast march, as tests/test_fast_march.py:53
    compares them: each a dict of numpy valid, ts, oct_idx (R, S) and
    first_oct_dis (R,).  Per ray with samples in both, the shares whose
    fast-march count is at least 0.6 of the scan's and whose first and last
    t agree within 0.2 and 0.5 (that test's bounds), the median gaps, the
    share of the scan's leaves that the fast march visits too; the share of
    the first hits of the rays both hit that agree (1e-3)."""
    import numpy as np

    fv, sv, fts, sts = fast["valid"], scan["valid"], fast["ts"], scan["ts"]
    fo, so = fast["oct_idx"], scan["oct_idx"]
    count, tmin, tmax, leaves, dmin, dmax = [], [], [], [], [], []
    for r in range(sv.shape[0]):
        if not sv[r].any() or not fv[r].any():
            continue
        count.append(fv[r].sum() >= 0.6 * sv[r].sum())
        dmin.append(abs(fts[r][fv[r]].min() - sts[r][sv[r]].min()))
        dmax.append(abs(fts[r][fv[r]].max() - sts[r][sv[r]].max()))
        tmin.append(dmin[-1] < 0.2)
        tmax.append(dmax[-1] < 0.5)
        scan_leaves = set(so[r][sv[r]].tolist())
        leaves.append(len(scan_leaves & set(fo[r][fv[r]].tolist()))
                      / len(scan_leaves))
    f_fod, s_fod = fast["first_oct_dis"], scan["first_oct_dis"]
    both = (f_fod < 1e8) & (s_fod < 1e8)
    hits = np.isclose(f_fod[both], s_fod[both], rtol=1e-3, atol=1e-3)
    return {"rays_with_samples": len(count),
            "count_share": float(np.mean(count)),
            "first_t_share": float(np.mean(tmin)),
            "last_t_share": float(np.mean(tmax)),
            "median_first_t_diff": float(np.median(dmin)),
            "median_last_t_diff": float(np.median(dmax)),
            "leaf_coverage": float(np.mean(leaves)),
            "first_hit_share": float(hits.mean()) if both.any() else 0.0,
            "samples_scan": int(sv.sum()), "samples_fast": int(fv.sum())}


def scan_coverage(oct_dev, scfg, o, d) -> dict:
    """The scan against the fast march on the same rays with eval noise
    and 1024 slots, so that neither march runs out of slots
    (``coverage_figures``).  Fails unless 95% of the rays pass the count
    and first-t bounds and 95% of the first hits agree, and the last-t
    share, the median last-t gap and the leaf coverage are the JAX
    package's on this octree (COVERAGE_JAX).  With COVERAGE_CASE set, the octree, the rays
    and the sampler config are written there (npz) for the JAX package's
    pair on the CPU."""
    import dataclasses

    import numpy as np
    import torch

    from gfnerf_tpu_torch.ops.scan_march import scan_march
    from gfnerf_tpu_torch.sampler.fast_march import get_samples_fast

    cfg = dataclasses.replace(scfg, max_samples=1024)
    noise = torch.ones((o.shape[0], 1024), device="cuda")
    fast = get_samples_fast(oct_dev, o, d, noise, 1.0,
                            dataclasses.replace(cfg, march="fast"))
    scan = scan_march(oct_dev, o, d, noise,
                      dataclasses.replace(cfg, march="scan"))

    def host(x):
        return {k: getattr(x, k).cpu().numpy() for k in
                ("valid", "ts", "oct_idx", "first_oct_dis")}

    out = coverage_figures(host(fast), host(scan))
    log(f"[scan] coverage, the scan against the fast march on "
        f"{o.shape[0]} train rays (1024 slots, eval noise): {out}")
    if COVERAGE_CASE is not None:
        tables = {f"oct_{f.name}": (v.cpu().numpy() if torch.is_tensor(v)
                                    else np.asarray(v))
                  for f in dataclasses.fields(oct_dev)
                  for v in [getattr(oct_dev, f.name)]}
        Path(COVERAGE_CASE).parent.mkdir(parents=True, exist_ok=True)
        np.savez_compressed(
            COVERAGE_CASE, rays_o=o.cpu().numpy(), rays_d=d.cpu().numpy(),
            sampler_config=json.dumps(dataclasses.asdict(cfg)),
            card=json.dumps(out), **tables)
        log(f"[scan] the coverage case written to {COVERAGE_CASE}")
    jax = COVERAGE_JAX
    if not (out["rays_with_samples"] > o.shape[0] // 2
            and out["count_share"] >= 0.95
            and out["first_t_share"] >= 0.95
            and out["first_hit_share"] >= 0.95
            and abs(out["last_t_share"] - jax["last_t_share"])
            <= COVERAGE_SHARE_TOL
            and abs(out["leaf_coverage"] - jax["leaf_coverage"])
            <= COVERAGE_SHARE_TOL
            and abs(out["median_last_t_diff"] - jax["median_last_t_diff"])
            <= COVERAGE_GAP_RTOL * jax["median_last_t_diff"]):
        raise AssertionError(f"scan coverage: {out}, the JAX package's "
                             f"pair on this octree {jax}")
    return out


def scan_march_bytes(r: int, s: int, oct_dev, noise_slots: int,
                     tables: bool = True) -> int:
    """The bytes M1 must move for r rays of s slots: each ray's origin and
    direction read once, each output written once (per slot the world and
    warped points, delta, t, three int32 indices, valid: 45 B; per ray the
    count and the first-hit distance), the noise of the ``noise_slots``
    slots that use it (those in a valid leaf: no other slot reads its
    noise), and the octree's rows (its nodes, not the padding to its
    capacity) and the warp tables read once (none of them for rays that
    miss the root: ``tables`` False)."""
    per_slot = 12 + 12 + 4 + 4 + 3 * 4 + 1
    per_ray = 24 + 8 + 4
    nbytes = r * s * per_slot + r * per_ray + 4 * noise_slots
    if not tables:
        return nbytes
    node_row = sum(t[0].numel() * t.element_size() for t in (
        oct_dev.centers, oct_dev.side_lens, oct_dev.childs, oct_dev.is_leaf,
        oct_dev.trans_idx, oct_dev.block_idx))
    warp = sum(t.numel() * t.element_size() for t in (
        oct_dev.w2xz_flat, oct_dev.warp_weight_flat, oct_dev.t_center,
        oct_dev.t_dis_summary))
    return nbytes + oct_dev.n_nodes * node_row + warp


def time_scan_march(oct_dev, scfg, o, d, what=None, eval_noise=False,
                    tables=True) -> dict:
    """M1 on rays o, d with the configuration's slots and train noise (or
    a render's, ``eval_noise``): CUDA-event medians of 10 calls per event
    pair, and its bound (the bytes it must move over the card's rate, the
    noise counted for the slots of this run's outputs that use it;
    ``tables`` as ``scan_march_bytes`` takes it).  Logged when ``what``
    names the input."""
    import dataclasses

    import torch

    from gfnerf_tpu_torch.ops.scan_march import scan_march

    r, s = o.shape[0], scfg.max_samples
    gen = torch.Generator(device="cuda").manual_seed(3)
    noise = (torch.ones((r, s), device="cuda") if eval_noise else
             torch.rand((r, s), generator=gen, device="cuda") + 0.5)
    cfg = dataclasses.replace(scfg, march="scan")
    ms = time_ms(lambda: scan_march(oct_dev, o, d, noise, cfg), n=7, reps=10)
    # the slots in a valid leaf: the emitted ones and each ray's first
    out = scan_march(oct_dev, o, d, noise, cfg)
    noise_slots = int(out.num_valid.sum()) + int(
        (out.first_oct_dis < 1e8).sum())
    nbytes = scan_march_bytes(r, s, oct_dev, noise_slots, tables)
    out = {"rays": r, "S": s, "ms": ms, "bytes": nbytes,
           "noise_slots": noise_slots,
           "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bound_by": "bytes"}
    if what:
        log(f"[scan] M1 on {what} (R={r}, S={s}): {ms:.4f} ms, bound "
            f"{out['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB)")
    return out


def miss_rays(oct_dev, r: int, seed: int):
    """r rays that miss the root cube: origins two sides from its centre
    in random directions, pointing further away."""
    import torch

    gen = torch.Generator(device="cuda").manual_seed(seed)
    u = torch.randn((r, 3), generator=gen, device="cuda")
    u = u / u.norm(dim=-1, keepdim=True)
    return oct_dev.centers[0] + 2.0 * oct_dev.side_lens[0] * u, u


def scan_by_part(oct_dev, scfg, cams, images) -> dict:
    """M1 on inputs that isolate its parts, each timed as
    ``time_scan_march`` times the train batch (S = the config's): the
    same work with each of SCAN_PART_RAYS[0] / SCAN_PART_REPEAT train rays
    repeated SCAN_PART_REPEAT times in a row (each copy its own noise: a
    warp's table reads fall on few rows), rays that miss the root (the
    write path alone), and the train batch's rays at every count of
    SCAN_PART_RAYS (how the time grows with the card's fill).  One line."""
    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.train_bench import make_batch

    batch = make_batch(images, SCAN_PART_RAYS[-1], 801, "cuda")
    rays = generate_rays_multi(cams, batch["camera_indices"],
                               batch["coords"])
    o, d = rays["origins"], rays["directions"]
    n, k = SCAN_PART_RAYS[0], SCAN_PART_REPEAT
    out = {"repeated": time_scan_march(
        oct_dev, scfg, o[:n // k].repeat_interleave(k, 0),
        d[:n // k].repeat_interleave(k, 0)),
        "miss": time_scan_march(oct_dev, scfg, *miss_rays(oct_dev, n, 5),
                                tables=False)}
    for r in SCAN_PART_RAYS:
        out[f"rays_{r}"] = time_scan_march(oct_dev, scfg, o[:r], d[:r])
    log(f"[scan] M1 by part (ms, bound ms): "
        + ", ".join(f"{name} {x['rays']}x{x['S']} {x['ms']:.4f} "
                    f"({x['bound_ms']:.4f})" for name, x in out.items()))
    return out


def scan_edge_cases(oct_dev, scfg, cams, images, o, d) -> list:
    """M1 against the plain scan, bit for bit, at the edge shapes: R = 1,
    3 and 8193 (no multiple of a block's rays) at S = 1, 1024 and 33; rays
    that miss the root; the train batch with SCAN_EDGE_NOISE times its
    noise, so that most steps leave their leaf and the anchor changes at
    nearly every emitted slot (at SCAN_EDGE_CHANGES of them at least)."""
    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.train_bench import make_batch

    batch = make_batch(images, 8193, 802, "cuda")
    rays = generate_rays_multi(cams, batch["camera_indices"],
                               batch["coords"])
    s, miss = scfg.max_samples, "rays that miss the root"
    cases = [(o[:1], d[:1], 1, 1.0, "one ray, one slot"),
             (o[:3], d[:3], 1024, 1.0, "three rays"),
             (rays["origins"], rays["directions"], 33, 1.0, "8193 rays"),
             (*miss_rays(oct_dev, o.shape[0], 6), s, 1.0, miss),
             (o, d, s, SCAN_EDGE_NOISE, "the train batch, large noise")]
    out = [check_scan_march(oct_dev, scfg, co, cd, cs, seed=10 + i,
                            what=what, noise_scale=scale, edge=True)
           for i, (co, cd, cs, scale, what) in enumerate(cases)]
    missed = next(x for x in out if x["what"] == miss)
    if missed["valid_samples"] != 0:
        raise AssertionError(f"scan: {miss} emitted samples: {missed}")
    if out[-1]["anchor_change_share"] < SCAN_EDGE_CHANGES:
        raise AssertionError(f"scan: the anchor changes at too few slots of "
                             f"{out[-1]['what']}: {out[-1]}")
    return out


def phase_scan(tmp: Path):
    """gf-nerf-perf with ``pipeline.sampler.march=scan`` through the
    Trainer on the pipeline phase's scene and schedule (SCAN_STEPS), the
    march through M1, counted: every step launches M1 once, K1 and K2
    once, H1 once at init and twice at the focal stage, H2 one call; the
    transition's error-map renders and the eval go through M1 too.
    Checked: finite losses, the rebuilds, the transition, both blocks'
    steps; the routed eval batch (H3) and the eval image's PSNR above the
    mean image's.  Then M1 against the plain scan on the train batch (S =
    160), the plain scan timed there; the scan against the fast march
    (coverage); one step with the kernels against the plain pairs (M1
    among them); M1 timed on the train batch and on a render chunk; M1
    against the plain scan on gf-nerf's march (S = 1024) and one gf-nerf
    step with the scan (budget 256: the compacted branch); one 1920x1080
    frame of render_bench's quality workload through the scan, and M1
    against the plain scan on one of its chunks (S = 384).  Returns (launches by path, stats, M1's report)."""
    import dataclasses

    import numpy as np
    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.optimizers import build_optimizer
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields.field import (STAGE_BLOCK, STAGE_INIT,
                                               FieldConfig, GFNeRFField,
                                               init_field_params)
    from gfnerf_tpu_torch.models.gfnerf import (init_train_state,
                                                make_render_fn,
                                                make_train_step)
    from gfnerf_tpu_torch.render_bench import (CHUNK, FRAME_WH,
                                               build_workload, frame_rays,
                                               render_rays)
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch
    from gfnerf_tpu_torch.utils.profiling import profile_device
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    scene = tmp / "scene"
    if not (scene / "train.npz").is_file():
        make_synthetic_npz(scene, n_train=48, n_val=4, img_wh=(96, 72))
    cfg = get_method("gf-nerf-perf")
    for key, value in {**SCAN_OVERRIDES,
                       "max_num_iterations": str(SCAN_STEPS),
                       "output_dir": str(tmp / "scan_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    trainer = Trainer(cfg, build_dataparser("minimal", scene))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    SETUP_REUSE.note()   # this setup's reuses alone
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    scfg = p.sampler.sampler_config
    reused = SETUP_REUSE.note()
    log(f"[scan] setup {setup_s:.2f}s ({reused})"
        f": {p.sampler.tree.n_nodes} nodes; "
        f"march {scfg.march}, S={scfg.max_samples}, sample_l "
        f"{scfg.sample_l:.6f}, locate_iters {scfg.locate_iters}")
    if scfg.march != "scan":
        raise AssertionError(f"scan: the sampler config says {scfg}")
    rec = {}
    get_loss = p.get_train_loss_dict

    def get_loss_w(step):
        before = launch_counts()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = launch_counts()
        rec[step] = {"s": dt, "counts": {k: after[k] - before[k]
                                         for k in after}, **m}
        return m

    p.get_train_loss_dict = get_loss_w
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    p.get_train_loss_dict = get_loss
    if sorted(rec) != list(range(SCAN_STEPS)):
        raise AssertionError(f"scan: steps run {sorted(rec)}")
    losses = [rec[i]["loss"] for i in range(SCAN_STEPS)]
    if not all(np.isfinite(losses)):
        raise AssertionError(f"scan: non-finite losses {losses}")
    h2 = table_grad_launches({"fcfg": p.field_cfg})
    for i in range(SCAN_STEPS):
        focal = i >= PIPELINE_INIT_STEPS
        want = {"scan_march": 1, "composite_fwd": 1, "composite_bwd": 1,
                "packed_hash_fwd": 2 if focal else 1,
                "packed_hash_bwd": h2}
        got = rec[i]["counts"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"scan step {i}: launches {rec[i]['counts']}"
                                 f", expected {want}")
    if p.sampler.cameras_labels is None:
        raise AssertionError("scan: no transition")
    log(f"[scan] losses {[round(x, 5) for x in losses]}")
    log(f"[scan] samples a ray by step: "
        f"{[round(rec[i]['num_samples_per_ray'], 1) for i in range(SCAN_STEPS)]}")

    # the routed eval batch and the eval image, at the focal stage
    last = SCAN_STEPS - 1
    before = launch_counts()
    t = time.perf_counter()
    eval_m = p.get_eval_loss_dict(last)
    torch.cuda.synchronize()
    eval_s = time.perf_counter() - t
    eval_launches = {k: v - before[k] for k, v in launch_counts().items()}
    metrics, _ = p.get_eval_image_metrics_and_images(last, 0)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    gt = p.datamanager.next_eval_image(0)[1]["image"]
    trivial = float(-10.0 * np.log10(np.mean((gt - gt.mean(axis=(0, 1)))
                                             ** 2)))
    log(f"[scan] routed eval batch in {eval_s:.3f}s: {json.dumps(eval_m)}; "
        f"its launches {eval_launches}; eval image 0: {json.dumps(metrics)}; "
        f"mean-image PSNR {trivial:.4f}; launches in the run {launches}")
    if not (eval_launches["packed_hash_routed"] >= 1
            and eval_launches["scan_march"] >= 1):
        raise AssertionError(f"scan: the eval batch launched "
                             f"{eval_launches}")
    if not metrics["psnr"] > trivial:
        raise AssertionError(f"scan: eval PSNR {metrics['psnr']} not above "
                             f"the mean image's {trivial}")
    # an init step (at fineness 1) and a focal step, each the faster of 2
    # on the host clock, then profiled
    profiles = {}
    for step in (PIPELINE_INIT_STEPS - 2, last):
        times = []
        for _ in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            get_loss(step)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prof = profile_device(lambda: get_loss(step))
        prof["step_ms"] = min(times) * 1e3
        profiles[step] = prof
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["step_ms"]
        spans = {k: round(v, 2) for k, v in
                 prof["stage_device_span_ms"].items()}
        top = [(k["name"][:50], round(k["device_ms"], 3), k["count"])
               for k in prof["top_kernels"][:6]]
        log(f"[scan] step {step} profiled: {prof['step_ms']:.1f} ms on the "
            f"host clock, device busy {prof['device_busy_ms']:.2f} ms, idle "
            f"share {prof['idle_share']:.3f}; spans {spans}; busiest {top}")

    # M1 against the plain scan, coverage, a step against the plain pairs
    images = np.asarray(p.datamanager.train_dataset.metadata[
        "images_array"], np.float32) / 255.0
    batch = make_batch(images, RAYS, 800, p.device)
    rays = generate_rays_multi(p.cameras_dev, batch["camera_indices"],
                               batch["coords"])
    o, d = rays["origins"], rays["directions"]
    oct_dev = p.sampler.oct_dev
    compare = [check_scan_march(oct_dev, scfg, o, d, scfg.max_samples,
                                seed=1, what="the train batch")]
    n = COVERAGE_RAYS
    coverage = scan_coverage(oct_dev, scfg, o[:n], d[:n])
    wl = {"field": p.field, "state": p.state, "tx": p.tx,
          "step_fn": p._train_step[STAGE_INIT],
          "focal_step_fn": p._train_step[STAGE_BLOCK],
          "oct_dev": oct_dev, "cams": p.cameras_dev, "fineness": 1.0,
          "scfg": scfg, "fcfg": p.field_cfg}
    gen = torch.Generator(device=p.device).manual_seed(8)
    noise, perms = step_draws(wl, gen)
    compare_step(wl, "scan", batch, noise, perms)
    train_m1 = time_scan_march(oct_dev, scfg, o, d, "the train batch")
    by_part = scan_by_part(oct_dev, scfg, p.cameras_dev, images)
    compare += scan_edge_cases(oct_dev, scfg, p.cameras_dev, images, o, d)

    # s/step through the Trainer (without the first 2 of each stage, the
    # rebuild and the profiled steps)
    skip = {8, 16, 12, 24, PIPELINE_INIT_STEPS - 1}
    init_s = [rec[i]["s"] for i in range(2, PIPELINE_INIT_STEPS)
              if i not in skip]
    focal_s = [rec[i]["s"] for i in (PIPELINE_INIT_STEPS + 1,
                                     PIPELINE_INIT_STEPS + 3)
               if i not in skip]
    log(f"[scan] Trainer: {_mean(init_s):.4f} s/init step "
        f"({RAYS / _mean(init_s):.1f} rays/s), {_mean(focal_s):.4f} s/focal"
        f" step; peak {peak / 2**30:.3f} GiB; the run {train_s:.1f}s")
    paths = {"scan_pipeline": launches}

    # the compacted branch: one gf-nerf step with the scan at gf-nerf's
    # width on this octree
    gcfg = get_method("gf-nerf").pipeline
    fcfg = FieldConfig(
        num_images=p.field_cfg.num_images, hidden_dim=gcfg.field_hidden_dim,
        hidden_dim_color=gcfg.field_hidden_dim_color,
        log2_hashmap_size=gcfg.field_log2_hashmap_size,
        num_levels=gcfg.field_num_levels,
        features_per_level=gcfg.field_features_per_level,
        n_blocks=gcfg.model.n_blocks, n_volumes=p.sampler.n_volumes,
        hash_layout=gcfg.field_hash_layout, mlp_dtype=gcfg.field_mlp_dtype)
    del trainer, wl
    torch.cuda.empty_cache()
    gfield = GFNeRFField(fcfg, *init_field_params(fcfg, seed=0),
                         device="cuda")
    tx = build_optimizer(gcfg.optimizers)
    gmcfg = dataclasses.replace(gcfg.model,
                                samples_budget_per_ray=SCAN_GFNERF_BUDGET)
    gscfg = dataclasses.replace(scfg, max_samples=SCAN_GFNERF_SLOTS)
    compare.append(check_scan_march(oct_dev, gscfg, o, d, SCAN_GFNERF_SLOTS,
                                    seed=2, what="gf-nerf's march"))
    gfnerf_m1 = time_scan_march(oct_dev, gscfg, o, d, "gf-nerf's march")
    step_fn = make_train_step(gmcfg, gscfg, tx, STAGE_INIT)
    state = init_train_state(gfield, tx)
    reset_launch_counts()
    times = []
    for i in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        state, _, gm, _ = step_fn(state, oct_dev, p.cameras_dev, batch, 1.0,
                                  generator=gen)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t)
    gl = launch_counts()
    log(f"[scan] gf-nerf with the scan ({SCAN_GFNERF_SLOTS} slots, budget "
        f"{SCAN_GFNERF_BUDGET}: the compacted branch), 3 init steps: loss "
        f"{float(gm['loss']):.5f}, samples a ray "
        f"{float(gm['num_samples_per_ray']):.1f}, s/step "
        f"{[round(x, 4) for x in times]}; launches {gl}")
    if not (np.isfinite(float(gm["loss"])) and gl["scan_march"] == 3
            and gl["hash_anchored_bwd"] > 0 and gl["composite_bwd"] == 3):
        raise AssertionError(f"scan: the gf-nerf step {gm}, {gl}")
    paths["scan_gfnerf"] = gl
    del gfield, state, step_fn, tx
    torch.cuda.empty_cache()

    # one 1080p frame of the quality workload through the scan
    qwl = build_workload(torch.device("cuda"), seed=0, config="quality")
    qscfg = dataclasses.replace(qwl["scfg"], march="scan")
    render_fn = make_render_fn(qwl["mcfg"], qscfg)
    fo, fd = frame_rays(qwl["cameras"][0][0], *FRAME_WH, torch.device("cuda"))
    reset_launch_counts()
    render_rays(render_fn, qwl["field"], qwl["oct_dev"], fo[:CHUNK],
                fd[:CHUNK], 0, CHUNK)
    torch.cuda.synchronize()
    t = time.perf_counter()
    frame = render_rays(render_fn, qwl["field"], qwl["oct_dev"], fo, fd, 0,
                        CHUNK)
    torch.cuda.synchronize()
    frame_s = time.perf_counter() - t
    fl = launch_counts()
    n_chunks = -(-fo.shape[0] // CHUNK)
    hit = check_rendered(frame, "scan frame", (fo.shape[0], 3))
    log(f"[scan] a {FRAME_WH[0]}x{FRAME_WH[1]} frame of the quality "
        f"workload through the scan (S={qscfg.max_samples}): {frame_s:.3f} s"
        f", {fo.shape[0] / frame_s:.1f} rays/s; rays that hit "
        f"{hit:.4f}; launches {fl}")
    if fl["scan_march"] != n_chunks + 1:
        raise AssertionError(f"scan frame: launches {fl}")
    mid = fo.shape[0] // 2 - CHUNK // 2
    render_m1 = time_scan_march(qwl["oct_dev"], qscfg, fo[mid:mid + CHUNK],
                                fd[mid:mid + CHUNK], "a render chunk",
                                eval_noise=True)
    compare.append(check_scan_march(
        qwl["oct_dev"], qscfg, fo[mid:mid + CHUNK], fd[mid:mid + CHUNK],
        qscfg.max_samples, seed=3, what="a render chunk", eval_noise=True))
    paths["scan_render"] = fl
    del qwl, frame
    torch.cuda.empty_cache()

    report = {"max_abs_err": max(c["max_abs_err"] for c in compare),
              "ms": train_m1["ms"], "plain_ms": compare[0]["plain_ms"],
              "bound_ms": train_m1["bound_ms"], "bound_by": "bytes",
              "library_ms": None, "train_batch": train_m1,
              "render_chunk": render_m1, "gfnerf_march": gfnerf_m1,
              "by_part": by_part, "vs_plain": compare}
    stats = {"setup_s": setup_s, "train_s": train_s,
             "init_s_per_step": _mean(init_s),
             "focal_s_per_step": _mean(focal_s), "peak_bytes": peak,
             "eval_psnr": float(metrics["psnr"]), "mean_image_psnr": trivial,
             "profiles": {s: {k: v for k, v in prof.items()
                              if k != "top_kernels"}
                          for s, prof in profiles.items()},
             "coverage": coverage, "frame_s": frame_s,
             "gfnerf_step_s": times}
    return paths, stats, report


# the four static-scene families on the vanilla pipeline, each at its
# registered width through the Trainer on the instant-ngp phase's Blender
# scene (read by the blender parser): steps run (cut from the configs'
# 30 k to 100 k), and the rays of the step held against the CPU
STOCK_KINDS = ("vanilla-nerf", "mipnerf", "tensorf", "neus")
STOCK_STEPS = {"vanilla-nerf": 200, "mipnerf": 200, "tensorf": 200,
               "neus": 200}
STOCK_WARMUP = 5
STOCK_PAIR_RAYS = 256
# the card's step against the CPU's: the f32 sums run in other orders, and
# the positional encodings (up to 2^9 x 2 pi a unit) turn a position one
# ulp apart, from resampled bins one ulp apart, into features 1e-3 apart.
# So each gradient is held by its norm, to 2e-2 of it, and its largest
# entry's error (relative to the tensor's largest entry) to the larger of
# STOCK_GRAD_MAX_FLOOR and STOCK_ULP_FACTOR times the function's own
# sensitivity: the same error between the CPU's step and the CPU's step on
# ray origins moved by one ulp
STOCK_GRAD_NORM_TOL = 2e-2
STOCK_GRAD_MAX_FLOOR = 5e-3
STOCK_ULP_FACTOR = 2.0


def stock_step_pair(p, batch, draws) -> dict:
    """The family's loss and backward on the first STOCK_PAIR_RAYS rays of
    a batch and their draws, from copies of the pipeline's model: on the
    card, on the CPU (the plain path: these families call no kernel), and
    on the CPU with the ray origins moved by one ulp.  The loss to
    TRAIN_LOSS_RTOL, every gradient's difference to STOCK_GRAD_NORM_TOL of
    its norm, and the largest entry's difference relative to the tensor's
    largest to the larger of STOCK_GRAD_MAX_FLOOR and STOCK_ULP_FACTOR
    times the one-ulp step's.  Returns the errors."""
    import copy

    import torch

    from gfnerf_tpu_torch.cameras.cameras import generate_rays_multi

    n = STOCK_PAIR_RAYS
    rays = generate_rays_multi(p.cameras_dev, batch["camera_indices"][:n],
                               batch["coords"][:n])
    outs = {}
    for run, dev in (("cuda", "cuda"), ("cpu", "cpu"), ("cpu_ulp", "cpu")):
        model = copy.deepcopy(p.model).to(dev)
        r = {k: v.to(dev) for k, v in rays.items()}
        if run == "cpu_ulp":
            r["origins"] = torch.nextafter(
                r["origins"], torch.full_like(r["origins"], float("inf")))
        total, _ = p.spec.loss(
            model, r, {k: v[:n].to(dev) for k, v in batch.items()},
            [x[:n].to(dev) for x in draws])
        total.backward()
        outs[run] = (float(total.detach()),
                     {name: q.grad.detach().cpu() for name, q
                      in model.named_parameters()})
    (lk, gk), (lp, gp) = outs["cuda"], outs["cpu"]
    gu = outs["cpu_ulp"][1]
    rel = abs(lk - lp) / abs(lp)
    norm_err = {k: float((gk[k] - gp[k]).norm() / gp[k].norm().clamp(
        min=1e-30)) for k in gp}

    def max_err(g):
        return {k: float((g[k] - gp[k]).abs().max()
                         / gp[k].abs().max().clamp(min=1e-30)) for k in gp}

    card_max, ulp_max = max_err(gk), max_err(gu)
    worst = max(norm_err, key=norm_err.get)
    max_tol = max(STOCK_GRAD_MAX_FLOOR,
                  STOCK_ULP_FACTOR * max(ulp_max.values()))
    out = {"loss_card": lk, "loss_cpu": lp, "loss_rel_err": rel,
           "grad_norm_err": norm_err[worst], "grad_norm_err_of": worst,
           "grad_max_err_rel_to_largest": max(card_max.values()),
           "grad_max_err_of": max(card_max, key=card_max.get),
           "one_ulp_grad_max_err": max(ulp_max.values()),
           "one_ulp_grad_max_err_of": max(ulp_max, key=ulp_max.get),
           "grad_max_err_tol": max_tol}
    log(f"[stock] {p.kind}: one step of {n} rays on the card against the "
        f"CPU: {out}")
    if not (rel <= TRAIN_LOSS_RTOL
            and norm_err[worst] <= STOCK_GRAD_NORM_TOL
            and out["grad_max_err_rel_to_largest"] <= max_tol):
        raise AssertionError(f"{p.kind}: the card's step against the CPU's "
                             f"{out}")
    return out


def phase_stock(tmp: Path):
    """vanilla-nerf, mipnerf, tensorf and neus, each through the Trainer at
    its registered width on the Blender scene the instant-ngp phase writes
    (written here if that phase did not run), counted: no kernel launches.
    Checked per family: finite losses, the rgb loss falling, every
    parameter changed, the eval PSNR above the mean image's, the checkpoint
    written.  Timed: s/step and rays/s through the Trainer, peak memory, a
    profiled step (busy time, idle share, spans); one step on the card
    against the CPU."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.pixel_samplers import (PixelSampler,
                                                      collate_batch)
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.utils.profiling import profile_device
    from gfnerf_tpu_torch.utils.synthetic import make_blender_fixture

    n_train, n_val, wh, focal = NGP_SCENE
    scene = tmp / "ngp_scene"
    if not (scene / "transforms_train.json").is_file():
        make_blender_fixture(scene, n_train, n_val, img_wh=wh, rgba=True,
                             focal=focal)
    paths, stats = {}, {}
    for kind in STOCK_KINDS:
        n_steps = STOCK_STEPS[kind]
        cfg = get_method(kind)
        for key, value in {"max_num_iterations": str(n_steps),
                           "steps_per_eval_image": str(n_steps),
                           "steps_per_save": str(n_steps),
                           "steps_per_log": "100",
                           "output_dir": str(tmp / f"{kind}_out")}.items():
            apply_override(cfg, key, value)
        cfg.data = scene
        trainer = Trainer(cfg, build_dataparser("blender", scene))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.setup()
        p = trainer.pipeline
        rays = p.config.train_num_rays_per_batch
        mc = p.model_cfg
        width = {k: v for k, v in vars(mc).items() if k != "num_images"}
        log(f"[stock] {kind}: {rays} rays a batch, draws "
            f"{p.spec.draw_counts(p.model_cfg)} samples a level; {width}; "
            f"{sum(q.numel() for q in p.model.parameters())} parameters")
        start = {k: q.detach().clone() for k, q in
                 p.model.named_parameters()}
        rec, evals = {}, []
        get_loss, eval_image = (p.get_train_loss_dict,
                                p.get_eval_image_metrics_and_images)

        def get_loss_w(step, get_loss=get_loss, rec=rec):
            t = time.perf_counter()
            m = get_loss(step)
            torch.cuda.synchronize()
            rec[step] = {"s": time.perf_counter() - t, **m}
            return m

        def eval_image_w(step, idx=0, eval_image=eval_image, evals=evals):
            metrics, images = eval_image(step, idx)
            evals.append((step, idx, metrics))
            return metrics, images

        p.get_train_loss_dict = get_loss_w
        p.get_eval_image_metrics_and_images = eval_image_w
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = launch_counts()
        peak = torch.cuda.max_memory_allocated()
        p.get_train_loss_dict = get_loss
        p.get_eval_image_metrics_and_images = eval_image
        check_launches(f"stock {kind}", launches, {})
        if sorted(rec) != list(range(n_steps)):
            raise AssertionError(f"{kind}: steps run {sorted(rec)}")
        rgb_key = "rgb_loss_fine" if kind in ("vanilla-nerf", "mipnerf") \
            else "rgb_loss"
        hist = [rec[i][rgb_key] for i in range(n_steps)]
        if not all(np.isfinite(rec[i]["loss"]) for i in range(n_steps)):
            raise AssertionError(f"{kind}: a non-finite loss")
        if not _mean(hist[-10:]) < _mean(hist[:10]):
            raise AssertionError(f"{kind}: the rgb loss did not fall")
        unchanged = [k for k, q in p.model.named_parameters()
                     if torch.equal(q.detach(), start[k])]
        if unchanged:
            raise AssertionError(f"{kind}: unchanged parameters {unchanged}")
        if not evals:
            raise AssertionError(f"{kind}: no eval image")
        step, idx, metrics = evals[-1]
        gt = p.eval_dataset.get_image(idx)
        trivial = float(-10.0 * np.log10(np.mean(
            (gt - gt.mean(axis=(0, 1))) ** 2)))
        every = max(n_steps // 6, 1)
        log(f"[stock] {kind}: {rgb_key} every {every} steps "
            f"{[round(x, 5) for x in hist[::every]]}; eval image {idx} at "
            f"step {step}: {json.dumps(metrics)}; mean-image PSNR "
            f"{trivial:.4f}")
        if not metrics["psnr"] > trivial:
            raise AssertionError(f"{kind}: eval PSNR {metrics['psnr']} not "
                                 f"above the mean image's {trivial}")
        ckpt = trainer.checkpoint_dir / f"step-{n_steps - 1:09d}"
        if not (ckpt / "state.pt").is_file():
            raise AssertionError(f"{kind}: no checkpoint at {ckpt}")
        step_s = [rec[i]["s"] for i in range(STOCK_WARMUP, n_steps)]
        sampler = PixelSampler(rays, seed=900)
        batch = p._device_batch(collate_batch(
            p.cache, sampler.sample_indices(p.cache)))
        gen = torch.Generator(device=p.device).manual_seed(900)
        draws = [torch.rand((rays, k + 1), generator=gen, device=p.device)
                 for k in p.spec.draw_counts(p.model_cfg)]
        pair = stock_step_pair(p, batch, draws)
        times = []
        for i in range(2):
            torch.cuda.synchronize()
            t = time.perf_counter()
            p.get_train_loss_dict(n_steps + i)
            torch.cuda.synchronize()
            times.append(time.perf_counter() - t)
        prof = profile_device(lambda: p.get_train_loss_dict(n_steps + 2))
        prof["step_ms"] = min(times) * 1e3
        prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["step_ms"]
        spans = {k: round(v, 2) for k, v in
                 prof["stage_device_span_ms"].items()}
        top = [(k["name"][:50], round(k["device_ms"], 3), k["count"])
               for k in prof["top_kernels"][:5]]
        log(f"[stock] {kind}: Trainer {_mean(step_s):.4f} s/step (median "
            f"{float(np.median(step_s)):.4f}, after {STOCK_WARMUP} warm-up "
            f"steps), {rays / _mean(step_s):.1f} rays/s; peak "
            f"{peak / 2**30:.3f} GiB; the run {train_s:.1f}s; one step "
            f"profiled: {prof['step_ms']:.1f} ms on the host clock (the "
            f"faster of 2), device busy {prof['device_busy_ms']:.2f} ms, "
            f"idle share {prof['idle_share']:.3f}; spans {spans}; busiest "
            f"kernels {top}")
        paths[f"stock_{kind}"] = launches
        stats[kind] = {"steps": n_steps, "s_per_step": _mean(step_s),
                       "rays_per_s": rays / _mean(step_s),
                       "peak_bytes": peak, "train_s": train_s,
                       "eval_psnr": float(metrics["psnr"]),
                       "mean_image_psnr": trivial,
                       "device_busy_ms": prof["device_busy_ms"],
                       "step_ms": prof["step_ms"],
                       "idle_share": prof["idle_share"],
                       "spans": prof["stage_device_span_ms"], **pair}
        del trainer, p, get_loss, eval_image, get_loss_w, eval_image_w
        torch.cuda.empty_cache()
    return paths, stats


# NeRFPlayer: both methods through the Trainer at their registered widths on
# a D-NeRF scene written to disk (NPL_SCENE, a sphere moving with the time)
# and read back by the dnerf parser
NPL_STEPS = {"nerfplayer-nerfacto": 300, "nerfplayer-ngp": 300}
NPL_WARMUP = 5
NPL_OVERRIDES = {"steps_per_log": "100", "steps_per_eval_batch": "100000"}
# train views, val views, width and height, focal length
NPL_SCENE = (24, 4, (200, 200), 180.0)
# (rays, proposal samples, field samples, levels, C, T, log2 entries,
# finest resolution, proposal levels, proposal T, proposal log2 entries,
# proposal finest resolutions, background)
NPL_NERFACTO_WIDTH = (4096, (256, 96), 48, 16, 2, 64, 19, 2048, 5, 32, 17,
                      (64, 256), "last_sample")
# (rays, samples, levels, C, T, log2 entries, finest resolution, grid,
# threshold, aabb_scale, background)
NPL_NGP_WIDTH = (4096, 192, 16, 2, 64, 19, 1024, 64, 0.01, 1.5, "white")
# levels a launch of T1 and T2, timed at nerfplayer-nerfacto's field
TEMPORAL_GROUPS = (1, 2, 4, 8, 16)


class record_temporal_encodes:
    """Within the block, the arguments of every temporal_grid_encode call
    that the nerfplayer models make, in order (points and times cloned)."""

    def __enter__(self):
        from gfnerf_tpu_torch.models import nerfplayer as npl

        self.mod, self.saved, self.calls = npl, npl.temporal_grid_encode, []

        def rec(table, st, xyz, times, *a, **kw):
            self.calls.append((table.detach(), st, xyz.detach().clone(),
                               times.detach().clone()))
            return self.saved(table, st, xyz, times, *a, **kw)

        npl.temporal_grid_encode = rec
        return self

    def __exit__(self, *exc):
        self.mod.temporal_grid_encode = self.saved
        return False


def temporal_bytes(table, st, xyz, times, gradient: bool) -> dict:
    """What T1 or T2 must move at these inputs: the points (12 B) and times
    (4 B) a point, the output (T1) or upstream gradient (T2) of L * C f32
    a point; T1 the table's distinct f32 channels the window reads (C + 1
    a corner), and the 32-byte sectors they fall in (reported, not
    counted); T2 the dense (rows, C + T) f32 gradient written once."""
    import torch

    from gfnerf_tpu_torch.fields.temporal_grid import temporal_scatter_terms

    p = xyz.shape[0]
    io = p * (12 + 4 + 4 * st.n_levels * st.level_dim)
    if gradient:
        return {"bytes": io + 4 * table.numel()}
    g = torch.ones((p, st.n_levels * st.level_dim), device=xyz.device)
    entries = torch.cat([i.reshape(-1) for i, _, _ in
                         temporal_scatter_terms(g, st, xyz, times)])
    distinct = torch.unique(entries)
    sectors = int(torch.unique(distinct // 8).numel())
    return {"bytes": io + 4 * int(distinct.numel()),
            "table_entries": int(distinct.numel()),
            "table_sectors": sectors}


def check_t2(what, st, g, xyz, times, **kw):
    """T2 (``ops.temporal_grid_bwd`` with ``kw``) on the grid ``st``
    against its plain version bit for bit, called again and on the points
    permuted (check_table_grad).  Returns T2's gradient."""
    from gfnerf_tpu_torch.fields import temporal_grid as tg
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    tables = st.tables(xyz.device)
    rows = tables.table_rows
    return check_table_grad(
        what,
        lambda gg, x, t: ops.temporal_grid_bwd(gg, tables, x, t, rows, **kw),
        lambda gg, x, t: tg.temporal_backward_reference(gg, st, x, t, rows),
        (g, xyz, times),
        permute=lambda args, perm: [a[perm].contiguous() for a in args])


def time_temporal_at(table, st, xyz, times, what, backward=True,
                     sweep=False) -> tuple:
    """T1 (and T2) at one shape: each equal to its plain version bit for
    bit (T2 also called again and on the points permuted: check_t2), and
    T2's records per level as reckoned (temporal_bwd_records); each timed
    with 10 calls per event pair against its plain version, T2 also
    against the library's sums of the plain terms (library_sums_ms:
    ``index_add_``, and the deterministic ``index_put_``); bounds from the
    bytes.  With ``sweep``, both also timed at TEMPORAL_GROUPS levels a
    launch (equal to the plain versions at each, T2 also called again and
    permuted).  Returns (T1's, T2's or None)."""
    import torch

    from gfnerf_tpu_torch.fields import temporal_grid as tg
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    tables = st.tables(xyz.device)
    p = xyz.shape[0]
    want = tg.temporal_grid_encode_raw(table, st, xyz, times)
    got = ops.temporal_grid_fwd(table, tables, xyz, times)
    torch.cuda.synchronize()
    fwd_err = max_err([got], [want])
    if not torch.equal(got, want):
        raise AssertionError(f"{what} temporal_grid_fwd: max abs err "
                             f"{fwd_err}, not equal bit for bit")
    del got, want
    moved = temporal_bytes(table, st, xyz, times, gradient=False)
    fwd = {"max_abs_err": fwd_err,
           "ms": time_ms(lambda: ops.temporal_grid_fwd(table, tables, xyz,
                                                       times), n=11, reps=10),
           "plain_ms": time_ms(lambda: tg.temporal_grid_encode_raw(
               table, st, xyz, times), n=3),
           "bound_ms": moved["bytes"] / HBM_BYTES_PER_S * 1e3,
           "bound_by": "bytes", "library_ms": None, "points": p,
           "rows": table.shape[0], "levels": st.n_levels,
           "table_entries_read": moved["table_entries"],
           "table_sectors_read": moved["table_sectors"]}
    if sweep:
        fwd["levels_per_launch_ms"] = {}
        for grp in TEMPORAL_GROUPS:
            if not torch.equal(ops.temporal_grid_fwd(
                    table, tables, xyz, times, levels_per_launch=grp),
                    tg.temporal_grid_encode_raw(table, st, xyz, times)):
                raise AssertionError(f"{what} temporal_grid_fwd at {grp} "
                                     f"levels a launch: not bit for bit")
            fwd["levels_per_launch_ms"][grp] = time_ms(
                lambda g=grp: ops.temporal_grid_fwd(
                    table, tables, xyz, times, levels_per_launch=g),
                n=11, reps=10)
    bwd = None
    if backward:
        gen = torch.Generator(device="cuda").manual_seed(9)
        g = torch.randn((p, st.n_levels * st.level_dim), generator=gen,
                        device="cuda")
        rows = table.shape[0]
        got = check_t2(f"{what} temporal_grid_bwd", st, g, xyz, times)
        bwd_err = max_err([got], [tg.temporal_backward_reference(
            g, st, xyz, times, rows)])
        records = torch.zeros(st.n_levels, dtype=torch.int64, device="cuda")
        ops.temporal_grid_bwd(g, tables, xyz, times, rows,
                              level_records=records)
        reckoned = tg.temporal_bwd_records(g, st, xyz, times)
        if not torch.equal(records, reckoned):
            raise AssertionError(f"{what} temporal_grid_bwd: records per "
                                 f"level {records.tolist()}, reckoned "
                                 f"{reckoned.tolist()}")
        groups_ms = {}
        for grp in TEMPORAL_GROUPS if sweep else ():
            other = check_t2(f"{what} temporal_grid_bwd at {grp} levels a "
                             f"launch", st, g, xyz, times,
                             levels_per_launch=grp)
            if not torch.equal(other, got):
                raise AssertionError(f"{what} temporal_grid_bwd at {grp} "
                                     f"levels a launch differs")
            del other
            groups_ms[grp] = time_ms(
                lambda gr=grp: ops.temporal_grid_bwd(
                    g, tables, xyz, times, rows, levels_per_launch=gr),
                n=11, reps=10)
        del got
        lib = library_sums_ms(
            [(i, v) for i, v, _ in tg.temporal_scatter_terms(
                g, st, xyz, times)], rows * st.width)
        moved = temporal_bytes(table, st, xyz, times, gradient=True)
        bwd = {"max_abs_err": bwd_err,
               "ms": time_ms(lambda: ops.temporal_grid_bwd(
                   g, tables, xyz, times, rows), n=11, reps=10),
               "plain_ms": time_ms(lambda: tg.temporal_backward_reference(
                   g, st, xyz, times, rows), n=3),
               "bound_ms": moved["bytes"] / HBM_BYTES_PER_S * 1e3,
               "bound_by": "bytes",
               "library_ms": lib["index_add_ms"],
               "deterministic_library_ms": lib["deterministic_index_put_ms"],
               "points": p, "rows": rows, "levels": st.n_levels,
               "terms": lib["terms"],
               "records_per_level": records.tolist(),
               "corners_per_level": p * 8,
               "parts": table_grad_breakdown(
                   lambda: ops.temporal_grid_bwd(g, tables, xyz, times,
                                                 rows), "temporal_grid_bwd",
                   want=(ops.bwd_launches(st.n_levels,
                                          ops.BWD_LEVELS_PER_LAUNCH, p),
                         ops.bwd_memsets(p)))}
        if sweep:
            bwd["levels_per_launch_ms"] = groups_ms
        del g
    torch.cuda.empty_cache()
    for name, x in (("temporal_grid_fwd", fwd), ("temporal_grid_bwd", bwd)):
        if x is None:
            continue
        log(f"[{what}] {name} at P={p}, L={st.n_levels}, "
            f"C={st.level_dim}, T={st.temporal_dim}, rows={table.shape[0]}: "
            f"max abs err {x['max_abs_err']:.3g}; kernel {x['ms']:.4f} ms, "
            f"plain {x['plain_ms']:.4f} ms, "
            + (f"index_add_ {x['library_ms']:.4f} ms, deterministic "
               f"index_put_ {x['deterministic_library_ms']:.4f} ms, "
               if x["library_ms"] is not None else "")
            + f"bound {x['bound_ms']:.4f} ms"
            + (f" ({x['table_entries_read']} table entries in "
               f"{x['table_sectors_read']} sectors)"
               if "table_entries_read" in x else "")
            + (f"; records per level {x['records_per_level']} of "
               f"{x['corners_per_level']} corners a level, as reckoned; "
               f"equal to the plain version bit for bit, also called again "
               f"and on the points permuted"
               if "records_per_level" in x else "")
            + (f"; levels a launch: ms {x['levels_per_launch_ms']}"
               if "levels_per_launch_ms" in x else "")
            + (f"; device ms a call by kernel {json.dumps(x['parts'])}"
               if "parts" in x else "")
            + f" ({CARD})")
    return fwd, bwd


def temporal_edge_cases(table, st, what) -> int:
    """T1 and T2 bit for bit (T2 also called again and on the points
    permuted: check_t2) at the edge inputs on one grid (dense and hashed
    levels): the cube's 8 corners (coordinates exactly 0.0 and 1.0),
    points on the coarsest level's cell edges, times 0, 1 and every window
    row's boundary, and a ragged 8193 points.  Returns the points
    checked."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.fields import temporal_grid as tg
    from gfnerf_tpu_torch.ops import temporal_grid as ops

    if not (st.hashed.any() and not st.hashed.all()):
        raise AssertionError(f"{what}: the grid lacks dense or hashed "
                             f"levels: {st.hashed.tolist()}")
    rng = np.random.default_rng(13)
    corners = np.array([[a, b, c] for a in (0, 1) for b in (0, 1)
                        for c in (0, 1)], np.float32)
    res = int(st.resolutions[0])
    edges = rng.integers(0, res + 1, (64, 3)) / np.float32(res)
    bounds = np.arange(st.n_rows + 1) / np.float32(st.time_scale)
    xyz = np.concatenate([np.repeat(corners, len(bounds), 0),
                          edges.astype(np.float32),
                          rng.random((8193, 3), np.float32)])
    t = np.concatenate([np.tile(bounds, len(corners)),
                        rng.choice(bounds, 64),
                        rng.random(8193, np.float32)]).astype(np.float32)
    t[-2:] = [0.0, 1.0]
    xyz, t = (torch.tensor(x, device="cuda") for x in (xyz, t))
    g = torch.randn((xyz.shape[0], st.n_levels * st.level_dim),
                    generator=torch.Generator(device="cuda").manual_seed(4),
                    device="cuda")
    for sl in (slice(0, -8193), slice(-8193, None)):
        x, tt = xyz[sl].contiguous(), t[sl].contiguous()
        tables = st.tables(x.device)
        if not torch.equal(ops.temporal_grid_fwd(table, tables, x, tt),
                           tg.temporal_grid_encode_raw(table, st, x, tt)):
            raise AssertionError(f"{what}: T1 at the edge inputs differs "
                                 f"from the plain encode")
        check_t2(f"{what}: T2 at the edge inputs", st, g[sl].contiguous(),
                 x, tt)
    torch.cuda.empty_cache()
    return int(xyz.shape[0])


def nerfplayer_step_pair(p, batch, draws, occupancy=None) -> dict:
    """The loss and backward from two copies of the pipeline's model on one
    batch and its draws, through T1/T2 and through the plain pairs (no
    kernel may launch in the plain one): the loss to TRAIN_LOSS_RTOL, each
    table's gradient to NERFACTO_TABLE_GRAD_TOL of its largest, the other
    parameters' to TRAIN_GRAD_TOL of their largest; with ``occupancy``
    (nerfplayer-ngp's draws) one occupancy update from each copy, equal bit
    for bit.  Returns the errors."""
    import copy

    import torch

    from gfnerf_tpu_torch.fields.temporal_grid import (
        plain_temporal_grid_encode)
    from gfnerf_tpu_torch.models import nerfplayer as npl

    what = p.kind
    runs, model0, encode = {}, p.model, npl.temporal_grid_encode
    for kind in ("kernels", "plain"):
        p.model = copy.deepcopy(model0)
        before = launch_counts()
        if kind == "plain":
            npl.temporal_grid_encode = plain_temporal_grid_encode
        try:
            total, _ = p.loss(batch, draws)
            total.backward()
            if occupancy is not None:
                npl.update_ngp_occupancy(p.model, *occupancy)
            torch.cuda.synchronize()
            runs[kind] = (total.item(), p.model)
        finally:
            npl.temporal_grid_encode = encode
            p.model = model0
        if kind == "plain" and launch_counts() != before:
            raise AssertionError(f"{what}: the plain step launched kernels")
    (lk, mk), (lp, mp) = runs["kernels"], runs["plain"]
    rel = abs(lk - lp) / abs(lp)
    out = {"loss": (lk, lp, rel)}
    if not rel <= TRAIN_LOSS_RTOL:
        raise AssertionError(f"{what} step loss: kernels {lk} vs plain {lp}")
    tables = {id(t) for t, _ in mk.grids()}
    for (name, a), b in zip(mk.named_parameters(), mp.parameters()):
        if id(a) not in tables:
            continue
        scale = float(b.grad.abs().max())
        err = float((a.grad - b.grad).abs().max())
        out[name] = (err, scale)
        if not (scale > 0 and err <= NERFACTO_TABLE_GRAD_TOL * scale):
            raise AssertionError(f"{what} {name} gradient: kernels vs plain "
                                 f"{err} of {scale}")
    rest = [(a, b) for a, b in zip(mk.parameters(), mp.parameters())
            if id(a) not in tables]
    scale = max(float(b.grad.abs().max()) for _, b in rest)
    err = max(float((a.grad - b.grad).abs().max()) for a, b in rest)
    out["mlps"] = (err, scale)
    if not err <= TRAIN_GRAD_TOL * scale:
        raise AssertionError(f"{what} MLP gradients: kernels vs plain {err} "
                             f"of {scale}")
    if occupancy is not None and not torch.equal(mk.occ, mp.occ):
        raise AssertionError(f"{what}: the occupancy update through T1 "
                             f"differs from the plain one")
    log(f"[nerfplayer] {what}, one step, kernels vs plain: loss {lk:.7f} vs "
        f"{lp:.7f} (rel {rel:.3g}, tol {TRAIN_LOSS_RTOL}); gradients (max "
        f"abs err, largest): {({k: v for k, v in out.items() if k != 'loss'})}"
        + ("; the occupancy update equal bit for bit" if occupancy else ""))
    del runs, mk, mp
    torch.cuda.empty_cache()
    return out


def nerfplayer_repeat_step(p, batch, draws) -> None:
    """One train step of the pipeline's model (the loss, the backward
    through T1/T2, Adam) twice from the same parameters, optimizer state,
    batch and draws: the loss, every gradient and every parameter after
    the update equal bit for bit, as the JAX package's step is a function
    of its inputs.  The parameters are left as they were.  On a
    difference the step runs once more under
    ``torch.use_deterministic_algorithms(True, warn_only=True)``, and the
    failure names the operations PyTorch warns have no deterministic
    form."""
    import copy
    import warnings

    import torch

    from gfnerf_tpu_torch.engine.optimizers import apply_updates

    names = [n for n, _ in p.model.named_parameters()]
    params = list(p.model.parameters())
    start = [t.detach().clone() for t in params]

    def step():
        with torch.no_grad():
            for t, s0 in zip(params, start):
                t.copy_(s0)
        p.model.zero_grad(set_to_none=True)
        total, _ = p.loss(batch, draws)
        total.backward()
        grads = [t.grad.clone() for t in params]
        updates, _ = p.tx.update({"all": [t.grad for t in params]},
                                 copy.deepcopy(p.state.opt_state),
                                 {"all": params})
        apply_updates({"all": params}, updates)
        torch.cuda.synchronize()
        return [total.detach().clone()], grads, [t.detach().clone()
                                                 for t in params]

    first, second = step(), step()
    apart = [f"{kind} {name}" for kind, a, b in zip(
        ("loss", "gradient", "parameter"), first, second)
        for name, x, y in zip(names if kind != "loss" else ["total"], a, b)
        if not torch.equal(x, y)]
    ops = []
    if apart:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.use_deterministic_algorithms(True, warn_only=True)
            try:
                step()
            finally:
                torch.use_deterministic_algorithms(False)
        ops = sorted({str(w.message).split("\n")[0][:160] for w in caught})
    with torch.no_grad():
        for t, s0 in zip(params, start):
            t.copy_(s0)
    p.model.zero_grad(set_to_none=True)
    if apart:
        raise AssertionError(f"{p.kind}: one step twice from one state: "
                             f"{len(apart)} tensors apart ({apart[:8]}); "
                             f"operations without a deterministic form: "
                             f"{ops}")
    log(f"[nerfplayer] {p.kind}: one step twice from one state, batch and "
        f"draws: the loss, all {len(names)} gradients and parameters after "
        f"Adam equal bit for bit")


def nerfplayer_run(tmp: Path, scene: Path, method: str) -> tuple:
    """One nerfplayer method through the Trainer at its registered width,
    NPL_STEPS[method] steps, counted; returns (launches, stats, the
    trained pipeline's trainer, T1/T2 reports at the step's shapes, the
    run's config.json)."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.data.pixel_samplers import (PixelSampler,
                                                      collate_batch)
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.models import nerfplayer as npl
    from gfnerf_tpu_torch.models.instant_ngp import OCC_UPDATE_EVERY
    from gfnerf_tpu_torch.ops.temporal_grid import (BWD_LEVELS_PER_LAUNCH,
                                                    FWD_LEVELS_PER_LAUNCH,
                                                    bwd_launches, n_launches)
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.utils.profiling import profile_device

    n_steps = NPL_STEPS[method]
    ngp = method == "nerfplayer-ngp"
    cfg = get_method(method)
    for key, value in {**NPL_OVERRIDES,
                       "max_num_iterations": str(n_steps),
                       "steps_per_eval_image": str(n_steps),
                       "steps_per_save": str(n_steps),
                       "output_dir": str(tmp / f"{method}_out")}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    trainer = Trainer(cfg, build_dataparser("dnerf", scene))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer.setup()
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    mc = p.model_cfg
    rays = p.config.train_num_rays_per_batch
    if ngp:
        width = (rays, mc.num_samples, mc.num_levels, mc.level_dim,
                 mc.temporal_dim, mc.log2_hashmap_size,
                 mc.desired_resolution, mc.grid_resolution,
                 mc.occ_threshold, mc.aabb_scale, mc.background_color)
        want_width = NPL_NGP_WIDTH
    else:
        width = (rays, tuple(mc.num_proposal_samples), mc.num_nerf_samples,
                 mc.num_levels, mc.level_dim, mc.temporal_dim,
                 mc.log2_hashmap_size, mc.desired_resolution,
                 mc.prop_num_levels, mc.prop_temporal_dim,
                 mc.prop_log2_hashmap_size, tuple(mc.prop_max_res),
                 mc.background_color)
        want_width = NPL_NERFACTO_WIDTH
    rows = [int(t.shape[0]) for t, _ in p.model.grids()]
    log(f"[nerfplayer] {method}: setup {setup_s:.2f}s; width {width}; grid "
        f"rows {rows} (field first, {sum(rows) * 66 * 4 / 2**30:.3f} GiB "
        f"of tables at 66 channels); {len(p.train_dataset)} train views at "
        f"times {np.round(p.model.camera_times.cpu().numpy(), 4).tolist()}")
    if width != want_width:
        raise AssertionError(f"{method} is not at its registered width: "
                             f"{width}")
    start = {n: t.detach().clone() for n, t in p.model.named_parameters()}
    rec = {"steps": {}}
    get_loss = p.get_train_loss_dict

    def get_loss_w(step):
        before = launch_counts()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        after = launch_counts()
        rec["steps"][step] = {"s": dt, "counts": {
            k: after[k] - before[k] for k in after}, **m}
        return m

    p.get_train_loss_dict = get_loss_w
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.max_memory_reserved()
    p.get_train_loss_dict = get_loss

    steps = rec["steps"]
    if sorted(steps) != list(range(n_steps)):
        raise AssertionError(f"{method}: steps run {sorted(steps)}")
    # the step's encodes: a launch per group of levels each
    levels = [mc.num_levels] if ngp else (
        [mc.prop_num_levels] * len(mc.num_proposal_samples)
        + [mc.num_levels])
    calls = {"temporal_grid_fwd": sum(n_launches(n, FWD_LEVELS_PER_LAUNCH)
                                      for n in levels),
             "temporal_grid_bwd": sum(bwd_launches(n, BWD_LEVELS_PER_LAUNCH,
                                                   rays) for n in levels)}
    occ_calls = n_launches(mc.num_levels, FWD_LEVELS_PER_LAUNCH)
    for i in range(n_steps):
        extra = occ_calls if ngp and i % OCC_UPDATE_EVERY == 0 else 0
        want = {"temporal_grid_fwd": calls["temporal_grid_fwd"] + extra,
                "temporal_grid_bwd": calls["temporal_grid_bwd"]}
        got = steps[i]["counts"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"{method} step {i}: launches {got}, "
                                 f"expected {want}")
    log(f"[nerfplayer] {method}: launches per step as expected: T1 "
        f"{calls['temporal_grid_fwd']} "
        + (f"(and {occ_calls} more at every 16th step, the occupancy "
           f"update) " if ngp else "")
        + f"and T2 {calls['temporal_grid_bwd']} ({len(levels)} encodes of "
        f"{levels} levels; T1 {FWD_LEVELS_PER_LAUNCH or 'all'} levels a "
        f"launch, T2 the level maxima, a count and a scatter a group of "
        f"{BWD_LEVELS_PER_LAUNCH or 'all'} levels, the scan, the owner "
        f"pass), no other kernel; in the whole run {launches}")
    keys = [k for k in steps[0] if k not in ("s", "counts")]
    hist = {k: [steps[i][k] for i in range(n_steps)] for k in keys}
    every = max(n_steps // 12, 1)
    log(f"[nerfplayer] {method}: metrics every {every} steps: "
        f"{ {k: [round(v, 5) for v in hist[k][::every]] for k in keys} }")
    if not all(np.isfinite(v).all() for v in hist.values()):
        raise AssertionError(f"{method}: a non-finite loss")
    rgb = hist["rgb_loss"]
    if not _mean(rgb[-10:]) < _mean(rgb[:10]):
        raise AssertionError(f"{method}: the rgb loss did not fall: "
                             f"{rgb[::every]}")
    unchanged = [n for n, t in p.model.named_parameters()
                 if torch.equal(t.detach(), start[n])]
    if unchanged:
        raise AssertionError(f"{method}: unchanged parameters {unchanged}")
    del start
    stats = {"setup_s": setup_s, "train_s": train_s, "peak_bytes": peak,
             "peak_reserved_bytes": reserved, "grid_rows": rows}
    if ngp:
        occ = p.model.occ
        stats["grid"] = {"min": float(occ.min()), "max": float(occ.max()),
                         "ones": int((occ == 1.0).sum()),
                         "below_threshold": float(
                             (occ <= mc.occ_threshold).float().mean())}
        log(f"[nerfplayer] {method}: the grid after {n_steps} steps "
            f"{stats['grid']}")
        if stats["grid"]["ones"]:
            raise AssertionError(f"{method}: the grid {stats['grid']}")
    log(f"[nerfplayer] {method}: every one of the "
        f"{len(list(p.model.parameters()))} parameter tensors changed")
    ckpt = trainer.checkpoint_dir / f"step-{n_steps - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"{method}: no checkpoint at {ckpt}")
    step_s = [steps[i]["s"] for i in range(NPL_WARMUP, n_steps)]
    stats.update({"s_per_step": _mean(step_s),
                  "median_s_per_step": float(np.median(step_s)),
                  "rays_per_s": rays / _mean(step_s)})
    if ngp:
        occ_s = [steps[i]["s"] for i in range(NPL_WARMUP, n_steps)
                 if i % OCC_UPDATE_EVERY == 0]
        stats["occupancy_step_s"] = _mean(occ_s)
    log(f"[nerfplayer] {method}: Trainer: {stats['s_per_step']:.4f} s/step "
        f"(median {stats['median_s_per_step']:.4f}, after {NPL_WARMUP} "
        f"warm-up steps"
        + (f"; the steps with an occupancy update "
           f"{stats['occupancy_step_s']:.4f}" if ngp else "")
        + f"), {stats['rays_per_s']:.1f} rays/s; peak {peak / 2**30:.3f} "
        f"GiB allocated, {reserved / 2**30:.3f} GiB reserved; the run "
        f"{train_s:.1f}s ({CARD})")

    # every val frame's PSNR, with its time, against its mean image's; eval
    # rays take train camera 0's time: the frames at that time must beat
    # their mean image
    t0_time = float(p.model.camera_times[0])
    frames = []
    for idx in range(len(p.eval_dataset)):
        metrics, _ = p.get_eval_image_metrics_and_images(n_steps, idx)
        gt = p.eval_dataset.get_image(idx)
        trivial = float(-10.0 * np.log10(np.mean(
            (gt - gt.mean(axis=(0, 1))) ** 2)))
        frames.append({"idx": idx, "time": float(
            p.eval_outputs.metadata["times"][idx]), "psnr": metrics["psnr"],
            "mean_image_psnr": trivial})
    log(f"[nerfplayer] {method}: eval PSNR of every val frame (time, PSNR, "
        f"mean-image PSNR), all rendered at train camera 0's time "
        f"{t0_time}: "
        f"{[(f['time'], round(f['psnr'], 4), round(f['mean_image_psnr'], 4)) for f in frames]}")
    gated = [f for f in frames if f["time"] == t0_time]
    if not gated or not all(f["psnr"] > f["mean_image_psnr"] for f in gated):
        raise AssertionError(f"{method}: the frames at camera 0's time do "
                             f"not beat their mean image: {frames}")
    stats["eval_frames"] = frames

    # the checkpoint: a pipeline rebuilt from it renders the same frame 0
    config_path = trainer.base_dir / "config.json"
    _, loaded = eval_setup(config_path)
    lp = loaded.pipeline
    a = lp.get_eval_image_metrics_and_images(n_steps, 0)[1]["img"]
    b = p.get_eval_image_metrics_and_images(n_steps, 0)[1]["img"]
    same = np.array_equal(a, b) and torch.equal(lp.model.camera_times,
                                                p.model.camera_times)
    if ngp:
        same = same and torch.equal(lp.model.occ, p.model.occ)
    if not same:
        raise AssertionError(f"{method}: the checkpoint did not restore the "
                             f"model" + (" and the grid" if ngp else ""))
    log(f"[nerfplayer] {method}: the checkpoint reloaded (the dnerf parser "
        f"guessed from the frames' times): the eval image equal bit for bit"
        + (", the grid equal" if ngp else ""))
    del loaded, lp
    torch.cuda.empty_cache()

    # from the trained model: a step against the plain pairs, T1 and T2 at
    # the step's shapes, a profiled step
    sampler = PixelSampler(rays, seed=700)
    batch = p._device_batch(collate_batch(p.cache,
                                          sampler.sample_indices(p.cache)))
    gen = torch.Generator(device=p.device).manual_seed(700)
    draws = [torch.rand((rays, n + 1), generator=gen, device=p.device)
             for n in p.spec.draw_counts(mc)]
    draws += p.spec.extra_draws(p.model, rays, gen, p.device)
    occupancy = npl.occupancy_draws(mc, gen, p.device) if ngp else None
    stats["step_pair"] = nerfplayer_step_pair(p, batch, draws, occupancy)
    nerfplayer_repeat_step(p, batch, draws)
    saved_occ = p.model.occ.clone() if ngp else None
    with torch.no_grad(), record_temporal_encodes() as enc:
        p.loss(batch, draws)
        if ngp:
            npl.update_ngp_occupancy(p.model, *occupancy)
    if ngp:
        p.model.occ.copy_(saved_occ)
    shapes = [(tuple(c[0].shape), c[2].shape[0]) for c in enc.calls]
    log(f"[nerfplayer] {method}: T1's calls in a step (table, points): "
        f"{shapes}")
    if ngp:
        names = ["train step", "occupancy update"]
        want_p = [rays * mc.num_samples, mc.grid_resolution ** 3]
    else:
        names = [f"proposal {i}" for i in range(len(mc.num_proposal_samples))
                 ] + ["field"]
        want_p = [rays * n for n in mc.num_proposal_samples] + [
            rays * mc.num_nerf_samples]
    if [s[1] for s in shapes] != want_p:
        raise AssertionError(f"{method}: encodes at {shapes}, expected "
                             f"points {want_p}")
    kernels = {}
    for name, (table, st, xyz, times) in zip(names, enc.calls):
        kernels[name] = time_temporal_at(
            table, st, xyz, times, f"nerfplayer {method} {name}",
            backward=name != "occupancy update", sweep=name == "field")
    field_table, field_st = enc.calls[-1 if not ngp else 0][:2]
    n_edge = temporal_edge_cases(field_table, field_st, method)
    log(f"[nerfplayer] {method}: T1 and T2 bit for bit (T2 also called "
        f"again and on the points permuted) at {n_edge} edge points on the "
        f"field's grid (levels "
        f"hashed {field_st.hashed.astype(int).tolist()}): the cube's "
        f"corners at every window-row boundary time, cell edges, t = 0 and "
        f"1, a ragged 8193")
    del enc
    torch.cuda.empty_cache()
    times_s = []
    for i in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        p.get_train_loss_dict(n_steps + 1 + i)
        torch.cuda.synchronize()
        times_s.append(time.perf_counter() - t)
    prof = profile_device(lambda: p.get_train_loss_dict(n_steps + 3))
    prof["step_ms"] = min(times_s) * 1e3
    prof["idle_share"] = 1.0 - prof["device_busy_ms"] / prof["step_ms"]
    spans = {k: round(v, 2) for k, v in prof["stage_device_span_ms"].items()}
    top = [(k["name"][:60], round(k["device_ms"], 3), k["count"])
           for k in prof["top_kernels"][:8]]
    log(f"[nerfplayer] {method}: one step, profiled: {prof['step_ms']:.1f} "
        f"ms on the host clock (the faster of 2), device busy "
        f"{prof['device_busy_ms']:.2f} ms, idle share "
        f"{prof['idle_share']:.3f}; stage device spans (ms) {spans}; "
        f"busiest kernels {top}; host waits {prof['host_waits']}")
    stats["profile"] = {n: prof[n] for n in ("step_ms", "device_busy_ms",
                                             "idle_share",
                                             "stage_device_span_ms")}
    stats["losses_every_25_steps"] = {k: v[::25] for k, v in hist.items()}
    del trainer, p, get_loss, batch, draws
    torch.cuda.empty_cache()
    return launches, stats, kernels, config_path


def phase_nerfplayer(tmp: Path):
    """The NeRFPlayer pair through the Trainer at their registered widths
    on a D-NeRF scene written to disk (NPL_SCENE: RGBA PNGs, a sphere
    moving with the frame's time) and read back by the dnerf parser:
    nerfplayer-nerfacto (NPL_NERFACTO_WIDTH) with T1 and T2 three calls a
    step each, nerfplayer-ngp (NPL_NGP_WIDTH) with T1 and T2 once a step
    and T1 once more at every 16th (the occupancy update), T1 a launch per
    group of 8 levels, T2 the level maxima, a count and a scatter per
    group of levels (all at once), the scan and the owner pass (the
    kernels' own grouping, which the launch count follows); no other
    kernel.  Per method (nerfplayer_run): finite losses, the rgb loss
    falling, every tensor changed, the checkpoint (reloaded to the same
    eval image; ngp's grid off all ones and reloaded equal), every val
    frame's PSNR with its time beside its mean image's (the frames at
    train camera 0's time must beat it: eval rays take that time), one
    step against the plain pairs (ngp: and an occupancy update), one step
    twice from one state (nerfplayer_repeat_step), T1 and T2 at the step's
    shapes against their plain versions and timed, the edge inputs on the
    field's grid, s/step, rays/s, peak memory and a profiled step; then
    python -m gfnerf_tpu_torch.eval and .render on each checkpoint."""
    import numpy as np

    from gfnerf_tpu_torch import eval as eval_entry
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.utils.image_io import read_png
    from gfnerf_tpu_torch.utils.synthetic import make_dnerf_fixture

    n_train, n_val, wh, focal = NPL_SCENE
    t0 = time.perf_counter()
    scene = make_dnerf_fixture(tmp / "dnerf_scene", n_train, n_val,
                               img_wh=wh, focal=focal)
    log(f"[nerfplayer] D-NeRF scene of {n_train} + {n_val} RGBA PNGs at "
        f"{wh[0]}x{wh[1]} written in {time.perf_counter() - t0:.2f}s")
    paths, stats, kernels = {}, {}, {}
    for method in NPL_STEPS:
        launches, st, ker, config_path = nerfplayer_run(tmp, scene, method)
        key = method.replace("-", "_")
        paths[key] = launches
        t = time.perf_counter()
        eval_entry.main(["--load-config", str(config_path), "--output-path",
                         str(tmp / f"{key}_eval.json")])
        eval_s = time.perf_counter() - t
        res = json.loads((tmp / f"{key}_eval.json").read_text())["results"]
        if not all(np.isfinite(v) for v in res.values()):
            raise AssertionError(f"gfnerf_tpu_torch.eval on {method}: {res}")
        frames_dir = tmp / f"{key}_frames"
        t = time.perf_counter()
        render_entry.main(["--load-config", str(config_path), "--traj",
                           "spiral", "--spiral-steps", "2", "--output-path",
                           str(frames_dir)])
        render_s = time.perf_counter() - t
        frames = sorted(frames_dir.glob("*.png"))
        if len(frames) != 2 or any(read_png(f).shape != (wh[1], wh[0], 3)
                                   for f in frames):
            raise AssertionError(f"gfnerf_tpu_torch.render wrote {frames}")
        log(f"[nerfplayer] {method}: python -m gfnerf_tpu_torch.eval on the "
            f"checkpoint in {eval_s:.2f}s: {json.dumps(res)}; .render --traj "
            f"spiral --spiral-steps 2 in {render_s:.2f}s: "
            f"{[f.name for f in frames]}")
        st.update({"eval_entry": res, "eval_entry_s": eval_s,
                   "render_entry_s": render_s})
        stats[key] = st
        kernels.update({f"{key} {name}": rep for name, rep in ker.items()})
    return paths, stats, kernels


# Captures read from disk: the six remaining formats, each written from the
# ring scene (CAPTURE_PARSE: views, width and height, focal length) by
# synthetic.CAPTURE_FIXTURES and parsed through build_dataparser; then
# gf-nerf-perf at its registered width (8192 rays, 160 slots) through the
# train entry point on a Phototourism capture (CAPTURE_SCENE: 54 PNGs at
# 192x144 with the fixtures' sky gradient, read at half size: the bench
# scene's 96x72 and focal length 55; the parser's scale factor 4 keeps the
# ring's radius of 4), clipped at CAPTURE_MAX_NORM and with MSE, for
# CAPTURE_STEPS init steps with the pipeline phase's milestones and
# fineness schedule (one compaction, at step 50), on the sampler's octree
# CAPTURE_TREE, with the march's near plane at 1 (the capture's nearest
# surface is 2.37 from the cameras; at the config's 0.01 each training
# view is fitted by a screen of density 0.3-0.8 in front of its camera,
# which its neighbours' val views look through).  The phase's variants
# (phase_capture_variants, ``--only capture-variants``) train the same
# capture with the sky or over black, on either tree, through the
# Phototourism or the minimal parser, with the cameras scaled with the
# images or left at full size (the JAX package's datamanager), at either
# near plane
CAPTURE_PARSE = (24, (64, 48), 55.0)
CAPTURE_SCENE = (54, (192, 144), 110.0)
CAPTURE_STEPS = 100
CAPTURE_WARMUP = 2
CAPTURE_LOG_EVERY = 10
CAPTURE_MAX_NORM = 0.02
CAPTURE_OVERRIDES = {
    **ONE_STEP_A_DISPATCH,
    "pipeline.datamanager.camera_res_scale_factor": "0.5",
    "pipeline.optimizers.max_norm": str(CAPTURE_MAX_NORM),
    "pipeline.model.use_ch_loss": "false",
    "pipeline.sampler.sub_div_milestones": "8,16",
    "pipeline.sampler.compact_freq": "50",
    "pipeline.sampler.ray_march_fineness_decay_end_iter": "16",
    "pipeline.sampler.global_near": "1.0",
    "steps_per_eval_batch": "25",
    "steps_per_eval_image": str(CAPTURE_STEPS),
    "steps_per_save": str(CAPTURE_STEPS),
    "steps_per_log": "100",
}
# the sampler's octree: the config's (bbox_levels 10, a root box 512 wide)
# or the bench's (octree_bench.BENCH_TREE: bbox_levels 4, a root box 8
# wide, around the ring of radius 4)
CAPTURE_TREES = {"config": {},
                 "bench": {"pipeline.sampler.max_level": "8",
                           "pipeline.sampler.bbox_levels": "4",
                           "pipeline.sampler.n_rand_pts": "4096",
                           "pipeline.sampler.vis_res_w": "64"}}
CAPTURE_TREE = "config"
# (sky, tree, parser, cameras scaled with the images, more overrides) of
# each variant; the captures phase's own is the sky, the config's tree,
# Phototourism, scaled, no more overrides
_NEAR0 = {"pipeline.sampler.global_near": "0.01"}
_LAST0 = {**_NEAR0, "pipeline.model.background_color": "last_sample"}
CAPTURE_VARIANTS = [(True, "bench", "phototourism", True, _NEAR0),
                    (True, "config", "phototourism", True, _NEAR0),
                    (True, "bench", "minimal", True, _NEAR0),
                    (True, "config", "minimal", True, _NEAR0),
                    (True, "bench", "phototourism", True, _LAST0),
                    (True, "config", "phototourism", True, _LAST0),
                    (False, "bench", "phototourism", True, _NEAR0),
                    (False, "bench", "phototourism", False, _NEAR0),
                    (True, "config", "phototourism", False, _NEAR0),
                    (True, "bench", "phototourism", True, {}),
                    (True, "config", "phototourism", False, {})]
# the kernels of a gf-nerf-perf init step, by the names their records carry
# in a profiler trace
CAPTURE_KERNEL_RECORDS = {"composite_fwd": "composite_fwd",
                          "composite_bwd": "composite_bwd",
                          "packed_hash_fwd": "packed_hash_encode",
                          "packed_hash_bwd": "packed_hash_bwd"}


def parse_captures(tmp: Path) -> dict:
    """Each of the six formats written (CAPTURE_PARSE) and parsed, train
    and val, through build_dataparser (nuscenes: its scene's name, the
    dataset root as ``data_dir``): the JAX tests' facts checked (the split
    sizes, finite poses, the auto-scaled formats' largest translation at
    their scale, the metadata and masks present, the files there).
    Returns {format: (train cameras, val cameras, parse s)}."""
    import math

    import numpy as np

    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.utils.synthetic import (CAPTURE_FIXTURES,
                                                  NUSCENES_SCENE)

    n, wh, focal = CAPTURE_PARSE
    scale = {"scannet": 1.0, "phototourism": 3.0, "arkitscenes": 1.0,
             "nuscenes": 1.0}
    meta = {"scannet": {"depth_filenames", "depth_unit_scale_factor"},
            "arkitscenes": {"depth_filenames", "depth_unit_scale_factor"},
            "sdfstudio": {"depth_filenames", "normal_filenames"}}
    out = {}
    for fmt, write in CAPTURE_FIXTURES.items():
        t0 = time.perf_counter()
        data = write(tmp / f"capture_{fmt}", n, wh, focal)
        write_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        if fmt == "nuscenes":
            parser = build_dataparser(fmt, Path(NUSCENES_SCENE))
            parser.config.data_dir = parser.config.mask_dir = data
        else:
            parser = build_dataparser(fmt, data)
        train = parser.get_dataparser_outputs("train")
        val = parser.get_dataparser_outputs("val")
        parse_s = time.perf_counter() - t0
        want = (n, n) if fmt in ("sdfstudio", "sitcoms3d") else (
            math.ceil(0.9 * n), n - math.ceil(0.9 * n))
        got = (len(train.cameras), len(val.cameras))
        poses = train.cameras.camera_to_worlds
        top = float(np.abs(poses[:, :3, 3]).max())
        files = [*train.image_filenames, *(train.mask_filenames or []),
                 *(train.metadata.get("depth_filenames") or []),
                 *(train.metadata.get("normal_filenames") or [])]
        log(f"[captures] {fmt}: {got[0]} train and {got[1]} val cameras "
            f"parsed in {parse_s:.3f}s (written in {write_s:.2f}s); "
            f"{train.cameras.width[0]}x{train.cameras.height[0]}, fx "
            f"{float(train.cameras.fx[0]):.3f}; largest |translation| "
            f"{top:.4f}; metadata {sorted(train.metadata)}")
        if got != want or len(train.image_filenames) != want[0]:
            raise AssertionError(f"captures {fmt}: {got} cameras, {want} "
                                 f"expected")
        if not np.isfinite(poses).all():
            raise AssertionError(f"captures {fmt}: non-finite poses")
        if fmt in scale and abs(top - scale[fmt]) > 1e-5 * scale[fmt]:
            raise AssertionError(f"captures {fmt}: largest translation "
                                 f"{top}, the parser scales to {scale[fmt]}")
        if not meta.get(fmt, set()) <= set(train.metadata):
            raise AssertionError(f"captures {fmt}: metadata "
                                 f"{sorted(train.metadata)}")
        if fmt == "nuscenes" and not train.mask_filenames:
            raise AssertionError("captures nuscenes: no masks")
        missing = [f for f in files if not Path(f).is_file()]
        if missing:
            raise AssertionError(f"captures {fmt}: missing {missing[:3]}")
        out[fmt] = (got[0], got[1], parse_s)
    return out


def capture_scene(tmp: Path, sky: bool, parser: str) -> Path:
    """CAPTURE_SCENE written for ``parser``: a Phototourism capture of
    JPEGs (the port's encoder at quality 95, 4:2:0) at full size
    (with the sky or over black), or the minimal parser's npz of the same
    cameras and views at half size (with the sky)."""
    from gfnerf_tpu_torch.utils.synthetic import (make_phototourism_fixture,
                                                  make_synthetic_npz)

    n, wh, focal = CAPTURE_SCENE
    if parser == "phototourism":
        return make_phototourism_fixture(
            tmp / f"capture_{'sky' if sky else 'black'}", n, wh, focal,
            sky=sky, image_format="jpeg")
    if not sky:
        raise ValueError("the minimal parser's scene has its sky")
    # ring_cameras' focal length 55 is CAPTURE_SCENE's at half size
    return make_synthetic_npz(tmp / "capture_npz", n_train=n - n // 10,
                              n_val=n // 10, img_wh=(wh[0] // 2, wh[1] // 2))


def capture_trainer(tmp: Path, tag: str, scene: Path, parser: str,
                    tree: str, scaled: bool = True, extra=None):
    """``train.build_trainer`` on ``scene`` through ``parser`` with
    CAPTURE_OVERRIDES on the octree ``tree`` (CAPTURE_TREES); without
    ``scaled``, the cameras left at the parser's size while the images are
    read at half size, as the JAX package's datamanager leaves them;
    ``extra``, more overrides.  Returns (the trainer, its argv)."""
    from unittest import mock

    from gfnerf_tpu_torch import train as train_entry
    from gfnerf_tpu_torch.data import datamanager

    over = {**CAPTURE_OVERRIDES, **CAPTURE_TREES[tree], **(extra or {})}
    argv = ["gf-nerf-perf", "--data", str(scene), "--dataparser", parser]
    if parser == "phototourism":
        argv += ["--dataparser-scale-factor", "4.0"]
    else:   # the npz holds the half-size views
        over["pipeline.datamanager.camera_res_scale_factor"] = "1.0"
    if not scaled:   # the Trainer's eval image would take the camera's size
        over["steps_per_eval_image"] = str(CAPTURE_STEPS + 1)
    argv += ["--output-dir", str(tmp / f"{tag}_out"), "--experiment-name",
             tag, "--max-num-iterations", str(CAPTURE_STEPS),
             *(f"{k}={v}" for k, v in over.items())]
    rescale = (datamanager.rescale_cameras if scaled
               else lambda outputs, scale: outputs)
    with mock.patch.object(datamanager, "rescale_cameras", rescale):
        return train_entry.build_trainer(argv), argv


def capture_frames(p, step: int, train_idx=()) -> list:
    """[(split, index, PSNR, its mean image's PSNR, median depth, mean
    accumulation)] of every
    val frame and of the train frames ``train_idx``, rendered at ``step``
    at the image's size (cameras left at full size cast its pixels through
    their own intrinsics, as the JAX package's datamanager does)."""
    import dataclasses

    import numpy as np

    dm = p.datamanager
    out = []
    for split, cams, cams_dev, ds, idxs in (
            ("val", dm.eval_dataparser_outputs.cameras, p.eval_cameras_dev,
             dm.eval_dataset, range(len(dm.eval_dataset))),
            ("train", dm.train_dataparser_outputs.cameras, p.cameras_dev,
             dm.train_dataset, train_idx)):
        for i in idxs:
            gt = ds.get_image(i)
            at_size = dataclasses.replace(
                cams, width=np.full_like(cams.width, gt.shape[1]),
                height=np.full_like(cams.height, gt.shape[0]))
            r = p.render_camera(at_size, cams_dev, i, step)
            psnr = -10.0 * np.log10(np.mean((r["rgb"] - gt) ** 2) + 1e-12)
            trivial = -10.0 * np.log10(np.mean(
                (gt - gt.mean(axis=(0, 1))) ** 2))
            out.append((split, int(i), float(psnr), float(trivial),
                        float(np.median(r["depth"])),
                        float(np.mean(r["accumulation"]))))
    return out


def phase_capture_variants(tmp: Path):
    """The capture of phase_captures trained once a variant
    (CAPTURE_VARIANTS: the sky or black, the octree, the parser, the
    cameras scaled or not, more overrides: the near plane, the background),
    CAPTURE_STEPS steps each;
    reported, not
    checked: the losses, every val frame's PSNR beside its mean image's
    (the captures phase's gate: each above), two train frames' PSNR, and
    the frames' median depth."""
    import numpy as np
    import torch

    out = {}
    for sky, tree, parser, scaled, extra in CAPTURE_VARIANTS:
        tag = "-".join([
            "sky" if sky else "black", tree, parser,
            "scaled" if scaled else "unscaled",
            *(f"{k.rsplit('.', 1)[-1]}={v}" for k, v in extra.items())])
        scene = capture_scene(tmp, sky, parser)
        t0 = time.perf_counter()
        trainer, _ = capture_trainer(tmp, tag, scene, parser, tree, scaled,
                                     extra)
        setup_s = time.perf_counter() - t0
        p = trainer.pipeline
        losses = []
        get_loss = p.get_train_loss_dict

        def get_loss_w(step, get_loss=get_loss, losses=losses):
            m = get_loss(step)
            losses.append(float(m["loss"]))
            return m

        p.get_train_loss_dict = get_loss_w
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        frames = capture_frames(
            p, CAPTURE_STEPS - 1,
            train_idx=(0, len(p.datamanager.train_dataset) // 2))
        val = [f for f in frames if f[0] == "val"]
        passed = all(f[2] > f[3] for f in val)
        log(f"[capture-variants] {tag}: setup {setup_s:.2f}s, "
            f"{p.sampler.tree.n_nodes} nodes, {CAPTURE_STEPS} steps in "
            f"{train_s:.1f}s; losses every {CAPTURE_LOG_EVERY} "
            f"{[round(x, 5) for x in losses[::CAPTURE_LOG_EVERY]]}; frames "
            f"(split, index, PSNR, mean-image PSNR, median depth, mean "
            f"accumulation) {[(f[0], f[1], *(round(x, 3) for x in f[2:])) for f in frames]}"
            f"; val mean {np.mean([f[2] for f in val]):.3f} vs "
            f"{np.mean([f[3] for f in val]):.3f}; gate "
            f"{'passed' if passed else 'failed'}")
        out[tag] = {"setup_s": setup_s, "train_s": train_s,
                    "losses": losses, "frames": frames, "gate": passed}
        del trainer, p
        torch.cuda.empty_cache()
    return {}, out


def phase_captures(tmp: Path):
    """The six capture formats written and parsed (parse_captures), then
    gf-nerf-perf through ``gfnerf_tpu_torch.train``'s command line
    (``train.build_trainer``, then its ``train``) on a Phototourism capture
    (CAPTURE_SCENE) with ``--dataparser phototourism``, the images read at
    half size, the gradients clipped and the rgb loss MSE
    (CAPTURE_OVERRIDES), counted: every step K1, K2 and H1 once, H2 one
    call; nothing else.  Checked: the images and cameras at half size, the
    losses finite and falling, every val frame's PSNR above its mean
    image's, each group's pre-clip norm a step and the steps it was
    clipped on (at least one), one step's profiler records of K1, K2, H1
    and H2, one step from the trained state against the plain pairs under
    the clip (the loss, the gradients, the norms and the clipped moments),
    the checkpoint.  Timed: s/step through the Trainer, the phase's peak
    memory above what it found allocated."""
    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK, STAGE_INIT
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode
    from gfnerf_tpu_torch.train_bench import RAYS, make_batch

    from gfnerf_tpu_torch.utils.jpeg import jpeg_info
    from gfnerf_tpu_torch.utils.synthetic import JPEG_QUALITY

    parsed = parse_captures(tmp)
    n, wh, focal = CAPTURE_SCENE
    t0 = time.perf_counter()
    scene = capture_scene(tmp, True, "phototourism")
    write_s = time.perf_counter() - t0
    files = sorted((scene / "dense" / "images").iterdir())
    if (len(files) != n or any(f.suffix != ".jpg" for f in files)
            or {jpeg_info(f.read_bytes()) for f in files} != {(*wh, 3)}):
        raise AssertionError(f"captures: the capture's files {files[:3]}")
    jpeg_bytes = sum(f.stat().st_size for f in files)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    trainer, argv = capture_trainer(tmp, "captures", scene, "phototourism",
                                    CAPTURE_TREE)
    setup_s = time.perf_counter() - t0
    p = trainer.pipeline
    dm, fc = p.datamanager, p.field_cfg
    cams = dm.train_dataparser_outputs.cameras
    shape = dm.init_cache.images.shape
    log(f"[captures] python -m gfnerf_tpu_torch.train {' '.join(argv)}")
    log(f"[captures] phototourism: {n} views at {wh[0]}x{wh[1]} written "
        f"as JPEG (quality {JPEG_QUALITY}, 4:2:0, {jpeg_bytes} "
        f"bytes) in {write_s:.2f}s and decoded by the port's codec on the "
        f"datamanager's pool; setup {setup_s:.2f}s: {len(cams)} train and "
        f"{len(dm.eval_dataparser_outputs.cameras)} val cameras, images "
        f"{shape[1:3]}, cameras {int(cams.width[0])}x{int(cams.height[0])} "
        f"fx {float(cams.fx[0]):.3f}; {p.sampler.tree.n_nodes} nodes; "
        f"{CAPTURE_TREE}'s octree; {fc.num_levels} levels x "
        f"{fc.features_per_level} of 2^{fc.packed_rows_log2}, "
        f"{dm.config.train_num_rays_per_batch} rays, "
        f"{p.sampler.sampler_config.max_samples} slots")
    half = (wh[1] // 2, wh[0] // 2)
    if (shape[1:3] != half or (int(cams.width[0]), int(cams.height[0]))
            != (half[1], half[0]) or float(cams.fx[0]) != focal / 2):
        raise AssertionError(f"captures: images {shape}, cameras "
                             f"{cams.width[0]}x{cams.height[0]} fx "
                             f"{cams.fx[0]}, expected half size")
    if (dm.config.train_num_rays_per_batch, p.sampler.sampler_config
            .max_samples) != (RAYS, 160):
        raise AssertionError("captures: not gf-nerf-perf's width")
    rec, evals = {}, []
    get_loss, eval_batch = p.get_train_loss_dict, p.get_eval_loss_dict

    def counts():
        return {**launch_counts(),
                "packed_hash_bwd_calls": packed_hash_encode.bwd_calls}

    def get_loss_w(step):
        before = counts()
        t = time.perf_counter()
        m = get_loss(step)
        torch.cuda.synchronize()
        after = counts()
        rec[step] = {"s": time.perf_counter() - t, **m,
                     "counts": {k: after[k] - before[k] for k in after}}
        return m

    def eval_batch_w(step):
        m = eval_batch(step)
        evals.append((step, float(m["eval_psnr"])))
        return m

    p.get_train_loss_dict, p.get_eval_loss_dict = get_loss_w, eval_batch_w
    reset_launch_counts()
    t0 = time.perf_counter()
    trainer.train()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() - held
    p.get_train_loss_dict, p.get_eval_loss_dict = get_loss, eval_batch
    if sorted(rec) != list(range(CAPTURE_STEPS)):
        raise AssertionError(f"captures: steps run {sorted(rec)}")
    h2 = table_grad_launches({"fcfg": fc})
    want = {"composite_fwd": 1, "composite_bwd": 1, "packed_hash_fwd": 1,
            "packed_hash_bwd": h2, "packed_hash_bwd_calls": 1}
    for i in range(CAPTURE_STEPS):
        got = rec[i]["counts"]
        if got != {k: want.get(k, 0) for k in got}:
            raise AssertionError(f"captures step {i}: launches {got}, "
                                 f"expected {want}")
    losses = [rec[i]["loss"] for i in range(CAPTURE_STEPS)]
    every = CAPTURE_LOG_EVERY
    log(f"[captures] every {every} steps: losses "
        f"{[round(x, 5) for x in losses[::every]]}; samples a ray "
        f"{[round(rec[i]['num_samples_per_ray'], 1) for i in range(0, CAPTURE_STEPS, every)]}"
        f"; eval batches (step, PSNR) {[(s, round(v, 3)) for s, v in evals]}")
    if not (np.isfinite(losses).all()
            and _mean(losses[-10:]) < _mean(losses[:10])):
        raise AssertionError(f"captures: the loss did not fall: {losses}")
    groups = sorted({k for i in rec for k in rec[i]
                     if k.startswith("grad_norm_")})
    norms = {g[len("grad_norm_"):]: [rec[i].get(g) for i in
                                     range(CAPTURE_STEPS)] for g in groups}
    clipped = {g: sum(v is not None and v >= CAPTURE_MAX_NORM for v in vs)
               for g, vs in norms.items()}
    early = {g: sum(v is not None and v >= CAPTURE_MAX_NORM for v in vs[:24])
             for g, vs in norms.items()}
    log(f"[captures] pre-clip norms every {every} steps (limit "
        f"{CAPTURE_MAX_NORM}): "
        f"{ {g: [None if v is None else round(v, 5) for v in vs[::every]] for g, vs in norms.items()} }; "
        f"steps clipped {clipped} of {CAPTURE_STEPS}, {early} of the "
        f"first 24")
    if set(norms) != {"fields", "base_encoding_init"} or not sum(
            clipped.values()):
        raise AssertionError(f"captures: the clip {clipped}, norms {norms}")
    # every val frame against its mean image
    frames = [f[1:] for f in capture_frames(p, CAPTURE_STEPS - 1)]
    log(f"[captures] val frames (index, PSNR, mean-image PSNR, median "
        f"depth, mean accumulation): "
        f"{[(f[0], *(round(x, 3) for x in f[1:])) for f in frames]}")
    if not all(f[1] > f[2] for f in frames):
        raise AssertionError(f"captures: eval PSNR not above the mean "
                             f"image's: {frames}")
    ckpt = trainer.checkpoint_dir / f"step-{CAPTURE_STEPS - 1:09d}"
    if not (ckpt / "state.pt").is_file():
        raise AssertionError(f"captures: no checkpoint at {ckpt}")
    # one more step profiled: its kernels' records
    def kernel_of(event):
        if event.device_type != DeviceType.CUDA:
            return None
        return next((k for k, match in CAPTURE_KERNEL_RECORDS.items()
                     if match in event.key), None)

    def one_step():
        p.get_train_loss_dict(CAPTURE_STEPS)
        torch.cuda.synchronize()

    traced, _ = profiled_counts(
        one_step, kernel_of, lambda got: all(
            got.get(k, (0,))[0] == want[k] for k in CAPTURE_KERNEL_RECORDS))
    records = {k: traced.get(k, (0,))[0] for k in CAPTURE_KERNEL_RECORDS}
    log(f"[captures] one step's profiler records {records}")
    if not all(records[k] >= 1 for k in CAPTURE_KERNEL_RECORDS):
        raise AssertionError(f"captures: kernel records {records}")
    wl = {"field": p.field, "state": p.state, "tx": p.tx,
          "step_fn": p._train_step[STAGE_INIT],
          "focal_step_fn": p._train_step[STAGE_BLOCK],
          "oct_dev": p.sampler.oct_dev, "cams": p.cameras_dev,
          "fineness": 1.0, "scfg": p.sampler.sampler_config, "fcfg": fc}
    batch = make_batch(dm.init_cache.images, RAYS, 800, p.device)
    gen = torch.Generator(device=p.device).manual_seed(11)
    noise, perms = step_draws(wl, gen)
    pair_loss = compare_step(wl, "captures", batch, noise, perms)
    step_s = [rec[i]["s"] for i in range(CAPTURE_WARMUP, CAPTURE_STEPS)]
    log(f"[captures] Trainer {_mean(step_s):.4f} s/step (median "
        f"{float(np.median(step_s)):.4f}, after {CAPTURE_WARMUP} warm-up "
        f"steps), {RAYS / _mean(step_s):.1f} rays/s; the phase's peak "
        f"{peak / 2**30:.3f} GiB above the {held / 2**30:.3f} it found "
        f"allocated; the run {train_s:.1f}s; launches "
        f"{launches}")
    stats = {"parsed": parsed, "tree": CAPTURE_TREE, "setup_s": setup_s,
             "image_format": "jpeg", "jpeg_bytes": jpeg_bytes,
             "train_s": train_s, "eval_batches": evals,
             "s_per_step": _mean(step_s), "rays_per_s": RAYS / _mean(step_s),
             "peak_bytes": peak, "losses": losses, "grad_norms": norms,
             "clipped_steps": clipped, "max_norm": CAPTURE_MAX_NORM,
             "val_frames": frames, "profiler_records": records,
             "compare_step_loss": pair_loss}
    del trainer, p, wl
    torch.cuda.empty_cache()
    return launches, stats


# the tools phase: the exporter, the viewer and a Trainer with the viewer
# attached, on the pipeline phase's run (gf-nerf-perf after 44 steps, in
# its focal stage).  The point cloud from every train view at downscale 4,
# the density mesh on a 64^3 grid, the TSDF from 8 views at 64^3, the
# texture on that mesh; viewer requests at 640x480 and at downscale 4;
# the live Trainer resumed from the checkpoint for up to 12 steps
TOOLS_POINT_VIEWS = 48
TOOLS_DOWNSCALE = 4
TOOLS_MESH_RES = 64
# the density mesh's threshold: this quantile of the grid's positive
# densities
TOOLS_DENSITY_QUANTILE = 0.99
TOOLS_TSDF = (8, 64)             # views, resolution
TOOLS_VIEW_WH = (640, 480)
TOOLS_REQUESTS = 3               # timed viewer requests at each size
TOOLS_LIVE_STEPS = 12
TOOLS_VIDEO_FRAMES = 8           # the render script's spiral, at full size
TOOLS_VIDEO_MIN_PSNR = 35.0      # a video frame against its PNG frame
# the point cloud, kernels against plain: its count within 0.5%, the
# pixels both keep within SLICE_ATOL of the scene's size
TOOLS_COUNT_RTOL = 5e-3


def _ply_points(path: Path):
    """(points (N, 3), colours (N, 3)) of write_ply's binary PLY."""
    import numpy as np

    data = path.read_bytes()
    head = b"end_header\n"
    n = int(data.split(b"element vertex ")[1].split(b"\n")[0])
    rows = np.frombuffer(data[data.index(head) + len(head):], np.dtype(
        [("p", "<f4", (3,)), ("c", "u1", (3,))]))
    if len(rows) != n:
        raise AssertionError(f"{path.name}: {len(rows)} rows, header {n}")
    return rows["p"], rows["c"]


def _obj_mesh(path: Path):
    """(vertices (V, 3), faces) of an OBJ: the face lines' first indices."""
    import numpy as np

    verts, faces = [], []
    for line in path.read_text().splitlines():
        if line.startswith("v "):
            verts.append([float(x) for x in line.split()[1:4]])
        elif line.startswith("f "):
            faces.append([int(x.split("/")[0]) for x in line.split()[1:]])
    return np.asarray(verts).reshape(-1, 3), faces


def sphere_distance(pts):
    """Each point's distance to the nearest sphere surface of the
    synthetic scene."""
    import numpy as np

    from gfnerf_tpu_torch.utils.synthetic import SPHERES

    pts = np.asarray(pts, np.float64).reshape(-1, 3)
    c, r = SPHERES[:, :3].astype(np.float64), SPHERES[:, 3]
    return np.abs(np.linalg.norm(pts[:, None] - c[None], axis=-1)
                  - r[None]).min(axis=1)


def tools_run_dir(tmp: Path) -> Path:
    """The pipeline phase's first run: its checkpoint of step 43."""
    for config in sorted((tmp / "out").glob(
            "scene/gf-nerf-perf/*/config.json")):
        if (config.parent / "nerfstudio_models"
                / f"step-{PIPELINE_STEPS - 1:09d}").is_dir():
            return config.parent
    raise AssertionError("tools: no checkpoint of the pipeline phase's run "
                         "(run the pipeline phase first: --only "
                         "pipeline,tools)")


def _http(url: str, doc=None) -> bytes:
    import urllib.request

    req = url if doc is None else urllib.request.Request(
        url, data=json.dumps(doc).encode())
    with urllib.request.urlopen(req, timeout=300) as res:
        return res.read()


def phase_tools(tmp: Path):
    """The exporter, the viewer and the live viewer on the pipeline phase's
    run (gf-nerf-perf, 44 steps: its focal stage), each part with the
    launch counters reset.

    Export, through gfnerf_tpu_torch.export's ``main`` (the command line's
    function): the point cloud of the 48 train views at
    downscale 4, the density mesh at 64^3 (its threshold the
    TOOLS_DENSITY_QUANTILE quantile of the grid's positive densities), the
    TSDF of 8 views at 64^3, the texture on the mesh.  Checked: K1 once and H1 twice a render chunk
    (the focal stage: the global encode, then the view's block on it),
    H1 once a density chunk of 65536 points, nothing else; every file read
    back, finite and inside the octree's root cube, the point cloud and
    both meshes non-empty; the poses the train cameras; the texture at the
    atlas's size; the point cloud and the mesh again through the plain
    versions (the count within TOOLS_COUNT_RTOL, the depths of the pixels
    both keep within SLICE_ATOL of the scene's size; the mesh's OBJ equal
    byte for byte, or the vertices that differ reported).  Reported: each
    mode's seconds, the point cloud's and the TSDF's median distance to the
    nearest sphere.

    Video: gfnerf_tpu_torch.render's ``main`` along a spiral of
    TOOLS_VIDEO_FRAMES frames as ``render.mp4``, and the same frames
    rendered and quantized as the script writes its PNGs, each with K1
    once and H1 twice a chunk.  Checked: the MP4's boxes (ftyp, mdat,
    moov; an mp4v entry naming JPEG), one sample a frame at 24 fps, every
    sample decoded by the port's codec to its frame's size with a PSNR of
    at least TOOLS_VIDEO_MIN_PSNR against it.

    Viewer: a ViewerServer on 127.0.0.1 at an ephemeral port.  Checked: the
    page; /scene's 48 cameras, the tree's nodes and valid leaves, the
    blocks' counts; /render at 640x480 (rgb, depth, accumulation) and at
    downscale 4: PNGs of the size, the rgb one equal to the quantized
    render_camera output for the same pose, the launches a chunk as in
    the export; a /camera_path document read back by the render script.
    Reported: seconds a request at both sizes.

    Live: a Trainer with vis "viewer", resumed from the checkpoint for up to
    TOOLS_LIVE_STEPS steps, driven over HTTP.  Checked: pause holds the
    step count for 1 s; resume continues it; a render while training (over
    HTTP and through render_outputs) is finite and never inside a step;
    stop saves the checkpoint of the step before the one it stopped on,
    K2 once a step; /status shows the published step and loss."""
    import threading

    import numpy as np
    import torch

    from gfnerf_tpu_torch import export as export_mod
    from gfnerf_tpu_torch import render as render_entry
    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.exporter import exporter
    from gfnerf_tpu_torch.fields.field import STAGE_BLOCK
    from gfnerf_tpu_torch.render import (cameras_from_camera_path,
                                         spiral_cameras)
    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.utils.image_io import decode_png, read_png
    from gfnerf_tpu_torch.utils.jpeg import decode_jpeg
    from gfnerf_tpu_torch.utils.video import read_mp4
    from gfnerf_tpu_torch.viewer.server import ViewerServer, quantize

    t_phase = time.perf_counter()
    run = tools_run_dir(tmp)
    config = run / "config.json"
    out = tmp / "exports"
    total = {k: 0 for k in launch_counts()}
    stats = {"export_s": {}, "viewer_s_per_request": {}}

    def counted(fn):
        reset_launch_counts()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        got = launch_counts()
        for k, v in got.items():
            total[k] += v
        return res, got, dt

    SETUP_REUSE.forget_primes()   # one process's eval_setup: drawn anew
    SETUP_REUSE.note()
    t0 = time.perf_counter()
    _, loaded = eval_setup(config)
    p = loaded.pipeline
    setup_s = time.perf_counter() - t0
    reused = SETUP_REUSE.note()
    chunk = p.config.eval_num_rays_per_chunk
    focal = p.stage_of(int(p.state.step)) == STAGE_BLOCK
    h1_a_chunk = 2 if focal else 1
    cams = p.datamanager.train_dataparser_outputs.cameras
    tree = p.sampler.tree
    lo = np.asarray(tree.centers[0]) - float(tree.side_lens[0]) / 2
    hi = np.asarray(tree.centers[0]) + float(tree.side_lens[0]) / 2
    pos = cams.camera_to_worlds[:, :, 3]
    scene_size = float(np.linalg.norm(pos[:, None] - pos[None], axis=-1)
                       .max())
    scale = export_mod.depth_scale(p)
    log(f"[tools] {run.name}: step {p.state.step} (focal stage: {focal}), "
        f"render chunks of {chunk} rays, root cube {lo.tolist()} .. "
        f"{hi.tolist()}, scene size {scene_size:.3f}; eval_setup "
        f"{setup_s:.2f}s (one process's: {reused})")

    def render_chunks(views, down):
        return sum(-(-(int(cams.height[i]) // down)
                     * (int(cams.width[i]) // down) // chunk) for i in views)

    def expect(what, got, chunks=0, density_chunks=0):
        check_launches(what, got, {
            "composite_fwd": chunks,
            "packed_hash_fwd": h1_a_chunk * chunks + density_chunks})

    def inside(pts, what):
        pts = np.asarray(pts)
        if not (np.isfinite(pts).all() and (pts >= lo).all()
                and (pts <= hi).all()):
            raise AssertionError(f"tools: {what} not finite or outside the "
                                 f"root cube")

    def export(mode, *extra):
        argv = [mode, "--load-config", str(config), "--output-dir", str(out),
                *extra]
        rc, got, dt = counted(lambda: export_mod.main(argv))
        if rc != 0:
            raise AssertionError(f"tools: export {mode} returned {rc}")
        stats["export_s"][mode] = dt
        return got

    def plain(fn):
        """fn() through the plain versions (no kernel may launch)."""
        reset_launch_counts()
        with plain_wrappers():
            return fn()

    # ---- point cloud, through the kernels and the plain versions ----
    renders = {"kernels": [], "plain": []}
    make_render = export_mod.camera_render_fn

    def recording(which, render):
        def recorded(c, i, downscale=1):
            res = render(c, i, downscale=downscale)
            renders[which].append(res)
            return res
        return recorded

    try:
        export_mod.camera_render_fn = lambda pipe, c: recording(
            "kernels", make_render(pipe, c))
        got = export("pointcloud", "--num-views", str(TOOLS_POINT_VIEWS),
                     "--downscale-factor", str(TOOLS_DOWNSCALE))
    finally:
        export_mod.camera_render_fn = make_render
    n_plain = plain(lambda: exporter.export_point_cloud(
        recording("plain", make_render(p, cams)), cams,
        tmp / "plain_point_cloud.ply", num_views=TOOLS_POINT_VIEWS,
        downscale=TOOLS_DOWNSCALE, depth_scale=scale))
    expect("tools pointcloud", got,
           render_chunks(range(TOOLS_POINT_VIEWS), TOOLS_DOWNSCALE))
    pts, _ = _ply_points(out / "point_cloud.ply")
    inside(pts, "the point cloud")
    worst = 0.0
    for k, q in zip(renders["kernels"], renders["plain"]):
        both = ((k["accumulation"] > 0.5) & (q["accumulation"] > 0.5))
        if both.any():
            worst = max(worst, float(np.abs(k["depth"] - q["depth"])[both]
                                     .max()) * scale)
    pc_dist = sphere_distance(pts)
    log(f"[tools] point cloud: {len(pts)} points ({n_plain} through the "
        f"plain versions); the depth of the pixels both keep differs by "
        f"{worst:.3g} (limit {SLICE_ATOL * scene_size:.3g}); median "
        f"distance to the nearest sphere {np.median(pc_dist):.4f}")
    if (not len(pts) or len(renders["kernels"]) != TOOLS_POINT_VIEWS
            or abs(len(pts) - n_plain) > TOOLS_COUNT_RTOL * len(pts)
            or not worst <= SLICE_ATOL * scene_size):
        raise AssertionError("tools: the point cloud, kernels against plain")

    # ---- poses ----
    expect("tools poses", export("poses"))
    frames = json.loads((out / "camera_poses.json").read_text())
    poses = np.asarray([f["transform"] for f in frames])
    if len(frames) != len(cams) or not np.array_equal(
            poses[:, :3], cams.camera_to_worlds):
        raise AssertionError("tools: the poses are not the train cameras")

    # ---- density mesh, kernels and plain ----
    # the grid's densities choose the threshold: the exporter's default,
    # 5, is past every grid point's density after 44 steps (the field
    # reads warped space, its densities per warped unit)
    aabb = export_mod.mesh_aabb(p)
    res = TOOLS_MESH_RES
    axes = [np.linspace(aabb[0][d], aabb[1][d], res + 1, dtype=np.float32)
            for d in range(3)]
    grid = np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)
    n_density = -(-len(grid) // 65536)
    dens, got, _ = counted(lambda: np.concatenate([
        export_mod.density_fn(p, grid[i:i + 65536])
        for i in range(0, len(grid), 65536)]))
    expect("tools grid densities", got, density_chunks=n_density)
    at_points = export_mod.density_fn(p, pts[::max(len(pts) // 4096, 1)])
    if not (dens > 0).any():
        raise AssertionError("tools: no grid point has a density")
    threshold = float(np.quantile(dens[dens > 0], TOOLS_DENSITY_QUANTILE))
    log(f"[tools] the {res + 1}^3 grid's densities: max {dens.max():.4g}, "
        f"quantiles 0.5/0.9/0.99 of the positive "
        f"{np.quantile(dens[dens > 0], [0.5, 0.9, 0.99]).round(4).tolist()}"
        f", {int((dens >= 5.0).sum())} points at 5 or more; at the point "
        f"cloud's points median {np.median(at_points):.4g}; the mesh's "
        f"threshold {threshold:.4g}")
    got = export("mesh", "--resolution", str(res), "--density-threshold",
                 repr(threshold))
    expect("tools mesh", got, density_chunks=n_density)
    plain(lambda: exporter.export_marching_cubes_mesh(
        lambda x: export_mod.density_fn(p, x), aabb, res, threshold,
        tmp / "plain_mesh.obj"))
    mesh_text = (out / "mesh.obj").read_text()
    plain_text = (tmp / "plain_mesh.obj").read_text()
    verts, faces = _obj_mesh(out / "mesh.obj")
    inside(verts, "the density mesh")
    same = mesh_text == plain_text
    vs = {ln for ln in mesh_text.splitlines() if ln.startswith("v ")}
    ps = {ln for ln in plain_text.splitlines() if ln.startswith("v ")}
    log(f"[tools] density mesh at {res}^3: {len(verts)} vertices, "
        f"{len(faces)} faces; the plain versions' OBJ "
        + ("equal byte for byte" if same else
           f"differs: {len(vs ^ ps)} vertices in one and not the other"))
    stats.update(mesh_equal_to_plain=same, mesh_threshold=threshold,
                 grid_density_max=float(dens.max()))
    if not len(faces):
        raise AssertionError("tools: the density mesh is empty")

    # ---- TSDF ----
    n_tsdf, tsdf_res = TOOLS_TSDF
    got = export("tsdf", "--resolution", str(tsdf_res), "--num-views",
                 str(n_tsdf), "--downscale-factor", str(TOOLS_DOWNSCALE))
    step = max(len(cams) // n_tsdf, 1)
    expect("tools tsdf", got, render_chunks(range(0, len(cams), step),
                                            TOOLS_DOWNSCALE))
    tsdf, _ = _obj_mesh(out / "tsdf_mesh.obj")
    inside(tsdf, "the TSDF mesh")
    tsdf_dist = sphere_distance(tsdf)
    log(f"[tools] TSDF of {n_tsdf} views at {tsdf_res}^3: {len(tsdf)} "
        f"vertices, median distance to the nearest sphere "
        f"{np.median(tsdf_dist) if len(tsdf) else float('nan'):.4f}")
    if not len(tsdf):
        raise AssertionError("tools: the TSDF mesh is empty")

    # ---- texture on the density mesh ----
    got = export("texture")
    expect("tools texture", got, -(-len(faces) * 64 // chunk))
    tex = read_png(out / "texture.png")
    cols = int(np.ceil(np.sqrt(len(faces))))
    rows = int(np.ceil(len(faces) / cols))
    tverts, tfaces = _obj_mesh(out / "mesh.obj")
    inside(tverts, "the textured mesh")
    log(f"[tools] texture: {len(tfaces)} faces, atlas {tex.shape}, mean "
        f"colour {tex.reshape(-1, 3).mean(0).round(2).tolist()}")
    if (tex.shape != (rows * 8, cols * 8, 3) or len(tfaces) != len(faces)
            or not np.allclose(tverts, verts, rtol=0, atol=1e-5)):
        raise AssertionError("tools: the textured mesh or its atlas")
    log(f"[tools] export seconds {json.dumps(stats['export_s'])} (each "
        f"mode's eval_setup included; {SETUP_REUSE.note()})")

    # ---- the render script's video against the frames it renders ----
    # (the frames as the script writes its PNGs, from the loaded pipeline:
    # the same checkpoint, spiral and quantization, one eval_setup fewer)
    spiral = spiral_cameras(p.datamanager.eval_dataparser_outputs.cameras,
                            steps=TOOLS_VIDEO_FRAMES)
    spiral_dev = spiral.to_device(p.device)
    at = int(p.state.step)
    pngs, got_png, png_s = counted(lambda: [
        (np.clip(p.render_camera(spiral, spiral_dev, i, at)["rgb"], 0, 1)
         * 255).astype(np.uint8) for i in range(len(spiral))])
    rc, got, video_s = counted(lambda: render_entry.main([
        "--load-config", str(config), "--traj", "spiral", "--spiral-steps",
        str(TOOLS_VIDEO_FRAMES), "--output-format", "video",
        "--output-path", str(tmp / "tools_video")]))
    if rc or len(pngs) != TOOLS_VIDEO_FRAMES:
        raise AssertionError(f"tools: render returned {rc}; {len(pngs)} "
                             f"frames")
    frame_chunks = sum(-(-f.shape[0] * f.shape[1] // chunk) for f in pngs)
    expect("tools spiral frames", got_png, frame_chunks)
    expect("tools render --output-format video", got, frame_chunks)
    video = read_mp4(tmp / "tools_video" / "render.mp4")
    decoded = [decode_jpeg(sample) for sample in video["samples"]]
    psnrs = [float(10 * np.log10(255.0 ** 2 / np.mean(
        (d.astype(np.float64) - f) ** 2))) for d, f in zip(decoded, pngs)]
    log(f"[tools] render --output-format video: {video['top']} boxes, "
        f"{video['codec']} entry (objectTypeIndication "
        f"{video['object_type']:#x}), {len(video['samples'])} samples of "
        f"{video['width']}x{video['height']} at {video['fps']} fps, "
        f"{sum(map(len, video['samples']))} bytes, in {video_s:.2f}s "
        f"(its eval_setup included; the frames alone {png_s:.2f}s); each "
        f"sample decoded by the codec against the frame's PNG pixels: PSNR "
        f"{[round(x, 2) for x in psnrs]} dB; launches {got}")
    if (video["top"] != [b"ftyp", b"mdat", b"moov"]
            or (video["codec"], video["object_type"]) != ("mp4v", 0x6C)
            or video["fps"] != 24.0
            or len(set(video["deltas"])) != 1
            or len(decoded) != TOOLS_VIDEO_FRAMES
            or any(d.shape != f.shape for d, f in zip(decoded, pngs))
            or (video["height"], video["width"], 3) != pngs[0].shape
            or min(psnrs) < TOOLS_VIDEO_MIN_PSNR):
        raise AssertionError("tools: the video's checks")
    stats.update(video_s=video_s, video_frames_s=png_s,
                 video_psnr=psnrs,
                 video_bytes=sum(map(len, video["samples"])))

    # ---- viewer ----
    server = ViewerServer(p, port=0, save_dir=tmp / "viewer_paths",
                          default_radius=float(np.linalg.norm(
                              pos, axis=1).mean())).start()
    base = f"http://127.0.0.1:{server.port}"
    try:
        if b"<canvas" not in _http(base + "/"):
            raise AssertionError("tools: the viewer's page")
        scene = json.loads(_http(base + "/scene"))
        blocks = scene["blocks"]
        log(f"[tools] /scene: {len(scene['cameras'])} cameras, octree "
            f"{scene['octree']}, blocks {blocks}")
        if (len(scene["cameras"]) != len(cams) or scene["octree"] != {
                "n_nodes": tree.n_nodes,
                "n_leaves": int(p.sampler.oct_dev.n_leaves)}
                or len(blocks) != p.field_cfg.n_blocks
                or sum(blocks.values()) != len(cams)):
            raise AssertionError(f"tools: /scene {scene}")
        w, h = TOOLS_VIEW_WH
        req = {"c2w": cams.camera_to_worlds[0].tolist(), "width": w,
               "height": h}
        for down in (1, TOOLS_DOWNSCALE):
            size = {"downscale": down}
            n_chunks = -(-(h // down) * (w // down) // chunk)
            for output in ("rgb", "depth", "accumulation"):
                png, got, _ = counted(lambda: _http(
                    base + "/render", {**req, **size, "output": output}))
                img = decode_png(png)
                if img.shape != (h // down, w // down, 3):
                    raise AssertionError(f"tools: /render {output} "
                                         f"{img.shape}")
                expect(f"tools /render {output} {w // down}x{h // down}",
                       got, n_chunks)
                if output == "rgb":
                    want = quantize(server.render_outputs({**req, **size})[
                        "rgb"])
                    if not np.array_equal(img, want):
                        raise AssertionError(
                            f"tools: /render's PNG differs from "
                            f"render_camera's image at downscale {down} in "
                            f"{int((img != want).any(-1).sum())} pixels")
            times = []
            for _ in range(TOOLS_REQUESTS):
                _, _, dt = counted(lambda: _http(base + "/render",
                                                 {**req, **size}))
                times.append(dt)
            stats["viewer_s_per_request"][f"{w // down}x{h // down}"] = \
                _mean(times)
        doc = json.loads(_http(base + "/camera_path", {
            "keyframes": [cams.camera_to_worlds[0].tolist(),
                          cams.camera_to_worlds[len(cams) // 4].tolist()],
            "width": 320, "height": 240, "fps": 24, "seconds": 1.0}))
        path_cams = cameras_from_camera_path(doc)
        if (path_cams.camera_to_worlds.shape != (24, 3, 4)
                or not np.allclose(path_cams.camera_to_worlds[0],
                                   cams.camera_to_worlds[0], atol=1e-5)):
            raise AssertionError("tools: the camera path did not read back")
    finally:
        server.shutdown()
    log(f"[tools] viewer: the PNGs of /render equal render_camera's "
        f"images; s/request {json.dumps(stats['viewer_s_per_request'])}; "
        f"a camera path of 24 frames read back")

    # ---- a live Trainer with the viewer ----
    cfg = get_method("gf-nerf-perf")
    for key, value in {**PIPELINE_OVERRIDES,
                       "max_num_iterations": str(PIPELINE_STEPS
                                                 + TOOLS_LIVE_STEPS),
                       "output_dir": str(tmp / "tools_out"),
                       "load_dir": str(run / "nerfstudio_models"),
                       "vis": "viewer", "viewer_port": "0",
                       "steps_per_log": "1"}.items():
        apply_override(cfg, key, value)
    cfg.data = tmp / "scene"
    trainer = Trainer(cfg, build_dataparser("minimal", cfg.data))
    trainer.setup()
    tp = trainer.pipeline
    steps, busy, overlaps = [], {"step": False, "render": False}, [0]
    step_fn, render_fn = tp.get_train_loss_dict, tp.render_camera

    def step_w(step):
        busy["step"] = True
        overlaps[0] += busy["render"]
        try:
            return step_fn(step)
        finally:
            steps.append(step)
            busy["step"] = False

    def render_w(*args, **kw):
        busy["render"] = True
        overlaps[0] += busy["step"]
        try:
            return render_fn(*args, **kw)
        finally:
            busy["render"] = False

    tp.get_train_loss_dict, tp.render_camera = step_w, render_w
    live = f"http://127.0.0.1:{trainer.viewer.port}"
    small = {**req, "downscale": TOOLS_DOWNSCALE}
    rec = {}

    def wait_steps(n):
        t0 = time.perf_counter()
        while len(steps) < n:
            if time.perf_counter() - t0 > 300:
                raise AssertionError(f"tools: {len(steps)} live steps")
            time.sleep(0.002)

    def drive():
        thread = threading.Thread(target=trainer.train, daemon=True)
        thread.start()
        try:
            wait_steps(2)
            _http(live + "/control", {"action": "pause"})
            time.sleep(0.3)                       # the step in flight ends
            rec["paused_at"] = len(steps)
            rec["paused_status"] = json.loads(_http(live + "/status"))
            time.sleep(1.0)
            rec["after_1s"] = len(steps)
            rec["paused_png"] = decode_png(_http(live + "/render", small))
            _http(live + "/control", {"action": "resume"})
            wait_steps(rec["paused_at"] + 1)
            rec["resumed_at"] = len(steps)
            rec["live_png"] = decode_png(_http(live + "/render", small))
            rec["live_out"] = trainer.viewer.render_outputs(small)
            _http(live + "/control", {"action": "stop"})
            thread.join(timeout=300)
            if thread.is_alive():
                raise AssertionError("tools: the live Trainer did not stop")
            rec["status"] = json.loads(_http(live + "/status"))
        finally:
            trainer.viewer.shutdown()

    _, got, live_s = counted(drive)
    ckpts = sorted(c.name for c in trainer.checkpoint_dir.glob("step-*"))
    st = rec["status"]
    log(f"[tools] live: steps {steps}; paused after {rec['paused_at']} "
        f"steps, {rec['after_1s']} after 1 s; resumed to "
        f"{rec['resumed_at']}; stopped after {len(steps)}, checkpoint "
        f"{ckpts}; /status step {st.get('step')} loss {st.get('loss')} "
        f"rays/s {st.get('rays_per_sec')}; renders inside a step: "
        f"{overlaps[0]}; {live_s:.2f}s; launches {got}")
    finite = all(bool(np.isfinite(v).all()) for v in rec["live_out"].values())
    if (rec["after_1s"] != rec["paused_at"]
            or not rec["paused_status"]["paused"]
            or rec["resumed_at"] <= rec["paused_at"]
            or steps != list(range(PIPELINE_STEPS, PIPELINE_STEPS
                                   + len(steps)))
            or len(steps) >= TOOLS_LIVE_STEPS
            or ckpts != [f"step-{steps[-1]:09d}"]
            or st.get("step") != steps[-1] or not np.isfinite(st["loss"])
            or not st["stopping"] or overlaps[0] or not finite
            or rec["live_png"].shape != (h // TOOLS_DOWNSCALE,
                                         w // TOOLS_DOWNSCALE, 3)
            or got["composite_bwd"] != len(steps)):
        raise AssertionError("tools: the live viewer's checks")
    stats.update(
        eval_setup_s=setup_s, points=len(pts), plain_points=n_plain,
        point_depth_err=worst, mesh_vertices=len(verts),
        mesh_faces=len(faces), tsdf_vertices=len(tsdf),
        atlas=list(tex.shape), live_s=live_s, live_steps=len(steps),
        point_sphere_dist_median=float(np.median(pc_dist)),
        tsdf_sphere_dist_median=float(np.median(tsdf_dist)),
        phase_s=time.perf_counter() - t_phase)
    log(f"[tools] the phase in {stats['phase_s']:.1f}s")
    return total, stats


# gf-nerf-perf over 4 ranks, the concurrent focal stage on a (data 2,
# block 2) grid: at its width (8192 rays a batch, a block group's at the
# focal stage; S = 160; 10 blocks), on the pipeline phase's 48-view scene.
# Cut: 8 init steps (the config's 30 k) with a milestone rebuild at 4
# (2000) and the fineness anneal over 8 steps (10 k), then 2 steps a phase
# (10 k): the first focal step data-parallel on block 0 (the transition
# runs after it), then 5 phases of the rotation, phase p training blocks
# {p, p + 5}; an eval image and the checkpoint at 17.  The octree is the
# bench's (octree_bench.BENCH_TREE), to keep rank 0's build short.
PARALLEL_WORLD = 4
PARALLEL_INIT_STEPS = 8
PARALLEL_STEPS = PARALLEL_INIT_STEPS + 10
PARALLEL_OVERRIDES = {
    **ONE_STEP_A_DISPATCH,
    **{f"pipeline.{part}.{key}": value
       for part in ("model", "datamanager", "optimizers")
       for key, value in (("steps_perssampler_init",
                           str(PARALLEL_INIT_STEPS)),
                          ("steps_per_split_dataset", "2"))},
    "pipeline.sampler.sub_div_milestones": "4",
    "pipeline.sampler.ray_march_fineness_decay_end_iter": "8",
    "steps_per_eval_batch": "100000",
    "steps_per_eval_image": str(PARALLEL_STEPS),
    "steps_per_save": str(PARALLEL_STEPS),
    "steps_per_log": "100",
    **CAPTURE_TREES["bench"],
}
# seconds a collective or the rendezvous may wait (rank 0's octree build,
# the checks at a barrier), and the ranks' whole run
PARALLEL_GROUP_TIMEOUT = 300.0
PARALLEL_JOIN_S = 600.0
# the all-reduced gradient against the one-process step on the union
# batch: the table's (H2's f32 sums, taken in another order) within this
# of its largest entry (the smoke's kernel limit), the loss relative
PARALLEL_GRAD_TOL = 1e-5
PARALLEL_LOSS_RTOL = 1e-5
# the bf16 MLPs' ("fields"): every weight-gradient product rounds to bf16,
# so the sum of the 4 ranks' rounded products is up to 4 half-ulps of
# theirs plus one of the one-process product's from that product: 2^-6 of
# the largest entry (on an H100: one ulp at an entry of 0.1, 2.4e-3 of the
# largest)
PARALLEL_BF16_GRAD_TOL = 2.0 ** -6
PARALLEL_TIMED_ONE = 3   # one-process init steps timed after the check


def _rank_counts() -> dict:
    from gfnerf_tpu_torch.fields.packed_hash import packed_hash_encode

    return {**launch_counts(),
            "packed_hash_bwd_calls": packed_hash_encode.bwd_calls}


def parallel_digest(p) -> dict:
    """Digests of a pipeline's state: "frozen" (the field's tensors but
    the block tables, ``parallel_tensor_sums``), "octree" (the nodes,
    their block indices and occupancy statistics), "maps" (a SHA-256 of every error map its caches hold) and
    "blocks" (one per block table).  Equal states give equal digests."""
    import hashlib

    import numpy as np

    dev = parallel_tensor_sums
    state = p.field.state_dict()
    blocks = state.pop("block_feats")
    dm = p.datamanager
    caches = [dm.init_cache, dm.split_cache] + [
        v[2] for _, v in sorted(getattr(dm, "_parallel_splits", {}).items())]
    h = hashlib.sha256()
    for c in caches:
        if c is not None and c.error_maps is not None:
            h.update(np.ascontiguousarray(c.error_maps).tobytes())
    return {"frozen": dev([v for _, v in sorted(state.items())]),
            "octree": dev([getattr(p.sampler.oct_dev, k) for k in (
                "centers", "side_lens", "childs", "trans_idx", "block_idx",
                "weight_stats", "alpha_stats", "visit_cnt")]),
            "maps": h.hexdigest(),
            "blocks": [tuple(dev([b])) for b in blocks]}


def parallel_grad_check(p, comm) -> dict:
    """At the common initial state: one data-parallel init step (copies of
    the field, this rank's slice of a batch of the config's rays, the
    whole batch's noise and S3IM permutations from one seed) and, on rank
    0, the one-process step on the whole batch; the all-reduced gradients
    against the one-process ones, each within PARALLEL_GRAD_TOL of its
    group's largest, the loss within PARALLEL_LOSS_RTOL.  Then rank 0 times
    PARALLEL_TIMED_ONE one-process steps while the others wait."""
    import copy

    import numpy as np
    import torch

    from gfnerf_tpu_torch.data.pixel_samplers import PixelSampler
    from gfnerf_tpu_torch.engine.optimizers import field_param_groups
    from gfnerf_tpu_torch.fields.field import STAGE_INIT
    from gfnerf_tpu_torch.model_components.losses import s3im_permutations
    from gfnerf_tpu_torch.models.gfnerf import (init_train_state,
                                                make_train_step)
    from gfnerf_tpu_torch.parallel import make_dp_train_step

    mcfg, scfg = p.config.model, p.sampler.sampler_config
    rays = p.config.datamanager.train_num_rays_per_batch
    batch = PixelSampler(rays, seed=1234).sample(p.datamanager.init_cache)
    gen = torch.Generator(device=p.device).manual_seed(7)
    noise = (torch.rand((rays, scfg.max_samples), generator=gen,
                        device=p.device) - 0.5) + 1.0
    perms = s3im_permutations(rays, mcfg.s3im_repeat_time, generator=gen,
                              device=p.device)

    def step(fn, rows):
        field = copy.deepcopy(p.field)
        state = init_train_state(field, p.tx)
        dev_batch = p._device_batch({k: batch[k][rows] for k in (
            "rel_camera_indices", "coords", "image")})
        torch.cuda.synchronize()
        t = time.perf_counter()
        _, _, m, _ = fn(state, p.sampler.oct_dev, p.cameras_dev, dev_batch,
                        1.0, noise=noise, s3im_perms=perms)
        torch.cuda.synchronize()
        grads = {k: [q.grad.detach().clone() for q in qs
                     if q.grad is not None]
                 for k, qs in field_param_groups(field).items()}
        return float(m["loss"]), grads, time.perf_counter() - t

    r = rays // comm.size
    dp_loss, dp_grads, dp_s = step(
        make_dp_train_step(mcfg, scfg, p.tx, comm, STAGE_INIT),
        slice(comm.rank * r, (comm.rank + 1) * r))
    out = {"dp_loss": dp_loss, "dp_s": dp_s, "grad_digest": [
        dev_sum for g in sorted(dp_grads) for dev_sum in
        parallel_tensor_sums(dp_grads[g])]}
    if comm.rank == 0:
        one = make_train_step(mcfg, scfg, p.tx, STAGE_INIT)
        one_loss, one_grads, _ = step(one, slice(None))
        errs = {}
        for g, want in one_grads.items():
            if not want:
                continue
            scale = max(float(x.abs().max()) for x in want)
            worst = max(float((a - b).abs().max())
                        for a, b in zip(dp_grads[g], want))
            tol = (PARALLEL_BF16_GRAD_TOL if g == "fields"
                   and p.field_cfg.mlp_dtype == "bfloat16"
                   else PARALLEL_GRAD_TOL)
            errs[g] = {"max_abs_err": worst, "largest": scale, "tol": tol}
        bad = [g for g, e in errs.items()
               if not (e["largest"] > 0
                       and e["max_abs_err"] <= e["tol"] * e["largest"])]
        if bad or abs(dp_loss - one_loss) > PARALLEL_LOSS_RTOL * abs(
                one_loss):
            raise AssertionError(f"parallel: the data-parallel step against "
                                 f"one process: loss {dp_loss!r} vs "
                                 f"{one_loss!r}, gradients {errs}")
        out.update(one_loss=one_loss, grad_errs=errs,
                   one_s=[step(one, slice(None))[2]
                          for _ in range(PARALLEL_TIMED_ONE)])
    comm.barrier()
    return out


def parallel_tensor_sums(ts) -> list:
    """Two sums of each tensor's bits on the card (of its int32 view, or
    its values widened where its elements are not 4 bytes): the sum and
    the index-weighted sum; equal tensors give equal sums."""
    import torch

    sums = []
    for t in ts:
        t = t.detach().reshape(-1).contiguous()
        x = (t.view(torch.int32) if t.element_size() == 4
             else t.to(torch.int64)).long()
        w = torch.arange(x.numel(), device=x.device) % 65521 + 1
        sums += [x.sum(), (x * w).sum()]
    return torch.stack(sums).tolist() if sums else []


def parallel_rank(rank, world, port, out, backend, scene):
    """One rank of the parallel phase, launched as ``torch.distributed.run``
    launches ``gfnerf_tpu_torch.train`` (its environment, then
    ``train.build_trainer``): the gradient check at the initial state,
    then the Trainer's run, each step counted, timed and digested; writes
    what it saw to OUT/rank{rank}.pt."""
    import os

    sys.path.insert(0, str(REPO))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    from gfnerf_tpu_torch.parallel import comm as pcomm
    from gfnerf_tpu_torch.train import build_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    argv = ["gf-nerf-perf", "--data", scene, "--output-dir",
            str(Path(out) / "runs"), "--experiment-name", "parallel",
            "--parallel-blocks", "--dist-backend", backend,
            "--dist-timeout", str(PARALLEL_GROUP_TIMEOUT),
            "--max-num-iterations", str(PARALLEL_STEPS),
            *[f"{k}={v}" for k, v in PARALLEL_OVERRIDES.items()]]
    try:
        t0 = time.perf_counter()
        trainer = build_trainer(argv)
        p, comm = trainer.pipeline, trainer.comm
        rec = {"setup_s": time.perf_counter() - t0, "backend": comm.backend,
               "device": torch.cuda.current_device(),
               "coords": p.grid.coords(comm.rank),
               "n_block_axis": p.n_block_axis,
               "grad_check": parallel_grad_check(p, comm),
               "steps": {}, "digests": {}, "syncs": []}
        get_loss, after = p.get_train_loss_dict, p.after_train_iteration
        sync = p.sync_block_tables

        def get_loss_w(step):
            before = _rank_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            m = get_loss(step)
            torch.cuda.synchronize()
            now = _rank_counts()
            rec["steps"][step] = {
                "s": time.perf_counter() - t, "metrics": m,
                "launches": {k: now[k] - before[k] for k in now},
                "nodes": p.sampler.tree.n_nodes}
            return m

        def after_w(step):
            t = time.perf_counter()
            after(step)
            rec["steps"][step]["after_s"] = time.perf_counter() - t
            rec["digests"][step] = parallel_digest(p)

        def sync_w():
            sync()
            rec["syncs"].append((max(rec["steps"], default=-1),
                                 parallel_digest(p)["blocks"]))

        # each collective timed (the card synchronised around it): seconds
        # and bytes a step
        coll = {"s": 0.0, "bytes": 0}
        groups = [comm] + ([p._data_comm] if p._parallel else [])
        for c in groups:
            for name in ("all_reduce", "all_gather", "broadcast"):
                def timed(*a, _fn=getattr(c, name), **k):
                    torch.cuda.synchronize()
                    t = time.perf_counter()
                    out = _fn(*a, **k)
                    torch.cuda.synchronize()
                    coll["s"] += time.perf_counter() - t
                    coll["bytes"] += a[0].numel() * a[0].element_size()
                    return out
                setattr(c, name, timed)

        def get_loss_c(step):
            coll.update(s=0.0, bytes=0)
            m = get_loss_w(step)
            rec["steps"][step].update(coll_s=coll["s"],
                                      coll_bytes=coll["bytes"])
            return m

        p.get_train_loss_dict, p.after_train_iteration = get_loss_c, after_w
        p.sync_block_tables = sync_w
        reset_launch_counts()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        rec.update(train_s=time.perf_counter() - t0,
                   launches=launch_counts(),
                   peak_bytes=torch.cuda.max_memory_allocated(),
                   base_dir=str(trainer.base_dir),
                   labels=p.sampler.cameras_labels.tolist(),
                   end=parallel_digest(p))
        torch.save(rec, Path(out) / f"rank{rank}.pt")
    except BaseException:
        # the parent reports the first rank to fail, often one that lost
        # its peer: each rank logs its own error
        import traceback

        log(f"[parallel] rank {rank} failed:\n{traceback.format_exc()}")
        raise
    finally:
        pcomm.shutdown()


def spawn_ranks(fn, out: Path, scene: Path, backend: str, world: int,
                join_s: float, what: str, saved=None) -> list:
    """``world`` spawned processes of ``fn(rank, world, port, out,
    backend, scene)``, a free port of this host for their rendezvous,
    killed past ``join_s`` seconds (a TimeoutError naming ``what``); the
    records OUT/rank{k}.pt of the ranks ``saved`` (all by default)."""
    import socket

    import torch
    import torch.multiprocessing as mp

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        fn, args=(world, port, str(out), backend, str(scene)),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + join_s
    while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
        if time.monotonic() >= deadline:
            for proc in ctx.processes:
                proc.kill()
            raise TimeoutError(f"{what}: {world} ranks under {backend} "
                               f"outlasted {join_s} s")
    return [torch.load(out / f"rank{k}.pt", weights_only=False)
            for k in (range(world) if saved is None else saved)]


def run_parallel_ranks(out: Path, scene: Path, backend: str) -> list:
    """PARALLEL_WORLD spawned ranks under ``backend``; their records."""
    return spawn_ranks(parallel_rank, out, scene, backend, PARALLEL_WORLD,
                       PARALLEL_JOIN_S, "parallel")


def check_parallel_ranks(ranks: list, backend: str, table_grad_calls: int
                         ) -> dict:
    """The checks of one run of the ranks (see phase_parallel); returns its
    figures."""
    import numpy as np

    tag = f"[parallel {backend}]"
    steps = range(PARALLEL_STEPS)
    rank0 = ranks[0]
    if rank0["n_block_axis"] != 2 or sorted(
            rk["coords"] for rk in ranks) != [(0, 0), (0, 1), (1, 0),
                                              (1, 1)]:
        raise AssertionError(f"{tag} grid {[rk['coords'] for rk in ranks]}")
    # the gradient check
    gc = rank0["grad_check"]
    if len({tuple(rk["grad_check"]["grad_digest"]) for rk in ranks}) != 1:
        raise AssertionError(f"{tag} the all-reduced gradients differ "
                             "between ranks")
    log(f"{tag} one data-parallel init step against one process on the "
        f"union batch (8192 rays): loss {gc['dp_loss']!r} vs "
        f"{gc['one_loss']!r}; gradients, max abs error / largest entry: "
        + ", ".join(f"{g} {e['max_abs_err']:.3g} / {e['largest']:.3g} "
                    f"(limit {e['tol']} of the largest)"
                    for g, e in gc["grad_errs"].items())
        + "; the all-reduced gradients bit-identical on every rank")
    # digests after every step: the frozen tensors, the octree and the
    # error maps on every rank; each table on its group's data ranks
    for step in steps:
        ds = [rk["digests"][step] for rk in ranks]
        for key in ("frozen", "octree", "maps"):
            if len({json.dumps(d[key]) for d in ds}) != 1:
                raise AssertionError(f"{tag} step {step}: {key} differs "
                                     "between ranks")
        for g in range(2):
            mates = [d["blocks"] for rk, d in zip(ranks, ds)
                     if rk["coords"][1] == g]
            if mates[0] != mates[1]:
                raise AssertionError(f"{tag} step {step}: group {g}'s "
                                     "data ranks differ")
        if step < PARALLEL_INIT_STEPS + 1 and len(
                {json.dumps(d["blocks"]) for d in ds}) != 1:
            raise AssertionError(f"{tag} step {step}: tables differ")
    syncs = [rk["syncs"] for rk in ranks]
    if any(s != syncs[0] for s in syncs[1:]):
        raise AssertionError(f"{tag} the synced tables differ")
    first = PARALLEL_INIT_STEPS
    want_at = [first] + [first + 1 + 2 * k for k in range(4)] + [
        PARALLEL_STEPS - 1]
    at = [s for s, _ in syncs[0]]
    # a sync at each phase's first concurrent step, then the eval's and
    # the checkpoint's (nothing new to send)
    if at[:len(want_at)] != want_at:
        raise AssertionError(f"{tag} syncs after steps {at}")
    marks = [(first - 1, rank0["digests"][first - 1]["blocks"])] + \
        syncs[0][1:len(want_at)]
    moved = [[b for b in range(10) if x[b] != y[b]]
             for (_, x), (_, y) in zip(marks, marks[1:])]
    log(f"{tag} blocks moved in each phase: {moved}")
    if moved != [[p, p + 5] for p in range(5)]:
        raise AssertionError(f"{tag} blocks moved by phase {moved}")
    # from the last init step (the octree: from the transition, which
    # uploads the block indices) to the end
    frozen = [s for s in range(first, PARALLEL_STEPS)
              if rank0["digests"][s]["frozen"]
              != rank0["digests"][first - 1]["frozen"]]
    octree = [s for s in range(first + 1, PARALLEL_STEPS)
              if rank0["digests"][s]["octree"]
              != rank0["digests"][first]["octree"]]
    if frozen or octree:
        raise AssertionError(f"{tag} at the focal stage the frozen "
                             f"parameters moved at steps {frozen}, the "
                             f"octree at {octree}")
    # launches a step, on every rank
    per_step = {}
    for rk in ranks:
        for s in steps:
            got = rk["steps"][s]["launches"]
            focal = s >= first
            want = {"composite_fwd": 1, "composite_bwd": 1,
                    "packed_hash_fwd": 2 if focal else 1,
                    "packed_hash_bwd": table_grad_calls,
                    "packed_hash_bwd_calls": 1}
            want = {k: want.get(k, 0) for k in got}
            if got != want:
                raise AssertionError(f"{tag} rank {rk['coords']} step {s}: "
                                     f"launches {got}, expected {want}")
            per_step[("focal" if focal else "init")] = got
    log(f"{tag} launches a step on each rank: {per_step}")
    losses = [rank0["steps"][s]["metrics"]["loss"] for s in steps]
    if not np.all(np.isfinite(losses)):
        raise AssertionError(f"{tag} losses {losses}")
    for s in range(first + 1, PARALLEL_STEPS):
        m = rank0["steps"][s]["metrics"]
        p = (s - first) // 2
        if not {f"block_{p}_loss", f"block_{p + 5}_loss"} <= set(m):
            raise AssertionError(f"{tag} step {s} metrics {sorted(m)}")
    log(f"{tag} losses {[round(x, 5) for x in losses]}")
    nodes = [rank0["steps"][s]["nodes"] for s in steps]
    grown = [s for s in range(1, first) if nodes[s] != nodes[s - 1]]
    log(f"{tag} octree nodes after each step {nodes}; camera clusters "
        f"{np.bincount(rank0['labels'], minlength=10).tolist()}")
    if grown != [4] or len(set(map(tuple, (rk["labels"]
                                             for rk in ranks)))) != 1:
        raise AssertionError(f"{tag} the milestone rebuild changed the "
                             f"tree at {grown}; or the labels differ")
    init = [s for s in range(2, first) if s != 4]
    focal = range(first + 2, PARALLEL_STEPS)
    init_s = [rank0["steps"][s]["s"] for s in init]
    focal_s = [rank0["steps"][s]["s"] for s in focal]
    coll = {stage: {"s": _mean([rank0["steps"][s]["coll_s"] for s in ss]),
                    "bytes": _mean([rank0["steps"][s]["coll_bytes"]
                                    for s in ss])}
            for stage, ss in (("init", init), ("focal", focal))}
    log(f"{tag} rank 0's time in collectives a step (the card "
        f"synchronised around each; the wait for the other ranks "
        f"included): init {coll['init']['s']:.4f} s for "
        f"{coll['init']['bytes'] / 2**20:.2f} MiB, focal "
        f"{coll['focal']['s']:.4f} s for "
        f"{coll['focal']['bytes'] / 2**20:.2f} MiB")
    return {"backend": backend, "setup_s": rank0["setup_s"],
            "collectives_per_step": coll,
            "train_s": rank0["train_s"],
            "init_s_per_step": _mean(init_s),
            "focal_s_per_step": _mean(focal_s),
            "one_process_init_s_per_step": _mean(gc["one_s"]),
            "transition_s": rank0["steps"][first]["after_s"],
            "peak_bytes": [rk["peak_bytes"] for rk in ranks],
            "devices": [rk["device"] for rk in ranks],
            "grad_errs": gc["grad_errs"],
            "loss_vs_one": [gc["dp_loss"], gc["one_loss"]],
            "launches": {k: sum(rk["launches"][k] for rk in ranks)
                         for k in rank0["launches"]}}


# The viewer over the parallel run's 4 ranks, config and scene, launched
# as ``torch.distributed.run`` would launch ``train ... --vis viewer
# viewer_port=0``: rank 0 serves it; this process drives it over HTTP into
# the concurrent focal stage (PARALLEL_VIEWER_AT steps taken): pause,
# render A, PARALLEL_VIEWER_HELD_S in which no rank may step, resume, a
# render while training (its sync at the next step boundary), 2 more
# steps, pause, render B (a training camera of the block the other group
# trains in that phase), stop.  Renders at PARALLEL_VIEWER_WH.
PARALLEL_VIEWER_AT = PARALLEL_INIT_STEPS + 2
PARALLEL_VIEWER_HELD_S = 1.0
PARALLEL_VIEWER_WH = (640, 480)
PARALLEL_VIEWER_OVERRIDES = {**PARALLEL_OVERRIDES,
                             "steps_per_eval_image": "1000000",
                             "steps_per_save": "1000000",
                             "steps_per_log": "1"}


def parallel_viewer_rank(rank, world, port, out, backend, scene):
    """One rank of the viewer drive (``train.build_trainer`` with ``--vis
    viewer viewer_port=0``): rank 0 writes its viewer's port and grid
    coordinates to OUT/viewer.json; every rank records each step's
    wall-clock start and end, each sync of the block tables (the step in
    flight or last taken, the tables' digests), the seconds of each
    control broadcast (``TrainControl.agree``), the launch counts of its
    run and its final state's digests; rank 0 also the tables of the
    blocks trained in the last phase, as that phase's first step synced
    them.  Writes OUT/rank{rank}.pt."""
    import os

    sys.path.insert(0, str(REPO))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    from gfnerf_tpu_torch.parallel import comm as pcomm
    from gfnerf_tpu_torch.train import build_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    argv = ["gf-nerf-perf", "--data", scene, "--output-dir",
            str(Path(out) / "runs"), "--experiment-name", "viewer",
            "--parallel-blocks", "--dist-backend", backend,
            "--dist-timeout", str(PARALLEL_GROUP_TIMEOUT),
            "--max-num-iterations", "100000", "--vis", "viewer",
            "viewer_port=0",
            *[f"{k}={v}" for k, v in PARALLEL_VIEWER_OVERRIDES.items()]]
    try:
        trainer = build_trainer(argv)
        p, comm = trainer.pipeline, trainer.comm
        rec = {"steps": {}, "syncs": [], "agree": [],
               "serves": trainer.viewer is not None,
               "coords": p.grid.coords(comm.rank)}
        state = {"in_step": None, "last": -1, "phase": None}
        get_loss, sync = p.get_train_loss_dict, p.sync_block_tables
        agree = trainer.control.agree

        def get_loss_w(step):
            t0 = time.time()
            state["in_step"] = step
            m = get_loss(step)
            torch.cuda.synchronize()
            state.update(in_step=None, last=step)
            rec["steps"][step] = {"t0": t0, "t1": time.time(),
                                  "loss": m["loss"]}
            return m

        def sync_w():
            sync()
            step = state["in_step"]
            inside = step is not None
            rec["syncs"].append((step if inside else state["last"], inside,
                                 parallel_digest(p)["blocks"]))
            if inside and rank == 0:
                state["phase"] = (step, {
                    b: p.field.block_feats[b].detach().cpu().clone()
                    for b in p.parallel_active_blocks(step)})

        def agree_w(c):
            torch.cuda.synchronize()
            t = time.perf_counter()
            got = agree(c)
            rec["agree"].append({"after": state["last"], "paused": got.paused,
                                 "sync": got.sync,
                                 "s": time.perf_counter() - t})
            return got

        p.get_train_loss_dict, p.sync_block_tables = get_loss_w, sync_w
        trainer.control.agree = agree_w
        if rank == 0:
            info = Path(out) / "viewer.json"
            info.with_suffix(".tmp").write_text(json.dumps({
                "port": trainer.viewer.port, "coords": rec["coords"],
                "n_block_axis": p.n_block_axis,
                "n_blocks": p.config.model.n_blocks}))
            os.replace(info.with_suffix(".tmp"), info)
        reset_launch_counts()
        t0 = time.perf_counter()
        trainer.train()
        torch.cuda.synchronize()
        rec.update(train_s=time.perf_counter() - t0,
                   launches=launch_counts(), base_dir=str(trainer.base_dir),
                   phase_start=state["phase"], end=parallel_digest(p))
        torch.save(rec, Path(out) / f"rank{rank}.pt")
    except BaseException:
        import traceback

        log(f"[parallel viewer] rank {rank} failed:\n"
            f"{traceback.format_exc()}")
        raise
    finally:
        pcomm.shutdown()


def run_parallel_viewer(out: Path, scene: Path, backend: str) -> tuple:
    """The viewer drive under ``backend`` (see PARALLEL_VIEWER_AT): the
    ranks' records, and what this process saw and timed."""
    import socket

    import torch
    import torch.multiprocessing as mp

    from gfnerf_tpu_torch.utils.image_io import decode_png

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out.mkdir(parents=True, exist_ok=True)
    ctx = mp.start_processes(
        parallel_viewer_rank, args=(PARALLEL_WORLD, port, str(out), backend,
                                    str(scene)),
        nprocs=PARALLEL_WORLD, join=False, start_method="spawn")
    deadline = time.monotonic() + PARALLEL_JOIN_S
    seen = {}
    try:
        def until(cond):
            while not cond():
                if ctx.join(timeout=0):
                    raise AssertionError("parallel viewer: the ranks ended "
                                         "before the stop")
                if time.monotonic() >= deadline:
                    raise TimeoutError(f"parallel viewer: {backend} ranks "
                                       f"outlasted {PARALLEL_JOIN_S} s")
                time.sleep(0.02)

        info = out / "viewer.json"
        until(info.exists)
        doc = json.loads(info.read_text())
        base = f"http://127.0.0.1:{doc['port']}"

        def status():
            return json.loads(_http(base + "/status"))

        def render(c2w, key):
            w, h = PARALLEL_VIEWER_WH
            req = {"c2w": c2w, "width": w, "height": h}
            t = time.perf_counter()
            png = _http(base + "/render", req)
            seen[key + "_s"] = time.perf_counter() - t
            seen[key] = decode_png(png)
            return req

        until(lambda: status().get("step", -1) >= PARALLEL_VIEWER_AT)
        cams = json.loads(_http(base + "/scene"))["cameras"]
        _http(base + "/control", {"action": "pause"})
        until(lambda: status()["held"])
        held_at = int(status()["step"])
        t0 = time.time()
        time.sleep(PARALLEL_VIEWER_HELD_S)
        seen["no_step_window"] = (t0, time.time())
        render(cams[0]["c2w"], "render_a")
        seen["held"] = (held_at, int(status()["step"]))
        _http(base + "/control", {"action": "resume"})
        until(lambda: status()["step"] > held_at)
        render(cams[1]["c2w"], "render_c")
        resumed = status()["step"]
        until(lambda: status()["step"] >= resumed + 2)
        _http(base + "/control", {"action": "pause"})
        until(lambda: status()["held"])
        step_b = int(status()["step"])
        # the block the other group trains in step_b's phase
        bps = doc["n_blocks"] // doc["n_block_axis"]
        phase = (max(step_b - PARALLEL_INIT_STEPS, 0) // 2) % bps
        block = (1 - doc["coords"][1]) * bps + phase
        cam = next(c for c in cams if c["cluster"] == block)
        seen.update(step_b=step_b, block_b=block, camera_b=cam["index"],
                    req_b=render(cam["c2w"], "render_b"))
        _http(base + "/control", {"action": "stop"})
        while not ctx.join(timeout=max(deadline - time.monotonic(), 0.0)):
            if time.monotonic() >= deadline:
                raise TimeoutError(f"parallel viewer: {backend} ranks "
                                   f"outlasted {PARALLEL_JOIN_S} s")
    except BaseException:
        for proc in ctx.processes:
            if proc.is_alive():
                proc.kill()
        raise
    return [torch.load(out / f"rank{k}.pt", weights_only=False)
            for k in range(PARALLEL_WORLD)], seen


def check_parallel_viewer(ranks: list, seen: dict, backend: str) -> tuple:
    """The viewer drive's checks: no rank stepped while held; every rank
    took the same steps and the same syncs (the phases', the pauses' and
    the render's while training, the checkpoint's); one checkpoint, rank
    0's, whose one-card load holds every rank's final state; render B
    equal, pixel for pixel, to the one-card render of that checkpoint at
    the same request, and unlike a render with that block's table as the
    phase's first step synced it; K1, K2, H1 and H2 launched on the ranks
    and no other kernel.  Returns (launches, figures)."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.utils.eval_utils import eval_setup
    from gfnerf_tpu_torch.utils.image_io import decode_png
    from gfnerf_tpu_torch.viewer.server import ViewerServer

    tag = f"[parallel viewer {backend}]"
    fails = []
    rank0 = ranks[0]
    steps = sorted(rank0["steps"])
    t0, t1 = seen["no_step_window"]
    stepped = {k: [s for s, r in rk["steps"].items() if t0 <= r["t0"] <= t1]
               for k, rk in enumerate(ranks)}
    if any(stepped.values()) or seen["held"][0] != seen["held"][1]:
        fails.append(f"steps while held: {stepped}, {seen['held']}")
    if steps != list(range(len(steps))) or any(
            sorted(rk["steps"]) != steps for rk in ranks):
        fails.append("the ranks took different steps")
    if [rk["serves"] for rk in ranks] != [True, False, False, False]:
        fails.append("a rank other than 0 serves")
    syncs = rank0["syncs"]
    if any(rk["syncs"] != syncs for rk in ranks[1:]):
        fails.append("the ranks' syncs differ")
    boundary = [s for s, inside, _ in syncs if not inside]
    held_at = seen["held"][0]
    if not (held_at in boundary and seen["step_b"] in boundary
            and any(held_at < s < seen["step_b"] for s in boundary)):
        fails.append(f"syncs at boundaries after steps {boundary}: not the "
                     f"pauses' ({held_at}, {seen['step_b']}) and the "
                     "render's between them")
    base = Path(rank0["base_dir"])
    ckpts = sorted(c.name for c in (base / "nerfstudio_models").iterdir())
    if ckpts != [f"step-{steps[-1]:09d}"]:
        fails.append(f"checkpoints {ckpts} after steps up to {steps[-1]}")
    t = time.perf_counter()
    _, trainer = eval_setup(base / "config.json")
    setup_s = time.perf_counter() - t
    p = trainer.pipeline
    loaded = parallel_digest(p)
    for rk in ranks:
        if (rk["end"]["frozen"], rk["end"]["blocks"]) != (
                loaded["frozen"], loaded["blocks"]):
            fails.append(f"rank {rk['coords']}'s final state is not the "
                         "checkpoint's")
    server = ViewerServer(p, port=0)
    t = time.perf_counter()
    want = decode_png(server._render(seen["req_b"]))
    one_s = time.perf_counter() - t
    got = seen["render_b"]
    diff = int(np.abs(got.astype(int) - want.astype(int)).max())
    step, tables = rank0["phase_start"]
    block = seen["block_b"]
    with torch.no_grad():
        p.field.block_feats[block].copy_(tables[block].to(p.device))
    stale = decode_png(server._render(seen["req_b"]))
    stale_px = int((stale != got).any(-1).sum())
    w, h = PARALLEL_VIEWER_WH
    log(f"{tag} render B (block {block}, camera {seen['camera_b']}, paused "
        f"after step {seen['step_b']}) against the one-card render of "
        f"{ckpts}: max abs pixel difference {diff} (limit 0); with block "
        f"{block}'s table as step {step} synced it, {stale_px} of {w * h} "
        f"pixels differ (must be > 0)")
    if diff or got.shape != (h, w, 3):
        fails.append(f"render B differs from the one-card render by {diff}")
    if not stale_px:
        fails.append("render B equals the render with the phase's first "
                     "table: the check cannot see the sync")
    for key in ("render_a", "render_c"):
        if seen[key].shape != (h, w, 3) or not seen[key].std() > 0:
            fails.append(f"{key} {seen[key].shape}")
    launches = {k: sum(rk["launches"][k] for rk in ranks)
                for k in rank0["launches"]}
    try:
        check_path_kernels(f"parallel viewer {backend}", launches,
                           QUALITY_KERNELS)
    except AssertionError as e:
        fails.append(str(e))
    if fails:
        raise AssertionError(f"{tag} " + "; ".join(fails))
    plain = [a["s"] for a in rank0["agree"]
             if not (a["paused"] or a["sync"])]
    focal = [rank0["steps"][s]["t1"] - rank0["steps"][s]["t0"]
             for s in steps if s > PARALLEL_INIT_STEPS + 1]
    figures = {"render_paused_s": seen["render_a_s"],
               "render_training_s": seen["render_c_s"],
               "render_b_s": seen["render_b_s"], "one_card_render_s": one_s,
               "control_broadcast_s_mean": _mean(plain),
               "control_broadcast_s_median": float(np.median(plain)),
               "control_broadcasts": len(rank0["agree"]),
               "focal_s_per_step": _mean(focal), "steps": len(steps),
               "syncs": len(syncs), "train_s": rank0["train_s"],
               "eval_setup_s": setup_s}
    log(f"{tag} a render at {w}x{h} over HTTP: {seen['render_a_s']:.4f} s "
        f"paused, {seen['render_c_s']:.4f} s while training (its wait for "
        f"the step boundary's sync included), {seen['render_b_s']:.4f} s "
        f"paused (render B); one card, the checkpoint: {one_s:.4f} s")
    log(f"{tag} a control broadcast on rank 0 at a step boundary (the card "
        f"synchronised before it; the wait for the other ranks included): "
        f"mean {figures['control_broadcast_s_mean']:.6f} s, median "
        f"{figures['control_broadcast_s_median']:.6f} s over {len(plain)} "
        f"boundaries that neither paused nor synced, against "
        f"{figures['focal_s_per_step']:.4f} s a concurrent focal step; "
        f"{len(steps)} steps, {len(syncs)} syncs on every rank; "
        f"launches {launches}")
    return launches, figures


def phase_parallel(tmp: Path):
    """gf-nerf-perf over 4 ranks with ``parallel_blocks`` (data 2 x block 2)
    through the Trainer, launched as ``torch.distributed.run`` would: under
    gloo on one card and, where the machine has 4 cards, under NCCL with a
    card per rank.  Checked: at the initial state one data-parallel init
    step against one process on the union batch (the all-reduced
    gradients within PARALLEL_GRAD_TOL of each group's largest, the loss
    within PARALLEL_LOSS_RTOL; the all-reduced gradients bit-identical on
    every rank); after every step the frozen tensors, the octree and the
    error maps equal on every rank, each table on its group's data ranks,
    every table on every rank after each sync; in each phase exactly
    blocks {p, p + 5} move, the frozen parameters and the octree not; per
    rank and step K1, K2 and H2 (one call) once, H1 once at init and twice
    at the focal stage; rank 0's checkpoint, loaded into a one-card
    Trainer, equal to the ranks' final state, resumed for 2 steps and
    evaluated.  Then under each backend the viewer over the 4 ranks
    (``run_parallel_viewer``, ``check_parallel_viewer``): paused, rendered,
    resumed and stopped over HTTP.  Where the machine has 2 or more cards,
    the NCCL window leg (``phase_parallel_window``): a data-parallel
    window of 8 steps captured with its collectives, against the same
    window eager and one process on the union batch, every rank
    bit-identical after it.  Printed: s/step at world 4 against one
    process, peak memory per rank, the backend; a 640x480 render's seconds
    paused and while training, a control broadcast's seconds a step, the
    phase's seconds."""
    import numpy as np
    import torch

    from gfnerf_tpu_torch.configs.config_io import apply_override
    from gfnerf_tpu_torch.configs.method_configs import get_method
    from gfnerf_tpu_torch.data.dataparsers import build_dataparser
    from gfnerf_tpu_torch.engine.trainer import Trainer
    from gfnerf_tpu_torch.fields import packed_hash
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    t_phase = time.perf_counter()
    scene = tmp / "scene"
    if not (scene / "train.npz").exists():
        make_synthetic_npz(scene, n_train=48, n_val=4, img_wh=(96, 72))
    torch.cuda.empty_cache()
    cards = torch.cuda.device_count()
    backends = ["gloo"] + (["nccl"] if cards >= PARALLEL_WORLD else [])
    if "nccl" not in backends:
        log(f"[parallel] NCCL: not run ({cards} card(s); it needs a card "
            f"per rank)")
    stats, launches = {}, None
    for backend in backends:
        t0 = time.perf_counter()
        ranks = run_parallel_ranks(tmp / f"parallel_{backend}", scene,
                                   backend)
        wall = time.perf_counter() - t0
        st = check_parallel_ranks(ranks, backend,
                                  packed_hash.table_grad_launches(1))
        st["ranks_wall_s"] = wall
        got = st.pop("launches")
        launches = got if launches is None else {
            k: launches[k] + got[k] for k in launches}
        log(f"[parallel {backend}] {PARALLEL_WORLD} ranks on cards "
            f"{st['devices']}: setup {st['setup_s']:.2f}s, the Trainer's "
            f"{PARALLEL_STEPS} steps {st['train_s']:.2f}s; "
            f"{st['init_s_per_step']:.4f} s/init step at world 4 against "
            f"{st['one_process_init_s_per_step']:.4f} for one process on "
            f"the same card and batch; {st['focal_s_per_step']:.4f} s a "
            f"concurrent focal step (2 blocks, 8192 rays each); the "
            f"transition {st['transition_s']:.2f}s; peak memory per rank "
            f"{[round(b / 2**30, 3) for b in st['peak_bytes']]} GiB; the "
            f"ranks' processes {wall:.1f}s in all")
        stats[backend] = st
        if backend == "gloo":
            base = Path(ranks[0]["base_dir"])
            final = ranks[0]["end"]
        t0 = time.perf_counter()
        got, st["viewer"] = check_parallel_viewer(*run_parallel_viewer(
            tmp / f"parallel_viewer_{backend}", scene, backend), backend)
        st["viewer"]["drive_s"] = time.perf_counter() - t0
        launches = {k: launches[k] + got[k] for k in launches}
        log(f"[parallel viewer {backend}] the drive in "
            f"{st['viewer']['drive_s']:.1f}s")

    got, stats["window"] = phase_parallel_window(tmp)
    launches = {k: launches[k] + got.get(k, 0) for k in launches}

    # rank 0's checkpoint in a one-card Trainer: the ranks' final state,
    # resumed for 2 steps, an eval image
    cfg = get_method("gf-nerf-perf")
    for key, value in {**PARALLEL_OVERRIDES,
                       "max_num_iterations": str(PARALLEL_STEPS + 2),
                       "load_dir": str(base / "nerfstudio_models")}.items():
        apply_override(cfg, key, value)
    cfg.data = scene
    cfg.output_dir = base.parent.parent.parent
    cfg.experiment_name = base.parent.parent.name
    cfg.timestamp = base.name
    trainer = Trainer(cfg, build_dataparser("minimal", scene))
    trainer.setup()
    p = trainer.pipeline
    loaded = parallel_digest(p)
    if (trainer._start_step != PARALLEL_STEPS or p.comm is not None
            or loaded["frozen"] != final["frozen"]
            or loaded["blocks"] != final["blocks"]):
        raise AssertionError("parallel: rank 0's checkpoint does not load "
                             "the ranks' final state into one card")
    resumed = {}
    get_loss = p.get_train_loss_dict

    def get_loss_w(step):
        torch.cuda.synchronize()
        t = time.perf_counter()
        resumed[step] = dict(get_loss(step))
        torch.cuda.synchronize()
        resumed[step]["s"] = time.perf_counter() - t
        return resumed[step]

    p.get_train_loss_dict = get_loss_w
    trainer.train()
    metrics, _ = p.get_eval_image_metrics_and_images(PARALLEL_STEPS + 1)
    gt = p.datamanager.next_eval_image(0)[1]["image"]
    trivial = float(-10.0 * np.log10(np.mean((gt - gt.mean(axis=(0, 1)))
                                             ** 2)))
    if sorted(resumed) != [PARALLEL_STEPS, PARALLEL_STEPS + 1] or not all(
            np.isfinite(m["loss"]) for m in resumed.values()) \
            or not np.isfinite(metrics["psnr"]):
        raise AssertionError(f"parallel: the resumed steps {resumed} or "
                             f"the eval image {metrics}")
    log(f"[parallel] rank 0's checkpoint in one card: the ranks' final "
        f"state bit for bit; resumed steps {PARALLEL_STEPS} and "
        f"{PARALLEL_STEPS + 1}: loss "
        f"{[round(m['loss'], 5) for m in resumed.values()]}, "
        f"{[round(m['s'], 4) for m in resumed.values()]} s (one process, a "
        f"sequential focal step); eval image 0: PSNR {metrics['psnr']:.4f}"
        f" against its mean image's {trivial:.4f}")
    stats.update(resumed_s=[m["s"] for m in resumed.values()],
                 eval_psnr=float(metrics["psnr"]), mean_image_psnr=trivial,
                 phase_s=time.perf_counter() - t_phase)
    log(f"[parallel] the phase in {stats['phase_s']:.1f}s")
    return launches, stats


# K steps a dispatch over NCCL ranks: gf-nerf-perf data-parallel (block
# axis 1) over 2 or 4 cards, a card per rank, 8192 rays a step split over
# the ranks, K = WINDOW_K windows at the init stage.  The checks start from
# the pipeline's initial state; then the Trainer trains
# PARALLEL_WINDOW_STEPS steps, all in windows (no milestone, no compaction
# step and one stage in them), on the same octree.
PARALLEL_WINDOW_STEPS = 3 * WINDOW_K
PARALLEL_WINDOW_OVERRIDES = {
    "pipeline.steps_per_dispatch": str(WINDOW_K),
    # the march fineness at 1 from the first window's end on (the checks
    # take the finenesses of steps K to 2K - 1)
    "pipeline.sampler.ray_march_fineness_decay_end_iter": str(WINDOW_K),
    "steps_per_eval_batch": "100000", "steps_per_eval_image": "100000",
    "steps_per_save": "100000", "steps_per_log": "100",
    **CAPTURE_TREES["bench"],
}
# timed in turns on every rank: captured windows, eager windows and
# single data-parallel steps, K each
PARALLEL_WINDOW_TIMED = 2
# The parameters after a window over the ranks: Adam's eps of 1e-15 turns
# any near-zero gradient into a whole learning-rate step of its sign, so a
# gradient summed in another order (the ranks' sums against one
# process's) moves an entry by up to 2 lr a step.  An eager window of the
# data-parallel step sits up to 38.6% of a tensor's entries past
# WINDOW_ENTRY_ATOL from one process on the union batch after 8 steps (4
# H100s of one host, 8192 rays).  So against one process each tensor of
# the captured window is held to at most WINDOW_MAX apart (8 steps of the
# largest learning rate) and to at most WINDOW_SHARE of its entries more
# than the eager window's spread.  Captured against eager, from the same
# draws, every loss and parameter must be equal bit for bit.
# seconds a collective (or a window's replayed ones) may wait, and the
# ranks' whole run
PARALLEL_WINDOW_GROUP_TIMEOUT = 120.0
PARALLEL_WINDOW_JOIN_S = 300.0


def parallel_window_world(cards: int) -> int:
    """The ranks of the NCCL window leg on a machine of ``cards`` cards: 4
    where there are 4, else 2 (the batch's 8192 rays split evenly); 0
    below 2 cards."""
    return 4 if cards >= 4 else (2 if cards >= 2 else 0)


class _recorded_updates:
    """Within the block, the gradients the first ``tx.update`` call of the
    optimizer ``tx`` receives (the window's first step, eager), cloned."""

    def __init__(self, tx):
        self.tx, self.grads = tx, None

    def __enter__(self):
        update = type(self.tx).update

        def recording(grads, opt_state, params):
            if self.grads is None:
                self.grads = {k: [None if g is None else g.detach().clone()
                                  for g in gs] for k, gs in grads.items()}
            return update(self.tx, grads, opt_state, params)

        self.tx.update = recording
        return self

    def __exit__(self, *exc):
        del self.tx.update


class _counted_collectives:
    """Within the block, the calls of ``comm``'s collectives."""

    def __init__(self, comm):
        self.comm, self.calls = comm, 0

    def __enter__(self):
        for name in ("all_reduce", "all_gather", "broadcast"):
            def counted(*a, _fn=getattr(type(self.comm), name), **k):
                self.calls += 1
                return _fn(self.comm, *a, **k)
            setattr(self.comm, name, counted)
        return self

    def __exit__(self, *exc):
        for name in ("all_reduce", "all_gather", "broadcast"):
            delattr(self.comm, name)


def nccl_kernels(prof) -> int:
    """The NCCL kernels' records in a ``profile_device`` trace (not the
    ``nccl:...`` annotations the profiler mirrors on the device)."""
    return sum(c for key, c in prof["kernel_counts"].items()
               if key.startswith(("ncclDevKernel", "ncclKernel")))


def parallel_window_checks(p, comm) -> dict:
    """The window over the ranks of ``comm`` from the pipeline ``p``'s
    initial state (copies of it), every rank in lockstep: a window of
    WINDOW_K data-parallel steps captured and replayed against the same
    window run eagerly (twice: their spread), from the same draws; on
    rank 0 the window of one
    process on the union batch from the same draws (the others wait); the
    collectives of an eager step (calls, and NCCL kernels in its trace)
    against a replayed window's per step; timed in turns: captured and
    eager windows and single steps; a replayed window's busy share; peak
    memory at K = 1 and K = WINDOW_K.  Returns what the parent checks."""
    import copy

    import torch

    from gfnerf_tpu_torch.data.pixel_samplers import PixelSampler
    from gfnerf_tpu_torch.fields.field import STAGE_INIT
    from gfnerf_tpu_torch.model_components.losses import s3im_permutations
    from gfnerf_tpu_torch.models.gfnerf import (TrainState,
                                                make_multi_train_step,
                                                window_mode)
    from gfnerf_tpu_torch.utils.profiling import profile_device

    k = WINDOW_K
    mcfg, scfg = p.config.model, p.sampler.sampler_config
    rays = p.config.datamanager.train_num_rays_per_batch
    r = rays // comm.size
    mine = slice(comm.rank * r, (comm.rank + 1) * r)
    keys = ("rel_camera_indices", "coords", "image")
    n_windows = 3 + 2 * PARALLEL_WINDOW_TIMED + 1
    sampler = PixelSampler(rays, seed=4321)
    union = [sampler.sample(p.datamanager.init_cache)
             for _ in range(n_windows * k)]
    fines = [p.sampler.fineness(k + i) for i in range(k)]

    def staged(i, rows):
        batches, fine, _ = p._stage_window(
            [{key: b[key][rows] for key in keys}
             for b in union[i * k:(i + 1) * k]], fines, None)
        return batches, fine

    windows = [staged(i, mine) for i in range(n_windows)]
    gen = torch.Generator(device=p.device).manual_seed(97)   # every rank

    def draws():
        return {"noise": torch.rand((k, rays, scfg.max_samples),
                                    generator=gen, device=p.device) + 0.5,
                "s3im_perms": torch.stack([s3im_permutations(
                    rays, mcfg.s3im_repeat_time, generator=gen,
                    device=p.device) for _ in range(k)])}

    def state_copy():
        return (TrainState(field=copy.deepcopy(p.field),
                           opt_state=copy.deepcopy(p.state.opt_state),
                           step=p.state.step),
                copy.deepcopy(p.sampler.oct_dev))

    def sync():
        if p.device.type == "cuda":
            torch.cuda.synchronize()

    dp = make_multi_train_step(mcfg, scfg, p.tx, STAGE_INIT, k, comm)
    mode = window_mode(p.device, comm)

    # the same draws, eager twice and captured
    d0 = draws()
    es, eo = state_copy()
    es, eo, em, _ = dp(es, eo, p.cameras_dev, *windows[0], draws=d0,
                       graph=False)
    es2, eo2 = state_copy()
    es2, eo2, em2, _ = dp(es2, eo2, p.cameras_dev, *windows[0], draws=d0,
                          graph=False)
    eager_spread = _params_apart(es2.field, es.field)
    del es2, eo2
    gs, go = state_copy()
    with _recorded_updates(p.tx) as rec:
        gs, go, gm, _ = dp(gs, go, p.cameras_dev, *windows[0], draws=d0)
    dp_grads = rec.grads
    sync()
    out = {"mode": mode, "captures": dp.captures,
           "eager_losses": em["loss"].tolist(),
           "eager2_losses": em2["loss"].tolist(),
           "eager_vs_eager": eager_spread,
           "graph_losses": gm["loss"].tolist(),
           "graph_vs_eager": _params_apart(gs.field, es.field)}
    # every rank's state after the captured window
    opt = gs.opt_state
    out["digest"] = {
        "params": parallel_tensor_sums(
            [v for _, v in sorted(gs.field.state_dict().items())]),
        "opt": parallel_tensor_sums(
            [x for part in (opt.mu, opt.nu) for _, xs in sorted(part.items())
             for x in xs if x is not None]
            + [torch.as_tensor(getattr(opt, n), device=p.device) for n in
               ("count", "total_notfinite", "last_finite")]),
        "octree": parallel_tensor_sums([getattr(go, n) for n in (
            "weight_stats", "alpha_stats", "visit_cnt", "trans_idx")])}

    # one process on the union batch (rank 0), from the same draws
    if comm.rank == 0:
        one = make_multi_train_step(mcfg, scfg, p.tx, STAGE_INIT, k)
        os_, oo = state_copy()
        with _recorded_updates(p.tx) as rec:
            os_, oo, om, _ = one(os_, oo, p.cameras_dev,
                                 *staged(0, slice(None)), draws=d0)
        sync()
        errs = {}
        for g, want in rec.grads.items():
            want = [x for x in want if x is not None]
            if not want:
                continue
            got = [x for x in dp_grads[g] if x is not None]
            scale = max(float(x.abs().max()) for x in want)
            tol = (PARALLEL_BF16_GRAD_TOL if g == "fields"
                   and p.field_cfg.mlp_dtype == "bfloat16"
                   else PARALLEL_GRAD_TOL)
            errs[g] = {"max_abs_err": max(float((a - b).abs().max())
                                          for a, b in zip(got, want)),
                       "largest": scale, "tol": tol}
        out.update(one_losses=om["loss"].tolist(), grad_errs=errs,
                   one_vs_dp=_params_apart(gs.field, os_.field),
                   one_vs_eager=_params_apart(es.field, os_.field))
        one.reset()
        del os_, oo, one
    del es, eo
    comm.barrier()

    # the collectives of one eager step against a replayed window's
    step_fn = p._train_step[STAGE_INIT]
    b1, f1 = windows[1]
    d1 = draws()

    def eager_step(i=0):
        nonlocal gs, go
        gs, go, _, _ = step_fn(gs, go, p.cameras_dev,
                               {key: v[i] for key, v in b1.items()},
                               f1[i], noise=d1["noise"][i],
                               s3im_perms=d1["s3im_perms"][i])

    def window(i, graph=True):
        nonlocal gs, go
        b, f = windows[i]
        gs, go, _, _ = dp(gs, go, p.cameras_dev, b, f, draws=draws(),
                          graph=graph)

    with _counted_collectives(comm) as cc:
        eager_step()
    sync()
    out["eager_step_collective_calls"] = cc.calls
    traced = {}
    if comm.rank == 0 and p.device.type == "cuda":
        traced["eager_step"] = nccl_kernels(profile_device(eager_step))
        win_s = []

        def timed_window():
            t0 = time.perf_counter()
            window(2)
            sync()
            win_s.append(time.perf_counter() - t0)

        prof = profile_device(timed_window)
        traced["replayed_window"] = nccl_kernels(prof)
        out.update(window_device_busy_ms=prof["device_busy_ms"],
                   profiled_window_s=win_s[0],
                   window_busy_share=prof["device_busy_ms"]
                   / (win_s[0] * 1e3))
    else:
        eager_step()
        window(2)
    sync()
    out["traced_nccl_kernels"] = traced

    # timed in turns: captured windows, eager windows, single steps
    turns = {"k8_graph": [], "k8_eager": [], "k1": [], "peak_k8": [],
             "peak_k8_eager": [], "peak_k1": []}

    def peak():
        if p.device.type != "cuda":
            return [0, 0]
        return [torch.cuda.max_memory_allocated(),
                torch.cuda.max_memory_reserved()]

    def reset_peak():
        sync()
        if p.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats()

    for t in range(PARALLEL_WINDOW_TIMED):
        for name, graph in (("k8_graph", True), ("k8_eager", False)):
            reset_peak()
            t0 = time.perf_counter()
            window(3 + 2 * t + (not graph), graph)
            sync()
            turns[name].append((time.perf_counter() - t0) / k)
            turns["peak_k8" if graph else "peak_k8_eager"].append(peak())
        reset_peak()
        t0 = time.perf_counter()
        for i in range(k):
            eager_step(i)
        sync()
        turns["k1"].append((time.perf_counter() - t0) / k)
        turns["peak_k1"].append(peak())
    out.update(turns)
    out["captures_after"] = dp.captures
    dp.reset()
    del gs, go
    if p.device.type == "cuda":
        torch.cuda.empty_cache()
    comm.barrier()
    return out


def parallel_window_rank(rank, world, port, out, backend, scene):
    """One rank of the NCCL window leg, launched as
    ``torch.distributed.run`` launches ``gfnerf_tpu_torch.train``
    gf-nerf-perf at K = WINDOW_K (its environment, then
    ``train.build_trainer``): ``parallel_window_checks``, then the
    Trainer's PARALLEL_WINDOW_STEPS steps, each window timed; writes what
    it saw to OUT/rank{rank}.pt.  A rank still running a minute before
    the parent's deadline prints its threads' stacks and exits."""
    import faulthandler
    import os

    faulthandler.dump_traceback_later(PARALLEL_WINDOW_JOIN_S - 60.0,
                                      exit=True)
    sys.path.insert(0, str(REPO))
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(world),
                      MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    import torch

    from gfnerf_tpu_torch.parallel import comm as pcomm
    from gfnerf_tpu_torch.train import build_trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    argv = ["gf-nerf-perf", "--data", scene, "--output-dir",
            str(Path(out) / "runs"), "--experiment-name", "parallel_window",
            "--dist-backend", backend,
            "--dist-timeout", str(PARALLEL_WINDOW_GROUP_TIMEOUT),
            "--max-num-iterations", str(PARALLEL_WINDOW_STEPS),
            *[f"{k}={v}" for k, v in PARALLEL_WINDOW_OVERRIDES.items()]]
    try:
        t0 = time.perf_counter()
        trainer = build_trainer(argv)
        p, comm = trainer.pipeline, trainer.comm
        rec = {"setup_s": time.perf_counter() - t0, "backend": comm.backend,
               "world": comm.size, "n_block_axis": p.n_block_axis,
               "device": str(p.device),
               "checks": parallel_window_checks(p, comm), "steps": {}}
        get_loss = p.get_train_loss_dict

        def get_loss_w(step):
            before = _rank_counts()
            t = time.perf_counter()
            m = get_loss(step)
            now = _rank_counts()
            rec["steps"][step] = {"s": time.perf_counter() - t,
                                  "loss": m["loss"],
                                  "launches": {n: now[n] - before[n]
                                               for n in now}}
            return m

        p.get_train_loss_dict = get_loss_w
        t0 = time.perf_counter()
        trainer.train()
        rec.update(train_s=time.perf_counter() - t0,
                   windows=(p._k_steps_scanned, p._k_steps_fallback),
                   captures=sum(fn.captures
                                for fn in p._multi_step_fns.values()),
                   end=parallel_digest(p))
        torch.save(rec, Path(out) / f"rank{rank}.pt")
        t0 = time.perf_counter()
        pcomm.shutdown()
        log(f"[parallel window] rank {rank}: the group left in "
            f"{time.perf_counter() - t0:.2f}s")
    except BaseException:
        import traceback

        log(f"[parallel window] rank {rank} failed:\n"
            f"{traceback.format_exc()}")
        raise
    finally:
        pcomm.shutdown()


def check_parallel_window(ranks: list, table_grad_calls: int) -> dict:
    """The checks of the NCCL window leg's ranks (see
    ``parallel_window_checks``), after its figures are logged; returns
    them."""
    import numpy as np

    world = len(ranks)
    backend = ranks[0]["backend"]
    tag = f"[parallel window {backend} x{world}]"
    k = WINDOW_K
    c0 = ranks[0]["checks"]
    got, want, one = c0["graph_losses"], c0["eager_losses"], \
        c0["one_losses"]
    errs = c0["grad_errs"]
    calls = {rk["checks"]["eager_step_collective_calls"] for rk in ranks}
    traced = c0["traced_nccl_kernels"]
    steps = range(PARALLEL_WINDOW_STEPS)
    window_s = [[rk["steps"][s]["s"] for s in range(0, len(steps), k)]
                for rk in ranks]

    st = {"world": world, "backend": backend,
          "setup_s": ranks[0]["setup_s"],
          "s_per_step_k8_graph": c0["k8_graph"],
          "s_per_step_k8_eager": c0["k8_eager"], "s_per_step_k1": c0["k1"],
          "window_busy_share": c0.get("window_busy_share"),
          "window_device_busy_ms": c0.get("window_device_busy_ms"),
          "profiled_window_s": c0.get("profiled_window_s"),
          "peak_k8": [rk["checks"]["peak_k8"] for rk in ranks],
          "peak_k8_eager": [rk["checks"]["peak_k8_eager"] for rk in ranks],
          "peak_k1": [rk["checks"]["peak_k1"] for rk in ranks],
          "grad_errs": errs, "losses_graph": got, "losses_eager": want,
          "losses_eager2": c0["eager2_losses"], "losses_one": one,
          "graph_vs_eager": c0["graph_vs_eager"],
          "eager_vs_eager": c0["eager_vs_eager"],
          "one_vs_graph": c0["one_vs_dp"],
          "one_vs_eager": c0["one_vs_eager"],
          "collective_calls_per_step": sorted(calls),
          "traced_nccl_kernels": traced, "trainer_window_s": window_s,
          "trainer_train_s": [rk["train_s"] for rk in ranks],
          "trainer_windows": [rk["windows"] for rk in ranks],
          "trainer_captures": [rk["captures"] for rk in ranks]}
    gib = 2.0 ** 30
    eager_peaks = st["peak_k8_eager"]
    log(f"{tag} captured against eager, the same draws: losses {got} vs "
        f"{want} (a second eager window {c0['eager2_losses']}), parameters "
        f"apart {c0['graph_vs_eager']} (two eager windows "
        f"{c0['eager_vs_eager']}); "
        f"against one process on the union batch: losses {one}, gradients"
        f" of the first step " + ", ".join(
            f"{g} {e['max_abs_err']:.3g} / {e['largest']:.3g} (limit "
            f"{e['tol']} of the largest)" for g, e in errs.items())
        + f", parameters after {k} steps apart {c0['one_vs_dp']} (the "
        f"eager window's {c0['one_vs_eager']}); "
        f"collectives a step: {sorted(calls)} calls eager, NCCL kernels "
        f"traced {traced}")
    log(f"{tag} s/step at world {world}: K={k} captured {c0['k8_graph']}, "
        f"K={k} eager {c0['k8_eager']}, K=1 {c0['k1']}; a replayed window "
        f"{c0.get('profiled_window_s')} s, device busy "
        f"{c0.get('window_device_busy_ms')} ms (share "
        f"{c0.get('window_busy_share')}, NCCL's waits included); peak GiB "
        f"allocated / reserved per rank: K={k} captured "
        f"{[[round(x / gib, 3) for x in v[-1]] for v in st['peak_k8']]}, "
        f"eager {[[round(x / gib, 3) for x in v[-1]] for v in eager_peaks]}"
        f", "
        f"K=1 {[[round(x / gib, 3) for x in v[-1]] for v in st['peak_k1']]}"
        f"; the Trainer: steps in windows and single "
        f"{st['trainer_windows']}, captures {st['trainer_captures']}, "
        f"rank 0's windows {[round(x, 4) for x in window_s[0]]} s")

    want_mode = "graph" if backend == "nccl" else "eager"
    for rk in ranks:
        c = rk["checks"]
        if rk["n_block_axis"] != 1 or rk["world"] != world:
            raise AssertionError(f"{tag} the grid: world {rk['world']}, "
                                 f"block axis {rk['n_block_axis']}")
        if c["mode"] != want_mode or (want_mode == "graph"
                                      and c["captures"] != 1):
            raise AssertionError(f"{tag} a window ran {c['mode']} with "
                                 f"{c['captures']} captures")
    # captured against eager, the same draws: bit for bit (the table
    # gradients sum in exact fixed point and NCCL's sums keep their order
    # under capture)
    if got != want:
        raise AssertionError(f"{tag} captured vs eager losses {got} against "
                             f"{want}")
    moved = {name: big for name, (_, big) in c0["graph_vs_eager"].items()
             if big != 0.0}
    if moved:
        raise AssertionError(f"{tag} captured vs eager: parameters apart, "
                             f"at most {moved}")
    for what, apart, spread in (
            ("against one process", c0["one_vs_dp"], c0["one_vs_eager"]),):
        for name, (share, big) in apart.items():
            if share > spread[name][0] + WINDOW_SHARE or big > WINDOW_MAX:
                raise AssertionError(
                    f"{tag} {what}: {name}: {share:.4g} of entries apart "
                    f"(the eager reference {spread[name][0]:.4g}), at most "
                    f"{big:.4g}")
    # every rank bit-identical after the window
    for part in ("params", "opt", "octree"):
        if len({json.dumps(rk["checks"]["digest"][part])
                for rk in ranks}) != 1:
            raise AssertionError(f"{tag} the ranks' {part} differ after "
                                 "the captured window")
    if any(rk["checks"]["graph_losses"] != got for rk in ranks):
        raise AssertionError(f"{tag} the ranks' window losses differ")
    # against one process on the union batch, after the first step
    if abs(got[0] - one[0]) > PARALLEL_LOSS_RTOL * abs(one[0]):
        raise AssertionError(f"{tag} the first step's loss {got[0]!r} "
                             f"against one process's {one[0]!r}")
    bad = [g for g, e in errs.items()
           if not (e["largest"] > 0
                   and e["max_abs_err"] <= e["tol"] * e["largest"])]
    if bad:
        raise AssertionError(f"{tag} the first step's gradients against "
                             f"one process: {errs}")
    # the collectives: an eager step's calls and NCCL kernels, a replayed
    # window's NCCL kernels per step
    if len(calls) != 1 or (traced and not (
            traced["eager_step"] == next(iter(calls))
            and traced["replayed_window"] == k * traced["eager_step"])):
        raise AssertionError(f"{tag} collectives: an eager step calls "
                             f"{calls}, its trace and a replayed "
                             f"window's hold {traced} NCCL kernels")
    # the Trainer's windows
    for rk in ranks:
        if rk["windows"] != (PARALLEL_WINDOW_STEPS, 0) or (
                want_mode == "graph" and rk["captures"] != 1):
            raise AssertionError(f"{tag} the Trainer: steps in windows and "
                                 f"single {rk['windows']}, captures "
                                 f"{rk['captures']}")
        launched = {n: sum(rk["steps"][s]["launches"][n] for s in steps)
                    for n in rk["steps"][0]["launches"]}
        want_l = {"composite_fwd": 1, "composite_bwd": 1,
                  "packed_hash_fwd": 1, "packed_hash_bwd": table_grad_calls,
                  "packed_hash_bwd_calls": 1}
        want_l = {n: PARALLEL_WINDOW_STEPS * want_l.get(n, 0)
                  for n in launched}
        if launched != want_l:
            raise AssertionError(f"{tag} the Trainer's launches {launched},"
                                 f" expected {want_l}")
    losses = [ranks[0]["steps"][s]["loss"] for s in steps]
    if not np.all(np.isfinite(losses)) or any(
            [rk["steps"][s]["loss"] for s in steps] != losses
            for rk in ranks):
        raise AssertionError(f"{tag} the Trainer's losses {losses}")
    ends = [rk["end"] for rk in ranks]
    for key in ("frozen", "octree", "blocks"):
        if len({json.dumps(e[key]) for e in ends}) != 1:
            raise AssertionError(f"{tag} the Trainer's {key} differ "
                                 "between ranks")
    return st


def phase_parallel_window(tmp: Path, backend: str = "nccl"):
    """The NCCL window leg alone (``--only parallel-window``): on a machine
    of 2 or more cards ``parallel_window_world`` ranks, a card each (see
    ``parallel_window_checks`` and ``check_parallel_window``); on one card
    it prints that it was not run and why."""
    import torch

    from gfnerf_tpu_torch.fields import packed_hash
    from gfnerf_tpu_torch.utils.synthetic import make_synthetic_npz

    launches = {name: 0 for name in launch_counts()}
    cards = torch.cuda.device_count()
    world = parallel_window_world(cards)
    if not world:
        log(f"[parallel window] NCCL: not run ({cards} card(s); it needs a "
            "card per rank, 2 or more)")
        return launches, {"run": False, "cards": cards}
    scene = tmp / "scene"
    if not (scene / "train.npz").exists():
        make_synthetic_npz(scene, n_train=48, n_val=4, img_wh=(96, 72))
    t0 = time.perf_counter()
    ranks = spawn_ranks(parallel_window_rank, tmp / "parallel_window",
                        scene, backend, world, PARALLEL_WINDOW_JOIN_S,
                        "parallel window")
    wall = time.perf_counter() - t0
    st = check_parallel_window(ranks, packed_hash.table_grad_launches(1))
    st.update(run=True, cards=cards, ranks_wall_s=wall)
    for rk in ranks:
        for s in rk["steps"].values():
            for n, v in s["launches"].items():
                if n in launches:
                    launches[n] += v
    log(f"[parallel window] {world} ranks in {wall:.1f}s")
    return launches, st


QUALITY_INIT_STEPS = 200
QUALITY_SPLIT_STEPS = 60
QUALITY_INIT_MARGIN_DB = 2.0    # after init: PSNR above the mean image's
QUALITY_FROZEN_DB = 0.1         # shared-only after split 0 vs after init
QUALITY_UNTRAINED_DB = 1e-3     # the untrained block vs shared-only
# the quality phase's kernels: K1-H2 run, no other
QUALITY_KERNELS = ("composite_fwd", "composite_bwd", "packed_hash_fwd",
                   "packed_hash_bwd")


def check_path_kernels(what: str, launches: dict, on_path) -> None:
    """Fail unless each kernel of ``on_path`` launched and no other did."""
    log(f"[{what}] launches {launches}")
    idle = [k for k in on_path if not launches[k]]
    stray = [k for k, n in launches.items() if n and k not in on_path]
    if idle or stray:
        raise AssertionError(f"{what}: kernels of the path never launched "
                             f"{idle}, kernels off the path launched "
                             f"{stray}: {launches}")


def phase_quality(tmp: Path):
    """quality_run --config perf --diag --n-blocks 2 on the textured scene
    at 160x120 through its own functions (scene, baselines, config, run,
    diag evals), the counters reset: after init the PSNR beats the mean
    image's by QUALITY_INIT_MARGIN_DB; after the first split the shared
    field renders as after init (QUALITY_FROZEN_DB) and the untrained block
    as the shared field (QUALITY_UNTRAINED_DB); the routed delta printed."""
    import math

    from gfnerf_tpu_torch import quality_run

    out = tmp / "quality"
    args = quality_run.parse_args([
        "--config", "perf", "--diag", "--n-blocks", "2",
        "--init-steps", str(QUALITY_INIT_STEPS),
        "--split-steps", str(QUALITY_SPLIT_STEPS),
        "--scene-dir", str(out / "scene"), "--out", str(out / "q.json"),
        "--output-dir", str(out / "runs")])
    t0 = time.perf_counter()
    reset_launch_counts()
    res = quality_run.run(args, log=lambda m: log(f"[quality] {m}"))
    launches = launch_counts()
    seconds = time.perf_counter() - t0
    check_path_kernels("quality", launches, QUALITY_KERNELS)
    base, init = res["baselines"], res["after_init"]
    diag = res["after_split0_diag"]
    shared = diag["shared_only"]["psnr"]
    untrained = diag["block1"]["psnr"] - shared
    stats = {"seconds": seconds, "s_per_step": res["s_per_step"],
             "minutes": res["minutes"], "baselines": base,
             "after_init": init, "after_split0": res["after_split0"],
             "final": res["final"],
             "diag_after_split0": {k: v["psnr"] for k, v in diag.items()
                                   if k != "routing"},
             "diag_final": {k: v["psnr"]
                            for k, v in res["final_diag"].items()
                            if k != "routing"},
             "routing": diag["routing"],
             "untrained_block_minus_shared_db": untrained,
             "routed_minus_init_db": {
                 m: res[m]["psnr"] - init["psnr"]
                 for m in ("after_split0", "final")}}
    log(f"[quality] after init PSNR {init['psnr']:.4f} (mean image "
        f"{base['mean_psnr']:.4f}, black {base['black_psnr']:.4f}); after "
        f"split 0 shared-only {shared:.4f}, block 1 (untrained) minus "
        f"shared-only {untrained:.3e} dB; routed minus after-init "
        f"{stats['routed_minus_init_db']} (printed, not checked)")
    if not init["psnr"] - base["mean_psnr"] >= QUALITY_INIT_MARGIN_DB:
        raise AssertionError(
            f"quality: after init PSNR {init['psnr']:.4f} is not "
            f"{QUALITY_INIT_MARGIN_DB} dB above the mean image's "
            f"{base['mean_psnr']:.4f}")
    if not abs(shared - init["psnr"]) <= QUALITY_FROZEN_DB:
        raise AssertionError(
            f"quality: shared-only PSNR after split 0 {shared:.4f} is not "
            f"after init's {init['psnr']:.4f} within {QUALITY_FROZEN_DB} dB")
    if not (math.isfinite(untrained)
            and abs(untrained) <= QUALITY_UNTRAINED_DB):
        raise AssertionError(
            f"quality: the untrained block's render is {untrained:.3e} dB "
            f"from shared-only's (limit {QUALITY_UNTRAINED_DB})")
    return launches, stats


# midscale_run at reduced steps and scene: 48 cameras at 100x75, the batch
# of its --fast run, a checkpoint every 120 steps (at 119, just before
# kill_at 120, and at the last; each holds the tables and Adam's moments,
# about 2 GB)
MIDSCALE_ARGS = ["--fast", "--init-steps", "60", "--split-steps", "40",
                 "--n-cams", "48", "--img-wh", "100x75",
                 "steps_per_save=120"]


def run_counted(counts_dir: str, argv) -> int:
    """``chip_smoke.py --counted DIR -m MODULE ARGS...``: run MODULE as
    ``python -m`` would and write the kernels' launch counts to
    DIR/<pid>.json as it exits, also on SIGTERM (then with exit code 143):
    the midscale phase's train and eval processes report what they
    launched."""
    import os
    import runpy
    import signal

    if argv[:1] != ["-m"] or len(argv) < 2:
        print("chip_smoke: --counted DIR -m MODULE [ARGS...]",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(REPO))

    def dump():
        Path(counts_dir, f"{os.getpid()}.json").write_text(
            json.dumps(launch_counts()))

    def on_term(signum, frame):
        dump()
        sys.stdout.flush()
        os._exit(128 + signum)

    signal.signal(signal.SIGTERM, on_term)
    sys.argv = [argv[1], *argv[2:]]
    try:
        runpy.run_module(argv[1], run_name="__main__", alter_sys=True)
    except SystemExit as e:
        dump()
        return e.code if isinstance(e.code, int) else 1
    dump()
    return 0


def phase_midscale(tmp: Path):
    """midscale_run at reduced steps (MIDSCALE_ARGS) with its train and
    eval processes counted (``run_counted``) and TensorBoard events
    (``--vis tensorboard`` passed on to train): phase 1 logs at least two
    octree rebuilds and is killed past kill_at; phase 2 resumes at its
    checkpoint's step + 1, logs no rebuild and ends with the last step's
    checkpoint and rc 0; eval exits 0 with a finite PSNR above the black
    image's (the mean image's printed beside it); each run's event file
    reads back with its scalars and config."""
    import math

    from gfnerf_tpu_torch import midscale_run
    from gfnerf_tpu_torch.utils.writer import read_events

    out = tmp / "midscale"
    counts = out / "counts"
    counts.mkdir(parents=True, exist_ok=True)
    args = midscale_run.parse_args([
        *MIDSCALE_ARGS, "--out-dir", str(out), "--scene-dir",
        str(out / "scene"), "--run-dir", str(out / "runs"),
        "--vis", "tensorboard"])
    t0 = time.perf_counter()
    summary = midscale_run.run(
        args, python=[sys.executable, str(REPO / "chip_smoke.py"),
                      "--counted", str(counts)],
        log=lambda m: log(f"[midscale] {m}"))
    seconds = time.perf_counter() - t0
    launches = {k: 0 for k in launch_counts()}
    per_process = [json.loads(f.read_text())
                   for f in sorted(counts.glob("*.json"))]
    for c in per_process:
        for k, n in c.items():
            launches[k] += n
    if len(per_process) != 3:
        raise AssertionError(f"midscale: {len(per_process)} processes "
                             "reported their launches, not 3")
    check_path_kernels("midscale", launches, QUALITY_KERNELS)
    sched = midscale_run.schedule(args)
    ckpt_step = int(summary["resume_ckpts"][-1].split("-")[1])
    ev = summary.get("eval", {}).get("results", {})
    psnr = ev.get("psnr", float("nan"))
    base = summary["baselines"]
    runs = sorted((out / "runs").glob("midscale/gf-nerf/*"))
    tb = {}
    for run in runs:
        events = [e for f in sorted(run.glob("events.out.tfevents.*"))
                  for e in read_events(f)]
        tags = {v["tag"] for e in events for v in e.get("values", [])}
        tb[run.name] = {"events": len(events),
                        "steps": sorted({e["step"] for e in events
                                         if "values" in e}),
                        "config": "config/text_summary" in tags,
                        "loss": "loss" in tags}
    stats = {"seconds": seconds, **{k: summary[k] for k in (
        "total_steps", "kill_at", "killed_at_logged_step", "resume_ckpts",
        "phase2_resumed_at", "phase2_rc", "phase2_ckpts", "eval_rc",
        "phase1_rebuilds", "phase2_rebuilds", "phase1_max_hits_events",
        "phase1_minutes", "phase2_minutes", "phase1_first_step_s",
        "phase2_first_step_s", "eval_minutes", "phase1_s_per_step",
        "phase2_s_per_step", "baselines")},
        "eval": ev, "tensorboard": tb,
        "launches_per_process": per_process}
    log(f"[midscale] killed at logged step "
        f"{summary['killed_at_logged_step']} (kill_at {sched['kill_at']}), "
        f"resumed at {summary['phase2_resumed_at']} from step "
        f"{ckpt_step}; rebuilds {summary['phase1_rebuilds']} + "
        f"{summary['phase2_rebuilds']}; eval PSNR {psnr:.4f} against the "
        f"black image's {base['black_psnr']:.4f} and the mean image's "
        f"{base['mean_psnr']:.4f}; TensorBoard {json.dumps(tb)}")
    fails = []
    if summary["phase1_rebuilds"] < 2:
        fails.append(f"phase 1 logged {summary['phase1_rebuilds']} octree "
                     "rebuilds, not >= 2")
    if summary["killed_at_logged_step"] < sched["kill_at"]:
        fails.append("phase 1 was not killed past kill_at")
    if summary["phase2_resumed_at"] != ckpt_step + 1:
        fails.append(f"phase 2 resumed at {summary['phase2_resumed_at']}, "
                     f"not at its checkpoint's step {ckpt_step} + 1")
    last = f"step-{sched['total'] - 1:09d}"
    if summary["phase2_rc"] != 0 or last not in summary["phase2_ckpts"]:
        fails.append(f"phase 2 rc {summary['phase2_rc']}, checkpoints "
                     f"{summary['phase2_ckpts']} (expected {last})")
    if summary["phase2_rebuilds"] != 0:
        fails.append(f"phase 2 logged {summary['phase2_rebuilds']} "
                     "rebuilds")
    if summary["eval_rc"] != 0 or not (math.isfinite(psnr)
                                       and psnr > base["black_psnr"]):
        fails.append(f"eval rc {summary['eval_rc']}, PSNR {psnr} against "
                     f"the black image's {base['black_psnr']}")
    if len(tb) != 2 or not all(t["config"] and t["loss"]
                               for t in tb.values()):
        fails.append(f"event files {tb}")
    if fails:
        raise AssertionError("midscale: " + "; ".join(fails))
    return launches, stats


def start_beside(phase, *args):
    """Start ``phase(*args)`` on a thread of its own, beside what the
    caller runs next; returns ``join()``, which waits for it and returns
    its result or raises its error."""
    import threading

    box = {}

    def run():
        try:
            box["out"] = phase(*args)
        except BaseException as e:   # raised again by join()
            box["err"] = e

    thread = threading.Thread(target=run, name=phase.__name__, daemon=True)
    thread.start()

    def join():
        thread.join()
        if "err" in box:
            raise box["err"]
        return box["out"]

    return join


def main() -> int:
    if not (REPO / "gfnerf_tpu_torch").is_dir():
        print("chip_smoke: gfnerf_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    SETUP_REUSE.install()
    start = time.perf_counter()

    def clock(name):
        log(f"[clock] {name} done at {time.perf_counter() - start:.1f}s")

    card = phase_device()
    start_parent()
    phase_build()
    join_parent()
    clock("build")
    jpeg_stats = phase_jpeg(card)
    clock("jpeg")
    report = phase_kernels(n_samples=384)
    clock("kernels")
    import torch

    from gfnerf_tpu_torch.train_bench import build_train_workload

    t0 = time.perf_counter()
    wl = build_train_workload(torch.device("cuda"), seed=0)
    tree, scfg = wl["tree"], wl["scfg"]
    log(f"[workload] in {time.perf_counter() - t0:.1f}s "
        f"({', '.join(f'{k} {v:.1f}s' for k, v in wl['timings'].items())}):"
        f" {tree.n_nodes} nodes, {int(wl['oct_dev'].n_leaves)} valid leaves, "
        f"{tree.n_volumes} volumes; S={scfg.max_samples}, sample_l "
        f"{scfg.sample_l:.6f}")
    paths, stats = {}, {}
    paths["render"], stats["render"], encode = phase_render(wl)
    clock("render")
    paths["train"], stats["train"], (hash_fwd, hash_bwd) = phase_train(wl)
    clock("train")
    paths["focal_train"], stats["focal_train"] = phase_focal(wl)
    clock("focal")
    paths["focal_render"], stats["focal_render"], routed = \
        phase_focal_render(wl)
    clock("focal render")
    with tempfile.TemporaryDirectory(prefix="gfnerf_window_") as tmp:
        paths["window"], stats["window"] = phase_window(Path(tmp), wl)
    clock("window")
    del wl
    torch.cuda.empty_cache()
    paths["parity_train"], stats["parity_train"], (anc_fwd, anc_bwd), wl = \
        phase_parity()
    clock("parity")
    paths["parity_focal"], stats["parity_focal"] = phase_parity_focal(wl)
    clock("parity focal")
    del wl
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory(prefix="gfnerf_pipeline_") as tmp:
        paths["pipeline"], stats["pipeline"] = phase_pipeline(Path(tmp))
        clock("pipeline")
        torch.cuda.empty_cache()
        paths["gfnerf"], stats["gfnerf"], (gf_fwd, gf_bwd) = \
            phase_gfnerf(Path(tmp))
        clock("gfnerf")
        torch.cuda.empty_cache()
        paths["prop"], stats["prop"], prop = phase_prop(Path(tmp))
        clock("prop")
        torch.cuda.empty_cache()
        paths["nerfacto"], stats["nerfacto"], nerfacto = \
            phase_nerfacto(Path(tmp))
        clock("nerfacto")
        paths["semantics"], stats["semantics"] = phase_semantics(Path(tmp))
        clock("semantics")
        torch.cuda.empty_cache()
        paths["instant_ngp"], stats["instant_ngp"], ngp = \
            phase_instant_ngp(Path(tmp))
        clock("instant-ngp")
        torch.cuda.empty_cache()
        scan_paths, stats["scan"], report["scan_march"] = \
            phase_scan(Path(tmp))
        paths.update(scan_paths)
        clock("scan")
        torch.cuda.empty_cache()
        stock_paths, stats["stock"] = phase_stock(Path(tmp))
        paths.update(stock_paths)
        clock("stock")
        torch.cuda.empty_cache()
        npl_paths, stats["nerfplayer"], npl = phase_nerfplayer(Path(tmp))
        paths.update(npl_paths)
        clock("nerfplayer")
        torch.cuda.empty_cache()
        paths["captures"], stats["captures"] = phase_captures(Path(tmp))
        clock("captures")
        torch.cuda.empty_cache()
        paths["tools"], stats["tools"] = phase_tools(Path(tmp))
        clock("tools")
        torch.cuda.empty_cache()
        # the mid-scale run's processes train beside the parallel and
        # quality phases (their seconds are taken with it running)
        midscale = start_beside(phase_midscale, Path(tmp))
        try:
            paths["parallel"], stats["parallel"] = phase_parallel(Path(tmp))
            clock("parallel")
            torch.cuda.empty_cache()
            paths["quality"], stats["quality"] = phase_quality(Path(tmp))
            clock("quality")
        finally:
            paths["midscale"], stats["midscale"] = midscale()
    clock("midscale")
    fast, scan = stats["pipeline"], stats["scan"]
    log(f"[scan] gf-nerf-perf through the Trainer, the scan (M1) against "
        f"the fast march on the same scene and schedule: "
        f"{scan['init_s_per_step']:.4f} vs {fast['init_s_per_step']:.4f} "
        f"s/init step, {scan['focal_s_per_step']:.4f} vs "
        f"{fast['focal_s_per_step']:.4f} s/focal step; eval PSNR "
        f"{scan['eval_psnr']:.3f} after {SCAN_STEPS} steps vs "
        f"{fast['eval_psnr']:.3f} after {PIPELINE_STEPS}")
    for name, i in (("hash_anchored_fwd", 0), ("hash_anchored_bwd", 1)):
        # the occupancy update runs H4 alone: no H5 at its shape
        on_path = {shape: parts[i] for shape, parts in ngp.items()
                   if i == 0 or shape == "train step"}
        report[name]["instant_ngp"] = on_path
        report[name]["max_abs_err"] = max(
            report[name]["max_abs_err"],
            *(part["max_abs_err"] for part in on_path.values()))
    for name, i in (("hash_anchored_fwd", 0), ("hash_anchored_bwd", 1)):
        report[name]["nerfacto"] = {shape: parts[i]
                                    for shape, parts in nerfacto.items()}
        report[name]["max_abs_err"] = max(
            report[name]["max_abs_err"],
            *(parts[i]["max_abs_err"] for parts in nerfacto.values()))
    for name, part in prop.items():
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          part["max_abs_err"])
        report[name]["prop"] = part
    for name, gf in (("hash_anchored_fwd", gf_fwd),
                     ("hash_anchored_bwd", gf_bwd)):
        report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                          gf["max_abs_err"])
        report[name]["gfnerf"] = gf
    # T1 and T2 at every shape of the nerfplayer pair's steps, the
    # nerfplayer-nerfacto field's at the top level
    for name, i in (("temporal_grid_fwd", 0), ("temporal_grid_bwd", 1)):
        on_path = {shape: parts[i] for shape, parts in npl.items()
                   if parts[i] is not None}
        report[name] = {**on_path["nerfplayer_nerfacto field"],
                        "nerfplayer": on_path}
        report[name]["max_abs_err"] = max(part["max_abs_err"]
                                          for part in on_path.values())
    for name, *parts in (("packed_hash_fwd", encode, hash_fwd),
                         ("packed_hash_bwd", hash_bwd),
                         ("packed_hash_routed", routed),
                         ("hash_anchored_fwd", anc_fwd),
                         ("hash_anchored_bwd", anc_bwd)):
        for part in parts:
            report[name]["max_abs_err"] = max(report[name]["max_abs_err"],
                                              part.pop("max_abs_err"))
            report[name].update(part)

    csrc, jax_pkg = "gfnerf_tpu_torch/csrc/", "gfnerf_tpu/"
    sources = {
        "composite_fwd": ("composite_fwd.cu", "ops/pallas/composite.py:80"),
        "composite_bwd": ("composite_bwd.cu", "ops/pallas/composite.py:112"),
        "packed_hash_fwd": ("packed_hash_fwd.cu",
                            "fields/packed_hash.py:202"),
        "packed_hash_bwd": ("packed_hash_bwd.cu",
                            "fields/packed_hash.py:490"),
        "packed_hash_routed": ("packed_hash_routed.cu",
                               "fields/packed_hash.py:336"),
        "hash_anchored_fwd": ("hash_anchored_fwd.cu",
                              "fields/hash_encoding.py:188"),
        "hash_anchored_bwd": ("hash_anchored_bwd.cu",
                              "fields/hash_encoding.py:376"),
        "scan_march": ("scan_march.cu", "sampler/perssampler.py:337"),
        "temporal_grid_fwd": ("temporal_grid_fwd.cu",
                              "fields/temporal_grid.py:117"),
        "temporal_grid_bwd": ("temporal_grid_bwd.cu",
                              "fields/temporal_grid.py:163"),
    }
    kernels = [{"name": name, "route": "cuda", "source": csrc + src,
                "replaces": jax_pkg + rep,
                "launches": sum(p[name] for p in paths.values()),
                "launches_by_path": {k: p[name] for k, p in paths.items()},
                **report[name]}
               for name, (src, rep) in sources.items()]
    for path, st in stats.items():
        log(f"[{path}] {json.dumps(st)}")
    log(f"[jpeg] {json.dumps(jpeg_stats)}")
    log(json.dumps({"kernels": kernels}))
    log(f"[clock] the whole script {time.perf_counter() - start:.1f}s")
    log(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


def main_only(names) -> int:
    """``--only pipeline,nerfacto,...``: the device and the build, then the
    named phases of the temp-dir family (pipeline, gfnerf, prop, nerfacto,
    semantics, instant-ngp, scan, stock, nerfplayer, captures, tools,
    capture-variants, parallel, parallel-window (its NCCL window leg
    alone), quality, midscale, table-grads (H2 and H5 alone at their
    rows' shapes: phase_table_grads); and jpeg, the codec alone; nerfacto,
    semantics
    and tools need the
    pipeline phase's scene and checkpoint, parallel writes the scene when
    the pipeline phase did not run,
    instant-ngp, nerfplayer and captures write their own scenes, scan and
    stock write theirs
    when the pipeline and instant-ngp phases did not run) in one temp dir,
    for work on one phase: their lines and stats, no kernels line and no
    result line."""
    if not (REPO / "gfnerf_tpu_torch").is_dir():
        print("chip_smoke: gfnerf_tpu_torch/ not found beside this script",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(REPO))
    SETUP_REUSE.install()
    start = time.perf_counter()
    phases = {"pipeline": phase_pipeline, "gfnerf": phase_gfnerf,
              "prop": phase_prop, "nerfacto": phase_nerfacto,
              "semantics": phase_semantics,
              "instant-ngp": phase_instant_ngp, "scan": phase_scan,
              "stock": phase_stock, "nerfplayer": phase_nerfplayer,
              "captures": phase_captures,
              "capture-variants": phase_capture_variants,
              "tools": phase_tools, "parallel": phase_parallel,
              "quality": phase_quality, "midscale": phase_midscale,
              "window": phase_window, "jpeg": phase_jpeg,
              "parallel-window": phase_parallel_window,
              "table-grads": phase_table_grads}
    unknown = set(names) - set(phases)
    if unknown:
        print(f"chip_smoke: unknown phases {sorted(unknown)}",
              file=sys.stderr)
        return 2
    card = phase_device()
    log(card)
    start_parent()
    phase_build()
    join_parent()
    with tempfile.TemporaryDirectory(prefix="gfnerf_pipeline_") as tmp:
        for name in names:
            if name == "jpeg":
                log(f"[jpeg] {json.dumps(phase_jpeg(card))}")
                continue
            out = phases[name](Path(tmp))
            log(f"[{name}] launches {out[0]}")
            log(f"[{name}] {json.dumps(out[1])}")
            if name == "scan":
                log(f"[scan] M1 {json.dumps(out[2])}")
            if name == "nerfplayer":
                log(f"[nerfplayer] T1/T2 {json.dumps(out[2])}")
            log(f"[clock] {name} done at "
                f"{time.perf_counter() - start:.1f}s")
    return 0


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--counted"] and len(args) > 1:
        sys.exit(run_counted(args[1], args[2:]))
    if args[:1] == ["--parent"] and len(args) > 1:
        PARENT_DIR = Path(args[1])
        args = args[2:]
    if args[-2:-1] == ["--coverage-case"]:
        COVERAGE_CASE = args[-1]
        args = args[:-2]
    if len(args) == 2 and args[0] == "--only":
        sys.exit(main_only(args[1].split(",")))

    if args:
        print(f"chip_smoke: unknown arguments {args}", file=sys.stderr)
        sys.exit(2)
    sys.exit(main())
