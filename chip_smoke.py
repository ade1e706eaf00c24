#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (startrax_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each printing its numbers:
  1. the card's name and power limit (nvidia-smi);
  2. build the CUDA kernels from startrax_torch/kernels/csrc (nvcc, sm_90a);
  3. each kernel against its plain PyTorch version at the shapes one online
     step gives it (static 8x256 and dynamic 4x256 with the SE(3) warp, on
     the coarse pass's 256,000 and the fine pass's 512,000 points; and the
     dynamic field with a BARF mask), within the limits of
     startrax_torch/kernels/parity.py, and the kernels' and plain versions'
     times;
  3b. the field-axis kernel (K fields in one launch, per-point input grads)
     against its plain version: the K = 2 dynamic fields of
     startrax/configs/synthetic_star_online_scaled.txt (4x128) on the
     per-ray step's 131,072 coarse and 262,144 fine points per field, their
     inputs made from a per-ray pose leaf [R, K, 7] through
     warp_to_vehicle_frames, without and with the BARF mask (end_barf 12,
     step 5); one 4x256 case at 512,000 points per field; and the static
     8x128 field per-field at both passes' shapes; with times;
  3c. the backward's further kernels: the weight-gradient GEMM
     (wgrad_kernel, one launch over every wide layer of a backward call)
     and the ordered partial sums (sum_rows_kernel, one launch a sum)
     against their plain versions within PART_TOL, with times (CUDA events
     and profiler device time) beside library yardsticks (one torch.mm a
     layer and field, one torch.sum a sum) and their bounds: at one online
     step's shapes, at the online app's shared-pose step's shapes (static
     8x128, dynamic 4x128), at the per-ray step's stacked fine call (K = 2),
     at nerf_time's fine call (96-row lin_in) and at the occgrid step's call
     at budgets 128 and 512 (4096 rays, static 8x256);
  3d. the per-field kernel at the shapes one shared-pose step of the online
     app (startrax/configs/synthetic_star_online.txt) gives it: the static
     8x128 field and the K = 2 dynamic 4x128 fields with the in-kernel SE(3)
     warp and the pose sums, on 131,072 coarse and 262,144 fine points,
     against its plain version within the limits of parity.py, with times;
  3e. the stacked kernels' pre-encoded mode (fused_stacked_apply with
     pe=None, fwd_kernel<true, true> / bwd_kernel<true, true>): K = 2
     time-conditioned fields at carla_nerf_time.txt's widths (8x256, 84 +
     27 encoded columns) on the coarse pass's 256,000 and the fine pass's
     512,000 points a field and on 3,000 ragged points, with input grads,
     against its plain version within parity.ENC_LIMITS, with times and
     bound; K = 1 through fused_stacked_apply against fused_field_apply's
     pre-encoded mode, bit for bit; then STACKED_ENC_CALLS forward and
     backward calls of the fine case, each exactly one stacked_enc_fwd, one
     stacked_enc_bwd, one GEMM and two sums (run after 3d);
  4. the main path: StarConfig and LossConfig from
     startrax/configs/carla_star_online_multi.txt, random weights from a
     seed, app-init steps then online training steps on one fixed batch of
     1000 rays x (256 + 256) samples, through the kernels; the fused forward
     and backward launch counts must rise by 2 per app-init step and 6 per
     online step, the stacked ones not at all, the GEMM's by one and the
     sums' by two a backward call, and the loss must be finite
     and fall; then peak memory, the kernel path's render against the plain
     path's on a small batch, and one plain-path step, which must launch no
     kernel;
  4b. the per-ray-pose (mixed-frame) path at the full widths of
     synthetic_star_online_scaled.txt: one fixed batch of 2048 rays with
     per-ray frames drawn from [0, 8), a uniform target and depth; the
     optimizer as apps/online.py builds it (accumulation 4, clip 1.0); BARF
     warmup steps (rotations frozen), joint steps, then gauge steps on
     frame-0 rays from an identity gauge (rotation frozen, depth term 2.0).
     The losses must be finite and the joint loss fall, the parameters
     change on every 4th step only, every frame in the batch get a pose
     grad, the gauge rotation stay identity, the gauge step leave the
     fields' and poses' grads alone, and the launches per step be those the
     path makes (online: fwd, bwd, stacked_fwd, stacked_bwd +2 each, and
     the backward's GEMM and sums, one and two a call;
     gauge: fwd +2, bwd +0, stacked +2 each, no GEMM or sum). Then peak
     memory, the kernel path's render against the plain path's on a small
     batch, and one plain-path joint step, which must launch no kernel;
  5. the time-conditioned baseline (nerf_time) at the full widths of
     startrax/configs/carla_nerf_time.txt (8x256 coarse and fine, 84 + 27
     encoded input columns, 1000 rays x (256 + 256) samples, bf16): (a) the
     kernels' pre-encoded mode against its plain version on the coarse
     pass's 256,000 and the fine pass's 512,000 points, on 3,000 ragged
     points with input grads and on the coarse shape with input grads, with
     times; (b) 20 steps on one fixed batch at frame 3 of 16 through the
     kernels, each adding exactly 2 "enc_fwd" and 2 "enc_bwd" launches, their
     GEMM and sums, and none of another kind, the loss finite and falling;
     (c) the tiled eval render of a 64x64 frame from get_rays, kernel path
     against plain path, then one plain-path step, which must launch no
     kernel;
  6. the appearance-init app at synthetic_star_online_scaled.txt's widths
     (scene 192x192, 32 + 4 views, 8 frames, K = 2; static field 8x128,
     N_rand 2048, 64 + 64 samples, accumulation 4), its depth cut by
     APP_CUT: (a) the scene generated on the card into a fresh cache
     directory and timed, loaded again from the cache file (equal arrays),
     and the card marcher held against the numpy marcher on a crop of one
     view and frame (rgb 2e-5, depth 2e-4, masks agreeing on > 99.9% of
     the pixels); (b) startrax_torch.apps.app_init.main through its argv
     parser: the fine loss per epoch (it must fall), each validation's PSNR
     and SSIM, the median step time (CUDA events, steps 10 on, the
     profiled window left out), the device's idle share (profiled device
     time over that median), the launches per step (2 fwd + 2 bwd, one
     weight-gradient GEMM and two sums a backward call, and the validation
     renders' forwards, nothing else) and one profiled step's table;
     (c) the final checkpoint restores bitwise, restore_static_only keeps
     exactly the static fields, and the last validation view re-rendered
     from the restored params gives the app's PSNR within 1e-4 dB;
     (d) the pose, RPE/ATE and 3D-IoU metrics of the noisy GT poses
     against the GT (errors > 0, the GT against itself 0), the pose-file
     round trip, and the logged PNG files hold the bytes that write_png
     makes of the re-rendered arrays;
  7. the online tracking app at synthetic_star_online.txt's widths (scene
     128x128, 8 + 1 views, 8 frames, K = 2; static 8x128, dynamic 4x128,
     N_rand 2048, 64 + 64 samples, bf16, accumulation 4), in the same
     temporary directory as phase 6: (a) warm-started from phase 6's final
     app-init checkpoint when the two configs give the same static fields
     (else from a short app-init on synthetic_star_online.txt); (b)
     startrax_torch.apps.online.main through its argv parser, cut in depth
     and schedule by ONLINE_CUT (each cut printed): the phase sequence of
     history.json must be ONLINE_PHASES (fieldform, BARF, the curriculum's
     pose and joint epochs, the alternate polish, a stop on the polish
     budget), the fine loss finite and falling over the warmup, val metrics
     finite, a selection score on every epoch after the last admission; the
     fine loss, window, pose errors and score per epoch, the validations,
     the median step by CUDA events (read after the run: no sync is added
     between steps) and the device time and idle share (profiled window of
     5 steps) of each step kind: per-ray batches (the
     anchor rays' [N] frames) and shared-pose batches; every step's
     launches as designed for its kind (per-ray: 2 fwd, 2 bwd, 2 stacked
     fwd, 2 stacked bwd, 4 GEMMs, 8 sums; shared-pose: 6 fwd, 6 bwd, 6
     GEMMs, 12 sums), the stale prefetched batches by phase, and the eval
     renders' 6 fwd a tile; (c) a resume from the final checkpoint with
     RESUME_CUT: run.log says it resumed the run and the polish sub-state
     and restored the best snapshot, the run continues the alternation, and
     the saved params and every optimizer state load bitwise into fresh
     leaves and buffers; (d) --test true on the final checkpoint: the test
     metrics present and finite, ATE under 0.4, the pose files written;
  8. the scaled recipe's online app (synthetic_star_online_scaled.txt, the
     config and scene of phase 6, warm-started from its checkpoint; static
     8x128, dynamic 4x128, N_rand 2048, 64 + 64 samples, bf16, accumulation
     4, depth loss 0.1; photometric_depth selection at stride 2, boundary
     only; the gauge_align polish in frame0 mode, gauge_epochs 2,
     gauge_depth_lambda 2.0), cut in depth and schedule by SCALED_CUT
     (gauge_rounds 2, so that the gauge round re-enters): (a) the phase
     sequence SCALED_PHASES (warmup, curriculum, two gauge rounds of two
     gauge_fit epochs, each followed by an alternation round that ends on a
     boundary row, the stop on the polish budget); each gauge application
     equal to G^-1 ∘ p to 1e-6 for every vehicle (read at the first step
     after it) and each reset optimizer's first step after it at a newly
     built optimizer's state; the boundary best restored into the returned
     params bitwise; the step time, device time and idle share of each kind
     (per-ray, shared-pose, and the gauge steps of either layout), every
     step's launches as its kind's design (gauge per-ray: 2 fwd, 2 stacked
     fwd, 2 stacked bwd; gauge shared-pose: 6 fwd, 4 bwd with the pose sums,
     4 sums; no GEMM), the stale batches and the renders' forwards; (b) a
     resume from the checkpoint of the second round's first gauge_fit
     epoch: the round restarts, both best snapshots are restored; (c)
     --test true over the 4 held-out views, ATE under 0.4;
  8b. on phase 7's config and scene, POLISH_CUTS: the gauge in ref_field
     mode with its held-out guard, then multi-start (2 candidates), and
     refit_anchor; each one's phases, run.log decisions and launches by
     kind;
  9. the occupancy-grid app-init (apps/occgrid_init.py) at
     carla_star_app_init_nerfacc.txt's field, batch and grid (8x256, bf16,
     N_rand 4096, N_samples 512, budget 128, grid 128^3) on phase 6's scene
     (the scene keys and render_step_size, at its ratio to the march step,
     are printed overrides; CARLA data is absent): (a) the static field's
     kernels against their plain version at the app's shapes: 4096 rays
     marched through a grid with 30% of its cells occupied at budgets 128,
     256 and 512 (524,288 to 2,097,152 points; the cotangent zero on the
     masked slots; the plain version in slices of PLAIN_ROWS rows above
     that), and the grid update's forward over 2,097,152 cells with one
     sample a ray under no_grad (and nothing saved), each with times and
     bounds; (b) the app through its argv parser, cut in depth by OCC_CUT:
     the fine loss finite and falling, mean_samples and dropped_frac per
     epoch, a budget doubling after an epoch that cut more than 1% of its
     occupied samples and the next steps at the doubled shape, a grid
     update before every 16th step (1 fwd, nothing saved), each step 1 fwd
     + 1 bwd + 1 GEMM + 2 sums, the step time by budget (CUDA events),
     device time and idle share (profiled steps), the march and the update
     timed alone, a {"params"} checkpoint an epoch;
  9b. render_star_occgrid at phase 9's grid (budget 128) on 4096 rays with
     K = 2 (pose warp, field-axis dynamic fields): kernel path against
     plain path (rgb within 2e-2, weight and pose grads within
     parity.LIMITS), launches 1 fwd + 1 bwd + 1 stacked fwd + 1 stacked
     bwd, 2 GEMMs, 4 sums; joint_density_fn over the grid's cells with and
     without the pose against the plain path;
  10. nerf_time's app (apps/nerf_time.py) at carla_nerf_time.txt's widths
     on phase 6's scene, cut by NT_APP_CUT: the loss finite and falling, 2 +
     2 pre-encoded launches, 2 GEMMs and 4 sums a step, a validation PSNR an
     epoch; then --test true from its checkpoint over
     NT_TEST_FRAMES frames of each held-out view: finite rows;
  10b. a CARLA-format capture (57 cameras, CARLA_FRAMES frames, 2
     vehicles, the 24-bit depth code, semantic id 10, bboxes.npy) written
     with utils/logging.write_png in a temporary directory: every PNG file
     read back bit-exact with read_png, the train, val and test splits
     loaded through make_dataset, nerf_time's app for one short epoch on it
     and test() with test_carla_nerf_time.txt's protocol;
  11. a Blender-format capture (BLENDER_VIEWS views a split of lego's
     800x800 RGBA: a sphere coloured by its normal on a transparent
     background, seen from cameras on a sphere of radius 4, so that the
     views agree) written with write_png in a temporary directory and every
     file read back bit-exact, then startrax_torch.apps.lego.main through
     its argv parser on lego.txt at its published widths (8x256, 64 + 128
     samples, N_rand 1024, white background, half_res to 400x400), cut in
     epochs and steps by LEGO_CUT: the fine loss finite and falling, a
     finite val PSNR an epoch, each step 2 fwd + 2 bwd + 2 GEMMs + 4 sums;
  12. startrax_torch.apps.mip.main on carla_star_app_init_mip.txt (8x256,
     24 + 4 IPE frequencies, N_rand 1000, 256 + 512 samples, bf16), then on
     carla_star_online_mip.txt (256 + 256 samples) warm-started from its
     checkpoint, then --test true on the online checkpoint, on phase 6's
     scene (the scene keys are printed overrides), each cut in depth and
     schedule (MIP_APP_CUT, MIP_ONLINE_CUT with the accumulation cut from
     50 to 4, MIP_TEST_CUT; printed): finite losses, the app-init loss
     falling, unit quaternions, pose-error and val rows, finite test rows,
     no fused-kernel launch; the peak memory of each app;
  13. ray-axis data parallelism, DP_WORLD ranks on the one card over gloo
     (spawned by startrax_torch.parallel.mesh.run_ranks; NCCL refuses two
     ranks on one device, so this is correctness, not a speed-up): (a) the
     online step at carla_star_online_multi.txt's widths on bench.py's 1000
     rays padded to 1008, shared-pose at frame 3 and per-ray frames from [0,
     8), depth and sigma losses on masks that count differently on the two
     halves, accumulation 4: each rank against the one-process step on the
     same batch, weights and draws (loss within DP_LOSS_RTOL before the
     first update, the summed field grads within PART_TOL["wgrad"] of the
     largest and the pose grads within parity.LIMITS["pose"], the ranks'
     parameters equal after every step, the one-process step's launches);
     (b) apps.app_init on phase 6's config and scene, 2 epochs, over the
     ranks against one rank (epoch losses within DP_APP_RTOL, one
     run directory, its checkpoint restored in this process to rank 0's
     tree); (c) apps.online on phase 7's config, warmup and one curriculum
     epoch (ONLINE_PHASES' first five; the warmup epochs' losses within
     DP_ONLINE_RTOL of one rank, the later ones, whose stale prefetched
     batches depend on timing, finite), then --test true over the ranks on
     the one-rank run's checkpoint with save_video_frames: the rows within
     DP_TEST_ATOL, view0.gif written; (d) the 2-rank step's median against
     the one-process step's, and the step's collectives alone;
  14. the eval-only utilities: (a) utils/mesh.extract_mesh's grid over
     models.fields.query_density of phase 11's trained fine field at
     startrax's defaults (256^3 over [-0.8, 0.8]^3, sigma 50; one fused
     forward a 65,536-point chunk), the marching on the host, the OBJ parsed
     back, non-empty (where the short-trained field stays under sigma 50 the
     surface at MESH_FALLBACK of its largest density instead, and said), the kernel
     path's grid against the plain path's on 64^3 within parity.LIMITS; (b)
     utils/profiling.trace around one app-init step (the Chrome trace names
     fwd_kernel and bwd_kernel, and holds the step's spans);
  15. one JSON line per kernel (with its bound: the larger of its FLOP over
     989 TFLOP/s dense bf16, 67 TFLOP/s f32 for the sums, and its bytes,
     each input read once and each output written once, over 3.35 TB/s;
     the launches of it by the app-init app, the online app, the scaled
     app of phase 8, the polishes of 8b and phases 9, 9b, 10, 10b, 11, 12,
     13 (rank 0) and 14, each counted from 0 over its run; the stacked
     pre-encoded rows' launches are phase 3e's path's; and the times at the
     occgrid app's shapes), the card's line, and the result line {"ok":
     true, "device": {...}} last.

Exits non-zero, printing no result, without a CUDA device or when any phase
fails. Imports nothing of JAX or of the JAX package: only torch, numpy,
scipy and startrax_torch; the configs are read as text by the port's own parser.
Float32 matmuls and convolutions on the plain paths run in full float32
(TF32 off).
"""

import contextlib
import dataclasses
import functools
import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from unittest import mock

N_APPINIT = 3
N_ONLINE = 20
FRAME = 3
# phase 4b: steps of the BARF warmup, the joint phase and the gauge fit; the
# BARF step (epoch) of the warmup and of phase 3b's masks
N_WARMUP = 8
N_JOINT = 48
N_GAUGE = 8
BARF_STEP = 5
SLICE_CONFIG = "synthetic_star_online_scaled.txt"
# phase 5: nerf_time's config, its kernel-path steps, the render's frame
# size
NT_CONFIG = "carla_nerf_time.txt"
N_NT = 20
RENDER_HW = 64
SRC = "startrax_torch/kernels/csrc/fused_mlp.cu"
# phase 6: the app's depth cut (existing config fields), the side of the
# crop held against the numpy marcher, the steps the step time skips, and
# the profiled window of steps
APP_CUT = ("--epochs_appearance", "3", "--steps_per_epoch", "100", "--epoch_val", "1")
MARCH_CROP = 32
APP_WARM = 10
APP_PROFILED = (60, 65)
# phase 7: the online app's config, its cut in depth and schedule (existing
# config fields), the phases it must run, the resume's extension, the steps of
# each kind the median skips, and the profiled window of each kind (by index
# among the steps of that kind)
ONLINE_CONFIG = "synthetic_star_online.txt"
ONLINE_CUT = ("--epochs_online", "12", "--steps_per_epoch", "40", "--pose_delay_epochs", "1",
              "--end_barf", "3", "--epochs_between_frames", "0", "--online_thres", "1e9",
              "--online_thres_tightened", "1e9", "--polish_epochs", "4", "--alt_field_epochs", "1",
              "--alt_pose_epochs", "1", "--epoch_val", "2", "--selection_patience", "0")
ONLINE_PHASES = ["fieldform", "barf", "barf", "pose", "joint", "joint", "pose", "polish_field",
                 "polish_pose", "polish_field", "polish_pose"]
RESUME_CUT = ("--epochs_online", "14", "--polish_epochs", "6")
ONLINE_WARM = 10
ONLINE_PROFILED = {"per_ray": (20, 25), "shared": (60, 65)}
# phase 8: the scaled recipe's online app (phase 6's config), cut in depth and
# schedule (existing config fields; gauge_rounds 1 -> 2 so that the gauge
# round re-enters), the phases it must run, the checkpoint the resume starts
# from (mid-gauge) and its extension, and the profiled window of each step
# kind; 8b: the ref_field gauge with its guard plus multi-start, and
# refit_anchor, on phase 7's config: each cut, its phases and the run.log
# lines it must write (text, count)
SCALED_CUT = ("--epochs_online", "16", "--steps_per_epoch", "24", "--pose_delay_epochs", "1",
              "--end_barf", "3", "--epochs_between_frames", "0", "--online_thres", "1e9",
              "--online_thres_tightened", "1e9", "--polish_epochs", "8", "--alt_field_epochs", "1",
              "--alt_pose_epochs", "1", "--gauge_rounds", "2", "--epoch_val", "12",
              "--selection_patience", "0")
SCALED_PHASES = ["fieldform", "barf", "barf", "pose", "joint", "joint", "pose", "gauge_fit",
                 "gauge_fit", "polish_field", "polish_pose", "gauge_fit", "gauge_fit",
                 "polish_field", "polish_pose"]
SCALED_RESUME_AT = 11
SCALED_RESUME_CUT = ("--epochs_online", "14")
SCALED_PROFILED = {"per_ray": (12, 17), "shared": (30, 35), "gauge_per_ray": (30, 35),
                   "gauge_shared": (2, 5)}
_POLISH_BASE = ("--epochs_online", "10", "--steps_per_epoch", "16", "--pose_delay_epochs", "0",
                "--end_barf", "0", "--initial_num_frames", "8", "--epochs_between_frames", "0",
                "--online_thres", "1e9", "--online_thres_tightened", "1e9",
                "--alt_field_epochs", "1", "--alt_pose_epochs", "1", "--epoch_val", "100",
                "--selection_patience", "0", "--refit_epochs", "1")
POLISH_CUTS = (
    ("guard_multi_start", _POLISH_BASE + (
        "--polish_epochs", "6", "--polish_mode", "gauge_align", "--gauge_mode", "ref_field",
        "--gauge_guard", "true", "--gauge_epochs", "1", "--gauge_rounds", "1",
        "--multi_start_rounds", "1", "--multi_start_candidates", "2", "--multi_start_epochs",
        "1"),
     ["joint", "gauge_ref", "gauge_fit", "polish_field", "polish_pose", "multi_start",
      "polish_field"],
     (("gauge_align: fitting frame-0 reference fields", 1), ("gauge_align guard: vehicle", 2),
      ("multi_start: candidate", 2), ("multi_start: ", 3))),
    ("refit_anchor", _POLISH_BASE + (
        "--polish_epochs", "4", "--polish_mode", "refit_anchor", "--refit_pose_epochs", "1"),
     ["joint", "refit_field", "refit_pose", "polish_field", "polish_pose"],
     (("refit_anchor: dynamic fields re-initialized", 1),
      ("refit_anchor: pose recovery done", 1))),
)
# phase 13: ranks on the one card (gloo), 13a's batch (bench.py's rays padded
# to the world size), steps a layout, frames of the per-ray layout and the
# accumulation (two updates in the steps), and the tolerances against the
# one-process runs: 13a's loss before the first update; 13b's epoch losses
# and 13c's warmup epoch losses (bf16 kernels: the grads' f32 sums run in
# another order over half the rows, and Adam amplifies it; read 5.8e-4 and
# up to 5.8e-3); 13c's test rows (one checkpoint, the renders' tiles
# split); the cuts of the apps
DP_WORLD = 2
DP_RAYS = 1000
DP_STEPS = 8
DP_FRAMES = 8
DP_ACCUMULATE = 4
DP_LOSS_RTOL = 1e-5
DP_APP_RTOL = 2e-2
DP_ONLINE_RTOL = 2e-2
DP_TEST_ATOL = 1e-4
DP_APP_CUT = ("--epochs_appearance", "2", "--steps_per_epoch", "100", "--epoch_val", "1")
DP_ONLINE_CUT = tuple(v if ONLINE_CUT[i - 1] not in ("--epochs_online", "--steps_per_epoch")
                      else {"--epochs_online": "5", "--steps_per_epoch": "20"}[ONLINE_CUT[i - 1]]
                      for i, v in enumerate(ONLINE_CUT))
DP_ONLINE_PHASES = ONLINE_PHASES[:5]
# phase 14: the mesh grid at startrax's defaults (resolution, sigma), the
# share of the field's largest density that stands in for sigma where the
# field stays under it, the grid the kernel path is held on against the
# plain path
MESH_RES = 256
MESH_SIGMA = 50.0
MESH_FALLBACK = 0.9
MESH_CHECK = 64
# the spans phase 14b's trace of an app-init step must hold (utils/profiling.span)
SMOKE_SPANS = ("train.step", "train.forward", "train.backward", "train.optimizer",
               "fused_mlp.pack")
# NVIDIA H100 SXM: dense bf16 tensor-core peak, float32 peak outside the
# tensor cores, and memory rate (data sheet)
# phase 9: the occgrid app's config, the scene keys taken from phase 6's
# config (CARLA data is absent), its depth cut, 9a's budgets and rays, the
# rows of a slice of the plain version at the largest shapes, the steps left
# out of a budget's median and the profiled steps; 9b's plain-path slices
OCC_CONFIG = "carla_star_app_init_nerfacc.txt"
SCENE_KEYS = ("synth_height", "synth_views", "synth_val_views", "num_frames", "num_vehicles",
              "near", "far", "scale_factor")
OCC_CUT = ("--epochs_appearance", "3", "--steps_per_epoch", "48")
OCC_BUDGETS = (128, 256, 512)
OCC_RAYS = 4096
PLAIN_ROWS = 524288
OCC_WARM = 4
OCC_PROFILED = (40, 45)
RENDER_CHUNKS = 4
# phase 10: nerf_time's app on phase 6's scene, cut in depth, and its test's
# frames; 10b: the CARLA-format capture and the app's cut on it
NT_APP_CUT = ("--epochs_online", "2", "--steps_per_epoch", "20", "--epoch_val", "1",
              "--epoch_ckpt", "1")
NT_TEST_FRAMES = 2
NT_TEST_CONFIG = "test_carla_nerf_time.txt"
CARLA_HW = (48, 64)
CARLA_CAMS = 57
CARLA_FRAMES = 2
CARLA_VEHICLES = 2
CARLA_CUT = ("--epochs_online", "1", "--steps_per_epoch", "10", "--epoch_val", "1",
             "--epoch_ckpt", "1")
# phase 3e: the stacked pre-encoded mode's fields, and its path's calls
STACKED_ENC_K = 2
STACKED_ENC_CALLS = 3
# phase 11: the Blender-format capture (lego's published 800x800, halved by
# half_res), its views a split, and lego's cut in epochs and steps
BLENDER_HW = (800, 800)
BLENDER_VIEWS = {"train": 16, "val": 2, "test": 2}
BLENDER_RADIUS = 0.5
LEGO_CONFIG = "lego.txt"
LEGO_CUT = ("--epochs_appearance", "2", "--steps_per_epoch", "60", "--epoch_val", "1")
# phase 12: the mip configs, each app's cut in depth and schedule, and the
# test's frames
MIP_APP_CONFIG = "carla_star_app_init_mip.txt"
MIP_ONLINE_CONFIG = "carla_star_online_mip.txt"
MIP_APP_CUT = ("--epochs_appearance", "2", "--steps_per_epoch", "8", "--epoch_ckpt", "1")
MIP_ONLINE_CUT = ("--epochs_online", "2", "--steps_per_epoch", "8", "--accumulate_grad_batches",
                  "4", "--epoch_val", "1", "--epoch_ckpt", "1")
MIP_TEST_CUT = ("--eval_last_frame", "2")
PEAK_FLOPS = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12
# phase 3c: largest error of wgrad_kernel and sum_rows_kernel against their
# plain versions, scaled by the plain result's largest magnitude (both sum
# exact products in f32, in another order)
PART_TOL = {"wgrad": 1e-4, "sum_rows": 1e-5}


def _require(ok, what):
    """A check that stays under python -O: raise when a phase fails."""
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def _counts(**nonzero):
    """A launch-count dict: every counter of kernels.fused_mlp at 0 but the
    ones given."""
    from startrax_torch.kernels import fused_mlp as fm

    return dict.fromkeys(fm.launches, 0) | nonzero


def _part_counts(*fields):
    """The launches of the backward's GEMM and sums in one backward call
    with weight grads for each field config given: one weight-gradient GEMM
    over every wide layer, two sums (the per-CTA and the per-split
    partials)."""
    return {"wgrad": len(fields), "sum_rows": 2 * len(fields)}


def _step_designs():
    """The launches of each kind of the online app's steps with K = 2
    dynamic fields: per-ray, shared-pose, and the gauge fit's on either
    layout (frozen fields: no weight grads, so no GEMM; a shared-pose gauge
    step's four dynamic backward calls sum their pose partials)."""
    return {"per_ray": _counts(fwd=2, bwd=2, stacked_fwd=2, stacked_bwd=2)
            | _part_counts(*range(4)),
            "shared": _counts(fwd=6, bwd=6) | _part_counts(*range(6)),
            "gauge_per_ray": _counts(fwd=2, stacked_fwd=2, stacked_bwd=2) | _part_counts(),
            "gauge_shared": _counts(fwd=6, bwd=4) | {"wgrad": 0, "sum_rows": 4}}


def _deltas(counts, before):
    return {k: counts[k] - before[k] for k in before}


@contextlib.contextmanager
def _patched(module, name, wrap):
    """Within the block, module.name (a step builder) builds wrap(step) in
    place of each step it builds; the builder is restored after the block,
    also when it raises. An app's steps are seen only where the app looks
    the builder up through its module at call time (loop.make_*_train_step,
    or a module-level name of its own), never through a name it imported:
    tests/test_torch_port.py holds the apps to that."""
    make = getattr(module, name)
    setattr(module, name, lambda *args, **kw: wrap(make(*args, **kw)))
    try:
        yield
    finally:
        setattr(module, name, make)


def _recording(steps):
    """A wrap for _patched: each step's launches (fused kernels, GEMM and
    sums) appended to steps. Launch counts are kept on the host, so nothing
    waits for the device."""

    def wrap(step):
        def recorded(*args, **kw):
            before = _launch_snapshot()
            out = step(*args, **kw)
            steps.append(_deltas(_launch_snapshot(), before))
            return out

        return recorded

    return wrap


def _card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _cuda_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _field(cfg, seed, n=None):
    """A field's params from a seed, or a stack of n fields'."""
    import torch

    from startrax_torch import convert
    from startrax_torch.models import fields

    g = torch.Generator().manual_seed(seed)
    params = (fields.init_field(cfg, g, device="cpu") if n is None
              else fields.init_stacked_fields(cfg, n, g, device="cpu"))
    for blk in params["blocks"]:  # nonzero fc1 so every block carries gradient
        blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    return convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                     requires_grad=True)


def _points(n, near, far, seed):
    """n samples along bench-style rays of 256 samples (the last ray cut
    short): normal origins, unit directions."""
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    rays = -(-n // 256)
    o = torch.randn(rays, 1, 3, generator=g, device="cuda")
    d = torch.nn.functional.normalize(torch.randn(rays, 1, 3, generator=g, device="cuda"), dim=-1)
    z = torch.linspace(near, far, 256, device="cuda")[None, :, None]
    x = (o + d * z).reshape(-1, 3)[:n].contiguous()
    return x, d.expand(-1, 256, -1).reshape(-1, 3)[:n].contiguous()


def kernel_work(params, x, n_blocks, pe, input_grads, warped, save=True):
    """FLOP and bytes of one kernel call's work, forward and backward, as
    {"fwd": (flop, bytes), "bwd": (flop, bytes)}: the multiply-adds of every
    layer at its real widths (the encoding's padding and the PE's sin/cos
    not counted), each input read once and each output written once: the
    points (raw, or encoded with pe=None), the f32 params, the output, the
    saved bf16 activations (written forward, read backward), the cotangent,
    the param grads and, with input grads, dx and dd. params and x may be
    stacked over K fields ([K, ...] leaves, x [K, N, C]). save=False: a
    forward that saves no activations (under no_grad). "bwd_tile" is the
    per-tile backward kernel's share of "bwd": the data-grad multiply-adds,
    the points, the saved activations it reads (all but feat, which only
    the weight-gradient GEMM reads) and the cotangent, the params read
    once, the bf16 dY of every layer and the bf16 encodings written (for
    the weight-gradient GEMM), and the input grads."""
    w_in = params["lin_in"]["w"]
    K = x.shape[0] if x.dim() == 3 else 1
    n = K * x.shape[-2]
    W, in_ch = w_in.shape[-1], w_in.shape[-2]
    view_ch, w2 = params["views"]["w"].shape[-2] - W, W // 2
    macs = in_ch * W + (2 * n_blocks + 2) * W * W + W + (W + view_ch) * w2 + 3 * w2
    # the backward's data grads skip lin_in and Wv_bot unless dx, dd are needed
    data = macs - (0 if input_grads or warped else in_ch * W + view_ch * w2)
    from startrax_torch.utils.tree import tree_leaves

    param_bytes = 4 * sum(t.numel() for t in tree_leaves(params))
    in_bytes = 4 * ((in_ch + view_ch) if pe is None else 6)
    act_bytes = 2 * ((2 * n_blocks + 3) * W + w2)
    fwd = (2 * macs * n, n * (in_bytes + (act_bytes if save else 0) + 16) + param_bytes)
    bwd = (2 * (macs + data) * n,
           n * (in_bytes + act_bytes + 16 + (in_bytes if input_grads else 0)) + 2 * param_bytes)
    from startrax_torch.kernels import fused_mlp as fm

    enc_bytes = 2 * ((fm.EW if pe is not None else fm.XW) + fm.EW)
    tile_reads = act_bytes - 2 * W  # every saved activation but feat
    dy_bytes = act_bytes  # one bf16 dY a wide layer, as wide as its saved output
    bwd_tile = (2 * data * n, n * (in_bytes + tile_reads + dy_bytes + 16 + enc_bytes
                                   + (in_bytes if input_grads else 0)) + param_bytes)
    return {"fwd": fwd, "bwd": bwd, "bwd_tile": bwd_tile}


def bound(flop, nbytes, peak=PEAK_FLOPS):
    """(bound ms, "operations" or "bytes"): the larger of flop at the peak
    (bf16 tensor cores unless given) and bytes at the memory rate."""
    t_op, t_b = flop / peak * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_op, "operations") if t_op >= t_b else (t_b, "bytes")


def kernel_cases(star_cfg, n_rand):
    """The field calls of one online step, as (name, field config, points,
    warped, masked, calls per online step): each field's coarse and fine
    call, the dynamic field's K times. The BARF case is off the flagship
    step (end_barf <= 0) and is checked, not timed."""
    n_coarse = n_rand * star_cfg.n_samples
    n_fine = n_rand * (star_cfg.n_samples + star_cfg.n_importance)
    K = star_cfg.num_vehicles
    return [("static coarse", star_cfg.static_field(), n_coarse, False, False, 1),
            ("static fine", star_cfg.static_field(True), n_fine, False, False, 1),
            ("dynamic coarse", star_cfg.dynamic_field(), n_coarse, True, False, K),
            ("dynamic fine", star_cfg.dynamic_field(True), n_fine, True, False, K),
            ("dynamic fine+barf", star_cfg.dynamic_field(True), n_fine, True, True, 0)]


def case_inputs(star_cfg, case, seed):
    """Random inputs of one kernel case, as parity.compare takes them."""
    import torch

    from startrax_torch.kernels.fused_mlp import pe_mask_row
    from startrax_torch.models.star import pack_warp
    from startrax_torch.ops.encoding import barf_weights

    _, fcfg, n_points, warped, masked, _ = case
    pe = (star_cfg.multires, star_cfg.multires_views)
    x, d = _points(n_points, star_cfg.near, star_cfg.far, seed=20 + seed)
    pose = torch.tensor([0.01, -0.02, 0.005, 0.1, 0.2, -0.1, 0.97], device="cuda")
    pose = (pose / torch.cat([torch.ones(3, device="cuda"), pose[3:].norm().expand(4)]))
    pose.requires_grad_(True)
    masks = None
    if masked:
        masks = tuple(pe_mask_row(barf_weights(37, 100, f, device="cuda"), f) for f in pe)
    return {"params": _field(fcfg, seed=10 + seed), "x": x, "d": d, "n_blocks": fcfg.n_blocks,
            "pe": pe, "pe_masks": masks, "warp": pack_warp(pose) if warped else None,
            "pose": pose if warped else None}


MEASURES = ("fwd", "fwd_rms", "w", "input", "input_rms", "pose", "ray_pose", "fwd_abs",
            "grad_abs")
STEP_TIMES = ("fwd", "plain_fwd", "bwd", "plain_bwd", "fwd_flop", "fwd_bytes", "bwd_flop",
              "bwd_bytes", "bwd_tile_flop", "bwd_tile_bytes")


def _check_and_time(label, inp, stacked, calls, worst, step_ms):
    """One case's kernels against their plain version (parity.compare), its
    readings folded into worst; for a case the step runs (calls > 0), both
    sides timed in turns (plain, kernel, kernel, plain), the forward with
    grad on as a training step runs it, and calls x each time and x the
    call's work (kernel_work) added to step_ms."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm, parity

    errs, run = parity.compare(**inp, stacked=stacked)
    torch.cuda.synchronize()
    print(f"kernel-vs-plain {label}: "
          + ", ".join(f"{k} {errs[k]:.3e} (limit {lim})"
                      for k, lim in parity.limits(errs).items() if k in errs), flush=True)
    for k in worst:
        worst[k] = max(worst[k], errs.get(k, 0.0))
    _require(not parity.failures(errs), f"{label}: kernel vs plain: {parity.failures(errs)}")
    if not calls:
        return
    weights = fm.flatten_params(inp["params"], inp["n_blocks"])
    args = (inp["n_blocks"], inp["pe"])

    def kernel():
        if stacked:
            a, r = fm.fused_stacked_apply(inp["params"], inp["x"], inp["d"], *args,
                                          pe_masks=inp["pe_masks"])
        else:
            a, r = fm.fused_field_apply(inp["params"], inp["x"], inp["d"], *args,
                                        pe_masks=inp["pe_masks"], warp=inp["warp"])
        return torch.cat([a[..., None], r], -1)

    def plain():
        if stacked:
            return fm.fused_stacked_plain(inp["x"], inp["d"], weights, *args, masks=inp["pe_masks"])
        return fm.fused_mlp_plain(inp["x"], inp["d"], weights, *args, warp=inp["warp"],
                                  masks=inp["pe_masks"])

    t = {k: [] for k in STEP_TIMES[:4]}
    for order in (("plain", "kernel"), ("kernel", "plain")):
        for side in order:
            fwd, out = (kernel, run["out_k"]) if side == "kernel" else (plain, run["out_p"])
            prefix = "" if side == "kernel" else "plain_"
            t[prefix + "fwd"].append(_cuda_ms(fwd, 3))
            t[prefix + "bwd"].append(_cuda_ms(
                lambda: torch.autograd.grad(out, run["leaves"], run["cot"], retain_graph=True), 3))
    t = {k: statistics.mean(v) for k, v in t.items()}
    work = kernel_work(inp["params"], inp["x"], inp["n_blocks"], inp["pe"],
                       inp["x"].requires_grad or inp["d"].requires_grad, inp["warp"] is not None)
    t.update(fwd_flop=work["fwd"][0], fwd_bytes=work["fwd"][1], bwd_flop=work["bwd"][0],
             bwd_bytes=work["bwd"][1], bwd_tile_flop=work["bwd_tile"][0],
             bwd_tile_bytes=work["bwd_tile"][1])
    for k, v in t.items():
        step_ms[k] += calls * v
    print(f"time {label}: " + ", ".join(f"{k} {t[k]:.3f} ms" for k in STEP_TIMES[:4])
          + ", bound fwd {:.3f} ms ({}), bwd {:.3f} ms ({})".format(
              *bound(*work["fwd"]), *bound(*work["bwd"])), flush=True)


def phase_kernels(star_cfg, n_rand):
    """Each kernel against its plain version at the shapes one online step
    gives it, with both timed. Returns the worst readings and the times
    summed over the six calls of one online step."""
    import torch

    worst, step_ms = dict.fromkeys(MEASURES, 0.0), dict.fromkeys(STEP_TIMES, 0.0)
    for i, case in enumerate(kernel_cases(star_cfg, n_rand)):
        name, fcfg, n_points, _, _, calls = case
        _check_and_time(f"{name} {fcfg.depth}x{fcfg.width} N={n_points}",
                        case_inputs(star_cfg, case, i), False, calls, worst, step_ms)
        torch.cuda.empty_cache()
    print("time of the six field calls of one online step: "
          + ", ".join(f"{k} {step_ms[k]:.3f} ms" for k in STEP_TIMES[:4]), flush=True)
    return worst, step_ms


def backward_part_cases(star_cfg, n_rand, online_cfg, online_rays, slice_cfg, slice_rays, nt_cfg,
                        nt_rays, occ_field):
    """The backward calls whose GEMM and sums phase 3c checks and times, as
    (path, name, width, n_blocks, lin_in's rows, fields, points per field,
    calls per step of the path): the field calls of one shared-pose online
    step at the flagship's widths and at the online app's, the per-ray
    step's stacked fine call (K fields a launch), the nerf_time fine call
    (lin_in's 96 rows) and the occgrid step's call at its first and last
    budget (occ_field, OCC_RAYS rays)."""
    from startrax_torch.kernels.fused_mlp import EW, XW

    out = [(path, name, f.width, f.n_blocks, EW, 1, n, calls)
           for path, cfg, rays in (("shared-pose", star_cfg, n_rand),
                                   ("online shared-pose", online_cfg, online_rays))
           for name, f, n, _, _, calls in kernel_cases(cfg, rays) if calls]
    name, f, rays, samples, _, calls = stacked_cases(slice_cfg, slice_rays, star_cfg, n_rand)[1]
    out.append(("per-ray", f"stacked {name} K={slice_cfg.num_vehicles}", f.width, f.n_blocks, EW,
                slice_cfg.num_vehicles, rays * samples, calls))
    name, f, n, _, calls = nerf_time_cases(nt_cfg, nt_rays)[1]
    out.append(("nerf_time", f"pre-encoded {name}", f.width, f.n_blocks, XW, 1, n, calls))
    out += [(f"occgrid budget {b}", f"static {occ_field.depth}x{occ_field.width}", occ_field.width,
             occ_field.n_blocks, EW, 1, OCC_RAYS * b, 1) for b in (OCC_BUDGETS[0], OCC_BUDGETS[-1])]
    return out


def _device_ms(fns, reps=3):
    """{i: the device time of fns[i]'s kernels, in ms a call}, from a
    torch.profiler trace of reps calls of each fn after one warm-up call."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for i, fn in enumerate(fns):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        out[i] = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / reps
    return out


def phase_backward_parts(cases):
    """The backward's weight-gradient GEMM (wgrad_kernel, one launch over
    every wide layer of a call) and ordered sums (sum_rows_kernel, one
    launch a sum) of backward_part_cases' calls, each against its plain
    version on random bf16 X and dY of every wide layer's shapes (the sums
    on the GEMM's split partials and on random per-CTA partials), then both
    timed in turns with a library yardstick the port never calls: for the
    GEMM one torch.mm(X^T, dY) a layer and field in bf16 (it writes bf16
    dW, not f32 split partials, and applies no relu to X), for the sums one
    torch.sum over the rows a sum. Times: CUDA events over back-to-back
    calls (host time between launches included where it exceeds the
    kernel's) and the device time of a profiler trace. Work: the function's
    own, X and dY read once and dW written once in f32; each sum's inputs
    read once and its outputs written once. Returns {"wgrad": ...,
    "sum_rows": ...}, each with its worst scaled and absolute error, the
    shared-pose step's times, flop and bytes summed over its calls, and
    "paths": the same per path of the calls its cases stand for."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm

    keys = ("ms", "plain_ms", "library_ms", "device_ms", "library_device_ms", "flop", "bytes")
    out = {k: {"err": 0.0, "abs": 0.0, **dict.fromkeys(keys, 0.0), "paths": {}} for k in PART_TOL}
    g = torch.Generator(device="cuda").manual_seed(30)

    def check(name, got, want):
        a = float((got - want).abs().max())
        e = a / float(want.abs().max())
        print(f"{name}: max abs err {a:.3e}, scaled {e:.3e} (tol {PART_TOL[name]})", flush=True)
        out[name]["abs"] = max(out[name]["abs"], a)
        out[name]["err"] = max(out[name]["err"], e)
        _require(e <= PART_TOL[name], f"{name} kernel vs plain: {e:.3e}")

    for path, name, width, n_blocks, in_rows, K, n, calls in cases:
        print(f"backward parts of {name} ({path}) {width} wide, {n_blocks} blocks, lin_in {in_rows} "
              f"rows, K={K}, N={n}/field", flush=True)
        shapes = fm.wgrad_shapes(width, n_blocks, in_rows)
        relus = [r for _, r, _ in shapes]
        splits = fm.wgrad_layout(shapes, n, K)["splits"]
        xs = [torch.randn((K, n, k), generator=g, device="cuda").to(torch.bfloat16)
              for k, _, _ in shapes]
        dys = [torch.randn((K, n, m), generator=g, device="cuda").to(torch.bfloat16)
               for _, _, m in shapes]
        sizes = [k * m for k, _, m in shapes]
        total = fm._partial_offsets(width, n_blocks)["total"]
        part = torch.randn((K, -(-n // 64), total), generator=g, device="cuda")
        wpart = fm.wgrad(xs, dys, relus)
        check("wgrad", wpart, fm.wgrad_grouped_plain(xs, dys, relus, splits))
        for src in (part, wpart):
            check("sum_rows", fm.sum_rows(src), fm.sum_rows_plain(src))

        def gemm():
            return fm.wgrad(xs, dys, relus)

        def gemm_plain():
            return fm.wgrad_grouped_plain(xs, dys, relus, splits)

        def gemm_library():
            return [torch.mm(X[k].t(), dY[k]) for X, dY in zip(xs, dys) for k in range(K)]

        def sums(f):  # the two sums of one backward call
            return f(part), f(wpart)

        def sums_library():
            return part.sum(1), wpart.sum(1)

        t = {"wgrad": [gemm, gemm_plain, gemm_library],
             "sum_rows": [lambda: sums(fm.sum_rows), lambda: sums(fm.sum_rows_plain), sums_library]}
        ms = {k: [0.0, 0.0, 0.0] for k in t}
        for order in ((0, 2), (2, 0)):  # kernel and library in turns, the plain version once
            for k, fns in t.items():
                for i in order:
                    ms[k][i] += _cuda_ms(fns[i], 3) / 2
        for k, fns in t.items():
            ms[k][1] = _cuda_ms(fns[1], 2)
        dev = {k: _device_ms([fns[0], fns[2]]) for k, fns in t.items()}
        sum_in = part.numel() + wpart.numel()
        sum_out = K * (total + sum(sizes))
        work = {"wgrad": (sum(2.0 * K * n * s for s in sizes),
                          sum(2.0 * K * n * (k + m) for k, _, m in shapes) + 4.0 * K * sum(sizes)),
                "sum_rows": (float(sum_in), 4.0 * (sum_in + sum_out))}
        for k in t:
            vals = {"ms": ms[k][0], "plain_ms": ms[k][1], "library_ms": ms[k][2],
                    "device_ms": dev[k][0], "library_device_ms": dev[k][1], "flop": work[k][0],
                    "bytes": work[k][1]}
            acc = out[k]["paths"].setdefault(path, dict.fromkeys(keys, 0.0))
            for key, v in vals.items():
                acc[key] += calls * v
                if path == "shared-pose":
                    out[k][key] += calls * v
        print(f"time {name} backward parts: wgrad {ms['wgrad'][0]:.3f} ms, device "
              f"{dev['wgrad'][0]:.3f} (plain {ms['wgrad'][1]:.3f}, torch.mm {ms['wgrad'][2]:.3f}, "
              f"device {dev['wgrad'][1]:.3f}, bound {bound(*work['wgrad'])[0]:.3f}); sum_rows "
              f"{ms['sum_rows'][0]:.4f} ms, device {dev['sum_rows'][0]:.4f} (plain "
              f"{ms['sum_rows'][1]:.4f}, torch.sum {ms['sum_rows'][2]:.4f}, device "
              f"{dev['sum_rows'][1]:.4f}, bound {bound(*work['sum_rows'], PEAK_F32)[0]:.4f})",
              flush=True)
        del xs, dys, wpart, part
        torch.cuda.empty_cache()
    for k in out:
        for path, r in out[k]["paths"].items():
            r["bound_ms"] = bound(r["flop"], r["bytes"], PEAK_FLOPS if k == "wgrad" else PEAK_F32)[0]
            print(f"{k}, {path} step's calls: " + ", ".join(f"{key} {r[key]:.4f}" for key in
                                                            ("ms", "device_ms", "library_ms",
                                                             "library_device_ms", "bound_ms")),
                  flush=True)
    return out


def stacked_cases(slice_cfg, n_rand, flagship_cfg, flagship_rays):
    """The field-axis kernel's cases, as (name, field config, rays, samples
    per ray, masked, calls per per-ray step): the slice's dynamic fields on
    each pass, without and with the BARF mask of slice_cfg's end_barf at
    BARF_STEP (the warmup steps' masked calls are checked, not timed), and
    the flagship width's fine pass."""
    s_c = slice_cfg.n_samples
    s_f = s_c + slice_cfg.n_importance
    dyn_c, dyn_f = slice_cfg.dynamic_field(), slice_cfg.dynamic_field(True)
    return [("dynamic coarse", dyn_c, n_rand, s_c, False, 1),
            ("dynamic fine", dyn_f, n_rand, s_f, False, 1),
            ("dynamic coarse+barf", dyn_c, n_rand, s_c, True, 0),
            ("dynamic fine+barf", dyn_f, n_rand, s_f, True, 0),
            ("flagship dynamic fine", flagship_cfg.dynamic_field(True), flagship_rays,
             flagship_cfg.n_samples + flagship_cfg.n_importance, False, 0)]


def stacked_case_inputs(star_cfg, case, seed):
    """Random inputs of one field-axis case, as parity.compare takes them:
    K fields on the samples of bench-style rays, warped into each vehicle's
    frame by a per-ray pose leaf [R, K, 7]."""
    import torch

    from startrax_torch.models.fields import barf_masks
    from startrax_torch.models.star import warp_to_vehicle_frames

    _, fcfg, n_rays, n_samples, masked, _ = case
    K = star_cfg.num_vehicles
    pe = (star_cfg.multires, star_cfg.multires_views)
    g = torch.Generator(device="cuda").manual_seed(40 + seed)
    o = torch.randn(n_rays, 1, 3, generator=g, device="cuda")
    dirs = torch.nn.functional.normalize(torch.randn(n_rays, 3, generator=g, device="cuda"), dim=-1)
    z = torch.linspace(star_cfg.near, star_cfg.far, n_samples, device="cuda")[None, :, None]
    q = torch.tensor([0.0, 0.0, 0.0, 1.0], device="cuda") \
        + 0.05 * torch.randn(n_rays, K, 4, generator=g, device="cuda")
    pose = torch.cat([0.1 * torch.randn(n_rays, K, 3, generator=g, device="cuda"),
                      torch.nn.functional.normalize(q, dim=-1)], -1).requires_grad_(True)
    pts_dyn, dirs_dyn = warp_to_vehicle_frames(pose, o + dirs[:, None, :] * z, dirs)
    n = n_rays * n_samples
    return {"params": _field(fcfg, seed=50 + seed, n=K),
            "x": pts_dyn.reshape(K, n, 3).contiguous(),
            "d": dirs_dyn[:, :, None, :].expand(K, n_rays, n_samples, 3).reshape(K, n, 3)
            .contiguous(),
            "n_blocks": fcfg.n_blocks, "pe": pe,
            "pe_masks": barf_masks(fcfg, BARF_STEP, "cuda") if masked else None, "warp": None,
            "pose": pose}


def phase_field_axis(slice_cfg, n_rand, flagship_cfg, flagship_rays):
    """The field-axis kernel against its plain version (stacked cases), and
    the per-field kernel on the slice's static field, each timed where the
    per-ray step runs it. slice_cfg is the BARF warmup's StarConfig.
    Returns (worst, step_ms) of the stacked cases and of the static ones,
    the times summed over one per-ray step's calls."""
    import torch

    worst_s, ms_s = dict.fromkeys(MEASURES, 0.0), dict.fromkeys(STEP_TIMES, 0.0)
    for i, case in enumerate(stacked_cases(slice_cfg, n_rand, flagship_cfg, flagship_rays)):
        name, fcfg, n_rays, n_samples, _, calls = case
        _check_and_time(f"stacked {name} K={slice_cfg.num_vehicles} {fcfg.depth}x{fcfg.width} "
                        f"N={n_rays * n_samples}/field",
                        stacked_case_inputs(slice_cfg, case, i), True, calls, worst_s, ms_s)
        torch.cuda.empty_cache()
    worst_f, ms_f = dict.fromkeys(MEASURES, 0.0), dict.fromkeys(STEP_TIMES, 0.0)
    for i, case in enumerate(kernel_cases(slice_cfg, n_rand)[:2]):  # static coarse and fine
        name, fcfg, n_points, _, _, calls = case
        _check_and_time(f"slice {name} {fcfg.depth}x{fcfg.width} N={n_points}",
                        case_inputs(slice_cfg, case, 10 + i), False, calls, worst_f, ms_f)
        torch.cuda.empty_cache()
    for what, ms in (("stacked dynamic", ms_s), ("static", ms_f)):
        print(f"time of the {what} field calls of one per-ray step: "
              + ", ".join(f"{k} {ms[k]:.3f} ms" for k in STEP_TIMES[:4]), flush=True)
    return worst_s, ms_s, worst_f, ms_f


def phase_online_kernels(online_cfg, n_rand):
    """3d: the per-field kernel at the shapes one shared-pose step of the
    online app gives it (the static field, and the dynamic fields with the
    in-kernel warp and the pose sums), each against its plain version and
    timed. Returns the worst readings."""
    import torch

    worst, ms = dict.fromkeys(MEASURES, 0.0), dict.fromkeys(STEP_TIMES, 0.0)
    for i, case in enumerate(kernel_cases(online_cfg, n_rand)[:4]):  # not the BARF case
        name, fcfg, n_points, _, _, calls = case
        _check_and_time(f"online {name} {fcfg.depth}x{fcfg.width} N={n_points}",
                        case_inputs(online_cfg, case, 20 + i), False, calls, worst, ms)
        torch.cuda.empty_cache()
    print("time of the six field calls of one shared-pose step of the online app: "
          + ", ".join(f"{k} {ms[k]:.3f} ms" for k in STEP_TIMES[:4]), flush=True)
    return worst


def _batch(n_rand, num_frames=None, near=None, far=None):
    """bench.py's fixed batch: normal origins, unit directions, uniform
    target, frame FRAME. With num_frames, a mixed-frame batch: per-ray frames
    drawn uniformly from [0, num_frames) and a uniform target depth in
    [near, far]."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    rays_o = rng.normal(size=(n_rand, 3)).astype(np.float32)
    rays_d = rng.normal(size=(n_rand, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    target = rng.uniform(size=(n_rand, 3)).astype(np.float32)
    batch = {"rays_o": torch.tensor(rays_o, device="cuda"),
             "rays_d": torch.tensor(rays_d, device="cuda"),
             "target": torch.tensor(target, device="cuda"), "frame": FRAME}
    if num_frames is not None:
        depth = rng.uniform(near, far, size=n_rand).astype(np.float32)
        batch.update(target_depth=torch.tensor(depth, device="cuda"),
                     frame=torch.tensor(rng.integers(0, num_frames, size=n_rand), device="cuda"))
    return batch


def _online(star_cfg, loss_cfg, cfg, seed):
    import torch

    from startrax_torch.train import loop, optim

    params = loop.init_online_params(
        star_cfg, cfg.num_frames, generator=torch.Generator(device="cuda").manual_seed(seed),
        device="cuda")
    # as bench.py builds it: three LR groups, milestone decay at epoch 60, clip 1.0
    opt = optim.make_fused_star_optimizer(params, lrate_static=cfg.lrate_static,
                                          lrate_dynamic=cfg.lrate_dynamic,
                                          lrate_pose=cfg.lrate_pose, steps_per_epoch=100,
                                          decay_milestones=cfg.lrate_decay_steps, grad_clip=1.0)
    return params, opt, loop.make_online_train_step(star_cfg, loss_cfg, opt)


def _run_steps(step, n, *args, **kw):
    """n calls of step(*args, **kw); returns their losses."""
    return [float(step(*args, **kw)[0]) for _ in range(n)]


def phase_main_path(cfg, star_cfg, loss_cfg):
    import dataclasses

    import torch

    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.models.star import render_star
    from startrax_torch.train import loop, optim

    batch = _batch(cfg.N_rand)
    gen = torch.Generator(device="cuda").manual_seed(1)
    params, opt, step = _online(star_cfg, loss_cfg, cfg, seed=0)
    app_opt = optim.make_appinit_optimizer(params["nerf"], lrate=cfg.lrate)
    app_step = loop.make_appinit_train_step(star_cfg, loss_cfg, app_opt)

    fm.reset_launch_counts()
    app_losses = _run_steps(app_step, N_APPINIT, params["nerf"], batch, generator=gen)
    after_app = dict(fm.launches)
    losses = _run_steps(step, N_ONLINE, params, batch, epoch=0, generator=gen)
    counts, parts = dict(fm.launches), dict(fm.part_launches)
    print(f"app-init losses {app_losses}", flush=True)
    print(f"online losses {losses}", flush=True)
    print(f"launches after {N_APPINIT} app-init steps {after_app}, after {N_ONLINE} online "
          f"steps {counts}", flush=True)
    n_app, n_all = 2 * N_APPINIT, 2 * N_APPINIT + 6 * N_ONLINE
    _require(after_app == _counts(fwd=n_app, bwd=n_app),
             f"2 launches of each per-field kernel per app-init step, got {after_app}")
    _require(counts == _counts(fwd=n_all, bwd=n_all),
             f"6 launches of each per-field kernel per online step, none stacked, got {counts}")
    cases = kernel_cases(star_cfg, cfg.N_rand)
    app = _part_counts(*(c[1] for c in cases[:2]))
    online = _part_counts(*(c[1] for c in cases for _ in range(c[5])))
    want = {k: N_APPINIT * app[k] + N_ONLINE * online[k] for k in app}
    print(f"backward parts' launches after {N_APPINIT} app-init and {N_ONLINE} online steps {parts}",
          flush=True)
    _require(parts == want, f"launches of the backward's GEMM and sums {want}, got {parts}")
    _require(all(math.isfinite(v) for v in app_losses + losses), "finite losses")
    _require(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]), "the loss falls")
    print(f"kernel path: peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
          flush=True)

    # the same batch through the kernel path and the plain path at a small size
    small = {k: (v[:64] if torch.is_tensor(v) else v) for k, v in batch.items()}
    plain_cfg = dataclasses.replace(star_cfg, use_fused=False)
    u_strat = torch.rand((64, star_cfg.n_samples), generator=gen, device="cuda")
    u_pdf = torch.rand((64, star_cfg.n_importance), generator=gen, device="cuda")
    pose = loop.gather_frame_pose(params["poses"], FRAME, star_cfg.num_vehicles)
    with torch.no_grad():
        outs = [render_star(params["nerf"], c, small["rays_o"], small["rays_d"], pose=pose,
                            u_strat=u_strat, u_pdf=u_pdf) for c in (star_cfg, plain_cfg)]
    for k in ("rgb0", "rgb"):
        _require(outs[0][k].shape == (64, 3) and bool(torch.isfinite(outs[0][k]).all()),
                 f"render {k}: finite [64, 3]")
        err = float((outs[0][k] - outs[1][k]).abs().max())
        print(f"render {k}: kernel path vs plain path max abs err {err:.3e} (tol 2e-2)",
              flush=True)
        _require(err <= 2e-2, f"render {k}: kernel path vs plain path")
    after = dict(fm.launches)
    del params, opt, step, app_opt, app_step, outs
    torch.cuda.empty_cache()

    # one step of the plain path (use_fused=False), same shapes
    params, opt, step = _online(plain_cfg, loss_cfg, cfg, seed=0)
    plain_losses = _run_steps(step, 1, params, batch, epoch=0, generator=gen)
    print(f"plain path: loss {plain_losses}", flush=True)
    _require(all(math.isfinite(v) for v in plain_losses), "a finite plain-path loss")
    _require(dict(fm.launches) == after, "the plain path launches no kernel")
    del params, opt, step
    torch.cuda.empty_cache()
    return counts, parts


def _per_ray_online(cfg, star_cfg, seed):
    """Online params with a noisy pose table, and the optimizer as
    apps/online.py builds it for the config (accumulation, clip 1.0)."""
    import numpy as np
    import torch

    from startrax_torch.train import loop, optim

    rng = np.random.default_rng(seed)
    K, F = star_cfg.num_vehicles, cfg.num_frames
    q = np.array([0.0, 0.0, 0.0, 1.0]) + 0.02 * rng.normal(size=(F - 1, K, 4))
    poses = np.concatenate([0.05 * rng.normal(size=(F - 1, K, 3)),
                            q / np.linalg.norm(q, axis=-1, keepdims=True)], -1)
    params = loop.init_online_params(
        star_cfg, F, generator=torch.Generator(device="cuda").manual_seed(seed), device="cuda",
        init_poses=poses.astype(np.float32))
    opt = optim.make_fused_star_optimizer(
        params, lrate_static=cfg.lrate_static, lrate_dynamic=cfg.lrate_dynamic,
        lrate_pose=cfg.lrate_pose, decay_rate=cfg.lrate_decay_rate, decay_epochs=cfg.lrate_decay,
        decay_milestones=cfg.lrate_decay_steps, pose_decay_rate=cfg.pose_lrate_decay_rate,
        pose_decay_epochs=cfg.pose_lrate_decay, pose_decay_milestones=cfg.pose_lrate_decay_steps,
        steps_per_epoch=cfg.steps_per_epoch, grad_clip=1.0,
        accumulate_steps=cfg.accumulate_grad_batches)
    return params, opt


def phase_per_ray_path(cfg, star_cfg, star_cfg_barf, loss_cfg):
    """The per-ray-pose path at the slice's configuration (module docstring,
    phase 4b). Returns the launch counts of its kernel-path run."""
    import dataclasses

    import torch

    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.models.star import render_star
    from startrax_torch.ops import lie
    from startrax_torch.train import loop, optim
    from startrax_torch.utils.tree import tree_leaves

    K, k_acc = star_cfg.num_vehicles, cfg.accumulate_grad_batches
    batch = _batch(cfg.N_rand, cfg.num_frames, star_cfg.near, star_cfg.far)
    gen = torch.Generator(device="cuda").manual_seed(3)
    torch.cuda.reset_peak_memory_stats()
    params, opt = _per_ray_online(cfg, star_cfg, seed=4)
    warmup = loop.make_online_train_step(star_cfg_barf, loss_cfg, opt,
                                         freeze_rot=cfg.barf_freeze_rot)
    joint = loop.make_online_train_step(star_cfg, loss_cfg, opt)
    nerf = params["nerf"]
    # leaves an update must move: two fields' weights and the translations
    watched = [lambda: nerf["static_coarse"]["lin_in"]["w"],
               lambda: nerf["dynamic_fine"]["rgb"]["w"], lambda: params["poses"][..., :3]]
    online_launches = _counts(fwd=2, bwd=2, stacked_fwd=2, stacked_bwd=2)
    gauge_launches = _counts(fwd=2, stacked_fwd=2, stacked_bwd=2)
    # every backward call of an online step forms weight grads; the gauge
    # step's fields are detached and warp nothing, so it forms no partials
    online_parts = _part_counts(star_cfg.static_field(), star_cfg.static_field(True),
                                star_cfg.dynamic_field(), star_cfg.dynamic_field(True))
    gauge_parts = _part_counts()
    mini_steps = [0]

    def run(step, n, launches_per_step, parts_per_step):
        """n calls of step() -> loss, each held to its launches, the
        backward's GEMM and sums included; an online step also to the
        accumulation rhythm. Returns the losses."""
        losses = []
        for _ in range(n):
            before = [w().detach().clone() for w in watched]
            counts0, parts0 = dict(fm.launches), dict(fm.part_launches)
            losses.append(float(step()))
            delta = _deltas(fm.launches, counts0)
            _require(delta == launches_per_step,
                     f"launches per step {launches_per_step}, got {delta}")
            delta = _deltas(fm.part_launches, parts0)
            _require(delta == parts_per_step,
                     f"launches of the backward's GEMM and sums per step {parts_per_step}, "
                     f"got {delta}")
            if launches_per_step is online_launches:
                changed = any(not torch.equal(b, w().detach()) for b, w in zip(before, watched))
                mini_steps[0] += 1
                _require(changed == (mini_steps[0] % k_acc == 0),
                         f"mini-step {mini_steps[0]}: parameters changed {changed}, an update "
                         f"every {k_acc} steps")
        return losses

    fm.reset_launch_counts()
    warm_losses = run(lambda: warmup(params, batch, epoch=BARF_STEP, generator=gen)[0],
                      N_WARMUP, online_launches, online_parts)

    def joint_step():
        return joint(params, batch, epoch=cfg.end_barf, generator=gen)[0]

    joint_losses = run(joint_step, 1, online_launches, online_parts)
    grad = params["poses"].grad
    for f in sorted(set(batch["frame"].tolist()) - {0}):
        _require(bool((grad[f - 1].abs().amax(-1) > 0).all()),
                 f"frame {f}: a non-zero pose grad for every vehicle after one joint step")
    joint_losses += run(joint_step, N_JOINT - 1, online_launches, online_parts)

    grads_before = [(leaf, leaf.grad, leaf.grad.clone()) for leaf in tree_leaves(params)]
    gauge = lie.se3_identity(K, device="cuda").requires_grad_(True)
    gauge_step = loop.make_gauge_train_step(
        star_cfg, optim.make_gauge_optimizer(gauge, cfg.lrate_pose),
        freeze_rot=cfg.gauge_freeze_rot, depth_lambda=cfg.gauge_depth_lambda)
    batch0 = dict(batch, frame=torch.zeros_like(batch["frame"]))  # frame-0 rays
    gauge_losses = run(lambda: gauge_step(gauge, nerf, params["poses"], batch0, generator=gen),
                       N_GAUGE, gauge_launches, gauge_parts)
    counts = dict(fm.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"per-ray path: BARF warmup losses {warm_losses}", flush=True)
    print(f"per-ray path: joint losses {joint_losses}", flush=True)
    print(f"per-ray path: gauge losses {gauge_losses}, gauge {gauge.detach().tolist()}", flush=True)
    print(f"per-ray path: launches after {N_WARMUP} warmup + {N_JOINT} joint + {N_GAUGE} gauge "
          f"steps {counts}; optimizer updates {opt.count}", flush=True)
    n_online = N_WARMUP + N_JOINT
    _require(counts == {k: n_online * online_launches[k] + N_GAUGE * gauge_launches[k]
                        for k in counts}, f"launch counts of the per-ray path, got {counts}")
    _require(opt.count == n_online // k_acc, f"{n_online // k_acc} optimizer updates")
    _require(all(math.isfinite(v) for v in warm_losses + joint_losses + gauge_losses),
             "finite losses")
    _require(statistics.mean(joint_losses[-4:]) < statistics.mean(joint_losses[:4]),
             "the joint loss falls")
    q = gauge.detach()[:, 3:7]
    _require(bool(torch.equal(q, torch.tensor([[0.0, 0.0, 0.0, 1.0]] * K, device="cuda"))),
             f"the gauge rotation stays identity, got {q.tolist()}")
    _require(bool(gauge.detach()[:, :3].abs().amax() > 0), "the gauge translation moves")
    _require(all(leaf.grad is g and torch.equal(leaf.grad, c) for leaf, g, c in grads_before),
             "the gauge step leaves the fields' and poses' grads untouched")
    print(f"per-ray path, kernel path: peak memory {peak_gb:.2f} GB", flush=True)

    # the kernel path's render against the plain path's on a small batch,
    # per-ray poses, without and with the BARF mask
    small = {k: v[:64] for k, v in batch.items()}
    pose = loop.gather_frame_pose(params["poses"], small["frame"], K)
    u_strat = torch.rand((64, star_cfg.n_samples), generator=gen, device="cuda")
    u_pdf = torch.rand((64, star_cfg.n_importance), generator=gen, device="cuda")
    for c, step in ((star_cfg, None), (star_cfg_barf, BARF_STEP)):
        with torch.no_grad():
            outs = [render_star(nerf, cc, small["rays_o"], small["rays_d"], pose=pose, step=step,
                                u_strat=u_strat, u_pdf=u_pdf)
                    for cc in (c, dataclasses.replace(c, use_fused=False))]
        for k in ("rgb0", "rgb"):
            _require(outs[0][k].shape == (64, 3) and bool(torch.isfinite(outs[0][k]).all()),
                     f"per-ray render {k}: finite [64, 3]")
            err = float((outs[0][k] - outs[1][k]).abs().max())
            print(f"per-ray render {k} (BARF step {step}): kernel path vs plain path max abs err "
                  f"{err:.3e} (tol 2e-2)", flush=True)
            _require(err <= 2e-2, f"per-ray render {k}: kernel path vs plain path")
    after = dict(fm.launches)
    del params, opt, warmup, joint, gauge_step, outs, grads_before
    torch.cuda.empty_cache()

    # one joint step of the plain path
    plain_cfg = dataclasses.replace(star_cfg, use_fused=False)
    params, opt = _per_ray_online(cfg, plain_cfg, seed=4)
    plain_losses = _run_steps(loop.make_online_train_step(plain_cfg, loss_cfg, opt), 1, params,
                              batch, epoch=cfg.end_barf, generator=gen)
    print(f"per-ray path, plain path: loss {plain_losses}", flush=True)
    _require(all(math.isfinite(v) for v in plain_losses), "a finite plain-path loss")
    _require(dict(fm.launches) == after, "the plain path launches no kernel")
    del params, opt
    torch.cuda.empty_cache()
    return counts


def nerf_time_cases(star_cfg, n_rand):
    """The pre-encoded kernels' cases, as (name, field config, points, input
    grads, calls per nerf_time step): the coarse and the fine pass's field
    call, then 3,000 ragged points and the coarse shape with input grads
    (dx_emb, dd_emb), checked, not timed."""
    from startrax_torch.models.nerf_time import time_field_cfg

    n_coarse = n_rand * star_cfg.n_samples
    n_fine = n_rand * (star_cfg.n_samples + star_cfg.n_importance)
    coarse, fine = time_field_cfg(star_cfg, False), time_field_cfg(star_cfg, True)
    return [("coarse", coarse, n_coarse, False, 1), ("fine", fine, n_fine, False, 1),
            ("ragged+input grads", fine, 3000, True, 0),
            ("coarse+input grads", coarse, n_coarse, True, 0)]


def nerf_time_case_inputs(star_cfg, case, seed, num_frames):
    """Random inputs of one pre-encoded case, as parity.compare takes them:
    samples along bench-style rays at frame FRAME's time, encoded as
    models.fields.apply_field encodes them (84 and 27 columns)."""
    import torch

    from startrax_torch.ops.encoding import positional_encoding

    _, fcfg, n_points, input_grads, _ = case
    x, d = _points(n_points, star_cfg.near, star_cfg.far, seed=60 + seed)
    x = torch.cat([x, torch.full_like(x[:, :1], FRAME / (num_frames - 1))], -1)
    x_emb = positional_encoding(x, fcfg.multires).contiguous()
    d_emb = positional_encoding(d, fcfg.multires_views).contiguous()
    return {"params": _field(fcfg, seed=70 + seed), "x": x_emb.requires_grad_(input_grads),
            "d": d_emb.requires_grad_(input_grads), "n_blocks": fcfg.n_blocks, "pe": None,
            "pe_masks": None, "warp": None}


def phase_nerf_time(cfg, star_cfg, loss_cfg):
    """The nerf_time path (module docstring, phase 5). Returns the worst
    readings and the times of the pre-encoded kernels (summed over a step's
    two calls) and the launch counts of the kernel path's steps."""
    import dataclasses

    import numpy as np
    import torch

    from startrax_torch.eval.image import psnr, ssim
    from startrax_torch.eval.render import render_image_nerf_time
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.models.nerf_time import init_nerf_time
    from startrax_torch.ops.rays import focal_from_fov, get_rays, intrinsics_matrix
    from startrax_torch.train import loop, optim
    from startrax_torch.utils.tree import tree_leaves

    worst, step_ms = dict.fromkeys(MEASURES, 0.0), dict.fromkeys(STEP_TIMES, 0.0)
    for i, case in enumerate(nerf_time_cases(star_cfg, cfg.N_rand)):
        name, fcfg, n_points, _, calls = case
        _check_and_time(f"pre-encoded {name} {fcfg.depth}x{fcfg.width} in_ch {fcfg.input_ch} "
                        f"N={n_points}", nerf_time_case_inputs(star_cfg, case, i, cfg.num_frames),
                        False, calls, worst, step_ms)
        torch.cuda.empty_cache()
    print("time of the two field calls of one nerf_time step: "
          + ", ".join(f"{k} {step_ms[k]:.3f} ms" for k in STEP_TIMES[:4]), flush=True)

    def setup(c):
        params = init_nerf_time(c, generator=torch.Generator(device="cuda").manual_seed(5),
                                device="cuda")
        for leaf in tree_leaves(params):
            leaf.requires_grad_(True)
        # as apps/nerf_time.py builds it
        opt = optim.make_appinit_optimizer(params, cfg.lrate, steps_per_epoch=cfg.steps_per_epoch,
                                           decay_rate=cfg.lrate_decay_rate,
                                           decay_epochs=cfg.lrate_decay,
                                           decay_milestones=cfg.lrate_decay_steps)
        return params, loop.make_nerf_time_train_step(c, loss_cfg, opt, cfg.num_frames)

    batch = _batch(cfg.N_rand)
    gen = torch.Generator(device="cuda").manual_seed(6)
    torch.cuda.reset_peak_memory_stats()
    params, step = setup(star_cfg)
    fm.reset_launch_counts()
    losses = []
    step_parts = _part_counts(*(c[1] for c in nerf_time_cases(star_cfg, cfg.N_rand)[:2]))
    for _ in range(N_NT):
        before, parts0 = dict(fm.launches), dict(fm.part_launches)
        losses += _run_steps(step, 1, params, batch, generator=gen)
        delta = _deltas(fm.launches, before)
        _require(delta == _counts(enc_fwd=2, enc_bwd=2),
                 f"2 launches of each pre-encoded kernel per nerf_time step, none other, got {delta}")
        delta = _deltas(fm.part_launches, parts0)
        _require(delta == step_parts, f"launches of the backward's GEMM and sums per nerf_time "
                 f"step {step_parts}, got {delta}")
    counts = dict(fm.launches)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"nerf_time losses {losses}", flush=True)
    print(f"launches after {N_NT} nerf_time steps {counts}", flush=True)
    _require(all(math.isfinite(v) for v in losses), "finite nerf_time losses")
    _require(statistics.mean(losses[-3:]) < statistics.mean(losses[:3]), "the nerf_time loss falls")
    print(f"nerf_time kernel path: peak memory {peak_gb:.2f} GB", flush=True)

    # the tiled eval render of one frame, kernel path against plain path
    K = intrinsics_matrix(RENDER_HW, RENDER_HW, focal_from_fov(RENDER_HW, 60.0))
    c2w = np.eye(4, dtype=np.float32)
    c2w[:3, 3] = [0.0, 0.0, 0.5 * (star_cfg.near + star_cfg.far)]
    rays_o, rays_d = get_rays(RENDER_HW, RENDER_HW, K, c2w, device="cuda")
    plain_cfg = dataclasses.replace(star_cfg, use_fused=False)
    before, parts0 = dict(fm.launches), dict(fm.part_launches)
    outs = [render_image_nerf_time(params, c, rays_o, rays_d, FRAME, cfg.num_frames,
                                   device="cuda") for c in (star_cfg, plain_cfg)]
    delta = _deltas(fm.launches, before) | _deltas(fm.part_launches, parts0)
    _require(delta == _counts(enc_fwd=2) | _part_counts(),
             f"the render's launches: 2 pre-encoded forward, got {delta}")
    for k in ("rgb0", "rgb"):
        _require(outs[0][k].shape == (RENDER_HW, RENDER_HW, 3) and np.isfinite(outs[0][k]).all(),
                 f"nerf_time render {k}: finite [{RENDER_HW}, {RENDER_HW}, 3]")
        err = float(np.abs(outs[0][k] - outs[1][k]).max())
        a, b = (torch.tensor(o[k], device="cuda") for o in outs)
        print(f"nerf_time render {k}: kernel path vs plain path max abs err {err:.3e} (tol 2e-2), "
              f"PSNR {float(psnr(a, b)):.2f} dB, SSIM {float(ssim(a, b)):.5f}", flush=True)
        _require(err <= 2e-2, f"nerf_time render {k}: kernel path vs plain path")
    after = dict(fm.launches)
    del params, step, outs
    torch.cuda.empty_cache()

    params, step = setup(plain_cfg)  # one step of the plain path
    plain_losses = _run_steps(step, 1, params, batch, generator=gen)
    print(f"nerf_time plain path: loss {plain_losses}", flush=True)
    _require(all(math.isfinite(v) for v in plain_losses), "a finite plain-path loss")
    _require(dict(fm.launches) == after, "the plain path launches no kernel")
    del params, step
    torch.cuda.empty_cache()
    return worst, step_ms, counts


def phase_scene(cfg):
    """6a: the scaled scene generated on the card into cfg.synth_cache_dir
    (empty), loaded again from the file, and a crop of one view and frame
    held against the numpy marcher."""
    import numpy as np
    import torch

    from startrax_torch.apps.common import make_dataset
    from startrax_torch.data import synthetic as syn

    syn._GEN_MEMO.clear()
    t0 = time.perf_counter()
    train = make_dataset(cfg, "train")
    make_dataset(cfg, "val")
    gen_s = time.perf_counter() - t0
    scene, views = train.scene, cfg.synth_views + cfg.synth_val_views
    files = os.listdir(cfg.synth_cache_dir)
    _require(files == [syn.cache_file(scene, views)], f"one cache file, got {files}")
    generated = syn._GEN_MEMO[syn.cache_key(scene, views)]
    syn._GEN_MEMO.clear()
    t0 = time.perf_counter()
    loaded = make_dataset(cfg, "train")
    load_s = time.perf_counter() - t0
    _require(loaded.data is not generated and all(
        np.array_equal(syn._GEN_MEMO[syn.cache_key(scene, views)][k], v)
        for k, v in generated.items()), "the cache file holds the generated arrays")
    imgs = generated["images"]
    _require(imgs.shape == (views, cfg.num_frames, scene.H, scene.W, 3)
             and bool(np.isfinite(imgs).all()) and generated["dyn_masks"].any(),
             f"a finite scene [V, F, H, W, 3] with vehicles in view, got {imgs.shape}")
    print(f"scene {scene}: {views} views x {cfg.num_frames} frames generated on the card in "
          f"{gen_s:.2f} s ({gen_s / (views * cfg.num_frames) * 1e3:.1f} ms a frame), cache file "
          f"{os.path.getsize(os.path.join(cfg.synth_cache_dir, files[0])) / 1e6:.1f} MB, loaded "
          f"again in {load_s:.2f} s", flush=True)

    # a crop across the left edge of the last frame's vehicle pixels in the
    # first view that has them: vehicle, background and the mask's border
    v, f = next((v, cfg.num_frames - 1) for v in range(views)
                if generated["dyn_masks"][v, cfg.num_frames - 1].any())
    ys, xs = np.nonzero(generated["dyn_masks"][v, f])
    y0, x0 = (min(max(c - MARCH_CROP // 2, 0), n - MARCH_CROP)
              for c, n in ((int(ys.mean()), scene.H), (int(xs.min()), scene.W)))
    crop = np.s_[y0:y0 + MARCH_CROP, x0:x0 + MARCH_CROP]
    ro, rd = generated["rays_o"][v][crop], generated["rays_d"][v][crop]
    got = scene.march(ro, rd, f)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want = scene.march_numpy(ro, rd, f)
    numpy_s = time.perf_counter() - t0
    err_rgb = float(np.abs(got[0] - want[0]).max())
    err_depth = float(np.abs(got[1] - want[1]).max())
    agree = float((got[2] == want[2]).mean())
    print(f"marcher on the card vs numpy, view {v} frame {f} crop {MARCH_CROP}x{MARCH_CROP} at "
          f"({y0}, {x0}), {scene.n_march} samples ({numpy_s:.2f} s in numpy): rgb {err_rgb:.3e} "
          f"(tol 2e-5), depth {err_depth:.3e} (tol 2e-4), masks agree {agree:.5f} (> 0.999), "
          f"{int(want[2].sum())} vehicle pixels", flush=True)
    _require(err_rgb <= 2e-5 and err_depth <= 2e-4 and agree > 0.999 and want[2].any(),
             "the card marcher against the numpy marcher")


def phase_app_init(cfg, config_path, basedir):
    """6b-6d: the appearance-init app through its entry point at cfg's
    widths with APP_CUT, its checkpoints, and the host modules on its
    outputs. Returns the app's launch counts (the fused kernels', then the
    backward's GEMM and sums')."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from startrax_torch.apps import app_init
    from startrax_torch.apps.common import make_dataset
    from startrax_torch.eval import iou, pose, trajectory
    from startrax_torch.eval.image import psnr
    from startrax_torch.eval.render import render_image
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.ops import lie
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.train import loop
    from startrax_torch.utils.config import load_config, star_config_from
    from startrax_torch.utils.logging import write_png
    from startrax_torch.utils.tree import tree_leaves

    argv = ["--config", config_path, "--basedir", basedir,
            "--synth_cache_dir", cfg.synth_cache_dir, *APP_CUT]
    app_cfg = load_config(argv)
    print(f"app_init: python -m startrax_torch.apps.app_init {' '.join(argv)} (depth cut: "
          f"epochs_appearance {cfg.epochs_appearance} -> {app_cfg.epochs_appearance}, "
          f"steps_per_epoch {cfg.steps_per_epoch} -> {app_cfg.steps_per_epoch}, epoch_val "
          f"{cfg.epoch_val} -> {app_cfg.epoch_val})", flush=True)

    # time each step the app takes: CUDA events around it, and one window of
    # steps profiled for its device time (device activity only, so that each
    # kernel counts once, as _device_ms counts it)
    step_ms, prof = [], profile(activities=[ProfilerActivity.CUDA])

    def timed(step):
        def run(*a, **k):
            i = len(step_ms)
            if i == APP_PROFILED[0]:
                torch.cuda.synchronize()
                prof.start()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(*a, **k)
            end.record()
            torch.cuda.synchronize()
            step_ms.append(start.elapsed_time(end))
            if i == APP_PROFILED[1] - 1:
                prof.stop()
            return out

        return run

    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with _patched(loop, "make_appinit_train_step", timed):
        params = app_init.main(argv)
    app_s = time.perf_counter() - t0
    counts, parts = dict(fm.launches), dict(fm.part_launches)

    run_dir = os.path.join(basedir, app_cfg.expname, "app_init")
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    losses = [r["train/fine_loss"] for r in rows if "train/fine_loss" in r]
    vals = [(r["step"], r["val/psnr"], r["val/ssim"]) for r in rows if "val/psnr" in r]
    n_steps, n_val = len(step_ms), len(vals)
    star_cfg = star_config_from(app_cfg)
    val_data = make_dataset(app_cfg, "val")
    n_pix = val_data.H * val_data.W
    tiles = -(-n_pix // 8192)  # render_image's tiles of a validation view
    print(f"app_init: {n_steps} steps in {app_s:.2f} s; train/fine_loss per epoch {losses}; "
          "validations (step, PSNR dB, SSIM) " + ", ".join(f"({s}, {p:.4f}, {q:.4f})"
                                                           for s, p, q in vals), flush=True)
    _require(n_steps == app_cfg.epochs_appearance * app_cfg.steps_per_epoch
             and len(losses) == app_cfg.epochs_appearance and n_val == len(losses),
             "every epoch trained, logged and validated")
    _require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             "the fine loss is finite and falls")
    _require(all(math.isfinite(p) and math.isfinite(q) for _, p, q in vals), "finite val metrics")
    want = _counts(fwd=2 * n_steps + 2 * tiles * n_val, bwd=2 * n_steps)
    want_parts = {k: n_steps * v for k, v in _part_counts("coarse", "fine").items()}
    print(f"app_init launches {counts}, backward parts {parts}: per step 2 fwd + 2 bwd, "
          f"{want_parts['wgrad'] // n_steps} wgrad + {want_parts['sum_rows'] // n_steps} "
          f"sum_rows, and {2 * tiles} fwd a validation ({tiles} tiles)", flush=True)
    _require(counts == want, f"the app's launches {want}, got {counts}")
    _require(parts == want_parts, f"the app's GEMM and sum launches {want_parts}, got {parts}")

    steady = [t for i, t in enumerate(step_ms)
              if i >= APP_WARM and not APP_PROFILED[0] <= i < APP_PROFILED[1]]
    step_med = statistics.median(steady)
    n_prof = APP_PROFILED[1] - APP_PROFILED[0]
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n_prof
    print(f"app_init step: median {step_med:.3f} ms over steps {APP_WARM + 1}-{n_steps} "
          f"(CUDA events, profiled steps {APP_PROFILED[0] + 1}-{APP_PROFILED[1]} left out), "
          f"{app_cfg.N_rand / step_med * 1e3:.1f} rays/s; device time {busy:.3f} ms a step "
          f"(profiler, {n_prof} steps), idle share {1 - busy / step_med:.3f}", flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=15), flush=True)

    # 6c: the checkpoints
    restored = ckpt.restore_checkpoint(os.path.join(run_dir, "ckpts"))
    pairs = list(zip(tree_leaves(restored["params"]), tree_leaves(params)))
    _require(len(pairs) == len(tree_leaves(params)) and all(
        a.device.type == "cuda" and torch.equal(a, b) for a, b in pairs),
        "the final checkpoint restores the returned params bitwise")
    steps = sorted(int(d) for d in os.listdir(os.path.join(run_dir, "ckpts")))
    _require(steps == list(range(app_cfg.epochs_appearance + 1)), f"checkpoint steps {steps}")
    online = loop.init_online_params(star_cfg, app_cfg.num_frames,
                                     torch.Generator(device="cuda").manual_seed(9))
    warm = ckpt.restore_static_only(restored["params"], online)
    _require(all(warm["nerf"][k] is (restored["params"][k] if k.startswith("static")
                                     else online["nerf"][k]) for k in online["nerf"])
             and warm["poses"] is online["poses"], "restore_static_only keeps the static fields")
    rng = np.random.default_rng(app_cfg.seed)  # the app's validation draws
    view = [int(rng.integers(0, val_data.rays_o.shape[0])) for _ in vals][-1]
    out = render_image(restored["params"], star_cfg, *val_data.view_rays(view))
    target = val_data.images[view, 0]
    p = float(psnr(torch.from_numpy(out["rgb"]), torch.tensor(target)))
    print(f"restored checkpoint: bitwise; view {view} re-rendered: PSNR {p:.6f} dB against the "
          f"app's {vals[-1][1]:.6f} (tol 1e-4)", flush=True)
    _require(abs(p - vals[-1][1]) <= 1e-4, "the restored params render the app's PSNR")

    # 6d: the host modules on the card's Python
    # the logged PNG holds the bytes write_png makes of the re-rendered image
    # (the CPU tests decode write_png's files independently)
    for name, arr in (("val_rgb", out["rgb"]), ("val_target", target)):
        logged = os.path.join(run_dir, "images", f"{name}_{vals[-1][0]:06d}.png")
        again = os.path.join(basedir, f"{name}_again.png")
        write_png(again, (255 * np.clip(np.nan_to_num(arr), 0, 1)).astype(np.uint8))
        same = open(logged, "rb").read() == open(again, "rb").read()
        print(f"logged {name} PNG: {os.path.getsize(logged)} bytes, equal to write_png of the "
              f"re-rendered array: {same}", flush=True)
        _require(same, f"the logged {name} PNG holds the re-rendered array")
    gt = val_data.gt_relative_poses()  # [K, F, 7]
    noisy = val_data.noisy_gt_relative_poses(np.random.default_rng(0))
    ident = pose.get_pose_metrics_multi(gt.swapaxes(0, 1), gt.swapaxes(0, 1))
    metrics = pose.get_pose_metrics_multi(noisy.swapaxes(0, 1), gt.swapaxes(0, 1))
    rpe = [trajectory.evaluate_rpe(n, g) for n, g in zip(noisy, gt)]
    ate = [trajectory.evaluate_ate(n, g) for n, g in zip(noisy, gt)]
    local = val_data.bbox_local_vertices()
    gt_mat = val_data.gt_vehicle_poses()[:, -1]
    est_mat = lie.se3_to_matrix(torch.from_numpy(np.ascontiguousarray(noisy[:, -1]))).numpy()
    ious = iou.compute_3d_iou(est_mat, gt_mat, local)[0]
    ious_gt = iou.compute_3d_iou(gt_mat, gt_mat, local)[0]
    print(f"noisy GT poses against GT, per vehicle: trans {[float(t) for t in metrics[0]]}, rot "
          f"{[float(r) for r in metrics[1]]}, RPE (trans, deg) {rpe}, ATE {ate}, 3D IoU (last "
          f"frame) {ious.tolist()}; GT against itself: trans {[float(t) for t in ident[0]]}, "
          f"3D IoU {ious_gt.tolist()}", flush=True)
    _require(all(t > 0 for t in metrics[0]) and all(a > 0 for a in ate)
             and all(r[0] > 0 for r in rpe) and bool((ious > 0).all() and (ious < 1).all()),
             "noisy poses show an error")
    _require(all(t == 0 and r < 1e-5 for t, r in zip(ident[0], ident[1]))
             and bool(np.allclose(ious_gt, 1.0, atol=1e-4)), "the GT against itself shows none")
    path = os.path.join(basedir, "poses.txt")
    ckpt.save_poses_txt(path, val_data.gt_vehicle_poses()[0])
    back = ckpt.load_poses_txt(path)
    _require(np.allclose(back, val_data.gt_vehicle_poses()[0], atol=1e-6), "pose file round trip")
    return counts, parts


def _same_static_fields(path_a, path_b):
    """Whether two configs give the same static coarse and fine fields."""
    from startrax_torch.utils.config import load_config, star_config_from

    a, b = (star_config_from(load_config(["--config", p])) for p in (path_a, path_b))
    return all(a.static_field(fine=f) == b.static_field(fine=f) for f in (False, True))


def phase_online(config_path, warm_path, basedir, cache):
    """7b-7d: the online app through its entry point at the config's widths
    with ONLINE_CUT, warm-started from warm_path; then the resume and the
    test protocol. Returns the 7b run's launch counts (the fused kernels',
    then the backward's GEMM and sums')."""
    import torch

    from startrax_torch.apps import online
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.train import loop, optim
    from startrax_torch.utils.config import load_config, parse_config_file, star_config_from
    from startrax_torch.utils.tree import tree_leaves

    argv = ["--config", config_path, "--basedir", basedir, "--synth_cache_dir", cache,
            "--appearance_ckpt_path", warm_path, *ONLINE_CUT]
    cfg = load_config(argv)
    published = parse_config_file(config_path)
    cuts = ", ".join(f"{k} {published.get(k, 'default')} -> {getattr(cfg, k)}"
                     for k in (flag[2:] for flag in ONLINE_CUT[::2]))
    print(f"online: python -m startrax_torch.apps.online {' '.join(argv)} (cut in depth and "
          f"schedule: {cuts})", flush=True)

    # each step the app takes: its kind (a per-ray batch carries [N] frame
    # tensors), its CUDA events, its launches; one profiled window a kind
    rec = _StepRecorder(ONLINE_PROFILED)
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with rec:
        online.main(argv)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    counts, parts = dict(fm.launches), dict(fm.part_launches)
    step_log = rec.log

    run_dir = os.path.join(basedir, cfg.expname, "online")
    history = json.load(open(os.path.join(run_dir, "history.json")))
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    vals = [(r["step"], r["val/psnr"], r["val/ssim"]) for r in rows if "val/psnr" in r]
    phases = [h["phase"] for h in history]
    print(f"online: {len(step_log)} steps, {len(history)} epochs in {app_s:.2f} s", flush=True)
    for h in history:
        print(f"  epoch {h['epoch']} {h['phase']}: fine {h['fine']}, window {h['window']}, "
              f"trans {h['trans']}, rot {h['rot']}"
              + (f", selection score {h['score']}" if "score" in h else ""), flush=True)
    print("online validations (step, PSNR dB, SSIM) "
          + ", ".join(f"({s}, {p:.4f}, {q:.4f})" for s, p, q in vals), flush=True)
    _require(phases == ONLINE_PHASES, f"the phase sequence {ONLINE_PHASES}, got {phases}")
    _require(len(step_log) == len(history) * cfg.steps_per_epoch, "every epoch took its steps")
    fines = [h["fine"] for h in history]
    _require(all(math.isfinite(f) for f in fines) and fines[2] < fines[0],
             "finite fine losses that fall over the warmup")
    _require(len(vals) == len(history) // cfg.epoch_val
             and all(math.isfinite(p) and math.isfinite(q) for _, p, q in vals),
             "finite val metrics every epoch_val epochs")
    _require(all(("score" in h) == (h["epoch"] >= 6) for h in history)
             and all(math.isfinite(h["score"]) for h in history[6:]),
             "a selection score on every epoch from the last admission on")
    log = open(os.path.join(run_dir, "run.log")).read()
    _require("training stopped: polish budget" in log, "the run stops on the polish budget")

    # launches: each step kind's as designed, the stale batches (sampled
    # under the previous phase's state) by layout, and the renders' forwards
    # (one GEMM and two sums a backward call: 4 calls a per-ray step, 6 a
    # shared-pose step)
    medians = rec.report(_step_designs(), ONLINE_WARM, cfg, "online", phases)
    _require(sorted(medians) == ["per_ray", "shared"], "steps of both kinds")
    for kind in sorted(rec.profs):
        print(rec.profs[kind].key_averages().table(sort_by="cuda_time_total", row_limit=12),
              flush=True)
    stale = {phases[r["epoch"]]: 0 for r in step_log}
    for r in step_log:
        per_ray_phase = phases[r["epoch"]] in ("fieldform", "barf", "polish_field")
        stale[phases[r["epoch"]]] += (r["kind"] == "per_ray") != per_ray_phase
    print(f"online steps whose batch has the other phase kind's layout (stale prefetched "
          f"batches), by phase: {stale}", flush=True)
    star_cfg = star_config_from(cfg)
    tiles = -(-cfg.synth_height * cfg.synth_height // 8192)
    n_frames = sum(len(online._score_frames(cfg, 0, cfg.num_frames)) for h in history
                   if "score" in h)
    renders = len(vals) + n_frames
    want = _counts(**{k: sum(r["launches"][k] for r in step_log) for k in fm.launches})
    want["fwd"] += renders * tiles * (2 + 2 * star_cfg.num_vehicles)
    want_parts = {k: sum(r["launches"][k] for r in step_log) for k in fm.part_launches}
    print(f"online launches {counts}, backward parts {parts}; the eval renders: {renders} "
          f"({len(vals)} validations, {n_frames} selection frames) of {tiles} tiles, "
          f"{2 + 2 * star_cfg.num_vehicles} fwd a tile", flush=True)
    _require(counts == want and parts == want_parts,
             f"the app's launches: the steps' and the renders' forwards {want}, got {counts}")

    # 7c: resume mid-polish from the final checkpoint
    ckpts = os.path.join(run_dir, "ckpts")
    argv_resume = argv + ["--online_ckpt_path", ckpts, *RESUME_CUT]
    t0 = time.perf_counter()
    params = online.main(argv_resume)
    resume_s = time.perf_counter() - t0
    cfg_r = load_config(argv_resume)
    log = open(os.path.join(run_dir, "run.log")).read()
    history_r = json.load(open(os.path.join(run_dir, "history.json")))
    print(f"online resume ({' '.join(RESUME_CUT)}): {resume_s:.2f} s, epochs "
          f"{[(h['epoch'], h['phase'], h['fine']) for h in history_r]}", flush=True)
    for line in ("resumed online training", "resumed polish sub-state",
                 "restored best-epoch snapshot"):
        _require(line in log, f"run.log says '{line}'")
    _require([h["phase"] for h in history_r] == ["polish_field"],
             "the resumed run continues the alternation")
    saved = ckpt.restore_checkpoint(ckpts)
    _require(saved["epoch"] == cfg_r.epochs_online, "the resumed run's final checkpoint")
    fresh = loop.init_online_params(star_cfg, cfg.num_frames,
                                    torch.Generator(device="cuda").manual_seed(1))
    leaves = tree_leaves(fresh)
    ckpt.copy_into(fresh, saved["params"])
    _require(all(a is b for a, b in zip(tree_leaves(fresh), leaves)) and all(
        torch.equal(a, b) and torch.equal(a, c) for a, b, c in
        zip(leaves, tree_leaves(saved["params"]), tree_leaves(params))),
        "the saved params load bitwise into fresh leaves and equal the returned ones")
    names = [k for k in saved if k.startswith("opt_state")]
    for name in names:
        opt = optim.make_fused_star_optimizer(fresh, 0.0, 0.0, 0.0,
                                              accumulate_steps=cfg.accumulate_grad_batches)
        buffers = [opt.m, opt.v, opt.acc]
        opt.load_state_dict(saved[name])
        st = saved[name]
        _require(all(a is b for a, b in zip([opt.m, opt.v, opt.acc], buffers)),
                 f"{name} loads in place")
        _require(all(torch.equal(getattr(opt, k), st[k]) for k in ("m", "v", "acc"))
                 and (opt.count, opt.mini_step) == (st["count"], st["mini_step"]),
                 f"{name} loads bitwise")
    if "restoring every-epoch best-epoch" in log.split("resumed online training")[-1]:
        best = ckpt.restore_checkpoint(run_dir + "/ckpts_best")["params"]
        _require(all(torch.equal(a, b) for a, b in zip(tree_leaves(best), leaves)),
                 "the restored best snapshot is the returned params")
    print(f"online resume: the final checkpoint's params and {len(names)} optimizer states "
          f"({', '.join(names)}) load bitwise into fresh leaves and buffers", flush=True)

    # 7d: the test protocol on the final checkpoint
    argv_test = argv + ["--test", "true", "--online_ckpt_path", ckpts]
    t0 = time.perf_counter()
    online.main(argv_test)
    test_s = time.perf_counter() - t0
    test_dir = os.path.join(basedir, cfg.expname, "online_test")
    rows_t = [json.loads(line) for line in open(os.path.join(test_dir, "metrics.jsonl"))]
    got = {}
    for r in rows_t:
        for k, v in r.items():
            if k.startswith("test/"):
                got.setdefault(k, []).append(v)
    K = star_cfg.num_vehicles
    need = ["test/view0_frame_psnr", "test/view0_frame_psnr_dynamic", "test/view0_frame_2d_iou",
            "test/view0_2d_iou"] + [f"test/{m}_{k}" for m in ("rpe_trans", "ate", "3d_iou")
                                    for k in range(K)]
    summary = {k: (got[k] if len(got.get(k, [])) <= 1 else
                   [round(min(got[k]), 5), round(max(got[k]), 5)]) for k in need if k in got}
    print(f"online test: {test_s:.2f} s; {summary} (a list of two: min and max over frames)",
          flush=True)
    _require(all(k in got and all(math.isfinite(v) for v in got[k]) for k in need),
             f"the test metrics {need} present and finite")
    _require(all(got[f"test/ate_{k}"][0] < 0.4 for k in range(K)), "ATE under 0.4")
    _require(all(os.path.exists(os.path.join(test_dir, f"poses_vehicle{k}.txt"))
                 for k in range(K)), "the pose files")
    return counts, parts


class _StepRecorder:
    """Records each step an app takes through its entry point: the step's
    kind (its batch's layout; gauge steps apart), its CUDA events and its
    launches, with one profiled window of each kind (device activity only)
    at the step indices `profiled` gives by kind. No sync is added but at
    the profiled windows' edges: the events are read after the run, so the
    host queues work ahead as the app does. Wrap the app's run in
    `with recorder:`."""

    def __init__(self, profiled):
        self.profiled = profiled
        self.log, self.profs, self.done = [], {}, set()
        self.on_online = self.on_gauge = None  # hooks(step_or_None, args) before a step

    def _run(self, kind, call, epoch):
        import torch
        from torch.profiler import ProfilerActivity, profile

        from startrax_torch.kernels import fused_mlp as fm

        seen = sum(r["kind"] == kind for r in self.log)
        lo, hi = self.profiled.get(kind, (-1, -1))
        if seen == lo:
            torch.cuda.synchronize()
            self.profs[kind] = profile(activities=[ProfilerActivity.CUDA])
            self.profs[kind].start()
        before = dict(fm.launches) | dict(fm.part_launches)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = call()
        end.record()
        if seen == hi - 1:
            torch.cuda.synchronize()
            self.profs[kind].stop()
            self.done.add(kind)
        after = dict(fm.launches) | dict(fm.part_launches)
        self.log.append({"kind": kind, "epoch": epoch, "events": (start, end),
                         "launches": _deltas(after, before)})
        return out

    def online(self, step):
        from startrax_torch.train import loop

        def run(params, batch, epoch=0, **k):
            if self.on_online:
                self.on_online(step, params)
            return self._run(loop.batch_kind(batch),
                             lambda: step(params, batch, epoch=epoch, **k), int(epoch))

        return run

    def gauge(self, step):
        from startrax_torch.train import loop

        def run(gauge, nerf, poses, batch, **k):
            if self.on_gauge:
                self.on_gauge(gauge, poses)
            # a gauge step learns no epoch: report() places it
            return self._run("gauge_" + loop.batch_kind(batch),
                             lambda: step(gauge, nerf, poses, batch, **k), None)

        return run

    def __enter__(self):
        from startrax_torch.train import loop

        self._patches = contextlib.ExitStack()
        self._patches.enter_context(_patched(loop, "make_online_train_step", self.online))
        self._patches.enter_context(_patched(loop, "make_gauge_train_step", self.gauge))
        return self

    def __exit__(self, *exc):
        import torch

        self._patches.close()
        for kind in [k for k in self.profs if k not in self.done]:
            torch.cuda.synchronize()
            self.profs.pop(kind).stop()  # a window that its kind's steps did not fill
        return False

    def times(self, steps_per_epoch):
        """Read the events; place each gauge step in its epoch: the epochs
        after the last online step's, steps_per_epoch steps each."""
        last, run = -1, 0
        for r in self.log:
            r["ms"] = r["events"][0].elapsed_time(r["events"][1])
            if r["epoch"] is None:
                r["epoch"] = last + 1 + run // steps_per_epoch
                run += 1
            else:
                last, run = r["epoch"], 0

    def report(self, design, warm, cfg, label, phases):
        """Per kind: the steps (by phase), the median step time (CUDA
        events, the first `warm` and the profiled window left out), the
        device time and idle share of the profiled window, and every step's
        launches against design[kind]. Returns {kind: median ms}."""
        import statistics

        self.times(cfg.steps_per_epoch)
        n_rand = cfg.N_rand
        kinds = {}
        for rec in self.log:
            kinds.setdefault(rec["kind"], []).append(rec)
        medians = {}
        for kind, recs in sorted(kinds.items()):
            lo, hi = self.profiled.get(kind, (-1, -1))
            kept = [r["ms"] for i, r in enumerate(recs) if i >= min(warm, len(recs) // 2)
                    and not lo <= i <= hi]
            med = statistics.median(kept or [r["ms"] for r in recs])
            medians[kind] = med
            by_phase = {}
            for r in recs:
                p = phases[r["epoch"]] if 0 <= r["epoch"] < len(phases) else r["epoch"]
                by_phase[p] = by_phase.get(p, 0) + 1
            line = (f"{label} {kind} steps: {len(recs)} (by phase {by_phase}), median {med:.3f} "
                    f"ms (CUDA events, no sync added), {n_rand / med * 1e3:.1f} rays/s")
            if kind in self.profs:
                n_prof = hi - lo
                busy = sum(e.self_device_time_total
                           for e in self.profs[kind].key_averages()) / 1e3 / n_prof
                line += (f"; device time {busy:.3f} ms a step (profiler, {n_prof} steps), idle "
                         f"share {1 - busy / med:.3f}")
            print(line + f"; launches a step {recs[0]['launches']}, design {design[kind]}",
                  flush=True)
            bad = [r for r in recs if r["launches"] != design[kind]]
            _require(not bad, f"{label}: every {kind} step launches {design[kind]}, got {bad[:1]}")
        return medians


def _check_jump(gauge, poses_before, poses_after, max_trans, max_rot):
    """The pose jump of a gauge application: poses_after must be
    accepted ∘ poses_before, accepted holding G^-1's rows within the caps
    (identity elsewhere). Returns (the largest error, the vehicles
    corrected)."""
    import torch

    from startrax_torch.apps import online
    from startrax_torch.ops import lie

    inv = lie.se3_inverse(gauge.detach().cpu())
    ok = [w for w, _, _ in online.gauge_within_caps(inv.numpy(), max_trans, max_rot)]
    accepted = torch.where(torch.tensor(ok)[:, None], inv, lie.se3_identity(len(ok)))
    want = lie.se3_multiply(accepted[None].to(poses_before.device), poses_before)
    return float((poses_after - want).abs().max()), sum(ok)


def phase_scaled_online(config_path, warm_path, basedir, cache):
    """8: the scaled recipe's online app through its entry point at the
    config's widths with SCALED_CUT, warm-started from warm_path (module
    docstring). Returns the main run's launch counts (the fused kernels',
    then the backward's GEMM and sums')."""
    import torch

    from startrax_torch.apps import online
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.utils.config import load_config, parse_config_file, star_config_from
    from startrax_torch.utils.tree import tree_leaves

    argv = ["--config", config_path, "--basedir", basedir, "--synth_cache_dir", cache,
            "--appearance_ckpt_path", warm_path, *SCALED_CUT]
    cfg = load_config(argv)
    star_cfg = star_config_from(cfg)
    K = star_cfg.num_vehicles
    published = parse_config_file(config_path)
    cuts = ", ".join(f"{k} {published.get(k, 'default')} -> {getattr(cfg, k)}"
                     for k in (flag[2:] for flag in SCALED_CUT[::2]))
    print(f"scaled online: python -m startrax_torch.apps.online {' '.join(argv)} (cut in depth "
          f"and schedule: {cuts})", flush=True)

    # each gauge application: the pose jump against G^-1 ∘ p (read at the
    # first online step after a gauge step), then each optimizer's first
    # step after it must find a newly built optimizer's state (these six
    # reads are the only syncs added between steps but the profiled
    # windows' edges)
    rec = _StepRecorder(SCALED_PROFILED)
    jump = {"gauge": None, "poses": None, "checked": None}
    jumps, resets = [], []

    def on_gauge(gauge, poses):
        if jump["gauge"] is not gauge:
            jump.update(gauge=gauge, poses=poses.detach().clone())

    def on_online(step, params):
        if jump["gauge"] is not None:
            err, n = _check_jump(jump["gauge"], jump["poses"], params["poses"].detach(),
                                 cfg.gauge_max_trans, cfg.gauge_max_rot)
            jumps.append((err, n))
            jump.update(gauge=None, checked=set() if n else None)
        opt = step.opt
        if jump["checked"] is not None and id(opt) not in jump["checked"]:
            jump["checked"].add(id(opt))
            resets.append((opt.count, opt.mini_step, float(opt.m.abs().max()),
                           float(opt.v.abs().max()),
                           0.0 if opt.acc is None else float(opt.acc.abs().max())))

    rec.on_gauge, rec.on_online = on_gauge, on_online
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with rec:
        params = online.main(argv)
    torch.cuda.synchronize()
    app_s = time.perf_counter() - t0
    counts, parts = dict(fm.launches), dict(fm.part_launches)

    run_dir = os.path.join(basedir, cfg.expname, "online")
    history = json.load(open(os.path.join(run_dir, "history.json")))
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    vals = [(r["step"], r["val/psnr"], r["val/ssim"]) for r in rows if "val/psnr" in r]
    phases = [h["phase"] for h in history]
    log = open(os.path.join(run_dir, "run.log")).read()
    print(f"scaled online: {len(rec.log)} steps, {len(history)} epochs in {app_s:.2f} s",
          flush=True)
    for h in history:
        print(f"  epoch {h['epoch']} {h['phase']}: fine {h['fine']}, window {h['window']}, "
              f"trans {h['trans']}, rot {h['rot']}"
              + (f", selection score {h['score']}" if "score" in h else "")
              + (", boundary" if h.get("boundary") else ""), flush=True)
    for line in log.splitlines():
        if "gauge_align" in line or "boundary best" in line or "restoring" in line:
            print("  " + line.split(" INFO ")[-1], flush=True)
    print("scaled online validations (step, PSNR dB, SSIM) "
          + ", ".join(f"({s}, {p:.4f}, {q:.4f})" for s, p, q in vals), flush=True)
    _require(phases == SCALED_PHASES, f"the phase sequence {SCALED_PHASES}, got {phases}")
    _require(len(rec.log) == len(history) * cfg.steps_per_epoch, "every epoch took its steps")
    fines = [h["fine"] for h in history]
    _require(all(math.isfinite(f) for f in fines) and fines[2] < fines[0],
             "finite fine losses that fall over the warmup")
    _require(all(math.isfinite(p) and math.isfinite(q) for _, p, q in vals) and len(vals) == 1,
             "a finite validation")
    last_admit = phases.index("gauge_fit") - 1
    _require(all(("score" in h) == (h["epoch"] >= last_admit) for h in history),
             "a selection score on every epoch from the last admission on")
    boundaries = [h["epoch"] for h in history if h.get("boundary")]
    _require(boundaries == [i for i, p in enumerate(phases) if p == "polish_pose"],
             f"a boundary row at each completed round, got {boundaries}")
    _require("training stopped: polish budget" in log, "the run stops on the polish budget")

    # the gauge applications: G^-1 ∘ p to 1e-6, then fresh optimizers
    print(f"scaled online gauge applications: (largest error against G^-1 ∘ p, vehicles "
          f"corrected) {jumps}; each optimizer's first step after them (count, mini_step, "
          f"max |m|, max |v|, max |acc|) {resets}", flush=True)
    _require(len(jumps) == 2 and all(err <= 1e-6 and n == K for err, n in jumps),
             "two gauge applications, each G^-1 ∘ p to 1e-6 for every vehicle")
    _require(len(resets) == 4 and all(r == (0, 0, 0.0, 0.0, 0.0) for r in resets),
             "the field and polish optimizers reset after each application")

    # the boundary best ships: restored into the returned params bitwise
    bbest = min((h for h in history if h.get("boundary")), key=lambda h: h["score"])
    snap_steps = sorted(int(s) for s in os.listdir(run_dir + "/ckpts_best"))
    snap = ckpt.restore_checkpoint(run_dir + "/ckpts_best")["params"]
    restored = f"restoring boundary best-epoch {bbest['epoch']} snapshot" in log
    _require(snap_steps[-1] == bbest["epoch"] and (restored or bbest["epoch"] == len(history) - 1)
             and all(torch.equal(a, b) for a, b in zip(tree_leaves(snap), tree_leaves(params))),
             f"the boundary best (epoch {bbest['epoch']}) restored bitwise into the returned "
             "params")
    print(f"scaled online: boundary best epoch {bbest['epoch']} (score {bbest['score']}) "
          f"{'restored' if restored else 'is the last epoch'}; the returned params equal its "
          "snapshot bitwise", flush=True)

    # launches by kind, the stale batches, the renders' forwards
    design = _step_designs()
    medians = rec.report(design, ONLINE_WARM, cfg, "scaled online", phases)
    _require(sorted(medians) == sorted(design), f"steps of every kind, got {sorted(medians)}")
    for kind in sorted(rec.profs):
        print(rec.profs[kind].key_averages().table(sort_by="cuda_time_total", row_limit=10),
              flush=True)
    stale = {}
    for r in rec.log:
        per_ray = phases[r["epoch"]] in ("fieldform", "barf", "polish_field", "gauge_fit")
        stale[phases[r["epoch"]]] = stale.get(phases[r["epoch"]], 0) + (
            r["kind"].endswith("per_ray") != per_ray)
    print(f"scaled online steps whose batch has the other layout (stale prefetched batches), "
          f"by phase: {stale}", flush=True)
    s = max(cfg.selection_stride, 1)
    H = cfg.synth_height
    sel_tiles, val_tiles = -(-(-(-H // s)) ** 2 // 8192), -(-H * H // 8192)
    n_frames = sum(len(online._score_frames(cfg, 0, cfg.num_frames)) for h in history
                   if "score" in h)
    want = _counts(**{k: sum(r["launches"][k] for r in rec.log) for k in fm.launches})
    want["fwd"] += (len(vals) * val_tiles + n_frames * sel_tiles) * (2 + 2 * K)
    want_parts = {k: sum(r["launches"][k] for r in rec.log) for k in fm.part_launches}
    print(f"scaled online launches {counts}, backward parts {parts}; the eval renders: "
          f"{len(vals)} validations of {val_tiles} tiles, {n_frames} selection frames of "
          f"{sel_tiles} tiles, {2 + 2 * K} fwd a tile", flush=True)
    _require(counts == want and parts == want_parts,
             f"the app's launches: the steps' and the renders' forwards {want}, got {counts}")

    # 8c: a resume that lands mid-gauge: the round restarts, the snapshots
    # are restored
    mid = os.path.join(basedir, "mid_gauge")
    for suffix in ("", "_best", "_bbound"):
        src = run_dir + "/ckpts" + suffix
        step = SCALED_RESUME_AT if not suffix else max(
            int(s) for s in os.listdir(src) if int(s) <= SCALED_RESUME_AT)
        shutil.copytree(f"{src}/{step}", f"{mid}{suffix}/{step}")
    saved = ckpt.restore_checkpoint(mid)
    _require(saved["polish"]["ga_stage"] == 1 and saved["polish"]["bbest_epoch"] >= 0,
             "the resumed checkpoint is mid-gauge with a boundary best")
    argv_resume = argv + ["--online_ckpt_path", mid, *SCALED_RESUME_CUT]
    t0 = time.perf_counter()
    online.main(argv_resume)
    resume_s = time.perf_counter() - t0
    log_r = open(os.path.join(run_dir, "run.log")).read().split("resumed online training")[-1]
    history_r = json.load(open(os.path.join(run_dir, "history.json")))
    print(f"scaled online resume from epoch {SCALED_RESUME_AT} ({' '.join(SCALED_RESUME_CUT)}): "
          f"{resume_s:.2f} s, epochs {[(h['epoch'], h['phase'], h['fine']) for h in history_r]}",
          flush=True)
    for line in ("ga=ref_field/1", "fitting the frame-0 gauge (round 1)",
                 f"restored boundary-best snapshot (epoch {saved['polish']['bbest_epoch']}",
                 "restored best-epoch snapshot", "gauge_align: applied gauge"):
        _require(line in log_r, f"the resumed run.log says '{line}'")
    _require([h["phase"] for h in history_r] == ["gauge_fit", "gauge_fit"],
             "the resumed run restarts the gauge round")

    # 8d: the test protocol over the held-out views on the final checkpoint
    argv_test = argv + ["--test", "true", "--online_ckpt_path", run_dir + "/ckpts"]
    t0 = time.perf_counter()
    online.main(argv_test)
    test_s = time.perf_counter() - t0
    test_dir = os.path.join(basedir, cfg.expname, "online_test")
    got = {}
    for r in (json.loads(line) for line in open(os.path.join(test_dir, "metrics.jsonl"))):
        for k, v in r.items():
            if k.startswith("test/"):
                got.setdefault(k, []).append(v)
    need = [f"test/view{v}_frame_psnr" for v in range(cfg.synth_val_views)] + [
        f"test/{m}_{k}" for m in ("rpe_trans", "ate", "3d_iou") for k in range(K)]
    summary = {k: (got[k] if len(got.get(k, [])) <= 1 else
                   [round(min(got[k]), 5), round(max(got[k]), 5)]) for k in need if k in got}
    print(f"scaled online test: {test_s:.2f} s; {summary} (a list of two: min and max over "
          "frames)", flush=True)
    _require(all(k in got and all(math.isfinite(v) for v in got[k]) for k in need),
             f"the test metrics {need} present and finite")
    _require(all(got[f"test/ate_{k}"][0] < 0.4 for k in range(K)), "ATE under 0.4")
    del params
    torch.cuda.empty_cache()
    return counts, parts


def phase_polishes(config_path, warm_path, basedir, cache):
    """8b: the ref_field gauge with its guard plus multi-start, then
    refit_anchor, through the online app's entry point on phase 7's config
    and scene with POLISH_CUTS. Returns their launch counts (the fused
    kernels', then the backward's GEMM and sums')."""
    import torch

    from startrax_torch.apps import online
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.utils.config import load_config

    fm.reset_launch_counts()
    for name, cut, want_phases, lines in POLISH_CUTS:
        argv = ["--config", config_path, "--basedir", os.path.join(basedir, name),
                "--synth_cache_dir", cache, "--appearance_ckpt_path", warm_path, *cut]
        cfg = load_config(argv)
        rec = _StepRecorder({})
        t0 = time.perf_counter()
        with rec:
            online.main(argv)
        torch.cuda.synchronize()
        run_dir = os.path.join(basedir, name, cfg.expname, "online")
        history = json.load(open(os.path.join(run_dir, "history.json")))
        log = open(os.path.join(run_dir, "run.log")).read()
        phases = [h["phase"] for h in history]
        print(f"polish {name}: {' '.join(cut)}: {len(rec.log)} steps in "
              f"{time.perf_counter() - t0:.2f} s; epochs "
              f"{[(h['epoch'], h['phase'], h['fine'], h.get('score')) for h in history]}",
              flush=True)
        for line in log.splitlines():
            if any(w in line for w in ("gauge_align", "multi_start", "refit_anchor")):
                print("  " + line.split(" INFO ")[-1], flush=True)
        _require(phases == want_phases, f"polish {name}: the phases {want_phases}, got {phases}")
        _require(len(rec.log) == sum(cfg.steps_per_epoch * (
            cfg.multi_start_candidates * cfg.multi_start_epochs if p == "multi_start" else 1)
            for p in phases), f"polish {name}: every epoch took its steps")
        _require(all(math.isfinite(h["fine"]) for h in history), f"polish {name}: finite losses")
        for pattern, n in lines:
            found = len([l for l in log.splitlines() if pattern in l])
            _require(found == n, f"polish {name}: run.log has {n} '{pattern}' lines, got {found}")
        rec.report(_step_designs(), 2, cfg, f"polish {name}", phases)
    return dict(fm.launches), dict(fm.part_launches)


def _scene_flags(scene_path, cache):
    """The argv keys that put an app on phase 6's synthetic scene (CARLA
    data is absent): SCENE_KEYS from scene_path's config and its cache."""
    from startrax_torch.utils.config import load_config

    scene = load_config(["--config", scene_path])
    flags = ["--dataset_type", "synthetic", "--synth_cache_dir", cache]
    for k in SCENE_KEYS:
        flags += [f"--{k}", str(getattr(scene, k))]
    return flags


def _launch_snapshot():
    from startrax_torch.kernels import fused_mlp as fm

    return dict(fm.launches) | dict(fm.part_launches)


def _occ_inputs(train_data, occ_cfg, n_rays, budget, near, far, seed):
    """One occgrid step's static-field inputs at `budget` samples a ray:
    n_rays frame-0 rays of phase 6's scene marched (jittered) through a grid
    with 30% of its cells occupied, the selected samples' points and
    directions [n_rays * budget, 3], and the valid mask as a float [N]."""
    import numpy as np
    import torch

    from startrax_torch.kernels import occgrid

    g = torch.Generator(device="cuda").manual_seed(seed)
    r = occ_cfg.resolution
    occupied = torch.rand((r, r, r), generator=g, device="cuda") < 0.3
    grid = {"density_ema": occupied.float() * (10.0 * occ_cfg.occ_threshold
                                                / occ_cfg.render_step_size), "step": 1}
    b = train_data.sample_batch(np.random.default_rng(seed), n_rays, frame=0)
    o, d = (torch.tensor(b[k], device="cuda") for k in ("rays_o", "rays_d"))
    z, valid, _ = occgrid.march_and_select(grid, dataclasses.replace(occ_cfg, n_selected=budget),
                                           o, d, near, far, generator=g)
    pts = o[:, None] + d[:, None] * z[..., None]
    dirs = torch.nn.functional.normalize(d, dim=-1)[:, None].expand(-1, budget, -1)
    return pts.reshape(-1, 3).contiguous(), dirs.reshape(-1, 3).contiguous(), \
        valid.reshape(-1).float()


def _plain_chunks(x, d, weights, n_blocks, pe, cot=None):
    """The plain version over PLAIN_ROWS-row slices: the joined outputs, and
    with cot the summed weight grads."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm

    outs = []
    for i in range(0, x.shape[0], PLAIN_ROWS):
        rows = slice(i, i + PLAIN_ROWS)
        o = fm.fused_mlp_plain(x[rows], d[rows], weights, n_blocks, pe)
        if cot is not None:
            torch.autograd.grad(o, weights, cot[rows])
        outs.append(o.detach())
    return torch.cat(outs)


def phase_occgrid_kernels(field_cfg, train_data, occ_cfg, near, far, worst):
    """9a: the static field's kernels at the occgrid app's shapes against
    their plain version: each budget's step call (4096 rays x 128, 256, 512
    samples; the cotangent zero on the masked slots; the plain version in
    PLAIN_ROWS slices above that), and the grid update's forward (one
    jittered point a cell, one sample a ray, under no_grad: nothing saved);
    each timed with its plain version and its bound. Folds the readings
    into worst; returns the times by shape."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm, occgrid, parity

    nb, pe = field_cfg.n_blocks, (field_cfg.multires, field_cfg.multires_views)
    shapes = {}
    for i, budget in enumerate(OCC_BUDGETS):
        x, d, mask = _occ_inputs(train_data, occ_cfg, OCC_RAYS, budget, near, far, seed=70 + i)
        n = x.shape[0]
        params = _field(field_cfg, seed=70 + i)
        errs, _ = parity.compare(params, x, d, nb, pe, cot_mask=mask,
                                 plain_rows=PLAIN_ROWS if n > PLAIN_ROWS else None)
        label = f"occgrid step budget {budget} {field_cfg.depth}x{field_cfg.width} N={n}"
        print(f"kernel-vs-plain {label} ({int(mask.sum())} valid slots, cotangent 0 on the "
              f"rest): " + ", ".join(f"{k} {errs[k]:.3e} (limit {lim})"
                                     for k, lim in parity.LIMITS.items() if k in errs), flush=True)
        for k in worst:
            worst[k] = max(worst[k], errs.get(k, 0.0))
        _require(not parity.failures(errs), f"{label}: kernel vs plain: {parity.failures(errs)}")
        weights = fm.flatten_params(params, nb)

        def kernel():
            a, r = fm.fused_field_apply(params, x, d, nb, pe)
            return torch.cat([a[..., None], r], -1)

        out = kernel()
        cot = (torch.cat([torch.cos(out[:, :1]), 2.0 * out[:, 1:]], -1) * mask[:, None]).detach()
        t = {"fwd": _cuda_ms(kernel, 3),
             "bwd": _cuda_ms(lambda: torch.autograd.grad(out, weights, cot, retain_graph=True), 3),
             "plain_fwd": _cuda_ms(lambda: _plain_chunks(x, d, weights, nb, pe), 1)}
        t["plain_bwd"] = _cuda_ms(lambda: _plain_chunks(x, d, weights, nb, pe, cot), 1) \
            - t["plain_fwd"]
        work = kernel_work(params, x, nb, pe, False, False)
        t.update({f"bound_{s}": bound(*work[s]) for s in ("fwd", "bwd")},
                 max_scaled_err=max(errs["fwd"], errs["w"]), max_abs_err=errs["grad_abs"])
        shapes[f"budget {budget}"] = t
        print(f"time {label}: " + ", ".join(f"{k} {t[k]:.3f} ms" for k in STEP_TIMES[:4])
              + ", bound fwd {:.3f} ms ({}), bwd {:.3f} ms ({})".format(
                  *t["bound_fwd"], *t["bound_bwd"]), flush=True)
        del out, cot, x, d, mask, params
        torch.cuda.empty_cache()

    # the grid update's forward: every cell's jittered centre, along (0, 0, -1)
    g = torch.Generator(device="cuda").manual_seed(79)
    centers = occgrid._cell_centers(occ_cfg, "cuda")
    cell = (occ_cfg.aabb_max[0] - occ_cfg.aabb_min[0]) / occ_cfg.resolution
    x = (centers + (torch.rand(centers.shape, generator=g, device="cuda") - 0.5) * cell)
    x = x.reshape(-1, 3).contiguous()
    n = x.shape[0]
    d = x.new_tensor([[0.0, 0.0, -1.0]]).expand(n, 3).contiguous()
    params = _field(field_cfg, seed=79)
    weights = fm.flatten_params(params, nb)

    def kernel():
        a, r = fm.fused_field_apply(params, x, d, nb, pe)
        return torch.cat([a[..., None], r], -1)

    with torch.no_grad():
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        k = kernel()
        extra = torch.cuda.max_memory_allocated() - base
        p = _plain_chunks(x, d, weights, nb, pe)
        errs = {"fwd": max(parity._max_rel(k[:, :1], p[:, :1]), parity._max_rel(k[:, 1:], p[:, 1:])),
                "fwd_rms": max(parity._rms_rel(k[:, :1], p[:, :1]),
                               parity._rms_rel(k[:, 1:], p[:, 1:])),
                "fwd_abs": float((k - p).abs().max())}
        t = {"fwd": _cuda_ms(kernel, 3), "plain_fwd": _cuda_ms(
            lambda: _plain_chunks(x, d, weights, nb, pe), 1)}
    save_bytes = n * field_cfg.width * 2  # one [N, W] bf16 buffer
    work = kernel_work(params, x, nb, pe, False, False, save=False)
    t.update(bound_fwd=bound(*work["fwd"]), max_scaled_err=errs["fwd"], max_abs_err=errs["fwd_abs"])
    shapes["grid update"] = t
    label = f"occgrid grid update forward {field_cfg.depth}x{field_cfg.width} N={n} (1 sample a ray)"
    print(f"kernel-vs-plain {label}: fwd {errs['fwd']:.3e} (limit {parity.LIMITS['fwd']}), "
          f"fwd_rms {errs['fwd_rms']:.3e} (limit {parity.LIMITS['fwd_rms']}); memory beyond the "
          f"inputs {extra / 1e9:.3f} GB (one [N, W] bf16 scratch: {save_bytes / 1e9:.3f} GB; "
          f"saved activations would take {(2 * nb + 3.5) * save_bytes / 1e9:.3f})", flush=True)
    print(f"time {label}: fwd {t['fwd']:.3f} ms, plain_fwd {t['plain_fwd']:.3f} ms, bound "
          "{:.3f} ms ({})".format(*t["bound_fwd"]), flush=True)
    _require(errs["fwd"] <= parity.LIMITS["fwd"] and errs["fwd_rms"] <= parity.LIMITS["fwd_rms"]
             and bool(torch.isfinite(k).all()), f"{label}: kernel vs plain")
    _require(extra < 2 * save_bytes, f"{label}: saves nothing under no_grad")
    for key in ("fwd", "fwd_rms"):
        worst[key] = max(worst[key], errs[key])
    del x, d, k, p, params, centers
    torch.cuda.empty_cache()
    return shapes


def phase_occgrid(config_path, scene_path, cache, basedir, worst):
    """9: the occgrid app-init through its entry point at config_path's
    field, batch and grid on phase 6's scene (module docstring). Returns
    (the app's launches, the kernel times by shape of 9a, what 9b needs: the
    app's config, final grid and grid config)."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from startrax_torch.apps import occgrid_init
    from startrax_torch.apps.common import make_dataset
    from startrax_torch.kernels import fused_mlp as fm, occgrid
    from startrax_torch.models.fields import query_density
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.utils.config import load_config
    from startrax_torch.utils.tree import tree_leaves

    published = load_config(["--config", config_path])
    scene = load_config(["--config", scene_path])
    # render_step_size keeps its ratio to the march step
    step_pub = (published.far - published.near) * published.scale_factor / published.N_samples
    rss = published.render_step_size / step_pub * (scene.far - scene.near) / published.N_samples
    argv = ["--config", config_path, "--basedir", basedir, *_scene_flags(scene_path, cache),
            "--render_step_size", f"{rss:.6g}", *OCC_CUT]
    cfg = load_config(argv)
    print(f"occgrid_init: python -m startrax_torch.apps.occgrid_init {' '.join(argv)} (scene "
          f"overrides from {os.path.basename(scene_path)}: CARLA data is absent; render_step_size "
          f"{published.render_step_size} on a {step_pub:.6g} march step -> {rss:.6g} on "
          f"{(scene.far - scene.near) / published.N_samples:.6g}; depth cut: epochs_appearance "
          f"{published.epochs_appearance} -> {cfg.epochs_appearance}, steps_per_epoch "
          f"{published.steps_per_epoch} -> {cfg.steps_per_epoch}); field "
          f"{cfg.netdepth}x{cfg.netwidth}, N_rand {cfg.N_rand}, N_samples {cfg.N_samples}, grid "
          f"{cfg.grid_resolution}^3, mixed_precision {cfg.mixed_precision}", flush=True)
    field_cfg, occ_cfg = occgrid_init.field_config(cfg), occgrid_init.occgrid_config(cfg)
    train_data = make_dataset(cfg, "train")
    shapes = phase_occgrid_kernels(field_cfg, train_data, occ_cfg, cfg.near, cfg.far, worst)

    steps, updates = [], []
    prof = profile(activities=[ProfilerActivity.CUDA])
    update, grid_step = occgrid.update_grid, occgrid_init.GridStep.__call__

    def profiled(self, *args, **kw):
        # around the whole step call: its span train.step holds the update too
        i = len(steps)
        if i == OCC_PROFILED[0]:
            torch.cuda.synchronize()
            prof.start()
        out = grid_step(self, *args, **kw)
        if i == OCC_PROFILED[1] - 1:
            prof.stop()
        return out

    def timed(step):
        def run(params, grid, batch, occ, generator=None):
            before = _launch_snapshot()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(params, grid, batch, occ, generator=generator)
            end.record()
            torch.cuda.synchronize()
            steps.append({"budget": occ.n_selected, "ms": start.elapsed_time(end),
                          "launches": _deltas(_launch_snapshot(), before)})
            return out

        return run

    def timed_update(grid, fn, occ, **kw):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        before = _launch_snapshot()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        out = update(grid, fn, occ, **kw)
        end.record()
        torch.cuda.synchronize()
        updates.append({"before_step": len(steps), "ms": start.elapsed_time(end),
                        "extra": torch.cuda.max_memory_allocated() - base,
                        "launches": _deltas(_launch_snapshot(), before)})
        return out

    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with (_patched(occgrid_init, "make_train_step", timed),
          mock.patch.object(occgrid, "update_grid", timed_update),
          mock.patch.object(occgrid_init.GridStep, "__call__", profiled)):
        params, grid = occgrid_init.main(argv)
    app_s = time.perf_counter() - t0
    counts, parts = dict(fm.launches), dict(fm.part_launches)

    run_dir = os.path.join(basedir, cfg.expname, "occgrid_init")
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    raised = [line.split(" INFO ", 1)[1].strip()
              for line in open(os.path.join(run_dir, "run.log")) if "sample budget" in line]
    n = len(steps)
    print(f"occgrid_init: {n} steps, {len(updates)} grid updates in {app_s:.2f} s; per epoch "
          "(fine loss, mean_samples, dropped_frac): " + ", ".join(
              f"({r['train/fine_loss']:.6f}, {r['train/mean_samples']:.2f}, "
              f"{r['train/dropped_frac']:.4f})" for r in rows) + f"; run.log: {raised}",
          flush=True)
    losses = [r["train/fine_loss"] for r in rows]
    _require(n == cfg.epochs_appearance * cfg.steps_per_epoch and len(rows) == cfg.epochs_appearance,
             "every epoch trained and logged")
    _require(all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             "the occgrid fine loss is finite and falls")
    # the budget of each epoch's steps: doubled after an epoch that cut > 1%
    budget, want, doublings = occ_cfg.n_selected, [], 0
    for r in rows:
        want += [budget] * cfg.steps_per_epoch
        if r["train/dropped_frac"] > 0.01 and budget < occ_cfg.n_march:
            budget, doublings = min(2 * budget, occ_cfg.n_march), doublings + 1
    got = [s["budget"] for s in steps]
    _require(got == want and len(raised) == doublings and len(set(got)) >= 2
             and rows[0]["train/dropped_frac"] > 0.01,
             f"a budget doubling after an epoch that cut > 1%, the next steps at the doubled "
             f"budget: {sorted(set(got))}")
    step_design = _counts(fwd=1, bwd=1) | _part_counts("static")
    update_design = _counts(fwd=1) | _part_counts()
    _require(all(s["launches"] == step_design for s in steps),
             f"every occgrid step launches {step_design}")
    _require([u["before_step"] for u in updates] == list(range(0, n, occgrid_init.GRID_UPDATE_EVERY))
             and len(updates) == math.ceil(n / occgrid_init.GRID_UPDATE_EVERY),
             "a grid update before every 16th step, the first included")
    _require(all(u["launches"] == update_design for u in updates),
             f"every grid update launches {update_design}")
    save_bytes = occ_cfg.resolution ** 3 * cfg.netwidth * 2
    extra = max(u["extra"] for u in updates)
    print(f"occgrid grid updates: launches {updates[0]['launches']} each, memory beyond their "
          f"inputs at most {extra / 1e9:.3f} GB (one [N, W] bf16 scratch {save_bytes / 1e9:.3f} "
          f"GB), median {statistics.median(u['ms'] for u in updates):.3f} ms (CUDA events)",
          flush=True)
    _require(extra < 2 * save_bytes, "the grid update saves nothing")
    want_counts = _counts(fwd=n + len(updates), bwd=n)
    _require(counts == want_counts and parts == {k: n * v for k, v in _part_counts("s").items()},
             f"the app's launches {want_counts}, got {counts} {parts}")

    by_budget = {}
    for i, s in enumerate(steps):
        if not OCC_PROFILED[0] <= i < OCC_PROFILED[1]:
            by_budget.setdefault(s["budget"], []).append(s["ms"])
    n_prof = OCC_PROFILED[1] - OCC_PROFILED[0]
    busy = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3 / n_prof
    medians = {b: statistics.median(v[OCC_WARM:] or v) for b, v in by_budget.items()}
    prof_budget = steps[OCC_PROFILED[0]]["budget"]
    for b, med in sorted(medians.items()):
        line = (f"occgrid step at budget {b}: median {med:.3f} ms over {len(by_budget[b])} steps "
                f"(CUDA events, the first {OCC_WARM} of each budget and the profiled window left "
                f"out), {cfg.N_rand / med * 1e3:.1f} rays/s")
        if b == prof_budget:
            line += (f"; device time {busy:.3f} ms a step (profiler, steps {OCC_PROFILED[0] + 1}-"
                     f"{OCC_PROFILED[1]}), idle share {1 - busy / med:.3f}")
        print(line, flush=True)
    print(prof.key_averages().table(sort_by="cuda_time_total", row_limit=12), flush=True)

    # the march and the grid update alone, at the final grid and budget
    occ = dataclasses.replace(occ_cfg, n_selected=budget)
    b = train_data.sample_batch(np.random.default_rng(1), cfg.N_rand, frame=0)
    o, d = (torch.tensor(b[k], device="cuda") for k in ("rays_o", "rays_d"))
    g = torch.Generator(device="cuda").manual_seed(3)
    march_ms = _cuda_ms(lambda: occgrid.march_and_select(grid, occ, o, d, cfg.near, cfg.far,
                                                         generator=g), 5)
    update_ms = _cuda_ms(lambda: occgrid.update_grid(
        grid, functools.partial(query_density, params, field_cfg), occ, generator=g), 3)
    z, valid, n_occ = occgrid.march_and_select(grid, occ, o, d, cfg.near, cfg.far, generator=g)
    occupied = float(occgrid.occupancy(grid, occ).float().mean())
    print(f"occgrid alone (CUDA events): march_and_select {march_ms:.3f} ms ({cfg.N_rand} rays x "
          f"{occ.n_march} steps, budget {occ.n_selected}; {float(valid.float().sum(-1).mean()):.1f} "
          f"valid slots a ray, {float(n_occ.float().mean()):.1f} occupied samples a ray), "
          f"update_grid {update_ms:.3f} ms ({occ.resolution ** 3} cells, {occupied:.4f} occupied)",
          flush=True)
    shapes["alone"] = {"march_ms": march_ms, "update_grid_ms": update_ms}

    ckpts = os.path.join(run_dir, "ckpts")
    restored = ckpt.restore_checkpoint(ckpts)
    _require(list(restored) == ["params"] and all(
        torch.equal(a, b) for a, b in zip(tree_leaves(restored["params"]), tree_leaves(params)))
        and sorted(int(s) for s in os.listdir(ckpts)) == list(range(cfg.epochs_appearance)),
        "a {params} checkpoint an epoch, the last one the returned params bitwise")
    return counts, parts, shapes, (cfg, grid, occ)


def phase_occgrid_render(cfg, grid, occ_cfg):
    """9b: render_star_occgrid at phase 9's grid on a 4096-ray batch of its
    scene with K = 2 (pose warp, field-axis dynamic fields), kernel path
    against plain path: the renders, and the kernels on the inputs the
    render gives them (the static field on the selected samples, the
    dynamic fields on the warped samples with input grads; the cotangent
    zero on the masked slots) within parity.LIMITS. The render's own weight
    and pose grads are printed: its loss sum(rgb * w) reaches the fields
    through the compositing as a zero-mean cotangent, under which bf16 relu
    flips move a weight grad by up to 3.5e-2 of its largest entry
    (ROADMAP, port-side facts). Then joint_density_fn over the grid's cells
    with and without the pose. Returns the kernel path's launches."""
    import numpy as np
    import torch

    from startrax_torch import convert
    from startrax_torch.apps.common import make_dataset
    from startrax_torch.kernels import occgrid, parity
    from startrax_torch.models import star_occgrid
    from startrax_torch.utils.config import star_config_from
    from startrax_torch.utils.tree import tree_leaves

    star = dataclasses.replace(star_config_from(cfg), num_vehicles=2)
    g = torch.Generator().manual_seed(90)
    params = star_occgrid.init_star_occgrid(star, g, device="cpu")
    for f in (params["static"], params["dynamic"]):  # nonzero fc1: every block carries gradient
        for blk in f["blocks"]:
            blk["fc1"]["w"] = 0.02 * torch.randn(blk["fc1"]["w"].shape, generator=g)
    params = convert.params_from_numpy(convert.params_to_numpy(params), device="cuda",
                                       requires_grad=True)
    q = torch.nn.functional.normalize(torch.tensor([[0.0, 0.1, 0.0, 0.995],
                                                    [0.05, 0.0, -0.05, 0.9975]]), dim=-1)
    pose = torch.cat([torch.tensor([[0.05, -0.02, 0.1], [-0.1, 0.03, -0.05]]), q], -1)
    pose = pose.cuda().requires_grad_(True)
    data = make_dataset(cfg, "train")
    b = data.sample_batch(np.random.default_rng(5), OCC_RAYS, frame=0)
    o, d = (torch.tensor(b[k], device="cuda") for k in ("rays_o", "rays_d"))
    u = torch.rand((OCC_RAYS, occ_cfg.n_march), generator=torch.Generator(device="cuda")
                   .manual_seed(6), device="cuda")
    w = torch.randn((OCC_RAYS, 3), generator=torch.Generator(device="cuda").manual_seed(7),
                    device="cuda")
    leaves = tree_leaves(params) + [pose]
    outs, grads, launched = [], [], None
    # the plain path in RENDER_CHUNKS slices of the rays (for its memory): the
    # loss sums over rays, so its grads are the slices' grads summed
    for use_fused, chunks in ((True, 1), (False, RENDER_CHUNKS)):
        c = dataclasses.replace(star, use_fused=use_fused)
        before = _launch_snapshot()
        parts, grad = [], None
        for rows in torch.arange(OCC_RAYS, device="cuda").chunk(chunks):
            out = star_occgrid.render_star_occgrid(params, c, grid, occ_cfg, o[rows], d[rows],
                                                   pose=pose, u=u[rows], with_test_outputs=True)
            g_rows = torch.autograd.grad((out["rgb"] * w[rows]).sum(), leaves)
            grad = g_rows if grad is None else [a + b for a, b in zip(grad, g_rows)]
            parts.append({k: out[k].detach() for k in ("rgb", "valid")})
        torch.cuda.synchronize()
        if use_fused:
            launched = _deltas(_launch_snapshot(), before)
        outs.append({k: torch.cat([p[k] for p in parts]) for k in ("rgb", "valid")})
        grads.append(grad)
    design = _counts(fwd=1, bwd=1, stacked_fwd=1, stacked_bwd=1) | _part_counts("s", "d")
    rgb_err = float((outs[0]["rgb"] - outs[1]["rgb"]).abs().max())
    w_err = max(parity._max_rel(a, b) for a, b in zip(grads[0][:-1], grads[1][:-1]))
    pose_err = parity._max_rel(grads[0][-1], grads[1][-1])
    valid = outs[0]["valid"]
    print(f"render_star_occgrid K=2, {OCC_RAYS} rays, budget {occ_cfg.n_selected} "
          f"({float(valid.float().sum(-1).mean()):.1f} valid slots a ray): kernel path vs plain "
          f"path rgb max abs err {rgb_err:.3e} (tol 2e-2); the render's weight grads "
          f"{w_err:.3e}, pose grad {pose_err:.3e} (scaled, under its zero-mean cotangent); "
          f"launches {launched}, design {design}", flush=True)
    _require(all(bool(torch.isfinite(out["rgb"]).all()) for out in outs)
             and torch.equal(outs[0]["valid"], outs[1]["valid"]), "finite renders, one march")
    _require(rgb_err <= 2e-2, "render_star_occgrid: kernel path vs plain path")
    _require(launched == design, f"render_star_occgrid launches {design}, got {launched}")

    # the kernels on the render's own inputs
    from startrax_torch.models.star import warp_to_vehicle_frames

    nb, pe = star.static_field().n_blocks, (star.multires, star.multires_views)
    with torch.no_grad():
        z, valid, _ = occgrid.march_and_select(grid, occ_cfg, o, d, star.near, star.far, u=u)
        dirs = torch.nn.functional.normalize(d, dim=-1)
        pts = o[:, None] + d[:, None] * z[..., None]
        pts_dyn, dirs_dyn = warp_to_vehicle_frames(pose, pts, dirs)
    S, K = z.shape[1], star.num_vehicles
    mask = valid.reshape(-1).float()
    cases = (("static", params["static"], pts.reshape(-1, 3),
              dirs[:, None].expand(-1, S, -1).reshape(-1, 3), False),
             ("dynamic K=2, input grads", params["dynamic"], pts_dyn.reshape(K, -1, 3),
              dirs_dyn[:, :, None].expand(-1, -1, S, -1).reshape(K, -1, 3), True))
    for name, p, x, dd, stacked in cases:
        x, dd = (t.contiguous().requires_grad_(stacked) for t in (x, dd))
        errs, _ = parity.compare(p, x, dd, nb, pe, stacked=stacked, cot_mask=mask)
        print(f"kernel-vs-plain render_star_occgrid {name} on its {x.shape[-2]} samples a field "
              f"(cotangent 0 on the masked slots): " + ", ".join(
                  f"{k} {errs[k]:.3e} (limit {lim})" for k, lim in parity.LIMITS.items()
                  if k in errs), flush=True)
        _require(not parity.failures(errs),
                 f"render_star_occgrid {name}: kernel vs plain {parity.failures(errs)}")
        del x, dd
        torch.cuda.empty_cache()

    centers = occgrid._cell_centers(occ_cfg, "cuda").reshape(-1, 3)
    with torch.no_grad():
        for p in (None, pose.detach()):
            before = _launch_snapshot()
            k = star_occgrid.joint_density_fn(params, star, p)(centers)
            delta = _deltas(_launch_snapshot(), before)
            plain_fn = star_occgrid.joint_density_fn(
                params, dataclasses.replace(star, use_fused=False), p)
            pl = torch.cat([plain_fn(centers[i:i + PLAIN_ROWS])
                            for i in range(0, centers.shape[0], PLAIN_ROWS)])
            err = parity._max_rel(k, pl)
            want = _counts(fwd=1, stacked_fwd=0 if p is None else 1) | _part_counts()
            print(f"joint_density_fn {'with' if p is not None else 'without'} pose on "
                  f"{centers.shape[0]} cell centres: kernel vs plain {err:.3e} (limit "
                  f"{parity.LIMITS['fwd']}), launches {delta}", flush=True)
            _require(err <= parity.LIMITS["fwd"] and delta == want,
                     "joint_density_fn: kernel path vs plain path and its launches")
    del params, outs, grads, centers
    torch.cuda.empty_cache()
    return launched


def phase_nerf_time_app(config_path, scene_path, cache, basedir):
    """10: nerf_time's app at config_path's widths on phase 6's scene, then
    --test true from its checkpoint. Returns the launches of both runs."""
    from startrax_torch.apps import nerf_time
    from startrax_torch.apps.common import make_dataset
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.train import loop
    from startrax_torch.utils.config import load_config

    argv = ["--config", config_path, "--basedir", basedir, *_scene_flags(scene_path, cache),
            *NT_APP_CUT]
    cfg = load_config(argv)
    published = load_config(["--config", config_path])
    print(f"nerf_time: python -m startrax_torch.apps.nerf_time {' '.join(argv)} (scene "
          f"overrides: CARLA data is absent; depth cut: epochs_online "
          f"{published.epochs_online} -> {cfg.epochs_online}, steps_per_epoch "
          f"{published.steps_per_epoch} -> {cfg.steps_per_epoch}, epoch_val "
          f"{published.epoch_val} -> {cfg.epoch_val})", flush=True)
    steps = []
    fm.reset_launch_counts()
    t0 = time.perf_counter()
    with _patched(loop, "make_nerf_time_train_step", _recording(steps)):
        nerf_time.main(argv)
    app_s = time.perf_counter() - t0
    counts = _launch_snapshot()
    run_dir = os.path.join(basedir, cfg.expname, "nerf_time")
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    losses = [r["train/fine_loss"] for r in rows if "train/fine_loss" in r]
    vals = [(r["val/psnr"], r["val/ssim"]) for r in rows if "val/psnr" in r]
    n = len(steps)
    val = make_dataset(cfg, "val")
    tiles = -(-val.H * val.W // 8192)
    design = _counts(enc_fwd=2, enc_bwd=2) | _part_counts("coarse", "fine")
    print(f"nerf_time app: {n} steps in {app_s:.2f} s; fine loss per epoch {losses}; val (PSNR, "
          f"SSIM) {vals}; launches {counts}", flush=True)
    _require(n == cfg.epochs_online * cfg.steps_per_epoch and len(losses) == cfg.epochs_online
             and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             "nerf_time app: every epoch trained, a finite fine loss that falls")
    _require(len(vals) == len(losses) and all(math.isfinite(p) for p, _ in vals),
             "nerf_time app: a finite validation PSNR each epoch")
    _require(all(s == design for s in steps), f"every nerf_time step launches {design}")
    want = _counts(enc_fwd=2 * n + 2 * tiles * len(vals), enc_bwd=2 * n) | {
        k: n * v for k, v in _part_counts("c", "f").items()}
    _require(counts == want, f"the nerf_time app's launches {want}, got {counts}")

    test_argv = argv + ["--test", "true", "--online_ckpt_path", os.path.join(run_dir, "ckpts"),
                        "--eval_last_frame", str(NT_TEST_FRAMES)]
    t0 = time.perf_counter()
    nerf_time.main(test_argv)
    test_rows = [json.loads(line) for line in open(os.path.join(
        basedir, cfg.expname, "nerf_time_test", "metrics.jsonl"))]
    means = {k: v for r in test_rows for k, v in r.items()
             if k.startswith("test/") and "_frame_" not in k}
    n_views = make_dataset(cfg, "test").rays_o.shape[0]
    print(f"nerf_time --test true: {len(test_rows)} rows in {time.perf_counter() - t0:.2f} s "
          f"({n_views} views x {NT_TEST_FRAMES} frames); view means {means}", flush=True)
    _require(len(test_rows) == n_views * (NT_TEST_FRAMES + 1) and all(
        math.isfinite(v) for r in test_rows for k, v in r.items() if k.startswith("test/")),
        "nerf_time test: a finite row a view and frame and a mean a view")
    return _launch_snapshot()


def _write_carla_capture(root, seed):
    """A CARLA-format capture in root (the layout of tests/test_data.py's
    carla_dir) written with the port's PNG writer; returns {path: array}
    of every PNG file written."""
    import numpy as np
    from scipy.spatial.transform import Rotation

    from startrax_torch.utils.logging import write_png

    rng = np.random.default_rng(seed)
    H, W = CARLA_HW
    np.save(os.path.join(root, "intrinsics.npy"), {"h": H, "w": W, "fov": 90.0})
    extrinsics, written = {}, {}
    code = int(500.0 / 1000.0 * (256 ** 3 - 1))  # 500 m in the 24-bit depth code
    for i in range(CARLA_CAMS):
        ang = 2 * np.pi * i / CARLA_CAMS
        pose = np.eye(4)
        pose[:3, :3] = Rotation.from_euler("z", ang).as_matrix()
        pose[:3, 3] = [10 * np.cos(ang), 10 * np.sin(ang), 2.0]
        extrinsics[i] = pose
        cam = os.path.join(root, f"camera{i}")
        os.makedirs(cam)
        for f in range(CARLA_FRAMES):
            sem = np.full((H, W, 3), 7, np.uint8)
            sem[:H // 3, :W // 3] = 10  # "car" pixels
            depth = np.zeros((H, W, 3), np.uint8)
            depth[..., 0], depth[..., 1], depth[..., 2] = (code % 256, (code // 256) % 256,
                                                           code // 65536)
            for name, arr in ((f"{f}.png", rng.integers(0, 256, (H, W, 3), dtype=np.uint8)),
                              (f"{f}_semantic.png", sem), (f"{f}_depth.png", depth)):
                path = os.path.join(cam, name)
                write_png(path, arr)
                written[path] = arr
    np.save(os.path.join(root, "extrinsics.npy"), extrinsics)
    for k in range(CARLA_VEHICLES):
        vdir = os.path.join(root, "poses", f"vehicle{k}")
        os.makedirs(vdir)
        for f in range(CARLA_FRAMES):
            pose = np.eye(4)
            pose[:3, :3] = Rotation.from_euler("z", 0.1 * f + 0.2 * k).as_matrix()
            pose[:3, 3] = [f * 2.0 + k, 0.5, 1.0]
            np.save(os.path.join(vdir, f"{f}.npy"), pose)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1) for sz in (-1, 1)],
                       np.float64) * [2.0, 1.0, 0.8]
    np.save(os.path.join(root, "bboxes.npy"),
            np.array([{"local_vertices": corners}] * CARLA_VEHICLES, dtype=object),
            allow_pickle=True)
    return written


def phase_carla(train_config, test_config, basedir):
    """10b: a CARLA-format capture written with write_png, read back
    bit-exact, loaded through make_dataset, and nerf_time's app trained on
    it for one short epoch and tested with the test_carla_nerf_time.txt
    protocol. Returns the launches of both runs."""
    import numpy as np

    from startrax_torch.apps import nerf_time
    from startrax_torch.apps.common import make_dataset
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.utils.config import load_config
    from startrax_torch.utils.logging import read_png

    root = os.path.join(basedir, "carla")
    os.makedirs(root)
    t0 = time.perf_counter()
    written = _write_carla_capture(root, seed=11)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    same = sum(np.array_equal(read_png(p), a) for p, a in written.items())
    read_s = time.perf_counter() - t0
    print(f"CARLA capture: {CARLA_CAMS} cameras x {CARLA_FRAMES} frames, {CARLA_VEHICLES} "
          f"vehicles, {CARLA_HW[0]}x{CARLA_HW[1]}: {len(written)} PNG files written in "
          f"{write_s:.2f} s, read back bit-exact: {same} of {len(written)} in {read_s:.2f} s",
          flush=True)
    _require(same == len(written), "every PNG file reads back bit-exact")
    flags = ["--datadir", root, "--basedir", basedir, "--num_frames", str(CARLA_FRAMES),
             "--num_vehicles", str(CARLA_VEHICLES)]
    cfg = load_config(["--config", train_config, *flags])
    views = {}
    for split in ("train", "val", "test"):
        s = make_dataset(cfg, split)
        views[split] = s.images.shape[0]
        _require(s.images.shape[1:] == (CARLA_FRAMES, *CARLA_HW, 3)
                 and np.allclose(s.depths, 5.0, rtol=1e-4) and (s.semantic == 10).any()
                 and s.gt_relative_poses().shape == (CARLA_VEHICLES, CARLA_FRAMES, 7),
                 f"the {split} split: images, depths (500 m x 0.01), semantics and poses")
    print(f"make_dataset(dataset_type = carla): views by split {views}", flush=True)
    _require(views == {"train": 50, "val": 6, "test": 1}, "the view split 50 / 6 / 1")

    fm.reset_launch_counts()
    nerf_time.main(["--config", train_config, *flags, *CARLA_CUT])
    run_dir = os.path.join(basedir, cfg.expname, "nerf_time")
    rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
    test = load_config(["--config", test_config, *flags])
    nerf_time.main(["--config", test_config, *flags, "--online_ckpt_path",
                    os.path.join(run_dir, "ckpts"), "--eval_last_frame", str(CARLA_FRAMES)])
    test_rows = [json.loads(line) for line in open(os.path.join(
        basedir, test.expname, "nerf_time_test", "metrics.jsonl"))]
    print(f"nerf_time on the capture: rows {[{k: v for k, v in r.items() if k != 'time'} for r in rows]}; "
          f"test rows {len(test_rows)}, view 0 means "
          f"{ {k: v for r in test_rows for k, v in r.items() if k.startswith('test/view0_') and '_frame_' not in k} }",
          flush=True)
    _require(all(math.isfinite(v) for r in rows for k, v in r.items() if "/" in k)
             and any("val/psnr" in r for r in rows), "finite train and val rows")
    _require(len(test_rows) == views["test"] * (CARLA_FRAMES + 1) and all(
        math.isfinite(v) for r in test_rows for k, v in r.items() if k.startswith("test/")),
        "finite test rows, a view and frame each and a mean a view")
    return _launch_snapshot()


def stacked_enc_cases(star_cfg, n_rand):
    """3e: the stacked pre-encoded cases, as (name, field config, points a
    field, calls summed into the timed pair): K = STACKED_ENC_K
    time-conditioned fields at the coarse and the fine pass's points, with
    input grads (dx_emb, dd_emb, as the JAX package's stacked backward
    writes them), then 3,000 ragged points, checked, not timed."""
    from startrax_torch.models.nerf_time import time_field_cfg

    coarse, fine = time_field_cfg(star_cfg, False), time_field_cfg(star_cfg, True)
    return [("coarse", coarse, n_rand * star_cfg.n_samples, 1),
            ("fine", fine, n_rand * (star_cfg.n_samples + star_cfg.n_importance), 1),
            ("ragged", fine, 3000, 0)]


def stacked_enc_inputs(star_cfg, fcfg, n_points, seed, num_frames, K=STACKED_ENC_K):
    """K fields' pre-encoded inputs [K, N, 84], [K, N, 27] (each field its
    own bench-style rays at frame FRAME's time, encoded as
    models.fields.apply_field encodes them) with input grads, and stacked
    params, as parity.compare takes them."""
    import torch

    from startrax_torch.ops.encoding import positional_encoding

    xs, ds = [], []
    for k in range(K):
        x, d = _points(n_points, star_cfg.near, star_cfg.far, seed=80 + 10 * seed + k)
        x = torch.cat([x, torch.full_like(x[:, :1], FRAME / (num_frames - 1))], -1)
        xs.append(positional_encoding(x, fcfg.multires))
        ds.append(positional_encoding(d, fcfg.multires_views))
    return {"params": _field(fcfg, seed=90 + seed, n=K),
            "x": torch.stack(xs).contiguous().requires_grad_(True),
            "d": torch.stack(ds).contiguous().requires_grad_(True), "n_blocks": fcfg.n_blocks,
            "pe": None, "pe_masks": None, "warp": None}


def phase_stacked_enc(cfg, star_cfg):
    """3e: the stacked kernels' pre-encoded mode (fused_stacked_apply with
    pe=None, fwd_kernel<true, true> / bwd_kernel<true, true>) at
    carla_nerf_time.txt's widths: each case against its plain version
    within parity.ENC_LIMITS and timed; K = 1 through the field-axis
    wrapper against fused_field_apply's pre-encoded mode, bit for bit; then
    the mode's own path: STACKED_ENC_CALLS forward and backward calls of
    the fine case with the counts set to 0 just before, each exactly one
    stacked_enc_fwd, one stacked_enc_bwd, one GEMM and two sums. Returns
    (worst, times summed over the coarse and fine calls, the path's
    launches)."""
    import torch

    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.utils.tree import tree_leaves, tree_map

    worst, ms = dict.fromkeys(MEASURES, 0.0), dict.fromkeys(STEP_TIMES, 0.0)
    cases = stacked_enc_cases(star_cfg, cfg.N_rand)
    for i, (name, fcfg, n_points, calls) in enumerate(cases):
        _check_and_time(f"stacked pre-encoded {name} K={STACKED_ENC_K} {fcfg.depth}x{fcfg.width} "
                        f"in_ch {fcfg.input_ch} N={n_points}/field, input grads",
                        stacked_enc_inputs(star_cfg, fcfg, n_points, i, cfg.num_frames), True,
                        calls, worst, ms)
        torch.cuda.empty_cache()
    print(f"time of the stacked pre-encoded calls (K={STACKED_ENC_K}, coarse + fine): "
          + ", ".join(f"{k} {ms[k]:.3f} ms" for k in STEP_TIMES[:4])
          + ", bound fwd {:.3f} ms ({}), bwd {:.3f} ms ({})".format(
              *bound(ms["fwd_flop"], ms["fwd_bytes"]), *bound(ms["bwd_flop"], ms["bwd_bytes"])),
          flush=True)

    # K = 1 through the field-axis wrapper is the per-field pre-encoded kernel
    _, fcfg, _, _ = cases[2]
    one = stacked_enc_inputs(star_cfg, fcfg, 3000, 7, cfg.num_frames, K=1)
    field = tree_map(lambda t: t[0].detach().requires_grad_(True), one["params"])
    outs, grads = [], []
    for params, x, d, wrap in ((one["params"], one["x"], one["d"], fm.fused_stacked_apply),
                               (field, one["x"][0], one["d"][0], fm.fused_field_apply)):
        a, r = wrap(params, x, d, fcfg.n_blocks)
        out = torch.cat([a.reshape(-1, 1), r.reshape(-1, 3)], -1)
        outs.append(out)
        grads.append([g.reshape(-1) for g in torch.autograd.grad(
            (torch.sin(out[:, 0])).sum() + (out[:, 1:] ** 2).sum(),
            tree_leaves(params) + [one["x"], one["d"]])])
    same = torch.equal(outs[0], outs[1]) and all(torch.equal(u, v) for u, v in zip(*grads))
    print(f"stacked pre-encoded K=1 vs fused_field_apply(pe=None) on 3000 points: outputs and "
          f"grads bit for bit equal: {same}", flush=True)
    _require(same, "K = 1 through fused_stacked_apply(pe=None) is the per-field pre-encoded mode")

    # the mode's path: forward and backward calls through fused_stacked_apply
    name, fcfg, n_points, _ = cases[1]
    inp = stacked_enc_inputs(star_cfg, fcfg, n_points, 1, cfg.num_frames)
    fm.reset_launch_counts()
    for _ in range(STACKED_ENC_CALLS):
        before = _launch_snapshot()
        a, r = fm.fused_stacked_apply(inp["params"], inp["x"], inp["d"], fcfg.n_blocks)
        torch.autograd.grad(a.sum() + (r ** 2).sum(),
                            tree_leaves(inp["params"]) + [inp["x"], inp["d"]])
        delta = _deltas(_launch_snapshot(), before)
        want = _counts(stacked_enc_fwd=1, stacked_enc_bwd=1) | _part_counts(fcfg)
        _require(delta == want, f"a stacked pre-encoded call launches {want}, got {delta}")
    torch.cuda.synchronize()
    launches = _launch_snapshot()
    print(f"stacked pre-encoded path: {STACKED_ENC_CALLS} forward + backward calls of the {name} "
          f"case, launches {launches}", flush=True)
    del inp
    torch.cuda.empty_cache()
    return worst, ms, launches


def _write_blender_capture(root):
    """A Blender-format capture in root, written with the port's PNG writer:
    BLENDER_HW RGBA views of an opaque sphere of radius BLENDER_RADIUS (inside
    the box phase 14 extracts a mesh from) coloured by its normal on a
    transparent background, from cameras on a sphere of radius 4 around it
    (lego's camera_angle_x), so that every view agrees with the others;
    BLENDER_VIEWS views a split. Returns {path: array} of every PNG file."""
    import numpy as np

    from startrax_torch.ops import rays as ray_ops
    from startrax_torch.utils.logging import write_png

    H, W = BLENDER_HW
    angle_x = 0.6911112070083618
    K = ray_ops.intrinsics_matrix(H, W, 0.5 * W / np.tan(0.5 * angle_x))
    written = {}
    for s, (split, views) in enumerate(BLENDER_VIEWS.items()):
        os.makedirs(os.path.join(root, split))
        frames = []
        for i in range(views):
            az, el = 2 * np.pi * (i + 0.37 * s) / views, 0.3 + 0.4 * ((i * 7) % views) / views
            eye = 4.0 * np.array([np.cos(el) * np.cos(az), np.cos(el) * np.sin(az), np.sin(el)])
            fwd = -eye / np.linalg.norm(eye)
            right = np.cross(fwd, [0.0, 0.0, 1.0])
            right /= np.linalg.norm(right)
            c2w = np.eye(4)
            c2w[:3, :3] = np.stack([right, np.cross(right, fwd), -fwd], 1)
            c2w[:3, 3] = eye
            o, d = ray_ops.get_rays_np(H, W, K, c2w[:3, :4])
            d = d / np.linalg.norm(d, axis=-1, keepdims=True)
            b = (o * d).sum(-1)
            disc = b * b - ((o * o).sum(-1) - BLENDER_RADIUS ** 2)
            hit = disc > 0
            t = -b - np.sqrt(np.maximum(disc, 0.0))
            normal = (o + d * t[..., None]) / BLENDER_RADIUS
            rgba = np.zeros((H, W, 4), np.uint8)
            rgba[..., :3] = np.clip(255 * (0.5 + 0.5 * normal), 0, 255).astype(np.uint8)
            rgba[..., 3] = np.where(hit, 255, 0)
            name = f"{split}/r_{i}"
            path = os.path.join(root, name + ".png")
            write_png(path, rgba)
            written[path] = rgba
            frames.append({"file_path": name, "transform_matrix": c2w.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as fp:
            json.dump({"camera_angle_x": angle_x, "frames": frames}, fp)
    return written


def phase_lego(config_path, basedir):
    """11: a Blender-format capture written with write_png and read back
    bit-exact, then startrax_torch.apps.lego.main through its argv parser
    on lego.txt at its published widths, cut in epochs and steps by
    LEGO_CUT: the fine loss finite and falling, a finite val PSNR an epoch,
    each step 2 fwd + 2 bwd + 2 GEMMs + 4 sums. Returns the app's
    launches."""
    import numpy as np
    import torch

    from startrax_torch.apps import lego
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.train import loop
    from startrax_torch.utils.config import load_config
    from startrax_torch.utils.logging import read_png

    root = os.path.join(basedir, "nerf_synthetic_lego")
    os.makedirs(root)
    t0 = time.perf_counter()
    written = _write_blender_capture(root)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    same = sum(np.array_equal(read_png(p), a) for p, a in written.items())
    print(f"Blender capture: {BLENDER_VIEWS} views of {BLENDER_HW[0]}x{BLENDER_HW[1]} RGBA, "
          f"{len(written)} PNG files written in {write_s:.2f} s, read back bit-exact: {same} of "
          f"{len(written)} in {time.perf_counter() - t0:.2f} s", flush=True)
    _require(same == len(written), "every Blender PNG file reads back bit-exact")

    argv = ["--config", config_path, "--datadir", root, "--basedir", basedir, *LEGO_CUT]
    cfg, published = load_config(argv), load_config(["--config", config_path])
    print(f"lego: python -m startrax_torch.apps.lego {' '.join(argv)} (cut: epochs_appearance "
          f"{published.epochs_appearance} -> {cfg.epochs_appearance}, steps_per_epoch "
          f"{published.steps_per_epoch} -> {cfg.steps_per_epoch}, epoch_val {published.epoch_val} "
          f"-> {cfg.epoch_val}); field {cfg.netdepth}x{cfg.netwidth}, samples {cfg.N_samples} + "
          f"{cfg.N_importance}, N_rand {cfg.N_rand}, white_bkgd {cfg.white_bkgd}, half_res "
          f"{cfg.half_res}, mixed_precision {cfg.mixed_precision}", flush=True)
    steps = []
    fm.reset_launch_counts()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    with _patched(loop, "make_appinit_train_step", _recording(steps)):
        lego.main(argv)
    app_s = time.perf_counter() - t0
    counts = _launch_snapshot()
    rows = [json.loads(line) for line in open(os.path.join(basedir, cfg.expname, "app_init",
                                                           "metrics.jsonl"))]
    losses = [r["train/fine_loss"] for r in rows if "train/fine_loss" in r]
    vals = [(r["val/psnr"], r["val/ssim"]) for r in rows if "val/psnr" in r]
    n = len(steps)
    design = _counts(fwd=2, bwd=2) | _part_counts("coarse", "fine")
    print(f"lego app: {n} steps in {app_s:.2f} s; fine loss per epoch {losses}; val (PSNR, SSIM) "
          f"{vals}; peak memory {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; launches "
          f"{counts}", flush=True)
    _require(n == cfg.epochs_appearance * cfg.steps_per_epoch
             and len(losses) == cfg.epochs_appearance
             and all(math.isfinite(v) for v in losses) and losses[-1] < losses[0],
             "lego app: every epoch trained, a finite fine loss that falls")
    _require(len(vals) == len(losses) and all(math.isfinite(p) for p, _ in vals),
             "lego app: a finite validation PSNR each epoch")
    _require(all(s == design for s in steps), f"every lego step launches {design}")
    return counts


def phase_mip(app_config, online_config, scene_path, cache, basedir):
    """12: startrax_torch.apps.mip.main on app_config (app init), then on
    online_config warm-started from its checkpoint, then --test true on the
    online checkpoint, each at the config's published field and batch on
    phase 6's scene (scene keys overridden), cut in depth and schedule by
    MIP_APP_CUT, MIP_ONLINE_CUT and MIP_TEST_CUT (printed): the losses
    finite and the app-init loss falling, the quaternions unit-norm, pose
    errors and val rows logged, the test rows finite, no fused-kernel
    launch; the peak memory of each app. Returns the launches (all
    zero)."""
    import torch

    from startrax_torch.apps import mip
    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.utils.config import load_config

    fm.reset_launch_counts()
    runs = {}
    for label, config_path, cut in (("app_init", app_config, MIP_APP_CUT),
                                    ("online", online_config, MIP_ONLINE_CUT)):
        argv = ["--config", config_path, "--basedir", basedir, *_scene_flags(scene_path, cache),
                *cut]
        if label == "online":
            argv += ["--appearance_ckpt_path", os.path.join(runs["app_init"]["dir"], "ckpts")]
        cfg, published = load_config(argv), load_config(["--config", config_path])
        cuts = {k: (getattr(published, k), getattr(cfg, k)) for k in
                ("epochs_appearance", "epochs_online", "steps_per_epoch", "epoch_val",
                 "accumulate_grad_batches") if getattr(published, k) != getattr(cfg, k)}
        print(f"mip {label}: python -m startrax_torch.apps.mip {' '.join(argv)} (scene overrides "
              f"from {os.path.basename(scene_path)}: CARLA data is absent; cut {cuts}); field "
              f"{cfg.netdepth}x{cfg.netwidth}, IPE {cfg.num_freqs_pos} + {cfg.num_freqs_dir} "
              f"frequencies, N_rand {cfg.N_rand}, samples {cfg.N_samples} + {cfg.N_importance}, "
              f"K={cfg.num_vehicles}, mixed_precision {cfg.mixed_precision}", flush=True)
        steps = []
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with _patched(mip, "make_train_step", _recording(steps)):
            mip.main(argv)
        run_dir = os.path.join(basedir, cfg.expname, f"mip_{label}")
        rows = [json.loads(line) for line in open(os.path.join(run_dir, "metrics.jsonl"))]
        losses = [r["train/fine_loss"] for r in rows if "train/fine_loss" in r]
        peak = torch.cuda.max_memory_allocated() / 1e9
        runs[label] = {"dir": run_dir, "rows": rows, "cfg": cfg}
        print(f"mip {label}: {len(steps)} steps in {time.perf_counter() - t0:.2f} s; fine loss "
              f"per epoch {losses}; peak memory {peak:.2f} GB", flush=True)
        _require(len(losses) >= 2 and all(math.isfinite(v) for v in losses),
                 f"mip {label}: a finite fine loss each epoch")
        _require(all(not any(s.values()) for s in steps),
                 f"mip {label}: no fused-kernel launch in a step")
    app_losses = [r["train/fine_loss"] for r in runs["app_init"]["rows"] if "train/fine_loss" in r]
    _require(app_losses[-1] < app_losses[0], "mip app init: the fine loss falls")
    online = runs["online"]
    K = online["cfg"].num_vehicles
    keys = set().union(*online["rows"])
    _require({f"train/trans_error_{k}" for k in range(K)} <= keys and "val/psnr" in keys
             and all(math.isfinite(r[k]) for r in online["rows"] for k in r if "/" in k),
             "mip online: finite pose-error and val rows")
    state = ckpt.restore_checkpoint(os.path.join(online["dir"], "ckpts"))
    qn = torch.linalg.norm(state["params"]["poses"][..., 3:7], dim=-1)
    vals = [(r["val/psnr"], r["val/ssim"]) for r in online["rows"] if "val/psnr" in r]
    errors = {k: v for r in online["rows"] for k, v in r.items() if "error" in k}
    print(f"mip online: val rows {vals}; final pose errors {errors}; |q| - 1 at most "
          f"{float((qn - 1).abs().max()):.2e}", flush=True)
    _require(float((qn - 1).abs().max()) < 1e-5, "mip online: unit quaternions")

    argv = ["--config", online_config, "--basedir", basedir, *_scene_flags(scene_path, cache),
            "--test", "true", "--online_ckpt_path", os.path.join(online["dir"], "ckpts"),
            *MIP_TEST_CUT]
    cfg = load_config(argv)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    mip.main(argv)
    test_rows = [json.loads(line) for line in open(os.path.join(basedir, cfg.expname, "mip_test",
                                                                "metrics.jsonl"))]
    means = {k: v for r in test_rows for k, v in r.items()
             if k.startswith("test/view0_") and "_frame_" not in k}
    print(f"mip --test true ({' '.join(MIP_TEST_CUT)}): {len(test_rows)} rows in "
          f"{time.perf_counter() - t0:.2f} s, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB; view 0 means {means}", flush=True)
    _require(test_rows and all(math.isfinite(v) for r in test_rows for k, v in r.items()
                               if k.startswith("test/")), "mip test: finite rows")
    launches = _launch_snapshot()
    _require(not any(launches.values()), f"the mip apps launch no fused kernel, got {launches}")
    return launches


def _dp_batches(n, star_cfg, num_frames):
    """Phase 13a's two global batches of n rays (bench.py's rays, a uniform
    target): shared-pose at frame FRAME and per-ray frames from [0,
    num_frames); a target depth inside (near, far) on a fifth of the first
    half's rays and four fifths of the second's, 0 (outside) elsewhere, so
    that the ranks' depth and sigma masks count differently."""
    import numpy as np

    rng = np.random.default_rng(0)
    rays_o = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d = rng.normal(size=(n, 3)).astype(np.float32)
    rays_d /= np.linalg.norm(rays_d, axis=-1, keepdims=True)
    depth = np.zeros(n, np.float32)
    half = n // 2
    span = star_cfg.far - star_cfg.near
    for lo, count in ((0, half // 5), (half, 4 * half // 5)):
        depth[lo:lo + count] = star_cfg.near + span * rng.uniform(0.05, 0.95, count)
    base = {"rays_o": rays_o, "rays_d": rays_d,
            "target": rng.uniform(size=(n, 3)).astype(np.float32), "target_depth": depth}
    return {"shared": dict(base, frame=np.int32(FRAME)),
            "per_ray": dict(base, frame=rng.integers(0, num_frames, n).astype(np.int32))}


def _launch_sum(per_step):
    return {k: sum(s[k] for s in per_step) for k in per_step[0]}


def phase_data_parallel(cfg, star_cfg, loss_cfg, app_config, online_config, warm, cache, basedir,
                        card):
    """13: ray-axis data parallelism, DP_WORLD gloo ranks on the one card
    (parallel.mesh.run_ranks; NCCL refuses two ranks on one device). (a)
    the online step at cfg's widths on DP_RAYS rays padded to the world
    size, both layouts, depth and sigma losses on masks that count
    differently on the two halves: each rank against the one-process step
    on the same batch, weights and draws (the loss within DP_LOSS_RTOL
    before the first update; the summed field grads within
    PART_TOL["wgrad"] of the largest field grad, as the GEMM's f32 partials
    run in another order; the pose grads, sums over every point with
    cancellation, within parity.LIMITS["pose"] of the largest; the ranks'
    parameters equal after every one of DP_STEPS steps, each rank's
    launches those of the one-process step); (b) the
    app-init app (app_config, DP_APP_CUT) over the ranks against one rank:
    epoch losses within DP_APP_RTOL, one run directory, its checkpoints
    restoring in this process to rank 0's tree; (c) the online app
    (online_config, DP_ONLINE_CUT, warm-started from warm) over the ranks:
    ONLINE_PHASES' first epochs, the warmup's losses within DP_ONLINE_RTOL
    of one rank (after a phase change the stale prefetched batches depend
    on timing); then test() over the ranks on the one-rank
    run's checkpoint, its rows within DP_TEST_ATOL of the one-rank test's,
    view0.gif written; (d) the 2-rank step's median against the
    one-process step's, and the collectives of one step alone. Returns rank
    0's launches over (a)-(c)."""
    import numpy as np
    import torch

    from startrax_torch import convert
    from startrax_torch.kernels.parity import LIMITS
    from startrax_torch.parallel import dryrun, mesh
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.train import loop
    from startrax_torch.utils.config import load_config
    from startrax_torch.utils.tree import tree_leaves

    print(f"phase 13: {DP_WORLD} ranks over gloo on the one card ({card}): nccl takes a card a "
          "rank and refuses two ranks on one device; this measures correctness, not a "
          "speed-up", flush=True)
    n = mesh.pad_rays_to_multiple(DP_RAYS, DP_WORLD)
    step_cfg = dataclasses.replace(loss_cfg, use_depth_loss=True, depth_lambda=0.1,
                                   use_sigma_loss=True, sigma_lambda=1e-3)
    params = convert.params_to_numpy(loop.init_online_params(
        star_cfg, DP_FRAMES, torch.Generator().manual_seed(11), "cpu"))
    opt = dict(lrate_static=cfg.lrate_static, lrate_dynamic=cfg.lrate_dynamic,
               lrate_pose=cfg.lrate_pose, steps_per_epoch=100,
               decay_milestones=cfg.lrate_decay_steps, grad_clip=1.0,
               accumulate_steps=DP_ACCUMULATE)
    batches = _dp_batches(n, star_cfg, DP_FRAMES)
    specs = {kind: {"kind": "online", "star_cfg": star_cfg, "loss_cfg": step_cfg,
                    "params": params, "opt": opt, "batches": [b] * DP_STEPS, "seed": 12,
                    "time": True, "device": "cuda"}
             for kind, b in batches.items()}
    print(f"13a: online step at {star_cfg.netdepth}x{star_cfg.netwidth} static, "
          f"{star_cfg.netdepth // 2}x{star_cfg.netwidth} dynamic, K={star_cfg.num_vehicles}, "
          f"{star_cfg.n_samples} + {star_cfg.n_importance} samples, {DP_RAYS} rays padded to "
          f"{n} (pad_rays_to_multiple), {DP_STEPS} steps a layout, accumulation "
          f"{cfg.accumulate_grad_batches} -> {DP_ACCUMULATE} (two updates in {DP_STEPS} steps), "
          f"depth and sigma losses on; depth masks {n // 10} + {2 * n // 5} of {n // 2} + "
          f"{n // 2} rays",
          flush=True)
    one = {kind: dryrun.replay(None, spec) for kind, spec in specs.items()}

    # the one-rank runs the apps over the ranks are held against
    app_argv = ["--config", app_config, "--synth_cache_dir", cache, *DP_APP_CUT]
    online_argv = ["--config", online_config, "--synth_cache_dir", cache,
                   "--appearance_ckpt_path", warm, *DP_ONLINE_CUT]
    one_dir, two_dir = os.path.join(basedir, "one"), os.path.join(basedir, "two")
    t0 = time.perf_counter()
    dryrun.run_app(None, "app_init", "train", app_argv + ["--basedir", one_dir], "cuda")
    dryrun.run_app(None, "online", "train", online_argv + ["--basedir", one_dir], "cuda")
    online_name = load_config(online_argv).expname
    ckpts = os.path.join(one_dir, online_name, "online", "ckpts")
    test_argv = online_argv + ["--test", "true", "--online_ckpt_path", ckpts,
                               "--save_video_frames", "true"]
    dryrun.run_app(None, "online", "test", test_argv + ["--basedir", one_dir], "cuda")
    one_s = time.perf_counter() - t0

    jobs = [(dryrun.replay, (specs["shared"],)), (dryrun.replay, (specs["per_ray"],)),
            (dryrun.run_app, ("app_init", "train", app_argv + ["--basedir", two_dir,
                                                              "--data_parallel", "on"])),
            (dryrun.run_app, ("online", "train", online_argv + ["--basedir", two_dir,
                                                               "--data_parallel", "on"])),
            (dryrun.run_app, ("online", "test", test_argv + ["--basedir", two_dir,
                                                            "--data_parallel", "on"]))]
    # the ranks are processes of their own on this card: hand them the
    # memory this process's allocator holds cached
    gc.collect()
    torch.cuda.empty_cache()
    print(f"13: this process holds {torch.cuda.memory_reserved() / 1e9:.2f} GB of the card "
          f"({torch.cuda.memory_allocated() / 1e9:.2f} GB allocated) as the ranks start",
          flush=True)
    t0 = time.perf_counter()
    ranks = mesh.run_ranks(dryrun.run_jobs, DP_WORLD, "gloo", args=(jobs,), device="cuda:0",
                           timeout=300.0, join_timeout=900.0)
    two_s = time.perf_counter() - t0
    print(f"13: one-rank apps {one_s:.1f} s; {DP_WORLD} ranks spawned, their steps and apps "
          f"{two_s:.1f} s", flush=True)

    launches = None
    for kind in ("shared", "per_ray"):
        ref = one[kind]
        # the grads in tree order: the fields' leaves, then the pose table
        grads_err = {"fields": 0.0, "poses": 0.0}
        for r, out in enumerate(r[["shared", "per_ray"].index(kind)] for r in ranks):
            loss_err = max(abs(a - b) / abs(b) for a, b in
                           zip(out["losses"][:DP_ACCUMULATE], ref["losses"][:DP_ACCUMULATE]))
            _require(loss_err <= DP_LOSS_RTOL,
                     f"13a {kind}: rank {r}'s loss {out['losses'][:DP_ACCUMULATE]} within "
                     f"{DP_LOSS_RTOL} of the one-process {ref['losses'][:DP_ACCUMULATE]}")
            _require(out["spread"] == [0.0] * DP_STEPS,
                     f"13a {kind}: the ranks' parameters equal after every step: {out['spread']}")
            _require(out["launches"] == ref["launches"],
                     f"13a {kind}: rank {r}'s launches a step are the one-process step's: "
                     f"{out['launches'][0]} vs {ref['launches'][0]}")
            _require(all(math.isfinite(v) for v in out["losses"]), f"13a {kind}: finite losses")
        for step in range(DP_ACCUMULATE):
            summed = [sum(r[["shared", "per_ray"].index(kind)]["grads"][step][i] for r in ranks)
                      for i in range(len(ref["grads"][step]))]
            for group, part in (("fields", slice(0, -1)), ("poses", slice(-1, None))):
                one_g, two_g = ref["grads"][step][part], summed[part]
                scale = max(float(np.abs(g).max()) for g in one_g)
                grads_err[group] = max(grads_err[group], max(
                    float(np.abs(a - b).max()) for a, b in zip(two_g, one_g)) / scale)
        _require(grads_err["fields"] <= PART_TOL["wgrad"],
                 f"13a {kind}: the ranks' summed field grads within {PART_TOL['wgrad']} of the "
                 f"largest one-process field grad, got {grads_err['fields']:.3e}")
        _require(grads_err["poses"] <= LIMITS["pose"],
                 f"13a {kind}: the ranks' summed pose grads within {LIMITS['pose']} of the "
                 f"largest one-process pose grad, got {grads_err['poses']:.3e}")
        rank0 = ranks[0][["shared", "per_ray"].index(kind)]
        med_two = statistics.median(rank0["step_ms"][1:])
        med_one = statistics.median(ref["step_ms"][1:])
        print(f"13a {kind}: losses one-process {ref['losses']}, rank 0 {rank0['losses']}; "
              f"worst loss rel err before the update {loss_err:.3e} (tol {DP_LOSS_RTOL}); summed "
              f"grads from the one-process grads, over the largest: fields "
              f"{grads_err['fields']:.3e} (tol {PART_TOL['wgrad']}), poses "
              f"{grads_err['poses']:.3e} (tol {LIMITS['pose']}, a sum over every point); parameter "
              f"spread after each step {rank0['spread']}; launches a step "
              f"{rank0['launches'][0]}", flush=True)
        print(f"13d {kind}: {DP_WORLD}-rank step median {med_two:.3f} ms (rank 0, synced, steps "
              f"2-{DP_STEPS}) against one process {med_one:.3f} ms; the step's collectives "
              f"alone (the grad vector of {sum(g.size for g in ref['grads'][0])} floats, the "
              f"metrics, the mask counts) {rank0['collective_ms']:.3f} ms; card {card}",
              flush=True)
        per = _launch_sum(rank0["launches"])
        launches = per if launches is None else {k: launches[k] + per[k] for k in per}

    # (b) the app-init app
    rows = [[json.loads(line) for line in open(os.path.join(d, load_config(app_argv).expname,
                                                            "app_init", "metrics.jsonl"))]
            for d in (one_dir, two_dir)]
    losses = [[r["train/fine_loss"] for r in rs if "train/fine_loss" in r] for rs in rows]
    err = max(abs(a - b) / abs(b) for a, b in zip(losses[1], losses[0]))
    print(f"13b app init: fine loss per epoch one rank {losses[0]}, {DP_WORLD} ranks "
          f"{losses[1]}: rel err {err:.3e} (tol {DP_APP_RTOL}); val PSNR "
          f"{[r['val/psnr'] for r in rows[1] if 'val/psnr' in r]}", flush=True)
    _require(len(losses[1]) == len(losses[0]) > 0 and err <= DP_APP_RTOL,
             "13b: the app-init app's epoch losses over the ranks within tolerance of one rank")
    app_dir = os.path.join(two_dir, load_config(app_argv).expname, "app_init")
    _require(sorted(os.listdir(two_dir)) == sorted({load_config(app_argv).expname, online_name}),
             f"13b/c: one run directory an app: {os.listdir(two_dir)}")
    steps = sorted(os.listdir(os.path.join(app_dir, "ckpts")))
    _require(steps == sorted(os.listdir(os.path.join(one_dir, load_config(app_argv).expname,
                                                     "app_init", "ckpts"))),
             f"13b: the checkpoints of one rank's run: {steps}")
    app_out = ranks[0][2]
    _require([r[2]["spread"] for r in ranks] == [0.0] * DP_WORLD,
             "13b: the ranks' final parameters equal")
    restored = ckpt.restore_checkpoint(os.path.join(app_dir, "ckpts"), device="cuda")["params"]
    _require(all(np.array_equal(a.cpu().numpy(), b) for a, b in
                 zip(tree_leaves(restored), tree_leaves(app_out["params"]))),
             "13b: the final checkpoint restores in one process to rank 0's tree")

    # (c) the online app and its test
    hist = [json.load(open(os.path.join(d, online_name, "online", "history.json")))
            for d in (one_dir, two_dir)]
    phases = [[h["phase"] for h in hs] for hs in hist]
    fine = [[h["fine"] for h in hs] for hs in hist]
    # the warmup epochs sample under one state; after the first phase change
    # the prefetch queue's stale batches depend on timing (PERF.md, PR 8)
    warm = sum(p in ("fieldform", "barf") for p in DP_ONLINE_PHASES)
    err = max(abs(a - b) / abs(b) for a, b in zip(fine[1][:warm], fine[0][:warm]))
    print(f"13c online: phases {phases[1]}; fine loss one rank {fine[0]}, {DP_WORLD} ranks "
          f"{fine[1]}: rel err over the {warm} warmup epochs {err:.3e} (tol {DP_ONLINE_RTOL}), "
          f"over all {max(abs(a - b) / abs(b) for a, b in zip(fine[1], fine[0])):.3e}",
          flush=True)
    _require(phases[0] == phases[1] == DP_ONLINE_PHASES,
             f"13c: the phase sequence {DP_ONLINE_PHASES}")
    _require(err <= DP_ONLINE_RTOL and all(math.isfinite(v) for v in fine[1]),
             "13c: the online app's warmup fine losses within tolerance, all finite")
    _require([r[3]["spread"] for r in ranks] == [0.0] * DP_WORLD,
             "13c: the ranks' final parameters equal")
    test_rows = [[{k: v for k, v in json.loads(line).items() if k.startswith("test/")}
                  for line in open(os.path.join(d, online_name, "online_test", "metrics.jsonl"))]
                 for d in (one_dir, two_dir)]
    test_err = max(abs(a[k] - b[k]) for a, b in zip(*test_rows) for k in a)
    test_dir = os.path.join(two_dir, online_name, "online_test")
    print(f"13c test over {DP_WORLD} ranks on the one-rank checkpoint: {len(test_rows[1])} rows, "
          f"worst abs difference from the one-rank rows {test_err:.3e} (tol {DP_TEST_ATOL}); "
          f"files {sorted(os.listdir(test_dir))}", flush=True)
    _require(len(test_rows[0]) == len(test_rows[1]) > 0
             and [sorted(r) for r in test_rows[0]] == [sorted(r) for r in test_rows[1]]
             and test_err <= DP_TEST_ATOL, "13c: the test rows over the ranks")
    _require(os.path.getsize(os.path.join(test_dir, "view0.gif")) > 0, "13c: view0.gif written")
    for out in ranks[0][2:]:
        launches = {k: launches[k] + out["launches"][k] for k in launches}
    return launches


def phase_utils(lego_config, lego_ckpts, app_config, card):
    """14: the eval-only utilities on the card. (a) utils/mesh.extract_mesh
    over models.fields.query_density of phase 11's trained fine field at
    startrax's defaults (MESH_RES^3 over [-0.8, 0.8]^3, sigma 50): the grid's
    time (one fused forward a 65,536-point chunk, nothing else launched),
    the marching on the host at sigma 50, or at MESH_FALLBACK of the grid's
    largest density where the field stays under 50 (no cell crosses it), a
    non-empty OBJ that parses into the returned mesh;
    the kernel path's density grid against the plain path's on a
    MESH_CHECK^3 grid within parity.LIMITS' forward limits. (b)
    utils/profiling.trace around one app-init step at app_config's widths:
    the Chrome trace names fwd_kernel and bwd_kernel and holds the spans
    SMOKE_SPANS. Returns the launches of (a) and (b)."""
    import numpy as np
    import torch

    from startrax_torch.kernels import fused_mlp as fm
    from startrax_torch.kernels.parity import LIMITS, _max_rel, _rms_rel
    from startrax_torch.models import fields
    from startrax_torch.models.star import init_star
    from startrax_torch.train import checkpoint as ckpt
    from startrax_torch.train import loop, optim
    from startrax_torch.utils import mesh as mesh_mod
    from startrax_torch.utils import profiling
    from startrax_torch.utils.config import load_config, loss_config_from, star_config_from
    from startrax_torch.utils.tree import tree_leaves

    lego = star_config_from(load_config(["--config", lego_config]))
    fcfg = lego.static_field(fine=True)
    params = ckpt.restore_checkpoint(lego_ckpts, device="cuda")["params"]["static_fine"]

    def density(kind):
        cfg = dataclasses.replace(fcfg, use_fused=kind == "kernel")
        return lambda p: fields.query_density(params, cfg, torch.from_numpy(p).cuda())

    tmp = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    try:
        fm.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid = mesh_mod.eval_density_grid(density("kernel"), MESH_RES)
        torch.cuda.synchronize()
        grid_s = time.perf_counter() - t0
        grid_launches = _launch_snapshot()
        n_chunks = -(-MESH_RES ** 3 // 65536)
        # startrax's sigma 50, or, where the short-trained field stays under
        # it everywhere (no cell can cross it), MESH_FALLBACK of its largest
        # density: a surface the marching must find
        level = MESH_SIGMA if grid.max() > MESH_SIGMA else MESH_FALLBACK * float(grid.max())
        t0 = time.perf_counter()
        verts, faces = mesh_mod.marching_tetrahedra(grid, level, (-0.8, 0.8))
        march_s = time.perf_counter() - t0
        path = os.path.join(tmp, "lego.obj")
        mesh_mod.save_obj(path, verts, faces)
        lines = open(path).read().splitlines()
        vs = np.array([[float(x) for x in ln.split()[1:]] for ln in lines if ln.startswith("v ")])
        fs = np.array([[int(x) - 1 for x in ln.split()[1:]] for ln in lines
                       if ln.startswith("f ")])
        print(f"14a mesh of phase 11's fine field ({fcfg.depth}x{fcfg.width}): {MESH_RES}^3 = "
              f"{MESH_RES ** 3} points over [-0.8, 0.8]^3 in {grid_s:.3f} s ({n_chunks} chunks "
              f"of 65,536; launches {grid_launches}); density min {grid.min():.3f} median "
              f"{float(np.median(grid)):.3f} max {grid.max():.3f}; marching tetrahedra at sigma "
              f"{level:.3f}" + ("" if level == MESH_SIGMA else
                                f" ({MESH_FALLBACK} of the max: the field, trained "
                                f"{int(LEGO_CUT[1]) * int(LEGO_CUT[3])} steps, stays under "
                                f"startrax's sigma {MESH_SIGMA}, where the mesh is empty)")
              + f" on the host {march_s:.2f} s: {len(verts)} vertices, {len(faces)} faces, OBJ "
              f"{os.path.getsize(path)} bytes; card {card}", flush=True)
        _require(grid_launches == _counts(fwd=n_chunks) | {"wgrad": 0, "sum_rows": 0},
                 f"14a: one fused forward a chunk, nothing else: {grid_launches}")
        _require(bool(np.isfinite(grid).all()), "14a: a finite density grid")
        _require(len(vs) == len(verts) and len(fs) == len(faces)
                 and (len(verts) == 0 or (np.abs(vs - verts).max() < 1e-5
                                          and np.array_equal(fs, faces))),
                 "14a: the OBJ parses into the returned mesh")
        _require(len(verts) > 0 and len(faces) > 0, "14a: a non-empty mesh")
        del grid
        fine = {k: mesh_mod.eval_density_grid(density(k), MESH_CHECK) for k in ("kernel", "plain")}
        a, b = (torch.from_numpy(fine[k]) for k in ("kernel", "plain"))
        err = {"fwd": _max_rel(a, b), "fwd_rms": _rms_rel(a, b)}
        print(f"14a kernel path against plain path on a {MESH_CHECK}^3 grid: {err} (limits fwd "
              f"{LIMITS['fwd']}, fwd_rms {LIMITS['fwd_rms']})", flush=True)
        _require(err["fwd"] <= LIMITS["fwd"] and err["fwd_rms"] <= LIMITS["fwd_rms"],
                 "14a: the density grid within parity.LIMITS' forward limits")

        # (b) profiling.trace around one app-init step
        app = load_config(["--config", app_config])
        star_cfg, loss_cfg = star_config_from(app), loss_config_from(app)
        gen = torch.Generator(device="cuda").manual_seed(13)
        nerf = init_star(star_cfg, gen, "cuda")
        for leaf in tree_leaves(nerf):
            leaf.requires_grad_(True)
        step = loop.make_appinit_train_step(star_cfg, loss_cfg,
                                            optim.make_appinit_optimizer(nerf, app.lrate))
        batch = {k: v for k, v in _batch(app.N_rand, 1, star_cfg.near, star_cfg.far).items()
                 if k != "frame"}
        step(nerf, batch, generator=gen)
        fm.reset_launch_counts()
        with profiling.trace(tmp) as prof:
            step(nerf, batch, generator=gen)
            torch.cuda.synchronize()
        traced = _launch_snapshot()
        text = open(os.path.join(tmp, profiling.TRACE_FILE)).read()
        names = {k: text.count(k) for k in ("fwd_kernel", "bwd_kernel", "wgrad_kernel")}
        spans = {k: text.count(f'"{k}"') for k in SMOKE_SPANS}
        device_ms = sum(e.self_device_time_total for e in prof.key_averages()) / 1e3
        print(f"14b trace of one app-init step ({star_cfg.netdepth}x{star_cfg.netwidth}, "
              f"{app.N_rand} rays): {os.path.getsize(os.path.join(tmp, profiling.TRACE_FILE))} "
              f"bytes, kernel names {names}, spans {spans}, device time {device_ms:.3f} ms, "
              f"launches {traced}; card {card}", flush=True)
        _require(names["fwd_kernel"] > 0 and names["bwd_kernel"] > 0,
                 "14b: the trace names fwd_kernel and bwd_kernel")
        _require(all(spans.values()), f"14b: the trace holds the step's spans: {spans}")
        traced = {k: grid_launches[k] + traced[k] for k in traced}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return traced


def _rows(per_field, stacked, encoded, stacked_enc, bwd_parts, part_launches):
    """The JSON kernel rows. per_field, stacked, encoded and stacked_enc are
    (worst, step_ms, launches) of the per-field kernel (the flagship step's
    times), the field-axis kernel (the per-ray step's times), the
    pre-encoded mode (the nerf_time step's times) and the stacked
    pre-encoded mode (phase 3e's coarse and fine calls, its path's
    launches); bwd_parts and part_launches are phase 3c's readings and the
    flagship path's launches of the backward's GEMM and sums."""
    from startrax_torch.kernels import parity

    rows = []
    for prefix, (worst, ms, launches), fwd_at, bwd_at in (
            ("fused_mlp", per_field, "291", "343"), ("fused_mlp_stacked", stacked, "1027", "1040"),
            ("fused_mlp_enc", encoded, "291", "343"),
            ("fused_mlp_stacked_enc", stacked_enc, "1027", "1040")):
        kind = prefix.removeprefix("fused_mlp").lstrip("_")
        kind = kind + "_" if kind else ""
        lim = parity.ENC_LIMITS if kind.endswith("enc_") else parity.LIMITS
        for side in ("fwd", "bwd"):
            bound_ms, bound_by = bound(ms[side + "_flop"], ms[side + "_bytes"])
            row = {"name": f"{prefix}_{side}", "route": "cuda", "source": SRC,
                   "replaces": f"startrax/kernels/fused_mlp.py:{fwd_at if side == 'fwd' else bwd_at}",
                   "launches": launches[kind + side],
                   "max_abs_err": worst["fwd_abs" if side == "fwd" else "grad_abs"],
                   "ms": ms[side], "plain_ms": ms["plain_" + side], "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": None}
            if side == "fwd":
                row.update(max_scaled_err=worst["fwd"], tol=lim["fwd"],
                           rms_scaled_err=worst["fwd_rms"], tol_rms=lim["fwd_rms"])
            else:
                row.update(max_scaled_err=worst["w"], tol=lim["w"])
            rows.append(row)
    lim = parity.LIMITS
    rows[1].update(max_pose_rel_err=per_field[0]["pose"], tol_pose=lim["pose"])
    rows[3].update(note="also stands for startrax/kernels/fused_mlp.py:343 with "
                   "input_grads=True (per-point dx, dd)",
                   max_input_rel_err=stacked[0]["input"], tol_input=lim["input"],
                   rms_input_err=stacked[0]["input_rms"], tol_input_rms=lim["input_rms"],
                   rms_ray_pose_err=stacked[0]["ray_pose"], tol_ray_pose=lim["ray_pose"])
    lim = parity.ENC_LIMITS
    rows[4].update(note="the pe=None (pre-encoded input) mode of _fwd_kernel")
    rows[5].update(note="the pe=None (pre-encoded input) mode of _bwd_kernel; dx_emb, dd_emb "
                   "when the inputs need a grad",
                   max_input_rel_err=encoded[0]["input"], tol_input=lim["input"],
                   rms_input_err=encoded[0]["input_rms"], tol_input_rms=lim["input_rms"])
    rows[6].update(note="the pe=None (pre-encoded input) mode of _stacked_fwd_kernel "
                   "(startrax/kernels/fused_mlp.py:1033), K fields on [K, N, in_ch], [K, N, "
                   "view_ch]; times summed over K = 2 fields' coarse and fine calls")
    rows[7].update(note="the pe=None mode of _stacked_bwd_kernel (startrax/kernels/fused_mlp.py:"
                   "1061, :1129): dx_emb, dd_emb and per-field weight grads; ms, plain_ms and "
                   "bound: the whole backward call (bwd_kernel<true, true>, then "
                   "fused_mlp_wgrad and fused_mlp_sum_rows)",
                   max_input_rel_err=stacked_enc[0]["input"], tol_input=lim["input"],
                   rms_input_err=stacked_enc[0]["input_rms"], tol_input_rms=lim["input_rms"])
    parts_ms = sum(bwd_parts[k]["ms"] for k in bwd_parts)
    tile_bound = bound(per_field[1]["bwd_tile_flop"], per_field[1]["bwd_tile_bytes"])
    rows[1].update(note="ms, plain_ms and bound: the whole backward call (per-tile bwd_kernel, "
                   "then fused_mlp_wgrad and fused_mlp_sum_rows); per_tile_ms subtracts phase "
                   "3c's times of those two; per_tile_bound_ms is bwd_kernel's own bound",
                   per_tile_ms=per_field[1]["bwd"] - parts_ms, per_tile_bound_ms=tile_bound[0],
                   per_tile_bound_by=tile_bound[1])
    for name, peak, note in (
            ("wgrad", PEAK_FLOPS, "dW = relu?(X)^T dY of every wide layer of a backward call in one "
             "launch, as split f32 partials: the weight-grad accumulation of _bwd_kernel "
             "(dw_ref[...] += dw, :520); bound: X and dY read once, dW written once in f32; "
             "library_ms is one torch.mm(X^T, dY) a layer and field in bf16, which writes bf16 dW, "
             "not f32 partials, and applies no relu to X"),
            ("sum_rows", PEAK_F32, "the ordered sums of the per-CTA and the per-split partials, one "
             "launch a sum: the grid-order accumulation of _bwd_kernel; library_ms is one torch.sum "
             "over the rows a sum, in another order")):
        r = bwd_parts[name]
        bound_ms, bound_by = bound(r["flop"], r["bytes"], peak)
        rows.append({"name": f"fused_mlp_{name}", "route": "cuda", "source": SRC,
                     "replaces": "startrax/kernels/fused_mlp.py:343",
                     "launches": part_launches[name], "max_abs_err": r["abs"], "ms": r["ms"],
                     "plain_ms": r["plain_ms"], "bound_ms": bound_ms, "bound_by": bound_by,
                     "library_ms": r["library_ms"], "device_ms": r["device_ms"],
                     "library_device_ms": r["library_device_ms"], "paths": r["paths"],
                     "max_scaled_err": r["err"], "tol": PART_TOL[name], "note": note})
    return rows


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, here)
    from startrax_torch.kernels import build, fused_mlp as fm
    from startrax_torch.utils.config import (
        Config,
        load_config,
        loss_config_from,
        parse_config_file,
        star_config_from,
    )

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = _card_line()
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, TF32 off", flush=True)

    t0 = time.perf_counter()
    fm.build()
    print(f"build: {time.perf_counter() - t0:.2f} s "
          f"(nvcc {build.build_seconds['fused_mlp']:.2f} s)", flush=True)

    def load(name):
        cfg = Config(**parse_config_file(os.path.join(here, "startrax", "configs", name)))
        star_cfg = star_config_from(cfg)
        print(f"config {name}: K={star_cfg.num_vehicles} {star_cfg.netdepth}x{star_cfg.netwidth} "
              f"samples {star_cfg.n_samples}+{star_cfg.n_importance} N_rand {cfg.N_rand} "
              f"near {star_cfg.near} far {star_cfg.far} compute {star_cfg.compute_dtype} "
              f"accumulate {cfg.accumulate_grad_batches}", flush=True)
        return cfg, star_cfg, loss_config_from(cfg)

    cfg, star_cfg, loss_cfg = load("carla_star_online_multi.txt")
    slice_cfg, slice_star, slice_loss = load(SLICE_CONFIG)
    # as apps/online.py builds them: the main steps at full frequency, the
    # BARF-masked variant for the warmup
    slice_star = dataclasses.replace(slice_star, end_barf=-1)
    slice_star_barf = dataclasses.replace(slice_star, end_barf=slice_cfg.end_barf)
    nt_cfg, nt_star, nt_loss = load(NT_CONFIG)
    _, occ_star, _ = load(OCC_CONFIG)
    # the online app's main steps, as apps/online.py builds them
    on_cfg, on_star, _ = load(ONLINE_CONFIG)
    on_star = dataclasses.replace(on_star, end_barf=-1)

    worst, step_ms = phase_kernels(star_cfg, cfg.N_rand)
    bwd_parts = phase_backward_parts(backward_part_cases(
        star_cfg, cfg.N_rand, on_star, on_cfg.N_rand, slice_star, slice_cfg.N_rand, nt_star,
        nt_cfg.N_rand, occ_star.static_field()))
    worst_s, ms_s, worst_f, _ = phase_field_axis(slice_star_barf, slice_cfg.N_rand, star_cfg,
                                                 cfg.N_rand)
    worst_o = phase_online_kernels(on_star, on_cfg.N_rand)
    t3e = time.perf_counter()
    worst_se, ms_se, counts_se = phase_stacked_enc(nt_cfg, nt_star)
    print(f"phase 3e (stacked pre-encoded mode): {time.perf_counter() - t3e:.1f} s", flush=True)
    worst = {k: max(worst[k], worst_f[k], worst_o[k]) for k in worst}
    counts, part_counts = phase_main_path(cfg, star_cfg, loss_cfg)
    counts_s = phase_per_ray_path(slice_cfg, slice_star, slice_star_barf, slice_loss)
    worst_e, ms_e, counts_e = phase_nerf_time(nt_cfg, nt_star, nt_loss)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        t6 = time.perf_counter()
        app_cfg = dataclasses.replace(slice_cfg, synth_cache_dir=os.path.join(tmp, "cache"))
        phase_scene(app_cfg)
        app_counts, app_parts = phase_app_init(
            app_cfg, os.path.join(here, "startrax", "configs", SLICE_CONFIG),
            os.path.join(tmp, "runs"))
        print(f"phase 6 (scene, app, checkpoints, host modules): "
              f"{time.perf_counter() - t6:.1f} s", flush=True)

        t7 = time.perf_counter()
        configs = os.path.join(here, "startrax", "configs")
        online_path = os.path.join(configs, ONLINE_CONFIG)
        warm = os.path.join(tmp, "runs", app_cfg.expname, "app_init", "ckpts")
        if _same_static_fields(os.path.join(configs, SLICE_CONFIG), online_path):
            print(f"online warm start: {SLICE_CONFIG} and {ONLINE_CONFIG} give the same static "
                  "fields; phase 6's final app-init checkpoint", flush=True)
        else:
            from startrax_torch.apps import app_init

            print(f"online warm start: {SLICE_CONFIG} and {ONLINE_CONFIG} give other static "
                  f"fields; a short app-init on {ONLINE_CONFIG} instead", flush=True)
            app_init.main(["--config", online_path, "--basedir", os.path.join(tmp, "warm"),
                           "--synth_cache_dir", app_cfg.synth_cache_dir, *APP_CUT])
            warm = os.path.join(tmp, "warm", load_config(["--config", online_path]).expname,
                                "app_init", "ckpts")
        online_counts, online_parts = phase_online(online_path, warm, os.path.join(tmp, "runs"),
                                                   app_cfg.synth_cache_dir)
        print(f"phase 7 (online app, resume, test): {time.perf_counter() - t7:.1f} s",
              flush=True)

        t8 = time.perf_counter()
        scaled_counts, scaled_parts = phase_scaled_online(
            os.path.join(configs, SLICE_CONFIG),
            os.path.join(tmp, "runs", app_cfg.expname, "app_init", "ckpts"),
            os.path.join(tmp, "scaled"), app_cfg.synth_cache_dir)
        print(f"phase 8 (scaled online app, resume mid-gauge, test): "
              f"{time.perf_counter() - t8:.1f} s", flush=True)
        t8 = time.perf_counter()
        polish_counts, polish_parts = phase_polishes(online_path, warm,
                                                     os.path.join(tmp, "polish"),
                                                     app_cfg.synth_cache_dir)
        print(f"phase 8b (ref_field guard and multi-start, refit_anchor): "
              f"{time.perf_counter() - t8:.1f} s", flush=True)

        t9 = time.perf_counter()
        slice_path = os.path.join(configs, SLICE_CONFIG)
        occ_counts, occ_parts, occ_shapes, (occ_app, occ_grid, occ_grid_cfg) = phase_occgrid(
            os.path.join(configs, OCC_CONFIG), slice_path, app_cfg.synth_cache_dir,
            os.path.join(tmp, "occgrid"), worst)
        print(f"phase 9 (occgrid kernels at the app's shapes, occgrid app-init): "
              f"{time.perf_counter() - t9:.1f} s", flush=True)
        t9 = time.perf_counter()
        render_launches = phase_occgrid_render(
            occ_app, occ_grid, dataclasses.replace(occ_grid_cfg, n_selected=OCC_BUDGETS[0]))
        del occ_grid
        print(f"phase 9b (render_star_occgrid, joint_density_fn): "
              f"{time.perf_counter() - t9:.1f} s", flush=True)
        t10 = time.perf_counter()
        nt_app_launches = phase_nerf_time_app(os.path.join(configs, NT_CONFIG), slice_path,
                                              app_cfg.synth_cache_dir, os.path.join(tmp, "nt"))
        print(f"phase 10 (nerf_time app and its test): {time.perf_counter() - t10:.1f} s",
              flush=True)
        t10 = time.perf_counter()
        carla_launches = phase_carla(os.path.join(configs, NT_CONFIG),
                                     os.path.join(configs, NT_TEST_CONFIG),
                                     os.path.join(tmp, "carla_runs"))
        print(f"phase 10b (CARLA-format capture through the PNG reader, nerf_time on it): "
              f"{time.perf_counter() - t10:.1f} s", flush=True)
        t11 = time.perf_counter()
        lego_launches = phase_lego(os.path.join(configs, LEGO_CONFIG),
                                   os.path.join(tmp, "lego"))
        print(f"phase 11 (Blender capture, lego app): {time.perf_counter() - t11:.1f} s",
              flush=True)
        t12 = time.perf_counter()
        mip_launches = phase_mip(os.path.join(configs, MIP_APP_CONFIG),
                                 os.path.join(configs, MIP_ONLINE_CONFIG), slice_path,
                                 app_cfg.synth_cache_dir, os.path.join(tmp, "mip"))
        print(f"phase 12 (mip app init, online and test): {time.perf_counter() - t12:.1f} s",
              flush=True)
        t13 = time.perf_counter()
        dp_launches = phase_data_parallel(
            cfg, star_cfg, loss_cfg, os.path.join(configs, SLICE_CONFIG), online_path, warm,
            app_cfg.synth_cache_dir, os.path.join(tmp, "dp"), card)
        print(f"phase 13 (data parallelism, {DP_WORLD} gloo ranks on the card): "
              f"{time.perf_counter() - t13:.1f} s", flush=True)
        t14 = time.perf_counter()
        util_launches = phase_utils(
            os.path.join(configs, LEGO_CONFIG),
            os.path.join(tmp, "lego", load_config(["--config", os.path.join(
                configs, LEGO_CONFIG)]).expname, "app_init", "ckpts"),
            os.path.join(configs, SLICE_CONFIG), card)
        print(f"phase 14 (mesh extraction, profiling): {time.perf_counter() - t14:.1f} s",
              flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    rows = _rows((worst, step_ms, counts), (worst_s, ms_s, counts_s), (worst_e, ms_e, counts_e),
                 (worst_se, ms_se, counts_se), bwd_parts, part_counts)
    app_launches = {"fused_mlp_fwd": app_counts["fwd"], "fused_mlp_bwd": app_counts["bwd"],
                    "fused_mlp_wgrad": app_parts["wgrad"],
                    "fused_mlp_sum_rows": app_parts["sum_rows"]}
    online_launches = {"fused_mlp_fwd": online_counts["fwd"], "fused_mlp_bwd": online_counts["bwd"],
                       "fused_mlp_stacked_fwd": online_counts["stacked_fwd"],
                       "fused_mlp_stacked_bwd": online_counts["stacked_bwd"],
                       "fused_mlp_wgrad": online_parts["wgrad"],
                       "fused_mlp_sum_rows": online_parts["sum_rows"]}
    scaled_launches, polish_launches = ({
        "fused_mlp_fwd": c["fwd"], "fused_mlp_bwd": c["bwd"],
        "fused_mlp_stacked_fwd": c["stacked_fwd"], "fused_mlp_stacked_bwd": c["stacked_bwd"],
        "fused_mlp_wgrad": p["wgrad"], "fused_mlp_sum_rows": p["sum_rows"]}
        for c, p in ((scaled_counts, scaled_parts), (polish_counts, polish_parts)))
    for name, launched in (("phase 8", scaled_launches), ("phase 8b", polish_launches)):
        _require(all(launched.values()), f"{name} launched every kernel of its path: {launched}")
    later = {"occgrid_launches": (dict(occ_counts) | occ_parts, ("fwd", "bwd", "wgrad", "sum_rows")),
             "occgrid_render_launches": (render_launches, ("fwd", "bwd", "stacked_fwd",
                                                           "stacked_bwd", "wgrad", "sum_rows")),
             "nerf_time_app_launches": (nt_app_launches, ("enc_fwd", "enc_bwd", "wgrad",
                                                          "sum_rows")),
             "carla_launches": (carla_launches, ("enc_fwd", "enc_bwd", "wgrad", "sum_rows")),
             "lego_launches": (lego_launches, ("fwd", "bwd", "wgrad", "sum_rows")),
             "mip_launches": (mip_launches, ()),
             "data_parallel_launches": (dp_launches, ("fwd", "bwd", "stacked_fwd",
                                                      "stacked_bwd", "wgrad", "sum_rows")),
             "utils_launches": (util_launches, ("fwd", "bwd", "wgrad", "sum_rows"))}
    for name, (launched, path) in later.items():
        _require(all(launched[k] > 0 for k in path),
                 f"{name}: every kernel of its path launched: {launched}")
    for row in rows:
        row["app_init_launches"] = app_launches.get(row["name"], 0)
        row["online_launches"] = online_launches.get(row["name"], 0)
        row["scaled_online_launches"] = scaled_launches.get(row["name"], 0)
        row["polish_launches"] = polish_launches.get(row["name"], 0)
        for name, (launched, _) in later.items():
            row[name] = launched[row["name"].removeprefix("fused_mlp_")]
    for row, side in ((rows[0], "fwd"), (rows[1], "bwd")):
        row["occgrid_shapes"] = {
            shape: {"ms": t[side], "plain_ms": t["plain_" + side], "bound_ms": t["bound_" + side][0],
                    "bound_by": t["bound_" + side][1], "max_scaled_err": t["max_scaled_err"]}
            for shape, t in occ_shapes.items() if "bound_" + side in t}
    rows[0]["occgrid_alone"] = occ_shapes["alone"]
    print(f"total: {time.perf_counter() - t0:.1f} s, the build included", flush=True)
    print(f"card: {card}")
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
