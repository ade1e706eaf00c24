"""Online tracking: jointly optimise the radiance fields and the per-frame
SE(3) vehicle poses by photometric self-supervision, admitting frames
through the curriculum (PyTorch).

Counterpart of startrax/apps/online.py:

- init: random fields (or the static fields of an appearance checkpoint,
  ``appearance_ckpt_path``) and the noisy GT poses (``noisy_pose_init``),
  or the GT poses pinned (``load_gt_poses``);
- warmup: a field-forming phase with poses frozen (``pose_delay_epochs``),
  then BARF coarse-to-fine on the dynamic fields with rotations frozen
  (``end_barf``, ``barf_freeze_rot``);
- curriculum: joint epochs that admit frames, with a pose-only epoch every
  ``pose_only_every`` epochs;
- polish, once every frame is admitted: ``alternate`` (field epochs, then
  pose epochs, each to a loss plateau or its cap) or ``interleave``, with
  ghost and frame-0 anchor rays in the field phases; ``refit_anchor``
  (fresh dynamic fields fit from frame 0, a pose recovery, then the
  alternation); ``gauge_align`` (a shared per-vehicle SE(3) gauge fit
  against frame-0 reference fields, ``gauge_mode = ref_field``, or against
  the production fields on frame-0 rays, ``frame0``; the correction goes
  through the held-out guard or the magnitude caps, then the alternation,
  ``gauge_rounds`` times); photometric multi-start after a completed
  round (``multi_start_rounds``);
- GT-free best-epoch selection on the held-out view (``photometric``,
  ``photometric_depth``) or the GT-pose oracle (``gt_pose``), optionally
  preferring the best round-boundary epoch (``selection_boundary_only``);
- validation and checkpoints every ``epoch_val`` epochs (every optimizer's
  state, the curriculum, the polish sub-state and the best snapshots),
  resume from one (``online_ckpt_path``), and the stop rules.

The parameters are leaf tensors that every optimizer (a FusedGroupAdam per
phase kind, all over the same leaves) updates in place; a restore or an
adopted correction copies into them (train.checkpoint.copy_into) and never
rebinds them. The polishes' scratch trees (the gauge's reference fields, the
multi-start candidates) are trees of their own leaves with optimizers of
their own. LPIPS is not ported and raises NotImplementedError.

Ray-axis data parallelism (``data_parallel``, apps.common.make_run_mesh):
one process a rank, as a launcher starts them. Rank 0 samples each global
batch and broadcasts it; every rank steps on its shard of it, and the
optimizers sum the grads over the ranks, so that every rank holds the same
parameters; the draws of a step are the one-process step's
(models.star.render_star's shard), and the eval renders split their tiles
over the ranks. Every host decision reads values that are equal on every
rank (all-reduced metrics, gathered renders of equal parameters, or rank
0's wall clock); only rank 0 writes the run directory.

Usage:
  python -m startrax_torch.apps.online --config startrax/configs/synthetic_star_online_scaled.txt
  python -m startrax_torch.apps.online --config ... --test true --online_ckpt_path <run>/ckpts
  torchrun --nproc_per_node N -m startrax_torch.apps.online --config ...
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from ..data.prefetch import BatchPrefetcher
from ..device import resolve
from ..eval import pose as pose_mod
from ..eval.image import psnr as psnr_fn
from ..eval.image import ssim as ssim_fn
from ..eval.render import render_image
from ..models.fields import init_stacked_fields
from ..ops import lie
from ..parallel.mesh import replicate_params, shard_batch
from ..train import checkpoint as ckpt
from ..train import loop, optim
from ..train.curriculum import CurriculumConfig, CurriculumState, advance
from ..utils.config import Config, load_config, loss_config_from, star_config_from
from ..utils.tree import tree_leaves, tree_map
from .common import (Workspace, agree, host_prng, log_run_mesh, make_dataset, make_run_mesh,
                     next_batch)
from .test_protocol import check_supported, run_test_protocol

POLISH_MODES = ("alternate", "interleave", "gauge_align", "refit_anchor")


def check_supported_train(cfg: Config) -> None:
    """Raise ValueError for an unknown polish_mode."""
    if cfg.polish_epochs > 0 and cfg.polish_mode not in POLISH_MODES:
        raise ValueError(f"polish_mode must be alternate, interleave, gauge_align or "
                         f"refit_anchor, got {cfg.polish_mode}")


def _init_params(cfg: Config, star_cfg, generator, device, train_data, rng):
    """The online parameters: random fields from ``generator``, the static
    fields of the appearance checkpoint when one is named, and the GT or
    noisy GT poses (drawn from the numpy ``rng``)."""
    params = loop.init_online_params(star_cfg, cfg.num_frames, generator, device)
    if cfg.appearance_ckpt_path:
        app = ckpt.restore_checkpoint(cfg.appearance_ckpt_path, device=device)
        ckpt.copy_into(params, ckpt.restore_static_only(
            app["params"] if "params" in app else app, params))
    if cfg.load_gt_poses:
        # debug path: train with the GT poses, pinned by a zero pose LR
        gt = np.swapaxes(train_data.gt_relative_poses(), 0, 1)  # [F, K, 7]
        ckpt.copy_into(params["poses"], gt[1:])
    elif cfg.noisy_pose_init and hasattr(train_data, "noisy_gt_relative_poses"):
        noisy = train_data.noisy_gt_relative_poses(rng)  # [K, F, 7]
        ckpt.copy_into(params["poses"], np.swapaxes(noisy, 0, 1)[1:])  # [F-1, K, 7]
    return params


def _place_batch(batch, device, group=None):
    """A sampled batch (this rank's shard of it over a ray group) on the
    device. A shared-pose batch's frame stays a Python int, so that its
    dynamic fields take the per-field kernels with the in-kernel warp; a
    per-ray batch's [N] frames become a tensor."""
    if group is not None:
        batch = shard_batch(batch, group)
    return {k: int(v) if k == "frame" and np.ndim(v) == 0 else torch.as_tensor(v, device=device)
            for k, v in batch.items()}


# polish sub-state <-> checkpoint encoding (phases as ints, as startrax
# stores them)
_ALT_PHASES = ("field", "pose")
_REFIT_STAGES = ("field", "pose", "alternate")
_GA_STAGES = ("ref_field", "gauge", "alternate")


def _polish_template():
    return {"polish_used": 0, "alt_phase": 0, "alt_rounds": 0,
            "refit_stage": 0, "refit_used": 0,
            "ga_stage": 0, "ga_used": 0, "ga_rounds": 0,
            "best_score": 0.0, "best_epoch": -1,
            "bbest_score": 0.0, "bbest_epoch": -1, "n_boundary": 0}


def _loss_plateau(losses, window: int, tol: float) -> bool:
    """True when the mean loss of the last `window` epochs improved less than
    tol (relative) over the window before it."""
    if len(losses) < 2 * window:
        return False
    prev = float(np.mean(losses[-2 * window: -window]))
    last = float(np.mean(losses[-window:]))
    return last > (1.0 - tol) * prev


def _score_frames(cfg: Config, start_frame: int, num_frames: int):
    """Frames scored by selection: an evenly strided subset of the window
    when selection_frames caps it."""
    frames = list(range(start_frame, num_frames))
    if 0 < cfg.selection_frames < len(frames):
        idx = np.linspace(0, len(frames) - 1, cfg.selection_frames)
        frames = [frames[i] for i in sorted({int(round(i)) for i in idx})]
    return frames


def _depth_mse(pred, gt, near: float, far: float) -> float:
    """Host-side DS-NeRF relative-squared depth error over in-volume
    pixels."""
    mask = (gt > near) & (gt < far)
    if not mask.any():
        return 0.0
    err = ((pred - gt) / np.where(gt == 0, 1.0, gt)) ** 2
    return float(err[mask].mean())


def _held_out(cfg: Config, star_cfg, params, val_data, frames, depth_lambda, with_mass: bool,
              view: int, device, group=None):
    """The held-out view rendered at each of ``frames`` with the learned
    poses (frame 0 = identity), its pixels subsampled by selection_stride:
    the mean over the frames of the MSE, plus depth_lambda times the
    relative-squared depth error unless depth_lambda is None; and with
    with_mass the mean per-vehicle visibility mass [K] (1 - the dynamic
    transmittance, over rays and frames), else None."""
    s = max(cfg.selection_stride, 1)
    rays_o, rays_d = val_data.view_rays(view)
    rays_o, rays_d = rays_o[::s, ::s], rays_d[::s, ::s]
    # N_importance = 0 renders give only the "0"-suffixed (coarse) outputs
    suff = "" if star_cfg.n_importance > 0 else "0"
    keys = ("rgb" + suff,)
    if depth_lambda is not None:
        keys += ("depth" + suff,)
    if with_mass:
        keys += ("dynamic_transmittance" + suff,)
    poses = params["poses"].detach()
    total, count = 0.0, 0
    mass = np.zeros(star_cfg.num_vehicles)
    for f in frames:
        pose = loop.gather_frame_pose(poses, f, star_cfg.num_vehicles)
        out = render_image(params["nerf"], star_cfg, rays_o, rays_d, pose=pose, keys=keys,
                           device=device, group=group)
        target = np.asarray(val_data.images[view, f], np.float32)[::s, ::s]
        score = float(np.mean((out["rgb" + suff] - target) ** 2))
        if depth_lambda is not None:
            gt_d = np.asarray(val_data.depths[view, f], np.float32)[::s, ::s]
            score += depth_lambda * _depth_mse(out["depth" + suff], gt_d, star_cfg.near,
                                               star_cfg.far)
        total += score
        if with_mass:
            mass += np.mean(1.0 - out["dynamic_transmittance" + suff], axis=(0, 1))
        count += 1
    return total / max(count, 1), (mass / max(count, 1) if with_mass else None)


def selection_score(cfg: Config, star_cfg, params, val_data, num_frames: int, view: int = 0,
                    start_frame: int = 0, device=None, group=None) -> float:
    """GT-free best-epoch criterion: the mean MSE of a held-out val view
    rendered at every scored frame with the learned poses (frame 0 =
    identity); lower is better. selection = "photometric_depth" adds
    selection_depth_lambda times the relative-squared depth error when the
    dataset carries depth maps. selection_frames / selection_stride
    subsample the scored frames / pixels. device=None is the card; group:
    the ray group the renders split their tiles over, or None."""
    use_depth = (cfg.selection == "photometric_depth"
                 and getattr(val_data, "depths", None) is not None)
    score, _ = _held_out(cfg, star_cfg, params, val_data,
                         _score_frames(cfg, start_frame, num_frames),
                         cfg.selection_depth_lambda if use_depth else None, False, view,
                         resolve(device), group)
    return score


# gauge_guard: a candidate correction must keep the vehicle at least this
# visible (held-out mean opacity mass against the uncorrected poses). A
# garbage fit that moves a vehicle out of the frustum can improve the
# held-out photometric score where the reference dynamic fields explain the
# pixels worse than the static background ("accept by vanishing"). The
# default of the gauge_guard_min_vis flag.
GAUGE_GUARD_MIN_VIS = 0.3


def _gauge_accept(base_score: float, cand_score: float, base_vis: float, cand_vis: float,
                  min_vis: float = GAUGE_GUARD_MIN_VIS, rel: float = 1e-3) -> bool:
    """Per-vehicle gauge acceptance: the candidate correction must strictly
    improve the held-out photometric error and keep the vehicle visible."""
    better = cand_score < base_score * (1.0 - rel)
    visible = base_vis < 1e-4 or cand_vis >= min_vis * base_vis
    return bool(better and visible)


def _guard_eval(cfg: Config, star_cfg, params, val_data, num_frames: int, view: int = 0,
                start_frame: int = 1, device=None, group=None):
    """The held-out photometric error (+ gauge_depth_lambda times the depth
    error when the dataset carries depth maps) and the per-vehicle held-out
    visibility mass [K], over the frames selection_frames scores, pixels
    subsampled by selection_stride. device=None is the card; group as
    selection_score."""
    use_depth = (cfg.gauge_depth_lambda > 0
                 and getattr(val_data, "depths", None) is not None)
    return _held_out(cfg, star_cfg, params, val_data,
                     _score_frames(cfg, start_frame, num_frames),
                     cfg.gauge_depth_lambda if use_depth else None, True, view, resolve(device),
                     group)


def gauge_within_caps(G: np.ndarray, max_trans: float, max_rot: float):
    """gauge_mode = frame0's magnitude caps on the correction G [K, 7]
    (translation, quaternion x y z w): for each vehicle (within, |t|,
    angle), the angle being 2 arccos(min(1, |q_w|)). A diverged short fit
    cannot jump a vehicle's whole pose table. The arithmetic is in G's
    dtype, as startrax's is."""
    out = []
    for g in G:
        tnorm = float(np.linalg.norm(g[:3]))
        ang = 2.0 * float(np.arccos(min(1.0, abs(g[6]))))
        out.append((tnorm <= max_trans and ang <= max_rot, tnorm, ang))
    return out


def guard_gauge(G: np.ndarray, evaluate, min_vis: float):
    """gauge_mode = ref_field's guard, vehicle by vehicle: evaluate(g [K, 7])
    -> (held-out score, visibility mass [K]) of the poses corrected by g.
    The identity's score is the base; vehicle k's row of G joins the rows
    accepted so far when _gauge_accept holds for them plus it. Returns
    (accepted [K, 7], [(base, score, base_vis, vis, accepted)] a vehicle)."""
    accepted = lie.se3_identity(G.shape[0]).numpy()
    base, base_mass = evaluate(accepted)
    decisions = []
    for k in range(G.shape[0]):
        gk = accepted.copy()
        gk[k] = G[k]
        sk, mk = evaluate(gk)
        ok = _gauge_accept(base, sk, base_mass[k], mk[k], min_vis=min_vis)
        decisions.append((base, sk, base_mass[k], mk[k], ok))
        if ok:
            accepted[k] = G[k]
    return accepted, decisions


def fresh_dynamic_fields(star_cfg, names, generator, device):
    """Newly initialised stacked dynamic fields for each of ``names``
    ("dynamic_coarse", "dynamic_fine"), drawn from ``generator``, as leaves
    that require grad: the fields that refit_anchor copies into the live
    ones and that the gauge's reference fit trains."""
    fields = {n: init_stacked_fields(star_cfg.dynamic_field(fine=n == "dynamic_fine"),
                                     star_cfg.num_vehicles, generator, device) for n in names}
    for leaf in tree_leaves(fields):
        leaf.requires_grad_(True)
    return fields


def train(cfg: Config, device=None):
    """Run online training; returns the parameters (leaf tensors on
    ``device``, None: the card, device.resolve; over a ray group, the
    group's device)."""
    check_supported_train(cfg)
    group = make_run_mesh(cfg, device)
    dev = resolve(device) if group is None else group.device
    ws = Workspace(cfg, "online", group)
    # the main (post-warmup) steps run at full frequency; a BARF-masked
    # variant serves the warmup epochs only
    star_cfg = dataclasses.replace(star_config_from(cfg), end_barf=-1)
    star_cfg_barf = (dataclasses.replace(star_cfg, end_barf=cfg.end_barf)
                     if cfg.end_barf > 0 else star_cfg)
    loss_cfg = loss_config_from(cfg)
    K = star_cfg.num_vehicles

    train_data = make_dataset(cfg, "train", dev)
    val_data = make_dataset(cfg, "val", dev)
    has_gt = hasattr(train_data, "gt_relative_poses")
    gt_rel = (np.swapaxes(train_data.gt_relative_poses(), 0, 1)
              if has_gt else None)  # [F, K, 7]

    rng, gen = host_prng(cfg.seed, dev)
    params = _init_params(cfg, star_cfg, gen, dev, train_data, rng)
    n_rand = log_run_mesh(ws, group, cfg.N_rand)
    if group is not None:
        replicate_params(params, group)

    pose_lr = 0.0 if cfg.load_gt_poses else cfg.lrate_pose
    opt_kw = dict(steps_per_epoch=cfg.steps_per_epoch, grad_clip=1.0,
                  accumulate_steps=cfg.accumulate_grad_batches, ray_group=group)
    nerf_decay = dict(decay_rate=cfg.lrate_decay_rate, decay_epochs=cfg.lrate_decay,
                      decay_milestones=cfg.lrate_decay_steps)
    pose_decay = dict(pose_decay_rate=cfg.pose_lrate_decay_rate,
                      pose_decay_epochs=cfg.pose_lrate_decay,
                      pose_decay_milestones=cfg.pose_lrate_decay_steps)
    polishing = cfg.polish_epochs > 0 and not cfg.load_gt_poses

    # the joint optimizer and step; the BARF warmup shares its state, with
    # the dynamic fields coarse-to-fine masked and rotations optionally
    # frozen (a blurred field is nearly rotation-symmetric)
    opt = optim.make_fused_star_optimizer(
        params, lrate_static=cfg.lrate_static, lrate_dynamic=cfg.lrate_dynamic,
        lrate_pose=pose_lr, **nerf_decay, **pose_decay, **opt_kw)
    step_fn = loop.make_online_train_step(star_cfg, loss_cfg, opt,
                                          trans_only=cfg.pose_trans_only)
    step_fn_barf = None
    if cfg.end_barf > 0:
        step_fn_barf = loop.make_online_train_step(
            star_cfg_barf, loss_cfg, opt, trans_only=cfg.pose_trans_only,
            freeze_rot=cfg.barf_freeze_rot and not cfg.pose_trans_only)

    # fields-only steps (pose LR 0): the field-forming warmup and the
    # alternation's field phases share one optimizer; refit_anchor and
    # gauge_align fall through to the alternation, so they need it too
    opt_field = None
    if cfg.pose_delay_epochs > 0 or (cfg.polish_epochs > 0 and cfg.polish_mode in (
            "alternate", "refit_anchor", "gauge_align")):
        opt_field = optim.make_fused_star_optimizer(
            params, lrate_static=cfg.lrate_static, lrate_dynamic=cfg.lrate_dynamic,
            lrate_pose=0.0, **nerf_decay, **opt_kw)
        step_fn_field = loop.make_online_train_step(star_cfg, loss_cfg, opt_field)
        step_fn_fieldform = (loop.make_online_train_step(star_cfg_barf, loss_cfg, opt_field)
                             if cfg.end_barf > 0 else step_fn_field)

    # pose-only step (field LRs 0) for the pose_only_every epochs
    opt_pose = None
    if cfg.pose_only_every > 0 and not cfg.load_gt_poses:
        opt_pose = optim.make_fused_star_optimizer(
            params, lrate_static=0.0, lrate_dynamic=0.0, lrate_pose=pose_lr,
            **pose_decay, **opt_kw)
        step_fn_pose = loop.make_online_train_step(star_cfg, loss_cfg, opt_pose,
                                                   trans_only=cfg.pose_trans_only)

    # the polish's pose refinement: pose-only, with its own decaying LR and
    # fresh moments; a multi-start candidate gets an optimizer of the same
    # settings over its own tree
    polish_kw = dict(lrate_static=0.0, lrate_dynamic=0.0, lrate_pose=pose_lr,
                     pose_decay_rate=cfg.polish_pose_lrate_decay_rate,
                     pose_decay_epochs=cfg.polish_pose_lrate_decay, **opt_kw)
    opt_polish = None
    if polishing:
        opt_polish = optim.make_fused_star_optimizer(params, **polish_kw)
        step_fn_polish = loop.make_online_train_step(star_cfg, loss_cfg, opt_polish,
                                                     trans_only=cfg.pose_trans_only)
    extra_opts = (("opt_state_pose", opt_pose), ("opt_state_polish", opt_polish),
                  ("opt_state_field", opt_field))

    # refit_anchor / gauge_align: dynamic-fields-only (static and poses
    # pinned) for the frame-0 (re-)fit, over the live leaves for
    # refit_anchor, over each gauge round's scratch tree for gauge_align
    refit_kw = dict(lrate_static=0.0, lrate_dynamic=cfg.lrate_dynamic, lrate_pose=0.0,
                    **nerf_decay, **opt_kw)
    if polishing and cfg.polish_mode == "refit_anchor":
        opt_refit = optim.make_fused_star_optimizer(params, **refit_kw)
        step_fn_refit = loop.make_online_train_step(star_cfg, loss_cfg, opt_refit)
        step_fn_refit_pose = (
            loop.make_online_train_step(
                star_cfg, loss_cfg, opt_polish, trans_only=cfg.pose_trans_only,
                freeze_rot=not cfg.pose_trans_only)
            if cfg.refit_pose_freeze_rot else step_fn_polish)

    cur_cfg = CurriculumConfig(
        num_frames=cfg.num_frames, initial_num_frames=cfg.initial_num_frames,
        online_thres=cfg.online_thres, min_epochs_between=cfg.epochs_between_frames,
        tightened_thres=cfg.online_thres_tightened)
    cur = CurriculumState.initial(cur_cfg)

    start_epoch = 0
    resume_polish = None
    if cfg.online_ckpt_path:
        restored = ckpt.restore_checkpoint(cfg.online_ckpt_path, device=dev)
        ckpt.copy_into(params, restored["params"])
        opt.load_state_dict(restored["opt_state"])
        for name, o in extra_opts:
            if o is not None and name in restored:
                o.load_state_dict(restored[name])
        cur = ckpt.curriculum_from_dict(restored["curriculum"])
        # the admission threshold is config-derived calibration, not run
        # state: re-derive it from the current config so that a per-scene
        # recalibration applies on resume
        new_thr = (cur_cfg.tightened_thres if cur.current_frame > cur_cfg.initial_num_frames
                   else cur_cfg.online_thres)
        if new_thr != cur.threshold:
            ws.log(f"curriculum threshold recalibrated on resume: "
                   f"{cur.threshold:g} -> {new_thr:g}")
            cur = dataclasses.replace(cur, threshold=new_thr)
        resume_polish = restored.get("polish")
        start_epoch = int(restored.get("epoch", -1)) + 1
        ws.log(f"resumed online training at epoch {start_epoch}, "
               f"frame window {cur.current_frame}")

    def pose_errors(poses):
        trans, rot, *_ = pose_mod.get_pose_metrics_multi(poses.detach().cpu().numpy(),
                                                         gt_rel[1:])
        return [float(t) for t in trans], [float(r) for r in rot]

    if has_gt and cfg.noisy_pose_init and not cfg.load_gt_poses:
        t0, r0 = pose_errors(params["poses"])
        ws.log(f"initial pose error: trans={t0} rot={r0}")

    # Host-side sampling overlaps device execution. The workers read
    # `sample_state` without a lock: up to depth + workers queued batches
    # were sampled under the previous phase's state; steps_per_epoch is far
    # larger than the queue, so a handful of stale-window batches at each
    # transition is accepted by design. Over a ray group only rank 0 samples
    # (apps.common.next_batch), so every rank steps on the same batch.
    sample_state = {"start": cur.start_frame, "end": min(cur.current_frame, cfg.num_frames),
                    "car": cfg.car_sample_ratio, "crop": False,
                    "ghost": cfg.ghost_sample_ratio, "f0": cfg.frame0_sample_ratio,
                    "mixed": cfg.mixed_frames}
    prefetcher = BatchPrefetcher(
        lambda r, st: train_data.sample_batch(
            r, n_rand, start_frame=st["start"], current_frame=st["end"],
            car_sample_ratio=st["car"], crop=st["crop"], mixed_frames=st["mixed"],
            ghost_sample_ratio=st["ghost"], frame0_sample_ratio=st["f0"]),
        sample_state, seed=cfg.seed * 7919 + 1, depth=6,
        workers=max(cfg.num_workers, 1)) if ws.writes else None

    car_pose = (cfg.car_sample_ratio_pose if cfg.car_sample_ratio_pose >= 0
                else cfg.car_sample_ratio)
    deadline = time.time() + cfg.train_minutes * 60 if cfg.train_minutes > 0 else None
    sel_enabled = cfg.selection != "none" and (cfg.selection != "gt_pose" or has_gt)
    best = {"score": float("inf"), "epoch": -1, "params": None}
    # the round-boundary best (selection_boundary_only): the best-scoring
    # epoch among those that complete a field + pose alternation round, the
    # settled states
    bbest = {"score": float("inf"), "epoch": -1, "params": None}
    n_boundary = 0
    best_saved = bbest_saved = -1

    def _active_best():
        """The selection rule that ships: the boundary best once there are
        at least two boundaries (one carries no comparison), else the
        every-epoch best."""
        if cfg.selection_boundary_only and n_boundary >= 2 and bbest["epoch"] >= 0:
            return bbest
        return best

    history = []
    # alternation sub-state
    alt_phase, alt_losses, alt_rounds = "field", [], 0
    # refit_anchor sub-state: field (frame-0 dynamic re-fit) -> pose ->
    # alternate for the remainder
    refit = {"stage": "field", "used": 0}
    # gauge_align sub-state: ref_field (fresh reference dynamics on a
    # scratch tree) -> gauge (the shared SE(3) fit) -> alternate; re-enters
    # ref_field after each completed round while rounds remain. The scratch
    # tree, the gauge and their steps are not checkpointed
    ga = {"stage": "ref_field", "used": 0, "rounds": 0, "ref_params": None, "ref_step": None,
          "gauge": None, "gauge_step": None}
    # photometric multi-start sub-state: restarts on resume (its result
    # lives in the adopted poses)
    ms = {"rounds": 0, "pending": False}
    polish_used = 0
    step = 0
    stop_reason = ""

    if resume_polish is not None:
        pd = {**_polish_template(), **resume_polish}
        polish_used = int(pd["polish_used"])
        alt_phase = _ALT_PHASES[int(pd["alt_phase"])]
        alt_rounds = int(pd["alt_rounds"])
        refit.update(stage=_REFIT_STAGES[int(pd["refit_stage"])], used=int(pd["refit_used"]))
        ga.update(stage=_GA_STAGES[int(pd["ga_stage"])], used=int(pd["ga_used"]),
                  rounds=int(pd["ga_rounds"]))
        # an interrupted gauge round restarts from its reference fit
        if ga["stage"] in ("ref_field", "gauge"):
            ga.update(stage="ref_field", used=0)
        for snap, name, suffix in ((best, "best", "_best"), (bbest, "bbest", "_bbound")):
            if int(pd[f"{name}_epoch"]) < 0:
                continue
            snap.update(score=float(pd[f"{name}_score"]), epoch=int(pd[f"{name}_epoch"]))
            try:
                snap["params"] = ckpt.restore_checkpoint(cfg.online_ckpt_path + suffix,
                                                         device=dev)["params"]
                ws.log(f"restored {'best-epoch' if snap is best else 'boundary-best'} snapshot "
                       f"(epoch {snap['epoch']}, score {snap['score']:.3e})")
            except FileNotFoundError:
                snap.update(score=float("inf"), epoch=-1)
        n_boundary = int(pd["n_boundary"])
        ws.log(f"resumed polish sub-state: used={polish_used} alt={alt_phase}/{alt_rounds} "
               f"ga={ga['stage']}/{ga['rounds']}")

    def _polish_state():
        return {"polish_used": polish_used, "alt_phase": _ALT_PHASES.index(alt_phase),
                "alt_rounds": alt_rounds,
                "refit_stage": _REFIT_STAGES.index(refit["stage"]), "refit_used": refit["used"],
                "ga_stage": _GA_STAGES.index(ga["stage"]), "ga_used": ga["used"],
                "ga_rounds": ga["rounds"],
                "best_score": best["score"] if best["epoch"] >= 0 else 0.0,
                "best_epoch": best["epoch"],
                "bbest_score": bbest["score"] if bbest["epoch"] >= 0 else 0.0,
                "bbest_epoch": bbest["epoch"], "n_boundary": n_boundary}

    def _state(epoch):
        state = {"params": params, "opt_state": opt.state_dict(),
                 "curriculum": ckpt.curriculum_to_dict(cur), "epoch": epoch,
                 "polish": _polish_state()}
        for name, o in extra_opts:
            if o is not None:
                state[name] = o.state_dict()
        return state

    # DS-NeRF supervision terms, averaged per epoch for the logs
    aux_losses = {}

    def run_phase_epoch(fn, epoch, car, ghost, f0, window=None, p=None, mixed=None):
        """One epoch of fn's steps on p (default: the live params), sampling
        from window (default: the curriculum's)."""
        nonlocal step
        start, end = (window if window is not None
                      else (cur.start_frame, min(cur.current_frame, cfg.num_frames)))
        sample_state.update(start=start, end=end, crop=epoch < cfg.precrop_iters, car=car,
                            ghost=ghost, f0=f0, mixed=cfg.mixed_frames if mixed is None else mixed)
        p = params if p is None else p
        fines = []
        aux_losses.clear()
        for _ in range(cfg.steps_per_epoch):
            batch = _place_batch(next_batch(prefetcher, group), dev, group)
            _, metrics = fn(p, batch, epoch=epoch, generator=gen)
            step += 1
            fines.append(metrics["fine_loss"])  # device scalar, no sync
            for k in ("depth_loss", "sigma_loss"):
                if k in metrics:
                    aux_losses.setdefault(k, []).append(metrics[k])
        return float(torch.stack(fines).mean())  # one device read an epoch

    def start_reference():
        """A scratch tree for the gauge's reference fit: the live static
        fields (pinned by the refit LRs), fresh dynamic fields, its own copy
        of the poses (its steps renormalise their quaternions), and its own
        optimizer and step."""
        names = [n for n in ("dynamic_coarse", "dynamic_fine") if n in params["nerf"]]
        ref = {"nerf": {**params["nerf"], **fresh_dynamic_fields(star_cfg, names, gen, dev)},
               "poses": params["poses"].detach().clone().requires_grad_(True)}
        ga.update(ref_params=ref, ref_step=loop.make_online_train_step(
            star_cfg, loss_cfg, optim.make_fused_star_optimizer(ref, **refit_kw)))

    def start_gauge():
        """Enter the gauge stage: an identity gauge leaf [K, 7], plain Adam
        over it and its step."""
        gauge = lie.se3_identity(K, device=dev).requires_grad_(True)
        ga.update(stage="gauge", used=0, gauge=gauge, gauge_step=loop.make_gauge_train_step(
            star_cfg, optim.make_gauge_optimizer(gauge, cfg.lrate_pose, ray_group=group),
            freeze_rot=cfg.gauge_freeze_rot, depth_lambda=cfg.gauge_depth_lambda))

    def run_gauge_epoch():
        """One epoch of the shared gauge fit, production poses frozen.
        ref_field: frames 1..F-1 against the scratch reference fields;
        frame0: frame-0 rays against the production fields (frame 0's pose
        is the identity, so the rendered pose is G itself). Per-ray mixed
        frames: every frame contributes to the shared G each step."""
        nonlocal step
        frame0 = cfg.gauge_mode == "frame0"
        sample_state.update(start=0 if frame0 else 1, end=1 if frame0 else cfg.num_frames,
                            crop=False, car=car_pose, ghost=0.0, f0=0.0, mixed=True)
        nerf = params["nerf"] if frame0 else ga["ref_params"]["nerf"]
        losses = []
        for _ in range(cfg.steps_per_epoch):
            batch = _place_batch(next_batch(prefetcher, group), dev, group)
            losses.append(ga["gauge_step"](ga["gauge"], nerf, params["poses"], batch,
                                           generator=gen))
            step += 1
        return float(torch.stack(losses).mean())

    def decide_gauge():
        """The correction to apply, [K, 7] numpy, and how many vehicles it
        corrects: the fitted gauge (its inverse in frame0 mode) row by row
        as the caps (frame0) or the guard (ref_field) accept it."""
        G = ga["gauge"].detach().cpu()
        frame0 = cfg.gauge_mode == "frame0"
        if frame0:
            # the fitted g places the drifted canonical field at frame-0
            # truth; the pose correction is its inverse
            G = lie.se3_inverse(G)
        G = G.numpy()
        if frame0:
            accepted, n_acc = lie.se3_identity(K).numpy(), 0
            for k, (ok, tnorm, ang) in enumerate(
                    gauge_within_caps(G, cfg.gauge_max_trans, cfg.gauge_max_rot)):
                if ok:
                    accepted[k] = G[k]
                    n_acc += 1
                else:
                    ws.log(f"gauge_align[frame0]: vehicle {k} correction |t|={tnorm:.4f} "
                           f"rot={ang:.4f} exceeds cap ({cfg.gauge_max_trans}/"
                           f"{cfg.gauge_max_rot}) — rejected")
            if n_acc:
                ws.log(f"gauge_align[frame0]: applying g^-1 t="
                       f"{accepted[:, :3].round(4).tolist()} ({n_acc}/{K} within bounds; "
                       "selection guards)")
            return accepted, n_acc
        if not cfg.gauge_guard:
            return G, K

        def evaluate(g):
            cand = lie.se3_multiply(torch.from_numpy(g).to(dev)[None], params["poses"].detach())
            return _guard_eval(cfg, star_cfg, {"nerf": ga["ref_params"]["nerf"], "poses": cand},
                               val_data, cfg.num_frames, start_frame=1, device=dev, group=group)

        accepted, decisions = guard_gauge(G, evaluate, cfg.gauge_guard_min_vis)
        for k, (base, sk, bv, vk, ok) in enumerate(decisions):
            ws.log(f"gauge_align guard: vehicle {k} held-out {base:.4e} -> {sk:.4e} "
                   f"vis {bv:.4e} -> {vk:.4e} ({'accept' if ok else 'reject'})")
        return accepted, sum(d[-1] for d in decisions)

    def run_multi_start(epoch):
        """Basin hopping over the drift subspace: per-vehicle constant
        translation perturbations of the pose table, each given a short
        pose-only polish with fresh moments on a tree of its own poses, all
        scored by the selection criterion; the best strictly-improving
        candidate's poses are adopted. Returns the adopted (or base)
        score."""
        rng_ms = np.random.default_rng(cfg.seed * 31 + ms["rounds"] * 7 + 5)
        base_score = selection_score(cfg, star_cfg, params, val_data, cfg.num_frames, device=dev,
                                     group=group)
        fields = [t.detach().clone() for t in tree_leaves(params["nerf"])]
        best_sc, best_poses, best_c = base_score, None, -1
        for c in range(cfg.multi_start_candidates):
            g = lie.se3_identity(K).numpy()
            d = rng_ms.normal(size=(K, 3))
            d /= np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
            g[:, :3] = cfg.multi_start_scale * d
            # the live fields (pinned by the polish LRs) and a pose leaf of
            # its own
            cand = {"nerf": params["nerf"], "poses": lie.se3_multiply(
                torch.from_numpy(g).to(dev)[None], params["poses"].detach()).requires_grad_(True)}
            cand_step = loop.make_online_train_step(
                star_cfg, loss_cfg, optim.make_fused_star_optimizer(cand, **polish_kw),
                trans_only=cfg.pose_trans_only)
            for _ in range(cfg.multi_start_epochs):
                # per-ray mixed frames: every frame's pose gets a gradient
                # in every step of the short budget
                run_phase_epoch(cand_step, epoch, car_pose, 0.0, 0.0, p=cand, mixed=True)
            sc = selection_score(cfg, star_cfg, cand, val_data, cfg.num_frames, device=dev,
                                 group=group)
            # ~0: the candidate rolled back into the base's basin
            resid = float((cand["poses"].detach()[..., :3]
                           - params["poses"].detach()[..., :3]).abs().max())
            ws.log(f"multi_start: candidate {c} |g|="
                   f"{np.linalg.norm(g[:, :3], axis=-1).round(4).tolist()} "
                   f"score {sc:.4e} (base {base_score:.4e}) residual_disp {resid:.4f}")
            if sc < best_sc:
                best_sc, best_poses, best_c = sc, cand["poses"], c
        if not all(torch.equal(a, b) for a, b in zip(fields, tree_leaves(params["nerf"]))):
            raise RuntimeError("multi_start: a candidate's pose-only polish changed the fields")
        if best_poses is not None:
            ckpt.copy_into(params["poses"], best_poses.detach())
            # the pose jump invalidates the accumulated moments
            opt_field.reset()
            opt_polish.reset()
            ws.log(f"multi_start: adopted candidate {best_c} "
                   f"({base_score:.4e} -> {best_sc:.4e})")
        else:
            ws.log(f"multi_start: no candidate beat the base ({base_score:.4e})")
        return best_sc

    try:
        for epoch in range(start_epoch, cfg.epochs_online):
            if agree(deadline is not None and time.time() > deadline, group):
                stop_reason = "train_minutes budget"
                break
            aux_losses.clear()
            # set when this epoch completes a field + pose alternation round
            round_boundary = False

            in_fieldform = epoch < cfg.pose_delay_epochs and opt_field is not None
            in_barf = not in_fieldform and cfg.end_barf > 0 and epoch < cfg.end_barf
            in_polish = cur.done and polishing
            if cur.done and not in_polish:
                break

            phase = "joint"
            if in_fieldform:
                phase = "fieldform"
                avg = run_phase_epoch(step_fn_fieldform, epoch, cfg.car_sample_ratio,
                                      cfg.ghost_sample_ratio, cfg.frame0_sample_ratio)
            elif in_barf:
                phase = "barf"
                avg = run_phase_epoch(step_fn_barf, epoch, cfg.car_sample_ratio,
                                      cfg.ghost_sample_ratio, cfg.frame0_sample_ratio)
            elif in_polish:
                if polish_used >= cfg.polish_epochs:
                    stop_reason = "polish budget"
                    break
                polish_used += 1
                mode = cfg.polish_mode
                if (mode == "refit_anchor" and refit["stage"] == "alternate") or (
                        mode == "gauge_align" and ga["stage"] == "alternate"):
                    mode = "alternate"
                if (mode == "gauge_align" and ga["stage"] == "ref_field"
                        and cfg.gauge_mode == "frame0"):
                    # the frame-0 estimator needs no reference fields
                    start_gauge()
                    ws.log(f"gauge_align[frame0]: fitting the frame-0 gauge "
                           f"(round {ga['rounds']})")
                if ms["pending"] and mode == "alternate" and ms["rounds"] < cfg.multi_start_rounds:
                    phase = "multi_start"
                    avg = run_multi_start(epoch)
                    ms.update(rounds=ms["rounds"] + 1, pending=False)
                    alt_phase, alt_losses = "field", []
                elif mode == "gauge_align" and ga["stage"] == "ref_field":
                    if ga["used"] == 0:
                        # fresh dynamic fields fit from frame-0 rays carry no
                        # canonical-frame drift by construction
                        start_reference()
                        ws.log(f"gauge_align: fitting frame-0 reference fields "
                               f"(round {ga['rounds']})")
                    phase = "gauge_ref"
                    avg = run_phase_epoch(ga["ref_step"], epoch, car_pose, 0.0, 0.0,
                                          window=(0, 1), p=ga["ref_params"], mixed=True)
                    ga["used"] += 1
                    if ga["used"] >= cfg.refit_epochs:
                        start_gauge()
                elif mode == "gauge_align":  # ga["stage"] == "gauge"
                    phase = "gauge_fit"
                    avg = run_gauge_epoch()
                    ga["used"] += 1
                    if ga["used"] >= cfg.gauge_epochs:
                        accepted, n_acc = decide_gauge()
                        if n_acc == 0:
                            # no real drift found (or a duplicate mode): stop
                            # gauging, poses and moments untouched
                            ga.update(stage="alternate", used=0, rounds=cfg.gauge_rounds)
                            ws.log("gauge_align: guard rejected every vehicle -> alternate "
                                   "(poses unchanged)")
                        else:
                            ckpt.copy_into(params["poses"], lie.se3_multiply(
                                torch.from_numpy(accepted).to(dev)[None],
                                params["poses"].detach()))
                            # the pose jump invalidates the accumulated moments
                            opt_field.reset()
                            opt_polish.reset()
                            ga.update(stage="alternate", used=0, rounds=ga["rounds"] + 1)
                            ws.log(f"gauge_align: applied gauge t={accepted[:, :3].tolist()} "
                                   f"({n_acc}/{K} accepted) -> alternate re-convergence")
                        ga.update(ref_params=None, ref_step=None, gauge=None, gauge_step=None)
                        alt_phase, alt_losses = "field", []
                elif mode == "refit_anchor" and refit["stage"] == "field":
                    if refit["used"] == 0:
                        # re-anchor: fresh canonical dynamic fields fit from
                        # frame-0 rays (identity pose, exact by construction)
                        names = [n for n in ("dynamic_coarse", "dynamic_fine")
                                 if n in params["nerf"]]
                        fresh = fresh_dynamic_fields(star_cfg, names, gen, dev)
                        ckpt.copy_into({n: params["nerf"][n] for n in names}, fresh)
                        opt_refit.reset()
                        ws.log("refit_anchor: dynamic fields re-initialized, fitting from frame 0")
                    phase = "refit_field"
                    avg = run_phase_epoch(step_fn_refit, epoch, car_pose, 0.0, 0.0,
                                          window=(0, max(1, min(cfg.refit_window,
                                                                cfg.num_frames))))
                    refit["used"] += 1
                    if refit["used"] >= cfg.refit_epochs:
                        refit.update(stage="pose", used=0)
                elif mode == "refit_anchor":  # refit["stage"] == "pose"
                    phase = "refit_pose"
                    avg = run_phase_epoch(step_fn_refit_pose, epoch, car_pose, 0.0, 0.0)
                    refit["used"] += 1
                    if refit["used"] >= cfg.refit_pose_epochs:
                        refit.update(stage="alternate", used=0)
                        ws.log("refit_anchor: pose recovery done -> alternate")
                elif mode == "alternate":
                    if alt_phase == "field":
                        phase = "polish_field"
                        avg = run_phase_epoch(step_fn_field, epoch, cfg.car_sample_ratio,
                                              cfg.ghost_sample_ratio, cfg.frame0_sample_ratio)
                        alt_losses.append(avg)
                        if (len(alt_losses) >= cfg.alt_field_epochs
                                or _loss_plateau(alt_losses, cfg.alt_plateau_window,
                                                 cfg.alt_plateau_tol)):
                            alt_phase, alt_losses = "pose", []
                    else:
                        phase = "polish_pose"
                        avg = run_phase_epoch(step_fn_polish, epoch, car_pose, 0.0, 0.0)
                        alt_losses.append(avg)
                        if (len(alt_losses) >= cfg.alt_pose_epochs
                                or _loss_plateau(alt_losses, cfg.alt_plateau_window,
                                                 cfg.alt_plateau_tol)):
                            alt_phase, alt_losses = "field", []
                            alt_rounds += 1
                            round_boundary = True
                            if cfg.polish_mode == "gauge_align" and ga["rounds"] < cfg.gauge_rounds:
                                # another gauge round from the re-converged
                                # fixed point
                                ga.update(stage="ref_field", used=0)
                            elif ms["rounds"] < cfg.multi_start_rounds:
                                # basin-hop from the completed round's optimum
                                ms["pending"] = True
                else:  # interleave
                    if polish_used % max(cfg.polish_joint_every, 1) == 0:
                        phase = "polish_joint"
                        avg = run_phase_epoch(step_fn, epoch, cfg.car_sample_ratio,
                                              cfg.ghost_sample_ratio, cfg.frame0_sample_ratio)
                    else:
                        phase = "polish_pose"
                        avg = run_phase_epoch(step_fn_polish, epoch, car_pose, 0.0, 0.0)
            elif opt_pose is not None and epoch > 0 and epoch % cfg.pose_only_every == 0:
                phase = "pose"
                avg = run_phase_epoch(step_fn_pose, epoch, car_pose, 0.0, 0.0)
            else:
                # no ghost / frame-0 anchor rays here: the admission
                # threshold is calibrated on the plain photometric loss, and
                # anchor rays through un-carved static ghosts inflate the
                # epoch average above it
                avg = run_phase_epoch(step_fn, epoch, cfg.car_sample_ratio, 0.0, 0.0)

            prev_frame = cur.current_frame
            if not cur.done and not in_fieldform and not in_barf \
                    and epoch >= cfg.precrop_iters:
                cur = advance(cur, cur_cfg, avg)
            if cur.current_frame != prev_frame:
                ws.log(f"curriculum: admitted frame {cur.current_frame - 1}")
            if cur.done and prev_frame != cur.current_frame and in_polish is False \
                    and cfg.polish_epochs > 0:
                ws.log(f"curriculum complete -> polish stage ({cfg.polish_mode})")

            row = {"epoch": epoch, "phase": phase, "fine": round(avg, 6),
                   "window": cur.current_frame}
            logs = {"train/fine_loss": avg, "train/current_frame_num": cur.current_frame,
                    "epoch": epoch}
            for k, v in aux_losses.items():
                logs[f"train/{k}"] = float(torch.stack(v).mean())

            trans_err = rot_err = None
            if has_gt and not cfg.load_gt_poses:
                trans_err, rot_err = pose_errors(params["poses"])
                row["trans"] = [round(t, 5) for t in trans_err]
                row["rot"] = [round(r, 5) for r in rot_err]
                logs.update({f"train/trans_error_{k}": v for k, v in enumerate(trans_err)})
                logs.update({f"train/rot_error_{k}": v for k, v in enumerate(rot_err)})

            # best-epoch selection once every frame is admitted (scores are
            # comparable only at a fixed window)
            if cur.done and sel_enabled:
                if cfg.selection == "gt_pose" and trans_err is not None:
                    score = sum(trans_err) + sum(rot_err)
                else:
                    score = selection_score(cfg, star_cfg, params, val_data, cfg.num_frames,
                                            device=dev, group=group)
                row["score"] = round(score, 8)
                logs["train/selection_score"] = score
                if score < best["score"]:
                    best.update(score=score, epoch=epoch,
                                params=tree_map(lambda t: t.detach().clone(), params))
                if cfg.selection_boundary_only and round_boundary:
                    n_boundary += 1
                    row["boundary"] = True
                    if score < bbest["score"]:
                        bbest.update(score=score, epoch=epoch,
                                     params=tree_map(lambda t: t.detach().clone(), params))
                        ws.log(f"boundary best: epoch {epoch} (round {alt_rounds}, "
                               f"score {score:.3e})")

            history.append(row)
            ws.metrics.log(logs, step)
            ws.log(f"epoch {epoch} [{phase}]: fine={avg:.6f} window={cur.current_frame}"
                   + (f" trans={['%.4f' % t for t in trans_err]}"
                      f" rot={['%.4f' % r for r in rot_err]}" if trans_err is not None else "")
                   + (f" score={row['score']:.3e}" if "score" in row else ""))

            if (epoch + 1) % cfg.epoch_val == 0:
                _validate(ws, cfg, params, star_cfg, val_data, gt_rel, cur, step, dev, group)
                ws.save_checkpoint(ws.ckpt_dir, _state(epoch), step=epoch)
                if best["params"] is not None and best["epoch"] > best_saved:
                    ws.save_checkpoint(ws.ckpt_dir + "_best", {"params": best["params"]},
                                       step=best["epoch"])
                    best_saved = best["epoch"]
                if bbest["params"] is not None and bbest["epoch"] > bbest_saved:
                    ws.save_checkpoint(ws.ckpt_dir + "_bbound", {"params": bbest["params"]},
                                       step=bbest["epoch"])
                    bbest_saved = bbest["epoch"]
                ws.write_json("history.json", history)

            if (cfg.target_pose_err > 0 and cur.done and trans_err is not None
                    and max(trans_err) < cfg.target_pose_err
                    and max(rot_err) < cfg.target_pose_err):
                stop_reason = f"pose target {cfg.target_pose_err} reached"
                break
            if (cfg.selection_patience > 0 and cur.done and in_polish and sel_enabled
                    and best["epoch"] >= 0 and epoch - best["epoch"] >= cfg.selection_patience):
                stop_reason = (f"selection patience (best epoch {best['epoch']}, "
                               f"score {best['score']:.3e})")
                break
            if cur.done and cfg.polish_epochs <= 0:
                stop_reason = "all frames admitted"
                break
    finally:
        if prefetcher is not None:
            prefetcher.close()

    if stop_reason:
        ws.log(f"training stopped: {stop_reason}")

    ab = _active_best()
    if ab["params"] is not None and ab["epoch"] >= 0:
        # keep the best-selected epoch if the final one is not it
        final_score = ab["score"] + 1.0
        if history and "score" in history[-1]:
            final_score = history[-1]["score"]
        if ab["score"] < final_score:
            which = "boundary" if ab is bbest else "every-epoch"
            ws.log(f"restoring {which} best-epoch {ab['epoch']} snapshot "
                   f"(score {ab['score']:.3e}, {cfg.selection}"
                   + (f", {n_boundary} boundaries" if ab is bbest else "") + ")")
            ckpt.copy_into(params, ab["params"])
        ws.save_checkpoint(ws.ckpt_dir + "_best", {"params": ab["params"]}, step=ab["epoch"])

    ws.save_checkpoint(ws.ckpt_dir, _state(cfg.epochs_online), step=cfg.epochs_online)
    ws.write_json("history.json", history)
    return params


def _validate(ws, cfg, params, star_cfg, val_data, gt_rel, cur, step, device, group=None):
    """Render the first val view at the newest admitted frame (a fixed
    view and frame, so that val PSNR compares across epochs); log its PSNR
    and SSIM, the pose errors and the rendered images."""
    frame = min(cur.current_frame, cfg.num_frames) - 1
    view = 0
    rays_o, rays_d = val_data.view_rays(view)
    target = val_data.images[view, frame]

    pose = loop.gather_frame_pose(params["poses"].detach(), frame, star_cfg.num_vehicles)
    out = render_image(params["nerf"], star_cfg, rays_o, rays_d, pose=pose, device=device,
                       group=group)
    rgb, tgt = torch.from_numpy(out["rgb"]), torch.tensor(np.asarray(target))
    p = float(psnr_fn(rgb, tgt))
    s = float(ssim_fn(rgb, tgt))

    logs = {"val/psnr": p, "val/ssim": s}
    if gt_rel is not None:
        est = params["poses"].detach().cpu().numpy()  # [F-1, K, 7]
        trans_err, rot_err, *_ = pose_mod.get_pose_metrics_multi(est, gt_rel[1:])
        logs.update({f"val/trans_error_{k}": float(v) for k, v in enumerate(trans_err)})
        logs.update({f"val/rot_error_{k}": float(v) for k, v in enumerate(rot_err)})
        ws.log(f"val: psnr={p:.2f} ssim={s:.4f} trans_err={[f'{t:.4f}' for t in trans_err]}")
    else:
        ws.log(f"val: psnr={p:.2f} ssim={s:.4f}")
    ws.metrics.log(logs, step)
    ws.metrics.log_image("val/rgb", out["rgb"], step)
    ws.metrics.log_image("val/rgb_static", out["rgb_static"], step)
    for k in range(star_cfg.num_vehicles):
        ws.metrics.log_image(f"val/rgb_dynamic_{k}", out["rgb_dynamic"][:, :, k], step)


def test(cfg: Config, device=None):
    """The test protocol (apps/test_protocol.run_test_protocol) on the
    checkpoint at online_ckpt_path: pose export, RPE/ATE, the masked
    metric suite and the IoUs, rendered with the test outputs. device=None
    is the card; over a ray group (make_run_mesh) each render splits its
    tiles over the ranks and rank 0 writes."""
    check_supported(cfg)
    group = make_run_mesh(cfg, device)
    dev = resolve(device) if group is None else group.device
    ws = Workspace(cfg, "online_test", group)
    if group is not None:
        ws.log(f"eval tiles split over {group.world} ranks ({group.backend})")
    star_cfg = star_config_from(cfg)
    test_data = make_dataset(cfg, "test", dev)

    _, gen = host_prng(cfg.seed, dev)
    params = loop.init_online_params(star_cfg, cfg.num_frames, gen, dev)
    restored = ckpt.restore_checkpoint(cfg.online_ckpt_path, device=dev)
    ckpt.copy_into(params, restored["params"] if "params" in restored else restored)

    def render_frame(pose, rays_o, rays_d):
        return render_image(params["nerf"], star_cfg, rays_o, rays_d, pose=pose.to(dev),
                            with_test_outputs=True, device=dev, group=group)

    run_test_protocol(ws, cfg, star_cfg.num_vehicles, params["poses"].detach().cpu().numpy(),
                      test_data, render_frame)


def main(argv=None):
    cfg = load_config(argv)
    if cfg.test:
        return test(cfg)
    return train(cfg)


if __name__ == "__main__":
    main()
