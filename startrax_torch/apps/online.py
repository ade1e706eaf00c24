"""Online tracking: jointly optimise the radiance fields and the per-frame
SE(3) vehicle poses by photometric self-supervision, admitting frames
through the curriculum (PyTorch).

Counterpart of startrax/apps/online.py on one device, for the recipe of
startrax/configs/synthetic_star_online.txt:

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
  ghost and frame-0 anchor rays in the field phases;
- GT-free best-epoch selection on the held-out view (``photometric``,
  ``photometric_depth``) or the GT-pose oracle (``gt_pose``);
- validation and checkpoints every ``epoch_val`` epochs (every optimizer's
  state, the curriculum and the polish sub-state), resume from one
  (``online_ckpt_path``), and the stop rules.

The parameters are leaf tensors that every optimizer (a FusedGroupAdam per
phase kind, all over the same leaves) updates in place; a restore copies
into them (train.checkpoint.copy_into) and never rebinds them. The gauge
alignment and refit polishes, multi-start and boundary-only selection
(startrax's scaled and depth recipes), ray-axis data parallelism, LPIPS and
the video export are not ported and raise NotImplementedError.

Usage:
  python -m startrax_torch.apps.online --config startrax/configs/synthetic_star_online.txt
  python -m startrax_torch.apps.online --config ... --test true --online_ckpt_path <run>/ckpts
"""

from __future__ import annotations

import dataclasses
import json
import os
import time

import numpy as np
import torch

from ..data.prefetch import BatchPrefetcher
from ..device import resolve
from ..eval import pose as pose_mod
from ..eval.image import psnr as psnr_fn
from ..eval.image import ssim as ssim_fn
from ..eval.render import render_image
from ..train import checkpoint as ckpt
from ..train import loop, optim
from ..train.curriculum import CurriculumConfig, CurriculumState, advance
from ..utils.config import Config, load_config, loss_config_from, star_config_from
from ..utils.tree import tree_map
from .common import Workspace, check_one_device, host_prng, make_dataset
from .test_protocol import check_supported, run_test_protocol

POLISH_MODES = ("alternate", "interleave")
_NOT_PORTED = "ROADMAP queue 1, item 4b"


def check_supported_train(cfg: Config) -> None:
    """Raise for what the port's online app does not run: ray-axis data
    parallelism, the polishes, multi-start and selection rule of startrax's
    scaled and depth recipes, and an unknown polish_mode."""
    check_one_device(cfg)
    if cfg.polish_epochs > 0 and cfg.polish_mode in ("gauge_align", "refit_anchor"):
        raise NotImplementedError(f"polish_mode = {cfg.polish_mode} is not ported yet "
                                  f"({_NOT_PORTED})")
    if cfg.polish_epochs > 0 and cfg.polish_mode not in POLISH_MODES:
        raise ValueError(f"polish_mode must be alternate, interleave, gauge_align or "
                         f"refit_anchor, got {cfg.polish_mode}")
    if cfg.multi_start_rounds > 0:
        raise NotImplementedError(f"multi_start_rounds > 0 is not ported yet ({_NOT_PORTED})")
    if cfg.selection_boundary_only:
        raise NotImplementedError(f"selection_boundary_only is not ported yet ({_NOT_PORTED})")


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


def _place_batch(batch, device):
    """A sampled batch on the device. A shared-pose batch's frame stays a
    Python int, so that its dynamic fields take the per-field kernels with
    the in-kernel warp; a per-ray batch's [N] frames become a tensor."""
    out = {}
    for k, v in batch.items():
        if k == "frame" and np.ndim(v) == 0:
            out[k] = int(v)
        else:
            out[k] = torch.as_tensor(v, device=device)
    return out


# polish sub-state <-> checkpoint encoding (phases as ints, as startrax
# stores them), for the alternate and interleave polishes
_ALT_PHASES = ("field", "pose")


def _polish_template():
    return {"polish_used": 0, "alt_phase": 0, "alt_rounds": 0, "best_score": 0.0,
            "best_epoch": -1}


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


def selection_score(cfg: Config, star_cfg, params, val_data, num_frames: int, view: int = 0,
                    start_frame: int = 0, device=None) -> float:
    """GT-free best-epoch criterion: the mean MSE of a held-out val view
    rendered at every scored frame with the learned poses (frame 0 =
    identity); lower is better. selection = "photometric_depth" adds
    selection_depth_lambda times the relative-squared depth error when the
    dataset carries depth maps. selection_frames / selection_stride
    subsample the scored frames / pixels. device=None is the card."""
    device = resolve(device)
    s = max(cfg.selection_stride, 1)
    rays_o, rays_d = val_data.view_rays(view)
    rays_o, rays_d = rays_o[::s, ::s], rays_d[::s, ::s]
    use_depth = (cfg.selection == "photometric_depth"
                 and getattr(val_data, "depths", None) is not None)
    # N_importance = 0 renders give only the "0"-suffixed (coarse) outputs
    suff = "" if star_cfg.n_importance > 0 else "0"
    keys = ("rgb" + suff, "depth" + suff) if use_depth else ("rgb" + suff,)
    poses = params["poses"].detach()
    total, count = 0.0, 0
    for f in _score_frames(cfg, start_frame, num_frames):
        pose = loop.gather_frame_pose(poses, f, star_cfg.num_vehicles)
        out = render_image(params["nerf"], star_cfg, rays_o, rays_d, pose=pose, keys=keys,
                           device=device)
        target = np.asarray(val_data.images[view, f], np.float32)[::s, ::s]
        score = float(np.mean((out["rgb" + suff] - target) ** 2))
        if use_depth:
            gt_d = np.asarray(val_data.depths[view, f], np.float32)[::s, ::s]
            score += cfg.selection_depth_lambda * _depth_mse(
                out["depth" + suff], gt_d, star_cfg.near, star_cfg.far)
        total += score
        count += 1
    return total / max(count, 1)


def train(cfg: Config, device=None):
    """Run online training; returns the parameters (leaf tensors on
    ``device``, None: the card, device.resolve)."""
    dev = resolve(device)
    check_supported_train(cfg)
    ws = Workspace(cfg, "online")
    # the main (post-warmup) steps run at full frequency; a BARF-masked
    # variant serves the warmup epochs only
    star_cfg = dataclasses.replace(star_config_from(cfg), end_barf=-1)
    star_cfg_barf = (dataclasses.replace(star_cfg, end_barf=cfg.end_barf)
                     if cfg.end_barf > 0 else star_cfg)
    loss_cfg = loss_config_from(cfg)

    train_data = make_dataset(cfg, "train", dev)
    val_data = make_dataset(cfg, "val", dev)
    has_gt = hasattr(train_data, "gt_relative_poses")
    gt_rel = (np.swapaxes(train_data.gt_relative_poses(), 0, 1)
              if has_gt else None)  # [F, K, 7]

    rng, gen = host_prng(cfg.seed, dev)
    params = _init_params(cfg, star_cfg, gen, dev, train_data, rng)

    pose_lr = 0.0 if cfg.load_gt_poses else cfg.lrate_pose
    opt_kw = dict(steps_per_epoch=cfg.steps_per_epoch, grad_clip=1.0,
                  accumulate_steps=cfg.accumulate_grad_batches)
    nerf_decay = dict(decay_rate=cfg.lrate_decay_rate, decay_epochs=cfg.lrate_decay,
                      decay_milestones=cfg.lrate_decay_steps)
    pose_decay = dict(pose_decay_rate=cfg.pose_lrate_decay_rate,
                      pose_decay_epochs=cfg.pose_lrate_decay,
                      pose_decay_milestones=cfg.pose_lrate_decay_steps)

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
    # alternation's field phases share one optimizer
    opt_field = None
    if cfg.pose_delay_epochs > 0 or (cfg.polish_epochs > 0 and cfg.polish_mode == "alternate"):
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
    # fresh moments
    opt_polish = None
    if cfg.polish_epochs > 0 and not cfg.load_gt_poses:
        opt_polish = optim.make_fused_star_optimizer(
            params, lrate_static=0.0, lrate_dynamic=0.0, lrate_pose=pose_lr,
            pose_decay_rate=cfg.polish_pose_lrate_decay_rate,
            pose_decay_epochs=cfg.polish_pose_lrate_decay, **opt_kw)
        step_fn_polish = loop.make_online_train_step(star_cfg, loss_cfg, opt_polish,
                                                     trans_only=cfg.pose_trans_only)
    extra_opts = (("opt_state_pose", opt_pose), ("opt_state_polish", opt_polish),
                  ("opt_state_field", opt_field))

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
    # transition is accepted by design.
    sample_state = {"start": cur.start_frame, "end": min(cur.current_frame, cfg.num_frames),
                    "car": cfg.car_sample_ratio, "crop": False,
                    "ghost": cfg.ghost_sample_ratio, "f0": cfg.frame0_sample_ratio,
                    "mixed": cfg.mixed_frames}
    prefetcher = BatchPrefetcher(
        lambda r, st: train_data.sample_batch(
            r, cfg.N_rand, start_frame=st["start"], current_frame=st["end"],
            car_sample_ratio=st["car"], crop=st["crop"], mixed_frames=st["mixed"],
            ghost_sample_ratio=st["ghost"], frame0_sample_ratio=st["f0"]),
        sample_state, seed=cfg.seed * 7919 + 1, depth=6, workers=max(cfg.num_workers, 1))

    car_pose = (cfg.car_sample_ratio_pose if cfg.car_sample_ratio_pose >= 0
                else cfg.car_sample_ratio)
    deadline = time.time() + cfg.train_minutes * 60 if cfg.train_minutes > 0 else None
    sel_enabled = cfg.selection != "none" and (cfg.selection != "gt_pose" or has_gt)
    best = {"score": float("inf"), "epoch": -1, "params": None}
    best_saved = -1
    history = []
    # alternation sub-state (polish_mode = "alternate")
    alt_phase, alt_losses, alt_rounds = "field", [], 0
    polish_used = 0
    step = 0
    stop_reason = ""

    if resume_polish is not None:
        pd = {**_polish_template(), **resume_polish}
        polish_used = int(pd["polish_used"])
        alt_phase = _ALT_PHASES[int(pd["alt_phase"])]
        alt_rounds = int(pd["alt_rounds"])
        if int(pd["best_epoch"]) >= 0:
            best.update(score=float(pd["best_score"]), epoch=int(pd["best_epoch"]))
            try:
                b = ckpt.restore_checkpoint(cfg.online_ckpt_path + "_best", device=dev)
                best["params"] = b["params"]
                ws.log(f"restored best-epoch snapshot (epoch {best['epoch']}, "
                       f"score {best['score']:.3e})")
            except FileNotFoundError:
                best.update(score=float("inf"), epoch=-1)
        ws.log(f"resumed polish sub-state: used={polish_used} alt={alt_phase}/{alt_rounds}")

    def _polish_state():
        state = _polish_template()
        state.update(polish_used=polish_used, alt_phase=_ALT_PHASES.index(alt_phase),
                     alt_rounds=alt_rounds,
                     best_score=best["score"] if best["epoch"] >= 0 else 0.0,
                     best_epoch=best["epoch"])
        return state

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

    def run_phase_epoch(fn, epoch, car, ghost, f0):
        nonlocal step
        sample_state.update(
            start=cur.start_frame, end=min(cur.current_frame, cfg.num_frames),
            crop=epoch < cfg.precrop_iters, car=car, ghost=ghost, f0=f0,
            mixed=cfg.mixed_frames)
        fines = []
        aux_losses.clear()
        for _ in range(cfg.steps_per_epoch):
            batch = _place_batch(next(prefetcher), dev)
            _, metrics = fn(params, batch, epoch=epoch, generator=gen)
            step += 1
            fines.append(metrics["fine_loss"])  # device scalar, no sync
            for k in ("depth_loss", "sigma_loss"):
                if k in metrics:
                    aux_losses.setdefault(k, []).append(metrics[k])
        return float(torch.stack(fines).mean())  # one device read an epoch

    try:
        for epoch in range(start_epoch, cfg.epochs_online):
            if deadline is not None and time.time() > deadline:
                stop_reason = "train_minutes budget"
                break
            aux_losses.clear()

            in_fieldform = epoch < cfg.pose_delay_epochs and opt_field is not None
            in_barf = not in_fieldform and cfg.end_barf > 0 and epoch < cfg.end_barf
            in_polish = cur.done and cfg.polish_epochs > 0 and not cfg.load_gt_poses
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
                if cfg.polish_mode == "alternate":
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
                                            device=dev)
                row["score"] = round(score, 8)
                logs["train/selection_score"] = score
                if score < best["score"]:
                    best.update(score=score, epoch=epoch,
                                params=tree_map(lambda t: t.detach().clone(), params))

            history.append(row)
            ws.metrics.log(logs, step)
            ws.log(f"epoch {epoch} [{phase}]: fine={avg:.6f} window={cur.current_frame}"
                   + (f" trans={['%.4f' % t for t in trans_err]}"
                      f" rot={['%.4f' % r for r in rot_err]}" if trans_err is not None else "")
                   + (f" score={row['score']:.3e}" if "score" in row else ""))

            if (epoch + 1) % cfg.epoch_val == 0:
                _validate(ws, cfg, params, star_cfg, val_data, gt_rel, cur, step, dev)
                ckpt.save_checkpoint(ws.ckpt_dir, _state(epoch), step=epoch)
                if best["params"] is not None and best["epoch"] > best_saved:
                    ckpt.save_checkpoint(ws.ckpt_dir + "_best", {"params": best["params"]},
                                         step=best["epoch"])
                    best_saved = best["epoch"]
                with open(os.path.join(ws.run_dir, "history.json"), "w") as f:
                    json.dump(history, f)

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
        prefetcher.close()

    if stop_reason:
        ws.log(f"training stopped: {stop_reason}")

    if best["params"] is not None and best["epoch"] >= 0:
        # keep the best-selected epoch if the final one is not it
        final_score = best["score"] + 1.0
        if history and "score" in history[-1]:
            final_score = history[-1]["score"]
        if best["score"] < final_score:
            ws.log(f"restoring every-epoch best-epoch {best['epoch']} snapshot "
                   f"(score {best['score']:.3e}, {cfg.selection})")
            ckpt.copy_into(params, best["params"])
        ckpt.save_checkpoint(ws.ckpt_dir + "_best", {"params": best["params"]},
                             step=best["epoch"])

    ckpt.save_checkpoint(ws.ckpt_dir, _state(cfg.epochs_online), step=cfg.epochs_online)
    with open(os.path.join(ws.run_dir, "history.json"), "w") as f:
        json.dump(history, f)
    return params


def _validate(ws, cfg, params, star_cfg, val_data, gt_rel, cur, step, device):
    """Render the first val view at the newest admitted frame (a fixed
    view and frame, so that val PSNR compares across epochs); log its PSNR
    and SSIM, the pose errors and the rendered images."""
    frame = min(cur.current_frame, cfg.num_frames) - 1
    view = 0
    rays_o, rays_d = val_data.view_rays(view)
    target = val_data.images[view, frame]

    pose = loop.gather_frame_pose(params["poses"].detach(), frame, star_cfg.num_vehicles)
    out = render_image(params["nerf"], star_cfg, rays_o, rays_d, pose=pose, device=device)
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
    is the card."""
    dev = resolve(device)
    check_supported(cfg)
    check_one_device(cfg)
    ws = Workspace(cfg, "online_test")
    star_cfg = star_config_from(cfg)
    test_data = make_dataset(cfg, "test", dev)

    _, gen = host_prng(cfg.seed, dev)
    params = loop.init_online_params(star_cfg, cfg.num_frames, gen, dev)
    restored = ckpt.restore_checkpoint(cfg.online_ckpt_path, device=dev)
    ckpt.copy_into(params, restored["params"] if "params" in restored else restored)

    def render_frame(pose, rays_o, rays_d):
        return render_image(params["nerf"], star_cfg, rays_o, rays_d, pose=pose.to(dev),
                            with_test_outputs=True, device=dev)

    run_test_protocol(ws, cfg, star_cfg.num_vehicles, params["poses"].detach().cpu().numpy(),
                      test_data, render_frame)


def main(argv=None):
    cfg = load_config(argv)
    if cfg.test:
        return test(cfg)
    return train(cfg)


if __name__ == "__main__":
    main()
