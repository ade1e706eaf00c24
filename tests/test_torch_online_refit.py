"""The port's refit_anchor polish against startrax's, on the CPU.

Both apps run as in tests/test_torch_online_polish.py (COMMON: the 24x24
scene, one tree, one scene cache, the JAX app's uniforms and field draws,
no warmup) with refit_anchor: refit_epochs 1 on window (0, 2),
refit_pose_epochs 1 with rotations frozen, then two alternation rounds.
The port is re-seeded from the JAX app's params after the last joint
epoch, so that the refit starts from one tree in both apps.
"""

import numpy as np

from test_torch_online import _close, _fresh_scene_memo, _one_torch_thread  # noqa: F401
from test_torch_online_gauge import logged, run_both
from test_torch_online_polish import COMMON, _equal_trees

REFIT = dict(COMMON, epochs_online=12, polish_epochs=6, polish_mode="refit_anchor",
             refit_epochs=1, refit_pose_epochs=1, refit_window=2, refit_pose_freeze_rot=True,
             selection="photometric")
REFIT_PHASES = ["joint", "joint", "refit_field", "refit_pose", "polish_field", "polish_pose",
                "polish_field", "polish_pose"]


def test_refit_anchor_matches_startrax(tmp_path, monkeypatch):
    """REFIT. Measured: fine losses to 1.3e-3 relative, selection scores to
    3.2e-4, translation and rotation errors to 9e-5 and 1.5e-4, the final
    poses (the best epoch's) equal. Tolerances, ten times those: 1.3e-2,
    3.2e-3, 9e-4 and 1.5e-3, and 1e-6 for the final poses. The phases are
    equal. In both apps: the refit starts from one tree (the live static
    fields and poses, the fresh dynamic fields drawn from the app's key)
    and trains the dynamic fields only (the quaternions move by their
    renormalisation's rounding, < 1.2e-7, as tests/test_torch_online.py
    bounds it); the pose recovery trains the translations only
    (refit_pose_freeze_rot) and no field."""
    at = REFIT_PHASES.index("refit_field")
    _, (jdir, tdir), (jh, th), fed, jepochs, _, (jout, tout) = run_both(
        tmp_path, monkeypatch, REFIT, reseed_after=[at - 1])

    assert [h["phase"] for h in th] == [h["phase"] for h in jh] == REFIT_PHASES
    assert [h["window"] for h in th] == [h["window"] for h in jh]
    _close([h["fine"] for h in th], [h["fine"] for h in jh], rtol=1.3e-2, what="fine")
    for k, atol in (("trans", 9e-4), ("rot", 1.5e-3)):
        _close([h[k] for h in th], [h[k] for h in jh], atol=atol, what=k)
    _close([h["score"] for h in th if "score" in h], [h["score"] for h in jh if "score" in h],
           rtol=3.2e-3, what="score")
    _close(tout["poses"], jout["poses"], atol=1e-6, what="final poses")
    for d in (tdir, jdir):
        assert logged(d, r"refit_anchor: (.*)") == [
            "dynamic fields re-initialized, fitting from frame 0",
            "pose recovery done -> alternate"]

    assert _equal_trees(fed["epochs"][at][0], jepochs[at][0])
    for epochs in (fed["epochs"], jepochs):
        (b0, a0), (b1, a1) = epochs[at], epochs[at + 1]
        # the field steps renormalise the quaternions: their rounding only
        assert np.array_equal(b0["poses"][..., :3], a0["poses"][..., :3])
        assert np.abs(b0["poses"][..., 3:] - a0["poses"][..., 3:]).max() < 1.2e-7
        for name in b0["nerf"]:
            assert _equal_trees(b0["nerf"][name], a0["nerf"][name]) == name.startswith("static")
        assert _equal_trees(b1["nerf"], a1["nerf"])
        assert np.array_equal(b1["poses"][..., 3:], a1["poses"][..., 3:])
        assert np.abs(a1["poses"][..., :3] - b1["poses"][..., :3]).max() > 1e-4
    # the refit's fields are fresh: not the live ones before it
    assert not _equal_trees(jepochs[at - 1][1]["nerf"]["dynamic_coarse"],
                            jepochs[at][0]["nerf"]["dynamic_coarse"])
