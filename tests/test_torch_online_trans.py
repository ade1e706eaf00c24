"""The port's online app with pose_trans_only = true against startrax's, on
the CPU (carla_star_online_trans.txt's recipe: translations only).

Both apps run a short phase machine (tests/test_torch_online.py's scene,
tree, batches and draws: one numpy init, one prefetch worker, the JAX
app's uniforms fed to every port step): the field-forming warmup, BARF,
the curriculum's joint epochs and one alternate polish epoch, 3 steps an
epoch. Every pose-updating step builder gets trans_only, so from the first
of those steps on each quaternion is the identity, exactly, through every
later phase (the field phases' renormalisation keeps it), in both apps.
The epoch losses are held within tests/test_torch_online.py's tolerances:
the warmup's fine losses 8e-5 relative, the later ones 4e-2 relative, the
translation errors 1.4e-3 absolute.
"""

import numpy as np

from startrax.apps import online as japp
from startrax_torch.apps import online as tapp
from test_torch_online import (_close, _configs, _fresh_scene_memo,  # noqa: F401
                               _history, _jax_epochs, _one_torch_thread, _shared_init,
                               _uniform_feed)

TRANS = dict(epochs_online=5, steps_per_epoch=3, pose_delay_epochs=1, end_barf=2,
             barf_freeze_rot=True, polish_epochs=1, polish_mode="alternate",
             alt_field_epochs=1, alt_pose_epochs=1, ghost_sample_ratio=0.1,
             frame0_sample_ratio=0.1, epoch_val=5, pose_trans_only=True)
IDENTITY = np.array([0.0, 0.0, 0.0, 1.0], np.float32)


def test_online_app_with_pose_trans_only_matches_startrax(tmp_path, monkeypatch):
    jcfg, tcfg = _configs(tmp_path, **TRANS)
    _shared_init(monkeypatch, jcfg)
    fed = _uniform_feed(monkeypatch, jcfg.seed)
    jepochs = _jax_epochs(monkeypatch)
    japp.train(jcfg)
    tapp.train(tcfg, device="cpu")

    jh, th = (_history(str(tmp_path / p / "smoke" / "online")) for p in ("jax", "torch"))
    phases = [h["phase"] for h in th]
    assert phases == [h["phase"] for h in jh]
    assert phases[:2] == ["fieldform", "barf"] and "joint" in phases
    assert fed["steps"] == len(phases) * TRANS["steps_per_epoch"]
    _close([h["fine"] for h in th[:2]], [h["fine"] for h in jh[:2]], rtol=8e-5, what="fine")
    _close([h["fine"] for h in th[2:]], [h["fine"] for h in jh[2:]], rtol=4e-2, what="fine")
    _close([h["trans"] for h in th], [h["trans"] for h in jh], atol=1.4e-3, what="trans")
    # the rotations: pinned from BARF's first step (the first trans_only
    # step) to the end, in every phase, in both apps
    for epochs in (fed["epochs"], jepochs):
        for h in th[1:]:
            before, after = epochs[h["epoch"]]
            q = after["poses"][..., 3:]
            assert np.array_equal(q, np.broadcast_to(IDENTITY, q.shape)), h["phase"]
            if h["phase"] != "barf":
                assert np.array_equal(before["poses"][..., 3:], q), h["phase"]
        assert np.abs(epochs[1][1]["poses"][..., :3] - epochs[1][0]["poses"][..., :3]).max() > 0
