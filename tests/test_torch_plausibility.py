"""The port's trajectory scoring and optimization against emloco_tpu, the
valuenet checkpoint in both directions, and the two LocoVal entry points
on the CPU.

Scores, rankings and 20 Adam steps of `optimize_trajectory` (with and
without the pinned origin) from the same parameters and trajectories
within 1e-5 absolute (values in [0, 1], coordinates of a few metres, float32
work in the same order); a JAX checkpoint loaded by the port scores as JAX
does, and a port checkpoint loaded and applied by JAX scores as the port
does, within 1e-6.

`test_optimize_on_card_matches_cpu` (marked requires_cuda) holds the
optimization on the card against the CPU; it needs neither jax nor the JAX
package.
"""
import json

import numpy as np
import pytest
import torch

try:
    import jax
    from emloco_tpu.analysis import plausibility as jpl
    from emloco_tpu.learning.networks import ValuePoseNet as JValuePoseNet
    from emloco_tpu.utils import checkpoint as jckpt
except ModuleNotFoundError:      # only the card test can run without jax
    jax = None
from emloco_tpu_torch import convert, optimize_traj, train_value
from emloco_tpu_torch.analysis import plausibility as pl
from emloco_tpu_torch.learning import ValuePoseNet
from emloco_tpu_torch.utils import checkpoint as ckpt

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

TOL, CKPT_TOL = 1e-5, 1e-6
B, W, STEPS = 16, 13, 20


def np_tree(x):
    return jax.tree.map(np.asarray, x)


def t_(a):
    return torch.as_tensor(np.array(a))


def inputs(seed, batch=B):
    """Smooth walks from the origin, a zero initial pose and the first
    segment's velocity, as the optimize-traj command builds them."""
    rng = np.random.default_rng(seed)
    heading = np.cumsum(rng.normal(0.0, 0.2, (batch, W)), 1)
    step = rng.uniform(0.2, 0.8, (batch, 1))
    d = np.stack([np.cos(heading), np.sin(heading)], -1) * step[..., None]
    d[:, 0] = 0.0
    wp = np.cumsum(d, 1).astype(np.float32)
    pose = np.zeros((batch, 24, 3), np.float32)
    vel = ((wp[:, 1] - wp[:, 0]) / 0.4).astype(np.float32)
    return wp, pose, vel


def nets(seed=0, **kw):
    """The JAX net and params, and the port's net and state_dict from
    them."""
    jnet = JValuePoseNet(**kw)
    jp = jnet.init(jax.random.PRNGKey(seed), *inputs(0, 1))
    vnet = ValuePoseNet(**kw, device="cpu")
    return jnet, jp, vnet, convert.valuenet_state_dict(np_tree(jp))


def test_score_and_rank_match_jax():
    jnet, jp, vnet, params = nets()
    wp, pose, vel = inputs(1)
    want = np.asarray(jpl.score_trajectories(jnet, jp, wp, pose, vel))
    with torch.no_grad():
        got = pl.score_trajectories(vnet, params, t_(wp), t_(pose), t_(vel))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL)
    order, v = pl.rank_trajectories(vnet, params, t_(wp), t_(pose), t_(vel))
    jorder, jv = jpl.rank_trajectories(jnet, jp, wp, pose, vel)
    np.testing.assert_allclose(v, jv, rtol=0, atol=TOL)
    assert sorted(order.tolist()) == list(range(B))
    assert (np.diff(v[order]) <= 0).all()
    np.testing.assert_array_equal(order, jorder)


@pytest.mark.parametrize("freeze_first", [True, False])
def test_optimize_trajectory_matches_jax(freeze_first):
    jnet, jp, vnet, params = nets(seed=2)
    wp, pose, vel = inputs(3)
    jtraj, jvals, jsnaps = jpl.optimize_trajectory(
        jnet, jp, wp, pose, vel, steps=STEPS, freeze_first=freeze_first,
        record_trajs=True)
    traj, vals, snaps = pl.optimize_trajectory(
        vnet, params, t_(wp), t_(pose), t_(vel), steps=STEPS,
        freeze_first=freeze_first, record_trajs=True)
    assert vals.shape == (STEPS + 1, B)
    assert snaps.shape == (STEPS + 1, B, W, 2)
    np.testing.assert_allclose(vals.numpy(), np.asarray(jvals), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(snaps.numpy(), np.asarray(jsnaps), rtol=0,
                               atol=TOL)
    np.testing.assert_allclose(traj.numpy(), np.asarray(jtraj), rtol=0,
                               atol=TOL)
    assert torch.equal(snaps[-1], traj) and torch.equal(snaps[0], t_(wp))
    assert float(vals[-1].mean()) > float(vals[0].mean())
    if freeze_first:
        assert torch.equal(traj[:, 0], t_(wp)[:, 0])
    else:
        assert not torch.equal(traj[:, 0], t_(wp)[:, 0])
    out, vals2 = pl.optimize_trajectory(vnet, params, t_(wp), t_(pose),
                                        t_(vel), steps=STEPS,
                                        freeze_first=freeze_first)
    assert torch.equal(out, traj) and torch.equal(vals2, vals)


def test_sample_candidate_trajs():
    gen = torch.Generator().manual_seed(0)
    trajs = pl.sample_candidate_trajs(gen, 8)
    assert trajs.shape == (8, 13, 2)
    assert not trajs[:, 0].any()
    assert bool(torch.isfinite(trajs).all()) and trajs[:, 1:].abs().max() > 0
    again = pl.sample_candidate_trajs(torch.Generator().manual_seed(0), 8,
                                      num_waypoints=5)
    assert again.shape == (8, 5, 2)


def test_jax_checkpoint_loads_in_the_port(tmp_path):
    """JAX save_valuenet → the port's load_pytree and convert: the same
    scores and metadata."""
    jnet, jp, _, _ = nets(seed=4, use_vel=False)
    path = str(tmp_path / "valuenet_00000003.ckpt")
    jckpt.save_valuenet(path, jp, dict(use_pose=True, use_vel=False))
    tree, meta = ckpt.load_pytree(path)
    assert meta == {"kind": "valuenet",
                    "config": {"use_pose": True, "use_vel": False}}
    vnet = ValuePoseNet(use_vel=False, device="cpu")
    vnet.load_state_dict(convert.valuenet_state_dict(tree))
    wp, pose, vel = inputs(5)
    with torch.no_grad():
        got = vnet(t_(wp), t_(pose), None).numpy()
    np.testing.assert_allclose(got, np.asarray(jnet.apply(jp, wp, pose)),
                               rtol=0, atol=CKPT_TOL)
    assert ckpt.latest_checkpoint(str(tmp_path)) == path
    assert ckpt.latest_checkpoint(str(tmp_path / "none")) is None


def test_port_checkpoint_loads_in_jax(tmp_path):
    """The port's save_valuenet → JAX load_pytree and apply: the same
    values and metadata; the file holds numpy arrays in the flax layout."""
    vnet = ValuePoseNet(use_pose=False, generator=torch.Generator()
                        .manual_seed(1), device="cpu")
    path = str(tmp_path / "valuenet_00000000.ckpt")
    ckpt.save_valuenet(path, vnet.state_dict(),
                       dict(use_pose=False, use_vel=True))
    ckpt.save_valuenet(str(tmp_path / "valuenet_00000012.ckpt"),
                       vnet.state_dict())
    tree, meta = jckpt.load_pytree(path)
    assert meta == {"kind": "valuenet",
                    "config": {"use_pose": False, "use_vel": True}}
    k = tree["params"]["fc1"]["kernel"]
    assert isinstance(k, np.ndarray) and k.shape == (28, 13)
    wp, pose, vel = inputs(6)
    want = np.asarray(JValuePoseNet(use_pose=False).apply(tree, wp, None,
                                                          vel))
    with torch.no_grad():
        got = vnet(t_(wp), None, t_(vel)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=CKPT_TOL)
    assert jckpt.latest_checkpoint(str(tmp_path)).endswith("_00000012.ckpt")


def test_entry_points_on_cpu(tmp_path, capsys, monkeypatch):
    """train_value for one epoch at 4 envs writes a checkpoint and
    evaluates; optimize_traj reads it: one JSON line each, the origin
    pinned; and no card is taken without one unless the CPU is asked for."""
    out = str(tmp_path / "vn")
    small = ["amp.amp_replay_size=8", "env.sensor_res=8",
             "env.num_amp_obs_steps=3"]
    vts = train_value.main(["--epochs", "1", "--num-envs", "4", "--device",
                            "cpu", "--out", out, "--games", "1", "--novel",
                            *small])
    lines = capsys.readouterr().out.strip().splitlines()
    epoch, evaluation = (json.loads(ln) for ln in lines[-2:])
    assert epoch["epoch"] == 1 and "vnet_loss" in epoch
    assert epoch["device"] == "cpu" and epoch["env_steps_per_s"] > 0
    assert evaluation["games"] == 1 and "mse" in evaluation
    assert vts.epoch == 1 and int(vts.vnet_opt.count) == 1
    path = ckpt.latest_checkpoint(out)
    assert path.endswith("valuenet_00000000.ckpt")
    tree, meta = ckpt.load_pytree(path)
    assert meta["config"] == {"use_pose": True, "use_vel": False}
    res = optimize_traj.main(["--valuenet", path, "--batch-size", "8",
                              "--steps", "5", "--device", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(line) >= {"value_before", "value_after", "seconds"}
    assert res["values"].shape == (6, 8)
    assert torch.equal(res["traj"][:, 0], res["traj0"][:, 0])
    assert line["value_after"] == pytest.approx(
        float(res["values"][-1].mean()))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        optimize_traj.main(["--valuenet", path])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_value.main(["--num-envs", "4", *small])


@pytest.mark.requires_cuda
def test_optimize_on_card_matches_cpu():
    """20 steps of optimize_trajectory on 64 trajectories on the card
    against the CPU, within 1e-4 (the smoke's tolerance)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.fp32_precision = "ieee"
    vnet = ValuePoseNet(generator=torch.Generator().manual_seed(3),
                        device="cpu")
    params = {k: v.detach().clone() for k, v in vnet.named_parameters()}
    wp, pose, vel = inputs(7, 64)
    runs = []
    for dev in ("cpu", "cuda"):
        vnet.to(dev)
        traj, vals = pl.optimize_trajectory(
            vnet, {k: v.to(dev) for k, v in params.items()},
            t_(wp).to(dev), t_(pose).to(dev), t_(vel).to(dev), steps=20)
        runs.append((traj.cpu(), vals.cpu()))
    vnet.to("cpu")
    (tc, vc), (tg, vg) = runs
    torch.testing.assert_close(tg, tc, rtol=0, atol=1e-4)
    torch.testing.assert_close(vg, vc, rtol=0, atol=1e-4)
    assert torch.equal(tg[:, 0], t_(wp)[:, 0])
