"""The port's trajectory input server and live viewer: HTTP round trips,
the in-place bank update against the JAX package's, and the viewer session
against hand-driven control steps of the port."""
import json
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from emloco_tpu.envs import traj_server as jts
from emloco_tpu_torch.envs import EnvConfig, PedestrianTerrainEnv
from emloco_tpu_torch.envs import traj_server as tts
from emloco_tpu_torch.envs import viewer_server as tvs
from emloco_tpu_torch.kinematics import motion_lib as tml
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
from emloco_tpu_torch.physics import EngineConfig, flat_terrain

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

SMALL = dict(num_envs=2, sensor_res=8, episode_length=12,
             num_amp_obs_steps=3, engine=EngineConfig(n_substeps=1))
AMP = dict(horizon=4, num_minibatches=2, mini_epochs=1, amp_batch_size=8,
           amp_replay_size=32)
PNG = b"\x89PNG\r\n\x1a\n"


def _post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=30) as r:
        return json.loads(r.read())


def _get(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        return r.read(), r.headers.get("Content-Type")


def test_traj_server_roundtrip():
    srv = tts.TrajInputServer(port=0, num_verts=101)
    try:
        base = f"http://127.0.0.1:{srv.port}"
        t13 = [[float(i) * 0.4, 0.0] for i in range(13)]
        t101 = [[0.0, float(i) * 0.05] for i in range(101)]
        assert _post(base + "/trajs", [t13, t101]) == {"accepted": 2}
        st = json.loads(_get(base + "/status")[0])
        assert st == {"pending": 2, "received_total": 2}
        trajs = srv.drain(max_items=1)
        assert trajs.shape == (1, 101, 2)
        np.testing.assert_allclose(trajs[0, -1], [4.8, 0.0], atol=1e-5)
        np.testing.assert_allclose(trajs[0, 50, 0], 2.4, atol=1e-4)
        assert srv.drain().shape == (1, 101, 2)
        assert srv.drain().shape == (0, 101, 2)
        for bad in ([[[0.0, 0.0, 0.0]]], [[[1.0, 2.0]]]):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/trajs", bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nowhere")
        assert e.value.code == 404
    finally:
        srv.close()


@pytest.mark.parametrize("start,k", [(2, 3), (0, 4), (3, 1), (1, 0)])
def test_update_traj_bank_matches_jax(start, k):
    rng = np.random.RandomState(start + k)
    bank = rng.randn(4, 101, 2).astype(np.float32)
    new = rng.randn(k, 101, 3).astype(np.float32)
    jbank, jnext = jts.update_traj_bank(jnp.asarray(bank), new, start)
    tbank = torch.as_tensor(bank)
    out, nxt = tts.update_traj_bank(tbank, new, start)
    assert out is tbank and nxt == jnext
    np.testing.assert_array_equal(tbank.numpy(), np.asarray(jbank))


@pytest.fixture(scope="module")
def agent():
    env = PedestrianTerrainEnv(
        EnvConfig(**SMALL), flat_terrain(extent=20.0, cell=0.1,
                                         device="cpu"),
        tml.synthetic_walk_motions(speeds=(1.0,), duration=1.5,
                                   device="cpu"), device="cpu")
    a = AMPAgent(env, AMPConfig(**AMP))
    return a, a.init(0)


def test_session_chunk_is_four_control_steps(agent):
    agent, ts = agent
    rng0 = ts.env_state.rng.get_state()
    sess = tvs.ViewerSession(agent, ts, chunk_steps=4, seed=5)
    assert sess.step_chunk() and sess.step_count == 4
    # the session steps a copy: the TrainState's generator did not move
    assert torch.equal(ts.env_state.rng.get_state(), rng0)
    env = agent.env
    gen = torch.Generator().manual_seed(5)
    rng = torch.Generator()
    rng.set_state(rng0)
    state = ts.env_state.replace(rng=rng)
    with torch.no_grad():
        for _ in range(4):
            obs = env.observe(state)
            _, mu, *_ = agent._policy(ts.params, ts.obs_norm, obs, gen)
            state, out = env.step(state, mu)
    for f in ("u", "body_x", "body_q", "root_pos"):
        assert torch.equal(getattr(sess.state.physics, f),
                           getattr(state.physics, f)), f
    assert torch.equal(sess.state.progress, state.progress)
    assert sess.last_reward == float(out.reward[0])
    assert sess.status()["step"] == 4


def test_session_controls(agent):
    agent, ts = agent
    sess = tvs.ViewerSession(agent, ts, chunk_steps=1)
    sess.control("pause")
    assert not sess.step_chunk() and sess.step_count == 0
    sess.control("resume")
    assert sess.step_chunk() and sess.step_count == 1
    u0 = sess.state.physics.u.clone()
    sess.control("push", velocity=[-2.0, 1.0])
    du = sess.state.physics.u - u0
    np.testing.assert_allclose(du[0, :2].numpy(), [-2.0, 1.0], atol=1e-6)
    assert not du[1].any() and not du[0, 2:].any()
    sess.control("next_env")
    sess.control("push")
    np.testing.assert_allclose((sess.state.physics.u - u0)[1, :2].numpy(),
                               [-2.0, 0.0], atol=1e-6)
    assert sess.control("prev_env")["env"] == 0
    assert sess.control("prev_env")["env"] == 1
    assert sess.control("env", index=5)["env"] == 1
    assert sess.control("follow")["follow"] is False
    assert sess.control("show_traj")["show_traj"] is False
    reset = sess.control("reset")
    assert reset["step"] == 0 and reset["num_envs"] == 2
    assert not torch.equal(sess.state.physics.u, u0)
    with pytest.raises(ValueError, match="unknown viewer command"):
        sess.control("bogus")
    # the JAX session's status keys
    assert set(sess.status()) == {"step", "env", "num_envs", "reward",
                                  "paused", "follow", "show_traj",
                                  "last_error"}


def test_viewer_server_http(agent):
    agent, ts = agent
    sess = tvs.ViewerSession(agent, ts, chunk_steps=1)
    assert sess.render_png()[:8] == PNG
    server = tvs.ViewerServer(sess, port=0, fps=20.0).start()
    try:
        base = f"http://127.0.0.1:{server.port}"
        st = json.loads(_get(base + "/status")[0])
        assert st["num_envs"] == 2 and st["last_error"] is None
        png, ctype = _get(base + "/frame.png?t=1")
        assert png[:8] == PNG and ctype == "image/png"
        page, ctype = _get(base + "/")
        assert b"emloco_tpu_torch live viewer" in page
        assert ctype == "text/html"
        assert _post(base + "/control", {"cmd": "pause"})["paused"] is True
        for bad in ({"cmd": "bogus"}, {"nocmd": 1}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(base + "/control", bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(base + "/nowhere")
        assert e.value.code == 404
    finally:
        server.close()
    assert sess.last_error is None
