"""Policy checkpoints across the two packages: a file written by the JAX
package's `save_pytree` loads in the port with jax, flax, optax and
emloco_tpu refused by the import system, and gives the agent's first
action, its norms and its Adam state as JAX has them; a class outside the
loader's list is refused; `train --out` then `--resume` keeps absolute
epochs and restores the state bit for bit; `train_value --policy` and
`--resume` read the files. The agent is tests/test_torch_train.py's small
one (4 envs, sensor_res 8, 3 AMP steps, narrow heads) on its world.
"""
import collections
import json
import os
import pathlib
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from emloco_tpu.learning.running_norm import RunningNorm as JNorm
from emloco_tpu.utils.checkpoint import save_pytree as jsave
from emloco_tpu_torch import train, train_value
from emloco_tpu_torch.utils import checkpoint as ckpt
from test_torch_train import _agents, jworld  # noqa: F401

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "emloco_tpu")
SMALL = ["--num-envs", "2", "--device", "cpu", "amp.horizon=2",
         "amp.num_minibatches=2", "amp.mini_epochs=1",
         "amp.amp_batch_size=4", "amp.amp_replay_size=8",
         "env.sensor_res=8", "env.num_amp_obs_steps=3"]

# runs in a fresh interpreter whose import system refuses the JAX side
LOADER = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in {blocked!r}:
            raise ModuleNotFoundError("refused: " + name)
sys.meta_path.insert(0, Refuse())
import numpy as np
from emloco_tpu_torch.utils import checkpoint as ckpt
from test_torch_train import port_env, small_net
from emloco_tpu_torch.learning.amp_agent import AMPAgent, AMPConfig
tree, meta = ckpt.load_pytree({path!r})
agent = AMPAgent(port_env(), AMPConfig(amp_replay_size=16))
agent.net = small_net(agent.env.cfg, agent.amp_dim)
ts = ckpt.restore_policy(agent.init(0), tree)
obs = np.load({obs!r})
import torch
mu = agent._apply(ts.params, "actor", ts.obs_norm.normalize(
    torch.as_tensor(obs)))[0]
out = dict(mu=mu.detach().numpy(), count=ts.opt_state.count.numpy(),
           epoch=np.array(ckpt.checkpoint_epoch({path!r}, meta)))
for n in ("obs_norm", "amp_norm", "value_norm"):
    for f in ("mean", "var", "count"):
        out[n + "." + f] = getattr(getattr(ts, n), f).numpy()
for k in ts.params:
    out["mu." + k] = ts.opt_state.mu[k].numpy()
    out["nu." + k] = ts.opt_state.nu[k].numpy()
np.savez({out!r}, **out)
bad = sorted(m for m in sys.modules if m.split(".")[0] in {blocked!r})
print(",".join(bad))
"""


def test_jax_policy_file_loads_without_jax(jworld, tmp_path):  # noqa: F811
    """A JAX policy file (params, three updated norms, the Adam state after
    one step) read by the port in a process that cannot import the JAX
    side: the first deterministic action within 1e-6 of JAX's, the norms
    and the Adam count and moments bit-equal."""
    jagent, agent = _agents(jworld, amp_replay_size=16)
    obs_dim, amp_dim = jagent.env.obs_dim, jagent.amp_dim
    # each JAX computation jitted whole: one compile, not one an op
    params = jax.jit(jagent.net.init)(jax.random.PRNGKey(1),
                                      jnp.zeros((1, obs_dim)),
                                      jnp.zeros((1, amp_dim)))
    rng = np.random.default_rng(0)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape), p.dtype), params)
    opt = jax.jit(lambda g, p: jagent.tx.update(g, jagent.tx.init(p), p)[1])(
        grads, params)
    updated = jax.jit(lambda x: JNorm.create(x.shape[-1]).update(x))

    def norm(dim, scale):
        return updated(jnp.asarray(rng.standard_normal((64, dim)) * scale,
                                   jnp.float32))

    obs_norm, amp_norm, value_norm = norm(obs_dim, 2.0), norm(amp_dim, 0.5), \
        norm(1, 3.0)
    path = str(tmp_path / "policy_00000007.ckpt")
    jsave(path, dict(params=params, obs_norm=obs_norm, amp_norm=amp_norm,
                     value_norm=value_norm, opt_state=opt),
          metadata=dict(epoch=7))
    obs = rng.standard_normal((4, obs_dim)).astype(np.float32)
    np.save(tmp_path / "obs.npy", obs)
    out = str(tmp_path / "port.npz")
    code = LOADER.format(blocked=BLOCKED, path=path,
                         obs=str(tmp_path / "obs.npy"), out=out)
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join([str(ROOT), str(ROOT / "tests")]))
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, cwd=ROOT, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == ""
    got = dict(np.load(out))
    mu, _ = jax.jit(lambda p, o: jagent.net.apply(
        p, obs_norm.normalize(o), method=jagent.net.actor))(
            params, jnp.asarray(obs))
    mu = np.asarray(mu)
    np.testing.assert_allclose(got["mu"], mu, rtol=0,
                               atol=1e-6 * np.abs(mu).max())
    assert int(got["epoch"]) == 7
    for name, n in (("obs_norm", obs_norm), ("amp_norm", amp_norm),
                    ("value_norm", value_norm)):
        for f in ("mean", "var", "count"):
            assert np.array_equal(got[f"{name}.{f}"],
                                  np.asarray(getattr(n, f))), (name, f)
    adam = opt[1][0]
    assert int(got["count"]) == int(adam.count) == 1
    from emloco_tpu_torch import convert
    for which, tree in (("mu", adam.mu), ("nu", adam.nu)):
        want = convert.agent_state_dict(jax.tree.map(np.asarray, tree))
        for k, v in want.items():
            assert np.array_equal(got[f"{which}.{k}"], v.numpy()), (which, k)


@pytest.mark.parametrize("obj", [collections.OrderedDict(a=1), os.system,
                                 collections.Counter("ab")],
                         ids=["OrderedDict", "os.system", "Counter"])
def test_unknown_class_is_refused(tmp_path, obj):
    path = tmp_path / "bad.ckpt"
    path.write_bytes(pickle.dumps({"tree": obj, "metadata": {}}))
    name = getattr(obj, "__name__", type(obj).__name__)
    with pytest.raises(pickle.UnpicklingError, match=name):
        ckpt.load_pytree(str(path))


@pytest.mark.parametrize("protocol", range(pickle.HIGHEST_PROTOCOL + 1))
def test_trees_of_arrays_load_at_every_protocol(tmp_path, protocol):
    """Arrays, numpy scalars, tuples and lists round-trip through the
    loader whatever pickle protocol wrote them."""
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": (np.int32(3), [np.float64(2.5)]),
            "c": np.array(1.5, np.float32)}
    path = tmp_path / "t.ckpt"
    path.write_bytes(pickle.dumps({"tree": tree, "metadata": {"epoch": 3}},
                                  protocol=protocol))
    got, meta = ckpt.load_pytree(str(path))
    assert meta == {"epoch": 3}
    assert np.array_equal(got["a"], tree["a"]) and got["a"].dtype == np.float32
    assert got["b"] == (3, [2.5]) and got["b"][0].dtype == np.int32
    assert got["c"] == np.float32(1.5) and got["c"].shape == ()


def _policy_state(ts):
    return {**{f"params.{k}": v for k, v in ts.params.items()},
            **{f"{n}.{f}": getattr(getattr(ts, n), f)
               for n in ("obs_norm", "amp_norm", "value_norm")
               for f in ("mean", "var", "count")},
            "adam.count": ts.opt_state.count,
            **{f"adam.mu.{k}": v for k, v in ts.opt_state.mu.items()},
            **{f"adam.nu.{k}": v for k, v in ts.opt_state.nu.items()}}


def test_train_saves_and_resumes(tmp_path, capsys):
    """Two epochs with --save-every 1 write policy_00000001 (epoch 0 is not
    saved, as in the JAX CLI); resuming it restores the params, norms and
    Adam state bit for bit at epoch 2, one more epoch writes
    policy_00000002, and train_value reads the policy (--policy) and then
    resumes its own file (--resume) with absolute epochs."""
    out = str(tmp_path / "policy")
    ts = train.main(["--epochs", "2", "--save-every", "1", "--out", out,
                     *SMALL])
    assert sorted(os.listdir(out)) == ["policy_00000001.ckpt"]
    path = os.path.join(out, "policy_00000001.ckpt")
    tree, meta = ckpt.load_pytree(path)
    assert meta == {"epoch": 1}
    back = train.main(["--epochs", "0", "--resume", path, *SMALL])
    assert back.epoch == 2 and ts.epoch == 2
    saved, restored = _policy_state(ts), _policy_state(back)
    assert saved.keys() == restored.keys()
    for k, v in saved.items():
        assert v.dtype == restored[k].dtype and torch.equal(
            v, restored[k]), k
    capsys.readouterr()
    train.main(["--epochs", "1", "--resume", path, "--out", out, *SMALL])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["epoch"] == 3
    assert sorted(os.listdir(out))[-1] == "policy_00000002.ckpt"
    assert ckpt.load_pytree(os.path.join(out, "policy_00000002.ckpt"))[1] \
        == {"epoch": 2}

    small = ["--num-envs", "2", "--device", "cpu", "amp.amp_replay_size=8",
             "env.sensor_res=8", "env.num_amp_obs_steps=3"]
    vout = str(tmp_path / "vn")
    vts = train_value.main(["--epochs", "1", "--policy", path, "--out",
                            vout, *small])
    for k, v in ts.params.items():
        assert torch.equal(vts.policy.params[k], v), k
    for n in ("obs_norm", "amp_norm"):
        assert torch.equal(getattr(vts.policy, n).mean,
                           getattr(ts, n).mean), n
    vpath = os.path.join(vout, "valuenet_00000000.ckpt")
    vts2 = train_value.main(["--epochs", "1", "--resume", vpath, "--out",
                             vout, *small])
    assert vts2.epoch == 2
    assert sorted(os.listdir(vout)) == ["valuenet_00000000.ckpt",
                                        "valuenet_00000001.ckpt"]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert all(np.isfinite(ln["vnet_loss"]) for ln in lines)
