"""The port's entry point (emloco_tpu_torch/cli/run.py) on the CPU:
`main` runs train-policy (with resume), train-valuenet and train-predictor
into files the JAX package reads, and refuses what it does not run."""
import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from emloco_tpu.learning.networks import ValuePoseNet as JValuePoseNet
from emloco_tpu.prediction.train import PredictorTrainer as JPredictor
from emloco_tpu.utils import checkpoint as jckpt
from emloco_tpu.utils import tracking as jtracking
from emloco_tpu_torch import convert
from emloco_tpu_torch.cli import run as RUN
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.prediction.train import PredictorTrainer
from emloco_tpu_torch.utils import checkpoint as ckpt
from emloco_tpu_torch.utils import config as TC

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

TINY = ["env.num_envs=2", "env.sensor_res=8", "env.num_amp_obs_steps=3",
        "env.episode_length=16", "terrain.map_length=2.0",
        "terrain.num_tiles=1", "engine.n_substeps=1", "amp.horizon=4",
        "amp.num_minibatches=2", "amp.mini_epochs=1", "amp.amp_batch_size=8",
        "amp.amp_replay_size=16", "value.horizon=4"]
PRED = ["model.nhid=16", "model.nhead=2", "model.dim_ff=32",
        "model.nlayers_local=1", "model.nlayers_global=1", "model.nmode=2",
        "--batch-size", "2", "--batches", "1"]


def test_train_policy_writes_and_resumes(tmp_path, capsys):
    out = str(tmp_path)
    # dotted overrides before, between and after the flags
    RUN.main(["train-policy", *TINY[:4], "--device", "cpu", *TINY[4:],
              f"out_dir={out}", "epochs=2", "save_every=1"])
    ck = tmp_path / "policy_00000001.ckpt"
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "policy.metrics.jsonl", "policy_00000001.ckpt", "tb"]
    rows = [json.loads(x) for x in open(tmp_path / "policy.metrics.jsonl")]
    assert len(rows) == 1 and rows[0]["step"] == 0 and rows[0]["step_fps"]
    (ev,) = os.listdir(tmp_path / "tb")
    assert ev.endswith(".policy")
    scalars = list(jtracking.read_scalars(str(tmp_path / "tb" / ev)))
    assert {s for s, _, _ in scalars} == {0}
    for _, tag, v in scalars:
        assert v == float(np.float32(rows[0][tag]))
    tree, meta = jckpt.load_pytree(str(ck))
    assert meta == {"epoch": 1} and "opt_state" in tree
    assert capsys.readouterr().err.startswith("[0] a_loss=")
    ts = RUN.main(["train-policy", "--resume", str(ck), "--device", "cpu",
                   *TINY, f"out_dir={out}", "epochs=1"])
    assert ts.epoch == 3
    tree2, meta2 = ckpt.load_pytree(str(tmp_path / "policy_00000002.ckpt"))
    assert meta2 == {"epoch": 2}
    assert int(tree2["opt_state"]["count"]) == 2 * int(
        tree["opt_state"]["count"]) // 2 + 2


def test_refusals(tmp_path):
    with pytest.raises(SystemExit, match="--mesh 2: only train-policy"):
        RUN.main(["eval-policy", "--mesh", "2", "--device", "cpu", *TINY,
                  f"out_dir={tmp_path}"])
    for argv in (["no-such-command"], ["train-policy", "--bogus"],
                 ["train-policy", "stray"]):
        with pytest.raises(SystemExit):
            RUN.main(argv)
    with pytest.raises(KeyError):
        RUN.main(["train-policy", "--device", "cpu", "env.nope=1"])


def test_valuenet_and_predictor_files_load_in_jax(tmp_path, capsys):
    vout, pout = tmp_path / "v", tmp_path / "p"
    vts = RUN.main(["train-valuenet", "--device", "cpu", "--novel", *TINY,
                    f"out_dir={vout}", "epochs=1"])
    path = str(vout / "valuenet_00000000.ckpt")
    tree, meta = jckpt.load_pytree(path)
    assert meta["config"] == {"use_pose": True, "use_vel": False}
    rows = [json.loads(x) for x in open(vout / "valuenet.metrics.jsonl")]
    assert [r["step"] for r in rows] == [0]
    rng = np.random.RandomState(2)
    wp = rng.randn(3, 13, 2).astype(np.float32)
    pose = rng.randn(3, 24, 3).astype(np.float32) * 0.1
    want = np.asarray(JValuePoseNet(use_vel=False).apply(tree, wp, pose,
                                                         None))
    vnet = ValuePoseNet(use_vel=False, device="cpu")
    vnet.load_state_dict(convert.valuenet_state_dict(tree))
    with torch.no_grad():
        got = vnet(torch.as_tensor(wp), torch.as_tensor(pose), None).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    for k, v in vnet.state_dict().items():
        assert torch.equal(v, vts.vnet_params[k]), k
    ts, history, best = RUN.main(["train-predictor", "--device", "cpu",
                                  *PRED, f"out_dir={pout}", "epochs=1"])
    jblob = JPredictor.load_checkpoint(str(pout / "predictor_best.ckpt"))
    mcfg = TC.load_config(None, PRED[:6]).model
    assert dataclasses.asdict(mcfg)["nhid"] == 16
    got = PredictorTrainer(mcfg, TC.load_config(None).predict,
                           device="cpu").params_from(jblob["params"])
    assert got.keys() == best.keys()
    for k in best:
        assert torch.equal(got[k], best[k]), k
    rows = [json.loads(x) for x in open(pout / "predictor.metrics.jsonl")]
    assert [r["step"] for r in rows] == [0] and "ade_min" in rows[0]
