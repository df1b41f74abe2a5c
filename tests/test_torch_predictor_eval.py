"""The port's predictor evaluation, files and entry points against
emloco_tpu/prediction on the CPU, on tests/test_torch_predictor_train.py's
small configuration and its untrained parameters: evaluate_with_filter,
the filter-threshold sweep and the observation-length sweep (each metric
within 1e-5 of its magnitude; the datasets of both packages from one
seed, so the windows match); predictor files read across the packages
(predictions within 1e-5 of the largest |output|); train_predictor and
eval_predictor at a tiny width on the JTA fixture.
"""
import json
import pathlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from emloco_tpu.prediction import data as jdata
from emloco_tpu.prediction import evaluate as jev
from emloco_tpu.prediction.model import TransMotionConfig as JCfg
from emloco_tpu.prediction.train import PredictorTrainer as JTrainer
from emloco_tpu.prediction.train import PredictTrainConfig as JPCfg
from emloco_tpu_torch import convert, eval_predictor, train_predictor
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.prediction import data as tdata
from emloco_tpu_torch.prediction import evaluate as tev
from emloco_tpu_torch.utils.checkpoint import save_valuenet
from test_torch_predictor_train import (FIXTURE, N, SMALL, TRAIN, jax_state,
                                        scenes, start, vnets)  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
EVAL_REL, PREDICT_REL = 1e-5, 1e-5


def _eval_sets():
    """Evaluation datasets of both packages from one seed."""
    return (jdata.NdjsonScenes(FIXTURE, max_people=N, seed=7),
            tdata.NdjsonScenes(FIXTURE, max_people=N, seed=7))


def close_metrics(got, want):
    assert got.keys() == want.keys()
    for k, w in want.items():
        assert abs(got[k] - w) <= EVAL_REL * max(abs(w), 1e-6), (k, got[k],
                                                                 w)


def test_evaluation_matches_jax(vnets, start):  # noqa: F811
    jv, vp, tvp = vnets
    tt, ts, params = start
    jt = JTrainer(JCfg(**SMALL), JPCfg(**TRAIN))
    jd, td = _eval_sets()
    want = jev.evaluate_with_filter(jt, params, jd, 4, 2, vnet=jv,
                                    vnet_params=vp, threshold=0.5)
    got = tev.evaluate_with_filter(tt, ts.params, td, 4, 2, vnet=tt.vnet,
                                   vnet_params=tvp, threshold=0.5)
    close_metrics(got, want)
    assert 0.0 < got["kept_frac"] <= 1.0
    jd, td = _eval_sets()
    want = jev.filter_threshold_sweep(jt, params, jd, 4, 2, jv, vp)
    got = tev.filter_threshold_sweep(tt, ts.params, td, 4, 2, tt.vnet, tvp)
    assert got.keys() == want.keys()
    for t in want:
        close_metrics(got[t], want[t])
    jd, td = _eval_sets()
    want = jev.observation_length_sweep(jt, params, jd, 4, 1,
                                        lengths=(1, 4, 9))
    got = tev.observation_length_sweep(tt, ts.params, td, 4, 1,
                                       lengths=(1, 4, 9))
    close_metrics(got, want)


def test_predictor_files_cross_packages(start, tmp_path):  # noqa: F811
    """A file the port writes, read by the JAX load_checkpoint, gives JAX's
    predict the port's output; a file JAX writes (with its optax states)
    gives the port JAX's output."""
    tt, ts, params = start
    jt = JTrainer(JCfg(**SMALL), JPCfg(**TRAIN))
    batch = scenes(1).window_batch([0, 1, 2, 3])
    want = tt.predict(ts.params, batch.obs, batch.padding_mask).numpy()
    path = str(tmp_path / "port.ckpt")
    tt.save_checkpoint(path, ts, {"preset": "small"})
    blob = JTrainer.load_checkpoint(path)
    assert blob["step"] == 0 and blob["config"] == {"preset": "small"}
    got = np.asarray(jt.predict(blob["params"], jnp.asarray(batch.obs),
                                jnp.asarray(batch.padding_mask)))
    tol = PREDICT_REL * np.abs(want).max()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)

    jts = jax_state(jt, params, None)
    path = str(tmp_path / "jax.ckpt")
    JTrainer.save_checkpoint(path, jts)
    blob = tt.load_checkpoint(path)
    got = tt.predict(tt.params_from(blob["params"]), batch.obs,
                     batch.padding_mask).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    back = convert.adam_state(blob["opt_state"], "cpu",
                              convert.transmotion_state_dict)
    assert int(back.count) == 0


def test_entry_points_on_cpu(tmp_path, capsys, monkeypatch):
    """train_predictor (EmLoco loss from a valuenet file, 2 epochs) writes
    predictor_best.ckpt; eval_predictor reads it with the filter and both
    sweeps; the lstm preset trains; no card is taken without one unless
    the CPU is asked for."""
    vpath = str(tmp_path / "valuenet_00000000.ckpt")
    vnet = ValuePoseNet(generator=torch.Generator().manual_seed(0),
                        device="cpu")
    save_valuenet(vpath, vnet.state_dict(), {"use_pose": True,
                                             "use_vel": True})
    small = ["model.nhid=16", "model.nhead=2", "model.dim_ff=32",
             "model.nlayers_local=1", "model.nlayers_global=1",
             "model.nmode=3"]
    common = ["--ndjson", FIXTURE, "--batch-size", "2", "--batches", "2",
              "--device", "cpu", *small]
    train_predictor.main(["--epochs", "2", "--valuenet", vpath, "--out",
                          str(tmp_path / "pred"), *common])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln.get("epoch") for ln in lines[:2]] == [0, 1]
    assert all(np.isfinite(ln["traj_loss"]) and ln["steps_per_s"] > 0
               and ln["device"] == "cpu" for ln in lines[:2])
    assert lines[-1]["steps"] == 4
    ckpt = lines[-1]["checkpoint"]
    res = eval_predictor.main(["--predictor", ckpt, "--valuenet", vpath,
                               "--sweep-thresholds", "--all-frames",
                               *common])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert len(lines) == 3 and lines[0]["scenes_per_s"] > 0
    assert {"ade_min", "kept_frac", "ade_filtered_min"} <= set(
        res["evaluate"])
    assert len(res["threshold_sweep"]) == 11
    assert len(res["obs_length_sweep"]) == 9
    with pytest.raises(SystemExit):         # --out is read only with --plots
        eval_predictor.main(["--predictor", ckpt, "--out", str(tmp_path)])
    train_predictor.main(["--preset", "lstm", "--epochs", "1", "--ndjson",
                          FIXTURE, "--batch-size", "2", "--batches", "1",
                          "--device", "cpu", "--out", str(tmp_path / "l"),
                          "model.nhid=8"])
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["steps"] == 1
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_predictor.main(["--ndjson", FIXTURE])
