"""The port's prediction tools against emloco_tpu/prediction on the CPU:
`collect_vis_data` on tests/test_torch_predictor_train.py's small
TransMotion and its parameters (both packages' datasets from one seed;
every array within 1e-5 of its largest magnitude), the plots and the
vis_dict file, the trajectory-bank export (`spline_to_vertices` within
1e-6 of the JAX package's, banks read back in both formats), the sweep's
trials (numpy's RandomState, equal to the JAX package's) and its resume
from the log; then the entry points `eval_predictor --plots`,
`visualize_pred`, `tune_predictor` and `train_eqmotion` on `--device
cpu`.
"""
import json
import os
import pickle

import numpy as np
import pytest
import torch

from emloco_tpu.prediction import data as jdata
from emloco_tpu.prediction import export as jexport
from emloco_tpu.prediction import tuning as jtuning
from emloco_tpu.prediction import visualize as jvis
from emloco_tpu.prediction.model import TransMotionConfig as JCfg
from emloco_tpu.prediction.train import PredictorTrainer as JTrainer
from emloco_tpu.prediction.train import PredictTrainConfig as JPCfg
from emloco_tpu_torch import (eval_predictor, train_eqmotion, train_predictor,
                              tune_predictor, visualize_pred)
from emloco_tpu_torch.learning.networks import ValuePoseNet
from emloco_tpu_torch.prediction import data as tdata
from emloco_tpu_torch.prediction import export as texport
from emloco_tpu_torch.prediction import tuning as ttuning
from emloco_tpu_torch.prediction import visualize as V
from emloco_tpu_torch.utils.checkpoint import load_pytree, save_valuenet
from test_torch_predictor_train import (FIXTURE, N, ROOT, SMALL, TRAIN,
                                        start, vnets)  # noqa: F401

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ETH = str(ROOT / "tests" / "data" / "ethucy_fixture.txt")
REL = 1e-5
TINY = ["model.nhid=16", "model.nhead=2", "model.dim_ff=32",
        "model.nlayers_local=1", "model.nlayers_global=1", "model.nmode=3"]


def _sets(seed=7):
    return (jdata.NdjsonScenes(FIXTURE, max_people=N, seed=seed),
            tdata.NdjsonScenes(FIXTURE, max_people=N, seed=seed))


def rel_close(got, want, rel=REL):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-12)


@pytest.fixture(scope="module")
def vis(vnets, start):  # noqa: F811
    """The port's vis_dict of 2 batches of 4, and JAX's of the same."""
    jv, vp, tvp = vnets
    tt, ts, params = start
    jd, td = _sets()
    jt = JTrainer(JCfg(**SMALL), JPCfg(**TRAIN))
    want = jvis.collect_vis_data(jt, params, jd, 4, 2, vnet=jv,
                                 vnet_params=vp)
    got = V.collect_vis_data(tt, ts.params, td, 4, 2, vnet=tt.vnet,
                             vnet_params=tvp)
    return got, want


def test_collect_vis_data_matches_jax(vis):
    got, want = vis
    assert sorted(got) == sorted(want) == ["gt", "init_pose", "obs", "pred",
                                           "values"]
    for k in want:
        assert got[k].dtype == np.float32, k
        rel_close(got[k], want[k])
    assert got["pred"].shape == (8, 12, 3, 2)


def test_plots_and_vis_dict_file(vis, tmp_path):
    got, _ = vis
    path = str(tmp_path / "vis_dict.pkl")
    V.save_vis_dict(path, got)
    back = V.load_vis_dict(path)
    assert sorted(back) == sorted(got)
    for k in got:
        np.testing.assert_array_equal(back[k], got[k])
    other = dict(got, pred=got["pred"] + 0.1)
    outs = [
        V.plot_prediction_comparison({"a": got, "b": other}, [0, 1],
                                     str(tmp_path / "cmp.png"),
                                     value_threshold=0.5),
        V.plot_metric_diff_histograms({"a": got, "b": other}, "b",
                                      str(tmp_path / "diff.png")),
        V.plot_value_histogram({"pred": got["values"]},
                               str(tmp_path / "vh.png")),
        V.plot_des_per_step({"a": np.linspace(0.1, 1.0, 12)},
                            str(tmp_path / "des.png")),
        *V.save_3d_plots(got, str(tmp_path / "vis3d"), num_samples=2)]
    ades = np.linalg.norm(got["pred"] - got["gt"][:, :, None], axis=-1)
    bars = V.plot_value_ade_bars(got["values"], ades.mean(1),
                                 str(tmp_path / "bars.png"))
    assert bars["counts"].sum() == got["values"].size
    for p in outs + [str(tmp_path / "bars.png")]:
        assert os.path.getsize(p) > 0, p
    ade, fde = V.per_sample_min_metrics(got)
    jade, jfde = jvis.per_sample_min_metrics(got)
    np.testing.assert_array_equal(ade, jade)
    np.testing.assert_array_equal(fde, jfde)


def test_traj_bank_export(tmp_path):
    rng = np.random.default_rng(0)
    for w in (13, 9):
        wp = np.cumsum(rng.normal(size=(w, 2)), 0)
        np.testing.assert_allclose(texport.spline_to_vertices(wp),
                                   jexport.spline_to_vertices(wp), rtol=0,
                                   atol=1e-6)
    trajs = [np.cumsum(rng.normal(size=(13, 2)), 0) for _ in range(3)]
    poses = [rng.normal(size=(24, 3)) for _ in range(3)]
    vels = [rng.normal(size=2) for _ in range(3)]
    path = str(tmp_path / "bank.pkl")
    bank = texport.export_traj_bank(trajs, path, init_poses=poses,
                                    init_vels=vels)
    for load in (texport.load_traj_bank, jexport.load_traj_bank):
        t, p, v = load(path)
        np.testing.assert_array_equal(t, bank)
        np.testing.assert_array_equal(p, np.stack(poses))
        np.testing.assert_array_equal(v, np.stack(vels))
    ref = str(tmp_path / "ref.pkl")
    with open(ref, "wb") as f:
        pickle.dump({f"scene{i}": np.concatenate(
            [b, np.zeros((101, 1))], -1) for i, b in enumerate(bank)}, f)
    t, p, v = texport.load_traj_bank(ref)
    np.testing.assert_array_equal(t, bank)
    assert p is None and v is None
    out = str(tmp_path / "scenes.pkl")
    got = texport.export_scene_dataset(tdata.NdjsonScenes(FIXTURE, seed=3),
                                       out, num_scenes=8, batch_size=4)
    want = jexport.export_scene_dataset(jdata.NdjsonScenes(FIXTURE, seed=3),
                                        str(tmp_path / "j.pkl"),
                                        num_scenes=8, batch_size=4)
    assert got.shape == (8, 101, 2)
    rel_close(got, want)
    t, _, _ = texport.load_traj_bank(out)
    np.testing.assert_array_equal(t, got)


def test_sample_trial_equals_jax():
    for seed in (0, 5):
        jr, tr = np.random.RandomState(seed), np.random.RandomState(seed)
        for _ in range(4):
            assert (ttuning.sample_trial(ttuning.DEFAULT_SPACE, tr)
                    == jtuning.sample_trial(jtuning.DEFAULT_SPACE, jr))


def test_run_sweep_resumes_from_log(tmp_path):
    log = str(tmp_path / "trials.jsonl")
    seen = []

    def objective(params, trial):
        seen.append(trial)
        if trial == 1:
            raise FloatingPointError("diverged")
        return params["predict.lr"] * 1e3

    s = ttuning.run_sweep(objective, num_trials=3, log_path=log, seed=2)
    assert s["num_trials"] == 2 and seen == [0, 1, 2]
    s = ttuning.run_sweep(objective, num_trials=5, log_path=log, seed=2)
    assert seen == [0, 1, 2, 3, 4] and s["num_trials"] == 4
    trials = ttuning.SweepLog(log).trials()
    assert [t["trial"] for t in trials] == list(range(5))
    assert "error" in trials[1]
    rng = np.random.RandomState(2)
    for t in trials:
        assert t["params"] == jtuning.sample_trial(jtuning.DEFAULT_SPACE,
                                                   rng)


def test_entry_points_on_cpu(vnets, tmp_path, capsys):  # noqa: F811
    """eval_predictor --plots writes a vis_dict and its plots, two of them
    compare in visualize_pred, tune_predictor runs 2 trials and resumes,
    train_eqmotion runs an epoch on the ETH-UCY fixture."""
    _, _, tvp = vnets
    vnet = str(tmp_path / "valuenet.ckpt")
    save_valuenet(vnet, tvp, dict(use_pose=True, use_vel=True))
    common = ["--device", "cpu", "--ndjson", FIXTURE, "--batch-size", "2",
              "--batches", "2", *TINY]
    train_predictor.main([*common, "--epochs", "1", "--out",
                          str(tmp_path / "pred")])
    ckpt = str(tmp_path / "pred" / "predictor_best.ckpt")
    dicts = []
    for name in ("a", "b"):
        out = str(tmp_path / name)
        res = eval_predictor.main([*common, "--predictor", ckpt,
                                   "--valuenet", vnet, "--plots", "--out",
                                   out])
        for key in ("vis_dict", "comparison", "value_ade", "value_hist"):
            assert os.path.getsize(res["plots"][key]) > 0, key
        assert len(res["plots"]["vis3d"]) == 3      # min(3, scenes)
        dicts.append(res["plots"]["vis_dict"])
    with pytest.raises(SystemExit):
        eval_predictor.main([*common, "--predictor", ckpt, "--plots"])
    paths = visualize_pred.main(["--vis-dicts", *dicts, "--out",
                                 str(tmp_path / "viz")])
    assert paths["ours"] == "b/vis_dict"
    for key in ("comparison", "metric_diff", "values_vis_dict",
                "values_b/vis_dict"):
        assert os.path.getsize(paths[key]) > 0, key
    with pytest.raises(ValueError, match="duplicate"):
        visualize_pred.load([dicts[0], dicts[0], dicts[0]])
    tune = [*common, "--epochs", "1", "--out", str(tmp_path / "tune")]
    summary, trials = tune_predictor.main([*tune, "--trials", "2"])
    assert [t["trial"] for t in trials] == [0, 1]
    assert all(np.isfinite(t["val_ade"]) for t in trials)
    summary, trials = tune_predictor.main([*tune, "--trials", "3"])
    assert [t["trial"] for t in trials] == [2]
    assert summary["num_trials"] == 3
    capsys.readouterr()
    out = str(tmp_path / "eq")
    vel = str(tmp_path / "vel.ckpt")
    v = ValuePoseNet(use_pose=False, use_vel=True,
                     generator=torch.Generator().manual_seed(0),
                     device="cpu")
    save_valuenet(vel, dict(v.named_parameters()),
                  dict(use_pose=False, use_vel=True))
    _, ts, ev = train_eqmotion.main([
        "--device", "cpu", "--epochs", "1", "--ethucy", ETH, "--valuenet",
        vel, "--out", out, "eqmotion.hidden_nf=16", "eqmotion.hid_channel=8",
        "eqmotion.n_layers=1", "eqmotion.nmode=3"])
    lines = [json.loads(ln) for ln in
             capsys.readouterr().out.strip().splitlines()]
    assert lines[1]["epoch"] == 0 and lines[1]["value_loss"] > 0
    assert all(np.isfinite(ev[k]) for k in ("ade_min", "ade_filtered_min",
                                             "mean_value"))
    tree, meta = load_pytree(os.path.join(out, "eqmotion.ckpt"))
    assert sorted(tree) == ["params"] and "cfg" in meta
