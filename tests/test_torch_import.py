"""The port stands alone: it imports torch and numpy, never jax, flax,
emloco_tpu, the JAX package's scripts, pyyaml or joblib (the card's machine
has neither), and its chip smoke script refuses to run without a card. Three
card tests (requires_cuda) run the entry point's train-policy at a small
width, alone and over two ranks, and the native helpers' build there."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "emloco_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "emloco_tpu", "scripts",
             "yaml", "joblib")


def _no_gpu_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_pulls_in_no_jax():
    """Every module imports with jax, flax, optax, emloco_tpu, the JAX
    package's scripts, pyyaml and joblib refused by an import hook, the
    configuration of configs/pacer_terrain.yaml loads, and none of them,
    nor matplotlib (imported inside the plotting functions), is in
    sys.modules afterwards."""
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        f"        if name.split('.')[0] in {FORBIDDEN!r}:\n"
        "            raise ImportError('refused: ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import emloco_tpu_torch, emloco_tpu_torch.convert, "
        "emloco_tpu_torch.build\n"
        "import emloco_tpu_torch.envs, emloco_tpu_torch.learning, "
        "emloco_tpu_torch.physics.linalg, "
        "emloco_tpu_torch.scripts.gram_kernel_probe, "
        "emloco_tpu_torch.learning.amp_agent, emloco_tpu_torch.train\n"
        "import emloco_tpu_torch.learning.value_train, "
        "emloco_tpu_torch.analysis, emloco_tpu_torch.utils.checkpoint, "
        "emloco_tpu_torch.train_value, emloco_tpu_torch.optimize_traj\n"
        "import emloco_tpu_torch.prediction.metrics, "
        "emloco_tpu_torch.prediction.data, "
        "emloco_tpu_torch.prediction.model, "
        "emloco_tpu_torch.prediction.lstm, "
        "emloco_tpu_torch.prediction.train, "
        "emloco_tpu_torch.prediction.evaluate, "
        "emloco_tpu_torch.prediction.presets, "
        "emloco_tpu_torch.train_predictor, "
        "emloco_tpu_torch.eval_predictor\n"
        "import emloco_tpu_torch.prediction.eqmotion, "
        "emloco_tpu_torch.prediction.eqmotion_full, "
        "emloco_tpu_torch.prediction.export, "
        "emloco_tpu_torch.prediction.tuning, "
        "emloco_tpu_torch.prediction.visualize, "
        "emloco_tpu_torch.learning.players, "
        "emloco_tpu_torch.kinematics.visualization, "
        "emloco_tpu_torch.train_eqmotion, emloco_tpu_torch.eval_policy, "
        "emloco_tpu_torch.visualize_pred, "
        "emloco_tpu_torch.tune_predictor\n"
        "import emloco_tpu_torch.cli.run, emloco_tpu_torch.utils.config, "
        "emloco_tpu_torch.utils.logging, emloco_tpu_torch.utils.tracking, "
        "emloco_tpu_torch.utils.profiling, emloco_tpu_torch.native, "
        "emloco_tpu_torch.envs.traj_server, "
        "emloco_tpu_torch.envs.viewer_server\n"
        "import emloco_tpu_torch.kinematics.smpl, "
        "emloco_tpu_torch.kinematics.retarget, "
        "emloco_tpu_torch.kinematics.bvh, "
        "emloco_tpu_torch.kinematics.curation, "
        "emloco_tpu_torch.kinematics.fbx, emloco_tpu_torch.parallel, "
        "emloco_tpu_torch.parallel.mesh\n"
        "from emloco_tpu_torch.utils.config import load_config\n"
        "cfg = load_config('configs/pacer_terrain.yaml', ['amp.lr=1.0e-5'])\n"
        "assert cfg.env.num_envs == 1600 and cfg.amp.lr == 1e-5\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN + ('matplotlib',)!r})\n"
        "print(','.join(bad))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=_no_gpu_env(), cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


@pytest.mark.parametrize(
    "path", sorted(str(p.relative_to(ROOT))
                   for p in [*PORT.rglob("*.py"), ROOT / "chip_smoke.py"]))
def test_sources_import_no_jax(path):
    tree = ast.parse((ROOT / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, (path, name)


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device: non-zero exit and no result on stdout — also from a
    directory that holds the script and nothing else of the repo."""
    for script in (ROOT / "chip_smoke.py",
                   shutil.copy(ROOT / "chip_smoke.py", tmp_path)):
        env = _no_gpu_env()
        env.pop("PYTHONPATH")
        out = subprocess.run([sys.executable, str(script)],
                             capture_output=True, text=True, env=env,
                             cwd=tmp_path, timeout=300)
        assert out.returncode != 0
        assert out.stdout == ""


def test_build_raises_without_nvcc(monkeypatch, tmp_path):
    from emloco_tpu_torch import build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        build.nvcc_path()


@pytest.mark.requires_cuda
def test_cli_train_policy_on_card(tmp_path):
    """`cli.run train-policy` over configs/pacer_terrain.yaml at 64 envs for
    one epoch on the card: the factor 32 and the resolve 64 times, a
    finite metrics row and the checkpoint."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from emloco_tpu_torch.cli import run
    from emloco_tpu_torch.physics import linalg
    from emloco_tpu_torch.utils.checkpoint import load_pytree
    linalg.reset_launch_counts()
    run.main(["train-policy", "--config",
              str(ROOT / "configs" / "pacer_terrain.yaml"), "epochs=1",
              "env.num_envs=64", "amp.num_minibatches=2",
              "amp.amp_replay_size=4096", "terrain.num_tiles=2",
              f"out_dir={tmp_path}"])
    assert linalg.LAUNCHES["cholesky_factor_blocked_t"] == 32
    assert linalg.LAUNCHES["cholesky_resolve_blocked_t"] == 64
    (row,) = [json.loads(x) for x in open(tmp_path / "policy.metrics.jsonl")]
    assert all(v == v for v in row.values())          # no NaN
    assert load_pytree(str(tmp_path / "policy_00000000.ckpt"))[1] == {
        "epoch": 0}


@pytest.mark.requires_cuda
def test_cli_mesh_train_policy_on_card(tmp_path):
    """`cli.run train-policy --mesh 2` at 64 envs for one epoch on the
    card's machine: each rank on cuda:(rank mod cards) with its factor 32
    and resolve 64 launches, and the ranks' parameters bit-equal."""
    import json

    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run(
        [sys.executable, "-m", "emloco_tpu_torch.cli.run", "train-policy",
         "--mesh", "2", "--config",
         str(ROOT / "configs" / "pacer_terrain.yaml"), "epochs=1",
         "env.num_envs=64", "amp.num_minibatches=2",
         "amp.amp_replay_size=4096", "terrain.num_tiles=2",
         f"out_dir={tmp_path}"], capture_output=True, text=True, cwd=ROOT,
        timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    last = [json.loads(x) for x in out.stdout.splitlines()
            if x.startswith("{") and "launches" in x]
    assert len(last) == 2
    for x in last:
        assert x["launches"]["cholesky_factor_blocked_t"] == 32
        assert x["launches"]["cholesky_resolve_blocked_t"] == 64
    assert last[0]["params_sha256"] == last[1]["params_sha256"]


@pytest.mark.requires_cuda
def test_native_build_on_card():
    """The native helpers build on the card's machine and read the JTA
    fixture as the plain reader does."""
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from emloco_tpu_torch import native
    from emloco_tpu_torch.prediction.data import read_ndjson_scenes
    path = str(ROOT / "tests" / "data" / "jta_all_cues_fixture.ndjson")
    scenes = native.scenes_to_arrays(*native.read_ndjson_fast(path))
    ref = read_ndjson_scenes(path)
    assert len(scenes) == len(ref) > 0
    for a, b in zip(scenes, ref):
        np.testing.assert_array_equal(a, b)
    h = np.random.RandomState(0).rand(32, 32).astype(np.float32)
    assert native.fast_walkable_mask(h, 0.1).shape == (32, 32)
