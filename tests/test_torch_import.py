"""The port stands alone: it imports torch and numpy, never jax, flax,
emloco_tpu or the JAX package's scripts, and its chip smoke script refuses
to run without a card."""
import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "emloco_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "emloco_tpu", "scripts")


def _no_gpu_env():
    env = dict(os.environ)
    env["CUDA_VISIBLE_DEVICES"] = ""
    env["PYTHONPATH"] = str(ROOT)
    return env


def test_import_pulls_in_no_jax():
    code = (
        "import sys\n"
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
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
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
