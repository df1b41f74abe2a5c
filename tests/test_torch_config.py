"""The port's run configuration (emloco_tpu_torch/utils/config.py) against
the JAX package's: `load_config` field by field on every committed config
with dotted overrides, and the port's own YAML reader against pyyaml (which
only this test imports; the port reads YAML without it)."""
import dataclasses
import glob
import math
import os

import pytest
import yaml

from emloco_tpu.utils import config as JC
from emloco_tpu_torch.utils import config as TC

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(glob.glob(os.path.join(ROOT, "configs", "*.yaml")))
OVERRIDES = (
    (),
    ("env.num_envs=4",),
    ("task=getup", "env.num_envs=4", "env.fall_gen_steps=2"),
    ("engine.gram_kernel=true", "engine.n_substeps=1"),
    ("amp.lr=1e-5",),                         # no dot: a string in YAML 1.1
    ("amp.lr=2.0e-5", "seed=3", "epochs=7", "out_dir=/tmp/x y"),
    ("dr.mass_range=[0.9, 1.1]", "dr.enabled=yes",
     "terrain.types=[flat, 'wave']"),
    ("traj.speed_max=2.5", "value.lr=1.0e-3", "model.nhid=64",
     "predict.pose_z_flip=false", "eqmotion.nmode=3"),
)


def same(a, b) -> bool:
    """a == b field by field, with the same leaf types (a NaN equals a
    NaN)."""
    if dataclasses.is_dataclass(a) and dataclasses.is_dataclass(b):
        fa = {f.name for f in dataclasses.fields(a)}
        fb = {f.name for f in dataclasses.fields(b)}
        return (type(a).__name__ == type(b).__name__ and fa == fb and all(
            same(getattr(a, k), getattr(b, k)) for k in fa))
    if isinstance(a, dict) and isinstance(b, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)) and isinstance(b, (list, tuple)):
        return (type(a) is type(b) and len(a) == len(b)
                and all(same(x, y) for x, y in zip(a, b)))
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return type(a) is type(b) and a == b


@pytest.mark.parametrize("overrides", OVERRIDES, ids=lambda o: " ".join(o)
                         or "none")
@pytest.mark.parametrize("path", CONFIGS + [None], ids=lambda p:
                         os.path.basename(p) if p else "no-yaml")
def test_load_config_matches_jax(path, overrides):
    j = JC.load_config(path, list(overrides))
    t = TC.load_config(path, list(overrides))
    assert same(j, t), (j, t)
    if "task=getup" in overrides:
        assert type(t.env).__name__ == "GetupEnvConfig"


@pytest.mark.parametrize("bad", ["env.no_such_field=1", "amp.bogus=2",
                                 "engine.warp=true", "traj.x=1"])
def test_unknown_key_raises_in_both(bad):
    with pytest.raises(KeyError):
        JC.load_config(None, [bad])
    with pytest.raises(KeyError, match="unknown"):
        TC.load_config(None, [bad])


VALUES = ["1e-5", "1.0e-3", "2.0e-5", "-1.5", ".5", "1.", "3.0e+2",
          "1_000", "0x1f", "017", "08", "0b11", "1:30", "-.inf", ".NaN",
          "true", "False", "yes", "off", "ON", "null", "~", "", "4", "-3",
          "+7", "abc", "a b", "a # c", "/tmp/run-1", "http://h:1/x",
          "'quoted # not a comment'", '"esc \\t \\u00e9"', "'it''s'",
          "[a, b]", "[1, 2.5, true, null]", "[]", "[[1, 2], [3]]",
          "[a , 'b c' ,]", "[x, 'y']  # c", "a: b", "--x", "-x"]


@pytest.mark.parametrize("text", VALUES)
def test_yaml_values_match_pyyaml(text):
    assert same(yaml.safe_load(text), TC.parse_yaml(text))


@pytest.mark.parametrize("path", CONFIGS, ids=os.path.basename)
def test_yaml_configs_match_pyyaml(path):
    with open(path) as f:
        text = f.read()
    assert same(yaml.safe_load(text), TC.parse_yaml(text))
    nested = ("a:\n  b:\n    c: 1  # x\n    d: 'q'\n  e: [1, 2]\n"
              "f:\n# comment\ng: ~\n")
    assert same(yaml.safe_load(nested), TC.parse_yaml(nested))


@pytest.mark.parametrize("text", [
    "- a\n- b", "a:\n  - 1", "a: &x 1", "b: *x", "a: !!str 1", "a: |\n  x",
    "a: >\n  x", "a: {b: 1}", "---\na: 1", "%YAML 1.1\na: 1",
    "a: 2001-01-01", "a: 1\n   b: 2", "a: [1, 2", "a: 'x", "a: [1,, 2]",
    "a:\n\tb: 1", "? a\n: b", "a: b: c"])
def test_yaml_outside_subset_raises(text):
    with pytest.raises(ValueError, match="YAML line"):
        TC.parse_yaml(text)
