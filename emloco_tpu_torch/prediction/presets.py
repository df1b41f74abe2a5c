"""The predictor configurations of the repository's YAML files, as Python
dicts: the `model` and `predict` sections of configs/jta_predictor.yaml
(`jta`), configs/jrdb_predictor.yaml (`jrdb`) and configs/jta_lstm.yaml
(`lstm`). The entry points take one with `--preset`; fields not named here
keep TransMotionConfig's and PredictTrainConfig's defaults."""
from __future__ import annotations

import dataclasses

from .model import TransMotionConfig
from .train import PredictTrainConfig

_TRANSMOTION = dict(nhid=128, nhead=4, dim_ff=1024, nlayers_local=6,
                    nlayers_global=3, nmode=20, dropout=0.1,
                    multi_modal=True)
_EMLOCO = dict(lr=1.0e-4, lr_decay=0.1, lr_decay_epochs=20, grad_clip=1.0,
               use_value_loss=True, valueloss_weight=0.3)

PRESETS = {
    "jta": dict(model=dict(_TRANSMOTION), predict=dict(_EMLOCO)),
    # TransMotionJRDB: trajectory, 2D box and 3D pose (model_jrdb.py:12);
    # poses consumed as they are (train_jrdb.py:187)
    "jrdb": dict(model=dict(_TRANSMOTION, use_3dbb=False, use_2dpose=False),
                 predict=dict(_EMLOCO, pose_z_flip=False)),
    "lstm": dict(model=dict(arch="lstm", nhid=128, nmode=5, multi_modal=True,
                            output_scale=0.1),
                 predict=dict(lr=1.0e-3, lr_decay=0.5, lr_decay_epochs=15,
                              grad_clip=1.0, use_value_loss=False)),
}


def _typed(cls, default, fields: dict):
    out = {}
    for key, value in fields.items():
        if not hasattr(default, key):
            raise SystemExit(f"bad override {key!r}: {cls.__name__} has no "
                             "such field")
        kind = type(getattr(default, key))
        if isinstance(value, str) and kind is bool:
            value = value.lower() in ("1", "true", "yes")
        out[key] = kind(value)
    return dataclasses.replace(default, **out)


def configs(preset: str, overrides=()) -> tuple:
    """(TransMotionConfig, PredictTrainConfig) of `preset` with
    `model.<field>=<value>` and `predict.<field>=<value>` overrides, each
    value typed as its field's default."""
    p = PRESETS[preset]
    extra = {"model": {}, "predict": {}}
    for item in overrides:
        key, sep, value = item.partition("=")
        part, _, name = key.partition(".")
        if not sep or part not in extra or not name:
            raise SystemExit(f"bad override {item!r}: expected "
                             "model.<field>=<value> or "
                             "predict.<field>=<value>")
        extra[part][name] = value
    return (_typed(TransMotionConfig, _typed(
                TransMotionConfig, TransMotionConfig(), p["model"]),
                extra["model"]),
            _typed(PredictTrainConfig, _typed(
                PredictTrainConfig, PredictTrainConfig(), p["predict"]),
                extra["predict"]))
