"""Run configuration: YAML + dotted overrides over the typed configs (port
of emloco_tpu/utils/config.py).

`load_config(yaml_path, overrides)` builds a `RunConfig` from an optional
YAML file and `key.subkey=value` overrides, rule for rule as the JAX
package's: an override may name any depth and its value is read as YAML;
`engine`, `traj` and `dr` nest into `env`; `task: getup` takes
`GetupEnvConfig`; an unknown key of a section raises `KeyError`; values keep
the type YAML gives them.

The card's machine has no pyyaml, so the port reads YAML itself
(`parse_yaml`): the subset that `configs/*.yaml` and override values use —
block mappings nested by indentation, `#` comments, plain, single- and
double-quoted strings, YAML 1.1's ints, floats, bools and nulls as pyyaml's
`safe_load` resolves them (so `1e-5`, which has no dot, stays a string, as
there), and flow sequences `[a, b]`. Anything else (block sequences, flow
mappings, anchors, tags, block scalars, documents, dates) raises
`ValueError` naming the line.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional

from ..envs.getup import GetupEnvConfig
from ..envs.pedestrian_terrain import DRConfig, EnvConfig
from ..envs.traj_gen import TrajConfig
from ..learning.amp_agent import AMPConfig
from ..learning.value_train import ValueTrainConfig
from ..physics.types import EngineConfig
from ..prediction.eqmotion import EqMotionConfig
from ..prediction.model import TransMotionConfig
from ..prediction.train import PredictTrainConfig


# ---------------------------------------------------------------------------
# the YAML subset
# ---------------------------------------------------------------------------

# pyyaml's YAML 1.1 implicit resolvers (resolver.py), for the tags below
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+"
                  r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TRUE = ("yes", "true", "on")
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t",
            "n": "\n", "v": "\v", "f": "\f", "r": "\r", "e": "\x1b",
            " ": " ", '"': '"', "/": "/", "\\": "\\", "N": "\x85",
            "_": "\xa0", "L": " ", "P": " "}
_HEX = {"x": 2, "u": 4, "U": 8}


class _Line:
    def __init__(self, num: int, text: str):
        self.num, self.text = num, text

    def error(self, what: str) -> ValueError:
        return ValueError(f"YAML line {self.num}: {what}: {self.text!r}")


def _sexagesimal(text: str, cast):
    digits = [cast(p) for p in text.split(":")]
    out, base = 0, 1
    for d in reversed(digits):
        out += d * base
        base *= 60
    return out


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t[0] == "-" else 1
    if t[0] in "+-":
        t = t[1:]
    if t == "0":
        return 0
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if t[0] == "0":
        return sign * int(t, 8)
    if ":" in t:
        return sign * _sexagesimal(t, int)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    sign = -1.0 if t[0] == "-" else 1.0
    if t[0] in "+-":
        t = t[1:]
    if t == ".inf":
        return sign * float("inf")
    if t == ".nan":
        return float("nan")
    if ":" in t:
        return sign * _sexagesimal(t, float)
    return sign * float(t)


def _plain(text: str, line: _Line):
    """A plain scalar as pyyaml's SafeLoader types it."""
    if (text[:1] in "&*!|>%@`{}[],#'\"" or text in ("=", "<<")
            or (text[:1] in "-?:" and text[1:2] in ("", " "))):
        raise line.error("outside the supported YAML subset")
    if ": " in text or text.endswith(":") or " #" in text:
        raise line.error("outside the supported YAML subset")
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return _int(text)
    if _FLOAT.match(text):
        return _float(text)
    if _TIMESTAMP.match(text):
        raise line.error("dates are outside the supported YAML subset")
    return text


def _quoted(text: str, i: int, line: _Line):
    """The quoted scalar starting at text[i]; returns (value, end index)."""
    q = text[i]
    out = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if c == q:
            if q == "'" and text[j + 1:j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            e = text[j + 1:j + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                j += 2
            elif e in _HEX:
                n = _HEX[e]
                code = text[j + 2:j + 2 + n]
                if len(code) != n or not re.fullmatch(r"[0-9a-fA-F]+", code):
                    raise line.error("bad escape")
                out.append(chr(int(code, 16)))
                j += 2 + n
            else:
                raise line.error("bad escape")
            continue
        out.append(c)
        j += 1
    raise line.error("unterminated quoted string (multi-line scalars are "
                     "outside the supported YAML subset)")


def _strip_comment(text: str, start: int) -> str:
    """text[start:] without a trailing comment (a # after whitespace or at
    the start)."""
    rest = text[start:]
    m = re.search(r"(^|\s)#", rest)
    return (rest[:m.start()] if m else rest).strip()


def _flow(text: str, i: int, line: _Line):
    """The flow sequence starting at text[i] == "["; returns (list, end)."""
    out = []
    j = i + 1
    expect_item = True
    while True:
        while j < len(text) and text[j] == " ":
            j += 1
        if j >= len(text):
            raise line.error("unterminated flow sequence (multi-line flow "
                             "sequences are outside the supported subset)")
        c = text[j]
        if c == "]":
            return out, j + 1
        if c == ",":
            if expect_item:
                raise line.error("empty flow sequence entry")
            expect_item = True
            j += 1
            continue
        if not expect_item:
            raise line.error("missing ',' in flow sequence")
        if c == "[":
            item, j = _flow(text, j, line)
        elif c in "'\"":
            item, j = _quoted(text, j, line)
        elif c == "{":
            raise line.error("flow mappings are outside the supported "
                             "YAML subset")
        else:
            m = re.compile(r"[^,\[\]{}]*").match(text, j)
            raw = m.group(0).rstrip()
            if " #" in raw:
                raise line.error("comment inside a flow sequence")
            item = _plain(raw, line)
            j = m.end()
        out.append(item)
        expect_item = False


def _value(text: str, line: _Line):
    """A scalar or flow sequence that makes up the whole of `text` (a
    comment after it allowed)."""
    t = text.strip()
    if not t:
        return None
    if t[0] in "'\"":
        v, end = _quoted(t, 0, line)
    elif t[0] == "[":
        v, end = _flow(t, 0, line)
    else:
        return _plain(_strip_comment(t, 0), line)
    if _strip_comment(t, end):
        raise line.error("text after a quoted scalar or flow sequence")
    return v


def _key(text: str, line: _Line):
    """Split "key: rest" → (key, rest) or None when the line is no key."""
    if text[0] in "'\"":
        key, end = _quoted(text, 0, line)
        if text[end:end + 1] != ":" or text[end + 1:end + 2] not in ("", " "):
            return None
        return key, text[end + 1:]
    m = re.match(r"([^#'\"\[\]{},][^:#]*?|):(?: |$)", text)
    if not m:
        return None
    key = m.group(1).rstrip()
    if not key:
        raise line.error("empty key")
    return _plain(key, line), text[m.end():]


def parse_yaml(text: str):
    """The value of a YAML document in the supported subset: a nested dict
    of block mappings, or one scalar or flow sequence; None when empty."""
    lines = []
    for num, raw in enumerate(text.splitlines(), 1):
        line = _Line(num, raw)
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise line.error("tab indentation")
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        if body in ("---", "...") or body.startswith(("--- ", "%")):
            raise line.error("document markers and directives are outside "
                             "the supported YAML subset")
        lines.append((len(raw) - len(raw.lstrip(" ")), body, line))
    if not lines:
        return None
    indent0, body0, line0 = lines[0]
    if _key(body0, line0) is None:
        if len(lines) > 1:
            raise lines[1][2].error("more than one top-level value")
        return _value(body0, line0)
    value, end = _mapping(lines, 0, indent0)
    if end != len(lines):
        raise lines[end][2].error("bad indentation")
    return value


def _mapping(lines, i, indent):
    """The block mapping at lines[i:] whose keys sit at `indent`."""
    out = {}
    while i < len(lines):
        ind, body, line = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise line.error("bad indentation")
        kv = _key(body, line)
        if kv is None:
            raise line.error("expected 'key: value' (block sequences and "
                             "other forms are outside the supported YAML "
                             "subset)")
        key, rest = kv
        i += 1
        if _strip_comment(rest, 0):
            out[key] = _value(rest, line)
        elif i < len(lines) and lines[i][0] > indent:
            out[key], i = _mapping(lines, i, lines[i][0])
        else:
            out[key] = None
    return out, i


# ---------------------------------------------------------------------------
# the run configuration
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunConfig:
    env: EnvConfig
    amp: AMPConfig
    value: ValueTrainConfig
    model: TransMotionConfig
    predict: PredictTrainConfig
    # env task family: "terrain", "getup" (fall recovery) or "hand"
    task: str = "terrain"
    seed: int = 0
    out_dir: str = "output/run"
    epochs: int = 1000
    save_every: int = 200
    terrain: dict = dataclasses.field(default_factory=dict)
    motions: Optional[str] = None        # motion pickle (None → synthetic)
    # SMPL model npz for mesh colliders; None → the committed fixture when
    # engine.mesh_contacts is on, else capsule bodies
    smpl_npz: Optional[str] = None
    real_traj_pkl: Optional[str] = None  # real-path bank (None → synthetic)
    ndjson: Optional[str] = None         # predictor scenes (None →
    ndjson_val: Optional[str] = None     # synthetic)
    eqmotion: Optional[EqMotionConfig] = None
    ethucy: Optional[str] = None         # ETH-UCY annotation files
    ethucy_val: Optional[str] = None


def _apply(cls, base, overrides: dict):
    if not overrides:
        return base
    known = {f.name for f in dataclasses.fields(cls)}
    bad = set(overrides) - known
    if bad:
        raise KeyError(f"unknown {cls.__name__} keys: {sorted(bad)}")
    return dataclasses.replace(base, **overrides)


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[list] = None) -> RunConfig:
    """Build a RunConfig from an optional YAML file plus dotted overrides
    like ["env.num_envs=1024", "amp.lr=2.0e-5"]."""
    raw: dict = {}
    if yaml_path:
        with open(yaml_path) as f:
            raw = parse_yaml(f.read()) or {}
    for ov in overrides or []:
        key, val = ov.split("=", 1)
        parts = key.split(".")
        d = raw
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = parse_yaml(val)

    engine = _apply(EngineConfig, EngineConfig(), raw.get("engine", {}))
    traj = _apply(TrajConfig, TrajConfig(), raw.get("traj", {}))
    dr = _apply(DRConfig, DRConfig(), raw.get("dr", {}))
    task = str(raw.get("task", "terrain"))
    env_cls = GetupEnvConfig if task == "getup" else EnvConfig
    env_over = dict(raw.get("env", {}))
    env = _apply(env_cls, env_cls(engine=engine, traj=traj, dr=dr), env_over)
    return RunConfig(
        env=env,
        task=task,
        amp=_apply(AMPConfig, AMPConfig(), raw.get("amp", {})),
        value=_apply(ValueTrainConfig, ValueTrainConfig(),
                     raw.get("value", {})),
        model=_apply(TransMotionConfig, TransMotionConfig(),
                     raw.get("model", {})),
        predict=_apply(PredictTrainConfig, PredictTrainConfig(),
                       raw.get("predict", {})),
        eqmotion=_apply(EqMotionConfig, EqMotionConfig(),
                        raw.get("eqmotion", {})),
        seed=int(raw.get("seed", 0)),
        out_dir=str(raw.get("out_dir", "output/run")),
        epochs=int(raw.get("epochs", 1000)),
        save_every=int(raw.get("save_every", 200)),
        terrain=raw.get("terrain", {}),
        motions=raw.get("motions"),
        smpl_npz=raw.get("smpl_npz"),
        real_traj_pkl=raw.get("real_traj_pkl"),
        ndjson=raw.get("ndjson"),
        ndjson_val=raw.get("ndjson_val"),
        ethucy=raw.get("ethucy"),
        ethucy_val=raw.get("ethucy_val"),
    )
