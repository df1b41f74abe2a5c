"""The port does all that the JAX package does: every public top-level
function and class of each source file of `emloco_tpu/`, every public
method (and `__init__`), every dataclass field and every parameter of
these has its counterpart at the same path in `emloco_tpu_torch/`, or is
an entry of DESIGN, the table of differences by design, each with the
record that gives its reason.

Both packages are read with `ast`; neither is imported. A JAX field is
matched by a port field, method or `__init__` parameter of that name (a
flax module's fields are a torch module's constructor arguments); a port
class's members include those it inherits from the port's classes.
"""
import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "emloco_tpu"
PORT = ROOT / "emloco_tpu_torch"
# JAX file → the port's file at another path
MOVED = {"physics/pallas_linalg.py": "physics/linalg.py"}

KEY = ("a jax.random key; the port draws from a torch.Generator or a seed "
       "(ROADMAP.md §C, hazards: jax.random streams cannot be reproduced)")
PALLAS = ("a Pallas tiling or interpret-mode option; physics/pallas_linalg.py"
          " → physics/linalg.py + csrc/ (ROADMAP.md §C, surface)")
SETUP = "flax's setup is nn.Module.__init__ (ROADMAP.md §C, surface)"
TRACING = ("the port's tracing is `utils.profiling.annotate`; no reader "
           "(utils/profiling.py)")

# (JAX file, item) → reason. Items: `name`, `Class.member`, `name(param)`,
# `Class.method(param)`.
DESIGN = {
    ("analysis/plausibility.py", "sample_candidate_trajs(key)"): KEY,
    ("envs/getup.py", "PedestrianTerrainGetupEnv.reset(key)"): KEY,
    ("envs/hand_task.py", "PedestrianTerrainHandEnv.reset(key)"): KEY,
    ("envs/observations.py", "amp_dropout_mask(key)"):
        "the port takes the draw u (amp_dropout_draw), not a key "
        "(ROADMAP.md §C, surface)",
    ("envs/observations.py", "amp_dropout_mask(batch)"):
        "the batch is u's first dimension (ROADMAP.md §C, surface)",
    ("envs/pedestrian_terrain.py", "PedestrianTerrainEnv.reset(key)"): KEY,
    ("envs/pedestrian_terrain.py",
     "PedestrianTerrainEnv.fetch_amp_obs_demo(key)"): KEY,
    ("envs/traj_gen.py", "procedural_verts(key)"): KEY,
    ("envs/traj_gen.py", "sample_traj(key)"): KEY,
    ("kinematics/motion_lib.py", "sample_motions(key)"): KEY,
    ("kinematics/motion_lib.py", "sample_time(key)"): KEY,
    ("learning/amp_agent.py", "TrainState.key"): KEY,
    ("learning/amp_agent.py", "AMPAgent.init(key)"): KEY,
    ("learning/networks.py", "AMPSeptValueNet.setup"): SETUP,
    ("learning/networks.py", "AMPSeptCNNNet.setup"): SETUP,
    ("learning/networks.py", "embodied_motion_loss(value_fn_apply)"):
        "the port takes the valuenet module (ROADMAP.md §C, surface)",
    ("learning/networks.py", "embodied_motion_loss(params)"):
        "the module holds its parameters (ROADMAP.md §C, surface)",
    ("learning/value_train.py", "ValueTrainState.key"): KEY,
    ("learning/value_train.py", "LocoValTrainer.init(key)"): KEY,
    ("parallel/mesh.py", "shard_env_axis(axis)"):
        "a JAX mesh axis name; the port's Mesh holds its process group "
        "(ROADMAP.md §C, surface)",
    ("parallel/mesh.py", "pmean_metrics(axis)"):
        "a JAX mesh axis name; the port's Mesh holds its process group "
        "(ROADMAP.md §C, surface)",
    ("physics/pallas_linalg.py", "cholesky_solve_soa_t(interpret)"): PALLAS,
    ("physics/pallas_linalg.py", "cholesky_solve_soa(interpret)"): PALLAS,
    ("physics/pallas_linalg.py", "cholesky_solve_blocked_t(interpret)"):
        PALLAS,
    ("physics/pallas_linalg.py", "cholesky_factor_blocked_t(interpret)"):
        PALLAS,
    ("physics/pallas_linalg.py", "cholesky_resolve_blocked_t(interpret)"):
        PALLAS,
    ("physics/pallas_linalg.py", "to_env_last(block_rows)"): PALLAS,
    ("physics/pallas_linalg.py", "to_env_last(interpret)"): PALLAS,
    ("physics/pallas_linalg.py", "cholesky_solve_blocked(interpret)"): PALLAS,
    ("physics/pallas_linalg.py", "cholesky_factor_blocked(interpret)"):
        PALLAS,
    ("physics/pallas_linalg.py", "cholesky_resolve_blocked(interpret)"):
        PALLAS,
    ("physics/pallas_linalg.py", "gram_diag(block_envs)"): PALLAS,
    ("physics/pallas_linalg.py", "gram_diag(interpret)"): PALLAS,
    ("physics/pallas_linalg.py", "backend_supports_pallas"):
        "whether the JAX backend runs Pallas; the port's kernels run on "
        "every card (ROADMAP.md §C, surface)",
    ("physics/terrain.py", "Heightfield.min2_tex"):
        "a TPU VMEM table, emloco_tpu/physics/terrain.py:98-124 "
        "(ROADMAP.md, corner-texture gather)",
    ("prediction/eqmotion.py", "EqMotionTrainState.key"): KEY,
    ("prediction/eqmotion.py", "EqMotionTrainer.init(key)"): KEY,
    ("prediction/eqmotion.py", "synthetic_eth_batch(key)"): KEY,
    ("prediction/eqmotion.py", "synthetic_nbody_batch(key)"): KEY,
    ("prediction/eqmotion.py", "synthetic_h36m_batch(key)"): KEY,
    ("prediction/eqmotion.py", "synthetic_md17_batch(key)"): KEY,
    ("prediction/eqmotion.py", "ethucy_batches(key)"): KEY,
    ("prediction/eqmotion_full.py", "FeatureLayer.setup"): SETUP,
    ("prediction/eqmotion_full.py", "EqMotionFull.setup"): SETUP,
    ("prediction/eqmotion_full.py", "EqMotionFullEth.setup"): SETUP,
    ("prediction/eqmotion_full.py", "transplant_from_torch"):
        "the port loads a reference state_dict itself "
        "(convert.eqmotion_full_params; ROADMAP.md §C, surface)",
    ("prediction/eqmotion_full.py", "EqMotionFullTrainer.init(key)"): KEY,
    ("prediction/model.py", "EncoderLayer.dropout"):
        "the rate is dropout_rate: the module's function dropout holds the "
        "name (ROADMAP.md §C, surface)",
    ("prediction/model.py", "EncoderStack"):
        "a scan over layers; the port writes the layers out "
        "(encoder_stack; ROADMAP.md §C, surface)",
    ("prediction/train.py", "PredictTrainState.key"): KEY,
    ("prediction/train.py", "PredictorTrainer.init(key)"): KEY,
    ("prediction/train.py", "PredictorTrainer.fit(log_every)"):
        "accepted and never read by the JAX trainer (ROADMAP.md §C, surface)",
    ("utils/logging.py", "SegmentTimer"): TRACING,
    ("utils/profiling.py", "device_timer"): TRACING,
}

JAX_FILES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _top(body):
    """A module's or class's statements, with those under `if` and `try`."""
    for n in body:
        if isinstance(n, ast.If):
            yield from _top(n.body)
            yield from _top(n.orelse)
        elif isinstance(n, ast.Try):
            yield from _top(n.body)
            for h in n.handlers:
                yield from _top(h.body)
            yield from _top(n.orelse)
        else:
            yield n


def _params(fn):
    a = fn.args
    names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
    names += ["*" + a.vararg.arg] if a.vararg else []
    names += ["**" + a.kwarg.arg] if a.kwarg else []
    return [n for n in names if n not in ("self", "cls")]


def _public(name):
    return not name.startswith("_")


def surface(path):
    """{name: params} for public functions and {name: (members, bases)} for
    public classes; members map a method to its params and a field to
    None."""
    funcs, classes = {}, {}
    for n in _top(ast.parse(path.read_text()).body):
        if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if _public(n.name):
                funcs[n.name] = _params(n)
        elif isinstance(n, ast.ClassDef) and _public(n.name):
            members = {}
            for m in _top(n.body):
                if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    if _public(m.name) or m.name == "__init__":
                        members[m.name] = _params(m)
                elif (isinstance(m, ast.AnnAssign)
                      and isinstance(m.target, ast.Name)):
                    members[m.target.id] = None
            bases = [b.id if isinstance(b, ast.Name) else getattr(b, "attr",
                                                                  None)
                     for b in n.bases]
            classes[n.name] = (members, bases)
    return funcs, classes


def port_classes():
    """Every class of the port: name → [(module, members, bases)]."""
    out = {}
    for p in PORT.rglob("*.py"):
        for name, (members, bases) in surface(p)[1].items():
            out.setdefault(name, []).append((p, members, bases))
    return out


PORT_CLASSES = port_classes()


def members_of(path, name, seen=()):
    """A port class's members with those it inherits from port classes (a
    base is looked up in its module first, then wherever the port defines
    a class of that name once)."""
    defs = PORT_CLASSES.get(name, [])
    here = [d for d in defs if d[0] == path] or (defs if len(defs) == 1
                                                else [])
    if not here or name in seen:
        return {}
    p, members, bases = here[0]
    out = {}
    for b in bases:
        out.update(members_of(p, b, seen + (name,)))
    out.update(members)
    return out


def differences(rel):
    """The JAX file's items without a counterpart in the port."""
    port = PORT / MOVED.get(rel, rel)
    if not port.exists():
        return {rel}
    j_funcs, j_classes = surface(JAX / rel)
    p_funcs, p_classes = surface(port)
    out = set()
    for name, params in j_funcs.items():
        if name not in p_funcs:
            out.add(name)
            continue
        out |= {f"{name}({a})" for a in params if a not in p_funcs[name]}
    for name, (members, _) in j_classes.items():
        if name not in p_classes:
            out.add(name)
            continue
        have = members_of(port, name)
        init = have.get("__init__") or []
        for m, params in members.items():
            if params is None:
                if m not in have and m not in init:
                    out.add(f"{name}.{m}")
            elif m not in have:
                out.add(f"{name}.{m}")
            else:
                out |= {f"{name}.{m}({a})" for a in params
                        if a not in (have[m] or [])}
    return out


@pytest.mark.parametrize("rel", JAX_FILES)
def test_port_has_the_jax_surface(rel):
    """Every item of the JAX file has its counterpart or its DESIGN entry,
    and every DESIGN entry of the file is still a difference."""
    table = {item for (f, item) in DESIGN if f == rel}
    found = differences(rel)
    assert not found - table, f"{rel}: not in the port: {sorted(found - table)}"
    assert not table - found, f"{rel}: stale DESIGN entries: " \
        f"{sorted(table - found)}"


def test_design_entries_name_their_record():
    """Each entry is a JAX file with a one-line reason naming where the
    difference is recorded."""
    for (rel, item), reason in DESIGN.items():
        assert rel in JAX_FILES, rel
        assert "\n" not in reason and ("ROADMAP.md" in reason
                                       or ".py" in reason), (rel, item)
