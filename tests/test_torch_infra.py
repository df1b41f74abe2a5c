"""The port's infrastructure against the JAX package's: TensorBoard event
files byte for byte, the metrics logger's rows and stderr line, the
profiling hooks on the CPU, and the native C++ helpers (the same sources,
the same outputs; and against the port's numpy versions)."""
import filecmp
import json
import os

import numpy as np
import pytest
import torch

from emloco_tpu.native import build as JNB
from emloco_tpu.native import ndjson as JND
from emloco_tpu.native import terrain as JNT
from emloco_tpu.utils import logging as JL
from emloco_tpu.utils import tracking as JT
from emloco_tpu_torch import native as TN
from emloco_tpu_torch.native import build as TNB
from emloco_tpu_torch.physics import mesh_terrain as tmesh
from emloco_tpu_torch.physics import terrain as tterrain
from emloco_tpu_torch.prediction.data import read_ndjson_scenes
from emloco_tpu_torch.utils import logging as TL
from emloco_tpu_torch.utils import profiling as TP
from emloco_tpu_torch.utils import tracking as TT

# one torch thread per process: the test workers share the cores, and a
# worker that spawned a thread per core would oversubscribe them
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "data", "jta_all_cues_fixture.ndjson")
SCALARS = [(1, {"loss/total": 1.25, "reward/loc": 0.5}),
           (2, {"loss/total": 0.75}), (300, {"x": -3.0e-7, "y": 1e30})]


class Clock:
    """A stand-in for the `time` module: time() and perf_counter() tick
    by 0.25 s from fixed origins."""

    def __init__(self):
        self.t, self.p = 1_700_000_000.0, 100.0

    def time(self):
        self.t += 0.25
        return self.t

    def perf_counter(self):
        self.p += 0.25
        return self.p


def frozen(monkeypatch, *modules):
    for m in modules:
        monkeypatch.setattr(m, "time", Clock())


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_event_files_byte_equal_and_cross_read(tmp_path, monkeypatch,
                                               writer):
    frozen(monkeypatch, JT, TT)
    paths = []
    for mod, d in ((JT, "j"), (TT, "t")):
        w = mod.TBWriter(str(tmp_path / d), filename_suffix=".run")
        for step, vals in SCALARS:
            w.scalars(step, vals)
        w.close()
        paths.append(w.path)
    assert os.path.basename(paths[0]) == os.path.basename(paths[1])
    assert filecmp.cmp(*paths, shallow=False)
    path = paths[0] if writer == "jax" else paths[1]
    want = [(s, k, float(np.float32(v))) for s, vals in SCALARS
            for k, v in vals.items()]
    assert list(JT.read_scalars(path)) == want
    assert list(TT.read_scalars(path)) == want


def test_event_reader_checks_crcs(tmp_path):
    w = TT.TBWriter(str(tmp_path))
    w.scalars(1, {"a": 1.0})
    w.close()
    data = bytearray(open(w.path, "rb").read())
    data[-6] ^= 1                                  # a payload byte
    bad = tmp_path / "bad"
    bad.write_bytes(bytes(data))
    with pytest.raises(ValueError, match="crc"):
        list(TT.read_scalars(str(bad)))


def test_metrics_logger_matches_jax(tmp_path, monkeypatch, capsys):
    frozen(monkeypatch, JT, TT, JL, TL)
    outs = []
    for mod, d, cast in ((JL, "j", np.float32), (TL, "t", torch.tensor)):
        log = mod.MetricsLogger(str(tmp_path / d), "policy", print_every=2)
        log.log(0, {"a_loss": cast(0.5), "d_loss": 0.25, "note": "x"})
        log.log(1, {"a_loss": cast(1.5)})
        log.log(2, {"a_loss": cast(-2.0)}, prefix="eval/")
        log.close()
        outs.append((capsys.readouterr().err, log._tb.path))
    (err_j, tb_j), (err_t, tb_t) = outs
    assert err_j == err_t and err_t.count("\n") == 2
    rows = [open(tmp_path / d / "policy.metrics.jsonl").read()
            for d in "jt"]
    assert rows[0] == rows[1]
    first = json.loads(rows[1].splitlines()[0])
    assert first["step"] == 0 and first["note"] == "x" and first["wall_s"]
    assert filecmp.cmp(tb_j, tb_t, shallow=False)


def test_profiling_on_cpu(tmp_path):
    """trace() writes a Chrome trace holding the program's spans as
    `emloco:` ranges beside the operations inside them."""
    a = torch.randn(64, 64)
    with TP.trace(str(tmp_path / "trace")) as d:
        with TP.annotate("physics.step"):
            (a @ a).sum()
    with open(os.path.join(d, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events}
    assert "emloco:physics.step" in names and "aten::mm" in names
    assert [r[0] for r in TP.records()] == ["physics.step"]


# ---------------------------------------------------------------------------
# the native helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["terrain_native", "ndjson_native"])
def test_native_sources_are_the_jax_packages(name):
    assert filecmp.cmp(os.path.join(ROOT, "emloco_tpu", "native",
                                    f"{name}.cpp"),
                       os.path.join(ROOT, "emloco_tpu_torch", "native",
                                    f"{name}.cpp"), shallow=False)
    lib = TN.load_native(name)
    assert lib is TN.load_native(name)
    assert TNB.library_path(name).startswith(os.path.join(ROOT, "build"))


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( {\n")
    monkeypatch.setattr(TNB, "_DIR", str(tmp_path))
    monkeypatch.setattr(TNB, "_ROOT", str(tmp_path))
    with pytest.raises(RuntimeError, match="error"):
        TNB.load_native("broken")


def _heights(seed):
    rng = np.random.RandomState(seed)
    h = rng.rand(64, 80).astype(np.float32) * 0.02
    h[20:30, 20:34] = 2.0                           # a steep block
    h[40:, 50:] += np.linspace(0, 3, 30, dtype=np.float32)  # a slope
    return h


@pytest.mark.parametrize("seed", [0, 1])
def test_walkable_mask_native(seed):
    h = _heights(seed)
    m = TN.fast_walkable_mask(h, 0.1, 0.5, 3)
    assert m.dtype == bool and 0 < m.sum() < m.size
    np.testing.assert_array_equal(m, JNT.fast_walkable_mask(h, 0.1, 0.5, 3))
    np.testing.assert_array_equal(m, tterrain.walkable_mask(h, 0.1, 0.5, 3))


@pytest.mark.parametrize("max_pts", [65536, 300])
def test_spawn_table_native(max_pts):
    assert JNB.load_native("terrain_native") is not None
    mask = tterrain.walkable_mask(_heights(0), 0.1)
    origin = (-3.2, -4.0)
    xy = TN.fast_spawn_table(mask, 0.1, origin, max_pts=max_pts, seed=7)
    np.testing.assert_array_equal(
        xy, JNT.fast_spawn_table(mask, 0.1, origin, max_pts=max_pts,
                                 seed=7))
    if max_pts >= mask.sum():
        # every walkable cell, in another order; the numpy version rounds
        # x·cell + origin once from float64, the C++ one twice in float32
        # (§C): within 1 float32 ulp of the larger of the two terms
        ref = tterrain.spawn_table(mask, 0.1, origin, max_pts=max_pts)
        a, b = xy[np.lexsort(xy.T)], ref[np.lexsort(ref.T)]
        assert a.shape == b.shape == (mask.sum(), 2)
        o = np.asarray(origin, np.float32)
        ulp = np.spacing(np.maximum(np.abs(b - o), np.abs(o)))
        assert (np.abs(a - b) <= ulp).all()
        assert (a != b).any()
    else:
        assert xy.shape == (max_pts, 2)
    empty = TN.fast_spawn_table(np.zeros((4, 4), bool), 0.1, origin)
    assert empty.shape == (1, 2)


def _mesh():
    rng = np.random.RandomState(3)
    g = np.stack(np.meshgrid(np.linspace(-2, 2, 9), np.linspace(-2, 2, 9),
                             indexing="ij"), -1).reshape(-1, 2)
    z = 0.3 * np.sin(g[:, :1] * 1.3) + 0.05 * rng.rand(len(g), 1)
    verts = np.concatenate([g, z], 1).astype(np.float32)
    faces = []
    for i in range(8):
        for j in range(8):
            a, b, c, d = i * 9 + j, (i + 1) * 9 + j, i * 9 + j + 1, \
                (i + 1) * 9 + j + 1
            faces += [(a, b, c), (b, d, c)]
    return verts, np.asarray(faces, np.int32)


def test_rasterize_trimesh_native():
    verts, faces = _mesh()
    args = (48, 40, 0.1, (-2.5, -2.1))
    h, cover = TN.fast_rasterize_trimesh(verts, faces, *args)
    hj, cj = JNT.fast_rasterize_trimesh(verts, faces, *args)
    np.testing.assert_array_equal(h, hj)
    np.testing.assert_array_equal(cover, cj)
    hn, cn = tmesh.rasterize_trimesh_np(verts, faces, *args)
    np.testing.assert_array_equal(cover, cn)
    assert 0 < cover.sum() < cover.size
    # the C++ version works in float32, the numpy one in float64
    np.testing.assert_allclose(h[cover], hn[cover], rtol=0, atol=2e-6)


def test_ndjson_native_matches_jax_and_plain():
    fp, xy, sc = TN.read_ndjson_fast(FIXTURE)
    jfp, jxy, jsc, _ = JND.read_ndjson_fast(FIXTURE)
    for a, b in ((fp, jfp), (xy, jxy), (sc, jsc)):
        np.testing.assert_array_equal(a, b)
    scenes = TN.scenes_to_arrays(fp, xy, sc)
    ref = read_ndjson_scenes(FIXTURE)
    assert len(scenes) == len(ref) == len(sc) > 1
    for a, b in zip(scenes, ref):
        np.testing.assert_array_equal(a, b)
    # the JAX package's scenes_to_arrays takes bool() of a per-frame array
    # and raises on every scene longer than one frame (ROADMAP §C)
    with pytest.raises(ValueError, match="truth value"):
        JND.scenes_to_arrays(jfp, jxy, jsc)
    with pytest.raises(IOError):
        TN.read_ndjson_fast(os.path.join(ROOT, "no_such.ndjson"))


def test_ndjson_native_drops_scene_without_primary(tmp_path):
    rows = [{"track": {"f": f, "p": p, "x": 0.1 * f * p, "y": -0.2 * f}}
            for f in range(10) for p in (1, 2)]
    rows.append({"track": {"f": 3, "p": 5, "x": 1.0, "y": 1.0}})
    rows += [{"scene": {"id": 0, "p": 1, "s": 0, "e": 9}},
             {"scene": {"id": 1, "p": 5, "s": 2, "e": 4}},
             {"scene": {"id": 2, "p": 2, "s": 4, "e": 8}}]
    path = tmp_path / "s.ndjson"
    path.write_text("".join(json.dumps(r) + "\n" for r in rows))
    scenes = TN.scenes_to_arrays(*TN.read_ndjson_fast(str(path)))
    ref = read_ndjson_scenes(str(path))
    assert [s.shape for s in scenes] == [(10, 2, 2), (5, 2, 2)]
    for a, b in zip(scenes, ref):
        np.testing.assert_array_equal(a, b)
