"""Build the port's CUDA kernels with nvcc and load them with ctypes.

The sources in csrc/ have a plain C interface and include no PyTorch header,
so nvcc builds them in seconds (PyTorch's cpp_extension builder would pull in
its headers and take minutes). One nvcc per source runs at the same time,
then one more links the objects into a single library. It lands in `build/`
at the root of the checkout, under a directory named by a hash of the
sources, headers and flags, and is built at first use; a missing nvcc or a
failed build raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_PKG = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_PKG)
_CSRC = os.path.join(_PKG, "csrc")
SOURCES = tuple(os.path.join(_CSRC, f) for f in (
    "block_arrow_cholesky.cu", "block_arrow_solve.cu", "dense_cholesky.cu",
    "to_env_last.cu", "gram_diag.cu", "gram_dual.cu", "clip_adam.cu"))
HEADERS = tuple(os.path.join(_CSRC, f) for f in (
    "block_arrow.cuh", "async_copy.cuh"))
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
# -fmad=false: the kernels repeat their plain versions' roundings exactly
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-fmad=false",
         "-Xptxas", "-v")
LIB_NAME = "libemloco_kernels.so"

_VP = ctypes.c_void_p
_INT = ctypes.c_int
_I64 = ctypes.c_longlong
_F64 = ctypes.c_double
_SIGNATURES = {
    "emloco_block_arrow_factor":
        [_VP, _VP, _INT, _INT, _VP, _INT, _VP, _INT, _VP],
    "emloco_block_arrow_factor_shape": [_INT, _VP, _INT, _VP, _INT, _VP],
    "emloco_block_arrow_resolve":
        [_VP, _VP, _VP, _INT, _INT, _VP, _INT, _VP, _INT, _VP],
    "emloco_block_arrow_solve":
        [_VP, _VP, _VP, _INT, _INT, _VP, _INT, _VP, _INT, _VP],
    "emloco_block_arrow_solve_shape": [_INT, _VP, _INT, _VP, _INT, _VP],
    "emloco_block_arrow_resolve_bm":
        [_VP, _VP, _VP, _INT, _INT, _VP, _INT, _VP, _INT, _VP],
    "emloco_dense_cholesky_solve": [_VP, _VP, _VP, _INT, _INT, _VP],
    "emloco_dense_cholesky_shape": [_INT, _VP],
    "emloco_to_env_last": [_VP, _VP, _INT, _INT, _INT, _VP],
    "emloco_gram_diag":
        [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _INT, _VP],
    "emloco_gram_diag_shape": [_INT, _INT, _VP],
    "emloco_gram_dual": [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    "emloco_gram_dual_batched":
        [_VP, _VP, _VP, _VP, _INT, _INT, _INT, _INT, _VP],
    "emloco_clip_adam": [_INT, _INT, _VP, _VP, _VP, _I64, _VP, _VP, _F64,
                         _F64, _INT, _F64, _INT, _VP, _VP],
    "emloco_clip_adam_shape": [_VP],
}

_loaded = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin or "
                           "/usr/local/cuda/bin): the CUDA kernels of "
                           "emloco_tpu_torch cannot be built")
    return path


def _tag() -> str:
    h = hashlib.sha256()
    for src in (*SOURCES, *HEADERS):
        with open(src, "rb") as f:
            h.update(f.read())
    h.update(" ".join(FLAGS).encode())
    return h.hexdigest()[:16]


def build() -> tuple[str, str]:
    """Compile the sources into build/<hash>/ if not there yet. Returns
    (library path, nvcc's output — empty when the library already existed)."""
    out_dir = os.path.join(_ROOT, "build", f"emloco_kernels-{_tag()}")
    lib_path = os.path.join(out_dir, LIB_NAME)
    if os.path.exists(lib_path):
        return lib_path, ""
    os.makedirs(out_dir, exist_ok=True)
    nvcc = nvcc_path()
    work = tempfile.mkdtemp(dir=out_dir)
    try:
        objs = [os.path.join(work, os.path.basename(src) + ".o")
                for src in SOURCES]
        cmds = [[nvcc, *FLAGS, "-c", "-o", obj, src]
                for src, obj in zip(SOURCES, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for cmd in cmds]
        log = [(cmd, proc.communicate()[0], proc.returncode)
               for cmd, proc in zip(cmds, procs)]
        tmp = os.path.join(work, LIB_NAME)
        link = [nvcc, *ARCH, "-shared", "-o", tmp, *objs]
        if all(rc == 0 for _, _, rc in log):
            proc = subprocess.run(link, capture_output=True, text=True)
            log.append((link, proc.stdout + proc.stderr, proc.returncode))
        failed = [(cmd, out, rc) for cmd, out, rc in log if rc != 0]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(
                f"({rc}) {' '.join(cmd)}\n{out}" for cmd, out, rc in failed))
        os.replace(tmp, lib_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib_path, "".join(out for _, out, _ in log)


def load() -> ctypes.CDLL:
    """The kernels' library, built on first use and loaded once."""
    if "lib" not in _loaded:
        lib = ctypes.CDLL(build()[0])
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _loaded["lib"] = lib
    return _loaded["lib"]
