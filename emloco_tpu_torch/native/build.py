"""Build the native helpers with g++ and load them with ctypes."""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile

_DIR = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(os.path.dirname(_DIR))
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_CACHE = {}


def library_path(name: str) -> str:
    """build/native-<hash of source and flags>/<name>.so under the root of
    the checkout."""
    with open(os.path.join(_DIR, f"{name}.cpp"), "rb") as f:
        h = hashlib.sha256(f.read())
    h.update(" ".join(FLAGS).encode())
    return os.path.join(_ROOT, "build", f"native-{h.hexdigest()[:16]}",
                        f"{name}.so")


def load_native(name: str) -> ctypes.CDLL:
    """emloco_tpu_torch/native/<name>.cpp compiled at first use and loaded
    once; a missing compiler or a failed build raises RuntimeError with the
    compiler's output."""
    if name in _CACHE:
        return _CACHE[name]
    src = os.path.join(_DIR, f"{name}.cpp")
    so_path = library_path(name)
    if not os.path.exists(so_path):
        cxx = shutil.which("g++") or shutil.which("c++")
        if cxx is None:
            raise RuntimeError(f"no C++ compiler (g++ or c++ on PATH) to "
                               f"build {src}")
        os.makedirs(os.path.dirname(so_path), exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so",
                                   dir=os.path.dirname(so_path))
        os.close(fd)
        try:
            proc = subprocess.run([cxx, *FLAGS, "-o", tmp, src],
                                  capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"building {src} failed ({proc.returncode})"
                                   f":\n{proc.stderr}{proc.stdout}")
            os.replace(tmp, so_path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    _CACHE[name] = ctypes.CDLL(so_path)
    return _CACHE[name]
