"""ctypes bindings for the port's host runtime (``host/retinanet_host.cc``,
its own copy of the JAX package's ``native/retinanet_host.cc``).

The shared library is built with ``g++`` at first use into ``build/host/``
at the repository root (git-ignored), under a name that carries a hash of
the compiler, its flags, the source and the host (``-march=native`` code
runs on the CPU it was built for), and loaded with ``ctypes``.  Unlike the
JAX module, a failed build or load raises, naming the compiler's error:
nothing falls back to numpy behind the caller's back.  The numpy path of
``data.pipeline.process_sample`` stays for a caller that asks for it
(``use_native=False``).  Nothing is built at import time.

Binds the one entry point the port calls, the fused resize+normalize of
``data.pipeline.process_sample``.  The source's other entry points
(``rn_iou_matrix``, ``rn_nms``) stay unbound: the copy keeps the JAX
package's code as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SOURCE = Path(__file__).resolve().parent / "host" / "retinanet_host.cc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "build" / "host"
# The JAX package's flags (``retinanet_tpu/native.py:_build``).
CXX_FLAGS = ("-O3", "-march=native", "-fno-math-errno", "-std=c++17",
             "-shared", "-fPIC", "-pthread")


class HostLibrary:
    """``source`` compiled by ``compiler`` into ``build_dir`` on first use."""

    def __init__(self, source: Path = SOURCE, build_dir: Path = BUILD_DIR,
                 compiler: str = "g++"):
        self.source = Path(source)
        self.build_dir = Path(build_dir)
        self.compiler = compiler
        self._lock = threading.Lock()
        self._lib: Optional[ctypes.CDLL] = None

    def _path(self) -> Path:
        digest = hashlib.sha256(" ".join(
            (self.compiler, *CXX_FLAGS, platform.node(),
             platform.machine())).encode())
        digest.update(self.source.read_bytes())
        return self.build_dir / (f"lib{self.source.stem}-"
                                 f"{digest.hexdigest()[:16]}.so")

    def build(self) -> Path:
        """Compile if the hashed library is missing; returns its path."""
        path = self._path()
        if path.exists():
            return path
        self.build_dir.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=self.build_dir)
        os.close(fd)
        try:
            try:
                proc = subprocess.run(
                    [self.compiler, *CXX_FLAGS, str(self.source), "-o", tmp],
                    capture_output=True, text=True, timeout=120)
            except (OSError, subprocess.SubprocessError) as err:
                raise RuntimeError(f"cannot build {self.source.name} with "
                                   f"{self.compiler!r}: {err}") from err
            if proc.returncode != 0:
                raise RuntimeError(f"{self.compiler} failed on "
                                   f"{self.source.name}:\n{proc.stderr}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
        return path

    @property
    def lib(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                path = self.build()
                try:
                    lib = ctypes.CDLL(str(path))
                except OSError as err:
                    raise RuntimeError(f"cannot load {path}: {err}") from err
                u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
                f32p = np.ctypeslib.ndpointer(np.float32,
                                              flags="C_CONTIGUOUS")
                lib.rn_resize_normalize.argtypes = [
                    u8p, ctypes.c_int, ctypes.c_int, f32p, ctypes.c_int,
                    ctypes.c_int, ctypes.c_int, ctypes.c_int, f32p, f32p,
                    ctypes.c_int]
                lib.rn_resize_normalize.restype = None
                self._lib = lib
            return self._lib


LIB = HostLibrary()


def resize_normalize(image: np.ndarray, canvas_size, nh: int, nw: int,
                     mean: np.ndarray, std: np.ndarray,
                     num_threads: int = 2) -> np.ndarray:
    """Fused resize(nh,nw)+normalize+pad to an [H, W, 3] f32 canvas
    (``canvas_size``: int for square or an (h, w) pair)."""
    lib = LIB.lib
    if isinstance(canvas_size, (tuple, list)):
        ch, cw = int(canvas_size[0]), int(canvas_size[1])
    else:
        ch = cw = int(canvas_size)
    image = np.ascontiguousarray(image, np.uint8)
    out = np.empty((ch, cw, 3), np.float32)
    lib.rn_resize_normalize(
        image, image.shape[0], image.shape[1], out, ch, cw,
        nh, nw, np.ascontiguousarray(mean, np.float32),
        np.ascontiguousarray(std, np.float32), num_threads)
    return out

