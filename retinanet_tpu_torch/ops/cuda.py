"""Build and load the hand-written CUDA kernels of ``ops/csrc``.

Each ``.cu`` file has a plain C interface and is compiled by ``nvcc`` into
its own shared library under ``build/kernels/`` at the repository root
(listed in ``.gitignore``), at first use, then loaded with ``ctypes``.  The
library name carries a hash of the flags, the source and every ``csrc``
header it includes, so an edited source or header rebuilds and an
unchanged one is reused.  Nothing is built at import time:
the CPU tests import every module of the port.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# sm_90a for Hopper; -fmad=false keeps multiplies and adds separately
# rounded (the bf16 GN affine and the NMS IoU must match their plain
# versions); no fast math.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")


def local_headers(source: Path) -> List[Path]:
    """Every header of ``csrc`` that ``source`` includes with quotes,
    directly or through another header, in the order first included."""
    found: List[Path] = []
    pending = [source]
    while pending:
        text = pending.pop(0).read_text()
        for name in re.findall(r'^\s*#\s*include\s+"([^"]+)"', text, re.M):
            path = CSRC / name
            if path not in found:
                found.append(path)
                pending.append(path)
    return found


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


class KernelLibrary:
    """One ``csrc/<source>`` compiled to a ``.so`` on first use.

    ``functions`` maps each exported C function to its ``argtypes``; every
    one returns the ``int`` of its first ``cudaGetLastError()``.
    """

    def __init__(self, source: str, functions: Dict[str, Sequence]):
        self.source = CSRC / source
        self.functions = functions
        self._lib: Optional[ctypes.CDLL] = None
        self.ptxas_log = ""

    def _path(self) -> Path:
        digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for path in [self.source, *local_headers(self.source)]:
            digest.update(path.read_bytes())
        return BUILD_DIR / f"{self.source.stem}-{digest.hexdigest()[:16]}.so"

    def build(self) -> Path:
        """Compile if the hashed library is missing; returns its path and
        keeps ``nvcc``'s register/shared-memory report in ``ptxas_log``."""
        path = self._path()
        log_path = path.with_suffix(".ptxas.txt")
        if not path.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
            os.close(fd)
            try:
                proc = subprocess.run(
                    [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(self.source)],
                    capture_output=True, text=True)
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source.name}:\n{proc.stderr}")
                log_path.write_text(proc.stdout + proc.stderr)
                os.replace(tmp, path)
            finally:
                if os.path.exists(tmp):
                    os.unlink(tmp)
        self.ptxas_log = log_path.read_text() if log_path.exists() else ""
        return path

    @property
    def lib(self) -> ctypes.CDLL:
        if self._lib is None:
            lib = ctypes.CDLL(str(self.build()))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = list(argtypes)
                fn.restype = ctypes.c_int
            self._lib = lib
        return self._lib

    def call(self, name: str, *args) -> None:
        """Launch on the current stream's work queue; raises on a refused
        launch (``cudaGetLastError`` != 0)."""
        err = getattr(self.lib, name)(*args)
        if err != 0:
            raise RuntimeError(f"{self.source.name}:{name} launch failed "
                               f"with cudaError {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


_TICKETS: Dict[Tuple[int, int], torch.Tensor] = {}


def tickets(device: torch.device, count: int) -> torch.Tensor:
    """At least ``count`` zero int32 words on ``device`` for the kernels'
    per-image "last CTA finalizes" tickets (B1, B3, B4, B5): one buffer per
    device and stream, which every launch leaves zero."""
    key = (device.index, stream_ptr(device))
    buf = _TICKETS.get(key)
    if buf is None or buf.numel() < count:
        buf = _TICKETS[key] = torch.zeros(max(count, 64), dtype=torch.int32,
                                          device=device)
    return buf


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` whose
    data starts on a 16-byte boundary (the kernels load 16 bytes at a
    time)."""
    if (not t.is_cuda or t.dtype != dtype or not t.is_contiguous()
            or t.data_ptr() % 16):
        raise ValueError(f"{name}: expected a contiguous, 16-byte aligned "
                         f"CUDA {dtype} tensor, got {t.dtype} on {t.device} "
                         f"(contiguous={t.is_contiguous()}, "
                         f"data_ptr % 16 = {t.data_ptr() % 16})")


class ParameterCache:
    """What ``build`` derives from some parameters (re-laid-out or
    quantized weights), rebuilt when any of them changes.

    A parameter's version is its ``data_ptr``, autograd ``_version``,
    device, dtype and shape: ``load_state_dict`` and in-place updates bump
    ``_version``, and ``.to()`` gives new storage.  The cache holds the
    storage it was built from, so a freed parameter's address cannot be
    reused by a new one while the entry lives.
    """

    def __init__(self, build: Callable[..., Any]):
        self.build = build
        self._key: Optional[tuple] = None
        self._held: tuple = ()
        self._value: Any = None

    def __call__(self, *params: torch.Tensor) -> Any:
        key = tuple((p.data_ptr(), p._version, p.device, p.dtype,
                     tuple(p.shape)) for p in params)
        if key != self._key:
            with torch.no_grad():
                self._value = self.build(*params)
            self._key = key
            self._held = tuple(p.detach() for p in params)
        return self._value
