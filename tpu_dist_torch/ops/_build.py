"""Shared plumbing for the port's hand-written kernels.

Counterpart of ``tpu_dist/ops/_pallas.py``.  Where the JAX package runs a
Pallas kernel interpreted off the TPU, the port takes the kernel's plain
PyTorch version for a tensor that lies on the CPU; a CUDA tensor launches the
kernel or raises, never falls back.

CUDA sources (``tpu_dist_torch/csrc/*.cu``) are compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface at first use, and
loaded with ``ctypes``.  The build lands in ``tpu_dist_torch/_build/`` (git
ignored), named by a hash of the source, the shared headers (``csrc/*.cuh``)
and the flags, so an edited source or header is rebuilt and an unchanged one
is reused.  Every C entry point returns the
``cudaError_t`` of its launch; :func:`check` raises on anything but 0.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

__all__ = ["resolve_device", "check_cuda_tensor", "load_library", "check",
           "compile_log", "build_all", "source_digest", "SOURCES"]

# every CUDA source of the port, in csrc/
SOURCES = ("flash_attention", "gmm")

_PKG = Path(__file__).resolve().parent.parent
_SRC_DIR = _PKG / "csrc"
_BUILD_DIR = _PKG / "_build"
_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
          "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo")

_LIBS: dict = {}
_LOGS: dict = {}
_LOCK = threading.Lock()


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``cuda`` unless the caller names
    another.  With no ``device`` and no CUDA device it raises — the port
    never moves to the CPU on its own."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port's plain PyTorch path on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a CUDA tensor of one of ``dtypes`` with
    ``ndim`` dimensions — what every kernel wrapper takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not supported "
                        f"(takes {', '.join(str(d) for d in dtypes)})")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape "
                         f"{tuple(t.shape)}")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin); the port's "
                       "CUDA kernels are built from source at first use")


def source_digest(name: str, src_dir: Path = _SRC_DIR) -> str:
    """The build key of ``csrc/<name>.cu``: a hash of its bytes, of every
    ``csrc/*.cuh`` header (any source may include any of them) and of the
    flags, so that an edited header rebuilds the libraries too."""
    h = hashlib.sha256((src_dir / f"{name}.cu").read_bytes())
    for header in sorted(src_dir.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(name: str) -> Path:
    src = _SRC_DIR / f"{name}.cu"
    so = _BUILD_DIR / f"lib{name}-{source_digest(name)}.so"
    log = so.with_suffix(".log")
    if so.exists():
        _LOGS[name] = log.read_text() if log.exists() else ""
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: concurrent ranks building the
    # same source never load a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run([_nvcc(), *_FLAGS, "-o", tmp, str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name} "
                               f"(rc {proc.returncode}):\n{proc.stderr}")
        log.write_text(proc.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    _LOGS[name] = proc.stderr
    return so


def build_all(names=SOURCES) -> None:
    """Compile the named sources at once, one ``nvcc`` each, in parallel
    (a later :func:`load_library` finds them built)."""
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(_build, names))


def load_library(name: str, signatures: dict) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``; ``signatures`` maps
    each C entry point to its ``argtypes``.  Every entry returns ``int``
    (a ``cudaError_t``); the source also exports
    ``const char* <name>_error_string(int)``."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(_build(name)))
            for fn, argtypes in signatures.items():
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
            err_fn = getattr(lib, f"{name}_error_string")
            err_fn.argtypes = [ctypes.c_int]
            err_fn.restype = ctypes.c_char_p
            _LIBS[name] = lib
        return lib


def compile_log(name: str) -> str:
    """``nvcc -Xptxas -v`` output of the last build of ``name`` (registers,
    shared memory and spills per kernel)."""
    return _LOGS.get(name, "")


def check(lib: ctypes.CDLL, name: str, err: int, what: str) -> None:
    """Raise if a C entry point of library ``name`` reported a CUDA error
    for its launch (``<name>_error_string`` names it)."""
    if err != 0:
        msg = getattr(lib, f"{name}_error_string")(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed with error {err} "
                           f"({msg})")
