"""Build and load the package's hand-written CUDA kernels.

Every ``kernels/*/csrc/*.cu`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into its own shared library with a plain C interface, under
``build/kernels/`` at the repository root, and loaded with ``ctypes``. Each
library's file name carries a hash of its source, of the shared headers
(``kernels/*/*.cuh``, which sources include by relative path) and of the
flags, so an edit rebuilds it at first use and an unchanged source is
loaded as it is. All
missing libraries are built at once, one ``nvcc`` per source, in parallel.

Nothing is built or loaded at import: the first :func:`library` call does
it, on a machine with the CUDA toolkit.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

__all__ = [
    "NVCC_FLAGS", "build_all", "build_dir", "check_status", "device_scope", "headers", "library",
    "library_path", "sources",
]

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_KERNELS_DIR = Path(__file__).resolve().parent
_REPO_ROOT = _KERNELS_DIR.parents[2]


def build_dir() -> Path:
    return _REPO_ROOT / "build" / "kernels"


def sources() -> dict[str, Path]:
    """Kernel sources by library name (the ``.cu`` file's stem)."""
    return {p.stem: p for p in sorted(_KERNELS_DIR.glob("*/csrc/*.cu"))}


def headers() -> list[Path]:
    """The headers the kernel sources share (``kernels/*/*.cuh``)."""
    return sorted(_KERNELS_DIR.glob("*/*.cuh"))


def _library_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    for header in headers():
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"{src.stem}-{h.hexdigest()[:16]}.so"


def library_path(name: str) -> Path:
    """Where the library of kernel source ``name`` is built."""
    return _library_path(sources()[name])


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME/bin")


def build_all() -> dict[str, dict]:
    """Build every kernel library that is missing; one ``nvcc`` per source,
    all started together. Returns, per library, its path, whether it was
    built now, the build's wall seconds and ``nvcc``'s ``-Xptxas -v`` report.
    """
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    procs = {}
    t0 = time.perf_counter()
    for name, src in sources().items():
        lib = _library_path(src)
        report[name] = {"path": str(lib), "built": False, "seconds": 0.0, "ptxas": ""}
        if lib.exists():
            continue
        tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        ), tmp, lib)
    failures = []
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        report[name].update(built=True, seconds=time.perf_counter() - t0, ptxas=log)
        if proc.returncode != 0:
            failures.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            tmp.unlink(missing_ok=True)
            continue
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
    if failures:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failures))
    return report


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built first if it is missing."""
    srcs = sources()
    if name not in srcs:
        raise KeyError(f"no kernel source named {name!r}; have {sorted(srcs)}")
    lib_path = _library_path(srcs[name])
    if not lib_path.exists():
        build_all()
    return ctypes.CDLL(str(lib_path))


def device_scope(device):
    """A context in which ``device`` is the current CUDA device: nothing to
    do when it already is (the common case, and the cheaper one)."""
    import torch

    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def check_status(lib: ctypes.CDLL, status: int, kernel: str) -> None:
    """Raise if a C entry point returned a non-zero ``cudaError_t``; every
    kernel library exports ``kernel_error_string`` to name it."""
    if status != 0:
        describe = lib.kernel_error_string
        describe.argtypes = [ctypes.c_int]
        describe.restype = ctypes.c_char_p
        raise RuntimeError(
            f"{kernel}: CUDA launch failed with cudaError_t {status} "
            f"({describe(status).decode()})"
        )


def require(t, name: str, dtype, device, shape: tuple[int, ...] | None = None) -> None:
    """Check one kernel argument: device, dtype, shape and contiguity."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} has dtype {t.dtype}, the kernel takes {dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
