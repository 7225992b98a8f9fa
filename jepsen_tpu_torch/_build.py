"""Builds the port's CUDA sources at first use.

Each `csrc/<name>.cu` compiles with nvcc into a shared library with a
plain C interface, `_build/<name>-<key>.so`, where `key` hashes the
source, the flags and the compiler path — an edited source or a changed
flag builds anew, an unchanged one loads the library already built.
The library is loaded with ctypes; no PyTorch headers are compiled, so
a build takes seconds, and ninja is not needed.

A build that cannot run (no nvcc) or fails raises KernelBuildError with
the compiler's output. Nothing here returns a substitute: the wrappers
in `checker/elle` launch their kernel or raise.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
SRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

#: Hopper only: `wgmma` and `setmaxnreg` exist only for `sm_90a`;
#: -Xptxas=-v makes ptxas report registers, shared memory and spills
#: into the build log. No -lcuda: the TMA descriptors' encoder is taken
#: from libcuda at run time (cudaGetDriverEntryPoint).
NVCC_FLAGS = ("-O3", "-std=c++17", "-gencode", "arch=compute_90a,code=sm_90a",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: ctypes prototypes of each library's C interface.
PROTOTYPES = {
    "closure_square": {
        # (m, mT, out, outT, changed, B, T, device, stream)
        "closure_square_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]),
        "closure_square_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """nvcc is missing or refused a source."""


def find_nvcc() -> str | None:
    """nvcc from $CUDA_HOME / $CUDA_PATH, else PATH, else the toolkit's
    default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root:
            cand = Path(root) / "bin" / "nvcc"
            if cand.is_file():
                return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.is_file() else None


def library_path(name: str, nvcc: str) -> Path:
    src = (SRC_DIR / f"{name}.cu").read_bytes()
    key = hashlib.sha256(
        src + "\0".join((nvcc,) + NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` unless its keyed library exists; returns
    the library's path. The compiler's output is kept beside it as
    `<library>.log`. Concurrent builds race benignly: each writes its
    own temporary file and renames it into place."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise KernelBuildError(
            f"cannot build {name}: nvcc not found (set CUDA_HOME or put "
            "the CUDA toolkit's bin directory on PATH)")
    lib = library_path(name, nvcc)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"nvcc failed ({proc.returncode}) building {name}:\n"
            f"{proc.stderr}{proc.stdout}")
    lib.with_name(f"{lib.name}.log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The compiler output of `name`'s current build ("" if none)."""
    nvcc = find_nvcc()
    if nvcc is None:
        return ""
    log = library_path(name, nvcc)
    log = log.with_name(f"{log.name}.log")
    return log.read_text() if log.is_file() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for `name`, built first if need be, with its
    C functions' argument and result types declared."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            path = build(name)
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            for fn, (restype, argtypes) in PROTOTYPES[name].items():
                f = getattr(lib, fn)
                f.restype = restype
                f.argtypes = argtypes
            _loaded[name] = lib
        return lib


def build_all() -> dict[str, Path]:
    """Build every `csrc/*.cu`, one nvcc per source, all started together;
    raises the first KernelBuildError."""
    names = [p.stem for p in sorted(SRC_DIR.glob("*.cu"))]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
