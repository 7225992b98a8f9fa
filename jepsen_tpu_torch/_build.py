"""Builds the port's native sources at first use.

Each CUDA source `csrc/<name>.cu` compiles with nvcc, and each host C++
source `csrc/<name>.cc` with g++, into a shared library with a plain C
interface, `_build/<name>-<key>.so`, where `key` hashes the source, the
flags and the compiler path — an edited source or a changed flag builds
anew, an unchanged one loads the library already built. The library is
loaded with ctypes; no PyTorch headers are compiled, so a build takes
seconds, and ninja is not needed.

A build that cannot run (no nvcc, no g++) or fails raises
KernelBuildError with the compiler's output. Nothing here returns a
substitute: the wrappers launch their kernel or raise.
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

#: Host C++ sources (`csrc/*.cc`): the flags the reference builds its
#: native libraries with.
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")

_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

#: ctypes prototypes of each library's C interface.
PROTOTYPES = {
    "closure_square": {
        # (m, mT, out, outT, changed, active, B, T, device, stream)
        "closure_square_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
        # (m, mT, out, outT, changed, active, B, T, c0, c1, device,
        #  stream): the output columns [c0, c1) only
        "closure_square_cols_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]),
        "closure_square_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "knossos_dense": {
        # (regs, comp, valid, rounds, peak (null: none), B, C, S, V,
        #  tier, threads, device, stream)
        "knossos_dense_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_void_p]),
        "knossos_dense_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "wgl": {
        "jt_wgl_abi_version": (ctypes.c_int64, []),
        # (events [E,6], E, max_configs, model, out[5])
        "jt_wgl_run": (None, [_i32p, ctypes.c_int64, ctypes.c_int64,
                              ctypes.c_int64, _i64p]),
    },
    "hist_encode": {
        "jt_ha_abi_version": (ctypes.c_int64, []),
        # (path) -> handle, NULL: the Python encoder takes the file
        "jt_ha_encode_file": (ctypes.c_void_p, [ctypes.c_char_p]),
        "jt_wr_encode_file": (ctypes.c_void_p, [ctypes.c_char_p]),
        # (handle, out[8]): n, n_keys, max_pos, n_app, n_rd, n_anom,
        # pre-key names' JSON length, n_edges
        "jt_ha_dims": (None, [ctypes.c_void_p, _i64p]),
        **{fn: (_i32p, [ctypes.c_void_p])
           for fn in ("jt_ha_appends", "jt_ha_reads", "jt_ha_edges",
                      "jt_ha_status", "jt_ha_process", "jt_ha_kid_to_pre")},
        **{fn: (_i64p, [ctypes.c_void_p])
           for fn in ("jt_ha_invoke_index", "jt_ha_complete_index",
                      "jt_ha_anomalies")},
        "jt_ha_pre_key_names_json": (ctypes.c_char_p, [ctypes.c_void_p]),
        "jt_ha_free": (None, [ctypes.c_void_p]),
        # (handle, history path, sidecar path, layout version 1|2) -> 1|0
        "jt_ha_write_sidecar": (ctypes.c_int64,
                                [ctypes.c_void_p, ctypes.c_char_p,
                                 ctypes.c_char_p, ctypes.c_int64]),
        # (bytes, length, seed) -> XXH64
        "jt_xxh64_buf": (ctypes.c_uint64,
                         [ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64]),
        # the per-key splitter (native_lib.split_key_ids): (path) ->
        # handle, NULL: the Python splitter takes the file
        "jt_ks_split_file": (ctypes.c_void_p, [ctypes.c_char_p]),
        # (handle, out[4]): n_ops, n_keys, key names' JSON length, lifted
        "jt_ks_dims": (None, [ctypes.c_void_p, _i64p]),
        "jt_ks_key_ids": (_i32p, [ctypes.c_void_p]),
        "jt_ks_key_names_json": (ctypes.c_char_p, [ctypes.c_void_p]),
        "jt_ks_free": (None, [ctypes.c_void_p]),
    },
}

#: library -> (its ABI-version function, the version this port speaks)
ABI_VERSIONS = {"wgl": ("jt_wgl_abi_version", 2),
                "hist_encode": ("jt_ha_abi_version", 5)}

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


class KernelBuildError(RuntimeError):
    """The compiler is missing or refused a source."""


class KernelLaunchError(RuntimeError):
    """A hand kernel's launch returned a CUDA error."""


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


def find_cxx() -> str | None:
    """The host C++ compiler, g++ on PATH."""
    return shutil.which("g++")


def _source(name: str) -> tuple[Path, bool]:
    """(`csrc/<name>.cu` or `.cc`, whether it is CUDA)."""
    cu = SRC_DIR / f"{name}.cu"
    return (cu, True) if cu.is_file() else (SRC_DIR / f"{name}.cc", False)


def _compiler(name: str) -> tuple[str, tuple[str, ...]]:
    """The compiler and flags that build `name`; raises KernelBuildError
    when the compiler is missing."""
    src, cuda = _source(name)
    if cuda:
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                f"cannot build {name}: nvcc not found (set CUDA_HOME or "
                "put the CUDA toolkit's bin directory on PATH)")
        return nvcc, NVCC_FLAGS
    cxx = find_cxx()
    if cxx is None:
        raise KernelBuildError(f"cannot build {name}: g++ not found on PATH")
    return cxx, CXX_FLAGS


def library_path(name: str, compiler: str) -> Path:
    src, cuda = _source(name)
    flags = NVCC_FLAGS if cuda else CXX_FLAGS
    key = hashlib.sha256(src.read_bytes() + "\0".join(
        (compiler,) + flags).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{key}.so"


def build(name: str) -> Path:
    """Compile `csrc/<name>.cu` (nvcc) or `csrc/<name>.cc` (g++) unless
    its keyed library exists; returns the library's path. The
    compiler's output is kept beside it as `<library>.log`. Concurrent
    builds race benignly: each writes its own temporary file and
    renames it into place."""
    compiler, flags = _compiler(name)
    lib = library_path(name, compiler)
    if lib.is_file():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.tmp.{os.getpid()}."
                        f"{threading.get_ident()}")
    cmd = [compiler, *flags, "-o", str(tmp), str(_source(name)[0])]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=600)
    except (OSError, subprocess.TimeoutExpired) as e:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(f"cannot run {' '.join(cmd)}: {e}") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise KernelBuildError(
            f"{Path(compiler).name} failed ({proc.returncode}) building "
            f"{name}:\n{proc.stderr}{proc.stdout}")
    lib.with_name(f"{lib.name}.log").write_text(proc.stderr + proc.stdout)
    os.replace(tmp, lib)
    return lib


def build_log(name: str) -> str:
    """The compiler output of `name`'s current build ("" if none)."""
    try:
        log = library_path(name, _compiler(name)[0])
    except KernelBuildError:
        return ""
    log = log.with_name(f"{log.name}.log")
    return log.read_text() if log.is_file() else ""


def load(name: str, path: str | os.PathLike | None = None) -> ctypes.CDLL:
    """The loaded library for `name`, built first if need be (or, with
    `path`, the library already built there), with its C functions'
    argument and result types declared and its ABI version checked.
    A library that cannot be loaded, lacks a function or speaks another
    ABI raises KernelBuildError."""
    key = name if path is None else f"{name}@{path}"
    with _lock:
        lib = _loaded.get(key)
    if lib is not None:
        return lib
    # the compiler runs outside the lock: a first build takes seconds to
    # minutes and would stall every other library's load behind it;
    # concurrent builds of one source race benignly (`build`'s rename)
    path = build(name) if path is None else Path(path)
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            try:
                lib = ctypes.CDLL(str(path))
                for fn, (restype, argtypes) in PROTOTYPES[name].items():
                    f = getattr(lib, fn)
                    f.restype = restype
                    f.argtypes = argtypes
            except (OSError, AttributeError) as e:
                raise KernelBuildError(f"cannot load {path}: {e}") from e
            if name in ABI_VERSIONS:
                fn, want = ABI_VERSIONS[name]
                got = getattr(lib, fn)()
                if got != want:
                    raise KernelBuildError(
                        f"{path} speaks ABI {got}, expected {want}")
            _loaded[key] = lib
        return lib


def resident_count() -> int:
    """How many CUDA kernel libraries (`csrc/*.cu`) this process has
    loaded: the port's counterpart of the reference's resident AOT
    executables (the host libraries, wgl and hist_encode, are not
    kernels and do not count)."""
    with _lock:
        keys = list(_loaded)
    return sum(1 for k in keys if _source(k.split("@", 1)[0])[1])


def build_all() -> dict[str, Path]:
    """Build every source, CUDA (`csrc/*.cu`) and host C++
    (`csrc/*.cc`), one compiler per source, all started together;
    raises the first KernelBuildError. (`load` builds one source at
    first use.)"""
    names = [p.stem for p in sorted(SRC_DIR.glob("*.cu"))] \
        + [p.stem for p in sorted(SRC_DIR.glob("*.cc"))]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
