"""Builds the port's native sources at first use.

Each CUDA source `csrc/<name>.cu` compiles with nvcc, and each host C++
source `csrc/<name>.cc` with g++, into a shared library with a plain C
interface, `_build/<name>-<key>.so`, where `key` hashes the source, the
flags and the compiler path — an edited source or a changed flag builds
anew, an unchanged one loads the library already built. The library is
loaded with ctypes; no PyTorch headers are compiled, so a build takes
seconds, and ninja is not needed.

A host source also builds in a sanitizer flavour (`SANITIZE_FLAGS`:
`asan`, AddressSanitizer with UndefinedBehaviorSanitizer, or `tsan`,
ThreadSanitizer), into `_build/<flavour>/` under its own key, and is
copied there to the reference's library name (LIB_NAMES), so
JEPSEN_TPU_NATIVE_LIB_DIR=`_build/asan` loads the instrumented builds
as the reference's `native/build/asan` copies are loaded. An
instrumented library loads only into a process started with its
runtime preloaded (`tools/sanitize_native.py` does that); a plain
`load` never returns one.

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

#: Sanitizer flavours of the host C++ sources: the reference's
#: `native/Makefile` ASAN_FLAGS and TSAN_FLAGS. CUDA sources take none.
SANITIZE_FLAGS = {
    "asan": ("-O1", "-g", "-fPIC", "-std=c++17",
             "-fsanitize=address,undefined", "-fno-sanitize-recover=all",
             "-shared"),
    "tsan": ("-O1", "-g", "-fPIC", "-std=c++17", "-fsanitize=thread",
             "-shared"),
}

#: The reference's file names of the host libraries, as a
#: JEPSEN_TPU_NATIVE_LIB_DIR holds them.
LIB_NAMES = {"hist_encode": "libjepsen_histenc.so",
             "wgl": "libjepsen_wgl.so"}

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
    "knossos_frontier": {
        # (events, valid, overflow, rounds, peak, explored (both null:
        #  none), work (null: the shared tier), B, E, F, S, packed, grid,
        #  device, stream)
        "knossos_frontier_launch": (
            ctypes.c_int,
            [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
             ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
             ctypes.c_void_p]),
        "knossos_frontier_error_string": (ctypes.c_char_p, [ctypes.c_int]),
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


def find_cuda_tool(tool: str) -> str | None:
    """A CUDA toolkit program (`nvcc`, `compute-sanitizer`) from
    $CUDA_HOME / $CUDA_PATH, else PATH, else the toolkit's default
    install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root:
            cand = Path(root) / "bin" / tool
            if cand.is_file():
                return str(cand)
    found = shutil.which(tool)
    if found:
        return found
    default = Path("/usr/local/cuda/bin") / tool
    return str(default) if default.is_file() else None


def find_nvcc() -> str | None:
    return find_cuda_tool("nvcc")


def find_cxx() -> str | None:
    """The host C++ compiler, g++ on PATH."""
    return shutil.which("g++")


def _source(name: str) -> tuple[Path, bool]:
    """(`csrc/<name>.cu` or `.cc`, whether it is CUDA)."""
    cu = SRC_DIR / f"{name}.cu"
    return (cu, True) if cu.is_file() else (SRC_DIR / f"{name}.cc", False)


def _host_flags(sanitize: str | None) -> tuple[str, ...]:
    """g++'s flags for a production build (None) or a flavour's."""
    if sanitize is None:
        return CXX_FLAGS
    if sanitize not in SANITIZE_FLAGS:
        raise ValueError(f"unknown sanitizer flavour {sanitize!r} (one of "
                         f"{sorted(SANITIZE_FLAGS)})")
    return SANITIZE_FLAGS[sanitize]


def _compiler(name: str, sanitize: str | None = None
              ) -> tuple[str, tuple[str, ...]]:
    """The compiler and flags that build `name` (in the flavour
    `sanitize`, a key of SANITIZE_FLAGS, for a host source); raises
    KernelBuildError when the compiler is missing, ValueError for a
    flavour of a CUDA source or an unknown one."""
    src, cuda = _source(name)
    if cuda:
        if sanitize is not None:
            raise ValueError(f"{src.name} is a CUDA source: no host "
                             f"sanitizer ({sanitize}) applies to it")
        nvcc = find_nvcc()
        if nvcc is None:
            raise KernelBuildError(
                f"cannot build {name}: nvcc not found (set CUDA_HOME or "
                "put the CUDA toolkit's bin directory on PATH)")
        return nvcc, NVCC_FLAGS
    flags = _host_flags(sanitize)
    cxx = find_cxx()
    if cxx is None:
        raise KernelBuildError(f"cannot build {name}: g++ not found on PATH")
    return cxx, flags


def library_path(name: str, compiler: str,
                 sanitize: str | None = None) -> Path:
    src, cuda = _source(name)
    flags = NVCC_FLAGS if cuda else _host_flags(sanitize)
    key = hashlib.sha256(src.read_bytes() + "\0".join(
        (compiler,) + flags).encode()).hexdigest()[:16]
    return (BUILD_DIR if sanitize is None else BUILD_DIR / sanitize) \
        / f"{name}-{key}.so"


def build(name: str, sanitize: str | None = None) -> Path:
    """Compile `csrc/<name>.cu` (nvcc) or `csrc/<name>.cc` (g++) unless
    its keyed library exists; returns the library's path. The
    compiler's output is kept beside it as `<library>.log`. Concurrent
    builds race benignly: each writes its own temporary file and
    renames it into place. With `sanitize` (a host source only) the
    flavour's build, also copied to its LIB_NAMES name in its
    directory."""
    compiler, flags = _compiler(name, sanitize)
    lib = library_path(name, compiler, sanitize)
    if not lib.is_file():
        lib.parent.mkdir(parents=True, exist_ok=True)
        tmp = _tmp(lib)
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
    if sanitize is not None:
        named = lib.parent / LIB_NAMES[name]
        tmp = _tmp(named)
        shutil.copyfile(lib, tmp)
        os.replace(tmp, named)
    return lib


def _tmp(path: Path) -> Path:
    """A temporary name beside `path`, this process's and thread's."""
    return path.with_name(f"{path.name}.tmp.{os.getpid()}."
                          f"{threading.get_ident()}")


def build_log(name: str) -> str:
    """The compiler output of `name`'s current build ("" if none)."""
    try:
        log = library_path(name, _compiler(name)[0])
    except KernelBuildError:
        return ""
    log = log.with_name(f"{log.name}.log")
    return log.read_text() if log.is_file() else ""


def load(name: str, path: str | os.PathLike | None = None,
         sanitize: str | None = None) -> ctypes.CDLL:
    """The loaded library for `name`, built first if need be (or, with
    `path`, the library already built there; with `sanitize`, the
    flavour's build, which loads only under its preloaded runtime),
    with its C functions' argument and result types declared and its
    ABI version checked. A library that cannot be loaded, lacks a
    function or speaks another ABI raises KernelBuildError."""
    if path is not None and sanitize is not None:
        raise ValueError("load takes a path or a sanitizer flavour, "
                         "not both")
    key = name if path is None and sanitize is None else \
        f"{name}@{path}" if sanitize is None else f"{name}#{sanitize}"
    with _lock:
        lib = _loaded.get(key)
    if lib is not None:
        return lib
    # the compiler runs outside the lock: a first build takes seconds to
    # minutes and would stall every other library's load behind it;
    # concurrent builds of one source race benignly (`build`'s rename)
    path = build(name, sanitize) if path is None else Path(path)
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
    return sum(1 for k in keys
               if _source(k.split("@", 1)[0].split("#", 1)[0])[1])


def build_all() -> dict[str, Path]:
    """Build every source, CUDA (`csrc/*.cu`) and host C++
    (`csrc/*.cc`), one compiler per source, all started together;
    raises the first KernelBuildError. (`load` builds one source at
    first use.)"""
    names = [p.stem for p in sorted(SRC_DIR.glob("*.cu"))] \
        + [p.stem for p in sorted(SRC_DIR.glob("*.cc"))]
    with ThreadPoolExecutor(max_workers=max(1, len(names))) as pool:
        return dict(zip(names, pool.map(build, names)))
