"""Build the port's CUDA sources at first use and load them with ctypes.

Every `csrc/*.cu` file is compiled by its own `nvcc` process, all started
together, for Hopper (`sm_90a`); the objects are then linked into one
shared library with a plain C interface, under `_build/` beside this
file. The library's name carries a hash of the sources (headers
included) and the flags, so a changed source builds anew and an
unchanged one loads what is there. If `nvcc` is missing or fails, the
compiler's error is raised.

`hashed_path`, `cached_build` and `load_once` are the build cache itself;
native/runtime.py builds the port's C++ host library with them too.

Flags that matter for the numbers (see csrc/common.cuh):
`--fmad=false` keeps every multiply and add separately rounded, as in the
reference; no `--use_fast_math`, so `sqrtf` and `/` stay IEEE.
`-Xptxas -v` writes each kernel's registers and spills into the build log.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_lock = threading.Lock()
_loaded: dict = {}


def nvcc_path() -> str:
    """nvcc from $CUDA_HOME, then $PATH, then the toolkit's default
    install prefix."""
    cands = []
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home:
        cands.append(Path(home) / "bin" / "nvcc")
    which = shutil.which("nvcc")
    if which:
        cands.append(Path(which))
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, $PATH "
                       "and /usr/local/cuda/bin): the CUDA kernels cannot "
                       "be built")


def flags(fmad: bool = False) -> list:
    """Compile flags of every source."""
    return [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
            f"--fmad={'true' if fmad else 'false'}", "-Xptxas", "-v"]


def hashed_path(name: str, args: list, sources: list) -> Path:
    """BUILD_DIR/lib{name}_{hash}.so, the hash over the compiler's
    arguments and each source's name and bytes: a changed source or flag
    names another library."""
    h = hashlib.sha256(" ".join(args).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def cached_build(out: Path, make) -> Path:
    """Returns `out`, built first if it is missing: make(tmp) writes the
    library to a temporary file of this process and returns the
    compilers' output (kept beside `out` as .log) or None. The file then
    replaces `out` atomically, so concurrent builders agree; a make that
    raises leaves no temporary file."""
    if out.is_file():
        return out
    out.parent.mkdir(exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    try:
        log = make(tmp)
    except BaseException:
        tmp.unlink(missing_ok=True)
        raise
    if log is not None:
        out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


def load_once(key, build, declare) -> ctypes.CDLL:
    """The library at build(), loaded and given its argtypes by
    declare(lib) once per process for `key`."""
    with _lock:
        lib = _loaded.get(key)
        if lib is None:
            lib = ctypes.CDLL(str(build()))
            declare(lib)
            _loaded[key] = lib
        return lib


def library_path(fmad: bool = False) -> Path:
    """Where the library for the current sources and flags lives."""
    return hashed_path("tinyrt_torch", flags(fmad),
                       sorted(CSRC_DIR.glob("*.cu*")))


def _run(cmds: list) -> list:
    """Runs the commands side by side; returns their (code, output)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    return [(p.returncode, out) for p, out in
            ((p, p.communicate()[0]) for p in procs)]


def build(fmad: bool = False) -> Path:
    """Compile csrc/*.cu unless the library for these sources exists.
    Returns its path; the compilers' output is kept beside it (.log)."""
    def make(tmp):
        nvcc = nvcc_path()
        srcs = sorted(CSRC_DIR.glob("*.cu"))
        objs = [tmp.with_name(f"{tmp.name}.{s.stem}.o") for s in srcs]
        steps = [[[nvcc, *flags(fmad), "-c", "-o", str(o), str(s)]
                  for s, o in zip(srcs, objs)],
                 [[nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp),
                   *map(str, objs)]]]
        log = []
        try:
            for cmds in steps:
                for cmd, (code, text) in zip(cmds, _run(cmds)):
                    log.append(text)
                    if code != 0:
                        raise RuntimeError(f"nvcc failed with code {code}: "
                                           f"{' '.join(cmd)}\n{text}")
        finally:
            for o in objs:
                o.unlink(missing_ok=True)
        return "".join(log)
    return cached_build(library_path(fmad), make)


def load(fmad: bool = False) -> ctypes.CDLL:
    """The kernel library, built if needed and loaded once per process."""
    return load_once(("cuda", fmad), lambda: build(fmad), _declare)


def _declare(lib: ctypes.CDLL) -> None:
    # argtypes for every exported function: without them ctypes passes
    # ints as 32 bits and would cut pointers
    p, i, u, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
    fn = lib.tinyrt_megakernel_packed
    fn.argtypes = [p, p, i, i, i, p, p, i, i, u, u, i, i, f, i, i, i, i, i,
                   i, p, p]
    fn.restype = i
    fn = lib.tinyrt_megakernel_packed_split
    fn.argtypes = [i, i, i, i, i, i, i]
    fn.restype = i
    fn = lib.tinyrt_megakernel_flat
    fn.argtypes = [p, p, i, i, p, i, p, i, p, i, i, p, i, p, p, i, i, u, u, i,
                   i, f, i, i, i, i, i, i, p, p, p, i, i]
    fn.restype = i
    fn = lib.tinyrt_megakernel_flat_split
    fn.argtypes = [i, i, i, i, i, i, i, i]
    fn.restype = i
    fn = lib.tinyrt_fold_samples
    fn.argtypes = [p, p, i, i, f, p]
    fn.restype = i
    fn = lib.tinyrt_gamma
    fn.argtypes = [p, p, ctypes.c_long, f, p]
    fn.restype = i
    ll = ctypes.c_longlong
    fn = lib.tinyrt_closest_hit
    fn.argtypes = [p, ll, ll, p, ll, ll, ctypes.c_char_p, p, i, p, i, i, p,
                   p, p, ll, p]
    fn.restype = i
    fn = lib.tinyrt_diff_packed
    fn.argtypes = [p, p, i, i, i, i, i, i, p, p, p, p, p, i, i, u, u, i, i,
                   f, i, i, i, i, i, i, i, i, i, i, p, i, i, p, p]
    fn.restype = i
    ip = ctypes.POINTER(i)
    fn = lib.tinyrt_diff_packed_occupancy
    fn.argtypes = [i, i, i, i, i, i, i, i, ip, ip]
    fn.restype = i
    fn = lib.tinyrt_diff_classic_occupancy
    fn.argtypes = [i, i, i, i, i, ip, ip]
    fn.restype = i
    fn = lib.tinyrt_diff_classic
    fn.argtypes = [p, p, i, i, i, i, i, p, i, p, i, p, p, p, p, p, p, i, i, i,
                   i, u, u, i, i, f, i, i, i, i, i, p, i, i, p, p]
    fn.restype = i
    fn = lib.tinyrt_microbench
    fn.argtypes = [p, p, i, i, i, ctypes.POINTER(f), p]
    fn.restype = i
    fn = lib.tinyrt_microbench_wave
    fn.argtypes = [i]
    fn.restype = i
    fn = lib.tinyrt_probe_packgrad
    fn.argtypes = [p, i, i, i, p]
    fn.restype = i
    fn = lib.tinyrt_probe_packgrad2
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = i
    fn = lib.tinyrt_probe_seglayout_a
    fn.argtypes = [p, p, p, i, i, i, p]
    fn.restype = i
    fn = lib.tinyrt_probe_seglayout_b
    fn.argtypes = [ctypes.POINTER(f), p, i, i, i, i, p]
    fn.restype = i
    for name in ("tinyrt_probe_packgrad_info", "tinyrt_probe_packgrad2_info",
                 "tinyrt_probe_seglayout_info"):
        fn = getattr(lib, name)
        fn.argtypes = [i, ip]
        fn.restype = i
    fn = lib.tinyrt_probe_sublanes
    fn.argtypes = [p, p, i, i, i, p]
    fn.restype = i
    lib.tinyrt_error_string.argtypes = [i]
    lib.tinyrt_error_string.restype = ctypes.c_char_p
