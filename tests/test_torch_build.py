"""The port's kernel build step, driven by a stand-in for nvcc.

No CUDA compiler is needed: a shell script takes nvcc's place, so the
logic around it (source hashing, the build cache, error reporting) is
checked on any machine.
"""

import ctypes

import pytest

from tinyraytracer_tpu_torch import _build


def _fake_nvcc(tmp_path, body: str) -> str:
    exe = tmp_path / "fake_nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return str(exe)


# every C entry of the library, the error string last
EXPORTED = ("tinyrt_megakernel_packed", "tinyrt_megakernel_flat",
            "tinyrt_closest_hit", "tinyrt_diff_packed",
            "tinyrt_diff_classic", "tinyrt_diff_packed_occupancy",
            "tinyrt_diff_classic_occupancy",
            "tinyrt_megakernel_packed_split", "tinyrt_megakernel_flat_split",
            "tinyrt_fold_samples", "tinyrt_gamma", "tinyrt_microbench",
            "tinyrt_microbench_wave", "tinyrt_probe_packgrad",
            "tinyrt_probe_packgrad2", "tinyrt_probe_seglayout_a",
            "tinyrt_probe_seglayout_b", "tinyrt_probe_sublanes",
            "tinyrt_probe_packgrad_info", "tinyrt_probe_packgrad2_info",
            "tinyrt_probe_seglayout_info", "tinyrt_error_string")


def _declared():
    """A stand-in library with an attribute per C entry, after _declare."""
    from types import SimpleNamespace

    lib = SimpleNamespace(**{n: SimpleNamespace() for n in EXPORTED})
    _build._declare(lib)
    return lib


@pytest.fixture
def fake_tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    (src / "j.cu").write_text('#include "c.cuh"\n')
    (src / "c.cuh").write_text("// header v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_build_caches_by_source_and_flag_hash(fake_tree, monkeypatch):
    """One nvcc per source (-c), then one link (-shared); a rebuild only
    when a source, a header or the flags change."""
    calls = fake_tree / "calls"
    nvcc = _fake_nvcc(fake_tree, (
        f'echo "$*" >> "{calls}"\n'
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        'echo "ptxas info : Used 8 registers" >&2\n'
        ': > "$out"\n'))
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)

    def links():
        return [c for c in calls.read_text().splitlines() if "-shared" in c]

    first = _build.build()
    assert first.is_file() and first.parent == fake_tree / "_build"
    assert "Used 8 registers" in first.with_suffix(".log").read_text()
    compiles = [c for c in calls.read_text().splitlines() if " -c " in c]
    assert sorted(c.split()[-1].rsplit("/", 1)[-1] for c in compiles) == [
        "j.cu", "k.cu"]
    assert len(links()) == 1 and links()[0].count(".o") == 2
    assert _build.build() == first                  # cached: no rebuild
    assert len(links()) == 1
    fma = _build.build(fmad=True)                   # other flags, other file
    assert fma != first and len(links()) == 2
    (fake_tree / "csrc" / "k.cu").write_text("// v2\n")
    second = _build.build()                         # changed source
    assert second != first and len(links()) == 3
    (fake_tree / "csrc" / "c.cuh").write_text("// header v2\n")
    assert _build.build() not in (first, second)    # changed header
    assert len(links()) == 4
    left = {p.suffix for p in (fake_tree / "_build").iterdir()}
    assert left == {".so", ".log"}                  # no objects, no .tmp


def test_declare_types_every_exported_function():
    """Each kernel entry point gets argtypes, pointers as c_void_p: with
    untyped arguments ctypes would pass them as 32-bit ints."""
    lib = _declared()
    p = ctypes.c_void_p
    packed = lib.tinyrt_megakernel_packed.argtypes
    assert len(packed) == 22
    # ... the device's counter buffer (or None) and the stream
    assert [k for k, t in enumerate(packed) if t is p] == [0, 1, 5, 6, 20,
                                                           21]
    assert packed[9] is packed[10] is ctypes.c_uint
    assert packed[13] is ctypes.c_float
    assert packed[18] is packed[19] is ctypes.c_int     # the pixel range
    flat = lib.tinyrt_megakernel_flat.argtypes
    assert len(flat) == 33
    # ... the BVH's nodes (or None) and their count after the AABBs'; the
    # media's rows (or None), their count and first payload row at the end
    assert [k for k, t in enumerate(flat) if t is p] == [0, 1, 4, 6, 8, 11,
                                                         13, 14, 28, 29, 30]
    assert flat[12] is flat[31] is flat[32] is ctypes.c_int
    assert flat[26] is flat[27] is ctypes.c_int
    assert flat[21] is ctypes.c_float
    assert flat[17] is flat[18] is ctypes.c_uint
    assert lib.tinyrt_megakernel_packed_split.argtypes == [ctypes.c_int] * 7
    # ... whether the launch walks the BVH, and whether it has media
    assert lib.tinyrt_megakernel_flat_split.argtypes == [ctypes.c_int] * 8
    fold = lib.tinyrt_fold_samples.argtypes
    assert fold == [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
    # in, out, the element count (64-bit), the exponent, the stream
    assert lib.tinyrt_gamma.argtypes == [p, p, ctypes.c_long, ctypes.c_float,
                                         p]
    k3 = lib.tinyrt_closest_hit.argtypes
    assert len(k3) == 17
    assert [k for k, t in enumerate(k3) if t is p] == [0, 3, 7, 9, 12, 13,
                                                       14, 16]
    assert k3[6] is ctypes.c_char_p     # the bank's bytes, or None
    # the ray strides and count are 64-bit: a (R, 3) view's row stride
    # times R passes 2^31 elements at R = 716 million rays
    assert [k for k, t in enumerate(k3) if t is ctypes.c_longlong] == [
        1, 2, 4, 5, 15]
    k5 = lib.tinyrt_diff_packed.argtypes
    assert len(k5) == 35
    # ... the stage events (or None) and the stream
    assert [k for k, t in enumerate(k5) if t is p] == [0, 1, 8, 9, 10, 11,
                                                       12, 30, 33, 34]
    assert k5[15] is k5[16] is ctypes.c_uint and k5[19] is ctypes.c_float
    assert k5[31] is k5[32] is ctypes.c_int
    k4 = lib.tinyrt_diff_classic.argtypes
    assert len(k4) == 36
    assert [k for k, t in enumerate(k4) if t is p] == [0, 1, 7, 9, 11, 12,
                                                       13, 14, 15, 16, 31,
                                                       34, 35]
    assert k4[21] is k4[22] is ctypes.c_uint and k4[25] is ctypes.c_float
    assert k4[32] is k4[33] is ctypes.c_int
    ip = ctypes.POINTER(ctypes.c_int)
    occ5 = lib.tinyrt_diff_packed_occupancy.argtypes
    assert occ5 == [ctypes.c_int] * 8 + [ip, ip]
    occ4 = lib.tinyrt_diff_classic_occupancy.argtypes
    assert occ4 == [ctypes.c_int] * 5 + [ip, ip]
    mb = lib.tinyrt_microbench.argtypes
    assert mb == [p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                  ctypes.POINTER(ctypes.c_float), p]
    assert lib.tinyrt_microbench_wave.argtypes == [ctypes.c_int]
    i = ctypes.c_int
    assert lib.tinyrt_probe_packgrad.argtypes == [p, i, i, i, p]
    assert lib.tinyrt_probe_packgrad2.argtypes == [p, p, i, i, i, p]
    assert lib.tinyrt_probe_seglayout_a.argtypes == [p, p, p, i, i, i, p]
    assert lib.tinyrt_probe_seglayout_b.argtypes == [
        ctypes.POINTER(ctypes.c_float), p, i, i, i, i, p]
    assert lib.tinyrt_probe_sublanes.argtypes == [p, p, i, i, i, p]
    assert lib.tinyrt_probe_packgrad_info.argtypes == [i, ip]
    assert lib.tinyrt_probe_packgrad2_info.argtypes == [i, ip]
    assert lib.tinyrt_probe_seglayout_info.argtypes == [i, ip]
    for n in EXPORTED[:-1]:
        assert getattr(lib, n).restype is ctypes.c_int


def test_build_failure_raises_compiler_output(fake_tree, monkeypatch):
    nvcc = _fake_nvcc(fake_tree, 'echo "k.cu(3): error: boom" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.build()
    assert not list((fake_tree / "_build").glob("*.so*"))


def test_flags_target_hopper_without_fast_math():
    for fmad in (False, True):
        f = _build.flags(fmad)
        assert "arch=compute_90a,code=sm_90a" in f
        assert f"--fmad={'true' if fmad else 'false'}" in f
        assert not any("fast" in x for x in f)


def test_k3_bank_is_the_kernels():
    """The bank's row limit and bytes the host packs are the ones
    csrc/closest_hit.cu is built with."""
    from tinyraytracer_tpu_torch.ops import intersect_kernel as ik

    src = (_build.CSRC_DIR / "closest_hit.cu").read_text()
    assert f"constexpr int kBankRows = {ik.BANK_MAX_ROWS};" in src
    assert f"sizeof(BankRows) == {ik.BANK_BYTES}" in src


def test_k5_accumulator_limit_is_the_kernels():
    """The routing rule's accumulator limit is the one K5 is built with."""
    from tinyraytracer_tpu_torch.ops.diffkernel import DIFF_PACKED_MAX_ACC

    src = (_build.CSRC_DIR / "diffkernel_packed.cu").read_text()
    assert f"constexpr int kMaxAcc = {DIFF_PACKED_MAX_ACC};" in src


def test_gamma_entry_is_the_kernels():
    """The ctypes signature of tinyrt_gamma is the one csrc/gamma.cu
    exports, its count a 64-bit C `long`; no other source declares it."""
    src = (_build.CSRC_DIR / "gamma.cu").read_text()
    assert ("int tinyrt_gamma(const float* in, float* out, long n, "
            "float inv_gamma,\n                 void* stream)") in src
    assert "powf(" not in src           # the power is taken in double
    for other in _build.CSRC_DIR.glob("*.cu*"):
        if other.name != "gamma.cu":
            assert "tinyrt_gamma" not in other.read_text()
    lib = _declared()
    fn = lib.tinyrt_gamma
    assert ctypes.sizeof(fn.argtypes[2]) == 8   # C `long` on LP64
    assert fn.restype is ctypes.c_int


@pytest.mark.parametrize("name", ["diffkernel.cu", "diff_common.cuh"])
def test_k4_source_and_shared_header_are_in_the_build_hash(
        name, tmp_path, monkeypatch):
    """K4's source and the estimator header it shares with K5 are built
    and hashed: changing either names another library."""
    import shutil

    src = tmp_path / "csrc"
    shutil.copytree(_build.CSRC_DIR, src)
    assert (src / name).is_file()
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    before = _build.library_path()
    (src / name).write_text((src / name).read_text() + "\n// edited\n")
    assert _build.library_path() != before
    if name.endswith(".cu"):
        assert (src / name) in sorted(src.glob("*.cu"))


def test_pyproject_packages_the_port_with_its_sources():
    """pyproject.toml declares the port (torch and numpy), ships every
    CUDA source and the native library's source as package data, and
    leaves the test settings to pytest.ini."""
    import tomllib
    from pathlib import Path

    root = Path(_build.PKG_DIR).parent
    meta = tomllib.loads((root / "pyproject.toml").read_text())
    assert meta["project"]["dependencies"] == ["torch", "numpy"]
    assert meta["tool"]["setuptools"]["packages"]["find"]["include"] == [
        "tinyraytracer_tpu_torch*"]
    globs = meta["tool"]["setuptools"]["package-data"][
        "tinyraytracer_tpu_torch"]
    shipped = {p for g in globs for p in _build.PKG_DIR.glob(g)}
    sources = (set(_build.CSRC_DIR.glob("*.cu*"))
               | set((_build.PKG_DIR / "native" / "src").glob("*.cpp")))
    assert sources and shipped == sources
    assert "pytest" not in meta.get("tool", {})
    assert meta["project"]["scripts"]["tinyraytracer-torch"] == (
        "tinyraytracer_tpu_torch.__main__:main")
