"""The port's kernel build step, driven by a stand-in for nvcc.

No CUDA compiler is needed: a shell script takes nvcc's place, so the
logic around it (source hashing, the build cache, error reporting) is
checked on any machine.
"""

import pytest

from tinyraytracer_tpu_torch import _build


def _fake_nvcc(tmp_path, body: str) -> str:
    exe = tmp_path / "fake_nvcc"
    exe.write_text("#!/bin/sh\n" + body)
    exe.chmod(0o755)
    return str(exe)


@pytest.fixture
def sandbox(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    (src / "k.cu").write_text("// v1\n")
    monkeypatch.setattr(_build, "CSRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "_build")
    return tmp_path


def test_build_caches_by_source_and_flag_hash(sandbox, monkeypatch):
    calls = sandbox / "calls"
    nvcc = _fake_nvcc(sandbox, (
        'while [ $# -gt 0 ]; do [ "$1" = "-o" ] && out="$2"; shift; done\n'
        f'echo x >> "{calls}"\n'
        'echo "ptxas info : Used 8 registers" >&2\n'
        ': > "$out"\n'))
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    first = _build.build()
    assert first.is_file() and first.parent == sandbox / "_build"
    assert "Used 8 registers" in first.with_suffix(".log").read_text()
    assert _build.build() == first                  # cached: no rebuild
    assert calls.read_text().count("x") == 1
    fma = _build.build(fmad=True)                   # other flags, other file
    assert fma != first and calls.read_text().count("x") == 2
    (sandbox / "csrc" / "k.cu").write_text("// v2\n")
    second = _build.build()                         # changed source
    assert second != first and calls.read_text().count("x") == 3
    assert not list((sandbox / "_build").glob("*.tmp"))


def test_build_failure_raises_compiler_output(sandbox, monkeypatch):
    nvcc = _fake_nvcc(sandbox, 'echo "k.cu(3): error: boom" >&2\nexit 2\n')
    monkeypatch.setattr(_build, "nvcc_path", lambda: nvcc)
    with pytest.raises(RuntimeError, match="error: boom"):
        _build.build()
    assert not list((sandbox / "_build").glob("*.so*"))


def test_flags_target_hopper_without_fast_math():
    for fmad in (False, True):
        f = _build.flags(fmad)
        assert "arch=compute_90a,code=sm_90a" in f
        assert f"--fmad={'true' if fmad else 'false'}" in f
        assert not any("fast" in x for x in f)
