"""Engine choice, compile-cache location and native build keys."""

import os
import subprocess
import sys

import pytest

from rovaca_tpu.native import build
from rovaca_tpu.ops.pairhmm import api
from rovaca_tpu.utils import platform

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _backend(monkeypatch, pinned, backend):
    import jax
    if pinned:
        monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    else:
        monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    monkeypatch.setattr(jax, "default_backend", lambda: backend)


@pytest.mark.parametrize("pinned,backend,want", [
    (False, "gpu", "cuda"),
    (True, "cpu", "native"),
    (True, "gpu", "native"),     # the pin wins; JAX is never asked
])
def test_auto_engine(monkeypatch, pinned, backend, want):
    _backend(monkeypatch, pinned, backend)
    assert api.choose_engine("auto") == want


def test_auto_without_gpu_or_pin_is_an_error(monkeypatch):
    _backend(monkeypatch, False, "cpu")
    with pytest.raises(api.NoDeviceError, match="JAX_PLATFORMS=cpu"):
        api.choose_engine()


@pytest.mark.parametrize("name", ["cuda", "xla", "native"])
def test_named_engine_is_kept(monkeypatch, name):
    _backend(monkeypatch, False, "cpu")
    assert api.choose_engine(name) == name


def test_unknown_engine(monkeypatch):
    with pytest.raises(ValueError):
        api.choose_engine("pallas")


def test_indexed_launch_per_engine():
    from rovaca_tpu.ops.pairhmm.compact import pairhmm_indexed_compact
    from rovaca_tpu.ops.pairhmm.cuda import pairhmm_cuda_indexed
    assert api.indexed_launch("cuda") is pairhmm_cuda_indexed
    assert api.indexed_launch("xla") is pairhmm_indexed_compact
    with pytest.raises(ValueError, match="no device launch"):
        api.indexed_launch("native")


def test_cli_reports_missing_gpu(monkeypatch, tmp_path, capsys):
    """An unpinned run with no GPU stops with an error instead of scoring
    on the host."""
    import simdata
    from rovaca_tpu import cli
    _backend(monkeypatch, False, "cpu")
    # a set variable makes the cache setup a no-op for this process
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    fasta, bam, _, _ = simdata.make_standard_case(tmp_path)
    rc = cli.main(["HaplotypeCaller", "-i", bam, "-r", fasta,
                   "-o", str(tmp_path / "o.vcf")])
    assert rc == 2
    assert "JAX_PLATFORMS=cpu" in capsys.readouterr().err


def test_compile_cache_from_env(monkeypatch, tmp_path):
    import jax
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    assert platform.compile_cache_dir() == str(tmp_path)
    platform.enable_persistent_compilation_cache()
    assert calls == []       # JAX reads the variable itself


def test_compile_cache_in_checkout(monkeypatch):
    import jax
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    monkeypatch.delenv("JAX_PLATFORMS", raising=False)
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda *a: calls.append(a))
    want = os.path.join(REPO, "build", "jax_cache")
    assert platform.compile_cache_dir() == want
    platform.enable_persistent_compilation_cache()
    assert calls == [("jax_compilation_cache_dir", want)]
    with open(os.path.join(REPO, ".gitignore")) as fh:
        assert "build/" in fh.read().split()


def test_build_key_tracks_source_command_and_host(monkeypatch, tmp_path):
    src = tmp_path / "x.cpp"
    src.write_text("int f() { return 1; }\n")
    k = build.build_key(str(src), ["g++", "-O3"])
    assert build.build_key(str(src), ["g++", "-O3"]) == k
    assert build.build_key(str(src), ["g++", "-O2"]) != k
    monkeypatch.setattr(build, "host_key", lambda: "another-host")
    assert build.build_key(str(src), ["g++", "-O3"]) != k
    src.write_text("int f() { return 2; }\n")
    assert build.build_key(str(src), ["g++", "-O2"]) != k


def test_native_libs_built_per_key():
    from rovaca_tpu.native import pairhmm_native
    assert pairhmm_native.available()
    path = build.shared_lib("pairhmm_cpu", extra_flags=("-fopenmp",))
    assert os.path.dirname(path) == build.BUILD_DIR
    name = os.path.basename(path)
    src = os.path.join(os.path.dirname(build.__file__), "pairhmm_cpu.cpp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           "-fopenmp", src]
    assert name == f"pairhmm_cpu-{build.build_key(src, cmd)}.so"


def test_chip_smoke_fails_without_gpu():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    cp = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                        env=env, capture_output=True, text=True, timeout=300)
    assert cp.returncode != 0
    assert '"ok": true' not in cp.stdout
