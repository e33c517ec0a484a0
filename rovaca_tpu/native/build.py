"""On-demand native builds: C++ (g++) and CUDA (nvcc) sources into shared libs.

Serves the role of the reference's CMake build for its native libs
(reference: CMakeLists.txt, build.sh) in a form that works from a pure
checkout: first use compiles, later uses load the cached library. Libraries
go to ``build/native/`` at the repository root, named by a key over the
source, the compile command and the host (name and CPU), so a library built
for another machine or from other sources is never loaded.
"""

import hashlib
import os
import platform
import shutil
import subprocess
import threading

# OpenMP defaults for the native batch libs, applied before libgomp loads.
# Active spin-waiting after each short parallel region starves the XLA/host
# pipeline threads (measured 8x end-to-end slowdown on a 2-core host);
# passive waiting + half the cores leaves the other half for XLA and IO.
os.environ.setdefault("OMP_WAIT_POLICY", "PASSIVE")
os.environ.setdefault(
    "OMP_NUM_THREADS",
    os.environ.get("ROVACA_NATIVE_THREADS")
    or str(max(1, (os.cpu_count() or 2) // 2)))

_DIR = os.path.dirname(os.path.abspath(__file__))
REPO_ROOT = os.path.dirname(os.path.dirname(_DIR))
BUILD_DIR = os.path.join(REPO_ROOT, "build", "native")
_LOCK = threading.Lock()


def host_key():
    """Host identity a -march=native build is valid for: machine name and
    the CPU model and feature flags."""
    cpu = []
    try:
        with open("/proc/cpuinfo") as fh:
            for line in fh:
                if line.startswith(("model name", "flags")) and \
                        line not in cpu:
                    cpu.append(line)
    except OSError:
        pass
    return "|".join([platform.node(), platform.machine(), *cpu])


def build_key(src, cmd):
    """Key of one build: the source bytes, the command and the host."""
    h = hashlib.sha256()
    with open(src, "rb") as fh:
        h.update(fh.read())
    h.update("\0".join(cmd).encode())
    h.update(host_key().encode())
    return h.hexdigest()[:16]


def _build(name, src, cmd):
    """Compile `src` with `cmd` (output path appended) unless a library
    with the same key exists; returns its path. Raises CalledProcessError
    or OSError on failure."""
    out = os.path.join(BUILD_DIR, f"{name}-{build_key(src, cmd)}.so")
    with _LOCK:
        if not os.path.exists(out):
            os.makedirs(BUILD_DIR, exist_ok=True)
            tmp = f"{out}.{os.getpid()}.tmp"
            subprocess.run([*cmd, "-o", tmp], check=True, capture_output=True,
                           text=True)
            os.replace(tmp, out)
    return out


def shared_lib(name, extra_flags=()):
    """Compile native/<name>.cpp with g++; return the library path, or None
    when the build fails."""
    src = os.path.join(_DIR, f"{name}.cpp")
    cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
           *extra_flags, src]
    try:
        return _build(name, src, cmd)
    except (subprocess.CalledProcessError, OSError):
        return None


def nvcc_path():
    return shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"


def cuda_lib(src):
    """Compile a CUDA source that defines XLA FFI handlers, for Hopper
    (sm_90a); return the library path. Raises RuntimeError with the
    compiler's output when the build fails."""
    import jax
    import jax.ffi

    name = os.path.splitext(os.path.basename(src))[0]
    # the JAX version define keys the build on the FFI headers it ships
    cmd = [nvcc_path(), "-gencode", "arch=compute_90a,code=sm_90a",
           "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
           f"-DROVACA_JAX_VERSION=\"{jax.__version__}\"",
           "-I", jax.ffi.include_dir(), src]
    try:
        return _build(name, src, cmd)
    except subprocess.CalledProcessError as exc:
        raise RuntimeError(f"nvcc failed for {src}:\n{exc.stderr}") from exc
    except OSError as exc:
        raise RuntimeError(f"cannot run nvcc for {src}: {exc}") from exc
