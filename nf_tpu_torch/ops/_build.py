"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` is compiled at first use with ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, and loaded
with ``ctypes``. A library named ``<name>@<bins>`` is the same source
built with ``-DNF_BINS=<bins>``, so that a source with many
instantiations (kernel E's) builds as one library per bin count, all at
once. The library's file name carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is reused. Output
goes to ``nf_tpu_torch/_build/`` (listed in ``.gitignore``).

Nothing here runs at import time: the CPU tests import every module of
the package on machines with no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# -fmad=false: no contraction of a*b+c into one rounding, so the kernels
# round as the plain version's separate PyTorch ops do. With contraction,
# kernel A and its plain version differed by 1.4e-5 on spline outputs at
# B = 65536 on the H100, over the 1e-5 bar; explicit fmaf() calls (kernel
# B's head product) are not affected.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v")

_LIBS: dict = {}
_LOCK = threading.Lock()
# ptxas register/spill report of the last build of each library
BUILD_LOGS: dict = {}


def set_build_dir(path):
    """Build and look up the libraries in ``path`` from now on
    (``utils.profiling.enable_compilation_cache``)."""
    global BUILD_DIR
    BUILD_DIR = os.path.abspath(path)


def _nvcc():
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels of nf_tpu_torch "
                       "are built at first use and need the CUDA toolkit")


def _flags(name):
    """The source of library ``name`` and the flags it is built with."""
    source, _, bins = name.partition("@")
    return source, NVCC_FLAGS + ((f"-DNF_BINS={int(bins)}",) if bins else ())


def _sources(name):
    """The ``.cu`` file and every header of ``csrc/``, in a fixed order."""
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    return [os.path.join(CSRC, _flags(name)[0] + ".cu")] + [
        os.path.join(CSRC, h) for h in headers]


def _lib_path(name):
    h = hashlib.sha1(" ".join(_flags(name)[1]).encode())
    for path in _sources(name):
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name.replace('@', '-k')}-"
                        f"{h.hexdigest()[:12]}.so")


def _start(name):
    """Start ``nvcc`` for ``csrc/<name>.cu``; returns (process, target,
    temporary output) or None if the library is already built."""
    target = _lib_path(name)
    if os.path.exists(target):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{target}.{os.getpid()}.tmp"
    source, flags = _flags(name)
    cmd = [_nvcc(), *flags, "-I", CSRC, "-o", tmp,
           os.path.join(CSRC, source + ".cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, target, tmp


def _finish(name, started):
    proc, target, tmp = started
    out, _ = proc.communicate()
    BUILD_LOGS[name] = out
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name} "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, target)


def build(names):
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together."""
    started = {n: _start(n) for n in names}
    for n, s in started.items():
        if s is not None:
            _finish(n, s)


def load(name):
    """The ``ctypes`` handle of library ``name``, built if needed.

    Building and loading run ``nvcc`` and initialise the library's CUDA
    runtime, which a stream capture may not record: a CUDA graph
    (``nf_tpu_torch.serving``, the captured training steps) loads every
    library it needs in its eager warm-up calls, and a library first
    asked for while the current stream is capturing raises."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            import torch

            if (torch.cuda.is_available()
                    and torch.cuda.is_current_stream_capturing()):
                raise RuntimeError(
                    f"CUDA library {name} is not loaded and the stream is "
                    f"capturing a graph: the warm-up calls before the "
                    f"capture must run the path that loads it")
            build([name])
            lib = ctypes.CDLL(_lib_path(name))
            _LIBS[name] = lib
        return lib
