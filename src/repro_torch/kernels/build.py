"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source in ``repro_torch/csrc/`` exposes a plain C interface and
is compiled on first use by ``nvcc`` for Hopper (``sm_90a``) into its own
shared library, loaded with ``ctypes``.  A library's file name carries a
hash of its source and flags, so an edited source never loads a stale
build; the build directory (``repro_torch/_build/``) is ignored by git.
Beside each library lies its ``ptxas`` report (``.ptxas``: registers and
spills of every kernel), so a cached build still reports them.
Compiles write to a temporary name and ``os.replace`` it into place, so
two threads (or processes) racing on the same build cannot tear a file.

``LAUNCHES`` counts, per kernel, the launches its wrapper made -- the proof
that a run went through the kernels rather than their plain versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

CSRC = os.path.join(os.path.dirname(os.path.dirname(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(__file__)), "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
#: kernel sources, one shared library each
SOURCES = ("dct8", "resize", "mamba_scan", "attention", "rglru")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    return os.path.join(home, "bin", "nvcc")


def _target(name: str) -> tuple[str, str]:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode())
    return src, os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:12]}.so")


def _report(lib: str) -> str:
    """Where the ptxas report of the library ``lib`` is kept."""
    return lib[:-len(".so")] + ".ptxas"


def compile_all(names=SOURCES) -> dict[str, str]:
    """Compile every missing library, one ``nvcc`` per source, all started
    together.  Returns ``{name: ptxas report}`` of every library asked for,
    built now or before; raises with the compiler's output if one fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        src, out = _target(name)
        if os.path.exists(out) and os.path.exists(_report(out)):
            continue
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc_path(), *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    failed = []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {name}.cu failed ({proc.returncode}):\n{log}")
            continue
        # the report first, so that a library on disk has its report
        with open(f"{tmp}.ptxas", "w") as f:
            f.write(log)
        os.replace(f"{tmp}.ptxas", _report(out))
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    reports = {}
    for name in names:
        with open(_report(_target(name)[1])) as f:
            reports[name] = f.read()
    return reports


class _Libraries:
    """Loaded kernel libraries, one per source, built at first use."""

    def __init__(self):
        self._mu = threading.Lock()
        self._libs: dict[str, ctypes.CDLL] = {}  # guarded-by: _mu

    def get(self, name: str) -> ctypes.CDLL:
        with self._mu:
            lib = self._libs.get(name)
        if lib is not None:
            return lib
        compile_all((name,))  # outside the lock: nvcc takes seconds
        lib = ctypes.CDLL(_target(name)[1])
        with self._mu:
            return self._libs.setdefault(name, lib)


LIBRARIES = _Libraries()


class LaunchCounts:
    """Per-kernel launch counters, safe to bump from several threads."""

    def __init__(self):
        self._mu = threading.Lock()
        self._n: dict[str, int] = {}  # guarded-by: _mu

    def add(self, name: str) -> None:
        with self._mu:
            self._n[name] = self._n.get(name, 0) + 1

    def reset(self) -> None:
        with self._mu:
            self._n.clear()

    def snapshot(self) -> dict[str, int]:
        with self._mu:
            return dict(self._n)


LAUNCHES = LaunchCounts()


def check_launch(name: str, rc: int) -> None:
    """Raise on a refused launch (the C side returns cudaGetLastError())."""
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
