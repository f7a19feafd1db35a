"""Build the hand-written CUDA kernels under ``repro_torch/csrc`` at first use.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
into its own shared library for ``sm_90a``, loaded with ``ctypes``. The
library lands in ``repro_torch/_build/`` (ignored by git) under a name keyed
by a hash of the source, the headers in ``csrc`` and the flags, so an edited
source is rebuilt and an unchanged one is reused. No ``--use_fast_math``:
the kernels rely on IEEE division and separately rounded multiply/add to
match their plain versions bit for bit. Every ``nvcc`` run is reported to
the registered build listeners (``register_build_listener``) as a
``BUILD_EVENT`` with its seconds: ``obs.gauges.RecompileCounter`` counts
them.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parents[1]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_build"

# every kernel source of the package; build_all() compiles them in parallel
KERNEL_SOURCES = ("quant_int8", "flash_attn", "rwkv6_scan",
                  "rwkv6_scan_bwd")

# the event a build listener receives once for each library nvcc built
BUILD_EVENT = "repro_torch/kernels/build"
_BUILD_LISTENERS: list = []

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")


def register_build_listener(fn) -> None:
    """Call ``fn(BUILD_EVENT, seconds, name=...)`` after every successful
    ``nvcc`` run of ``build_all``."""
    if fn not in _BUILD_LISTENERS:
        _BUILD_LISTENERS.append(fn)


def unregister_build_listener(fn) -> None:
    if fn in _BUILD_LISTENERS:
        _BUILD_LISTENERS.remove(fn)


def nvcc_path() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda``,
    else ``nvcc`` on PATH. Raises when there is none."""
    candidates = [Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc"] \
        if os.environ.get("CUDA_HOME") else []
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                           "of repro_torch build only where the CUDA toolkit "
                           "is installed")
    return found


def library_path(name: str) -> Path:
    """Keyed by the source, every header beside it and the flags."""
    src = CSRC_DIR / f"{name}.cu"
    headers = b"".join(h.read_bytes() for h in sorted(CSRC_DIR.glob("*.h")))
    digest = hashlib.sha256(src.read_bytes() + headers
                            + "\0".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"lib{name}-{digest}.so"


def build_all(names=KERNEL_SOURCES) -> dict:
    """Compile every source in ``names`` that has no library yet, one
    ``nvcc`` per source, all started together. Returns ``{name: compiler
    log}`` (the ``-Xptxas=-v`` register/spill report; empty when the library
    was already built). Raises with the compiler's output on failure."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    logs = {}
    for name in names:
        out = library_path(name)
        if out.is_file():
            logs[name] = ""
            continue
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())  # repro: ignore[raw-timer] -- an nvcc process's wall time: host work, nothing queued on a device
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu "
                          f"(exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)   # atomic: a concurrent build never sees half a file
        seconds = time.perf_counter() - t0  # repro: ignore[raw-timer] -- an nvcc process's wall time: host work, nothing queued on a device
        for fn in list(_BUILD_LISTENERS):
            fn(BUILD_EVENT, seconds, name=name)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built first if
    needed. Callers declare ``argtypes``/``restype`` on its functions."""
    build_all((name,))
    return ctypes.CDLL(str(library_path(name)))
