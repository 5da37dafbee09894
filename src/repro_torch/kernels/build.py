"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` for Hopper (``sm_90a``) into ``build/repro_torch/`` at the repo
root — a directory ``.gitignore`` lists.  The library's file name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header rebuilds and concurrent builds never load
a half-written file (each writes a private temporary and renames it
into place).  The compiler's report
(``-Xptxas -v``: registers, spills) is kept beside each library.  Nothing
is built when this module is imported; :func:`load` builds on the first
call and :func:`build` starts one ``nvcc`` per source, all at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parents[1] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

#: every CUDA source of the port (``csrc/<name>.cu``)
SOURCES = ("masked_select", "flash_attention", "ssd_scan")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    """``nvcc`` from ``$CUDA_HOME`` (default ``/usr/local/cuda``), else
    the one on ``PATH``; raises when neither exists."""
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on "
                           "PATH to build the port's CUDA kernels")
    return found


def library_path(name: str) -> Path:
    """The library of ``csrc/<name>.cu``, named by a hash of the source,
    of every header in ``csrc/`` (``*.cuh``) and of the flags."""
    src = (CSRC / f"{name}.cu").read_bytes()
    src += b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def report_path(name: str) -> Path:
    """Where the ``-Xptxas -v`` report of :func:`library_path` is kept."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(names=SOURCES) -> dict[str, str]:
    """Compile every source in ``names`` that has no current library, one
    ``nvcc`` process each, all started together.  Returns the compiler's
    report (``-Xptxas -v``: registers, spills) per newly built source;
    raises with the compiler output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    procs = {}
    for name in names:
        out = library_path(name)
        if out.exists():
            continue
        nvcc = nvcc or nvcc_path()
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp, out)
    reports, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        log_tmp = tmp.with_suffix(".ptxas.tmp")
        log_tmp.write_text(log)
        os.replace(log_tmp, report_path(name))
        os.replace(tmp, out)
        reports[name] = log
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return reports


def ptxas_report(name: str) -> str:
    """The ``-Xptxas -v`` report of ``csrc/<name>.cu``'s current library,
    built first if needed."""
    build((name,))
    return report_path(name).read_text()


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build((name,))
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
    return lib
