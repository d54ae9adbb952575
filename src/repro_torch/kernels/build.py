"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

At first use each source under ``csrc/`` is compiled for Hopper
(``sm_90a``) into a shared library with a plain C interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -O3 -std=c++17 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/kernels/<name>-<hash>.so <src>

The library lands in ``build/kernels/`` at the repository root (listed in
``.gitignore``); its name carries a hash of the source, of every header
under ``csrc/`` (``hopper.cuh``, which the tensor-core kernels include)
and of the flags, so a changed source or header is rebuilt.  ptxas's register and spill report is kept
beside it as ``<name>-<hash>.log``.  No PyTorch header is included, so a
build takes seconds; ``build_all`` starts one ``nvcc`` per source, all
together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = {"csvm_update": CSRC / "csvm_update.cu",
           "flash_attention": CSRC / "flash_attention.cu",
           "flash_backward": CSRC / "flash_backward.cu",
           "ssd_scan": CSRC / "ssd_scan.cu",
           "ssd_backward": CSRC / "ssd_backward.cu"}
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]

_loaded: Dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under ``CUDA_HOME`` or
    ``/usr/local/cuda``; raises when there is none."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA kernels build only where "
                       "the CUDA toolkit is installed")


def library_path(name: str) -> Path:
    """Where ``name``'s library is (or will be) for the current source and
    headers."""
    digest = hashlib.sha256(SOURCES[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``name``'s source unless its library is already built;
    returns the library's path."""
    return build_all([name])[name]


def build_all(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, Path]:
    """Compile the sources of ``names`` whose libraries are not built yet,
    one ``nvcc`` process each, all started together; returns every
    library's path.  Raises after all have ended if any failed."""
    paths = {name: library_path(name) for name in names}
    todo = [name for name, out in paths.items() if not out.exists()]
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    procs = {}
    for name in todo:
        tmp = paths[name].with_name(f"{paths[name].stem}.{os.getpid()}.tmp.so")
        procs[name] = (tmp, subprocess.Popen(
            [compiler, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (tmp, proc) in procs.items():
        report = proc.communicate()[0]
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(f"nvcc failed on {SOURCES[name]}:\n{report}")
            continue
        paths[name].with_suffix(".log").write_text(report)
        os.replace(tmp, paths[name])   # atomic: no reader sees a half file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """ptxas's report (registers, shared memory, spills) of the last build."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        lib = _loaded[name] = ctypes.CDLL(str(build(name)))
    return lib
