"""Build the port's CUDA sources with nvcc on first use and load them.

Each library is compiled from the sources in the checkout into
``build/repro_torch/`` (listed in .gitignore) with a content hash of the
sources, the headers beside them and the flags in its file name, so a
stale library is never loaded (extra flags, such as -D values of a
kernel's instantiation, go after the common ones and into the hash):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/lib<name>_<hash>.so <sources>

ptxas's report of each kernel's registers, stack and spill bytes is kept
beside the library as lib<name>_<hash>.ptxas.txt (`build_log`).
`build_all` compiles several libraries with one nvcc process each, all
started together.  The sources have a plain C interface; the wrappers load
them with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

REPO_ROOT = Path(__file__).resolve().parents[3]
BUILD_DIR = REPO_ROOT / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in /usr/local/cuda/bin); the "
        "CUDA kernels are built from source on first use"
    )


def library_path(name: str, sources: list[Path], flags=()) -> Path:
    """The hashed library of ``sources``; the hash covers the sources, the
    headers (``*.cuh``) beside them and the flags."""
    h = hashlib.sha256()
    dirs = sorted({Path(src).parent for src in sources})
    headers = [hdr for d in dirs for hdr in sorted(d.glob("*.cuh"))]
    for src in (*sources, *headers):
        h.update(Path(src).read_bytes())
    h.update(" ".join((*NVCC_FLAGS, *flags)).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_log(name: str, sources: list[Path], flags=()) -> Path:
    """ptxas's resource report of the library's last build."""
    return library_path(name, sources, flags).with_suffix(".ptxas.txt")


def build_all(libs: list[tuple]) -> list[Path]:
    """Compile each (name, sources) or (name, sources, extra flags) library
    that does not exist yet, one nvcc process per library, all started
    together; raise if any fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    libs = [(name, sources, tuple(rest[0]) if rest else ())
            for name, sources, *rest in libs]
    jobs = []
    for name, sources, flags in libs:
        out = library_path(name, sources, flags)
        if out.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc_path(), *NVCC_FLAGS, *flags, "-o", tmp,
               *(str(s) for s in sources)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, sources, flags, out, tmp, cmd, proc))
    failed = []
    for name, sources, flags, out, tmp, cmd, proc in jobs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(f"nvcc failed building {name} ({proc.returncode}):"
                          f"\n{' '.join(cmd)}\n{log}")
            continue
        build_log(name, sources, flags).write_text(log)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return [library_path(*lib) for lib in libs]


def build(name: str, sources: list[Path]) -> Path:
    """Compile ``sources`` into the hashed library unless it exists."""
    return build_all([(name, sources)])[0]


def load_library(name: str, sources: list[Path]) -> ctypes.CDLL:
    """Build (if needed) and load one library."""
    return ctypes.CDLL(str(build(name, sources)))
