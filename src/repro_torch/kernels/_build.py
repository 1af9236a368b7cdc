"""Build and load the hand-written CUDA kernels (``repro_torch/csrc``).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper (``sm_90a``)
into a shared library with a plain C interface and loaded with ``ctypes``.
The build happens at first use, into ``repro_torch/_build/`` (listed in
``.gitignore``), from the checkout's sources only; the library name carries
a hash of the source, the shared headers (``csrc/*.cuh``) and the flags,
so an edited source or header is rebuilt.
``build(names)`` compiles several sources in parallel, one ``nvcc`` each.

The simulator's kernels are compiled with ``--fmad=false``: they are held
bit for bit against their plain PyTorch versions, which round each
multiply and add separately.  The model-zoo kernels (``FMAD_FLAGS``) are
held within a stated tolerance and keep nvcc's fused multiply-adds.  Every
build also asks ``ptxas`` for its register and spill report.
Each build's compiler output is kept beside its library (``log(name)``).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

_PKG = Path(__file__).resolve().parents[1]
SRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC")
# per-source flags, in place of NVCC_FLAGS for the sources named here
FMAD_FLAGS = tuple(f for f in NVCC_FLAGS if f != "--fmad=false")
SOURCE_FLAGS = {"cloudlet_finish": NVCC_FLAGS + ("-Xptxas=-v",),
                "tropical": NVCC_FLAGS + ("-Xptxas=-v",),
                "link_share": NVCC_FLAGS + ("-Xptxas=-v",),
                "flash_attention": FMAD_FLAGS + ("-Xptxas=-v",),
                "ssd_chunk": FMAD_FLAGS + ("-Xptxas=-v",),
                "flash_attention_bwd": FMAD_FLAGS + ("-Xptxas=-v",),
                "ssd_chunk_bwd": FMAD_FLAGS + ("-Xptxas=-v",)}

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()
# nvcc runs started in this process (the recompile sentinel's counter,
# ``analysis.recompile``)
builds = 0


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and Path("/usr/local/cuda/bin/nvcc").exists():
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "are built on a machine with the CUDA toolkit")
    return path


def _flags(name: str) -> tuple:
    return SOURCE_FLAGS.get(name, NVCC_FLAGS)


def library(name: str) -> Path:
    """The path of ``csrc/<name>.cu``'s library (built or not)."""
    src = (SRC_DIR / f"{name}.cu").read_bytes() + b"".join(
        h.read_bytes() for h in sorted(SRC_DIR.glob("*.cuh")))
    tag = hashlib.sha256(src + " ".join(_flags(name)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{tag[:12]}.so"


def _start(name: str):
    out = library(name)
    if out.exists():
        return None
    global builds
    builds += 1
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *_flags(name), "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True), tmp, out


def build(names: Iterable[str]) -> None:
    """Compile the named sources (those not built yet) in parallel."""
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        errors = []
        for name, job in jobs:
            if job is None:
                continue
            proc, tmp, out = job
            text, _ = proc.communicate()
            if proc.returncode != 0:
                errors.append(f"nvcc failed for {name}.cu:\n{text}")
                continue
            out.with_suffix(".log").write_text(text)
            os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))


def log(name: str) -> str:
    """The compiler's output of the build of ``csrc/<name>.cu`` ("" before
    it is built)."""
    path = library(name).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    lib = _LIBS.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(library(name)))
        _LIBS[name] = lib
    return lib
