"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Each ``csrc/<name>.cu`` exports a plain C function; it is compiled for
``sm_90a`` into its own shared library under ``build/repro_torch_kernels/``
at the repository root, named by a hash of its source and flags, so an
edited source is rebuilt and an unchanged one is reused.  Sources are built
in parallel, one ``nvcc`` each.  Nothing is fetched; a host without
``nvcc`` raises.  Only CUDA tensors ever reach this module (the CPU uses
the plain versions in :mod:`repro_torch.kernels.ops`).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

SRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source (``csrc/<name>.cu``)."""
    return sorted(p.stem for p in SRC_DIR.glob("*.cu"))


def _nvcc() -> str:
    path = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                           "the CUDA kernels are built from csrc/ at first use")
    return path


def _target(name: str) -> Path:
    digest = hashlib.sha256((SRC_DIR / f"{name}.cu").read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{digest.hexdigest()[:16]}.so"


def build(names: list[str] | None = None) -> dict[str, dict]:
    """Compile every named source (default: all) whose library is missing,
    all ``nvcc`` processes at once.  Returns ``{name: {"seconds", "log",
    "path"}}`` — ``log`` is nvcc's output (``-Xptxas -v``: registers,
    shared memory and spills per kernel), empty for a reused library."""
    names = sources() if names is None else names
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report: dict[str, dict] = {}
    running = {}
    for name in names:
        target = _target(name)
        if target.exists():
            report[name] = {"seconds": 0.0, "log": "", "path": str(target)}
            continue
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
        running[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                          stderr=subprocess.STDOUT, text=True),
                         time.perf_counter(), tmp, target)
    failed = []
    for name, (proc, t0, tmp, target) in running.items():
        log, _ = proc.communicate()
        seconds = time.perf_counter() - t0
        if proc.returncode:
            failed.append(f"{name}.cu:\n{log}")
            continue
        os.replace(tmp, target)   # atomic: a half-written library is never loaded
        report[name] = {"seconds": seconds, "log": log, "path": str(target)}
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu`` (built on first use)."""
    if name not in _LIBS:
        path = build([name])[name]["path"]
        _LIBS[name] = ctypes.CDLL(path)
    return _LIBS[name]
