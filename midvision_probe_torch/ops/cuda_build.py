"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled with
``nvcc`` into its own shared library on first use, then loaded with
``ctypes``. Libraries land in ``build/torch_kernels/`` at the repository
root (git-ignored), named by a hash of the source, the shared headers and
the flags, so a changed source never loads a stale build. The ``wgmma``
kernels need the ``sm_90a`` target; their TMA tensor maps are encoded
through ``cudaGetDriverEntryPoint``, so nothing links libcuda.
``build_all`` starts one ``nvcc`` per source at once. Nothing here runs at
import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNEL_SOURCES = ("vit_attention", "knn2", "rope2d", "bench_attn", "fused_mlp",
                  "attention_bwd")

_LOADED: dict[str, ctypes.CDLL] = {}
# per source: build seconds (0.0 when the library was already on disk) and
# the compiler's output (-Xptxas -v register / shared-memory report)
BUILD_INFO: dict[str, dict] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels are built on first use "
                       "and need the CUDA toolkit")


def _library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names=KERNEL_SOURCES) -> dict[str, Path]:
    """Compile every source whose library is missing, all nvcc processes in
    parallel; raise with the compiler's output if any build fails."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = _library_path(name)
        if so.exists():
            BUILD_INFO.setdefault(name, {"seconds": 0.0, "log": ""})
            continue
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, so, time.perf_counter())
    failed = []
    for name, (proc, tmp, so, t0) in procs.items():
        log, _ = proc.communicate()
        BUILD_INFO[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{log}")
            continue
        os.replace(tmp, so)  # atomic against a concurrent build
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: _library_path(name) for name in names}


def float_bits(x: float) -> int:
    """The 32-bit pattern of ``x`` rounded to float32, as a C int: the C
    entry points take their float arguments this way (every argument is a
    pointer or an integer)."""
    return struct.unpack("<i", struct.pack("<f", x))[0]


def load_library(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built if needed."""
    lib = _LOADED.get(name)
    if lib is None:
        path = build_all((name,))[name]
        lib = _LOADED[name] = ctypes.CDLL(str(path))
    return lib
