"""DenseCRF mask refinement (counterpart of the JAX package's
``models/crf.py``; reference ``evals/models/crf.py``).

Mean-field inference over the permutohedral lattice (Krähenbühl & Koltun
2011) with the reference's constants: MAX_ITER=10, a Gaussian pairwise term
(sxy=3, compat=7) and a bilateral one (sxy=50, srgb=5, compat=10)
(``crf.py:11-16``). The two-channel logits ``[1 - mask, mask]`` are
bilinearly resized in float32 to the image (``ops/image.py::resize``),
soft-maxed and handed to the repository's C++ implementation.

The library is built from the sources in ``native/densecrf/`` at first use,
with the Makefile's flags, into ``build/densecrf/`` (git-ignored), named by
a hash of the sources, the flags, the compiler's version and the target
that ``-march=native`` resolves to on this host, so a build copied from
another CPU is never loaded: it misses and is rebuilt here. Concurrent
processes take a file lock around the build, so one compiles and the
others load its result; the prebuilt library committed in
``native/densecrf/`` is never loaded. There is no fallback: a failed build, a failed load or a
non-zero return from the library raises (the JAX package falls back to an
approximate numpy mean field).
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

import numpy as np
import torch

from midvision_probe_torch.ops.image import resize

MAX_ITER = 10
POS_W = 7.0
POS_XY_STD = 3.0
BI_W = 10.0
BI_XY_STD = 50.0
BI_RGB_STD = 5.0

ROOT = Path(__file__).resolve().parents[2]
NATIVE_DIR = ROOT / "native" / "densecrf"
BUILD_DIR = ROOT / "build" / "densecrf"
SOURCES = ("densecrf.cpp", "permutohedral.cpp")
HEADERS = ("permutohedral.h",)
CXXFLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")

# the loaded library per (source dir, build dir)
_LOADED: dict[tuple[Path, Path], ctypes.CDLL] = {}
# the library's path and its build seconds (0.0 when it was already on disk)
BUILD_INFO: dict[str, object] = {}


def _compiler() -> str:
    for name in ("g++", "c++"):
        found = shutil.which(name)
        if found:
            return found
    raise RuntimeError("no C++ compiler (g++ or c++) found: the DenseCRF library is "
                       "built from native/densecrf/ on first use")


@functools.cache
def _host_target(compiler: str) -> bytes:
    """The compiler's version and the target options ``-march=native``
    resolves to on this CPU (its ``-Q --help=target`` report)."""
    out = []
    for args in (["--version"], ["-march=native", "-Q", "--help=target"]):
        proc = subprocess.run([compiler, *args], capture_output=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{compiler} {' '.join(args)} failed:\n"
                               f"{proc.stderr.decode(errors='replace')}")
        out.append(proc.stdout)
    return b"\n".join(out)


def library_path(src_dir: Path = NATIVE_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """Where the library built from ``src_dir`` for this host lies, named by
    a hash of the sources, the flags, the compiler and its CPU target."""
    digest = hashlib.sha256(" ".join(CXXFLAGS).encode())
    digest.update(_host_target(_compiler()))
    for name in SOURCES + HEADERS:
        path = Path(src_dir) / name
        if not path.is_file():
            raise FileNotFoundError(f"DenseCRF source missing: {path}")
        digest.update(path.read_bytes())
    return Path(build_dir) / f"libdensecrf_{digest.hexdigest()[:16]}.so"


def build_densecrf(src_dir: Path = NATIVE_DIR, build_dir: Path = BUILD_DIR) -> Path:
    """The DenseCRF library built from ``src_dir`` into ``build_dir`` for
    this host (kept when already built from the same sources, flags,
    compiler and CPU target); raises when a source is missing or the
    compiler fails."""
    src_dir, build_dir = Path(src_dir), Path(build_dir)
    so = library_path(src_dir, build_dir)
    if so.exists():
        if BUILD_INFO.get("path") != str(so):
            BUILD_INFO.update(path=str(so), seconds=0.0)
        return so
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / f"{so.stem}.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # one build; the others wait for it
        if so.exists():
            BUILD_INFO.update(path=str(so), seconds=0.0)
            return so
        tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
        cmd = [_compiler(), *CXXFLAGS, "-o", str(tmp), *(str(src_dir / s) for s in SOURCES)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building the DenseCRF library failed:\n{' '.join(cmd)}\n"
                               f"{proc.stdout}{proc.stderr}")
        os.replace(tmp, so)
    BUILD_INFO.update(path=str(so), seconds=time.perf_counter() - t0)
    return so


def load_densecrf(src_dir: Path = NATIVE_DIR, build_dir: Path = BUILD_DIR) -> ctypes.CDLL:
    """The loaded library, built first if needed."""
    key = (Path(src_dir), Path(build_dir))
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build_densecrf(src_dir, build_dir)))
        lib.dense_crf_inference.argtypes = [
            ctypes.POINTER(ctypes.c_ubyte),  # image HxWx3
            ctypes.POINTER(ctypes.c_float),  # unary probs CxHxW
            ctypes.c_int, ctypes.c_int, ctypes.c_int,  # H, W, C
            ctypes.c_int,  # iters
            ctypes.c_float, ctypes.c_float,  # pos_w, pos_xy_std
            ctypes.c_float, ctypes.c_float, ctypes.c_float,  # bi_w/xy/rgb
            ctypes.POINTER(ctypes.c_float),  # out QxCxHxW
        ]
        lib.dense_crf_inference.restype = ctypes.c_int
        _LOADED[key] = lib
    return lib


def _bilinear_resize(mask_chw: np.ndarray, hw) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(mask_chw.transpose(1, 2, 0)))
    return resize(x, hw, mode="bilinear").numpy().transpose(2, 0, 1)


def _softmax(x, axis=0):
    e = np.exp(x - x.max(axis=axis, keepdims=True))
    return e / e.sum(axis=axis, keepdims=True)


def densecrf(image: np.ndarray, mask: np.ndarray) -> np.ndarray:
    """Refine a soft binary mask against the RGB image (API of reference
    ``crf.py:19-49``).

    Args:
        image: (H, W, 3) uint8 (or [0,1]/[0,255] float).
        mask: (h, w) float foreground map (any resolution).

    Returns:
        (H, W) float32 hard MAP labels (0/1).
    """
    if image.dtype != np.uint8:
        img = image.astype(np.float32)
        if img.max() <= 1.5:
            img = img * 255.0
        image = np.clip(img, 0, 255).astype(np.uint8)

    h, w = mask.shape
    fg = mask.astype(np.float32).reshape(1, h, w)
    logits = np.concatenate([1.0 - fg, fg], axis=0)
    H, W = image.shape[:2]
    probs = _softmax(_bilinear_resize(logits, (H, W)), axis=0)
    C = probs.shape[0]

    lib = load_densecrf()
    # C-order buffers: the native side reads and writes row-major
    out = np.zeros(probs.shape, dtype=np.float32, order="C")
    img_c = np.ascontiguousarray(image)
    probs_c = np.ascontiguousarray(probs, dtype=np.float32)
    ret = lib.dense_crf_inference(
        img_c.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
        probs_c.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        H, W, C, MAX_ITER,
        POS_W, POS_XY_STD, BI_W, BI_XY_STD, BI_RGB_STD,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
    )
    if ret != 0:
        raise RuntimeError(f"dense_crf_inference returned {ret} on a {H}x{W}x{C} input")
    return np.argmax(out, axis=0).astype(np.float32)
