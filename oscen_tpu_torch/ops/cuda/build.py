"""Build the package's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``oscen_tpu_torch/_build/lib<name>-<digest>.so`` at first use and loaded
with ``ctypes``.  The digest covers the source, every header under
``csrc/`` (``*.cuh``, which the sources include) and the flags, so an
edited source or header rebuilds.  The build uses only the sources in the package; a missing
``nvcc`` or a failed compile raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Tuple

import torch

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# --fmad=false: products and sums round as PyTorch's separate elementwise
# ops do, so a kernel's state matches its plain version bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

# every source of csrc/ that a path or a check of the package launches
SOURCES = ("additive", "phase", "iir", "adsr", "fm", "kabl", "kabl_hmaj",
           "fractabl")

_libs: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# name -> (build seconds, nvcc's diagnostics incl. -Xptxas -v register use)
build_info: Dict[str, Tuple[float, str]] = {}


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [shutil.which("nvcc")]
    if home:
        candidates.append(str(Path(home) / "bin" / "nvcc"))
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if c and Path(c).exists():
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (set CUDA_HOME or put nvcc on PATH)")


def source_digest(name: str, csrc: Path = CSRC_DIR) -> str:
    """The build key of ``csrc/<name>.cu``: its bytes, every ``*.cuh``
    beside it (name and bytes, in name order) and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for hdr in sorted(csrc.glob("*.cuh")):
        h.update(hdr.name.encode() + b"\0" + hdr.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def load_library(name: str, csrc: Path = CSRC_DIR) -> ctypes.CDLL:
    """Build (once per source digest) and load ``csrc/<name>.cu``; another
    ``csrc`` directory (an older tree's, for an A/B timing) builds beside
    the package's own libraries under its own digest."""
    key = name if csrc == CSRC_DIR else f"{name}@{csrc}"
    lib = _libs.get(key)
    if lib is not None:
        return lib
    src = csrc / f"{name}.cu"
    out = BUILD_DIR / f"lib{name}-{source_digest(name, csrc)}.so"
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed on {src.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, out)
        build_info[key] = (time.perf_counter() - t0,
                           proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    _libs[key] = lib
    return lib


def load_all(names: Tuple[str, ...] = SOURCES) -> None:
    """Build and load ``names`` (by default every source) in parallel, one
    ``nvcc`` each; raises if any fails."""
    from concurrent.futures import ThreadPoolExecutor
    with ThreadPoolExecutor(len(names)) as pool:
        list(pool.map(load_library, names))


def entry(name: str, symbol: str, n_ptr: int, n_int: int, n_float: int = 0):
    """``csrc/<name>.cu``'s C entry point ``symbol``, typed for ctypes:
    ``n_ptr`` pointers, ``n_int`` ints, ``n_float`` floats, then the
    stream; returns the launch's CUDA error code (built and typed at first
    use)."""
    fn = _entries.get((name, symbol))
    if fn is None:
        fn = getattr(load_library(name), symbol)
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                       + [ctypes.c_float] * n_float + [ctypes.c_void_p])
        _entries[(name, symbol)] = fn
    return fn


def check_launch(name: str, rc: int, what: str) -> None:
    """Raise if a launch from ``csrc/<name>.cu`` returned an error."""
    if rc != 0:
        fn = load_library(name).oscen_cuda_error_string
        fn.restype = ctypes.c_char_p
        fn.argtypes = [ctypes.c_int]
        raise RuntimeError(
            f"{what} kernel launch failed: {fn(rc).decode()} ({rc})")


def run_sweep(name: str, symbol: str, dev) -> Tuple[int, int]:
    """Run ``csrc/<name>.cu``'s sweep ``symbol`` over all 2^32 float32
    patterns on the card ``dev``: (patterns where its short path differs
    from the reference, patterns the short path takes)."""
    counts = torch.zeros(2, dtype=torch.int64, device=dev)
    check_launch(name, entry(name, symbol, 1, 0)(
        counts.data_ptr(), torch.cuda.current_stream(dev).cuda_stream),
        symbol)
    wrong, taken = counts.tolist()
    return wrong, taken


def check_operands(dev, **tensors) -> None:
    """The operands a kernel takes: contiguous float32 tensors on ``dev``."""
    for nm, t in tensors.items():
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError(
                f"{nm} must be a contiguous float32 tensor on {dev} (got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}, contiguous="
                f"{t.is_contiguous()})")
