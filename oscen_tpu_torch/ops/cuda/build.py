"""Build the package's CUDA sources into plain-C shared libraries.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``oscen_tpu_torch/_build/lib<name>-<digest>.so`` at first use and loaded
with ``ctypes``.  The digest covers the source and the flags, so an edited
source rebuilds.  The build uses only the sources in the package; a missing
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

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "_build"

# --fmad=false: products and sums round as PyTorch's separate elementwise
# ops do, so a kernel's state matches its plain version bit for bit.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
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


def load_library(name: str) -> ctypes.CDLL:
    """Build (once per source digest) and load ``csrc/<name>.cu``."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"lib{name}-{digest}.so"
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
        build_info[name] = (time.perf_counter() - t0,
                            proc.stdout + proc.stderr)
    lib = ctypes.CDLL(str(out))
    _libs[name] = lib
    return lib
