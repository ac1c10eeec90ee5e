"""Builds the port's CUDA sources (``nlsolver_torch/csrc/*.cu``) into one
shared library with a plain C interface, at first use, and loads it with
``ctypes``.

The library goes to ``build/nlsolver_torch/lib_<digest>.so`` beside the
package, where ``<digest>`` hashes the sources, so an edit rebuilds and an
unchanged tree reuses the file.  ``nvcc`` is looked up on ``PATH``, then
under ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``.  A failed build
raises with nvcc's error output; nothing falls back to another path.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nlsolver_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_digest() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc")
    candidates.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in candidates:
        if c.is_file():
            return str(c)
    raise RuntimeError(
        "nvcc not found on PATH, under $CUDA_HOME/bin or /usr/local/cuda/bin; "
        "the CUDA kernels of nlsolver_torch need the CUDA toolkit"
    )


def nvcc_command(nvcc: str, srcs: list[Path], out: Path) -> list[str]:
    """The compile line: Hopper only (sm_90a), accurate math (no
    --use_fast_math), register and spill report from ptxas."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out), *map(str, srcs),
    ]


def ensure_built() -> tuple[Path, str]:
    """Build the library unless this tree's sources were built already.
    Returns its path and nvcc's output (empty when nothing was built)."""
    out = BUILD_DIR / f"lib_{source_digest()}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cmd = nvcc_command(find_nvcc(), sources(), tmp)
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    return out, proc.stdout + proc.stderr


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    path, _ = ensure_built()
    return ctypes.CDLL(str(path))
