"""Builds the port's CUDA sources (``nlsolver_torch/csrc/*.cu``) into one
shared library with a plain C interface, at first use, and loads it with
``ctypes``.  Each source compiles in its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects.

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

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "nlsolver_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
# the dtypes the linear-algebra kernels are built for, by launcher suffix
DTYPE_SUFFIX = {torch.float32: "f32", torch.float64: "f64"}
# dynamic shared memory a block may opt in to on sm_90 (227 KB)
MAX_DYNAMIC_SMEM = 232448
# an SM of an H100: the shared memory its CTAs share (each also reserves 1
# KB) and its threads; the card's SMs, the default of the cluster plans
SM_SHARED, SM_THREADS, SMS = 233472, 2048, 132


def lanes_at_once(size: int, cta_bytes: int, cta_threads: int, sms: int = SMS) -> int:
    """Lanes of a kernel that gives a lane a cluster of ``size`` CTAs, each
    of ``cta_bytes`` bytes of shared memory and ``cta_threads`` threads,
    that ``sms`` SMs run at once: the CTAs an SM holds by either, over size."""
    return sms * min(SM_SHARED // (cta_bytes + 1024), SM_THREADS // cta_threads) // size


def cluster_size(sizes, cta_bytes, cta_threads, lanes=None, sms=SMS) -> int:
    """The cluster of the sizes ``sizes`` (CTAs a lane, ascending) whose CTAs
    of ``cta_bytes(C)`` bytes of shared memory fit a block and that runs the
    most of ``lanes`` lanes at once on ``sms`` SMs (``lanes_at_once`` with
    ``cta_threads(C)`` threads; the least such C), doubled (to at most the
    largest size) while ``lanes`` clusters of twice as many CTAs still find
    an SM each; 0 where no size fits."""
    fits = [c for c in sizes if cta_bytes(c) <= MAX_DYNAMIC_SMEM]
    if not fits:
        return 0
    size = max(fits, key=lambda c: (
        min(lanes or 1 << 40, lanes_at_once(c, cta_bytes(c), cta_threads(c), sms)), -c))
    while lanes and size < sizes[-1] and lanes * 2 * size <= sms:
        size *= 2
    return size


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


def nvcc_command(nvcc: str, srcs: list[Path], out: Path, compile_only: bool = False) -> list[str]:
    """The compile line: Hopper only (sm_90a), accurate math (no
    --use_fast_math), register and spill report from ptxas.  With
    ``compile_only`` it makes one object; otherwise the shared library."""
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-c" if compile_only else "-shared",
        "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-o", str(out), *map(str, srcs),
    ]


def ensure_built() -> tuple[Path, str]:
    """Build the library unless this tree's sources were built already.
    Returns its path and nvcc's output (empty when nothing was built)."""
    out = BUILD_DIR / f"lib_{source_digest()}.so"
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    tag = f"{out.stem}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}.{tag}.o" for src in sources()]
    tmp = out.with_name(f"{tag}.tmp.so")
    compiles = [nvcc_command(nvcc, [src], obj, compile_only=True)
                for src, obj in zip(sources(), objs)]
    log = []

    def finish(cmd, proc):
        output = proc.communicate()[0]
        log.append(output)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed (exit {proc.returncode}): {' '.join(cmd)}\n{output}")

    procs = []

    def start(cmd):
        procs.append(subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
        return procs[-1]

    try:
        for cmd, proc in zip(compiles, [start(cmd) for cmd in compiles]):
            finish(cmd, proc)
        link = nvcc_command(nvcc, objs, tmp)
        finish(link, start(link))
        os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file
    finally:
        for proc in procs:  # after a failure, stop the compiles still running
            if proc.poll() is None:
                proc.kill()
                proc.wait()
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)
    return out, "".join(log)


@functools.lru_cache(maxsize=None)
def load_library() -> ctypes.CDLL:
    path, _ = ensure_built()
    return ctypes.CDLL(str(path))


def check_cuda_inputs(name: str, tensors: dict) -> None:
    """Device, dtype and contiguity rules of the CUDA kernels (shapes are
    the caller's)."""
    first = next(iter(tensors.values()))
    if first.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {first.device}")
    for what, t in tensors.items():
        if t.device != first.device:
            raise ValueError(f"{name}: {what} is on {t.device}, expected {first.device}")
        if t.dtype not in DTYPE_SUFFIX:
            raise ValueError(f"{name}: {what} must be float32 or float64, got {t.dtype}")
        if t.dtype != first.dtype:
            raise ValueError(f"{name}: {what} is {t.dtype}, expected {first.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be contiguous")
