"""Build the port's CUDA sources (``csrc/*.cu``) at first use.

Each source becomes a shared library with a plain C interface, compiled
by ``nvcc`` for ``sm_90a`` and loaded with ``ctypes``. Libraries land in
``build/torch_kernels/<hash>/`` at the root of the checkout (listed in
``.gitignore``), keyed on a hash of every source and the flags, so an
edited source is rebuilt and an unchanged one is reused. All missing
libraries are compiled in parallel, one ``nvcc`` per source. A missing
``nvcc`` or a failed compile raises: there is no fallback. ``launch``
calls a kernel's C entry point and counts the launch in ``ops.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

from k8s_dra_driver_tpu_torch.ops import LAUNCHES

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# Compiler output (ptxas register and shared-memory report) by kernel name,
# kept for the caller to print.
BUILD_LOGS: Dict[str, str] = {}
_LIBS: Dict[str, ctypes.CDLL] = {}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of ``nvcc``: on PATH, else under the toolkit PyTorch finds."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (not on PATH, no CUDA toolkit): the "
                       "port's CUDA kernels cannot be built")


def build_dir() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        if p.suffix in (".cu", ".cuh", ".h"):
            h.update(p.name.encode())
            h.update(p.read_bytes())
    return BUILD_ROOT / h.hexdigest()[:16]


def build_all() -> float:
    """Compile every source whose library is missing, all at once.
    Returns the wall seconds spent; raises if any compile fails."""
    out = build_dir()
    todo = [s for s in sources() if not (out / f"lib{s.stem}.so").exists()]
    if not todo:
        return 0.0
    exe = nvcc()
    out.mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    procs = []
    for src in todo:
        tmp = out / f"lib{src.stem}.so.{os.getpid()}.tmp"
        cmd = [exe, *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for src, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOGS[src.stem] = log
        if proc.returncode != 0:
            failed.append(f"{src.name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out / f"lib{src.stem}.so")
    if failed:
        raise RuntimeError("building the port's CUDA kernels failed:\n"
                           + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The shared library built from ``csrc/<name>.cu``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        if not (CSRC / f"{name}.cu").exists():
            raise FileNotFoundError(f"no CUDA source {name}.cu in {CSRC}")
        build_all()
        lib = ctypes.CDLL(str(build_dir() / f"lib{name}.so"))
        _LIBS[name] = lib
    return lib


def launch(name: str, device: torch.device, *args) -> None:
    """Call the C function ``name`` of ``lib<name>.so`` with ``args``
    (tensors pass their data pointers, ints and floats pass as C ints and
    floats) and the current CUDA stream of ``device``; raise if it returns
    a CUDA error, else count one launch of ``name``."""
    fn = getattr(load(name), name)
    kinds = {int: ctypes.c_int, float: ctypes.c_float}
    fn.argtypes = [ctypes.c_void_p if isinstance(a, torch.Tensor) else kinds[type(a)]
                   for a in args] + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = fn(*(a.data_ptr() if isinstance(a, torch.Tensor) else a for a in args),
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCHES[name] += 1
