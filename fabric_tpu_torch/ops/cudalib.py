"""Build a CUDA source of the package with nvcc on first use and load it;
the checks every kernel wrapper makes before it launches.

A kernel source under `fabric_tpu_torch/csrc/` exposes a plain C interface
(raw pointers, ints, a stream) and is compiled for sm_90a into
`build/torch_kernels/<name>-<sha256 of the source>.so` at the root of the
checkout, then loaded with ctypes. A changed source gets a new file; an
unchanged one is built once. Nothing here runs at import time, and a
missing compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

import torch

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-O3",
    "-std=c++17",
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-shared",
    "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, Tuple[ctypes.CDLL, str]] = {}
# what the first load of each library in this process found: "builds"
# ran nvcc, "cache_hits" found the content-addressed library already
# built (a warm start). The serve registry reports both per bucket.
LOAD_EVENTS: Dict[str, int] = {"builds": 0, "cache_hits": 0}


def find_nvcc() -> str:
    for candidate in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if candidate and os.access(candidate, os.X_OK):
            return candidate
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _library_path(name: str) -> Tuple[Path, Path]:
    src = CSRC_DIR / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes()).hexdigest()
    return src, BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its content-addressed library exists.

    The compiler's `-Xptxas -v` report goes beside the library as
    `<library>.ptxas.txt`."""
    src, lib = _library_path(name)
    if lib.exists():
        return lib
    nvcc = find_nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(src)]
    proc = subprocess.run(cmd, capture_output=True, text=True, check=False)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed on {src.name} (rc {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    Path(f"{lib}.ptxas.txt").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, lib)
    return lib


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if needed."""
    with _lock:
        entry = _loaded.get(name)
        if entry is None:
            built = _library_path(name)[1].exists()
            lib = build(name)
            LOAD_EVENTS["cache_hits" if built else "builds"] += 1
            entry = (ctypes.CDLL(str(lib)), str(lib))
            _loaded[name] = entry
        return entry[0]


def ptxas_report(name: str) -> str:
    """The `-Xptxas -v` output recorded when csrc/<name>.cu was built."""
    _, lib = _library_path(name)
    return Path(f"{lib}.ptxas.txt").read_text()


def check_tensor(name: str, t: torch.Tensor, dtype: torch.dtype, shape, device) -> None:
    """Raise unless `t` is a contiguous tensor of `dtype` and `shape` on
    `device`: what a kernel takes."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def kernel_device(device: torch.device, what: str) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU tensor
    (run the plain version); anything else raises."""
    if device.type == "cuda":
        return True
    if device.type == "cpu":
        return False
    raise ValueError(f"no {what} kernel for device {device}")


def resolve_device(device, what: str) -> torch.device:
    """The device an entry point runs on: the card unless the caller asks
    for "cpu"; without a card, a request for it raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' to run the plain versions")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"no {what} kernel for device {dev}")
    return dev
