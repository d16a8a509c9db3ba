"""Build the hand-written CUDA kernels at first use and load them with ctypes.

Each ``csrc/*.cu`` becomes one shared library with a plain C interface,
compiled by ``nvcc`` for ``sm_90a`` into ``build/repro_torch/`` at the root
of the checkout.  A library's file name carries a hash of its source and
flags, so an edited source rebuilds and an unchanged one loads as it is.
All sources compile at once, one ``nvcc`` each.  A failed build raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


@dataclasses.dataclass(frozen=True)
class Built:
    """One compiled source: the library's path, how long ``nvcc`` took
    (0.0 when the library was already built) and the compiler's report
    (``-Xptxas -v``: registers and shared memory per kernel)."""
    path: Path
    seconds: float
    log: str


_lock = threading.Lock()
_built: Dict[str, Built] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): "
                       "the CUDA kernels cannot be built on this host")


def _target(src: Path) -> Path:
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}-{key.hexdigest()[:16]}.so"


def build_all() -> Dict[str, Built]:
    """Compile every ``csrc/*.cu`` not built yet, all in parallel; return
    ``{source stem: Built}``.  Raises ``RuntimeError`` if any build fails."""
    with _lock:
        if _built:
            return dict(_built)
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        pending = {}
        for src in sorted(CSRC.glob("*.cu")):
            out = _target(src)
            if out.exists():
                log = out.with_suffix(".log")
                _built[src.stem] = Built(
                    out, 0.0, log.read_text() if log.exists() else "")
                continue
            tmp = out.with_name(f"tmp{os.getpid()}-{out.name}")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            pending[src.stem] = (proc, tmp, out, time.monotonic())
        failures = []
        for stem, (proc, tmp, out, t0) in pending.items():
            log, _ = proc.communicate()
            if proc.returncode != 0:
                failures.append(f"{stem}.cu (nvcc exit {proc.returncode}):\n"
                                f"{log}")
                continue
            os.replace(tmp, out)
            out.with_suffix(".log").write_text(log)
            _built[stem] = Built(out, time.monotonic() - t0, log)
        if failures:
            _built.clear()
            raise RuntimeError("CUDA kernel build failed:\n" +
                               "\n".join(failures))
        return dict(_built)


def library(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``."""
    if stem not in _libs:
        built = build_all()
        if stem not in built:
            raise RuntimeError(f"no CUDA source csrc/{stem}.cu")
        with _lock:
            _libs.setdefault(stem, ctypes.CDLL(str(built[stem].path)))
    return _libs[stem]
