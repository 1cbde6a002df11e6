"""Build and bind the port's CUDA kernels.

Each kernel source under ``src/repro_torch/csrc/`` has a plain C interface
(pointers, ints and the stream; no PyTorch headers) and is compiled with
``nvcc -gencode arch=compute_90a,code=sm_90a`` into its own shared library
under ``build/kernels/`` at the root of the checkout, at first use. The
library is named after its source and carries a hash of the source, the
shared headers (``csrc/*.cuh``) and the flags, so an edited source or header
is rebuilt and an unchanged one is loaded as it is. Kernels exported by one
source share its library. Libraries are bound with ``ctypes``: every
pointer and the stream are ``c_void_p``, every int ``c_int``.

A :class:`CudaKernel` counts its successful launches in ``launches`` (a
plain integer), so a run can show which kernels its main path went
through; a :class:`KernelForm` counts one form of them apart. A launch
whose C function returns a non-zero ``cudaError_t`` (the
``cudaGetLastError()`` right after the launch) raises.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Iterable, List, Optional, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from ``$CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH, $CUDA_HOME and /usr/local/cuda): "
        "the port's CUDA kernels are compiled at first use on the machine "
        "with the card")


class CudaKernel:
    """One ``.cu`` source → one shared library → one exported C function.

    ``argtypes`` lists the C function's parameters (``c_void_p`` for
    pointers and the stream, ``c_int`` for ints); it returns ``int``.
    """

    def __init__(self, name: str, source: str, symbol: str,
                 argtypes: Sequence):
        self.name = name
        self.source = CSRC / source
        self.symbol = symbol
        self.argtypes = list(argtypes)
        self.launches = 0
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    # -- build --------------------------------------------------------------
    def library_path(self) -> Path:
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC.glob("*.cuh")):
            h.update(header.read_bytes())
        h.update(" ".join(NVCC_FLAGS).encode())
        return BUILD_DIR / f"lib{self.source.stem}-{h.hexdigest()[:16]}.so"

    def start_build(self) -> Optional[subprocess.Popen]:
        """Start ``nvcc`` for this kernel unless its library exists; the
        caller waits on the returned process via :meth:`finish_build`."""
        out = self.library_path()
        if out.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(self.source)]
        return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)

    def finish_build(self, proc: Optional[subprocess.Popen]) -> None:
        if proc is None:
            return
        log, _ = proc.communicate()
        self.build_log = log
        tmp = Path(proc.args[proc.args.index("-o") + 1])
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"nvcc failed building {self.source.name} "
                f"(exit {proc.returncode}):\n{log}")
        os.replace(tmp, self.library_path())

    def build(self) -> None:
        self.finish_build(self.start_build())

    # -- bind / launch ------------------------------------------------------
    def _function(self):
        with self._lock:
            if self._lib is None:
                self.build()
                lib = ctypes.CDLL(str(self.library_path()))
                fn = getattr(lib, self.symbol)
                fn.argtypes = self.argtypes
                fn.restype = ctypes.c_int
                err = getattr(lib, "kernel_error_string")
                err.argtypes = [ctypes.c_int]
                err.restype = ctypes.c_char_p
                self._lib = (lib, fn, err)
            return self._lib[1]

    def launch(self, *args) -> None:
        """Call the C launcher on the given arguments; raise on a non-zero
        ``cudaError_t``; count the launch."""
        rc = self._function()(*args)
        if rc != 0:
            msg = self._lib[2](rc).decode()
            raise RuntimeError(f"{self.name} launch failed: "
                               f"cudaError {rc} ({msg})")
        self.launches += 1


class KernelForm:
    """One launch form of a kernel (the W4A16 GEMM's expert-batched
    launch): launching it launches the kernel, and the launch counts on
    both. Building and binding go through the kernel."""

    def __init__(self, kernel: CudaKernel, name: str):
        self.kernel, self.name = kernel, name
        self.launches = 0

    def launch(self, *args) -> None:
        self.kernel.launch(*args)
        self.launches += 1

    def __getattr__(self, attr):
        return getattr(self.kernel, attr)


def build_all(kernels: Iterable[CudaKernel]) -> List[str]:
    """Build every kernel with one ``nvcc`` per source, all started
    together; returns each source's compiler log (register and shared
    memory use from ``-Xptxas -v``), in the order the sources first
    appear."""
    by_lib = {}
    for k in kernels:
        by_lib.setdefault(k.library_path(), k)
    firsts = list(by_lib.values())
    procs = [k.start_build() for k in firsts]
    for k, p in zip(firsts, procs):
        k.finish_build(p)
    return [k.build_log for k in firsts]


def stream_ptr(device) -> ctypes.c_void_p:
    """PyTorch's current CUDA stream on ``device``, as a ``c_void_p``."""
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(0 if t is None else t.data_ptr())
