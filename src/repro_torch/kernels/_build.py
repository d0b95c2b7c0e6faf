"""Build the CUDA sources under ``kernels/csrc`` and load them with ctypes.

Each ``csrc/<name>.cu`` compiles on first use, with ``nvcc`` for
``sm_90a``, into ``build/lib<name>.so`` at the repository root, and is
loaded with `ctypes`. The sources have a plain C interface: every entry
point takes device pointers, sizes and the stream (PyTorch's current
one) and returns ``cudaGetLastError()`` after its launches, which
`check` turns into an exception. All sources build in parallel, one
``nvcc`` each. A failed build raises; nothing falls back.

A library is rebuilt when any source under ``csrc`` is newer than it.
``-Xptxas -v`` is on: its report (registers, shared memory and spills
of each kernel) is kept beside the library as ``lib<name>.ptxas.txt``.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
SOURCES = ("assign_top2", "cluster_sum", "fused_nested_round",
           "fused_round")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()
#: guards the kernel modules' launch counts (``launches += 1`` is a read
#: and a write, and the service launches kernels from several threads)
launch_lock = threading.Lock()


def nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``/usr/local/cuda/bin``,
    then ``PATH``."""
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME)")
    return found


def lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = lib_path(name)
    if not out.is_file():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return out.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES, *, force: bool = False
          ) -> Dict[str, Tuple[float, str]]:
    """Compile ``names`` in parallel; returns {name: (seconds, ptxas -v)}.

    Libraries that are up to date are skipped unless ``force``. Each
    library is written to a temporary name and renamed into place, so a
    concurrent loader never sees half a file.
    """
    todo = [n for n in names if force or _stale(n)]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    exe = nvcc() if todo else ""
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f".lib{name}.{os.getpid()}.so"
        cmd = [exe, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
               str(CSRC / f"{name}.cu")]
        procs[name] = (time.perf_counter(), tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    report: Dict[str, Tuple[float, str]] = {}
    failed = []
    for name, (t0, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"--- {name}.cu (nvcc exit {proc.returncode})\n"
                          f"{log}")
            continue
        os.replace(tmp, lib_path(name))
        (BUILD_DIR / f"lib{name}.ptxas.txt").write_text(log)
        report[name] = (secs, log)
    if failed:
        raise RuntimeError("CUDA kernel build failed:\n" + "\n".join(failed))
    return report


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built first if needed."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            if _stale(name):
                build([name])
            lib = ctypes.CDLL(str(lib_path(name)))
            _libs[name] = lib
        return lib


def bind(name: str, fn: str, n_ptr: int, n_int: int):
    """``lib.fn`` with its ctypes signature set. Every entry point takes
    ``n_ptr`` pointers, then ``n_int`` ints, then the stream. Pointers are
    c_void_p: a c_int would cut them to 32 bits."""
    f = getattr(load(name), fn)
    f.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
                  + [ctypes.c_void_p])
    f.restype = ctypes.c_int
    return f


def resolve_device(device):
    """``device`` as a torch device; a CUDA device must exist."""
    import torch
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device={str(device)!r} but torch.cuda.is_available() is "
            f"False; pass device='cpu' to run the plain versions on the CPU")
    return dev


def require_cuda(*ts):
    """The one CUDA device all tensors ``ts`` lie on; raises unless they
    are contiguous and on that device."""
    dev = ts[0].device
    for t in ts:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"the CUDA kernels take tensors on one CUDA "
                             f"device, got {[str(u.device) for u in ts]}")
        if not t.is_contiguous():
            raise ValueError("the CUDA kernels take contiguous tensors")
    return dev


def stream(dev) -> int:
    """PyTorch's current stream on ``dev``, as the C entry points take it."""
    import torch
    return torch.cuda.current_stream(dev).cuda_stream


def check(err: int, name: str, fn: str) -> None:
    """Raise if the C entry point ``fn`` of ``name`` reported a CUDA
    error (a refused launch never runs, and a synchronise would not
    report it)."""
    if err != 0:
        what = load(name).kernel_error_string
        what.argtypes = [ctypes.c_int]
        what.restype = ctypes.c_char_p
        raise RuntimeError(f"{fn}: CUDA error {err}: "
                           f"{what(err).decode()}")
