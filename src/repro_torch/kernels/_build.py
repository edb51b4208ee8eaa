"""Build, load and count the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into one shared
library with a plain C interface, loaded with ``ctypes``. The build runs at
first use, never at import, into ``build/kernels/<hash>/`` under the
checkout, where ``<hash>`` covers the sources, the headers they include
(``csrc/*.cuh``) and the flags, so an edited source rebuilds and an unchanged one is loaded as it is. A missing ``nvcc``
or a failed compile raises; nothing falls back to the plain versions.

Each kernel wrapper calls ``launch(name, ...)``, which counts one launch of
``name``, runs the C launcher on the current stream and raises when the
launcher reports a CUDA error (a refused launch never runs, and a later
synchronize would not report it).

A tensor without data (on the meta device, or a ``FakeTensor``) never
reaches ``launch``: the kernel-shaped branches of the attention and SSD
wrappers allocate what their kernel's call allocates and report the
kernel's operations and bytes through ``trace_launch`` to the counters
that listen (``core/profiler.py``'s ``_CostMode``), so a dry run counts a
kernel as the card runs it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Dict, List, Optional

import torch
from torch._subclasses.fake_tensor import FakeTensor

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "kernels"
LIB_NAME = "libmeili_kernels.so"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I64 = ctypes.c_longlong
_I32 = ctypes.c_int
_F32 = ctypes.c_float
# C launcher -> argument types; every launcher returns a cudaError_t code.
SIGNATURES = {
    "meili_flow_lookup": [_P, _P, _P, _P, _I64, _P, _P, _I64, _I32, _I32,
                          _P, _P],
    "meili_dfa_regex": [_P, _I64, _I64, _P, _P, _P] + [_I32] * 6 + [_P, _P],
    "meili_arx_cipher": [_P, _I64, _I64, _P, _P, _P],
    "meili_keyed_hash": [_P, _I64, _I64, _P, _P, _P],
    "meili_flash_attention": [_P, _P, _P, _P] + [_I32] * 8 + [_F32]
                             + [_I32] * 4 + [_P] * 4,
    "meili_flash_attention_bwd": [_P] * 10 + [_I32] * 8 + [_F32, _P],
    "meili_decode_attention": [_P] * 9 + [_I32] * 9 + [_F32] + [_I32] * 2
                              + [_P],
    "meili_ssd_scan": [_P] * 8 + [_I32] * 6 + [_I64] * 3 + [_I32] * 3 + [_P],
    "meili_ssd_scan_bwd": [_P] * 14 + [_I32] * 6 + [_I64] * 3 + [_I32] * 3
                          + [_P],
}
# Kernel name (as counted and reported) -> C launcher.
KERNELS = {
    "flow_lookup": "meili_flow_lookup",
    "dfa_regex": "meili_dfa_regex",
    "arx_cipher": "meili_arx_cipher",
    "keyed_hash": "meili_keyed_hash",
    "flash_attention": "meili_flash_attention",
    "flash_attention_bwd": "meili_flash_attention_bwd",
    "decode_attention": "meili_decode_attention",
    "ssd_scan": "meili_ssd_scan",
    "ssd_scan_bwd": "meili_ssd_scan_bwd",
}

_lib: Optional[ctypes.CDLL] = None
_failed: Optional[RuntimeError] = None    # a failed build, not retried
_launches: Dict[str, int] = {name: 0 for name in KERNELS}


def sources() -> List[Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[Path]:
    return sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_ROOT / _digest() / LIB_NAME


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and Path("/usr/local/cuda/bin/nvcc").exists():
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the port's CUDA kernels are built from "
            f"{CSRC} at first use and need the CUDA toolkit on PATH")
    return nvcc


def _run_all(cmds: List[List[str]]) -> List[str]:
    """Run the commands concurrently; their combined output in order.
    Raises, naming the command, if any fails (after all have ended)."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for c, p, o in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(c)}\n{o}")
    return outs


def build() -> Path:
    """Compile each ``csrc/*.cu`` with its own nvcc process, all at once,
    and link the objects into the shared library; returns its path. A no-op
    when it already exists."""
    out = library_path()
    if out.exists():
        return out
    nvcc = find_nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    tmp = Path(tempfile.mkdtemp(prefix="tmp-", dir=BUILD_ROOT))
    try:
        objs = [tmp / (src.stem + ".o") for src in sources()]
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                        for src, obj in zip(sources(), objs)])
        log += _run_all([[nvcc, *NVCC_FLAGS, "-shared", "-o",
                          str(tmp / LIB_NAME), *map(str, objs)]])
        out.parent.mkdir(parents=True, exist_ok=True)
        (out.parent / "build.log").write_text("".join(log))
        os.replace(tmp / LIB_NAME, out)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def build_log() -> str:
    """nvcc's output of the last build (``-Xptxas -v``: registers, shared
    memory and spills of each kernel)."""
    path = library_path().parent / "build.log"
    return path.read_text() if path.exists() else ""


def load() -> ctypes.CDLL:
    """The kernel library, built on first use. A build that failed raises
    the same error again without compiling anew: the sources have not
    changed within the process."""
    global _lib, _failed
    if _failed is not None:
        raise _failed
    if _lib is None:
        try:
            path = build()
        except RuntimeError as err:
            _failed = err
            raise
        lib = ctypes.CDLL(str(path))
        for fn, argtypes in SIGNATURES.items():
            getattr(lib, fn).argtypes = argtypes
            getattr(lib, fn).restype = ctypes.c_int
        lib.meili_error_string.argtypes = [ctypes.c_int]
        lib.meili_error_string.restype = ctypes.c_char_p
        lib.meili_launch_floor.argtypes = [_P]
        lib.meili_launch_floor.restype = ctypes.c_int
        lib.meili_read_floor.argtypes = [_P, _I64, _P, _P]
        lib.meili_read_floor.restype = ctypes.c_int
        _lib = lib
    return _lib


def launch(name: str, device: torch.device, *args) -> None:
    """Count and run one launch of kernel ``name`` on ``device``'s current
    stream; pointers are passed as Python ints (``tensor.data_ptr()``). A
    checkpointed body's recompute (``models/remat.py``) launches again and
    is counted: the card runs it."""
    lib = load()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        _launches[name] += 1
        err = getattr(lib, KERNELS[name])(*args, stream)
    if err != 0:
        msg = lib.meili_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err} "
                           f"({msg})")


def launch_floor(device: torch.device) -> None:
    """Launch the kernel that does nothing (``csrc/launch_floor.cu``) on
    ``device``'s current stream, uncounted: timed like a kernel, it is the
    least time any launch takes."""
    lib = load()
    with torch.cuda.device(device):
        err = lib.meili_launch_floor(
            torch.cuda.current_stream(device).cuda_stream)
    _raise_floor("launch_floor", lib, err)


def read_floor(t: torch.Tensor) -> None:
    """Read ``t``'s bytes once with a plain coalesced kernel
    (``csrc/launch_floor.cu``), uncounted: timed like a kernel, it is the
    least time a kernel that must read them takes. ``t`` contiguous on a
    CUDA device, 16-byte aligned, its size a multiple of 16 bytes."""
    nbytes = t.numel() * t.element_size()
    if not (t.is_cuda and t.is_contiguous()) or nbytes % 16:
        raise ValueError("read_floor: a contiguous CUDA tensor of whole "
                         "16-byte pieces")
    lib = load()
    with torch.cuda.device(t.device):
        err = lib.meili_read_floor(
            t.data_ptr(), nbytes // 16, None,
            torch.cuda.current_stream(t.device).cuda_stream)
    _raise_floor("read_floor", lib, err)


def _raise_floor(name: str, lib: ctypes.CDLL, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error "
                           f"{err} ({lib.meili_error_string(err).decode()})")


def launch_counts() -> Dict[str, int]:
    return dict(_launches)


def reset_launch_counts() -> None:
    for name in _launches:
        _launches[name] = 0


def traced(t: torch.Tensor) -> bool:
    """True for a tensor that holds no data: on the meta device, or a
    ``FakeTensor`` (whatever device it stands for)."""
    return t.is_meta or isinstance(t, FakeTensor)


_SINKS: List = []      # counters of traced launches (``_CostMode``)


def trace_launch(name: str, flops: int, nbytes: int) -> None:
    """Report one launch of kernel ``name`` on traced tensors, with the
    operations and bytes its work needs, to every listening counter; no
    kernel runs and ``launch_counts`` does not move."""
    if name not in _launches:
        raise KeyError(f"no kernel {name!r}")
    for sink in _SINKS:
        sink.kernel(name, flops, nbytes)


def require_cuda(name: str, *tensors: torch.Tensor) -> torch.device:
    """Every tensor on one CUDA device (or every one traced, ``traced``)
    and contiguous; returns the device."""
    dev = tensors[0].device
    fake = traced(tensors[0])
    for t in tensors:
        if (t.device != dev or traced(t) != fake
                or (dev.type != "cuda" and not fake)):
            raise ValueError(f"{name}: every tensor must be on one CUDA "
                             f"device, got {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensors must be contiguous")
    return dev


def require_dtype(name: str, what: str, t: torch.Tensor,
                  dtype: torch.dtype) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name}: {what} must be {dtype}, got {t.dtype}")
