"""Build and load the package's CUDA kernels.

Each kernel is one source, ``csrc/<name>.cu``, with a plain C interface.
At first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a
shared library under ``build/torch_kernels/`` at the repository root and
loaded with ``ctypes``; no PyTorch headers are involved, so a build takes
seconds. The library's file name carries a hash of its source and flags,
so an edited source is rebuilt and a stale library is never loaded.

``build(names)`` compiles several kernels at once, one ``nvcc`` process
each, all started together. ``call`` reaches a kernel's entry point, and
``card`` gives the limits of the card that the launch plans read.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# C signatures of each kernel library's entry points: name -> (restype,
# argtypes). Pointers and the stream are c_void_p, or ctypes would pass
# them as 32-bit ints.
_SIGNATURES = {
    "replay_fsm": {
        "cadence_replay_fsm": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]),
        "cadence_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "affine_segscan": {
        "cadence_affine_segscan": (ctypes.c_int, [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
        ]),
        "cadence_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
    "refresh_tasks": {
        # the six state tables, the 12 outputs, B and the five slot caps,
        # threads a lane, lanes a block, the five slab offsets and their
        # end, the stream, the device
        "cadence_refresh_tasks": (ctypes.c_int, [ctypes.c_void_p] * 18 + [
            ctypes.c_int] * 14 + [ctypes.c_void_p, ctypes.c_int]),
        "cadence_cuda_error_string": (ctypes.c_char_p, [ctypes.c_int]),
    },
}

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each kernel built in
# this process
build_logs: Dict[str, str] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: building the CUDA kernels needs the CUDA toolkit")


def _lib_path(name: str) -> Path:
    src = (_CSRC / f"{name}.cu").read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{key[:16]}.so"


def _start(nvcc: str, name: str):
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(_CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def build(names: Iterable[str]) -> None:
    """Compile the named kernels that are not built yet, in parallel."""
    with _lock:
        todo = [n for n in names if not _lib_path(n).exists()]
        if not todo:
            return
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        jobs = [(n, _start(nvcc, n)) for n in todo]
        errors = []
        for name, (proc, tmp, out) in jobs:
            log, _ = proc.communicate()
            build_logs[name] = log
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                errors.append(f"nvcc failed to build {name}:\n{log}")
            else:
                # atomic: a reader never sees a half-written library
                os.replace(tmp, out)
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built at first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build([name])
    with _lock:
        if name not in _libs:
            lib = ctypes.CDLL(str(_lib_path(name)))
            for fn, (restype, argtypes) in _SIGNATURES[name].items():
                getattr(lib, fn).restype = restype
                getattr(lib, fn).argtypes = argtypes
            _libs[name] = lib
        return _libs[name]


KERNELS = tuple(_SIGNATURES)


def call(name: str, entry: str, device: torch.device, *args) -> None:
    """Call entry point ``entry`` of kernel ``name``'s library with
    ``args``, then the current stream of CUDA ``device`` and its index,
    which every entry point takes last; raise RuntimeError with the
    decoded cudaError_t that it returns."""
    lib = load(name)
    index = (device.index if device.index is not None
             else torch.cuda.current_device())
    err = getattr(lib, entry)(
        *args, torch.cuda.current_stream(device).cuda_stream, index)
    if err:
        raise RuntimeError(f"{name} kernel launch failed: "
                           + lib.cadence_cuda_error_string(err).decode())


# threads a warp
WARP = 32


@dataclasses.dataclass(frozen=True)
class Card:
    """The limits of a card that the kernels' launch plans read."""

    sms: int            # streaming multiprocessors
    sm_smem: int        # shared memory of one SM, bytes
    block_smem: int     # the most dynamic shared memory a block opts in to
    reserved_smem: int  # what the card reserves of an SM's for each block


# an H100: the card the kernels are built for (sm_90a), and the limits a
# plan takes where there is no card to ask. torch does not report the
# reserve, 1 KB a block on Hopper, so every card takes this one.
H100 = Card(sms=132, sm_smem=233_472, block_smem=232_448,
            reserved_smem=1_024)


@functools.lru_cache(maxsize=None)
def _cuda_card(index: int) -> Card:
    props = torch.cuda.get_device_properties(index)
    return Card(sms=props.multi_processor_count,
                sm_smem=props.shared_memory_per_multiprocessor,
                block_smem=props.shared_memory_per_block_optin,
                reserved_smem=H100.reserved_smem)


def card(device: torch.device) -> Card:
    """The limits of ``device``: a CUDA card's, read once; the H100's for
    any other device."""
    if device.type != "cuda":
        return H100
    return _cuda_card(device.index if device.index is not None
                      else torch.cuda.current_device())
