"""ctypes bindings for the port's C++ sidecar (``sidecar.cpp`` beside
this file).

At first use the source is compiled with ``g++ -O3 -shared -fPIC
-std=c++17`` into ``build/torch_native/`` at the repository root; the
library's file name carries a hash of the source and the flags, so an
edited source is rebuilt and a stale library is never loaded. It exposes:

- ``scatter_time_major`` / ``scatter_batch_major`` / ``scatter_teb``:
  fused pad and layout of ragged event rows into the dense tensors the
  replay consumes ([T, B, E], [B, T, E] and the FSM kernel's [T, E, B]);
- ``replay_sequential``: the compiled sequential replayer, the baseline a
  replay's rate is measured against.

Without ``g++`` (or when the build fails) ``_load()`` returns None and
the scatters take their numpy paths (``HAVE_NATIVE`` says which is live);
``replay_sequential`` then raises, because the baseline must be compiled
code. Tests run both scatter paths differentially.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Optional

import numpy as np

SRC = Path(__file__).resolve().parent / "sidecar.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_native"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
# EV_TYPE of a padding row (ops/schema.py)
TYPE_PAD = -1

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_load_failed = False
HAVE_NATIVE = False
# why the last build or load failed (compiler output), for diagnostics
load_error = ""


def lib_path() -> Path:
    """Where the library of the current source and flags lives."""
    key = hashlib.sha256(
        SRC.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libctsidecar-{key[:16]}.so"


def _build() -> Optional[Path]:
    global load_error
    out = lib_path()
    if out.exists():
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        load_error = "g++ not found"
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a temp path and rename atomically: a killed compile or
    # two processes racing never leave a half-written library behind
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, out)
        return out
    except subprocess.CalledProcessError as e:
        load_error = f"g++ failed:\n{e.stderr}"
    except (OSError, subprocess.TimeoutExpired) as e:
        load_error = f"g++ failed: {e}"
    tmp.unlink(missing_ok=True)
    return None


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built at first use; None without g++ or when
    the build fails (not retried in this process)."""
    global _lib, _load_failed, HAVE_NATIVE, load_error
    with _lock:
        if _lib is not None or _load_failed:
            return _lib
        path = _build()
        if path is None:
            _load_failed = True
            return None
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            load_error = f"cannot load {path}: {e}"
            _load_failed = True
            return None
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        scatter = [i32p, i64p, ctypes.c_int64, ctypes.c_int64,
                   ctypes.c_int64, ctypes.c_int32, i32p]
        for fn in ("ct_scatter_time_major", "ct_scatter_batch_major",
                   "ct_scatter_teb"):
            getattr(lib, fn).argtypes = scatter
            getattr(lib, fn).restype = None
        lib.ct_replay_sequential.argtypes = (
            [i32p, i64p] + [ctypes.c_int64] * 8 + [i32p] * 8)
        lib.ct_replay_sequential.restype = None
        _lib = lib
        HAVE_NATIVE = True
        return lib


def _i32p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _i64p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))


# -- scatter ---------------------------------------------------------------


def _check_scatter_args(
    rows: np.ndarray, lengths: np.ndarray, max_events: int
) -> None:
    """Bounds-check the scatter arguments before handing buffers to C.

    The native scatter trusts its inputs (it clamps per-workflow copies
    to ``max_events`` but cannot detect a lengths/rows mismatch), so
    anything inconsistent raises here, on both paths."""
    if lengths.size and int(lengths.min()) < 0:
        raise ValueError("scatter: negative workflow length")
    if lengths.size and int(lengths.max()) > max_events:
        raise ValueError(
            f"scatter: workflow length {int(lengths.max())} exceeds "
            f"max_events={max_events}")
    n_rows = rows.shape[0] if rows.ndim == 2 else 0
    if int(lengths.sum()) != n_rows:
        raise ValueError(
            f"scatter: sum(lengths)={int(lengths.sum())} != rows={n_rows}")


def _scatter(fn: str, rows, lengths, max_events: int, force_python: bool,
             layout: str) -> np.ndarray:
    """One scatter: ``layout`` names the output's axes, a permutation of
    "tbe" (step, batch, event field). Padding rows carry the packer's
    padding type in column 0 (EV_TYPE) and zeros elsewhere."""
    rows = np.ascontiguousarray(rows, dtype=np.int32)
    lengths64 = np.ascontiguousarray(lengths, dtype=np.int64)
    _check_scatter_args(rows, lengths64, max_events)
    batch = len(lengths64)
    ev_n = rows.shape[1] if rows.ndim == 2 else 0
    dims = {"t": max_events, "b": batch, "e": ev_n}
    shape = tuple(dims[a] for a in layout)
    lib = None if force_python else _load()
    if lib is not None and ev_n and rows.size:
        out = np.empty(shape, dtype=np.int32)
        getattr(lib, fn)(_i32p(rows), _i64p(lengths64), batch, ev_n,
                         max_events, TYPE_PAD, _i32p(out))
        return out
    # numpy path: fill a [B, T, E] view of the output per workflow
    out = np.zeros(shape, dtype=np.int32)
    view = np.transpose(out, [layout.index(a) for a in "bte"])
    if ev_n:
        view[:, :, 0] = TYPE_PAD
    start = 0
    for b, n in enumerate(lengths64.tolist()):
        view[b, :n, :] = rows[start:start + n]
        start += n
    return out


def scatter_time_major(rows: np.ndarray, lengths: np.ndarray,
                       max_events: int,
                       force_python: bool = False) -> np.ndarray:
    """[sum(lengths), E] rows + [B] lengths → [T, B, E] dense tensor."""
    return _scatter("ct_scatter_time_major", rows, lengths, max_events,
                    force_python, "tbe")


def scatter_teb(rows: np.ndarray, lengths: np.ndarray, max_events: int,
                force_python: bool = False) -> np.ndarray:
    """[sum(lengths), E] rows + [B] lengths → [T, E, B] field-major tensor
    (the FSM kernel's operand layout)."""
    return _scatter("ct_scatter_teb", rows, lengths, max_events,
                    force_python, "teb")


def scatter_batch_major(rows: np.ndarray, lengths: np.ndarray,
                        max_events: int,
                        force_python: bool = False) -> np.ndarray:
    """[sum(lengths), E] rows + [B] lengths → [B, T, E] (the packer's
    ``PackedHistories.events``)."""
    return _scatter("ct_scatter_batch_major", rows, lengths, max_events,
                    force_python, "bte")


# -- sequential replayer (compiled-host baseline) --------------------------


def replay_sequential(packed, caps=None):
    """Replay packed histories with the C++ sequential loop.

    The compiled-host baseline: the FSM kernel's transition semantics
    applied one workflow, one event at a time, the shape of the
    reference's Go stateBuilder.applyEvents loop
    (service/history/stateBuilder.go:112-613). ``packed`` needs
    ``events`` [B, T, EV_N], ``lengths`` [B] and ``caps``; every history
    starts from the empty state. Returns numpy StateTensors. Raises
    RuntimeError without the library: the baseline must be compiled
    code, never interpreted Python."""
    from ..ops import schema as S

    lib = _load()
    if lib is None:
        raise RuntimeError(
            f"native sidecar unavailable, no compiled baseline: {load_error}")
    if getattr(packed, "initial", None) is not None:
        raise ValueError(
            "replay_sequential replays from the empty state; a resumed "
            "pack (packed.initial) has no compiled baseline")
    caps = caps or packed.caps
    events = np.ascontiguousarray(packed.events, dtype=np.int32)
    batch, t, ev_n = events.shape
    if ev_n != S.EV_N:
        raise ValueError(f"event width {ev_n} != schema EV_N {S.EV_N}")
    caps_n = (caps.max_activities, caps.max_timers, caps.max_children,
              caps.max_request_cancels, caps.max_signals_ext,
              caps.max_version_items)
    if min(caps_n) < 0 or caps.max_version_items < 1:
        raise ValueError(f"replay_sequential: capacities out of range {caps}")
    lengths = np.ascontiguousarray(packed.lengths, dtype=np.int64)
    if lengths.shape != (batch,):
        raise ValueError(
            f"lengths shape {lengths.shape} != ({batch},) histories")
    state = S.empty_state(batch, caps)
    lib.ct_replay_sequential(
        _i32p(events), _i64p(lengths), batch, t, *caps_n,
        _i32p(state.exec_info), _i32p(state.activities),
        _i32p(state.timers), _i32p(state.children),
        _i32p(state.cancels), _i32p(state.signals),
        _i32p(state.vh_items), _i32p(state.vh_len),
    )
    return state
