"""Diagnostic/profiling HTTP surface.

Reference: common/pprof.go starts Go's net/http/pprof endpoint per
service (config Service.PProf.Port). The Python equivalents served
here, all stdlib but the device trace:

  GET /debug/pprof/            index
  GET /debug/pprof/stack       every thread's current stack (the
                               goroutine-profile analog)
  GET /debug/pprof/profile?seconds=N&hz=H
                               statistical CPU profile: samples all
                               thread stacks at H hz for N seconds and
                               returns collapsed stacks ("frame;frame N"
                               lines — feed straight to flamegraph.pl)
  GET /debug/pprof/heap?topn=N tracemalloc top allocation sites
                               (tracemalloc starts on first call)
  GET /debug/pprof/traces[?trace_id=ID]
                               the tracing flight recorder
                               (utils/tracing.py ring buffer) as
                               Chrome-trace-format JSON — load in
                               Perfetto / chrome://tracing; trace_id
                               filters to one request's trace
  POST /debug/pprof/device/start?dir=D
  POST /debug/pprof/device/stop
                               bracket a torch.profiler trace (the CUDA
                               kernels and the host's torch ops of every
                               thread, a Chrome-trace JSON file written
                               into D at stop, whose path the stop
                               replies) — the device-side story Go
                               pprof has no equivalent for

The sampler is safe to run in production: it reads
``sys._current_frames`` from a daemon thread, never stops the world.

A copy of the reference package's ``utils/pprof.py``. The device-trace
pair brackets ``torch.profiler`` where the reference brackets
``jax.profiler``; the server's ``device`` says which activities it
records (``"cuda"``: the card's kernels too, and a host without CUDA
answers the start with an error; ``"cpu"``: the host's ops only).
"""

from __future__ import annotations

import os
import sys
import tempfile
import threading
import time
import traceback
from collections import Counter
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional, Tuple
from urllib.parse import parse_qs, urlparse

from .log import get_logger


def thread_stacks() -> str:
    """Every live thread's stack, most recent call last."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = []
    for ident, frame in sys._current_frames().items():
        out.append(
            f"--- thread {names.get(ident, '?')} (id {ident}) ---\n"
            + "".join(traceback.format_stack(frame))
        )
    return "\n".join(out)


def sample_cpu(seconds: float = 5.0, hz: float = 100.0) -> str:
    """Collapsed-stack statistical profile of all threads.

    Lines are ``frame;frame;...;frame count`` with the root first —
    flamegraph.pl / speedscope both ingest this directly.
    """
    me = threading.get_ident()
    counts: Counter = Counter()
    interval = 1.0 / max(hz, 1.0)
    deadline = time.monotonic() + seconds
    while time.monotonic() < deadline:
        for ident, frame in sys._current_frames().items():
            if ident == me:
                continue
            stack = []
            f = frame
            while f is not None:
                code = f.f_code
                stack.append(f"{code.co_name} ({code.co_filename}:{f.f_lineno})")
                f = f.f_back
            counts[";".join(reversed(stack))] += 1
        time.sleep(interval)
    return "\n".join(f"{k} {v}" for k, v in counts.most_common())


def heap_top(topn: int = 30) -> str:
    import tracemalloc

    if not tracemalloc.is_tracing():
        tracemalloc.start()
        return (
            "tracemalloc started; allocations are tracked from now — "
            "call again for a snapshot"
        )
    snap = tracemalloc.take_snapshot()
    stats = snap.statistics("lineno")[:topn]
    total = sum(s.size for s in snap.statistics("filename"))
    lines = [f"total tracked: {total / 1e6:.1f} MB"]
    lines += [str(s) for s in stats]
    return "\n".join(lines)


class _Handler(BaseHTTPRequestHandler):
    server_version = "cadence-tpu-pprof"

    def log_message(self, fmt, *args):  # route to our logger, not stderr
        self.server._log.info("pprof " + fmt % args)

    def _reply(self, code: int, body: str,
               content_type: str = "text/plain; charset=utf-8") -> None:
        data = body.encode()
        self.send_response(code)
        self.send_header("Content-Type", content_type)
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self) -> Tuple[str, dict]:
        u = urlparse(self.path)
        return u.path.rstrip("/"), parse_qs(u.query)

    def do_GET(self) -> None:  # noqa: N802 (stdlib casing)
        path, q = self._route()
        try:
            if path in ("", "/debug/pprof"):
                self._reply(200, __doc__ or "")
            elif path == "/debug/pprof/stack":
                self._reply(200, thread_stacks())
            elif path == "/debug/pprof/profile":
                seconds = float(q.get("seconds", ["5"])[0])
                hz = float(q.get("hz", ["100"])[0])
                # clamp like seconds: an absurd hz would busy-spin a
                # core walking every thread's stack for the whole window
                self._reply(200, sample_cpu(
                    min(seconds, 120.0), min(hz, 1000.0)
                ))
            elif path == "/debug/pprof/heap":
                self._reply(200, heap_top(int(q.get("topn", ["30"])[0])))
            elif path == "/debug/pprof/traces":
                from .tracing import TRACER

                trace_id = q.get("trace_id", [None])[0]
                self._reply(
                    200, TRACER.chrome_trace_json(trace_id),
                    content_type="application/json",
                )
            else:
                self._reply(404, f"unknown pprof path {path}\n")
        except Exception as e:  # diagnostics must not kill the server
            self._reply(500, f"{type(e).__name__}: {e}\n")

    def do_POST(self) -> None:  # noqa: N802
        path, q = self._route()
        try:
            if path == "/debug/pprof/device/start":
                trace_dir = q.get("dir", [_DEFAULT_TRACE_DIR])[0]
                self.server.device_trace.start(trace_dir)
                self._reply(200, f"device trace started -> {trace_dir}\n")
            elif path == "/debug/pprof/device/stop":
                out = self.server.device_trace.stop()
                self._reply(200, f"device trace stopped -> {out}\n")
            else:
                self._reply(404, f"unknown pprof path {path}\n")
        except Exception as e:
            self._reply(500, f"{type(e).__name__}: {e}\n")


_DEFAULT_TRACE_DIR = os.path.join(tempfile.gettempdir(),
                                  "cadence-tpu-torch-trace")


class DeviceTrace:
    """One ``torch.profiler`` trace at a time, started and stopped by
    calls from any threads (two HTTP requests run on two). The profiler
    lives on a thread of its own, which enters it at ``start`` and leaves
    it at ``stop``, writing the Chrome trace; it records the host's torch
    ops on every thread, and on ``"cuda"`` the card's kernels."""

    def __init__(self, device="cuda") -> None:
        self.device = str(device)
        self._lock = threading.Lock()
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._result: dict = {}
        self._seq = 0

    def start(self, trace_dir: str) -> None:
        with self._lock:
            if self._thread is not None:
                raise RuntimeError("a device trace is already running")
            self._seq += 1
            path = os.path.join(
                trace_dir, f"device-trace-{os.getpid()}-{self._seq}.json")
            started = threading.Event()
            self._stop.clear()
            self._result = {}
            self._thread = threading.Thread(
                target=self._run, args=(path, started),
                name="pprof-device-trace", daemon=True)
            self._thread.start()
            started.wait()
            if "error" in self._result:
                self._thread.join()
                self._thread = None
                raise self._result["error"]

    def stop(self) -> str:
        """End the trace; returns the path of its Chrome-trace file."""
        with self._lock:
            if self._thread is None:
                raise RuntimeError("no device trace is running")
            self._stop.set()
            self._thread.join()
            self._thread = None
            if "error" in self._result:
                raise self._result["error"]
            return self._result["path"]

    def _activities(self):
        import torch
        from torch.profiler import ProfilerActivity

        if self.device.startswith("cuda"):
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "device trace on cuda: this host has no CUDA device")
            return [ProfilerActivity.CPU, ProfilerActivity.CUDA]
        if self.device != "cpu":
            raise ValueError(f"device trace: unknown device {self.device!r}")
        return [ProfilerActivity.CPU]

    def _run(self, path: str, started: threading.Event) -> None:
        try:
            from torch._C._profiler import _ExperimentalConfig
            from torch.profiler import profile

            prof = profile(
                activities=self._activities(),
                experimental_config=_ExperimentalConfig(
                    profile_all_threads=True),
            )
            prof.start()
        except Exception as e:  # handed to the caller of start()
            self._result["error"] = e
            started.set()
            return
        started.set()
        self._stop.wait()
        try:
            prof.stop()
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            prof.export_chrome_trace(path)
            self._result["path"] = path
        except Exception as e:  # handed to the caller of stop()
            self._result["error"] = e


class PProfServer:
    """The per-process diagnostics endpoint (common/pprof.go Start);
    ``device`` is where its device trace records (``DeviceTrace``)."""

    def __init__(self, port: int = 0, host: str = "127.0.0.1",
                 device="cuda") -> None:
        self._log = get_logger("cadence_tpu_torch.pprof")
        self._httpd = ThreadingHTTPServer((host, port), _Handler)
        self._httpd._log = self._log
        self._httpd.device_trace = DeviceTrace(device)
        self._httpd.daemon_threads = True
        self._thread: Optional[threading.Thread] = None

    @property
    def address(self) -> str:
        host, port = self._httpd.server_address[:2]
        return f"{host}:{port}"

    def start(self) -> "PProfServer":
        self._thread = threading.Thread(
            target=self._httpd.serve_forever, name="pprof", daemon=True
        )
        self._thread.start()
        self._log.info(f"pprof listening on {self.address}")
        return self

    def stop(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        if self._thread:
            self._thread.join(timeout=5.0)
