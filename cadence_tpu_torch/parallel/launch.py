"""Run one function on every rank of a fresh process group.

The reference package runs its mesh in one process (XLA's SPMD over the
devices it sees). A ``torch.distributed`` mesh is one process a rank:
``run_ranks`` spawns them, joins them into a group, runs the function on
each and returns what each returned.

* The ``spawn`` start method: the caller may have initialised CUDA, so
  ``fork`` is unsafe. Children import the function by its module path,
  so worker functions live in this package. The function and its
  arguments go to the children in a file, pickled once: a child reads
  its start-up pipe only after importing the caller's main module, so
  large arguments in the pipe would start the ranks one after another.
* Each rank joins through a ``FileStore`` in a fresh temporary
  directory: no TCP port, so several runs side by side cannot collide.
* ``backend`` is explicit. ``"nccl"`` puts rank r on ``cuda:r`` and
  needs a card a rank; ``"gloo"`` runs every rank on ``device``: the
  CPU, or all of them on one card, where their kernels time-slice it.
* The parent waits for every rank against one deadline. When a rank
  raises, or the deadline passes, it kills every rank and raises with
  that rank's traceback: a hung collective fails within ``timeout_s``.
"""

from __future__ import annotations

import datetime
import pickle
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path
from typing import Any, Callable, List, Sequence

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

BACKENDS = ("gloo", "nccl")


def _rank_devices(world: int, backend: str, device) -> List[str]:
    """The device of each rank: ``cuda:r`` for nccl, ``device`` for every
    rank under gloo. Raises when the host cannot give them."""
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} (got {backend!r})")
    dev = torch.device(device)
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device!r}")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available on this host; pass device='cpu' with "
            "backend='gloo' to run the ranks on the CPU")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("backend 'nccl' runs on CUDA devices only")
        n = torch.cuda.device_count()
        if n < world:
            raise ValueError(
                f"backend 'nccl' needs one card a rank: {world} ranks, "
                f"{n} card(s); use backend='gloo' to share a card")
        return [f"cuda:{r}" for r in range(world)]
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", 0)
    return [str(dev)] * world


def _rank_main(rank: int, world: int, tmp: str, backend: str,
               device: str, timeout_s: float, results) -> None:
    try:
        with open(Path(tmp) / "call.pkl", "rb") as f:
            fn, args = pickle.load(f)
        dev = torch.device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            torch.set_num_threads(1)
        dist.init_process_group(
            backend, store=dist.FileStore(str(Path(tmp) / "store"), world),
            rank=rank, world_size=world,
            timeout=datetime.timedelta(seconds=timeout_s))
        out = fn(dev, *args)
        dist.destroy_process_group()
    except Exception:
        # the process boundary: report the traceback, the parent raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run_ranks(fn: Callable, world: int, *, backend: str, device,
              timeout_s: float, args: Sequence[Any] = ()) -> List[Any]:
    """Run ``fn(device, *args)`` on ``world`` ranks of a new process
    group; returns each rank's result, in rank order.

    ``fn`` is a module-level function of an importable module; it runs
    after ``init_process_group`` and returns something picklable (numpy
    and plain values, never tensors). Raises ``RuntimeError`` with the
    rank's traceback when a rank raises or dies, and ``TimeoutError``
    when ``timeout_s`` seconds pass before every rank has returned; every
    rank is killed either way."""
    devices = _rank_devices(world, backend, device)
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = Path(tempfile.mkdtemp(prefix="run_ranks-"))
    with open(tmp / "call.pkl", "wb") as f:
        pickle.dump((fn, tuple(args)), f, protocol=pickle.HIGHEST_PROTOCOL)
    procs = [ctx.Process(
        target=_rank_main, daemon=True,
        args=(r, world, str(tmp), backend, devices[r], timeout_s, results))
        for r in range(world)]
    deadline = time.monotonic() + timeout_s
    out = {}
    try:
        for p in procs:
            p.start()
        while len(out) < world:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                late = [r for r in range(world) if r not in out]
                raise TimeoutError(
                    f"rank(s) {late} of {world} still running after "
                    f"{timeout_s} s; killed every rank")
            try:
                rank, ok, payload = results.get(timeout=min(remaining, 0.5))
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in out and p.exitcode not in (None, 0)]
                if not dead:
                    continue
                try:  # its report may still be in the pipe
                    rank, ok, payload = results.get(timeout=2)
                except queue.Empty:
                    raise RuntimeError(
                        f"rank {dead[0]} of {world} died with exit code "
                        f"{procs[dead[0]].exitcode} and no result") from None
            if not ok:
                raise RuntimeError(f"rank {rank} of {world} failed:\n{payload}")
            out[rank] = payload
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
        for p in procs:
            p.join(timeout=30)
        results.close()
        results.cancel_join_thread()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(world)]
