"""Process-group mesh for the replay fabric.

The counterpart of the reference package's ``parallel/mesh.py``. Two
logical axes over the ranks of a ``torch.distributed`` process group:

* ``shard`` — the batch axis. Cadence shards (workflowID % numShards)
  are rows of the event tensor; splitting them over ranks is the
  data-parallel dimension.
* ``seq`` — the time axis of the pipelined long-history replay
  (``parallel/pipeline.py``).

Rank ``r`` of ``n`` sits at shard ``r // seq``, seq ``r % seq``: the grid
``np.arange(n).reshape(n // seq, seq)``, as the reference lays its
devices out. A ``ReplayMesh`` holds one subgroup per axis: the ranks of
its shard axis (same seq index, in shard order) and of its seq axis
(same shard index, in seq order).

The collectives below run on the axis subgroups. Under ``nccl`` they
take the CUDA tensors as they are. Under ``gloo`` a CUDA tensor is
copied to a pinned host buffer first and the result copied back. gloo's
``send``/``recv`` take host memory only: given a CUDA tensor, torch
2.11's gloo fails in ``writev`` with "Bad address". Its all_gather and
all_reduce accept CUDA tensors and stage them through the host
themselves; the mesh stages those too, so one rule covers every gloo
operation and ``ReplayMesh.staged_bytes`` counts every byte copied
each way. The replay itself stays on the card.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

SHARD_AXIS = "shard"
SEQ_AXIS = "seq"


def mesh_grid(world: int, seq: int = 1) -> np.ndarray:
    """The [world // seq, seq] grid of ranks: row = shard index, column
    = seq index. Raises ``ValueError`` when ``world % seq != 0``."""
    if seq < 1 or world % seq != 0:
        raise ValueError(f"{world} ranks not divisible by seq={seq}")
    return np.arange(world).reshape(world // seq, seq)


@dataclasses.dataclass(eq=False)
class ReplayMesh:
    """One rank's view of a ("shard", "seq") mesh."""

    rank: int                     # global rank
    backend: str
    shape: Dict[str, int]         # {"shard": n // seq, "seq": seq}
    shard_index: int
    seq_index: int
    shard_ranks: Tuple[int, ...]  # global ranks of this rank's shard axis
    seq_ranks: Tuple[int, ...]    # global ranks of this rank's seq axis
    shard_group: object
    seq_group: object
    # bytes copied between the card and pinned host buffers for gloo
    staged_bytes: int = 0

    def group(self, axis: str):
        return self.shard_group if axis == SHARD_AXIS else self.seq_group

    def ranks(self, axis: str) -> Tuple[int, ...]:
        return self.shard_ranks if axis == SHARD_AXIS else self.seq_ranks


def make_mesh(seq: int = 1) -> ReplayMesh:
    """Build a ("shard", "seq") mesh over the ranks of the default
    process group, which must be initialized.

    ``seq`` ranks are dedicated to the time pipeline; the rest to the
    batch axis. seq=1 (default) is pure batch sharding. Collective:
    every rank calls it, in the same order as its other calls that
    create groups (``dist.new_group`` is collective over the default
    group, so each rank creates every axis group, its own and the
    others')."""
    world, rank = dist.get_world_size(), dist.get_rank()
    grid = mesh_grid(world, seq)
    shard_i, seq_i = divmod(rank, seq)
    shard_groups = [dist.new_group(grid[:, j].tolist())
                    for j in range(seq)]
    seq_groups = [dist.new_group(grid[i].tolist())
                  for i in range(grid.shape[0])]
    return ReplayMesh(
        rank=rank, backend=dist.get_backend(),
        shape={SHARD_AXIS: grid.shape[0], SEQ_AXIS: seq},
        shard_index=shard_i, seq_index=seq_i,
        shard_ranks=tuple(int(r) for r in grid[:, seq_i]),
        seq_ranks=tuple(int(r) for r in grid[shard_i]),
        shard_group=shard_groups[seq_i], seq_group=seq_groups[shard_i])


def _block(n: int, parts: int, index: int, what: str) -> slice:
    if n % parts != 0:
        raise ValueError(f"{what} {n} not divisible by {parts}")
    size = n // parts
    return slice(index * size, (index + 1) * size)


def shard_spec(mesh: ReplayMesh, batch: int) -> slice:
    """This rank's contiguous block of a batch of ``batch`` split on the
    shard axis: the block ``NamedSharding(P("shard"))`` gives a device."""
    return _block(batch, mesh.shape[SHARD_AXIS], mesh.shard_index,
                  "batch")


def events_spec(mesh: ReplayMesh, batch: int) -> slice:
    """This rank's block of an event tensor's batch axis (the lanes of
    [T, P, B], the histories of [EV_N, B, T])."""
    return shard_spec(mesh, batch)


def replicated_spec(mesh: ReplayMesh, batch: int) -> slice:
    """The whole batch: every rank holds all of it."""
    return slice(0, batch)


def pipeline_spec(mesh: ReplayMesh, steps: int,
                  batch: int) -> Tuple[slice, slice]:
    """This rank's (steps, lanes) block of a [T, P, B] event tensor for
    ``replay_pipelined``: steps split on the seq axis, lanes on the shard
    axis. Raises when T or B does not divide."""
    return (_block(steps, mesh.shape[SEQ_AXIS], mesh.seq_index, "steps"),
            shard_spec(mesh, batch))


# --------------------------------------------------------------------------
# Collectives on one axis
# --------------------------------------------------------------------------


def _stages(mesh: ReplayMesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _to_host(mesh: ReplayMesh, t: torch.Tensor) -> torch.Tensor:
    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    host.copy_(t)
    mesh.staged_bytes += host.numel() * host.element_size()
    return host


def _to_device(mesh: ReplayMesh, host: torch.Tensor,
               device: torch.device) -> torch.Tensor:
    mesh.staged_bytes += host.numel() * host.element_size()
    return host.to(device)


def all_gather(mesh: ReplayMesh, t: torch.Tensor, axis: str,
               to_host: bool = False) -> torch.Tensor:
    """Every rank's ``t`` on ``axis``, concatenated along dim 0 in axis
    order (tiled); on the host when ``to_host``, else on t's device."""
    x = _to_host(mesh, t.contiguous()) if _stages(mesh, t) else t.contiguous()
    parts = [torch.empty_like(x) for _ in mesh.ranks(axis)]
    dist.all_gather(parts, x, group=mesh.group(axis))
    out = torch.cat(parts, dim=0)
    if to_host:
        return out.cpu()
    if out.device != t.device:
        return _to_device(mesh, out, t.device)
    return out


def all_reduce(mesh: ReplayMesh, t: torch.Tensor, op,
               axis: str) -> torch.Tensor:
    """``op`` over ``axis`` of ``t``; returns the result on t's device."""
    x = _to_host(mesh, t) if _stages(mesh, t) else t.clone()
    dist.all_reduce(x, op=op, group=mesh.group(axis))
    return _to_device(mesh, x, t.device) if x.device != t.device else x


def broadcast_(mesh: ReplayMesh, t: torch.Tensor, src_index: int,
               axis: str) -> torch.Tensor:
    """Overwrite ``t`` on every rank of ``axis`` with the copy of the
    rank at position ``src_index``; returns ``t``."""
    src = mesh.ranks(axis)[src_index]
    if not _stages(mesh, t):
        dist.broadcast(t, src=src, group=mesh.group(axis))
        return t
    host = (_to_host(mesh, t) if mesh.rank == src else
            torch.empty(t.shape, dtype=t.dtype, pin_memory=True))
    dist.broadcast(host, src=src, group=mesh.group(axis))
    if mesh.rank != src:
        t.copy_(host)
        mesh.staged_bytes += host.numel() * host.element_size()
    return t


class _Sent:
    """A pending send and the buffer it reads, kept alive until waited."""

    def __init__(self, work, buf):
        self.work, self.buf = work, buf

    def wait(self) -> None:
        self.work.wait()


def isend(mesh: ReplayMesh, t: torch.Tensor, dst_index: int, axis: str,
          tag: int = 0) -> _Sent:
    """Start sending ``t`` to the rank at ``dst_index`` of ``axis``; the
    caller waits the returned handle and leaves ``t`` unchanged until
    then."""
    buf = _to_host(mesh, t) if _stages(mesh, t) else t
    work = dist.isend(buf, dst=mesh.ranks(axis)[dst_index],
                      group=mesh.group(axis), tag=tag)
    return _Sent(work, buf)


def recv(mesh: ReplayMesh, shape, dtype, device: torch.device,
         src_index: int, axis: str, tag: int = 0) -> torch.Tensor:
    """Receive a tensor of ``shape`` from the rank at ``src_index`` of
    ``axis``, onto ``device``."""
    staged = mesh.backend == "gloo" and device.type == "cuda"
    buf = (torch.empty(shape, dtype=dtype, pin_memory=True) if staged
           else torch.empty(shape, dtype=dtype, device=device))
    dist.irecv(buf, src=mesh.ranks(axis)[src_index],
               group=mesh.group(axis), tag=tag).wait()
    return _to_device(mesh, buf, device) if staged else buf

