"""Entry points: the batched replay step and a multi-rank dry run.

The twin of the reference repository's ``__graft_entry__.py``.
``entry`` returns the replay + task-refresh forward step with example
inputs; ``dryrun_multichip`` runs the batch-sharded replay + refresh,
the NDC snapshot exchange and the time-pipelined replay on a mesh of
``torch.distributed`` ranks.

    python -m cadence_tpu_torch.entry --ranks 4 --backend gloo

``--backend`` is explicit: ``nccl`` needs a card a rank; ``gloo`` runs
the ranks on the CPU (``--device cpu``) or all of them on one card,
where their kernels time-slice it.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch
import torch.distributed as dist

from .ops import schema as S
from .ops import replay_cuda as RC
from .ops.pack import pack_histories
from .ops.refresh import refresh_tasks_device
from .parallel import (
    make_mesh, ndc_snapshot_exchange, replay_packed_sharded,
    replay_pipelined,
)
from .parallel.launch import run_ranks
from .parallel.mesh import pipeline_spec, shard_spec
from .testing.event_generator import HistoryFuzzer

ENTRY_CAPS = S.Capacities(max_events=64)


def _tiny_packed(n_workflows: int, target_events: int, caps):
    fuzzer = HistoryFuzzer(seed=7, caps=caps)
    histories = [
        (f"wf-{i}", f"run-{i}", fuzzer.generate(target_events=target_events))
        for i in range(n_workflows)
    ]
    return pack_histories(histories, caps=caps, pad_batch_to=n_workflows)


def entry(device="cuda"):
    """(forward, example_args): the batched replay + refresh step on
    ``device`` and its inputs, 8 fuzzed workflows of 24 target events."""
    dev = S.resolve_device(device)
    caps = ENTRY_CAPS
    packed = _tiny_packed(n_workflows=8, target_events=24, caps=caps)
    state = S.state_from_numpy(S.empty_state(packed.batch, caps), dev)
    events_teb = S.host_tensor(packed.teb()).to(dev)

    def forward(state, events_teb):
        final = RC.replay_scan_teb(state, events_teb, caps)
        return final, refresh_tasks_device(final)

    return forward, (state, events_teb)


def dryrun_multichip(n_ranks: int, device="cuda", *, backend: str,
                     timeout_s: float = 600.0) -> list:
    """The full sharded step on ``n_ranks`` ranks: batch-sharded replay +
    refresh, the NDC all_gather/all_reduce snapshot exchange and (when
    the mesh has a seq axis) the time-pipelined replay, checked against
    the sharded replay. Returns each rank's record."""
    return run_ranks(_dryrun_rank, n_ranks, backend=backend, device=device,
                     timeout_s=timeout_s)


def _dryrun_rank(dev: torch.device) -> dict:
    n = dist.get_world_size()
    seq = 2 if n % 2 == 0 and n >= 4 else 1
    mesh = make_mesh(seq=seq)
    n_shard = mesh.shape["shard"]
    caps = ENTRY_CAPS
    batch = max(2 * n_shard * seq, n_shard)  # divisible by both axes' needs
    packed = _tiny_packed(n_workflows=batch, target_events=24, caps=caps)
    RC.replay_rows.launches = 0

    # 1) dp: batch-sharded replay + task refresh
    final, _ = replay_packed_sharded(packed, mesh, device=dev)
    if final.exec_info.shape[0] != batch:
        raise RuntimeError(f"sharded replay gave {final.exec_info.shape[0]}"
                           f" rows for a batch of {batch}")

    # 2) NDC storm: all_gather / all_reduce snapshot exchange
    blk = shard_spec(mesh, batch)
    digests, _, _, replayed, _ = ndc_snapshot_exchange(
        S.state_from_numpy(final.map(lambda x: x[blk]), dev), mesh)
    started = int((final.exec_info[:, S.X_START_TS] > 0).sum())
    if int(replayed) != started or digests.shape != (batch, 6):
        raise RuntimeError(
            f"exchange: replayed {int(replayed)} of {started} started, "
            f"digests {tuple(digests.shape)}")

    # 3) sp: time-pipelined deep-history replay, checked against (1)
    if seq > 1:
        steps, lanes = pipeline_spec(mesh, caps.max_events, batch)
        init = S.state_from_numpy(
            S.empty_state(batch, caps).map(lambda x: x[lanes]), dev)
        events = S.host_tensor(packed.teb()[steps, :, lanes]).to(dev)
        piped = replay_pipelined(init, events, mesh, n_micro=2)
        if not np.array_equal(piped.exec_info.cpu().numpy(),
                              final.exec_info[lanes]):
            raise RuntimeError("pipelined replay differs from the sharded")
    return {"rank": mesh.rank, "mesh": dict(mesh.shape), "batch": batch,
            "replayed": int(replayed), "pipelined": seq > 1,
            "launches": RC.replay_rows.launches,
            "staged_bytes": mesh.staged_bytes}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--backend", required=True, choices=("gloo", "nccl"))
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    forward, example = entry(args.device)
    final, _ = forward(*example)
    print(f"entry ok: {final.exec_info.shape[0]} workflows on "
          f"{final.exec_info.device}", flush=True)
    recs = dryrun_multichip(args.ranks, args.device, backend=args.backend,
                            timeout_s=args.timeout)
    print(f"dryrun_multichip ok: mesh {recs[0]['mesh']}, "
          f"{args.backend} on {args.device}, FSM launches by rank "
          f"{[r['launches'] for r in recs]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
