"""A checkpoint-resume storm: each lane resumes from its checkpointed
state and replays only the tail of its history (the trailing whole
batches within ``traffic["tail_frac"]`` of its events) through
``replay_scan_teb``, then refreshes its tasks (``refresh_tasks_device``),
in the closed loop of ``yardstick/closed_loop.py``. Set-up replays each
prefix once on the card and packs the tail from the lane's state and
packer state, as a rebuild resumes from a checkpoint record."""

import dataclasses
from types import SimpleNamespace

import numpy as np
import torch

import port
from yardstick import histories as H
from yardstick import reference as REF
from yardstick import roofline
from yardstick.closed_loop import window  # noqa: F401  (the driver's loop)

SPANS = (port.REPLAY_SPAN, port.REFRESH_SPAN)
step = port.resident_step
to_host = port.to_host


def program(device: str):
    return port.program(device, ("replay_fsm",))


def _cuts(cell, hs) -> list:
    frac = float(cell.traffic["tail_frac"])
    return [H.split_tail(h, frac) for h in hs]


def make_inputs(prog, cell, hs, device: str) -> SimpleNamespace:
    """The tails packed from each prefix's checkpoint and tiled to the
    cell's lanes on ``device``: events [T, EV_N, lanes] with T the
    tail's ``ceil(max_events * tail_frac)`` steps, each lane's resumed
    state."""
    S, P, RC = prog.S, prog.P, prog.RC
    caps = S.Capacities(**cell.config["caps"])
    u, lanes = len(hs), int(cell.size["lanes"])
    reps = port.reps_of(lanes, u)
    cuts = _cuts(cell, hs)
    pre = P.pack_histories(port.to_port(prog, [c[0] for c in cuts]),
                           caps=caps)
    pre_state = RC.replay_scan_teb(
        port.empty_states(prog, caps, u, device),
        torch.from_numpy(np.array(pre.teb())).to(device), caps)
    pre_host = S.state_to_numpy(pre_state)
    # what a checkpoint record hands the packer (its resume_state)
    resume = [P.ResumeState(pack=pre.side[i].resume,
                            side=pre.side[i].duplicate(),
                            state_row=S.state_row(pre_host, i))
              for i in range(u)]
    steps = int(np.ceil(caps.max_events * float(cell.traffic["tail_frac"])))
    packed = P.pack_histories(port.to_port(prog, [c[1] for c in cuts]),
                              caps=dataclasses.replace(caps,
                                                       max_events=steps),
                              resume=resume)
    teb = torch.from_numpy(np.array(packed.teb())).to(device)
    init = S.state_from_numpy(packed.initial, device)
    return SimpleNamespace(
        caps=caps, lanes=lanes, steps=teb.shape[0],
        events=port.tile(teb, reps, 2),
        state0=port.tile_state(prog, init, reps),
        tail_events=[H.n_events(c[1]) for c in cuts])


def work(cell, hs) -> dict:
    """The FSM's bytes, operations and least time a batch needs: the
    tail's events of every history (``yardstick/roofline.py``)."""
    caps = H.caps_of(cell.config)
    epoch = REF.epoch_of(hs)
    rows = [REF.pack_rows(h, caps, epoch)[-H.n_events(t):]
            for h, (_, t) in zip(hs, _cuts(cell, hs))]
    return roofline.replay_work(rows, int(cell.size["lanes"]), caps)
