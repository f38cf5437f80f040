"""A rebuild storm whose histories are already on the card: each batch
replays every lane from the empty state over its whole history through
``replay_scan_teb``, then refreshes its tasks (``refresh_tasks_device``),
in the closed loop of ``yardstick/closed_loop.py``."""

from types import SimpleNamespace

import numpy as np
import torch

import port
from yardstick import reference as REF
from yardstick import roofline
from yardstick.closed_loop import window  # noqa: F401  (the driver's loop)
from yardstick.histories import caps_of

SPANS = (port.REPLAY_SPAN, port.REFRESH_SPAN)
step = port.resident_step
to_host = port.to_host


def program(device: str):
    return port.program(device, ("replay_fsm",))


def make_inputs(prog, cell, hs, device: str) -> SimpleNamespace:
    """The uniques packed by the port's packer and tiled to the cell's
    lanes on ``device``: events [T, EV_N, lanes], each lane's empty
    state."""
    S, P = prog.S, prog.P
    caps = S.Capacities(**cell.config["caps"])
    lanes = int(cell.size["lanes"])
    reps = port.reps_of(lanes, len(hs))
    packed = P.pack_histories(port.to_port(prog, hs), caps=caps)
    teb = torch.from_numpy(np.array(packed.teb())).to(device)
    return SimpleNamespace(
        caps=caps, lanes=lanes, steps=teb.shape[0],
        events=port.tile(teb, reps, 2),
        state0=port.empty_states(prog, caps, lanes, device))


def work(cell, hs) -> dict:
    """The FSM's bytes, operations and least time a batch needs: every
    event of every history (``yardstick/roofline.py``)."""
    caps = caps_of(cell.config)
    epoch = REF.epoch_of(hs)
    rows = [REF.pack_rows(h, caps, epoch) for h in hs]
    return roofline.replay_work(rows, int(cell.size["lanes"]), caps)
