"""The benchmark's plain reference: the final state and the outstanding
tasks of each history, replayed from the empty state over its whole
history.

It reads only the generated histories and its own frozen copies of the
packer (``pack.py``), the plain FSM step (``fsm.py``) and the refresh
(``refresh.py``), in NumPy and PyTorch on the CPU; it imports nothing of
the program under test.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch

from . import fsm
from . import refresh as R
from . import schema as S
from .pack import epoch_of, pack_rows, teb


def replay_histories(histories: Sequence, caps: S.Capacities,
                     block: int = 256):
    """(state, tasks) of ``histories`` (each a list of transaction
    batches): ``state`` a numpy StateTensors, ``tasks`` a dict of numpy
    arrays by ``refresh.FIELDS``, one row a history. Replays ``block``
    histories at a time."""
    epoch = epoch_of(histories)
    rm = fsm.RowMap(caps)
    states, tasks = [], []
    for lo in range(0, len(histories), block):
        part = histories[lo:lo + block]
        rows = [pack_rows(h, caps, epoch) for h in part]
        steps = max(r.shape[0] for r in rows)
        ev = torch.from_numpy(teb(rows, steps))
        empty = S.empty_state(len(part), caps)
        st0 = S.StateTensors(**{f: torch.from_numpy(getattr(empty, f))
                                for f in S.STATE_ROW_FIELDS})
        final = fsm.rows_to_state(
            fsm.replay(ev, fsm.state_to_rows(st0, rm), caps), rm)
        refreshed = R.refresh_tasks_device(final)
        states.append({f: getattr(final, f).numpy()
                       for f in S.STATE_ROW_FIELDS})
        tasks.append({f: getattr(refreshed, f).numpy() for f in R.FIELDS})
    state = S.StateTensors(**{
        f: np.concatenate([s[f] for s in states]) for f in S.STATE_ROW_FIELDS})
    return state, {f: np.concatenate([t[f] for t in tasks])
                   for f in R.FIELDS}


def lanes_wrong(got: Dict[str, np.ndarray], want: Dict[str, np.ndarray],
                lanes: int) -> np.ndarray:
    """[lanes] bool: lane ``i`` differs from unique ``i % U`` of ``want``
    in any field of ``got`` (arrays by field, one row a lane). A field of
    the wrong shape marks every lane."""
    bad = np.zeros(lanes, bool)
    for f, w in want.items():
        g = np.asarray(got[f])
        u = w.shape[0]
        if g.shape[0] != lanes or g.shape[1:] != w.shape[1:] or lanes % u:
            bad[:] = True
            continue
        diff = (g.reshape(lanes // u, u, -1).astype(np.int64)
                != w.reshape(1, u, -1).astype(np.int64))
        bad |= diff.any(axis=2).reshape(lanes)
    return bad
