"""The program's side of the benchmark: the port (``cadence_tpu_torch``)
and what the drivers hand it. Nothing of the yardstick (``yardstick/``)
imports this module, and nothing here imports JAX or the JAX package.
"""

from types import SimpleNamespace

import torch

# the benchmark's own spans around its calls into the port; device work
# is attributed to the span whose host call launched it
REPLAY_SPAN, REFRESH_SPAN = "bench.replay", "bench.refresh"


def program(device: str, libraries=()) -> SimpleNamespace:
    """The port's modules the resident rebuild step uses; on a card,
    ``libraries`` (the kernel libraries of ``ops/_build.py``) loaded, or
    built in a checkout's first run."""
    from cadence_tpu_torch.core.enums import EventType
    from cadence_tpu_torch.core.events import HistoryEvent
    from cadence_tpu_torch.ops import pack, refresh, replay_cuda, schema
    if device != "cpu" and libraries:
        from cadence_tpu_torch.ops import _build
        for lib in libraries:
            _build.load(lib)
    return SimpleNamespace(P=pack, R=refresh, RC=replay_cuda, S=schema,
                           EventType=EventType, HistoryEvent=HistoryEvent)


def to_port(prog, histories, tag: str = ""):
    """The generated histories as the port's (workflow, run, batches)."""
    E, HE = prog.EventType, prog.HistoryEvent
    return [(f"wf-{tag}{i}", f"run-{tag}{i}", [[
        HE(event_id=e.event_id, event_type=E(int(e.event_type)),
           version=e.version, timestamp=e.timestamp, task_id=e.task_id,
           attributes=dict(e.attributes)) for e in b] for b in h])
        for i, h in enumerate(histories)]


def tile(x: torch.Tensor, reps: int, dim: int) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[dim] = reps
    return x.repeat(*shape).contiguous()


def tile_state(prog, state, reps: int):
    return prog.S.StateTensors(**{
        f: tile(getattr(state, f), reps, 0)
        for f in prog.S.STATE_ROW_FIELDS})


def empty_states(prog, caps, n: int, device: str):
    """``n`` lanes of the empty state on ``device``."""
    S = prog.S
    return tile_state(prog, S.state_from_numpy(S.empty_state(1, caps),
                                               device), n)


def reps_of(lanes: int, uniques: int) -> int:
    if lanes % uniques:
        raise ValueError(f"{lanes} lanes do not tile {uniques} uniques")
    return lanes // uniques


def resident_step(prog, inp, spans):
    """One batch: the port's device-resident rebuild step, the replay of
    every lane then the refresh of its tasks, results left on the card."""
    RC, R = prog.RC, prog.R

    def step():
        with spans(REPLAY_SPAN):
            final = RC.replay_scan_teb(inp.state0, inp.events, inp.caps)
        with spans(REFRESH_SPAN):
            tasks = R.refresh_tasks_device(final)
        return final, tasks
    return step


def to_host(prog, out) -> tuple:
    """A batch's (state, tasks) as NumPy arrays by field."""
    final, tasks = out
    return ({f: getattr(final, f).cpu().numpy()
             for f in prog.S.STATE_ROW_FIELDS},
            {f: getattr(tasks, f).cpu().numpy() for f in prog.R.FIELDS})
