#!/usr/bin/env python3
"""The control and the planted faults of the benchmark's check: each
must come out not correct, while the program's own step comes out
correct.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 1 [--modes program,control,unchanged,...]

For each seed the cell is set up once (as ``run.py`` does) and the
reference worked out once; then each mode drives a short window of the
cell's own load through its step, and the window's first and last batch
are checked as a run checks them. One JSON line a seed and mode.

Modes (the configuration states no precision; its guarantee is an exact
state and exact tasks for every lane):

- ``program``: the port's step, as the benchmark times it;
- ``control``: the port's step on the int16 event stream with every
  column narrowed by a plain cast, wide columns (hashes, raw values)
  wrapped to 16 bits: the lossy step a narrower stream would tempt;
- ``unchanged``: a step that returns the state it started from;
- ``half``: half the lanes replayed, the rest left at their start;
- ``altered_state`` / ``altered_task``: one lane's state field, or one
  lane's task, altered where it is produced.
"""

import argparse
import json
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
if str(HERE) not in sys.path:
    sys.path.insert(0, str(HERE))

import torch  # noqa: E402

import port  # noqa: E402
import run  # noqa: E402

MODES = ("program", "control", "unchanged", "half", "altered_state",
         "altered_task")


def _refresh(prog, spans, final):
    with spans(port.REFRESH_SPAN):
        return final, prog.R.refresh_tasks_device(final)


def control_step(prog, inp, spans):
    ev = inp.events
    lo = torch.amin(ev, dim=(0, 2)).long()
    hi = torch.amax(ev, dim=(0, 2)).long()
    base = ((lo + hi) // 2).to(torch.int32)
    ev16 = (ev - base[None, :, None]).to(torch.int16)
    base_host = base.cpu().numpy()

    def step():
        with spans(port.REPLAY_SPAN):
            final = prog.RC.replay_scan_teb(inp.state0, ev16, inp.caps,
                                            base=base_host, wide_cols=())
        return _refresh(prog, spans, final)
    return step


def unchanged_step(prog, inp, spans):
    def step():
        return _refresh(prog, spans, inp.state0)
    return step


def half_step(prog, inp, spans):
    h = inp.lanes // 2
    ev = inp.events[:, :, :h].contiguous()
    st = inp.state0.map(lambda x: x[:h].contiguous())

    def step():
        with spans(port.REPLAY_SPAN):
            part = prog.RC.replay_scan_teb(st, ev, inp.caps)
            final = prog.S.StateTensors(**{
                f: torch.cat([getattr(part, f), getattr(inp.state0, f)[h:]])
                for f in prog.S.STATE_ROW_FIELDS})
        return _refresh(prog, spans, final)
    return step


def altered_state_step(prog, inp, spans):
    x_next = prog.S.X_NEXT_EVENT_ID

    def step():
        with spans(port.REPLAY_SPAN):
            final = prog.RC.replay_scan_teb(inp.state0, inp.events, inp.caps)
            final.exec_info[0, x_next] += 1
        return _refresh(prog, spans, final)
    return step


def altered_task_step(prog, inp, spans):
    inner = port.resident_step(prog, inp, spans)

    def step():
        final, tasks = inner()
        tasks.workflow_timeout_ts[0] += 1
        return final, tasks
    return step


STEPS = {"program": port.resident_step, "control": control_step,
         "unchanged": unchanged_step, "half": half_step,
         "altered_state": altered_state_step,
         "altered_task": altered_task_step}


def readings(cell, seed: int, seconds: float, modes, device: str):
    """One reading a mode: (mode, correct, checks, batches)."""
    ctx = run.prepare(cell, seed, device)
    want = run.reference(ctx)
    out = []
    for mode in modes:
        step = STEPS[mode](ctx.prog, ctx.inp, run.spans_of(False))
        step()
        w = ctx.driver.window(step, seconds, cell.traffic, device)
        outputs = run.outputs_to_host(ctx, w.kept)
        w.kept = step = None
        checks, _ = run.check(outputs, want, ctx.lanes)
        out.append((mode, run.passes(checks, len(outputs)), checks,
                    w.batches))
        if device != "cpu":
            torch.cuda.empty_cache()
    ctx.inp = None
    if device != "cpu":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--modes", default=",".join(MODES))
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("control: needs a CUDA device", file=sys.stderr)
        return 2
    cell = run.resolve(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode, ok, checks, batches in readings(
                cell, seed, args.seconds, args.modes.split(","), "cuda"):
            print(json.dumps({"workload": args.workload, "seed": seed,
                              "mode": mode, "correct": ok,
                              "batches": batches, "checks": checks}),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
