#!/usr/bin/env python3
"""One run of one cell of the benchmark of ``cadence_tpu_torch`` (the
PyTorch and CUDA port) on one card.

    python3 portbench/run.py --workload <config>.<traffic> --seed <n> \\
        --seconds <s> --trace <0|1>

A cell names a configuration (``configs/<config>.json``: capacities,
generator, depth, unique histories), a traffic mix
(``traffic/<traffic>.json``: parameters, and the driver that drives the
port with them) and its own size (``cells/<cell>.json``: lanes). The run
makes the cell's histories from the seed; the driver
(``drivers/<driver>.py``) hands them to the port on the card and builds
the step its window drives for ``--seconds``. The run checks every lane
of the window's first and last batch against the plain reference in
``yardstick/`` and prints one JSON line: the cell's end-to-end metrics
with ``--trace 0``, and with ``--trace 1`` its per-layer metrics, each
read by ``metrics/<metric>.py`` from the profiler's trace of a further
window. It exits non-zero without a result where there is no CUDA card.

This file holds no code of one configuration, mix or metric: a later
cell adds files and entries only.
"""

import time

T_PROCESS = time.perf_counter()  # set-up counts from the process start

import argparse  # noqa: E402
import contextlib  # noqa: E402
import gc  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
for p in (str(HERE), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from yardstick import histories as H  # noqa: E402
from yardstick import reference as REF  # noqa: E402
from yardstick import trace  # noqa: E402
from yardstick.closed_loop import sync  # noqa: E402

T_IMPORTED = time.perf_counter()

# top-level module names no run may load (compared whole: the port's name
# begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "cadence_tpu")
# batches of the traced window (at most; it also ends after --seconds)
TRACE_BATCHES = 200
WARMUP_BATCHES = 4


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def resolve(cell: str) -> SimpleNamespace:
    """The cell's entry in ``BENCHMARK.json``, its configuration, traffic
    and size files, its traffic's driver, and the metrics it reports."""
    bench = _load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == cell), None)
    if entry is None:
        raise SystemExit(f"unknown workload {cell!r}")

    def applies(m):
        return "workloads" not in m or cell in m["workloads"]

    traffic = _load_json(HERE / "traffic" / f"{entry['traffic']}.json")
    return SimpleNamespace(
        name=cell, entry=entry,
        config=_load_json(HERE / "configs" / f"{entry['config']}.json"),
        traffic=traffic, driver=driver(traffic["driver"]),
        size=_load_json(HERE / "cells" / f"{cell}.json"),
        end_to_end=[m for m in bench["end_to_end"] if applies(m)],
        per_layer=[m for m in bench["per_layer"] if applies(m)])


def _module(folder: str, name: str):
    spec = importlib.util.spec_from_file_location(
        f"portbench_{folder}_{name.replace('.', '_').replace('-', '_')}",
        HERE / folder / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(name: str):
    """``read(view)`` of ``metrics/<name>.py``."""
    return _module("metrics", name).read


def driver(name: str):
    """``drivers/<name>.py``: ``program(device)``, ``make_inputs(prog, cell,
    histories, device)``, ``step(prog, inputs, spans)``, ``window(step,
    seconds, traffic, device, max_batches)``, ``to_host(prog, output)``
    (state and tasks by field), ``work(cell, histories)`` (the FSM's
    least time a batch) and ``SPANS``, the span names its step opens."""
    return _module("drivers", name)


def traced_window(drv, step, seconds: float, traffic: dict, device: str):
    """The driver's window under torch.profiler, at most
    ``TRACE_BATCHES`` batches; returns it and the trace's reduction."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if device != "cpu":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(trace.WINDOW_SPAN):
            w = drv.window(step, seconds, traffic, device, TRACE_BATCHES)
    red = trace.reduce_events(prof.profiler.kineto_results.events(),
                              tuple(drv.SPANS), DeviceType.CUDA,
                              DeviceType.CPU)
    return w, red


# --------------------------------------------------------------------------
# The check
# --------------------------------------------------------------------------


def outputs_to_host(ctx, kept) -> list:
    return [ctx.driver.to_host(ctx.prog, out) for out in kept]


def reference(ctx) -> tuple:
    """The reference's state fields and tasks of the cell's uniques."""
    state, tasks = REF.replay_histories(ctx.hs, H.caps_of(ctx.cell.config))
    return {f: getattr(state, f) for f in REF.S.STATE_ROW_FIELDS}, tasks


def check(outputs, want, lanes: int) -> tuple:
    """Every lane of every kept batch against the reference ``want``: the
    lanes whose state, and those whose refreshed tasks, differ from a
    whole replay of their history from the empty state. Exact: limit 0.
    Returns the checks and the count of lanes wrong in either."""
    want_state, want_tasks = want
    bad_state = np.zeros(lanes, bool)
    bad_tasks = np.zeros(lanes, bool)
    for state, tasks in outputs:
        bad_state |= REF.lanes_wrong(state, want_state, lanes)
        bad_tasks |= REF.lanes_wrong(tasks, want_tasks, lanes)
    return {
        "state_lanes_wrong": {"value": int(bad_state.sum()), "limit": 0},
        "task_lanes_wrong": {"value": int(bad_tasks.sum()), "limit": 0},
    }, int((bad_state | bad_tasks).sum())


def passes(checks: dict, batches_checked: int) -> bool:
    return batches_checked > 0 and all(
        c["value"] <= c["limit"] for c in checks.values())


# --------------------------------------------------------------------------
# One run
# --------------------------------------------------------------------------


def power_limit() -> str:
    """The card's name and power limit as ``nvidia-smi`` reads them."""
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"unread: {e}"
    return res.stdout.strip() or res.stderr.strip()


def prepare(cell, seed: int, device: str) -> SimpleNamespace:
    """Set-up up to the warm-up: the driver's program (its kernel
    libraries), the histories of the seed, and the inputs on
    ``device``."""
    drv = cell.driver
    split = {}
    t = time.perf_counter()
    if device != "cpu":
        torch.cuda.init()
    split["cuda_init_s"] = time.perf_counter() - t
    t = time.perf_counter()
    prog = drv.program(device)
    if device != "cpu":
        torch.cuda.reset_peak_memory_stats()
    split["program_s"] = time.perf_counter() - t
    t = time.perf_counter()
    hs = H.make(cell.config, seed)
    split["generate_s"] = time.perf_counter() - t
    t = time.perf_counter()
    inp = drv.make_inputs(prog, cell, hs, device)
    sync(device)
    split["inputs_s"] = time.perf_counter() - t
    return SimpleNamespace(
        prog=prog, cell=cell, driver=drv, hs=hs, device=device, inp=inp,
        split=split, lanes=int(cell.size["lanes"]))


def spans_of(traced: bool):
    if traced:
        return lambda n: torch.profiler.record_function(n)
    return lambda n: contextlib.nullcontext()


def run_cell(name: str, seed: int, seconds: float, traced: bool,
             device: str = "cuda", cell=None, t_start: float = None,
             split: dict = None) -> dict:
    """One run; returns the result line as a dict. ``cell`` overrides
    the resolved cell (tests shrink it); ``split`` holds set-up's parts
    timed before this call."""
    t_start = T_PROCESS if t_start is None else t_start
    ctx = prepare(cell or resolve(name), seed, device)
    ctx.split = dict(split or {}, **ctx.split)
    cell, drv, traffic = ctx.cell, ctx.driver, ctx.cell.traffic
    step = drv.step(ctx.prog, ctx.inp, spans_of(traced))
    t = time.perf_counter()
    # a short window of its own: the allocator grows to the window's
    # footprint (the first batch kept, the batches in flight) here
    drv.window(step, float("inf"), traffic, device, WARMUP_BATCHES)
    ctx.split["warmup_s"] = time.perf_counter() - t
    # the histories (a million Python objects) stay alive for the check:
    # keep the cyclic collector's full passes over them (~0.3 s each) out
    # of the window
    t = time.perf_counter()
    gc.collect()
    gc.freeze()
    ctx.split["gc_s"] = time.perf_counter() - t
    setup_s = time.perf_counter() - t_start
    ctx.split["other_s"] = setup_s - sum(ctx.split.values())

    w = drv.window(step, seconds, traffic, device)
    red = None
    if traced:
        # the profiler's start-up, then the traced window; after the
        # untraced one, whose host times the profiler's hooks would slow
        if device != "cpu":
            traced_window(drv, step, 0.5, traffic, device)
        tw, red = traced_window(drv, step, seconds, traffic, device)
        w.kept = [w.kept[0], tw.kept[-1]]
        red["batches"] = tw.batches
    dev = {"platform": "gpu" if device != "cpu" else "cpu",
           "kind": (torch.cuda.get_device_name(0) if device != "cpu"
                    else "cpu"),
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if device != "cpu" else 0)}
    if device != "cpu":
        dev["power_limit"] = power_limit()
    if red is not None:
        dev["busy_s"] = red.get("busy_s", 0.0)
        dev["window_s"] = red.get("window_s", 0.0)

    gc.unfreeze()
    outputs = outputs_to_host(ctx, w.kept)
    w.kept = None
    ctx.inp = step = None
    if device != "cpu":
        torch.cuda.empty_cache()
    checks, failed = check(outputs, reference(ctx), ctx.lanes)
    batches_checked = len(outputs)
    del outputs

    view = SimpleNamespace(
        cell=cell, setup_s=setup_s, window=w, trace=red,
        lanes=ctx.lanes, work=lambda: drv.work(cell, ctx.hs))
    wanted = cell.per_layer if traced else cell.end_to_end
    metrics = {}
    for m in wanted:
        v = reader(m["name"])(view)
        if v is not None:
            metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    result = {"correct": passes(checks, batches_checked),
              "attempted": w.batches * ctx.lanes,
              "failed": failed, "metrics": metrics, "device": dev}
    if red:
        result["breakdown"] = {
            "device_ops": [[k, v] for k, v in red["device_ops"]],
            "idle_gaps": [[k, v] for k, v in red["idle_gaps"]]}
        result["trace_attribution"] = {
            "batches": red["batches"],
            "device_activities": red["device_activities"],
            "unattributed": red["unattributed"],
            "attributed_by_op": red["attributed_by_op"],
            "span_activities": red["span_activities"]}
    result["window"] = {"batches": w.batches, "seconds": w.seconds}
    for key, xs in (("enqueue", w.enqueue_s), ("batch", w.batch_s)):
        if xs:
            result["window"][f"{key}_ms_median"] = statistics.median(xs) * 1e3
            result["window"][f"{key}_ms_max"] = max(xs) * 1e3
    result["setup_split"] = ctx.split
    result["checks"] = checks
    return result


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    split = {"import_s": T_IMPORTED - T_PROCESS}
    t = time.perf_counter()
    cell = resolve(args.workload)
    chips = int(cell.entry["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    split["resolve_s"] = time.perf_counter() - t
    result = run_cell(args.workload, args.seed, args.seconds,
                      bool(args.trace), cell=cell, split=split)
    found = forbidden_modules()
    if found:
        print(f"portbench: the run loaded {found}; no result",
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
