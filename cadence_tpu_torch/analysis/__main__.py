"""CLI for the port's static-analysis gate.

    python -m cadence_tpu_torch.analysis [--baseline PATH ...]
                                         [--passes surface,jit,locks,metrics,queue]
                                         [--emit-matrix PATH]
                                         [--emit-conflict-matrix PATH]
                                         [--emit-lock-graph PATH [--witness PATH]]
                                         [--strict-stale]
                                         [--write-baseline PATH]
                                         [--root DIR]
                                         [--device cuda|cpu]

Exit status: 0 when every finding is baselined (or none), 1 when new
findings exist, 2 on usage/internal error. The baselines are this
package's ``lint_baseline.json`` and ``lock_baseline.json`` unless
``--baseline`` names others. The surface pass probes the FSM step one
step per transition group on ``--device``: by default ``cuda``, the
CUDA kernel (raising without a card, like every entry point of the
port); ``--device cpu`` probes the plain step instead, and the whole gate
then runs on the CPU in well under a minute.

A copy of the reference package's ``analysis/__main__.py``.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m cadence_tpu_torch.analysis")
    ap.add_argument(
        "--root",
        default=os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__)
        ))),
        help="repo root (default: derived from this package's location)",
    )
    ap.add_argument(
        "--baseline", default=None, action="append", metavar="PATH",
        help="baseline JSON of accepted findings, repeatable (default: "
        "this package's lint_baseline.json and lock_baseline.json)",
    )
    ap.add_argument(
        "--passes", default=None,
        help="comma-separated subset of passes "
        "(surface,jit,locks,metrics,queue)",
    )
    ap.add_argument(
        "--emit-matrix", default=None, metavar="PATH",
        help="also write the transition coverage matrix JSON artifact",
    )
    ap.add_argument(
        "--emit-conflict-matrix", default=None, metavar="PATH",
        help="also write the queue-task commutativity matrix JSON "
        "artifact (the parallel-queue executor's gate)",
    )
    ap.add_argument(
        "--emit-lock-graph", default=None, metavar="PATH",
        help="also write the lock-graph JSON artifact: static lock "
        "inventory + acquisition-order edges, annotated "
        "observed/never-observed against the latest runtime witness "
        "(build/torch_lock_witness.json from a sanitized suite run)",
    )
    ap.add_argument(
        "--witness", default=None, metavar="PATH",
        help="runtime lock-witness artifact for --emit-lock-graph "
        "annotations (default: build/torch_lock_witness.json under "
        "--root)",
    )
    ap.add_argument(
        "--strict-stale", action="store_true",
        help="treat stale baseline entries as errors (exit 1) instead "
        "of warnings, so dead entries can't accumulate silently",
    )
    ap.add_argument(
        "--write-baseline", default=None, metavar="PATH",
        help="write ALL current findings as a fresh baseline "
        "(justifications stubbed 'TODO') and exit 0",
    )
    ap.add_argument(
        "-q", "--quiet", action="store_true",
        help="only print the summary line and new findings",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="where the surface pass probes the FSM step: cuda (the "
        "kernel; the default, needs a card) or cpu (the plain step)",
    )
    args = ap.parse_args(argv)

    from . import (
        BASELINE_PATHS, Baseline, BaselineEntry, load_baselines, run_all,
        scope_baseline,
    )

    passes = args.passes.split(",") if args.passes else None
    t0 = time.monotonic()
    try:
        by_pass = run_all(args.root, passes=passes, device=args.device)
    except Exception as e:  # a broken tree must fail loudly, not pass
        print(f"analysis error: {type(e).__name__}: {e}", file=sys.stderr)
        return 2

    if args.emit_matrix:
        from . import transition_surface

        try:
            transition_surface.emit_matrix(args.root, args.emit_matrix,
                                           device=args.device)
        except Exception as e:
            print(
                f"analysis error writing matrix: {type(e).__name__}: {e}",
                file=sys.stderr,
            )
            return 2
        print(f"transition matrix -> {args.emit_matrix}")

    if args.emit_conflict_matrix:
        from . import queue_effects

        try:
            queue_effects.emit_conflict_matrix(
                args.root, args.emit_conflict_matrix
            )
        except Exception as e:
            print(
                f"analysis error writing conflict matrix: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )
            return 2
        print(f"queue conflict matrix -> {args.emit_conflict_matrix}")

    if args.emit_lock_graph:
        from . import lock_order

        try:
            doc = lock_order.emit_lock_graph(
                args.root, args.emit_lock_graph,
                witness_path=args.witness,
                baseline_path=(args.baseline[0] if args.baseline
                               and len(args.baseline) == 1 else None),
            )
        except Exception as e:
            print(
                f"analysis error writing lock graph: "
                f"{type(e).__name__}: {e}",
                file=sys.stderr,
            )
            return 2
        print(
            f"lock graph -> {args.emit_lock_graph} "
            f"(witness: {doc['witness']})"
        )

    all_findings = [f for fs in by_pass.values() for f in fs]

    if args.write_baseline:
        bl = Baseline([
            BaselineEntry(rule=f.rule, anchor=f.anchor, justification="TODO")
            for f in all_findings
        ])
        bl.save(args.write_baseline)
        print(f"wrote {len(bl.entries)} baseline entries -> "
              f"{args.write_baseline}")
        return 0

    baseline = load_baselines(args.baseline or BASELINE_PATHS)
    # a --passes subset must not count the skipped passes' baseline
    # entries as stale (a `--passes queue` run would otherwise strict-
    # fail on every SURFACE-*/LOCK-* entry)
    baseline = scope_baseline(baseline, passes)
    new, accepted, stale = baseline.split(all_findings)

    for name, fs in by_pass.items():
        fresh = [f for f in fs if f in new]
        if not args.quiet:
            print(f"== pass {name}: {len(fs)} finding(s), "
                  f"{len(fs) - len(fresh)} baselined ==")
        for f in fresh:
            print(f.format())
    stale_word = "error" if args.strict_stale else "warning"
    for e in stale:
        print(f"{stale_word}: stale baseline entry [{e.rule}] {e.anchor} "
              "matched nothing (fixed? remove it)", file=sys.stderr)

    dt = time.monotonic() - t0
    print(
        f"cadence_tpu_torch.analysis: {len(all_findings)} finding(s), "
        f"{len(accepted)} baselined, {len(new)} new, "
        f"{len(stale)} stale baseline entr(ies) in {dt:.1f}s"
    )
    if new:
        return 1
    if stale and args.strict_stale:
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
