"""The histories of a configuration, made from a seed, and the cut of a
history into the prefix a checkpoint holds and the tail replayed after
it.

A configuration names its generator, ``generators/<generator>.py`` of
the benchmark, whose ``make(seed, n, caps, args)`` takes the
configuration's ``generator_args``. The same seed gives the same
histories.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path
from typing import Dict, List, Sequence, Tuple

from .schema import Capacities

GENERATORS = Path(__file__).resolve().parent.parent / "generators"


def generator(name: str):
    """``make`` of ``generators/<name>.py``."""
    spec = importlib.util.spec_from_file_location(
        f"portbench_generators_{name}", GENERATORS / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.make


def caps_of(config: Dict) -> Capacities:
    return Capacities(**config["caps"])


def make(config: Dict, seed: int) -> List:
    """``config["unique_histories"]`` histories of the configuration's
    generator, each a list of transaction batches."""
    gen = generator(config["generator"])
    return gen(seed, int(config["unique_histories"]), caps_of(config),
               dict(config.get("generator_args", {})))


def n_events(batches: Sequence) -> int:
    return sum(len(b) for b in batches)


def split_tail(batches: Sequence, tail_frac: float) -> Tuple[list, list]:
    """(prefix, tail): the tail is the trailing whole batches that hold at
    most ``floor(n * tail_frac)`` of the history's n events, and at least
    its last batch; the prefix keeps at least the first batch."""
    limit = int(n_events(batches) * tail_frac)
    cut, held = len(batches), 0
    while cut > 1 and (cut == len(batches)
                       or held + len(batches[cut - 1]) <= limit):
        held += len(batches[cut - 1])
        cut -= 1
    return list(batches[:cut]), list(batches[cut:])
