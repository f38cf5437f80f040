"""The ndc_storm configuration's histories: ``ndc_storm_history`` of
``yardstick/workloads.py``, each from a fuzzer of its own seeded
``seed * 2**16 + index``."""

from yardstick import workloads as W
from yardstick.event_generator import HistoryFuzzer

# seeds of the per-history fuzzers: seed * _STRIDE + index
_STRIDE = 1 << 16


def make(seed: int, n: int, caps, args: dict) -> list:
    if n > _STRIDE:
        raise ValueError(f"{n} unique histories exceed {_STRIDE}")
    return [W.ndc_storm_history(HistoryFuzzer(seed=seed * _STRIDE + i,
                                              caps=caps), **args)
            for i in range(n)]
