"""The retry_deep configuration's histories: ``retry_deep_history`` of
``yardstick/workloads.py``, all drawn from one ``random.Random(seed)``."""

import random

from yardstick import workloads as W


def make(seed: int, n: int, caps, args: dict) -> list:
    rng = random.Random(seed)
    return [W.retry_deep_history(rng, **args) for _ in range(n)]
