"""Canary: live health-probe workflows.

Reference: canary/ — const.go:64-84 lists the probe set (echo, signal,
timeout, retry, concurrentExec, cron, query, reset, ...); sanity.go:54
fans them out. run via ``python -m cadence_tpu_torch.tools.cli canary``.

A copy of the reference package's ``canary/``; ``run_canary`` takes
``device`` for the Onebox it embeds when given neither an address nor a
frontend.
"""

from .runner import run_canary

__all__ = ["run_canary"]
