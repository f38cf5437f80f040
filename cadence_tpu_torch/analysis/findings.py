"""Findings + baseline plumbing for the static-analysis gate.

A finding is identified by ``(rule, anchor)``. Anchors are built from
stable names (module path, class.method, event-type name, lock
attribute) — never line numbers — so a baseline entry survives
unrelated edits to the file it points at. Line numbers ride along in
the message for humans.

The baseline file (``analysis/lock_baseline.json``) records *accepted*
findings, each with a one-line justification. ``fnmatch`` patterns are
allowed in baseline anchors so a family of intentional findings (e.g.
every sqlite-store method doing I/O under the connection lock) is one
entry, not forty.

A copy of the reference package's ``analysis/findings.py``.
"""

from __future__ import annotations

import dataclasses
import fnmatch
import json
from typing import Dict, List, Optional, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation.

    rule:    short rule id, e.g. "LOCK-BLOCKING" or "SURFACE-UNHANDLED".
    anchor:  stable identifier of the site, e.g.
             "runtime/shard.py:ShardContext.renew_range:_lock:update_shard".
    message: human-readable description (may include file:line).
    """

    rule: str
    anchor: str
    message: str

    @property
    def key(self) -> Tuple[str, str]:
        return (self.rule, self.anchor)

    def format(self) -> str:
        return f"[{self.rule}] {self.anchor}\n    {self.message}"


@dataclasses.dataclass
class BaselineEntry:
    rule: str
    anchor: str  # may be an fnmatch pattern
    justification: str = ""

    def matches(self, finding: Finding) -> bool:
        return self.rule == finding.rule and fnmatch.fnmatchcase(
            finding.anchor, self.anchor
        )


class Baseline:
    """Accepted-findings file: new findings fail the gate, accepted ones
    don't. Entries that match nothing are reported as stale (warning,
    not failure — a fixed finding shouldn't break the build)."""

    def __init__(self, entries: Optional[Sequence[BaselineEntry]] = None):
        self.entries: List[BaselineEntry] = list(entries or [])

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as f:
            doc = json.load(f)
        return cls([
            BaselineEntry(
                rule=e["rule"],
                anchor=e["anchor"],
                justification=e.get("justification", ""),
            )
            for e in doc.get("findings", [])
        ])

    def save(self, path: str) -> None:
        doc = {
            "findings": [
                {
                    "rule": e.rule,
                    "anchor": e.anchor,
                    "justification": e.justification,
                }
                for e in self.entries
            ]
        }
        with open(path, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=False)
            f.write("\n")

    def split(
        self, findings: Sequence[Finding]
    ) -> Tuple[List[Finding], List[Finding], List[BaselineEntry]]:
        """(new, accepted, stale_entries)."""
        new: List[Finding] = []
        accepted: List[Finding] = []
        used: set = set()
        for f in findings:
            hit = None
            for i, e in enumerate(self.entries):
                if e.matches(f):
                    hit = i
                    break
            if hit is None:
                new.append(f)
            else:
                accepted.append(f)
                used.add(hit)
        stale = [e for i, e in enumerate(self.entries) if i not in used]
        return new, accepted, stale


def dedupe(findings: Sequence[Finding]) -> List[Finding]:
    """Drop exact (rule, anchor) duplicates, keeping first occurrence."""
    seen: Dict[Tuple[str, str], bool] = {}
    out: List[Finding] = []
    for f in findings:
        if f.key not in seen:
            seen[f.key] = True
            out.append(f)
    return out
