"""Versioned JSON build artifacts for the analysis gate.

One writer for every machine-readable artifact the gate emits
(``--emit-matrix``, ``--emit-conflict-matrix``): a ``schema_version``
plus an ``artifact`` kind ride at the top of the document so downstream
consumers — the future parallel-queue executor, bench tooling — can
validate what they load instead of guessing from the file name.
``load_artifact`` is that validation, shared so the checks can't drift
per consumer.

A copy of the reference package's ``analysis/artifact.py``. The port
writes its conflict matrix at a path of its own
(``runtime/queues/parallel.PORT_MATRIX_PATH``), never over the reference
package's artifact.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Optional

SCHEMA_VERSION = 1


def write_artifact(path: str, kind: str, payload: Dict) -> None:
    """Write ``payload`` wrapped with the artifact envelope. The
    envelope keys win on collision — a payload must not be able to
    spoof its own schema version."""
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    doc = dict(payload)
    doc["schema_version"] = SCHEMA_VERSION
    doc["artifact"] = kind
    with open(path, "w") as f:
        json.dump(doc, f, indent=2)
        f.write("\n")


def load_artifact(path: str, kind: Optional[str] = None) -> Dict:
    """Load + validate an artifact: the schema version must be one this
    code understands and (when given) the kind must match — a consumer
    handed the wrong file fails loudly instead of misreading it."""
    with open(path) as f:
        doc = json.load(f)
    version = doc.get("schema_version")
    if version != SCHEMA_VERSION:
        raise ValueError(
            f"{path}: artifact schema_version {version!r} "
            f"(this build understands {SCHEMA_VERSION})"
        )
    if kind is not None and doc.get("artifact") != kind:
        raise ValueError(
            f"{path}: artifact kind {doc.get('artifact')!r}, "
            f"expected {kind!r}"
        )
    return doc
