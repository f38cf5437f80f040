"""Client SDK version gate.

Reference: service/frontend/versionChecker.go — requests carry
feature-version headers; clients older than the supported floor are
rejected with ClientVersionNotSupportedError.

A copy of the reference package's ``frontend/version_checker.py``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple


class ClientVersionNotSupportedError(Exception):
    def __init__(self, client: str, version: str, supported: str) -> None:
        super().__init__(
            f"client {client} version {version} < supported {supported}"
        )
        self.client = client
        self.version = version
        self.supported = supported


def _parse(version: str) -> Tuple[int, ...]:
    try:
        return tuple(int(p) for p in version.split("."))
    except ValueError:
        return ()


class ClientVersionChecker:
    DEFAULT_SUPPORTED = {
        "cadence-tpu-py": "0.1.0",
        "uber-go": "1.5.0",
        "uber-java": "1.5.0",
        "cli": "1.0.0",
    }

    def __init__(
        self, supported: Optional[Dict[str, str]] = None,
        enabled: bool = True,
    ) -> None:
        self.supported = dict(supported or self.DEFAULT_SUPPORTED)
        self.enabled = enabled

    def check(self, client_impl: str = "", feature_version: str = "") -> None:
        """No headers → no check (reference: missing headers pass)."""
        if not self.enabled or not client_impl or not feature_version:
            return
        floor = self.supported.get(client_impl)
        if floor is None:
            return  # unknown client impls pass
        got = _parse(feature_version)
        want = _parse(floor)
        if got and want and got < want:
            raise ClientVersionNotSupportedError(
                client_impl, feature_version, floor
            )
