"""Test/deploy environment resolution.

Reference: environment/env.go — every integration harness resolves its
backend endpoints (Cassandra/MySQL/Kafka/ES seeds + ports) from env
vars with local defaults, so the same suite runs against a laptop, a
docker-compose network, or CI. This build's equivalents:

  CADENCE_TPU_STORE          "memory" | "sqlite"        (default memory)
  CADENCE_TPU_SQLITE_PATH    sqlite file                (default tmp)
  CADENCE_TPU_NUM_SHARDS     history shard count        (default 4)
  CADENCE_TPU_BIND_IP        service bind address       (default 127.0.0.1)

A copy of the reference package's ``testing/environment.py`` without its
JAX knobs (``CADENCE_TPU_JAX_PLATFORM``, ``CADENCE_TPU_MESH_DEVICES``)
and ``setup_env``, which pin JAX's platform and virtual CPU mesh before
JAX loads: this package runs on torch, whose entry points take a
``device`` argument instead.
"""

from __future__ import annotations

import os
import tempfile

LOCALHOST = "127.0.0.1"

STORE = "CADENCE_TPU_STORE"
SQLITE_PATH = "CADENCE_TPU_SQLITE_PATH"
NUM_SHARDS = "CADENCE_TPU_NUM_SHARDS"
BIND_IP = "CADENCE_TPU_BIND_IP"


def store() -> str:
    return os.environ.get(STORE, "memory")


def sqlite_path() -> str:
    path = os.environ.get(SQLITE_PATH, "")
    if path:
        return path
    return os.path.join(tempfile.gettempdir(), "cadence_tpu.db")


def num_shards() -> int:
    return int(os.environ.get(NUM_SHARDS, "4"))


def bind_ip() -> str:
    return os.environ.get(BIND_IP, LOCALHOST)


def create_bundle():
    """A persistence bundle per the env (env.go's backend selection)."""
    if store() == "sqlite":
        from ..runtime.persistence.sqlite import create_sqlite_bundle

        return create_sqlite_bundle(sqlite_path())
    from ..runtime.persistence.memory import create_memory_bundle

    return create_memory_bundle()
