"""Versioned sqlite schema migrations + boot-time compat check.

Reference: tools/cassandra/handler.go (setup-schema / update-schema
over the versioned dirs in schema/cassandra/cadence/versioned/) and the
server's boot compat check (cmd/server/cadence.go:66 — refuse to start
against a store whose schema the binary doesn't understand).

A copy of the reference package's ``runtime/persistence/schema.py``: the
DDL text and the version numbers are the reference's, so one database
file serves both packages.
"""

from __future__ import annotations

import time
from typing import List, Tuple

_V1_BASE = """
CREATE TABLE IF NOT EXISTS shards (
  shard_id INTEGER PRIMARY KEY, range_id INTEGER NOT NULL, blob TEXT NOT NULL);
CREATE TABLE IF NOT EXISTS executions (
  shard_id INTEGER, domain_id TEXT, workflow_id TEXT, run_id TEXT,
  next_event_id INTEGER NOT NULL, last_write_version INTEGER NOT NULL,
  snapshot TEXT NOT NULL,
  PRIMARY KEY (shard_id, domain_id, workflow_id, run_id));
CREATE TABLE IF NOT EXISTS current_executions (
  shard_id INTEGER, domain_id TEXT, workflow_id TEXT,
  run_id TEXT NOT NULL, create_request_id TEXT, state INTEGER,
  close_status INTEGER, last_write_version INTEGER,
  PRIMARY KEY (shard_id, domain_id, workflow_id));
CREATE TABLE IF NOT EXISTS transfer_tasks (
  shard_id INTEGER, task_id INTEGER, blob TEXT NOT NULL,
  PRIMARY KEY (shard_id, task_id));
CREATE TABLE IF NOT EXISTS timer_tasks (
  shard_id INTEGER, visibility_ts INTEGER, task_id INTEGER, blob TEXT NOT NULL,
  PRIMARY KEY (shard_id, visibility_ts, task_id));
CREATE TABLE IF NOT EXISTS replication_tasks (
  shard_id INTEGER, task_id INTEGER, blob TEXT NOT NULL,
  PRIMARY KEY (shard_id, task_id));
CREATE TABLE IF NOT EXISTS history_nodes (
  tree_id TEXT, branch_id TEXT, node_id INTEGER, txn_id INTEGER, blob BLOB,
  PRIMARY KEY (tree_id, branch_id, node_id));
CREATE TABLE IF NOT EXISTS history_branches (
  tree_id TEXT, branch_id TEXT, token TEXT NOT NULL,
  PRIMARY KEY (tree_id, branch_id));
CREATE TABLE IF NOT EXISTS task_lists (
  domain_id TEXT, name TEXT, task_type INTEGER,
  range_id INTEGER NOT NULL, ack_level INTEGER NOT NULL, kind INTEGER,
  last_updated INTEGER,
  PRIMARY KEY (domain_id, name, task_type));
CREATE TABLE IF NOT EXISTS tasks (
  domain_id TEXT, name TEXT, task_type INTEGER, task_id INTEGER,
  blob TEXT NOT NULL,
  PRIMARY KEY (domain_id, name, task_type, task_id));
CREATE TABLE IF NOT EXISTS domains (
  id TEXT PRIMARY KEY, name TEXT UNIQUE NOT NULL, blob TEXT NOT NULL,
  notification_version INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS meta (k TEXT PRIMARY KEY, v INTEGER NOT NULL);
CREATE TABLE IF NOT EXISTS visibility (
  domain_id TEXT, workflow_id TEXT, run_id TEXT, is_open INTEGER,
  start_time INTEGER, close_time INTEGER, close_status INTEGER,
  workflow_type TEXT, blob TEXT NOT NULL,
  PRIMARY KEY (domain_id, workflow_id, run_id));
"""

_V2_QUERY_INDEXES = """
CREATE INDEX IF NOT EXISTS idx_visibility_open
  ON visibility (domain_id, is_open, start_time);
CREATE INDEX IF NOT EXISTS idx_visibility_close
  ON visibility (domain_id, close_time);
CREATE INDEX IF NOT EXISTS idx_timer_due
  ON timer_tasks (shard_id, visibility_ts);
CREATE INDEX IF NOT EXISTS idx_current_by_domain
  ON current_executions (shard_id, domain_id);
"""

_V3_REPLAY_CHECKPOINTS = """
CREATE TABLE IF NOT EXISTS replay_checkpoints (
  branch_key TEXT, event_id INTEGER, tree_id TEXT, fingerprint TEXT,
  created_at INTEGER, blob TEXT NOT NULL,
  PRIMARY KEY (branch_key, event_id));
CREATE INDEX IF NOT EXISTS idx_ckpt_tree
  ON replay_checkpoints (tree_id, event_id);
"""

_V4_RESHARD_STATE = """
CREATE TABLE IF NOT EXISTS reshard_state (
  id INTEGER PRIMARY KEY CHECK (id = 0),
  epoch INTEGER NOT NULL, blob TEXT NOT NULL);
"""

_V5_REPLICATION_PROGRESS = """
CREATE TABLE IF NOT EXISTS replication_progress (
  shard_id INTEGER, cluster TEXT,
  version INTEGER NOT NULL, blob TEXT NOT NULL,
  PRIMARY KEY (shard_id, cluster));
"""

# (version, name, script) — append-only, like the reference's
# schema/cassandra/cadence/versioned/ dirs
MIGRATIONS: List[Tuple[int, str, str]] = [
    (1, "base", _V1_BASE),
    (2, "query indexes", _V2_QUERY_INDEXES),
    (3, "replay checkpoints", _V3_REPLAY_CHECKPOINTS),
    (4, "reshard state", _V4_RESHARD_STATE),
    (5, "replication progress", _V5_REPLICATION_PROGRESS),
]

CURRENT_SCHEMA_VERSION = MIGRATIONS[-1][0]


class SchemaVersionError(RuntimeError):
    pass


def _ensure_version_table(conn) -> None:
    conn.execute(
        "CREATE TABLE IF NOT EXISTS schema_version "
        "(version INTEGER PRIMARY KEY, name TEXT NOT NULL, "
        "applied_at INTEGER NOT NULL)"
    )


def get_schema_version(conn) -> int:
    """0 = empty database; pre-versioning databases (tables but no
    version table) read as 1 (the baseline they were created from)."""
    has_version_table = conn.execute(
        "SELECT 1 FROM sqlite_master WHERE type='table' "
        "AND name='schema_version'"
    ).fetchone()
    if has_version_table:
        row = conn.execute(
            "SELECT MAX(version) FROM schema_version"
        ).fetchone()
        return int(row[0] or 0)
    has_base = conn.execute(
        "SELECT 1 FROM sqlite_master WHERE type='table' "
        "AND name='executions'"
    ).fetchone()
    return 1 if has_base else 0


def update_schema(conn) -> List[Tuple[int, str]]:
    """Apply every pending migration; returns [(version, name)]
    applied. Idempotent (ref tools/cassandra update-schema)."""
    # read BEFORE creating the version table: a pre-versioning database
    # (tables, no stamps) must read as its baseline, not as empty
    current = get_schema_version(conn)
    _ensure_version_table(conn)
    applied: List[Tuple[int, str]] = []
    for version, name, script in MIGRATIONS:
        if version <= current:
            # stamp pre-versioning baselines so the table is complete
            conn.execute(
                "INSERT OR IGNORE INTO schema_version VALUES (?,?,?)",
                (version, name, int(time.time())),
            )
            continue
        conn.executescript(script)
        conn.execute(
            "INSERT OR IGNORE INTO schema_version VALUES (?,?,?)",
            (version, name, int(time.time())),
        )
        applied.append((version, name))
    conn.commit()
    return applied


def setup_schema(conn) -> List[Tuple[int, str]]:
    return update_schema(conn)


def check_compat(conn) -> None:
    """Boot-time gate (ref cmd/server/cadence.go:66): refuse to run
    against a database the code doesn't match."""
    version = get_schema_version(conn)
    if version > CURRENT_SCHEMA_VERSION:
        raise SchemaVersionError(
            f"database schema v{version} is NEWER than this build "
            f"(v{CURRENT_SCHEMA_VERSION}); refusing to start"
        )
    if version < CURRENT_SCHEMA_VERSION:
        raise SchemaVersionError(
            f"database schema v{version} is behind this build "
            f"(v{CURRENT_SCHEMA_VERSION}); run "
            f"`cadence-tpu schema update` first"
        )
