"""Operator tooling (reference: tools/cli, tools/cassandra, tools/sql);
a copy of the reference package's ``tools/``."""
