"""Replication-side services: the state rebuilder."""
