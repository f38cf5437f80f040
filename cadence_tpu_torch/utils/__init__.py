"""Stable string hashing."""
