"""Workload history generators."""
