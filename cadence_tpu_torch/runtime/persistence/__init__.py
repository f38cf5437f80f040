"""Persistence: the five-manager storage contract (shards, executions,
history, task lists, domain metadata) plus visibility, the memory
backend (``memory.create_memory_bundle``), the records and the JSON
codecs checkpoints use."""
