"""Persistence: the history store (``HistoryManager``) and its memory
backend, the branch-token records and the JSON codecs checkpoints use."""
