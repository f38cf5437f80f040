"""Host utilities: hashing, clocks, metrics and tracing, logging, lock
constructors, retry and backoff, quotas, dynamic config and cron."""
