"""Runtime services: the history host (service, shard controller, history
engine, transfer and timer queues, domains, membership), the persistence
stores and the state rebuilder."""
