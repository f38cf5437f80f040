"""Cross-cluster messaging plane.

Reference: common/messaging/ (kafkaClient.go / kafkaConsumer.go /
kafkaProducer.go) — topic pub/sub with consumer groups, per-message
ack/nack, bounded redelivery, and a dead-letter topic. The TPU build
replaces the Kafka cluster with an in-process broker (the host plane is
gRPC/in-proc; cross-"cluster" traffic in tests rides the same broker the
way host/xdc wires two oneboxes to one Kafka).

A copy of the reference package's ``messaging/__init__.py``.
"""

from .bus import Message, MessageBus, Consumer, Producer

__all__ = ["Message", "MessageBus", "Consumer", "Producer"]
