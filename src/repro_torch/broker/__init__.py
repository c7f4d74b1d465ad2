"""Minimal message-broker substrate with the Kafka semantics the paper's
system relies on (Sec. V):

* ordered, append-only partitions; messages delivered in production order;
* per-(group, partition) committed offsets with seek/commit;
* at most one consumer of a group reading a partition at a time (enforced);
* ``describe_log_dirs()`` -- byte size per TopicPartition (the AdminClient
  call the monitor uses);
* a simulated clock so the 30 s monitor window and consumer wait times run
  deterministically and fast in tests.

This is an in-process stand-in for the data plane; the control plane built
on top of it (monitor/controller/consumers) is the paper's actual system.
A copy of ``repro.broker``; it runs on the host and touches no device.
"""
from .clock import Clock, SimClock, WallClock
from .sim import Broker, ConsumerHandle, Partition, Topic, TopicPartition

__all__ = [
    "Clock",
    "SimClock",
    "WallClock",
    "Broker",
    "ConsumerHandle",
    "Partition",
    "Topic",
    "TopicPartition",
]
