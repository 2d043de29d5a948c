"""``pw.io.redpanda`` — Kafka-compatible API (reference
``python/pathway/io/redpanda``): delegates to ``pw.io.kafka``.

Counterpart of ``pathway_tpu/io/redpanda``: the same host code over the port's engine.
"""

from pathway_tpu_torch.io.kafka import read, write

__all__ = ["read", "write"]
