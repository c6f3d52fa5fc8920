"""Serving-side resilience (port of ``repro.runtime``): the retry and
straggler policy (``straggler``), the injected failure (``fault``) and
the seeded chaos harness (``chaos``).  ``FaultTolerantTrainer`` and the
elastic re-shard need the training path, which the port does not carry
yet."""
