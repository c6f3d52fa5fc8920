"""Resilience (port of ``repro.runtime``): the retry and straggler
policy (``straggler``), the seeded chaos harness (``chaos``), the
fault-tolerant trainer with its injected failure (``fault``) and the
elastic restore onto a mesh of another size (``elastic``)."""
