"""Distributed helpers over ``torch.distributed`` (port of
``repro.distributed``): collectives (``collectives``) and the
row-sharded embedding lookup (``embedding``).  ``sharding`` and
``context`` serve the MoE/MLA model code, which the port does not carry
yet."""
