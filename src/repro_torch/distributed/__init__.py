"""Distributed helpers over ``torch.distributed`` (port of
``repro.distributed``): collectives (``collectives``), the row-sharded
embedding lookup (``embedding``) and the mesh context that model code
reads (``context``).  ``sharding`` (the partition rules of the HLO
tools' cells) is not ported."""
