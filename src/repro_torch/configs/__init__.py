"""Model configs and the arch registry (copied from ``repro.configs``)."""
from repro_torch.configs.base import (ArchSpec, GNNConfig, LM_SHAPES,
                                      MLAConfig, MoEConfig, RECSYS_SHAPES,
                                      RecsysConfig, RetrievalConfig,
                                      ShapeSpec, TransformerConfig, get_arch,
                                      list_archs, reduced, register,
                                      shape_for)
