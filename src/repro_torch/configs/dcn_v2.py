"""DCN-v2 — cross network v2 + deep MLP. [arXiv:2008.13535; paper]

n_dense=13 n_sparse=26 embed_dim=16 n_cross=3 mlp=1024-1024-512.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, RecsysConfig, register

MODEL = RecsysConfig(name="dcn-v2", n_dense=13, n_sparse=26, embed_dim=16,
                     rows_per_field=1_000_000, mlp=(1024, 1024, 512),
                     interaction="cross", n_cross_layers=3)

SPEC = register(ArchSpec("dcn-v2", "recsys", MODEL, RECSYS_SHAPES,
                         source="arXiv:2008.13535"))
