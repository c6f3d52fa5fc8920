"""DeepFM — FM interaction + deep MLP over 39 sparse fields.

[arXiv:1703.04247; paper] embed_dim=10 mlp=400-400-400.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, RecsysConfig, register

MODEL = RecsysConfig(name="deepfm", n_sparse=39, embed_dim=10,
                     rows_per_field=1_000_000, mlp=(400, 400, 400),
                     interaction="fm")

SPEC = register(ArchSpec("deepfm", "recsys", MODEL, RECSYS_SHAPES,
                         source="arXiv:1703.04247"))
