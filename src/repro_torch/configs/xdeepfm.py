"""xDeepFM — CIN interaction + deep MLP. [arXiv:1803.05170; paper]

n_sparse=39 embed_dim=10 cin=200-200-200 mlp=400-400.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, RecsysConfig, register

MODEL = RecsysConfig(name="xdeepfm", n_sparse=39, embed_dim=10,
                     rows_per_field=1_000_000, mlp=(400, 400),
                     interaction="cin", cin_layers=(200, 200, 200))

SPEC = register(ArchSpec("xdeepfm", "recsys", MODEL, RECSYS_SHAPES,
                         source="arXiv:1803.05170"))
