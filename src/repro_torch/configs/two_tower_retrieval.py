"""Two-tower retrieval — sampled-softmax retrieval; the paper's technique
serves the 1M-candidate `retrieval_cand` cell via IVF early-exit.

[RecSys'19 (YouTube); unverified] embed_dim=256 tower 1024-512-256 dot.
"""
from repro_torch.configs.base import ArchSpec, RECSYS_SHAPES, RecsysConfig, register

MODEL = RecsysConfig(name="two-tower-retrieval", n_sparse=16, embed_dim=256,
                     rows_per_field=1_000_000, mlp=(),
                     tower_mlp=(1024, 512, 256), interaction="dot",
                     n_candidates=1_000_000)

SPEC = register(ArchSpec("two-tower-retrieval", "recsys", MODEL, RECSYS_SHAPES,
                         source="RecSys'19 YouTube"))
