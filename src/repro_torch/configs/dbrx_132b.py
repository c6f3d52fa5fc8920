"""DBRX-132B — MoE: 16 experts top-4, GQA kv=8.

[hf:databricks/dbrx-base; unverified] 40L d_model=6144 48H d_ff_expert=10752
vocab=100352.
"""
from repro_torch.configs.base import (ArchSpec, LM_SHAPES, MoEConfig,
                                TransformerConfig, register)

MODEL = TransformerConfig(
    name="dbrx-132b", n_layers=40, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=10752, vocab_size=100352, rope_theta=500_000.0,
    moe=MoEConfig(n_experts=16, top_k=4, d_ff_expert=10752))

SPEC = register(ArchSpec("dbrx-132b", "lm", MODEL, LM_SHAPES,
                         source="hf:databricks/dbrx-base"))
