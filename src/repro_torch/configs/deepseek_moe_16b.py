"""DeepSeekMoE-16B — fine-grained MoE: 2 shared + 64 routed top-6.

[arXiv:2401.06066; hf] 28L d_model=2048 16H d_ff_expert=1408 vocab=102400.
First layer dense FFN (d_ff=10944), paper-faithful.
"""
from repro_torch.configs.base import (ArchSpec, LM_SHAPES, MoEConfig,
                                TransformerConfig, register)

MODEL = TransformerConfig(
    name="deepseek-moe-16b", n_layers=28, d_model=2048, n_heads=16,
    n_kv_heads=16, d_ff=10944, vocab_size=102400,
    moe=MoEConfig(n_experts=64, top_k=6, n_shared=2, d_ff_expert=1408,
                  first_k_dense=1, d_ff_dense=10944))

SPEC = register(ArchSpec("deepseek-moe-16b", "lm", MODEL, LM_SHAPES,
                         source="arXiv:2401.06066"))
