"""StarCoder2-3B — dense LM, GQA kv=2, RoPE.

[arXiv:2402.19173; hf] 30L d_model=3072 24H (kv=2) d_ff=12288 vocab=49152.
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig, register

MODEL = TransformerConfig(
    name="starcoder2-3b", n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab_size=49152, qkv_bias=True, rope_theta=100_000.0,
    mlp_type="gelu", tie_embeddings=True)

SPEC = register(ArchSpec("starcoder2-3b", "lm", MODEL, LM_SHAPES,
                         source="arXiv:2402.19173"))
