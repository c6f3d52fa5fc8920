"""MiniCPM3-4B — dense LM with Multi-head Latent Attention.

[hf:openbmb/MiniCPM3-4B; hf] 62L d_model=2560 40H (kv=40 via MLA latent)
d_ff=6400 vocab=73448.
"""
from repro_torch.configs.base import (ArchSpec, LM_SHAPES, MLAConfig,
                                TransformerConfig, register)

MODEL = TransformerConfig(
    name="minicpm3-4b", n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
    d_ff=6400, vocab_size=73448, attn_type="mla",
    mla=MLAConfig(q_lora_rank=768, kv_lora_rank=256, qk_nope_head_dim=64,
                  qk_rope_head_dim=32, v_head_dim=64),
    d_head=96, rope_theta=10000.0, tie_embeddings=True)

SPEC = register(ArchSpec("minicpm3-4b", "lm", MODEL, LM_SHAPES,
                         source="hf:openbmb/MiniCPM3-4B"))
