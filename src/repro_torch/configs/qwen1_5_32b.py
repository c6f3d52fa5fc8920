"""Qwen1.5-32B — dense LM, MHA (kv=40) with QKV bias.

[hf:Qwen/Qwen1.5 family; hf] 64L d_model=5120 40H d_ff=27392 vocab=152064.
decode cells use int8 KV cache (DESIGN §4: 5.5TB bf16 cache at decode_32k).
"""
from repro_torch.configs.base import ArchSpec, LM_SHAPES, TransformerConfig, register

MODEL = TransformerConfig(
    name="qwen1.5-32b", n_layers=64, d_model=5120, n_heads=40, n_kv_heads=40,
    d_ff=27392, vocab_size=152064, qkv_bias=True, rope_theta=1_000_000.0,
    kv_cache_dtype="int8")

SPEC = register(ArchSpec("qwen1.5-32b", "lm", MODEL, LM_SHAPES,
                         source="hf:Qwen/Qwen1.5-32B"))
