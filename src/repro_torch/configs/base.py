"""Config system: typed model configs, shape specs, and the arch registry.

A copy of ``repro.configs.base`` (dataclasses only), so the port needs
nothing of the JAX package.  Every assigned architecture registers an
:class:`ArchSpec` mapping ``--arch <id>`` to (model config, shape set,
family).  Shapes carry the *global* batch/sequence dims.  The port runs
the dense GQA transformers and the recsys models; MLA and MoE configs
are registered too and raise in ``models/transformer.py``.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

# ---------------------------------------------------------------------------
# Model configs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims."""

    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_head_dim: int = 64
    qk_rope_head_dim: int = 32
    v_head_dim: int = 64


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8                # routed experts
    top_k: int = 2
    n_shared: int = 0                 # always-on shared experts (DeepSeekMoE)
    d_ff_expert: int = 0              # per-expert hidden dim
    capacity_factor: float = 1.25
    first_k_dense: int = 0            # leading dense-FFN layers (DeepSeekMoE=1)
    d_ff_dense: int = 0               # hidden dim of those dense layers
    router_aux_weight: float = 0.01


@dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab_size: int
    d_head: int = 0                   # 0 -> d_model // n_heads
    qkv_bias: bool = False
    attn_type: str = "gqa"            # "gqa" | "mla"
    mla: Optional[MLAConfig] = None
    moe: Optional[MoEConfig] = None
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    mlp_type: str = "swiglu"          # "swiglu" | "gelu" (2-matrix)
    tie_embeddings: bool = False
    # serving knobs
    kv_cache_dtype: str = "bfloat16"  # "bfloat16" | "int8"
    attn_chunk: int = 512             # query-block size for chunked attention
    remat_policy: str = "nothing"     # "nothing" | "dots" (§Perf: trade
                                      # HBM for fewer recompute gathers)
    param_dtype: str = "float32"      # "bfloat16" halves FSDP gather
                                      # bytes (fp32 lives in the moments)
    # TP padding (see DESIGN §4): heads padded so n_heads % tp == 0
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    def param_count(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, L, V = self.d_model, self.n_layers, self.vocab_size
        hd = self.head_dim()
        if self.attn_type == "mla":
            m = self.mla or MLAConfig()
            qk = m.qk_nope_head_dim + m.qk_rope_head_dim
            attn = (d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                    + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                    + m.kv_lora_rank * self.n_heads * (m.qk_nope_head_dim + m.v_head_dim)
                    + self.n_heads * m.v_head_dim * d)
        else:
            attn = d * (self.n_heads * hd) + 2 * d * (self.n_kv_heads * hd) \
                + (self.n_heads * hd) * d
            if self.qkv_bias:
                attn += (self.n_heads + 2 * self.n_kv_heads) * hd
        nmat = 3 if self.mlp_type == "swiglu" else 2
        if self.moe is not None:
            mo = self.moe
            ff_layer = (mo.n_experts + mo.n_shared) * nmat * d * mo.d_ff_expert \
                + d * mo.n_experts
            dense_layer = nmat * d * (mo.d_ff_dense or self.d_ff)
            ffn = mo.first_k_dense * dense_layer + (L - mo.first_k_dense) * ff_layer
        else:
            ffn = L * nmat * d * self.d_ff
        blocks = L * (attn + 2 * d) + (ffn if self.moe is not None else ffn)
        emb = V * d * (1 if self.tie_embeddings else 2)
        return blocks + emb

    def active_param_count(self) -> int:
        """Params touched per token (MoE: routed top_k + shared only)."""
        if self.moe is None:
            return self.param_count()
        mo = self.moe
        full = self.param_count()
        all_experts = (self.n_layers - mo.first_k_dense) * \
            (mo.n_experts + mo.n_shared) * 3 * self.d_model * mo.d_ff_expert
        active = (self.n_layers - mo.first_k_dense) * \
            (mo.top_k + mo.n_shared) * 3 * self.d_model * mo.d_ff_expert
        return full - all_experts + active


@dataclass(frozen=True)
class GNNConfig:
    name: str
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    aggregator: str = "attn"          # "attn" | "mean" | "sum" | "max"
    d_in: int = 1433
    n_classes: int = 7
    dropout: float = 0.0


@dataclass(frozen=True)
class RecsysConfig:
    name: str
    n_dense: int = 0
    n_sparse: int = 26
    embed_dim: int = 16
    rows_per_field: int = 100_000     # synthetic vocab per sparse field
    mlp: Tuple[int, ...] = (400, 400, 400)
    interaction: str = "fm"           # "fm" | "cross" | "cin" | "dot"
    n_cross_layers: int = 0
    cin_layers: Tuple[int, ...] = ()
    tower_mlp: Tuple[int, ...] = ()   # two-tower
    n_candidates: int = 0             # retrieval-scoring candidate count


@dataclass(frozen=True)
class RetrievalConfig:
    """The paper's own system config (IVF early-exit dense retrieval)."""

    name: str
    n_docs: int = 8_800_000
    dim: int = 768
    n_clusters: int = 65_536
    n_probe: int = 80                 # N (A-kNN_95)
    k: int = 100
    tau: int = 10
    patience_delta: int = 7
    patience_phi: float = 95.0
    list_pad: int = 256               # padded scan tile (docs per probe step)
    storage_dtype: str = "float32"    # doc/centroid storage ("bfloat16"
                                      # halves the HBM-bound scan, §Perf)
    probe_width: int = 1              # clusters scanned per loop step
                                      # (amortises merges, §Perf iter 2)


# ---------------------------------------------------------------------------
# Shapes
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str                         # train|prefill|decode|long_decode|full_graph|
                                      # minibatch|batched_graphs|train_batch|serve|
                                      # retrieval|ivf_serve|ivf_build
    dims: Dict[str, int] = field(default_factory=dict)
    note: str = ""


LM_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", "train", {"seq_len": 4096, "global_batch": 256}),
    ShapeSpec("prefill_32k", "prefill", {"seq_len": 32768, "global_batch": 32}),
    ShapeSpec("decode_32k", "decode", {"seq_len": 32768, "global_batch": 128}),
    ShapeSpec("long_500k", "long_decode", {"seq_len": 524288, "global_batch": 1},
              note="bonus: full-attn decode is O(S)/step; seq-sharded KV (DESIGN §4)"),
)

GNN_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("full_graph_sm", "full_graph",
              {"n_nodes": 2708, "n_edges": 10556, "d_feat": 1433}),
    ShapeSpec("minibatch_lg", "minibatch",
              {"n_nodes": 232_965, "n_edges": 114_615_892, "batch_nodes": 1024,
               "fanout0": 15, "fanout1": 10, "d_feat": 602}),
    ShapeSpec("ogb_products", "full_graph",
              {"n_nodes": 2_449_029, "n_edges": 61_859_140, "d_feat": 100}),
    ShapeSpec("molecule", "batched_graphs",
              {"n_nodes": 30, "n_edges": 64, "batch": 128, "d_feat": 64}),
)

RECSYS_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_batch", "train_batch", {"batch": 65536}),
    ShapeSpec("serve_p99", "serve", {"batch": 512}),
    ShapeSpec("serve_bulk", "serve", {"batch": 262144}),
    ShapeSpec("retrieval_cand", "retrieval", {"batch": 1, "n_candidates": 1_000_000}),
)

IVF_SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("ivf_serve_1k", "ivf_serve", {"batch": 1024}),
    ShapeSpec("ivf_build", "ivf_build", {"sample": 1_048_576}),
)


# ---------------------------------------------------------------------------
# Registry
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ArchSpec:
    arch_id: str
    family: str                       # "lm" | "gnn" | "recsys" | "ivf"
    model: Any
    shapes: Tuple[ShapeSpec, ...]
    source: str = ""


_REGISTRY: Dict[str, ArchSpec] = {}


def register(spec: ArchSpec) -> ArchSpec:
    if spec.arch_id in _REGISTRY:
        raise ValueError(f"duplicate arch id {spec.arch_id}")
    _REGISTRY[spec.arch_id] = spec
    return spec


def get_arch(arch_id: str) -> ArchSpec:
    _ensure_loaded()
    if arch_id not in _REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(_REGISTRY)}")
    return _REGISTRY[arch_id]


def list_archs() -> List[str]:
    _ensure_loaded()
    return sorted(_REGISTRY)


def shape_for(spec: ArchSpec, shape_name: str) -> ShapeSpec:
    for s in spec.shapes:
        if s.name == shape_name:
            return s
    raise KeyError(f"{spec.arch_id} has no shape {shape_name!r}; "
                   f"known: {[s.name for s in spec.shapes]}")


def reduced(spec: ArchSpec) -> ArchSpec:
    """A tiny same-family config for CPU smoke tests (DESIGN §4)."""
    m = spec.model
    if spec.family == "lm":
        mo = m.moe
        if mo is not None:
            # capacity_factor 8: drop-free at smoke scale so
            # prefill/decode-vs-forward consistency checks are exact
            mo = dataclasses.replace(mo, n_experts=min(mo.n_experts, 8),
                                     d_ff_expert=64, d_ff_dense=128,
                                     top_k=min(mo.top_k, 2),
                                     capacity_factor=8.0)
        mla = MLAConfig(q_lora_rank=24, kv_lora_rank=16, qk_nope_head_dim=8,
                        qk_rope_head_dim=8, v_head_dim=8) if m.attn_type == "mla" else None
        small = dataclasses.replace(
            m, n_layers=2, d_model=64, n_heads=4,
            n_kv_heads=max(1, min(m.n_kv_heads, 4) if m.n_kv_heads < m.n_heads else 4),
            d_ff=128, vocab_size=512, d_head=16, moe=mo, mla=mla, attn_chunk=16)
        shapes = (ShapeSpec("smoke_train", "train", {"seq_len": 32, "global_batch": 4}),
                  ShapeSpec("smoke_decode", "decode", {"seq_len": 64, "global_batch": 2}))
        return ArchSpec(spec.arch_id + "-smoke", "lm", small, shapes)
    if spec.family == "gnn":
        small = dataclasses.replace(m, d_in=32, n_classes=5)
        shapes = (ShapeSpec("smoke_graph", "full_graph",
                            {"n_nodes": 64, "n_edges": 256, "d_feat": 32}),)
        return ArchSpec(spec.arch_id + "-smoke", "gnn", small, shapes)
    if spec.family == "recsys":
        small = dataclasses.replace(
            m, rows_per_field=128, embed_dim=8,
            mlp=tuple(min(x, 32) for x in m.mlp) or (32,),
            cin_layers=tuple(min(x, 16) for x in m.cin_layers),
            tower_mlp=tuple(min(x, 32) for x in m.tower_mlp),
            n_candidates=min(m.n_candidates, 256) if m.n_candidates else 0)
        shapes = (ShapeSpec("smoke_train", "train_batch", {"batch": 32}),
                  ShapeSpec("smoke_serve", "serve", {"batch": 8}))
        return ArchSpec(spec.arch_id + "-smoke", "recsys", small, shapes)
    if spec.family == "ivf":
        small = dataclasses.replace(m, n_docs=4096, dim=32, n_clusters=64,
                                    n_probe=16, k=10, tau=3, list_pad=64)
        shapes = (ShapeSpec("smoke_serve", "ivf_serve", {"batch": 8}),)
        return ArchSpec(spec.arch_id + "-smoke", "ivf", small, shapes)
    raise ValueError(spec.family)


_LOADED = False


def _ensure_loaded() -> None:
    global _LOADED
    if _LOADED:
        return
    _LOADED = True
    from repro_torch.configs import (  # noqa: F401
        minicpm3_4b, qwen1_5_32b, starcoder2_3b, deepseek_moe_16b, dbrx_132b,
        gat_cora, deepfm, dcn_v2, two_tower_retrieval, xdeepfm, msmarco_ivf)
