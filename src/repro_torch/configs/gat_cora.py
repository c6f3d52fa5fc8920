"""GAT (Cora) — 2-layer graph attention network. [arXiv:1710.10903; paper]"""
from repro_torch.configs.base import ArchSpec, GNN_SHAPES, GNNConfig, register

MODEL = GNNConfig(name="gat-cora", n_layers=2, d_hidden=8, n_heads=8,
                  aggregator="attn", d_in=1433, n_classes=7)

SPEC = register(ArchSpec("gat-cora", "gnn", MODEL, GNN_SHAPES,
                         source="arXiv:1710.10903"))
