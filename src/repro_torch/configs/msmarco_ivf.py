"""The paper's own system: IVF early-exit dense retrieval on an
MS-MARCO-scale corpus (8.8M x 768, 65536 clusters, STAR operating point
N=80, k=100, tau=10, patience Delta=7 Phi=95).
"""
from repro_torch.configs.base import (ArchSpec, IVF_SHAPES, RetrievalConfig,
                                register)

# paper-faithful defaults; the §Perf-optimised serving variant uses
# storage_dtype="bfloat16", probe_width=4 (see EXPERIMENTS.md §Perf)
MODEL = RetrievalConfig(name="msmarco-ivf", n_docs=8_800_000, dim=768,
                        n_clusters=65_536, n_probe=80, k=100, tau=10,
                        patience_delta=7, patience_phi=95.0, list_pad=256)

SPEC = register(ArchSpec("msmarco-ivf", "ivf", MODEL, IVF_SHAPES,
                         source="CIKM'24 Busolin et al."))
