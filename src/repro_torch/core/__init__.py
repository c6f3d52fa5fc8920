"""The paper's contribution: adaptive early-exit A-kNN for dense
retrieval, in PyTorch."""
from repro_torch.core.ivf import (IVFIndex, SearchResult, brute_force,
                                  build_index, extract_features,
                                  index_from_arrays, min_probes_labels,
                                  probe_trace, search, validate_alignment)
from repro_torch.core import metrics, policies
