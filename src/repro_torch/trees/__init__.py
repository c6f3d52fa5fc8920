"""Tree ensembles of the learned exit stages: the NumPy GBDT and SMOTE
(copies of ``repro.trees``) and their inference in PyTorch."""
from repro_torch.trees.gbdt import GBDT, Forest, Tree
from repro_torch.trees.smote import smote
from repro_torch.trees.torch_infer import (TreeEnsemble, ensemble_from_arrays,
                                           from_numpy_forest, predict_margin,
                                           predict_proba)
