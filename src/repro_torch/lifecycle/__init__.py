"""Declarative lifecycle builtins (port of `repro.lifecycle`), written on
the lineage-traced DSL so the compiler rewrites and the reuse cache
optimize across lifecycle tasks: the regression family, the §5
validation workloads on `parfor`, the cleaning builtins and the
algorithm library. The regression builtins are placement-neutral:
`lmDS_federated` / `steplm_federated` run them over a federated X."""
from .regression import (lm, lmCG, lmDS, lmDS_federated,  # noqa: F401
                         steplm, steplm_federated)
from .validation import (cross_validate_lm, grid_search_lm,  # noqa: F401
                         make_folds, parfor)
from .cleaning import (impute_by_mean, impute_by_median, mice_lite,  # noqa: F401
                       outlier_by_iqr, outlier_by_sd, scale_matrix,
                       winsorize)
from .algorithms import kmeans, l2svm, mlogreg, pca  # noqa: F401
