"""paper-hpo — scale knobs for the paper's own experiments (§5).

Not a transformer: describes the HPO/CV regression workloads
(benchmarks/hpo_*.py, cv_reuse.py). The paper uses 100K×1K dense
(800 MB) / sparsity-0.1 inputs; this container scales rows down so a
full Fig. 5 sweep finishes in minutes while keeping the 100:1 row:col
aspect and the GFLOP-per-model accounting.
"""
from dataclasses import dataclass


@dataclass(frozen=True)
class PaperWorkload:
    rows: int = 100_000
    cols: int = 1_000
    rows_cpu: int = 20_000      # scaled-down default for this container
    cols_cpu: int = 1_000
    sparsity: float = 0.1
    k_models: tuple = (1, 10, 20, 30, 40, 50, 60, 70)
    k_models_cpu: tuple = (1, 10, 20, 40, 70)
    n_folds: int = 8


CONFIG = PaperWorkload()
