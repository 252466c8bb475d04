"""Declarative lifecycle builtins (port of `repro.lifecycle`), written on
the lineage-traced DSL so the compiler rewrites and the reuse cache
optimize across lifecycle tasks. Ported so far: the regression family."""
from .regression import lm, lmCG, lmDS, steplm  # noqa: F401
