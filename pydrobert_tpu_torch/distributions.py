"""Public distributions interface (counterpart of
:mod:`pydrobert_tpu.distributions`): the straight-through protocols, the
relaxed distributions, fixed-cardinality sampling and the sequential LM's
distribution over token sequences. Every sampling method takes a
:class:`torch.Generator`.
"""

from .ops.combinatorics import SimpleRandomSamplingWithoutReplacement  # noqa: F401
from .ops.decoding import (  # noqa: F401
    SequentialLanguageModelDistribution,
    TokenSequenceConstraint,
)
from .ops.straight_through import (  # noqa: F401
    ConditionalStraightThrough,
    Density,
    GumbelOneHotCategorical,
    LogisticBernoulli,
    StraightThrough,
)

__all__ = [
    "ConditionalStraightThrough",
    "Density",
    "GumbelOneHotCategorical",
    "LogisticBernoulli",
    "SequentialLanguageModelDistribution",
    "SimpleRandomSamplingWithoutReplacement",
    "StraightThrough",
    "TokenSequenceConstraint",
]
