"""The host samplers' CPU oracles, copies of the JAX package's
``oracle/``: :class:`AlgorithmLOracle` (uniform, with its C skip-jump scan),
:class:`BottomKOracle` (distinct, with its C scan) and the weighted
:class:`AExpJOracle` and :class:`NaiveWeightedOracle`.  Plain Python and
numpy; the semantic baseline of BASELINE.md config 1 and the statistical
ground truth of the engines."""

from .algorithm_l import AlgorithmLOracle
from .bottom_k import BottomKOracle
from .weighted import AExpJOracle, NaiveWeightedOracle

__all__ = ["AExpJOracle", "AlgorithmLOracle", "BottomKOracle", "NaiveWeightedOracle"]
