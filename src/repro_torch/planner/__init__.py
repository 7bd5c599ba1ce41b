"""Cost-based plan optimizer (DESIGN.md §16).

Pattern-matches validated operator DAGs (:mod:`repro_torch.core.dataflow`) at
registration time and rewrites the ones where a cheaper execution strategy
pays, recording provenance on the plan.  The flagship pass is the landmark
hub-cut (`landmark_rewrite`, paper §6.6): SPSP plans share one
differentially-maintained landmark-index subplan and answer through
triangle-bound-pruned scratch runs.
"""

from repro_torch.planner.cost import CostEstimate, CostModel
from repro_torch.planner.landmark_rewrite import LandmarkRule
from repro_torch.planner.rules import INDEX_OP, PLANNER_QID, Planner, RewriteRule

__all__ = [
    "CostEstimate",
    "CostModel",
    "INDEX_OP",
    "LandmarkRule",
    "PLANNER_QID",
    "Planner",
    "RewriteRule",
]
