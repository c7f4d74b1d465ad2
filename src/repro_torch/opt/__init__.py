"""Global packing optimizer: the exact oracle and the batched annealer.

* ``branch_bound`` -- exact branch-and-bound with Martello-Toth L2 lower
  bounds (pure Python ground truth for small N);
* ``anneal`` / ``pareto`` -- batched simulated annealing over ``bins +
  lambda * Rscore`` with a per-chain lambda, whose lambda sweep traces
  cost-vs-R-score Pareto fronts; its move evaluation is the
  ``kernels.move_eval`` CUDA kernel on the card.

The registry exposes the annealer as the closed-loop policies ``ANNEAL`` /
``ANNEAL_STICKY``; ``api.optimize`` traces one instance's frontier.
"""
from .anneal import (
    AnnealNoise,
    AnnealResult,
    anneal_assign,
    anneal_chains,
    anneal_pack,
    assignment_cost,
    name_universe,
)
from .branch_bound import (
    BnBResult,
    branch_and_bound,
    brute_force,
    lower_bound_l1,
    lower_bound_l2,
)
from .pareto import (
    FrontierResult,
    anneal_frontier,
    dominated,
    heuristic_point,
    hypervolume_2d,
    incumbent_assignment,
    optimality_gap,
    pareto_front,
    reference_point,
)

__all__ = [
    "AnnealNoise",
    "AnnealResult",
    "BnBResult",
    "FrontierResult",
    "anneal_assign",
    "anneal_chains",
    "anneal_frontier",
    "anneal_pack",
    "assignment_cost",
    "branch_and_bound",
    "brute_force",
    "dominated",
    "heuristic_point",
    "hypervolume_2d",
    "incumbent_assignment",
    "lower_bound_l1",
    "lower_bound_l2",
    "name_universe",
    "optimality_gap",
    "pareto_front",
    "reference_point",
]
