"""The paper's packing core: variable-item-size bin packing with rebalance
cost (Rscore), the Modified Any Fit family, the monitor/controller control
plane, and the Sec. VI-B evaluation driver.

The package surface is the reference's (``repro.core``, 30 names).  As
there, package-level ``pack`` is the ``py`` packer ``binpack.pack``; the
batched packers on the card live in the submodule ``core.pack`` (the
counterpart of ``repro.core.jaxpack``), so import from it by its full
name (``from repro_torch.core.pack import ...``).  ``evaluate_stream_jax``
is that submodule's ``evaluate_stream``, under the reference's name.
"""
import importlib as _importlib

from .assignment import (
    ConsumerId,
    PackResult,
    PartitionId,
    capacity_lower_bound,
    group_view,
    rebalanced_partitions,
)
from .metrics import (
    StreamRun,
    average_rscores,
    cardinal_bin_score,
    evaluate_deltas,
    pareto_front,
    run_stream,
)
from .pack import SweepResult, sweep_streams
from .pack import evaluate_stream as evaluate_stream_jax
from .modified import MODIFIED, modified_any_fit
from .rscore import recovery_iterations, rscore, rscore_of_set
from .scenarios import (
    SCENARIO_FAMILIES,
    generate_scenario,
    scenario_suite,
    stack_suite,
)
from .streams import PAPER_DELTAS, generate_stream, paper_streams
# last: importing the submodule ``core.pack`` above set the package's
# ``pack`` to the submodule; the package-level name is the py packer
from .binpack import CLASSICAL, Bins, pack  # noqa: E402


def __getattr__(name: str):
    # deprecated name tables forward to the per-module shims (which warn
    # once and resolve through repro_torch.registry)
    if name == "ALL_ALGORITHMS":
        from . import modified as _modified
        return _modified.ALL_ALGORITHMS
    if name == "ALL_ALGORITHM_NAMES":
        return _importlib.import_module(".pack", __name__).ALL_ALGORITHM_NAMES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = [
    "ConsumerId",
    "PackResult",
    "PartitionId",
    "capacity_lower_bound",
    "group_view",
    "rebalanced_partitions",
    "CLASSICAL",
    "Bins",
    "pack",
    "StreamRun",
    "average_rscores",
    "cardinal_bin_score",
    "evaluate_deltas",
    "pareto_front",
    "run_stream",
    "MODIFIED",
    "modified_any_fit",
    "recovery_iterations",
    "rscore",
    "rscore_of_set",
    "PAPER_DELTAS",
    "generate_stream",
    "paper_streams",
    "SweepResult",
    "evaluate_stream_jax",
    "sweep_streams",
    "SCENARIO_FAMILIES",
    "generate_scenario",
    "scenario_suite",
    "stack_suite",
]
