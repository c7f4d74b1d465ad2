"""Replica capacity from a dry run's roofline records (the paper's Fig.-10
calibration; a copy of ``repro.serving.capacity``'s reader).

The paper measures a consumer's max throughput empirically (~2.3 MB/s) and
feeds it to the packer as the bin size C.  On the TPU serving fleet the
equivalent C is the decode throughput of one replica (mesh slice), which we
derive from the dry-run's compiled ``serve_step``: tokens/s = global_batch /
dominant roofline term (+ amortized flush for block-buffered decode).

``ControllerConfig(capacity=derived_replica_capacity(...)["tokens_per_s"])``
closes the loop: the packer sizes the fleet with a capacity that comes from
the same compiled artifact the dry-run validated.

The port has no dry run of its own yet, so nothing here writes
``dryrun_results.jsonl``: pass ``results_path=`` to a file of records, or
give the controller a capacity directly.  A file of the reference's TPU
records gives a TPU replica's capacity, not the card's.
"""
from __future__ import annotations

import json
import os
from typing import Dict, Optional

# repo root, resolved robustly from this file (src/repro_torch/serving -> root)
# rather than left as a fragile relative join for open() to trip over
_REPO_ROOT = os.path.abspath(os.path.join(
    os.path.dirname(os.path.abspath(__file__)),
    os.pardir, os.pardir, os.pardir))
DEFAULT_RESULTS = os.path.join(_REPO_ROOT, "dryrun_results.jsonl")


def derived_replica_capacity(arch: str, shape: str = "decode_32k",
                             mesh: str = "16x16", rules: str = "baseline",
                             results_path: Optional[str] = None,
                             bytes_per_token: float = 4.0) -> Dict:
    path = os.path.abspath(results_path or DEFAULT_RESULTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no dry-run results at {path}. The replica capacity is derived "
            f"from a dry run's roofline records, and the port has no dry "
            f"run yet (nothing in it writes this file): pass results_path= "
            f"pointing at an existing dryrun_results.jsonl for "
            f"{arch}/{shape}/{mesh}/{rules}, or give the controller a "
            f"capacity directly (ControllerConfig(capacity=...), "
            f"launch.serve --capacity).")
    best = None
    with open(path) as f:
        for line in f:
            try:
                r = json.loads(line)
            except json.JSONDecodeError:
                continue
            if (r.get("arch") == arch and r.get("shape") == shape and
                    r.get("mesh") == mesh and
                    r.get("rules", "baseline") == rules and "roofline" in r):
                best = r
    if best is None:
        raise KeyError(f"no dry-run record for {arch}/{shape}/{mesh}/{rules}")
    rl = best["roofline"]
    step_s = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
    fl = best.get("flush_amortized")
    if fl:
        step_s += fl["t_memory_s"] + fl["t_collective_s"]
    # global_batch tokens are decoded per step across the whole mesh slice
    from repro_torch.launch.shapes import SHAPES
    batch = SHAPES[shape].global_batch
    tok_s = batch / step_s
    return {
        "arch": arch, "shape": shape, "mesh": mesh, "rules": rules,
        "step_seconds": step_s,
        "tokens_per_s": tok_s,
        "bytes_per_s": tok_s * bytes_per_token,
        "bottleneck": rl["bottleneck"],
    }
