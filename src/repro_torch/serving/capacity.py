"""Replica capacity from a dry run's roofline records (the paper's Fig.-10
calibration; a copy of ``repro.serving.capacity``'s reader).

The paper measures a consumer's max throughput empirically (~2.3 MB/s) and
feeds it to the packer as the bin size C.  On a serving fleet the
equivalent C is the decode throughput of one replica, which we derive
from the dry run's ``serve_step``: tokens/s = the batch a replica decodes
a step / dominant roofline term (+ amortized flush for block-buffered
decode).

``ControllerConfig(capacity=derived_replica_capacity(...)["tokens_per_s"])``
closes the loop: the packer sizes the fleet with a capacity that comes from
the same step the dry run walked.

The port's dry run (``repro_torch.launch.dryrun``) writes
``dryrun_results_torch.jsonl`` at the repo root (``DEFAULT_RESULTS``).  A
``mesh="1xH100"`` record is one H100 a replica and names the batch the
card takes (``batch_per_device``).  A ``"16x16"`` (``"2x16x16"``) record
is a replica of 256 (512) H100s that decodes the shape's global batch a
step across the mesh, its step the largest of its compute, memory and
collective (NVLink and InfiniBand) terms, as the reference's TPU records
of the same meshes are read.
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
DEFAULT_RESULTS = os.path.join(_REPO_ROOT, "dryrun_results_torch.jsonl")


def derived_replica_capacity(arch: str, shape: str = "decode_32k",
                             mesh: str = "16x16", rules: str = "baseline",
                             results_path: Optional[str] = None,
                             bytes_per_token: float = 4.0) -> Dict:
    path = os.path.abspath(results_path or DEFAULT_RESULTS)
    if not os.path.exists(path):
        raise FileNotFoundError(
            f"no dry-run results at {path}. The replica capacity is derived "
            f"from a dry run's roofline records: run `python -m "
            f"repro_torch.launch.dryrun --arch {arch} --shape {shape} "
            f"--rules {rules} --mesh "
            f"{'card' if mesh == '1xH100' else 'both'}`, pass "
            f"results_path= pointing at a file of "
            f"records for {arch}/{shape}/{mesh}/{rules}, or give the "
            f"controller a capacity directly (ControllerConfig(capacity="
            f"...), launch.serve --capacity).")
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
    mem = best.get("memory", {})
    if mem.get("fits_hbm") is False and "batch_per_device" in best:
        raise ValueError(
            f"{arch}/{shape}/{mesh}/{rules} does not fit "
            f"{'one card' if best.get('chips', 1) == 1 else 'its cards'}: "
            f"{mem.get('live_bytes_per_device')} live bytes a card at "
            f"batch {best['batch_per_device']}, over {mem.get('hbm_bytes')}")
    rl = best["roofline"]
    step_s = max(rl["t_compute_s"], rl["t_memory_s"], rl["t_collective_s"])
    fl = best.get("flush_amortized")
    if fl:
        step_s += fl["t_memory_s"] + fl["t_collective_s"]
    # a card's record names the batch it decodes a step; a mesh's (the
    # reference's and the port's) decodes global_batch tokens a step across
    # the whole mesh slice
    batch = (best.get("batch_per_device") if best.get("chips", 1) == 1
             else None)
    if batch is None:
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
