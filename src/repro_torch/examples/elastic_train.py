"""Elastic training with preemption recovery, on the port.

Trains a small LM end to end (data pipeline -> forward, backward through
the flash kernels, AdamW -> checkpoints), stops the run half-way as a
preemption would, restarts from the checkpoint (the data pipeline's
cursor included), and checks that the loss fell across the restart.  The
default config is a ~2M-parameter model (a few hundred steps in a minute
or two on a CPU); ``--full`` takes the ~100M-parameter one, the same code
path.  The configs are the reference example's (``examples/
elastic_train.py``).

  PYTHONPATH=src python -m repro_torch.examples.elastic_train [--device cpu]
"""
from __future__ import annotations

import argparse
import shutil
import tempfile

from repro_torch.launch.train import train
from repro_torch.models import ArchConfig

TINY = ArchConfig(
    name="elastic-demo-2m", family="dense",
    n_layers=4, d_model=128, n_heads=4, n_kv_heads=2,
    d_ff=384, vocab_size=2048, remat=False,
    dtype="float32", param_dtype="float32",
)

FULL_100M = ArchConfig(
    name="elastic-demo-100m", family="dense",
    n_layers=12, d_model=640, n_heads=10, n_kv_heads=5,
    d_ff=2560, vocab_size=32000,
)


def main(argv=None):
    """Run the demo; returns ``(first loss, last loss)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true", help="~100M-param config")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = FULL_100M if args.full else TINY
    batch, seq = (8, 256) if args.full else (8, 64)

    ckpt = tempfile.mkdtemp(prefix="elastic_train_")
    try:
        print(f"=== phase 1: train {cfg.name}, preempted at step "
              f"{args.steps // 2} ===")
        out1 = train(cfg, steps=args.steps, batch=batch, seq=seq,
                     ckpt_dir=ckpt, save_every=args.steps // 4,
                     die_at_step=args.steps // 2, device=args.device)
        print(f"=== phase 2: restart from checkpoint, finish to "
              f"{args.steps} ===")
        out2 = train(cfg, steps=args.steps, batch=batch, seq=seq,
                     ckpt_dir=ckpt, save_every=args.steps // 4,
                     device=args.device)
        l0 = out1["losses"][0]
        l1 = out2["losses"][-1]
        print(f"\nloss {l0:.3f} -> {l1:.3f} across the preemption boundary")
        assert l1 < l0, "loss did not improve across restart"
        print("elastic restart OK")
        return l0, l1
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
