"""Training driver: data pipeline -> train step -> checkpoints.

The reference's ``launch/train.py`` on the port: ``TokenPipeline``
batches (numpy, moved to the device by the step), ``make_train_step``
(forward, one backward through the flash or WKV kernels, AdamW), and a
``CheckpointManager`` that keeps the parameters, the optimizer state and
the pipeline's cursor (in the manifest's ``extra``).  Restart-safe: a run
resumes from the latest checkpoint in ``ckpt_dir``, and ``die_at_step``
stops a run there to stand for a preemption.

Usage (``--device`` defaults to the CUDA card; ``--arch`` takes every
token-fed arch, the MoE and hybrid families included):

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b \\
      --smoke --device cpu --steps 50 --batch 4 --seq 64 --ckpt /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train \\
      --arch qwen2-moe-a2.7b --smoke --device cpu --steps 3
"""
from __future__ import annotations

import argparse
import time
from typing import Optional

from repro_torch import configs
from repro_torch._device import resolve_device
from repro_torch.checkpoint import CheckpointManager, load_manifest
from repro_torch.data import TokenPipeline
from repro_torch.launch.steps import make_train_step
from repro_torch.models import init_params
from repro_torch.optim.adamw import AdamWConfig, adamw_init


def train(cfg, *, steps: int, batch: int, seq: int, ckpt_dir: Optional[str],
          save_every: int = 20, lr: float = 3e-4, log_every: int = 10,
          die_at_step: Optional[int] = None, seed: int = 0, device=None):
    """Train ``cfg`` from ``init_params(cfg, seed)`` (or the latest
    checkpoint in ``ckpt_dir``) to ``steps`` steps on ``device`` (``None``
    = the CUDA card).  Returns ``{"final_step", "losses", "params"}``, or
    ``{"died_at", "losses"}`` when stopped at ``die_at_step``."""
    dev = resolve_device(device)
    opt_cfg = AdamWConfig(lr=lr, warmup_steps=min(20, steps // 5 or 1),
                          total_steps=steps)
    # the parameters and state are donated, as the reference driver's
    # jax.jit(..., donate_argnums=(0, 1)) does: updated in place
    step_fn = make_train_step(cfg, opt_cfg, dev, donate=True)
    pipeline = TokenPipeline(batch, seq, cfg.vocab_size, seed=seed)
    params = init_params(cfg, seed=seed, device=dev)
    opt_state = adamw_init(params)
    start_step = 0

    mgr = (CheckpointManager(ckpt_dir, keep=2, async_save=False)
           if ckpt_dir else None)
    if mgr is not None:
        found, tree = mgr.restore_latest({"params": params, "opt": opt_state})
        if found is not None:
            start_step = found
            params, opt_state = tree["params"], tree["opt"]
            extra = load_manifest(mgr.directory, found).get("extra", {})
            if "pipeline" in extra:
                pipeline.load_state(extra["pipeline"])
            print(f"[train] resumed from step {start_step}")

    losses = []
    t0 = time.time()
    for step in range(start_step, steps):
        params, opt_state, metrics = step_fn(params, opt_state,
                                             pipeline.next_batch())
        losses.append(float(metrics["loss"]))
        if (step + 1) % log_every == 0:
            dt = (time.time() - t0) / log_every
            print(f"[train] step {step + 1}/{steps} loss={losses[-1]:.4f} "
                  f"lr={float(metrics['lr']):.2e} "
                  f"gnorm={float(metrics['grad_norm']):.3f} {dt:.2f}s/step",
                  flush=True)
            t0 = time.time()
        if mgr is not None and (step + 1) % save_every == 0:
            mgr.save(step + 1, {"params": params, "opt": opt_state},
                     extra={"pipeline": pipeline.state()})
        if die_at_step is not None and step + 1 == die_at_step:
            print(f"[train] simulating preemption at step {step + 1}")
            return {"died_at": step + 1, "losses": losses}
    if mgr is not None:
        mgr.save(steps, {"params": params, "opt": opt_state},
                 extra={"pipeline": pipeline.state()})
        mgr.wait()
    return {"final_step": steps, "losses": losses, "params": params}


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="olmo-1b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config (CPU-sized)")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--save-every", type=int, default=20)
    ap.add_argument("--die-at-step", type=int, default=None)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    args = ap.parse_args(argv)
    cfg = configs.get(args.arch, smoke=args.smoke)
    out = train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                ckpt_dir=args.ckpt, lr=args.lr, save_every=args.save_every,
                die_at_step=args.die_at_step, device=args.device)
    print(f"[train] done: {out.get('final_step', out.get('died_at'))} steps, "
          f"loss {out['losses'][0]:.3f} -> {out['losses'][-1]:.3f}")


if __name__ == "__main__":
    main()
