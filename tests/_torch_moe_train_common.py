"""Shared helpers of the MoE and hybrid Mamba training tests
(``tests/test_torch_moe_train*.py``): the SMOKE configs of both packages,
the reference's weights carried across, batches, the reference run
jitted in float32 and eager in bfloat16, and the loss and every gradient
of each package.  Imported by those test files after their
``pytest.importorskip("torch")``."""
import contextlib
import dataclasses
import functools
import io
import sys
from pathlib import Path

import numpy as np
import torch

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.launch import train as jtrain
from repro.launch.steps import make_train_step as j_train_step
from repro.models import forward as j_forward
from repro.models import init_params as j_init_params
from repro.models import mamba as jmamba
from repro.models import moe as jmoe
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import adamw_init as j_adamw_init
from repro_torch import _tree, configs as tconfigs
from repro_torch.convert import params_from_numpy
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as ttrain
from repro_torch.launch.steps import make_train_step
from repro_torch.models import forward
from repro_torch.models import mamba as tmamba
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer
from repro_torch.optim import AdamWConfig, adamw_init

#: the AdamW settings of the train steps (and the chip helpers' step)
OPT = dict(lr=1e-3, warmup_steps=2, total_steps=6)

#: the routed families: two MoE archs and the hybrid Mamba one
ARCHS = ("qwen2-moe-a2.7b", "llama4-scout-17b-a16e", "jamba-v0.1-52b")
MOE = "qwen2-moe-a2.7b"
HYBRID = "jamba-v0.1-52b"


def configs(arch, dtype="float32", **over):
    over = dict(dtype=dtype, param_dtype="float32", **over)
    return tuple(dataclasses.replace(m.get(arch, smoke=True), **over)
                 for m in (jconfigs, tconfigs))


@functools.lru_cache(maxsize=None)
def models(arch, dtype="float32", remat=False):
    """(reference cfg, port cfg, reference params, port params)."""
    jcfg, tcfg = configs(arch, dtype, remat=remat)
    jp = j_init_params(jax.random.key(0), jcfg)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, device="cpu")
    return jcfg, tcfg, jp, tp


def batch_of(cfg, seed, b=2, s=16):
    return TokenPipeline(b, s, cfg.vocab_size, seed=seed).next_batch()


def reference(fn, dtype):
    """The reference's ``fn``: jitted in float32, eager in bfloat16."""
    if dtype == "float32":
        return jax.jit(fn)

    def eager(*args):
        with jax.disable_jit():
            return fn(*args)
    return eager


def as_port(jtree, tcfg):
    """A reference tree (parameters, gradients, moments) as the port's
    flat ``{name: tensor}``."""
    return dict(_tree.items(params_from_numpy(
        jax.tree.map(np.asarray, jtree), tcfg, device="cpu")))


def grad_close(got, want, tol, what):
    """Within ``tol`` absolute, and within ``tol`` (float32: 1e-4) of the
    leaf's largest magnitude."""
    got, want = got.float().numpy(), np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= max(tol, 1e-4 * scale if tol < 1e-4 else tol * scale), \
        f"{what}: max abs err {err} (largest {scale})"


def port_loss_and_grads(tp, tcfg, batch):
    leaves = {k: p.clone().requires_grad_(True)
              for k, p in _tree.items(tp)}
    loss, metrics = forward(_tree.unflatten(tp, leaves), tcfg,
                            {k: torch.tensor(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    return loss.detach(), metrics, dict(zip(leaves, grads))


@functools.lru_cache(maxsize=None)
def reference_loss_and_grads(arch, dtype, remat, seed):
    jcfg, tcfg, jp, _ = models(arch, dtype, remat)
    batch = batch_of(tcfg, seed)
    (loss, m), g = reference(jax.value_and_grad(
        lambda p, bt: j_forward(p, jcfg, bt), has_aux=True), dtype)(
            jp, {k: jnp.asarray(v) for k, v in batch.items()})
    return float(loss), float(m["ce"]), float(m["aux"]), as_port(g, tcfg)

