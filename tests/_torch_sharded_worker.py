"""The 4-rank half of ``tests/test_torch_sharded_steps.py``: each rank of
a gloo process group runs the port's steps sharded (DTensors under the
rules) and unsharded on the same SMOKE weights, and writes what it found
to ``<out>/rank<r>.json`` for the test to hold.  Imports no JAX.

Cases (float32, the kernels' plain versions on the CPU):

* ``dense``: a GQA model whose 3 KV heads do not divide the 2-way model
  axis (6 q heads) on a (2, 2) mesh under ``train_rules()``: the loss and
  the parameters after one AdamW step; and the loss under ``no_sp``,
  where the logits split along the vocabulary;
* ``moe_ep``: qwen2-moe SMOKE (6 experts, padded to 8) on a (1, 4) mesh
  under ``train_rules(False, "ep")``: the loss and every layer's expert
  choices;
* ``decode``: the dense model's decode steps on a (2, 2) mesh under
  ``serve_rules()``, the cache sharded along its sequence (3 KV heads
  fall back), across the shards' boundary; and the same with a 4-row tail
  and its flushes;
* ``ef_int8``: ``ef_int8_psum`` over the group against the stacked form.
"""
from __future__ import annotations

import dataclasses
import json
import sys
from pathlib import Path

import torch
import torch.distributed as dist

WORLD = 4


def _mesh(shape):
    from torch.distributed.device_mesh import DeviceMesh

    return DeviceMesh("cpu", torch.arange(WORLD).reshape(shape),
                      mesh_dim_names=("data", "model"))


def _full(tree):
    from repro_torch._tree import tree_map

    return tree_map(lambda t: t.full_tensor() if hasattr(t, "full_tensor")
                    else t, tree)


def _max_diff(a, b) -> float:
    from repro_torch._tree import leaves

    return max(float((x.float() - y.float()).abs().max())
               for x, y in zip(leaves(a), leaves(b)))


def dense_cfg():
    from repro_torch import configs

    return dataclasses.replace(configs.get("qwen3-8b", smoke=True),
                               n_heads=6, n_kv_heads=3, d_model=96,
                               dtype="float32", param_dtype="float32",
                               remat=True)


def _tokens(b, s, seed, vocab):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, vocab, (b, s), generator=g)


def _sharded(mesh, rules):
    import contextlib

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.models.sharding import axis_rules

    stack = contextlib.ExitStack()
    stack.enter_context(axis_rules(mesh, rules))
    stack.enter_context(implicit_replication())
    return stack


def case_dense():
    from repro_torch.launch.rules import train_rules
    from repro_torch.launch.shapes import batch_logical_specs, SHAPES
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import forward, init_params, param_specs
    from repro_torch.models.sharding import distribute_tree
    from repro_torch.optim.adamw import (AdamWConfig, adamw_init,
                                         opt_state_specs)

    cfg = dense_cfg()
    opt = AdamWConfig(lr=1e-2, warmup_steps=1, eps=1e-3)
    batch = {"inputs": _tokens(4, 16, 1, cfg.vocab_size),
             "labels": _tokens(4, 16, 2, cfg.vocab_size)}
    params = init_params(cfg, 0, device="cpu")
    step = make_train_step(cfg, opt, "cpu")
    p1, _, m1 = step(params, adamw_init(params), batch)

    mesh, rules = _mesh((2, 2)), train_rules()
    specs = param_specs(cfg)
    with _sharded(mesh, rules):
        dp = distribute_tree(init_params(cfg, 0, device="cpu"), specs, mesh,
                             rules)
        ds = distribute_tree(adamw_init(params), opt_state_specs(specs),
                             mesh, rules)
        db = distribute_tree(batch, batch_logical_specs(cfg,
                                                        SHAPES["train_4k"]),
                             mesh, rules)
        p2, _, m2 = step(dp, ds, db)
        loss2 = float(m2["loss"].full_tensor())
        p2 = _full(p2)
    # no_sp: the residual whole along the sequence, so the logits split
    # along the vocabulary (the vocabulary-parallel loss)
    rules = train_rules(False, "no_sp")
    with _sharded(mesh, rules):
        dp = distribute_tree(init_params(cfg, 0, device="cpu"), specs, mesh,
                             rules)
        db = distribute_tree(batch, batch_logical_specs(cfg,
                                                        SHAPES["train_4k"]),
                             mesh, rules)
        loss3, _ = forward(dp, cfg, db)
        loss3 = float(loss3.full_tensor())
    loss1 = float(m1["loss"])
    return {"dense_loss": [loss1, loss2], "dense_no_sp_loss": loss3,
            "dense_param_diff": _max_diff(p1, p2)}


def case_moe_ep():
    from repro_torch import configs
    from repro_torch.launch.rules import train_rules
    from repro_torch.models import forward, init_params, param_specs
    from repro_torch.models import moe
    from repro_torch.models.sharding import distribute_tree

    cfg = dataclasses.replace(configs.get("qwen2-moe-a2.7b", smoke=True),
                              dtype="float32", param_dtype="float32")
    batch = {"inputs": _tokens(2, 16, 3, cfg.vocab_size),
             "labels": _tokens(2, 16, 4, cfg.vocab_size)}
    seen = []
    route = moe.route

    def spy(p, cfg_, x):
        out = route(p, cfg_, x)
        seen.append(out[2].clone())
        return out

    moe.route = spy
    try:
        params = init_params(cfg, 0, device="cpu")
        with torch.no_grad():
            loss1 = float(forward(params, cfg, batch)[0])
        choices1, seen[:] = list(seen), []
        mesh, rules = _mesh((1, 4)), train_rules(False, "ep")
        with _sharded(mesh, rules), torch.no_grad():
            from repro_torch.models.sharding import rule_axis_size

            pad = rule_axis_size("p_experts")
            dp = distribute_tree(params, param_specs(cfg), mesh, rules)
            db = distribute_tree(batch, {"inputs": ("batch", "seq_sp"),
                                         "labels": ("batch", "seq_sp")},
                                 mesh, rules)
            loss2 = float(forward(dp, cfg, db)[0].full_tensor())
        choices2 = list(seen)
    finally:
        moe.route = route
    same = (len(choices1) == len(choices2) and all(
        torch.equal(a, b) for a, b in zip(choices1, choices2)))
    return {"moe_loss": [loss1, loss2], "moe_choices_equal": same,
            "moe_layers_routed": len(choices2), "moe_ep_axis": pad,
            "moe_experts": cfg.n_experts}


def _decode_run(cfg, mesh, rules, steps: int, max_len: int):
    from repro_torch.launch.steps import make_serve_step
    from repro_torch.models import (decode_state_specs, flush_kv_tail,
                                    init_decode_state, init_params,
                                    param_specs)
    from repro_torch.models.sharding import distribute_tree

    params = init_params(cfg, 0, device="cpu")
    state = init_decode_state(cfg, 4, max_len, "cpu")
    toks = _tokens(4, steps, 5, cfg.vocab_size)
    step = make_serve_step(cfg, "cpu")
    ctx = _sharded(mesh, rules) if mesh is not None else None
    out = []
    with (ctx if ctx is not None else torch.no_grad()):
        if mesh is not None:
            params = distribute_tree(params, param_specs(cfg), mesh, rules)
            state = distribute_tree(state, decode_state_specs(cfg), mesh,
                                    rules)
            tok_spec = ("batch",)
        for t in range(steps):
            w = cfg.decode_tail_window
            if w and t and t % w == 0:
                flush_kv_tail(cfg, state)
            batch = {"inputs": toks[:, t]}
            if mesh is not None:
                batch = distribute_tree(batch, {"inputs": tok_spec}, mesh,
                                        rules)
            logits, state = step(params, state, batch)
            out.append(logits.full_tensor() if mesh is not None
                       else logits)
        placements = (str(state["kv"]["k"].placements) if mesh is not None
                      else "")
    return torch.stack(out), placements


def case_decode():
    from repro_torch.launch.rules import serve_rules

    res = {}
    for name, window in (("decode", 0), ("decode_tail", 4)):
        cfg = dataclasses.replace(dense_cfg(), decode_tail_window=window)
        ref, _ = _decode_run(cfg, None, None, 12, 16)
        got, pl = _decode_run(cfg, _mesh((2, 2)), serve_rules(), 12, 16)
        res[f"{name}_diff"] = float((ref - got).abs().max())
        res[f"{name}_scale"] = float(ref.abs().max())
        res[f"{name}_cache_placements"] = pl
    return res


def ef_inputs(rank: int):
    g = torch.Generator().manual_seed(100 + rank)
    grads = {"a": torch.randn(3, 5, generator=g),
             "b": [torch.randn(7, generator=g) * 1e-3]}
    res = {"a": torch.randn(3, 5, generator=g) * 0.01,
           "b": [torch.randn(7, generator=g) * 1e-5]}
    return grads, res


def case_ef(rank: int):
    from repro_torch._tree import leaves, tree_map
    from repro_torch.optim.compress import ef_int8_psum

    grads, res = ef_inputs(rank)
    red, new_r = ef_int8_psum(grads, res, group=dist.group.WORLD)
    all_in = [ef_inputs(r) for r in range(WORLD)]
    stack = lambda *xs: torch.stack(xs)  # noqa: E731
    sg = tree_map(stack, *[a for a, _ in all_in])
    sr = tree_map(stack, *[b for _, b in all_in])
    red_s, new_s = ef_int8_psum(sg, sr)
    equal = all(torch.equal(x, y[rank]) for x, y in
                zip(leaves(red) + leaves(new_r), leaves(red_s)
                    + leaves(new_s)))
    return {"ef_bit_equal": equal}


def worker(rank: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD)
    try:
        res = {}
        for case in (case_dense, case_moe_ep, case_decode):
            res.update(case())
        res.update(case_ef(rank))
        Path(out, f"rank{rank}.json").write_text(json.dumps(res))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    worker(int(sys.argv[1]), sys.argv[2], sys.argv[3])
