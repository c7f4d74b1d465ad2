"""The port's sharded steps on 4 real gloo ranks against the same steps
unsharded (``tests/_torch_sharded_worker.py`` runs both on every rank):
a GQA model whose KV heads do not divide the model axis, qwen2-moe under
expert parallelism with E padded, decode on a sequence-sharded cache (the
log-sum-exp merge) with and without a tail, and the collective
``ef_int8_psum``.  One ``spawn`` for the module; the group is destroyed
by each rank before it exits.
"""
from __future__ import annotations

import json

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

pytestmark = pytest.mark.skipif(not dist.is_available(),
                                reason="torch.distributed is not built")

import _torch_sharded_worker as worker  # noqa: E402


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's findings (one spawn of 4 gloo ranks, a FileStore in a
    temporary directory: no port)."""
    import torch.multiprocessing as mp

    out = tmp_path_factory.mktemp("sharded")
    mp.spawn(worker.worker, args=(str(out / "store"), str(out)),
             nprocs=worker.WORLD, join=True)
    return [json.loads((out / f"rank{r}.json").read_text())
            for r in range(worker.WORLD)]


def test_dense_gqa_loss_and_step_match_unsharded(ranks):
    """6 q heads and 3 KV heads on a (2, 2) mesh: each rank's flash call
    reads the KV heads of its own q heads (kv head h // 2 of global q head
    h, by index: 0, 0, 1 and 1, 2, 2)."""
    cfg = worker.dense_cfg()
    assert cfg.n_kv_heads % 2 and not cfg.n_heads % 2
    for r in ranks:
        loss1, loss2 = r["dense_loss"]
        assert abs(loss2 - loss1) <= 1e-5 * abs(loss1)
        assert r["dense_param_diff"] <= 1e-5
        # no_sp splits the logits along the vocabulary
        assert abs(r["dense_no_sp_loss"] - loss1) <= 1e-5 * abs(loss1)


def test_moe_expert_parallel_with_padding_matches_unsharded(ranks):
    for r in ranks:
        assert r["moe_ep_axis"] == 4 and r["moe_experts"] % 4
        loss1, loss2 = r["moe_loss"]
        assert abs(loss2 - loss1) <= 1e-5 * abs(loss1)
        assert r["moe_layers_routed"] == 2
        assert r["moe_choices_equal"]


@pytest.mark.parametrize("name", ["decode", "decode_tail"])
def test_decode_on_sequence_sharded_cache_matches_unsharded(ranks, name):
    """12 steps over a 16-position cache split 8 and 8 along its sequence
    (the write lands on the rank that owns ``cache_len``; the shards merge
    by log-sum-exp); the tailed run flushes its 4-row tail every 4 steps
    into the sharded main cache."""
    for r in ranks:
        assert r[f"{name}_cache_placements"] == "(Shard(dim=1), Shard(dim=3))"
        assert r[f"{name}_diff"] <= 1e-5 * max(1.0, r[f"{name}_scale"])


def test_ef_int8_psum_over_group_equals_stacked_form(ranks):
    assert all(r["ef_bit_equal"] for r in ranks)
