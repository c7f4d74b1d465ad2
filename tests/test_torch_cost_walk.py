"""The cost walk (``repro_torch.launch.cost_walk``), the counterpart of
``tests/test_hlo_walker.py``: exact counts where a closed form is exact
(a product's 2 M N K, a loop of N products counting N times, nested loops
multiplying, each kernel stand-in's formula, an ``index_copy_`` into a
cache counting the slice), the live-byte count, remat's recompute, and a
whole step's FLOPs against ``model_flops``.  Everything walks under fake
tensors at SMOKE sizes; nothing of JAX is needed."""
import dataclasses
import math

import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from repro_torch import configs  # noqa: E402
from repro_torch.kernels import decode_attention as da  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import rwkv6_scan as ws  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.cost_walk import (BLOCK, CostWalk,  # noqa: E402
                                          block_bytes)
from repro_torch.launch.shapes import ShapeSpec, model_flops  # noqa: E402
from repro_torch.models import attention as mattn  # noqa: E402
from repro_torch.models import rwkv6 as mrwkv  # noqa: E402

BF16 = torch.bfloat16


def walk(fn, *track):
    """``fn()``'s walk under fake tensors; ``track`` builds the inputs
    (inside the fake mode) whose storages count as live."""
    with FakeTensorMode():
        xs = track[0]() if track else ()
        with CostWalk() as w:
            w.track(xs)
            fn(*xs) if track else fn()
    return w.stats


@pytest.mark.parametrize("dtype", (torch.float32, BF16))
@pytest.mark.parametrize("m,n,k", ((64, 48, 32), (4096, 4096, 4096)))
def test_a_product_counts_2mnk_and_its_operands_bytes(m, n, k, dtype):
    s = walk(lambda a, b: a @ b,
             lambda: (torch.empty(m, k, dtype=dtype),
                      torch.empty(k, n, dtype=dtype)))
    size = torch.empty(0, dtype=dtype).element_size()
    assert s.flops == 2 * m * n * k
    assert dict(s.flops_by_dtype) == {str(dtype)[6:]: 2 * m * n * k}
    assert s.hbm_bytes == (m * k + k * n + m * n) * size
    assert s.by_op["mm"][0] == 1


@pytest.mark.parametrize("n", (1, 3, 7))
def test_a_loop_of_n_products_counts_n_times_and_nesting_multiplies(n):
    def body(a, b):
        for _ in range(n):
            a @ b

    def nested(a, b):
        for _ in range(3):
            body(a, b)

    make = lambda: (torch.empty(8, 16), torch.empty(16, 4))  # noqa: E731
    one, looped, deep = (walk(f, make) for f in (
        lambda a, b: a @ b, body, nested))
    assert looped.flops == n * one.flops and looped.by_op["mm"][0] == n
    assert deep.flops == 3 * n * one.flops
    assert deep.hbm_bytes == 3 * n * one.hbm_bytes


def test_views_cost_nothing_and_copies_write_without_reading():
    def views(a):
        a.t().t().reshape(-1)[:5].unsqueeze(0).expand(3, 5)

    s = walk(views, lambda: (torch.empty(4, 6),))
    assert s.hbm_bytes == 0 and s.flops == 0
    # a reshape that cannot view copies
    s = walk(lambda a: a.t().reshape(-1), lambda: (torch.empty(4, 6),))
    assert s.hbm_bytes == 2 * 96
    s = walk(lambda a, b: a.copy_(b),
             lambda: (torch.empty(10, 10), torch.empty(10, 10)))
    assert s.hbm_bytes == 2 * 400
    s = walk(lambda a: a.zero_(), lambda: (torch.empty(10, 10),))
    assert s.hbm_bytes == 400
    s = walk(lambda a, b: a.add_(b),
             lambda: (torch.empty(10, 10), torch.empty(10, 10)))
    assert s.hbm_bytes == 3 * 400
    # a broadcast operand is read once
    s = walk(lambda a, b: a * b,
             lambda: (torch.empty(32, 10), torch.empty(10)))
    assert s.hbm_bytes == (320 + 10 + 320) * 4


def test_index_copy_into_a_cache_counts_the_slice_not_the_cache():
    """The decode step's write of one token's K/V into a (B, KV, S, hd)
    cache reads and writes the token's rows, as the reference counts a
    dynamic-update-slice."""
    def write(cache, new, at):
        cache.index_copy_(2, at, new)

    s = walk(write, lambda: (torch.empty(2, 4, 4096, 64, dtype=BF16),
                             torch.empty(2, 4, 1, 64, dtype=BF16),
                             torch.zeros(1, dtype=torch.long)))
    assert s.hbm_bytes == 8 + 2 * (2 * 4 * 64 * 2)
    # an indexed read (the embedding lookup) reads the rows, not the table
    s = walk(lambda t, i: t[i], lambda: (torch.empty(1000, 64),
                                         torch.zeros(2, 3, dtype=torch.long)))
    assert s.hbm_bytes == 6 * 8 + 2 * 6 * 64 * 4


def test_live_bytes_round_to_blocks_and_fall_when_freed():
    assert block_bytes(1) == block_bytes(BLOCK) == BLOCK
    assert block_bytes(BLOCK + 1) == 2 * BLOCK and block_bytes(0) == 0
    with FakeTensorMode():
        with CostWalk() as w:
            a = torch.empty(1000)                   # 4000 B -> 4096
            b = a[:10] + 1                           # 40 B -> 512
            assert w.stats.live_bytes == 4096 + 512
            del a                                    # b holds a new storage
            assert w.stats.live_bytes == 512
            c = torch.empty(10)
            c.add_(1)                               # in place: no new block
            assert w.stats.live_bytes == 1024
            del b, c
    assert w.stats.live_bytes == 0 and w.stats.peak_bytes == 4096 + 512


# ---------------------------------------------------------------------------
# the kernels' stand-ins: the kernels' output shapes and allocations, their
# closed-form costs
# ---------------------------------------------------------------------------


def _stand_in(fn, make):
    """(the stand-in's walk, its outputs' shapes/dtypes held against the
    plain version's on real tensors)."""
    with FakeTensorMode():
        xs = make()
        with CostWalk() as w:
            out = fn[0](*xs[0], **xs[1])
        meta = [(tuple(t.shape), t.dtype) for t in
                (out if isinstance(out, tuple) else (out,)) if t is not None]
    real = make()
    want = fn[1](*real[0], **real[1])
    assert meta == [(tuple(t.shape), t.dtype) for t in
                    (want if isinstance(want, tuple) else (want,))
                    if t is not None]
    return w.stats


@pytest.mark.parametrize("causal", (True, False))
@pytest.mark.parametrize("sq,skv", ((48, 48), (16, 40), (40, 16)))
def test_flash_stand_ins_charge_the_unmasked_pairs(sq, skv, causal):
    b, h, kv, hd = 2, 4, 2, 16
    mk = lambda: ((torch.randn(b, h, sq, hd), torch.randn(b, kv, skv, hd),  # noqa: E731
                   torch.randn(b, kv, skv, hd)),
                  dict(causal=causal, return_lse=True))
    pairs = dryrun.causal_pairs(sq, skv, causal)
    assert pairs == sum(min(q + 1, skv) if causal else skv
                        for q in range(sq))
    s = _stand_in((dryrun.flash_fwd_stand_in, fa.flash_attention_fwd), mk)
    io = 4 * (2 * b * h * sq * hd + 2 * b * kv * skv * hd + b * h * sq)
    assert s.flops == 4 * b * h * hd * pairs and s.hbm_bytes == io
    assert s.peak_bytes == block_bytes(4 * b * h * sq * hd) + block_bytes(
        4 * b * h * sq)

    def mkb():
        (q, k, v), _ = mk()
        o, lse = fa.flash_attention_plain(q, k, v, causal=causal,
                                          return_lse=True)
        return (q, k, v, o, torch.randn_like(o), lse), dict(causal=causal)

    s = _stand_in((dryrun.flash_bwd_stand_in, fa.flash_attention_bwd), mkb)
    io = 4 * (4 * b * h * sq * hd + 4 * b * kv * skv * hd + b * h * sq)
    assert s.flops == 10 * b * h * hd * pairs and s.hbm_bytes == io
    # dq, dk, dv and the f32 scratch (2 floats a row) at once
    assert s.peak_bytes == (block_bytes(4 * b * h * sq * hd)
                            + 2 * block_bytes(4 * b * kv * skv * hd)
                            + block_bytes(4 * 2 * b * h * sq))


@pytest.mark.parametrize("dtype", (torch.float32, BF16))
def test_decode_stand_ins_charge_the_whole_cache(dtype):
    b, kv, g, s, w, hd = 2, 2, 4, 96, 16, 32
    size = torch.empty(0, dtype=dtype).element_size()
    mk = lambda: ((torch.randn(b, kv, g, hd).to(dtype),  # noqa: E731
                   torch.randn(b, kv, s, hd).to(dtype),
                   torch.randn(b, kv, s, hd).to(dtype),
                   torch.tensor(37, dtype=torch.int32)), {})
    st = _stand_in((dryrun.decode_stand_in, da.decode_attention_fwd), mk)
    assert st.flops == 4 * b * kv * g * s * hd
    assert st.hbm_bytes == size * (2 * b * kv * g * hd + 2 * b * kv * s * hd)
    # the output and the f32 partials in one allocation
    splits = da.decode_splits(b, kv, s)
    ws_at = -(-b * kv * g * hd * size // 16) * 16
    assert st.peak_bytes == block_bytes(
        ws_at + 4 * b * kv * splits * g * (hd + 2))
    mk = lambda: ((torch.randn(b, kv, g, hd).to(dtype),  # noqa: E731
                   torch.randn(b, kv, s, hd).to(dtype),
                   torch.randn(b, kv, s, hd).to(dtype),
                   torch.randn(b, kv, w, hd).to(dtype),
                   torch.randn(b, kv, w, hd).to(dtype),
                   torch.tensor(37, dtype=torch.int32), w), {})
    st = _stand_in((dryrun.decode_tailed_stand_in,
                    da.decode_attention_tailed_fwd), mk)
    assert st.flops == 4 * b * kv * g * (s + w) * hd
    assert st.hbm_bytes == size * (2 * b * kv * g * hd
                                   + 2 * b * kv * (s + w) * hd)


@pytest.mark.parametrize("t", (1, 19))
def test_wkv_stand_ins_charge_their_formulas(t):
    b, h, hd = 2, 3, 16
    mk = lambda: (tuple(torch.rand(b, t, h, hd) for _ in range(4))  # noqa: E731
                  + (torch.randn(h, hd), torch.randn(b, h, hd, hd)),
                  dict(checkpoints=True))
    s = _stand_in((dryrun.wkv_fwd_stand_in, ws.rwkv6_wkv_fwd), mk)
    n_ck = math.prod(ws.ckpt_shape(b, t, h, hd))
    assert s.flops == b * t * h * (5 * hd * hd + 5 * hd)
    assert dict(s.flops_by_dtype) == {"float32": s.flops}
    assert s.hbm_bytes == 4 * (5 * b * t * h * hd + h * hd
                               + 2 * b * h * hd * hd + n_ck)

    def mkb():
        xs, _ = mk()
        _, _, ckpt = ws.rwkv6_wkv_plain(*xs, checkpoints=True)
        return (*xs[:5], ckpt, torch.randn(b, t, h, hd),
                torch.randn(b, h, hd, hd)), {}

    s = _stand_in((dryrun.wkv_bwd_stand_in, ws.rwkv6_wkv_bwd), mkb)
    assert s.flops == b * t * h * (14 * hd * hd + 16 * hd)
    assert s.hbm_bytes == 4 * (9 * b * t * h * hd + 2 * h * hd
                               + 2 * b * h * hd * hd + n_ck)


def test_stand_ins_sit_where_the_models_read_the_kernels_and_leave():
    kernels = {name: getattr(mod, name) for mod, name in (
        (mattn, "flash_attention_fwd"), (mattn, "flash_attention_bwd"),
        (mattn, "decode_attention_fwd"),
        (mattn, "decode_attention_tailed_fwd"),
        (mrwkv, "rwkv6_wkv_fwd"), (mrwkv, "rwkv6_wkv_bwd"))}
    with dryrun.stand_ins():
        for (mod, name), fn in dryrun.STAND_INS.items():
            assert getattr({"repro_torch.models.attention": mattn,
                            "repro_torch.models.rwkv6": mrwkv}[mod],
                           name) is fn
    for name, fn in kernels.items():
        mod = mrwkv if name.startswith("rwkv6") else mattn
        assert getattr(mod, name) is fn
    assert fa.flash_attention_fwd is kernels["flash_attention_fwd"]


# ---------------------------------------------------------------------------
# whole steps (SMOKE)
# ---------------------------------------------------------------------------

def _smoke(arch, **over):
    return dataclasses.replace(configs.get(arch, smoke=True), **over)


def _flops(cfg, shape, b):
    return dryrun.walk_step(cfg, shape, b)[0]


def test_remat_shows_its_recompute():
    """A dense train step with remat counts, beyond the same step without
    it, exactly one more forward of the layer bodies (the prefill step's
    backbone; its final norm does no product) when the checkpoint
    recomputes whole layers; by default (early stop, as the port runs)
    the recompute stops once the saved tensors are rebuilt, so it counts
    less, and still more than nothing."""
    from torch.utils.checkpoint import set_checkpoint_early_stop

    cfg = _smoke("qwen3-8b")
    shape = ShapeSpec("t", "train", 64, 2)
    off = _flops(dataclasses.replace(cfg, remat=False), shape, 2)
    with set_checkpoint_early_stop(False):
        whole = _flops(dataclasses.replace(cfg, remat=True), shape, 2)
    on = _flops(dataclasses.replace(cfg, remat=True), shape, 2)
    fwd = _flops(cfg, ShapeSpec("p", "prefill", 64, 2), 2)
    head = 2 * 2 * cfg.d_model * cfg.vocab_size     # the last positions'
    assert whole.flops - off.flops == fwd.flops - head
    assert 0 < on.flops - off.flops < whole.flops - off.flops
    assert whole.by_op["flash_attention_fwd"][0] == \
        2 * off.by_op["flash_attention_fwd"][0]
    assert on.peak_bytes < off.peak_bytes


@pytest.mark.parametrize("arch", ("qwen3-8b", "olmo-1b", "granite-3-8b"))
@pytest.mark.parametrize("kind", ("train", "prefill"))
def test_a_whole_steps_flops_against_model_flops(arch, kind):
    """A whole SMOKE step's walked FLOPs within [0.99, 1.03] of
    ``model_flops`` less what it counts that the step does not multiply:
    the embedding table of an untied model (a lookup, no product) in ``6
    N D`` / ``2 N D``, and in prefill the head at all but the last
    position (the step's logits are the last position's).  What is left
    is the walk's larger share: the attention backward's five products
    where ``model_flops`` takes twice the forward's two, and the causal
    diagonal (S (S + 1) / 2 pairs, not S^2 / 2).  Norms, softmax and
    embeddings' lookups are in neither count."""
    cfg = _smoke(arch)
    b, s = 4, 128
    shape = ShapeSpec("s", kind, s, b)
    vd, tokens = cfg.vocab_size * cfg.d_model, b * s
    table = 0 if cfg.tie_embeddings else (6 if kind == "train" else 2)
    want = model_flops(cfg, shape) - table * vd * tokens
    if kind == "prefill":
        want -= 2 * vd * (tokens - b)
    ratio = _flops(cfg, shape, b).flops / want
    assert 0.99 <= ratio <= 1.03, ratio
