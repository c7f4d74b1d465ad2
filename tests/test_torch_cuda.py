"""The port's kernels on the card, against their plain versions.

Every test here needs a CUDA card and ``nvcc`` (the kernels are built from
``src/repro_torch/kernels/csrc`` on first use); without a card each one
skips.  The file imports nothing of JAX, so it also runs on a machine that
has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

The annealer's step (``anneal_step``) equals ``anneal_step_reference``
bit for bit over 48 steps at path C1's widths (n = 32, 6 chains a row,
64 rows: a warp a chain) and path C2's (n = 256, 28 chains: a cluster of
8 blocks a chain), masked and unmasked, with draws that tie; the move
plane (``move_delta_batch``) equals its plain version bit for bit at
ragged and unaligned shapes; ``loop_fused`` equals its plain version
bit for bit for every n from 1 to 14, the 8 heuristics, masked and
unmasked, with an initial lag and recorded assignments.
The drain (``lag_update``) equals its in-order plain sum bit for bit
at N = 1, 31, 32, 33 and 256, masked and not, with bool and int32 masks
and int32 and int64 ``assign``, launching nothing but the output's
allocation besides its kernel.
The packing kernel (``pack_rows``) runs all 12 packers, masked and
unmasked, at n = 7, 32 and 256 and at its width limit, and must equal the
plain packers exactly (``loads`` bit for bit); the warp-per-row selection
kernel equals ``select_slot_plain`` exactly, ties included.  For the LLM
kernels, shapes are the reference tests' sweeps (``tests/test_kernels.py``), an
odd length, every head dim of the flash kernels (forward and backward),
q lengths that do not divide their tiles, the bfloat16 backward's
tensor-core kernels at hd 64 and 128 with G = 1 and 4 and ragged Sq !=
Skv (two calls bit-equal, and the routes that stay on the CUDA-core
kernels), the forward kernel's lse within 1e-5 of the plain lse (its
output bit-equal with and without it), decode fills on either side of a
split boundary and a decode call replayed from a CUDA graph at other fills
(also at 8 query rows a KV head), the decode kernel's tailed entry
(``decode_attention_tailed_fwd``) at 4 and 8 rows with an empty main
cache, a full tail, an empty tail and a window that does not divide the
cache, replayed from a CUDA graph across flushes, and small models end to
end (a tailed serve step and the VLM's M-RoPE prefill and decode); the
adversarial search's oracle rows on the card against the CPU transform of
the same draws, a search run twice with one seed (bit-equal), a trace
replayed equal to a direct run, and the ``py`` packers equal to the
``torch`` packers on the card; tolerances as everywhere for the attention
kernels: 2e-5 in float32, 2e-2 in bfloat16 (the backward's absolute part
scaled by the largest gradient of the plain result, and beside it
``chip_smoke.bwd_rel_errs``'s relative norms, whole and by blocks of 64
rows of one head, within ``chip_smoke.BWD_REL_TOL``); a train step of a
smoke model on the card against the CPU within 1e-4 of each leaf's largest
magnitude (loss, parameters, moments), and MoE and hybrid smoke models'
train steps with the kernels against their plain versions on the card
(``chip_smoke.train_agreement``); the WKV kernel (float32 only)
within 1e-4 of the largest magnitude of its plain result, the reference's
own tolerance for its kernel; its backward (``rwkv6_wkv_bwd``) at every
head size, T not a multiple of its checkpoint stride and T = 1, decays
that are exactly 0 and near 1, within 1e-4 of each plain gradient's
largest magnitude and ``chip_smoke.WKV_BWD_REL_TOL`` in relative norm
(whole and by 64-step blocks), two calls bit-equal; and an RWKV smoke
model's train steps on the card against the CPU.
"""
import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch import configs  # noqa: E402
from repro_torch.core.pack import modified_any_fit_plain, pack_plain  # noqa: E402
from repro_torch.kernels.binpack_select import (  # noqa: E402
    PACK_MAX_N, PackWidthError, pack_rows, select_slot_grid,
    select_slot_plain)
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_fwd, decode_attention_plain,
    decode_attention_tailed_fwd, decode_attention_tailed_plain,
    decode_splits)
from repro_torch.kernels.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention, flash_attention_bwd,
    flash_attention_bwd_plain, flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.lag_update import (  # noqa: E402
    lag_update_batch, lag_update_reference, lag_update_single)
from repro_torch.kernels.loop_fused import (  # noqa: E402
    loop_fused, loop_fused_reference)
from repro_torch.kernels.move_eval import (  # noqa: E402
    ChainState, anneal_step, anneal_step_reference, move_delta_batch,
    move_delta_reference)
from repro_torch.kernels.rwkv6_scan import (  # noqa: E402
    WKV, rwkv6_wkv, rwkv6_wkv_bwd, rwkv6_wkv_bwd_plain, rwkv6_wkv_fwd,
    rwkv6_wkv_plain)
from repro_torch.launch.steps import (make_prefill_step,  # noqa: E402
                                      make_serve_step, make_train_step)
from repro_torch.models import init_decode_state, init_params  # noqa: E402
from repro_torch.registry import get_spec  # noqa: E402

pytestmark = pytest.mark.cuda
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels are built and run there")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _normal(seed, shapes, dtype, dev):
    rng = np.random.default_rng(seed)
    return [torch.tensor(rng.standard_normal(s, dtype=np.float32)).to(
        device=dev, dtype=dtype) for s in shapes]


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 256, 64),
    (1, 4, 1, 256, 256, 128), (1, 2, 2, 64, 192, 32),
    (2, 4, 2, 100, 100, 16),          # odd length, smoke head dim
    # every head dim the kernels are built for (the bf16 kernel's tile
    # sizes and swizzle modes differ by head dim: 64-key tiles at 256)
    *[(2, 4, 2, 300, 300, hd) for hd in HEAD_DIMS],
    # q lengths that do not divide the 128-row q tile; Skv > Sq (causal
    # by absolute position); 333 x 1000
    (2, 8, 2, 1, 1, 128), (2, 8, 2, 65, 65, 128), (2, 8, 2, 129, 129, 128),
    (2, 8, 2, 1000, 1000, 128), (2, 8, 2, 129, 700, 128),
    (2, 8, 2, 333, 1000, 128),
    # chip_smoke's paths: M1 (qwen2-moe, 16 heads over 16 KV heads) and
    # N1 (jamba, 32 over 8; D1's shape too)
    (8, 16, 16, 1024, 1024, 128), (8, 32, 8, 1024, 1024, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernel_matches_plain(cuda, b, h, kv, sq, skv, hd, dtype,
                                    causal):
    q, k, v = _normal(4, [(b, h, sq, hd), (b, kv, skv, hd),
                          (b, kv, skv, hd)], dtype, cuda)
    before = flash_attention_fwd.launches
    got = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_fwd.launches == before + 1
    assert got.dtype == dtype
    torch.testing.assert_close(
        got.float(), flash_attention_plain(q, k, v, causal=causal).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", [
    (1, 4, 4, 128, 128, 64), (2, 8, 2, 128, 256, 64),
    (1, 4, 1, 256, 256, 128), (1, 2, 2, 64, 192, 32),
    (2, 4, 2, 100, 100, 16),          # odd length, smoke head dim
    *[(2, 4, 2, 300, 300, hd) for hd in HEAD_DIMS],
    # q tiles of 64 (dq) and 32 (dkv) rows and key blocks of 64 (32 at hd
    # 256) that do not divide the lengths; Skv > Sq and Sq > Skv
    (2, 8, 2, 1, 1, 128), (2, 8, 2, 65, 65, 128), (2, 8, 2, 129, 700, 128),
    (2, 8, 2, 333, 100, 64), (1, 16, 16, 1024, 1024, 128),
])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_kernel_matches_plain(cuda, b, h, kv, sq, skv, hd, dtype,
                                        causal):
    q, k, v, do = _normal(5, [(b, h, sq, hd), (b, kv, skv, hd),
                              (b, kv, skv, hd), (b, h, sq, hd)], dtype, cuda)
    o, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want = flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal)
    _assert_grads_close(got, want, dtype)


def _assert_grads_close(got, want, dtype):
    """The backward's tolerance: ``rtol``, and ``atol`` scaled by the
    plain result's largest gradient; and ``chip_smoke.bwd_rel_errs``'s
    relative norms, whole and by blocks of 64 rows of one head, within
    ``chip_smoke.BWD_REL_TOL``."""
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        scale = max(float(w.float().abs().max()), 1.0)
        torch.testing.assert_close(g.float(), w.float(), rtol=TOL[dtype],
                                   atol=TOL[dtype] * scale)
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    name = str(dtype).removeprefix("torch.")
    rel = chip_smoke.bwd_rel_errs(got, want, name)
    assert max(max(r) for r in rel.values()) <= chip_smoke.BWD_REL_TOL[
        name], rel


@pytest.fixture
def entries(monkeypatch):
    """The C entry points launched, in order (a spy on ``_build.launch``
    that still launches)."""
    from repro_torch.kernels import _build

    seen, launch = [], _build.launch

    def spy(name, *args):
        seen.append(name)
        return launch(name, *args)

    monkeypatch.setattr(_build, "launch", spy)
    return seen


# the tensor-core backward: G = 1 and 4, lengths that divide none of its
# tiles (64-row q tiles, 128-row blocks), Sq < Skv and Sq > Skv
WGMMA_BWD_SHAPES = [
    (2, 4, 4, 200, 200), (2, 8, 2, 333, 333), (1, 8, 2, 100, 250),
    (1, 4, 4, 250, 100), (1, 4, 1, 1, 70), (2, 8, 2, 129, 129),
    (1, 16, 4, 1024, 1024),
]


@pytest.mark.parametrize("b,h,kv,sq,skv", WGMMA_BWD_SHAPES)
@pytest.mark.parametrize("hd", [64, 128])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_wgmma_matches_plain(cuda, entries, b, h, kv, sq, skv, hd,
                                       causal):
    """bfloat16 at hd 64 and 128 on the tensor-core kernels, fed the
    forward kernel's output and lse, against the plain version on the
    same inputs; a second call gives the same bits."""
    dtype = torch.bfloat16
    q, k, v, do = _normal(9, [(b, h, sq, hd), (b, kv, skv, hd),
                              (b, kv, skv, hd), (b, h, sq, hd)], dtype, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    assert entries[-1] == "flash_attention_bwd_bf16_wgmma"
    _assert_grads_close(
        got, flash_attention_bwd_plain(q, k, v, o, do, lse, causal=causal),
        dtype)
    again = flash_attention_bwd(q, k, v, o, do, lse, causal=causal)
    assert all(torch.equal(x, y) for x, y in zip(got, again))


@pytest.mark.parametrize("dtype,hd", [(torch.float32, 64),
                                      (torch.float32, 128),
                                      (torch.bfloat16, 16),
                                      (torch.bfloat16, 256)])
def test_flash_bwd_cuda_core_routes(cuda, entries, dtype, hd):
    """float32, and bfloat16 at head dims the tensor-core kernels do not
    take, stay on the CUDA-core kernels: one launch of their entry
    point, within tolerance of the plain version."""
    q, k, v, do = _normal(10, [(2, 8, 150, hd), (2, 2, 150, hd),
                               (2, 2, 150, hd), (2, 8, 150, hd)], dtype, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=True, return_lse=True)
    before = flash_attention_bwd.launches
    got = flash_attention_bwd(q, k, v, o, do, lse, causal=True)
    torch.cuda.synchronize()
    assert flash_attention_bwd.launches == before + 1
    want_entry = ("flash_attention_bwd_f32" if dtype == torch.float32
                  else "flash_attention_bwd_bf16")
    assert entries[-1] == want_entry
    _assert_grads_close(
        got, flash_attention_bwd_plain(q, k, v, o, do, lse, causal=True),
        dtype)


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", [
    (2, 8, 2, 333, 1000, 128), (2, 4, 4, 1000, 333, 64),
    (1, 4, 1, 1, 1, 128), *[(2, 4, 2, 300, 300, hd) for hd in HEAD_DIMS]])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_kernel_lse(cuda, b, h, kv, sq, skv, hd, dtype, causal):
    """The forward kernel's lse within 1e-5 of the plain lse; its output
    with lse stored is bit-equal to its output without."""
    q, k, v = _normal(11, [(b, h, sq, hd), (b, kv, skv, hd),
                           (b, kv, skv, hd)], dtype, cuda)
    o, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    plain = flash_attention_fwd(q, k, v, causal=causal)
    _, want = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert lse.dtype == torch.float32 and lse.shape == (b, h, sq)
    torch.testing.assert_close(lse, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(o, plain)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_gradient_on_the_card(cuda, dtype):
    """``flash_attention`` through autograd on the card: one launch of each
    kernel, gradients nonzero and equal to the plain versions' Function
    on the card."""
    q, k, v, do = _normal(6, [(2, 8, 200, 64), (2, 2, 200, 64),
                              (2, 2, 200, 64), (2, 8, 200, 64)], dtype, cuda)
    grads = []
    for fwd, bwd in ((flash_attention_fwd, flash_attention_bwd),
                     (flash_attention_plain, flash_attention_bwd_plain)):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        before = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        flash_attention(*leaves, causal=True, fwd=fwd, bwd=bwd).backward(do)
        torch.cuda.synchronize()
        after = (flash_attention_fwd.launches, flash_attention_bwd.launches)
        kernel = fwd is flash_attention_fwd
        assert after == tuple(n + kernel for n in before)
        grads.append([x.grad for x in leaves])
    assert all(float(g.float().abs().max()) > 0 for g in grads[0])
    _assert_grads_close(*grads, dtype)


@pytest.mark.parametrize("arch", ["qwen3-8b", "olmo-1b", "granite-3-8b"])
def test_train_step_on_the_card_matches_the_cpu(cuda, arch):
    """Two AdamW steps of the float32 smoke model (remat on) on the card
    (both flash kernels) against the CPU (plain versions)."""
    from repro_torch import _tree
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype="float32", remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
    cpu = init_params(cfg, seed=0, device="cpu")
    card = _tree.tree_map(lambda t: t.to(cuda), cpu)
    states = [adamw_init(card), adamw_init(cpu)]
    params = [card, cpu]
    steps = [make_train_step(cfg, opt, d) for d in (cuda, "cpu")]
    pipe = TokenPipeline(2, 32, cfg.vocab_size, seed=2)
    for _ in range(2):
        batch = pipe.next_batch()
        before = flash_attention_bwd.launches
        out = [step(p, st, batch)
               for step, p, st in zip(steps, params, states)]
        assert flash_attention_bwd.launches == before + cfg.n_layers
        params = [o[0] for o in out]
        states = [o[1] for o in out]
        torch.testing.assert_close(out[0][2]["loss"].cpu(), out[1][2]["loss"],
                                   rtol=1e-4, atol=1e-4)
        for tree_card, tree_cpu in ((params[0], params[1]),
                                    (states[0]["mu"], states[1]["mu"]),
                                    (states[0]["nu"], states[1]["nu"])):
            for (name, g), w in zip(_tree.items(tree_card),
                                    _tree.leaves(tree_cpu)):
                scale = max(float(w.abs().max()), 1.0)
                assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("arch", ["qwen2-moe-a2.7b", "jamba-v0.1-52b"])
def test_moe_and_hybrid_train_steps_on_the_card_match_their_plain_steps(
        cuda, chip_smoke, arch):
    """A MoE and a hybrid smoke model (float32, remat on): two AdamW steps
    on the card with the flash kernels against the same steps with their
    plain versions swapped in where ``models.attention`` reads them, as
    ``chip_smoke.py`` paths R2 and R3 hold them
    (``chip_smoke.train_agreement``: losses within 1e-5, every leaf's
    update by its relative norm within the float32 limit, two forward and
    one backward launch a step and attention layer, the bfloat16 backward
    of ``agreement_controls`` rejected)."""
    from repro_torch.data import TokenPipeline
    from repro_torch.models.transformer import attention_layers
    from repro_torch.optim import AdamWConfig

    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype="float32", remat=True)
    pipe = TokenPipeline(2, 32, cfg.vocab_size, seed=2)
    out = chip_smoke.train_agreement(
        cuda, cfg, [pipe.next_batch() for _ in range(2)],
        AdamWConfig(lr=1e-3, warmup_steps=1, eps=1e-3), f"{arch} on the card",
        controls=chip_smoke.agreement_controls())
    n_attn = len(attention_layers(cfg))
    assert out["flash_attention_fwd"] == 2 * 2 * n_attn
    assert out["flash_attention_bwd"] == 2 * n_attn
    assert out["verdict"]["rel_ok"]
    assert min(out["controls"].values()) > chip_smoke.F32_UPDATE_REL_TOL


@pytest.mark.parametrize("b,kv,g,s,hd", [
    (2, 2, 4, 256, 64), (1, 4, 1, 128, 128), (3, 1, 8, 512, 64),
    # chip_smoke's paths M2 (one query head over each of 16 KV heads), N2
    # (4 over each of 8) and P2 (8 over each of 8), at their 1152-position
    # caches
    (8, 16, 1, 1152, 128), (8, 8, 4, 1152, 128), (8, 8, 8, 1152, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("fill", [0, 7, 200])
def test_decode_kernel_matches_plain(cuda, b, kv, g, s, hd, dtype, fill):
    q, k, v = _normal(5, [(b, kv, g, hd), (b, kv, s, hd), (b, kv, s, hd)],
                      dtype, cuda)
    clen = torch.tensor(fill, dtype=torch.int32, device=cuda)
    before = decode_attention_fwd.launches
    got = decode_attention_fwd(q, k, v, clen)
    torch.cuda.synchronize()
    assert decode_attention_fwd.launches == before + 1
    torch.testing.assert_close(
        got.float(), decode_attention_plain(q, k, v, clen).float(),
        rtol=TOL[dtype], atol=TOL[dtype])


def _boundary_fills(b, kv, s):
    """Fills 0 and S - 1, and the fills whose n = fill + 1 positions end
    one short of and exactly at a multiple of the split count."""
    splits = decode_splits(b, kv, s)
    at = splits * max(1, (s // 2) // splits) - 1
    return sorted({0, at - 1, at, s - 1})


@pytest.mark.parametrize("b,kv,g,s", [(2, 2, 4, 200), (8, 8, 4, 1152),
                                      (1, 2, 4, 32768), (8, 16, 1, 1152)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_split_boundaries(cuda, b, kv, g, s, dtype):
    q, k, v = _normal(8, [(b, kv, g, 128), (b, kv, s, 128),
                          (b, kv, s, 128)], dtype, cuda)
    for fill in _boundary_fills(b, kv, s):
        clen = torch.tensor(fill, dtype=torch.int32, device=cuda)
        got = decode_attention_fwd(q, k, v, clen)
        torch.testing.assert_close(
            got.float(), decode_attention_plain(q, k, v, clen).float(),
            rtol=TOL[dtype], atol=TOL[dtype],
            msg=lambda m: f"fill {fill}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_graph_replays_at_other_fills(cuda, dtype):
    """One call captured in a CUDA graph, replayed after ``cache_len`` is
    changed in place: the split plan is fixed by the shapes and each block
    reads the fill on the device, so every replay equals the plain
    version at the new fill."""
    b, kv, g, s = 4, 8, 4, 1152
    q, k, v = _normal(9, [(b, kv, g, 128), (b, kv, s, 128),
                          (b, kv, s, 128)], dtype, cuda)
    clen = torch.tensor(17, dtype=torch.int32, device=cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_fwd(q, k, v, clen)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_fwd(q, k, v, clen)
    for fill in (17, 700, s - 1):
        clen.fill_(fill)
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), decode_attention_plain(q, k, v, clen).float(),
            rtol=TOL[dtype], atol=TOL[dtype],
            msg=lambda m: f"fill {fill}: {m}")


@pytest.mark.parametrize("b,kv,g,s,w", [
    (8, 8, 8, 1152, 256), (8, 8, 4, 1152, 256), (2, 2, 8, 64, 16),
    (2, 4, 1, 200, 7), (1, 2, 2, 1152, 100)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_tailed_kernel_matches_plain(cuda, b, kv, g, s, w, dtype):
    """The tailed entry at fills with an empty main cache (0, w - 1), an
    empty tail (w, 2w), mid-way and the last fill: one counted launch a
    call, equal to the reference's two-part merge."""
    q, km, vm, kt, vt = _normal(11, [(b, kv, g, 128), (b, kv, s, 128),
                                     (b, kv, s, 128), (b, kv, w, 128),
                                     (b, kv, w, 128)], dtype, cuda)
    for fill in sorted({0, w - 1, w, 2 * w, s // 2, s - 1}):
        clen = torch.tensor(fill, dtype=torch.int32, device=cuda)
        before = decode_attention_tailed_fwd.launches
        got = decode_attention_tailed_fwd(q, km, vm, kt, vt, clen, w)
        torch.cuda.synchronize()
        assert decode_attention_tailed_fwd.launches == before + 1
        torch.testing.assert_close(
            got.float(), decode_attention_tailed_plain(
                q, km, vm, kt, vt, clen, w).float(),
            rtol=TOL[dtype], atol=TOL[dtype],
            msg=lambda m: f"fill {fill}: {m}")


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_tailed_graph_replays_across_a_flush(cuda, dtype):
    """One tailed call captured in a CUDA graph, replayed at fills set on
    the card, the tail flushed into the main cache (``flush_kv_tail``, in
    place) and refilled at each multiple of the window: every replay
    equals the plain version."""
    from repro_torch.models import flush_kv_tail

    b, kv, g, s, w = 4, 8, 8, 1152, 256
    cfg = dataclasses.replace(configs.get("deepseek-67b", smoke=True),
                              decode_tail_window=w)
    q, km, vm, kt, vt = _normal(12, [(b, kv, g, 128), (b, kv, s, 128),
                                     (b, kv, s, 128), (b, kv, w, 128),
                                     (b, kv, w, 128)], dtype, cuda)
    clen = torch.tensor(100, dtype=torch.int32, device=cuda)
    state = {"cache_len": clen, "kv": {"k": km[None], "v": vm[None]},
             "tail": {"k": kt[None], "v": vt[None]}}
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        decode_attention_tailed_fwd(q, km, vm, kt, vt, clen, w)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = decode_attention_tailed_fwd(q, km, vm, kt, vt, clen, w)
    gen = torch.Generator(cuda).manual_seed(0)
    for fill in (100, w - 1, w, w + 9, 2 * w, s - 1):
        clen.fill_(fill)
        if fill % w == 0:
            flush_kv_tail(cfg, state)
            assert not bool(kt.any())
            kt.copy_(torch.randn(kt.shape, generator=gen, device=cuda))
            vt.copy_(torch.randn(vt.shape, generator=gen, device=cuda))
        graph.replay()
        torch.cuda.synchronize()
        torch.testing.assert_close(
            out.float(), decode_attention_tailed_plain(
                q, km, vm, kt, vt, clen, w).float(),
            rtol=TOL[dtype], atol=TOL[dtype],
            msg=lambda m: f"fill {fill}: {m}")


def test_tailed_serve_on_the_card_matches_the_cpu(cuda):
    """deepseek SMOKE in float32 with a tail of 4: 11 decode steps with a
    flush at 4 and 8 on the card (the tailed entry, 3 launches a step)
    against the same weights on the CPU (plain versions): logits, the main
    cache and the tail."""
    from repro_torch import _tree
    from repro_torch.models import flush_kv_tail

    cfg = dataclasses.replace(configs.get("deepseek-67b", smoke=True),
                              dtype="float32", decode_tail_window=4)
    cpu_params = init_params(cfg, seed=0, device="cpu")
    params = _tree.tree_map(lambda t: t.to(cuda), cpu_params)
    toks = np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 11)).astype(np.int32)
    states = [init_decode_state(cfg, 2, 16, d) for d in (cuda, "cpu")]
    steps = [make_serve_step(cfg, d) for d in (cuda, "cpu")]
    before = decode_attention_tailed_fwd.launches
    for t in range(11):
        (got, states[0]), (want, states[1]) = (
            step(p, st, {"inputs": toks[:, t]})
            for step, p, st in zip(steps, (params, cpu_params), states))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
        if (t + 1) % 4 == 0:
            states = [flush_kv_tail(cfg, st) for st in states]
    assert decode_attention_tailed_fwd.launches == before + 11 * cfg.n_layers
    for part in ("kv", "tail"):
        for name in ("k", "v"):
            torch.testing.assert_close(states[0][part][name].cpu(),
                                       states[1][part][name], rtol=1e-5,
                                       atol=1e-5)


def test_vlm_on_the_card_matches_the_cpu(cuda):
    """qwen2-vl SMOKE in float32: a prefill of embeddings with 3-stream
    image-grid positions and six decode steps of (B, 1, d) embeddings on
    the card against the CPU."""
    from repro_torch import _tree

    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    try:
        from chip_smoke import mrope_positions
    finally:
        sys.path.pop(0)
    cfg = dataclasses.replace(configs.get("qwen2-vl-72b", smoke=True),
                              dtype="float32")
    cpu_params = init_params(cfg, seed=0, device="cpu")
    params = _tree.tree_map(lambda t: t.to(cuda), cpu_params)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 13, cfg.d_model), dtype=np.float32)
    batch = {"inputs": x, "positions": mrope_positions(2, 3, (2, 3), 4)}
    torch.testing.assert_close(
        make_prefill_step(cfg, cuda)(params, batch).cpu(),
        make_prefill_step(cfg, "cpu")(cpu_params, batch),
        rtol=1e-5, atol=1e-5)
    states = [init_decode_state(cfg, 2, 8, d) for d in (cuda, "cpu")]
    steps = [make_serve_step(cfg, d) for d in (cuda, "cpu")]
    for t in range(6):
        feed = {"inputs": x[:, t:t + 1],
                "positions": np.full((3, 2, 1), 10 + t, np.int64)}
        (got, states[0]), (want, states[1]) = (
            step(p, st, feed)
            for step, p, st in zip(steps, (params, cpu_params), states))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)


def _wkv_inputs(b, t, h, hd, dev, seed=3):
    """As ``tests/test_kernels.py`` draws them: w in (0.45, 0.95), non-zero
    u and s0."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    w = 0.5 / (1.0 + np.exp(-n(b, t, h, hd))) + 0.45
    xs = [n(b, t, h, hd), n(b, t, h, hd) * 0.3, n(b, t, h, hd), w,
          n(h, hd) * 0.1, n(b, h, hd, hd) * 0.1]
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in xs]


def _wkv_close(got, want):
    tol = 1e-4 * float(want.abs().max())
    torch.testing.assert_close(got, want, rtol=0.0, atol=tol)


@pytest.mark.parametrize("b,t,h,hd", [
    (1, 16, 2, 16), (2, 64, 4, 32), (1, 128, 1, 64),   # the reference's
    (2, 1000, 3, 64), (3, 1, 5, 128), (1, 77, 2, 128),
    # T not a multiple of the 8-step tile, at every head size (hd = 16
    # leaves lanes idle; hd = 128 is 16 one-warp column blocks a head);
    # E2's decode call; a tile count past the 3-stage ring's wrap
    (2, 25, 3, 16), (2, 19, 3, 32), (1, 13, 5, 64), (1, 9, 2, 128),
    (8, 1, 40, 64), (1, 61, 1, 64)])
@pytest.mark.parametrize("in_place", [False, True])
def test_wkv_kernel_matches_plain(cuda, b, t, h, hd, in_place):
    r, k, v, w, u, s0 = _wkv_inputs(b, t, h, hd, cuda)
    want, s_want = rwkv6_wkv_plain(r, k, v, w, u, s0)
    before = rwkv6_wkv_fwd.launches
    out, s_last = rwkv6_wkv_fwd(r, k, v, w, u, s0,
                                s_last=s0 if in_place else None)
    torch.cuda.synchronize()
    assert rwkv6_wkv_fwd.launches == before + 1
    assert (s_last is s0) == in_place
    _wkv_close(out, want)
    _wkv_close(s_last, s_want)


def test_wkv_kernel_takes_inputs_off_a_16_byte_boundary(cuda):
    """The kernel's bulk copies and float4 accesses need 16-byte aligned
    tensors: the wrapper copies an input that is not, and refuses an
    ``s_last`` that is not (it must be written in place)."""
    xs = _wkv_inputs(2, 11, 3, 64, cuda, seed=5)
    want, s_want = rwkv6_wkv_plain(*xs)
    off = [torch.empty(x.numel() + 1, device=cuda)[1:].view(x.shape).copy_(x)
           for x in xs]
    assert all(x.data_ptr() % 16 for x in off)
    out, s_last = rwkv6_wkv_fwd(*off)
    torch.cuda.synchronize()
    _wkv_close(out, want)
    _wkv_close(s_last, s_want)
    with pytest.raises(ValueError, match="16-byte"):
        rwkv6_wkv_fwd(*off[:5], off[5], s_last=off[5])


def test_wkv_chunked_kernel_matches_unchunked(cuda):
    xs = _wkv_inputs(2, 256, 3, 64, cuda, seed=4)
    before = rwkv6_wkv_fwd.launches
    got, s_got = rwkv6_wkv(*xs, chunk=64)
    assert rwkv6_wkv_fwd.launches == before + 4
    want, s_want = rwkv6_wkv(*xs)
    torch.cuda.synchronize()
    _wkv_close(got, want)
    _wkv_close(s_got, s_want)


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _wkv_bwd_inputs(b, t, h, hd, dev, seed=7):
    """r, k, v, w, u, s0, do, ds_last; w = exp(-exp(wlog)), wlog uniform
    on [-8, 6]: exact zeros and values near 1."""
    rng = np.random.default_rng(seed)
    n = lambda *s: rng.standard_normal(s, dtype=np.float32)  # noqa: E731
    w = np.exp(-np.exp(rng.uniform(-8.0, 6.0, (b, t, h, hd))))
    xs = [n(b, t, h, hd), n(b, t, h, hd) * 0.5, n(b, t, h, hd), w,
          n(h, hd) * 0.5, n(b, h, hd, hd) * 0.3, n(b, t, h, hd),
          n(b, h, hd, hd)]
    return [torch.tensor(x, dtype=torch.float32, device=dev) for x in xs]


@pytest.mark.parametrize("b,t,h,hd", [
    (2, 37, 3, 16), (2, 37, 3, 32), (1, 70, 2, 64), (2, 37, 3, 128),
    (2, 1000, 3, 64), (3, 1, 5, 64), (1, 1, 2, 16), (2, 16, 2, 64),
    (1, 9, 2, 128), (2, 65, 40, 64)])
def test_wkv_bwd_kernel_matches_plain(cuda, chip_smoke, b, t, h, hd):
    """The training forward kernel's checkpoints against the plain
    forward's (within 1e-4 of their largest), and the backward kernel,
    fed the plain checkpoints, against the plain backward."""
    xs = _wkv_bwd_inputs(b, t, h, hd, cuda)
    assert int((xs[3] == 0).sum()) > 0 or t * h * hd < 64
    *_, ckpt = rwkv6_wkv_plain(*xs[:6], checkpoints=True)
    *_, ckpt_k = rwkv6_wkv_fwd(*xs[:6], checkpoints=True)
    assert float((ckpt_k - ckpt).abs().max()) <= 1e-4 * float(
        ckpt.abs().max())
    bx = [*xs[:5], ckpt, *xs[6:]]
    want = rwkv6_wkv_bwd_plain(*bx)
    before = rwkv6_wkv_bwd.launches
    got, again = rwkv6_wkv_bwd(*bx), rwkv6_wkv_bwd(*bx)
    torch.cuda.synchronize()
    assert rwkv6_wkv_bwd.launches == before + 2
    verdict = chip_smoke.wkv_bwd_verdict(got, want)
    assert all(c["close"] and c["rel_ok"] for c in verdict.values()), \
        verdict
    assert all(torch.equal(x, y) for x, y in zip(got, again))


def test_wkv_function_on_the_card_matches_the_plain_pair(cuda, chip_smoke):
    xs = _wkv_bwd_inputs(2, 300, 4, 64, cuda, seed=8)
    grads = []
    for fwd, bwd in ((rwkv6_wkv_fwd, rwkv6_wkv_bwd),
                     (rwkv6_wkv_plain, rwkv6_wkv_bwd_plain)):
        leaves = [x.clone().requires_grad_(True) for x in xs[:6]]
        out, s_last = WKV.apply(*leaves, fwd, bwd)
        ((out * xs[6]).sum() + (s_last * xs[7]).sum()).backward()
        grads.append(tuple(x.grad for x in leaves))
    verdict = chip_smoke.wkv_bwd_verdict(*grads)
    assert all(c["close"] and c["rel_ok"] for c in verdict.values()), \
        verdict


def test_rwkv_train_step_on_the_card_matches_the_cpu(cuda):
    """Two AdamW steps of the float32 rwkv6-smoke (remat on) on the card
    (both WKV kernels, two forward launches a layer) against the CPU
    (plain versions)."""
    from repro_torch import _tree
    from repro_torch.data import TokenPipeline
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(configs.get("rwkv6-3b", smoke=True),
                              dtype="float32", remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
    cpu = init_params(cfg, seed=0, device="cpu")
    card = _tree.tree_map(lambda t: t.to(cuda), cpu)
    states = [adamw_init(card), adamw_init(cpu)]
    params = [card, cpu]
    steps = [make_train_step(cfg, opt, d) for d in (cuda, "cpu")]
    pipe = TokenPipeline(2, 48, cfg.vocab_size, seed=2)
    for _ in range(2):
        batch = pipe.next_batch()
        fwd, bwd = rwkv6_wkv_fwd.launches, rwkv6_wkv_bwd.launches
        out = [step(p, st, batch)
               for step, p, st in zip(steps, params, states)]
        assert rwkv6_wkv_fwd.launches == fwd + 2 * cfg.n_layers
        assert rwkv6_wkv_bwd.launches == bwd + cfg.n_layers
        params = [o[0] for o in out]
        states = [o[1] for o in out]
        torch.testing.assert_close(out[0][2]["loss"].cpu(), out[1][2]["loss"],
                                   rtol=1e-4, atol=1e-4)
        for tree_card, tree_cpu in ((params[0], params[1]),
                                    (states[0]["mu"], states[1]["mu"]),
                                    (states[0]["nu"], states[1]["nu"])):
            for (name, g), w in zip(_tree.items(tree_card),
                                    _tree.leaves(tree_cpu)):
                scale = max(float(w.abs().max()), 1.0)
                assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, name


@pytest.mark.parametrize("arch", ["qwen3-8b", "olmo-1b", "granite-3-8b",
                                  "rwkv6-3b", "qwen2-moe-a2.7b",
                                  "llama4-scout-17b-a16e", "jamba-v0.1-52b"])
def test_model_on_the_card_matches_the_cpu(cuda, arch):
    """The smoke model in float32: prefill and six decode steps on the card
    (kernels; a MoE model's dispatch on the card) against the same weights
    on the CPU (plain versions)."""
    cfg = dataclasses.replace(configs.get(arch, smoke=True),
                              dtype="float32")
    cpu_params = init_params(cfg, seed=0, device="cpu")
    from repro_torch import _tree

    params = _tree.tree_map(lambda t: t.to(cuda), cpu_params)
    toks = np.random.default_rng(6).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    torch.testing.assert_close(
        make_prefill_step(cfg, cuda)(params, {"inputs": toks}).cpu(),
        make_prefill_step(cfg, "cpu")(cpu_params, {"inputs": toks}),
        rtol=1e-5, atol=1e-5)
    states = [init_decode_state(cfg, 2, 8, d) for d in (cuda, "cpu")]
    steps = [make_serve_step(cfg, d) for d in (cuda, "cpu")]
    for t in range(6):
        (got, states[0]), (want, states[1]) = (
            step(p, st, {"inputs": toks[:, t]})
            for step, p, st in zip(steps, (params, cpu_params), states))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert int(states[0]["cache_len"]) == 6


def test_whisper_on_the_card_matches_the_cpu(cuda):
    """whisper SMOKE in float32: prefill, then the encoder, the cross K/V
    and six decode steps on the card (flash and decode kernels) against
    the same weights on the CPU (plain versions)."""
    from repro_torch import _tree
    from repro_torch.models.whisper import encode, precompute_cross_kv

    cfg = dataclasses.replace(configs.get("whisper-large-v3", smoke=True),
                              dtype="float32")
    cpu_params = init_params(cfg, seed=0, device="cpu")
    params = _tree.tree_map(lambda t: t.to(cuda), cpu_params)
    rng = np.random.default_rng(7)
    frames = rng.standard_normal((2, cfg.encoder_seq_len, cfg.d_model),
                                 dtype=np.float32)
    toks = rng.integers(0, cfg.vocab_size, (2, 6)).astype(np.int32)
    batch = {"inputs": frames, "decoder_tokens": toks}
    torch.testing.assert_close(
        make_prefill_step(cfg, cuda)(params, batch).cpu(),
        make_prefill_step(cfg, "cpu")(cpu_params, batch),
        rtol=1e-5, atol=1e-5)
    states, steps = [], []
    for p, d in ((params, cuda), (cpu_params, "cpu")):
        st = init_decode_state(cfg, 2, 8, d)
        with torch.no_grad():
            st["cross_k"], st["cross_v"] = precompute_cross_kv(
                p, cfg, encode(p, cfg, torch.tensor(frames, device=d)))
        states.append(st)
        steps.append(make_serve_step(cfg, d))
    torch.testing.assert_close(states[0]["cross_k"].cpu(),
                               states[1]["cross_k"], rtol=1e-5, atol=1e-5)
    before = decode_attention_fwd.launches
    for t in range(6):
        (got, states[0]), (want, states[1]) = (
            step(p, st, {"inputs": toks[:, t]})
            for step, p, st in zip(steps, (params, cpu_params), states))
        torch.testing.assert_close(got.cpu(), want, rtol=1e-5, atol=1e-5)
    assert decode_attention_fwd.launches == before + 6 * 2 * cfg.n_layers
    assert int(states[0]["cache_len"]) == 6


def test_whisper_train_step_on_the_card_matches_the_cpu(cuda):
    """Two AdamW steps of whisper SMOKE in float32 (remat on) on the card
    (flash forward and backward, the masks off and on) against the CPU
    (plain versions)."""
    from repro_torch import _tree
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = dataclasses.replace(configs.get("whisper-large-v3", smoke=True),
                              dtype="float32", remat=True)
    opt = AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4, eps=1e-6)
    cpu = init_params(cfg, seed=0, device="cpu")
    card = _tree.tree_map(lambda t: t.to(cuda), cpu)
    params, states = [card, cpu], [adamw_init(card), adamw_init(cpu)]
    steps = [make_train_step(cfg, opt, d) for d in (cuda, "cpu")]
    rng = np.random.default_rng(8)
    for _ in range(2):
        batch = {"inputs": rng.standard_normal(
                     (2, cfg.encoder_seq_len, cfg.d_model), dtype=np.float32),
                 "decoder_tokens": rng.integers(0, cfg.vocab_size, (2, 12)),
                 "labels": rng.integers(0, cfg.vocab_size, (2, 12))}
        before = flash_attention_bwd.launches
        out = [step(p, st, batch)
               for step, p, st in zip(steps, params, states)]
        assert flash_attention_bwd.launches == before + (
            cfg.n_encoder_layers + 2 * cfg.n_layers)
        params = [o[0] for o in out]
        states = [o[1] for o in out]
        torch.testing.assert_close(out[0][2]["loss"].cpu(), out[1][2]["loss"],
                                   rtol=1e-4, atol=1e-4)
        for (name, g), w in zip(_tree.items(params[0]),
                                _tree.leaves(params[1])):
            scale = max(float(w.abs().max()), 1.0)
            assert float((g.cpu() - w).abs().max()) <= 1e-4 * scale, name


def _lag_inputs(seed, b, n, masked, mask_dtype, assign_dtype, dev):
    """A row batch over 2n + 2 bins with bins that several partitions
    share, unassigned (-1) and out-of-range names; ``active`` is one step
    of a [B, 3, N] mask, a strided row view as the engine passes it."""
    rng = np.random.default_rng(seed)
    m = 2 * n + 2
    assign = rng.integers(-1, max(2, n // 4), (b, n))
    assign[::3] = rng.integers(-1, m + 3, assign[::3].shape)
    t = lambda x, dt=torch.float32: torch.tensor(x).to(  # noqa: E731
        device=dev, dtype=dt)
    act = (t(rng.random((b, 3, n)) > 0.2, mask_dtype)[:, 1] if masked
           else None)
    return (t(rng.uniform(0, 2, (b, n))), t(rng.uniform(0, 1, (b, n))),
            t(assign, assign_dtype), t(rng.random((b, n)) > 0.25, mask_dtype),
            t(rng.uniform(0, 2, (b, m))), act)


def _lag_in_order(lag, produced, assign, readable, cap, active):
    """The drain with each bin's backlog summed over its live partitions
    in increasing index with float32 adds from 0, on the CPU: the order
    the kernel sums in, so the two agree bit for bit."""
    lag, produced, assign, readable, cap = (
        x.cpu() for x in (lag, produced, assign, readable, cap))
    b, n = lag.shape
    m = cap.shape[1]
    act = (torch.ones((b, n), dtype=torch.bool) if active is None
           else active.cpu().bool())
    avail = lag + torch.where(act, produced, torch.zeros(()))
    live = readable.bool() & act & (assign >= 0) & (assign < m)
    c = assign.long().clamp(0, m - 1)
    rows = torch.arange(b)
    per_bin = torch.zeros((b, m))
    for j in range(n):
        cur = per_bin[rows, c[:, j]]
        per_bin[rows, c[:, j]] = torch.where(live[:, j], cur + avail[:, j],
                                             cur)
    ratio = (torch.gather(cap, 1, c)
             / torch.clamp(torch.gather(per_bin, 1, c), min=1e-30))
    frac = torch.where(live, torch.clamp(ratio, max=1.0), torch.zeros(()))
    out = torch.clamp(avail * (1.0 - frac), min=0.0)
    return torch.where(act, out, torch.zeros(()))


def _dispatched(fn):
    """``(fn(), the names of the torch operators it dispatched)``."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Record(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.ops.append(str(func))
            return func(*args, **(kwargs or {}))

    with Record() as rec:
        out = fn()
    return out, rec.ops


@pytest.mark.parametrize("n", [1, 31, 32, 33, 256])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("mask_dtype", [torch.bool, torch.int32])
@pytest.mark.parametrize("assign_dtype", [torch.int32, torch.int64])
def test_lag_update_kernel_matches_plain(cuda, n, masked, mask_dtype,
                                         assign_dtype):
    """One launch a call, no cast or copy in the wrapper (it allocates the
    output and nothing else), within 1e-5 of ``lag_update_reference`` and
    bit for bit the in-order drain; 37 rows leave the last block of 8
    warps partial."""
    lag, produced, assign, readable, cap, act = _lag_inputs(
        n + 7 * masked, 37, n, masked, mask_dtype, assign_dtype, cuda)
    before = lag_update_batch.launches
    got, ops = _dispatched(lambda: lag_update_batch(
        lag, produced, assign, readable, cap, active=act))
    torch.cuda.synchronize()
    assert lag_update_batch.launches == before + 1
    assert ops == ["aten.empty.memory_format"], ops
    want = lag_update_reference(lag, produced, assign, readable, cap,
                                m=cap.shape[1], active=act)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert torch.equal(got.cpu(), _lag_in_order(lag, produced, assign,
                                                readable, cap, act))
    one = lag_update_single(lag[3], produced[3], assign[3], readable[3],
                            cap[3], active=None if act is None else act[3])
    assert torch.equal(one, got[3])


def test_lag_update_kernel_refuses_what_it_does_not_take(cuda):
    lag, produced, assign, readable, cap, _ = _lag_inputs(
        1, 4, 8, False, torch.bool, torch.int64, cuda)
    for bad, match in (
            (dict(lag=lag.double()), "lag must be"),
            (dict(assign=assign.to(torch.int16)), "assign must be"),
            (dict(readable=readable.float()), "readable must be"),
            (dict(produced=produced.cpu()), "produced must be"),
            (dict(readable=readable[:, :4]), "readable must be"),
            (dict(cap=cap[:2]), "cap must be")):
        args = dict(lag=lag, produced=produced, assign=assign,
                    readable=readable, cap=cap)
        args.update(bad)
        with pytest.raises(ValueError, match=match):
            lag_update_batch(args.pop("lag"), **args)


PACKERS = ("NF", "NFD", "FF", "FFD", "BF", "BFD", "WF", "WFD",
           "MWF", "MBF", "MWFP", "MBFP")


def _plain_packer(name):
    """The registered packer's plain version (launches nothing)."""
    hyper = get_spec(name).hyperparams
    if "fit" in hyper:
        return lambda *a, **k: modified_any_fit_plain(
            *a, fit=hyper["fit"], sort_key=hyper["sort_key"], **k)
    return lambda *a, **k: pack_plain(
        *a, strategy=hyper["strategy"], decreasing=hyper["decreasing"], **k)


def _pack_instances(seed, rows, n, masked, dev):
    """Rows with tied speeds, oversized items (w > C), a few large
    consumers, and ``prev`` holding -1, lower negatives and names past
    the 2n + 2 of the name range."""
    rng = np.random.default_rng(seed)
    speeds = rng.uniform(0, 1.0, (rows, n)).astype(np.float32)
    speeds[::2] = np.round(speeds[::2] * 4) / 4
    speeds[1::3, 0] = 1.3
    prev = rng.integers(-3, 2 * n + 5, (rows, n))
    prev[3::4] = rng.integers(0, 3, prev[3::4].shape)
    act = (rng.random((rows, n)) > 0.3) if masked else None
    return (torch.tensor(speeds, device=dev), torch.tensor(prev, device=dev),
            None if act is None else torch.tensor(act, device=dev))


def _assert_packed_equal(got, want):
    for f in ("bin_of", "names", "n_bins"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and torch.equal(a, b), f
    assert got.loads.dtype == want.loads.dtype == torch.float32
    assert torch.equal(got.loads.view(torch.int32),
                       want.loads.view(torch.int32)), "loads (bits)"


@pytest.mark.parametrize("n,rows", [(7, 64), (32, 64), (256, 6)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", PACKERS)
def test_pack_kernel_matches_plain(cuda, name, masked, n, rows):
    speeds, prev, act = _pack_instances(n + masked, rows, n, masked, cuda)
    before = (pack_rows.launches, select_slot_grid.launches)
    got = get_spec(name).packer(speeds, prev, 1.0, active=act)
    torch.cuda.synchronize()
    assert (pack_rows.launches, select_slot_grid.launches) == (
        before[0] + 1, before[1])
    _assert_packed_equal(got, _plain_packer(name)(speeds, prev, 1.0,
                                                  active=act))


@pytest.mark.parametrize("name", ["BFD", "MBF"])
def test_pack_kernel_at_its_width_limit(cuda, name):
    """One row of PACK_MAX_N items: one block's whole shared memory."""
    speeds, prev, act = _pack_instances(11, 1, PACK_MAX_N, True, cuda)
    got = get_spec(name).packer(speeds, prev, 1.0, active=act)
    _assert_packed_equal(got, _plain_packer(name)(speeds, prev, 1.0,
                                                  active=act))


def test_pack_kernel_refuses_rows_past_its_width_limit(cuda):
    n = PACK_MAX_N + 1
    speeds = torch.zeros((1, n), device=cuda)
    prev = torch.full((1, n), -1, device=cuda)
    before = pack_rows.launches
    for kw in (dict(strategy="best"), dict(strategy="best",
                                           sort_key="cumulative")):
        with pytest.raises(PackWidthError, match=f"PACK_MAX_N = {PACK_MAX_N}"):
            pack_rows(speeds, prev, 1.0, **kw)
    assert issubclass(PackWidthError, ValueError)
    assert pack_rows.launches == before


@pytest.mark.parametrize("m", [33, 65, 513])
@pytest.mark.parametrize("strategy", ["first", "best", "worst"])
@pytest.mark.parametrize("masked", [False, True])
def test_select_kernel_matches_plain(cuda, m, strategy, masked):
    rng = np.random.default_rng(m)
    b, n = 64, 8
    # a coarse load grid makes ties common (they break to the lowest slot)
    loads = (rng.integers(0, 9, (b, n, m)) / 8).astype(np.float32)
    w = (rng.integers(0, 5, (b, n)) / 8).astype(np.float32)
    k = rng.integers(0, m + 2, (b, n)).astype(np.int32)
    cap = np.ones((b, n), np.float32)
    act = (rng.random((b, n)) > 0.2) if masked else None
    t = [torch.tensor(x, device=cuda) for x in (loads, w, k, cap)]
    tact = None if act is None else torch.tensor(act, device=cuda)
    before = select_slot_grid.launches
    got = select_slot_grid(*t, strategy=strategy, active=tact)
    torch.cuda.synchronize()
    assert select_slot_grid.launches == before + 1
    assert torch.equal(got, select_slot_plain(*t, strategy=strategy,
                                              active=tact))


def _chain_states(seed, rows, k, n, masked, dev):
    """Chains in random states over ``m = 2n + 2`` names (loads and
    counts from the assignment, inactive items excluded), speeds on a
    coarse grid so that moves tie, lambda 0 or 4, a cost and a best cost
    of their own; and the step's read-only inputs."""
    rng = np.random.default_rng(seed)
    c, m = rows * k, 2 * n + 2
    speeds = (np.round(rng.uniform(0, 0.9, (c, n)) * 8) / 8).astype(
        np.float32)
    speeds[:, 0] = 1.25                              # oversized items
    assign = rng.integers(0, m, (c, n)).astype(np.int32)
    prev = rng.integers(-1, m, (c, n)).astype(np.int32)
    act = rng.random((c, n)) > 0.2 if masked else np.ones((c, n), bool)
    w = np.where(act, speeds, 0).astype(np.float32)
    loads = np.zeros((c, m), np.float32)
    counts = np.zeros((c, m), np.int32)
    for i in range(c):
        np.add.at(loads[i], assign[i], w[i])
        np.add.at(counts[i], assign[i], act[i].astype(np.int32))
    cost = rng.uniform(n / 2, n, c).astype(np.float32)
    lam = np.tile(np.float32([0.0, 4.0]), c)[:c]
    t = lambda x: torch.tensor(x, device=dev)  # noqa: E731
    state = ChainState(t(assign), t(loads), t(counts), t(cost),
                       t(cost + 0.5), t(assign))
    return state, (t(w), t(prev), t(lam), torch.ones(c, device=dev),
                   t(act.astype(np.int32)) if masked else None)


@pytest.mark.parametrize("rows,k,n", [(64, 6, 32), (1, 28, 256), (3, 4, 5)])
@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("coarse", [False, True])
def test_anneal_step_kernel_matches_plain(cuda, rows, k, n, masked, coarse):
    """48 steps of the kernel and of the plain version from the same
    state: every state tensor equal bit for bit after each step.  Coarse
    draws make moves tie in z and the "stay" draw tie the best move."""
    got, (speeds, prev, lam, cap, act) = _chain_states(
        n + masked, rows, k, n, masked, cuda)
    want = ChainState(*(x.clone() for x in got))
    start = got.assign.clone()
    steps = 48
    gen = torch.Generator(cuda).manual_seed(n)
    u = torch.rand((steps, k, n * (2 * n + 2) + 1), generator=gen,
                   device=cuda).clamp_(min=1e-30)
    gumbel = -torch.log(-torch.log(u))
    if coarse:
        gumbel = torch.round(gumbel * 2) / 2
    temps = torch.logspace(0, -2, steps, device=cuda)
    before = anneal_step.launches
    for t in range(steps):
        anneal_step(got, speeds, prev, lam, cap, gumbel[t], temps, t,
                    active=act)
        anneal_step_reference(want, speeds, prev, lam, cap, gumbel[t], temps,
                              t, active=act)
        for name, a, b in zip(ChainState._fields, got, want):
            assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
                f"step {t}: {name}")
    torch.cuda.synchronize()
    assert anneal_step.launches == before + steps
    assert not torch.equal(got.assign, start)        # moves were made


@pytest.mark.parametrize("k,n,m", [
    (7, 9, 20), (5, 5, 7), (33, 3, 5), (6144, 32, 66), (13, 130, 262),
    (2, 1, 1), (3, 301, 604)])
@pytest.mark.parametrize("masked", [False, True])
def test_move_delta_kernel_matches_plain(cuda, k, n, m, masked):
    """Ragged and unaligned planes (N*M not a multiple of 4, chains that
    start off a 16-byte boundary, chains split over blocks): bit for
    bit."""
    rng = np.random.default_rng(k + n + m)
    speeds = rng.uniform(0, 1.3, (k, n)).astype(np.float32)
    assign = rng.integers(0, m, (k, n)).astype(np.int32)
    prev = rng.integers(-1, m, (k, n)).astype(np.int32)
    act = rng.random((k, n)) > 0.2
    loads = np.zeros((k, m), np.float32)
    counts = np.zeros((k, m), np.int32)
    for i in range(k):
        np.add.at(loads[i], assign[i], np.where(act[i], speeds[i], 0))
        np.add.at(counts[i], assign[i], act[i].astype(np.int32))
    lam = np.tile(np.float32([0.0, 4.0]), k)[:k]
    args = [torch.tensor(x, device=cuda) for x in (
        loads, counts, assign, speeds, prev, lam, np.ones(k, np.float32))]
    tact = torch.tensor(act, device=cuda) if masked else None
    before = move_delta_batch.launches
    got = move_delta_batch(*args, active=tact)
    torch.cuda.synchronize()
    assert move_delta_batch.launches == before + 1
    assert torch.equal(got, move_delta_reference(*args, active=tact))


LOOP_STRATS = [("next", False), ("next", True), ("first", False),
               ("first", True), ("best", False), ("best", True),
               ("worst", False), ("worst", True)]


def _loop_case(seed, b, t, n, masked, dev):
    rng = np.random.default_rng(seed)
    rates = rng.uniform(0, 1.2, (b, t, n)).astype(np.float32)
    rates[::2] = np.round(rates[::2] * 4) / 4        # ties
    act = torch.tensor(rng.random((b, t, n)) > 0.25, device=dev) \
        if masked else None
    lag0 = torch.tensor(rng.uniform(0, 2, (b, n)).astype(np.float32),
                        device=dev)
    return torch.tensor(rates, device=dev), act, lag0


def _assert_loop_equal(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == b.dtype and a.shape == b.shape, i
        assert torch.equal(a.view(torch.int32), b.view(torch.int32)), (
            f"output {i}")


@pytest.mark.parametrize("n", range(1, 15))
@pytest.mark.parametrize("masked", [False, True])
def test_loop_fused_kernel_matches_plain(cuda, n, masked):
    """The 8 heuristics over 40 streams (a partial warp) x 37 steps (a
    partial ring stage; rows of T * N that are not a multiple of 16
    bytes) with an initial lag, assignments recorded: bit for bit."""
    rates, act, lag0 = _loop_case(n + 20 * masked, 40, 37, n, masked, cuda)
    kw = dict(strategies=[s for s, _ in LOOP_STRATS],
              decreasing=[d for _, d in LOOP_STRATS], capacity=1.0, dt=0.8,
              migration_steps=2, active=act, initial_lag=lag0,
              record_assign=True)
    before = loop_fused.launches
    got = loop_fused(rates, **kw)
    torch.cuda.synchronize()
    assert loop_fused.launches == before + 1
    _assert_loop_equal(got, loop_fused_reference(rates, **kw))


@pytest.mark.parametrize("policies", [3, 12])
def test_loop_fused_kernel_at_other_policy_counts(cuda, policies):
    """Fewer policies than a block's 8 warps, and more (two blocks over
    the same streams), without recording: bit for bit."""
    rates, act, lag0 = _loop_case(policies, 70, 64, 14, True, cuda)
    strats = [LOOP_STRATS[i % 8] for i in range(3, 3 + policies)]
    kw = dict(strategies=[s for s, _ in strats],
              decreasing=[d for _, d in strats], active=act,
              initial_lag=lag0)
    _assert_loop_equal(loop_fused(rates, **kw),
                       loop_fused_reference(rates, **kw))


@pytest.mark.parametrize("masked", [False, True])
def test_sweep_streams_on_the_card_equal_the_cpu(cuda, masked):
    """The stream scans, every step one ``pack_rows`` launch an
    algorithm, against the same scans on the CPU (the plain packers):
    bins and migrations exact, R-scores within 1e-5."""
    from repro_torch.core.pack import sweep_streams

    rng = np.random.default_rng(31)
    sp = torch.tensor(rng.uniform(0, 0.6, (16, 40, 32)).astype(np.float32))
    act = torch.tensor(rng.uniform(size=sp.shape) < 0.85) if masked else None
    pack_rows.launches = 0
    got = sweep_streams(PACKERS, sp.to(cuda), 1.0,
                        None if act is None else act.to(cuda), device=cuda)
    assert pack_rows.launches == len(PACKERS) * sp.shape[1]
    want = sweep_streams(PACKERS, sp, 1.0, act, device="cpu")
    assert torch.equal(got.bins.cpu(), want.bins)
    assert torch.equal(got.migrations.cpu(), want.migrations)
    torch.testing.assert_close(got.rscores.cpu(), want.rscores, rtol=0,
                               atol=1e-5)


def test_fleet_padded_equals_direct_on_the_card(cuda):
    """A ragged fleet cut from one tensor on the card, padded into
    buckets, against ``sweep_lag`` at each group's own shape on the card:
    integers exact, lag within 1e-5."""
    from repro_torch.fleet import FleetConfig, FleetRunner
    from repro_torch.lagsim import LagSimConfig, sweep_lag

    rng = np.random.default_rng(32)
    rates = torch.tensor(rng.uniform(0, 0.7, (6, 48, 16)).astype(
        np.float32)).to(cuda)
    act = torch.tensor(rng.uniform(size=rates.shape) < 0.9).to(cuda)
    cut = ((48, 16), (30, 5), (17, 7), (48, 3), (24, 16), (40, 12))
    pairs = [(rates[i, :t, :n], act[i, :t, :n]) for i, (t, n) in
             enumerate(cut)]
    policies = ("BFD", "MBF", "MWFP", "KEDA_LAG")
    cfg = LagSimConfig(use_kernel=True)
    runner = FleetRunner(FleetConfig(t_buckets=(24, 48), n_buckets=(8, 16)))
    res = runner.simulate(policies, pairs, cfg, device=cuda)
    for i, (sp, ac) in enumerate(pairs):
        solo = sweep_lag(policies, sp[None], cfg, active=ac[None],
                         device=cuda)
        for f in ("consumers", "migrations", "unreadable"):
            np.testing.assert_array_equal(getattr(res, f)[i],
                                          getattr(solo, f)[:, 0].cpu().numpy())
        for f in ("lag_total", "lag_max"):
            np.testing.assert_allclose(getattr(res, f)[i],
                                       getattr(solo, f)[:, 0].cpu().numpy(),
                                       rtol=0, atol=1e-5)
    assert runner.stats()["buckets"] == {"24x8": 1, "24x16": 1, "48x8": 2,
                                         "48x16": 2}


def _obs_config(**over):
    from repro_torch.lagsim import LagSimConfig
    from repro_torch.telemetry import (AlertConfig, SketchConfig,
                                       TelemetryConfig, default_rules)

    return LagSimConfig(use_kernel=True, telemetry=TelemetryConfig(
        sketch=SketchConfig(), alerts=AlertConfig(rules=default_rules())),
        **over)


def _masked(seed, shape):
    rng = np.random.default_rng(seed)
    act = rng.uniform(size=shape) < 0.85
    return (torch.tensor(np.where(act, rng.uniform(0, 0.7, shape), 0).astype(
        np.float32)), torch.tensor(act))


@pytest.mark.parametrize("policy", ("BFD", "MBF", "KEDA_LAG",
                                    "RATE_THRESHOLD"))
def test_zero_friction_is_bit_equal_on_the_card(cuda, policy):
    """Behind the zero-friction control plane a policy equals its bare run
    on the card bit for bit (drain and packing kernels on)."""
    import dataclasses

    from repro_torch.lagsim import ControlPlaneConfig, LagSimConfig, sweep_lag

    rates, act = _masked(41, (32, 40, 16))
    cfg = LagSimConfig(use_kernel=True)
    bare = sweep_lag((policy,), rates.to(cuda), cfg, active=act.to(cuda),
                     device=cuda)
    wrapped = sweep_lag((policy,), rates.to(cuda), dataclasses.replace(
        cfg, control_plane=ControlPlaneConfig()), active=act.to(cuda),
        device=cuda)
    for f in ("lag_total", "lag_max", "consumers", "migrations",
              "unreadable"):
        assert torch.equal(getattr(bare, f), getattr(wrapped, f)), f


@pytest.mark.parametrize("policies", (("BFD", "KEDA_LAG_REAL"),
                                      ("MBF", "CLOUD_RUN_CPU_LAG")))
def test_telemetry_on_equals_off_on_the_card(cuda, policies):
    """Frames, a sketch and alerts on leave every trajectory as it is with
    them off, bit for bit, and their states match the CPU's run
    (integers and incident tables exact, floats within 1e-5)."""
    import dataclasses

    from repro_torch.lagsim import sweep_lag

    rates, act = _masked(42, (32, 40, 12))
    on_cfg = _obs_config()
    off = sweep_lag(policies, rates.to(cuda), dataclasses.replace(
        on_cfg, telemetry=None), active=act.to(cuda), device=cuda)
    on = sweep_lag(policies, rates.to(cuda), on_cfg, active=act.to(cuda),
                   device=cuda)
    cpu = sweep_lag(policies, rates, on_cfg, active=act, device="cpu")
    for f in ("lag_total", "lag_max", "consumers", "migrations",
              "unreadable"):
        assert torch.equal(getattr(off, f), getattr(on, f)), f
    for f in ("count", "open_step", "close_step", "active"):
        assert torch.equal(getattr(on.incidents, f).cpu(),
                           getattr(cpu.incidents, f)), f
    for f in ("count", "hist"):
        assert torch.equal(getattr(on.sketch, f).cpu(),
                           getattr(cpu.sketch, f)), f
    for f in ("mean", "vmin", "vmax", "ewma"):
        torch.testing.assert_close(getattr(on.sketch, f).cpu(),
                                   getattr(cpu.sketch, f), rtol=1e-5,
                                   atol=1e-5)


def test_padded_sketches_equal_direct_on_the_card(cuda):
    """A ragged fleet with a sketch and alerts on, padded into buckets on
    the card: each scenario's states equal its own run's (counts,
    histograms and incident tables exact, floats within 1e-5)."""
    from repro_torch.fleet import FleetConfig, FleetRunner
    from repro_torch.lagsim import sweep_lag

    rates, act = _masked(43, (5, 48, 16))
    rates, act = rates.to(cuda), act.to(cuda)
    cut = ((48, 16), (30, 5), (17, 7), (40, 12), (24, 16))
    pairs = [(rates[i, :t, :n], act[i, :t, :n])
             for i, (t, n) in enumerate(cut)]
    policies = ("BFD", "MBF", "KEDA_LAG_REAL")
    cfg = _obs_config(max_consumers=16)
    runner = FleetRunner(FleetConfig(t_buckets=(24, 48), n_buckets=(8, 16)))
    res = runner.simulate(policies, pairs, cfg, device=cuda)
    for i, (sp, ac) in enumerate(pairs):
        solo = sweep_lag(policies, sp[None], cfg, active=ac[None],
                         device=cuda)
        for f in ("count", "hist"):
            np.testing.assert_array_equal(
                getattr(res.sketch[i], f),
                getattr(solo.sketch, f)[:, 0].cpu().numpy(), f)
        for f in ("mean", "m2", "vmin", "vmax", "ewma", "ewma_w"):
            np.testing.assert_allclose(
                getattr(res.sketch[i], f),
                getattr(solo.sketch, f)[:, 0].cpu().numpy(), rtol=1e-5,
                atol=1e-5)
        for f in ("tick", "count", "open_step", "close_step", "active",
                  "consec"):
            np.testing.assert_array_equal(
                getattr(res.incidents[i], f),
                getattr(solo.incidents, f)[:, 0].cpu().numpy(), f)


def test_storm_scatter_is_deterministic_on_the_card(cuda):
    """The warm-up storm's touched-consumer scatter (duplicate ids in a
    row) gives the same warming countdowns and trajectories in 3 runs."""
    from repro_torch.lagsim import ControlPlaneConfig, LagSimConfig, sweep_lag

    rates, act = _masked(44, (64, 40, 32))
    cfg = LagSimConfig(use_kernel=True, control_plane=ControlPlaneConfig(
        polling_interval=2, observation_delay=1, actuation_delay=1,
        cooldown_period=2, max_replicas=8, warmup_steps=3))
    runs = [sweep_lag(("MBF", "KEDA_LAG"), rates.to(cuda), cfg,
                      active=act.to(cuda), device=cuda) for _ in range(3)]
    assert int(runs[0].unreadable.sum()) > 0
    for other in runs[1:]:
        for f in ("lag_total", "consumers", "migrations", "unreadable"):
            assert torch.equal(getattr(runs[0], f), getattr(other, f)), f


def test_oracle_rows_on_the_card_equal_the_cpu_transform(cuda):
    """Each genome's rows drawn on the card under the search's scenario
    seed, against the CPU transform of the same draws copied to the
    host: masks exact, rates within 1e-5."""
    from repro_torch.core import scenarios as tsc
    from repro_torch.scenarios import genome as tg
    from repro_torch.scenarios import search as ts

    cfg = ts.SearchConfig(pop_size=4, scenarios_per_genome=2, iters=96,
                          n=6)
    spec = tsc.family_spec("adversarial")
    draws = ts._Draws(None, 7, cuda, len(spec.knobs), cfg)
    pop = tg.random_population(spec, 3, 4, device=cuda)
    pop[1, spec.knob_names.index("churn_p")] = 0.15
    sp, ac = ts._scenario_oracle(spec, cfg, draws)(pop)
    assert sp.device.type == cuda.type and sp.shape == (8, 96, 6)
    for i, g in enumerate(tg.repair_genome(spec, pop).cpu().numpy()):
        knobs = tg.genome_knobs(spec, g)
        gen = torch.Generator(device=cuda).manual_seed(draws.scenario_seed)
        raw = tsc.adversarial_draws(gen, 2, 96, 6, churn_p=knobs.pop(
            "churn_p"))
        want_sp, want_ac = tsc.adversarial_masked(
            {k: v.cpu() for k, v in raw.items()}, **knobs)
        assert torch.equal(ac[2 * i:2 * i + 2].cpu(), want_ac)
        torch.testing.assert_close(sp[2 * i:2 * i + 2].cpu(), want_sp,
                                   rtol=1e-5, atol=1e-5)


def test_attack_on_the_card_is_bit_identical(cuda):
    """One seed, two searches on the card (drain and packing kernels
    on): the same history, witness genome and evals."""
    from repro_torch import api
    from repro_torch.fleet import FleetRunner
    from repro_torch.lagsim import LagSimConfig

    cfg = api.SearchConfig(pop_size=6, generations=3, iters=48, n=6)
    sim = LagSimConfig(use_kernel=True)
    runs = [api.attack("MBF", config=cfg, sim=sim, seed=5,
                       fleet=FleetRunner(), device=cuda) for _ in range(2)]
    a, b = runs
    assert a.history == b.history
    assert a.witness_genome == b.witness_genome
    assert (a.evals, a.generations_run, a.baseline_fitness) == (
        b.evals, b.generations_run, b.baseline_fitness)


@pytest.mark.parametrize("ext", ("npz", "json"))
def test_replay_equals_direct_on_the_card(cuda, tmp_path, ext):
    from repro_torch import api
    from repro_torch.scenarios import resample_trace, save_trace, seed_trace

    tr = seed_trace("kafka_lifecycle_churn", batch=3, iters=64, n=8,
                    device=cuda)
    path = str(tmp_path / f"t.{ext}")
    save_trace(tr, path)
    pols = ("MBF", "BFD", "KEDA_LAG")
    for iters in (None, 32):
        out = api.replay(path, policies=pols, iters=iters, method="linear",
                         use_kernel=True, device=cuda)
        want = tr if iters is None else resample_trace(tr, iters, "linear")
        direct = api.simulate(want.rates, policies=pols, active=want.active,
                              capacity=want.capacity, use_kernel=True,
                              device=cuda)
        for f in ("lag_total", "consumers", "migrations"):
            assert (getattr(out.result, f).tobytes()
                    == getattr(direct, f).tobytes()), f


def test_py_packers_equal_the_torch_packers_on_the_card(cuda):
    """``api.pack`` on both backends, speeds quantized to k/1024 so that
    every load sum is exact in float32."""
    from repro_torch import api
    from repro_torch.registry import PACKER_FAMILIES, list_policies

    rng = np.random.default_rng(9)
    speeds = np.round(rng.uniform(0.01, 0.3, 256) * 1024) / 1024
    prev = rng.integers(-1, 40, 256).astype(np.int32)
    for name in list_policies(family=PACKER_FAMILIES, backend="py"):
        card = api.pack(speeds, 1.0, algorithm=name, prev=prev,
                        backend="torch", device=cuda)
        py = api.pack({j: float(w) for j, w in enumerate(speeds)}, 1.0,
                      algorithm=name,
                      prev={j: int(c) for j, c in enumerate(prev) if c >= 0})
        assert (card.n_bins, card.assignment) == (py.n_bins, py.assignment)
        assert card.loads == {c: float(np.float32(v))
                              for c, v in py.loads.items()}
