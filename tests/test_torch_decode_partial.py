"""A decode over a cache split along its sequence, shard by shard, against
the JAX reference's decode kernel over the whole cache.

Each shard's part comes from ``decode_attention_partial`` (its plain
version on CPU tensors: the CUDA kernel's partial entry is held against
it by ``chip_smoke.py``'s path V on the card); the parts are merged with
the arithmetic of ``models.attention._merge`` (the row max, then the
rescaled sums and outputs: ``chip_smoke.merge_partials``, which path V1
runs on the card) and, on the tailed route, ``_combine``.  The
whole is held against the reference's ``decode_attention_fwd`` run in
interpret mode, as the reference's own tests run it on the CPU, from the
same numpy inputs: within 1e-5 in float32 and 2e-2 in bfloat16.
"""
import functools
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.kernels.decode_attention import \
    decode_attention_fwd as j_decode  # noqa: E402
from repro.models.attention import NEG_INF as J_NEG_INF  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_partial, decode_attention_partial_plain)
from repro_torch.kernels.ref import NEG_INF  # noqa: E402
from repro_torch.models.attention import _combine  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 1e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}
B, KV, G, HD = 2, 2, 4, 32
S = 64                     # the whole cache: 64 positions, blocks of 16
BLOCK_S = 16


@functools.lru_cache(maxsize=None)
def _arrays(seed: int, dtype: str, s: int = S):
    """q (B, KV, G, HD) and K/V (B, KV, s, HD), standard normal, rounded to
    ``dtype`` on the JAX side; the torch copies carry the same values."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    js = tuple(jnp.asarray(rng.standard_normal(sh, dtype=np.float32)
                           ).astype(jdt)
               for sh in ((B, KV, G, HD), (B, KV, s, HD), (B, KV, s, HD)))
    ts = tuple(torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in js)
    return js, ts


@functools.lru_cache(maxsize=None)
def _reference(seed: int, dtype: str, fill: int):
    (jq, jk, jv), _ = _arrays(seed, dtype)
    return np.asarray(j_decode(jq, jk, jv, jnp.int32(fill), block_s=BLOCK_S,
                               interpret=True), np.float32)


@pytest.fixture(scope="module")
def chip_smoke():
    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    return chip_smoke


def _shard_parts(q, k, v, fill: int, shards: int):
    """Each shard's ``(m, l, acc)`` at its local fill ``fill - offset``."""
    s_l = k.shape[2] // shards
    return [decode_attention_partial(
        q, k[:, :, j * s_l:(j + 1) * s_l], v[:, :, j * s_l:(j + 1) * s_l],
        torch.tensor(fill - j * s_l, dtype=torch.int32))
        for j in range(shards)]


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol, rtol=tol)


@pytest.mark.parametrize("shards", [1, 2, 4, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fill", [0, 37, 63, 100])
def test_sharded_decode_merges_to_the_reference(chip_smoke, shards, dtype,
                                                fill):
    """Fill 37 over 4 shards of 16: two full shards (local fills 37 and
    21, at or past the shard's end), one partly filled (5), one empty
    (-11); fill 100 runs past the cache (every shard full), fill 0 leaves
    every shard but the first empty."""
    _, (q, k, v) = _arrays(0, dtype)
    parts = _shard_parts(q, k, v, fill, shards)
    for m, l_, acc in parts:
        assert m.dtype == l_.dtype == acc.dtype == torch.float32
        assert torch.isfinite(m).all() and torch.isfinite(acc).all()
    m, l_, acc = chip_smoke.merge_partials(parts)
    out = (acc / l_.clamp(min=1e-30)[..., None]).to(q.dtype)
    assert not torch.isnan(out).any()
    _close(out, _reference(0, dtype, fill), DTYPES[dtype][2])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_an_empty_shard_is_the_reference_neg_inf_with_nothing_summed(dtype):
    """A shard none of whose positions is attended (local fill < 0) holds
    the reference's finite NEG_INF as its row max, and zero sums and
    outputs; a shard attended to its end (fill >= S_l) equals the same
    shard at fill S_l - 1 bit for bit."""
    _, (q, k, v) = _arrays(1, dtype)
    assert NEG_INF == J_NEG_INF
    for fill in (-1, -40):
        m, l_, acc = decode_attention_partial(q, k[:, :, :16], v[:, :, :16],
                                              fill)
        assert (m == NEG_INF).all() and not l_.any() and not acc.any()
    full = decode_attention_partial(q, k[:, :, :16], v[:, :, :16], 15)
    for fill in (16, 1000):
        for a, b in zip(decode_attention_partial(q, k[:, :, :16],
                                                 v[:, :, :16], fill), full):
            assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_a_shard_row_max_and_sum_give_the_reference_logsumexp(dtype):
    """``m + log l`` of a shard is the logsumexp of the reference's scaled
    scores over the shard's attended positions."""
    (jq, jk, _), (q, k, v) = _arrays(2, dtype)
    fill = 20
    m, l_, _ = decode_attention_partial(q, k, v, fill)
    s = jnp.einsum("bngd,bnsd->bngs", jq.astype(jnp.float32),
                   jk.astype(jnp.float32)) * HD ** -0.5
    want = jax.nn.logsumexp(s[..., :fill + 1], axis=-1)
    np.testing.assert_allclose((m + torch.log(l_)).numpy(),
                               np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("shards", [2, 4, 16])
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("main_len,tail_len", [(0, 0), (0, 5), (32, 5)])
def test_tailed_route_merges_to_the_reference(chip_smoke, shards, dtype,
                                              main_len, tail_len):
    """The tailed route: the sharded main cache's parts merged at the main
    fill ``main_len - 1``, then combined with the local tail's part at
    ``tail_len``.  With ``main_len`` 0 every main shard is empty (before
    the first flush), and the result is the tail's alone: no NaN.  The
    reference attends ``main[0:main_len] ++ tail[0:tail_len + 1]`` as one
    cache of ``main_len + W`` positions."""
    w = 16
    (jq, jm, jvm), (q, km, vm) = _arrays(3, dtype)
    (_, jt, jvt), (_, kt, vt) = _arrays(4, dtype, w)
    main = chip_smoke.merge_partials(_shard_parts(q, km, vm, main_len - 1,
                                                  shards))
    if main_len == 0:
        assert (main[0] == NEG_INF).all() and not main[1].any()
    tail = decode_attention_partial(q, kt, vt, tail_len)
    out = _combine(main, tail).to(q.dtype)
    assert not torch.isnan(out).any()
    jk = jnp.concatenate([jm[:, :, :main_len], jt], axis=2)
    jv = jnp.concatenate([jvm[:, :, :main_len], jvt], axis=2)
    want = np.asarray(j_decode(jq, jk, jv, jnp.int32(main_len + tail_len),
                               block_s=BLOCK_S, interpret=True), np.float32)
    _close(out, want, DTYPES[dtype][2])


def test_the_plain_version_counts_no_launch():
    _, (q, k, v) = _arrays(0, "float32")
    before = decode_attention_partial.launches
    got = decode_attention_partial(q, k, v, 10)
    want = decode_attention_partial_plain(q, k, v, 10)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert decode_attention_partial.launches == before
    assert "decode_attention_partial" in _build.launch_counts()


def test_the_wrapper_rejects_mismatched_shapes():
    _, (q, k, v) = _arrays(0, "float32")
    with pytest.raises(ValueError):
        decode_attention_partial(q, k[:, :1], v, 0)
    with pytest.raises(ValueError):
        decode_attention_partial(q, k, v[:, :, :8], 0)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_chip_check_takes_the_plain_partial_and_rejects_faults(chip_smoke,
                                                               dtype):
    """Path V1's verdict (``chip_smoke.partial_close``) passes the plain
    version against itself, empty rows included, and rejects an empty row
    whose max leaks the split kernel's -inf, a sum 5% off (over the bf16
    tolerance, 2%), and an output row dropped."""
    _, (q, k, v) = _arrays(5, dtype)
    want = decode_attention_partial_plain(q, k[:, :, :16], v[:, :, :16], 7)
    empty = decode_attention_partial_plain(q, k[:, :, :16], v[:, :, :16], -1)
    assert chip_smoke.partial_close(want, want, dtype, "plain") == 0.0
    assert chip_smoke.partial_close(empty, empty, dtype, "empty") == 0.0
    m, l_, acc = want
    leak = (torch.full_like(empty[0], float("-inf")), *empty[1:])
    faults = {"-inf leaks": (leak, empty),
              "sum off": ((m, l_ * 1.05, acc), want),
              "row dropped": ((m, l_, acc.index_fill(2, torch.tensor([1]),
                                                     0.0)), want)}
    for name, (got, ref) in faults.items():
        with pytest.raises(chip_smoke.SmokeFailure):
            chip_smoke.partial_close(got, ref, dtype, name)
