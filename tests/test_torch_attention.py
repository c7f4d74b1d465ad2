"""The port's attention kernels against the JAX reference.

``flash_attention_fwd`` and ``decode_attention_fwd`` run their plain
versions on CPU tensors; the CUDA kernels are held against those plain
versions by ``chip_smoke.py`` and ``tests/test_torch_cuda.py`` on the
card.  Here the plain versions are held against the reference's Pallas
kernels in interpret mode and against its jnp oracles
(``repro.kernels.ref``), over the reference tests' own shape sweeps, at
their tolerances: 2e-5 in float32, 2e-2 in bfloat16.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels import ref as jref  # noqa: E402
from repro.kernels.decode_attention import \
    decode_attention_fwd as j_decode  # noqa: E402
from repro.kernels.flash_attention import \
    flash_attention_fwd as j_flash  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.decode_attention import (  # noqa: E402
    decode_attention_fwd, decode_attention_plain, decode_splits)
from repro_torch.kernels.flash_attention import \
    flash_attention_fwd  # noqa: E402

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(seed, shapes, dtype):
    """Standard-normal numpy arrays, rounded to ``dtype`` on the JAX side;
    the torch copies carry the same values."""
    rng = np.random.default_rng(seed)
    jdt, tdt, _ = DTYPES[dtype]
    js = [jnp.asarray(rng.standard_normal(s, dtype=np.float32)).astype(jdt)
          for s in shapes]
    ts = [torch.tensor(np.asarray(x, np.float32)).to(tdt) for x in js]
    return js, ts


def _close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=tol, rtol=tol)


# the reference's sweep, tests/test_kernels.py:27-32
FLASH_SHAPES = [
    (1, 4, 4, 128, 128, 64),       # MHA square
    (2, 8, 2, 128, 256, 64),       # GQA, rectangular
    (1, 4, 1, 256, 256, 128),      # MQA, bigger head
    (1, 2, 2, 64, 192, 32),        # uneven kv blocks
]


@pytest.mark.parametrize("b,h,kv,sq,skv,hd", FLASH_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_matches_reference(b, h, kv, sq, skv, hd, dtype, causal):
    (jq, jk, jv), (q, k, v) = _inputs(
        0, [(b, h, sq, hd), (b, kv, skv, hd), (b, kv, skv, hd)], dtype)
    tol = DTYPES[dtype][2]
    got = flash_attention_fwd(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, j_flash(jq, jk, jv, causal=causal, block_q=64, block_k=64,
                        interpret=True), tol)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), tol)


@pytest.mark.parametrize("causal", [True, False])
def test_flash_plain_odd_length(causal):
    """Sq = Skv = 100, which the Pallas wrapper's blocks cannot tile: the
    port takes any length (the CUDA kernel masks the ragged tail)."""
    (jq, jk, jv), (q, k, v) = _inputs(
        1, [(1, 4, 100, 32), (1, 2, 100, 32), (1, 2, 100, 32)], "float32")
    got = flash_attention_fwd(q, k, v, causal=causal)
    _close(got, jref.attention_ref(jq, jk, jv, causal=causal), 2e-5)


# the reference's sweep, tests/test_kernels.py:66-70; fill 200 on the
# 128-long cache attends to the whole cache (cache_len >= S)
DECODE_SHAPES = [
    (2, 2, 4, 256, 64),    # GQA
    (1, 4, 1, 128, 128),   # MHA
    (3, 1, 8, 512, 64),    # MQA
]


@pytest.mark.parametrize("b,kv,g,s,hd", DECODE_SHAPES)
@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("fill", [0, 7, 200])
def test_decode_plain_matches_reference(b, kv, g, s, hd, dtype, fill):
    (jq, jk, jv), (q, k, v) = _inputs(
        2, [(b, kv, g, hd), (b, kv, s, hd), (b, kv, s, hd)], dtype)
    tol = DTYPES[dtype][2]
    clen = torch.tensor(fill, dtype=torch.int32)
    got = decode_attention_fwd(q, k, v, clen)
    assert got.dtype == q.dtype and got.shape == q.shape
    _close(got, j_decode(jq, jk, jv, jnp.int32(fill), block_s=64,
                         interpret=True), tol)
    _close(got, jref.decode_attention_ref(jq, jk, jv, jnp.int32(fill)), tol)
    # an int cache_len gives the same result as a tensor
    torch.testing.assert_close(decode_attention_fwd(q, k, v, fill), got,
                               rtol=0, atol=0)


def test_plain_versions_do_not_count_launches():
    _build.reset_launches()
    (_, _, _), (q, k, v) = _inputs(3, [(1, 2, 8, 16)] * 3, "float32")
    flash_attention_fwd(q, k, v)
    decode_attention_fwd(q[:, :, :1], k, v, 3)
    counts = _build.launch_counts()
    assert counts["flash_attention_fwd"] == 0
    assert counts["decode_attention_fwd"] == 0


@pytest.mark.parametrize("call", ("flash", "decode"))
def test_wrappers_reject_bad_shapes(call):
    q = torch.zeros(1, 4, 8, 16)
    k = torch.zeros(1, 3, 8, 16)                 # 4 heads over 3 kv heads
    with pytest.raises(ValueError):
        if call == "flash":
            flash_attention_fwd(q, k, k)
        else:
            decode_attention_fwd(q, k[:, :, :, :8], k, 0)


@pytest.mark.parametrize("b,kvh,s", [
    (8, 8, 1152), (8, 8, 32768), (1, 1, 1), (1, 1, 31), (1, 1, 33),
    (2, 2, 256), (64, 64, 4096), (3, 5, 7)])
def test_decode_splits_depend_only_on_the_shapes(b, kvh, s):
    """The split count is a function of (B, KV, S) alone -- never of the
    fill, so a call captured in a CUDA graph replays at any fill -- and
    lies in [1, S]."""
    splits = decode_splits(b, kvh, s)
    assert isinstance(splits, int) and 1 <= splits <= s
    assert decode_splits(b, kvh, s) == splits


def _split_merge(q, k, v, cache_len, splits):
    """The decode kernel's algebra in plain PyTorch: ``splits`` equal
    shares of the ``n = min(cache_len + 1, S)`` filled positions, each an
    f32 partial (m, l, acc) -- empty past n -- merged by log-sum-exp
    rescaling."""
    s_len, hd = k.shape[2], q.shape[-1]
    n = max(0, min(cache_len + 1, s_len))
    per = -(-n // splits)
    shape = q.shape[:-1]
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo, hi = sp * per, min(n, sp * per + per)
        if lo >= hi:
            ms.append(torch.full(shape, -torch.inf))
            ls.append(torch.zeros(shape))
            accs.append(torch.zeros(q.shape))
            continue
        sc = q.float() @ k[:, :, lo:hi].float().transpose(-1, -2)
        sc = sc * hd ** -0.5
        m = sc.amax(-1)
        p = torch.exp(sc - m[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(p @ v[:, :, lo:hi].float())
    m, l, acc = torch.stack(ms), torch.stack(ls), torch.stack(accs)
    w = torch.where(m == -torch.inf, 0.0, torch.exp(m - m.amax(0)))
    return (acc * w[..., None]).sum(0) / (l * w).sum(0).clamp(
        min=1e-30)[..., None]


@pytest.mark.parametrize("splits", [1, 2, 3, 5, 8, 16])
@pytest.mark.parametrize("fill", [0, 1, 14, 15, 39, 99, 130])
def test_split_merge_algebra_matches_plain(splits, fill):
    """Split-then-merge equals the full softmax within 1e-6 in float32,
    with empty splits (few filled positions over many splits) and with
    ``cache_len`` past the cache (fill 130 on a 100-long cache)."""
    _, (q, k, v) = _inputs(7, [(2, 2, 4, 16), (2, 2, 100, 16),
                               (2, 2, 100, 16)], "float32")
    want = decode_attention_plain(q, k, v, torch.tensor(fill))
    torch.testing.assert_close(_split_merge(q, k, v, fill, splits), want,
                               rtol=1e-6, atol=1e-6)
