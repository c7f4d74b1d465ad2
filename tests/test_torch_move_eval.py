"""The port's move evaluation against the JAX reference.

``move_delta_batch`` runs its plain version on CPU tensors (the CUDA kernel
is held against that plain version by ``chip_smoke.py`` on the card).  The
plain version must equal the reference's jnp oracle ``move_delta_reference``
bit for bit; against the Pallas kernel in interpret mode the blocked
pattern must be identical and the values within ``atol = 1e-6`` (the
interpreted kernel rounds 1 ulp differently in a few entries).  Instances
hold unassigned items (prev = -1), oversized items (w > C), empty bins and,
masked, inactive items.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro.kernels.move_eval import MOVE_BLOCKED as J_BLOCKED  # noqa: E402
from repro.kernels.move_eval import move_delta_batch as j_move_batch  # noqa: E402
from repro.kernels.move_eval import move_delta_reference as j_move_ref  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.move_eval import (MOVE_BLOCKED,  # noqa: E402
                                           move_delta_batch,
                                           move_delta_reference)


def _instance(seed, k=7, n=9, cap=1.0, m=None):
    """Chains in random feasible-ish states: assignments over ``m`` names
    (the annealer's ``2n+2`` by default), loads and counts derived from
    them (inactive items excluded), so some bins are empty and some items
    oversized."""
    rng = np.random.default_rng(seed)
    m = 2 * n + 2 if m is None else m
    speeds = rng.uniform(0, 1.4 * cap, (k, n)).astype(np.float32)
    speeds[:, 0] = 1.2 * cap                       # always one oversized item
    assign = rng.integers(0, n, (k, n)).astype(np.int32)
    prev = rng.integers(-1, m, (k, n)).astype(np.int32)
    prev[:, 1] = -1
    active = rng.random((k, n)) > 0.25
    lam = rng.choice(np.float32([0.0, 0.5, 4.0]), k).astype(np.float32)
    return dict(speeds=speeds, assign=assign, prev=prev, active=active,
                lam=lam, cap=np.full(k, cap, np.float32), m=m)


def _state(x, masked):
    act = x["active"] if masked else np.ones_like(x["active"])
    k, m = x["speeds"].shape[0], x["m"]
    loads = np.zeros((k, m), np.float32)
    counts = np.zeros((k, m), np.int32)
    for c in range(k):
        for p in np.flatnonzero(act[c]):
            loads[c, x["assign"][c, p]] += x["speeds"][c, p]
            counts[c, x["assign"][c, p]] += 1
    return loads, counts


def _both(x, masked, lam):
    loads, counts = _state(x, masked)
    lam_k = np.full_like(x["lam"], lam) if lam is not None else x["lam"]
    args = (loads, counts, x["assign"], x["speeds"], x["prev"], lam_k,
            x["cap"])
    act = x["active"] if masked else None
    return args, act


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("lam", (0.0, 4.0, None), ids=("lam0", "lam4",
                                                        "mixed"))
def test_plain_version_equals_reference_bit_for_bit(masked, lam):
    args, act = _both(_instance(0), masked, lam)
    want = np.asarray(j_move_ref(*map(jnp.asarray, args),
                                 active=None if act is None
                                 else jnp.asarray(act)))
    got = move_delta_reference(*map(torch.tensor, args),
                               active=None if act is None
                               else torch.tensor(act))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    blocked = want >= J_BLOCKED / 2
    assert blocked.any() and (~blocked).any()
    assert float(np.float32(MOVE_BLOCKED)) == float(np.float32(J_BLOCKED))


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("seed", (1, 2))
def test_batch_on_cpu_matches_interpret_kernel(masked, seed):
    args, act = _both(_instance(seed, k=5, n=6, cap=0.8), masked, None)
    want = np.asarray(j_move_batch(*map(jnp.asarray, args),
                                   active=None if act is None
                                   else jnp.asarray(act), interpret=True))
    _build.reset_launches()
    got = move_delta_batch(*map(torch.tensor, args),
                           active=None if act is None else torch.tensor(act))
    assert move_delta_batch.launches == 0       # the plain version ran
    got = got.numpy()
    np.testing.assert_array_equal(got >= MOVE_BLOCKED / 2,
                                  want >= J_BLOCKED / 2)
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


@pytest.mark.parametrize("masked", (False, True))
@pytest.mark.parametrize("n,m", ((5, 7), (3, 9), (9, 13)))
def test_plain_plane_with_moves_not_a_multiple_of_four(n, m, masked):
    """An ``N*M`` that is not a multiple of 4 (the kernel's chains then
    start off its 16-byte stores' boundary): the plain version and the
    CPU path still equal the reference's oracle bit for bit."""
    assert (n * m) % 4
    x = _instance(n + m, k=6, n=n, m=m)
    x["assign"] %= m
    x["prev"] = np.minimum(x["prev"], m - 1)
    args, act = _both(x, masked, None)
    want = np.asarray(j_move_ref(*map(jnp.asarray, args),
                                 active=None if act is None
                                 else jnp.asarray(act)))
    targs = [torch.tensor(a) for a in args]
    tact = None if act is None else torch.tensor(act)
    got = move_delta_reference(*targs, active=tact)
    assert got.shape == (6, n, m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        move_delta_batch(*targs, active=tact).numpy(), want)
    blocked = want >= J_BLOCKED / 2
    assert blocked.any() and (~blocked).any()


def test_kernel_source_is_built_and_bound():
    assert "move_eval.cu" in [p.name for p in _build._sources()]
    assert len(_build.SIGNATURES["move_eval_f32"]) == 13
    assert "move_delta_batch" in _build.launch_counts()
    assert len(_build.SIGNATURES["anneal_step_f32"]) == 19
    assert "anneal_step" in _build.launch_counts()
