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


def _instance(seed, k=7, n=9, cap=1.0):
    """Chains in random feasible-ish states: assignments over ``m = 2n+2``
    names, loads and counts derived from them (inactive items excluded),
    so some bins are empty and some items oversized."""
    rng = np.random.default_rng(seed)
    m = 2 * n + 2
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


def test_kernel_source_is_built_and_bound():
    assert "move_eval.cu" in [p.name for p in _build._sources()]
    assert len(_build.SIGNATURES["move_eval_f32"]) == 13
    assert "move_delta_batch" in _build.launch_counts()
