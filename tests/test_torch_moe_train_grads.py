"""The MoE and hybrid Mamba families' whole training loss and every
gradient against ``jax.value_and_grad`` of the reference's ``forward``
(qwen2-moe, llama4-scout and jamba SMOKE; float32 within 1e-5, bfloat16
within 5e-2 with the reference eager; remat on and off).  Split from
``test_torch_moe_train.py``; its module docstring says more."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _torch_moe_train_common import *  # noqa: E402,F401,F403


# ---------------------------------------------------------------------------
# the whole loss and every gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("remat", [False, True])
def test_forward_and_every_gradient_match_reference(arch, dtype, remat):
    _, tcfg, _, tp = models(arch, dtype, remat)
    jloss, jce, jaux, want = reference_loss_and_grads(arch, dtype, remat, 7)
    loss, metrics, grads = port_loss_and_grads(tp, tcfg, batch_of(tcfg, 7))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for got, ref in ((loss, jloss), (metrics["ce"], jce),
                     (metrics["aux"], jaux)):
        np.testing.assert_allclose(float(got.detach()), ref, rtol=tol,
                                   atol=tol)
    assert float(metrics["aux"].detach()) > 0
    assert set(grads) == set(want)
    for name, g in grads.items():
        assert g.dtype == torch.float32 and g.shape == want[name].shape
        grad_close(g, want[name].numpy(), tol, f"{arch} {dtype} {name}")


