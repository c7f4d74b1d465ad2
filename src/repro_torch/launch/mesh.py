"""The card's constants (roofline denominators) and the one-card mesh: the
counterpart of the reference's TPU v5e constants
(``repro.launch.mesh``).

Every constant is the data sheet's figure for an NVIDIA H100 80GB HBM3
(SXM) at its 700.00 W limit, the card ``chip_smoke.py`` runs on; a card
held below that limit runs slower under load.  The reference's 16x16 and
2x16x16 meshes, their interconnect rates and the fake 512-rank process
group come with the port's sharding rules.
"""
from __future__ import annotations

#: H100 80GB HBM3, 700.00 W: dense bfloat16 on the tensor cores, FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: H100 80GB HBM3, 700.00 W: float32 outside the tensor cores, FLOP/s (the
#: port's float32 products keep full precision: TF32 is off)
PEAK_FLOPS_F32 = 67e12
#: H100 80GB HBM3, 700.00 W: HBM3 bytes/s
HBM_BW = 3.35e12
#: H100 80GB HBM3: device memory, bytes (``nvidia-smi``'s 81559 MiB)
HBM_BYTES = 81559 * 1024 ** 2

#: the one-card mesh: its name, as a dry-run record's ``mesh``, and its
#: cards
MESH_NAME = "1xH100"
N_CHIPS = 1
