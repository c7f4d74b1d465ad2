"""The card's constants (roofline denominators) and the meshes: the
counterpart of the reference's TPU v5e constants and production mesh
(``repro.launch.mesh``).

Every constant is the data sheet's figure for an NVIDIA H100 80GB HBM3
(SXM) at its 700.00 W limit, the card ``chip_smoke.py`` runs on; a card
held below that limit runs slower under load.  The interconnect rates are
those of a DGX H100 node (NVIDIA DGX H100 data sheet): 8 cards joined by
fourth-generation NVLink through NVSwitch, and one ConnectX-7 NDR
InfiniBand adapter per card between nodes.  They take the place of the
reference's ``ICI_BW`` and ``DCI_BW``.

The reference's 16x16 mesh (``data``, ``model``) and 2x16x16 mesh
(``pod``, ``data``, ``model``) are ``torch.distributed`` device meshes of
H100s here.  ``make_production_mesh`` is a function, not a module
constant, so that importing this module touches no process group and no
device.  On a host without the cards the dry run builds them over a fake
process group of 512 ranks (:func:`fake_world`), where a collective moves
nothing and a tensor keeps only its shape.
"""
from __future__ import annotations

from typing import Tuple

#: H100 80GB HBM3, 700.00 W: dense bfloat16 on the tensor cores, FLOP/s
PEAK_FLOPS_BF16 = 989e12
#: H100 80GB HBM3, 700.00 W: float32 outside the tensor cores, FLOP/s (the
#: port's float32 products keep full precision: TF32 is off)
PEAK_FLOPS_F32 = 67e12
#: H100 80GB HBM3, 700.00 W: HBM3 bytes/s
HBM_BW = 3.35e12
#: H100 80GB HBM3: device memory, bytes (``nvidia-smi``'s 81559 MiB)
HBM_BYTES = 81559 * 1024 ** 2

#: H100 80GB HBM3, 700.00 W (NVIDIA H100 SXM / DGX H100 data sheets):
#: NVLink 4, 900 GB/s a card both ways, so bytes/s a card each way
NVLINK_BW = 450e9
#: H100 80GB HBM3, 700.00 W (DGX H100 data sheet): one ConnectX-7 NDR
#: 400 Gb/s InfiniBand adapter a card, bytes/s each way
IB_BW = 50e9
#: cards a node joins by NVLink (a DGX H100)
NODE_CARDS = 8

#: the one-card mesh: its name, as a dry-run record's ``mesh``, and its
#: cards
MESH_NAME = "1xH100"
N_CHIPS = 1

SINGLE_POD_CHIPS = 256
MULTI_POD_CHIPS = 512
#: a record's ``mesh`` for the reference's two meshes
SINGLE_POD_MESH = "16x16"
MULTI_POD_MESH = "2x16x16"


def mesh_layout(multi_pod: bool = False
                ) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """``(shape, axis names)`` of the reference's production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def n_chips(multi_pod: bool) -> int:
    return MULTI_POD_CHIPS if multi_pod else SINGLE_POD_CHIPS


def fake_world(world_size: int = MULTI_POD_CHIPS) -> None:
    """Start a fake process group of ``world_size`` ranks (this process
    is rank 0) once a process; a later call with the same size does
    nothing.  Collectives over it return at once and move nothing, so a
    step walked over it under fake tensors costs only host time."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        if dist.get_world_size() != world_size:
            raise RuntimeError(f"a process group of "
                               f"{dist.get_world_size()} ranks is already "
                               f"running; the fake world needs "
                               f"{world_size}")
        return
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)


def make_production_mesh(multi_pod: bool = False, device_type: str = "cpu"):
    """A ``DeviceMesh`` of shape (16, 16), axes ``("data", "model")``, or
    (2, 16, 16), axes ``("pod", "data", "model")``, over ranks 0..255
    (0..511) of the current process group, in row-major order as
    ``jax.make_mesh`` lays out its devices.  The group must hold at least
    that many ranks (:func:`fake_world` on a host without the cards).
    Builds no tensor on a device and reads no CUDA state."""
    import torch
    from torch.distributed.device_mesh import DeviceMesh

    shape, names = mesh_layout(multi_pod)
    ranks = torch.arange(n_chips(multi_pod)).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)
