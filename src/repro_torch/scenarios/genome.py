"""Scenario genomes: fixed vectors over a family's registered knobs.

A genome is ``f32[K]`` where gene ``i`` is the value of the family's
``i``-th registered :class:`~repro_torch.core.scenarios.KnobSpec` (so the
registry *is* the genome layout -- ``FamilySpec.knob_names`` names the
axes).  ``decode_genome`` gives the knob dict with the genes still as
tensors, ``repair_genome`` works on f32 tensors of any leading shape
(clip to bounds, then enforce each ``FamilySpec.ordered`` pair by lifting
the upper knob to the lower one -- the tensor twin of the host-side
``ValueError`` an empty lifecycle window raises), and
``random_population`` takes its uniforms injected or from a generator.
The operations and their order are the reference's
(``repro.scenarios.genome``), so the same genomes give the same bits.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.scenarios import FamilySpec, Seed, _generator, family_spec


def _spec(family: Union[str, FamilySpec]) -> FamilySpec:
    return family if isinstance(family, FamilySpec) else family_spec(family)


def genome_bounds(family: Union[str, FamilySpec]
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """-> ``(lo f32[K], hi f32[K])`` over the family's registered knobs."""
    spec = _spec(family)
    lo = np.asarray([k.lo for k in spec.knobs], np.float32)
    hi = np.asarray([k.hi for k in spec.knobs], np.float32)
    return lo, hi


def default_genome(family: Union[str, FamilySpec]) -> np.ndarray:
    """The genome encoding every knob's registered default (``f32[K]``)."""
    spec = _spec(family)
    return np.asarray([k.default for k in spec.knobs], np.float32)


def decode_genome(family: Union[str, FamilySpec], genome
                  ) -> Dict[str, torch.Tensor]:
    """Genome vector -> ``{knob_name: gene}`` with each gene a 0-dim f32
    tensor on the genome's device."""
    spec = _spec(family)
    genome = torch.as_tensor(genome, dtype=torch.float32)
    if tuple(genome.shape) != (len(spec.knobs),):
        raise ValueError(
            f"family {spec.name!r} takes genomes of shape "
            f"({len(spec.knobs)},) over knobs {spec.knob_names}; got "
            f"shape {tuple(genome.shape)}")
    return {k.name: genome[i] for i, k in enumerate(spec.knobs)}


def genome_knobs(family: Union[str, FamilySpec], genome
                 ) -> Dict[str, float]:
    """Host-side twin of :func:`decode_genome`: plain floats, for witness
    JSON and replaying a stored genome through ``generate_*``."""
    spec = _spec(family)
    if isinstance(genome, torch.Tensor):
        genome = genome.cpu().numpy()
    genome = np.asarray(genome, np.float32)
    if genome.shape != (len(spec.knobs),):
        raise ValueError(
            f"family {spec.name!r} takes genomes of shape "
            f"({len(spec.knobs)},); got shape {genome.shape}")
    return {k.name: float(genome[i]) for i, k in enumerate(spec.knobs)}


def repair_genome(family: Union[str, FamilySpec], genome) -> torch.Tensor:
    """Project a (possibly batched ``[..., K]``) genome back into the
    valid region: clip every gene to its knob bounds, then repair each
    ``ordered`` pair so the upper knob is ``>=`` the lower one (e.g.
    ``death_frac >= birth_frac`` -- mutation may break the order; the
    search repairs instead of raising, so every stored witness replays
    through the host-side validation cleanly).  Returns a new f32 tensor
    on the genome's device."""
    spec = _spec(family)
    lo, hi = genome_bounds(spec)
    g = torch.as_tensor(genome, dtype=torch.float32)
    g = torch.clamp(g, torch.from_numpy(lo).to(g.device),
                    torch.from_numpy(hi).to(g.device))
    idx = {name: i for i, name in enumerate(spec.knob_names)}
    for lo_name, hi_name in spec.ordered:
        i, j = idx[lo_name], idx[hi_name]
        g[..., j] = torch.maximum(g[..., j], g[..., i])
    return g


def random_population(family: Union[str, FamilySpec], seed: Optional[Seed],
                      pop: int, *, uniforms: Optional[torch.Tensor] = None,
                      device=None) -> torch.Tensor:
    """``pop`` genomes uniform over the knob bounds, repaired
    (``f32[pop, K]``); the search's init and the random baseline's draw.
    The uniforms ``f32[pop, K]`` in [0, 1) are ``uniforms`` when given
    (``seed`` is then unused), else drawn on ``device`` (``None`` = the
    CUDA card) from a generator seeded ``seed`` (or from the generator
    ``seed``)."""
    spec = _spec(family)
    shape = (int(pop), len(spec.knobs))
    if uniforms is None:
        gen = _generator(seed, device)
        uniforms = torch.rand(shape, generator=gen, device=gen.device)
    u = torch.as_tensor(uniforms, dtype=torch.float32)
    if tuple(u.shape) != shape:
        raise ValueError(f"random_population takes uniforms of shape "
                         f"{shape}; got {tuple(u.shape)}")
    lo, hi = genome_bounds(spec)
    span = torch.from_numpy(hi - lo).to(u.device)
    return repair_genome(spec, torch.from_numpy(lo).to(u.device) + u * span)


__all__ = [
    "decode_genome",
    "default_genome",
    "genome_bounds",
    "genome_knobs",
    "random_population",
    "repair_genome",
]
