"""PyTorch / CUDA port of the Kafka consumer-group autoscaler reproduction.

The JAX package ``repro`` is the reference; this package runs the same
closed-loop lag twin on an NVIDIA H100 with hand-written CUDA kernels
(``repro_torch.kernels``), and imports nothing of ``repro``.  Every entry
point takes ``device=None``, meaning the CUDA card; on a host without
CUDA it raises :class:`CudaUnavailableError` unless called with
``device="cpu"``, which runs the kernels' plain PyTorch versions.
"""
from ._device import CudaUnavailableError, resolve_device

__all__ = ["CudaUnavailableError", "resolve_device"]
