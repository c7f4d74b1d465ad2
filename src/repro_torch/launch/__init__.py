"""Step builders of the port (``make_prefill_step``, ``make_serve_step``)."""
from .steps import make_prefill_step, make_serve_step

__all__ = ["make_prefill_step", "make_serve_step"]
