"""The paper's packing core on the card (``pack``: the batched packers)
and its pure-Python ``py`` packers (``binpack``, ``modified``)."""


def __getattr__(name: str):
    # deprecated name tables forward to the per-module shims (which warn
    # once and resolve through repro_torch.registry)
    if name == "ALL_ALGORITHMS":
        from . import modified as _modified
        return _modified.ALL_ALGORITHMS
    if name == "ALL_ALGORITHM_NAMES":
        from . import pack as _pack
        return _pack.ALL_ALGORITHM_NAMES
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
