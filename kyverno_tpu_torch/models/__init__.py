"""Policy IR + compiler: policy documents -> flat pattern tensors, the
flattener that packs resources into one blob, and the engine facade that
scores blobs on the card."""

# the engine, loaded on first use: the compiler, the IR and the
# flattener load no torch (the lint path imports them)
_EXPORTS = ("CompiledPolicySet", "Verdict")

__all__ = list(_EXPORTS)


def __getattr__(name: str):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    from . import engine

    return getattr(engine, name)
