"""Numerics primitives: stencils, calibrated filters, resampling, warping."""


def resolve_impl(impl: str) -> str:
    """The implementation a solver's ``impl`` argument names: "auto" and
    "xla" are the plain XLA body, on every backend; any other value raises
    instead of falling back."""
    if impl not in ("auto", "xla"):
        raise ValueError(f"unknown impl {impl!r}; expected 'auto' or 'xla'")
    return "xla"
