"""The legacy warning of the port's filter banks.

Counterpart of ``repro/_compat.py``.  The typed façade
(``repro_torch.open_filter`` / ``repro_torch.FilterSpec``) is the front
door; constructing a :class:`~repro_torch.dist.FilterBank` or a
:class:`~repro_torch.dist.TenantFilterBank` directly emits a
:class:`LegacyAPIWarning` naming the ``FilterSpec`` that opens the same
bank, as the reference's constructors do.  The port's ``BloomRF``,
``FilterOps`` and ``Store`` do not warn: they are the port's own building
blocks, not legacy entry points.

In-tree code never goes through the warning: every internal construction
site passes the private ``_warn=False`` keyword.  Warnings are attributed
to the *caller* of the constructor (``stacklevel``).
"""
from __future__ import annotations

import warnings

__all__ = ["LegacyAPIWarning", "warn_legacy"]


class LegacyAPIWarning(DeprecationWarning):
    """A bank constructor was used directly instead of the façade."""


def warn_legacy(old: str, spec_hint: str) -> None:
    """Warn that ``old`` is a legacy entry point.

    ``spec_hint`` is the ``FilterSpec(...)`` argument list that opens the
    equivalent filter through the façade.  Called from a legacy
    constructor's ``__init__``; ``stacklevel=3`` attributes the warning to
    whoever invoked that constructor."""
    warnings.warn(
        f"{old} is a deprecated public entry point; open it through the "
        f"typed façade instead: repro_torch.open_filter(repro_torch."
        f"FilterSpec({spec_hint})).",
        LegacyAPIWarning, stacklevel=3)
