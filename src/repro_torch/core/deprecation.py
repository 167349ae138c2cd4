"""Deprecation plumbing for the port's legacy entry points.

The package-specific warning class lets a test suite turn the port's own
deprecations into hard errors without tripping over DeprecationWarnings
raised by third-party imports.

Port of ``repro.core.deprecation``.
"""

from __future__ import annotations

import warnings


class ReproDeprecationWarning(DeprecationWarning):
    """A repro_torch API is deprecated in favor of a newer one.
    Subclassing ``DeprecationWarning`` keeps standard tooling (``python
    -W``, pytest) able to address it generically."""


def warn_deprecated(old: str, new: str) -> None:
    warnings.warn(
        f"{old} is deprecated; use {new} instead (see README.md)",
        ReproDeprecationWarning,
        stacklevel=3,
    )
