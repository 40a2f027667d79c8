"""NaN/Inf sentinels (port of ``libskylark_tpu/guard/sentinels.py``).

:func:`finite_probe` reduces a tensor or a nest of them (dicts, lists,
tuples) to one device-side bool without a host sync;
:func:`tree_all_finite` reads it (one sync) and :func:`check_finite`
raises :class:`NumericalHealthError` naming the stage.  The JAX
package's ``is_traced`` has no counterpart: the port does not trace, so
a guarded entry point always runs its host-side checks.
"""

from __future__ import annotations

import torch

from ..utils.exceptions import NumericalHealthError

__all__ = ["finite_probe", "tree_all_finite", "check_finite"]


def _float_leaves(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_floating_point() or tree.is_complex():
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _float_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _float_leaves(v)


def finite_probe(tree) -> torch.Tensor:
    """0-d bool tensor: every float/complex tensor of ``tree`` is finite
    (stays on the device)."""
    probe = None
    for a in _float_leaves(tree):
        ok = torch.isfinite(a).all()
        probe = ok if probe is None else probe & ok
    return torch.tensor(True) if probe is None else probe


def tree_all_finite(tree) -> bool:
    """Host-side finiteness verdict: one device-to-host sync."""
    return bool(finite_probe(tree))


def check_finite(tree, stage: str, report=None):
    """Raise :class:`NumericalHealthError` if ``tree`` has a non-finite
    float entry; otherwise return ``tree``."""
    if not tree_all_finite(tree):
        raise NumericalHealthError(f"non-finite values detected at stage {stage!r}",
                                   stage=stage, report=report)
    return tree
