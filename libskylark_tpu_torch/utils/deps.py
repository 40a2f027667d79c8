"""Optional-dependency import with an install hint (port of
``libskylark_tpu/utils/deps.py``).

The port needs torch and numpy; scipy lives behind the ``ml`` extra.
Features that need it (the community detection's Bessel bound and
sparse products) import through :func:`require`, so a bare install
fails with the pip command to run, not a raw ``ModuleNotFoundError``.
"""

from __future__ import annotations

import importlib

__all__ = ["require"]

# module name -> the extra that provides it
_EXTRAS = {"scipy": "ml", "h5py": "io", "fsspec": "io"}


def require(module: str):
    """Import ``module`` (dotted paths allowed), or raise ImportError
    naming the ``pip install 'libskylark-tpu[extra]'`` that provides it."""
    try:
        return importlib.import_module(module)
    except ImportError as e:
        root = module.split(".", 1)[0]
        extra = _EXTRAS.get(root)
        hint = f"pip install 'libskylark-tpu[{extra}]'" if extra else f"pip install {root}"
        raise ImportError(
            f"{root!r} is required for this feature but is not installed; run: {hint}"
        ) from e
