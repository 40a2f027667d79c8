"""Profile keys (port of ``shape_class`` and ``profile_key`` of
``libskylark_tpu/policy/profile.py``).  The store itself waits for
ROADMAP Queue A item 3b."""

from __future__ import annotations

import math

__all__ = ["shape_class", "profile_key"]


def shape_class(m: int, n: int) -> str:
    """Geometric shape bucket ``r<ceil log2 m>c<ceil log2 n>``."""

    def _l2(x: int) -> int:
        return max(0, math.ceil(math.log2(max(int(x), 1))))

    return f"r{_l2(m)}c{_l2(n)}"


def profile_key(kind: str, backend: str, dtype: str, m: int, n: int) -> str:
    """The store key: ``kind|backend|dtype|shape-class``."""
    return "|".join([kind, backend, str(dtype), shape_class(m, n)])
