"""Limb-form u64 row sort (the headline benchmark path).

u64 key / u64 payload rows travel as (hi, lo) uint32 limb quadruples and
sort with one variadic ``lax.sort`` over the two key limbs. Lexicographic
(hi, lo) order equals u64 order (keys.split64). The module keeps its
historical name; the only engine left is XLA's comparator sort.
"""

from __future__ import annotations

import jax

__all__ = ["sort_pairs_limbs", "ENGINES"]

ENGINES = ("auto", "comparator")


def sort_pairs_limbs(khi, klo, vhi, vlo, engine: str = "auto"):
    """Stable sort of u64 key/payload rows held as u32 limb quadruples.

    ``engine``: "comparator" (XLA variadic sort) or "auto" (the same).
    """
    if engine not in ENGINES:
        raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
    return tuple(
        jax.lax.sort([khi, klo, vhi, vlo], num_keys=2, is_stable=True)
    )
