"""NULL-value support: per-column null masks over the static-shape engine.

SQL NULLs on a static-shape engine cannot be sentinel values (every bit pattern of
every dtype is a legal key) and cannot be dynamic shapes (XLA traces once).
The representation here is a companion BOOL MASK per nullable column
(True = NULL) with one invariant the whole engine relies on:

    **values are canonicalized to 0 wherever the mask is True.**

That invariant is what lets NULL semantics ride the existing machinery:

  - masks are stored as hidden companion columns (``name + "\\x00null"``)
    inside ``Table``'s column dict, so every row-permuting operator
    (filter / sort payload / top_k / limit / unnest / join gathers)
    carries them with zero extra code — they are just one more bool word
    on the variadic sort;
  - grouping ops (distinct / GROUP BY / set ops) weave the mask in as one
    extra uint32 key word per nullable key, exactly like the validity
    flag: all NULLs share value 0, so (mask, value) equality groups NULL
    with NULL and nothing else (SQL GROUP BY semantics);
  - ordering ops put the mask word FIRST so NULL sorts as +infinity
    (ascending => NULLS LAST, descending => NULLS FIRST — the PostgreSQL
    default), and the word complements with ``descending`` like any limb;
  - joins extend the never-match flag word (left padding=1, right
    padding=2) with left-NULL=3 / right-NULL=4: NULL keys match nothing,
    including other NULLs, while outer joins still emit them unmatched;
  - aggregates skip NULLs by substitution (sum already ignores 0-filled
    cells; min/max substitute the dtype's +/- infinity; count sums the
    non-null indicator) plus a shared non-null-count word that turns
    all-NULL groups into NULL results.

Expression-level three-valued logic (Kleene AND/OR, null-propagating
arithmetic, IS NULL / COALESCE / NULLIF) lives in ``expr.py`` on top of
the same (value, mask) pairs.

The reference crate has no NULLs (it is a sort crate,
src/radix_sort/mod.rs); this belongs to the north-star query-engine
surface (BASELINE.json).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = ["MaskedColumn", "NULL_SUFFIX", "mask_name", "is_mask_name",
           "base_name", "detect", "dtype_max", "dtype_min", "merge_masks"]

NULL_SUFFIX = "\x00null"


def mask_name(name: str) -> str:
    """The hidden companion-column name of ``name``'s null mask."""
    return name + NULL_SUFFIX


def is_mask_name(name: str) -> bool:
    return name.endswith(NULL_SUFFIX)


def base_name(name: str) -> str:
    """Owning column name of a mask column name."""
    return name[: -len(NULL_SUFFIX)]


class MaskedColumn:
    """A (values, null-mask) pair for passing nullable data through APIs
    that move single arrays (``with_columns``, aggregate value columns,
    window value columns). ``mask`` is bool, True = NULL."""

    __slots__ = ("values", "mask")

    def __init__(self, values, mask):
        self.values = values
        self.mask = mask

    def __repr__(self):
        return f"MaskedColumn({self.values!r}, mask={self.mask!r})"


def detect(x):
    """Recognize nullable host/device input -> ``(values, bool mask)`` or
    None when ``x`` carries no null information.

    Accepts :class:`MaskedColumn`, ``np.ma.MaskedArray``, and host
    lists / object arrays containing ``None`` entries (string data with
    ``None`` becomes ``""`` + mask; numeric data becomes 0 + mask)."""
    if isinstance(x, MaskedColumn):
        return x.values, jnp.asarray(x.mask, jnp.bool_)
    if isinstance(x, np.ma.MaskedArray):
        m = np.ma.getmaskarray(x)
        data = np.ma.getdata(x).copy()
        if data.dtype.kind in ("U", "S", "O"):
            data[m] = "" if data.dtype.kind != "S" else b""
        else:
            data[m] = 0
        return data, jnp.asarray(m, jnp.bool_)
    if isinstance(x, (list, tuple)) or (
            isinstance(x, np.ndarray) and x.dtype.kind == "O"):
        vals = list(x)
        if not any(v is None for v in vals):
            return None
        m = np.array([v is None for v in vals], dtype=bool)
        rest = [v for v in vals if v is not None]
        if rest and all(isinstance(v, (str, bytes)) for v in rest):
            fill = ""
            vals = [fill if v is None else v for v in vals]
            return np.asarray(vals, dtype=np.str_), jnp.asarray(m)
        vals = [0 if v is None else v for v in vals]
        return np.asarray(vals), jnp.asarray(m)
    return None


def dtype_max(dt):
    """The dtype's +infinity surrogate (for NULL-skipping min)."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        return jnp.asarray(np.inf, dt)
    if dt.kind == "b":
        return jnp.asarray(True)
    return jnp.asarray(np.iinfo(dt).max, dt)


def dtype_min(dt):
    """The dtype's -infinity surrogate (for NULL-skipping max)."""
    dt = np.dtype(dt)
    if dt.kind == "f":
        return jnp.asarray(-np.inf, dt)
    if dt.kind == "b":
        return jnp.asarray(False)
    return jnp.asarray(np.iinfo(dt).min, dt)


def merge_masks(a, b):
    """OR of two optional masks (None = no nulls)."""
    if a is None:
        return b
    if b is None:
        return a
    return a | b
