"""Relational completions over the sort engine: asof join, set operators,
exact quantiles.

These extend the north-star query-operator set (filter / hash_join /
hash_aggregate, BASELINE.json) with the remaining relational algebra a
query-engine user expects, each built the same way — one stable variadic
sort plus vectorized segment math, no per-row control flow (the reference
crate is sort-only; these are engine capabilities layered on its sort
semantics, src/radix_sort/mod.rs:61-176).

  - ``join_asof``: the timeseries join — each left key matches the nearest
    right key at or before/after it (SQL ``ASOF JOIN``, pandas
    ``merge_asof``). Probe ranks come from the fused merge-rank union sorts
    (ops/query.py:merge_rank_pair), candidates from two clamped gathers.
  - ``set_union`` / ``set_intersect`` / ``set_difference``: SQL
    UNION / INTERSECT / EXCEPT over distinct keys (single or composite
    multi-column). One stable sort of the tagged union; per-group presence
    comes from segment min/max over the origin tag.
  - ``quantiles``: exact order statistics at static quantile points (sort +
    static gathers); the distributed form lives in
    parallel/dist_query.py:distributed_quantiles.

All ragged outputs follow the engine convention: (padded arrays..., count).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radix_sort_tpu import keys as K
from radix_sort_tpu.ops.query import (
    _cols_to_limbs,
    _limbs_differ,
    _limbs_to_cols,
    _stable_sort,
    filter as _filter,
    merge_rank_pair,
)

__all__ = [
    "join_asof",
    "set_union",
    "set_intersect",
    "set_difference",
    "quantiles",
    "ASOF_DIRECTIONS",
]

ASOF_DIRECTIONS = ("backward", "forward", "nearest")


def join_asof(
    left_keys: jnp.ndarray,
    right_keys: jnp.ndarray,
    right_values: jnp.ndarray,
    *,
    direction: str = "backward",
    tolerance=None,
    fill=0,
    right_valid=None,
):
    """Nearest-key (asof) join: align each left row with one right row.

    For every ``left_keys[i]`` the match is the right row whose key is

      - ``"backward"``: the greatest key <= it (the latest tie wins, as in
        pandas ``merge_asof``);
      - ``"forward"``: the least key >= it (the earliest tie wins);
      - ``"nearest"``: whichever of those two candidates is closer (ties go
        backward).

    Order is the dtype's total order (the sort's semantics); neither side
    needs to be pre-sorted, and left order is preserved in the outputs.

    Returns ``(values, matched, right_pos)``, all aligned to ``left_keys``:
    ``values[i]`` is the matched row's ``right_values`` entry (``fill``
    where unmatched), ``matched`` the bool match mask, and ``right_pos`` the
    matched row's original index into ``right_keys`` (-1 where unmatched).

    ``tolerance`` (optional scalar, key units) rejects matches farther than
    it. ``nearest`` and ``tolerance`` measure distance arithmetically and
    support 8/16/32-bit integer keys (exact, in rank space) and float32
    keys (IEEE subtraction; NaN-valued distances reject/fall backward);
    64-bit keys support backward/forward only.

    ``right_valid`` (optional bool mask over ``right_keys``) excludes rows
    from candidacy entirely — the match is the nearest VALID row (the
    ``Table`` facade passes its padding mask). Costs two extra scans.
    """
    if direction not in ASOF_DIRECTIONS:
        raise ValueError(
            f"direction must be one of {ASOF_DIRECTIONS}, got {direction!r}"
        )
    if np.dtype(left_keys.dtype) != np.dtype(right_keys.dtype):
        raise ValueError("left and right keys must share a dtype")
    if right_values.shape[0] != right_keys.shape[0]:
        raise ValueError("right keys/values length mismatch")
    if (tolerance is not None and isinstance(tolerance, (int, float))
            and tolerance < 0):
        raise ValueError(f"tolerance must be >= 0, got {tolerance}")
    needs_dist = direction == "nearest" or tolerance is not None
    kdt = np.dtype(left_keys.dtype)
    if needs_dist and K.num_limbs(kdt) != 1:
        raise ValueError(
            "nearest/tolerance need arithmetic key distances — supported "
            f"for <=32-bit keys, got {kdt}"
        )
    n_l = left_keys.shape[0]
    n_r = right_keys.shape[0]
    vdt = right_values.dtype
    fill_v = jnp.asarray(fill, vdt)
    if n_l == 0 or n_r == 0:
        return (
            jnp.full((n_l,), fill_v, vdt),
            jnp.zeros((n_l,), jnp.bool_),
            jnp.full((n_l,), -1, jnp.int32),
        )

    # sort the right side by key, carrying values + original positions
    r_limbs = K.encode_limbs(right_keys)
    nk = len(r_limbs)
    pos = jnp.arange(n_r, dtype=jnp.int32)
    if right_valid is None:
        out = _stable_sort([*r_limbs, right_values, pos], num_keys=nk)
        rk_s, rv_s, rp_s = list(out[:nk]), out[nk], out[nk + 1]
    else:
        out = _stable_sort(
            [*r_limbs, right_values, pos, right_valid.astype(jnp.int32)],
            num_keys=nk,
        )
        rk_s, rv_s, rp_s = list(out[:nk]), out[nk], out[nk + 1]
        rvd_s = out[nk + 2] > 0

    l_limbs = K.encode_limbs(left_keys)
    lo, hi = merge_rank_pair(rk_s, l_limbs)
    # backward candidate: last right row with key <= q; forward: first >= q
    if right_valid is None:
        idx_b = jnp.clip(hi - 1, 0, n_r - 1)
        idx_f = jnp.clip(lo, 0, n_r - 1)
        m_b = hi > 0
        m_f = lo < n_r
    else:
        # nearest VALID candidate: forward/backward fills of valid sorted
        # positions turn "last row <= q" into "last valid row <= q"
        i_s = jnp.arange(n_r, dtype=jnp.int32)
        lastv = jax.lax.cummax(jnp.where(rvd_s, i_s, -1))
        firstv = jax.lax.cummin(
            jnp.where(rvd_s, i_s, n_r), reverse=True
        )
        cand_b = lastv[jnp.clip(hi - 1, 0, n_r - 1)]
        m_b = (hi > 0) & (cand_b >= 0)
        idx_b = jnp.clip(cand_b, 0, n_r - 1)
        cand_f = firstv[jnp.clip(lo, 0, n_r - 1)]
        m_f = (lo < n_r) & (cand_f < n_r)
        idx_f = jnp.clip(cand_f, 0, n_r - 1)

    is_float = np.issubdtype(kdt, np.floating)

    def _dist(idx, back):
        """Distance from query to candidate (valid only where matched)."""
        if is_float:
            k = K.decode_limbs([rk_s[0][idx]], kdt)
            d = left_keys - k if back else k - left_keys
            return jnp.abs(d)
        # integers: rank space is an order-preserving shift, so unsigned
        # limb differences are the exact numeric distances
        q = l_limbs[0]
        k = rk_s[0][idx]
        return q - k if back else k - q

    if direction == "backward":
        idx, matched = idx_b, m_b
        picked_back = jnp.ones((n_l,), jnp.bool_)
    elif direction == "forward":
        idx, matched = idx_f, m_f
        picked_back = jnp.zeros((n_l,), jnp.bool_)
    else:  # nearest: the closer matched candidate; ties go backward
        d_b = _dist(idx_b, True)
        d_f = _dist(idx_f, False)
        use_f = m_f & (~m_b | (d_f < d_b))
        idx = jnp.where(use_f, idx_f, idx_b)
        matched = m_b | m_f
        picked_back = ~use_f

    if tolerance is not None:
        # distance of the picked candidate, signed per the picked side
        # (distances on unmatched rows are garbage but masked by `matched`)
        d = jnp.where(picked_back, _dist(idx, True), _dist(idx, False))
        if is_float:
            tol = jnp.asarray(tolerance, kdt)
        else:
            tol = jnp.asarray(tolerance).astype(jnp.uint32)
        matched = matched & (d <= tol)

    values = jnp.where(matched, rv_s[idx], fill_v)
    right_pos = jnp.where(matched, rp_s[idx], -1)
    return values, matched, right_pos


def _set_op(a_keys, b_keys, want, a_valid=None, b_valid=None):
    """Shared machinery: one stable sort of the tagged union, per-group
    presence via segment max over per-side indicator bits, the qualifying
    group leaders compacted with ``filter``. ``want(has_a, has_b) -> bool``
    selects groups. Optional validity masks exclude padding rows (the
    distributed wrappers gather padded per-shard distincts): invalid rows
    contribute no presence, so any group they form alone is never selected.
    Returns ``(key_cols_or_col, count)`` padded to n_a + n_b."""
    multi = isinstance(a_keys, (list, tuple))
    if multi != isinstance(b_keys, (list, tuple)):
        raise ValueError("both sides must be single columns or column lists")
    a_cols = list(a_keys) if multi else [a_keys]
    b_cols = list(b_keys) if multi else [b_keys]
    if not a_cols or len(a_cols) != len(b_cols):
        raise ValueError("sides must have the same non-zero column count")
    for a, b in zip(a_cols, b_cols):
        if np.dtype(a.dtype) != np.dtype(b.dtype):
            raise ValueError("column dtypes must match between sides")
    n_a, n_b = a_cols[0].shape[0], b_cols[0].shape[0]
    for c in a_cols:
        if c.shape[0] != n_a:
            raise ValueError("left columns must have equal length")
    for c in b_cols:
        if c.shape[0] != n_b:
            raise ValueError("right columns must have equal length")
    n = n_a + n_b
    if n == 0:
        z = [jnp.zeros((0,), c.dtype) for c in a_cols]
        return (z if multi else z[0]), jnp.int32(0)

    cols = [jnp.concatenate([a, b]) for a, b in zip(a_cols, b_cols)]
    av = jnp.ones((n_a,), jnp.bool_) if a_valid is None else a_valid
    bv = jnp.ones((n_b,), jnp.bool_) if b_valid is None else b_valid
    ia = jnp.concatenate([av, jnp.zeros((n_b,), jnp.bool_)]).astype(jnp.int32)
    ib = jnp.concatenate([jnp.zeros((n_a,), jnp.bool_), bv]).astype(jnp.int32)
    limbs, specs = _cols_to_limbs(cols)
    out = _stable_sort([*limbs, ia, ib], num_keys=len(limbs))
    sk, sia, sib = list(out[:-2]), out[-2], out[-1]
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         _limbs_differ([w[1:] for w in sk], [w[:-1] for w in sk])]
    )
    gid = jnp.cumsum(first.astype(jnp.int32)) - 1
    ga = jax.ops.segment_max(sia, gid, num_segments=n,
                             indices_are_sorted=True)
    gb = jax.ops.segment_max(sib, gid, num_segments=n,
                             indices_are_sorted=True)
    has_a, has_b = ga[gid] == 1, gb[gid] == 1
    sel = first & want(has_a, has_b)
    uk_cols = _limbs_to_cols(sk, specs)
    *out_keys, count = _filter(sel, *uk_cols)
    return (out_keys if multi else out_keys[0]), count


def set_union(a_keys, b_keys):
    """SQL ``UNION``: distinct keys present in either side, ascending under
    the total order. Keys may be single columns or equal-dtype column lists
    (composite rows, lexicographic order). Returns ``(keys, count)``:
    rows [0, count) are the result, the tail is padding."""
    return _set_op(a_keys, b_keys, lambda ha, hb: ha | hb)


def set_intersect(a_keys, b_keys):
    """SQL ``INTERSECT``: distinct keys present in both sides. Same
    shapes/contract as :func:`set_union`."""
    return _set_op(a_keys, b_keys, lambda ha, hb: ha & hb)


def set_difference(a_keys, b_keys):
    """SQL ``EXCEPT``: distinct keys present in the first side and absent
    from the second. Same shapes/contract as :func:`set_union`."""
    return _set_op(a_keys, b_keys, lambda ha, hb: ha & ~hb)


QUANTILE_METHODS = ("lower", "higher", "nearest")


def quantile_ranks(n: int, qs, method: str = "lower"):
    """Static ranks into a sorted n-array for quantile points ``qs``
    (numpy ``quantile`` index conventions for the discrete methods)."""
    if method not in QUANTILE_METHODS:
        raise ValueError(
            f"method must be one of {QUANTILE_METHODS}, got {method!r}"
        )
    ranks = []
    for q in qs:
        q = float(q)
        if not 0.0 <= q <= 1.0:
            raise ValueError(f"quantile points must be in [0, 1], got {q}")
        x = q * (n - 1)
        if method == "lower":
            r = int(np.floor(x))
        elif method == "higher":
            r = int(np.ceil(x))
        else:
            r = int(np.floor(x + 0.5))
        ranks.append(min(max(r, 0), n - 1))
    return ranks


def quantiles(x: jnp.ndarray, qs, *, method: str = "lower") -> jnp.ndarray:
    """Exact quantiles of ``x`` as order statistics under the dtype's total
    order (floats: IEEE total_cmp, so NaNs rank at the ends rather than
    poisoning the result as in ``np.quantile``).

    ``qs`` is a static sequence of points in [0, 1]; ``method`` picks the
    discrete index convention (numpy's ``lower`` / ``higher`` / ``nearest``
    — no interpolation, so any supported dtype works and the results are
    elements of ``x``). Returns an array of ``len(qs)`` values.
    """
    n = x.shape[0]
    if n == 0:
        raise ValueError("quantiles of an empty array")
    ranks = quantile_ranks(n, qs, method)
    limbs = K.encode_limbs(x)
    if len(limbs) == 1:
        s = [jnp.sort(limbs[0], stable=False)]
    else:
        s = list(jax.lax.sort(limbs, num_keys=len(limbs), is_stable=False))
    idx = jnp.asarray(ranks, jnp.int32)
    return K.decode_limbs([w[idx] for w in s], x.dtype)
