"""SQL window functions (OVER PARTITION BY ... ORDER BY ...).

The reference crate is sort-only; window functions are part of the
north-star query surface this framework adds (BASELINE.json). On a vector
machine the classic row-at-a-time window evaluation serializes; the
massively-parallel equivalent is the same recipe as the other operators in
:mod:`radix_sort_tpu.ops.query`:

  1. ONE stable variadic sort by (partition limbs, order limbs) with the
     original position and every value column riding along;
  2. vectorized segment math on the sorted view — partition starts/ends via
     boundary flags + ``cummax``/reverse ``cummin`` forward/backward fills,
     exact integer prefix-sum differences, ``jax.ops.segment_*`` for
     partition-wide float reductions, and a log-step (Hillis–Steele)
     segmented scan for running float sums / running min / max (24
     elementwise sweeps at 16M rows, cheap next to the sorts);
  3. ONE scatter back to original position.

All requested window columns share the one sort and the scatter. Ties in ``order_by``
(and rows with no ``order_by``) keep their input order — the sort is
stable, so results are deterministic (stronger than SQL's unspecified
tie order).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radix_sort_tpu import keys as K

__all__ = ["window", "WINDOW_OPS"]

# value-less rank/count ops and value ops (partition-wide vs running)
_RANK_OPS = (
    "row_number", "rank", "dense_rank", "count",
    "percent_rank", "cume_dist",          # SQL relative-rank functions
)
_PARAM_OPS = ("ntile", "rolling_count")   # value-less but parameterized
_VALUE_OPS = (
    "sum", "min", "max", "mean",          # partition-wide, broadcast to rows
    "cumsum", "cummin", "cummax",         # running (rows up to and incl. self)
    "first_value", "last_value",          # partition first/last under order
    "nth_value",                          # partition's k-th row under order
    "lag", "lead",                        # shifted within partition
    "rolling_sum", "rolling_min",         # sliding frame
    "rolling_max", "rolling_mean",        # (ROWS BETWEEN p PRECEDING
)                                         #  AND f FOLLOWING)
_ROLLING_OPS = (
    "rolling_sum", "rolling_min", "rolling_max", "rolling_mean",
    "rolling_count",
)
# value-based sliding frames (SQL RANGE BETWEEN v PRECEDING AND w
# FOLLOWING over ONE ascending numeric order column; None = UNBOUNDED)
_RANGE_OPS = (
    "range_sum", "range_min", "range_max", "range_mean", "range_count",
)
WINDOW_OPS = _RANK_OPS + _PARAM_OPS + _VALUE_OPS + _RANGE_OPS


def _normalize_spec(spec):
    """spec -> (name, values|None, p1, p2, fill).

    ``p1``/``p2`` carry the op's integer parameters: lag/lead offset and
    nth_value's k in ``p1``; rolling frames put ``preceding`` in ``p1`` and
    ``following`` in ``p2``; ntile's bucket count in ``p1``.
    """
    if isinstance(spec, str):
        name, rest = spec, ()
    elif isinstance(spec, tuple) and spec and isinstance(spec[0], str):
        name, rest = spec[0], tuple(spec[1:])
    else:
        raise ValueError(
            f"bad window op spec: {spec!r} (a spec is a name string or a "
            "(name, values, ...) tuple; pass several specs as a list)"
        )
    if name not in WINDOW_OPS:
        raise ValueError(f"op must be one of {WINDOW_OPS}, got {name!r}")
    if name in _RANK_OPS:
        if rest:
            raise ValueError(f"{name!r} takes no value column")
        return name, None, 1, 0, None
    if name == "ntile":
        if len(rest) != 1:
            raise ValueError("ntile takes a bucket count: ('ntile', n)")
        b = int(rest[0])
        if b < 1:
            raise ValueError(f"ntile bucket count must be >= 1, got {b}")
        return name, None, b, 0, None
    if name == "rolling_count":
        if not 1 <= len(rest) <= 2:
            raise ValueError(
                "rolling_count takes a frame: "
                "('rolling_count', preceding[, following])"
            )
        p = int(rest[0])
        f = int(rest[1]) if len(rest) > 1 else 0
        if p < 0 or f < 0:
            raise ValueError(f"{name!r} frame bounds must be >= 0")
        return name, None, p, f, None
    if name == "range_count":
        if not 1 <= len(rest) <= 2:
            raise ValueError(
                "range_count takes a frame: "
                "('range_count', preceding[, following])"
            )
        p = rest[0]
        f = rest[1] if len(rest) > 1 else 0
        _check_range_bounds(name, p, f)
        return name, None, p, f, None
    if not rest:
        raise ValueError(f"{name!r} needs a value column: ({name!r}, values)")
    values, rest = rest[0], rest[1:]
    p1, p2, fill = 1, 0, None
    if name in ("lag", "lead", "nth_value"):
        if rest:
            p1, rest = int(rest[0]), rest[1:]
            if p1 < 1:
                raise ValueError(f"{name!r} offset must be >= 1")
        if rest:
            fill, rest = rest[0], rest[1:]
    elif name in _ROLLING_OPS:
        if not rest:
            raise ValueError(
                f"{name!r} takes a frame: ({name!r}, values, "
                "preceding[, following])"
            )
        p1, rest = int(rest[0]), rest[1:]
        if rest:
            p2, rest = int(rest[0]), rest[1:]
        if p1 < 0 or p2 < 0:
            raise ValueError(f"{name!r} frame bounds must be >= 0")
    elif name in _RANGE_OPS:
        if not rest:
            raise ValueError(
                f"{name!r} takes a frame: ({name!r}, values, "
                "preceding[, following]) — value deltas, None=UNBOUNDED"
            )
        p1, rest = rest[0], rest[1:]
        p2 = 0
        if rest:
            p2, rest = rest[0], rest[1:]
        _check_range_bounds(name, p1, p2)
    if rest:
        raise ValueError(f"too many arguments for {name!r}: {spec!r}")
    return name, values, p1, p2, fill


def _check_range_bounds(name, p, f):
    for b in (p, f):
        if b is None:
            continue
        if (isinstance(b, tuple) and len(b) == 3
                and b[0] == "interval"):
            if b[1] >= 0 and b[2] >= 0:
                continue  # dtype-resolved in _range_delta
        elif isinstance(b, (int, float)) and b >= 0:
            continue
        raise ValueError(
            f"{name!r} frame bounds are numeric value deltas >= 0 "
            f"(or None for UNBOUNDED), got {b!r}"
        )


def _cols_to_limbs(cols):
    limbs = []
    for c in cols:
        limbs.extend(K.encode_limbs(c))
    return limbs


def _norm_descending(descending, n_cols, what="order_by"):
    """Normalize a descending spec to one bool per column."""
    if descending is None:
        return [False] * n_cols
    if isinstance(descending, bool):
        return [descending] * n_cols
    desc = [bool(d) for d in descending]
    if len(desc) != n_cols:
        raise ValueError(
            f"descending must match {what} ({n_cols} columns), "
            f"got {len(desc)} flags"
        )
    return desc


def _order_limbs(o_cols, descending):
    """Order-key limbs honoring per-column direction: complementing every
    limb word of an order-preserving big-endian encoding reverses its
    lexicographic order while preserving equality (ties stay ties)."""
    limbs = []
    for c, d in zip(o_cols, descending):
        enc = K.encode_limbs(c)
        limbs.extend([jnp.bitwise_not(w) for w in enc] if d else enc)
    return limbs


def _limbs_differ(limbs_a, limbs_b):
    d = limbs_a[0] != limbs_b[0]
    for a, b in zip(limbs_a[1:], limbs_b[1:]):
        d = d | (a != b)
    return d


def _boundary(limbs, n):
    """first-row-of-run flags for consecutive equal rows of a limb list."""
    if not limbs:
        return jnp.zeros((n,), jnp.bool_).at[0].set(True)
    return jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         _limbs_differ([w[1:] for w in limbs], [w[:-1] for w in limbs])]
    )


def _shift_back(arr, s, fill):
    return jnp.concatenate([jnp.full((s,), fill, arr.dtype), arr[:-s]])


def _seg_scan(vals, rn0, combine, identity):
    """Inclusive segmented scan (Hillis–Steele doubling): position i gets
    combine over its partition's rows [start, i]. ``rn0`` is the 0-based
    offset within the partition; an element ``s`` back is in-partition iff
    ``rn0 >= s``. log2(n) unrolled elementwise sweeps."""
    n = vals.shape[0]
    w = vals
    s = 1
    while s < n:
        prev = _shift_back(w, s, identity)
        w = jnp.where(rn0 >= s, combine(w, prev), w)
        s *= 2
    return w


def _pow2_tables(vals, max_len, combine, identity):
    """Sparse table for sliding frames: ``tables[k][i]`` = combine over
    ``vals[i - 2**k + 1 .. i]`` (identity-padded past the left edge).
    Levels up to the smallest power of two >= ``max_len`` — log2 shifted
    elementwise sweeps, same cost shape as :func:`_seg_scan`."""
    tables = [vals]
    s = 1
    while s < max_len:
        tables.append(
            combine(tables[-1], _shift_back(tables[-1], s, identity))
        )
        s *= 2
    return tables


def _rolling_two_windows(tables, ws, we):
    """The classic idempotent-reduce trick: a window [ws, we] is covered by
    two overlapping power-of-2 windows of span ``2**floor(log2(len))`` ending
    at ``we`` and starting at ``ws``. Returns the two table entries (the
    caller combines them); two gathers over the stacked (levels, n) table."""
    st = jnp.stack(tables)
    L = we - ws + 1
    k = jnp.int32(31) - jax.lax.clz(L)  # floor(log2(L)); L >= 1
    span = jnp.left_shift(jnp.int32(1), k)
    return st[k, we], st[k, ws + span - 1]


def _binary_decomp_sum(tables, ws, we, zero):
    """Window sum from the binary decomposition of the window length:
    walk the length's bits from the top, taking one power-of-2 table entry
    (a balanced tree sum) per set bit. Accuracy ~ULP(window_sum) x
    log2(max_len) — no prefix-difference cancellation. One gather per
    level (static unroll)."""
    n = tables[0].shape[0]
    L = we - ws + 1
    acc = jnp.full(L.shape, zero, tables[0].dtype)
    pos = we
    for k in reversed(range(len(tables))):
        take = ((L >> k) & 1) == 1
        piece = tables[k][jnp.clip(pos, 0, n - 1)]
        acc = acc + jnp.where(take, piece, zero)
        pos = pos - jnp.where(take, jnp.int32(1 << k), 0)
    return acc


def _range_delta(ov, d):
    """A frame bound delta in the order column's dtype (ints reject
    fractional deltas instead of silently truncating). An
    ``("interval", days, us)`` marker resolves by dtype: int64
    epoch-microseconds columns take days*86.4e9 + us, int32 epoch-days
    columns take days (sub-day parts rejected)."""
    if isinstance(d, tuple) and len(d) == 3 and d[0] == "interval":
        _, days, us = d
        if ov.dtype == jnp.int64:
            d = days * 86_400_000_000 + us
        elif us:
            raise ValueError(
                "a sub-day INTERVAL RANGE bound needs an int64 "
                "epoch-microseconds order column (a DATE has no time "
                "of day)"
            )
        else:
            d = days
    if jnp.issubdtype(ov.dtype, jnp.floating):
        return ov.dtype.type(d)
    if isinstance(d, float) and not d.is_integer():
        raise ValueError(
            f"RANGE bound {d!r} is fractional but the order column is "
            f"{ov.dtype}"
        )
    return ov.dtype.type(int(d))


def _mean_dt(dt):
    return jnp.float64 if dt == jnp.float64 else jnp.float32


def window(ops, *, partition_by=None, order_by=None, descending=None):
    """Evaluate window functions over partitions.

    ``ops`` is one spec or a list of specs, each:

      - ``"row_number"`` — 1-based position within the partition in
        ``order_by`` order (ties broken by input order; deterministic);
      - ``"rank"`` / ``"dense_rank"`` — SQL semantics over ``order_by``
        ties (with no ``order_by`` every row ranks 1);
      - ``"percent_rank"`` / ``"cume_dist"`` — SQL relative ranks:
        ``(rank-1)/(count-1)`` (0 for single-row partitions) and
        ``peers_through_self / count``, both float32;
      - ``"count"`` — partition size, broadcast to every row;
      - ``("ntile", n)`` — 1-based bucket of an n-way even split of the
        partition (first ``count mod n`` buckets one row larger);
      - ``(agg, values)`` with agg in sum/min/max/mean — partition-wide
        aggregate broadcast to every row;
      - ``("cumsum"|"cummin"|"cummax", values)`` — running aggregate over
        the partition's rows up to and including the current row;
      - ``("first_value"|"last_value", values)`` — the partition's
        first/last row's value under ``order_by``;
      - ``("nth_value", values, k[, fill])`` — the partition's k-th row's
        value under ``order_by`` (fill where the partition has < k rows);
      - ``("lag"|"lead", values[, offset[, fill]])`` — the value ``offset``
        rows back/ahead within the partition (default offset 1, fill 0);
      - ``("rolling_sum"|"rolling_min"|"rolling_max"|"rolling_mean",
        values, preceding[, following])`` and ``("rolling_count",
        preceding[, following])`` — sliding-frame aggregates over ``ROWS
        BETWEEN preceding PRECEDING AND following FOLLOWING`` (following
        defaults 0), clamped to the partition. Frame bounds are static
        ints. Integer rolling sums are exact (modular prefix difference);
        float rolling sums take a binary-decomposition of power-of-2 tree
        sums (~ULP(window_sum) x log accuracy, no prefix cancellation);
        min/max use the two-overlapping-windows sparse table.

    ``partition_by`` / ``order_by``: None, a column, or a list of columns
    (any supported dtype mix; multi-column keys order lexicographically).
    With ``partition_by=None`` the whole input is one partition.
    ``descending``: None, one bool, or one bool per ``order_by`` column —
    reverses that column's direction (ties still break by input order).

    Returns one array per spec (a single array if ``ops`` was a single
    spec), aligned with the INPUT row order. Integer sums are exact
    (modular); float partition sums use an independent per-group
    segmented reduction (ULP(group_sum) accuracy); float running sums use
    a log-depth segmented scan (tree-reduction accuracy, better than the
    global prefix-difference trick's cancellation).
    """
    single = isinstance(ops, (str, tuple))
    specs = [_normalize_spec(ops)] if single else [
        _normalize_spec(s) for s in ops
    ]
    if not specs:
        raise ValueError("ops must contain at least one window op")

    p_cols = ([] if partition_by is None else
              list(partition_by) if isinstance(partition_by, (list, tuple))
              else [partition_by])
    o_cols = ([] if order_by is None else
              list(order_by) if isinstance(order_by, (list, tuple))
              else [order_by])

    # infer n and validate lengths
    n = None
    for c in p_cols + o_cols + [s[1] for s in specs if s[1] is not None]:
        if n is None:
            n = c.shape[0]
        elif c.shape[0] != n:
            raise ValueError("all partition/order/value columns must have "
                             "equal length")
    if n is None:
        raise ValueError("window needs at least one column to infer length "
                         "(partition_by, order_by, or a value column)")

    def _out_dt(name, values):
        if name in ("percent_rank", "cume_dist"):
            return jnp.float32
        if name in _RANK_OPS or name in _PARAM_OPS:
            return jnp.int32
        if name in ("mean", "rolling_mean"):
            return _mean_dt(values.dtype)
        return values.dtype

    if n == 0:
        outs = [jnp.zeros((0,), _out_dt(nm, v)) for nm, v, _, _, _ in specs]
        return outs[0] if single else outs

    p_limbs = _cols_to_limbs(p_cols)
    o_limbs = _order_limbs(o_cols, _norm_descending(descending,
                                                    len(o_cols)))

    has_range = any(nm in _RANGE_OPS for nm, *_ in specs)
    if has_range:
        if len(o_cols) != 1:
            raise ValueError(
                "RANGE frames need exactly one order_by column"
            )
        if _norm_descending(descending, 1)[0]:
            raise ValueError(
                "RANGE frames need an ascending order_by column"
            )

    # one stable sort by (partition, order); position + value columns ride
    pos = jnp.arange(n, dtype=jnp.int32)
    val_ids, val_arrays = {}, []
    for _, v, _, _, _ in specs:
        if v is not None and id(v) not in val_ids:
            val_ids[id(v)] = len(val_arrays)
            val_arrays.append(v)
    if has_range and id(o_cols[0]) not in val_ids:
        # the raw order values ride the sort: RANGE bounds are value
        # deltas against them
        val_ids[id(o_cols[0])] = len(val_arrays)
        val_arrays.append(o_cols[0])
    nk = len(p_limbs) + len(o_limbs)
    if nk:
        out = jax.lax.sort(
            [*p_limbs, *o_limbs, pos, *val_arrays],
            num_keys=nk, is_stable=True,
        )
        sp = list(out[:len(p_limbs)])
        so = list(out[len(p_limbs):nk])
        pos_s = out[nk]
        vals_s = list(out[nk + 1:])
    else:
        sp, so, pos_s, vals_s = [], [], pos, val_arrays

    i = jnp.arange(n, dtype=jnp.int32)
    big = jnp.int32(2**31 - 1)
    part_first = _boundary(sp, n)
    part_last = jnp.concatenate([part_first[1:], jnp.ones((1,), jnp.bool_)])
    start = jax.lax.cummax(jnp.where(part_first, i, -1))
    pend = jax.lax.cummin(jnp.where(part_last, i, big), reverse=True)
    rn0 = i - start
    gid = jnp.cumsum(part_first.astype(jnp.int32)) - 1

    # (partition, order) run boundaries for rank/dense_rank
    order_first = part_first | _boundary(so, n) if so else part_first

    def _sv(spec_v):
        return vals_s[val_ids[id(spec_v)]]

    range_bounds_cache = {}

    def _range_bounds(p1, p2):
        """Frame row bounds [ws, we] for a RANGE frame: the rows of the
        current partition whose order value lies in
        [ov - p1, ov + p2] (None = unbounded side). Computed by the
        engine's merge-rank searchsorted over the already-sorted
        (partition, order) keys — two extra union sorts per distinct
        frame, no per-row binary search."""
        key = (p1, p2)
        if key in range_bounds_cache:
            return range_bounds_cache[key]
        from radix_sort_tpu.ops import query as Q

        ov = vals_s[val_ids[id(o_cols[0])]]
        data = [*sp, *so]
        unsigned = jnp.issubdtype(ov.dtype, jnp.unsignedinteger)
        if p1 is None:
            ws = start
        else:
            d = _range_delta(ov, p1)
            lo_v = ov - (jnp.minimum(ov, d) if unsigned else d)
            ws = jnp.clip(
                Q.merge_rank(data, [*sp, *K.encode_limbs(lo_v)],
                             side="left"), start, pend
            )
        if p2 is None:
            we = pend
        else:
            d = _range_delta(ov, p2)
            if unsigned:
                room = jnp.array(jnp.iinfo(ov.dtype).max, ov.dtype) - ov
                d = jnp.minimum(room, d)
            hi_v = ov + d
            we = jnp.clip(
                Q.merge_rank(data, [*sp, *K.encode_limbs(hi_v)],
                             side="right") - 1,
                start, pend,
            )
        range_bounds_cache[key] = (ws, we)
        return ws, we

    results = []
    for name, v, p1, p2, fill in specs:
        offset = p1  # lag/lead shift; nth_value's k; ntile's bucket count
        if name == "row_number":
            results.append(rn0 + 1)
        elif name == "rank":
            run_start = jax.lax.cummax(jnp.where(order_first, i, -1))
            results.append(run_start - start + 1)
        elif name == "dense_rank":
            rid = jnp.cumsum(order_first.astype(jnp.int32))
            rid_start = jax.lax.cummax(jnp.where(part_first, rid, 0))
            results.append(rid - rid_start + 1)
        elif name == "count":
            results.append(pend - start + 1)
        elif name == "percent_rank":
            run_start = jax.lax.cummax(jnp.where(order_first, i, -1))
            rank = run_start - start + 1
            cnt = pend - start + 1
            denom = jnp.maximum(cnt - 1, 1).astype(jnp.float32)
            results.append(
                jnp.where(
                    cnt > 1, (rank - 1).astype(jnp.float32) / denom, 0.0
                )
            )
        elif name == "cume_dist":
            order_last = jnp.concatenate(
                [order_first[1:], jnp.ones((1,), jnp.bool_)]
            )
            run_end = jax.lax.cummin(
                jnp.where(order_last, i, big), reverse=True
            )
            cnt = pend - start + 1
            results.append(
                (run_end - start + 1).astype(jnp.float32)
                / cnt.astype(jnp.float32)
            )
        elif name == "ntile":
            cnt = pend - start + 1
            base = cnt // offset
            extra = cnt % offset
            thr = extra * (base + 1)
            # base == 0 (fewer rows than buckets): thr == cnt, so every row
            # takes the first branch and the max() guard below stays inert
            tile = jnp.where(
                rn0 < thr,
                rn0 // (base + 1),
                extra + (rn0 - thr) // jnp.maximum(base, 1),
            )
            results.append(tile.astype(jnp.int32) + 1)
        elif name == "rolling_count":
            ws = jnp.maximum(start, i - p1)
            we = jnp.minimum(pend, i + p2)
            results.append((we - ws + 1).astype(jnp.int32))
        elif name in _RANGE_OPS:
            ws, we = _range_bounds(p1, p2)
            if name == "range_count":
                results.append((we - ws + 1).astype(jnp.int32))
                continue
            sv = _sv(v)
            if name in ("range_min", "range_max"):
                w = K.encode(sv)
                if name == "range_min":
                    ident = jnp.array(jnp.iinfo(w.dtype).max, w.dtype)
                    comb = jnp.minimum
                else:
                    ident = jnp.array(0, w.dtype)
                    comb = jnp.maximum
                # frame lengths are data-dependent (up to the partition
                # size): full log2(n)-level sparse table, O(n log n)
                tables = _pow2_tables(w, n, comb, ident)
                a, b = _rolling_two_windows(tables, ws, we)
                results.append(K.decode(comb(a, b), sv.dtype))
            else:  # range_sum / range_mean
                if jnp.issubdtype(sv.dtype, jnp.floating):
                    tables = _pow2_tables(sv, n, jnp.add,
                                          sv.dtype.type(0))
                    s = _binary_decomp_sum(tables, ws, we,
                                           sv.dtype.type(0))
                else:
                    csum = jnp.cumsum(sv)
                    prev = jnp.where(
                        ws > 0, csum[jnp.maximum(ws - 1, 0)], 0
                    )
                    s = csum[we] - prev  # exact under modular arithmetic
                if name == "range_mean":
                    mdt = _mean_dt(sv.dtype)
                    s = s.astype(mdt) / (we - ws + 1).astype(mdt)
                results.append(s)
        elif name in _ROLLING_OPS:
            sv = _sv(v)
            ws = jnp.maximum(start, i - p1)
            we = jnp.minimum(pend, i + p2)
            max_len = p1 + p2 + 1
            if name in ("rolling_min", "rolling_max"):
                w = K.encode(sv)
                if name == "rolling_min":
                    ident = jnp.array(jnp.iinfo(w.dtype).max, w.dtype)
                    comb = jnp.minimum
                else:
                    ident = jnp.array(0, w.dtype)
                    comb = jnp.maximum
                tables = _pow2_tables(w, max_len, comb, ident)
                a, b = _rolling_two_windows(tables, ws, we)
                results.append(K.decode(comb(a, b), sv.dtype))
            else:  # rolling_sum / rolling_mean
                if jnp.issubdtype(sv.dtype, jnp.floating):
                    tables = _pow2_tables(
                        sv, max_len, jnp.add, sv.dtype.type(0)
                    )
                    s = _binary_decomp_sum(tables, ws, we, sv.dtype.type(0))
                else:
                    csum = jnp.cumsum(sv)
                    prev = jnp.where(
                        ws > 0, csum[jnp.maximum(ws - 1, 0)], 0
                    )
                    s = csum[we] - prev  # exact under modular arithmetic
                if name == "rolling_mean":
                    mdt = _mean_dt(sv.dtype)
                    s = s.astype(mdt) / (we - ws + 1).astype(mdt)
                results.append(s)
        elif name in ("sum", "mean", "cumsum"):
            sv = _sv(v)
            is_float = jnp.issubdtype(sv.dtype, jnp.floating)
            if name == "cumsum":
                if is_float:
                    run = _seg_scan(sv, rn0, jnp.add, sv.dtype.type(0))
                else:
                    csum = jnp.cumsum(sv)
                    before = jnp.where(
                        start > 0, csum[jnp.maximum(start - 1, 0)], 0
                    )
                    run = csum - before  # exact under modular arithmetic
                results.append(run)
                continue
            if is_float:
                seg = jax.ops.segment_sum(
                    sv, gid, num_segments=n, indices_are_sorted=True
                )
                total = seg[gid]
            else:
                csum = jnp.cumsum(sv)
                before = jnp.where(
                    start > 0, csum[jnp.maximum(start - 1, 0)], 0
                )
                total = csum[pend] - before
            if name == "mean":
                mdt = _mean_dt(sv.dtype)
                cnt = (pend - start + 1).astype(mdt)
                total = total.astype(mdt) / cnt
            results.append(total)
        elif name in ("min", "max"):
            sv = _sv(v)
            w = K.encode(sv)
            seg = (jax.ops.segment_min if name == "min"
                   else jax.ops.segment_max)(
                w, gid, num_segments=n, indices_are_sorted=True
            )
            results.append(K.decode(seg[gid], sv.dtype))
        elif name in ("cummin", "cummax"):
            sv = _sv(v)
            w = K.encode(sv)
            ident = (jnp.iinfo(w.dtype).max if name == "cummin"
                     else jnp.array(0, w.dtype))
            comb = jnp.minimum if name == "cummin" else jnp.maximum
            run = _seg_scan(w, rn0, comb, ident)
            results.append(K.decode(run, sv.dtype))
        elif name == "first_value":
            sv = _sv(v)
            results.append(sv[start])
        elif name == "last_value":
            sv = _sv(v)
            results.append(sv[pend])
        elif name == "nth_value":
            sv = _sv(v)
            fill_v = sv.dtype.type(0) if fill is None else jnp.asarray(
                fill, sv.dtype
            )
            idx = start + (offset - 1)
            ok = idx <= pend
            results.append(
                jnp.where(ok, sv[jnp.clip(idx, 0, n - 1)], fill_v)
            )
        else:  # lag / lead
            sv = _sv(v)
            fill_v = sv.dtype.type(0) if fill is None else jnp.asarray(
                fill, sv.dtype
            )
            k = min(offset, n)
            if name == "lag":
                shifted = _shift_back(sv, k, fill_v)
                ok = rn0 >= k
            else:
                shifted = jnp.concatenate(
                    [sv[k:], jnp.full((k,), fill_v, sv.dtype)]
                )
                ok = i + k <= pend
            results.append(jnp.where(ok, shifted, fill_v))

    if nk:
        # back to input order. pos_s is a permutation, so this is one
        # scatter per column — not a sort keyed by pos_s, which XLA:GPU's
        # permutation-sort rewrite turns into an invalid scatter when the
        # carried columns mix dtypes
        results = [jnp.zeros_like(r).at[pos_s].set(r, unique_indices=True)
                   for r in results]
    return results[0] if single else results
