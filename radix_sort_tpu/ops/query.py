"""Vectorized query operators: filter, hash_join, hash_aggregate.

The north-star operator set layered over the sort engine (BASELINE.json;
the reference crate itself is sort-only — these are the query-engine
capabilities this engine adds on top, built from sorts and scans):

  - ``filter``: predicate compaction as a stable 1-bit partition — kept rows
    keep their order, the result is the valid prefix (static shapes + count,
    the standard XLA convention for data-dependent sizes).
  - ``hash_aggregate``: group-by + {sum, count, min, max}. On a vector
    machine the classic hash table serializes; the massively-parallel
    equivalent is sort-based aggregation: stable sort by key, mark group
    boundaries, segment-reduce with cumulative sums. Same contract as a
    hash aggregate (unique keys in some order + one aggregate per key).
  - ``hash_join``: inner equi-join via sort + binary search (sort-merge
    join): the build side is sorted once, probes binary-search their key
    range, matches expand with prefix-sum addressing into a static-capacity
    output (+ overflow flag).

All outputs are (padded arrays..., count) — concatenating/slicing the first
``count`` rows gives the exact ragged result. Key dtypes: any supported by
:mod:`radix_sort_tpu.keys`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radix_sort_tpu import keys as K

__all__ = [
    "append_unmatched_right",
    "band_join",
    "BAND_OPS",
    "filter",
    "hash_aggregate",
    "hash_join",
    "repeat",
    "unique",
    "searchsorted",
    "AGGREGATIONS",
    "JOIN_HOWS",
]

AGGREGATIONS = (
    "sum", "count", "min", "max", "mean",
    "any", "all",                 # bool OR / AND over (value != 0)
    "first", "last",              # group's first/last value in input order
    "median",                     # lower order statistic (exact)
    "mode",                       # most frequent value (ties: smallest)
    "var", "std",                 # population variance / stddev (two-pass)
    "count_distinct",             # distinct values per group
    "argmin", "argmax",           # input position of the group min/max
)
# "quantile:<q>" (0 <= q <= 1) is also accepted anywhere an aggregation
# name is: the group's lower order statistic at rank floor(q*(len-1)) —
# PERCENTILE_DISC semantics; "quantile:0.5" == "median". Parsed by
# quantile_q(). "quantile_cont:<q>" is the interpolated variant
# (PERCENTILE_CONT: linear between the two bracketing order statistics,
# float32 output).


def quantile_q(agg):
    """The q of a ``"quantile:<q>"`` / ``"quantile_cont:<q>"``
    aggregation name, else None."""
    if isinstance(agg, str) and (agg.startswith("quantile:")
                                 or agg.startswith("quantile_cont:")):
        try:
            q = float(agg.split(":", 1)[1])
        except ValueError:
            return None
        if 0.0 <= q <= 1.0:
            return q
    return None


def quantile_is_cont(agg):
    return isinstance(agg, str) and agg.startswith("quantile_cont:")


def valid_agg(agg):
    return agg in AGGREGATIONS or quantile_q(agg) is not None
# aggregations whose per-shard partials combine with a plain reduction
# (holistic ones need the repartition plan — parallel/dist_query.py)
COMBINABLE_AGGREGATIONS = ("sum", "count", "min", "max", "mean",
                           "any", "all")
JOIN_HOWS = ("inner", "left", "right", "full", "semi", "anti")


def _stable_sort(operands, num_keys):
    return jax.lax.sort(list(operands), num_keys=num_keys, is_stable=True)


def _as_limb_list(arr_or_limbs):
    """Canonicalize a key operand: a single word array or a list of
    big-endian limb arrays -> list of limb arrays."""
    if isinstance(arr_or_limbs, (list, tuple)):
        return list(arr_or_limbs)
    return [arr_or_limbs]


def _cols_to_limbs(cols):
    """Encode key columns -> (flat uint32 limb list, per-column specs)."""
    limbs, specs = [], []
    for c in cols:
        cl = K.encode_limbs(c)
        limbs.extend(cl)
        specs.append((c.dtype, len(cl)))
    return limbs, specs


def _limbs_to_cols(limbs, specs):
    """Inverse of :func:`_cols_to_limbs`."""
    out, i = [], 0
    for dt, nl in specs:
        out.append(K.decode_limbs(limbs[i:i + nl], dt))
        i += nl
    return out


def _limbs_differ(limbs_a, limbs_b):
    """Row-wise 'any limb differs' between two equal-shape limb lists."""
    d = limbs_a[0] != limbs_b[0]
    for a, b in zip(limbs_a[1:], limbs_b[1:]):
        d = d | (a != b)
    return d


def merge_rank(sorted_arr, queries, side="left"):
    """``jnp.searchsorted(sorted_arr, queries, side)`` at comparator rate.

    jnp.searchsorted lowers to a per-query binary search — ~24 dependent
    device gathers each. Two stable variadic sorts produce the same
    indices: sort the union by (key, origin-tag) — ties put queries before data for
    side="left" and after for side="right" — then each query's insertion
    index is its union position minus its rank among queries; a second sort
    restores original query order.

    Both key operands may be lists of big-endian uint32 limb arrays
    (composite / multi-column keys): the union sorts simply take more key
    operands, everything else is width-independent.
    """
    d_limbs = _as_limb_list(sorted_arr)
    q_limbs = _as_limb_list(queries)
    n_d = d_limbs[0].shape[0]
    n_q = q_limbs[0].shape[0]
    if len(d_limbs) == 1 and _few_queries(n_d, n_q):
        return jnp.searchsorted(d_limbs[0], q_limbs[0], side=side).astype(
            jnp.int32
        )
    # tag and query index share one int32 operand: queries carry their index
    # (< 2^31), data rows a sentinel that ties to the correct side —
    # INT32_MAX puts data after equal queries (side="left"), -1 before
    # (side="right")
    big = jnp.int32(2**31 - 1)
    sentinel = big if side == "left" else jnp.int32(-1)
    key = [jnp.concatenate([d, q]) for d, q in zip(d_limbs, q_limbs)]
    packed = jnp.concatenate(
        [jnp.full((n_d,), sentinel), jnp.arange(n_q, dtype=jnp.int32)]
    )
    out = _stable_sort([*key, packed], num_keys=len(key) + 1)
    p2 = out[-1]
    isq = (p2 != sentinel).astype(jnp.int32)
    rank_q = jnp.cumsum(isq) - isq
    res = jnp.arange(n_d + n_q, dtype=jnp.int32) - rank_q
    # bring queries to the front in original index order (data rows all get
    # the MAX restore key; their relative order is irrelevant)
    _, res2 = _stable_sort(
        [jnp.where(isq == 1, p2, big), res], num_keys=1
    )
    return res2[:n_q]


def _few_queries(n_d, n_q):
    """True when a direct binary search beats the merge-rank sorts: a
    binary search pays ~24 dependent gather rounds per query while each
    merge-rank sort pays one pass per union element, so searchsorted wins
    once the query side is much smaller than the data side. The 20x
    crossover is inherited from an earlier build and has not been
    re-measured on the GPU."""
    return n_q > 0 and n_q * 20 <= n_d


def merge_rank_pair(sorted_arr, queries):
    """Both ``searchsorted`` sides at once: returns ``(lo, hi)`` ==
    ``(merge_rank(..., "left"), merge_rank(..., "right"))`` with TWO variadic
    sorts instead of four.

    One stable union sort with queries tying before equal data gives each
    query its left rank directly (union position minus query rank). The
    right rank adds the query's equal-key data run: the data count at the
    run's END, backward-filled to every member of the run with a reversed
    cummin (data counts are non-decreasing, so the nearest run end to the
    right is the minimum among remaining ends). A final sort restores query
    order for both outputs together.

    Key operands may be limb lists (composite keys), as in ``merge_rank``.
    """
    d_limbs = _as_limb_list(sorted_arr)
    q_limbs = _as_limb_list(queries)
    n_d = d_limbs[0].shape[0]
    n_q = q_limbs[0].shape[0]
    if len(d_limbs) == 1 and _few_queries(n_d, n_q):
        return (
            jnp.searchsorted(d_limbs[0], q_limbs[0], side="left").astype(
                jnp.int32
            ),
            jnp.searchsorted(d_limbs[0], q_limbs[0], side="right").astype(
                jnp.int32
            ),
        )
    n = n_d + n_q
    big = jnp.int32(2**31 - 1)
    # one packed tag+index operand (see merge_rank): queries carry their
    # index, data rows INT32_MAX (ties after equal queries = "left" order)
    key = [jnp.concatenate([d, q]) for d, q in zip(d_limbs, q_limbs)]
    packed = jnp.concatenate(
        [jnp.full((n_d,), big), jnp.arange(n_q, dtype=jnp.int32)]
    )
    out = _stable_sort([*key, packed], num_keys=len(key) + 1)
    k2, p2 = out[:-1], out[-1]
    isq = (p2 != big).astype(jnp.int32)
    rank_q = jnp.cumsum(isq) - isq
    lo_pos = jnp.arange(n, dtype=jnp.int32) - rank_q
    cum_data = jnp.cumsum(1 - isq)
    run_end = jnp.concatenate(
        [_limbs_differ([w[1:] for w in k2], [w[:-1] for w in k2]),
         jnp.ones((1,), jnp.bool_)]
    )
    hi_pos = jax.lax.cummin(
        jnp.where(run_end, cum_data, big), reverse=True
    )
    _, lo2, hi2 = _stable_sort(
        [jnp.where(isq == 1, p2, big), lo_pos, hi_pos], num_keys=1
    )
    return lo2[:n_q], hi2[:n_q]


def expand_offsets(starts: jnp.ndarray, capacity: int) -> jnp.ndarray:
    """Map output slot t in [0, capacity) to the last row whose (sorted)
    output offset ``starts[row]`` is <= t — the addressing step of a
    prefix-sum expansion (equivalent to
    ``merge_rank(starts, arange(capacity), side="right") - 1``).

    ``starts`` is already sorted, so no rank-by-sorting is needed: scatter
    each row index at its start slot (max resolves duplicate offsets from
    zero-match rows to the later row, exactly like a side="right" rank) and
    forward-fill with a running max. Costs one len(starts)-sized scatter +
    one capacity-sized cummax instead of two capacity-sized variadic sorts
    (~2x cheaper at equal sizes, ~free for small ``starts``). Out-of-range
    offsets (>= capacity, e.g. an INT32_MAX wraparound poison) are dropped.
    Slots before the first start get -1.
    """
    seed = jnp.full((capacity,), -1, jnp.int32)
    seed = seed.at[starts].max(
        jnp.arange(starts.shape[0], dtype=jnp.int32), mode="drop"
    )
    return jax.lax.cummax(seed)


def filter(mask: jnp.ndarray, *arrays: jnp.ndarray):
    """Compact rows where ``mask`` is True, preserving order.

    Returns ``(*compacted, count)``: each output array has the input length;
    rows [0, count) are the kept rows in their original order, the tail is
    the dropped rows (also in order — the op is a stable partition).
    """
    if not arrays:
        raise ValueError("filter needs at least one array")
    n = mask.shape[0]
    for a in arrays:
        if a.shape[0] != n:
            raise ValueError(
                f"all arrays must match mask length {n}, got {a.shape}"
            )
    discard = (~mask).astype(jnp.uint32)
    out = _stable_sort([discard, *arrays], num_keys=1)
    count = jnp.sum(mask.astype(jnp.int32))
    return (*out[1:], count)


def hash_aggregate(keys, values, agg: str = "sum", *, _positions=None):
    """Group ``values`` by ``keys`` and reduce with ``agg``.

    Returns ``(unique_keys, aggregates, count)``: rows [0, count) hold one
    group each, keys in ascending key order (a deterministic, stronger
    contract than a hash aggregate's arbitrary order).

    ``keys`` may be a list/tuple of equal-length columns (composite GROUP BY
    key, any supported dtype mix); ``unique_keys`` is then a list of columns
    and groups order lexicographically (first column primary).

    ``values`` and ``agg`` may be parallel lists — the SQL multi-aggregate
    ``SELECT sum(a), min(b), count(*) ... GROUP BY k`` — sharing ONE key
    sort (see :func:`_hash_aggregate_multi`); ``aggregates`` is then a list.

    sum/count accumulate in the value dtype (modular for unsigned ints,
    IEEE for floats); min/max are exact for any supported dtype; mean is
    group sum / group count in float32 (float64 values keep float64).

    The holistic aggregations:
      - ``first`` / ``last``: the group's first/last value in INPUT order
        (deterministic — the key sort is stable);
      - ``median``: the exact lower median (order statistic at
        ``(count-1)//2`` under the value dtype's total order; dtype
        preserved — no interpolation);
      - ``var`` / ``std``: population variance / standard deviation
        (ddof=0), computed two-pass (mean, then squared deviations) with
        per-group segmented reductions — float32 (float64 values keep
        float64);
      - ``count_distinct``: distinct values per group (int32), exact.
      - ``mode``: the group's most frequent value (ties break to the
        SMALLEST value under the dtype's total order — deterministic);
      - ``argmin`` / ``argmax``: the INPUT position (int32) of the group's
        minimum / maximum value; ties break to the first occurrence in
        input order (like ``np.argmin`` per group).

    ``any`` / ``all`` (combinable) reduce the truth values ``value != 0``
    to one bool per group.

    ``_positions`` (internal): overrides the position column ``argmin`` /
    ``argmax`` report — the distributed repartition plan passes each row's
    original global position.
    """
    if isinstance(agg, (list, tuple)) or isinstance(values, (list, tuple)):
        if not (isinstance(agg, (list, tuple))
                and isinstance(values, (list, tuple))):
            raise ValueError(
                "multi-aggregate needs BOTH values and agg as lists"
            )
        if len(values) != len(agg) or not values:
            raise ValueError(
                "values and agg lists must be non-empty and equal-length"
            )
        return _hash_aggregate_multi(keys, list(values), list(agg),
                                     _positions=_positions)
    if not valid_agg(agg):
        raise ValueError(
            f"agg must be one of {AGGREGATIONS} or 'quantile:<q>', "
            f"got {agg!r}"
        )
    multi = isinstance(keys, (list, tuple))
    cols = list(keys) if multi else [keys]
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    for c in cols:
        if c.shape[0] != n:
            raise ValueError("all key columns must have equal length")
    if values.shape[0] != n:
        raise ValueError("keys and values must have the same length")
    if n == 0:
        vdt = (jnp.int32
               if agg in ("count", "count_distinct", "argmin", "argmax")
               else values.dtype)
        if agg in ("mean", "var", "std"):
            vdt = jnp.float64 if values.dtype == jnp.float64 else jnp.float32
        if agg in ("any", "all"):
            vdt = jnp.bool_
        return keys, jnp.zeros((0,), vdt), jnp.int32(0)
    if agg == "mean":
        mdt = jnp.float64 if values.dtype == jnp.float64 else jnp.float32
        uk, sums, count = hash_aggregate(keys, values, "sum")
        _, cnts, _ = hash_aggregate(keys, values, "count")
        means = sums.astype(mdt) / jnp.maximum(cnts, 1).astype(mdt)
        return uk, means, count
    limbs, specs = _cols_to_limbs(cols)
    nk = len(limbs)

    sposr = None
    if (agg in ("min", "max", "median", "count_distinct", "mode",
                "argmin", "argmax") or quantile_q(agg) is not None):
        # sort by (key, value): the group's order statistics sit at known
        # offsets and (key, value) runs mark distinct values
        vw = K.encode(values)
        if agg in ("argmin", "argmax"):
            posr = (_positions if _positions is not None
                    else jnp.arange(n, dtype=jnp.int32))
            out = _stable_sort([*limbs, vw, posr], num_keys=nk + 1)
            sk, svw, sposr = list(out[:-2]), out[-2], out[-1]
        else:
            out = _stable_sort([*limbs, vw], num_keys=nk + 1)
            sk, svw = list(out[:-1]), out[-1]
        sv = K.decode(svw, values.dtype)
    else:
        out = _stable_sort([*limbs, values], num_keys=nk)
        sk, sv = list(out[:-1]), out[-1]

    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         _limbs_differ([w[1:] for w in sk], [w[:-1] for w in sk])]
    )
    last = jnp.concatenate([first[1:], jnp.ones((1,), jnp.bool_)])

    uk_cols = _limbs_to_cols(sk, specs)

    def _pack(keys_out):
        return keys_out if multi else keys_out[0]

    if agg in ("first", "last"):
        pick = first if agg == "first" else last
        *out_keys, out_vals, count = filter(pick, *uk_cols, sv)
        return _pack(out_keys), out_vals, count
    if agg == "median" or quantile_q(agg) is not None:
        # the group's lower order statistic at floor(q*(len-1)) — exact
        # integer halving for the median; float32 rank math for general q
        # (1-index boundary tolerance only beyond ~2^24-row groups)
        q = 0.5 if agg == "median" else quantile_q(agg)
        pos = jnp.arange(n, dtype=jnp.int32)
        *out_keys, ends_c, count = filter(last, *uk_cols, pos)
        starts_c = jnp.roll(ends_c, 1).at[0].set(-1) + 1
        span = ends_c - starts_c
        if quantile_is_cont(agg):
            # PERCENTILE_CONT: rank r = q*(len-1) interpolates linearly
            # between the bracketing order statistics. Interpolate in
            # float64 whenever x64 is enabled so wide int64 values stay
            # exact; float32 otherwise (documented in sql.py)
            ft = jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
            r = span.astype(ft) * q
            lo = jnp.floor(r + 1e-6).astype(jnp.int32)
            lo = jnp.clip(lo, 0, span)
            hi = jnp.minimum(lo + 1, span)
            frac = (r - lo.astype(ft)).clip(0.0, 1.0)
            vlo = sv[jnp.clip(starts_c + lo, 0, n - 1)].astype(ft)
            vhi = sv[jnp.clip(starts_c + hi, 0, n - 1)].astype(ft)
            return _pack(out_keys), vlo + frac * (vhi - vlo), count
        if agg == "median":
            off = span // 2
        else:
            off = jnp.floor(span.astype(jnp.float32) * q
                            + 1e-6).astype(jnp.int32)
        q_idx = starts_c + jnp.clip(off, 0, span)
        return _pack(out_keys), sv[jnp.clip(q_idx, 0, n - 1)], count
    if agg in ("argmin", "argmax"):
        # (key, value)-sorted with positions riding: the group's first row
        # holds argmin; the first row of its LAST value run holds argmax
        # (stable sort -> first occurrence among ties, both cases)
        pos = jnp.arange(n, dtype=jnp.int32)
        *out_keys, ends_c, count = filter(last, *uk_cols, pos)
        if agg == "argmin":
            idx = jnp.roll(ends_c, 1).at[0].set(-1) + 1  # group starts
        else:
            kv_first = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_),
                 _limbs_differ([w[1:] for w in sk] + [svw[1:]],
                               [w[:-1] for w in sk] + [svw[:-1]])]
            )
            run_start = jax.lax.cummax(jnp.where(kv_first, pos, -1))
            idx = run_start[jnp.clip(ends_c, 0, n - 1)]
        return (_pack(out_keys),
                sposr[jnp.clip(idx, 0, n - 1)].astype(jnp.int32), count)
    if agg == "mode":
        # (key, value) runs: per-group max run length, ties to the FIRST
        # run (runs ascend by value -> the smallest value wins). A reverse
        # segmented doubling scan over (run_len, value word) pairs — every
        # row carries its run's pair — instead of two segment scatters
        pos = jnp.arange(n, dtype=jnp.int32)
        kv_first = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_),
             _limbs_differ([w[1:] for w in sk] + [svw[1:]],
                           [w[:-1] for w in sk] + [svw[:-1]])]
        )
        kv_last = jnp.concatenate([kv_first[1:], jnp.ones((1,), jnp.bool_)])
        big = jnp.int32(2**31 - 1)
        run_start = jax.lax.cummax(jnp.where(kv_first, pos, -1))
        run_end = jax.lax.cummin(jnp.where(kv_last, pos, big), reverse=True)
        run_len = run_end - run_start + 1
        pend = jax.lax.cummin(jnp.where(last, pos, big), reverse=True)
        best_l, best_w = run_len, svw
        s = 1
        while s < n:
            nl = jnp.concatenate([best_l[s:], jnp.zeros((s,), jnp.int32)])
            nw = jnp.concatenate(
                [best_w[s:], jnp.zeros((s,), best_w.dtype)]
            )
            ok = pos + s <= pend  # i+s still inside i's group
            better = ok & ((nl > best_l) | ((nl == best_l) & (nw < best_w)))
            best_l = jnp.where(better, nl, best_l)
            best_w = jnp.where(better, nw, best_w)
            s *= 2
        # group start rows hold the whole group's best; compact at starts
        *out_keys, ends_c, count = filter(last, *uk_cols, pos)
        starts_c = jnp.roll(ends_c, 1).at[0].set(-1) + 1
        w = best_w[jnp.clip(starts_c, 0, n - 1)]
        return _pack(out_keys), K.decode(w, values.dtype), count
    if agg in ("any", "all"):
        # exact via the int cumsum-difference: count of true rows per group
        t = (sv != 0).astype(jnp.uint32)
        pos = jnp.arange(n, dtype=jnp.int32)
        *out_keys, tcsum_c, ends_c, count = filter(
            last, *uk_cols, jnp.cumsum(t), pos
        )
        tprev = jnp.roll(tcsum_c, 1).at[0].set(0)
        ntrue = tcsum_c - tprev
        if agg == "any":
            out_v = ntrue > 0
        else:
            group_n = (ends_c - (jnp.roll(ends_c, 1).at[0].set(-1))
                       ).astype(jnp.uint32)
            out_v = ntrue == group_n
        return _pack(out_keys), out_v, count
    if agg == "count_distinct":
        # (key, value) run starts; per-group distinct count = exact
        # int32 prefix-difference of the run-start cumsum at group ends
        kv_first = jnp.concatenate(
            [jnp.ones((1,), jnp.bool_),
             _limbs_differ([w[1:] for w in sk] + [svw[1:]],
                           [w[:-1] for w in sk] + [svw[:-1]])]
        )
        csum = jnp.cumsum(kv_first.astype(jnp.int32))
        *out_keys, csum_c, count = filter(last, *uk_cols, csum)
        prev = jnp.roll(csum_c, 1).at[0].set(0)
        return _pack(out_keys), csum_c - prev, count
    if agg in ("var", "std"):
        mdt = jnp.float64 if values.dtype == jnp.float64 else jnp.float32
        x = sv.astype(mdt)
        gid = jnp.cumsum(first.astype(jnp.int32)) - 1
        ones = jnp.ones((n,), mdt)
        cntv = jax.ops.segment_sum(
            ones, gid, num_segments=n, indices_are_sorted=True
        )
        sums = jax.ops.segment_sum(
            x, gid, num_segments=n, indices_are_sorted=True
        )
        mean_g = sums / jnp.maximum(cntv, 1)
        d = x - mean_g[gid]
        m2 = jax.ops.segment_sum(
            d * d, gid, num_segments=n, indices_are_sorted=True
        )
        out_v = m2 / jnp.maximum(cntv, 1)
        if agg == "std":
            out_v = jnp.sqrt(out_v)
        # segment g is the g-th group in ascending key order == output row g
        *out_keys, _, count = filter(last, *uk_cols, sv)
        return _pack(out_keys), out_v, count
    if agg in ("sum", "count"):
        if agg == "count":
            sv = jnp.ones((n,), jnp.int32)
        if jnp.issubdtype(sv.dtype, jnp.floating):
            # floats: a per-group segmented reduction. The cumsum-difference
            # trick (int path below) inherits cancellation error proportional
            # to the whole preceding prefix — and so does ANY formulation
            # whose final combine is a prefix over partials: a blocked
            # two-level variant (block cumsums + boundary compaction) was
            # faster, but its group sums differ by ULP(total_sum) (~0.01
            # absolute at 16M uniforms) — reverted. segment_sum's
            # scatter-add accumulates each group independently at
            # ULP(group_sum) accuracy.
            gid = jnp.cumsum(first.astype(jnp.int32)) - 1
            seg = jax.ops.segment_sum(sv, gid, num_segments=n)
            *out_keys, _, count = filter(last, *uk_cols, sv)
            return _pack(out_keys), seg, count
        # ints: compact the running total at each group END; consecutive ends
        # then differ by exactly the group's sum (modular arithmetic is exact
        # under wraparound) — no segment fill or gather
        csum = jnp.cumsum(sv)
        *out_keys, csum_c, count = filter(last, *uk_cols, csum)
        prev = jnp.roll(csum_c, 1).at[0].set(0)
        return _pack(out_keys), csum_c - prev, count
    pick = first if agg == "min" else last
    *out_keys, out_vals, count = filter(pick, *uk_cols, sv)
    return _pack(out_keys), out_vals, count


def _hash_aggregate_multi(keys, val_cols, aggs, _positions=None):
    """Several aggregations over one GROUP BY, sharing a single key sort.

    All value columns ride the ONE stable sort by key limbs; per-group
    reductions then come from gid-indexed segment ops (float sums, min,
    max, var/std — `jax.ops.segment_*` with sorted segment ids) or the
    exact cumsum-difference trick (integer sums, counts), with every
    compacted-at-group-end quantity (incl. ``last`` values) going through
    one shared :func:`filter` call (``first`` values share a second).
    ``median`` / ``count_distinct`` need a different sort order —
    (key, value) — so each delegates to a single-aggregate call (one extra
    sort per such column; group order is identical, so rows align). Group
    j of every output is the j-th distinct key in ascending order.
    Returns ``(unique_keys, [aggregates...], count)``.
    """
    for a in aggs:
        if not valid_agg(a):
            raise ValueError(
                f"agg must be one of {AGGREGATIONS} or 'quantile:<q>', "
                f"got {a!r}"
            )
    multi_k = isinstance(keys, (list, tuple))
    cols = list(keys) if multi_k else [keys]
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    for x in cols[1:] + val_cols:
        if x.shape[0] != n:
            raise ValueError("all key/value columns must have equal length")

    def _mean_dt(dt):
        return jnp.float64 if dt == jnp.float64 else jnp.float32

    def _out_dt(a, dt):
        if a in ("count", "count_distinct", "argmin", "argmax"):
            return jnp.int32
        if a in ("mean", "var", "std"):
            return _mean_dt(dt)
        if a in ("any", "all"):
            return jnp.bool_
        return dt

    if n == 0:
        outs = [jnp.zeros((0,), _out_dt(a, v.dtype))
                for a, v in zip(aggs, val_cols)]
        return keys, outs, jnp.int32(0)

    # (key, value)-sorted holistic aggs delegate to single-agg calls (rows
    # align: both produce groups ascending by key)
    delegated = {
        i: hash_aggregate(keys, val_cols[i], a, _positions=_positions)[1]
        for i, a in enumerate(aggs)
        if (a in ("median", "count_distinct", "mode", "argmin", "argmax")
                or quantile_q(a) is not None)
    }

    limbs, specs = _cols_to_limbs(cols)
    nk = len(limbs)
    out = _stable_sort([*limbs, *val_cols], num_keys=nk)
    sk, svs = list(out[:nk]), list(out[nk:])
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         _limbs_differ([w[1:] for w in sk], [w[:-1] for w in sk])]
    )
    last = jnp.concatenate([first[1:], jnp.ones((1,), jnp.bool_)])
    gid = jnp.cumsum(first.astype(jnp.int32)) - 1
    uk_cols = _limbs_to_cols(sk, specs)

    # everything compacted at group ends goes through ONE filter: key
    # columns, the group-end position (-> per-group counts), the running
    # cumsum of every integer-sum column (exact under modular wraparound;
    # see the single-agg path), and every "last" value column
    needs_sum = [a in ("sum", "count", "mean") for a in aggs]
    int_sum_idx = [
        i for i, (a, sv) in enumerate(zip(aggs, svs))
        if needs_sum[i] and a != "count"
        and not jnp.issubdtype(sv.dtype, jnp.floating)
    ]
    last_idx = [i for i, a in enumerate(aggs) if a == "last"]
    first_idx = [i for i, a in enumerate(aggs) if a == "first"]
    anyall_idx = [i for i, a in enumerate(aggs) if a in ("any", "all")]
    csums = [jnp.cumsum(svs[i]) for i in int_sum_idx]
    tcsums = [jnp.cumsum((svs[i] != 0).astype(jnp.uint32))
              for i in anyall_idx]
    pos = jnp.arange(n, dtype=jnp.int32)
    *compacted, count = filter(
        last, *uk_cols, pos, *csums, *tcsums,
        *[svs[i] for i in last_idx]
    )
    out_keys = compacted[:len(uk_cols)]
    pos_c = compacted[len(uk_cols)]
    base = len(uk_cols) + 1
    csums_c = compacted[base:base + len(csums)]
    tcsums_c = compacted[base + len(csums):base + len(csums) + len(tcsums)]
    lasts_c = compacted[base + len(csums) + len(tcsums):]
    group_n = pos_c - (jnp.roll(pos_c, 1).at[0].set(-1))
    # "first" values share one more filter at group starts
    firsts_c = []
    if first_idx:
        *firsts_c, _ = filter(first, *[svs[i] for i in first_idx])

    def _diff(c):
        return c - jnp.roll(c, 1).at[0].set(0)

    int_sums = {i: _diff(c) for i, c in zip(int_sum_idx, csums_c)}
    ntrues = {i: _diff(c) for i, c in zip(anyall_idx, tcsums_c)}
    last_vals = dict(zip(last_idx, lasts_c))
    first_vals = dict(zip(first_idx, firsts_c))

    def _segsum(x):
        return jax.ops.segment_sum(
            x, gid, num_segments=n, indices_are_sorted=True
        )

    results = []
    for i, (a, sv) in enumerate(zip(aggs, svs)):
        if i in delegated:
            results.append(delegated[i])
            continue
        if a == "count":
            results.append(group_n.astype(jnp.int32))
            continue
        if a == "first":
            results.append(first_vals[i])
            continue
        if a == "last":
            results.append(last_vals[i])
            continue
        if a in ("any", "all"):
            results.append(ntrues[i] > 0 if a == "any"
                           else ntrues[i] == group_n.astype(jnp.uint32))
            continue
        is_float = jnp.issubdtype(sv.dtype, jnp.floating)
        if a in ("sum", "mean"):
            if is_float:
                s = _segsum(sv)
            else:
                s = int_sums[i]
            if a == "mean":
                mdt = _mean_dt(sv.dtype)
                s = s.astype(mdt) / jnp.maximum(group_n, 1).astype(mdt)
            results.append(s)
        elif a in ("var", "std"):
            # two-pass per-group moments (see the single-agg path);
            # segment g == compacted output row g, so group_n aligns
            mdt = _mean_dt(sv.dtype)
            x = sv.astype(mdt)
            cnt_g = jnp.maximum(group_n, 1).astype(mdt)
            mean_g = _segsum(x) / cnt_g
            d = x - mean_g[gid]
            v = _segsum(d * d) / cnt_g
            results.append(jnp.sqrt(v) if a == "std" else v)
        else:  # min / max — gid-indexed segment reduction on rank words
            w = K.encode(sv)
            seg = (jax.ops.segment_min if a == "min" else jax.ops.segment_max)(
                w, gid, num_segments=n, indices_are_sorted=True
            )
            # untouched segments hold the op identity (max/min word) in the
            # tail; rows [0, count) are all touched, so decode is exact there
            results.append(K.decode(seg, sv.dtype))
    return (out_keys if multi_k else out_keys[0]), results, count


# aggregations computable per PREFIX level from one shared full-key sort
# (segment/cumsum forms; excludes input-order-dependent first/last and the
# (key,value)-sorted holistics, which need their own sort per level)
LEVEL_AGGREGATIONS = ("sum", "count", "mean", "min", "max", "any", "all",
                      "var", "std")


def hash_aggregate_levels(keys, val_cols, aggs, level_cols):
    """Prefix-sharing multi-aggregate for GROUPING SETS chains: ONE
    stable sort by ALL key columns serves every leading-prefix level
    (data sorted by the full key list is also sorted by any prefix of
    it), so an L-level ROLLUP costs one n-row multi-key sort plus L
    cheap boundary/compaction sweeps instead of L full sorts.

    ``keys``: list of key columns. ``level_cols``: one leading-column
    count per level (0 = a single global group — the grand total).
    ``aggs`` must all be in :data:`LEVEL_AGGREGATIONS`; the integer
    sum/count/any/all levels share level-independent running cumsums
    (the cumsum-difference trick), float sums and min/max/var/std pay
    one segment reduction per level.

    Returns ``[(unique_key_cols, [aggregates...], count), ...]`` aligned
    with ``level_cols``, each shaped like :func:`hash_aggregate`'s
    output (padded to n; group j of a level = the j-th distinct key
    prefix in ascending order).

    GROUPING SETS / ROLLUP / CUBE has no reference-crate counterpart
    (src/radix_sort/mod.rs is sort-only); this is north-star
    query-engine surface built on the same sort machinery.
    """
    for a in aggs:
        if a not in LEVEL_AGGREGATIONS:
            raise ValueError(
                f"hash_aggregate_levels supports {LEVEL_AGGREGATIONS}, "
                f"got {a!r}"
            )
    cols = list(keys)
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    for x in list(cols[1:]) + list(val_cols):
        if x.shape[0] != n:
            raise ValueError("all key/value columns must have equal length")
    level_cols = [int(c) for c in level_cols]
    for c in level_cols:
        if not 0 <= c <= len(cols):
            raise ValueError(
                f"level column count {c} out of range 0..{len(cols)}"
            )

    def _mean_dt(dt):
        return jnp.float64 if dt == jnp.float64 else jnp.float32

    def _out_dt(a, dt):
        if a == "count":
            return jnp.int32
        if a in ("mean", "var", "std"):
            return _mean_dt(dt)
        if a in ("any", "all"):
            return jnp.bool_
        return dt

    if n == 0:
        return [
            (
                [jnp.zeros((0,), k.dtype) for k in cols[:c]],
                [jnp.zeros((0,), _out_dt(a, v.dtype))
                 for a, v in zip(aggs, val_cols)],
                jnp.int32(0),
            )
            for c in level_cols
        ]

    limbs, specs = _cols_to_limbs(cols)
    limb_at = [0]  # limb count of each leading-column prefix
    for _, nl in specs:
        limb_at.append(limb_at[-1] + nl)
    nk = len(limbs)
    out = _stable_sort([*limbs, *val_cols], num_keys=nk)
    sk, svs = list(out[:nk]), list(out[nk:])
    pos = jnp.arange(n, dtype=jnp.int32)
    uk_all = _limbs_to_cols(sk, specs)

    # level-INDEPENDENT running sums: one cumsum per integer-sum / truth
    # column serves every level (each level only re-compacts them)
    needs_sum = [a in ("sum", "mean") for a in aggs]
    int_sum_idx = [
        i for i, (a, sv) in enumerate(zip(aggs, svs))
        if needs_sum[i] and not jnp.issubdtype(sv.dtype, jnp.floating)
    ]
    anyall_idx = [i for i, a in enumerate(aggs) if a in ("any", "all")]
    csums = [jnp.cumsum(svs[i]) for i in int_sum_idx]
    tcsums = [jnp.cumsum((svs[i] != 0).astype(jnp.uint32))
              for i in anyall_idx]
    minmax_w = {
        i: K.encode(svs[i])
        for i, a in enumerate(aggs) if a in ("min", "max")
    }
    needs_gid = any(
        a in ("min", "max", "var", "std")
        or (needs_sum[i] and jnp.issubdtype(svs[i].dtype, jnp.floating))
        for i, a in enumerate(aggs)
    )

    def _diff(c):
        return c - jnp.roll(c, 1).at[0].set(0)

    results = []
    for c in level_cols:
        nl = limb_at[c]
        if nl == 0:
            firstk = pos == 0
            lastk = pos == n - 1
        else:
            firstk = jnp.concatenate(
                [jnp.ones((1,), jnp.bool_),
                 _limbs_differ([w[1:] for w in sk[:nl]],
                               [w[:-1] for w in sk[:nl]])]
            )
            lastk = jnp.concatenate(
                [firstk[1:], jnp.ones((1,), jnp.bool_)]
            )
        *compacted, count = filter(lastk, *uk_all[:c], pos,
                                   *csums, *tcsums)
        out_keys = list(compacted[:c])
        pos_c = compacted[c]
        csums_c = compacted[c + 1:c + 1 + len(csums)]
        tcsums_c = compacted[c + 1 + len(csums):]
        group_n = pos_c - (jnp.roll(pos_c, 1).at[0].set(-1))
        int_sums = {i: _diff(x) for i, x in zip(int_sum_idx, csums_c)}
        ntrues = {i: _diff(x) for i, x in zip(anyall_idx, tcsums_c)}
        gid = (jnp.cumsum(firstk.astype(jnp.int32)) - 1 if needs_gid
               else None)

        def _segsum(x):
            return jax.ops.segment_sum(
                x, gid, num_segments=n, indices_are_sorted=True
            )

        outs = []
        for i, (a, sv) in enumerate(zip(aggs, svs)):
            if a == "count":
                outs.append(group_n.astype(jnp.int32))
                continue
            if a in ("any", "all"):
                outs.append(ntrues[i] > 0 if a == "any"
                            else ntrues[i] == group_n.astype(jnp.uint32))
                continue
            if a in ("sum", "mean"):
                if jnp.issubdtype(sv.dtype, jnp.floating):
                    s = _segsum(sv)
                else:
                    s = int_sums[i]
                if a == "mean":
                    mdt = _mean_dt(sv.dtype)
                    s = s.astype(mdt) / jnp.maximum(group_n, 1).astype(mdt)
                outs.append(s)
            elif a in ("var", "std"):
                mdt = _mean_dt(sv.dtype)
                x = sv.astype(mdt)
                cnt_g = jnp.maximum(group_n, 1).astype(mdt)
                mean_g = _segsum(x) / cnt_g
                d = x - mean_g[gid]
                v = _segsum(d * d) / cnt_g
                outs.append(jnp.sqrt(v) if a == "std" else v)
            else:  # min / max — segment reduction on rank words
                seg = (jax.ops.segment_min if a == "min"
                       else jax.ops.segment_max)(
                    minmax_w[i], gid, num_segments=n,
                    indices_are_sorted=True
                )
                outs.append(K.decode(seg, sv.dtype))
        results.append((out_keys, outs, count))
    return results


def _expand_rows(cols, counts, total_size):
    """Shared UNNEST core: emit row i of every column ``counts[i]`` times,
    in order, into static ``total_size`` rows (the expansion index is
    computed once for all columns). Returns ``(outs, count, overflow)``
    with :func:`repeat`'s contract."""
    n = counts.shape[0]
    if n == 0:
        return (
            [jnp.zeros((total_size,), c.dtype) for c in cols],
            jnp.int32(0),
            jnp.bool_(False),
        )
    counts = jnp.maximum(counts.astype(jnp.int32), 0)
    starts = jnp.cumsum(counts) - counts
    total = starts[-1] + counts[-1]
    # int32 wraparound guard (see hash_join)
    mono = jax.lax.cummax(starts)
    wrapped = jnp.any(starts != mono) | (total < 0)
    big = jnp.int32(2**31 - 1)
    starts = jnp.where(starts == mono, starts, big)
    total = jnp.where(wrapped, big, total)
    cnt = jnp.minimum(total, total_size)
    t = jnp.arange(total_size, dtype=jnp.int32)
    i = jnp.clip(expand_offsets(starts, total_size), 0, n - 1)
    valid = t < cnt
    outs = [jnp.where(valid, c[i], 0) for c in cols]
    return outs, cnt, (total > total_size) | wrapped


def repeat(values: jnp.ndarray, counts: jnp.ndarray, *, total_size: int):
    """``np.repeat(values, counts)`` into a static-size output (the unnest
    primitive): element i is emitted ``counts[i]`` times, in order.

    Returns ``(out, count, overflow)``: rows [0, count) hold the expansion,
    the tail is 0. ``overflow`` is True if the true expansion exceeds
    ``total_size`` (the result then holds the first ``total_size`` rows,
    exactly).

    Scatter + cummax addressing (:func:`expand_offsets`) and one gather.
    """
    if counts.shape[0] != values.shape[0]:
        raise ValueError("values and counts must have the same length")
    n = values.shape[0]
    if n == 0:
        return (
            jnp.zeros((total_size,), values.dtype),
            jnp.int32(0),
            jnp.bool_(False),
        )
    counts = jnp.maximum(counts.astype(jnp.int32), 0)
    starts = jnp.cumsum(counts) - counts
    total = starts[-1] + counts[-1]
    # int32 wraparound guard (see hash_join)
    mono = jax.lax.cummax(starts)
    wrapped = jnp.any(starts != mono) | (total < 0)
    big = jnp.int32(2**31 - 1)
    starts = jnp.where(starts == mono, starts, big)
    total = jnp.where(wrapped, big, total)
    count = jnp.minimum(total, total_size)
    overflow = (total > total_size) | wrapped

    t = jnp.arange(total_size, dtype=jnp.int32)
    i = jnp.clip(expand_offsets(starts, total_size), 0, n - 1)
    out = jnp.where(t < count, values[i], 0)
    return out, count, overflow


def join_expand(
    lkw, left_values, rvs, lo, hi, *, capacity, how="inner", valid_left=None
):
    """The match-expansion phase shared by the single-chip and distributed
    joins: given each left row's sorted-right match range [lo, hi), emit the
    join result for ``how`` into static-``capacity`` output arrays.

    Operates on encoded key words (``lkw``); callers decode. ``lkw`` may be
    a single word array or a list of big-endian uint32 limb arrays
    (composite keys) — the returned ``key_words`` matches its shape.
    ``valid_left`` masks out padding rows (distributed shards). Returns
    ``(key_words, left_vals, right_vals, count, overflow)``.

    ``how="full"`` emits the left-join rows only (matched pairs + unmatched
    left); callers complete the full outer join by appending the unmatched
    right rows with :func:`append_unmatched_right`. ``how="right"`` is a
    side swap resolved by the callers — it never reaches this phase.
    """
    if how not in JOIN_HOWS or how == "right":
        raise ValueError(
            f"join_expand handles {tuple(h for h in JOIN_HOWS if h != 'right')},"
            f" got {how!r} (right joins swap sides before expansion)"
        )
    if how == "full":
        how = "left"
    multi = isinstance(lkw, (list, tuple))
    lkws = _as_limb_list(lkw)
    multi_lv = isinstance(left_values, (list, tuple))
    lvs = list(left_values) if multi_lv else [left_values]
    multi_rv = isinstance(rvs, (list, tuple))
    rvs_l = list(rvs) if multi_rv else [rvs]

    def _pack_lv(outs):
        return outs if multi_lv else outs[0]

    def _pack_rv(outs):
        return outs if multi_rv else outs[0]

    n_l = lkws[0].shape[0]
    matches = hi - lo
    if valid_left is not None:
        matches = jnp.where(valid_left, matches, 0)

    if how in ("semi", "anti"):
        # one output row per qualifying LEFT row, in left order — a stable
        # filter, no expansion
        sel = (matches > 0) if how == "semi" else (matches == 0)
        if valid_left is not None:
            sel = sel & valid_left
        *c_all, cnt = filter(sel, *lkws, *lvs)
        cks, cvs = c_all[:len(lkws)], c_all[len(lkws):]
        pad = capacity - n_l

        def _fit(a):
            if pad >= 0:
                return jnp.concatenate([a, jnp.zeros((pad,), a.dtype)])
            return a[:capacity]

        cks = [_fit(ck) for ck in cks]
        cvs = [_fit(cv) for cv in cvs]
        t = jnp.arange(capacity, dtype=jnp.int32)
        valid = t < jnp.minimum(cnt, capacity)
        out_ks = [jnp.where(valid, ck, 0) for ck in cks]
        return (
            out_ks if multi else out_ks[0],
            _pack_lv([jnp.where(valid, cv, 0) for cv in cvs]),
            _pack_rv([jnp.zeros((capacity,), rv.dtype) for rv in rvs_l]),
            jnp.minimum(cnt, capacity),
            cnt > capacity,
        )

    # inner/left: prefix-sum output addressing. A left join emits exactly one
    # row (with right value 0) for each unmatched left row.
    emit = matches
    if how == "left":
        emit = jnp.where(matches == 0, 1, matches)
        if valid_left is not None:
            emit = jnp.where(valid_left, emit, 0)
    starts = jnp.cumsum(emit) - emit  # output offset per left row
    total = starts[-1] + emit[-1] if emit.shape[0] else jnp.int32(0)

    # >2^31 total pairs wrap the int32 running sum (duplicate-heavy keys on
    # large inputs). A true prefix sum is non-decreasing, so wrapped entries
    # are exactly those below the running max: poison them to INT32_MAX (all
    # wrapped rows lie beyond any practical capacity) so the expansion still
    # resolves the un-wrapped prefix exactly, and force the overflow flag —
    # never a silently-negative count.
    mono = jax.lax.cummax(starts)
    wrapped = jnp.any(starts != mono) | (total < 0)
    big = jnp.int32(2**31 - 1)
    starts = jnp.where(starts == mono, starts, big)
    total = jnp.where(wrapped, big, total)

    # expansion: output slot t belongs to left row i(t), match ordinal
    # j(t) = t - starts[i]
    t = jnp.arange(capacity, dtype=jnp.int32)
    i = expand_offsets(starts, capacity)
    i = jnp.clip(i, 0, n_l - 1)
    j = t - starts[i]
    valid = t < total
    ridx = jnp.clip(lo[i] + j, 0, rvs_l[0].shape[0] - 1)

    out_rvs = []
    for rv in rvs_l:
        orv = rv[ridx]
        if how == "left":
            orv = jnp.where(matches[i] > 0, orv, 0)
        out_rvs.append(jnp.where(valid, orv, 0))
    out_ks = [jnp.where(valid, w[i], 0) for w in lkws]
    out_lvs = [jnp.where(valid, lv[i], 0) for lv in lvs]
    count = jnp.minimum(total, capacity)
    overflow = (total > capacity) | wrapped
    return ((out_ks if multi else out_ks[0]), _pack_lv(out_lvs),
            _pack_rv(out_rvs), count, overflow)


def append_unmatched_right(
    out_ks, out_lv, out_rv, count, overflow,
    rks, rvs, lo, hi, *, capacity, valid_left=None, valid_right=None,
):
    """Complete a full outer join: append the unmatched SORTED-RIGHT rows
    (left value 0) after the left-join block already in ``out_*``.

    A sorted-right row is matched iff it lies inside some left row's match
    range [lo_i, hi_i) — range-marked with a +1/-1 scatter at the range
    ends and a cumsum (two n_left scatters + one n_right cumsum; no sort).
    Unmatched rows compact stably (right sorted order) and land at output
    slots [count, count + n_unmatched); rows that would exceed ``capacity``
    are dropped and flagged, so the first ``capacity`` rows stay exact.

    ``out_ks`` / ``rks`` are parallel limb lists; ``rvs`` / ``out_rv`` /
    ``out_lv`` may be value-column lists; ``valid_left`` / ``valid_right``
    mask shard padding rows (distributed callers). Returns
    ``(out_ks, out_lv, out_rv, count, overflow)`` with the same contract.
    """
    multi_rv = isinstance(rvs, (list, tuple))
    rvs_l = list(rvs) if multi_rv else [rvs]
    orv_l = list(out_rv) if multi_rv else [out_rv]
    n_r = rvs_l[0].shape[0]
    has = hi > lo
    if valid_left is not None:
        has = has & valid_left
    one = has.astype(jnp.int32)
    delta = jnp.zeros((n_r + 1,), jnp.int32)
    delta = delta.at[jnp.clip(lo, 0, n_r)].add(one, mode="drop")
    delta = delta.at[jnp.clip(hi, 0, n_r)].add(-one, mode="drop")
    covered = jnp.cumsum(delta[:n_r]) > 0
    unmatched = ~covered
    if valid_right is not None:
        unmatched = unmatched & valid_right
    *cu, cnt_u = filter(unmatched, *rks, *rvs_l)
    cks, crvs = cu[:len(rks)], cu[len(rks):]
    # slot per appended row; junk rows (>= cnt_u) poison to capacity -> drop
    slot = count + jnp.arange(n_r, dtype=jnp.int32)
    slot = jnp.where(jnp.arange(n_r, dtype=jnp.int32) < cnt_u, slot, capacity)
    out_ks = [
        ok.at[slot].set(ck, mode="drop") for ok, ck in zip(out_ks, cks)
    ]
    # left values of appended rows are 0 — the slots were already zeroed by
    # the expansion's validity mask, so only the right values need writing
    orv_l = [o.at[slot].set(c, mode="drop") for o, c in zip(orv_l, crvs)]
    total = count + cnt_u
    return (
        out_ks,
        out_lv,
        orv_l if multi_rv else orv_l[0],
        jnp.minimum(total, capacity),
        overflow | (total > capacity),
    )


def hash_join(
    left_keys: jnp.ndarray,
    left_values: jnp.ndarray,
    right_keys: jnp.ndarray,
    right_values: jnp.ndarray,
    *,
    capacity: int,
    how: str = "inner",
):
    """Equi-join. Returns ``(keys, left_vals, right_vals, count, overflow)``:
    rows [0, count) are the result, ordered by left row then right sorted
    position. ``overflow`` is True if the result exceeds ``capacity`` (the
    arrays then hold the first ``capacity`` rows).

    ``how``:
      - ``"inner"``: all (left, right) matching pairs;
      - ``"left"``: matching pairs plus one row per unmatched left row with
        ``right_vals`` 0 (callers needing an is-matched indicator can
        anti-join);
      - ``"right"``: the mirror — matching pairs plus one row per unmatched
        right row with ``left_vals`` 0; rows order by RIGHT row then left
        sorted position (the join is evaluated with the sides swapped);
      - ``"full"``: the left-join rows (ordered as ``"left"``) followed by
        one row per unmatched right row (``left_vals`` 0) in right sorted
        order — a full outer join;
      - ``"semi"``: each left row with at least one match, once, in left
        order (``right_vals`` all 0);
      - ``"anti"``: each left row with no match, once, in left order
        (``right_vals`` all 0);
      - ``"lookup"``: each left row with at least one match, once, in
        left order, paired with its FIRST match in right sorted order —
        the inner join of a key-UNIQUE right side at semi-join cost (no
        expansion machinery). With duplicate right keys the join
        degrades AT RUNTIME to the exact inner join (all pairs, left-row
        major) — the result is always exact; ``overflow`` reports only a
        capacity excess.

    Composite keys: pass a list/tuple of equal-length columns for BOTH
    ``left_keys`` and ``right_keys`` (matching dtypes per column, any
    supported mix) — the join key is the tuple of columns and the returned
    ``keys`` is a list of columns.

    Multi-column payloads: ``left_values`` and/or ``right_values`` may
    independently be lists of equal-length columns (a whole table side
    riding the one join); the matching output is then a list.
    """
    if how not in JOIN_HOWS and how != "lookup":
        raise ValueError(
            f"how must be one of {JOIN_HOWS} or 'lookup', got {how!r}"
        )
    if how == "right":
        jk, j_rv, j_lv, cnt, ovf = hash_join(
            right_keys, right_values, left_keys, left_values,
            capacity=capacity, how="left",
        )
        return jk, j_lv, j_rv, cnt, ovf
    multi = isinstance(left_keys, (list, tuple))
    if multi != isinstance(right_keys, (list, tuple)):
        raise ValueError("left and right keys must both be single columns "
                         "or both be column lists")
    l_cols = list(left_keys) if multi else [left_keys]
    r_cols = list(right_keys) if multi else [right_keys]
    if multi and (not l_cols or len(l_cols) != len(r_cols) or any(
            np.dtype(a.dtype) != np.dtype(b.dtype)
            for a, b in zip(l_cols, r_cols))):
        raise ValueError("left and right key columns must be non-empty and "
                         "match in count and dtypes")
    n_l = l_cols[0].shape[0]
    n_r = r_cols[0].shape[0]
    multi_lv = isinstance(left_values, (list, tuple))
    lv_cols = list(left_values) if multi_lv else [left_values]
    multi_rv = isinstance(right_values, (list, tuple))
    rv_cols = list(right_values) if multi_rv else [right_values]

    def _pack_lv(outs):
        return outs if multi_lv else outs[0]

    def _pack_rv(outs):
        return outs if multi_rv else outs[0]

    for c in l_cols:
        if c.shape[0] != n_l:
            raise ValueError("left key columns must have equal length")
    for c in r_cols:
        if c.shape[0] != n_r:
            raise ValueError("right key columns must have equal length")
    for c in lv_cols:
        if c.shape[0] != n_l:
            raise ValueError("left keys/values length mismatch")
    for c in rv_cols:
        if c.shape[0] != n_r:
            raise ValueError("right keys/values length mismatch")
    if n_l == 0 or (n_r == 0 and how == "inner"):
        if how == "full" and n_r > 0:
            # degenerate full outer join: every right row is unmatched
            rk_limbs, rspecs = _cols_to_limbs(r_cols)
            out = _stable_sort(
                [*rk_limbs, *rv_cols], num_keys=len(rk_limbs)
            )
            rks, rvs = list(out[:len(rk_limbs)]), list(out[len(rk_limbs):])
            e = jnp.zeros((0,), jnp.int32)
            out_ks, out_lv, out_rv, count, overflow = append_unmatched_right(
                [jnp.zeros((capacity,), w.dtype) for w in rks],
                _pack_lv([jnp.zeros((capacity,), c.dtype)
                          for c in lv_cols]),
                [jnp.zeros((capacity,), c.dtype) for c in rv_cols],
                jnp.int32(0), jnp.bool_(False),
                rks, rvs, e, e, capacity=capacity,
            )
            out_cols = _limbs_to_cols(out_ks, rspecs)
            return (
                out_cols if multi else out_cols[0],
                out_lv, _pack_rv(out_rv), count, overflow,
            )
        # an empty side is a normal inner-join input: zero matching pairs
        zk = [jnp.zeros((capacity,), c.dtype) for c in l_cols]
        return (
            zk if multi else zk[0],
            _pack_lv([jnp.zeros((capacity,), c.dtype) for c in lv_cols]),
            _pack_rv([jnp.zeros((capacity,), c.dtype) for c in rv_cols]),
            jnp.int32(0),
            jnp.bool_(False),
        )
    lk_limbs, specs = _cols_to_limbs(l_cols)
    if n_r == 0:
        # left/semi/anti against an empty right side: no row matches
        lo = hi = jnp.zeros((n_l,), jnp.int32)
        rvs = [jnp.zeros((1,), c.dtype) for c in rv_cols]
    else:
        rk_limbs, _ = _cols_to_limbs(r_cols)
        out = _stable_sort(
            [*rk_limbs, *rv_cols], num_keys=len(rk_limbs)
        )
        rks, rvs = list(out[:len(rk_limbs)]), list(out[len(rk_limbs):])
        lo, hi = merge_rank_pair(rks, lk_limbs)

    if how == "lookup":
        # key-unique-right fast path: each left row pairs with its FIRST
        # match in right sorted order — a membership test + rank gather,
        # skipping the whole expansion machinery (expand_offsets scatter/
        # cummax + capacity-sized output gathers). Exact inner join when
        # the right side is key-unique (e.g. an aggregate output keyed by
        # the join key — the planner's eager-aggregation rewrite builds
        # exactly that); with duplicate right keys the join DEGRADES at
        # runtime (lax.cond) to the exact inner-join expansion over the
        # same match ranges, so the result is always the true inner join
        # and ``overflow`` reports only a capacity excess — never a
        # silent first-match truncation.
        matched = hi > lo
        dup = jnp.any((hi - lo) > 1)

        def _fit(a):
            if a.shape[0] >= capacity:
                return a[:capacity]
            return jnp.concatenate(
                [a, jnp.zeros((capacity - a.shape[0],), a.dtype)]
            )

        def _lookup(_):
            safe = jnp.clip(lo, 0, max(n_r, 1) - 1)
            rv_g = [rv[safe] for rv in rvs]
            *comp, cnt = filter(matched, *lk_limbs, *lv_cols, *rv_g)
            comp = [_fit(a) for a in comp]
            t = jnp.arange(capacity, dtype=jnp.int32)
            valid = t < jnp.minimum(cnt, capacity)
            comp = [jnp.where(valid, a, 0) for a in comp]
            return (*comp, jnp.minimum(cnt, capacity).astype(jnp.int32),
                    cnt > capacity)

        def _inner(_):
            kw, olv, orv, cnt, ovf = join_expand(
                lk_limbs if len(lk_limbs) > 1 else lk_limbs[0],
                lv_cols, rvs, lo, hi, capacity=capacity, how="inner",
            )
            return (*_as_limb_list(kw), *olv, *orv,
                    cnt.astype(jnp.int32), ovf)

        *comp, cnt, overflow = jax.lax.cond(dup, _inner, _lookup, None)
        ks = comp[:len(lk_limbs)]
        lvo = comp[len(lk_limbs):len(lk_limbs) + len(lv_cols)]
        rvo = comp[len(lk_limbs) + len(lv_cols):]
        out_cols = _limbs_to_cols(ks, specs)
        return (
            out_cols if multi else out_cols[0],
            _pack_lv(lvo),
            _pack_rv(rvo),
            cnt,
            overflow,
        )

    lk_arg = lk_limbs if multi or len(lk_limbs) > 1 else lk_limbs[0]
    out_kw, out_lv, out_rv, count, overflow = join_expand(
        lk_arg, _pack_lv(lv_cols), _pack_rv(rvs), lo, hi,
        capacity=capacity, how=how,
    )
    if how == "full" and n_r > 0:
        out_kw, out_lv, out_rv, count, overflow = append_unmatched_right(
            _as_limb_list(out_kw), out_lv, out_rv, count, overflow,
            rks, _pack_rv(rvs), lo, hi, capacity=capacity,
        )
    out_limbs = _as_limb_list(out_kw)
    out_cols = _limbs_to_cols(out_limbs, specs)
    return (
        out_cols if multi else out_cols[0],
        out_lv,
        out_rv,
        count,
        overflow,
    )


BAND_OPS = ("lt", "le", "gt", "ge", "between")


def _limbs_le(a, b):
    """Row-wise lexicographic ``a <= b`` over parallel big-endian unsigned
    limb lists (rank space, so the comparison equals the source dtype's
    total order)."""
    le = a[-1] <= b[-1]
    for x, y in zip(reversed(a[:-1]), reversed(b[:-1])):
        le = (x < y) | ((x == y) & le)
    return le


def _seg_cummax_limbs(limbs, rn0):
    """Within-segment running lexicographic max over a limb list
    (Hillis–Steele doubling — log2(n) elementwise sweeps, the engine's
    segmented-scan form). ``rn0`` is each row's 0-based offset in its
    segment; an element ``s`` back is in-segment iff ``rn0 >= s``."""
    n = limbs[0].shape[0]
    ws = list(limbs)
    s = 1
    while s < n:
        prevs = [jnp.concatenate([jnp.zeros((s,), w.dtype), w[:-s]])
                 for w in ws]
        take_prev = (rn0 >= s) & _limbs_le(ws, prevs)
        ws = [jnp.where(take_prev, p, w) for p, w in zip(prevs, ws)]
        s *= 2
    return ws


def band_join(
    left_band,
    left_values,
    right_band,
    right_values,
    *,
    op: str,
    capacity: int,
    left_equi=None,
    right_equi=None,
    how: str = "inner",
):
    """Non-equi (band / theta / interval) join.

    Emits the (left, right) row pairs where the optional equality
    conjunct matches AND the band predicate holds::

      op="lt":      l.x <  r.y         op="gt":  l.x >  r.y
      op="le":      l.x <= r.y         op="ge":  l.x >= r.y
      op="between": r.lo <= l.x <= r.hi

    ``left_band`` is the left probe column x; ``right_band`` the right
    column y (for "between": the ``(lo, hi)`` column pair). Band columns
    must share one dtype; comparisons happen in the column's
    order-preserving rank space, so signed/float/date orders are exact
    (floats: total_cmp order, the engine-wide contract). ``left_equi`` /
    ``right_equi`` (parallel column lists) add an equality conjunct.

    Sort-shaped evaluation — never a per-pair predicate and never a
    per-row binary search: the right side sorts once by (equi..., band),
    each left row's matches are then ONE contiguous range of sorted
    positions computed with merge-rank union sorts at comparator rate,
    and the expansion is the shared :func:`join_expand` phase (prefix-sum
    addressing and one gather per output column). "between"
    expands a candidate range bounded BELOW by a segmented running-max
    of ``hi`` (rows before the group's first running-max(hi) >= x cannot
    match) and ABOVE by the last ``lo <= x`` row, then post-filters
    ``x <= hi`` with one stable compaction; ``capacity`` must cover
    those CANDIDATES — a tight superset of the matches, equal to them
    whenever each equi group's intervals don't interleave (tier tables,
    validity ranges), NOT every ``lo <= x`` row.

    ``how``: "inner" / "left" / "semi" / "anti" for the inequality ops
    (exact — match counts are exact range widths); "between" supports
    "inner" only. Returns ``(left_vals, right_vals, count, overflow)``;
    rows [0, count) order by left row then right sorted position.
    ``overflow`` True means the true result (for "between": the candidate
    set) exceeded ``capacity`` and rows were dropped.

    The reference crate has no joins at all (SURVEY §2.2); this is
    north-star relational surface beyond the equi :func:`hash_join`.
    """
    if op not in BAND_OPS:
        raise ValueError(f"op must be one of {BAND_OPS}, got {op!r}")
    if op == "between":
        if how != "inner":
            raise ValueError(
                f'op="between" supports how="inner" only, got {how!r} '
                f"(candidate post-filtering makes match counts inexact "
                f"before expansion)"
            )
        if not (isinstance(right_band, (list, tuple))
                and len(right_band) == 2):
            raise ValueError('op="between" needs right_band=(lo, hi)')
        rlo, rhi = right_band
        band_cols_r = [rlo, rhi]
    else:
        if how not in ("inner", "left", "semi", "anti"):
            raise ValueError(
                f'band joins support how="inner"/"left"/"semi"/"anti", '
                f"got {how!r}"
            )
        if isinstance(right_band, (list, tuple)):
            raise ValueError(
                f'op={op!r} takes a single right band column '
                f'(only "between" takes a (lo, hi) pair)'
            )
        band_cols_r = [right_band]
    for c in band_cols_r:
        if np.dtype(c.dtype) != np.dtype(left_band.dtype):
            raise TypeError(
                f"band columns must share one dtype, got "
                f"{left_band.dtype} vs {c.dtype}"
            )
    multi_lv = isinstance(left_values, (list, tuple))
    lvs = list(left_values) if multi_lv else [left_values]
    multi_rv = isinstance(right_values, (list, tuple))
    rvs = list(right_values) if multi_rv else [right_values]
    le_cols = list(left_equi) if left_equi is not None else []
    re_cols = list(right_equi) if right_equi is not None else []
    if len(le_cols) != len(re_cols) or any(
            np.dtype(a.dtype) != np.dtype(b.dtype)
            for a, b in zip(le_cols, re_cols)):
        raise ValueError(
            "left_equi and right_equi must match in count and dtypes"
        )
    n_l = left_band.shape[0]
    n_r = band_cols_r[0].shape[0]
    for c in (*le_cols, *lvs):
        if c.shape[0] != n_l:
            raise ValueError("left columns must have equal length")
    for c in (*re_cols, *rvs, *band_cols_r):
        if c.shape[0] != n_r:
            raise ValueError("right columns must have equal length")

    def _pack_lv(outs):
        return outs if multi_lv else outs[0]

    def _pack_rv(outs):
        return outs if multi_rv else outs[0]

    if n_l == 0:
        return (
            _pack_lv([jnp.zeros((capacity,), c.dtype) for c in lvs]),
            _pack_rv([jnp.zeros((capacity,), c.dtype) for c in rvs]),
            jnp.int32(0),
            jnp.bool_(False),
        )

    lx = K.encode_limbs(left_band)
    le_limbs, _ = _cols_to_limbs(le_cols) if le_cols else ([], [])
    if n_r == 0:
        # no right rows: nothing matches (left/anti still emit left rows)
        lo = hi = jnp.zeros((n_l,), jnp.int32)
        rvs_s, rhi_s = [jnp.zeros((1,), c.dtype) for c in rvs], []
    else:
        ry = K.encode_limbs(band_cols_r[0])
        re_limbs, _ = _cols_to_limbs(re_cols) if re_cols else ([], [])
        nk = len(re_limbs) + len(ry)
        ride = list(rvs)
        if op == "between":
            ride += K.encode_limbs(rhi)
        srt = _stable_sort([*re_limbs, *ry, *ride], num_keys=nk)
        rk_s = list(srt[:nk])
        rvs_s = list(srt[nk:nk + len(rvs)])
        rhi_s = list(srt[nk + len(rvs):])
        # each left row's matches are one contiguous sorted-right range:
        #   lt:      [rank_right(E, x), group_end)
        #   le:      [rank_left (E, x), group_end)
        #   gt:      [group_start, rank_left (E, x))
        #   ge:      [group_start, rank_right(E, x))
        #   between: [rank_left(E, segcummax(hi)), rank_right(E, lo=x))
        side = "left" if op in ("le", "gt") else "right"
        v = merge_rank(rk_s if nk > 1 else rk_s[0],
                       [*le_limbs, *lx] if nk > 1 else lx[0], side=side)
        if op == "between":
            # candidate lower bound: rows before the group's first
            # running-max(hi) >= x can't match (their own hi <= the
            # running max < x). The running max is non-decreasing within
            # a group, so (E, segcummax(hi)) is globally sorted and one
            # merge-rank bounds the candidates to [first possibly-
            # matching interval, last lo <= x] — a tight superset of the
            # matches (exact for non-overlapping per-group intervals)
            # instead of every lo <= x row; capacity sizes to THIS.
            pos = jnp.arange(n_r, dtype=jnp.int32)
            if le_limbs:
                re_s = rk_s[:len(re_limbs)]
                fst = jnp.concatenate([
                    jnp.ones((1,), jnp.bool_),
                    _limbs_differ([w[1:] for w in re_s],
                                  [w[:-1] for w in re_s]),
                ])
                rn0 = pos - jax.lax.cummax(jnp.where(fst, pos, 0))
            else:
                rn0 = pos
            cmh = _seg_cummax_limbs(rhi_s, rn0)
            g = merge_rank(
                [*rk_s[:len(re_limbs)], *cmh]
                if len(re_limbs) + len(cmh) > 1 else cmh[0],
                [*le_limbs, *lx] if nk > 1 else lx[0], side="left",
            )
        elif le_limbs:
            g_side = "right" if op in ("lt", "le") else "left"
            g = merge_rank(
                rk_s[:len(re_limbs)]
                if len(re_limbs) > 1 else rk_s[0],
                le_limbs if len(le_limbs) > 1 else le_limbs[0],
                side=g_side,
            )
        else:
            g = (jnp.full((n_l,), n_r, jnp.int32)
                 if op in ("lt", "le") else jnp.zeros((n_l,), jnp.int32))
        lo, hi = (v, g) if op in ("lt", "le") else (g, v)
        if op == "between":
            # INVERTED intervals (hi < lo rows, which match nothing in
            # SQL) can push the running-max lower bound PAST the
            # lo <= x upper bound: such rows keep cmh < x while their
            # own lo > x. Matches are still a subset of [lo, hi); a
            # crossed range just means none — clamp so widths never go
            # negative (negative emit counts corrupt the expansion's
            # prefix sums; caught in round-5 review)
            hi = jnp.maximum(hi, lo)

    if op == "between" and rhi_s:
        # Two runtime regimes (lax.cond): when every left row has at
        # most ONE candidate — exactly the non-interleaving tier /
        # validity-range shape under the running-max lower bound — the
        # single candidate gathers directly (no expansion machinery, no
        # capacity-sized arrays in flight: one n_left compaction).
        # Otherwise the shared expansion runs, post-filtering x <= hi;
        # an inner cond skips even that compaction when per-group hi is
        # monotone (cmh == hi) and every candidate provably matches.
        single_ok = jnp.all(hi - lo <= 1)

        def _fit(a):
            if a.shape[0] >= capacity:
                return a[:capacity]
            return jnp.concatenate(
                [a, jnp.zeros((capacity - a.shape[0],), a.dtype)]
            )

        def _single(_):
            cand = hi > lo
            safe = jnp.clip(lo, 0, n_r - 1)
            rv_g = [rv[safe] for rv in rvs_s]
            rhi_g = [w[safe] for w in rhi_s]
            keep = cand & _limbs_le(lx, rhi_g)
            *comp, cnt = filter(keep, *lvs, *rv_g)
            comp = [_fit(a) for a in comp]
            t = jnp.arange(capacity, dtype=jnp.int32)
            validm = t < jnp.minimum(cnt, capacity)
            comp = [jnp.where(validm, a, 0) for a in comp]
            return (*comp, jnp.minimum(cnt, capacity).astype(jnp.int32),
                    cnt > capacity)

        def _multi(_):
            kout, lv_out, rv_out, count, overflow = join_expand(
                lx if len(lx) > 1 else lx[0], lvs, rvs_s + rhi_s,
                lo, hi, capacity=capacity, how=how,
            )
            ko = _as_limb_list(kout)
            rhi_out = rv_out[len(rvs):]
            rv_real = rv_out[:len(rvs)]
            all_match = ~jnp.any(_limbs_differ(cmh, rhi_s))

            def _exact(_):
                return (*lv_out, *rv_real, count)

            def _filtered(_):
                valid = jnp.arange(capacity, dtype=jnp.int32) < count
                keep = valid & _limbs_le(ko, rhi_out)
                *comp, cnt = filter(keep, *lv_out, *rv_real)
                return (*comp, cnt.astype(count.dtype))

            *packed, cnt2 = jax.lax.cond(all_match, _exact, _filtered,
                                         None)
            return (*packed, cnt2.astype(jnp.int32), overflow)

        *packed, count, overflow = jax.lax.cond(
            single_ok, _single, _multi, None
        )
        lv_out = list(packed[:len(lvs)])
        rv_out = list(packed[len(lvs):])
        return _pack_lv(lv_out), _pack_rv(rv_out), count, overflow

    kout, lv_out, rv_out, count, overflow = join_expand(
        lx if len(lx) > 1 else lx[0], lvs, rvs_s + rhi_s, lo, hi,
        capacity=capacity, how=how,
    )
    rv_out = rv_out[:len(rvs)]
    return _pack_lv(lv_out), _pack_rv(rv_out), count, overflow


def searchsorted(sorted_keys: jnp.ndarray, queries: jnp.ndarray,
                 side: str = "left") -> jnp.ndarray:
    """``jnp.searchsorted`` under the dtype's total order, at sort rate.

    ``sorted_keys`` must be ascending under the total order (the output of
    :func:`radix_sort_tpu.sort`); NaNs and mixed-sign zeros rank exactly as
    the sort places them (IEEE total_cmp), unlike ``jnp.searchsorted``'s
    comparison order. The device binary search pays 24 dependent gather
    rounds per query; the merge-rank formulation (two variadic sorts over
    the union) is selected automatically when the query side is large.
    """
    if side not in ("left", "right"):
        raise ValueError(f"side must be 'left' or 'right', got {side!r}")
    if np.dtype(sorted_keys.dtype) != np.dtype(queries.dtype):
        raise ValueError("sorted_keys and queries must share a dtype")
    if queries.shape[0] == 0:
        return jnp.zeros((0,), jnp.int32)
    return merge_rank(K.encode(sorted_keys), K.encode(queries), side=side)


def unique(keys):
    """Distinct keys with multiplicities (DISTINCT / GROUP BY COUNT(*)).

    Returns ``(unique_keys, counts, num_unique)``: rows [0, num_unique) hold
    each distinct key once, ascending under the dtype's total order, with
    its occurrence count; the tail is padding. Cheaper than
    ``hash_aggregate(keys, ·, "count")`` — keys-only, so the sort is a
    keys-only unstable network and counts come from boundary positions.

    ``keys`` may be a list/tuple of equal-length columns (composite
    DISTINCT); ``unique_keys`` is then a list of columns and rows order
    lexicographically.
    """
    multi = isinstance(keys, (list, tuple))
    cols = list(keys) if multi else [keys]
    if not cols:
        raise ValueError("keys must have at least one column")
    n = cols[0].shape[0]
    for c in cols:
        if c.shape[0] != n:
            raise ValueError("all key columns must have equal length")
    if n == 0:
        return keys, jnp.zeros((0,), jnp.int32), jnp.int32(0)
    limbs, specs = _cols_to_limbs(cols)
    if len(limbs) == 1:
        sk = [jnp.sort(limbs[0], stable=False)]
    else:
        sk = list(jax.lax.sort(limbs, num_keys=len(limbs), is_stable=False))
    first = jnp.concatenate(
        [jnp.ones((1,), jnp.bool_),
         _limbs_differ([w[1:] for w in sk], [w[:-1] for w in sk])]
    )
    uk_cols = _limbs_to_cols(sk, specs)
    pos = jnp.arange(n, dtype=jnp.int32)
    *out_keys, start, num = filter(first, *uk_cols, pos)
    # counts[i] = next group's start - this group's start (last ends at n)
    nxt = jnp.concatenate([start[1:], start[:1]])
    nxt = jnp.where(pos == num - 1, n, nxt)
    counts = jnp.where(pos < num, nxt - start, 0)
    return (out_keys if multi else out_keys[0]), counts, num
