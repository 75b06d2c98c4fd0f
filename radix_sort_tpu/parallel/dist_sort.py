"""Multi-chip distributed sort: ragged bucket exchange over a device mesh.

This replaces the reference's shared-memory thread orchestration
(src/radix_sort/mod.rs:90-168): instead of OS threads over one address
space, rows are sharded across mesh devices and redistributed with XLA
collectives (NCCL over NVLink on GPUs).

Algorithm (single exchange round — parallel sort by regular sampling, with
composite tie-broken splitters):

  1. local stable sort of each shard (the per-chunk work, analogous to one
     thread's chunk in mod.rs:94-99);
  2. every device contributes ``m`` evenly spaced samples of its sorted
     shard; the gathered sketch's quantiles become the P-1 global splitters.
     Splitters and routing both use the composite order
     ``(key, device-major position)`` — position breaks ties, so duplicate
     keys (the reference's StepUniform regime, src/distr.rs:78-106, and the
     all-equal worst case) split EVENLY across devices instead of flooding
     one. Regular sampling gives a deterministic balance bound: every
     destination receives at most ``n/P + P*ceil(n_local/m)`` rows plus a
     small sampling slack — no distribution can overflow a capacity
     provisioned to that bound.
  3. exchange the per-destination runs with ``jax.lax.ragged_all_to_all``:
     exact counts on the wire (no padded per-pair blocks), landing
     source-major-packed in each destination's output buffer;
  4. final local stable sort of the received rows (padding carries an
     explicit invalid flag as the leading sort key, so sentinel-valued real
     keys cannot mix with padding).

Equal keys keep global input order: routing orders ties by source position,
the exchange lands runs in source-rank order, and both local sorts are
stable — the same invariant the reference maintains with its digit-major /
chunk-minor prefix sum (mod.rs:110-120).

The output is *range-ragged*: device d holds count[d] valid rows padded to a
static per-device capacity; concatenating valid prefixes in device order is
the fully sorted array. If the exchange ever exceeds capacity (impossible
for the provisioned bound, but reachable through the test-only ``capacity``
override), the public entry points fall back to a replicated global sort in
the same padded layout — the result is always exact, never flagged garbage.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from radix_sort_tpu import keys as K

__all__ = [
    "distributed_sort",
    "distributed_sort_pairs",
    "distributed_sort_limbs",
    "exchange_capacity",
]

from radix_sort_tpu.config import DEFAULT as _CFG


def _num_samples(n_local: int, num_devices: int) -> int:
    """Samples per device for the splitter sketch.

    ``m = 8 * P**2`` bounds the max bucket at ``n/P * (1 + 1/8)`` plus the
    sampling-gap slack (see :func:`exchange_capacity`); capped by the shard
    size (m = n_local degenerates to exact splitters) and floored for tiny
    meshes. Note: m grows as P**2, which is fine for one host's devices; a
    mesh of many hosts would want a hierarchical sketch instead.
    """
    return max(64, min(n_local, 8 * num_devices * num_devices))


def exchange_capacity(n_local: int, num_devices: int) -> int:
    """Deterministic per-device receive bound for the regular-sampled
    composite partition.

    Between consecutive splitters lie at most ``m`` sketch samples; each
    shard holds at most ``gap = ceil(n_local/m)`` rows between its own
    consecutive samples, so a bucket's rows per shard are bounded by
    ``(its samples in range + 2) * gap`` and the global bucket by
    ``n/P + 2*P*gap`` (composite keys are duplicate-free, so this holds for
    EVERY input distribution). A further ``P`` covers boundary rounding.
    """
    m = _num_samples(n_local, num_devices)
    gap = -(-n_local // m) + 1
    cap = n_local + (num_devices * num_devices * n_local) // m
    cap += 2 * num_devices * gap + num_devices + 64
    return -(-cap // 8) * 8  # round up to a multiple of 8


def _regular_sample_positions(n_local: int, m: int) -> jnp.ndarray:
    """Midpoints of the m equal strides through a sorted shard."""
    # i * n_local // m without the int32 product (which wraps once
    # n_local * m >= 2**31): n_local = q * m + r, so it is i*q + i*r // m
    # (i*r < m*m, which fits int32 for every m = 8 * P**2 with P <= 75)
    q, r = divmod(n_local, m)
    i = jnp.arange(m, dtype=jnp.int32)
    return i * np.int32(q) + (i * np.int32(r)) // m + n_local // (2 * m)


def _sketch_quantiles(samp_ws, samp_p, axis_name, num_devices, per_shard):
    """Gather every shard's (key limbs..., pos) samples, sort the pooled
    sketch by the composite order, return the P-1 quantile splitters."""
    sk_ws = [jax.lax.all_gather(w, axis_name, tiled=True) for w in samp_ws]
    sk_p = jax.lax.all_gather(samp_p, axis_name, tiled=True)
    out = jax.lax.sort(
        sk_ws + [sk_p], num_keys=len(sk_ws) + 1, is_stable=True
    )
    ranks = (jnp.arange(num_devices - 1, dtype=jnp.int32) + 1) * per_shard - 1
    return [w[ranks] for w in out[:-1]], out[-1][ranks]


def _composite_splitters(s_limbs, axis_name, num_devices):
    """(P-1,) composite splitters (key limbs..., device-major sorted
    position) — ``s_limbs`` is a list of sorted key limb arrays (one entry
    for plain word keys).

    Positions are ``rank * n_local + sorted_index``. Among EQUAL keys the
    stable local sort preserves original order, so sorted-index order equals
    original-order — and only equal-key comparisons ever reach the position
    tiebreak, so routing on sorted positions preserves global input order
    exactly as original positions would.
    """
    n_local = s_limbs[0].shape[0]
    m = _num_samples(n_local, num_devices)
    pos = _regular_sample_positions(n_local, m)
    r = jax.lax.axis_index(axis_name).astype(jnp.int32)
    return _sketch_quantiles(
        [w[pos] for w in s_limbs], r * np.int32(n_local) + pos,
        axis_name, num_devices, m,
    )


def _lex_below(ws, p, sws, sp):
    """Row-wise (ws..., p) < (sws..., sp) in lexicographic (composite key)
    order; each ``ws`` entry broadcasts against its ``sws`` entry."""
    below = p < sp
    for w, sw in zip(reversed(ws), reversed(sws)):
        below = (w < sw) | ((w == sw) & below)
    return below


def _below_starts(s_limbs, gpos, splitter_ws, splitter_p):
    """Run-start offsets: count of rows lexicographically below each
    composite splitter (the shard is sorted by (key limbs, position), so
    each destination's rows are a contiguous slice). One compare-sum per
    splitter — a searchsorted has no multi-key form."""
    below = _lex_below(
        [w[:, None] for w in s_limbs], gpos[:, None],
        [sw[None, :] for sw in splitter_ws], splitter_p[None, :],
    )
    starts = below.astype(jnp.int32).sum(axis=0)  # (P-1,)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), starts])


def _composite_starts(s_limbs, splitter_ws, splitter_p, axis_name,
                      num_devices):
    n_local = s_limbs[0].shape[0]
    r = jax.lax.axis_index(axis_name).astype(jnp.int32)
    gpos = r * np.int32(n_local) + jnp.arange(n_local, dtype=jnp.int32)
    return _below_starts(s_limbs, gpos, splitter_ws, splitter_p)


def _key_splitters(s_words, axis_name, num_devices):
    """Key-only regular-sampled splitters (no position tiebreak) — for
    consumers that must co-locate equal keys (joins). Balance is then
    input-dependent; duplicate-heavy keys can overflow and must be flagged
    by the caller."""
    n_local = s_words.shape[0]
    m = _num_samples(n_local, num_devices)
    pos = _regular_sample_positions(n_local, m)
    sketch = jax.lax.all_gather(s_words[pos], axis_name, tiled=True)
    sketch = jnp.sort(sketch)
    ranks = (jnp.arange(num_devices - 1, dtype=jnp.int32) + 1) * m - 1
    return sketch[ranks]


def _key_starts(s_words, splitters):
    """Key-only variant (for joins: equal keys MUST co-locate, so no
    position tiebreak; balance is then input-dependent and flagged)."""
    starts = jnp.searchsorted(s_words, splitters, side="left").astype(jnp.int32)
    return jnp.concatenate([jnp.zeros((1,), jnp.int32), starts])


def _lex_ge(ws, p, sws, sp):
    """(ws..., p) >= (sws..., sp) lexicographically (composite key order);
    ``ws``/``sws`` are matching-length limb lists."""
    ge = p >= sp
    for w, sw in zip(reversed(ws), reversed(sws)):
        ge = (w > sw) | ((w == sw) & ge)
    return ge


def _gather_exchange(sorted_ops, sentinels, bounds, axis_name, num_devices,
                     capacity, gpos_local=None, num_keys=1):
    """all_gather-based exchange: every device gathers all shards (in
    source-major order — gpos == flat index, so stability is free) and
    selects its own splitter range with one stable local sort.

    P-times the optimal wire bytes, but exact for every distribution and
    supported on every backend — this is the CPU virtual-mesh path (XLA:CPU
    has no ragged-all-to-all thunk) and the reference semantics the ragged
    path is tested against. ``bounds``: (kind, lo, hi) where kind is
    "composite" (lo/hi are ((P-1,) key limb list, (P-1,) pos) pairs) or
    "key" (leading word only). ``gpos_local``: explicit per-row global
    positions (striped callers, where the gathered flat index is not the
    global original position); default is the flat gathered index.
    ``num_keys``: leading entries of ``sorted_ops`` that form the composite
    key (the restore sort orders by all of them).
    """
    me = jax.lax.axis_index(axis_name).astype(jnp.int32)
    g = [jax.lax.all_gather(x, axis_name, tiled=True) for x in sorted_ops]
    w = g[0]
    n_total = w.shape[0]
    if gpos_local is None:
        gpos = jnp.arange(n_total, dtype=jnp.int32)
    else:
        gpos = jax.lax.all_gather(gpos_local, axis_name, tiled=True)

    kind, lo, hi = bounds
    if num_devices == 1:
        valid = jnp.ones((n_total,), jnp.bool_)  # one bucket: no splitters
    elif kind == "composite":
        sws, sp = lo
        ks = g[:num_keys]
        i_lo = jnp.clip(me - 1, 0, num_devices - 2)
        ge_lo = (me == 0) | _lex_ge(
            ks, gpos, [sw[i_lo] for sw in sws], sp[i_lo]
        )
        i_hi = jnp.clip(me, 0, num_devices - 2)
        lt_hi = (me == num_devices - 1) | ~_lex_ge(
            ks, gpos, [sw[i_hi] for sw in sws], sp[i_hi]
        )
    else:
        sk = lo
        i_lo = jnp.clip(me - 1, 0, num_devices - 2)
        ge_lo = (me == 0) | (w >= sk[i_lo])
        i_hi = jnp.clip(me, 0, num_devices - 2)
        lt_hi = (me == num_devices - 1) | (w < sk[i_hi])
    if num_devices > 1:
        valid = ge_lo & lt_hi

    invalid = (~valid).astype(jnp.int32)
    srt = jax.lax.sort([invalid] + g, num_keys=1 + num_keys, is_stable=True)
    n_valid = valid.astype(jnp.int32).sum()
    overflow = n_valid > capacity
    outs = []
    pos_out = jnp.arange(capacity, dtype=jnp.int32)
    take = min(capacity, n_total)  # capacity may over-provision tiny shards
    for x, sent in zip(srt[1:], sentinels):
        body = x[:take]
        if take < capacity:
            body = jnp.concatenate(
                [body, jnp.full((capacity - take,), sent, x.dtype)]
            )
        outs.append(jnp.where(pos_out < n_valid, body, jnp.asarray(sent, x.dtype)))
    return outs, jnp.minimum(n_valid, capacity), overflow


def _ragged_exchange(arrays, sentinels, starts, axis_name, num_devices, capacity):
    """Exchange each array's per-destination runs; returns (received arrays,
    valid_count, overflow).

    ``starts``: (P,) run starts in the local shard (run t is
    [starts[t], starts[t+1]) with starts[P] == n_local implied). All sizing
    is derived from the replicated all-gathered count matrix, so senders and
    receivers clamp identically and out-of-bounds writes are impossible even
    when a capacity override forces overflow.
    """
    n_local = arrays[0].shape[0]
    me = jax.lax.axis_index(axis_name).astype(jnp.int32)
    ends = jnp.append(starts[1:], jnp.int32(n_local))
    counts = ends - starts  # (P,) my send sizes

    allc = jax.lax.all_gather(counts, axis_name, tiled=False)  # (P src, P dst)
    excl = jnp.cumsum(allc, axis=0) - allc  # landing offsets per (src, dst)
    oo_full = jnp.minimum(excl, capacity)
    sz_full = jnp.minimum(allc, capacity - oo_full)
    send_sizes = sz_full[me]  # (P,)
    output_offsets = oo_full[me]
    recv_sizes = sz_full[:, me]
    overflow = jnp.any(allc.sum(axis=0) > capacity)

    outs = []
    for arr, sent in zip(arrays, sentinels):
        buf = jnp.full((capacity,), sent, dtype=arr.dtype)
        outs.append(
            jax.lax.ragged_all_to_all(
                arr, buf, starts, send_sizes, output_offsets, recv_sizes,
                axis_name=axis_name,
            )
        )
    # landing offsets of each source's segment in MY buffer (striped callers
    # reconstruct per-row source ranks from these)
    oo_me = oo_full[:, me]
    return outs, recv_sizes.sum(), overflow, oo_me


# platforms whose XLA backend lowers ragged-all-to-all. XLA:CPU does not
# ("not supported by XLA:CPU ThunkEmitter"); XLA:GPU does (chip_smoke.py
# runs the ragged exchange on the card on every run).
RAGGED_EXCHANGE_PLATFORMS = ("gpu",)


def default_exchange() -> str:
    """ragged-all-to-all (exact counts on the wire) where the backend lowers
    it; the all_gather emulation elsewhere."""
    if jax.default_backend() in RAGGED_EXCHANGE_PLATFORMS:
        return "ragged"
    return "gather"


def _pipelined_exchange(words, values, axis_name, num_devices, capacity,
                        sentinel, stripes=2):
    """Double-buffered comm/compute exchange — the pipeline-parallel
    analogue SURVEY §2.2 calls for (the reference's nearest structure is
    radix_sort1's up-front histogram threads, mod.rs:217-239).

    The shard is split into ``stripes`` independent stripes; each stripe is
    locally sorted, routed and exchanged on its own dependency chain, so
    XLA's latency-hiding scheduler can overlap stripe i's collective with
    stripe i+1's local sort/routing compute (collectives lower to async
    start/done pairs). Global stability is preserved exactly: every row
    carries a monotone global-position surrogate
    ``src_rank*n_local + stripe*stripe_len + local_sorted_index`` (within a
    stripe the stable local sort keeps equal keys in original order, so the
    surrogate ranks equal keys exactly as original positions do), and the
    final merge sorts by (invalid, key, surrogate).

    Returns (out_words, out_vals, n_valid, overflow) like _local_exchange.
    """
    n_local = words.shape[0]
    if n_local % stripes != 0:
        raise ValueError(f"n_local ({n_local}) must be divisible by stripes")
    sl = n_local // stripes
    has_vals = values is not None
    r = jax.lax.axis_index(axis_name).astype(jnp.int32)
    use_ragged = default_exchange() == "ragged"

    srt = []
    for s in range(stripes):
        seg = [words[s * sl : (s + 1) * sl]]
        if has_vals:
            seg.append(values[s * sl : (s + 1) * sl])
        srt.append(jax.lax.sort(seg, num_keys=1, is_stable=True))

    # union composite sketch across stripes (positions in full gpos space)
    m = _num_samples(sl, num_devices)
    pos = _regular_sample_positions(sl, m)
    samp_w = jnp.concatenate([srt[s][0][pos] for s in range(stripes)])
    samp_p = jnp.concatenate(
        [r * np.int32(n_local) + np.int32(s * sl) + pos for s in range(stripes)]
    )
    sws, sp = _sketch_quantiles(
        [samp_w], samp_p, axis_name, num_devices, stripes * m
    )

    big_invalid, big_w, big_g, big_v = [], [], [], []
    n_valid = jnp.int32(0)
    overflow = jnp.asarray(False)
    for s in range(stripes):
        s_words = srt[s][0]
        gpos = (
            r * np.int32(n_local)
            + np.int32(s * sl)
            + jnp.arange(sl, dtype=jnp.int32)
        )
        sentinels = [sentinel] + (
            [jnp.zeros((), srt[s][1].dtype)] if has_vals else []
        )
        if use_ragged:
            starts = _below_starts([s_words], gpos, sws, sp)
            recv, nv, ovf, oo = _ragged_exchange(
                srt[s], sentinels, starts, axis_name, num_devices, capacity
            )
            rows = jnp.arange(capacity, dtype=jnp.int32)
            ge = rows[:, None] >= oo[None, :]
            src = ge.astype(jnp.int32).sum(axis=1) - 1  # oo[0]==0 -> src >= 0
            seg_base = jnp.max(jnp.where(ge, oo[None, :], 0), axis=1)
            # reconstruct the monotone surrogate: source-major, stripe,
            # then position within the source's segment (no device gathers)
            g_sur = (
                src * np.int32(n_local) + np.int32(s * sl) + (rows - seg_base)
            )
        else:
            recv_all, nv, ovf = _gather_exchange(
                list(srt[s]) + [gpos],
                sentinels + [jnp.asarray(np.int32(2**31 - 1))],
                ("composite", (sws, sp), None),
                axis_name,
                num_devices,
                capacity,
                gpos_local=gpos,
            )
            recv, g_sur = recv_all[:-1], recv_all[-1]
        inval = (jnp.arange(capacity, dtype=jnp.int32) >= nv).astype(jnp.int32)
        big_invalid.append(inval)
        big_w.append(recv[0])
        big_g.append(g_sur)
        if has_vals:
            big_v.append(recv[1])
        n_valid = n_valid + nv.astype(jnp.int32)
        overflow = overflow | ovf

    ops = [
        jnp.concatenate(big_invalid),
        jnp.concatenate(big_w),
        jnp.concatenate(big_g),
    ] + ([jnp.concatenate(big_v)] if has_vals else [])
    merged = jax.lax.sort(ops, num_keys=3, is_stable=True)
    overflow = overflow | (n_valid > capacity)
    out_words = merged[1][:capacity]
    out_vals = merged[3][:capacity] if has_vals else None
    n_valid = jnp.minimum(n_valid, capacity)
    return (
        out_words,
        out_vals,
        n_valid.reshape(1),
        overflow.reshape(1),
    )


def _local_exchange(words, values, axis_name, num_devices, capacity, sentinel,
                    splitters=None, exchange=None):
    """Body run per device under shard_map. words: (n_local,) rank-space —
    or a LIST of big-endian uint32 limb arrays (composite keys; rows order
    and partition by the full lexicographic limb tuple).
    ``values`` likewise may be None, one array, or a list.

    ``splitters``: optional externally chosen key-only (P-1,) range
    splitters over the LEADING limb (e.g. a join routing both sides on one
    shared sketch — equal tuples share the leading limb, so they still
    co-locate); when None, composite regular-sampled (key limbs...,
    position) splitters are drawn from this data and the partition is
    deterministically balanced for any distribution and any limb count.
    ``exchange``: "ragged" | "gather" | "pipelined" (default by backend;
    "pipelined" stripes the shard to overlap collectives with compute and
    picks ragged/gather per backend underneath; single-limb only).
    """
    if exchange is None:
        exchange = default_exchange()
    multi_k = isinstance(words, (list, tuple))
    multi_v = isinstance(values, (list, tuple))
    key_ops = list(words) if multi_k else [words]
    val_ops = (
        [] if values is None else (list(values) if multi_v else [values])
    )
    nk = len(key_ops)

    def _shape_out(recv_k, recv_v, n_valid, overflow):
        ow = recv_k if multi_k else recv_k[0]
        if values is None:
            ov = None
        else:
            ov = recv_v if multi_v else recv_v[0]
        return ow, ov, n_valid.astype(jnp.int32).reshape(1), overflow.reshape(1)

    if exchange == "pipelined":
        if splitters is not None:
            raise ValueError("pipelined exchange draws its own splitters")
        if multi_k or multi_v:
            raise ValueError("pipelined exchange supports single-word keys")
        return _pipelined_exchange(
            words, values, axis_name, num_devices, capacity, sentinel
        )
    sorted_ops = jax.lax.sort(key_ops + val_ops, num_keys=nk, is_stable=True)
    s_limbs = list(sorted_ops[:nk])
    s_words = sorted_ops[0]

    if splitters is None:
        sws, sp = _composite_splitters(s_limbs, axis_name, num_devices)
        bounds = ("composite", (sws, sp), None)
    else:
        bounds = ("key", splitters, None)

    sentinels = (
        [sentinel]
        + [jnp.asarray(np.iinfo(np.dtype(w.dtype)).max, w.dtype)
           for w in key_ops[1:]]
        + [jnp.zeros((), v.dtype) for v in val_ops]
    )
    if exchange == "gather":
        recv, n_valid, overflow = _gather_exchange(
            sorted_ops, sentinels, bounds, axis_name, num_devices, capacity,
            num_keys=nk,
        )
        return _shape_out(recv[:nk], recv[nk:], n_valid, overflow)

    if bounds[0] == "composite":
        starts = _composite_starts(s_limbs, sws, sp, axis_name, num_devices)
    else:
        starts = _key_starts(s_words, splitters)
    recv, n_valid, overflow, _ = _ragged_exchange(
        sorted_ops, sentinels, starts, axis_name, num_devices, capacity
    )

    # final stable local sort; explicit invalid flag leads the key so real
    # sentinel-valued keys sort before padding, ties keep (source rank,
    # source position) order -> global stability
    invalid = (jnp.arange(capacity, dtype=jnp.int32) >= n_valid).astype(jnp.int32)
    ops = [invalid] + recv
    sorted_final = jax.lax.sort(ops, num_keys=1 + nk, is_stable=True)
    return _shape_out(
        list(sorted_final[1:1 + nk]), list(sorted_final[1 + nk:]),
        n_valid, overflow,
    )


def distributed_sort(
    keys,
    mesh: Mesh,
    axis_name: str = "x",
    *,
    descending: bool = False,
    capacity: int | None = None,
    exchange: str | None = None,
):
    """Sort ``keys`` (sharded or shardable over ``mesh``'s ``axis_name``).

    ``keys`` may be one column of any supported dtype, or a LIST of
    equal-length columns — rows then sort lexicographically by the column
    tuple (the distributed ``lexsort``, primary column first) and the
    sorted columns come back as a list.

    Returns ``(sorted_padded, counts, overflow)`` where ``sorted_padded``
    has shape (num_devices * capacity,) sharded over the mesh; device d's
    valid prefix is ``counts[d]`` rows and the concatenation of valid
    prefixes is the globally sorted array (stable, total_cmp float order —
    the reference's semantics, src/radix_sort/tests.rs:7-23).

    ``descending=True`` reverses the key order (stable-descending: equal
    keys keep global input order), as on the single-chip entry points.

    ``capacity`` (test/tuning override) replaces the provisioned
    :func:`exchange_capacity` bound. If the exchange overflows — impossible
    at the provisioned bound, reachable only through the override — the
    result falls back to a replicated global sort laid out identically, so
    the output is ALWAYS exact; ``overflow`` then reports that the fallback
    path was taken.

    ``exchange``: None picks :func:`default_exchange` (and skips the
    exchange on a 1-device mesh); a named exchange ("ragged", "gather",
    "pipelined") runs even on one device.
    """
    limbs, decode = _encode_key_arg(keys, descending)
    ows, _, counts, overflow = _dist_sort_impl(
        limbs, None, mesh, axis_name, capacity, exchange
    )
    return decode(ows), counts, overflow


def distributed_sort_pairs(
    keys,
    values,
    mesh: Mesh,
    axis_name: str = "x",
    *,
    descending: bool = False,
    capacity: int | None = None,
    exchange: str | None = None,
):
    """Key/payload variant of :func:`distributed_sort` (stable; the tuple
    semantics of the reference, src/radix_sort/radix_digits.rs:126-136).
    ``keys`` and/or ``values`` may be column lists (composite keys / a
    multi-column table riding one sort)."""
    limbs, decode = _encode_key_arg(keys, descending)
    ows, ovs, counts, overflow = _dist_sort_impl(
        limbs, values, mesh, axis_name, capacity, exchange
    )
    return decode(ows), ovs, counts, overflow


def distributed_sort_limbs(
    limbs,
    values=None,
    *,
    mesh: Mesh,
    axis_name: str = "x",
    descending: bool = False,
    capacity: int | None = None,
    exchange: str | None = None,
):
    """Raw multi-word variant: ``limbs`` is a list of big-endian unsigned
    limb arrays already in rank space (the distributed analogue of
    :func:`radix_sort_tpu.sort_limbs` — e.g. ``keys.encode128`` output for
    128-bit keys). Returns ``(sorted_limbs, values, counts, overflow)`` in
    the padded per-device layout of :func:`distributed_sort`."""
    if not isinstance(limbs, (list, tuple)) or not limbs:
        raise ValueError("limbs must be a non-empty list of limb arrays")
    for w in limbs:
        if np.dtype(w.dtype).kind != "u":
            raise ValueError(
                f"limbs must be unsigned rank-space words, got {w.dtype}"
            )
    limb_list = [~w for w in limbs] if descending else list(limbs)
    ows, ovs, counts, overflow = _dist_sort_impl(
        limb_list, values, mesh, axis_name, capacity, exchange
    )
    if descending:
        ows = [~w for w in ows]
    return ows, ovs, counts, overflow


def _encode_key_arg(keys, descending=False):
    """Canonicalize a public key operand -> (limb list, decode fn).
    ``descending`` complements every rank-space limb (stable-descending:
    complement + stable ascending sort reverses key order while equal keys
    keep input order), mirroring ops/sort.py's ``_dir``."""
    if isinstance(keys, (list, tuple)):
        from radix_sort_tpu.ops import query as _q

        cols = list(keys)
        limbs, specs = _q._cols_to_limbs(cols)
        if descending:
            limbs = [~w for w in limbs]

        def decode(ows):
            if descending:
                ows = [~w for w in ows]
            return _q._limbs_to_cols(ows, specs)

        return limbs, decode
    word = K.encode(keys)
    if descending:
        word = ~word

    def decode1(ows):
        w = ~ows[0] if descending else ows[0]
        return K.decode(w, keys.dtype)

    return [word], decode1


def _global_sort_fallback(limbs, val_ops, num_devices, capacity, sentinels):
    """Replicated exact path in the padded per-device layout (overflow
    insurance)."""
    n = limbs[0].shape[0]
    n_local = n // num_devices
    nk = len(limbs)
    srt = jax.lax.sort(list(limbs) + list(val_ops), num_keys=nk,
                       is_stable=True)

    def pad_out(x, fill):
        x = x.reshape(num_devices, n_local)
        pad = jnp.full((num_devices, capacity - n_local), fill, x.dtype)
        return jnp.concatenate([x, pad], axis=1).reshape(-1)

    outs = [pad_out(x, s) for x, s in zip(srt, sentinels)]
    counts = jnp.full((num_devices,), n_local, jnp.int32)
    return outs[:nk], outs[nk:], counts


def _dist_sort_impl(limbs, values, mesh, axis_name, capacity=None,
                    exchange=None):
    """Core distributed sort over a key limb LIST plus 0..M value operands.

    Returns ``(key_limbs, value_list, counts, overflow)``; the value list
    mirrors the input form (None stays None, one array stays one array)."""
    multi_v = isinstance(values, (list, tuple))
    val_ops = [] if values is None else (list(values) if multi_v else [values])
    nk, nv = len(limbs), len(val_ops)
    num_devices = mesh.shape[axis_name]
    n = limbs[0].shape[0]
    for x in limbs[1:] + val_ops:
        if x.shape[0] != n:
            raise ValueError("all key/value operands must share a length")
    if n % num_devices != 0:
        raise ValueError(
            f"n ({n}) must be divisible by the mesh axis ({num_devices}); pad upstream"
        )
    n_local = n // num_devices
    if n >= 2**31:
        # routing/stability tiebreaks use int32 global positions
        # (r*n_local + i); beyond 2^31 rows they would wrap and silently
        # mis-partition equal keys — refuse instead (hi/lo position limbs
        # would be the extension point)
        raise ValueError(
            f"distributed sort supports < 2**31 total rows (got {n}): "
            "int32 position tiebreaks"
        )
    if exchange not in (None, "ragged", "gather", "pipelined"):
        raise ValueError(
            "exchange must be one of None (auto), 'ragged', 'gather', "
            f"'pipelined'; got {exchange!r}"
        )
    if exchange == "pipelined" and (nk > 1 or nv > 1):
        raise ValueError("pipelined exchange supports one key word and at "
                         "most one value operand")
    if capacity is None:
        capacity = exchange_capacity(n_local, num_devices)
    if capacity < n_local:
        raise ValueError(f"capacity ({capacity}) must be >= n_local ({n_local})")
    sentinel = np.array(np.iinfo(limbs[0].dtype).max, dtype=limbs[0].dtype)
    sentinels = (
        [sentinel]
        + [np.array(np.iinfo(np.dtype(w.dtype)).max, w.dtype)
           for w in limbs[1:]]
        + [np.zeros((), v.dtype) for v in val_ops]
    )

    def _shape_vals(ovs):
        if values is None:
            return None
        return list(ovs) if multi_v else ovs[0]

    if num_devices == 1 and exchange is None:
        # degenerate mesh: no exchange, just the local stable sort in the
        # same padded-layout contract (an explicitly named exchange still
        # runs, so one device can exercise the exchange code)
        ows, ovs, cnt = _global_sort_fallback(
            limbs, val_ops, 1, capacity, sentinels
        )
        return ows, _shape_vals(ovs), cnt, jnp.asarray(False)

    body = functools.partial(
        _local_exchange,
        axis_name=axis_name,
        num_devices=num_devices,
        capacity=capacity,
        sentinel=sentinel,
        exchange=exchange,
    )

    def fn(*ops):
        w = list(ops[:nk]) if nk > 1 else ops[0]
        if nv == 0:
            v = None
        elif nv == 1 and not multi_v:
            v = ops[nk]
        else:
            v = list(ops[nk:])
        ow, ov, cnt, ovf = body(w, v)
        ows = list(ow) if nk > 1 else [ow]
        ovs = [] if nv == 0 else (list(ov) if isinstance(ov, list) else [ov])
        return (*ows, *ovs, cnt, ovf)

    out = shard_map(
        fn, mesh=mesh, in_specs=(P(axis_name),) * (nk + nv),
        out_specs=(P(axis_name),) * (nk + nv + 2),
        check_vma=False,
    )(*limbs, *val_ops)
    ows, ovs = list(out[:nk]), list(out[nk:nk + nv])
    cnt, ovf = out[-2], out[-1]
    overflow = jnp.any(ovf)

    # The replicated fallback lives INSIDE its cond branch: it all-gathers
    # the whole input and sorts it on every device, so it must only execute
    # on the (override-forced) overflow path, never eagerly.
    def fb(_):
        fw, fv, fc = _global_sort_fallback(
            limbs, val_ops, num_devices, capacity, sentinels
        )
        return fw, fv, fc

    ows, ovs, cnt = jax.lax.cond(
        overflow, fb, lambda t: t, (ows, ovs, cnt)
    )
    return ows, _shape_vals(ovs), cnt, overflow
