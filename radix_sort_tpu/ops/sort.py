"""Public sort API (the L3 layer).

Array equivalent of the reference's extension traits on slices
(``RadixSort::radix_sort`` at mod.rs:18-20 and the ``RadixSortCopyOnly``
variant ladder at mod.rs:22-38), as pure functions over arrays:

    sort(keys)                 -- stable total-order sort, any supported dtype
    argsort(keys)              -- stable sorting permutation
    sort_pairs(keys, values)   -- stable key/payload row sort (tuple semantics)
    counting_sort(x)           -- single-pass counting sort for uint8

``implementation`` selects an engine from the variant ladder; "auto" picks
the active config's default (the comparator sort). All engines produce
bit-identical output (enforced by tests against the oracle).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from radix_sort_tpu import config
from radix_sort_tpu import keys as K
from radix_sort_tpu.ops import xla_radix

__all__ = [
    "sort",
    "argsort",
    "sort_pairs",
    "sort_limbs",
    "lexsort",
    "top_k",
    "sort_segments",
    "sort128",
    "argsort128",
    "sort_pairs128",
    "counting_sort",
    "IMPLEMENTATIONS",
]


def _words_engines():
    # name -> (sort_words, argsort_words)
    return {
        "comparator": (
            # keys-only sort: equal words are indistinguishable, so the
            # unstable network gives the identical array ~20% faster;
            # argsort keeps stability (permutation IS observable)
            lambda w: jnp.sort(w, stable=False),
            lambda w: jnp.argsort(w, stable=True),
        ),
        "oracle": (
            lambda w: jnp.sort(w, stable=True),
            lambda w: jnp.argsort(w, stable=True),
        ),
        "xla_argsort": (
            xla_radix.radix_sort_words_argsort,
            xla_radix.radix_argsort_words_argsort,
        ),
        "xla_rank": (
            xla_radix.radix_sort_words_rank,
            xla_radix.radix_argsort_words_rank,
        ),
    }


IMPLEMENTATIONS = (
    "auto", "comparator", "oracle", "xla_argsort", "xla_rank",
)


def _resolve(implementation: str) -> str:
    if implementation == "auto":
        # "auto" follows the active config's default engine
        return config.get().default_implementation
    if implementation not in IMPLEMENTATIONS:
        raise ValueError(
            f"implementation must be one of {IMPLEMENTATIONS}, got {implementation!r}"
        )
    return implementation


def _dir(words: jnp.ndarray, descending: bool) -> jnp.ndarray:
    """Complement encoded rank words to reverse the order.

    Bitwise NOT reverses unsigned order exactly, so sorting ``~w`` stably
    ascending == sorting ``w`` descending with equal keys still in input
    order (stable-descending semantics)."""
    return ~words if descending else words


def sort(keys: jnp.ndarray, *, descending: bool = False,
         implementation: str = "auto") -> jnp.ndarray:
    """Stable sort under the dtype's total order (ascending by default).

    Equivalent to the reference's ``data.radix_sort()`` on scalar slices
    (mod.rs:61-176): floats order by IEEE total_cmp (incl. -0.0 < +0.0, NaNs
    by sign/payload), signed ints by value. ``descending=True`` reverses the
    order (a complement in encoded rank space — no extra sort cost).
    """
    if implementation == "auto" and np.dtype(keys.dtype).itemsize == 1:
        # byte-wide keys-only: the single-pass counting sort (mod.rs:40-59)
        # is ~4x the comparator here — two fused compare-sum passes, no
        # element movement at all (keys-only, so stability is vacuous)
        w = _dir(xla_radix.counting_sort_u8(_dir(K.encode(keys), descending)),
                 descending)
        return K.decode(w, keys.dtype)
    impl = _resolve(implementation)
    sort_words, _ = _words_engines()[impl]
    w = _dir(sort_words(_dir(K.encode(keys), descending)), descending)
    return K.decode(w, keys.dtype)


def argsort(keys: jnp.ndarray, *, descending: bool = False,
            implementation: str = "auto") -> jnp.ndarray:
    """Indices of the stable total-order sort."""
    impl = _resolve(implementation)
    _, argsort_words = _words_engines()[impl]
    return argsort_words(_dir(K.encode(keys), descending))


def sort_pairs(keys: jnp.ndarray, values: jnp.ndarray, *,
               descending: bool = False, implementation: str = "auto"):
    """Stable sort of (key, payload) rows by key.

    Equivalent to the reference's tuple sort (radix_digits.rs:126-136): the
    payload never influences the order; equal keys keep input payload order
    (the stability invariant of mod.rs:110-120, tested at tests.rs:175-187).
    """
    if values.shape[:1] != keys.shape[:1]:
        raise ValueError(
            f"keys and values must share the leading axis, got {keys.shape} vs {values.shape}"
        )
    impl = _resolve(implementation)
    if impl == "comparator":
        # one variadic sort carries the payload; no argsort + gathers
        words, out_vals = jax.lax.sort(
            [_dir(K.encode(keys), descending), values], num_keys=1,
            is_stable=True
        )
        return K.decode(_dir(words, descending), keys.dtype), out_vals
    perm = argsort(keys, descending=descending, implementation=impl)
    return keys[perm], values[perm]


def counting_sort(x: jnp.ndarray) -> jnp.ndarray:
    """Single-pass counting sort for uint8 (reference mod.rs:40-59)."""
    return xla_radix.counting_sort_u8(x)


def sort_limbs(key_words, value_words=(), *, descending: bool = False,
               implementation: str = "auto"):
    """Stable co-sort by a multi-word big-endian unsigned key.

    ``key_words``: most-significant-first uint32 limbs (any count — this is
    how arbitrarily wide keys sort as 32-bit words, covering the
    reference's u128/usize impls, radix_digits.rs:37-53). ``value_words``:
    additional uint32 arrays carried along. Returns the co-sorted lists
    ``(key_words, value_words)``.
    """
    key_words = list(key_words)
    value_words = list(value_words)
    if not key_words:
        raise ValueError("sort_limbs needs at least one key word")
    n = key_words[0].shape[0]
    for a in key_words + value_words:
        if a.shape[0] != n or a.dtype != jnp.uint32:
            raise ValueError("all limbs must be uint32 arrays of equal length")
    nk = len(key_words)
    if descending:
        # complementing every limb reverses the lexicographic order exactly
        key_words = [~w for w in key_words]
    _resolve(implementation)  # validate; one fused variadic sort either way
    out = jax.lax.sort(key_words + value_words, num_keys=nk, is_stable=True)
    kw_out = [~w for w in out[:nk]] if descending else list(out[:nk])
    return kw_out, list(out[nk:])


_column_limbs = K.encode_limbs


def lexsort(columns, *, descending: bool = False,
            implementation: str = "auto") -> jnp.ndarray:
    """Stable sorting permutation over multiple key columns.

    ``columns`` is a sequence of equal-length arrays (any supported dtype
    mix); the FIRST column is the primary key (note: numpy's ``lexsort``
    takes the primary key LAST). Ties across all columns keep input order.
    Generalizes the reference's tuple keys (radix_digits.rs:126-136) from
    (key, payload) to arbitrarily many significant columns: each column is
    encoded into uint32 rank limbs and the concatenation sorts
    lexicographically via :func:`sort_limbs`.
    """
    columns = list(columns)
    if not columns:
        raise ValueError("lexsort needs at least one column")
    n = columns[0].shape[0]
    limbs = []
    for c in columns:
        if c.shape[0] != n:
            raise ValueError("all columns must have equal length")
        limbs.extend(_column_limbs(c))
    idx = jnp.arange(n, dtype=jnp.uint32)
    _, vals = sort_limbs(limbs, [idx], descending=descending,
                         implementation=implementation)
    return vals[0].astype(jnp.int32)


def sort_segments(keys: jnp.ndarray, offsets: jnp.ndarray,
                  values=(), *, descending: bool = False,
                  implementation: str = "auto"):
    """Independently sort each contiguous segment of ``keys`` (stably).

    ``offsets`` is the (S+1,)-element int32 boundary array of the CUB
    ``DeviceSegmentedRadixSort`` convention: segment ``s`` is rows
    ``[offsets[s], offsets[s+1])``; ``offsets[0] == 0`` and
    ``offsets[-1] == len(keys)`` (empty segments allowed). Returns
    ``(keys_sorted, [values_sorted...])`` with every segment in place and
    internally sorted; equal keys keep input order (``descending`` reverses
    key order within each segment only).

    Formulation: one fused multi-word stable sort by
    (segment-id, key) — segment ids are non-decreasing over rows, so the
    global sort leaves segments in place. Segment ids come from a cumsum
    over boundary scatters, not a per-row binary search.
    """
    values = list(values)
    n = keys.shape[0]
    for v in values:
        if v.shape[0] != n:
            raise ValueError("all value arrays must match the keys length")
    if n == 0:
        return keys, values
    # interior boundaries only; duplicates (empty segments) just skip ids
    marks = jnp.zeros((n,), jnp.uint32)
    interior = offsets[1:-1].astype(jnp.int32)
    if interior.shape[0]:
        marks = marks.at[jnp.clip(interior, 0, n - 1)].add(
            jnp.where((interior >= 0) & (interior < n), 1, 0).astype(
                jnp.uint32
            )
        )
    seg = jnp.cumsum(marks)
    key_limbs = [_dir(w, descending) for w in _column_limbs(keys)]
    _resolve(implementation)  # validate; one fused variadic sort either way
    nk = 1 + len(key_limbs)
    out = jax.lax.sort(
        [seg] + key_limbs + values, num_keys=nk, is_stable=True
    )
    kw = out[1] if nk == 2 else K.merge64(out[1], out[2])
    out_keys = K.decode(_dir(kw, descending), keys.dtype)
    return out_keys, list(out[nk:])


def top_k(keys: jnp.ndarray, k: int, *arrays: jnp.ndarray,
          largest: bool = True):
    """Top ``k`` rows by key under the dtype's total order.

    Returns ``(top_keys, *top_arrays)`` with the selected rows sorted
    (descending for ``largest=True``, ascending otherwise); ties are broken
    by input position (stable). Payload ``arrays`` are co-selected by k
    gathers — cheap because only k rows move, unlike a full
    ``sort_pairs`` (the selection itself is ``lax.top_k`` over encoded
    rank words: O(n) scan instead of a full sort).

    ``keys`` may be a list/tuple of equal-length columns (composite
    ORDER BY ... LIMIT k, selection by the lexicographic column tuple);
    ``top_keys`` is then a column list and the selection runs as one
    variadic sort over the uint32 limbs (no multi-key ``lax.top_k``).
    """
    multi = isinstance(keys, (list, tuple))
    cols = list(keys) if multi else [keys]
    n = cols[0].shape[0]
    if not 0 <= k <= n:
        raise ValueError(f"k must be in [0, {n}], got {k}")
    for a in list(cols[1:]) + list(arrays):
        if a.shape[0] != n:
            raise ValueError("all arrays must match the keys length")
    if multi:
        from radix_sort_tpu.ops import query as _q

        limbs, specs = _q._cols_to_limbs(cols)
        sel = [~w for w in limbs] if largest else limbs
        idx_all = jnp.arange(n, dtype=jnp.int32)
        srt = jax.lax.sort(
            sel + [idx_all], num_keys=len(sel) + 1, is_stable=False
        )
        top_limbs = [(~w if largest else w)[:k] for w in srt[:len(sel)]]
        idx = srt[len(sel)][:k]
        out = [_q._limbs_to_cols(top_limbs, specs)]
        for a in arrays:
            out.append(a[idx])
        return tuple(out)
    w = K.encode(keys)
    if not largest:
        w = ~w
    # lax.top_k orders descending and breaks ties by lower index — exactly
    # stable-descending over the encoded rank word
    topw, idx = jax.lax.top_k(w, k)
    if not largest:
        topw = ~topw
    out = [K.decode(topw, keys.dtype)]
    for a in arrays:
        out.append(a[idx])
    return tuple(out)


def sort128(hi, lo, *, signed: bool = False, implementation: str = "auto"):
    """Stable sort of 128-bit keys held as (hi, lo) 64-bit words.

    The reference's u128/i128 key types (radix_digits.rs:37-53, 87-93):
    keys travel as 4 big-endian uint32 limbs
    (:func:`radix_sort_tpu.keys.encode128`). ``signed`` selects i128 (hi is
    int64). Returns the sorted (hi, lo) pair.
    """
    limbs = K.encode128(hi, lo, signed=signed)
    out, _ = sort_limbs(limbs, implementation=implementation)
    return K.decode128(out, signed=signed)


def argsort128(hi, lo, *, signed: bool = False, implementation: str = "auto"):
    """Indices of the stable 128-bit total-order sort."""
    limbs = K.encode128(hi, lo, signed=signed)
    idx = jnp.arange(hi.shape[0], dtype=jnp.uint32)
    _, vals = sort_limbs(limbs, [idx], implementation=implementation)
    return vals[0].astype(jnp.int32)


def sort_pairs128(hi, lo, values, *, signed: bool = False,
                  implementation: str = "auto"):
    """Stable 128-bit key / uint32-payload row sort (tuple semantics,
    radix_digits.rs:126-136). Returns ((hi, lo), values)."""
    if values.dtype != jnp.uint32:
        raise TypeError(f"values must be uint32 words, got {values.dtype}")
    limbs = K.encode128(hi, lo, signed=signed)
    out, vals = sort_limbs(limbs, [values], implementation=implementation)
    return K.decode128(out, signed=signed), vals[0]
