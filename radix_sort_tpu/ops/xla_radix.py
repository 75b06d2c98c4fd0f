"""jnp-only LSD radix sort variants (the pedagogical ladder).

The reference keeps an optimization ladder ``radix_sort0..5`` documenting how
its production design was reached (src/radix_sort/mod.rs:178-571). This is
the array analogue: pure-XLA formulations of the multi-pass LSD pipeline
(histogram -> exclusive scan -> stable scatter), all checked against the
oracle. None of these is
the fast path -- they document the pass structure and serve as in-repo
cross-checks that run on any backend.

All variants operate in unsigned rank space (see keys.encode) and process
``digit_bits`` per pass, LSD order, exactly like the reference's outer pass
loop (mod.rs:84-168).
"""

from __future__ import annotations

import jax.numpy as jnp

from radix_sort_tpu import keys as K

__all__ = [
    "radix_sort_words_argsort",
    "radix_sort_words_rank",
    "radix_argsort_words_argsort",
    "radix_argsort_words_rank",
    "counting_sort_u8",
]


def _digit(words: jnp.ndarray, shift: int, nbits: int) -> jnp.ndarray:
    """Extract the pass digit; vectorized get_digit (radix_digits.rs)."""
    mask = (1 << nbits) - 1
    return ((words >> words.dtype.type(shift)) & words.dtype.type(mask)).astype(
        jnp.int32
    )


def radix_sort_words_argsort(words: jnp.ndarray, digit_bits: int = 8) -> jnp.ndarray:
    """Variant 0: LSD passes, each a stable argsort of the pass digit.

    Demonstrates that LSD over stable per-digit partitions yields a total
    sort (the invariant behind mod.rs:84: outer ``for digit`` loop).
    """
    bits = K.num_digit_bits(words.dtype)
    out = words
    for shift in range(0, bits, digit_bits):
        nbits = min(digit_bits, bits - shift)
        perm = jnp.argsort(_digit(out, shift, nbits), stable=True)
        out = out[perm]
    return out


def radix_sort_words_rank(words: jnp.ndarray, digit_bits: int = 4) -> jnp.ndarray:
    """Variant 1: LSD passes with explicit histogram/scan/rank/scatter.

    Mirrors the production pass pipeline of the reference (histogram
    mod.rs:90-109, exclusive scan mod.rs:110-120, stable scatter
    mod.rs:121-168) in dense XLA ops: per-pass one-hot digit matrix,
    destination = bin_offset[d] + rank-within-bin, applied with a scatter.
    O(N * 2**digit_bits) memory -- pedagogical sizes only.
    """
    bits = K.num_digit_bits(words.dtype)
    nbins = 1 << digit_bits
    out = words
    for shift in range(0, bits, digit_bits):
        nbits = min(digit_bits, bits - shift)
        d = _digit(out, shift, nbits)
        onehot = d[:, None] == jnp.arange(nbins, dtype=jnp.int32)[None, :]
        onehot = onehot.astype(jnp.int32)
        counts = onehot.sum(axis=0)  # histogram (mod.rs:95-99)
        offsets = jnp.cumsum(counts) - counts  # exclusive scan (mod.rs:110-120)
        # rank within bin = # earlier elements with the same digit -> the
        # scatter is a stable partition (mod.rs:130-154).
        rank = (jnp.cumsum(onehot, axis=0) - onehot)[
            jnp.arange(out.shape[0]), d
        ]
        dest = offsets[d] + rank
        out = jnp.zeros_like(out).at[dest].set(out, unique_indices=True)
    return out


def radix_argsort_words_argsort(words: jnp.ndarray, digit_bits: int = 8) -> jnp.ndarray:
    """Permutation-returning form of variant 0 (for sort_pairs / argsort)."""
    bits = K.num_digit_bits(words.dtype)
    out = words
    total = jnp.arange(words.shape[0], dtype=jnp.int32)
    for shift in range(0, bits, digit_bits):
        nbits = min(digit_bits, bits - shift)
        perm = jnp.argsort(_digit(out, shift, nbits), stable=True)
        out = out[perm]
        total = total[perm]
    return total


def radix_argsort_words_rank(words: jnp.ndarray, digit_bits: int = 4) -> jnp.ndarray:
    """Permutation-returning form of variant 1."""
    bits = K.num_digit_bits(words.dtype)
    nbins = 1 << digit_bits
    out = words
    total = jnp.arange(words.shape[0], dtype=jnp.int32)
    for shift in range(0, bits, digit_bits):
        nbits = min(digit_bits, bits - shift)
        d = _digit(out, shift, nbits)
        onehot = (d[:, None] == jnp.arange(nbins, dtype=jnp.int32)[None, :]).astype(
            jnp.int32
        )
        counts = onehot.sum(axis=0)
        offsets = jnp.cumsum(counts) - counts
        rank = (jnp.cumsum(onehot, axis=0) - onehot)[jnp.arange(out.shape[0]), d]
        dest = offsets[d] + rank
        out = jnp.zeros_like(out).at[dest].set(out, unique_indices=True)
        total = jnp.zeros_like(total).at[dest].set(total, unique_indices=True)
    return total


def counting_sort_u8(x: jnp.ndarray) -> jnp.ndarray:
    """Single-pass counting sort for uint8 (reference pub fn counting_sort,
    mod.rs:40-59): histogram then emit each value count[v] times.

    Both phases are compare-sums (XLA fuses the (n, 256) one-hots into the
    reductions), where scatter-add histograms and repeat/searchsorted
    emission would lower to element scatters/gathers. output[i] = #{v : end[v] <= i}
    — the number of value bins exhausted before position i."""
    assert x.dtype == jnp.uint8, x.dtype
    n = x.shape[0]
    vals = jnp.arange(256, dtype=jnp.int32)
    counts = jnp.sum(
        x.astype(jnp.int32)[:, None] == vals[None, :], axis=0, dtype=jnp.int32
    )
    ends = jnp.cumsum(counts)  # end[v] = first output position of v+1
    pos = jnp.arange(n, dtype=jnp.int32)
    return jnp.sum(
        (pos[:, None] >= ends[None, :]).astype(jnp.uint8), axis=1
    )
