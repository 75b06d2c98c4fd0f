"""Order-preserving key bit-transforms (the L1 "key abstraction" layer).

This is the vectorized equivalent of the reference's ``RadixDigits`` trait
(reference: src/radix_sort/radix_digits.rs:1-136). Where the reference maps
(element, byte-index) -> u8 digit one scalar at a time, we map whole arrays
into an unsigned "rank space" with a single vectorized bit transform, so that

    unsigned_compare(encode(a), encode(b))  ==  total_order_compare(a, b)

for every supported dtype. Digits are then extracted from the encoded words
by shift/mask inside the sort engine.

Transforms (all exactly mirror the reference semantics):
  * unsigned ints  -- identity                 (radix_digits.rs:7-53)
  * signed ints    -- flip sign bit (x ^ MIN)  (radix_digits.rs:55-101)
  * floats         -- stereopsis total-order transform: negative values flip
                      all bits, positives flip only the sign bit
                      (radix_digits.rs:103-124); yields IEEE total_cmp order
                      including -0.0 < +0.0 and NaN ordered by payload/sign.

64-bit dtypes require ``jax.config.update("jax_enable_x64", True)`` at the
API boundary. :func:`split64` / :func:`merge64` move between one 64-bit
word and two 32-bit limbs, the form composite keys take through the
engine (:func:`encode_limbs`). Integer 64-bit transforms avoid bitcasts
(xor + two's-complement astype); f64 bitcasts to int64 on the device.
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

__all__ = [
    "encode",
    "decode",
    "encoded_dtype",
    "num_digit_bits",
    "split64",
    "merge64",
    "encode128",
    "decode128",
    "SUPPORTED_DTYPES",
]

# dtype -> (unsigned container dtype, bit width)
_UNSIGNED = {
    np.dtype(np.uint8): (np.uint8, 8),
    np.dtype(np.uint16): (np.uint16, 16),
    np.dtype(np.uint32): (np.uint32, 32),
    np.dtype(np.uint64): (np.uint64, 64),
}
_SIGNED = {
    np.dtype(np.int8): (np.uint8, 8),
    np.dtype(np.int16): (np.uint16, 16),
    np.dtype(np.int32): (np.uint32, 32),
    np.dtype(np.int64): (np.uint64, 64),
}
_FLOAT = {
    np.dtype(np.float32): (np.uint32, 32),
    np.dtype(np.float64): (np.uint64, 64),
}

SUPPORTED_DTYPES = tuple(_UNSIGNED) + tuple(_SIGNED) + tuple(_FLOAT)


def _signed_of(bits: int):
    return {8: np.int8, 16: np.int16, 32: np.int32, 64: np.int64}[bits]


def encoded_dtype(dtype) -> np.dtype:
    """Unsigned container dtype that ``encode`` produces for ``dtype``."""
    dtype = np.dtype(dtype)
    for table in (_UNSIGNED, _SIGNED, _FLOAT):
        if dtype in table:
            return np.dtype(table[dtype][0])
    raise TypeError(f"unsupported key dtype: {dtype}")


def num_digit_bits(dtype) -> int:
    """Total key width in bits (8 * reference NUMBER_OF_DIGITS)."""
    dtype = np.dtype(dtype)
    for table in (_UNSIGNED, _SIGNED, _FLOAT):
        if dtype in table:
            return table[dtype][1]
    raise TypeError(f"unsupported key dtype: {dtype}")


def encode(keys: jnp.ndarray) -> jnp.ndarray:
    """Map keys to unsigned words whose unsigned order is the keys' total order.

    Vectorized equivalent of the reference's per-type ``get_digit`` bit
    transforms (radix_digits.rs:7-124), applied to the whole word at once.
    """
    dtype = np.dtype(keys.dtype)
    if dtype in _UNSIGNED:
        return keys
    if dtype in _SIGNED:
        udt, bits = _SIGNED[dtype]
        # x ^ MIN flips the sign bit (radix_digits.rs:59 etc). The
        # signed->unsigned move is an astype (two's-complement wrap, bit
        # preserving).
        sign = dtype.type(np.iinfo(dtype).min)
        return (keys ^ sign).astype(udt)
    if dtype in _FLOAT:
        udt, bits = _FLOAT[dtype]
        sdt = _signed_of(bits)
        i = keys.view(sdt)
        # b ^= (b >> (bits-1)) | MIN  (radix_digits.rs:110-113, 118-121):
        # negative -> flip all bits; positive -> flip only the sign bit.
        mask = (i >> (bits - 1)) | sdt(np.iinfo(sdt).min)
        return (i ^ mask).view(udt)
    raise TypeError(f"unsupported key dtype: {dtype}")


def _encode_f64_np(x: np.ndarray) -> np.ndarray:
    """numpy mirror of the f64 stereopsis transform (host-side encode)."""
    i = np.ascontiguousarray(x).view(np.int64)
    mask = (i >> 63) | np.int64(np.iinfo(np.int64).min)
    return (i ^ mask).view(np.uint64)


def _decode_f64_np(w: np.ndarray) -> np.ndarray:
    e = np.ascontiguousarray(w).view(np.int64)
    mask = (~e >> 63) | np.int64(np.iinfo(np.int64).min)
    return (e ^ mask).view(np.float64)


def decode(words: jnp.ndarray, dtype) -> jnp.ndarray:
    """Inverse of :func:`encode`: unsigned rank-space words -> original dtype."""
    dtype = np.dtype(dtype)
    if dtype in _UNSIGNED:
        return words.astype(dtype) if words.dtype != dtype else words
    if dtype in _SIGNED:
        sign = dtype.type(np.iinfo(dtype).min)
        return words.astype(dtype) ^ sign
    if dtype in _FLOAT:
        _, bits = _FLOAT[dtype]
        sdt = _signed_of(bits)
        e = words.view(sdt)
        # If the encoded sign bit is set the original was >= +0.0: undo the
        # sign-bit flip. Otherwise the original was negative: undo the
        # full complement. mask = (~e >> (bits-1)) | MIN selects between them.
        mask = (~e >> (bits - 1)) | sdt(np.iinfo(sdt).min)
        return (e ^ mask).view(dtype)
    raise TypeError(f"unsupported key dtype: {dtype}")


def encode128(hi: jnp.ndarray, lo: jnp.ndarray, *, signed: bool = False):
    """128-bit keys (as hi/lo 64-bit words) -> 4 big-endian uint32 rank-space
    limbs for :func:`radix_sort_tpu.sort_limbs`.

    Covers the reference's u128/i128 (and usize/isize, which alias u64/i64)
    key types (src/radix_sort/radix_digits.rs:37-53, 87-93). For ``signed``
    (i128), ``hi`` is the int64 high word and the sign flip of the full
    128-bit value (``x ^ (1 << 127)``, the radix_digits.rs:93 transform) is
    exactly the int64 sign flip of the high word. ``lo`` is always the
    unsigned uint64 low word.
    """
    if signed:
        if hi.dtype != jnp.int64:
            raise TypeError(f"signed=True needs an int64 hi word, got {hi.dtype}")
        hi = encode(hi)
    elif hi.dtype != jnp.uint64:
        raise TypeError(f"signed=False needs a uint64 hi word, got {hi.dtype}")
    if lo.dtype != jnp.uint64:
        raise TypeError(f"lo must be uint64 (the unsigned low word), got {lo.dtype}")
    w0, w1 = split64(hi)
    w2, w3 = split64(lo)
    return [w0, w1, w2, w3]


def decode128(limbs, *, signed: bool = False):
    """Inverse of :func:`encode128`: 4 big-endian uint32 limbs -> (hi, lo)
    64-bit words (hi is int64 when ``signed``)."""
    w0, w1, w2, w3 = limbs
    hi = merge64(w0, w1)
    if signed:
        hi = decode(hi, np.int64)
    lo = merge64(w2, w3)
    return hi, lo


def encode_limbs(col: jnp.ndarray):
    """One key column -> its big-endian uint32 rank-space limbs.

    64-bit dtypes produce two limbs (``split64``), narrower dtypes one
    zero-extended limb; lexicographic unsigned order over the limbs equals
    the column's total order. This is the canonical form composite
    (multi-column) keys take through the engine.
    """
    w = encode(col)
    if np.dtype(w.dtype).itemsize == 8:
        return list(split64(w))
    return [w.astype(jnp.uint32)]


def decode_limbs(limbs, dtype) -> jnp.ndarray:
    """Inverse of :func:`encode_limbs` for one column."""
    dtype = np.dtype(dtype)
    if len(limbs) == 2:
        return decode(merge64(limbs[0], limbs[1]), dtype)
    (w,) = limbs
    edt = encoded_dtype(dtype)
    return decode(w.astype(edt), dtype)


def num_limbs(dtype) -> int:
    """Limb count :func:`encode_limbs` produces for ``dtype``."""
    return 2 if np.dtype(encoded_dtype(dtype)).itemsize == 8 else 1


def split64(words: jnp.ndarray):
    """uint64 rank-space words -> (hi, lo) uint32 limbs.

    Lexicographic unsigned order on (hi, lo) equals unsigned order on the
    64-bit word; this is how 64-bit keys enter multi-limb sorts.
    """
    assert words.dtype == jnp.uint64, words.dtype
    hi = (words >> np.uint64(32)).astype(jnp.uint32)
    lo = (words & np.uint64(0xFFFFFFFF)).astype(jnp.uint32)
    return hi, lo


def merge64(hi: jnp.ndarray, lo: jnp.ndarray) -> jnp.ndarray:
    """(hi, lo) uint32 limbs -> uint64 words. Inverse of :func:`split64`."""
    return (hi.astype(jnp.uint64) << np.uint64(32)) | lo.astype(jnp.uint64)
