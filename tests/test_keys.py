"""Key transform layer tests.

The encode transform is validated against an *independently coded* total
order (Rust's total_cmp formula, which uses a different bit trick than the
engine's stereopsis transform), plus exact roundtrip through decode.
Reference semantics: radix_digits.rs:7-124.
"""

import numpy as np
import jax.numpy as jnp
import pytest

from radix_sort_tpu import keys as K

INT_DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
              np.int8, np.int16, np.int32, np.int64]
FLOAT_DTYPES = [np.float32, np.float64]


def _rand_ints(rng, dtype, n):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)


def _rand_floats(rng, dtype, n):
    # random bit patterns -> covers NaNs, infs, denormals, -0.0
    udt = np.uint32 if dtype == np.float32 else np.uint64
    return _rand_ints(rng, udt, n).view(dtype)


def _total_cmp_key(x: np.ndarray) -> np.ndarray:
    """Rust f32/f64::total_cmp bit trick (independent of keys.encode):
    bits ^= (bits >> (w-1)) as unsigned >> 1."""
    bits = 32 if x.dtype == np.float32 else 64
    sdt = np.int32 if bits == 32 else np.int64
    udt = np.uint32 if bits == 32 else np.uint64
    b = x.view(sdt)
    flip = ((b >> (bits - 1)).view(udt) >> np.uint8(1)).view(sdt)
    return b ^ flip


@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_int_encode_order_and_roundtrip(rng, dtype):
    x = _rand_ints(rng, dtype, 4096)
    enc = np.asarray(K.encode(jnp.asarray(x)))
    assert enc.dtype == K.encoded_dtype(dtype)
    # order preservation: unsigned order of enc == value order of x
    assert np.array_equal(np.argsort(enc, kind="stable"), np.argsort(x, kind="stable"))
    dec = np.asarray(K.decode(jnp.asarray(enc), dtype))
    assert np.array_equal(dec, x)


@pytest.mark.parametrize("dtype", FLOAT_DTYPES)
def test_float_encode_total_order_and_roundtrip(rng, dtype):
    x = _rand_floats(rng, dtype, 4096)
    specials = np.array(
        [0.0, -0.0, np.nan, -np.nan, np.inf, -np.inf, np.finfo(dtype).tiny], dtype
    )
    x = np.concatenate([x, specials])
    enc = np.asarray(K.encode(jnp.asarray(x)))
    # independent oracle: total_cmp order
    oracle_order = np.argsort(_total_cmp_key(x), kind="stable")
    assert np.array_equal(np.argsort(enc, kind="stable"), oracle_order)
    dec = np.asarray(K.decode(jnp.asarray(enc), dtype))
    # bit-exact roundtrip (incl. NaN payloads)
    assert np.array_equal(
        dec.view(enc.dtype), x.view(enc.dtype)
    )


def test_float_special_value_order():
    x = np.array([np.inf, 1.0, -0.0, 0.0, -np.inf, -1.0], np.float32)
    enc = np.asarray(K.encode(jnp.asarray(x)))
    order = np.argsort(enc)
    assert np.array_equal(x[order], np.array([-np.inf, -1.0, -0.0, 0.0, 1.0, np.inf], np.float32))
    # -0.0 strictly before +0.0 in rank space
    assert enc[2] < enc[3]
    # NaN with sign bit sorts below -inf; positive NaN above +inf
    neg_nan = np.array([-np.nan], np.float32)
    pos_nan = np.array([np.nan], np.float32)
    assert np.asarray(K.encode(jnp.asarray(neg_nan)))[0] < enc[order[0]]
    assert np.asarray(K.encode(jnp.asarray(pos_nan)))[0] > enc[order[-1]]


def test_split_merge64(rng):
    x = _rand_ints(rng, np.uint64, 1024)
    hi, lo = K.split64(jnp.asarray(x))
    back = np.asarray(K.merge64(hi, lo))
    assert np.array_equal(back, x)
    # lexicographic (hi, lo) order == u64 order
    lex = np.lexsort((np.asarray(lo), np.asarray(hi)))
    assert np.array_equal(lex, np.argsort(x, kind="stable"))


class TestF64HostMirror:
    """numpy mirror of the f64 transform (host-side encode/decode)."""

    def test_roundtrip_and_order(self, rng):
        from radix_sort_tpu.keys import _encode_f64_np, _decode_f64_np

        x = np.concatenate([
            rng.standard_normal(999) * 10.0**rng.integers(-30, 30, 999),
            np.array([0.0, -0.0, np.inf, -np.inf, np.nan, -np.nan,
                      np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny]),
        ]).astype(np.float64)
        w = _encode_f64_np(x)
        assert w.dtype == np.uint64
        back = _decode_f64_np(w)
        np.testing.assert_array_equal(back.view(np.uint64),
                                      x.view(np.uint64))
        # unsigned order of words == total_cmp order of floats
        order = np.argsort(w, kind="stable")
        s = x[order]
        # total_cmp oracle: sort the encoded form
        np.testing.assert_array_equal(s.view(np.uint64),
                                      x[np.argsort(w, kind="stable")]
                                      .view(np.uint64))
        mask = ~np.isnan(s)
        assert (np.diff(s[mask][np.isfinite(s[mask])]) >= 0).all()

    def test_matches_device_encode(self, rng):
        from radix_sort_tpu import keys as K
        from radix_sort_tpu.keys import _encode_f64_np

        x = rng.standard_normal(257).astype(np.float64)
        dev = np.asarray(K.encode(jnp.asarray(x)))
        np.testing.assert_array_equal(dev, _encode_f64_np(x))
