"""Sort API tests: the reference test suite's pattern (tests.rs:25-187)
re-created -- one randomized test per key type against a trusted oracle,
adversarial float specials, and stability via payloads -- run across every
engine in the variant ladder."""

import numpy as np
import jax.numpy as jnp
import pytest

import radix_sort_tpu as rst

IMPLS = ["oracle", "comparator", "xla_argsort", "xla_rank"]
INT_DTYPES = [np.uint8, np.uint16, np.uint32, np.uint64,
              np.int8, np.int16, np.int32, np.int64]

N = 10_001  # odd size: exercises remainder handling


def _rand_ints(rng, dtype, n=N):
    info = np.iinfo(dtype)
    return rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", INT_DTYPES)
def test_sort_int_matrix(rng, impl, dtype):
    # mirrors tests.rs:25-131 (one test per int type, vs stable oracle)
    x = _rand_ints(rng, dtype)
    got = np.asarray(rst.sort(jnp.asarray(x), implementation=impl))
    assert np.array_equal(got, np.sort(x, kind="stable"))


@pytest.mark.parametrize("impl", IMPLS)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_sort_float_specials(rng, impl, dtype):
    # mirrors tests.rs:134-173: uniform floats + injected specials, oracle
    # order = IEEE total_cmp == numpy sort on the independent total_cmp key
    x = (rng.random(N) * 2.0 - 1.0).astype(dtype)
    specials = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], dtype)
    idx = rng.integers(0, N, size=specials.size)
    x[idx] = specials
    got = np.asarray(rst.sort(jnp.asarray(x), implementation=impl))

    bits = 32 if dtype == np.float32 else 64
    sdt = np.int32 if bits == 32 else np.int64
    udt = np.uint32 if bits == 32 else np.uint64
    b = x.view(sdt)
    tc = b ^ ((b >> (bits - 1)).view(udt) >> np.uint8(1)).view(sdt)
    want = x[np.argsort(tc, kind="stable")]
    assert np.array_equal(got.view(udt), want.view(udt))  # bit-exact incl NaN


@pytest.mark.parametrize("impl", IMPLS)
def test_sort_pairs_stability(rng, impl):
    # mirrors tests.rs:175-187: (u32,u32) rows, equal keys keep payload order
    keys = rng.integers(0, 64, size=N, dtype=np.uint32)  # heavy duplicates
    vals = np.arange(N, dtype=np.uint32)
    k, v = rst.sort_pairs(jnp.asarray(keys), jnp.asarray(vals), implementation=impl)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(np.asarray(k), keys[order])
    assert np.array_equal(np.asarray(v), vals[order])


@pytest.mark.parametrize("impl", IMPLS)
def test_argsort(rng, impl):
    x = _rand_ints(rng, np.int32, 4097)
    perm = np.asarray(rst.argsort(jnp.asarray(x), implementation=impl))
    assert np.array_equal(perm, np.argsort(x, kind="stable"))


def test_counting_sort_u8(rng):
    # reference pub fn counting_sort (mod.rs:40-59)
    x = _rand_ints(rng, np.uint8, 4096)
    got = np.asarray(rst.counting_sort(jnp.asarray(x)))
    assert np.array_equal(got, np.sort(x))


@pytest.mark.parametrize("impl", IMPLS)
def test_sort_empty_and_single(impl):
    for x in [np.array([], np.uint32), np.array([42], np.uint32)]:
        got = np.asarray(rst.sort(jnp.asarray(x), implementation=impl))
        assert np.array_equal(got, np.sort(x))


@pytest.mark.parametrize("impl", IMPLS)
def test_sort_already_sorted_and_reverse(impl):
    x = np.arange(1000, dtype=np.uint32)
    assert np.array_equal(np.asarray(rst.sort(jnp.asarray(x), implementation=impl)), x)
    assert np.array_equal(
        np.asarray(rst.sort(jnp.asarray(x[::-1].copy()), implementation=impl)), x
    )


class TestSort128:
    """128-bit keys (reference radix_digits.rs:37-53, 87-93): u128/i128 as
    (hi, lo) 64-bit words, sorted via 4 big-endian u32 limbs."""

    def _edges(self, rng, n, signed):
        hdt = np.int64 if signed else np.uint64
        hi = rng.integers(np.iinfo(hdt).min, np.iinfo(hdt).max, n,
                          endpoint=True, dtype=hdt)
        lo = rng.integers(0, np.iinfo(np.uint64).max, n, endpoint=True,
                          dtype=np.uint64)
        # inject boundary values (the sign flip's edge cases)
        hi[:6] = [np.iinfo(hdt).min, np.iinfo(hdt).max, 0, 0,
                  np.iinfo(hdt).min, np.iinfo(hdt).max]
        lo[:6] = [0, np.iinfo(np.uint64).max, 0,
                  np.iinfo(np.uint64).max, np.iinfo(np.uint64).max, 0]
        return hi, lo

    @pytest.mark.parametrize("signed", [False, True])
    def test_sort128_matches_lexsort(self, rng, signed):
        n = 4096
        hi, lo = self._edges(rng, n, signed)
        oh, ol = rst.sort128(jnp.asarray(hi), jnp.asarray(lo), signed=signed)
        perm = np.lexsort((lo, hi))  # hi primary (signed order for int64)
        np.testing.assert_array_equal(np.asarray(oh), hi[perm])
        np.testing.assert_array_equal(np.asarray(ol), lo[perm])

    @pytest.mark.parametrize("signed", [False, True])
    def test_argsort128_and_pairs_stability(self, rng, signed):
        n = 4096
        hdt = np.int64 if signed else np.uint64
        # heavy duplicates across BOTH words: stability observable
        hi = rng.integers(-2 if signed else 0, 2, n).astype(hdt)
        lo = rng.integers(0, 3, n).astype(np.uint64)
        vals = np.arange(n, dtype=np.uint32)
        perm = np.asarray(
            rst.argsort128(jnp.asarray(hi), jnp.asarray(lo), signed=signed)
        )
        want = np.lexsort((np.arange(n), lo, hi))  # stable lexsort
        np.testing.assert_array_equal(perm, want)
        (oh, ol), ov = rst.sort_pairs128(
            jnp.asarray(hi), jnp.asarray(lo), jnp.asarray(vals), signed=signed
        )
        np.testing.assert_array_equal(np.asarray(oh), hi[want])
        np.testing.assert_array_equal(np.asarray(ol), lo[want])
        np.testing.assert_array_equal(np.asarray(ov), vals[want])

    def test_encode128_rejects_wrong_dtypes(self):
        from radix_sort_tpu import keys as K

        with pytest.raises(TypeError, match="uint64"):
            K.encode128(jnp.zeros(4, jnp.int64), jnp.zeros(4, jnp.uint64))
        with pytest.raises(TypeError, match="int64"):
            K.encode128(jnp.zeros(4, jnp.uint64), jnp.zeros(4, jnp.uint64),
                        signed=True)
        with pytest.raises(TypeError, match="lo must be"):
            K.encode128(jnp.zeros(4, jnp.uint64), jnp.zeros(4, jnp.int64))


class TestSortLimbs:
    """Multi-word keys (the reference's u128/usize parity on 32-bit lanes)."""

    def test_u128_as_four_limbs(self, rng):
        import jax.numpy as jnp
        from radix_sort_tpu import sort_limbs

        n = 4096
        limbs = [rng.integers(0, 2**32, n, dtype=np.uint32) for _ in range(4)]
        payload = [np.arange(n, dtype=np.uint32)]
        (k_out, v_out) = sort_limbs(
            [jnp.asarray(x) for x in limbs], [jnp.asarray(payload[0])]
        )
        perm = np.lexsort(tuple(reversed(limbs)))
        for got, src in zip(k_out, limbs):
            np.testing.assert_array_equal(np.asarray(got), src[perm])
        np.testing.assert_array_equal(np.asarray(v_out[0]), payload[0][perm])

    def test_rejects_bad_dtypes(self):
        import jax.numpy as jnp
        import pytest
        from radix_sort_tpu import sort_limbs

        with pytest.raises(ValueError, match="uint32"):
            sort_limbs([jnp.zeros(8, jnp.uint16)])
        with pytest.raises(ValueError, match="at least one key"):
            sort_limbs([])
