"""Order-variant API tests: descending sorts, lexsort, top_k, unique.

Extends the reference's oracle pattern (tests.rs:7-23 — bit-exact equality
vs a trusted host sort) to the order-control surface the query engine adds
on top of the core sort: reversed total order, multi-column keys, partial
selection, and distinct-count.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import radix_sort_tpu as rst
from radix_sort_tpu import keys as K

IMPLS = ["oracle", "comparator", "xla_argsort", "xla_rank"]
N = 4_097


def _rand_ints(rng, dtype, n=N, hi=None):
    info = np.iinfo(dtype)
    high = info.max if hi is None else hi
    return rng.integers(info.min, high, size=n, endpoint=True, dtype=dtype)


def _np_encode(x):
    """Host mirror of keys.encode: unsigned words in total order."""
    return np.asarray(K.encode(jnp.asarray(x)))


def _stable_desc_perm(x):
    """Oracle permutation for stable-descending: equal keys keep input order."""
    enc = _np_encode(x)
    comp = np.invert(enc)  # unsigned complement reverses the order exactly
    return np.argsort(comp, kind="stable")


class TestDescending:
    @pytest.mark.parametrize("impl", IMPLS)
    @pytest.mark.parametrize("dtype", [np.uint8, np.uint32, np.int16,
                                       np.int64, np.uint64])
    def test_sort_descending_ints(self, rng, impl, dtype):
        x = _rand_ints(rng, dtype)
        got = np.asarray(
            rst.sort(jnp.asarray(x), descending=True, implementation=impl)
        )
        assert np.array_equal(got, np.sort(x, kind="stable")[::-1])

    @pytest.mark.parametrize("dtype", [np.float32, np.float64])
    def test_sort_descending_float_specials(self, rng, dtype):
        x = (rng.random(N) * 2.0 - 1.0).astype(dtype)
        specials = np.array([0.0, -0.0, np.nan, np.inf, -np.inf], dtype)
        x[rng.integers(0, N, size=specials.size)] = specials
        got = np.asarray(rst.sort(jnp.asarray(x), descending=True))
        want = x[_stable_desc_perm(x)]
        udt = np.uint32 if dtype == np.float32 else np.uint64
        assert np.array_equal(got.view(udt), want.view(udt))  # bit-exact

    @pytest.mark.parametrize("impl", IMPLS)
    def test_sort_pairs_descending_stability(self, rng, impl):
        # duplicate-heavy keys: equal keys must keep input payload order
        keys = rng.integers(0, 64, size=N, dtype=np.uint32)
        vals = np.arange(N, dtype=np.uint32)
        k, v = rst.sort_pairs(
            jnp.asarray(keys), jnp.asarray(vals),
            descending=True, implementation=impl,
        )
        perm = _stable_desc_perm(keys)
        assert np.array_equal(np.asarray(k), keys[perm])
        assert np.array_equal(np.asarray(v), vals[perm])

    @pytest.mark.parametrize("impl", IMPLS)
    def test_argsort_descending(self, rng, impl):
        x = _rand_ints(rng, np.int32, hi=500)  # duplicates: check stability
        got = np.asarray(
            rst.argsort(jnp.asarray(x), descending=True, implementation=impl)
        )
        assert np.array_equal(got, _stable_desc_perm(x))

    def test_sort_limbs_descending(self, rng):
        hi = rng.integers(0, 8, size=N, dtype=np.uint32)  # ties across limbs
        lo = rng.integers(0, 1 << 32, size=N, dtype=np.uint32)
        pay = np.arange(N, dtype=np.uint32)
        (ohi, olo), (op,) = rst.sort_limbs(
            [jnp.asarray(hi), jnp.asarray(lo)], [jnp.asarray(pay)],
            descending=True,
        )
        perm = np.lexsort((np.arange(N), np.invert(lo), np.invert(hi)))
        assert np.array_equal(np.asarray(ohi), hi[perm])
        assert np.array_equal(np.asarray(olo), lo[perm])
        assert np.array_equal(np.asarray(op), pay[perm])


class TestLexsort:
    def test_matches_numpy_lexsort(self, rng):
        # mixed dtypes, duplicate-heavy so secondary/tertiary columns matter
        a = rng.integers(0, 8, size=N).astype(np.int32)
        b = (rng.random(N) * 4).astype(np.float32)
        c = _rand_ints(rng, np.uint16)
        perm = np.asarray(
            rst.lexsort([jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)])
        )
        # numpy lexsort takes the primary key LAST; ours takes it FIRST
        want = np.lexsort((c, b, a))
        assert np.array_equal(perm, want)

    def test_stability_on_full_ties(self, rng):
        a = np.full(N, 7, dtype=np.uint32)
        b = rng.integers(0, 4, size=N, dtype=np.uint8)
        perm = np.asarray(rst.lexsort([jnp.asarray(a), jnp.asarray(b)]))
        assert np.array_equal(perm, np.argsort(b, kind="stable"))

    def test_64bit_column(self, rng):
        a = _rand_ints(rng, np.int64, hi=4)  # narrow: force lo-limb ties
        b = _rand_ints(rng, np.uint32)
        perm = np.asarray(rst.lexsort([jnp.asarray(a), jnp.asarray(b)]))
        assert np.array_equal(perm, np.lexsort((b, a)))

    def test_descending(self, rng):
        a = rng.integers(0, 8, size=N).astype(np.uint32)
        b = rng.integers(0, 8, size=N).astype(np.uint32)
        perm = np.asarray(
            rst.lexsort([jnp.asarray(a), jnp.asarray(b)], descending=True)
        )
        want = np.lexsort((np.arange(N), np.invert(b), np.invert(a)))
        assert np.array_equal(perm, want)

    def test_single_column_equals_argsort(self, rng):
        x = _rand_ints(rng, np.int32, hi=100)
        perm = np.asarray(rst.lexsort([jnp.asarray(x)]))
        assert np.array_equal(perm, np.argsort(x, kind="stable"))

    def test_rejects_empty_and_ragged(self, rng):
        with pytest.raises(ValueError):
            rst.lexsort([])
        with pytest.raises(ValueError):
            rst.lexsort([jnp.zeros(4, jnp.int32), jnp.zeros(5, jnp.int32)])


class TestTopK:
    @pytest.mark.parametrize("dtype", [np.uint32, np.int32, np.float32])
    def test_largest(self, rng, dtype):
        if dtype == np.float32:
            x = (rng.random(N) * 100 - 50).astype(dtype)
        else:
            x = _rand_ints(rng, dtype)
        k = 129
        (tk,) = rst.top_k(jnp.asarray(x), k)
        want = x[_stable_desc_perm(x)][:k]
        assert np.array_equal(np.asarray(tk), want)

    def test_smallest(self, rng):
        x = _rand_ints(rng, np.int64)
        k = 65
        (tk,) = rst.top_k(jnp.asarray(x), k, largest=False)
        assert np.array_equal(np.asarray(tk), np.sort(x, kind="stable")[:k])

    def test_payloads_and_tie_stability(self, rng):
        # heavy duplicates: ties must resolve to the LOWEST input index
        keys = rng.integers(0, 16, size=N, dtype=np.uint32)
        vals = np.arange(N, dtype=np.int32)
        k = 257
        tk, tv = rst.top_k(jnp.asarray(keys), k, jnp.asarray(vals))
        perm = _stable_desc_perm(keys)[:k]
        assert np.array_equal(np.asarray(tk), keys[perm])
        assert np.array_equal(np.asarray(tv), vals[perm])

    def test_float_specials_order(self, rng):
        x = np.array([1.0, -np.inf, np.nan, 0.0, -0.0, np.inf, -1.0],
                     np.float32)
        (tk,) = rst.top_k(jnp.asarray(x), 3)
        # total order: NaN(+) > +inf > 1.0
        assert np.isnan(tk[0]) and tk[1] == np.inf and tk[2] == 1.0

    def test_k_bounds(self, rng):
        x = jnp.arange(8, dtype=jnp.uint32)
        (full,) = rst.top_k(x, 8)
        assert np.array_equal(np.asarray(full), np.arange(7, -1, -1))
        with pytest.raises(ValueError):
            rst.top_k(x, 9)
        with pytest.raises(ValueError):
            rst.top_k(x, -1)
        with pytest.raises(ValueError):
            rst.top_k(x, 2, jnp.zeros(4, jnp.uint32))


class TestUnique:
    @pytest.mark.parametrize("dtype", [np.uint8, np.int32, np.uint64,
                                       np.float32])
    def test_matches_numpy_unique(self, rng, dtype):
        if dtype == np.float32:
            x = (rng.random(N) * 8).round().astype(dtype)
        else:
            x = _rand_ints(rng, dtype, hi=min(200, np.iinfo(dtype).max))
        uk, counts, num = rst.unique(jnp.asarray(x))
        want_k, want_c = np.unique(x, return_counts=True)
        m = int(num)
        assert m == want_k.size
        assert np.array_equal(np.asarray(uk)[:m], want_k)
        assert np.array_equal(np.asarray(counts)[:m], want_c)
        assert np.all(np.asarray(counts)[m:] == 0)

    def test_all_equal(self):
        x = jnp.full((1000,), 42, jnp.uint32)
        uk, counts, num = rst.unique(x)
        assert int(num) == 1 and int(uk[0]) == 42 and int(counts[0]) == 1000

    def test_all_unique(self, rng):
        x = rng.permutation(N).astype(np.int32)
        uk, counts, num = rst.unique(jnp.asarray(x))
        assert int(num) == N
        assert np.array_equal(np.asarray(uk), np.arange(N))
        assert np.all(np.asarray(counts) == 1)

    def test_empty(self):
        uk, counts, num = rst.unique(jnp.zeros((0,), jnp.uint32))
        assert uk.shape == (0,) and counts.shape == (0,) and int(num) == 0

    def test_signed_negative_order(self, rng):
        x = rng.integers(-50, 50, size=N, dtype=np.int16)
        uk, counts, num = rst.unique(jnp.asarray(x))
        m = int(num)
        want_k, want_c = np.unique(x, return_counts=True)
        assert np.array_equal(np.asarray(uk)[:m], want_k)
        assert np.array_equal(np.asarray(counts)[:m], want_c)


class TestTopKComposite:
    def test_composite_vs_lexsort_oracle(self, rng):
        n = 4096
        a = rng.integers(0, 8, n).astype(np.int16)
        b = rng.standard_normal(n).astype(np.float32)
        v = np.arange(n, dtype=np.uint32)
        k = 97
        for largest in (True, False):
            tk, tv = rst.top_k(
                [jnp.asarray(a), jnp.asarray(b)], k, jnp.asarray(v),
                largest=largest,
            )
            order = np.lexsort((np.arange(n), b, a))  # stable asc by (a, b)
            if largest:
                # stable-descending oracle: lexsort on negated unsigned rank
                # words (total_cmp order), ties keep input position
                u = b.view(np.uint32).astype(np.int64)
                rank = np.where(u >= 2**31, (2**32 - 1) - u, u + 2**31)
                order = np.lexsort(
                    (np.arange(n), -rank, -a.astype(np.int64))
                )
            perm = order[:k]
            np.testing.assert_array_equal(np.asarray(tk[0]), a[perm])
            np.testing.assert_array_equal(
                np.asarray(tk[1]).view(np.uint32), b[perm].view(np.uint32)
            )
            np.testing.assert_array_equal(np.asarray(tv), v[perm])
