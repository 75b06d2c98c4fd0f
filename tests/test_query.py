"""Query operator tests (filter / hash_aggregate / hash_join) vs numpy oracles."""

import numpy as np
import pytest
import jax.numpy as jnp

from radix_sort_tpu.ops import query


class TestFilter:
    def test_compacts_preserving_order(self, rng):
        n = 10_000
        x = rng.integers(0, 2**32, n, dtype=np.uint32)
        y = rng.integers(0, 2**32, n, dtype=np.uint32)
        mask = rng.random(n) < 0.3
        xc, yc, cnt = query.filter(jnp.asarray(mask), jnp.asarray(x), jnp.asarray(y))
        cnt = int(cnt)
        assert cnt == mask.sum()
        np.testing.assert_array_equal(np.asarray(xc)[:cnt], x[mask])
        np.testing.assert_array_equal(np.asarray(yc)[:cnt], y[mask])
        # the tail holds the dropped rows, also in order (stable partition)
        np.testing.assert_array_equal(np.asarray(xc)[cnt:], x[~mask])

    def test_empty_and_full(self, rng):
        x = rng.integers(0, 100, 64, dtype=np.uint32)
        _, cnt0 = query.filter(jnp.zeros(64, bool), jnp.asarray(x))
        assert int(cnt0) == 0
        xc, cnt1 = query.filter(jnp.ones(64, bool), jnp.asarray(x))
        assert int(cnt1) == 64
        np.testing.assert_array_equal(np.asarray(xc), x)

    def test_length_mismatch_raises(self):
        with pytest.raises(ValueError, match="match mask length"):
            query.filter(jnp.ones(4, bool), jnp.zeros(5, jnp.uint32))


class TestHashAggregate:
    @pytest.mark.parametrize("agg", query.AGGREGATIONS)
    def test_matches_numpy_groupby(self, rng, agg):
        n = 8_192
        keys = rng.integers(0, 50, n).astype(np.uint32)
        vals = rng.integers(0, 1000, n).astype(np.uint32)
        uk, av, cnt = query.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), agg)
        cnt = int(cnt)
        ref_keys = np.unique(keys)
        assert cnt == len(ref_keys)
        np.testing.assert_array_equal(np.asarray(uk)[:cnt], ref_keys)
        fns = {
            "sum": np.sum,
            "count": len,
            "min": np.min,
            "max": np.max,
            "mean": np.mean,
            "first": lambda g: g[0],
            "last": lambda g: g[-1],
            "median": lambda g: np.sort(g)[(len(g) - 1) // 2],
            "var": lambda g: g.astype(np.float64).var(),
            "std": lambda g: g.astype(np.float64).std(),
            "count_distinct": lambda g: len(np.unique(g)),
            "any": lambda g: (g != 0).any(),
            "all": lambda g: (g != 0).all(),
            "mode": lambda g: np.unique(g, return_counts=True)[0][
                np.argmax(np.unique(g, return_counts=True)[1])],
        }
        if agg in ("argmin", "argmax"):
            pick = np.argmin if agg == "argmin" else np.argmax
            ref = np.array([
                np.flatnonzero(keys == k)[pick(vals[keys == k])]
                for k in ref_keys
            ])
        else:
            ref = np.array([fns[agg](vals[keys == k]) for k in ref_keys])
        if agg in ("mean", "var", "std"):
            assert av.dtype == jnp.float32
            np.testing.assert_allclose(np.asarray(av)[:cnt], ref, rtol=1e-5)
        else:
            np.testing.assert_array_equal(
                np.asarray(av)[:cnt].astype(np.int64), ref.astype(np.int64)
            )

    def test_float_values_sum(self, rng):
        n = 4_096
        keys = rng.integers(0, 8, n).astype(np.uint32)
        vals = rng.random(n).astype(np.float32)
        uk, av, cnt = query.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), "sum")
        cnt = int(cnt)
        for i, k in enumerate(np.unique(keys)):
            np.testing.assert_allclose(
                np.asarray(av)[i], vals[keys == k].sum(), rtol=1e-4
            )

    def test_float_sum_large_vs_float64_oracle(self, rng):
        # spans many _SUM_BLOCK blocks; group sums must track a float64
        # oracle closely (two-level blocked accumulation)
        n = 65_536
        keys = rng.integers(0, 33, n).astype(np.uint32)
        vals = (rng.random(n).astype(np.float32) - 0.5) * 1000
        uk, av, cnt = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "sum"
        )
        cnt = int(cnt)
        ref = np.array(
            [vals[keys == k].astype(np.float64).sum() for k in np.unique(keys)]
        )
        np.testing.assert_allclose(
            np.asarray(av)[:cnt].astype(np.float64), ref, rtol=2e-5, atol=1e-2
        )

    def test_float_sum_single_group_and_tiny(self, rng):
        for n in (1, 2, 7):
            vals = rng.random(n).astype(np.float32)
            keys = np.zeros(n, np.uint32)
            uk, av, cnt = query.hash_aggregate(
                jnp.asarray(keys), jnp.asarray(vals), "sum"
            )
            assert int(cnt) == 1
            np.testing.assert_allclose(np.asarray(av)[0], vals.sum(), rtol=1e-5)

    def test_signed_keys(self, rng):
        keys = np.array([-5, 3, -5, 0, 3, -5], np.int32)
        vals = np.arange(6, dtype=np.uint32)
        uk, av, cnt = query.hash_aggregate(jnp.asarray(keys), jnp.asarray(vals), "count")
        assert int(cnt) == 3
        np.testing.assert_array_equal(np.asarray(uk)[:3], [-5, 0, 3])
        np.testing.assert_array_equal(np.asarray(av)[:3], [3, 1, 2])

    def test_bad_agg_raises(self):
        with pytest.raises(ValueError, match="agg must be one of"):
            query.hash_aggregate(jnp.zeros(4, jnp.uint32), jnp.zeros(4, jnp.uint32), "product")


class TestHolisticAggregations:
    """first/last/median/var/std/count_distinct vs numpy group loops."""

    def _data(self, rng, n=1500, kmax=40):
        keys = rng.integers(0, kmax, n).astype(np.uint32)
        vals = rng.integers(-100, 100, n).astype(np.int32)
        return keys, vals

    def _groups(self, keys):
        return np.unique(keys)

    def test_first_last(self, rng):
        keys, vals = self._data(rng)
        for agg in ("first", "last"):
            uk, av, cnt = query.hash_aggregate(
                jnp.asarray(keys), jnp.asarray(vals), agg
            )
            cnt = int(cnt)
            uks = self._groups(keys)
            assert cnt == len(uks)
            np.testing.assert_array_equal(np.asarray(uk)[:cnt], uks)
            for i, u in enumerate(uks):
                grp = vals[keys == u]
                want = grp[0] if agg == "first" else grp[-1]
                assert np.asarray(av)[i] == want, (agg, u)

    def test_median_lower(self, rng):
        keys, vals = self._data(rng)
        uk, av, cnt = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "median"
        )
        cnt = int(cnt)
        for i, u in enumerate(self._groups(keys)):
            grp = np.sort(vals[keys == u])
            want = grp[(len(grp) - 1) // 2]  # lower median
            assert np.asarray(av)[i] == want

    def test_quantile(self, rng):
        keys, vals = self._data(rng)
        for q in (0.0, 0.25, 0.5, 0.9, 1.0):
            uk, av, cnt = query.hash_aggregate(
                jnp.asarray(keys), jnp.asarray(vals), f"quantile:{q}"
            )
            for i, u in enumerate(self._groups(keys)):
                grp = np.sort(vals[keys == u])
                want = grp[int(np.floor(q * (len(grp) - 1) + 1e-6))]
                assert np.asarray(av)[i] == want, (q, u)

    def test_quantile_equals_median_and_validates(self, rng):
        keys, vals = self._data(rng)
        _, m, _ = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "median")
        _, h, _ = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "quantile:0.5")
        np.testing.assert_array_equal(np.asarray(m), np.asarray(h))
        with pytest.raises(ValueError, match="quantile"):
            query.hash_aggregate(
                jnp.asarray(keys), jnp.asarray(vals), "quantile:1.5")
        with pytest.raises(ValueError, match="quantile"):
            query.hash_aggregate(
                jnp.asarray(keys), jnp.asarray(vals), "quantile:x")

    def test_median_float_total_order(self, rng):
        keys = rng.integers(0, 8, 300).astype(np.uint32)
        vals = rng.standard_normal(300).astype(np.float32)
        vals[:6] = [np.nan, -0.0, 0.0, np.inf, -np.inf, 1.0]
        uk, av, cnt = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "median"
        )
        for i, u in enumerate(self._groups(keys)):
            grp = vals[keys == u]
            order = np.argsort([(np.isnan(x), x) for x in grp],
                               axis=0)  # not total order for -nan; approx
            # use the package's own total order as oracle (tested in
            # test_keys.py): sort encoded words
            from radix_sort_tpu import keys as K
            w = np.asarray(K.encode(jnp.asarray(grp)))
            srt = grp[np.argsort(w, kind="stable")]
            want = srt[(len(grp) - 1) // 2]
            got = np.asarray(av)[i]
            assert (np.isnan(want) and np.isnan(got)) or want == got or (
                want == 0 and got == 0
            )

    def test_var_std(self, rng):
        keys, vals = self._data(rng)
        for agg in ("var", "std"):
            uk, av, cnt = query.hash_aggregate(
                jnp.asarray(keys), jnp.asarray(vals), agg
            )
            for i, u in enumerate(self._groups(keys)):
                grp = vals[keys == u].astype(np.float64)
                want = grp.var() if agg == "var" else grp.std()
                np.testing.assert_allclose(np.asarray(av)[i], want,
                                           rtol=1e-5, atol=1e-5)

    def test_var_float_values(self, rng):
        keys, _ = self._data(rng)
        vals = (rng.standard_normal(len(keys)) * 10).astype(np.float32)
        uk, av, cnt = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "var"
        )
        for i, u in enumerate(self._groups(keys)):
            want = vals[keys == u].astype(np.float64).var()
            np.testing.assert_allclose(np.asarray(av)[i], want,
                                       rtol=1e-4, atol=1e-5)

    def test_count_distinct(self, rng):
        keys, _ = self._data(rng)
        vals = rng.integers(0, 12, len(keys)).astype(np.int32)
        uk, av, cnt = query.hash_aggregate(
            jnp.asarray(keys), jnp.asarray(vals), "count_distinct"
        )
        for i, u in enumerate(self._groups(keys)):
            assert np.asarray(av)[i] == len(np.unique(vals[keys == u]))

    def test_single_row_groups(self):
        keys = jnp.asarray(np.arange(5, dtype=np.uint32))
        vals = jnp.asarray(np.array([3, -1, 4, 1, -5], np.int32))
        for agg, want in [
            ("first", [3, -1, 4, 1, -5]), ("last", [3, -1, 4, 1, -5]),
            ("median", [3, -1, 4, 1, -5]),
            ("count_distinct", [1] * 5), ("var", [0.0] * 5),
            ("std", [0.0] * 5),
        ]:
            _, av, cnt = query.hash_aggregate(keys, vals, agg)
            assert int(cnt) == 5
            np.testing.assert_allclose(np.asarray(av)[:5], want)

    def test_multi_agg_with_holistics(self, rng):
        keys, vals = self._data(rng)
        vals2 = rng.integers(0, 7, len(keys)).astype(np.uint32)
        uk, outs, cnt = query.hash_aggregate(
            jnp.asarray(keys),
            [jnp.asarray(vals)] * 5 + [jnp.asarray(vals2)],
            ["first", "last", "median", "var", "sum", "count_distinct"],
        )
        cnt = int(cnt)
        uks = self._groups(keys)
        assert cnt == len(uks)
        for i, u in enumerate(uks):
            grp = vals[keys == u]
            assert np.asarray(outs[0])[i] == grp[0]
            assert np.asarray(outs[1])[i] == grp[-1]
            assert np.asarray(outs[2])[i] == np.sort(grp)[(len(grp) - 1) // 2]
            np.testing.assert_allclose(
                np.asarray(outs[3])[i], grp.astype(np.float64).var(),
                rtol=1e-5, atol=1e-5,
            )
            assert np.asarray(outs[4])[i] == grp.sum()
            assert np.asarray(outs[5])[i] == len(
                np.unique(vals2[keys == u])
            )

    def test_composite_keys_holistic(self, rng):
        n = 600
        k1 = rng.integers(0, 5, n).astype(np.uint32)
        k2 = rng.integers(0, 4, n).astype(np.int32)
        vals = rng.integers(-50, 50, n).astype(np.int32)
        uk, av, cnt = query.hash_aggregate(
            [jnp.asarray(k1), jnp.asarray(k2)], jnp.asarray(vals), "first"
        )
        cnt = int(cnt)
        seen = sorted(set(zip(k1.tolist(), k2.tolist())))
        assert cnt == len(seen)
        for i, (a, b) in enumerate(seen):
            grp = vals[(k1 == a) & (k2 == b)]
            assert np.asarray(av)[i] == grp[0]

    def test_empty_input_dtypes(self):
        e = jnp.zeros((0,), jnp.int32)
        for agg, dt in [("median", jnp.int32), ("count_distinct", jnp.int32),
                        ("var", jnp.float32), ("first", jnp.int32),
                        ("any", jnp.bool_), ("all", jnp.bool_),
                        ("mode", jnp.int32), ("argmin", jnp.int32),
                        ("argmax", jnp.int32)]:
            _, av, cnt = query.hash_aggregate(e, e, agg)
            assert int(cnt) == 0 and av.dtype == dt

    def test_mode_ties_pick_smallest(self):
        keys = jnp.asarray(np.array([0, 0, 0, 0, 1, 1], np.uint32))
        vals = jnp.asarray(np.array([7, -2, 7, -2, 5, 3], np.int32))
        _, av, cnt = query.hash_aggregate(keys, vals, "mode")
        # group 0: -2 and 7 tie at 2 -> smallest (-2); group 1: 3/5 tie -> 3
        np.testing.assert_array_equal(np.asarray(av)[:2], [-2, 3])

    def test_argminmax_first_occurrence(self):
        keys = jnp.asarray(np.array([0, 0, 0, 0], np.uint32))
        vals = jnp.asarray(np.array([5, 1, 1, 5], np.int32))
        _, amin, _ = query.hash_aggregate(keys, vals, "argmin")
        _, amax, _ = query.hash_aggregate(keys, vals, "argmax")
        assert int(np.asarray(amin)[0]) == 1  # first of the two 1s
        assert int(np.asarray(amax)[0]) == 0  # first of the two 5s

    def test_any_all_bool_and_float(self, rng):
        keys = rng.integers(0, 9, 500).astype(np.uint32)
        b = rng.random(500) < 0.4
        f = rng.standard_normal(500).astype(np.float32) * (
            rng.random(500) < 0.8)
        for vals in (b, f):
            for agg in ("any", "all"):
                _, av, cnt = query.hash_aggregate(
                    jnp.asarray(keys), jnp.asarray(vals), agg
                )
                assert av.dtype == jnp.bool_
                for i, u in enumerate(np.unique(keys)):
                    g = vals[keys == u] != 0
                    want = g.any() if agg == "any" else g.all()
                    assert bool(np.asarray(av)[i]) == want, (agg, u)


class TestHashJoin:
    def _oracle(self, lk, lv, rk, rv):
        out = []
        order = np.argsort(rk, kind="stable")
        rks, rvs = rk[order], rv[order]
        for i in range(len(lk)):
            for j in range(len(rks)):
                if rks[j] == lk[i]:
                    out.append((lk[i], lv[i], rvs[j]))
        return out

    def test_inner_join(self, rng):
        nl, nr = 500, 300
        lk = rng.integers(0, 80, nl).astype(np.uint32)
        lv = rng.integers(0, 2**31, nl).astype(np.uint32)
        rk = rng.integers(0, 80, nr).astype(np.uint32)
        rv = rng.integers(0, 2**31, nr).astype(np.uint32)
        ref = self._oracle(lk, lv, rk, rv)
        cap = len(ref) + 64
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), jnp.asarray(rv),
            capacity=cap,
        )
        cnt = int(cnt)
        assert not bool(ovf)
        assert cnt == len(ref)
        got = list(zip(np.asarray(jk)[:cnt], np.asarray(jlv)[:cnt], np.asarray(jrv)[:cnt]))
        assert got == ref

    @pytest.mark.parametrize("how", ["inner", "left", "right", "full",
                                     "semi", "anti"])
    def test_multi_column_payloads(self, rng, how):
        """Value-column LISTS ride the one join; each output column must
        equal the single-payload join of that column alone."""
        nl, nr = 400, 300
        lk = jnp.asarray(rng.integers(0, 60, nl).astype(np.uint32))
        rk = jnp.asarray(rng.integers(0, 60, nr).astype(np.uint32))
        lvs = [jnp.asarray(rng.integers(0, 2**31, nl).astype(np.uint32)),
               jnp.asarray(rng.integers(-50, 50, nl).astype(np.int32))]
        rvs = [jnp.asarray(rng.integers(0, 9999, nr).astype(np.int32)),
               jnp.asarray(rng.standard_normal(nr).astype(np.float32))]
        cap = 8192
        jk, jl, jr, cnt, ovf = query.hash_join(
            lk, lvs, rk, rvs, capacity=cap, how=how
        )
        assert not bool(ovf)
        assert isinstance(jl, list) and isinstance(jr, list)
        cnt = int(cnt)
        for ci in range(2):
            k1, l1, r1, c1, o1 = query.hash_join(
                lk, lvs[ci], rk, rvs[ci], capacity=cap, how=how
            )
            assert int(c1) == cnt
            np.testing.assert_array_equal(np.asarray(jk)[:cnt],
                                          np.asarray(k1)[:cnt])
            np.testing.assert_array_equal(np.asarray(jl[ci])[:cnt],
                                          np.asarray(l1)[:cnt])
            np.testing.assert_array_equal(np.asarray(jr[ci])[:cnt],
                                          np.asarray(r1)[:cnt])

    def test_overflow_flag(self, rng):
        lk = np.zeros(100, np.uint32)
        rk = np.zeros(100, np.uint32)
        v = np.arange(100, dtype=np.uint32)
        _, _, _, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(v), jnp.asarray(rk), jnp.asarray(v),
            capacity=128,
        )
        assert bool(ovf)
        assert int(cnt) == 128

    def test_no_matches(self, rng):
        lk = np.arange(0, 50, dtype=np.uint32)
        rk = np.arange(100, 150, dtype=np.uint32)
        v = np.zeros(50, np.uint32)
        _, _, _, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(v), jnp.asarray(rk), jnp.asarray(v),
            capacity=16,
        )
        assert int(cnt) == 0 and not bool(ovf)


class TestJoinHows:
    def _sides(self, rng, nl=400, nr=250, kmax=60):
        lk = rng.integers(0, kmax, nl).astype(np.uint32)
        lv = rng.integers(0, 2**31, nl).astype(np.uint32)
        rk = rng.integers(0, kmax, nr).astype(np.uint32)
        rv = rng.integers(0, 2**31, nr).astype(np.uint32)
        return lk, lv, rk, rv

    def test_left_join(self, rng):
        lk, lv, rk, rv = self._sides(rng)
        order = np.argsort(rk, kind="stable")
        rks, rvs = rk[order], rv[order]
        ref = []
        for i in range(len(lk)):
            ms = [rvs[j] for j in range(len(rks)) if rks[j] == lk[i]]
            if ms:
                ref += [(lk[i], lv[i], m) for m in ms]
            else:
                ref.append((lk[i], lv[i], 0))
        cap = len(ref) + 32
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), jnp.asarray(rv),
            capacity=cap, how="left",
        )
        cnt = int(cnt)
        assert not bool(ovf) and cnt == len(ref)
        got = list(
            zip(np.asarray(jk)[:cnt], np.asarray(jlv)[:cnt], np.asarray(jrv)[:cnt])
        )
        assert got == ref

    def _left_oracle(self, lk, lv, rk, rv):
        """(key, lval, rval) rows of a left join: by left row, matches in
        right sorted order, unmatched left rows once with rval 0."""
        order = np.argsort(rk, kind="stable")
        rks, rvs = rk[order], rv[order]
        ref = []
        for i in range(len(lk)):
            ms = [rvs[j] for j in range(len(rks)) if rks[j] == lk[i]]
            if ms:
                ref += [(lk[i], lv[i], m) for m in ms]
            else:
                ref.append((lk[i], lv[i], 0))
        return ref

    def test_right_join(self, rng):
        lk, lv, rk, rv = self._sides(rng)
        # mirror of the left join with sides swapped (and value slots back
        # in (left, right) order)
        ref = [(k, l, r) for (k, r, l) in self._left_oracle(rk, rv, lk, lv)]
        cap = len(ref) + 32
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), jnp.asarray(rv),
            capacity=cap, how="right",
        )
        cnt = int(cnt)
        assert not bool(ovf) and cnt == len(ref)
        got = list(
            zip(np.asarray(jk)[:cnt], np.asarray(jlv)[:cnt], np.asarray(jrv)[:cnt])
        )
        assert got == ref

    def test_full_join(self, rng):
        lk, lv, rk, rv = self._sides(rng)
        ref = self._left_oracle(lk, lv, rk, rv)
        # then every unmatched right row, in right sorted order, lval 0
        order = np.argsort(rk, kind="stable")
        for j in order:
            if rk[j] not in lk:
                ref.append((rk[j], 0, rv[j]))
        cap = len(ref) + 32
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), jnp.asarray(rv),
            capacity=cap, how="full",
        )
        cnt = int(cnt)
        assert not bool(ovf) and cnt == len(ref)
        got = list(
            zip(np.asarray(jk)[:cnt], np.asarray(jlv)[:cnt], np.asarray(jrv)[:cnt])
        )
        assert got == ref

    def test_full_join_overflow_prefix_exact(self, rng):
        lk, lv, rk, rv = self._sides(rng, nl=60, nr=80, kmax=20)
        ref = self._left_oracle(lk, lv, rk, rv)
        order = np.argsort(rk, kind="stable")
        for j in order:
            if rk[j] not in lk:
                ref.append((rk[j], 0, rv[j]))
        cap = len(ref) - 5  # force overflow; first cap rows must stay exact
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), jnp.asarray(rv),
            capacity=cap, how="full",
        )
        assert bool(ovf) and int(cnt) == cap
        got = list(zip(np.asarray(jk), np.asarray(jlv), np.asarray(jrv)))
        assert got == ref[:cap]

    def test_full_join_empty_sides(self):
        rk = np.array([7, 2, 7], np.uint32)
        rv = np.array([70, 20, 71], np.uint32)
        e = jnp.zeros(0, jnp.uint32)
        # empty left: all right rows unmatched, right sorted order
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            e, e, jnp.asarray(rk), jnp.asarray(rv), capacity=8, how="full",
        )
        cnt = int(cnt)
        assert cnt == 3 and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(jk)[:cnt], [2, 7, 7])
        np.testing.assert_array_equal(np.asarray(jrv)[:cnt], [20, 70, 71])
        assert not np.asarray(jlv).any()
        # empty right: degenerates to the left join
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(rk), jnp.asarray(rv), e, e, capacity=8, how="full",
        )
        cnt = int(cnt)
        assert cnt == 3 and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(jk)[:cnt], rk)
        np.testing.assert_array_equal(np.asarray(jlv)[:cnt], rv)
        assert not np.asarray(jrv).any()

    def test_full_join_composite_keys(self, rng):
        nl, nr = 120, 90
        lk1 = rng.integers(0, 6, nl).astype(np.uint32)
        lk2 = rng.integers(-4, 4, nl).astype(np.int32)
        rk1 = rng.integers(0, 6, nr).astype(np.uint32)
        rk2 = rng.integers(-4, 4, nr).astype(np.int32)
        lv = rng.integers(0, 2**31, nl).astype(np.uint32)
        rv = rng.integers(0, 2**31, nr).astype(np.uint32)
        lt = list(zip(lk1.tolist(), lk2.tolist()))
        rt = list(zip(rk1.tolist(), rk2.tolist()))
        order = sorted(range(nr), key=lambda j: (rt[j][0], rt[j][1], j))
        ref = []
        for i in range(nl):
            ms = [rv[j] for j in order if rt[j] == lt[i]]
            if ms:
                ref += [(lt[i], lv[i], m) for m in ms]
            else:
                ref.append((lt[i], lv[i], 0))
        for j in order:
            if rt[j] not in lt:
                ref.append((rt[j], 0, rv[j]))
        cap = len(ref) + 16
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            [jnp.asarray(lk1), jnp.asarray(lk2)], jnp.asarray(lv),
            [jnp.asarray(rk1), jnp.asarray(rk2)], jnp.asarray(rv),
            capacity=cap, how="full",
        )
        cnt = int(cnt)
        assert not bool(ovf) and cnt == len(ref)
        k1, k2 = np.asarray(jk[0]), np.asarray(jk[1])
        got = [((int(k1[t]), int(k2[t])), np.asarray(jlv)[t], np.asarray(jrv)[t])
               for t in range(cnt)]
        assert got == ref

    @pytest.mark.parametrize("how", ["semi", "anti"])
    def test_semi_anti(self, rng, how):
        lk, lv, rk, rv = self._sides(rng)
        in_right = np.isin(lk, rk)
        sel = in_right if how == "semi" else ~in_right
        cap = len(lk)
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk), jnp.asarray(rv),
            capacity=cap, how=how,
        )
        cnt = int(cnt)
        assert not bool(ovf) and cnt == sel.sum()
        np.testing.assert_array_equal(np.asarray(jk)[:cnt], lk[sel])
        np.testing.assert_array_equal(np.asarray(jlv)[:cnt], lv[sel])
        assert not np.asarray(jrv).any()

    @pytest.mark.parametrize("how", ["left", "semi", "anti"])
    def test_empty_right_side(self, how, rng):
        lk = np.array([3, 1, 4], np.uint32)
        lv = np.array([30, 10, 40], np.uint32)
        e = jnp.zeros(0, jnp.uint32)
        jk, jlv, jrv, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), e, e, capacity=8, how=how,
        )
        cnt = int(cnt)
        if how == "semi":
            assert cnt == 0
        else:  # left and anti both emit every left row once
            assert cnt == 3
            np.testing.assert_array_equal(np.asarray(jk)[:cnt], lk)
            np.testing.assert_array_equal(np.asarray(jlv)[:cnt], lv)
        assert not bool(ovf)

    def test_semi_capacity_overflow(self, rng):
        lk = np.zeros(10, np.uint32)
        rk = np.zeros(4, np.uint32)
        v = np.arange(10, dtype=np.uint32)
        _, _, _, cnt, ovf = query.hash_join(
            jnp.asarray(lk), jnp.asarray(v), jnp.asarray(rk),
            jnp.asarray(np.arange(4, dtype=np.uint32)), capacity=6, how="semi",
        )
        assert bool(ovf) and int(cnt) == 6

    def test_bad_how_raises(self):
        z = jnp.zeros(4, jnp.uint32)
        with pytest.raises(ValueError, match="how must be one of"):
            query.hash_join(z, z, z, z, capacity=4, how="outer")


class TestRepeat:
    def test_matches_numpy(self, rng):
        n = 300
        vals = rng.integers(0, 2**31, n).astype(np.uint32)
        counts = rng.integers(0, 6, n).astype(np.int32)
        ref = np.repeat(vals, counts)
        out, cnt, ovf = query.repeat(
            jnp.asarray(vals), jnp.asarray(counts), total_size=len(ref) + 16
        )
        assert int(cnt) == len(ref) and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(out)[: len(ref)], ref)
        assert not np.asarray(out)[len(ref):].any()

    def test_kernel_path_high_fanout(self, rng):
        # high mean fanout (total_size >= 64 * n) through the gather path
        n = 32
        vals = rng.integers(0, 2**31, n).astype(np.uint32)
        counts = rng.integers(50, 90, n).astype(np.int32)
        ref = np.repeat(vals, counts)
        total = 64 * n + 1024
        out, cnt, ovf = query.repeat(
            jnp.asarray(vals), jnp.asarray(counts), total_size=total
        )
        assert int(cnt) == len(ref) and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(out)[: len(ref)], ref)

    def test_truncation_and_overflow(self, rng):
        vals = np.array([1, 2, 3], np.uint32)
        counts = np.array([4, 4, 4], np.int32)
        out, cnt, ovf = query.repeat(
            jnp.asarray(vals), jnp.asarray(counts), total_size=6
        )
        assert bool(ovf) and int(cnt) == 6
        np.testing.assert_array_equal(np.asarray(out), [1, 1, 1, 1, 2, 2])

    def test_float_and_zero_counts(self, rng):
        vals = np.array([1.5, -2.5, 3.25], np.float32)
        counts = np.array([0, 2, 0], np.int32)
        out, cnt, ovf = query.repeat(
            jnp.asarray(vals), jnp.asarray(counts), total_size=8
        )
        assert int(cnt) == 2 and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(out)[:2], [-2.5, -2.5])

    def test_empty_and_mismatch(self):
        out, cnt, ovf = query.repeat(
            jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.int32), total_size=4
        )
        assert int(cnt) == 0 and not bool(ovf) and out.shape == (4,)
        with pytest.raises(ValueError, match="same length"):
            query.repeat(
                jnp.zeros(3, jnp.uint32), jnp.zeros(2, jnp.int32), total_size=4
            )


class TestHighFanoutKernelPath:
    """High-fanout joins (capacity >= 64 * n_left) through the gather
    expansion path must match the oracle exactly."""

    def _join(self, lk, lv, rk, rv, capacity, how="inner"):
        return query.hash_join(
            jnp.asarray(lk), jnp.asarray(lv), jnp.asarray(rk),
            jnp.asarray(rv), capacity=capacity, how=how,
        )

    def test_inner_matches_oracle(self, rng):
        n_l, fan = 48, 80
        lk = rng.permutation(n_l).astype(np.uint32)
        lv = rng.integers(0, 2**31, n_l).astype(np.uint32)
        rk = np.repeat(np.arange(n_l, dtype=np.uint32), fan)
        rv = rng.integers(0, 2**31, n_l * fan).astype(np.uint32)
        cap = n_l * fan + 64  # high fanout (>= 64*n_l), > total
        jk, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, cap)
        cnt = int(cnt)
        assert not bool(ovf) and cnt == n_l * fan
        order = np.argsort(rk, kind="stable")
        rks, rvs = rk[order], rv[order]
        ref = []
        for i in range(n_l):
            sel = rks == lk[i]
            ref += list(zip([lk[i]] * fan, [lv[i]] * fan, rvs[sel]))
        got = list(
            zip(np.asarray(jk)[:cnt], np.asarray(jlv)[:cnt], np.asarray(jrv)[:cnt])
        )
        assert got == ref
        # tail is zeroed (not sentinel) beyond count
        assert not np.asarray(jk)[cnt:].any()

    def test_left_join_unmatched_fill(self, rng):
        lk = np.array([7, 3, 99], np.uint32)  # 99 unmatched
        lv = np.array([70, 30, 990], np.uint32)
        rk = np.repeat(np.array([3, 7], np.uint32), 100)
        rv = rng.integers(1, 2**31, 200).astype(np.uint32)
        cap = 256  # >= 64*3: high fanout; > total 201
        jk, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, cap, how="left")
        cnt = int(cnt)
        assert not bool(ovf) and cnt == 201
        assert np.asarray(jk)[200] == 99 and np.asarray(jrv)[200] == 0
        # left row 0 has key 7; its matches are the sorted-right tail rv[100:]
        np.testing.assert_array_equal(np.asarray(jrv)[:100], rv[100:])

    def test_capacity_truncation_exact(self, rng):
        # overflow: first `capacity` rows must still be exact
        n_l, fan = 4, 200
        lk = np.arange(n_l, dtype=np.uint32)
        lv = lk * 10
        rk = np.repeat(lk, fan)
        rv = np.arange(n_l * fan, dtype=np.uint32)
        cap = 64 * n_l  # 256 < total 800
        jk, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, cap)
        assert bool(ovf) and int(cnt) == cap
        # rows are ordered by left row then right sorted position
        ref_rv = rv[np.argsort(rk, kind="stable")][:cap]
        np.testing.assert_array_equal(np.asarray(jrv), ref_rv[:cap])

    def test_float_values_bitcast(self, rng):
        n_l = 8
        lk = np.arange(n_l, dtype=np.uint32)
        lv = rng.random(n_l).astype(np.float32)
        rk = np.repeat(lk, 70)
        rv = rng.random(n_l * 70).astype(np.float32)
        cap = n_l * 70 + 16
        jk, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, cap)
        cnt = int(cnt)
        assert jlv.dtype == jnp.float32 and jrv.dtype == jnp.float32
        assert cnt == n_l * 70
        np.testing.assert_array_equal(np.asarray(jrv)[:70], rv[rk == 0])

    def test_u64_values_two_calls(self, rng):
        # 8-byte integer values at high fanout
        n_l, fan = 8, 70
        lk = np.arange(n_l, dtype=np.uint32)
        lv = rng.integers(0, 2**63, n_l).astype(np.uint64)
        rk = np.repeat(lk, fan)
        rv = rng.integers(0, 2**63, n_l * fan).astype(np.uint64)
        cap = n_l * fan + 16
        jk, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, cap)
        cnt = int(cnt)
        assert jlv.dtype == jnp.uint64 and jrv.dtype == jnp.uint64
        assert cnt == n_l * fan and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(jrv)[:fan], rv[rk == 0])
        np.testing.assert_array_equal(
            np.asarray(jlv)[:cnt], np.repeat(lv, fan)
        )

    def test_i64_negative_values_roundtrip(self, rng):
        n_l, fan = 4, 80
        lk = np.arange(n_l, dtype=np.uint32)
        lv = (rng.integers(-(2**62), 2**62, n_l)).astype(np.int64)
        rk = np.repeat(lk, fan)
        rv = (rng.integers(-(2**62), 2**62, n_l * fan)).astype(np.int64)
        cap = n_l * fan + 16
        _, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, cap)
        cnt = int(cnt)
        assert cnt == n_l * fan and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(jrv)[:fan], rv[rk == 0])
        np.testing.assert_array_equal(
            np.asarray(jlv)[:cnt], np.repeat(lv, fan)
        )

    def test_value_lists_multi_call(self, rng):
        # column-list payloads on both sides at high fanout
        n_l, fan = 8, 70
        lk = np.arange(n_l, dtype=np.uint32)
        lv1 = rng.integers(0, 2**31, n_l).astype(np.uint32)
        lv2 = rng.random(n_l).astype(np.float32)
        rk = np.repeat(lk, fan)
        rv1 = rng.integers(0, 2**31, n_l * fan).astype(np.uint32)
        rv2 = rng.random(n_l * fan).astype(np.float32)
        cap = n_l * fan + 16
        jk, jlvs, jrvs, cnt, ovf = query.hash_join(
            jnp.asarray(lk), [jnp.asarray(lv1), jnp.asarray(lv2)],
            jnp.asarray(rk), [jnp.asarray(rv1), jnp.asarray(rv2)],
            capacity=cap,
        )
        cnt = int(cnt)
        assert cnt == n_l * fan and not bool(ovf)
        np.testing.assert_array_equal(np.asarray(jrvs[0])[:fan], rv1[rk == 0])
        np.testing.assert_array_equal(np.asarray(jrvs[1])[:fan], rv2[rk == 0])
        np.testing.assert_array_equal(
            np.asarray(jlvs[0])[:cnt], np.repeat(lv1, fan)
        )
        np.testing.assert_array_equal(
            np.asarray(jlvs[1])[:cnt], np.repeat(lv2, fan)
        )

    def test_left_join_u64_unmatched_fill(self, rng):
        lk = np.array([7, 3, 99], np.uint32)  # 99 unmatched
        lv = np.array([70, 30, 990], np.uint64)
        rk = np.repeat(np.array([3, 7], np.uint32), 100)
        rv = rng.integers(1, 2**63, 200).astype(np.uint64)
        jk, jlv, jrv, cnt, ovf = self._join(lk, lv, rk, rv, 256, how="left")
        cnt = int(cnt)
        assert not bool(ovf) and cnt == 201
        assert np.asarray(jk)[200] == 99 and np.asarray(jrv)[200] == 0
        assert np.asarray(jlv)[200] == 990
        np.testing.assert_array_equal(np.asarray(jrv)[:100], rv[100:])


class TestEdgeCases:
    def test_aggregate_empty(self):
        uk, av, cnt = query.hash_aggregate(
            jnp.zeros(0, jnp.uint32), jnp.zeros(0, jnp.uint32), "sum"
        )
        assert int(cnt) == 0 and uk.shape[0] == 0

    def test_join_empty_sides(self, rng):
        lk = jnp.asarray(np.arange(4, dtype=np.uint32))
        v = jnp.zeros(4, jnp.uint32)
        e = jnp.zeros(0, jnp.uint32)
        for a, av_, b, bv in [(lk, v, e, e), (e, e, lk, v), (e, e, e, e)]:
            _, _, _, cnt, ovf = query.hash_join(a, av_, b, bv, capacity=8)
            assert int(cnt) == 0 and not bool(ovf)


class TestMergeRank:
    """query.merge_rank must equal np.searchsorted exactly (it replaces the
    ~230ns/query device binary search with two variadic sorts)."""

    @pytest.mark.parametrize("side", ["left", "right"])
    def test_matches_numpy(self, rng, side):
        from radix_sort_tpu.ops.query import merge_rank

        data = np.sort(rng.integers(0, 50, 500, dtype=np.uint32))
        q = rng.integers(0, 55, 300, dtype=np.uint32)  # heavy ties + misses
        got = np.asarray(merge_rank(jnp.asarray(data), jnp.asarray(q), side))
        np.testing.assert_array_equal(got, np.searchsorted(data, q, side=side))

    @pytest.mark.parametrize("side", ["left", "right"])
    def test_all_equal_and_bounds(self, side):
        from radix_sort_tpu.ops.query import merge_rank

        data = np.full(64, 7, np.uint32)
        q = np.array([6, 7, 8, 0, 0xFFFFFFFF], np.uint32)
        got = np.asarray(
            merge_rank(jnp.asarray(np.sort(data)), jnp.asarray(q), side)
        )
        np.testing.assert_array_equal(got, np.searchsorted(data, q, side=side))

    def test_empty_queries(self):
        from radix_sort_tpu.ops.query import merge_rank

        data = jnp.asarray(np.arange(16, dtype=np.uint32))
        got = merge_rank(data, jnp.zeros((0,), jnp.uint32), "left")
        assert got.shape == (0,)

    def test_pair_matches_numpy(self, rng):
        from radix_sort_tpu.ops.query import merge_rank_pair

        data = np.sort(rng.integers(0, 50, 500, dtype=np.uint32))
        q = rng.integers(0, 55, 300, dtype=np.uint32)  # heavy ties + misses
        lo, hi = merge_rank_pair(jnp.asarray(data), jnp.asarray(q))
        np.testing.assert_array_equal(
            np.asarray(lo), np.searchsorted(data, q, side="left")
        )
        np.testing.assert_array_equal(
            np.asarray(hi), np.searchsorted(data, q, side="right")
        )

    def test_pair_all_equal_and_bounds(self):
        from radix_sort_tpu.ops.query import merge_rank_pair

        data = np.full(64, 7, np.uint32)
        q = np.array([6, 7, 8, 0, 0xFFFFFFFF], np.uint32)
        lo, hi = merge_rank_pair(jnp.asarray(data), jnp.asarray(q))
        np.testing.assert_array_equal(
            np.asarray(lo), np.searchsorted(data, q, side="left")
        )
        np.testing.assert_array_equal(
            np.asarray(hi), np.searchsorted(data, q, side="right")
        )


    @pytest.mark.parametrize("side", ["left", "right"])
    def test_few_queries_searchsorted_path(self, rng, side):
        # n_q * 20 <= n_d takes the device binary-search branch
        from radix_sort_tpu.ops.query import merge_rank, merge_rank_pair

        data = np.sort(rng.integers(0, 40, 2000, dtype=np.uint32))
        q = rng.integers(0, 45, 50, dtype=np.uint32)
        got = np.asarray(merge_rank(jnp.asarray(data), jnp.asarray(q), side))
        np.testing.assert_array_equal(got, np.searchsorted(data, q, side=side))
        lo, hi = merge_rank_pair(jnp.asarray(data), jnp.asarray(q))
        np.testing.assert_array_equal(
            np.asarray(lo), np.searchsorted(data, q, side="left")
        )
        np.testing.assert_array_equal(
            np.asarray(hi), np.searchsorted(data, q, side="right")
        )


class TestExpandOffsets:
    """query.expand_offsets must equal searchsorted(starts, t, 'right')-1
    (the addressing step of the join expansion)."""

    def test_matches_numpy(self, rng):
        from radix_sort_tpu.ops.query import expand_offsets

        matches = rng.integers(0, 5, 200)
        starts = (np.cumsum(matches) - matches).astype(np.int32)
        cap = int(matches.sum()) + 7
        got = np.asarray(expand_offsets(jnp.asarray(starts), cap))
        want = np.searchsorted(starts, np.arange(cap), side="right") - 1
        np.testing.assert_array_equal(got, want)

    def test_out_of_range_offsets_dropped(self):
        from radix_sort_tpu.ops.query import expand_offsets

        starts = jnp.asarray([0, 2, 2**31 - 1, 2**31 - 1], jnp.int32)
        got = np.asarray(expand_offsets(starts, 4))
        np.testing.assert_array_equal(got, [0, 0, 1, 1])


class TestHashAggregateLevels:
    """hash_aggregate_levels: one shared sort must reproduce
    hash_aggregate exactly at every prefix level."""

    def test_matches_per_level_hash_aggregate(self, rng):
        n = 500
        k1 = rng.integers(0, 7, n).astype(np.uint32)
        k2 = rng.integers(0, 5, n).astype(np.int32)
        vi = rng.integers(-9, 9, n).astype(np.int32)
        vf = rng.random(n).astype(np.float32)
        keys = [jnp.asarray(k1), jnp.asarray(k2)]
        aggs = ["sum", "count", "mean", "min", "max", "any", "all",
                "var", "std"]
        vals = [jnp.asarray(vi), jnp.asarray(vi), jnp.asarray(vf),
                jnp.asarray(vi), jnp.asarray(vi), jnp.asarray(vi),
                jnp.asarray(vi), jnp.asarray(vf), jnp.asarray(vf)]
        levels = query.hash_aggregate_levels(keys, vals, aggs, [2, 1, 0])
        for c, (uk, outs, cnt) in zip([2, 1, 0], levels):
            if c:
                uk1, outs1, cnt1 = query.hash_aggregate(
                    keys[:c], vals, list(aggs)
                )
            else:
                uk1, outs1, cnt1 = query.hash_aggregate(
                    [jnp.zeros((n,), jnp.uint32)], vals, list(aggs)
                )
            m = int(cnt)
            assert m == int(cnt1)
            for a, b in zip(uk, uk1):
                np.testing.assert_array_equal(
                    np.asarray(a)[:m], np.asarray(b)[:m]
                )
            for name, a, b in zip(aggs, outs, outs1):
                ga, gb = np.asarray(a)[:m], np.asarray(b)[:m]
                if ga.dtype.kind == "f":
                    np.testing.assert_allclose(
                        ga, gb, rtol=1e-5, atol=1e-6, err_msg=name
                    )
                else:
                    np.testing.assert_array_equal(ga, gb, err_msg=name)

    def test_u64_limb_keys_and_empty(self, rng):
        n = 64
        k1 = rng.integers(0, 2**63, n).astype(np.uint64)
        v = rng.integers(0, 100, n).astype(np.int64)
        levels = query.hash_aggregate_levels(
            [jnp.asarray(k1)], [jnp.asarray(v)], ["sum"], [1, 0]
        )
        (uk, (s,), cnt), (_, (tot,), cnt0) = levels
        m = int(cnt)
        want_keys = np.sort(np.unique(k1))
        np.testing.assert_array_equal(np.asarray(uk[0])[:m], want_keys)
        want = np.array([v[k1 == kk].sum() for kk in want_keys])
        np.testing.assert_array_equal(np.asarray(s)[:m], want)
        assert int(cnt0) == 1 and int(np.asarray(tot)[0]) == int(v.sum())
        # n == 0
        empty = query.hash_aggregate_levels(
            [jnp.zeros((0,), jnp.uint32)], [jnp.zeros((0,), jnp.int32)],
            ["sum"], [1, 0]
        )
        for uk_e, outs_e, cnt_e in empty:
            assert int(cnt_e) == 0

    def test_rejects_order_dependent_aggs(self):
        with pytest.raises(ValueError, match="supports"):
            query.hash_aggregate_levels(
                [jnp.arange(4, dtype=jnp.uint32)],
                [jnp.arange(4, dtype=jnp.int32)], ["first"], [1]
            )
