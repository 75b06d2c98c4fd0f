"""Distributed sort tests on the 8-virtual-device CPU mesh (the fake-backend
pattern SURVEY.md section 4 prescribes for collectives without a GPU).

The composite-splitter partition (dist_sort.py) must sort EVERY distribution
— including the reference's duplicate-heavy StepUniform regime
(src/distr.rs:78-106) and the all-equal worst case — without overflowing the
provisioned exchange capacity.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from radix_sort_tpu.parallel import dist_sort


def _mesh():
    return Mesh(np.array(jax.devices()), ("x",))


def _collect(sorted_padded, counts, num_devices):
    """Concatenate the valid prefix of each device's range (ragged output)."""
    per_dev = np.split(np.asarray(sorted_padded), num_devices)
    cnt = np.asarray(counts)
    return np.concatenate([d[: cnt[i]] for i, d in enumerate(per_dev)])


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64, np.int32, np.float32])
def test_distributed_sort_matches_oracle(rng, dtype):
    mesh = _mesh()
    n = 8 * 4096
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal(n).astype(dtype)
    else:
        info = np.iinfo(dtype)
        x = rng.integers(info.min, info.max, size=n, endpoint=True, dtype=dtype)
    out, counts, overflow = jax.jit(
        lambda k: dist_sort.distributed_sort(k, mesh)
    )(jnp.asarray(x))
    assert not bool(overflow)
    got = _collect(out, counts, 8)
    assert got.shape == x.shape
    assert np.array_equal(got, np.sort(x, kind="stable"))


def _skew_cases(rng, n):
    yield "all_equal", np.full(n, 123456789, np.uint32)
    yield "two_values", np.where(rng.random(n) < 0.95, 7, 9).astype(np.uint32)
    # StepUniform: few distinct equally spaced values (distr.rs:78-106)
    step = (np.uint64(1) << np.uint64(32)) // np.uint64(5)
    yield "step_uniform", (
        rng.integers(0, 5, n).astype(np.uint64) * step
    ).astype(np.uint32)
    # Zipf-ish: heavy head, long tail
    z = rng.zipf(1.3, size=n)
    yield "zipf", np.minimum(z, 1 << 31).astype(np.uint32)
    yield "sorted_ascending", np.sort(rng.integers(0, 1 << 32, n, dtype=np.uint32))
    yield "sorted_descending", np.sort(
        rng.integers(0, 1 << 32, n, dtype=np.uint32)
    )[::-1].copy()


def test_distributed_sort_skewed_distributions(rng):
    """Skewed/duplicate-heavy keys must SORT, not overflow (round-1's
    codified failure, now the capability test)."""
    mesh = _mesh()
    n = 8 * 2048
    f = jax.jit(lambda k: dist_sort.distributed_sort(k, mesh))
    for name, x in _skew_cases(rng, n):
        out, counts, overflow = f(jnp.asarray(x))
        assert not bool(overflow), name
        got = _collect(out, counts, 8)
        assert np.array_equal(got, np.sort(x, kind="stable")), name


def test_distributed_sort_pairs_stable_under_skew(rng):
    """Stability across device boundaries for every skew case: payload order
    of equal keys must match the stable oracle exactly."""
    mesh = _mesh()
    n = 8 * 2048
    f = jax.jit(lambda a, b: dist_sort.distributed_sort_pairs(a, b, mesh))
    for name, keys in _skew_cases(rng, n):
        vals = np.arange(n, dtype=np.uint32)
        k, v, counts, overflow = f(jnp.asarray(keys), jnp.asarray(vals))
        assert not bool(overflow), name
        got_k = _collect(k, counts, 8)
        got_v = _collect(v, counts, 8)
        order = np.argsort(keys, kind="stable")
        assert np.array_equal(got_k, keys[order]), name
        assert np.array_equal(got_v, vals[order]), name


def test_distributed_sort_pairs_stable(rng):
    mesh = _mesh()
    n = 8 * 2048
    keys = rng.integers(0, 1 << 32, size=n, dtype=np.uint32)
    keys = (keys >> 24).astype(np.uint32) << 24  # heavy duplicates
    vals = np.arange(n, dtype=np.uint32)
    k, v, counts, overflow = jax.jit(
        lambda a, b: dist_sort.distributed_sort_pairs(a, b, mesh)
    )(jnp.asarray(keys), jnp.asarray(vals))
    assert not bool(overflow)
    got_k = _collect(k, counts, 8)
    got_v = _collect(v, counts, 8)
    order = np.argsort(keys, kind="stable")
    assert np.array_equal(got_k, keys[order])
    assert np.array_equal(got_v, vals[order])


def test_capacity_bound_is_provisioned(rng):
    """The default capacity meets the deterministic regular-sampling bound:
    a distribution engineered to concentrate one bucket still fits."""
    n_local = 4096
    cap = dist_sort.exchange_capacity(n_local, 8)
    assert cap >= n_local  # worst single bucket can never exceed the bound
    # bound is tight-ish: not more than ~40% slack over n_local at this size
    assert cap <= int(n_local * 1.45)


def test_forced_overflow_falls_back_exactly(rng):
    """With a test-only capacity too small for the exchange, the result must
    STILL be the exact stable sort (global-sort fallback), with the overflow
    flag reporting the degraded path."""
    mesh = _mesh()
    n = 8 * 1024
    n_local = n // 8
    x = np.full(n, 42, np.uint32)  # all-equal: balanced by position tiebreak
    # capacity == n_local is >= n_local (validated) but below the sampling
    # slack the partition needs at this size, so some device overflows
    out, counts, overflow = jax.jit(
        lambda k: dist_sort.distributed_sort(k, mesh, capacity=n_local)
    )(jnp.asarray(x))
    got = _collect(out, counts, 8)
    assert bool(overflow)  # zero-slack capacity cannot fit the last bucket
    assert np.array_equal(got, np.sort(x, kind="stable"))
    k2, v2, counts2, overflow2 = jax.jit(
        lambda a, b: dist_sort.distributed_sort_pairs(
            a, b, mesh, capacity=n_local
        )
    )(jnp.asarray(x), jnp.arange(n, dtype=jnp.uint32))
    got_k = _collect(k2, counts2, 8)
    got_v = _collect(v2, counts2, 8)
    assert bool(overflow2)
    assert np.array_equal(got_k, np.sort(x, kind="stable"))
    # fallback path: payload order must still be exact (stability)
    assert np.array_equal(got_v, np.arange(n, dtype=np.uint32))


def test_pipelined_exchange_stability_and_skew(rng):
    # the comm/compute-overlap (PP-analogue) path: striped local sorts +
    # per-stripe exchanges + surrogate-merged output must equal the stable
    # oracle exactly, including duplicate-heavy keys whose equal-key order
    # crosses stripe boundaries
    mesh = _mesh()
    n = 8 * 2048
    for name, keys in (
        ("uniform", rng.integers(0, 1 << 32, n, dtype=np.uint32)),
        ("dup_heavy", rng.integers(0, 3, n).astype(np.uint32)),
        ("all_equal", np.full(n, 0xFFFFFFFF, np.uint32)),
    ):
        vals = np.arange(n, dtype=np.uint32)
        out_k, out_v, counts, overflow = jax.jit(
            lambda k, v: dist_sort.distributed_sort_pairs(
                k, v, mesh, exchange="pipelined"
            )
        )(jnp.asarray(keys), jnp.asarray(vals))
        assert not bool(overflow), name
        gk = _collect(out_k, counts, 8)
        gv = _collect(out_v, counts, 8)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(gk, keys[order], err_msg=name)
        np.testing.assert_array_equal(gv, vals[order], err_msg=name)


def test_pipelined_keys_only(rng):
    mesh = _mesh()
    n = 8 * 1024
    x = rng.integers(-1000, 1000, n).astype(np.int32)
    out, counts, overflow = jax.jit(
        lambda k: dist_sort.distributed_sort(k, mesh, exchange="pipelined")
    )(jnp.asarray(x))
    assert not bool(overflow)
    np.testing.assert_array_equal(_collect(out, counts, 8), np.sort(x, kind="stable"))


def test_bad_exchange_string_rejected(rng):
    mesh = _mesh()
    x = jnp.asarray(rng.integers(0, 100, 8 * 128, dtype=np.uint32))
    with pytest.raises(ValueError, match="exchange must be"):
        dist_sort.distributed_sort(x, mesh, exchange="gahter")


def test_multiprocess_init_failure_is_not_swallowed(monkeypatch):
    # an explicitly requested multi-process bring-up that fails must raise,
    # never silently degrade to local-only JAX (collectives would hang)
    from radix_sort_tpu.parallel import runtime

    def boom(**kw):
        raise ValueError("coordinator_address should be defined.")

    monkeypatch.setattr(jax.distributed, "initialize", boom)
    monkeypatch.setattr(jax.distributed, "is_initialized", lambda: False,
                        raising=False)
    with pytest.raises(ValueError):
        runtime.initialize_multihost(num_processes=4, process_id=2)
    # ... while the documented no-arg single-process case stays a no-op
    runtime.initialize_multihost()


class TestDistributedMultiLimb:
    """Composite / multi-limb distributed sort: lexicographic splitters
    partition on the full limb tuple (dist_sort._composite_splitters)."""

    def test_multi_column_lexsort(self, rng):
        mesh = _mesh()
        n = 8 * 2048
        a = rng.integers(0, 4, n).astype(np.int32)       # low cardinality
        b = rng.standard_normal(n).astype(np.float32)
        cols, counts, overflow = dist_sort.distributed_sort([
            jnp.asarray(a), jnp.asarray(b)
        ], mesh)
        assert not bool(overflow)
        ga = _collect(cols[0], counts, 8)
        gb = _collect(cols[1], counts, 8)
        order = np.lexsort((b, a))  # primary a, secondary b
        np.testing.assert_array_equal(ga, a[order])
        np.testing.assert_array_equal(gb, b[order])

    def test_all_equal_composite_balances(self, rng):
        # every row identical in BOTH columns: the position tiebreak must
        # still split rows evenly instead of flooding one device
        mesh = _mesh()
        n = 8 * 1024
        a = np.full(n, 7, np.uint32)
        b = np.full(n, 9, np.uint64)
        cols, counts, overflow = dist_sort.distributed_sort([
            jnp.asarray(a), jnp.asarray(b)
        ], mesh)
        assert not bool(overflow)
        cnt = np.asarray(counts)
        assert cnt.sum() == n
        assert cnt.max() <= dist_sort.exchange_capacity(n // 8, 8)
        assert cnt.min() > 0
        np.testing.assert_array_equal(_collect(cols[0], counts, 8), a)
        np.testing.assert_array_equal(_collect(cols[1], counts, 8), b)

    def test_sort_pairs_composite_multi_value(self, rng):
        mesh = _mesh()
        n = 8 * 1024
        a = rng.integers(0, 100, n, dtype=np.uint64)
        b = rng.integers(0, 3, n).astype(np.uint8)
        v1 = np.arange(n, dtype=np.uint32)
        v2 = rng.standard_normal(n).astype(np.float32)
        cols, vals, counts, overflow = dist_sort.distributed_sort_pairs(
            [jnp.asarray(a), jnp.asarray(b)],
            [jnp.asarray(v1), jnp.asarray(v2)],
            mesh,
        )
        assert not bool(overflow)
        order = np.lexsort((np.arange(n), b, a))  # stable by (a, b)
        np.testing.assert_array_equal(_collect(cols[0], counts, 8), a[order])
        np.testing.assert_array_equal(_collect(cols[1], counts, 8), b[order])
        np.testing.assert_array_equal(_collect(vals[0], counts, 8), v1[order])
        np.testing.assert_array_equal(_collect(vals[1], counts, 8), v2[order])

    def test_sort_limbs_128bit(self, rng):
        from radix_sort_tpu import keys as K
        mesh = _mesh()
        n = 8 * 1024
        # 128-bit keys as 4 big-endian u32 limbs; duplicate-heavy hi words
        hi = rng.integers(0, 3, n, dtype=np.uint64)
        lo = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        limbs = K.encode128(jnp.asarray(hi), jnp.asarray(lo), signed=False)
        out_limbs, _, counts, overflow = dist_sort.distributed_sort_limbs(
            limbs, mesh=_mesh()
        )
        assert not bool(overflow)
        got = [
            _collect(w, counts, 8).astype(np.uint64) for w in out_limbs
        ]
        order = np.lexsort((lo, hi))
        want_hi, want_lo = hi[order], lo[order]
        np.testing.assert_array_equal((got[0] << 32) | got[1], want_hi)
        np.testing.assert_array_equal((got[2] << 32) | got[3], want_lo)

    def test_limbs_rejects_signed(self, rng):
        with pytest.raises(ValueError, match="unsigned"):
            dist_sort.distributed_sort_limbs(
                [jnp.zeros(8, jnp.int32)], mesh=_mesh()
            )

    def test_gather_exchange_composite(self, rng):
        # force the all_gather emulation path explicitly (it restores order
        # with a full multi-key sort)
        mesh = _mesh()
        n = 8 * 512
        a = rng.integers(0, 2, n).astype(np.uint32)
        b = rng.integers(0, 1 << 16, n).astype(np.uint16)
        cols, counts, overflow = dist_sort.distributed_sort(
            [jnp.asarray(a), jnp.asarray(b)], mesh, exchange="gather"
        )
        assert not bool(overflow)
        order = np.lexsort((b, a))
        np.testing.assert_array_equal(_collect(cols[0], counts, 8), a[order])
        np.testing.assert_array_equal(_collect(cols[1], counts, 8), b[order])


def test_below_starts_lexicographic_oracle(rng):
    # unit oracle for the ragged path's run-start computation (the exchange
    # XLA:CPU cannot run): counts below each (limb..., pos) splitter must
    # equal the numpy lexicographic rank
    n, p = 512, 8
    a = rng.integers(0, 4, n).astype(np.uint32)
    b = rng.integers(0, 6, n).astype(np.uint32)
    order = np.lexsort((b, a))
    sa, sb = a[order], b[order]
    gpos = np.arange(n, dtype=np.int32)
    sw0 = rng.integers(0, 4, p - 1).astype(np.uint32)
    sw1 = rng.integers(0, 6, p - 1).astype(np.uint32)
    sp = rng.integers(0, n, p - 1).astype(np.int32)
    starts = np.asarray(dist_sort._below_starts(
        [jnp.asarray(sa), jnp.asarray(sb)], jnp.asarray(gpos),
        [jnp.asarray(sw0), jnp.asarray(sw1)], jnp.asarray(sp),
    ))
    for t in range(p - 1):
        want = int(np.sum(
            (sa < sw0[t])
            | ((sa == sw0[t]) & (sb < sw1[t]))
            | ((sa == sw0[t]) & (sb == sw1[t]) & (gpos < sp[t]))
        ))
        assert starts[t + 1] == want
    assert starts[0] == 0


@pytest.mark.parametrize("dtype", [np.uint32, np.float32])
def test_distributed_sort_descending(rng, dtype):
    mesh = _mesh()
    n = 8 * 1024
    if np.dtype(dtype).kind == "f":
        x = rng.standard_normal(n).astype(dtype)
    else:
        x = rng.integers(0, 100, n, dtype=dtype)  # duplicates exercise ties
    v = np.arange(n, dtype=np.uint32)
    out, vals, counts, overflow = dist_sort.distributed_sort_pairs(
        jnp.asarray(x), jnp.asarray(v), mesh, descending=True
    )
    assert not bool(overflow)
    got_k = _collect(out, counts, 8)
    got_v = _collect(vals, counts, 8)
    # stable-descending oracle: stable argsort of the complemented rank word
    order = np.argsort(-x.astype(np.float64) if np.dtype(dtype).kind == "f"
                       else x.max() - x, kind="stable")
    np.testing.assert_array_equal(got_k, x[order])
    np.testing.assert_array_equal(got_v, v[order])


def test_distributed_sort_descending_composite(rng):
    mesh = _mesh()
    n = 8 * 512
    a = rng.integers(0, 5, n).astype(np.int32)
    b = rng.integers(0, 7, n).astype(np.uint32)
    cols, counts, overflow = dist_sort.distributed_sort(
        [jnp.asarray(a), jnp.asarray(b)], mesh, descending=True
    )
    assert not bool(overflow)
    order = np.lexsort((-b.astype(np.int64), -a.astype(np.int64)))
    np.testing.assert_array_equal(_collect(cols[0], counts, 8), a[order])
    np.testing.assert_array_equal(_collect(cols[1], counts, 8), b[order])
