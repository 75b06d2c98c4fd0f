"""The GPU bring-up surface on the CPU: the smoke's queries against their
numpy references, its checks, the compile-cache location, the exchange
choice, and the engine-selection errors left after the Pallas engine went."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

import chip_smoke
import radix_sort_tpu as rst
from radix_sort_tpu import demo
from radix_sort_tpu.ops import pallas_sort
from radix_sort_tpu.parallel import dist_sort, runtime
from radix_sort_tpu.utils import compile_cache

QUERY_ROWS = 4096


@pytest.fixture(scope="module")
def query_data():
    host = demo.make_query_data(QUERY_ROWS, seed=0)
    return host, demo.device_query_data(host)


@pytest.mark.parametrize("q", demo.QUERIES, ids=lambda q: q.name.split()[0])
def test_queries_match_numpy_reference(q, query_data):
    host, dev = query_data
    run, dictionaries = demo.build_query(q, host)
    got = demo.query_result_to_host(run(dev), dictionaries)
    demo.check_query(q, got, q.reference(host))


def test_check_query_catches_a_wrong_count(query_data):
    host, dev = query_data
    q = demo.QUERIES[0]  # Q1: exact COUNT(*) per status
    run, dictionaries = demo.build_query(q, host)
    got = demo.query_result_to_host(run(dev), dictionaries)
    want = q.reference(host)
    want["n"] = want["n"].copy()
    want["n"][0] += 1
    with pytest.raises(AssertionError):
        demo.check_query(q, got, want)


def test_compile_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    prev = jax.config.jax_compilation_cache_dir
    try:
        path = compile_cache.enable_compile_cache()
        root = os.path.dirname(os.path.dirname(os.path.abspath(
            rst.__file__)))
        assert path == os.path.join(root, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", prev)


def test_compile_cache_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    prev = jax.config.jax_compilation_cache_dir
    assert compile_cache.enable_compile_cache() == str(tmp_path)
    # JAX reads the variable itself: nothing else is configured
    assert jax.config.jax_compilation_cache_dir == prev


def test_default_exchange_on_cpu_is_gather():
    assert jax.default_backend() == "cpu"
    assert dist_sort.default_exchange() == "gather"


def test_default_exchange_on_gpu_is_ragged(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert dist_sort.default_exchange() == "ragged"


@pytest.mark.parametrize("exchange", ["gather", "pipelined"])
def test_named_exchange_runs_on_one_device(rng, exchange):
    # a named exchange runs even on a 1-device mesh (the smoke relies on
    # this to compile the exchange on a single card)
    mesh = runtime.data_mesh(devices=jax.devices()[:1])
    n = 3000
    keys = rng.integers(0, 50, n).astype(np.uint64)  # duplicate-heavy
    vals = np.arange(n, dtype=np.uint64)
    k, v, counts, overflow = jax.jit(
        lambda a, b: dist_sort.distributed_sort_pairs(
            a, b, mesh, exchange=exchange)
    )(jnp.asarray(keys), jnp.asarray(vals))
    c = int(np.asarray(counts)[0])
    order = np.argsort(keys, kind="stable")
    assert c == n and not bool(overflow)
    np.testing.assert_array_equal(np.asarray(k)[:c], keys[order])
    np.testing.assert_array_equal(np.asarray(v)[:c], vals[order])


def test_pallas_implementation_is_gone():
    assert "pallas" not in rst.IMPLEMENTATIONS
    with pytest.raises(ValueError, match="implementation must be one of"):
        rst.sort(jnp.arange(8, dtype=jnp.uint32), implementation="pallas")


def test_sort_pairs_limbs_rejects_sample_engine():
    z = jnp.zeros(4, jnp.uint32)
    with pytest.raises(ValueError, match="engine must be one of"):
        pallas_sort.sort_pairs_limbs(z, z, z, z, engine="sample")


def test_f64_sort_inside_jit(rng):
    x = rng.standard_normal(2049)
    x[:4] = [np.nan, -0.0, 0.0, -np.inf]
    got = np.asarray(jax.jit(rst.sort)(jnp.asarray(x)))
    w = x.view(np.int64)
    want = x[np.argsort(w ^ ((w >> 63) & 0x7FFFFFFFFFFFFFFF), kind="stable")]
    np.testing.assert_array_equal(got.view(np.uint64), want.view(np.uint64))


def test_chip_smoke_refuses_the_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        chip_smoke.check_device()


@pytest.fixture
def cpu_peak(monkeypatch):
    # the CPU has no published bandwidth; the smoke's checks still run
    monkeypatch.setattr(chip_smoke, "peak_hbm_bytes_per_s", lambda kind: 1e12)


def test_chip_smoke_sort_phase_small(cpu_peak):
    chip_smoke.phase_sort(jax.devices()[0], "cpu", n=5000)


def test_chip_smoke_join_phase_small(cpu_peak):
    chip_smoke.phase_joins(jax.devices()[0], "cpu", n_l=2048,
                           fanouts=(16, 64))


def test_chip_smoke_four_card_sort_small():
    chip_smoke.four_card_sort(jax.devices()[:4], "cpu", n_local=2048)


def test_chip_smoke_four_card_dist_table_small():
    chip_smoke.four_card_dist_table(jax.devices()[:4], "cpu", n_local=2048)


def test_chip_smoke_four_card_join_small():
    chip_smoke.four_card_join(jax.devices()[:4], "cpu", n_local=2048)


def test_stable_sort_check_catches_a_swap():
    keys = np.array([3, 1, 1, 2], np.uint64)
    ids = np.arange(4, dtype=np.uint64)
    chip_smoke._check_stable_sort(keys, ids, keys[[1, 2, 3, 0]],
                                  ids[[1, 2, 3, 0]])
    with pytest.raises(AssertionError, match="input order"):
        chip_smoke._check_stable_sort(keys, ids, keys[[2, 1, 3, 0]],
                                      ids[[2, 1, 3, 0]])


@pytest.mark.gpu
def test_chip_smoke_phases_on_gpu(gpu_device):
    with jax.default_device(gpu_device):
        chip_smoke.phase_sort(gpu_device, "gpu", n=1 << 20)
        chip_smoke.phase_joins(gpu_device, "gpu", n_l=1 << 16)


def test_regular_sample_positions_at_large_shards():
    # 62.5M rows per shard x 128 samples overflows an int32 product; the
    # positions must still be the exact stride midpoints, all in range
    from radix_sort_tpu.parallel.dist_sort import _regular_sample_positions

    for n_local, m in ((62_500_000, 128), (2**30, 8 * 64 * 64), (1000, 64)):
        got = np.asarray(_regular_sample_positions(n_local, m))
        i = np.arange(m, dtype=np.int64)
        np.testing.assert_array_equal(got, i * n_local // m
                                      + n_local // (2 * m))
        assert got.min() >= 0 and got.max() < n_local
