"""Multi-process (multi-host-shaped) engine smoke: one process per "host".

The reference is a single-process shared-memory program — its only
synchronization is a thread join (src/radix_sort/mod.rs:103-108). The
north-star equivalent is the engine's collectives riding a REAL process
boundary (multi-host-shaped): this module is the per-process worker that brings
up `jax.distributed` via :func:`runtime.initialize_multihost`, builds one
global mesh spanning every process's devices, and runs the distributed
engine across it with full numpy-oracle checks:

  1. ``distributed_sort_pairs`` (uniform + duplicate-heavy keys — the
     stability regime, src/distr.rs:132-160) over the cross-process mesh;
  2. a ``DistTable`` pipeline (filter -> distributed aggregate);
  3. a SQL query through the planner (aggregate-over-join -> the
     broadcast-lookup eager-aggregation plan).

Every process holds the same seeded numpy inputs, owns only its local
device shards (``jax.make_array_from_callback``), and verifies the
globally-gathered outputs independently; it prints ``MP_SMOKE_OK`` and
exits 0 only if every check passes.

Run it standalone (per process i of N)::

    JAX_PLATFORMS=cpu XLA_FLAGS=--xla_force_host_platform_device_count=2 \
      python -m radix_sort_tpu.parallel.mp_smoke --process-id i \
        --num-processes N --coordinator localhost:PORT

or let :func:`runtime.run_local_cluster` launch the whole cluster.
"""

from __future__ import annotations

import argparse
import sys


def _fetch(x):
    """Host copy of a (possibly non-fully-addressable) global array."""
    import jax
    import numpy as np
    from jax.experimental import multihost_utils

    if getattr(x, "is_fully_addressable", True):
        return np.asarray(x)
    return np.asarray(
        jax.device_get(multihost_utils.process_allgather(x, tiled=True))
    )


def _check_sort(mesh, n_devices, keys, vals, name, exchange=None):
    """One cross-process distributed sort + exact stable-oracle check."""
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    from radix_sort_tpu.parallel import dist_sort

    sh = NamedSharding(mesh, P("x"))
    n = keys.shape[0]

    def put(a):
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

    kd, vd = put(keys), put(vals)
    fn = jax.jit(
        lambda k, v: dist_sort.distributed_sort_pairs(
            k, v, mesh, exchange=exchange
        )
    )
    k_out, v_out, counts, overflow = jax.block_until_ready(fn(kd, vd))
    assert not _fetch(overflow).any(), f"{name}: exchange overflow"
    cnt = _fetch(counts).reshape(-1)[:n_devices]
    mk = np.concatenate(
        [d[: cnt[i]] for i, d in enumerate(np.split(_fetch(k_out), n_devices))]
    )
    mv = np.concatenate(
        [d[: cnt[i]] for i, d in enumerate(np.split(_fetch(v_out), n_devices))]
    )
    order = np.argsort(keys, kind="stable")
    np.testing.assert_array_equal(mk, keys[order], err_msg=name)
    np.testing.assert_array_equal(mv, vals[order], err_msg=name)


def run_smoke(coordinator: str, num_processes: int, process_id: int) -> None:
    """The worker body (see module docstring). Raises on any failure."""
    # bring-up MUST precede any backend-touching JAX call
    from radix_sort_tpu.parallel.runtime import data_mesh, initialize_multihost

    initialize_multihost(coordinator, num_processes, process_id)

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import NamedSharding, PartitionSpec as P

    assert jax.process_count() == num_processes, (
        f"process_count {jax.process_count()} != {num_processes} — "
        f"cluster bring-up silently degraded"
    )
    assert jax.process_index() == process_id
    n_local_devs = len(jax.local_devices())
    mesh = data_mesh()
    n_devices = len(jax.devices())
    assert n_devices == num_processes * n_local_devs

    # --- 1. distributed sorts across the process boundary ---------------
    rng = np.random.default_rng(0xD15C0)
    n = 1024 * n_devices
    vals = np.arange(n, dtype=np.uint32)
    uniform = rng.integers(0, 1 << 31, size=n, dtype=np.uint32)
    # duplicate-heavy: 7 distinct keys -> stability is load-bearing and
    # every shard must split runs of equal keys across processes
    step = (rng.integers(0, 7, size=n).astype(np.uint32) + 1) * np.uint32(
        0x24924924
    )
    _check_sort(mesh, n_devices, uniform, vals, "uniform")
    _check_sort(mesh, n_devices, step, vals, "step_dups")  # same jit cache
    _check_sort(mesh, n_devices, step, vals, "pipelined", exchange="pipelined")

    # --- 2. DistTable pipeline: filter -> distributed aggregate ---------
    import radix_sort_tpu as rst

    sh = NamedSharding(mesh, P("x"))

    def put(a):
        return jax.make_array_from_callback(a.shape, sh, lambda idx: a[idx])

    sym = rng.integers(0, 11, n).astype(np.uint32)
    qty = rng.integers(1, 100, n).astype(np.uint32)
    dt = rst.DistTable({"sym": put(sym), "qty": put(qty)}, mesh)
    agg = dt.filter(lambda t: t["qty"] > 50).aggregate(
        "sym", {"vol": ("sum", "qty"), "n": ("count", "qty")}, max_groups=32
    )
    out = {k: _fetch(agg[k]) for k in agg.column_names}
    ngroups = int(_fetch(agg.count).reshape(-1)[0]) if agg.count is not None \
        else out["sym"].shape[0]
    keep = qty > 50
    uks = np.unique(sym[keep])
    assert ngroups == len(uks), "dist_table group count"
    np.testing.assert_array_equal(out["sym"][:ngroups], uks,
                                  err_msg="dist_table keys")
    for i, u in enumerate(uks):
        g = qty[keep][sym[keep] == u]
        assert out["vol"][i] == g.sum(), "dist_table vol"
        assert out["n"][i] == len(g), "dist_table count"

    # --- 3. SQL across the boundary: eager-aggregated lookup join -------
    fact = rst.DistTable({"sym": put(sym), "qty": put(qty)}, mesh)
    dsym = np.repeat(np.arange(8, dtype=np.uint32), 2)  # fanout 2
    dim = rst.Table({"sym": dsym, "seg": (dsym % 3).astype(np.uint32)})
    lq = rst.sql(
        "SELECT sym, SUM(qty) AS vol, COUNT(*) AS cnt FROM f "
        "JOIN d USING (sym) WHERE seg < 2 GROUP BY sym ORDER BY sym",
        {"f": fact, "d": dim}, max_groups=32,
    )
    assert "join[lookup on sym]" in lq.explain(), "eager-agg rewrite"
    res = lq.collect()
    got = {k: _fetch(res[k]) for k in res.column_names}
    nrows = int(_fetch(res.count).reshape(-1)[0]) if res.count is not None \
        else got["sym"].shape[0]
    dkeep = np.unique(dsym[dsym % 3 < 2])
    uks = np.array([u for u in np.unique(sym) if u in dkeep])
    assert nrows == len(uks), "sql row count"
    np.testing.assert_array_equal(got["sym"][:nrows], uks, err_msg="sql sym")
    for i, u in enumerate(uks):
        g = qty[sym == u]
        assert int(got["vol"][i]) == 2 * int(g.sum()), "sql vol"
        assert int(got["cnt"][i]) == 2 * len(g), "sql cnt"

    print(
        f"MP_SMOKE_OK process={process_id}/{num_processes} "
        f"devices={n_devices} local={n_local_devs}",
        flush=True,
    )


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", required=True,
                   help="host:port of process 0's coordinator service")
    p.add_argument("--num-processes", type=int, required=True)
    p.add_argument("--process-id", type=int, required=True)
    a = p.parse_args(argv)
    run_smoke(a.coordinator, a.num_processes, a.process_id)
    return 0


if __name__ == "__main__":
    sys.exit(main())
