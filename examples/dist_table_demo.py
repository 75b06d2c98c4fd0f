"""DistTable analytics pipeline — the MPP relation API composed end to end.

The distributed form of examples/table_demo.py's market query: trades are
row-sharded over the device mesh, every verb runs as its MPP plan (splitter
-sampled exchanges, carry-chain windows, two-phase aggregation), and the
whole pipeline is one jitted expression:

    SELECT sym, COUNT(*) AS n, SUM(qty) AS volume, MAX(run) AS peak_run
    FROM (SELECT *, SUM(qty) OVER (PARTITION BY sym ORDER BY ts) AS run
          FROM trades WHERE qty > MIN_QTY)
    GROUP BY sym ORDER BY volume DESC LIMIT 5

Run (any backend; multi-chip on a real mesh):

    python -m examples.dist_table_demo [--n 262144]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

import radix_sort_tpu as rst
from radix_sort_tpu.parallel import runtime


def build_pipeline(mesh, min_qty: int, max_groups: int):
    @jax.jit
    def run(sym, qty, ts):
        dt = rst.DistTable({"sym": sym, "qty": qty, "ts": ts}, mesh)
        dt = dt.filter(lambda t: t["qty"] > jnp.uint32(min_qty))
        dt = dt.window({"run": ("cumsum", "qty")},
                       partition_by="sym", order_by="ts")
        agg = dt.aggregate(
            "sym",
            {"n": "count", "volume": ("sum", "qty"),
             "peak_run": ("max", "run")},
            max_groups=max_groups,
        ).sort_by("volume", descending=True)
        return agg["sym"], agg["n"], agg["volume"], agg["peak_run"], agg.count

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 18)
    ap.add_argument("--symbols", type=int, default=64)
    args = ap.parse_args()

    mesh = runtime.data_mesh()
    nshards = mesh.devices.size
    n = -(-args.n // nshards) * nshards
    rng = np.random.default_rng(0)
    sym = jnp.asarray(rng.integers(0, args.symbols, n).astype(np.uint32))
    qty = jnp.asarray(rng.integers(1, 1000, n).astype(np.uint32))
    ts = jnp.asarray(rng.integers(0, 1 << 30, n).astype(np.uint32))

    run = build_pipeline(mesh, min_qty=100, max_groups=args.symbols * 2)
    jax.block_until_ready(run(sym, qty, ts))  # compile
    t0 = time.perf_counter()
    s, cnt, vol, peak, num = jax.block_until_ready(run(sym, qty, ts))
    dt_s = time.perf_counter() - t0
    num = int(num)
    print(f"{n:,} trades over {nshards} shards -> {num} symbols "
          f"in {dt_s*1e3:.1f} ms")
    for i in range(min(5, num)):
        print(f"  sym {int(s[i]):4d}  n={int(cnt[i]):7,d}  "
              f"volume={int(vol[i]):12,d}  peak_run={int(peak[i]):12,d}")


if __name__ == "__main__":
    main()
