"""Table-facade analytics pipeline — the relation API composed end to end.

A miniature market-data query, one jitted expression on device:

    -- enrich each trade with the latest quote at or before it (ASOF JOIN),
    -- then aggregate per symbol and rank by notional
    SELECT symbol, COUNT(*), SUM(qty * px) AS notional
    FROM trades ASOF JOIN quotes ON trades.ts >= quotes.ts
    WHERE qty > MIN_QTY
    GROUP BY symbol ORDER BY notional DESC

Run: python -m examples.table_demo [--n 100000]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import jax
import jax.numpy as jnp

import radix_sort_tpu as rst


def build_pipeline(min_qty: int):
    @jax.jit
    def run(sym, qty, ts, q_ts, q_px):
        t = rst.Table({"sym": sym, "qty": qty, "ts": ts})
        t = t.filter(lambda t: t["qty"] > jnp.uint32(min_qty))
        # ASOF JOIN: latest quote at-or-before each trade (padding rows get
        # garbage quotes, but they sit beyond t.count and every downstream
        # op is validity-aware)
        px, _, _ = rst.join_asof(t["ts"], q_ts, q_px, direction="backward")
        t = t.with_columns(px=px, notional=t["qty"] * px)
        agg = t.aggregate(
            "sym", {"n": "count", "notional": ("sum", "notional")}
        ).sort_by("notional", descending=True)
        return agg["sym"], agg["n"], agg["notional"], agg.count

    return run


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--symbols", type=int, default=64)
    args = ap.parse_args()
    rng = np.random.default_rng(0)
    n, n_q = args.n, max(args.n // 16, 1)
    sym = rng.integers(0, args.symbols, n).astype(np.uint32)
    qty = rng.integers(1, 500, n).astype(np.uint32)
    ts = np.sort(rng.integers(0, 1 << 30, n).astype(np.uint32))
    q_ts = rng.integers(0, 1 << 30, n_q).astype(np.uint32)
    q_px = rng.integers(90, 110, n_q).astype(np.uint32)

    run = build_pipeline(min_qty=250)
    args_dev = tuple(jnp.asarray(a) for a in (sym, qty, ts, q_ts, q_px))
    jax.block_until_ready(run(*args_dev))  # compile
    t0 = time.perf_counter()
    out = jax.block_until_ready(run(*args_dev))
    dt = time.perf_counter() - t0
    s, cnt_, notional, num = out
    num = int(num)
    print(f"{n:,} trades x {n_q:,} quotes in {dt*1e3:.1f} ms "
          f"({num} symbols); top 5 by notional:")
    for i in range(min(5, num)):
        print(f"  sym {int(np.asarray(s)[i]):4d}  trades "
              f"{int(np.asarray(cnt_)[i]):7,d}  notional "
              f"{int(np.asarray(notional)[i]):14,d}")


if __name__ == "__main__":
    main()
