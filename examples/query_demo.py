"""End-to-end query on device — the north-star operator set composed.

A miniature analytics query over synthetic data, running entirely on the
accelerator with static shapes + counts:

    SELECT t.key, SUM(t.amount)
    FROM transactions t JOIN accounts a ON t.key = a.key
    WHERE t.amount > THRESHOLD AND a.tier = 1
    GROUP BY t.key ORDER BY t.key

Run: python -m examples.query_demo [--n 1000000]
"""

from __future__ import annotations

import argparse
import time

import numpy as np

import jax
import jax.numpy as jnp

import radix_sort_tpu as rst
from radix_sort_tpu.utils import distributions as D


def build_query(n_accounts: int, join_capacity: int):
    @jax.jit
    def query(t_keys, t_amounts, a_keys, a_tier, threshold):
        # WHERE t.amount > threshold  (stable compaction)
        tk, ta, n_kept = rst.filter(t_amounts > threshold, t_keys, t_amounts)
        # WHERE a.tier = 1 on the dimension side
        ak, _, n_acc = rst.filter(a_tier == 1, a_keys, a_tier)
        # mask the dropped tails to non-matching sentinels (distinct per
        # side so sentinel never joins sentinel) before the equi-join
        tk = jnp.where(
            jnp.arange(tk.shape[0]) < n_kept, tk, jnp.uint32(0xFFFFFFFF)
        )
        ak = jnp.where(
            jnp.arange(ak.shape[0]) < n_acc, ak, jnp.uint32(0xFFFFFFFE)
        )
        jk, ja, _, n_pairs, overflow = rst.hash_join(
            tk, ta, ak, jnp.ones_like(ak), capacity=join_capacity
        )
        # mask out slots beyond the valid pair count before aggregating
        valid = jnp.arange(join_capacity) < n_pairs
        jk = jnp.where(valid, jk, jnp.uint32(0xFFFFFFFF))
        ja = jnp.where(valid, ja, 0)
        # GROUP BY key, SUM(amount) — ascending key order by construction
        uk, sums, n_groups = rst.hash_aggregate(jk, ja, "sum")
        # the masked slots form one junk group at key 0xFFFFFFFF (dropped
        # by the caller via n_groups-1 when any slot was masked)
        junk = jnp.any(~valid)
        return uk, sums, n_groups - junk.astype(jnp.int32), overflow

    return query


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1 << 20, help="transaction rows")
    ap.add_argument("--accounts", type=int, default=1 << 12)
    args = ap.parse_args(argv)

    key = jax.random.PRNGKey(0)
    k1, k2, k3, k4 = jax.random.split(key, 4)
    # skewed transaction keys (Zipf over the account range), uniform amounts
    t_keys = (D.zipf(k1, args.n, jnp.uint32) % args.accounts).astype(jnp.uint32)
    t_amounts = (jax.random.bits(k2, (args.n,), jnp.uint32) >> 16).astype(jnp.uint32)
    a_keys = jnp.arange(args.accounts, dtype=jnp.uint32)
    a_tier = jax.random.randint(k3, (args.accounts,), 0, 3, jnp.uint32)
    threshold = jnp.uint32(1 << 14)

    q = build_query(args.accounts, join_capacity=int(args.n * 1.1))
    q_args = (t_keys, t_amounts, a_keys, a_tier, threshold)
    jax.block_until_ready(q(*q_args))  # compile
    t0 = time.perf_counter()
    uk, sums, n_groups, overflow = jax.block_until_ready(q(*q_args))
    dt = time.perf_counter() - t0
    n_groups = int(n_groups)
    print(f"query over {args.n} rows in {dt*1e3:.1f} ms -> {n_groups} groups"
          f" (overflow={bool(overflow)})")
    print("first groups:", np.asarray(uk)[:5], np.asarray(sums)[:5])


if __name__ == "__main__":
    main()
