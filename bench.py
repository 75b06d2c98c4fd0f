"""Headline benchmark: u64 key/payload sort throughput per device.

Reproduces the reference's measurement protocol (src/main.rs:101-127): N
runs over uniform-random (u64,u64) key/payload rows, mean wall-clock of the
full sort, reported as keys/s against the BASELINE.md north-star target of
1e9 u64 keys/s/chip.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline": N}.

64-bit keys are processed as (hi, lo) uint32 limb pairs end to end (the
``sort_pairs_limbs`` form). Runs on a GPU only; any other platform is
refused.

Run:  python bench.py [--n ROWS] [--runs 5]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

BASELINE_KEYS_PER_S = 1e9  # BASELINE.md north-star target per chip


def _gen_limbs(key, n):
    """Uniform u64 keys as (hi, lo) u32 limbs + u64 payload limbs (zeros),
    mirroring KeyUniform (distr.rs:46-51): uniform key, payload 0, packed
    as one (4, n) array."""
    khi, klo = jax.random.split(key)
    hi = jax.random.bits(khi, (n,), jnp.uint32)
    lo = jax.random.bits(klo, (n,), jnp.uint32)
    z = jnp.zeros((2, n), jnp.uint32)
    return jnp.concatenate([hi[None], lo[None], z])


def _make_sort_fn():
    from radix_sort_tpu.ops import pallas_sort

    def sort_packed(p):
        return jnp.stack(pallas_sort.sort_pairs_limbs(p[0], p[1], p[2], p[3]))

    # donating the packed input frees its 16n bytes for the output — the
    # 4.0 GB sweep point (250M rows) needs half the device memory with it
    return jax.jit(sort_packed, donate_argnums=0)


def _auto_ns():
    """Default sizes: the FULL reference sweep — 0.5 to 4.0 GB of
    (u64,u64) rows in 0.5 GB steps (main.rs:104; 16 bytes/row ->
    31.25M..250M rows); headline = peak keys/s over the sweep."""
    return [i * 31_250_000 for i in range(1, 9)]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--n",
        type=int,
        default=0,
        help="number of u64 rows; 0 = auto (the full reference 0.5-4.0GB "
        "sweep, peak reported)",
    )
    ap.add_argument("--runs", type=int, default=5)
    args = ap.parse_args()
    platform = jax.devices()[0].platform
    if platform != "gpu":
        sys.exit(f"bench.py times the GPU only; found platform {platform!r}")
    from radix_sort_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    ns = [args.n] if args.n else _auto_ns()

    sort_fn = _make_sort_fn()
    key = jax.random.PRNGKey(0)
    best = 0.0

    for n in ns:
        # compile + warmup (excluded from timing, like the reference's
        # per-run fresh-data protocol which times only the sort,
        # main.rs:32-34)
        data = _gen_limbs(key, n)
        jax.block_until_ready(sort_fn(data))

        times = []
        for r in range(args.runs):
            key, sub = jax.random.split(key)
            data = jax.block_until_ready(_gen_limbs(sub, n))
            t0 = time.perf_counter()
            jax.block_until_ready(sort_fn(data))
            times.append(time.perf_counter() - t0)
        mean = float(np.mean(times))
        print(  # per-point sweep row (stderr: stdout is the one JSON line)
            f"  sweep n={n:>11,} ({n * 16 / 1e9:.1f} GB): {mean:.3f} s = "
            f"{n / mean / 1e6:7.1f} M keys/s",
            file=sys.stderr,
            flush=True,
        )
        best = max(best, n / mean)

    print(
        json.dumps(
            {
                "metric": "u64_pair_sort_throughput_per_chip",
                "value": round(best, 1),
                "unit": "keys/s",
                "vs_baseline": round(best / BASELINE_KEYS_PER_S, 4),
            }
        )
    )


if __name__ == "__main__":
    main()
