"""Smoke run of the engine's main path on an NVIDIA GPU.

Drives the engine through its user entry points at real sizes and checks
every result against a plain numpy reference built from the same seeded
host arrays:

  1. device check: the first JAX device must be a GPU (no CPU fallback);
  2. queries: the nine ``demo --suite queries`` SQL queries through
     ``rst.sql`` over ``Table``s, at 60,000,000 lineitem rows (the row
     count of TPC-H SF10) and 3,750,000 customers;
  3. sort: 62,500,000 uniform (u64, u64) rows (the reference sweep's
     1.0 GB point) through ``rst.sort_pairs``,
     ``pallas_sort.sort_pairs_limbs(engine="comparator")`` and
     ``dist_sort.distributed_sort_pairs`` on a 1-device mesh with the
     backend's exchange named, so the exchange code compiles and runs;
  4. high-fanout joins: ``rst.hash_join`` of 1,000,000 left rows at fanout
     16, 64 and 256 (up to 256M output rows).

With ``--four-cards`` it runs only the sharded path on four GPUs of one
host: ``distributed_sort_pairs`` over 4 x 62.5M (u64, u64) rows, the
``DistTable`` filter -> window -> aggregate pipeline, and
``distributed_hash_join`` at fanout 16, each at P=1 and P=4.

Each timed step prints its compile seconds and the median of 3 runs that
end in ``jax.block_until_ready``; each phase prints the device's running
``peak_bytes_in_use``. The last line of standard output is one JSON
object; any failed check or exception exits non-zero before printing it.

Run:  python chip_smoke.py [--four-cards]
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

import radix_sort_tpu as rst
from radix_sort_tpu import demo
from radix_sort_tpu.ops import pallas_sort
from radix_sort_tpu.parallel import dist_query, dist_sort, runtime
from radix_sort_tpu.utils.compile_cache import enable_compile_cache
from radix_sort_tpu.utils.profiling import peak_hbm_bytes_per_s

LINEITEM_ROWS = 60_000_000  # TPC-H SF10 lineitem
SORT_ROWS = 62_500_000  # 1.0 GB of (u64, u64) rows
JOIN_LEFT_ROWS = 1_000_000
JOIN_FANOUTS = (16, 64, 256)
TIMED_RUNS = 3
FOUR_CARDS = 4
DIST_TABLE_ROWS_PER_CARD = 1 << 24
DIST_JOIN_FANOUT = 16


def gpu_info() -> list[str]:
    """One ``name, power.limit`` line per card, as nvidia-smi prints them
    (read before JAX touches the device)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as e:
        return [f"nvidia-smi unavailable ({type(e).__name__})"]
    return [line.strip() for line in out.splitlines() if line.strip()]


def check_device():
    """The first JAX device, which must be a GPU."""
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke.py needs a GPU; JAX found platform {dev.platform!r}")
    return dev


def log(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def timed(phase: str, name: str, fn, *args, rows: int | None = None):
    """Compile ``fn`` for ``args``, run it once to warm up, then time
    ``TIMED_RUNS`` runs. Returns ``(last output, median seconds)``."""
    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    out = jax.block_until_ready(compiled(*args))
    ts = []
    for _ in range(TIMED_RUNS):
        del out
        t0 = time.perf_counter()
        out = jax.block_until_ready(compiled(*args))
        ts.append(time.perf_counter() - t0)
    med = statistics.median(ts)
    rate = f", {rows / med / 1e6:.3f} M rows/s" if rows else ""
    log(phase, f"{name}: compile {compile_s:.3f} s; median {med:.6f} s of "
               f"{TIMED_RUNS} runs {[round(t, 6) for t in ts]}{rate}")
    return out, med


def log_peak(phase: str, devices) -> None:
    for d in devices:
        stats = d.memory_stats() or {}
        log(phase, f"peak_bytes_in_use {d.id}: "
                   f"{stats.get('peak_bytes_in_use', 'not reported')}")


def _header(phase: str, dev, smi: str) -> None:
    log(phase, f"device_kind {dev.device_kind!r}; nvidia-smi: {smi}")


# ---- phase 2: queries ---------------------------------------------------

def phase_queries(dev, smi: str, n: int = LINEITEM_ROWS) -> None:
    phase = "queries"
    _header(phase, dev, smi)
    t0 = time.perf_counter()
    host = demo.make_query_data(n, seed=0)
    data = demo.device_query_data(host)
    log(phase, f"lineitem {n:,} rows, customers {host['n_c']:,}; data made "
               f"and placed in {time.perf_counter() - t0:.3f} s")
    for q in demo.QUERIES:
        run, dictionaries = demo.build_query(q, host)
        out, _ = timed(phase, q.name, run, data, rows=q.rows * n)
        got = demo.query_result_to_host(out, dictionaries)
        del out
        demo.check_query(q, got, q.reference(host))
        log(phase, f"{q.name}: matches the numpy reference")
    del data
    log_peak(phase, [dev])


# ---- phase 3: sort ------------------------------------------------------

def _sort_data(n: int, seed: int):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 2**64, n, dtype=np.uint64)
    vals = rng.integers(0, 2**64, n, dtype=np.uint64)
    return keys, vals


def _split(a):
    return ((a >> np.uint64(32)).astype(np.uint32),
            (a & np.uint64(0xFFFFFFFF)).astype(np.uint32))


def phase_sort(dev, smi: str, n: int = SORT_ROWS) -> None:
    phase = "sort"
    _header(phase, dev, smi)
    keys, vals = _sort_data(n, seed=1)
    t0 = time.perf_counter()
    order = np.argsort(keys, kind="stable")
    want_k, want_v = keys[order], vals[order]
    del order
    log(phase, f"{n:,} (u64, u64) rows; numpy stable argsort reference in "
               f"{time.perf_counter() - t0:.3f} s")

    k, v = jnp.asarray(keys), jnp.asarray(vals)
    (ok, ov), _ = timed(phase, "rst.sort_pairs", rst.sort_pairs, k, v, rows=n)
    np.testing.assert_array_equal(np.asarray(ok), want_k)
    np.testing.assert_array_equal(np.asarray(ov), want_v)
    del ok, ov
    log(phase, "rst.sort_pairs: bit-exact against numpy")

    limbs = [jnp.asarray(x) for x in (*_split(keys), *_split(vals))]
    del k, v

    def limb_sort(khi, klo, vhi, vlo):
        return pallas_sort.sort_pairs_limbs(khi, klo, vhi, vlo,
                                            engine="comparator")

    out, _ = timed(phase, "sort_pairs_limbs(comparator)", limb_sort, *limbs,
                   rows=n)
    got = [np.asarray(x) for x in out]
    del out, limbs
    for (hi, lo), want in ((got[:2], want_k), (got[2:], want_v)):
        np.testing.assert_array_equal(
            (hi.astype(np.uint64) << np.uint64(32)) | lo, want)
    del got
    log(phase, "sort_pairs_limbs(comparator): bit-exact against numpy")

    mesh = runtime.data_mesh(devices=[dev])
    exchange = dist_sort.default_exchange()
    k, v = runtime.shard_rows(mesh, keys, vals)

    def dsort(a, b):
        return dist_sort.distributed_sort_pairs(a, b, mesh, exchange=exchange)

    (ok, ov, counts, overflow), _ = timed(
        phase, f"distributed_sort_pairs P=1 exchange={exchange}", dsort, k, v,
        rows=n)
    c = int(np.asarray(counts)[0])
    if bool(overflow) or c != n:
        raise AssertionError(f"distributed sort: count {c}, overflow "
                             f"{bool(overflow)}")
    np.testing.assert_array_equal(np.asarray(ok)[:c], want_k)
    np.testing.assert_array_equal(np.asarray(ov)[:c], want_v)
    log(phase, f"distributed_sort_pairs P=1 ({exchange} exchange): "
               f"bit-exact against numpy")
    log_peak(phase, [dev])


# ---- phase 4: high-fanout joins -----------------------------------------

def _join_data(n_l: int, fanout: int, seed: int):
    """Left keys uniform over ``n_l // fanout`` keys, each of which the
    right side holds ``fanout`` times (shuffled): every left row matches
    exactly ``fanout`` right rows."""
    rng = np.random.default_rng(seed)
    n_keys = n_l // fanout
    lk = rng.integers(0, n_keys, n_l).astype(np.uint32)
    lv = rng.integers(0, 2**32, n_l, dtype=np.uint64).astype(np.uint32)
    rk = rng.permutation(np.repeat(np.arange(n_keys, dtype=np.uint32),
                                   fanout))
    rv = rng.integers(0, 2**32, rk.size, dtype=np.uint64).astype(np.uint32)
    return lk, lv, rk, rv


def _join_reference(lk, lv, rk, rv, fanout):
    """hash_join's inner result: left rows in order, each followed by its
    matches in stable key order of the right side."""
    order = np.argsort(rk, kind="stable")
    lo = np.searchsorted(rk[order], lk, side="left")
    ridx = np.repeat(lo, fanout) + np.tile(np.arange(fanout), lk.size)
    return np.repeat(lk, fanout), np.repeat(lv, fanout), rv[order][ridx]


def phase_joins(dev, smi: str, n_l: int = JOIN_LEFT_ROWS,
                fanouts=JOIN_FANOUTS) -> None:
    phase = "joins"
    _header(phase, dev, smi)
    peak = peak_hbm_bytes_per_s(dev.device_kind)
    for fanout in fanouts:
        lk, lv, rk, rv = _join_data(n_l, fanout, seed=2)
        rows = n_l * fanout

        def join(a, b, c, d, cap=rows):
            return rst.hash_join(a, b, c, d, capacity=cap)

        args = [jnp.asarray(x) for x in (lk, lv, rk, rv)]
        out, med = timed(phase, f"hash_join fanout {fanout}", join, *args,
                         rows=rows)
        del args
        jk, jl, jr, cnt, overflow = out
        if bool(overflow) or int(cnt) != rows:
            raise AssertionError(f"fanout {fanout}: count {int(cnt)}, "
                                 f"overflow {bool(overflow)}")
        got = [np.asarray(x) for x in (jk, jl, jr)]
        del out, jk, jl, jr
        for name, g, w in zip(("keys", "left", "right"), got,
                              _join_reference(lk, lv, rk, rv, fanout)):
            np.testing.assert_array_equal(g, w, err_msg=f"fanout {fanout} "
                                                        f"{name}")
        del got
        out_bytes = 12 * rows  # three u32 output columns
        log(phase, f"hash_join fanout {fanout}: exact; {rows:,} output rows; "
                   f"{med / rows * 1e9:.4f} ns per output row; output "
                   f"written at {out_bytes / med / 1e9:.1f} GB/s = "
                   f"{out_bytes / med / peak:.4f} of the "
                   f"{peak / 1e12:.2f} TB/s peak")
    log_peak(phase, [dev])


# ---- --four-cards: the sharded path -------------------------------------

def _gather_valid(arr, counts, p):
    counts = np.asarray(counts)
    blocks = np.split(np.asarray(arr), p)
    return np.concatenate([b[:counts[i]] for i, b in enumerate(blocks)])


def _check_stable_sort(keys, ids, k_out, v_out):
    """``(k_out, v_out)`` is the stable sort of ``(keys, ids)`` where
    ``ids`` is ``arange(n)``: keys non-decreasing, ids a permutation that
    carries each key, and ids increasing within equal keys. Equivalent to
    comparing with numpy's stable argsort, in O(n)."""
    n = keys.size
    if k_out.size != n or v_out.size != n:
        raise AssertionError(f"{k_out.size} rows out of {n}")
    if not (k_out[1:] >= k_out[:-1]).all():
        raise AssertionError("keys out of order")
    seen = np.zeros(n, np.bool_)
    seen[v_out] = True
    if not seen.all():
        raise AssertionError("payloads are not a permutation of the input")
    if not np.array_equal(keys[v_out], k_out):
        raise AssertionError("a payload left its key")
    tie = k_out[1:] == k_out[:-1]
    if not (v_out[1:][tie] > v_out[:-1][tie]).all():
        raise AssertionError("equal keys lost their input order")


def four_card_sort(devices, smi, n_local=SORT_ROWS):
    phase = "4-card sort"
    _header(phase, devices[0], smi)
    rates = {}
    for p in (1, FOUR_CARDS):
        n = n_local * p
        rng = np.random.default_rng(3)
        keys = rng.integers(0, 2**64, n, dtype=np.uint64)
        ids = np.arange(n, dtype=np.uint64)
        mesh = runtime.data_mesh(devices=devices[:p])
        exchange = dist_sort.default_exchange()
        k, v = runtime.shard_rows(mesh, keys, ids)

        def dsort(a, b, mesh=mesh, exchange=exchange):
            return dist_sort.distributed_sort_pairs(a, b, mesh,
                                                    exchange=exchange)

        (ko, vo, counts, overflow), med = timed(
            phase, f"distributed_sort_pairs P={p} exchange={exchange}",
            dsort, k, v, rows=n)
        del k, v
        if bool(overflow):
            raise AssertionError(f"P={p}: exchange overflow")
        _check_stable_sort(keys, ids, _gather_valid(ko, counts, p),
                           _gather_valid(vo, counts, p))
        del ko, vo
        rates[p] = n / med / p
        log(phase, f"P={p}: exact stable sort; {rates[p] / 1e6:.3f} M "
                   f"rows/s per device")
    log(phase, f"rows/s per device P=1 {rates[1] / 1e6:.3f} M, "
               f"P={FOUR_CARDS} {rates[FOUR_CARDS] / 1e6:.3f} M; scaling "
               f"efficiency {rates[FOUR_CARDS] / rates[1]:.4f}")
    log_peak(phase, devices)


def four_card_dist_table(devices, smi, n_local=DIST_TABLE_ROWS_PER_CARD):
    phase = "4-card DistTable"
    _header(phase, devices[0], smi)
    rates = {}
    for p in (1, FOUR_CARDS):
        n = n_local * p
        rng = np.random.default_rng(4)
        sym = rng.integers(0, 11, n).astype(np.uint32)
        qty = rng.integers(1, 100, n).astype(np.uint32)
        mesh = runtime.data_mesh(devices=devices[:p])
        s_d, q_d = runtime.shard_rows(mesh, sym, qty)

        def pipeline(s, q, mesh=mesh):
            dt = rst.DistTable({"sym": s, "qty": q}, mesh)
            dt = dt.filter(lambda t: t["qty"] > 50)
            dt = dt.window({"rn": "row_number"}, partition_by="sym")
            agg = dt.aggregate("sym", {"vol": ("sum", "qty"),
                                       "n": ("max", "rn")}, max_groups=32)
            count = agg.count if agg.count is not None else agg.num_rows
            return {c: agg[c] for c in ("sym", "vol", "n")}, count

        out, med = timed(phase, f"filter -> window -> aggregate P={p}",
                         pipeline, s_d, q_d, rows=n)
        got = _local_table_to_numpy(out)
        keep = qty > 50
        want_n = np.bincount(sym[keep], minlength=11)
        want_vol = np.bincount(sym[keep], weights=qty[keep], minlength=11)
        uks = np.flatnonzero(want_n)
        np.testing.assert_array_equal(got["sym"], uks)
        np.testing.assert_array_equal(got["vol"], want_vol[uks].astype(
            np.int64))
        np.testing.assert_array_equal(got["n"], want_n[uks])
        rates[p] = n / med / p
        log(phase, f"P={p}: exact; {rates[p] / 1e6:.3f} M rows/s per device")
    log(phase, f"scaling efficiency {rates[FOUR_CARDS] / rates[1]:.4f}")
    log_peak(phase, devices)


def _local_table_to_numpy(out):
    cols, count = out
    n = int(count)
    return {k: np.asarray(v)[:n].astype(np.int64) for k, v in cols.items()}


def four_card_join(devices, smi, n_local=JOIN_LEFT_ROWS,
                   fanout=DIST_JOIN_FANOUT):
    phase = "4-card join"
    _header(phase, devices[0], smi)
    rates = {}
    for p in (1, FOUR_CARDS):
        n_l = n_local * p
        rng = np.random.default_rng(5)
        n_keys = n_l // fanout
        lk = rng.integers(0, n_keys, n_l).astype(np.uint32)
        rk = rng.permutation(np.repeat(np.arange(n_keys, dtype=np.uint32),
                                       fanout))
        # row ids as payloads: each output row names its (left, right) pair
        lid = np.arange(n_l, dtype=np.uint32)
        rid = np.arange(rk.size, dtype=np.uint32)
        mesh = runtime.data_mesh(devices=devices[:p])
        args = runtime.shard_rows(mesh, lk, lid, rk, rid)
        rows = n_l * fanout
        cap = (rows // p) * 5 // 4

        def join(a, b, c, d, mesh=mesh, cap=cap):
            return dist_query.distributed_hash_join(
                a, b, c, d, mesh, capacity_per_shard=cap)

        out, med = timed(phase, f"distributed_hash_join fanout {fanout} "
                                f"P={p}", join, *args, rows=rows)
        del args
        jk, jl, jr, counts, overflow = out
        if bool(overflow) or int(np.asarray(counts).sum()) != rows:
            raise AssertionError(f"P={p}: {int(np.asarray(counts).sum())} "
                                 f"rows, overflow {bool(overflow)}")
        jk, jl, jr = (_gather_valid(x, counts, p) for x in (jk, jl, jr))
        del out
        if not np.array_equal(jk, lk[jl]) or not np.array_equal(jk, rk[jr]):
            raise AssertionError(f"P={p}: a joined row's keys differ")
        pairs = np.sort((jl.astype(np.uint64) << np.uint64(32)) | jr)
        order = np.argsort(rk, kind="stable")
        lo = np.searchsorted(rk[order], lk, side="left")
        want_r = order[np.repeat(lo, fanout)
                       + np.tile(np.arange(fanout), n_l)]
        want = np.sort((np.repeat(lid, fanout).astype(np.uint64)
                        << np.uint64(32)) | want_r.astype(np.uint64))
        np.testing.assert_array_equal(pairs, want)
        rates[p] = rows / med / p
        log(phase, f"P={p}: exact; {rows:,} output rows; "
                   f"{rates[p] / 1e6:.3f} M output rows/s per device")
    log(phase, f"scaling efficiency {rates[FOUR_CARDS] / rates[1]:.4f}")
    log_peak(phase, devices)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the sharded path on four GPUs")
    args = ap.parse_args(argv)

    smi_lines = gpu_info()  # before JAX initializes the device
    smi = "; ".join(smi_lines)
    jax.config.update("jax_enable_x64", True)
    log("device", f"nvidia-smi: {smi}")
    dev = check_device()
    enable_compile_cache()
    devices = jax.devices()
    log("device", f"platform {dev.platform}; device_kind {dev.device_kind!r};"
                  f" {len(devices)} device(s)")
    # The engine has no matrix product (no dot/matmul/einsum in the
    # package), so TF32 matmul precision cannot change any result here.

    if args.four_cards:
        if len(devices) < FOUR_CARDS:
            raise SystemExit(f"--four-cards needs {FOUR_CARDS} GPUs, found "
                             f"{len(devices)}")
        devices = devices[:FOUR_CARDS]
        four_card_sort(devices, smi)
        four_card_dist_table(devices, smi)
        four_card_join(devices, smi)
    else:
        devices = devices[:1]
        phase_queries(dev, smi)
        phase_sort(dev, smi)
        phase_joins(dev, smi)

    for line in smi_lines:
        print(line)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
