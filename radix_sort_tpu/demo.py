"""Benchmark demo CLI — the reference's `cargo run -r` path rebuilt in JAX.

Reproduces the measurement protocols of src/main.rs:

  - main.rs:101-127 (main): a GB sweep per row type; fresh rows per run;
    mean wall-clock per size. Extras: selectable distribution, keys/s and
    GB/s columns.
  - main.rs:36-45 (bench_sorts): SEVERAL engines timed on clones of the SAME
    data — `--engines comparator xla_rank` prints a side-by-side table.
  - main.rs:47-81 (bench_sorts_data) + main.rs:83-99 (gen_data): persist a
    dataset once (`--gen-data file.raw --n ...`), bench it repeatedly and
    bit-identically (`--data file.raw`).

Run:  python -m radix_sort_tpu.demo --sizes 0.5 1.0 --dtypes u32 u64 --runs 5
      python -m radix_sort_tpu.demo --gen-data /tmp/d.raw --n 1e8 --dist zipf
      python -m radix_sort_tpu.demo --data d.raw --engines comparator xla_rank
      python -m radix_sort_tpu.demo --suite queries --ops-n 1e7
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np

import jax
import jax.numpy as jnp

from radix_sort_tpu.sql import sql
from radix_sort_tpu.table import Table


def _parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument(
        "--sizes", type=float, nargs="+",
        default=[0.5, 1.0, 1.5, 2.0, 2.5, 3.0, 3.5, 4.0],
        help="data sizes in GB (element count = GB*1e9/rowbytes, main.rs:24)",
    )
    p.add_argument("--dtypes", nargs="+", default=["u32", "u64"],
                   choices=["u32", "u64"], help="key/payload word width")
    p.add_argument("--runs", type=int, default=5, help="runs per size (main.rs:102)")
    p.add_argument("--dist", default="uniform",
                   choices=["uniform", "zipf", "geometric", "step_uniform"])
    p.add_argument("--zipf-s", type=float, default=1.1)
    p.add_argument("--steps", type=int, default=1000,
                   help="distinct values for step_uniform")
    p.add_argument("--implementation", default=None,
                   help="single engine (legacy alias for --engines X)")
    p.add_argument("--engines", nargs="+", default=None,
                   help="engines timed side-by-side on clones of the same "
                        "data (main.rs:36-42), e.g. comparator xla_rank")
    p.add_argument("--data", default=None, metavar="FILE.raw",
                   help="bench keys from a persisted dataset "
                        "(utils.io.read_raw; main.rs:47-81)")
    p.add_argument("--gen-data", default=None, metavar="FILE.raw",
                   help="generate+persist a dataset, then exit (main.rs:83-99)")
    p.add_argument("--n", type=float, default=None,
                   help="element count for --gen-data")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--suite", default="sort",
                   choices=["sort", "ops", "queries"],
                   help="sort = the reference GB sweep (default); ops = "
                        "query-operator throughputs (window / rolling / "
                        "asof join / holistic aggregates / hash join) at "
                        "--ops-n rows; queries = end-to-end SQL analytics "
                        "(TPC-H-shaped Q1/Q3/window) through the planner")
    p.add_argument("--ops-n", type=float, default=float(1 << 24),
                   help="row count for --suite ops")
    p.add_argument("--groups", type=float, default=float(1 << 20),
                   help="group/partition count for --suite ops")
    return p.parse_args(argv)


def _gen_keys(key, n, dtype, args):
    from radix_sort_tpu.utils import distributions as D

    if args.dist == "uniform":
        return D.key_uniform(key, n, dtype)
    if args.dist == "zipf":
        return D.zipf(key, n, dtype, s=args.zipf_s)
    if args.dist == "geometric":
        return D.geometric(key, n, dtype=dtype)
    return D.step_uniform(key, n, args.steps, dtype)


def _gen_limbs(key, n, args):
    from radix_sort_tpu.utils import distributions as D

    if args.dist == "uniform":
        return D.key_uniform_limbs(key, n)
    if args.dist == "zipf":
        return D.zipf_limbs(key, n, s=args.zipf_s)
    if args.dist == "geometric":
        return D.geometric_limbs(key, n)
    return D.step_uniform_limbs(key, n, args.steps)


def _engine_fns(dt_name, engines, donate=False):
    """One jitted packed-rows -> packed-sorted closure per engine name.

    Rows travel as one stacked array each way. ``donate`` frees the packed
    input for the output (halves the peak memory of the large sweep
    points) — only safe when each buffer is sorted exactly once, i.e. a
    single engine."""
    from radix_sort_tpu.ops import pallas_sort
    import radix_sort_tpu as rst

    fns = {}
    for eng in engines:
        if dt_name == "u64":
            # u64 path: (hi, lo) u32 limb pairs end to end
            if eng not in pallas_sort.ENGINES:
                raise SystemExit(
                    f"u64 rows support {pallas_sort.ENGINES}, not {eng!r}")
            fns[eng] = jax.jit(
                lambda p, e=eng: jnp.stack(
                    pallas_sort.sort_pairs_limbs(*p, engine=e)
                ),
                donate_argnums=(0,) if donate else (),
            )
        else:
            fns[eng] = jax.jit(
                lambda p, e=eng: jnp.stack(
                    rst.sort_pairs(p[0], p[1], implementation=e)
                ),
                donate_argnums=(0,) if donate else (),
            )
    return fns


# ---- the queries workload (`--suite queries`, chip_smoke.py) -------------
#
# Nine SQL queries over Tables, each compiled by the SQL frontend onto the
# lazy planner and jitted whole, each with a numpy reference computed from
# the same seeded host arrays. The engine has no matrix product (no
# dot/matmul/einsum in the package), so TF32 never enters these results.

# float32 SUM/AVG against a float64 reference. The engine accumulates in
# float32, in another order than the reference. A group of 60M/8 rows sums
# past 2**31, where one float32 ulp is 256: each addend (~475) is rounded
# to a multiple of 256, a bias of up to ~0.6% (Q1's revenue reads 0.30% low
# on an H100). All values summed here are non-negative, so no cancellation
# widens it.
FLOAT32_SUM_RTOL = 1e-2


def make_query_data(n: int, seed: int = 0) -> dict:
    """Seeded host columns of the queries workload: a lineitem-shaped fact
    table of ``n`` rows, ``n // 16`` customers, 4 contact rows per
    customer and a 1,024-word string column over the fact rows."""
    from radix_sort_tpu.dates import parse_date

    rng = np.random.default_rng(seed)
    n_c = max(8, n // 16)
    n_w = 1024
    d_lo, d_hi = parse_date("2024-01-01"), parse_date("2027-01-01")
    return {
        "n": n,
        "n_c": n_c,
        "status": rng.integers(0, 8, n).astype(np.uint32),
        "qty": rng.integers(1, 51, n).astype(np.int32),
        "price": rng.random(n, dtype=np.float32) * np.float32(1000),
        "disc": rng.random(n, dtype=np.float32) * np.float32(0.1),
        "custkey": rng.integers(0, n_c, n).astype(np.uint32),
        "shipdate": rng.integers(d_lo, d_hi, n).astype(np.int32),
        "c_custkey": np.arange(n_c, dtype=np.uint32),
        "c_mktseg": rng.integers(0, 5, n_c).astype(np.uint32),
        "k_custkey": np.repeat(np.arange(n_c, dtype=np.uint32), 4),
        "k_region": rng.integers(0, 5, 4 * n_c).astype(np.uint32),
        "w": rng.integers(1, n_w, n).astype(np.uint32),
        "w_vocab": np.array([f"w{i:04d}" for i in range(n_w)]),
    }


def device_query_data(host: dict) -> dict:
    """The array columns of :func:`make_query_data`, on the device."""
    return {k: jnp.asarray(v) for k, v in host.items()
            if isinstance(v, np.ndarray) and v.dtype.kind != "U"}


@dataclasses.dataclass(frozen=True)
class Query:
    """One query of the workload.

    ``tables(dev, host)`` builds the SQL tables from device columns
    (``host`` supplies static host data such as dictionaries);
    ``options(host)`` the capacity knobs; ``reference(host)`` the expected
    result columns. ``check`` says how results compare:

      - ``"ordered"``: row for row (the query has ORDER BY on unique keys);
      - ``"rows"``: as a multiset of rows (no ORDER BY);
      - ``("top", key, value, k)``: ORDER BY value DESC LIMIT k — the
        values match the reference's k largest, and each returned key's
        reference value matches its returned value (ties may pick either
        key).

    Columns in ``rtol`` compare at that relative tolerance
    (:data:`FLOAT32_SUM_RTOL`); every other column compares exactly.
    """

    name: str
    text: str
    tables: object
    options: object
    reference: object
    check: object = "ordered"
    rtol: tuple = ()
    rows: int = 1  # input rows scanned per lineitem row


def _lineitem(dev, host, *names):
    cols = {"status": "status", "qty": "qty", "price": "price",
            "disc": "disc", "custkey": "custkey", "d": "shipdate"}
    return Table({k: dev[cols[k]] for k in names})


def _customers(dev, host):
    return Table({"custkey": dev["c_custkey"], "mktseg": dev["c_mktseg"]})


def _group_sum(keys, vals, size):
    return np.bincount(keys, weights=vals, minlength=size)


def _ref_q1(h):
    keep = h["qty"] < 45
    st = h["status"][keep].astype(np.int64)
    qty = h["qty"][keep].astype(np.int64)
    rev = h["price"][keep].astype(np.float64) * (
        1 - h["disc"][keep].astype(np.float64))
    n = np.bincount(st, minlength=8)
    sq = np.bincount(st, weights=qty, minlength=8)
    present = n > 0
    return {"status": np.arange(8)[present], "n": n[present],
            "sq": sq[present].astype(np.int64),
            "rev": _group_sum(st, rev, 8)[present],
            "aq": (sq / np.maximum(n, 1))[present]}


def _ref_q3(h):
    seg2 = h["c_mktseg"][h["custkey"]] == 2
    rev = _group_sum(h["custkey"][seg2], h["price"][seg2].astype(np.float64),
                     h["n_c"])
    present = np.bincount(h["custkey"][seg2], minlength=h["n_c"]) > 0
    keys = np.flatnonzero(present)
    return {"custkey": keys, "rev": rev[keys]}


def _ref_qwin(h):
    ck = h["custkey"].astype(np.int64)
    price = h["price"]
    # sort by (custkey asc, price desc): price is non-negative float32, so
    # its bit pattern orders like its value
    desc = np.uint64(0xFFFFFFFF) - price.view(np.uint32).astype(np.uint64)
    order = np.argsort((ck.astype(np.uint64) << np.uint64(32)) | desc,
                       kind="stable")
    sk, sp = ck[order], price[order]
    pos = np.arange(len(ck))
    new_part = np.r_[True, sk[1:] != sk[:-1]]
    new_val = new_part | np.r_[True, sp[1:] != sp[:-1]]
    part_start = np.maximum.accumulate(np.where(new_part, pos, 0))
    val_start = np.maximum.accumulate(np.where(new_val, pos, 0))
    rank = np.empty(len(ck), np.int64)
    rank[order] = val_start - part_start + 1
    tot = _group_sum(ck, price.astype(np.float64), h["n_c"])
    return {"custkey": h["custkey"], "price": price, "r": rank,
            "tot": tot[ck]}


def _ref_qsub(h):
    seg = h["c_mktseg"][h["custkey"]] < 2
    return {"custkey": h["custkey"][(h["qty"] > 40) & seg]}


def _ref_qdate(h):
    from radix_sort_tpu.dates import parse_date

    d = h["shipdate"]
    keep = (d >= parse_date("2025-01-01")) & (d < parse_date("2026-01-01"))
    days = d[keep].astype("datetime64[D]")
    mo = days.astype("datetime64[M]").astype("datetime64[D]").astype(np.int64)
    uniq, inv = np.unique(mo, return_inverse=True)
    return {"mo": uniq, "cnt": np.bincount(inv),
            "rev": np.bincount(inv, weights=h["price"][keep]
                               .astype(np.float64))}


def _ref_qrollup(h):
    st = h["status"].astype(np.int64)
    yr = h["shipdate"].astype("datetime64[D]").astype("datetime64[Y]")
    yr = yr.astype(np.int64)
    y0, n_y = yr.min(), yr.max() - yr.min() + 1
    qty = h["qty"].astype(np.int64)
    levels = [(st * n_y + (yr - y0), lambda g: g // n_y),  # (status, year)
              (st, lambda g: g),                           # (status)
              (np.zeros_like(st), lambda g: -1 + 0 * g)]   # () -> NULL
    status, cnt, s = [], [], []
    for gid, key_of in levels:
        c = np.bincount(gid)
        g = np.flatnonzero(c)
        status.append(key_of(g))
        cnt.append(c[g])
        s.append(np.bincount(gid, weights=qty)[g].astype(np.int64))
    status = np.concatenate(status)
    return {"status": np.ma.masked_equal(status, -1),
            "cnt": np.concatenate(cnt), "s": np.concatenate(s)}


def _ref_qunion(h):
    st = h["status"].astype(np.int64)
    sel = np.r_[st[h["qty"] < 10], st[h["qty"] >= 45]]
    n = np.bincount(sel, minlength=8)
    return {"status": np.flatnonzero(n), "n": n[n > 0]}


def _ref_qfan(h):
    # 4 contact rows per customer: every lineitem row joins 4 times
    ck = h["custkey"]
    rev = 4 * _group_sum(ck, h["price"].astype(np.float64), h["n_c"])
    cnt = 4 * np.bincount(ck, minlength=h["n_c"])
    keys = np.flatnonzero(cnt)
    return {"custkey": keys, "rev": rev[keys], "cnt": cnt[keys]}


def _ref_qstr(h):
    vocab = h["w_vocab"]
    ok = np.array([v.startswith("w0") and "1" in v for v in vocab])
    cnt = np.bincount(h["w"][ok[h["w"]]], minlength=len(vocab))
    codes = np.flatnonzero(cnt)
    return {"u": np.char.upper(vocab[codes]), "cnt": cnt[codes]}


QUERIES = (
    Query(
        "Q1 pricing summary (filter+group+4 aggs)",
        "SELECT status, COUNT(*) AS n, SUM(qty) AS sq, "
        "SUM(price * (1 - disc)) AS rev, AVG(qty) AS aq "
        "FROM l WHERE qty < 45 GROUP BY status ORDER BY status",
        lambda dev, h: {"l": _lineitem(dev, h, "status", "qty", "price",
                                       "disc")},
        lambda h: {"max_groups": 8},
        _ref_q1, rtol=("rev", "aq"),
    ),
    Query(
        "Q3 revenue top-10 (join+group+topk)",
        "SELECT custkey, SUM(price) AS rev FROM l "
        "JOIN c USING (custkey) WHERE mktseg = 2 "
        "GROUP BY custkey ORDER BY rev DESC LIMIT 10",
        lambda dev, h: {"l": _lineitem(dev, h, "custkey", "price"),
                        "c": _customers(dev, h)},
        lambda h: {"capacity": h["n"], "max_groups": h["n_c"]},
        _ref_q3, check=("top", "custkey", "rev", 10), rtol=("rev",),
    ),
    Query(
        "window rank + partition total over 1/16 parts",
        "SELECT custkey, price, "
        "RANK() OVER (PARTITION BY custkey ORDER BY price DESC) AS r, "
        "SUM(price) OVER (PARTITION BY custkey) AS tot FROM l",
        lambda dev, h: {"l": _lineitem(dev, h, "custkey", "price")},
        lambda h: {},
        _ref_qwin, rtol=("tot",),
    ),
    Query(
        "IN-subquery semi join (filter+semi)",
        "SELECT custkey FROM l WHERE qty > 40 AND custkey IN "
        "(SELECT custkey FROM c WHERE mktseg < 2)",
        lambda dev, h: {"l": _lineitem(dev, h, "custkey", "qty"),
                        "c": _customers(dev, h)},
        lambda h: {},
        _ref_qsub, check="rows",
    ),
    Query(
        "date filter + DATE_TRUNC month group",
        "SELECT DATE_TRUNC('month', d) AS mo, COUNT(*) AS cnt, "
        "SUM(price) AS rev FROM l "
        "WHERE d >= DATE '2025-01-01' AND d < DATE '2026-01-01' "
        "GROUP BY DATE_TRUNC('month', d) ORDER BY mo",
        lambda dev, h: {"l": _lineitem(dev, h, "d", "price")},
        lambda h: {"max_groups": 16},
        _ref_qdate, rtol=("rev",),
    ),
    Query(
        "ROLLUP(status, YEAR(d)) 3-level aggregate",
        "SELECT status, COUNT(*) AS cnt, SUM(qty) AS s FROM l "
        "GROUP BY ROLLUP(status, YEAR(d))",
        lambda dev, h: {"l": _lineitem(dev, h, "status", "qty", "d")},
        lambda h: {"max_groups": 64},
        _ref_qrollup, check="rows",
    ),
    Query(
        "UNION ALL of two filtered scans + group",
        "SELECT status, COUNT(*) AS n FROM "
        "(SELECT status FROM l WHERE qty < 10 "
        "UNION ALL SELECT status FROM l WHERE qty >= 45) "
        "GROUP BY status ORDER BY status",
        lambda dev, h: {"l": _lineitem(dev, h, "status", "qty")},
        lambda h: {"max_groups": 8},
        _ref_qunion, rows=2,
    ),
    # the inner join has fanout 4, so the naive plan materializes a 4n-row
    # join before grouping — the eager-aggregation rewrite
    # (plan._eager_join_aggregate) never expands (lookup join +
    # multiplicity scaling), exact at any fanout
    Query(
        "fanout-4 join + group (eager-agg rewrite)",
        "SELECT custkey, SUM(price) AS rev, COUNT(*) AS cnt FROM l "
        "JOIN c USING (custkey) GROUP BY custkey "
        "ORDER BY rev DESC LIMIT 10",
        lambda dev, h: {"l": _lineitem(dev, h, "custkey", "price"),
                        "c": Table({"custkey": dev["k_custkey"],
                                    "region": dev["k_region"]})},
        lambda h: {"capacity": 4 * h["n"], "max_groups": h["n_c"]},
        _ref_qfan, check=("top", "custkey", "rev", 10), rtol=("rev",),
    ),
    Query(
        "string fns: LIKE+CONTAINS filter, UPPER group",
        "SELECT UPPER(w) AS u, COUNT(*) AS cnt FROM l "
        "WHERE w LIKE 'w0%' AND CONTAINS(w, '1') "
        "GROUP BY UPPER(w) ORDER BY cnt DESC LIMIT 20",
        lambda dev, h: {"l": Table({"w": dev["w"], "qty": dev["qty"]},
                                   dictionaries={"w": h["w_vocab"]})},
        lambda h: {"max_groups": 2 * len(h["w_vocab"])},
        _ref_qstr, check=("top", "u", "cnt", 20),
    ),
)


def build_query(q: Query, host: dict):
    """``(run, dictionaries)``: ``run(dev)`` is the jitted query returning
    ``(columns, null_masks, count)``; ``dictionaries`` fills in, while
    ``run`` traces, with the host vocabularies of string result columns."""
    dictionaries = {}

    def run(dev):
        out = sql(q.text, q.tables(dev, host), **q.options(host)).collect()
        names = out.column_names
        for name in names:
            if out.is_string(name):
                dictionaries[name] = out.dictionary(name)
        count = out.count if out.count is not None else out.num_rows
        masks = {c: out.null_mask(c) for c in names if out.is_nullable(c)}
        return ({c: out[c] for c in names}, masks,
                jnp.asarray(count, jnp.int32))

    return jax.jit(run), dictionaries


def query_result_to_host(result, dictionaries) -> dict:
    """The valid rows of a :func:`build_query` result as host arrays:
    string columns decoded, nullable columns as masked arrays."""
    from radix_sort_tpu import strings

    cols, masks, count = result
    n = int(count)
    out = {}
    for name, col in cols.items():
        a = np.asarray(col[:n])
        if name in dictionaries:
            a = strings.decode(a, dictionaries[name])
        if name in masks:
            a = np.ma.MaskedArray(a, mask=np.asarray(masks[name][:n]))
        out[name] = a
    return out


def _close(name, got, want, q):
    if name in q.rtol:
        np.testing.assert_allclose(
            np.asarray(got, np.float64), np.asarray(want, np.float64),
            rtol=FLOAT32_SUM_RTOL, atol=0, err_msg=f"{q.name}: {name}")
    elif np.ma.isMaskedArray(got) or np.ma.isMaskedArray(want):
        got, want = np.ma.asarray(got), np.ma.asarray(want)
        np.testing.assert_array_equal(
            np.ma.getmaskarray(got), np.ma.getmaskarray(want),
            err_msg=f"{q.name}: {name} nulls")
        keep = ~np.ma.getmaskarray(got)
        np.testing.assert_array_equal(
            np.asarray(got.data)[keep].astype(np.int64),
            np.asarray(want.data)[keep].astype(np.int64),
            err_msg=f"{q.name}: {name}")
    elif np.asarray(want).dtype.kind == "U":
        np.testing.assert_array_equal(got, want, err_msg=f"{q.name}: {name}")
    else:
        np.testing.assert_array_equal(
            np.asarray(got), np.asarray(want).astype(np.asarray(got).dtype),
            err_msg=f"{q.name}: {name}")


def _row_order(cols: dict, names) -> np.ndarray:
    """A canonical row order over the exact columns (NULL sorts first)."""
    keys = []
    for name in reversed(list(names)):
        a = cols[name]
        if np.ma.isMaskedArray(a):
            keys.append(np.asarray(a.filled(0)))
            keys.append(~np.ma.getmaskarray(a))
        else:
            keys.append(np.asarray(a))
    return np.lexsort(keys)


def check_query(q: Query, got: dict, want: dict) -> None:
    """Assert that ``got`` (:func:`query_result_to_host`) is the reference
    result ``want`` under ``q.check`` and ``q.rtol``."""
    if set(got) != set(want):
        raise AssertionError(f"{q.name}: columns {sorted(got)} != "
                             f"{sorted(want)}")
    if isinstance(q.check, tuple):
        _, key, val, limit = q.check
        k = len(got[key])
        if k != min(limit, len(want[val])):
            raise AssertionError(f"{q.name}: {k} rows returned")
        order = np.argsort(-np.asarray(want[val], np.float64), kind="stable")
        top = order[:k]
        # the k values are the reference's k largest, in descending order
        _close(val, got[val], np.asarray(want[val])[top], q)
        # and each returned key carries its own reference value
        pos = {kk: i for i, kk in enumerate(np.asarray(want[key]).tolist())}
        missing = [kk for kk in np.asarray(got[key]).tolist() if kk not in pos]
        if missing:
            raise AssertionError(f"{q.name}: {key} {missing} not expected")
        idx = np.array([pos[kk] for kk in np.asarray(got[key]).tolist()])
        for name in got:
            if name != key:
                _close(name, got[name], np.asarray(want[name])[idx], q)
        if len(set(np.asarray(got[key]).tolist())) != k:
            raise AssertionError(f"{q.name}: duplicate {key} in top rows")
        return
    n_got = len(next(iter(got.values())))
    n_want = len(next(iter(want.values())))
    if n_got != n_want:
        raise AssertionError(f"{q.name}: {n_got} rows, want {n_want}")
    if q.check == "rows":
        exact = [c for c in got if c not in q.rtol]
        og, ow = _row_order(got, exact), _row_order(want, exact)
        got = {c: v[og] for c, v in got.items()}
        want = {c: v[ow] for c, v in want.items()}
    for name in got:
        _close(name, got[name], want[name], q)


def _queries_suite(args):
    """End-to-end SQL analytics throughput: :data:`QUERIES` over
    ``--ops-n`` lineitem rows."""
    n = int(args.ops_n)
    host = make_query_data(n, args.seed)
    dev = device_query_data(host)
    print(f"backend={jax.default_backend()} lineitem={n:,} "
          f"customers={host['n_c']:,} runs={args.runs}")
    for q in QUERIES:
        run, _ = build_query(q, host)
        jax.block_until_ready(run(dev))  # compile + warm
        ts = []
        for _ in range(args.runs):
            t0 = time.perf_counter()
            jax.block_until_ready(run(dev))
            ts.append(time.perf_counter() - t0)
        dt = float(np.mean(ts))
        rows = q.rows * n
        print(f"{q.name:45s} {dt*1e3:9.1f} ms   {rows/dt/1e6:8.1f} M rows/s")


def _ops_suite(args):
    """Query-operator throughput table (one packed buffer each way)."""
    import radix_sort_tpu as rst

    n = int(args.ops_n)
    g = max(1, int(args.groups))
    runs = args.runs
    rng = np.random.default_rng(args.seed)
    as_i32 = lambda a: jax.lax.bitcast_convert_type(a, jnp.int32)

    def timed(fn, packed):
        jax.block_until_ready(fn(packed))  # compile + warm
        ts = []
        for _ in range(runs):
            t0 = time.perf_counter()
            jax.block_until_ready(fn(packed))
            ts.append(time.perf_counter() - t0)
        return float(np.mean(ts))

    def report(name, rows, dt):
        print(f"{name:45s} {dt*1e3:9.1f} ms   {rows/dt/1e6:8.1f} M rows/s")

    print(f"backend={jax.default_backend()} n={n:,} groups={g:,} runs={runs}")

    k = rng.integers(0, g, n).astype(np.uint32)
    o = rng.integers(0, 1 << 31, n).astype(np.uint32)
    v = rng.integers(-1000, 1000, n).astype(np.int32)
    packed = jnp.asarray(np.stack([k, o, v.view(np.uint32)]))

    @jax.jit
    def win(x):
        outs = rst.window(
            ["rank", ("cumsum", as_i32(x[2])), ("sum", as_i32(x[2]))],
            partition_by=x[0], order_by=x[1],
        )
        return jnp.stack([o.astype(jnp.uint32) for o in outs])

    report("window rank+cumsum+sum", n, timed(win, packed))

    @jax.jit
    def win_roll(x):
        out = rst.window(("rolling_sum", as_i32(x[2]), 64, 32),
                         partition_by=x[0], order_by=x[1])
        return out.astype(jnp.uint32)[None]

    report("window rolling_sum(64,32)", n, timed(win_roll, packed))

    for agg in ("sum", "median", "mode", "argmax", "count_distinct", "var"):
        @jax.jit
        def hagg(x, agg=agg):
            uk, av, cnt = rst.hash_aggregate(x[0], as_i32(x[2]), agg)
            return jnp.stack([uk, av.astype(jnp.uint32)])

        report(f"hash_aggregate {agg}", n, timed(hagg, packed))

    m = n // 4
    lk = rng.integers(0, 1 << 31, m).astype(np.int32)
    rk = rng.integers(0, 1 << 31, m).astype(np.int32)
    rv = rng.integers(0, 1 << 31, m).astype(np.uint32)
    packed2 = jnp.asarray(np.stack([lk.view(np.uint32), rk.view(np.uint32),
                                    rv]))

    @jax.jit
    def asof(x):
        vals, matched, pos = rst.join_asof(
            as_i32(x[0]), as_i32(x[1]), x[2], direction="backward"
        )
        return jnp.stack(
            [vals, matched.astype(jnp.uint32), pos.astype(jnp.uint32)]
        )

    def _fmt(x):
        return f"{x/(1<<20):g}M" if x >= (1 << 20) else f"{x/1024:g}K"

    report(f"join_asof backward {_fmt(m)}x{_fmt(m)}", m, timed(asof, packed2))

    jk = rng.integers(0, max(m // 4, 1), m).astype(np.uint32)
    jk2 = rng.integers(0, max(m // 4, 1), m).astype(np.uint32)
    packed3 = jnp.asarray(np.stack([jk, jk2, rv]))
    cap = 8 * m

    @jax.jit
    def hj(x):
        _, jl, jr, cnt, ovf = rst.hash_join(
            x[0], x[2], x[1], x[2], capacity=cap, how="inner"
        )
        return jnp.stack([jl, jr])

    report(f"hash_join inner {_fmt(m)}x{_fmt(m)} (cap {_fmt(cap)})",
           m, timed(hj, packed3))


def main(argv=None):
    args = _parse_args(argv)
    from radix_sort_tpu.utils import io
    from radix_sort_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    if args.suite == "ops":
        _ops_suite(args)
        return
    if args.suite == "queries":
        _queries_suite(args)
        return

    if args.gen_data:
        if args.n is None:
            raise SystemExit("--gen-data needs --n")
        kw = {}
        if args.dist == "zipf":
            kw["s"] = args.zipf_s
        if args.dist == "step_uniform":
            kw["num_steps"] = args.steps
        dtype = np.uint64 if "u64" in args.dtypes and "u32" not in args.dtypes else np.uint32
        arr = io.gen_data(args.gen_data, int(args.n), dtype=dtype,
                          dist=args.dist, seed=args.seed, **kw)
        print(f"wrote {arr.size} {arr.dtype} keys ({arr.nbytes/1e9:.2f} GB) "
              f"to {args.gen_data} (dist={args.dist})")
        return

    engines = args.engines or ([args.implementation] if args.implementation else ["auto"])
    print(f"backend={jax.default_backend()} devices={jax.devices()} "
          f"engines={engines}")
    key = jax.random.PRNGKey(args.seed)

    if args.data:
        # bit-identical persisted dataset (bench_sorts_data, main.rs:47-81)
        host = io.read_raw(args.data)
        dt_name = {4: "u32", 8: "u64"}[host.dtype.itemsize]
        n = host.size
        donate = len(engines) == 1
        fns = _engine_fns(dt_name, engines, donate)

        def upload():
            if dt_name == "u64":
                hi = jnp.asarray((host >> np.uint64(32)).astype(np.uint32))
                lo = jnp.asarray(host.astype(np.uint32))
                z = jnp.zeros((n,), jnp.uint32)
                return jnp.stack([hi, lo, z, z])
            return jnp.stack(
                [jnp.asarray(host), jnp.zeros((n,), jnp.uint32)]
            )

        data = upload()
        gb = host.nbytes * 2 / 1e9  # key+payload rows
        for eng in engines:
            jax.block_until_ready(fns[eng](data))  # compile + warm
            times = []
            for _ in range(args.runs):
                if donate:
                    data = upload()  # the donated buffer was consumed
                t0 = time.perf_counter()
                jax.block_until_ready(fns[eng](data))
                times.append(time.perf_counter() - t0)
            mean = float(np.mean(times))
            print(f"Sorted {args.data} [{n} ({dt_name},{dt_name}) rows] "
                  f"with {eng}: {mean:.4f}s  ({n/mean/1e6:.1f}M keys/s, "
                  f"{gb/mean:.2f} GB/s)")
        return

    for dt_name in args.dtypes:
        rowbytes = {"u32": 8, "u64": 16}[dt_name]
        fns = _engine_fns(dt_name, engines, donate=len(engines) == 1)

        def make(key, n):
            if dt_name == "u64":
                hi, lo = _gen_limbs(key, n, args)
                z = jnp.zeros((n,), jnp.uint32)
                return jnp.stack([hi, lo, z, z])
            return jnp.stack(
                [_gen_keys(key, n, jnp.uint32, args),
                 jnp.zeros((n,), jnp.uint32)]
            )

        for gb in args.sizes:
            n = int(gb * 1e9 / rowbytes)
            key, sub = jax.random.split(key)
            warm = jax.block_until_ready(make(sub, n))
            for eng in engines:
                jax.block_until_ready(fns[eng](warm))  # compile + warm up
            times = {eng: [] for eng in engines}
            for _ in range(args.runs):
                key, sub = jax.random.split(key)
                data = jax.block_until_ready(make(sub, n))
                # every engine sorts THE SAME rows (clone semantics of
                # main.rs:36-42 — jax arrays are immutable, no copy needed)
                for eng in engines:
                    t0 = time.perf_counter()
                    jax.block_until_ready(fns[eng](data))
                    times[eng].append(time.perf_counter() - t0)
            for eng in engines:
                mean = float(np.mean(times[eng]))
                tag = f" [{eng}]" if len(engines) > 1 else ""
                print(
                    f"Sorted {gb}GB of ({dt_name},{dt_name}) data in: {mean:.4f}s"
                    f"  ({n/mean/1e6:.1f}M keys/s, {gb/mean:.2f} GB/s,"
                    f" dist={args.dist}){tag}"
                )


if __name__ == "__main__":
    main()
