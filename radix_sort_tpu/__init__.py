"""radix_sort_tpu — a sort-centred vectorized query-execution engine in JAX.

A from-scratch JAX/XLA framework with the capabilities of the
reference Rust crate jgrodzki/radix_sort (stable LSD radix sort over the
full numeric type matrix), extended per the north star with distributed
shuffle over device meshes and the query-operator set (filter, hash join,
hash aggregate). See SURVEY.md for the layer map this package mirrors.
"""

from radix_sort_tpu import config, keys, strings
from radix_sort_tpu.ops.sort import (
    sort,
    argsort,
    sort_pairs,
    sort_limbs,
    lexsort,
    top_k,
    sort_segments,
    sort128,
    argsort128,
    sort_pairs128,
    counting_sort,
    IMPLEMENTATIONS,
)
from radix_sort_tpu.ops.query import (
    filter,
    hash_aggregate,
    hash_aggregate_levels,
    hash_join,
    band_join,
    repeat,
    unique,
    searchsorted,
    AGGREGATIONS,
    BAND_OPS,
    COMBINABLE_AGGREGATIONS,
    JOIN_HOWS,
)
from radix_sort_tpu.ops.relational import (
    join_asof,
    set_union,
    set_intersect,
    set_difference,
    quantiles,
    ASOF_DIRECTIONS,
)
from radix_sort_tpu.ops.window import window, WINDOW_OPS
from radix_sort_tpu.expr import col, lit, udf, where, concat, coalesce, nullif, null
from radix_sort_tpu.sql import sql, SqlError
from radix_sort_tpu.table import Table

__version__ = "0.1.0"


def __getattr__(name):
    # lazy: DistTable pulls the whole parallel layer (shard_map machinery),
    # which plain single-chip users never pay for
    if name == "DistTable":
        from radix_sort_tpu.parallel.dist_table import DistTable

        return DistTable
    if name == "LazyTable":
        from radix_sort_tpu.plan import LazyTable

        return LazyTable
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__all__ = [
    "config",
    "keys",
    "strings",
    "sort",
    "argsort",
    "sort_pairs",
    "sort_limbs",
    "lexsort",
    "top_k",
    "sort_segments",
    "sort128",
    "argsort128",
    "sort_pairs128",
    "counting_sort",
    "filter",
    "hash_aggregate",
    "hash_aggregate_levels",
    "hash_join",
    "band_join",
    "BAND_OPS",
    "repeat",
    "unique",
    "searchsorted",
    "join_asof",
    "set_union",
    "set_intersect",
    "set_difference",
    "quantiles",
    "ASOF_DIRECTIONS",
    "window",
    "Table",
    "DistTable",
    "LazyTable",
    "col",
    "lit",
    "udf",
    "where",
    "concat",
    "coalesce",
    "nullif",
    "null",
    "sql",
    "SqlError",
    "WINDOW_OPS",
    "AGGREGATIONS",
    "COMBINABLE_AGGREGATIONS",
    "JOIN_HOWS",
    "IMPLEMENTATIONS",
    "__version__",
]
