"""External merge-sort tests (reference: sort.cc external path, tested by
sort_test.cc with tiny memory quotas to force spills)."""
import numpy as np
import pytest

from supersonic_jax import (DataType, ScanTable, Sort, SortKey, Table,
                            TupleSchema, execute)
from supersonic_jax.io.external import ExternalSorter, external_sort

SCHEMA = TupleSchema.of(("k", DataType.INT64, True),
                        ("s", DataType.STRING, True),
                        ("v", DataType.DOUBLE, False))


def make_tables(n_rows, n_tables, seed=3):
    rng = np.random.default_rng(seed)
    tables = []
    for ti in range(n_tables):
        k = [None if rng.random() < 0.05 else int(x)
             for x in rng.integers(0, 50, n_rows)]
        s = [None if rng.random() < 0.05 else f"s{int(x):02d}"
             for x in rng.integers(0, 20, n_rows)]
        v = rng.random(n_rows)
        tables.append(Table.from_data(
            SCHEMA, {"k": k, "s": s, "v": v}))
    return tables


ORDER = [SortKey("k", ascending=True), SortKey("s", ascending=False)]


def reference_sorted_rows(tables):
    big = {"k": [], "s": [], "v": []}
    for t in tables:
        cols = t.to_numpy()
        for n in big:
            big[n].extend(list(cols[n]))
    whole = Table.from_data(SCHEMA, big)
    return execute(Sort(ORDER, ScanTable(whole))).to_pylist()


def test_external_sort_spilling_matches_device_sort():
    tables = make_tables(n_rows=300, n_tables=5)
    # limit 400 rows -> multiple spilled runs + a final in-memory run
    got = external_sort(tables, ORDER, memory_limit_rows=400)
    want = reference_sorted_rows(tables)
    got_rows = got.to_pylist()
    # stability across runs is partition-order-defined; compare keys and
    # multisets of full rows
    assert [(r[0], r[1]) for r in got_rows] == [(r[0], r[1]) for r in want]
    assert sorted(map(repr, got_rows)) == sorted(map(repr, want))


def test_external_sort_single_run_no_spill():
    tables = make_tables(n_rows=50, n_tables=2)
    got = external_sort(tables, ORDER, memory_limit_rows=10_000)
    want = reference_sorted_rows(tables)
    assert [(r[0], r[1]) for r in got.to_pylist()] == \
        [(r[0], r[1]) for r in want]


def test_external_sorter_chunk_stream():
    tables = make_tables(n_rows=256, n_tables=4)
    with ExternalSorter(SCHEMA, ORDER, memory_limit_rows=300) as sorter:
        for t in tables:
            sorter.write(t)
        total = 0
        prev_key = None
        for chunk in sorter.result_chunks():
            rows = chunk.to_pylist()
            total += len(rows)
            for r in rows:
                key = (0, 0) if r[0] is None else (1, r[0])
                if prev_key is not None:
                    assert key >= prev_key
                prev_key = key
        assert total == 4 * 256


def test_external_sort_null_ordering():
    t = Table.from_data(SCHEMA, {
        "k": [3, None, 1, None, 2],
        "s": ["a", "b", None, "d", None],
        "v": [1.0, 2.0, 3.0, 4.0, 5.0]})
    got = external_sort([t], ORDER, memory_limit_rows=2)
    ks = [r[0] for r in got.to_pylist()]
    assert ks == [None, None, 1, 2, 3]  # NULL first ascending


def test_native_merge_matches_streaming_merge():
    # result() takes the native C++ k-way code merge; result_chunks() is
    # the streaming python heap — both must produce identical rows
    from supersonic_jax import native
    if not native.available():
        pytest.skip("native library unavailable")
    tables = make_tables(400, 5, seed=11)
    s1 = ExternalSorter(SCHEMA, ORDER, memory_limit_rows=300)
    s2 = ExternalSorter(SCHEMA, ORDER, memory_limit_rows=300)
    for t in tables:
        s1.write(t)
        s2.write(t)
    native_rows = s1.result().to_pylist()
    stream_rows = [r for c in s2.result_chunks() for r in c.to_pylist()]
    s1.close(); s2.close()
    assert native_rows == stream_rows
    assert native_rows == reference_sorted_rows(tables)


def test_native_merge_float_desc_and_uint64():
    from supersonic_jax import native
    if not native.available():
        pytest.skip("native library unavailable")
    schema = TupleSchema.of(("f", DataType.DOUBLE, True),
                            ("u", DataType.UINT64, False))
    rng = np.random.default_rng(5)
    tabs = []
    for _ in range(3):
        f = [None if rng.random() < 0.1 else float(x) - 0.5
             for x in rng.random(200)]
        # include -0.0 and huge uint64s
        f[0] = -0.0
        u = [int(x) + (1 << 63) if i % 3 == 0 else int(x)
             for i, x in enumerate(rng.integers(0, 1000, 200))]
        tabs.append(Table.from_data(schema, {"f": f, "u": u}))
    order = [SortKey("f", ascending=False), SortKey("u", ascending=True)]
    s = ExternalSorter(schema, order, memory_limit_rows=150)
    for t in tabs:
        s.write(t)
    got = s.result().to_pylist()
    s.close()
    big = {"f": [], "u": []}
    for t in tabs:
        cols = t.to_numpy()
        for n in big:
            big[n].extend(list(cols[n]))
    whole = Table.from_data(schema, big)
    want = execute(Sort(order, ScanTable(whole))).to_pylist()
    assert got == want


def test_sort_with_memory_limit_spills_and_matches():
    """reference: sort.h:89-98 — a memory_limit below the working set must
    degrade to the external (spill) path, never be silently ignored."""
    tables = make_tables(n_rows=400, n_tables=1, seed=11)
    t = tables[0]
    from supersonic_jax import SortWithTempDirPrefix

    want = execute(Sort(ORDER, ScanTable(t))).to_pylist()
    # ~400 rows x ~40 B/row working set >> 2 KB limit -> must spill
    got = execute(SortWithTempDirPrefix(
        ORDER, ScanTable(t), memory_limit=2048,
        temporary_directory_prefix="/tmp"))
    got_rows = got.to_pylist()
    assert [(r[0], r[1]) for r in got_rows] == [(r[0], r[1]) for r in want]
    assert sorted(map(repr, got_rows)) == sorted(map(repr, want))


def test_sort_with_ample_memory_limit_stays_on_device():
    tables = make_tables(n_rows=100, n_tables=1, seed=12)
    t = tables[0]
    from supersonic_jax import SortWithTempDirPrefix
    from supersonic_jax.ops.base import BindContext

    op = SortWithTempDirPrefix(ORDER, ScanTable(t), memory_limit=1 << 30)
    ctx = BindContext()
    op.bind(ctx)
    # device path: exactly the child's one leaf, no host-sorted rescan leaf
    assert len(ctx.leaves) == 1 and ctx.leaves[0] is t
    want = execute(Sort(ORDER, ScanTable(t))).to_pylist()
    got = execute(op).to_pylist()
    assert got == want
