"""Hash join tests (reference analogue: cursor/core/hash_join_test.cc)."""
import pytest

from supersonic_jax import (DOUBLE, INT64, STRING, DataType, HashJoin, JoinType,
                            KeyUniqueness, Projector, ScanTable, Table,
                            TupleSchema, execute)


def sides():
    ls = TupleSchema.of(("fk", INT64), ("lv", DOUBLE))
    rs = TupleSchema.of(("pk", INT64), ("rv", STRING))
    lhs = Table.from_data(ls, {"fk": [1, 2, None, 4, 2],
                               "lv": [0.1, 0.2, 0.3, 0.4, 0.5]})
    rhs = Table.from_data(rs, {"pk": [2, 1, 3], "rv": ["two", "one", "three"]})
    return lhs, rhs


def test_inner_unique():
    lhs, rhs = sides()
    out = execute(HashJoin(JoinType.INNER, ["fk"], ["pk"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.UNIQUE))
    assert out.to_pylist() == [
        (1, 0.1, 1, "one"), (2, 0.2, 2, "two"), (2, 0.5, 2, "two")]


def test_left_outer_unique():
    lhs, rhs = sides()
    out = execute(HashJoin(JoinType.LEFT_OUTER, ["fk"], ["pk"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.UNIQUE))
    # NULL key and unmatched keys produce NULL rhs rows (hash_join.cc:801-806)
    assert out.to_pylist() == [
        (1, 0.1, 1, "one"), (2, 0.2, 2, "two"), (None, 0.3, None, None),
        (4, 0.4, None, None), (2, 0.5, 2, "two")]


def test_inner_multi():
    ls = TupleSchema.of(("k", INT64),)
    rs = TupleSchema.of(("k2", INT64), ("tag", INT64))
    lhs = Table.from_data(ls, {"k": [7, 8, 7]})
    rhs = Table.from_data(rs, {"k2": [7, 9, 7], "tag": [100, 200, 300]})
    out = execute(HashJoin(JoinType.INNER, ["k"], ["k2"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.NOT_UNIQUE))
    # matches per lhs row in rhs original order
    assert out.to_pylist() == [
        (7, 7, 100), (7, 7, 300), (7, 7, 100), (7, 7, 300)]


def test_left_outer_multi():
    ls = TupleSchema.of(("k", INT64),)
    rs = TupleSchema.of(("k2", INT64), ("tag", INT64))
    lhs = Table.from_data(ls, {"k": [5, 7]})
    rhs = Table.from_data(rs, {"k2": [7, 7], "tag": [1, 2]})
    out = execute(HashJoin(JoinType.LEFT_OUTER, ["k"], ["k2"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.NOT_UNIQUE, out_capacity=8))
    assert out.to_pylist() == [
        (5, None, None), (7, 7, 1), (7, 7, 2)]


def test_null_keys_never_match():
    ls = TupleSchema.of(("k", INT64),)
    rs = TupleSchema.of(("k2", INT64),)
    lhs = Table.from_data(ls, {"k": [None, 1]})
    rhs = Table.from_data(rs, {"k2": [None, 1]})
    out = execute(HashJoin(JoinType.INNER, ["k"], ["k2"],
                           ScanTable(lhs), ScanTable(rhs)))
    assert out.to_pylist() == [(1, 1)]


def test_string_key_join_different_dicts():
    ls = TupleSchema.of(("s", STRING), ("v", INT64))
    rs = TupleSchema.of(("s2", STRING), ("w", INT64))
    lhs = Table.from_data(ls, {"s": ["x", "y", "z"], "v": [1, 2, 3]})
    rhs = Table.from_data(rs, {"s2": ["y", "x"], "w": [20, 10]})
    out = execute(HashJoin(JoinType.INNER, ["s"], ["s2"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.UNIQUE))
    assert out.to_pylist() == [("x", 1, "x", 10), ("y", 2, "y", 20)]


def test_multi_key_join():
    ls = TupleSchema.of(("a", INT64), ("b", INT64))
    rs = TupleSchema.of(("a2", INT64), ("b2", INT64), ("w", INT64))
    lhs = Table.from_data(ls, {"a": [1, 1, 2], "b": [1, 2, 1]})
    rhs = Table.from_data(rs, {"a2": [1, 2], "b2": [2, 1], "w": [11, 21]})
    out = execute(HashJoin(JoinType.INNER, ["a", "b"], ["a2", "b2"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.UNIQUE))
    assert out.to_pylist() == [(1, 2, 1, 2, 11), (2, 1, 2, 1, 21)]


def test_projectors_select_columns():
    lhs, rhs = sides()
    out = execute(HashJoin(
        JoinType.INNER, ["fk"], ["pk"], ScanTable(lhs), ScanTable(rhs),
        KeyUniqueness.UNIQUE,
        lhs_projector=Projector.named("lv"),
        rhs_projector=Projector([("rv", "name")])))
    assert out.schema.names() == ("lv", "name")
    assert out.to_pylist() == [(0.1, "one"), (0.2, "two"), (0.5, "two")]


def test_empty_build_side():
    ls = TupleSchema.of(("k", INT64),)
    rs = TupleSchema.of(("k2", INT64),)
    lhs = Table.from_data(ls, {"k": [1, 2]})
    rhs = Table.from_data(rs, {"k2": []})
    out = execute(HashJoin(JoinType.LEFT_OUTER, ["k"], ["k2"],
                           ScanTable(lhs), ScanTable(rhs)))
    assert out.to_pylist() == [(1, None), (2, None)]


# ---------------------------------------------------------------------------
# Dense direct-address fast path (planner statistics; UNIQUE integer keys)
# ---------------------------------------------------------------------------

def _dense_tables():
    import numpy as np
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, True), ("x", DataType.DOUBLE)),
        {"fk": [5, 3, None, 99, 5, 7], "x": [1.0, 2.0, 3.0, 4.0, 5.0, 6.0]})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, True), ("y", DataType.INT64)),
        {"pk": [3, 5, 7, None], "y": [30, 50, 70, 0]})
    return lhs, rhs


@pytest.mark.parametrize("allow_dense", [True, False])
def test_unique_join_dense_vs_merge_paths(allow_dense):
    lhs, rhs = _dense_tables()
    for jt, want in [
        (JoinType.INNER,
         [(5, 1.0, 50), (3, 2.0, 30), (5, 5.0, 50), (7, 6.0, 70)]),
        (JoinType.LEFT_OUTER,
         [(5, 1.0, 50), (3, 2.0, 30), (None, 3.0, None), (99, 4.0, None),
          (5, 5.0, 50), (7, 6.0, 70)]),
    ]:
        out = execute(HashJoin(
            jt, ["fk"], ["pk"], ScanTable(lhs), ScanTable(rhs),
            KeyUniqueness.UNIQUE,
            lhs_projector=Projector.named("fk", "x"),
            rhs_projector=Projector.named("y"),
            allow_dense_lookup=allow_dense))
        assert out.to_pylist() == want


def test_dense_path_is_selected_and_guard_flags():
    import jax
    import numpy as np
    from supersonic_jax.ops.base import compile_plan

    lhs, rhs = _dense_tables()
    plan = HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(lhs),
                    ScanTable(rhs), KeyUniqueness.UNIQUE)
    run, bound, leaves = compile_plan(plan)
    out, flags = jax.jit(run)(leaves)
    assert not np.asarray(flags).any()
    # re-run the SAME compiled program with a build key far outside the
    # planned dense range -> the range-guard flag must trip
    from supersonic_jax.batch import Column
    import jax.numpy as jnp
    rt = leaves[1]
    newvals = jnp.asarray(np.array([3, 5, 1 << 22, 0], dtype=np.int32))
    bad = Table(rt.schema,
                {**rt.columns,
                 "pk": Column(newvals, rt.columns["pk"].valid)},
                rt.num_rows, rt.dicts)
    out2, flags2 = jax.jit(run)([leaves[0], bad])
    assert np.asarray(flags2).any()


def test_dense_path_duplicate_range_sparse_keys_fall_back():
    # build keys with a huge range must NOT use the dense LUT (stats budget)
    import numpy as np
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, False)),
        {"fk": np.array([0, 1 << 40, 7], dtype=np.int64)})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False)),
        {"pk": np.array([1 << 40, 7], dtype=np.int64)})
    out = execute(HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(lhs),
                           ScanTable(rhs), KeyUniqueness.UNIQUE))
    assert out.to_pylist() == [(1 << 40, 1 << 40), (7, 7)]


@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.LEFT_OUTER])
def test_not_unique_join_dense_csr_vs_merge_paths(jt):
    # randomized parity: the dense CSR probe (duplicate build keys in a
    # small integer range) must agree with the general merge probe
    import numpy as np
    rng = np.random.default_rng(7)
    ls = TupleSchema.of(("fk", DataType.INT32, True), ("x", INT64))
    rs = TupleSchema.of(("pk", DataType.INT32, True), ("y", INT64))
    fk = rng.integers(0, 40, size=200).astype(object)
    pk = rng.integers(0, 30, size=100).astype(object)
    fk[rng.random(200) < 0.1] = None
    pk[rng.random(100) < 0.1] = None
    lhs = Table.from_data(ls, {"fk": list(fk),
                               "x": list(range(200))})
    rhs = Table.from_data(rs, {"pk": list(pk),
                               "y": list(range(100))})
    outs = []
    for allow_dense in (True, False):
        out = execute(HashJoin(
            jt, ["fk"], ["pk"], ScanTable(lhs), ScanTable(rhs),
            KeyUniqueness.NOT_UNIQUE, out_capacity=4096,
            allow_dense_lookup=allow_dense))
        outs.append(out.to_pylist())
    assert outs[0] == outs[1]
    assert len(outs[0]) > 200  # duplicates actually expanded


def test_dense_csr_guard_flag_not_unique():
    import jax
    import numpy as np
    import jax.numpy as jnp
    from supersonic_jax.ops.base import compile_plan
    from supersonic_jax.batch import Column

    ls = TupleSchema.of(("fk", DataType.INT32, False))
    rs = TupleSchema.of(("pk", DataType.INT32, False))
    lhs = Table.from_data(ls, {"fk": [3, 5, 3]})
    rhs = Table.from_data(rs, {"pk": [3, 3, 5, 9]})
    plan = HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(lhs),
                    ScanTable(rhs), KeyUniqueness.NOT_UNIQUE,
                    out_capacity=16)
    run, bound, leaves = compile_plan(plan)
    out, flags = jax.jit(run)(leaves)
    assert not np.asarray(flags).any()
    # same compiled program, build key outside the planned dense range
    rt = leaves[1]
    newvals = jnp.asarray(np.array([3, 3, 1 << 22, 9], dtype=np.int32))
    bad = Table(rt.schema,
                {**rt.columns,
                 "pk": Column(newvals, rt.columns["pk"].valid)},
                rt.num_rows, rt.dicts)
    out2, flags2 = jax.jit(run)([leaves[0], bad])
    assert np.asarray(flags2).any()


@pytest.mark.parametrize("uniq", [KeyUniqueness.UNIQUE,
                                  KeyUniqueness.NOT_UNIQUE])
@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.LEFT_OUTER])
def test_string_key_dense_codes_vs_merge(jt, uniq):
    # dictionary codes are dense [0, len(dict)) -> string-key joins take
    # the LUT/CSR path; must agree with the merge probe
    import numpy as np
    rng = np.random.default_rng(11)
    words = [f"w{i:03d}" for i in range(40)]
    lhs_s = [words[i] for i in rng.integers(0, 40, 120)]
    rhs_idx = list(rng.permutation(40)[:25]) if uniq == KeyUniqueness.UNIQUE \
        else list(rng.integers(0, 30, 50))
    rhs_s = [words[i] for i in rhs_idx]
    ls = TupleSchema.of(("s", STRING), ("x", INT64))
    rs = TupleSchema.of(("s2", STRING), ("y", INT64))
    lhs = Table.from_data(ls, {"s": lhs_s, "x": list(range(120))})
    rhs = Table.from_data(rs, {"s2": rhs_s, "y": list(range(len(rhs_s)))})
    outs = []
    for allow_dense in (True, False):
        out = execute(HashJoin(jt, ["s"], ["s2"], ScanTable(lhs),
                               ScanTable(rhs), uniq, out_capacity=8192,
                               allow_dense_lookup=allow_dense))
        outs.append(out.to_pylist())
    assert outs[0] == outs[1]
    assert len(outs[0]) >= (120 if jt == JoinType.LEFT_OUTER else 1)


def test_enum_key_dense_join():
    from supersonic_jax import EnumDefinition
    ed = EnumDefinition(("red", "green", "blue"))
    ls = TupleSchema.of(("c", DataType.ENUM, True, ed), ("x", INT64))
    rs = TupleSchema.of(("c2", DataType.ENUM, True, ed), ("y", INT64))
    lhs = Table.from_data(ls, {"c": ["red", "blue", None, "green"],
                               "x": [1, 2, 3, 4]})
    rhs = Table.from_data(rs, {"c2": ["blue", "red"], "y": [30, 10]})
    out = execute(HashJoin(JoinType.LEFT_OUTER, ["c"], ["c2"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.UNIQUE,
                           lhs_projector=Projector.named("c", "x"),
                           rhs_projector=Projector.named("y")))
    assert out.to_pylist() == [("red", 1, 10), ("blue", 2, 30),
                               (None, 3, None), ("green", 4, None)]


@pytest.mark.parametrize("uniq", [KeyUniqueness.UNIQUE,
                                  KeyUniqueness.NOT_UNIQUE])
def test_multi_key_mixed_dense_vs_merge(uniq):
    # composite dense slot over (STRING dictionary codes x INT32 stats
    # range) must agree with the merge probe
    import numpy as np
    rng = np.random.default_rng(23)
    cities = ["ams", "ber", "cdg", "dub", "eze"]
    if uniq == KeyUniqueness.UNIQUE:
        pairs = [(c, d) for c in cities for d in range(7)]
        rng.shuffle(pairs)
        pairs = pairs[:20]
    else:
        pairs = [(cities[i], int(d)) for i, d in
                 zip(rng.integers(0, 5, 30), rng.integers(0, 7, 30))]
    ls = TupleSchema.of(("c", STRING), ("d", DataType.INT32), ("x", INT64))
    rs = TupleSchema.of(("c2", STRING), ("d2", DataType.INT32), ("y", INT64))
    lhs = Table.from_data(ls, {
        "c": [cities[i] for i in rng.integers(0, 5, 80)],
        "d": [int(v) for v in rng.integers(0, 9, 80)],
        "x": list(range(80))})
    rhs = Table.from_data(rs, {
        "c2": [p[0] for p in pairs],
        "d2": [p[1] for p in pairs],
        "y": list(range(len(pairs)))})
    outs = []
    for allow_dense in (True, False):
        out = execute(HashJoin(
            JoinType.LEFT_OUTER, ["c", "d"], ["c2", "d2"],
            ScanTable(lhs), ScanTable(rhs), uniq, out_capacity=2048,
            allow_dense_lookup=allow_dense))
        outs.append(out.to_pylist())
    assert outs[0] == outs[1]


def test_fat_lut_mixed_width_payload_lanes():
    # DOUBLE/INT64 rhs columns ride per-dtype LUT groups; BOOL widens to
    # a u32 lane; nullable DOUBLE carries a validity lane
    import numpy as np
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False)),
        {"fk": np.array([2, 0, 5, 9], dtype=np.int32)})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("d", DataType.DOUBLE, True),
                       ("i", DataType.INT64, False),
                       ("b", DataType.BOOL, False)),
        # reversed pk order defeats rowid-direct detection so the fat-LUT
        # path (not the direct-index probe) is what's under test here
        {"pk": np.arange(8, dtype=np.int32)[::-1].copy(),
         "d": [0.5, None, 2.5, 3.5, 4.5, 5.5, 6.5, 7.5][::-1],
         "i": (np.arange(8) * 10).astype(np.int64)[::-1].copy(),
         "b": ([True, False] * 4)[::-1]})
    out = execute(HashJoin(JoinType.LEFT_OUTER, ["fk"], ["pk"],
                           ScanTable(lhs), ScanTable(rhs),
                           KeyUniqueness.UNIQUE))
    assert out.to_pylist() == [
        (2, 2, 2.5, 20, True), (0, 0, 0.5, 0, True),
        (5, 5, 5.5, 50, False), (9, None, None, None, None)]


# --- rowid-direct probe (rhs key == row position + kmin) --------------------

def _rowid_tables(kmin=100):
    import numpy as np
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT64, True),
                       ("lv", DataType.DOUBLE, False)),
        {"fk": [kmin + 2, None, kmin - 1, kmin + 5, kmin + 9, kmin],
         "lv": [0.1, 0.2, 0.3, 0.4, 0.5, 0.6]})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("rv", DataType.INT32, False)),
        {"pk": np.arange(kmin, kmin + 6, dtype=np.int64),
         "rv": np.arange(6, dtype=np.int32) * 10})
    return lhs, rhs


def test_rowid_direct_selected():
    from supersonic_jax.ops.base import bind_plan
    lhs, rhs = _rowid_tables()
    bound, _ = bind_plan(ScanTable(rhs))
    assert "pk" in bound.rowid


@pytest.mark.parametrize("jt", [JoinType.INNER, JoinType.LEFT_OUTER])
def test_rowid_direct_matches_merge(jt):
    # kmin+9 is out of range, kmin-1 below range, None key never matches
    lhs, rhs = _rowid_tables()
    outs = []
    for allow_dense in (True, False):
        out = execute(HashJoin(jt, ["fk"], ["pk"], ScanTable(lhs),
                               ScanTable(rhs), KeyUniqueness.UNIQUE,
                               allow_dense_lookup=allow_dense))
        outs.append(out.to_pylist())
    assert outs[0] == outs[1]
    if jt == JoinType.INNER:
        assert outs[0] == [(102, 0.1, 102, 20), (105, 0.4, 105, 50),
                           (100, 0.6, 100, 0)]


def test_rowid_direct_guard_flags_on_rerun():
    import jax
    import numpy as np
    import jax.numpy as jnp
    from supersonic_jax.batch import Column
    from supersonic_jax.ops.base import compile_plan

    lhs, rhs = _rowid_tables()
    plan = HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(lhs),
                    ScanTable(rhs), KeyUniqueness.UNIQUE)
    run, bound, leaves = compile_plan(plan)
    out, flags = jax.jit(run)(leaves)
    assert not np.asarray(flags).any()
    # same compiled program, rhs keys no longer the row-id sequence ->
    # the rowid guard must trip
    rt = leaves[1]
    perm = jnp.asarray(np.array([101, 100, 102, 103, 104, 105],
                                dtype=np.int64))
    bad = Table(rt.schema,
                {**rt.columns, "pk": Column(perm, rt.columns["pk"].valid)},
                rt.num_rows, rt.dicts)
    _, flags2 = jax.jit(run)([leaves[0], bad])
    assert np.asarray(flags2).any()


def test_rowid_direct_under_group_aggregate():
    # masked bind: the rowid join's output feeds a dense group-by
    import numpy as np
    from supersonic_jax import (AggSpec, Aggregation, GroupAggregate,
                                GroupAggregateOptions)
    rng = np.random.default_rng(0)
    n, d = 5000, 64
    lhs = Table.from_data(
        TupleSchema.of(("fk", DataType.INT32, False),
                       ("v", DataType.DOUBLE, False)),
        {"fk": rng.integers(0, d, n).astype(np.int32),
         "v": rng.random(n)})
    rhs = Table.from_data(
        TupleSchema.of(("pk", DataType.INT32, False),
                       ("g", DataType.INT32, False)),
        {"pk": np.arange(d, dtype=np.int32),
         "g": rng.integers(0, 8, d).astype(np.int32)})
    plan = GroupAggregate(
        ["g"], [AggSpec(Aggregation.SUM, "v", "sv"),
                AggSpec(Aggregation.COUNT, None, "c")],
        HashJoin(JoinType.INNER, ["fk"], ["pk"], ScanTable(lhs),
                 ScanTable(rhs), KeyUniqueness.UNIQUE,
                 lhs_projector=Projector.named("v"),
                 rhs_projector=Projector.named("g")),
        GroupAggregateOptions(estimated_result_row_count=8))
    got = dict((r[0], (round(r[1], 6), r[2])) for r in
               execute(plan).to_pylist())
    g_of = np.asarray(rhs.columns["g"].values)[:d]
    fk = np.asarray(lhs.columns["v"].values)  # noqa: F841
    fkv = np.asarray(lhs.columns["fk"].values)[:n]
    vv = np.asarray(lhs.columns["v"].values)[:n]
    want = {}
    for k in range(8):
        m = g_of[fkv] == k
        if m.any():
            want[k] = (round(float(vv[m].sum()), 6), int(m.sum()))
    assert got == want
