"""SharedOperation / Spy / format_table / group_concat / regexp /
hashing-expression tests."""
import numpy as np

from supersonic_jax import (INT64, STRING, AggSpec, Aggregation, Coalesce,
                            Compute, Const, Fingerprint, Filter, Hash,
                            Project, Projector, RegexpExtract,
                            RegexpFullMatch, RegexpPartialMatch,
                            RegexpReplace, ScanTable, SharedOperation, Spy,
                            SpyListener, Table, TupleSchema, col, execute,
                            format_table, group_concat)


def make_table():
    schema = TupleSchema.of(("k", INT64), ("s", STRING))
    return Table.from_data(schema, {
        "k": [1, 2, 1, 2, 1], "s": ["ab1", "cd2", "ef3", None, "ab1"]})


def test_shared_operation():
    shared = SharedOperation(Filter(col("k") > 0, ScanTable(make_table())))
    left = Project(Projector([("k", "k1")]), shared)
    right = Project(Projector([("k", "k2")]), shared)
    out = execute(Coalesce(left, right))
    assert out.to_pylist()[0] == (1, 1)
    assert int(out.num_rows) == 5


def test_spy_reports_rows():
    seen = []

    class L(SpyListener):
        def on_result(self, name, num_rows):
            seen.append((name, num_rows))

    out = execute(Spy("filter", Filter(col("k") > 1, ScanTable(make_table())),
                      L()))
    assert int(out.num_rows) == 2
    assert seen == [("filter", 2)]


def test_format_table():
    text = format_table(execute(ScanTable(make_table())))
    assert "k" in text and "'ab1'" in text and "None" in text


def test_group_concat():
    out = group_concat(ScanTable(make_table()), ["k"], "s", "cs")
    assert out.to_pylist() == [(1, "ab1,ef3,ab1"), (2, "cd2")]
    out2 = group_concat(ScanTable(make_table()), ["k"], "s", "cs",
                        distinct=True)
    assert out2.to_pylist() == [(1, "ab1,ef3"), (2, "cd2")]


def eval_expr(expr, t=None):
    out = execute(Compute(expr, ScanTable(t or make_table())))
    return [r[0] for r in out.to_pylist()]


def test_regexp_partial_full():
    assert eval_expr(RegexpPartialMatch(col("s"), Const("[0-9]"))) == \
        [True, True, True, None, True]
    assert eval_expr(RegexpFullMatch(col("s"), Const("ab."))) == \
        [True, False, False, None, True]


def test_regexp_replace_extract():
    assert eval_expr(RegexpReplace(col("s"), Const("[0-9]"), Const("#"))) == \
        ["ab#", "cd#", "ef#", None, "ab#"]
    assert eval_expr(RegexpExtract(col("s"), Const("([a-z]+)"))) == \
        ["ab", "cd", "ef", None, "ab"]


def test_hash_fingerprint():
    h = eval_expr(Hash(col("k")))
    assert h[0] == h[2] == h[4] and h[0] != h[1]
    f = eval_expr(Fingerprint(col("k"), col("s")))
    assert f[0] == f[4]           # same (k, s) pair
    assert len({f[0], f[1], f[2]}) == 3


def test_group_concat_fast_matches_python():
    """The native device-sort + C++ assembly path of group_concat is
    differentially tested against the pure-Python fallback on random data
    with NULL keys, NULL values, numeric inputs and DISTINCT."""
    import numpy as np

    from supersonic_jax import DataType
    from supersonic_jax.ops import host as host_mod

    rng = np.random.default_rng(17)
    n = 500
    words = ["a", "bb", "ccc", "", "dd,d", "é"]
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, True),
                       ("k2", DataType.STRING, False),
                       ("s", DataType.STRING, True),
                       ("v", DataType.INT64, True)),
        {"k": [None if x < 0.1 else int(x * 5)
               for x in rng.random(n)],
         "k2": [words[i % 3] for i in range(n)],
         "s": [None if x < 0.2 else words[int(x * 6)]
               for x in rng.random(n)],
         "v": [None if x < 0.2 else int(x * 40)
               for x in rng.random(n)]})

    for input_col in ("s", "v"):
        for distinct in (False, True):
            for keys in (["k"], ["k", "k2"]):
                fast = host_mod._group_concat_fast(
                    t, keys, input_col, "cc", ",", distinct)
                assert fast is not None, "native library unavailable"
                # force the pure-python path by monkeypatching the guard
                orig = host_mod._group_concat_fast
                host_mod._group_concat_fast = lambda *a, **k: None
                try:
                    slow = group_concat(t, keys, input_col, "cc",
                                        distinct=distinct)
                finally:
                    host_mod._group_concat_fast = orig
                assert sorted(map(str, fast.to_pylist())) == \
                    sorted(map(str, slow.to_pylist())), \
                    (input_col, distinct, keys)
                # first-appearance group order must match exactly too
                assert fast.to_pylist() == slow.to_pylist(), \
                    (input_col, distinct, keys)
