"""The reference's tutorial query set, reproduced end-to-end.

These mirror /root/reference/test/guide/{primer,group_sort,join}.cc — the
"reference query set" whose outputs define the correctness bar.  Goldens are computed programmatically the same way the
guide tests do (std::map cross-check, primer.cc:302-313).
"""
import numpy as np
import pytest

from supersonic_jax import (AggSpec, Aggregation, AttributeAt, Compute,
                            DataType, ExtendedSort, GroupAggregate, HashJoin,
                            JoinType, KeyUniqueness, Projector, ScanTable,
                            Sort, Table, TupleSchema, col, execute)

SUM, MIN, MAX = Aggregation.SUM, Aggregation.MIN, Aggregation.MAX


def test_primer_addition():
    # primer.cc PrepareBoundExpression: Plus(AttributeAt(0), AttributeAt(1))
    schema = TupleSchema.of(("a", DataType.INT32, False),
                            ("b", DataType.INT32, False))
    a = [3, 4, 7, 10, -3]
    b = [5, 3, -2, -10, 0]
    t = Table.from_data(schema, {"a": a, "b": b})
    out = execute(Compute(AttributeAt(0) + AttributeAt(1), ScanTable(t)))
    assert [r[0] for r in out.to_pylist()] == [x + y for x, y in zip(a, b)]


def test_primer_grouped_sums():
    # primer.cc GroupedSums: GROUP BY key, SUM(data) AS data_sums
    schema = TupleSchema.of(("key", DataType.INT32, False),
                            ("data", DataType.DOUBLE, False))
    keys = [1, 2, 3, 1, 2, 3, 1, 2]
    data = [1.5, 3.0, 3.0, 7.6, 5.5, 2.0, 1.6, 9.5]
    expected = {}
    for k, d in zip(keys, data):
        expected[k] = expected.get(k, 0.0) + d
    t = Table.from_data(schema, {"key": keys, "data": data})
    out = execute(GroupAggregate(["key"], [AggSpec(SUM, "data", "data_sums")],
                                 ScanTable(t)))
    assert out.schema.names() == ("key", "data_sums")
    rows = out.to_pylist()
    assert len(rows) == 3
    for k, s in rows:
        assert s == pytest.approx(expected[k])


def _group_sort_data():
    names = ["John", "Darrel", "Greg", "Amanda", "Stacy"]
    ages = [20, 25, 32, 31, 33]
    salaries = [1800, 3300, 4800, 3500, 1900]
    depts = ["Accounting", "Sales", "Sales", "IT", "IT"]
    full_time = [False, True, False, True, False]
    return names, ages, salaries, depts, full_time


def test_group_sort_grouping():
    # group_sort.cc GroupingTest: GROUP BY (full_time AS "Works full time?",
    # department) -> MIN(salary), MAX(age)
    names, ages, salaries, depts, full_time = _group_sort_data()
    schema = TupleSchema.of(
        ("name", DataType.STRING, False), ("age", DataType.INT32, False),
        ("salary", DataType.INT32, False),
        ("department", DataType.STRING, False),
        ("full_time", DataType.BOOL, False))
    t = Table.from_data(schema, {
        "name": names, "age": ages, "salary": salaries,
        "department": depts, "full_time": full_time})
    out = execute(GroupAggregate(
        ["full_time", "department"],
        [AggSpec(MIN, "salary", "min_salary"),
         AggSpec(MAX, "age", "max_age")],
        ScanTable(t)))
    golden = {}
    for a, s, d, f in zip(ages, salaries, depts, full_time):
        k = (f, d)
        if k not in golden:
            golden[k] = [s, a]
        else:
            golden[k][0] = min(golden[k][0], s)
            golden[k][1] = max(golden[k][1], a)
    rows = out.to_pylist()
    assert len(rows) == len(golden)
    for f, d, mn, mx in rows:
        assert golden[(f, d)] == [mn, mx]


@pytest.mark.parametrize("row_count", [12, 300])
def test_group_sort_sorting(row_count):
    # group_sort.cc SortingTest: ORDER BY grade ASC over (id, grade)
    rng = np.random.default_rng(7)
    ids = rng.integers(0, 1000, row_count).astype(np.int32)
    grades = np.round(rng.random(row_count) * 5, 2)
    schema = TupleSchema.of(("id", DataType.INT32, False),
                            ("grade", DataType.DOUBLE, False))
    t = Table.from_data(schema, {"id": ids, "grade": grades})
    out = execute(Sort(["grade"], ScanTable(t)))
    got = out.to_pylist()
    assert [g for _, g in got] == sorted(grades.tolist())
    # multiset of pairs preserved
    assert sorted(got) == sorted(zip(ids.tolist(), grades.tolist()))


def test_join_books_authors():
    # join.cc HashJoinTest: books INNER JOIN authors (UNIQUE rhs) on
    # author_id_ref == author_id; project title, date_published,
    # name AS author_name, nobel.  NULL author refs never match.
    author_schema = TupleSchema.of(
        ("author_id", DataType.INT32, False),
        ("name", DataType.STRING, False),
        ("nobel", DataType.BOOL, False))
    book_schema = TupleSchema.of(
        ("book_id", DataType.INT32, False),
        ("author_id_ref", DataType.INT32, True),
        ("title", DataType.STRING, False),
        ("date_published", DataType.DATE, True))
    authors = Table.from_data(author_schema, {
        "author_id": [1, 2, 3],
        "name": ["Tolkien", "Lem", "Dick"],
        "nobel": [False, False, False]})
    books = Table.from_data(book_schema, {
        "book_id": [10, 11, 12, 13],
        "author_id_ref": [2, 1, None, 9],
        "title": ["Solaris", "The Hobbit", "Anonymous", "Orphan"],
        "date_published": [100, 200, None, 300]})
    out = execute(HashJoin(
        JoinType.INNER, ["author_id_ref"], ["author_id"],
        ScanTable(books), ScanTable(authors), KeyUniqueness.UNIQUE,
        lhs_projector=Projector.named("title", "date_published"),
        rhs_projector=Projector([("name", "author_name"), ("nobel", None)])))
    assert out.schema.names() == ("title", "date_published", "author_name",
                                  "nobel")
    assert out.to_pylist() == [
        ("Solaris", 100, "Lem", False),
        ("The Hobbit", 200, "Tolkien", False)]
