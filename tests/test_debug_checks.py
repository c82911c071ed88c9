"""DCHECK-style debug validation layer (reference: pervasive DCHECKs —
block.h:91-94, cursor.h:114-117).  `set_debug_checks(True)` validates
every operator output on device: num_rows within capacity, dictionary
codes in range on live valid rows.  Violations raise through the standard
error-flag host sync."""
import numpy as np
import pytest

from supersonic_jax import (AggSpec, Aggregation, Column, Const, DataType,
                            Equal, Filter, GroupAggregate, HashJoin,
                            JoinType, KeyUniqueness, ScanTable, Sort, Table,
                            TupleSchema, col, execute)
from supersonic_jax.exprs.base import EvaluationError
from supersonic_jax.ops import set_debug_checks


@pytest.fixture
def debug_on():
    set_debug_checks(True)
    yield
    set_debug_checks(False)


def test_clean_plans_pass_debug_checks(debug_on):
    rng = np.random.default_rng(3)
    n = 300
    t = Table.from_data(
        TupleSchema.of(("k", DataType.INT64, False),
                       ("v", DataType.INT64, True),
                       ("s", DataType.STRING, True)),
        {"k": rng.integers(0, 9, n),
         "v": [None if x < 0.1 else int(x * 50) for x in rng.random(n)],
         "s": [None if x < 0.1 else f"w{int(x*6)}" for x in rng.random(n)]})
    dim = Table.from_data(
        TupleSchema.of(("pk", DataType.INT64, False),
                       ("w", DataType.INT64, False)),
        {"pk": np.arange(9), "w": np.arange(9) * 7})
    plan = Sort(
        ["k"],
        GroupAggregate(
            ["k"], [AggSpec(Aggregation.SUM, "v", "sv"),
                    AggSpec(Aggregation.MAX, "s", "ms")],
            HashJoin(JoinType.INNER, ["k"], ["pk"],
                     Filter(col("v") > 5, ScanTable(t)), ScanTable(dim),
                     KeyUniqueness.UNIQUE)))
    out = execute(plan)  # passes: every node's invariants hold
    assert int(out.num_rows) <= 9


def test_corrupted_dictionary_code_raises(debug_on):
    t = Table.from_data(
        TupleSchema.of(("s", DataType.STRING, False)), {"s": ["x", "y"]})
    c = t.columns["s"]
    t.columns["s"] = Column(c.values + 99, c.valid)
    with pytest.raises(EvaluationError, match="dictionary code"):
        execute(Filter(Equal(col("s"), Const("x")), ScanTable(t)))


def test_checks_off_by_default():
    t = Table.from_data(
        TupleSchema.of(("s", DataType.STRING, False)), {"s": ["x", "y"]})
    c = t.columns["s"]
    t.columns["s"] = Column(c.values + 99, c.valid)
    # without debug checks the bad code passes silently through the
    # clipped gather (production behavior: no per-node validation cost)
    execute(Filter(Equal(col("s"), Const("x")), ScanTable(t)))
