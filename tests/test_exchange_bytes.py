"""Measured exchange-byte accounting: a scaling projection must rest on
numbers produced by code, not prose.  ``shuffle(..., stats_out=...)`` returns the [P, P] src->dst live-row
matrix actually exchanged; here it is checked against ground truth
computed on the host from the same data + destination function."""
import numpy as np
import pytest

import jax

from supersonic_jax import DataType, Table, TupleSchema
from supersonic_jax.parallel import dist as D


@pytest.fixture(scope="module")
def mesh():
    if len(jax.devices()) < 4:
        pytest.skip("needs a multi-device mesh")
    return D.make_mesh(4)


def _make(n=4000, seed=0):
    rng = np.random.default_rng(seed)
    return Table.from_data(
        TupleSchema.of(("k", DataType.INT32, False),
                       ("v", DataType.FLOAT, False)),
        {"k": rng.integers(0, 500, n).astype(np.int32),
         "v": rng.random(n, dtype=np.float32)})


def test_shuffle_sent_matrix_matches_ground_truth(mesh):
    t = _make()
    P_ = mesh.devices.size
    dist_t = D.distribute_table(t, mesh)
    stats = {}
    out = D.shuffle(mesh, dist_t, D._key_dest_fn(["k"], P_),
                    stats_out=stats)
    # ground truth: run the same dest function on each source shard's
    # live rows on the host
    counts = np.asarray(dist_t.num_rows)
    want = np.zeros((P_, P_), dtype=np.int64)
    for p in range(P_):
        np_rows = int(counts[p])
        local = Table.from_data(
            t.schema,
            {"k": np.asarray(dist_t.columns["k"].values)[p][:np_rows],
             "v": np.asarray(dist_t.columns["v"].values)[p][:np_rows]})
        dest = np.asarray(D._key_dest_fn(["k"], P_)(local))[:np_rows]
        for d in range(P_):
            want[p, d] = int((dest == d).sum())
    np.testing.assert_array_equal(stats["sent_rows"], want)
    # every live row is exchanged exactly once
    assert stats["sent_rows"].sum() == int(t.num_rows)
    # byte model: rows x row width (4B k + 4B v, non-nullable)
    assert stats["row_bytes"] == D.table_row_bytes(t.schema) == 8
    assert stats["total_bytes"] == int(t.num_rows) * 8
    offdiag = want.sum() - np.trace(want)
    assert stats["offmesh_bytes"] == offdiag * 8
    # the shuffle itself stays correct
    back = D.collect_table(out)
    assert sorted(back.to_pylist()) == sorted(t.to_pylist())


def test_offmesh_share_tracks_uniform_model(mesh):
    """Analytic model behind the exchange-bytes projection: a uniform
    key hash sends ~ (P-1)/P of live rows off-shard."""
    t = _make(n=20000, seed=3)
    P_ = mesh.devices.size
    dist_t = D.distribute_table(t, mesh)
    stats = {}
    D.shuffle(mesh, dist_t, D._key_dest_fn(["k"], P_), stats_out=stats)
    model = int(t.num_rows) * (P_ - 1) / P_ * stats["row_bytes"]
    assert abs(stats["offmesh_bytes"] - model) / model < 0.10
