"""The seq axis of the port's topology search against the JAX package's.

``goodput.mesh_shape_grid`` and ``GoodputFunction.optimize_topology``
take the same fitted parameters (with the seq terms priced) and chip
counts in both packages: the grids are equal and the searches return
equal configurations and goodputs (rtol 1e-12: the same numpy
expressions), at ``max_seq_shards`` 1, 2 and 4, with and without
accumulation. ``SpeedupFunction`` tables and configurations at
``max_seq_shards=2`` and under a seq-only ``mesh_shape_grid`` equal the
JAX package's, hysteresis included. The same holds with model and
expert limits (the JAX functions over a grid of sp, tp and ep limits),
and with stage limits, where the search also picks the pipeline M and,
for a job of ``pipeline_chunks`` chunks, the interleaved schedule.
"""

import numpy as np
import pytest

from adaptdl_tpu import goodput as jax_goodput
from adaptdl_tpu.sched.policy import speedup as jax_speedup
from adaptdl_tpu_torch import goodput as port_goodput
from adaptdl_tpu_torch.sched.policy import speedup as port_speedup

# Fitted parameters with the ring term (7, 8) priced, so that seq shards
# trade compute for communication.
PERF = (0.121, 0.00568, 0.0236, 0.00634, 0.0118, 0.00317, 1.14,
        0.004, 0.0002, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0)
GRAD = (0.00136, 0.000502)
PACKAGES = {"jax": (jax_goodput, jax_speedup), "port": (port_goodput, port_speedup)}
NODES = np.array([1, 1, 1, 1, 2, 2, 1])
CHIPS = np.array([1, 2, 4, 8, 4, 8, 6])


def _goodput_fn(pkg):
    goodput = PACKAGES[pkg][0]
    return goodput.GoodputFunction(
        goodput.PerfParams(*PERF), goodput.GradParams(*GRAD), 128
    )


@pytest.mark.parametrize("chips", [None, 4, 6, 8])
@pytest.mark.parametrize("max_sp", [1, 2, 4])
def test_mesh_shape_grid_matches_jax(max_sp, chips):
    kw = {"max_seq_shards": max_sp, "num_chips": chips}
    got = port_goodput.mesh_shape_grid(**kw)
    assert got == jax_goodput.mesh_shape_grid(**kw)
    assert got[0] == (1, 1, 1, 1)
    assert all(tp == ss == ep == 1 for _, tp, ss, ep in got)


@pytest.mark.parametrize("accumulation", [True, False])
@pytest.mark.parametrize("max_sp", [1, 2, 4])
def test_optimize_topology_matches_jax(max_sp, accumulation):
    kw = dict(
        max_batch_size=1280, atomic_bsz_range=(64, 256),
        accumulation=accumulation, max_seq_shards=max_sp,
    )
    got = _goodput_fn("port").optimize_topology(NODES, CHIPS, **kw)
    want = _goodput_fn("jax").optimize_topology(NODES, CHIPS, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)
    # Scalars come back as scalars, as in the JAX package.
    one = _goodput_fn("port").optimize_topology(1, 4, **kw)
    assert one == _goodput_fn("jax").optimize_topology(1, 4, **kw)
    if max_sp == 1:
        assert set(got[3].tolist()) == {1}


def _speedup_fn(pkg, **kw):
    kw = {"max_batch_size": 1280, "atomic_bsz_range": (64, 256),
          "accumulation": True, **kw}
    return PACKAGES[pkg][1].SpeedupFunction(_goodput_fn(pkg), **kw)


@pytest.mark.parametrize(
    "kw", [{"max_seq_shards": 2}, {"mesh_shape_grid": [(1, 1, 1, 1), (2, 1, 1, 1)]}],
)
def test_speedup_tables_with_seq_shards_match_jax(kw):
    fns = [_speedup_fn(pkg, **kw) for pkg in PACKAGES]
    tables = [fn(NODES, CHIPS) for fn in fns]
    np.testing.assert_allclose(tables[1], tables[0], rtol=1e-12, atol=0)
    assert fns[1].mesh_shape_grid == fns[0].mesh_shape_grid
    for n, c in zip(NODES.tolist(), CHIPS.tolist()):
        assert fns[1].best_config(n, c) == fns[0].best_config(n, c)
        for incumbent in (None, {"seqShards": 2}, {"seqShards": 1}):
            assert fns[1].best_config_with_hysteresis(
                n, c, incumbent
            ) == fns[0].best_config_with_hysteresis(n, c, incumbent)
    # The priced ring term lets sp 2 win somewhere in this table.
    assert any(fns[1].best_config(n, c)[2] == 2 for n, c in zip(NODES, CHIPS))


@pytest.mark.parametrize(
    "kw",
    [{"max_model_shards": 2}, {"max_stage_shards": 2}, {"max_expert_shards": 2},
     {"mesh_shape_grid": [(2, 1, 1, 1), (1, 1, 2, 1)]},
     {"mesh_shape_grid": [(1, 1, 1, 1), (2, 1, 1, 1), (1, 1, 2, 1)]},
     {"max_stage_shards": 4, "max_model_shards": 2, "pipeline_chunks": 12},
     {"max_stage_shards": 2, "max_pipeline_micro": 2}],
)
def test_model_stage_expert_limits_raise(kw):
    """Model, stage and expert limits, and stage shapes in the grid, give
    the JAX package's tables and configurations (a stage configuration
    carries the pipeline M the search picked). A grid without the
    one-chip shape has no base goodput: both packages divide by zero on
    the table. The name is kept from when stage limits raised."""
    fns = [_speedup_fn(pkg, max_seq_shards=2, **kw) for pkg in PACKAGES]
    if (1, 1, 1, 1) not in kw.get("mesh_shape_grid", [(1, 1, 1, 1)]):
        for fn in fns:
            assert fn._base_goodput == 0.0
            with pytest.raises(ZeroDivisionError):
                fn(NODES, CHIPS)
        return
    np.testing.assert_allclose(fns[1](NODES, CHIPS), fns[0](NODES, CHIPS), rtol=1e-12, atol=0)
    configs = [fns[1].best_config(n, c) for n, c in zip(NODES.tolist(), CHIPS.tolist())]
    assert configs == [fns[0].best_config(n, c) for n, c in zip(NODES.tolist(), CHIPS.tolist())]
    cap = kw.get("max_pipeline_micro", 8)
    assert all(micro <= cap for *_, micro in configs)
    if kw.get("max_stage_shards", 1) > 1 and cap == 8:
        # At M up to 8 a stage configuration wins somewhere.
        assert any(ss > 1 for _, _, _, _, ss, _, _ in configs)


# ---- the model and expert axes of the search ------------------------------


@pytest.mark.parametrize("chips", [None, 4, 8])
@pytest.mark.parametrize("limits", [(1, 2, 1), (2, 2, 2), (1, 4, 2), (2, 1, 4)])
def test_mesh_shape_grid_with_model_and_expert_matches_jax(limits, chips):
    sp, tp, ep = limits
    kw = {"max_seq_shards": sp, "max_model_shards": tp, "max_expert_shards": ep,
          "num_chips": chips}
    got = port_goodput.mesh_shape_grid(**kw)
    assert got == jax_goodput.mesh_shape_grid(**kw)
    assert all(ss == 1 for _, _, ss, _ in got)


@pytest.mark.parametrize("accumulation", [True, False])
@pytest.mark.parametrize("limits", [(1, 2, 1), (1, 1, 2), (2, 2, 2), (1, 4, 4)])
def test_optimize_topology_with_model_and_expert_matches_jax(limits, accumulation):
    sp, tp, ep = limits
    kw = dict(
        max_batch_size=1280, atomic_bsz_range=(64, 256), accumulation=accumulation,
        max_seq_shards=sp, max_model_shards=tp, max_expert_shards=ep,
    )
    got = _goodput_fn("port").optimize_topology(NODES, CHIPS, **kw)
    want = _goodput_fn("jax").optimize_topology(NODES, CHIPS, **kw)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-12, atol=0)
    for a, b in zip(got[1:], want[1:]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "kw",
    [{"max_model_shards": 4}, {"max_expert_shards": 4},
     {"max_model_shards": 2, "max_expert_shards": 2, "max_seq_shards": 2},
     {"mesh_shape_grid": [(1, 1, 1, 1), (1, 2, 1, 1), (1, 1, 1, 2), (2, 2, 1, 1)]}],
)
def test_speedup_tables_with_model_and_expert_shards_match_jax(kw):
    fns = [_speedup_fn(pkg, **kw) for pkg in PACKAGES]
    tables = [fn(NODES, CHIPS) for fn in fns]
    np.testing.assert_allclose(tables[1], tables[0], rtol=1e-12, atol=0)
    for n, c in zip(NODES.tolist(), CHIPS.tolist()):
        assert fns[1].best_config(n, c) == fns[0].best_config(n, c)
        for incumbent in (None, {"modelShards": 2}, {"expertShards": 2}):
            assert fns[1].best_config_with_hysteresis(
                n, c, incumbent
            ) == fns[0].best_config_with_hysteresis(n, c, incumbent)
