"""The port's sequence-parallel attention against the JAX package's.

The same numpy q, k, v (``tests/test_ulysses.py::_qkv``'s shapes: batch
2, 4 heads, seq 32, head_dim 8) and cotangent go to
``adaptdl_tpu.parallel.{ulysses,ring_attention}`` under ``shard_map`` on
2 and 4 of the conftest's CPU devices, and to
``adaptdl_tpu_torch.parallel.{ulysses,ring_attention}`` at 2 and 4 gloo
processes of ``tests/torch_seq_worker.py`` (one launch each, started
together while the JAX references run). Causal and non-causal. The
forward agrees at atol 2e-5 (the reference's own bound,
``tests/test_ulysses.py``) and the q/k/v gradients of ``sum(out * cot)``
at atol 1e-4. Also: ulysses with the port's ``flash_attention`` inner
(its plain version on the CPU) equals the default inner at the same
bounds, ulysses with indivisible heads raises ``ValueError``, and the
process mesh's layout (data outermost).
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu.parallel.ring_attention import ring_attention as jax_ring
from adaptdl_tpu.parallel.ulysses import ulysses_attention as jax_ulysses
from adaptdl_tpu_torch import collective
from adaptdl_tpu_torch.parallel import mesh as pmesh
from tests import torch_zero_support as support
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

try:
    shard_map = jax.shard_map
except AttributeError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

SHARDS = (2, 4)
MODES = ("ulysses", "ring")
FWD_ATOL = 2e-5
GRAD_ATOL = 1e-4
WORKER = "tests/torch_seq_worker.py"


def _qkv(batch=2, heads=4, seq=32, dim=8, seed=0):
    rng = np.random.default_rng(seed)
    shape = (batch, heads, seq, dim)
    return {k: rng.normal(size=shape).astype(np.float32) for k in ("q", "k", "v", "cot")}


def _jax_reference(data, mode, shards, causal):
    fn = {"ulysses": jax_ulysses, "ring": jax_ring}[mode]
    mesh = jax_mesh({"seq": shards}, devices=jax.devices()[:shards])
    sharded = shard_map(
        lambda a, b, c: fn(a, b, c, axis_name="seq", causal=causal),
        mesh=mesh, in_specs=(P(None, None, "seq"),) * 3,
        out_specs=P(None, None, "seq"),
    )
    q, k, v, cot = (jnp.asarray(data[x]) for x in ("q", "k", "v", "cot"))
    out = jax.jit(sharded)(q, k, v)
    grads = jax.jit(jax.grad(
        lambda a, b, c: jnp.sum(sharded(a, b, c) * cot), argnums=(0, 1, 2)
    ))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("seq_attention")
    data = _qkv()
    plan = [
        {"kind": "attention", "name": f"{mode}-{causal}", "file": "qkv.npz",
         "mode": mode, "causal": causal}
        for mode in MODES + ("ulysses_flash",) for causal in (True, False)
    ] + [{"kind": "attention", "name": "indivisible", "heads": 3}]
    procs = {}
    for n in SHARDS:
        (out / str(n)).mkdir()
        np.savez(out / str(n) / "qkv.npz", **data)
        with open(out / str(n) / "plan.json", "w") as f:
            json.dump(plan, f)
        procs[n] = support.start_ranks(out / str(n), "plan", replicas=n, worker=WORKER)
    reference = {}
    try:
        for mode in MODES:
            for n in SHARDS:
                for causal in (True, False):
                    reference[(mode, n, causal)] = _jax_reference(data, mode, n, causal)
    finally:
        for proc in procs.values():
            support.finish(proc)
    port = {}
    for n in SHARDS:
        for task in plan:
            port[(task["name"], n)] = [
                torch.load(out / str(n) / f"{task['name']}-rank{r}.pt") for r in range(n)
            ]
    return {"jax": reference, "port": port}


def _gathered(ranks):
    """The ranks' sequence blocks (dim 2) joined: output and gradients."""
    out = torch.cat([r["out"] for r in ranks], 2).numpy()
    grads = [torch.cat([r["grads"][i] for r in ranks], 2).numpy() for i in range(3)]
    return out, grads


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("mode", MODES)
def test_attention_matches_jax(runs, mode, shards, causal):
    want_out, want_grads = runs["jax"][(mode, shards, causal)]
    got_out, got_grads = _gathered(runs["port"][(f"{mode}-{causal}", shards)])
    np.testing.assert_allclose(got_out, want_out, atol=FWD_ATOL, rtol=0)
    for got, want in zip(got_grads, want_grads):
        np.testing.assert_allclose(got, want, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("shards", SHARDS)
def test_ulysses_flash_inner_equals_default(runs, shards, causal):
    flash_out, flash_grads = _gathered(runs["port"][(f"ulysses_flash-{causal}", shards)])
    out, grads = _gathered(runs["port"][(f"ulysses-{causal}", shards)])
    np.testing.assert_allclose(flash_out, out, atol=FWD_ATOL, rtol=0)
    for a, b in zip(flash_grads, grads):
        np.testing.assert_allclose(a, b, atol=GRAD_ATOL, rtol=0)


@pytest.mark.parametrize("shards", SHARDS)
def test_ulysses_indivisible_heads_raise(runs, shards):
    for rank in runs["port"][("indivisible", shards)]:
        assert rank["error"] == (
            f"ulysses attention needs num_heads (3) divisible by seq shards "
            f"({shards}); use ring attention otherwise"
        )


def test_mesh_layout_is_data_outermost(monkeypatch):
    """Rank r of a dp x sp mesh sits at data r // sp, seq r % sp, as the
    JAX package's device order; each axis's rows are the ranks that
    differ only in that coordinate."""
    axes = {"data": 2, "seq": 2}
    assert pmesh._row_ranks(axes, "seq") == [[0, 1], [2, 3]]
    assert pmesh._row_ranks(axes, "data") == [[0, 2], [1, 3]]
    for rank in range(4):
        mesh = pmesh.ProcessMesh(axes, rank, {})
        assert (mesh.index("data"), mesh.index("seq")) == (rank // 2, rank % 2)
    assert pmesh.topology_axes(2, 2) == axes
    assert pmesh.topology_axes(4) == {"data": 4}
    # One process: a one-rank mesh, the exchanges are the identity.
    monkeypatch.delenv("ADAPTDL_NUM_PROCESSES", raising=False)
    mesh = pmesh.create_mesh({"data": 1, "seq": 1})
    assert pmesh.current_mesh() is mesh and pmesh.axis_size("seq") == 1
    x = torch.arange(8.0).reshape(2, 4)
    assert collective.all_to_all(x, None, 1, 0) is x
    assert collective.ppermute(x, None) is x
    # The stage axis is ported: a one-process stage mesh is built (its
    # hops are the identity); an unknown axis raises.
    mesh = pmesh.create_mesh({"data": 1, "stage": 1})
    assert mesh.axis_size("stage") == 1 and pmesh.axis_index("stage") == 0
    assert pmesh.topology_axes(1, 1, 1, 2) == {"data": 1, "stage": 2}
    with pytest.raises(ValueError, match="unknown mesh axes"):
        pmesh.create_mesh({"data": 1, "pipe": 2})
    pmesh._reset()
