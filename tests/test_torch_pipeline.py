"""The port's pipeline schedules (``parallel/pipeline.py``) and pipelined
LM (``models/pipeline_lm.py``) against the JAX package, and the stage
axis of the hints, the speedups and the loader's decisions.

- ``gpipe`` and ``interleaved_pipeline`` at two gloo ranks of
  ``tests/torch_pipeline_worker.py`` (a stage group of two), each chunk
  ``relu(x @ w + b)`` on numpy inputs from one seed, against the JAX
  functions in ``shard_map`` on a two-device CPU mesh (``_pcast`` bound to
  a keyword call, ``tests/torch_zero_support.py::bind_pcast``): the
  outputs the last stage shares, and the gradients of ``sum(out * cot)``
  with respect to every chunk and to the inputs (the ranks' shares
  summed, as the JAX gradient of a replicated input is). GPipe at M 3,
  the interleaved schedule at v 2 and M 2 (= S) and 3 (> S: the wrap hop
  lands early and waits in the buffer); and the same through
  ``gpipe_loss`` / ``interleaved_loss`` (head ``sum(final * cot)``, the
  other stages' outputs replaced by ones) against the JAX losses. Outputs
  rtol 1e-5, atol 1e-6 of the largest entry; losses rtol 1e-5;
  gradients rtol 1e-4, atol 1e-6 of the largest entry.
- The pipelined LM (4 layers, d 32, 2 heads, seq 16, float32, per-block
  remat on in the port) from the JAX ``init_pipeline_lm`` weights
  (``weights.flax_pipeline_to_rank_state_dict``), GPipe and interleaved
  (v 2) at M 2: the loss and every parameter's gradient against
  ``jax.value_and_grad`` of the JAX loss in ``shard_map``; the
  replicated leaves' gradients are partial on each stage (the input
  path on the first, the head on the last) and their sum is the JAX
  gradient. Loss rtol 1e-5, gradients rtol 1e-4 and atol 1e-6 of their
  largest entry.
- The weights: a stage's state dict is its layers of the dense LM's, the
  port's ``init_pipeline_lm`` draws the dense ``init_transformer``'s
  weights for a seed, and ``stack_interleaved_params`` stacks as the JAX
  function does.
- The hints (``maxStageShards``, ``maxPipelineMicro``,
  ``pipelineMicrobatches``, ``pipelineChunks``), the LM example's
  speedups and the loader's batch-size decisions with a stage axis equal
  the JAX package's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from adaptdl_tpu import data as jdata
from adaptdl_tpu import goodput as jax_goodput
from adaptdl_tpu import metrics as jmetrics
from adaptdl_tpu import sched_hints as jhints
from adaptdl_tpu.models import TransformerConfig as JaxConfig
from adaptdl_tpu.models.pipeline_lm import init_pipeline_lm as jax_init_pipeline_lm
from adaptdl_tpu.models.pipeline_lm import pipeline_lm_sharding_fn
from adaptdl_tpu.parallel import create_mesh as jax_mesh
from adaptdl_tpu.parallel import pipeline as jax_pipeline
from adaptdl_tpu.sched.policy import speedup as jax_speedup
from adaptdl_tpu_torch import checkpoint, data, metrics, sched_hints
from adaptdl_tpu_torch import goodput as port_goodput
from adaptdl_tpu_torch.examples import transformer_lm as example
from adaptdl_tpu_torch.goodput import GoodputFunction, GradParams, PerfParams
from adaptdl_tpu_torch.models import TransformerConfig, init_pipeline_lm, init_transformer
from adaptdl_tpu_torch.models.pipeline_lm import PipelineLM, stage_layers
from adaptdl_tpu_torch.parallel import mesh as pmesh
from adaptdl_tpu_torch.parallel import pipeline
from adaptdl_tpu_torch.sched.policy import speedup as port_speedup
from adaptdl_tpu_torch.weights import (
    flax_pipeline_to_rank_state_dict, flax_pipeline_to_state_dict,
)
from tests import torch_zero_support as support
from tests.torch_pipeline_worker import LM_SIZES
from tests.torch_support import one_torch_thread, private_tempdir  # noqa: F401

shard_map = jax.shard_map
WORKER = "tests/torch_pipeline_worker.py"
D, STAGES = 8, 2
SCHEDULES = {"gpipe-m3": (1, 3), "interleaved-m2": (2, 2), "interleaved-m3": (2, 3)}
LM_MICRO = 2
OUT_RTOL, OUT_ATOL = 1e-5, 1e-6
LOSS_RTOL = 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def jax_lm_config():
    return JaxConfig(**LM_SIZES, max_seq_len=16, dtype=jnp.float32, remat=False)


def _jax_schedule(data_, v, num_micro):
    """The JAX schedule's shared outputs and gradients of sum(out * cot)."""
    chunks = [{"w": jnp.asarray(data_["w"][g]), "b": jnp.asarray(data_["b"][g])}
              for g in range(STAGES * v)]
    if v > 1:
        stacked = jax_pipeline.stack_interleaved_params(chunks, STAGES)
    else:
        stacked = jax_pipeline.stack_stage_params(chunks)

    def chunk_fn(p, h):
        return jax.nn.relu(h @ p["w"] + p["b"])

    def total(params, x):
        local = jax.tree.map(lambda leaf: leaf[0], params)
        if v > 1:
            outs = jax_pipeline.interleaved_pipeline(chunk_fn, local, x)
        else:
            outs = jax_pipeline.gpipe(chunk_fn, local, x)
        stage = jax.lax.axis_index("stage")
        shared = jax.lax.psum(jnp.where(stage == STAGES - 1, outs, 0.0), "stage")
        return (shared * data_["cot"]).sum(), shared

    def head(final, batch):
        return (final * batch["cot"]).sum()

    if v > 1:
        loss_fn = jax_pipeline.interleaved_loss(chunk_fn, head, num_micro)
    else:
        loss_fn = jax_pipeline.gpipe_loss(
            lambda p, h: chunk_fn(jax.tree.map(lambda leaf: leaf[0], p), h), head, num_micro
        )

    def both(params, x, batch):
        return (jax.value_and_grad(total, argnums=(0, 1), has_aux=True)(params, x),
                jax.value_and_grad(loss_fn, argnums=(0, 1))(params, batch, None))

    specs = jax.tree.map(lambda _: P("stage"), stacked)
    run = jax.jit(shard_map(
        both, mesh=jax_mesh({"stage": STAGES}, devices=jax.devices()[:STAGES]),
        in_specs=(specs, P(), P()),
        out_specs=(((P(), P()), (specs, P())), (P(), (specs, P()))),
    ))
    rows = {k: jnp.asarray(data_[k].reshape(-1, D)) for k in ("x", "cot")}
    ((_, out), (grads, gx)), (loss, (loss_grads, loss_gx)) = run(
        stacked, jnp.asarray(data_["x"]), rows
    )

    def per_stage(leaf):
        leaf = np.asarray(leaf)
        return leaf[:, None] if v == 1 else leaf

    return {"out": np.asarray(out), "w": per_stage(grads["w"]), "b": per_stage(grads["b"]),
            "x": np.asarray(gx), "loss": float(loss), "loss_w": per_stage(loss_grads["w"]),
            "loss_b": per_stage(loss_grads["b"]),
            "loss_x": np.asarray(loss_gx["x"]).reshape(data_["x"].shape)}


def _jax_lm_grads(params, tokens, interleave):
    loss_fn, _ = jax_init_pipeline_lm(
        jax_lm_config(), STAGES, LM_MICRO, interleave, seq_len=16
    )
    specs = jax.tree_util.tree_map_with_path(pipeline_lm_sharding_fn, params)
    run = jax.jit(shard_map(
        lambda p, b: jax.value_and_grad(loss_fn)(p, b, None),
        mesh=jax_mesh({"stage": STAGES}, devices=jax.devices()[:STAGES]),
        in_specs=(specs, P()), out_specs=(P(), specs),
    ))
    loss, grads = run(params, {"tokens": jnp.asarray(tokens)})
    return float(loss), flax_pipeline_to_state_dict(
        jax.tree.map(np.asarray, grads), STAGES, interleave
    )


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    inputs = {}
    for name, (v, num_micro) in SCHEDULES.items():
        inputs[name] = {
            "w": (rng.normal(size=(STAGES * v, D, D)) * 0.5).astype(np.float32),
            "b": (rng.normal(size=(STAGES * v, D)) * 0.1).astype(np.float32),
            "x": rng.normal(size=(num_micro, 4, D)).astype(np.float32),
            "cot": rng.normal(size=(num_micro, 4, D)).astype(np.float32),
        }
        np.savez(out / f"{name}.npz", **inputs[name])
    tokens = rng.integers(0, 64, size=(1, 4, 17), dtype=np.int64)
    np.savez(out / "lm.npz", tokens=tokens)
    lm_params = {}
    for interleave in (1, 2):
        _, params = jax_init_pipeline_lm(
            jax_lm_config(), STAGES, LM_MICRO, interleave, seq_len=16
        )
        lm_params[interleave] = jax.device_get(params)
        for stage in range(STAGES):
            torch.save(
                flax_pipeline_to_rank_state_dict(lm_params[interleave], STAGES, interleave, stage),
                out / f"lm-v{interleave}-stage{stage}.pt",
            )
    plan = [
        {"kind": "schedule", "name": name, "axes": {"data": 1, "stage": STAGES},
         "file": f"{name}.npz", "interleave": v}
        for name, (v, _) in SCHEDULES.items()
    ] + [
        {"kind": "lm", "name": f"lm-v{interleave}", "axes": {"data": 1, "stage": STAGES},
         "micro": LM_MICRO, "interleave": interleave, "batches": "lm.npz",
         "weights": f"lm-v{interleave}-stage{{stage}}.pt"}
        for interleave in (1, 2)
    ]
    with open(out / "plan.json", "w") as f:
        json.dump(plan, f)
    proc = support.start_ranks(out, "plan", replicas=STAGES, worker=WORKER)
    patch = support.bind_pcast()
    try:
        reference = {
            name: _jax_schedule(inputs[name], v, m) for name, (v, m) in SCHEDULES.items()
        }
        for interleave in (1, 2):
            reference[f"lm-v{interleave}"] = _jax_lm_grads(
                lm_params[interleave], tokens[0], interleave
            )
    finally:
        patch.undo()
        support.finish(proc)
    port = {
        task["name"]: [torch.load(out / f"{task['name']}-rank{r}.pt") for r in range(STAGES)]
        for task in plan
    }
    return {"jax": reference, "port": port, "lm_params": lm_params}


def _close(got, want, rtol, atol_scale, msg):
    want = np.asarray(want)
    np.testing.assert_allclose(
        np.asarray(got), want, rtol=rtol,
        atol=atol_scale * float(np.abs(want).max()), err_msg=msg,
    )


@pytest.mark.parametrize("name", list(SCHEDULES))
def test_schedules_match_jax(runs, name):
    ranks, want = runs["port"][name], runs["jax"][name]
    v = SCHEDULES[name][0]
    for rank in ranks:
        _close(rank["out"], want["out"], OUT_RTOL, OUT_ATOL, "out")
    # Stage d holds global chunks k * S + d: its gradients are JAX's
    # [d, k] (the [S, v, ...] stacking).
    for d, rank in enumerate(ranks):
        for key in ("w", "b"):
            assert rank[key].shape[0] == v
            _close(rank[key], want[key][d], GRAD_RTOL, GRAD_ATOL, (key, d))
    # Only stage 0 reads the inputs; the shares sum to the JAX gradient.
    _close(sum(r["x"] for r in ranks), want["x"], GRAD_RTOL, GRAD_ATOL, "x")
    assert not ranks[1]["x"].any()
    # gpipe_loss / interleaved_loss: the loss on every rank, the same
    # gradients through the trainer-style loss.
    for d, rank in enumerate(ranks):
        np.testing.assert_allclose(float(rank["loss"]), want["loss"], rtol=LOSS_RTOL)
        for key in ("loss_w", "loss_b"):
            _close(rank[key], want[key][d], GRAD_RTOL, GRAD_ATOL, (key, d))
    _close(sum(r["loss_x"] for r in ranks), want["loss_x"], GRAD_RTOL, GRAD_ATOL, "loss_x")


@pytest.mark.parametrize("interleave", [1, 2])
def test_pipeline_lm_loss_and_grads_match_jax(runs, interleave):
    ranks = runs["port"][f"lm-v{interleave}"]
    loss, want = runs["jax"][f"lm-v{interleave}"]
    for rank in ranks:
        np.testing.assert_allclose(float(rank["loss"]), loss, rtol=LOSS_RTOL)
    got = {}
    for stage, rank in enumerate(ranks):
        mine = {f"layers.{l}." for l in stage_layers(4, STAGES, interleave, stage)}
        for name, g in rank["grads"].items():
            if name.startswith("layers."):
                assert name[: name.index(".", 7) + 1] in mine, name
                got[name] = g
            else:
                got[name] = got.get(name, 0) + g
    assert set(got) == set(want)
    for name, value in want.items():
        _close(got[name].numpy(), value.numpy(), GRAD_RTOL, GRAD_ATOL, name)
    # Partial gradients of the replicated leaves: the lookup's on the
    # first stage, the head's and ln_f's on the last.
    first, last = (r["grads"] for r in ranks)
    assert not first["ln_f.scale"].any() and last["ln_f.scale"].any()
    assert first["embed.weight"].any() and last["embed.weight"].any()


def test_stage_weights_are_the_dense_lms(runs):
    config = TransformerConfig(**LM_SIZES, dtype=torch.float32)
    dense = {}
    for interleave, params in runs["lm_params"].items():
        dense[interleave] = flax_pipeline_to_state_dict(params, STAGES, interleave)
        for stage in range(STAGES):
            part = flax_pipeline_to_rank_state_dict(params, STAGES, interleave, stage)
            assert set(part) <= set(dense[interleave])
            for name, value in part.items():
                assert torch.equal(value, dense[interleave][name]), name
    # The JAX init draws per global layer: one logical model either way.
    for name, value in dense[1].items():
        assert torch.equal(value, dense[2][name]), name
    # The port's init gives each stage the dense init's tensors (each
    # stage's rank stood for by a mesh whose groups it never reaches).
    pmesh._reset()
    full = init_transformer(config, seed=3, device="cpu").state_dict()
    for interleave in (1, 2):
        for stage in range(STAGES):
            pmesh._current = pmesh.ProcessMesh({"data": 1, "stage": STAGES}, stage, {})
            try:
                _, model = init_pipeline_lm(config, STAGES, 2, interleave, seed=3,
                                            device="cpu")
            finally:
                pmesh._reset()
            layers = stage_layers(4, STAGES, interleave, stage)
            assert [int(k) for k in model.layers] == layers
            for name, value in model.state_dict().items():
                assert torch.equal(value, full[name]), name
            assert model.dense_names() == list(full)
            assert model.peer_name(f"layers.{layers[0]}.ln1.scale", 1 - stage) == (
                f"layers.{stage_layers(4, STAGES, interleave, 1 - stage)[0]}.ln1.scale"
            )


def test_stack_interleaved_params_matches_jax():
    rng = np.random.default_rng(1)
    chunks = [{"w": rng.normal(size=(3, 2)).astype(np.float32)} for _ in range(6)]
    want = np.asarray(jax_pipeline.stack_interleaved_params(
        [{"w": jnp.asarray(c["w"])} for c in chunks], 2
    )["w"])
    got = pipeline.stack_interleaved_params(
        [{"w": torch.from_numpy(c["w"])} for c in chunks], 2
    )["w"]
    assert got.shape == (2, 3, 3, 2)
    np.testing.assert_array_equal(got.numpy(), want)
    stacked = pmesh.stack_params([{"w": torch.from_numpy(c["w"])} for c in chunks[:2]])
    assert torch.equal(stacked["w"][1], torch.from_numpy(chunks[1]["w"]))


def test_interleaved_needs_as_many_microbatches_as_stages():
    config = TransformerConfig(**LM_SIZES, dtype=torch.float32)
    with pytest.raises(ValueError, match="num_micro >= num_stages"):
        PipelineLM(config, 2, 1, interleave=2)
    with pytest.raises(ValueError, match="uniform chunks"):
        PipelineLM(config, 2, 2, interleave=3)
    with pytest.raises(ValueError, match="current mesh has 1 stage"):
        pmesh.create_mesh({"data": 1})
        try:
            init_pipeline_lm(config, 2, 2, device="cpu")
        finally:
            pmesh._reset()
    # The schedule itself checks M against the group before any hop.
    pmesh._current = pmesh.ProcessMesh({"data": 1, "stage": 2}, 0, {})
    try:
        with pytest.raises(ValueError, match="got M=1 < S=2"):
            pipeline.interleaved_pipeline(lambda p, h: h, [None, None], torch.zeros(1, 2, 3))
    finally:
        pmesh._reset()


# ---- the stage axis of the hints, the speedups and the loader -------------

PERF = (0.12, 0.0057, 0.024, 0.0063, 0.012, 0.0032, 1.14, 0.0, 0.0, 0.0, 0.0,
        0.004, 0.0003, 0.0, 0.0)
GRAD = (0.00136, 0.000502)


@pytest.fixture
def fresh_metrics():
    checkpoint._reset_registry()
    metrics._reset_state()
    jmetrics._reset_state()
    yield
    checkpoint._reset_registry()
    metrics._reset_state()
    jmetrics._reset_state()


@pytest.mark.parametrize("micro", [None, 2, 16])
def test_pipeline_hints_match_jax(fresh_metrics, monkeypatch, micro):
    posted = {}
    monkeypatch.setattr(sched_hints, "post_sched_hints",
                        lambda hints: posted.__setitem__("port", hints))
    monkeypatch.setattr(jhints, "post_sched_hints",
                        lambda hints, job_id=None: posted.__setitem__("jax", hints))
    for package in (metrics, jmetrics):
        package.set_batch_size_config(32, 1024, (4, 128), True)
        kw = {} if micro is None else {"pipeline_microbatches": micro}
        package.set_topology_config(
            max_model_shards=8, max_stage_shards=4, pipeline_chunks=12, **kw
        )
        package.set_active_topology(1, 1, 2, 1, micro or 4)
        package.fit_and_report_now()
    keys = ("maxSeqShards", "maxModelShards", "maxStageShards", "maxExpertShards",
            "maxPipelineMicro", "pipelineMicrobatches", "pipelineChunks")
    assert {k: posted["port"][k] for k in keys} == {k: posted["jax"][k] for k in keys}
    assert posted["port"]["pipelineMicrobatches"] == (micro or 4)
    assert posted["port"]["maxPipelineMicro"] == max(8, micro or 4)


def test_pipeline_fields_survive_the_metrics_checkpoint(fresh_metrics, tmp_path, monkeypatch):
    monkeypatch.setenv("ADAPTDL_CHECKPOINT_PATH", str(tmp_path))
    metrics.set_topology_config(max_stage_shards=4, pipeline_microbatches=2,
                                max_pipeline_micro=16, pipeline_chunks=12)
    metrics.ensure_checkpoint_registered()
    checkpoint.save_all_states()
    checkpoint._reset_registry()
    metrics._reset_state()
    assert metrics.current_state().pipeline_chunks == 0
    metrics.ensure_checkpoint_registered()
    state = metrics.current_state()
    assert (state.max_stage_shards, state.pipeline_microbatches,
            state.max_pipeline_micro, state.pipeline_chunks) == (4, 2, 16, 12)


def test_example_speedups_with_the_stage_axis_match_jax():
    """The LM example's pipeline-family hints at full width (12 layers:
    max_stage_shards 4, pipeline_chunks 12, tp up to 8, sp and ep 1)."""
    hints = dict(max_batch_size=1024, atomic_bsz_range=(4, 128), accumulation=True,
                 max_model_shards=8, max_stage_shards=12 & -12, pipeline_chunks=12)
    fns = []
    for goodput, speedup in ((jax_goodput, jax_speedup), (port_goodput, port_speedup)):
        fn = goodput.GoodputFunction(goodput.PerfParams(*PERF), goodput.GradParams(*GRAD), 32)
        fns.append(speedup.SpeedupFunction(fn, **hints))
    nodes, chips = np.array([1, 1, 1, 1, 2]), np.array([1, 2, 4, 8, 8])
    np.testing.assert_allclose(fns[1](nodes, chips), fns[0](nodes, chips), rtol=1e-12, atol=0)
    configs = [fns[1].best_config(n, c) for n, c in zip(nodes.tolist(), chips.tolist())]
    assert configs == [fns[0].best_config(n, c) for n, c in zip(nodes.tolist(), chips.tolist())]
    assert all(sp == 1 and ep == 1 for _, _, sp, _, _, ep, _ in configs)


@pytest.mark.parametrize("stage_shards, micro", [(2, 4), (2, 1), (4, 8)])
def test_loader_decisions_with_a_stage_axis_match_jax(fresh_metrics, stage_shards, micro):
    dataset = {"x": np.zeros((4096, 2), np.float32)}
    loaders = []
    for package, mpkg in ((data, metrics), (jdata, jmetrics)):
        mpkg.set_active_topology(1, 1, stage_shards, 1, micro)
        loader = package.AdaptiveDataLoader(dataset, batch_size=32)
        loader.autoscale_batch_size(1024, (4, 128), True)
        loaders.append(loader)
    metrics._state.perf_params = PerfParams(*PERF)
    jmetrics._state.perf_params = jax_goodput.PerfParams(*PERF)
    for sqr, var in ((GRAD[0], GRAD[1]), (1e-4, 1e-1), (1e-1, 1e-4)):
        metrics._state.grad_params = GradParams(sqr, var)
        jmetrics._state.grad_params = jax_goodput.GradParams(sqr, var)
        port, reference = (loader._rank0_decision() for loader in loaders)
        assert port == reference, (sqr, var)
    # The stage terms are priced: the goodput at this topology differs
    # from the same fit's at ss 1 wherever the pipeline has a bubble.
    fn = GoodputFunction(PerfParams(*PERF), GradParams(*GRAD), 32)
    staged = fn(1, 1, 32, 0, stage_shards=stage_shards, pipeline_micro=micro)
    assert staged != fn(1, 1, 32, 0)


def test_example_pipeline_rules():
    """The JAX example's schedule choice and pipeline-family rules."""
    assert example.pipeline_interleave(12, 2, 4) == 6
    assert example.pipeline_interleave(12, 4, 4) == 3
    assert example.pipeline_interleave(12, 4, 2) == 1  # M < ss: GPipe
    assert example.pipeline_interleave(2, 2, 4) == 1  # one layer per stage
    assert example.pipeline_interleave(12, 1, 4) == 1

    class Args:
        pipeline, stage_shards, moe_experts, flash, chunked_xent = False, 2, 0, False, 0
        zero1 = zero3 = zero3_blocks = False

    assert example.pipeline_family(Args)
    example.check_pipeline_flags(Args, 1)
    with pytest.raises(AssertionError, match="composes the stage axis"):
        example.check_pipeline_flags(Args, 2)
    Args.flash = True
    with pytest.raises(AssertionError, match="composes the stage axis"):
        example.check_pipeline_flags(Args, 1)
    Args.flash, Args.zero1 = False, True
    with pytest.raises(AssertionError, match="dp/seq only"):
        example.check_zero_flags(Args)
