"""One rank of the port's pipeline tests, run under the launcher:

    python -m adaptdl_tpu_torch.launch tests/torch_pipeline_worker.py DIR PLAN

Each rank joins the process group on the CPU through ``initialize_job``,
runs every task of ``DIR/PLAN.json`` in order and writes what it saw to
``DIR/<task name>-rank<r>.pt``. It imports neither JAX nor the JAX
package. Every task names its mesh (``axes``, data first). Tasks
(``kind``):

- ``schedule``: ``gpipe`` (``interleave`` 1) or ``interleaved_pipeline``
  over the stage axis on ``DIR/<file>``'s ``x [M, mb, D]``, ``cot`` and
  the chunks ``w [S*v, D, D]``, ``b [S*v, D]`` (global chunk order),
  each chunk ``relu(x @ w + b)``: the outputs shared from the last stage
  and the gradients of ``sum(out * cot)`` with respect to this rank's
  chunks and to ``x`` (this rank's share); and the same through
  ``gpipe_loss`` / ``interleaved_loss`` with the head ``sum(final * cot)``.
- ``lm``: the pipelined LM of ``DIR/<weights>`` (this stage's state
  dict) on ``DIR/<batches>``'s first batch of raw token rows: the loss
  and this rank's parameter gradients, the replicated leaves' partial.
- ``train``: the pipelined LM (or, without a stage axis, the dense LM)
  from the full dense weights of ``DIR/lm.pt``, AdamW(1e-2) + AdamScale
  + the Adam preconditioner, ``steps`` steps at ``(atomic, accum)`` on this
  replica's rows of each batch; with ``ckpt_dir`` it restores from there
  first and saves after the steps. Writes the per-step metrics, the full
  logical payload as the checkpoint's ``sync`` gathers it (the dense
  LM's names), this rank's parameters, ``params_tree`` and
  ``eval_step``'s totals of the loss over the first batch it stepped.
"""

import json
import os
import sys

import numpy as np
import torch

import adaptdl_tpu_torch
from adaptdl_tpu_torch import checkpoint, collective, env

LM_SIZES = dict(vocab_size=64, num_layers=4, num_heads=2, d_model=32, d_ff=64)


def make_mesh(axes):
    from adaptdl_tpu_torch.parallel.mesh import create_mesh

    os.environ["ADAPTDL_NUM_REPLICAS"] = str(axes["data"])
    for axis, var in (("model", "MODEL"), ("stage", "STAGE")):
        os.environ[f"ADAPTDL_{var}_SHARDS"] = str(axes.get(axis, 1))
    return create_mesh(axes)


def lm_config(task):
    from adaptdl_tpu_torch.models import TransformerConfig

    return TransformerConfig(
        **LM_SIZES, dtype=torch.float32, remat=task.get("remat", True),
        model_axis="model" if task["axes"].get("model", 1) > 1 else None,
    )


def schedule(task, out_dir, rank):
    from adaptdl_tpu_torch.parallel import mesh as pmesh
    from adaptdl_tpu_torch.parallel.pipeline import (
        gpipe, gpipe_loss, interleaved_loss, interleaved_pipeline, stage_sum,
    )

    make_mesh(task["axes"])
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out_dir, task["file"])).items()}
    stages, stage = pmesh.axis_size("stage"), pmesh.axis_index("stage")
    v = task["interleave"]
    chunks = [
        {"w": data["w"][k * stages + stage].clone().requires_grad_(),
         "b": data["b"][k * stages + stage].clone().requires_grad_()}
        for k in range(v)
    ]
    x = data["x"].clone().requires_grad_()

    def chunk_fn(p, h):
        return torch.relu(h @ p["w"] + p["b"])

    if v > 1:
        outs = interleaved_pipeline(chunk_fn, chunks, x)
    else:
        outs = gpipe(chunk_fn, chunks[0], x)
    is_last = torch.tensor(stage == stages - 1)
    shared = stage_sum(torch.where(is_last, outs, torch.zeros_like(outs)))
    total = (shared * data["cot"]).sum()
    leaves = [c[k] for c in chunks for k in ("w", "b")] + [x]
    grads = torch.autograd.grad(total, leaves)
    # The same through the trainer-style loss: x as [rows, D], the head
    # sum(final * cot) on the last stage, shared with the group.
    make_loss = interleaved_loss if v > 1 else gpipe_loss
    loss_fn = make_loss(chunk_fn, lambda final, batch: (final * batch["cot"]).sum(), x.shape[0])
    rows = data["x"].reshape(-1, x.shape[-1]).clone().requires_grad_()
    loss = loss_fn(chunks if v > 1 else chunks[0],
                   {"x": rows, "cot": data["cot"].reshape(rows.shape)})
    loss_grads = torch.autograd.grad(loss, leaves[:-1] + [rows])
    return {
        "out": shared.detach(),
        "w": torch.stack(grads[0 : 2 * v : 2]), "b": torch.stack(grads[1 : 2 * v : 2]),
        "x": grads[-1],
        "loss": loss.detach(),
        "loss_w": torch.stack(loss_grads[0 : 2 * v : 2]),
        "loss_b": torch.stack(loss_grads[1 : 2 * v : 2]),
        "loss_x": loss_grads[-1].reshape(x.shape),
    }


def lm(task, out_dir, rank):
    from adaptdl_tpu_torch.models.pipeline_lm import PipelineLM, pipeline_lm_loss_fn
    from adaptdl_tpu_torch.parallel import mesh as pmesh

    make_mesh(task["axes"])
    stage = pmesh.axis_index("stage")
    model = PipelineLM(lm_config(task), pmesh.axis_size("stage"), task["micro"],
                       task["interleave"], stage)
    model.load_state_dict(torch.load(os.path.join(out_dir, task["weights"].format(stage=stage))))
    tokens = torch.from_numpy(np.load(os.path.join(out_dir, task["batches"]))["tokens"][0])
    loss = pipeline_lm_loss_fn(model, {"tokens": tokens})
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, list(model.parameters()))
    return {"loss": loss.detach(), "grads": dict(zip(names, (g.detach() for g in got)))}


def build(task, out_dir):
    """(loss_fn, module): this rank's share of the full dense weights of
    ``DIR/lm.pt``, pipelined under a stage axis."""
    from adaptdl_tpu_torch.models import TransformerLM, lm_loss_fn
    from adaptdl_tpu_torch.models.pipeline_lm import PipelineLM, pipeline_lm_loss_fn
    from adaptdl_tpu_torch.parallel import mesh as pmesh
    from adaptdl_tpu_torch.parallel.tensor_parallel import shard_transformer

    config = lm_config(task)
    weights = torch.load(os.path.join(out_dir, "lm.pt"))
    stages = task["axes"].get("stage", 1)
    if stages == 1:
        model = TransformerLM(config)
        model.load_state_dict(weights)
        return lm_loss_fn, model
    model = PipelineLM(config, stages, task["micro"], task["interleave"],
                       pmesh.axis_index("stage"))
    model.load_state_dict({n: weights[n] for n in model.state_dict()})
    if config.model_axis is not None:
        model = shard_transformer(model, (pmesh.axis_index("model"), pmesh.axis_size("model")))
    return pipeline_lm_loss_fn, model


def replica_rows(batch, dp, data_rank):
    rows = len(next(iter(batch.values())))
    block = rows // dp
    return {k: v[data_rank * block : (data_rank + 1) * block] for k, v in batch.items()}


def train(task, out_dir, rank):
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.parallel import mesh as pmesh
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer, _map_tensors

    checkpoint._reset_registry()
    mesh = make_mesh(task["axes"])
    loss_fn, model = build(task, out_dir)
    trainer = ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=1e-2),
        init_batch_size=task["init_batch"], scaling_rule=AdamScale(),
        precondition="adam", device="cpu", mesh=mesh,
        pipeline_micro=task.get("micro"),
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="lm"
    )

    def logical():
        payload = ckpt._dense_payload(holder["state"])
        if trainer.sharded:
            payload = trainer.logical_payload(payload)
        return _map_tensors(payload, lambda t: t.detach().clone())

    result = {"mesh": dict(mesh.shape)}
    if task.get("ckpt_dir"):
        os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(out_dir, task["ckpt_dir"])
        result["restored"] = checkpoint.load_state(ckpt)
        result["resumed_step"] = holder["state"].host_step
        result["resumed"] = logical()
    batches = dict(np.load(os.path.join(out_dir, task["batches"])))
    dp, data_rank = mesh.axis_size("data"), mesh.index(pmesh.DATA_AXIS)
    step = trainer.train_step(task["atomic"], task.get("accum", 0))
    first = task.get("first", 0)
    metrics = []
    for i in range(first, first + task["steps"]):
        batch = replica_rows({k: v[i] for k, v in batches.items()}, dp, data_rank)
        holder["state"], m = step(holder["state"], trainer.to_device(batch))
        metrics.append({k: float(v) for k, v in m.items()})

    def metric_fn(model_, batch):
        return {"loss_sum": loss_fn(model_, batch) * len(batch["tokens"]),
                "rows": len(batch["tokens"])}

    last = replica_rows({k: v[first] for k, v in batches.items()}, dp, data_rank)
    result.update(
        eval=trainer.eval_step(metric_fn)(holder["state"], trainer.to_device(last)),
        params_tree=trainer.params_tree(),
        steps=metrics, step=holder["state"].host_step,
        local={n: p.detach().clone() for n, p in trainer.model.named_parameters()},
        logical=logical(),
    )
    if task.get("ckpt_dir"):
        checkpoint.save_all_states()
        collective.barrier()
        ckpt.unregister()
        del os.environ["ADAPTDL_CHECKPOINT_PATH"]
    return result


TASKS = {"schedule": schedule, "lm": lm, "train": train}


def main(out_dir, plan):
    torch.set_num_threads(1)
    adaptdl_tpu_torch.initialize_job(device="cpu")
    rank = env.process_rank()
    with open(os.path.join(out_dir, f"{plan}.json")) as f:
        tasks = json.load(f)
    for task in tasks:
        result = TASKS[task["kind"]](task, out_dir, rank)
        torch.save(result, os.path.join(out_dir, f"{task['name']}-rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
