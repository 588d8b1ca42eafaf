"""One rank of the port's model-axis, expert-axis and seq x ZeRO tests,
run under the launcher:

    python -m adaptdl_tpu_torch.launch tests/torch_axes_worker.py DIR PLAN

Each rank joins the process group on the CPU through ``initialize_job``,
runs every task of ``DIR/PLAN.json`` in order and writes what it saw to
``DIR/<task name>-rank<r>.pt``. It imports neither JAX nor the JAX
package. Every task names its mesh (``axes``, data first); the example's
rewrite sets ``ADAPTDL_NUM_REPLICAS`` to the data axis. Tasks (``kind``):

- ``grads``: the 2-layer LM of ``DIR/lm.pt`` (full weights, cut to this
  rank's shards) on ``DIR/<batches>.npz``'s first batch: the loss over
  inputs and targets and this rank's parameter gradients.
- ``moe``: ``switch_moe`` over the expert axis on the ``x``, ``router``,
  ``w_up``, ``w_down`` and ``cot`` of ``DIR/<file>``: the output, the
  aux loss and the gradients of ``sum(out * cot) + 3 aux`` with respect
  to ``x``, the router and this rank's experts.
- ``train``: the LM (or under ``zero`` = ``zero3_blocks`` the zero3 LM)
  under ``zero`` (None, zero1, zero3, zero3_blocks), AdamW(1e-2) +
  AdamScale + the Adam preconditioner, ``steps`` steps at ``(atomic,
  accum)`` on this replica's rows of each batch (this rank's seq block
  under a seq axis); with ``ckpt_dir`` it restores from there first and
  saves after the steps, through the trainer's checkpoint state or, with
  ``ckpt`` = ``sharded``, a ``ShardedTrainerCheckpoint``. Writes the per-step metrics and the full
  logical payload (parameters, moments, noise statistics) as the
  checkpoint's ``sync`` gathers it; without a ZeRO mode also
  ``params_tree`` and ``eval_step``'s totals of the loss over the first
  batch it stepped.
"""

import json
import os
import sys

import numpy as np
import torch

import adaptdl_tpu_torch
from adaptdl_tpu_torch import checkpoint, collective, env

LM_SIZES = dict(vocab_size=64, num_layers=2, num_heads=4, d_model=32, d_ff=64)


def make_mesh(axes):
    from adaptdl_tpu_torch.parallel.mesh import create_mesh

    os.environ["ADAPTDL_NUM_REPLICAS"] = str(axes["data"])
    for axis, var in (("seq", "SEQ"), ("model", "MODEL"), ("expert", "EXPERT")):
        os.environ[f"ADAPTDL_{var}_SHARDS"] = str(axes.get(axis, 1))
    return create_mesh(axes)


def lm_config(task):
    from adaptdl_tpu_torch.models import TransformerConfig

    axes = task["axes"]
    experts = task.get("experts", 0)
    return TransformerConfig(
        **LM_SIZES, dtype=torch.float32, remat=task.get("remat", True),
        seq_axis="seq" if axes.get("seq", 1) > 1 else None,
        seq_attention=task.get("seq_mode", "ring"),
        model_axis="model" if axes.get("model", 1) > 1 else None,
        moe_axis="expert" if axes.get("expert", 1) > 1 else None,
        moe_every_n=2 if experts else 0, moe_num_experts=experts,
        moe_top_k=task.get("top_k", 1), moe_router=task.get("router", "tokens"),
        causal=task.get("router", "tokens") == "tokens",
    )


def build(task, out_dir):
    """(loss_fn, module) of the task's model, this rank's shards of the
    full weights of ``DIR/lm.pt``."""
    from adaptdl_tpu_torch.models import TransformerLM, Zero3LMParams, lm_pair_loss_fn
    from adaptdl_tpu_torch.models import zero3_lm_loss_fn
    from adaptdl_tpu_torch.models.transformer import shard_for_mesh

    config = lm_config(task)
    weights = torch.load(os.path.join(out_dir, task.get("weights", "lm.pt")))
    if task.get("zero") == "zero3_blocks":
        params = Zero3LMParams(config)
        params.load_state_dict(weights)
        return zero3_lm_loss_fn(params), params
    model = TransformerLM(config)
    model.load_state_dict(weights)
    return lm_pair_loss_fn, shard_for_mesh(model)


def replica_rows(batch, dp, data_rank):
    rows = len(next(iter(batch.values())))
    block = rows // dp
    return {k: v[data_rank * block : (data_rank + 1) * block] for k, v in batch.items()}


def grads(task, out_dir, rank):
    make_mesh(task["axes"])
    loss_fn, model = build(task, out_dir)
    batches = np.load(os.path.join(out_dir, task["batches"]))
    batch = {k: torch.from_numpy(batches[k][0]) for k in ("inputs", "targets")}
    loss = loss_fn(model, batch)
    names = [n for n, _ in model.named_parameters()]
    got = torch.autograd.grad(loss, list(model.parameters()))
    return {"loss": loss.detach(), "grads": dict(zip(names, (g.detach() for g in got)))}


def moe(task, out_dir, rank):
    from adaptdl_tpu_torch.models.moe import switch_moe
    from adaptdl_tpu_torch.parallel import mesh as pmesh

    mesh = make_mesh(task["axes"])
    data = {k: torch.from_numpy(v) for k, v in np.load(os.path.join(out_dir, task["file"])).items()}
    ep, me = mesh.axis_size("expert"), mesh.index("expert")
    local = data["w_up"].shape[0] // ep
    x = data["x"].clone().requires_grad_()
    router = data["router"].clone().requires_grad_()
    w_up = data["w_up"][me * local : (me + 1) * local].clone().requires_grad_()
    w_down = data["w_down"][me * local : (me + 1) * local].clone().requires_grad_()
    out, aux = switch_moe(
        router, {"w_up": w_up, "w_down": w_down}, x, pmesh.axis_group("expert"),
        top_k=task["top_k"], return_aux=True, router_type=task["router"],
    )
    total = (out * data["cot"]).sum() + 3.0 * aux
    got = torch.autograd.grad(total, (x, router, w_up, w_down))
    return {"out": out.detach(), "aux": aux.detach(),
            "grads": dict(zip(("x", "router", "w_up", "w_down"), (g.detach() for g in got)))}


def logical(trainer, state, ckpt):
    """A copy of the full logical payload, as the checkpoint's ``sync``
    gathers it (a collective every rank joins)."""
    from adaptdl_tpu_torch.trainer import _map_tensors

    if trainer.zero_mode is not None:
        payload = trainer.canonical_payload(state)
    else:
        payload = trainer.logical_payload(ckpt._dense_payload(state))
    return _map_tensors(payload, lambda t: t.detach().clone())


def train(task, out_dir, rank):
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.parallel import mesh as pmesh
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.sharded_checkpoint import ShardedTrainerCheckpoint
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    checkpoint._reset_registry()
    mesh = make_mesh(task["axes"])
    loss_fn, model = build(task, out_dir)
    zero = task.get("zero")
    trainer = ElasticTrainer(
        loss_fn, model, AdamW(model.parameters(), lr=1e-2),
        init_batch_size=task["init_batch"], scaling_rule=AdamScale(),
        precondition="adam", device="cpu", mesh=mesh,
        zero1=zero == "zero1", zero3=zero == "zero3",
        zero3_blocks="blocks" if zero == "zero3_blocks" else None,
    )
    holder = {"state": trainer.init_state()}
    accessors = (lambda: holder["state"], lambda s: holder.__setitem__("state", s))
    if task.get("ckpt") == "sharded":
        ckpt = ShardedTrainerCheckpoint("lm", trainer, *accessors)
    else:
        ckpt = trainer.make_checkpoint_state(*accessors, name="lm")
    result = {"mesh": dict(mesh.shape)}
    if task.get("ckpt_dir"):
        os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(out_dir, task["ckpt_dir"])
        result["restored"] = checkpoint.load_state(ckpt)
        result["resumed_step"] = holder["state"].host_step
        result["resumed"] = logical(trainer, holder["state"], ckpt)
    batches = dict(np.load(os.path.join(out_dir, task["batches"])))
    dp, data_rank = mesh.axis_size("data"), mesh.index(pmesh.DATA_AXIS)
    step = trainer.train_step(task["atomic"], task["accum"])
    first = task.get("first", 0)
    metrics = []
    for i in range(first, first + task["steps"]):
        batch = replica_rows({k: v[i] for k, v in batches.items()}, dp, data_rank)
        holder["state"], m = step(holder["state"], trainer.to_device(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    if zero is None:
        # The evaluation sums over the data replicas, once per replica.
        def metric_fn(model_, batch):
            return {"loss_sum": loss_fn(model_, batch) * len(batch["inputs"]),
                    "rows": len(batch["inputs"])}

        last = replica_rows({k: v[first] for k, v in batches.items()}, dp, data_rank)
        result["eval"] = trainer.eval_step(metric_fn)(holder["state"], trainer.to_device(last))
        result["params_tree"] = trainer.params_tree()
    result.update(
        steps=metrics, step=holder["state"].host_step,
        local={n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        if zero is None else None,
        logical=logical(trainer, holder["state"], ckpt),
        gns={k: v.detach().clone() for k, v in holder["state"].gns.tensors().items()
             if k != "prev_grad"},
    )
    if task.get("ckpt_dir"):
        checkpoint.save_all_states()
        collective.barrier()
        ckpt.unregister()
        del os.environ["ADAPTDL_CHECKPOINT_PATH"]
    return result


TASKS = {"grads": grads, "moe": moe, "train": train}


def main(out_dir, plan):
    adaptdl_tpu_torch.initialize_job(device="cpu")
    rank = env.process_rank()
    with open(os.path.join(out_dir, f"{plan}.json")) as f:
        tasks = json.load(f)
    for task in tasks:
        result = TASKS[task["kind"]](task, out_dir, rank)
        torch.save(result, os.path.join(out_dir, f"{task['name']}-rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
