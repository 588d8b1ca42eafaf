"""One rank of the port's ZeRO tests, run under the launcher:

    python -m adaptdl_tpu_torch.launch tests/torch_zero_worker.py DIR PLAN

Each rank joins the process group on the CPU through ``initialize_job``,
runs every task of ``DIR/PLAN.json`` in order and writes what it saw to
``DIR/<task name>-rank<r>.pt``. It imports neither JAX nor the JAX
package. Tasks (``kind``):

- ``train``: the model of ``DIR/<model_file>`` (``lm``: the 2-layer LM;
  ``lm_z3b``: the zero3 LM, ``Zero3LMParams`` weights; ``mlp``: the toy
  stacked-block MLP) under ``mode`` (dense, zero1, zero3, zero3_blocks)
  and ``opt`` (adamw: AdamW(1e-2) + AdamScale + the Adam
  preconditioner; sgd: SGD(0.05, momentum 0.9) + AdaScale; adamw_plain:
  AdamW(1e-2) with no rule), ``param_groups`` optional, takes a step on
  this rank's replica-major block of each batch of ``DIR/<batches>.npz``
  at ``accum`` accumulation steps; with ``ckpt`` (``trainer`` or
  ``sharded``) it first restores from ``DIR/<ckpt_dir>`` and saves there
  after the steps. Writes the per-step metrics, the parameter tree, the
  flat canonical moments, the noise statistics and the layout's facts
  (row shapes, released storage).
- ``collectives``: ``reduce_scatter_sum`` and ``all_gather_rows`` on
  rank-dependent inputs.
- ``scan``: the toy MLP's loss and row gradients through ``build_view``
  and ``scan_blocks`` (``unroll`` 1 and 2) on this rank's block.
"""

import json
import os
import sys

import numpy as np
import torch
from torch import nn

import adaptdl_tpu_torch
from adaptdl_tpu_torch import checkpoint, collective, env

LM_SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)


class ToyMLP(nn.Module):
    """The JAX tests' stacked-block MLP (``tests/test_zero3_blocks.py``),
    with its parameters registered in ``ravel_pytree`` order: ``blocks``
    (b1, b2, w1, w2), then ``inp.w`` and ``out.w``."""

    def __init__(self, L=3, d=8, h=16):
        super().__init__()
        self.blocks = nn.Module()
        self.blocks.b1 = nn.Parameter(torch.zeros(L, h))
        self.blocks.b2 = nn.Parameter(torch.zeros(L, d))
        self.blocks.w1 = nn.Parameter(torch.zeros(L, d, h))
        self.blocks.w2 = nn.Parameter(torch.zeros(L, h, d))
        self.inp, self.out = nn.Module(), nn.Module()
        self.inp.w = nn.Parameter(torch.zeros(d, d))
        self.out.w = nn.Parameter(torch.zeros(d, d))


def mlp_block(p, hid):
    return hid + torch.tanh(hid @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def mlp_dense_loss(model, batch, generator=None):
    hid = batch["x"] @ model.inp.w
    for i in range(model.blocks.w1.shape[0]):
        hid = mlp_block(
            {k: getattr(model.blocks, k)[i] for k in ("b1", "b2", "w1", "w2")}, hid
        )
    return ((hid @ model.out.w - batch["y"]) ** 2).mean()


def mlp_z3b_loss(spec, unroll=1):
    from adaptdl_tpu_torch.parallel import zero3

    def loss(view, batch, generator=None):
        hid = batch["x"] @ view.other["inp.w"]
        hid = zero3.scan_blocks(mlp_block, view.blocks, hid, spec, unroll=unroll)
        return ((hid @ view.other["out.w"] - batch["y"]) ** 2).mean()

    return loss


def build(model_kind, mode, weights, device="cpu"):
    """(loss_fn, module) of a model from its state dict."""
    from adaptdl_tpu_torch.models import (
        TransformerConfig, TransformerLM, Zero3LMParams, lm_loss_fn, zero3_lm_loss_fn,
    )
    from adaptdl_tpu_torch.parallel import zero3

    if model_kind == "mlp":
        model = ToyMLP(*mlp_dims(weights))
        model.load_state_dict(weights)
        if mode == "zero3_blocks":
            return mlp_z3b_loss(zero3.block_spec(model, "blocks")), model
        return mlp_dense_loss, model
    config = TransformerConfig(**LM_SIZES, dtype=torch.float32, remat=False)
    if model_kind == "lm_z3b":
        params = Zero3LMParams(config)
        params.load_state_dict(weights)
        return zero3_lm_loss_fn(params), params
    model = TransformerLM(config)
    model.load_state_dict(weights)
    return lm_loss_fn, model


def mlp_dims(weights):
    L, d, h = weights["blocks.w1"].shape
    return L, d, h


def make_trainer(task, weights):
    from adaptdl_tpu_torch.optim import SGD, AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale, AdaScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    loss_fn, model = build(task["model"], task["mode"], weights)
    opt_kind = task.get("opt", "adamw")
    if opt_kind == "sgd":
        optimizer, rule, precond = SGD(model.parameters(), lr=0.05, momentum=0.9), AdaScale(), None
    elif opt_kind == "adamw_plain":
        optimizer, rule, precond = AdamW(model.parameters(), lr=1e-2), None, None
    else:
        optimizer, rule, precond = AdamW(model.parameters(), lr=1e-2), AdamScale(), "adam"
    mode = task["mode"]
    kwargs = {
        "zero1": {"zero1": True}, "zero3": {"zero3": True},
        "zero3_blocks": {"zero3_blocks": "blocks"},
    }.get(mode, {})
    group_fn = None
    if task.get("param_groups"):
        group_fn = lambda name, p: 0 if name.startswith("embed") else 1  # noqa: E731
    return ElasticTrainer(
        loss_fn, model, optimizer, init_batch_size=task["init_batch"],
        scaling_rule=rule, precondition=precond, device="cpu",
        param_group_fn=group_fn, **kwargs,
    )


def canonical_moments(trainer, state):
    """Flat canonical moments (a collective under the ZeRO modes)."""
    if trainer.zero_mode is None:
        out = {}
        for key in ("exp_avg", "exp_avg_sq", "momentum_buffer"):
            parts = [trainer.optimizer.state[p].get(key) for p in trainer.optimizer.params()]
            if all(t is not None for t in parts):
                out[key] = torch.cat([t.reshape(-1) for t in parts])
        return out
    return {
        k: trainer.layout.gather(v)
        for k, v in trainer.row_families(state).items() if k not in ("params", "prev_grad")
    }


def layout_facts(trainer, state):
    facts = {"rows": [list(r.shape) for r in trainer._rows] if trainer.zero_mode else []}
    if trainer.zero_mode:
        facts["moments"] = {
            k: [list(trainer.optimizer.state[r][k].shape) for r in trainer._rows]
            for k in trainer._moment_keys()
        }
        facts["released"] = [
            p.untyped_storage().nbytes() == 0 for p in trainer.model.parameters()
        ]
        facts["prev_grad"] = [list(t.shape) for t in state.gns.prev_grad]
        facts["n"] = trainer.layout.n
    return facts


def train(task, out_dir, rank, replicas):
    from adaptdl_tpu_torch.sharded_checkpoint import ShardedTrainerCheckpoint

    weights = torch.load(os.path.join(out_dir, task["model_file"]))
    trainer = make_trainer(task, weights)
    holder = {"state": trainer.init_state()}
    ckpt = None
    if task.get("ckpt"):
        os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(out_dir, task["ckpt_dir"])
        checkpoint._reset_registry()
        args = ("zero-test", trainer, lambda: holder["state"],
                lambda s: holder.__setitem__("state", s))
        ckpt = (ShardedTrainerCheckpoint(*args) if task["ckpt"] == "sharded"
                else trainer.make_checkpoint_state(args[2], args[3], name=args[0]))
        checkpoint.load_state(ckpt)
    resumed = holder["state"].host_step
    resumed_params = (
        {k: v.clone() for k, v in trainer.params_tree(holder["state"]).items()}
        if resumed else None
    )
    accum = task.get("accum", 0)
    batches = np.load(os.path.join(out_dir, task["batches"]))
    steps = []
    for i in range(task.get("first", 0), task.get("first", 0) + task["steps"]):
        global_rows = {k: batches[k][i] for k in batches.files}
        rows = len(next(iter(global_rows.values()))) // replicas
        atomic = rows // (accum + 1)
        local = {k: v[rank * rows : (rank + 1) * rows] for k, v in global_rows.items()}
        holder["state"], m = trainer.train_step(atomic, accum)(
            holder["state"], trainer.to_device(local)
        )
        steps.append({k: float(v) for k, v in m.items()})
    if ckpt is not None and task.get("save", True):
        checkpoint.save_all_states()
    state = holder["state"]
    result = {
        "steps": steps,
        "resumed": resumed,
        "resumed_params": resumed_params,
        "params": {k: v.clone() for k, v in trainer.params_tree(state).items()},
        "moments": canonical_moments(trainer, state),
        "gns": {k: v for k, v in state.gns.tensors().items() if k != "prev_grad"},
        "step": int(state.step),
        "facts": layout_facts(trainer, state),
    }
    if ckpt is not None:
        ckpt.unregister()
    return result


def collectives_check(rank, replicas):
    collective.reset_traffic()
    row = torch.arange(4, dtype=torch.float32) + 10 * rank
    gathered = collective.all_gather_rows(row).clone()
    out = torch.empty(4 * replicas)
    collective.all_gather_rows(row, out=out)
    flat = torch.arange(4 * replicas, dtype=torch.float32) * (rank + 1)
    scattered = collective.reduce_scatter_sum(flat).clone()
    return {"gathered": gathered, "gathered_out": out, "scattered": scattered,
            "traffic": dict(collective.TRAFFIC)}


def scan_check(task, out_dir, rank, replicas):
    from adaptdl_tpu_torch.parallel import zero3

    weights = torch.load(os.path.join(out_dir, task["model_file"]))
    model = ToyMLP(*mlp_dims(weights))
    model.load_state_dict(weights)
    spec = zero3.block_spec(model, "blocks")
    blocks, other = zero3.tree_to_rows(dict(model.named_parameters()), "blocks", spec, replicas)
    saved = np.load(os.path.join(out_dir, task["batches"]))
    batch = {k: torch.as_tensor(saved[k][0]) for k in saved.files}
    rows = len(batch["x"]) // replicas
    local = {k: v[rank * rows : (rank + 1) * rows] for k, v in batch.items()}
    result = {}
    for unroll in (1, 2):
        b = blocks[:, rank].clone().requires_grad_()
        o = other[rank].clone().requires_grad_()
        view = zero3.build_view(b, o, spec)
        loss = mlp_z3b_loss(spec, unroll)(view, local)
        gb, go = torch.autograd.grad(loss, [b, o])
        total = collective.allreduce_sum(loss.detach().reshape(1).clone())
        result[unroll] = {"loss": total / replicas, "blocks": gb / replicas, "other": go / replicas}
    return result


def main(out_dir, plan):
    adaptdl_tpu_torch.initialize_job(device="cpu")
    rank, replicas = env.process_rank(), env.num_replicas()
    with open(os.path.join(out_dir, f"{plan}.json")) as f:
        tasks = json.load(f)
    for task in tasks:
        if task["kind"] == "collectives":
            result = collectives_check(rank, replicas)
        elif task["kind"] == "scan":
            result = scan_check(task, out_dir, rank, replicas)
        else:
            result = train(task, out_dir, rank, replicas)
        torch.save(result, os.path.join(out_dir, f"{task['name']}-rank{rank}.pt"))


if __name__ == "__main__":
    main(*sys.argv[1:3])
