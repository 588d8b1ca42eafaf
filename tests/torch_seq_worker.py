"""One rank of the port's sequence-axis tests, run under the launcher:

    python -m adaptdl_tpu_torch.launch tests/torch_seq_worker.py DIR PLAN

Each rank joins the process group on the CPU through ``initialize_job``,
runs every task of ``DIR/PLAN.json`` in order and writes what it saw to
``DIR/<task name>-rank<r>.pt``. It imports neither JAX nor the JAX
package. Tasks (``kind``):

- ``attention``: ``mode`` (``ulysses``, ``ulysses_flash``: the port's
  ``flash_attention`` as the inner attention, or ``ring``) over a
  ``{"seq": ranks}`` mesh on this rank's sequence block of ``q, k, v`` of
  ``DIR/<file>``; writes the output block and the q/k/v gradients of
  ``sum(out * cot)`` (the cotangent's block). ``heads`` > 0 instead runs
  ulysses at that head count and records the error it raises.
- ``train``: the 2-layer LM (``DIR/lm.pt`` weights) under ``seq_mode`` at
  ``dp`` x ``sp`` (``ADAPTDL_NUM_REPLICAS`` rewritten to ``dp``, the mesh
  from the topology), SGD(0.05, momentum 0.9) + AdaScale,
  ``steps`` steps at ``(atomic, accum)`` on this replica's block of each
  batch of ``DIR/<batches>.npz``; with ``ckpt_dir`` it restores from
  there first (``restored``, the step and parameters it found) and saves
  after the steps. ``chunked`` > 0 trains on the chunked softmax
  cross-entropy at that vocab chunk (``ops/chunked_xent.py``).
- ``loader``: the first batch an ``AdaptiveDataLoader`` of ``batch`` rows
  yields this process at ``dp`` x ``sp``.
"""

import json
import os
import sys

import numpy as np
import torch

import adaptdl_tpu_torch
from adaptdl_tpu_torch import checkpoint, collective, env

LM_SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)


def attention(task, out_dir, rank):
    from adaptdl_tpu_torch.ops import flash_attention
    from adaptdl_tpu_torch.parallel.mesh import create_mesh
    from adaptdl_tpu_torch.parallel.ring_attention import ring_attention
    from adaptdl_tpu_torch.parallel.ulysses import ulysses_attention

    n = env.num_processes()
    create_mesh({"seq": n})
    if task.get("heads"):
        q = torch.zeros(1, task["heads"], 4, 8)
        try:
            ulysses_attention(q, q, q)
        except ValueError as e:
            return {"error": str(e)}
        return {"error": None}
    data = np.load(os.path.join(out_dir, task["file"]))
    width = data["q"].shape[2] // n

    def block(x):
        return torch.from_numpy(x[:, :, rank * width : (rank + 1) * width].copy())

    q, k, v = (block(data[x]).requires_grad_() for x in "qkv")
    causal = task["causal"]
    mode = task["mode"]
    if mode == "ring":
        out = ring_attention(q, k, v, causal=causal)
    else:
        inner = None
        if mode == "ulysses_flash":
            seq = data["q"].shape[2]
            inner = lambda a, b, c, causal: flash_attention(  # noqa: E731
                a, b, c, causal=causal, block_q=seq // 2, block_k=seq // 2
            )
        out = ulysses_attention(q, k, v, causal=causal, inner_attention=inner)
    grads = torch.autograd.grad((out * block(data["cot"])).sum(), (q, k, v))
    return {"out": out.detach(), "grads": [g.detach() for g in grads]}


def _rewrite_topology(dp, sp):
    """The example's rewrite: the launcher's chip count -> dp replicas."""
    os.environ["ADAPTDL_SEQ_SHARDS"] = str(sp)
    os.environ["ADAPTDL_NUM_REPLICAS"] = str(dp)


def build_trainer(
    seq_mode, sp, init_batch, weights, device="cpu", remat=True, chunked=0
):
    """The LM trainer under SGD(0.05, momentum 0.9) + AdaScale; remat on,
    so the backward re-runs the seq exchanges. ``chunked`` > 0 takes the
    chunked head's loss at that vocab chunk."""
    from adaptdl_tpu_torch.models import TransformerConfig, TransformerLM, lm_pair_loss_fn
    from adaptdl_tpu_torch.ops.chunked_xent import chunked_lm_pair_loss_fn
    from adaptdl_tpu_torch.optim import SGD
    from adaptdl_tpu_torch.scaling_rules import AdaScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    config = TransformerConfig(
        **LM_SIZES, dtype=torch.float32, remat=remat,
        seq_axis="seq" if sp > 1 else None, seq_attention=seq_mode,
    )
    model = TransformerLM(config)
    model.load_state_dict(weights)
    model.to(device)
    loss_fn = chunked_lm_pair_loss_fn(chunked) if chunked else lm_pair_loss_fn
    return ElasticTrainer(
        loss_fn, model, SGD(model.parameters(), lr=0.05, momentum=0.9),
        init_batch_size=init_batch, scaling_rule=AdaScale(), device=device,
    )


def replica_rows(batch, dp, data_rank):
    rows = len(next(iter(batch.values())))
    block = rows // dp
    return {k: v[data_rank * block : (data_rank + 1) * block] for k, v in batch.items()}


def train(task, out_dir, rank):
    from adaptdl_tpu_torch.parallel import mesh as pmesh

    dp, sp = task["dp"], task["sp"]
    _rewrite_topology(dp, sp)
    checkpoint._reset_registry()
    weights = torch.load(os.path.join(out_dir, "lm.pt"))
    trainer = build_trainer(
        task["seq_mode"], sp, task["init_batch"], weights,
        chunked=task.get("chunked", 0),
    )
    holder = {"state": trainer.init_state()}
    result = {"mesh": dict(trainer.mesh.shape)}
    ckpt = None
    if task.get("ckpt_dir"):
        os.environ["ADAPTDL_CHECKPOINT_PATH"] = os.path.join(out_dir, task["ckpt_dir"])
        ckpt = trainer.make_checkpoint_state(
            lambda: holder["state"], lambda s: holder.__setitem__("state", s), name="lm"
        )
        result["restored"] = checkpoint.load_state(ckpt)
        result["resumed_step"] = holder["state"].host_step
        result["resumed_params"] = {
            k: v.detach().clone() for k, v in trainer.model.state_dict().items()
        }
    batches = dict(np.load(os.path.join(out_dir, task["batches"])))
    data_rank = trainer.mesh.index(pmesh.DATA_AXIS)
    step = trainer.train_step(task["atomic"], task["accum"])
    first = task.get("first", 0)
    metrics = []
    for i in range(first, first + task["steps"]):
        batch = replica_rows({k: v[i] for k, v in batches.items()}, dp, data_rank)
        holder["state"], m = step(holder["state"], trainer.to_device(batch))
        metrics.append({k: float(v) for k, v in m.items()})
    result.update(
        steps=metrics,
        params={k: v.detach().clone() for k, v in trainer.model.state_dict().items()},
        gns={k: v.detach().clone() for k, v in holder["state"].gns.tensors().items()
             if k != "prev_grad"},
        step=holder["state"].host_step,
    )
    if ckpt is not None:
        checkpoint.save_all_states()
        collective.barrier()
        ckpt.unregister()
        del os.environ["ADAPTDL_CHECKPOINT_PATH"]
    return result


def loader(task, out_dir, rank):
    from adaptdl_tpu_torch.data import AdaptiveDataLoader

    _rewrite_topology(task["dp"], task["sp"])
    checkpoint._reset_registry()
    dataset = {"x": np.arange(64 * 4, dtype=np.float32).reshape(64, 4)}
    loop = iter(AdaptiveDataLoader(dataset, batch_size=task["batch"]))
    try:
        return {"x": torch.from_numpy(next(loop)["x"])}
    finally:
        loop.close()


TASKS = {"attention": attention, "train": train, "loader": loader}


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
