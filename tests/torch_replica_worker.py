"""One replica of the port's multi-replica tests, run under the launcher:

    python -m adaptdl_tpu_torch.launch tests/torch_replica_worker.py \
        parity DIR
    python -m adaptdl_tpu_torch.launch tests/torch_replica_worker.py \
        elastic DIR [--preempt-after K --preempt-rank R] [--autoscale]
    python -m adaptdl_tpu_torch.launch tests/torch_replica_worker.py \
        guarded DIR [--pod-ips ADDR0,ADDR1,...]
    python -m adaptdl_tpu_torch.launch tests/torch_replica_worker.py \
        dcgan DIR

Each rank joins the process group on the CPU through ``initialize_job``
and writes what it saw to ``DIR/rank{r}...``. It imports neither JAX nor
the JAX package: the launcher starts it as a fresh interpreter.

- ``parity``: the 2-layer transformer from ``DIR/weights.pt`` takes
  three steps at accum_steps 0 and then (fresh from the same weights) at
  accum_steps 1 on the global batches ``DIR/batches-accum{a}.npy``, each
  rank stepping on its replica-major block of every batch.
- ``elastic``: a user program of linear regression (ElasticTrainer,
  AdaptiveDataLoader, remaining_epochs_until and an Accumulator) that
  restores from ``ADAPTDL_CHECKPOINT_PATH``; with ``--preempt-after``
  rank R alone raises the exit flag after K of its steps. With
  ``--autoscale`` the loader chooses its batch size from a goodput model
  pinned to ``PINNED_PERF`` (the refits return it), so that the choice
  follows the gradient statistics, which the run determines, and not
  the step times of a loaded host.
- ``guarded``: the same linear regression for one epoch with the guard
  graded at every step (``metrics_every`` 1), under whatever supervisor,
  save cadence and fault schedule the environment sets; each rank
  records every step's loss, state checksum, position and rollbacks,
  and the host its process group was joined at. With ``--pod-ips``
  rank r registers the r-th address as its own (``ADAPTDL_POD_IP``).
- ``dcgan``: the DCGAN pair at 8 features from ``DIR/dcgan-weights.pt``
  takes DCGAN_STEPS alternating steps on the global batches
  ``DIR/dcgan-batches.npz``, each rank on its replica-major block: the
  discriminator under ``ElasticTrainer(has_aux=True)``, the generator
  through ``make_generator_step`` on the rank's own noise.
"""

import argparse
import json
import os

import numpy as np
import torch

import adaptdl_tpu_torch
from adaptdl_tpu_torch import _signal, checkpoint, collective, env, epoch, metrics
from adaptdl_tpu_torch.goodput import PerfParams

# The parity model and step (tests/test_torch_multi_replica.py holds the
# JAX trainer to the same values).
SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)
INIT_BATCH = 2
ATOMIC = 4

TRUE_W = np.array([1.0, -2.0, 3.0, 0.5], np.float32)
# Step time mostly per sample (1 ms each), with a small fixed cost and a
# small sync: throughput barely grows with the batch, so the statistical
# efficiency picks the batch size.
PINNED_PERF = dict(
    alpha_c=1e-4, beta_c=1e-3, alpha_n=1e-3, beta_n=0.0,
    alpha_r=1e-3, beta_r=0.0, gamma=1.0,
)
DATASET_SIZE = 512
EPOCHS = 6


def parity(out_dir):
    from adaptdl_tpu_torch.models import TransformerConfig, TransformerLM, lm_loss_fn
    from adaptdl_tpu_torch.ops import make_flash_attention
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    device = adaptdl_tpu_torch.initialize_job(device="cpu")
    rank = env.process_rank()
    weights = torch.load(os.path.join(out_dir, "weights.pt"))
    for accum in (0, 1):
        model = TransformerLM(TransformerConfig(
            **SIZES, dtype=torch.float32, remat=True,
            attention_fn=make_flash_attention(block_q=16, block_k=16),
        ))
        model.load_state_dict(weights)
        trainer = ElasticTrainer(
            lm_loss_fn, model, AdamW(model.parameters(), lr=3e-4),
            init_batch_size=INIT_BATCH, scaling_rule=AdamScale(),
            precondition="adam", device=device,
        )
        state = trainer.init_state()
        step = trainer.train_step(ATOMIC, accum)
        rows = ATOMIC * (accum + 1)
        steps = []
        for batch in np.load(os.path.join(out_dir, f"batches-accum{accum}.npy")):
            local = {"tokens": batch[rank * rows : (rank + 1) * rows]}
            state, m = step(state, trainer.to_device(local))
            steps.append({k: float(v) for k, v in m.items()})
        torch.save(
            {
                "steps": steps,
                "params": model.state_dict(),
                "gns": {
                    k: v for k, v in state.gns.tensors().items()
                    if k != "prev_grad"
                },
                "step": int(state.step),
            },
            os.path.join(out_dir, f"rank{rank}-accum{accum}.pt"),
        )


def _dataset():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(DATASET_SIZE, 4)).astype(np.float32)
    y = x @ TRUE_W + 0.05 * rng.normal(size=DATASET_SIZE).astype(np.float32)
    return {"x": x, "y": y}


def _mse(model, batch, generator):
    return ((model(batch["x"]).squeeze(-1) - batch["y"]) ** 2).mean()


def elastic(out_dir, preempt_after, preempt_rank, autoscale):
    from adaptdl_tpu_torch.accumulator import Accumulator
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    device = adaptdl_tpu_torch.initialize_job(device="cpu")
    rank = env.process_rank()
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    trainer = ElasticTrainer(
        _mse, model, AdamW(model.parameters(), lr=0.1),
        init_batch_size=32, scaling_rule=AdamScale(), device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = AdaptiveDataLoader(_dataset(), batch_size=32)
    if autoscale:
        loader.autoscale_batch_size(
            128, local_bsz_bounds=(8, 64), gradient_accumulation=True
        )
        pinned = PerfParams(**PINNED_PERF)
        metrics._fit = lambda: pinned
        metrics.current_state().perf_params = pinned
    accum = Accumulator()
    report = {
        "rank": rank,
        "replicas": env.num_replicas(),
        "position": [loader.sampler.epoch, loader.sampler.index],
        "epochs": [],
        "opened": [],
        "closed": [],
        "configs": [],
        "losses": [],
        "steps": 0,
    }
    try:
        for e in epoch.remaining_epochs_until(EPOCHS):
            report["epochs"].append(e)
            # Out of any loop: after a restart into this epoch, this
            # sync replays the total recorded before the preemption.
            with accum.synchronized():
                report["opened"].append(accum["steps"])
            for batch in loader:
                holder["state"], m = trainer.run_step(
                    holder["state"], batch, loader
                )
                accum["steps"] += 1
                accum["rows"] += len(batch["y"])
                report["steps"] += 1
                report["losses"].append(float(m["loss"]))
                report["configs"].append(
                    [loader.current_atomic_bsz, loader.current_accum_steps]
                )
                if report["steps"] == preempt_after and rank == preempt_rank:
                    _signal.set_exit_flag(True)
            with accum.synchronized():
                report["closed"].append([accum["steps"], accum["rows"]])
        metrics.join_fit()
    finally:
        state = metrics.current_state()
        report["params"] = [
            float(x) for p in model.parameters() for x in p.detach().reshape(-1)
        ]
        report["step"] = int(holder["state"].step)
        report["progress"] = float(holder["state"].progress)
        report["max_profiled_replicas"] = state.max_profiled_replicas
        report["profiled_replica_counts"] = sorted(
            {key[1] for key, entry in state.profile.items() if entry.optim_count}
        )
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)


def _state_values(model, optimizer, state):
    """Every float of the parameters, Adam's moments and the noise
    statistics, in a fixed order: equal lists mean equal states."""
    tensors = list(model.parameters())
    for p in optimizer.params():
        tensors += [optimizer.state[p][k] for k in ("exp_avg", "exp_avg_sq")]
    fields = state.gns.tensors()
    tensors += fields.pop("prev_grad") + list(fields.values())
    return [float(x) for t in tensors for x in t.detach().float().reshape(-1)]


def guarded(out_dir, pod_ips):
    from adaptdl_tpu_torch import guard
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    rank = env.process_rank()
    if pod_ips:
        os.environ["ADAPTDL_POD_IP"] = pod_ips.split(",")[rank]
    joined = {}
    join = collective.initialize

    def recorded_join(addr, port, **kwargs):
        joined["host"] = addr
        return join(addr, port, **kwargs)

    collective.initialize = recorded_join
    device = adaptdl_tpu_torch.initialize_job(device="cpu")
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 1)
    trainer = ElasticTrainer(
        _mse, model, AdamW(model.parameters(), lr=0.1),
        init_batch_size=32, scaling_rule=AdamScale(), device=device,
    )
    trainer.metrics_every = 1
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = AdaptiveDataLoader(_dataset(), batch_size=32)
    report = {
        "rank": rank, "group_host": joined.get("host"), "steps": [],
        "hint_posts": [],
    }
    post = metrics.sched_hints.post_sched_hints

    def counted_post(hints):
        ok = post(hints)
        report["hint_posts"].append(ok)
        return ok

    metrics.sched_hints.post_sched_hints = counted_post
    try:
        for _ in epoch.remaining_epochs_until(1):
            for batch in loader:
                span = loader.current_batch_span()
                holder["state"], m = trainer.run_step(
                    holder["state"], batch, loader
                )
                report["steps"].append({
                    "span": list(span),
                    "loss": float(m["loss"]),
                    "rollbacks": guard._get_guard().rollbacks,
                    "step": int(holder["state"].step),
                    "position": [loader.sampler.epoch, loader.sampler.index],
                    "values": _state_values(
                        model, trainer.optimizer, holder["state"]
                    ),
                })
        metrics.join_fit()
    finally:
        report["skip_ranges"] = [list(r) for r in loader._skip_ranges]
        report["guard"] = guard.guard_stats()
        with open(os.path.join(out_dir, f"guarded-rank{rank}.json"), "w") as f:
            json.dump(report, f)


DCGAN_SIZES = dict(latent_dim=8, base_features=8, channels=1)
DCGAN_STEPS = 3


def dcgan_pair(device):
    """(d_trainer, g_step, generator) of the DCGAN test pair."""
    from adaptdl_tpu_torch.models import dcgan
    from adaptdl_tpu_torch.optim import Adam
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    generator, discriminator = dcgan.init_dcgan(device=device, **DCGAN_SIZES)
    trainer = ElasticTrainer(
        dcgan.discriminator_loss_fn, discriminator,
        Adam(discriminator.parameters(), lr=2e-4, b1=0.5), INIT_BATCH,
        has_aux=True, device=device,
    )
    g_step = dcgan.make_generator_step(
        generator, discriminator, Adam(generator.parameters(), lr=2e-4, b1=0.5)
    )
    return trainer, g_step, generator


def dcgan_run(out_dir):
    device = adaptdl_tpu_torch.initialize_job(device="cpu")
    rank, replicas = env.process_rank(), env.num_replicas()
    trainer, g_step, generator = dcgan_pair(device)
    weights = torch.load(os.path.join(out_dir, "dcgan-weights.pt"))
    generator.load_state_dict(weights["generator"])
    trainer.model.load_state_dict(weights["discriminator"])
    batches = np.load(os.path.join(out_dir, "dcgan-batches.npz"))
    state = trainer.init_state()
    rows = len(batches["image"][0]) // replicas
    step = trainer.train_step(rows, 0)
    g_losses = []
    for i in range(DCGAN_STEPS):
        local = {
            k: batches[k][i][rank * rows : (rank + 1) * rows]
            for k in ("image", "z")
        }
        state, _ = step(state, trainer.to_device(local), generator)
        g_losses.append(float(g_step(torch.as_tensor(local["z"]))))
    torch.save(
        {
            "generator": generator.state_dict(),
            "discriminator": trainer.model.state_dict(),
            "g_losses": g_losses,
        },
        os.path.join(out_dir, f"dcgan-rank{rank}.pt"),
    )


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("mode", choices=("parity", "elastic", "guarded", "dcgan"))
    parser.add_argument("out_dir")
    parser.add_argument("--preempt-after", type=int, default=None)
    parser.add_argument("--preempt-rank", type=int, default=1)
    parser.add_argument("--autoscale", action="store_true")
    parser.add_argument("--pod-ips", default=None)
    args = parser.parse_args()
    if args.mode == "parity":
        parity(args.out_dir)
    elif args.mode == "dcgan":
        dcgan_run(args.out_dir)
    elif args.mode == "guarded":
        guarded(args.out_dir, args.pod_ips)
    else:
        elastic(
            args.out_dir, args.preempt_after, args.preempt_rank,
            args.autoscale,
        )


if __name__ == "__main__":
    main()
