"""One incarnation of the port's rescale tests (handoff, preemption,
trace), run as a fresh interpreter:

    python tests/torch_rescale_worker.py DIR --steps N [--stop-after K]

The 2-layer transformer LM of tests/torch_replica_worker.py (AdamW,
AdamScale, the Adam-preconditioned statistics) trains on the CPU through
``initialize_job`` -> ``AdaptiveDataLoader`` -> ``ElasticTrainer.run_step``
under whatever the environment sets (checkpoint path, restarts, handoff,
save cadence, preemption listener, supervisor, trace directory). Under
a supervisor it adopts the trace of ``/config``. It restores from its
predecessor first; after ``--stop-after`` steps it
raises the exit flag, so the loader saves, leaves a shard server behind
when the handoff is on, and exits 143. A preemption notice ends it the
same way through the urgent drain. After every step it rewrites
``DIR/report-<restarts>.json`` (``report-<restarts>-rank<r>.json`` on
rank r > 0, under ``adaptdl_tpu_torch.launch``): where each state was
restored from, the trainer state's digest after the restore, the
losses, the handoff's bytes, the restart stats and the preemption
notice.
"""

import argparse
import hashlib
import json
import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import adaptdl_tpu_torch  # noqa: E402
from adaptdl_tpu_torch import (  # noqa: E402
    _signal,
    checkpoint,
    env,
    epoch,
    handoff,
    metrics,
    sched_hints,
)

SIZES = dict(vocab_size=64, num_layers=2, num_heads=2, d_model=32, d_ff=64)
SEQ = 16
BATCH = 8
DATASET = 256


def build(seed, device="cpu"):
    """The tiny LM's trainer, its state holder and checkpoint state."""
    from adaptdl_tpu_torch.models import TransformerConfig, init_transformer, lm_loss_fn
    from adaptdl_tpu_torch.optim import AdamW
    from adaptdl_tpu_torch.scaling_rules import AdamScale
    from adaptdl_tpu_torch.trainer import ElasticTrainer

    config = TransformerConfig(**SIZES, dtype=torch.float32)
    model = init_transformer(config, seed=seed, device=device)
    trainer = ElasticTrainer(
        lm_loss_fn, model, AdamW(model.parameters(), lr=1e-3),
        init_batch_size=BATCH, scaling_rule=AdamScale(), precondition="adam",
        device=device,
    )
    holder = {"state": trainer.init_state()}
    ckpt = trainer.make_checkpoint_state(
        lambda: holder["state"], lambda s: holder.__setitem__("state", s)
    )
    return trainer, holder, ckpt


def digest(state) -> str:
    """sha256 over every tensor of a TrainState, in a fixed order."""
    sha = hashlib.sha256()
    tensors = list(state.model.state_dict().values())
    for p in state.optimizer.params():
        tensors += [v for _, v in sorted(state.optimizer.state[p].items())]
    fields = state.gns.tensors()
    tensors += fields.pop("prev_grad")
    tensors += [fields[k] for k in sorted(fields)]
    tensors += [state.progress, state.step]
    for t in tensors:
        sha.update(t.detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy())
    return sha.hexdigest()


def tokens():
    rng = np.random.default_rng(0)
    return {"tokens": rng.integers(0, SIZES["vocab_size"], (DATASET, SEQ + 1))}


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument("out")
    parser.add_argument("--steps", type=int, default=4)
    parser.add_argument("--stop-after", type=int, default=None)
    args = parser.parse_args()
    from adaptdl_tpu_torch.data import AdaptiveDataLoader
    from adaptdl_tpu_torch.sched import preemption

    adaptdl_tpu_torch.initialize_job(device="cpu")
    # Under a supervisor, join the trace of its current decision.
    sched_hints.fetch_job_config()
    trainer, holder, ckpt = build(seed=env.num_restarts())
    restored = checkpoint.load_state(ckpt)
    metrics.ensure_checkpoint_registered()
    loader = AdaptiveDataLoader(tokens(), batch_size=BATCH)
    report = {"restored": restored, "digest": digest(holder["state"]), "losses": []}
    rank = env.replica_rank()
    path = os.path.join(
        args.out,
        f"report-{env.num_restarts()}" + (f"-rank{rank}" if rank else "") + ".json",
    )

    def write():
        report["loaded_from"] = {
            k: (v if v == checkpoint.HANDOFF_SOURCE else os.path.basename(v))
            for k, v in checkpoint._loaded_from.items()
        }
        report["handoff"] = handoff.fetch_stats()
        report["restart_stats"] = metrics.restart_stats()
        report["notice"] = preemption.notice_state()
        with open(path + ".tmp", "w") as f:
            json.dump(report, f)
        os.replace(path + ".tmp", path)

    write()
    for _ in epoch.remaining_epochs_until(100):
        for batch in loader:
            holder["state"], m = trainer.run_step(holder["state"], batch, loader)
            report["losses"].append(float(m["loss"]))
            report["digest_now"] = digest(holder["state"])
            write()
            if len(report["losses"]) == args.stop_after:
                _signal.set_exit_flag(True)
            if len(report["losses"]) >= args.steps:
                metrics.join_fit()
                return


if __name__ == "__main__":
    main()
