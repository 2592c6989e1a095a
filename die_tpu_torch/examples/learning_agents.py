"""Neuroevolution of the NCA agent on the exact engine (twin of the JAX
package's ``examples/learning_agents.py``).

PGPE with ClipUp over the conv perception model's weights
(``learn/train.py::train``: a generation is one lockstep batch of the
exact engine; on CUDA the policy reads its three action channels through
one gather-kernel launch a step); metrics to JSONL, and to MLflow where it
is installed; checkpoints every ``max(1, epochs // 5)`` epochs and the best
agent under ``<outdir>/nca_pgpe_epochs<E>x<I>/``.

Usage: python3 -m die_tpu_torch.examples.learning_agents [--size 96]
       [--epochs 100] [--iters 30] [--dynamics st-perlin-wide]
       [--popsize 10] [--seed 0] [--device cuda]
"""
from __future__ import annotations

import argparse
import datetime
import importlib.util
import os

from die_tpu_torch.core.config import preset
from die_tpu_torch.examples.common import add_device_arg
from die_tpu_torch.learn.train import TrainConfig, train
from die_tpu_torch.models.nca import NCAPolicy
from die_tpu_torch.utils.metrics import JsonlSink, MultiSink, StdoutSink


def make_policy() -> NCAPolicy:
    return NCAPolicy(scale=0.01, deposit=2.0, kernel_sizes=(3, 3))


def run_experiment(field_size=96, epochs=100, epoch_iters=30,
                   dynamics_id="st-perlin-wide", agent_ratio=0.10,
                   popsize=10, seed=0, outdir="saved_models",
                   device="cuda", log_fn=None):
    """Train the NCA policy -> (best params, history).  ``log_fn(epoch,
    metrics)``, where given, also gets each epoch's metrics."""
    dyn = preset(dynamics_id, agent_ratio)
    policy = make_policy()
    cfg = TrainConfig(field_size=(field_size, field_size),
                      max_agents=field_size * field_size,
                      epochs=epochs, epoch_iters=epoch_iters,
                      popsize=popsize, seed=seed)
    print(f"NCA has {policy.num_params()} parameters; "
          f"searcher=pgpe popsize={popsize}")

    stamp = datetime.datetime.now(datetime.UTC).strftime("%Y%m%d-%H%M%S")
    run_dir = os.path.join(outdir, f"nca_pgpe_epochs{epochs}x{epoch_iters}")
    os.makedirs(run_dir, exist_ok=True)
    sinks = [StdoutSink(every=1),
             JsonlSink(os.path.join(run_dir, f"{stamp}.jsonl"))]
    if importlib.util.find_spec("mlflow") is not None:
        from die_tpu_torch.utils.metrics import MlflowSink

        sinks.append(MlflowSink(run_name=f"nca_{stamp}"))
    if log_fn is not None:
        sinks.append(log_fn)
    sink = MultiSink(*sinks)

    best_params, _, history = train(
        dyn, policy, cfg, log_fn=sink, checkpoint_dir=run_dir,
        checkpoint_every=max(1, epochs // 5), device=device)

    agent_file = os.path.join(run_dir, f"{stamp}.npz")
    print(f"Saving the best agent to: {agent_file}")
    policy.save(agent_file, best_params)
    sink.close()
    return best_params, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--size", type=int, default=96)
    ap.add_argument("--epochs", type=int, default=100)
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--dynamics", default="st-perlin-wide",
                    choices=["st-perlin", "st-perlin-wide", "dyn-pred"])
    ap.add_argument("--popsize", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    add_device_arg(ap)
    args = ap.parse_args(argv)
    return run_experiment(field_size=args.size, epochs=args.epochs,
                          epoch_iters=args.iters, dynamics_id=args.dynamics,
                          popsize=args.popsize, seed=args.seed,
                          device=args.device)


if __name__ == "__main__":
    main()
