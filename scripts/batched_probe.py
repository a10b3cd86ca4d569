"""Probe the batched benchmark protocol on the real chip.

Runs BenchmarkSuite.run_batched on the full test split (the driver
headline configuration) at one or more sparsification widths and prints
per-technique stats — iteration parity vs the per-case protocol is the
correctness check, batch wall time the tuning signal.

Usage: python scripts/batched_probe.py [--widths 48 96] [--irregular]
"""

import argparse
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--irregular", action="store_true")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--chunk", type=int, default=20)
    args = parser.parse_args()

    from deeppreconditioning_tpu.bench.suite import BenchmarkSuite
    from deeppreconditioning_tpu.config import params_show
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.models import NeuralFSAI, plan_builder_for
    from deeppreconditioning_tpu.train.trainer import load_checkpoint

    params = params_show(REPO / "params.yaml")
    root = REPO / params.data_root
    specs = plan_builder_for(params.model, params.channels)
    family = "sludge_patterns_3d" if args.irregular else "sludge_patterns"
    ds = SludgePatternDataSet(
        stage="test", batch_size=1, specs=specs, shuffle=False,
        root=root, family=family,
    )
    payload = load_checkpoint(REPO / params.checkpoint_dir / "best.npz")
    model = NeuralFSAI(
        width=int(payload["width"]),
        hidden=int(payload.get("hidden", 64)),
        poly_degree=int(payload.get("poly_degree", 1)),
    )
    fsai_power = 2 if args.irregular else 4
    learned_power = 2 if args.irregular else int(payload.get("power", 4))

    suite = BenchmarkSuite(
        ds, model, payload["params"],
        techniques=("vanilla", "jacobi",
                    "incomplete_cholesky_neumann", "fsai", "learned"),
        kappa_cases=0,
        fsai_power=fsai_power,
        learned_power=learned_power,
        results_directory=REPO / "assets" / "results" / "probe",
    )
    print(f"=== batched dense protocol, family={family} ===", flush=True)
    t0 = time.perf_counter()
    stats = suite.run_batched(
        reps=args.reps, chunk=args.chunk, verbose=True
    )
    print(f"wall: {time.perf_counter() - t0:.1f}s")
    tot = {k: v["total_batch"] for k, v in stats.items()}
    if "learned" in tot:
        print(f"learned_vs_jacobi: {tot['jacobi'] / tot['learned']:.3f}"
              f"  learned_vs_fsai: {tot['fsai'] / tot['learned']:.3f}")
    it = {k: round(v["iterations"], 2) for k, v in stats.items()}
    print("iterations:", it, flush=True)


if __name__ == "__main__":
    main()
