"""Test stage — preconditioner benchmark (dvc.yaml:29-43 parity).

Mirrors the reference test entry point (test.py:201-221): load the test
split with batch size 1, restore the trained model, run the benchmark
suite, dump table.csv / totals.csv / eigenvalues.csv.

Usage: python scripts/test.py [--kappa-cases N]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from deeppreconditioning_tpu.bench.suite import BenchmarkSuite  # noqa: E402
from deeppreconditioning_tpu.config import (  # noqa: E402
    get_dataset_class,
    get_model_class,
    params_show,
)
from deeppreconditioning_tpu.models import plan_builder_for  # noqa: E402
from deeppreconditioning_tpu.train.trainer import load_checkpoint  # noqa: E402


def main() -> None:
    params = params_show()
    parser = argparse.ArgumentParser()
    parser.add_argument("--kappa-cases", type=int, default=5)
    parser.add_argument(
        "--techniques", default="vanilla,jacobi,incomplete_cholesky,learned",
        help="comma list; 'all' = every technique incl. ILU + AMG",
    )
    parser.add_argument("--checkpoint", type=Path, default=None)
    parser.add_argument("--verbose", action="store_true")
    parser.add_argument("--timing-reps", type=int, default=10)
    parser.add_argument("--family", default=None,
                        help="dataset family (e.g. sludge_patterns_3d "
                        "for the irregular split)")
    parser.add_argument("--fsai-power", type=int, default=0,
                        help="override fsai pattern power (0 = default)")
    parser.add_argument("--results-dir", default=None)
    args = parser.parse_args()

    specs = plan_builder_for(params.model, params.channels)
    dataset_cls = get_dataset_class(params.data)
    ds_kwargs = {"family": args.family} if args.family else {}
    data_set = dataset_cls(
        stage="test",
        batch_size=1,
        specs=specs,
        shuffle=False,
        root=Path(params.data_root),
        **ds_kwargs,
    )

    ckpt_path = args.checkpoint or (
        Path(params.checkpoint_dir) / "best.npz"
    )
    payload = load_checkpoint(ckpt_path)
    model_params = payload["params"]
    if params.model == "NeuralFSAI":
        from deeppreconditioning_tpu.models import NeuralFSAI

        model = NeuralFSAI(
            width=int(payload["width"]),
            hidden=int(payload.get("hidden", 64)),
            poly_degree=int(payload.get("poly_degree", 1)),
        )
    else:
        model_cls = get_model_class(params.model)
        model = model_cls(channels=tuple(params.channels))

    if args.techniques == "all":
        techniques = ("vanilla", "jacobi", "incomplete_cholesky",
                      "incomplete_cholesky_neumann", "incomplete_lu",
                      "algebraic_multigrid", "fsai", "learned")
    else:
        techniques = tuple(args.techniques.split(","))
    suite_kwargs = {}
    if params.model == "NeuralFSAI":
        # the learned technique's pattern power is baked into the
        # checkpoint; the classical fsai baseline keeps its own optimum
        suite_kwargs["learned_power"] = int(payload.get("power", 4)) or 4
    if args.fsai_power:
        suite_kwargs["fsai_power"] = args.fsai_power
        if params.model == "NeuralFSAI":
            suite_kwargs["learned_power"] = min(
                suite_kwargs["learned_power"], args.fsai_power
            )
    results_dir = Path(args.results_dir or params.results_dir)
    suite = BenchmarkSuite(
        data_set,
        model,
        model_params,
        techniques=techniques,
        kappa_cases=args.kappa_cases,
        timing_reps=args.timing_reps,
        results_directory=results_dir,
        **suite_kwargs,
    )
    suite.run(verbose=args.verbose)
    suite.dump_csv()
    try:  # box plots (reference defines plot_histograms, test.py:157)
        for parameter, figure in suite.plot_histograms():
            figure.savefig(
                results_dir / f"{parameter}_boxplot.png",
                dpi=120, bbox_inches="tight",
            )
    except ImportError:
        pass  # no matplotlib in this environment
    for name, stats in suite.summary().items():
        print(f"{name}: iters={stats['iterations']:.1f} "
              f"total={stats['total'] * 1e3:.2f}ms "
              f"kappa={stats['kappa']:.3g} "
              f"success={stats['success']:.0f}%")


if __name__ == "__main__":
    main()
