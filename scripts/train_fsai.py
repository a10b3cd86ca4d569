"""Train stage for the NeuralFSAI model family (framework extension).

Same protocol as scripts/train.py (reference train.py:139-190: params
from params.yaml, 95/5 split, Adam, early stopping, checkpoints +
metrics), but over FSAI plans instead of conv plans.  The learning rate
defaults to params.learning_rate / 10: training starts at the exact FSAI
optimum (zero-init refinement + identity polynomial) and fine-tunes,
which overshoots at the conv-net default.

The default objective is ``pcg_loss`` — the unrolled-PCG residual
proxy for the deployed CG iteration count (metrics.pcg_residual_loss);
``--dp N`` shards each batch over an N-device mesh (SURVEY §2.4 item 1),
``--platform cpu`` trains on the host (8 virtual devices in tests).

Usage: python scripts/train_fsai.py [--max-epochs N] [--loss NAME]
       [--width W] [--power P] [--lr LR] [--pcg-steps K] [--dp N]
       [--platform cpu|gpu] [--poly-degree D]
"""

import argparse
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


class _SubsetView:
    def __init__(self, base, indices):
        self.base = base
        self.indices = list(indices)
        self.batch_size = base.batch_size

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, i):
        return self.base[self.indices[i]]


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--platform", default=None,
                        choices=["cpu", "gpu"])
    parser.add_argument("--dp", type=int, default=0,
                        help="data-parallel devices (0 = single device)")
    args_pre, _ = parser.parse_known_args()

    import jax

    if args_pre.platform:
        jax.config.update("jax_platforms", args_pre.platform)

    from deeppreconditioning_tpu.config import (  # noqa: E402
        get_dataset_class,
        params_show,
    )
    from deeppreconditioning_tpu.models import (  # noqa: E402
        FSAIPlanProvider,
        NeuralFSAI,
        plan_builder_for,
    )
    from deeppreconditioning_tpu.train.trainer import (  # noqa: E402
        train_neural_fsai,
    )

    params = params_show()
    parser.add_argument("--max-epochs", type=int,
                        default=params.max_epochs)
    parser.add_argument("--loss", default="pcg_loss",
                        choices=["pcg_loss", "inverse_loss",
                                 "kaporin_loss"])
    parser.add_argument("--pcg-steps", type=int, default=16)
    parser.add_argument("--width", type=int,
                        default=params.extra.get("fsai_width", 16))
    parser.add_argument("--power", type=int,
                        default=params.extra.get("fsai_power", 3))
    parser.add_argument("--poly-degree", type=int, default=1)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--lr", type=float,
                        default=params.learning_rate / 10)
    parser.add_argument("--patience", type=int, default=params.patience)
    is_flagship = params.model == "NeuralFSAI"
    parser.add_argument(
        "--checkpoint-dir",
        default=(params.checkpoint_dir if is_flagship
                 else "assets/checkpoints_fsai"),
    )
    parser.add_argument(
        "--metrics-dir",
        default=(params.metrics_dir if is_flagship
                 else "assets/metrics_fsai"),
    )
    parser.add_argument("--select-by", default="iterations",
                        choices=["loss", "iterations"])
    parser.add_argument("--init-from", default=None,
                        help="warm-start params from this checkpoint "
                        "(same width/hidden/poly-degree)")
    parser.add_argument("--family", default=None,
                        help="dataset family under data_root (e.g. "
                        "frame_structures for the StAn-like split)")
    parser.add_argument("--plan-kind", default="auto",
                        choices=["auto", "range", "generic"],
                        help="FSAI plan kind; 'generic' for families "
                        "whose pattern spread exceeds the range "
                        "window on some cases (e.g. frames)")
    args = parser.parse_args()

    mesh = None
    if args.dp:
        import numpy as np
        from jax.sharding import Mesh

        devs = jax.devices()
        assert len(devs) >= args.dp, (
            f"requested dp={args.dp} but only {len(devs)} devices"
        )
        mesh = Mesh(np.array(devs[: args.dp]), ("dp",))

    specs = plan_builder_for("NeuralFSAI", None)
    dataset_cls = get_dataset_class(params.data)
    extra_kwargs = {"family": args.family} if args.family else {}
    full = dataset_cls(
        stage="train",
        batch_size=params.batch_size,
        specs=specs,
        root=Path(params.data_root),
        seed=params.seed,
        **extra_kwargs,
    )
    n_batches = len(full)
    n_val = max(1, n_batches * 5 // 100)
    train_set = _SubsetView(full, range(n_batches - n_val))
    val_set = _SubsetView(full, range(n_batches - n_val, n_batches))
    provider = FSAIPlanProvider(full, power=args.power,
                                width=args.width, kind=args.plan_kind)
    model = NeuralFSAI(width=args.width, hidden=args.hidden,
                       poly_degree=args.poly_degree)

    state = train_neural_fsai(
        model, train_set, val_set, provider,
        learning_rate=args.lr,
        patience=args.patience,
        max_epochs=args.max_epochs,
        checkpoint_dir=Path(args.checkpoint_dir),
        metrics_dir=Path(args.metrics_dir),
        seed=params.seed,
        loss=args.loss,
        pcg_steps=args.pcg_steps,
        select_by=args.select_by,
        mesh=mesh,
        init_from=args.init_from,
    )
    print("final step:", int(state.step))


if __name__ == "__main__":
    main()
