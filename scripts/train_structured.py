"""Train the structured-grid NeuralFSAI head for the scaling family.

The flagship's refinement MLP and polynomial wrap are width-local
(per-column features only), so a head trained on SMALL grids deploys
unchanged at 64^3/128^3+ (ops/structured_fsai.py) — this script trains
it end-to-end *through the structured ops* so the train and deploy slot
layouts are identical by construction (see structured_refine's
docstring; the generic-plan checkpoints pack boundary slots
differently).

Family: variable-coefficient 7-point Poisson operators (lognormal
kappa, harmonic face means — data/poisson.py), one fixed grid shape per
run; the loss is the log squared relative residual after K unrolled PCG
steps with the deployed factor-form apply (the structured analog of
metrics.pcg_residual_loss — same objective as the reference's
validation metric, train.py:102-108).

Usage: python scripts/train_structured.py [--shape 12,12,12]
    [--samples 32] [--steps 400] [--lr 2e-3] [--power 2] [--degree 1]
    [--pcg-steps 12] [--platform cpu|gpu] [--out PATH]
"""

import argparse
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

REPO = Path(__file__).resolve().parent.parent


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--shape", default="12,12,12")
    parser.add_argument("--samples", type=int, default=32)
    parser.add_argument("--steps", type=int, default=400)
    parser.add_argument("--lr", type=float, default=2e-3)
    parser.add_argument("--power", type=int, default=2)
    parser.add_argument("--degree", type=int, default=1)
    parser.add_argument("--hidden", type=int, default=64)
    parser.add_argument("--pcg-steps", type=int, default=12)
    parser.add_argument("--sigma", default="1.0",
                        help="coefficient contrast: a float, or "
                        "'LO:HI' for per-sample uniform draws (trains "
                        "a contrast-robust head)")
    parser.add_argument("--rhs", default="random",
                        choices=["random", "ax"],
                        help="training rhs protocol — match the "
                        "deployment benchmark (scaling_learned --rhs)")
    parser.add_argument("--seed", type=int, default=69)
    parser.add_argument("--platform", default=None,
                        choices=["cpu", "gpu"])
    parser.add_argument(
        "--out",
        default=str(REPO / "assets" / "checkpoints_structured"
                    / "best.npz"),
    )
    args = parser.parse_args()

    import jax

    if args.platform:
        jax.config.update("jax_platforms", args.platform)

    import jax.numpy as jnp
    import numpy as np
    import optax

    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.train.trainer import write_checkpoint
    from deeppreconditioning_tpu.ops.structured_fsai import (
        build_structured_plan,
        dia_sorted_by_offset,
        make_structured_poly_apply,
        structured_setup,
    )
    from deeppreconditioning_tpu.sparse.dia import DIAMatrix

    shape = tuple(int(s) for s in args.shape.split(","))
    plan = build_structured_plan(shape, power=args.power)
    w = plan.width
    print(f"shape={shape} pattern width={w} offsets={plan.offsets}",
          flush=True)

    if ":" in str(args.sigma):
        lo, hi = (float(s) for s in str(args.sigma).split(":"))
    else:
        lo = hi = float(args.sigma)

    rng = np.random.default_rng(args.seed)
    mats, rhss = [], []
    for _ in range(args.samples):
        a = dia_sorted_by_offset(poisson_coeff_dia(
            shape, rng=rng, sigma=float(rng.uniform(lo, hi)),
            dtype=jnp.float32,
        ))
        mats.append(np.asarray(a.vals))
        if args.rhs == "ax":
            x_star = np.zeros(a.n_pad, np.float32)
            x_star[:a.n] = rng.standard_normal(a.n)
            rhss.append(np.asarray(a.matvec(jnp.asarray(x_star))))
        else:
            b_np = np.zeros(a.n_pad, np.float32)
            b_np[:a.n] = rng.standard_normal(a.n)
            rhss.append(b_np)
    a0 = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(0), dtype=jnp.float32
    ))
    offsets_a = a0.offsets
    n = a0.n
    a_vals = jnp.asarray(np.stack(mats))  # (S, n_diag, n_pad)
    b_all = jnp.asarray(np.stack(rhss))  # (S, n_pad)

    # lecun-normal kernels, zero biases (the NeuralFSAI init;
    # alpha/beta/q zero-init => training starts at classical FSAI)
    def lecun(key, shape_):
        fan_in = shape_[0]
        return (jax.random.truncated_normal(key, -2.0, 2.0, shape_)
                * np.sqrt(1.0 / fan_in) / 0.87962566103423978)

    k0, k1 = jax.random.split(jax.random.PRNGKey(args.seed))
    feat = 4 * w
    params = {
        "dense0": {"kernel": lecun(k0, (feat, args.hidden)),
                   "bias": jnp.zeros((args.hidden,))},
        "dense1": {"kernel": lecun(k1, (args.hidden, args.hidden)),
                   "bias": jnp.zeros((args.hidden,))},
        "alpha": {"kernel": jnp.zeros((args.hidden, w)),
                  "bias": jnp.zeros((w,))},
        "beta": {"kernel": jnp.zeros((args.hidden, w)),
                 "bias": jnp.zeros((w,))},
        "q_coeffs": jnp.zeros((args.degree + 1,)),
    }
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32), params)

    apply_fn = make_structured_poly_apply(plan.offsets, args.degree)

    def case_loss(params, vals, b):
        a = DIAMatrix(vals=vals, offsets=offsets_a, n=n)
        # safeguard off in training: the clamp's jnp.where would zero
        # q's gradients the moment it engages, freezing the head; the
        # deployment-time safeguard (structured_setup default) is what
        # protects out-of-distribution systems
        bands, q = structured_setup(
            a, plan, {"params": params}, safeguard=False
        )
        m_data = (bands, q, a)
        bb = jnp.maximum(jnp.sum(b * b), 1e-30)
        x = jnp.zeros_like(b)
        r = b
        z = apply_fn(m_data, r)
        p = r * 0 + z
        for _ in range(args.pcg_steps):
            ap = a.matvec(p)
            rz = jnp.sum(r * z)
            denom = jnp.sum(ap * p)
            alpha = rz / jnp.where(denom == 0, 1.0, denom)
            x = x + alpha * p
            r = r - alpha * ap
            z = apply_fn(m_data, r)
            beta = jnp.sum(r * z) / jnp.where(rz == 0, 1.0, rz)
            p = z + beta * p
        return jnp.log(jnp.maximum(jnp.sum(r * r) / bb, 1e-28))

    def loss_fn(params, vals_b, b_b):
        return jnp.mean(jax.vmap(
            lambda v, b: case_loss(params, v, b)
        )(vals_b, b_b))

    tx = optax.adam(args.lr)
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, vals_b, b_b):
        loss, grads = jax.value_and_grad(loss_fn)(params, vals_b, b_b)
        updates, opt_state = tx.update(grads, opt_state)
        return optax.apply_updates(params, updates), opt_state, loss

    best = (np.inf, params)
    t0 = time.time()
    for it in range(args.steps):
        prev = params  # loss is evaluated at PRE-update params — pair
        # them (the post-update params can be the exploding step that
        # produced a NaN on the NEXT loss)
        params, opt_state, loss = step(params, opt_state, a_vals, b_all)
        loss = float(loss)
        if loss < best[0]:
            best = (loss, prev)
        if it % 25 == 0 or it == args.steps - 1:
            print(f"step {it:4d} loss {loss:+.4f} "
                  f"(best {best[0]:+.4f}, {time.time()-t0:.0f}s)",
                  flush=True)

    out = Path(args.out)
    payload = {
        "params": {"params": jax.tree.map(np.asarray, best[1])},
        "width": w,
        "hidden": args.hidden,
        "poly_degree": args.degree,
        "power": args.power,
        "family": "structured_poisson",
        "train_shape": list(shape),
        "sigma": [lo, hi],
        "rhs": args.rhs,
        "final_loss": float(best[0]),
    }
    write_checkpoint(out, payload)
    print(f"saved {out} (loss {best[0]:+.4f})", flush=True)


if __name__ == "__main__":
    main()
