"""Smoke test of the learned-preconditioner pipeline on one GPU.

Runs the main path through the entry points a user calls, one phase
after another, and exits non-zero if any phase fails:

  (a) device: a GPU, its name and power limit, the native host library;
  (b) training: 8 sludge cases (mesh_cells=2) from a fixed seed, the
      committed NeuralFSAI checkpoint at full width, 3 ``pcg_loss``
      train steps, first-step loss against a CPU float64 run;
  (c) PCG on those cases, per case and batched (bench/suite.py), with
      jacobi, fsai and learned; every solve converges, the true residual
      is recomputed in float64 on the host, iterations match a CPU run;
  (d) the structured 128^3 lognormal sigma=1 Poisson solves
      (scripts/scaling_learned.py) with jacobi, classical structured
      FSAI and gmg_learned; the DIA matvec against a scipy float64 CSR
      matvec at that size; block_until_ready against a value fetch;
  (e) kernels: none hand-written stays on this path (PERF.md); the
      batched local solves as compiled for the device, at the setups'
      widths, against numpy float64, timed.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}``.

``--four`` runs only the four-GPU path and its one-GPU comparison:
distributed PCG with the distributed FSAI apply at 256^3, and one
data-parallel train step.  ``--rehearse`` runs every phase on the CPU at
tiny sizes to check the script itself; it prints no result line.

Usage: python chip_smoke.py [--four] [--rehearse]
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
sys.path.insert(0, str(REPO))

SEED = 20240601
# Tolerances, each with its precision:
# (b) first-step pcg_loss (mean log residual after PCG_STEPS steps),
#     GPU float32 against CPU float64, absolute in log units
LOSS_ATOL = 1e-3
PCG_STEPS = 4
# (c) per-case iteration counts, GPU float32 against CPU float32
ITER_BAND = 2
# (c)/(d) solver criterion on the recurrence residual (float32 solve),
#     and the true residual recomputed in float64 on the host, which the
#     float32 solution's rounding may push past the criterion: allowed up
#     to ten times it
RTOL = 1e-8
TRUE_RTOL = 1e-7
# (d) DIA matvec (float32) against scipy CSR (float64), relative to the
#     largest entry
DIA_RTOL = 1e-6
# (e) batched local solves (float32) against numpy float64, relative to
#     the largest entry
KERNEL_RTOL = 1e-4
# --four: distributed against one-GPU solve (both float32)
FOUR_SOL_RTOL = 1e-5


class PhaseError(RuntimeError):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise PhaseError(what)


def log(*parts) -> None:
    print(*parts, flush=True)


def timed(fn, *args, reps: int = 5) -> float:
    """Best wall seconds of ``fn(*args)`` after a compiling call."""
    import jax

    jax.block_until_ready(fn(*args))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


# -- (a) device ----------------------------------------------------------------

def phase_device(ctx) -> None:
    import jax

    from deeppreconditioning_tpu import native

    dev = jax.devices()[0]
    ctx["device"] = dev
    if not ctx["rehearse"]:
        check(dev.platform == "gpu", f"no GPU: first device is {dev}")
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, check=True,
        ).stdout.strip()
        ctx["card"] = smi.splitlines()[0]
        log(smi)  # name, power limit — as nvidia-smi prints them
    else:
        ctx["card"] = f"{dev.platform} (rehearsal)"
    log(f"device: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    check(native.available(), "native host library unavailable")


# -- (b) training --------------------------------------------------------------

def make_cases(n_cases: int) -> Path:
    from deeppreconditioning_tpu.data.fvm import generate_sludge_case, save_case

    import numpy as np

    root = REPO / "assets" / "data" / "smoke"
    fam = root / "sludge_patterns"
    shutil.rmtree(fam, ignore_errors=True)
    rng = np.random.default_rng(SEED)
    for i in range(n_cases):
        save_case(generate_sludge_case(rng, mesh_cells=2),
                  fam / f"case_{i:04d}")
    return root


def load_flagship():
    from deeppreconditioning_tpu.models import NeuralFSAI
    from deeppreconditioning_tpu.train.trainer import load_checkpoint

    payload = load_checkpoint(REPO / "assets" / "checkpoints_fsai"
                              / "best.npz")
    model = NeuralFSAI(width=int(payload["width"]),
                       hidden=int(payload["hidden"]),
                       poly_degree=int(payload["poly_degree"]))
    return model, payload


def training_batch(root: Path, model, power: int, batch_size: int):
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.models import plan_builder_for
    from deeppreconditioning_tpu.models.neural_fsai import FSAIPlanProvider

    ds = SludgePatternDataSet(stage="all", batch_size=batch_size,
                              specs=plan_builder_for("NeuralFSAI", None),
                              shuffle=False, root=root)
    batch = ds[0]
    plans = FSAIPlanProvider(ds, power=power, width=model.width)(0, batch)
    return (plans, batch.features[:, :, 0], batch.systems.to_dense(),
            batch.right_hand_sides)


def phase_training(ctx) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from deeppreconditioning_tpu.train.trainer import (
        TrainState,
        fsai_train_step,
    )

    root = make_cases(8)
    ctx["root"] = root
    model, payload = load_flagship()
    ctx["model"], ctx["payload"] = model, payload
    inputs = training_batch(root, model, int(payload["power"]), 8)
    tx = optax.adam(1e-4)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          payload["params"])
    state = TrainState(params, tx.init(params), jnp.int32(0))
    losses = []
    for _ in range(3):
        state, loss = fsai_train_step(model, tx, state, *inputs,
                                      "pcg_loss", PCG_STEPS)
        losses.append(float(loss))
    log(f"train: width={model.width} hidden={model.hidden} "
        f"degree={model.poly_degree} power={payload['power']} "
        f"losses={losses}")
    check(all(np.isfinite(losses)), f"non-finite loss {losses}")
    moved = max(float(jnp.max(jnp.abs(a - b))) for a, b in zip(
        jax.tree.leaves(state.params), jax.tree.leaves(params)))
    check(moved > 0, "parameters did not change")

    # the same first step on the CPU in float64
    cpu = jax.devices("cpu")[0]
    with jax.enable_x64(True), jax.default_device(cpu):
        to64 = lambda x: (jnp.asarray(np.asarray(x), jnp.float64)  # noqa
                          if np.issubdtype(np.asarray(x).dtype,
                                           np.floating)
                          else jnp.asarray(np.asarray(x)))
        inputs64 = jax.tree.map(to64, inputs)
        params64 = jax.tree.map(to64, payload["params"])
        state64 = TrainState(params64, tx.init(params64), jnp.int32(0))
        _, loss64 = fsai_train_step(model, tx, state64, *inputs64,
                                    "pcg_loss", PCG_STEPS)
        loss64 = float(loss64)
    log(f"train: first-step loss gpu(f32)={losses[0]:.6f} "
        f"cpu(f64)={loss64:.6f} atol={LOSS_ATOL}")
    check(abs(losses[0] - loss64) <= LOSS_ATOL,
          f"first-step loss {losses[0]} vs CPU float64 {loss64}")


# -- (c) PCG on the sludge cases -----------------------------------------------

TECHNIQUES = ("jacobi", "fsai", "learned")


def run_suite(ctx, device):
    import jax

    from deeppreconditioning_tpu.bench.suite import BenchmarkSuite
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.models import plan_builder_for

    with jax.default_device(device):
        ds = SludgePatternDataSet(stage="all", batch_size=1,
                                  specs=plan_builder_for("NeuralFSAI", None),
                                  shuffle=False, root=ctx["root"])
        suite = BenchmarkSuite(
            ds, ctx["model"], ctx["payload"]["params"],
            techniques=TECHNIQUES, kappa_cases=0, timing_reps=2,
            learned_power=int(ctx["payload"]["power"]),
            results_directory=REPO / "assets" / "results" / "smoke",
        )
        suite.run()
        suite.run_batched(reps=2, setup_reps=4)
    return suite


def true_residual(a_sp, rhs, x) -> float:
    import numpy as np

    x = np.asarray(x, np.float64)
    r = rhs - a_sp @ x
    return float(r @ r / (rhs @ rhs))


def phase_pcg(ctx) -> None:
    import jax
    import numpy as np

    gpu = run_suite(ctx, ctx["device"])
    cpu = run_suite(ctx, jax.devices("cpu")[0])
    for name in TECHNIQUES:
        it_g = np.asarray(gpu.iterations[name])
        it_c = np.asarray(cpu.iterations[name])
        bat = gpu.batched[name]
        true_pc, true_b = [], []
        for i in range(len(it_g)):
            a_sp, rhs, n0 = gpu._reconstruct(i)
            true_pc.append(true_residual(
                a_sp, rhs, gpu.solutions[name][i][:n0]))
            true_b.append(true_residual(
                a_sp, rhs, gpu.batched_solutions[name][i][:n0]))
        log(f"pcg {name}: per-case iters gpu={it_g.tolist()} "
            f"cpu={it_c.tolist()} batched={bat['iterations_per_case']} "
            f"success per-case={np.mean(gpu.successes[name]):.0f}% "
            f"batched={bat['success']:.0f}% "
            f"true r2/b2 max per-case={max(true_pc):.3e} "
            f"batched={max(true_b):.3e}")
        check(all(s == 100.0 for s in gpu.successes[name]),
              f"{name}: a per-case solve missed r2/b2 < {RTOL}")
        check(bat["success"] == 100.0,
              f"{name}: a batched solve missed r2/b2 < {RTOL}")
        check(max(true_pc + true_b) < TRUE_RTOL,
              f"{name}: true residual above {TRUE_RTOL}")
        check(np.all(np.abs(it_g - it_c) <= ITER_BAND),
              f"{name}: GPU iterations {it_g} vs CPU {it_c}")
        check(np.all(np.abs(np.asarray(bat["iterations_per_case"])
                            - np.asarray(cpu.batched[name]
                                         ["iterations_per_case"]))
                     <= ITER_BAND),
              f"{name}: batched iterations off the CPU run")


# -- (d) structured 128^3 ------------------------------------------------------

def phase_structured(ctx) -> None:
    import jax.numpy as jnp
    import numpy as np

    sys.path.insert(0, str(REPO / "scripts"))
    from scaling_learned import run_scaling

    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.ops.structured_fsai import (
        dia_sorted_by_offset,
    )
    from deeppreconditioning_tpu.solvers.cg import pcg_fixed_trips

    side = ctx["side"]
    sols: dict = {}
    rows, _ = run_scaling(
        [side], REPO / "assets" / "checkpoints_structured"
        / "deg1_random.npz", sigma=1.0, reps=4,
        out=REPO / "assets" / "results" / "smoke" / "scaling.csv",
        techniques=("jacobi", "fsai", "gmg_learned"), solutions=sols,
    )
    # the operator run_scaling solved (same seed), in float64 on the host
    a = dia_sorted_by_offset(poisson_coeff_dia(
        (side,) * 3, rng=np.random.default_rng(1), sigma=1.0,
        dtype=jnp.float32))
    a_sp = a.to_scipy().tocsr()
    n = a.n
    for row in rows:
        x, b = sols[(side, row["technique"])]
        tr = true_residual(a_sp, np.asarray(b[:n], np.float64), x[:n])
        log(f"{side}^3 {row['technique']}: iters={row['iterations']} "
            f"converged={row['converged']} true r2/b2={tr:.3e} "
            f"setup={row['setup_s'] * 1e3:.3f}ms "
            f"solve={row['solve_s'] * 1e3:.3f}ms")
        check(row["converged"], f"{row['technique']} did not converge")
        check(tr < TRUE_RTOL, f"{row['technique']} true residual {tr}")

    x = np.random.default_rng(3).standard_normal(a.n_pad)
    x[n:] = 0.0
    y = np.asarray(a.matvec(jnp.asarray(x, jnp.float32)), np.float64)
    y_ref = a_sp @ x[:n]
    err = float(np.max(np.abs(y[:n] - y_ref)) / np.max(np.abs(y_ref)))
    log(f"{side}^3 DIA matvec vs scipy float64 CSR: max rel err {err:.2e} "
        f"(limit {DIA_RTOL})")
    check(err < DIA_RTOL, f"DIA matvec error {err}")

    # device barrier: block_until_ready against a value fetch
    d = a.vals[a.offsets.index(0)]
    inv_d = jnp.where(d == 0, 0.0, 1.0 / jnp.where(d == 0, 1.0, d))
    b = jnp.asarray(sols[(side, "jacobi")][1])

    def solve(b_):
        return pcg_fixed_trips(_dia_mv, a, b_, apply_m=_diag_apply,
                               m_data=inv_d, trips=300).x

    t_bur = timed(solve, b)
    t_fetch = float("inf")
    for _ in range(5):
        t0 = time.perf_counter()
        float(solve(b)[0])
        t_fetch = min(t_fetch, time.perf_counter() - t0)
    log(f"{side}^3 jacobi 300-trip solve: block_until_ready "
        f"{t_bur * 1e3:.3f} ms, value fetch {t_fetch * 1e3:.3f} ms "
        f"[{ctx['card']}]")


def _dia_mv(a, x):
    return a.matvec(x)


def _diag_apply(m, r):
    return m * r


# -- (e) kernels ---------------------------------------------------------------

def phase_kernels(ctx) -> None:
    """No hand-written kernel stays on this path (PERF.md, "Kernel
    decisions"): the DIA matvec and the batched Gauss-Jordan are XLA's.
    This phase checks the local solves, as compiled for the device, at
    the setups' real widths against numpy float64, and times them."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from deeppreconditioning_tpu.ops import gauss_jordan as gj

    solve = jax.jit(gj.solve_batched)
    for w, n in ctx["gj_shapes"]:
        rng = np.random.default_rng(w)
        a = rng.standard_normal((n, w, w)).astype(np.float32) * 0.1
        a = a @ a.transpose(0, 2, 1) + np.eye(w, dtype=np.float32)
        e = np.zeros((n, w), np.float32)
        e[:, 0] = 1.0
        sub, rhs = jnp.asarray(a), jnp.asarray(e)
        y = np.asarray(solve(sub, rhs))
        m = min(n, 4096)
        ref = np.linalg.solve(a[:m].astype(np.float64),
                              e[:m, :, None].astype(np.float64))[..., 0]
        err = float(np.max(np.abs(y[:m] - ref)) / np.max(np.abs(ref)))
        t = timed(solve, sub, rhs)
        log(f"gauss-jordan (XLA) w={w} N={n}: {t * 1e3:.3f} ms, rel err "
            f"{err:.1e} (float32 vs numpy float64, limit {KERNEL_RTOL}) "
            f"[{ctx['card']}]")
        check(err < KERNEL_RTOL, f"gauss-jordan w={w} error {err}")


# -- --four ----------------------------------------------------------------------

def phase_four(ctx) -> None:
    import jax
    import jax.numpy as jnp
    import numpy as np
    import optax

    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.ops.structured_fsai import (
        build_structured_plan,
        dia_sorted_by_offset,
        structured_setup,
    )
    from deeppreconditioning_tpu.parallel.fsai import (
        build_sharded_fsai,
        make_fsai_sharded_apply,
    )
    from deeppreconditioning_tpu.parallel.multihost import train_mesh
    from deeppreconditioning_tpu.parallel.partition import (
        pad_vector,
        shard_ell_rows,
    )
    from deeppreconditioning_tpu.parallel.pcg import make_mesh, pcg_sharded
    from deeppreconditioning_tpu.sparse import ELLMatrix
    from deeppreconditioning_tpu.train.trainer import (
        TrainState,
        dp_shard,
        fsai_train_step,
    )

    check(len(jax.devices()) >= 4, f"needs 4 devices, has {jax.devices()}")
    side = ctx["four_side"]
    shape = (side,) * 3
    t0 = time.perf_counter()
    a = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(1), sigma=1.0, dtype=jnp.float32))
    plan = build_structured_plan(shape, power=1)
    bands, _ = structured_setup(a, plan, None)
    bands = np.asarray(bands)  # (w, n_pad) raw-space factor columns
    n, n_pad = a.n, a.n_pad
    cols = np.arange(n_pad)
    out_rows = np.stack([np.where((bands[k] != 0) & (cols + o < n),
                                  cols + o, n_pad)
                         for k, o in enumerate(plan.offsets)], axis=1)
    c_vals = np.where(out_rows < n_pad, bands.T, 0.0).astype(np.float32)
    ell = ELLMatrix.from_scipy(a.to_scipy(), n_pad=n_pad,
                               dtype=jnp.float32)
    b = np.zeros(n_pad, np.float32)
    b[:n] = np.random.default_rng(2).standard_normal(n)
    log(f"four: {side}^3 n={n} host build {time.perf_counter() - t0:.1f}s")

    results = {}
    for shards in (4, 1):
        mesh = make_mesh(shards)
        sharded = shard_ell_rows(ell, shards)
        sf = build_sharded_fsai(out_rows, c_vals, shards,
                                n_total=sharded.n_total)
        m_data = {"u_pos": sf.u_pos, "u_vals": sf.u_vals,
                  "l_pos": sf.l_pos, "l_vals": sf.l_vals}
        b_pad = jnp.asarray(pad_vector(b, sharded.n_total))

        def solve(b_, _mesh=mesh, _a=sharded, _m=m_data, _sf=sf):
            return pcg_sharded(_mesh, _a, b_, m_data=_m,
                               apply_m=make_fsai_sharded_apply(_sf.halo),
                               mode="halo")
        res = solve(b_pad)
        t = timed(lambda b_: solve(b_).x, b_pad, reps=3)
        results[shards] = (np.asarray(res.x)[:n], int(res.iterations),
                           float(res.residual))
        log(f"four: pcg_sharded fsai {shards} device(s): "
            f"iters={int(res.iterations)} r2/b2={float(res.residual):.3e} "
            f"solve {t * 1e3:.3f} ms [{ctx['card']}]")
    x4, it4, r4 = results[4]
    x1, it1, r1 = results[1]
    diff = float(np.linalg.norm(x4 - x1) / np.linalg.norm(x1))
    log(f"four: iterations 4 vs 1 device: {it4} vs {it1}; solution rel "
        f"diff {diff:.2e} (limit {FOUR_SOL_RTOL}, float32)")
    check(r4 < RTOL and r1 < RTOL, "sharded solve did not converge")
    check(abs(it4 - it1) <= 1, f"iterations {it4} vs {it1}")
    check(diff <= FOUR_SOL_RTOL, f"solution rel diff {diff}")

    # one data-parallel train step against the same step on one device
    root = make_cases(8)
    model, payload = load_flagship()
    inputs = training_batch(root, model, int(payload["power"]), 8)
    tx = optax.adam(1e-4)
    params = jax.tree.map(lambda x: jnp.asarray(x, jnp.float32),
                          payload["params"])
    state = TrainState(params, tx.init(params), jnp.int32(0))
    mesh = train_mesh(4)
    s_dp, l_dp = fsai_train_step(model, tx, dp_shard(state, mesh),
                                 *dp_shard(inputs, mesh), "pcg_loss",
                                 PCG_STEPS)
    one = jax.devices()[0]
    s_1, l_1 = fsai_train_step(model, tx, jax.device_put(state, one),
                               *jax.device_put(inputs, one), "pcg_loss",
                               PCG_STEPS)
    p_diff = max(
        float(np.max(np.abs(np.asarray(u) - np.asarray(v)))
              / max(float(np.max(np.abs(np.asarray(v)))), 1e-30))
        for u, v in zip(jax.tree.leaves(s_dp.params),
                        jax.tree.leaves(s_1.params)))
    log(f"four: dp train step loss 4 devices {float(l_dp):.6f} vs 1 "
        f"device {float(l_1):.6f}; params max rel diff {p_diff:.2e}")
    check(abs(float(l_dp) - float(l_1)) <= 1e-4 * abs(float(l_1)),
          "data-parallel loss differs from the one-device step")
    check(p_diff <= FOUR_SOL_RTOL, f"dp params differ by {p_diff}")


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("--four", action="store_true",
                        help="only the four-GPU path and its comparison")
    parser.add_argument("--rehearse", action="store_true",
                        help="CPU, tiny sizes; prints no result line")
    args = parser.parse_args()

    if args.rehearse:
        os.environ["JAX_PLATFORMS"] = "cpu"
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_"
                                   "device_count=4")
    else:
        # keep the CPU backend next to the GPU for the reference runs
        plats = os.environ.get("JAX_PLATFORMS")
        if plats and "cpu" not in plats.split(","):
            os.environ["JAX_PLATFORMS"] = plats + ",cpu"

    import jax

    import deeppreconditioning_tpu  # noqa: F401  (compile cache)

    ctx = {
        "rehearse": args.rehearse,
        "side": 16 if args.rehearse else 128,
        "four_side": 16 if args.rehearse else 256,
        "gj_shapes": (((24, 300), (13, 500), (4, 500)) if args.rehearse
                      else ((24, 102400), (13, 262144), (4, 262144))),
    }
    phases = [("device", phase_device)]
    phases += ([("four", phase_four)] if args.four else [
        ("training", phase_training), ("pcg", phase_pcg),
        ("structured", phase_structured), ("kernels", phase_kernels),
    ])
    for name, fn in phases:
        t0 = time.perf_counter()
        log(f"== phase {name}")
        fn(ctx)
        log(f"== phase {name} ok ({time.perf_counter() - t0:.1f} s)")
    if args.rehearse:
        log("rehearsal finished")
        return 0
    dev = ctx["device"]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
