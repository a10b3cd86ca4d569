"""Kernel decisions on the GPU: each hand-written kernel against the
plain form XLA compiles, at the benchmark's shapes.

* DIA SpMV (the CG operator on structured grids): XLA's fused
  ``DIAMatrix.matvec`` against an elementwise copy of the same bytes in
  the same process, at 128^3 and 256^3, plus a Pallas Triton-route
  candidate and a 128^3 Jacobi PCG solve with each.
* Batched Gauss-Jordan (the FSAI / NeuralFSAI setup's local solves):
  a Pallas Triton-route candidate at several block shapes, the XLA
  lane-major form the package uses, the XLA row-major masked form and
  ``jnp.linalg.solve``, alone at
  (w, N) = (24, 102400), (7, 262144), (13, 262144) and end to end in
  the batched learned setup (100 sludge cases) and the 128^3 structured
  FSAI builds.
* Device barrier: ``jax.block_until_ready`` against a value fetch on a
  128^3 Jacobi PCG solve.

Needs a CUDA device.  Writes the numbers to ``--out`` (JSON) and prints
them.  Usage: python scripts/kernel_decisions.py [--out PATH]
"""

from __future__ import annotations

import argparse
import functools
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402
from jax.experimental.pallas import triton as pl_triton  # noqa: E402


def timed(fn, *args, reps: int = 10):
    """(min, median) seconds of ``fn(*args)`` after one compiling call;
    every call ends in ``block_until_ready``."""
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return min(ts), float(np.median(ts))


def per_rep(make_chain, *args, k1: int = 5, k2: int = 25):
    """Seconds per repetition from two chain lengths (the slope removes
    dispatch and launch overhead)."""
    t1 = timed(make_chain(k1), *args)[0]
    t2 = timed(make_chain(k2), *args)[0]
    return (t2 - t1) / (k2 - k1)


# -- DIA SpMV ---------------------------------------------------------------

def _dia_triton_kernel(vals_ref, x_ref, y_ref, *, offsets, halo, block):
    base = pl.program_id(0) * block
    acc = jnp.zeros((block,), y_ref.dtype)
    for d, off in enumerate(offsets):
        acc += (vals_ref[d, pl.ds(base, block)]
                * x_ref[pl.ds(base + halo + off, block)])
    y_ref[pl.ds(base, block)] = acc


INTERPRET = False  # --rehearse: Pallas kernels in interpret mode on CPU


def dia_matvec_triton(a, x, block=1024, num_warps=4):
    """Candidate Pallas (Triton route) DIA SpMV: one program per row
    block, the 7 offsets as shifted loads of the halo-padded x."""
    halo = max(abs(o) for o in a.offsets)
    x_ext = jnp.pad(x, (halo, halo))
    return pl.pallas_call(
        functools.partial(_dia_triton_kernel, offsets=a.offsets,
                          halo=halo, block=block),
        grid=(a.n_pad // block,),
        out_shape=jax.ShapeDtypeStruct((a.n_pad,), x.dtype),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=INTERPRET,
        name="dia_spmv",
    )(a.vals, x_ext)


def mv_xla(a, v):
    return a.matvec(v)


def mv_triton(a, v):
    return dia_matvec_triton(a, v)


def diag_apply(m, r):
    return m * r


def dia_section(out, sides):
    from deeppreconditioning_tpu.solvers.cg import pcg_fixed_trips
    from deeppreconditioning_tpu.sparse.dia import poisson_dia

    def chain(step):
        def make(k):
            @jax.jit
            def run(a, v):
                for _ in range(k):
                    v = jax.lax.optimization_barrier(step(a, v))
                return v
            return run
        return make

    s = jnp.float32(1.0 / 12.0)
    for side in sides:
        a = poisson_dia((side,) * 3, dtype=jnp.float32)
        n_diag = a.vals.shape[0]
        dia_bytes = (n_diag + 2) * a.n_pad * 4  # vals + x read, y written
        x = jnp.asarray(np.random.default_rng(0).standard_normal(a.n_pad),
                        jnp.float32)
        buf = jnp.ones(((n_diag + 2) * a.n_pad) // 2, jnp.float32)

        t_copy = per_rep(chain(lambda _, v: v * s), None, buf)
        t_xla = per_rep(chain(lambda a_, v: a_.matvec(v) * s), a, x)
        rec = {
            "n": a.n, "bytes": dia_bytes,
            "copy_us": t_copy * 1e6,
            "copy_gb_s": dia_bytes / t_copy / 1e9,
            "xla_us": t_xla * 1e6,
            "xla_gb_s": dia_bytes / t_xla / 1e9,
            "xla_over_copy": t_copy / t_xla,
        }
        y_ref = np.asarray(a.matvec(x))
        for block, warps in ((1024, 4), (2048, 8)):
            key = f"triton_b{block}_w{warps}"
            try:
                def step(a_, v, _b=block, _w=warps):
                    return dia_matvec_triton(a_, v, block=_b,
                                             num_warps=_w) * s
                y = np.asarray(jax.jit(step)(a, x)) / float(s)
                err = float(np.max(np.abs(y - y_ref)))
                t = per_rep(chain(step), a, x)
                rec[key] = {"us": t * 1e6, "gb_s": dia_bytes / t / 1e9,
                            "max_abs_err": err}
            except Exception as exc:  # record a refused kernel, go on
                rec[key] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
        out[f"dia_{side}"] = rec
        print(f"dia {side}^3", json.dumps(rec), flush=True)

        if side == sides[0]:
            d = a.vals[a.offsets.index(0)]
            inv_d = jnp.where(d == 0, 0.0, 1.0 / jnp.where(d == 0, 1.0, d))
            b = jnp.where(jnp.arange(a.n_pad) < a.n, x, 0.0)
            trips = 400
            pcg = {}
            for name, mv in (("xla", mv_xla), ("triton", mv_triton)):
                try:
                    def solve(a_, bb, _mv=mv):
                        return pcg_fixed_trips(_mv, a_, bb,
                                               apply_m=diag_apply,
                                               m_data=inv_d, trips=trips)
                    res = solve(a, b)
                    t = timed(solve, a, b, reps=5)
                    pcg[name] = {f"ms_{trips}_trips": t[0] * 1e3,
                                 "iterations": int(res.iterations),
                                 "residual": float(res.residual)}
                except Exception as exc:
                    pcg[name] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
            out[f"dia_pcg_jacobi_{side}"] = pcg
            print(f"dia pcg {side}^3", json.dumps(pcg), flush=True)

            # barrier check: block_until_ready vs a value fetch
            def solve_x(a_, bb):
                return pcg_fixed_trips(mv_xla, a_, bb, apply_m=diag_apply,
                                       m_data=inv_d, trips=trips).x
            jax.block_until_ready(solve_x(a, b))
            tb, tf = [], []
            for _ in range(5):
                t0 = time.perf_counter()
                jax.block_until_ready(solve_x(a, b))
                tb.append(time.perf_counter() - t0)
                t0 = time.perf_counter()
                float(solve_x(a, b)[0])
                tf.append(time.perf_counter() - t0)
            out[f"sync_{side}_pcg"] = {
                "block_until_ready_ms": min(tb) * 1e3,
                "value_fetch_ms": min(tf) * 1e3}
            print("sync", json.dumps(out[f"sync_{side}_pcg"]), flush=True)
        del a, x, buf


# -- Gauss-Jordan -------------------------------------------------------------

def _pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _eliminate(aug, k):
    """Gauss-Jordan step k on a (w, c, N) tile by masks only (``k`` may
    be traced; the Triton route lowers no slices)."""
    w_idx = jax.lax.broadcasted_iota(jnp.int32, aug.shape, 0)
    c_idx = jax.lax.broadcasted_iota(jnp.int32, aug.shape, 1)
    row_k = jnp.sum(jnp.where(w_idx == k, aug, 0.0), axis=0)  # (c, N)
    c_row = jax.lax.broadcasted_iota(jnp.int32, row_k.shape, 0)
    pk = jnp.sum(jnp.where(c_row == k, row_k, 0.0), axis=0)  # (N,)
    row_k = row_k / jnp.where(pk == 0, 1.0, pk)[None]
    col_k = jnp.sum(jnp.where((c_idx == k) & (w_idx != k), aug, 0.0),
                    axis=1)  # (w, N), zero at row k
    return jnp.where(w_idx == k, row_k[None],
                     aug - col_k[:, None] * row_k[None])


def _gj_kernel(aug_ref, y_ref, *, w: int):
    aug = jax.lax.fori_loop(0, w, lambda k, a: _eliminate(a, k),
                            aug_ref[...])
    c_idx = jax.lax.broadcasted_iota(jnp.int32, aug.shape, 1)
    y_ref[...] = jnp.sum(jnp.where(c_idx == w, aug, 0.0), axis=1)


def gauss_jordan_lanes_triton(aug, block=16, num_warps=4):
    """Candidate Pallas (Triton route) form of
    ``ops/gauss_jordan.gauss_jordan_lanes``: each program loads one
    (wp, cp, block) tile (w and w+1 padded to powers of two with zero
    rows and columns), runs the w steps on it in registers and stores
    the solution column once."""
    w, w1, n = aug.shape
    wp, cp = _pow2(w), _pow2(w + 1)
    n_pad = -(-n // block) * block
    aug = jnp.pad(aug, ((0, wp - w), (0, cp - w - 1), (0, n_pad - n)))
    y = pl.pallas_call(
        functools.partial(_gj_kernel, w=w),
        grid=(n_pad // block,),
        in_specs=[pl.BlockSpec((wp, cp, block), lambda i: (0, 0, i))],
        out_specs=pl.BlockSpec((wp, block), lambda i: (0, i)),
        out_shape=jax.ShapeDtypeStruct((wp, n_pad), aug.dtype),
        compiler_params=pl_triton.CompilerParams(num_warps=num_warps,
                                                 num_stages=1),
        interpret=INTERPRET,
        name=f"gauss_jordan_w{w}",
    )(aug)
    return y[:w, :n]


def masked_rowmajor(sub, e):
    """The row-major (N, w, w+1) masked Gauss-Jordan XLA form."""
    w = sub.shape[-1]
    aug = jnp.concatenate([sub, e[..., :, None]], axis=-1)
    row_iota = jnp.arange(w)
    for k in range(w):
        row_k = aug[..., k, :] / aug[..., k, k][..., None]
        col_k = jnp.where(row_iota == k, 0.0, aug[..., :, k])
        aug = aug - col_k[..., :, None] * row_k[..., None, :]
        aug = jnp.where((row_iota == k)[:, None], row_k[..., None, :], aug)
    return aug[..., :, w]


def linalg_solve(sub, e):
    return jnp.linalg.solve(sub, e[..., None])[..., 0]


def gj_variants():
    from deeppreconditioning_tpu.ops import gauss_jordan as gj

    lanes = {"xla_lanes": gj.gauss_jordan_lanes}
    for block, warps in ((8, 4), (16, 4), (32, 8)):
        lanes[f"triton_b{block}_w{warps}"] = functools.partial(
            gauss_jordan_lanes_triton, block=block, num_warps=warps)
    rowmajor = {"xla_masked": masked_rowmajor, "linalg_solve": linalg_solve}
    return lanes, rowmajor


def _as_lanes(solve):
    """Row-major solver -> lane-major signature (transposes included)."""
    def f(aug):
        w = aug.shape[0]
        sub = jnp.transpose(aug[:, :w, :], (2, 0, 1))
        e = jnp.transpose(aug[:, w, :])
        return jnp.transpose(solve(sub, e))
    return f


def _as_rowmajor(lane_fn):
    def f(sub, e):
        from deeppreconditioning_tpu.ops.gauss_jordan import to_lanes
        return jnp.transpose(lane_fn(to_lanes(sub, e)))
    return f


def gj_micro(out, shapes):
    from deeppreconditioning_tpu.ops.gauss_jordan import to_lanes

    lanes, rowmajor = gj_variants()
    for w, n in shapes:
        rng = np.random.default_rng(w)
        a = rng.standard_normal((n, w, w)).astype(np.float32) * 0.1
        a = a @ a.transpose(0, 2, 1) + np.eye(w, dtype=np.float32)
        e = np.zeros((n, w), np.float32)
        e[:, 0] = 1.0
        ref = np.linalg.solve(a[:2048].astype(np.float64),
                              e[:2048, :, None].astype(np.float64))[..., 0]
        sub, ed = jnp.asarray(a), jnp.asarray(e)
        aug = to_lanes(sub, ed)
        rec = {}
        for name, fn in list(lanes.items()) + list(rowmajor.items()):
            try:
                if name in lanes:
                    f = jax.jit(fn)
                    y = np.asarray(f(aug)).T
                    t = timed(f, aug)
                else:
                    f = jax.jit(fn)
                    y = np.asarray(f(sub, ed))
                    t = timed(f, sub, ed)
                err = float(np.max(np.abs(y[:2048] - ref))
                            / np.max(np.abs(ref)))
                rec[name] = {"ms": t[0] * 1e3, "ms_median": t[1] * 1e3,
                             "rel_err": err}
            except Exception as exc:
                rec[name] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
        out[f"gj_w{w}_n{n}"] = rec
        print(f"gj w={w} n={n}", json.dumps(rec), flush=True)


def gj_end_to_end(out, data_root: Path, samples: int, side: int):
    from deeppreconditioning_tpu.data.datasets import SludgePatternDataSet
    from deeppreconditioning_tpu.data.fvm import generate_sludge_case, save_case
    from deeppreconditioning_tpu.data.poisson import poisson_coeff_dia
    from deeppreconditioning_tpu.models import NeuralFSAI, plan_builder_for
    from deeppreconditioning_tpu.models.neural_fsai import (
        FSAIPlanProvider,
        batched_apply_fsai,
    )
    from deeppreconditioning_tpu.ops import gauss_jordan as gj
    from deeppreconditioning_tpu.ops.structured_fsai import (
        build_structured_plan,
        dia_sorted_by_offset,
        structured_setup,
    )
    from deeppreconditioning_tpu.train.trainer import (
        _fsai_operands,
        load_checkpoint,
    )

    lanes, rowmajor = gj_variants()
    orig_lanes, orig_batched = gj.gauss_jordan_lanes, gj.solve_batched

    def use(name):
        jax.clear_caches()
        if name in lanes:
            gj.gauss_jordan_lanes = lanes[name]
            gj.solve_batched = _as_rowmajor(lanes[name])
        else:
            gj.gauss_jordan_lanes = _as_lanes(rowmajor[name])
            gj.solve_batched = rowmajor[name]

    # batched learned setup: the 100-case test split of 500 cases
    fam = data_root / "sludge_patterns"
    if len(list(fam.glob("case_*"))) < samples:
        rng = np.random.default_rng(69420)
        for i in range(samples):
            save_case(generate_sludge_case(rng, mesh_cells=2),
                      fam / f"case_{i:04d}")
    specs = plan_builder_for("NeuralFSAI", None)
    ds = SludgePatternDataSet(stage="test", batch_size=samples // 5,
                              specs=specs, shuffle=False, root=data_root)
    payload = load_checkpoint(REPO / "assets/checkpoints_fsai/best.npz")
    model = NeuralFSAI(width=int(payload["width"]),
                       hidden=int(payload["hidden"]),
                       poly_degree=int(payload["poly_degree"]))
    params = jax.device_put(payload["params"])
    batch = ds[0]
    t0 = time.perf_counter()
    plans = FSAIPlanProvider(ds, power=int(payload["power"]),
                             width=model.width)(0, batch)
    prep_s = time.perf_counter() - t0
    operands = _fsai_operands(plans, batch.features[:, :, 0],
                              batch.systems.to_dense())
    learned = {"cases": int(batch.features.shape[0]),
               "plan_kind": type(plans).__name__,
               "host_plan_s": prep_s}
    ref_c = None
    for name in list(lanes) + list(rowmajor):
        try:
            use(name)
            f = jax.jit(lambda p, pl_, op: batched_apply_fsai(
                model, p, pl_, op).c_vals)
            c = np.asarray(f(params, plans, operands))
            if ref_c is None:
                ref_c = c
            t = timed(f, params, plans, operands)
            learned[name] = {
                "ms": t[0] * 1e3, "ms_median": t[1] * 1e3,
                "max_rel_diff_vs_xla_lanes": float(
                    np.max(np.abs(c - ref_c)) / np.max(np.abs(ref_c))),
            }
        except Exception as exc:
            learned[name] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
    out[f"gj_learned_setup_{samples // 5}"] = learned
    print("gj learned setup", json.dumps(learned), flush=True)

    shape = (side,) * 3
    a = dia_sorted_by_offset(poisson_coeff_dia(
        shape, rng=np.random.default_rng(1), sigma=1.0, dtype=jnp.float32))
    for power in (1, 2):
        plan = build_structured_plan(shape, power=power)
        rec = {"width": plan.width}
        for name in list(lanes) + list(rowmajor):
            try:
                use(name)
                f = jax.jit(lambda a_: structured_setup(a_, plan, None)[0])
                t = timed(f, a, reps=5)
                rec[name] = {"ms": t[0] * 1e3, "ms_median": t[1] * 1e3}
            except Exception as exc:
                rec[name] = {"error": f"{type(exc).__name__}: {exc}"[:300]}
        out[f"gj_structured_{side}_p{power}"] = rec
        print(f"gj structured p{power}", json.dumps(rec), flush=True)
    gj.gauss_jordan_lanes, gj.solve_batched = orig_lanes, orig_batched
    jax.clear_caches()


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--out", default=str(
        REPO / "assets" / "results" / "kernel_decisions.json"))
    parser.add_argument("--data-root", default=str(
        REPO / "assets" / "data" / "kernel_decisions"))
    parser.add_argument("--only", default="dia,gj,e2e")
    parser.add_argument("--rehearse", action="store_true",
                        help="tiny sizes on the CPU, Pallas kernels in "
                        "interpret mode (checks the script, times nothing "
                        "worth keeping)")
    args = parser.parse_args()

    global INTERPRET
    INTERPRET = args.rehearse
    dev = jax.devices()[0]
    if dev.platform != "gpu" and not args.rehearse:
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    if args.rehearse:
        sides, shapes, samples, side = (8, 16), ((7, 256), (24, 300)), 20, 8
    else:
        sides = (128, 256)
        shapes = ((24, 102400), (7, 262144), (13, 262144))
        samples, side = 500, 128
    smi = "" if args.rehearse else subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
    ).stdout.strip()
    out = {"device_kind": dev.device_kind, "nvidia_smi": smi}
    print(dev.device_kind, "|", smi, flush=True)
    only = set(args.only.split(","))
    if "dia" in only:
        dia_section(out, sides)
    if "gj" in only:
        gj_micro(out, shapes)
    if "e2e" in only:
        gj_end_to_end(out, Path(args.data_root), samples, side)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))


if __name__ == "__main__":
    main()
