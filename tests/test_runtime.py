"""Runtime pieces with no model behind them: the pytree dataclass helper,
the params.yaml reader, compile-cache placement, the HBM peak table, the
committed checkpoints, and chip_smoke.py's refusal to run without a
GPU."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from deeppreconditioning_tpu.utils import struct

REPO = Path(__file__).resolve().parent.parent


# -- struct ---------------------------------------------------------------------

@struct.dataclass
class _Pair:
    values: jax.Array
    scale: jax.Array
    width: int = struct.field(pytree_node=False)
    tag: str = struct.field(pytree_node=False, default="t")


def test_struct_dynamic_fields_are_leaves():
    p = _Pair(values=jnp.arange(3.0), scale=jnp.float32(2.0), width=3)
    leaves = jax.tree.leaves(p)
    assert len(leaves) == 2
    doubled = jax.tree.map(lambda x: 2 * x, p)
    np.testing.assert_allclose(np.asarray(doubled.values), [0, 2, 4])
    assert doubled.width == 3 and doubled.tag == "t"


def test_struct_static_fields_key_the_jit_cache():
    traces = []

    @jax.jit
    def f(p):
        traces.append(p.width)
        return p.values * p.scale * p.width

    a = _Pair(values=jnp.ones(3), scale=jnp.float32(1.0), width=2)
    b = _Pair(values=jnp.ones(3) * 5, scale=jnp.float32(3.0), width=2)
    c = _Pair(values=jnp.ones(3), scale=jnp.float32(1.0), width=4)
    f(a), f(b)
    assert traces == [2]  # same static width: one trace
    np.testing.assert_allclose(np.asarray(f(c)), [4.0] * 3)
    assert traces == [2, 4]  # a new static value retraces


def test_struct_is_frozen_and_replace_works():
    p = _Pair(values=jnp.zeros(2), scale=jnp.float32(1.0), width=1)
    with pytest.raises(Exception):
        p.width = 5
    q = p.replace(width=7)
    assert q.width == 7 and p.width == 1
    vmapped = jax.vmap(lambda x: x.values.sum())(
        _Pair(values=jnp.ones((4, 2)), scale=jnp.ones(4), width=1)
    )
    np.testing.assert_allclose(np.asarray(vmapped), [2.0] * 4)


# -- params.yaml ----------------------------------------------------------------

# params.yaml as a full YAML parser reads it
EXPECTED_PARAMS = {
    "model": "NeuralFSAI", "data": "SludgePatternDataSet",
    "number_samples": 500, "resolution": 128, "mesh_cells": 2,
    "channels": [1, 16, 32, 64, 32, 16, 1], "batch_size": 4,
    "learning_rate": 0.001, "patience": 16, "loss": "inverse_loss",
    "schedule": "constant", "seed": 69, "data_root": "assets/data/raw",
    "checkpoint_dir": "assets/checkpoints_fsai",
    "metrics_dir": "assets/metrics_fsai", "fsai_power": 4,
    "fsai_width": 24, "results_dir": "assets/results", "max_epochs": 200,
}


def test_read_params_matches_yaml_values():
    from deeppreconditioning_tpu.config import read_params

    got = read_params((REPO / "params.yaml").read_text())
    assert got == EXPECTED_PARAMS
    assert all(type(got[k]) is type(v) for k, v in EXPECTED_PARAMS.items())


def test_read_params_scalars_lists_and_comments():
    from deeppreconditioning_tpu.config import read_params

    text = (
        "# header\n"
        "a: 1  # trailing\n"
        "b: 2.5e-3\n"
        "c: 'quoted # not a comment'\n"
        "d: true\n"
        "e: ~\n"
        "f:\n"
        "- x\n"
        "- 3\n"
        "g: plain text\n"
    )
    assert read_params(text) == {
        "a": 1, "b": 2.5e-3, "c": "quoted # not a comment", "d": True,
        "e": None, "f": ["x", 3], "g": "plain text",
    }
    with pytest.raises(ValueError):
        read_params("a:\n  nested: 1\n")


def test_params_show_merges_defaults(tmp_path):
    from deeppreconditioning_tpu.config import params_show

    (tmp_path / "p.yaml").write_text("model: PreconditionerNet\nextra_key: 3\n")
    p = params_show(tmp_path / "p.yaml")
    assert p.model == "PreconditionerNet"
    assert p.extra == {"extra_key": 3}


# -- compile cache --------------------------------------------------------------

def test_compile_cache_follows_env(monkeypatch, tmp_path):
    from deeppreconditioning_tpu import runtime

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.configure_compile_cache() == str(tmp_path)
    # nothing is set in code when the variable is given
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_checkout(monkeypatch):
    from deeppreconditioning_tpu import runtime

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        got = runtime.configure_compile_cache()
        assert got == str(REPO / ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


# -- HBM peak table -------------------------------------------------------------

def test_peak_table_raises_on_unknown_device():
    from deeppreconditioning_tpu.utils.profiling import hbm_peak_gb_s

    with pytest.raises(KeyError):
        hbm_peak_gb_s("cpu")
    with pytest.raises(KeyError):
        hbm_peak_gb_s("Some Future Accelerator")
    assert hbm_peak_gb_s("NVIDIA H100 80GB HBM3") == 3350.0


def test_roofline_report_needs_a_known_peak():
    from deeppreconditioning_tpu.utils.profiling import RooflineReport

    with pytest.raises(KeyError):  # the CPU has no entry: no default
        RooflineReport("k", seconds=1e-3, nnz=10, bytes_moved=100,
                       flops=20)
    r = RooflineReport("k", seconds=1e-3, nnz=10, bytes_moved=3.35e9,
                       flops=20, hbm_gb_s=3350.0)
    assert abs(r.bandwidth_fraction - 1.0) < 1e-12


# -- committed checkpoints ------------------------------------------------------

CHECKPOINTS = [
    "assets/checkpoints/best.npz",
    "assets/checkpoints_frames/best.npz",
    "assets/checkpoints_frames/latest.npz",
    "assets/checkpoints_fsai/best.npz",
    "assets/checkpoints_fsai/k16_best.npz",
    "assets/checkpoints_fsai/k8_best.npz",
    "assets/checkpoints_fsai/latest.npz",
    "assets/checkpoints_fsai_d2/best.npz",
    "assets/checkpoints_fsai_d2/latest.npz",
    "assets/checkpoints_fsai_k8/best.npz",
    "assets/checkpoints_fsai_k8/latest.npz",
    "assets/checkpoints_structured/best.npz",
    "assets/checkpoints_structured/deg0.npz",
    "assets/checkpoints_structured/deg0_p1.npz",
    "assets/checkpoints_structured/deg1_random.npz",
    "assets/checkpoints_unet/best.npz",
    "assets/checkpoints_unet/latest.npz",
    "assets/checkpoints_v2/best.npz",
    "assets/checkpoints_v2/latest.npz",
]


def _model_for(payload):
    from deeppreconditioning_tpu import models

    if "width" in payload:
        return models.NeuralFSAI(width=int(payload["width"]),
                                 hidden=int(payload["hidden"]),
                                 poly_degree=int(payload["poly_degree"]))
    inner = payload["params"]["params"]
    cls = (models.PreconditionerSparseUNet if "w_enc1" in inner
           else models.PreconditionerNet)
    return cls(channels=tuple(payload["channels"]))


@pytest.mark.parametrize("rel", CHECKPOINTS)
def test_checkpoint_loads_into_its_model(rel):
    """Every committed checkpoint loads, holds finite float32 weights in
    exactly the tree its model's init builds, and (when it carries an
    optimizer state) resumes into an optax Adam state."""
    import optax

    from deeppreconditioning_tpu.train.trainer import (
        load_checkpoint,
        resume_state,
    )

    path = REPO / rel
    payload = load_checkpoint(path)
    model = _model_for(payload)
    if isinstance(model, tuple):  # pragma: no cover
        raise AssertionError(model)
    init = (model.init(jax.random.PRNGKey(0), None,
                       jnp.zeros((1,), jnp.float32))
            if "width" in payload else model.init(jax.random.PRNGKey(0)))
    assert jax.tree.structure(init) == jax.tree.structure(
        jax.tree.map(jnp.asarray, payload["params"]))
    for a, b in zip(jax.tree.leaves(init),
                    jax.tree.leaves(payload["params"])):
        assert a.shape == b.shape and b.dtype == np.float32
        assert np.isfinite(b).all()
    if "opt_state" in payload:
        state = resume_state(path, optax.adam(1e-3))
        assert int(state.step) == payload["step"]


def test_checkpoint_roundtrip_keeps_metadata(tmp_path):
    from deeppreconditioning_tpu.train.trainer import (
        load_checkpoint,
        write_checkpoint,
    )

    params = {"params": {"dense": {"kernel": np.ones((2, 3), np.float32)},
                         "q": np.zeros(2, np.float32)}}
    write_checkpoint(tmp_path / "c.npz", {
        "params": params, "step": 4, "train_shape": [3, 4],
        "family": "x", "final_loss": -1.5,
    })
    got = load_checkpoint(tmp_path / "c.npz")
    assert got["step"] == 4 and got["train_shape"] == [3, 4]
    assert got["family"] == "x" and got["final_loss"] == -1.5
    np.testing.assert_array_equal(got["params"]["params"]["dense"]["kernel"],
                                  params["params"]["dense"]["kernel"])


# -- chip_smoke.py --------------------------------------------------------------

def _run_smoke(cwd: Path) -> subprocess.CompletedProcess:
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "no GPU" in proc.stderr


def test_chip_smoke_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
