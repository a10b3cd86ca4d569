"""Content-addressed stage skipping (scripts/repro.py, dvc.lock parity)."""

import importlib.util
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
spec = importlib.util.spec_from_file_location(
    "repro", REPO / "scripts" / "repro.py"
)
repro = importlib.util.module_from_spec(spec)
sys.modules["repro"] = repro
spec.loader.exec_module(repro)


def _stage(tmp_path, name="s"):
    dep = tmp_path / "dep"
    out = tmp_path / "out.txt"
    dep.mkdir(exist_ok=True)
    (dep / "a.bin").write_bytes(b"data-v1")
    out.write_text("result")
    # Stage paths must live under REPO for relative lock keys; monkey
    # the module REPO to the tmp dir instead
    repro.REPO = tmp_path
    return repro.Stage(
        name, "noop.py", ["alpha", "beta"], deps=[dep], outs=[out]
    )


def test_skip_only_when_everything_matches(tmp_path):
    stage = _stage(tmp_path)
    params = {"alpha": 1, "beta": "x", "gamma": "ignored"}
    lock = {stage.name: stage.record(params)}
    assert repro.should_skip(stage, params, lock)

    # params change invalidates
    assert not repro.should_skip(stage, {**params, "alpha": 2}, lock)
    # irrelevant param change does not
    assert repro.should_skip(stage, {**params, "gamma": "other"}, lock)


def test_dep_content_change_invalidates(tmp_path):
    stage = _stage(tmp_path)
    params = {"alpha": 1, "beta": "x"}
    lock = {stage.name: stage.record(params)}
    (tmp_path / "dep" / "a.bin").write_bytes(b"data-v2-regenerated")
    assert not repro.should_skip(stage, params, lock)


def test_missing_or_tampered_output_invalidates(tmp_path):
    stage = _stage(tmp_path)
    params = {"alpha": 1, "beta": "x"}
    lock = {stage.name: stage.record(params)}
    (tmp_path / "out.txt").write_text("hand-edited")
    assert not repro.should_skip(stage, params, lock)
    (tmp_path / "out.txt").unlink()
    assert not repro.should_skip(stage, params, lock)


def test_no_lock_entry_runs(tmp_path):
    stage = _stage(tmp_path)
    assert not repro.should_skip(stage, {"alpha": 1, "beta": "x"}, {})


def test_downstream_chain_invalidation(tmp_path):
    """Regenerating stage-1 output (stage-2 dep) invalidates stage 2
    even though stage 2's own outputs exist — the dvc.lock behavior the
    presence-based skipper lacked."""
    repro.REPO = tmp_path
    data = tmp_path / "data"
    data.mkdir()
    (data / "case.npz").write_bytes(b"cases-v1")
    ckpt = tmp_path / "best.npz"
    ckpt.write_bytes(b"weights-v1")
    gen = repro.Stage("generate", "g.py", ["n"], deps=[], outs=[data])
    train = repro.Stage("train", "t.py", ["lr"], deps=[data], outs=[ckpt])
    params = {"n": 5, "lr": 0.1}
    lock = {
        "generate": gen.record(params),
        "train": train.record(params),
    }
    assert repro.should_skip(train, params, lock)
    # "re-run" generate with a different sample count
    (data / "case.npz").write_bytes(b"cases-v2-more-samples")
    assert not repro.should_skip(gen, {**params, "n": 9}, lock)
    assert not repro.should_skip(train, params, lock)
