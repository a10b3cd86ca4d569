"""Config system — params.yaml replacement for dvc.api.params_show.

The reference injects hyperparameters into every entry point through
``dvc.api.params_show()`` reading ``params.yaml``
(reference: params.yaml:1-15; train.py:145, test.py:207,
generate_data.py:90).  Same file and keys here, read by ``read_params``,
which parses the flat YAML subset the file uses (``key: scalar`` lines,
``- item`` lists under a bare ``key:``, ``#`` comments); model/dataset
selection stays string-keyed (train.py:147-154's getattr registry
pattern).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from pathlib import Path
from typing import List

DEFAULT_PARAMS = {
    # reference params.yaml defaults
    "model": "PreconditionerNet",
    "data": "SludgePatternDataSet",
    "number_samples": 500,
    "resolution": 128,
    "mesh_cells": 2,
    "channels": [1, 16, 32, 64, 32, 16, 1],
    "batch_size": 4,
    "learning_rate": 0.001,
    "patience": 16,
    # rebuild-specific knobs
    "loss": "inverse_loss",
    "schedule": "constant",
    "seed": 69,
    "data_root": "assets/data/raw",
    "checkpoint_dir": "assets/checkpoints",
    "metrics_dir": "assets/metrics",
    "results_dir": "assets/results",
    "max_epochs": 200,
}


@dataclass
class Params:
    model: str
    data: str
    number_samples: int
    resolution: int
    mesh_cells: int
    channels: List[int]
    batch_size: int
    learning_rate: float
    patience: int
    loss: str
    schedule: str
    seed: int
    data_root: str
    checkpoint_dir: str
    metrics_dir: str
    results_dir: str
    max_epochs: int
    extra: dict = field(default_factory=dict)


def _scalar(text: str):
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    lowered = text.lower()
    if lowered in ("true", "false"):
        return lowered == "true"
    if lowered in ("null", "~", ""):
        return None
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment (at line start or after whitespace) that is
    not inside quotes."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1].isspace()):
            return line[:i]
    return line


def read_params(text: str) -> dict:
    """Parse the flat YAML subset of params.yaml into a dict."""
    out: dict = {}
    current = None  # key whose ``- item`` list is being read
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if not line.strip():
            continue
        stripped = line.strip()
        if stripped.startswith("- ") or stripped == "-":
            if current is None:
                raise ValueError(f"list item outside a list: {raw!r}")
            out[current].append(_scalar(stripped[1:]))
            continue
        if line[0].isspace() or ":" not in line:
            raise ValueError(f"unsupported params line: {raw!r}")
        key, value = line.split(":", 1)
        key = key.strip()
        if value.strip():
            out[key] = _scalar(value)
            current = None
        else:
            out[key] = []
            current = key
    return out


def params_show(path: str | Path = "params.yaml") -> Params:
    """Load params.yaml merged over defaults (dvc.api.params_show
    equivalent)."""
    merged = dict(DEFAULT_PARAMS)
    p = Path(path)
    if p.exists():
        merged.update(read_params(p.read_text()))
    known = {k: merged.pop(k) for k in list(DEFAULT_PARAMS)}
    return Params(**known, extra=merged)


def get_model_class(name: str):
    """String -> model class (getattr registry, train.py:147)."""
    import deeppreconditioning_tpu.models as models

    return getattr(models, name)


def get_dataset_class(name: str):
    """String -> dataset class (train.py:154)."""
    import deeppreconditioning_tpu.data.datasets as datasets

    return getattr(datasets, name)
