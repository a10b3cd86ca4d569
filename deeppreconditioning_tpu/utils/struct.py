"""Frozen dataclasses registered as JAX pytrees.

``dataclass`` fields are pytree children (traced, vmapped, sharded)
unless declared with ``field(pytree_node=False)``, which makes them
static metadata: part of the treedef, compared and hashed by jit as a
cache key.  Static values must therefore be hashable (ints, tuples).
"""

from __future__ import annotations

import dataclasses

import jax


def field(pytree_node: bool = True, **kwargs):
    """A dataclass field; ``pytree_node=False`` marks it static."""
    metadata = dict(kwargs.pop("metadata", None) or {})
    metadata["pytree_node"] = pytree_node
    return dataclasses.field(metadata=metadata, **kwargs)


def dataclass(cls):
    """Frozen dataclass + pytree registration + a ``replace`` method."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    data, meta = [], []
    for f in dataclasses.fields(cls):
        (data if f.metadata.get("pytree_node", True) else meta).append(
            f.name
        )
    jax.tree_util.register_dataclass(
        cls, data_fields=data, meta_fields=meta
    )
    cls.replace = dataclasses.replace
    return cls
