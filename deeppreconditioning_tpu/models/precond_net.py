"""PreconditionerNet — sparse CNN mapping tril(A) to a tril factor L.

Behavioral contract = reference ``PreconditionerNet``
(uibk/deep_preconditioning/model.py:13-59): a 1x1 conv in, kernel-2 convs
with asymmetric padding — the first half pads rows (1,0), the second half
pads cols (0,1), restoring the spatial shape — a 1x1 conv out, then the
output transform that (a) zeroes features at sites with row < col to force
lower-triangularity and (b) applies softplus on the diagonal so L has a
strictly positive diagonal, making M = L L^T SPD by construction.

Shape: the network runs over a *precomputed index plan*
(ops/sparse_conv.py) — features are a dense (nnz_pad, C) array, every layer
is K gathers + K small GEMMs, and the whole forward jits to a single XLA
program with static shapes.  Batching is an outer ``jax.vmap``.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from deeppreconditioning_tpu.ops.sparse_conv import (
    ConvSpec,
    LayerPlan,
    apply_sparse_conv,
)


def precond_net_specs(channels: Sequence[int]) -> List[ConvSpec]:
    """Static layer specs for a channels list (must have odd length).

    Mirrors the layer construction at model.py:27-40: 1x1 in, kernel-2
    hidden layers with padding (1,0) for the first half and (0,1) for the
    second, 1x1 out.
    """
    assert len(channels) % 2, "channels list must have odd length"
    specs = [ConvSpec((1, 1), (0, 0))]
    n_hidden = len(channels) - 3
    for index in range(n_hidden):
        padding = (1, 0) if index < (len(channels) - 2) // 2 else (0, 1)
        specs.append(ConvSpec((2, 2), padding))
    specs.append(ConvSpec((1, 1), (0, 0)))
    return specs


def param_key(key, *path) -> jax.Array:
    """The PRNG key a parameter is drawn from: the first 4 bytes of the
    SHA-1 of its path (strings as UTF-8, ints big-endian), folded into
    ``key``.  Every model derives its initial parameters this way, so a
    given seed gives the same weights it always has."""
    digest = hashlib.sha1()
    for part in path:
        digest.update(part.encode() if isinstance(part, str)
                      else part.to_bytes((part.bit_length() + 7) // 8,
                                         "big"))
    return jax.random.fold_in(
        key, jnp.uint32(int.from_bytes(digest.digest()[:4], "big")))


def _torch_conv_init(key, k: int, cin: int, cout: int, dtype):
    """Kaiming-uniform init matching torch's Conv2d default (parity with
    the reference's spconv layers)."""
    fan_in = cin * k
    bound = 1.0 / np.sqrt(fan_in)
    kw, kb = jax.random.split(key)
    w = jax.random.uniform(kw, (k, cin, cout), dtype, -bound, bound)
    b = jax.random.uniform(kb, (cout,), dtype, -bound, bound)
    return w, b


@dataclasses.dataclass(frozen=True)
class PreconditionerNet:
    """Fully convolutional sparse net returning lower-triangular factors.

    ``init(key, features, plans)`` returns ``{"params": {w{i}, b{i},
    prelu{i}}}``; ``apply(variables, features, plans)`` runs one sample
    (vmap for batches):
        features: (nnz0_pad, channels[0]) input entry values.
        plans: per-layer LayerPlans from ops.sparse_conv (list length =
            number of layers).

    Returns (nnz_out_pad,) values of L at the final plan's sites.
    """

    channels: Tuple[int, ...] = (1, 16, 32, 64, 32, 16, 1)

    def init(self, key, features=None, plans=None) -> dict:
        del features, plans
        chans = self.channels
        specs = precond_net_specs(chans)
        params = {}
        count = 0  # parameters are numbered in creation order
        for li, spec in enumerate(specs):
            k = spec.kernel[0] * spec.kernel[1]
            io = (k, chans[li], chans[li + 1], jnp.float32)
            params[f"w{li}"] = _torch_conv_init(
                param_key(key, count + 1), *io)[0]
            params[f"b{li}"] = _torch_conv_init(
                param_key(key, count + 2), *io)[1]
            count += 2
            if li < len(specs) - 1:
                # PReLU with torch's default 0.25 slope (model.py:29,37)
                params[f"prelu{li}"] = jnp.full((1,), 0.25, jnp.float32)
                count += 1
        return {"params": params}

    def apply(self, variables, features: jax.Array,
              plans: Sequence[LayerPlan]) -> jax.Array:
        p = variables["params"]
        specs = precond_net_specs(self.channels)
        assert len(plans) == len(specs)

        x = features
        for li in range(len(specs)):
            x = apply_sparse_conv(x, plans[li], p[f"w{li}"], p[f"b{li}"])
            if li < len(specs) - 1:
                x = jnp.where(x >= 0, x, p[f"prelu{li}"] * x)
        return lower_factor_output(x, plans[-1])


def lower_factor_output(x: jax.Array, final) -> jax.Array:
    """Output transform (model.py:53-57): zero the strict upper
    triangle, softplus the diagonal, zero padded sites."""
    vals = x[:, 0]
    vals = jnp.where(final.rows < final.cols, 0.0, vals)
    vals = jnp.where(
        final.rows == final.cols, jax.nn.softplus(vals), vals
    )
    return jnp.where(final.valid, vals, 0.0)


def batched_apply(model: PreconditionerNet, params, features: jax.Array,
                  plans) -> jax.Array:
    """vmap the single-sample forward over a stacked batch.

    Args:
        features: (B, nnz0_pad, C) layer-0 inputs.
        plans: tuple of batched LayerPlans (leaves have leading B).

    Returns (B, nnz_out_pad) values of L at each sample's final sites.
    """
    return jax.vmap(lambda f, p: model.apply(params, f, p))(
        features, plans
    )


def output_to_dense(values: jax.Array, final_plan, n: int) -> jax.Array:
    """Scatter batched L values to dense (B, n, n) lower-tri matrices."""
    from deeppreconditioning_tpu.metrics import scatter_tril_dense

    return scatter_tril_dense(
        values, final_plan.rows, final_plan.cols, final_plan.valid, n
    )
