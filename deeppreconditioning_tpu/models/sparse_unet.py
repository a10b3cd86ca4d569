"""PreconditionerSparseUNet — U-Net over sparse matrix patterns.

Behavioral port of the reference ``PreconditionerSparseUNet``
(uibk/deep_preconditioning/model.py:62-179): SubMConv2d encoders,
stride-2 SparseConv2d downsamplers, SparseInverseConv2d upsamplers that
restore the downsampler's input active set (indice_key semantics), and
sparse_add skip connections, finishing with the same lower-triangular
mask + softplus diagonal output transform.

Shape: all index maps are precomputed host-side by
``UNetPlanBuilder`` (ops/sparse_conv.py builders).  Because an inverse
conv restores *exactly* the site set (and order) of the matching
downsampler's input, every skip connection operates on identically-laid-
out feature arrays — ``sparse_add`` reduces to plain elementwise
addition, with no add-index maps at runtime.

Deviations from the reference, by design:
  * the output 1x1 conv emits 1 channel; the reference emits
    ``channels[5]`` channels (model.py:137) of which consumers only ever
    read channel 0 (test.py:103, metrics.py:44) — the extra channels are
    dead weight.
  * LeakyReLU keeps torch's default negative slope 0.01.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from deeppreconditioning_tpu.models.precond_net import (
    _torch_conv_init,
    lower_factor_output,
    param_key,
)
from deeppreconditioning_tpu.ops.sparse_conv import (
    ConvSpec,
    LayerPlan,
    SamplePlanHost,
    apply_sparse_conv,
    build_conv_maps,
    build_inverse_conv_maps,
)

_SUBM3 = ConvSpec((3, 3), (1, 1), stride=1, submanifold=True)
_DOWN = ConvSpec((3, 3), (1, 1), stride=2, submanifold=False)
_SUBM1 = ConvSpec((1, 1), (0, 0), stride=1, submanifold=True)

# (name, spec_kind, in_level, out_level); kinds: subm3, down, up, subm1
UNET_TOPOLOGY = (
    ("enc1", "subm3", 0, 0),
    ("down1", "down", 0, 1),
    ("enc2", "subm3", 1, 1),
    ("down2", "down", 1, 2),
    ("enc3", "subm3", 2, 2),
    ("down3", "down", 2, 3),
    ("enc4", "subm3", 3, 3),
    ("bneck", "down", 3, 4),
    ("up3", "up", 4, 3),
    ("dec3", "subm3", 3, 3),
    ("up2", "up", 3, 2),
    ("dec2", "subm3", 2, 2),
    ("up1", "up", 2, 1),
    ("dec1", "subm3", 1, 1),
    ("up0", "up", 1, 0),
    ("dec0", "subm3", 0, 0),
    ("out", "subm1", 0, 0),
)

# skip connections: layer index (into UNET_TOPOLOGY) whose output is
# added to the upsampler's output (sparse_add, model.py:156-168) — both
# live on the same site set so the add is elementwise.
UNET_SKIPS = {"up3": "enc4", "up2": "enc3", "up1": "enc2", "up0": "enc1"}


class UNetPlanBuilder:
    """Host-side index-plan builder for the U-Net topology.

    Implements the dataset plan-builder protocol (``build``): returns a
    SamplePlanHost whose 17 layers follow UNET_TOPOLOGY, with site-set
    levels 0..4 (level k = input set downsampled k times).
    """

    def build(self, rows: np.ndarray, cols: np.ndarray,
              hw: Tuple[int, int]) -> SamplePlanHost:
        plan = SamplePlanHost(shapes=[hw])
        # downsampling chain: site sets + shapes per level
        level_sites = [(rows.astype(np.int32), cols.astype(np.int32))]
        level_hw = [hw]
        for _ in range(4):
            r, c = level_sites[-1]
            o_rows, o_cols, _, hw_out = build_conv_maps(
                r, c, level_hw[-1], _DOWN
            )
            level_sites.append((o_rows, o_cols))
            level_hw.append(hw_out)
        plan.level_nnz = [s[0].shape[0] for s in level_sites]

        for name, kind, in_lv, out_lv in UNET_TOPOLOGY:
            in_r, in_c = level_sites[in_lv]
            out_r, out_c = level_sites[out_lv]
            if kind == "subm3":
                _, _, gather, _ = build_conv_maps(
                    in_r, in_c, level_hw[in_lv], _SUBM3
                )
            elif kind == "subm1":
                gather = np.arange(in_r.shape[0], dtype=np.int32)[None, :]
            elif kind == "down":
                o_rows, o_cols, gather, _ = build_conv_maps(
                    in_r, in_c, level_hw[in_lv], _DOWN
                )
                # determinism check: strided conv output must equal the
                # precomputed level sites (same unique/sort path)
                assert np.array_equal(o_rows, out_r)
                assert np.array_equal(o_cols, out_c)
            elif kind == "up":
                gather = build_inverse_conv_maps(
                    in_r, in_c, level_hw[in_lv], out_r, out_c, _DOWN
                )
            else:  # pragma: no cover
                raise ValueError(kind)
            plan.layer_rows.append(out_r)
            plan.layer_cols.append(out_c)
            plan.layer_gather.append(gather)
            plan.shapes.append(level_hw[out_lv])
            plan.in_level.append(in_lv)
            plan.out_level.append(out_lv)
        return plan


@dataclasses.dataclass(frozen=True)
class PreconditionerSparseUNet:
    """U-Net mapping tril(A) patterns to lower-triangular factors L.

    ``init(key, features, plans)`` returns ``{"params": {w_<layer>,
    b_<layer>}}``; ``apply(variables, features (nnz0_pad, channels[0]),
    plans: 17 LayerPlans in UNET_TOPOLOGY order)`` runs one sample (vmap
    for batches).  Uses channels[0..5] like the reference
    (model.py:69-137).
    """

    channels: Tuple[int, ...] = (1, 16, 32, 64, 32, 16, 1)

    def _io(self):
        c = self.channels
        # per-layer (Cin, Cout); mirrors model.py:69-137
        return {
            "enc1": (c[0], c[1]), "down1": (c[1], c[2]),
            "enc2": (c[2], c[2]), "down2": (c[2], c[3]),
            "enc3": (c[3], c[3]), "down3": (c[3], c[4]),
            "enc4": (c[4], c[4]), "bneck": (c[4], c[5]),
            "up3": (c[5], c[4]), "dec3": (c[4], c[4]),
            "up2": (c[4], c[3]), "dec2": (c[3], c[3]),
            "up1": (c[3], c[2]), "dec1": (c[2], c[2]),
            "up0": (c[2], c[1]), "dec0": (c[1], c[1]),
            "out": (c[1], 1),
        }

    def init(self, key, features=None, plans=None) -> dict:
        del features, plans
        io = self._io()
        params = {}
        for li, (name, kind, _, _) in enumerate(UNET_TOPOLOGY):
            k = 1 if kind == "subm1" else 9
            shape = (k, *io[name], jnp.float32)
            # parameters are numbered in creation order: w, b per layer
            params[f"w_{name}"] = _torch_conv_init(
                param_key(key, 2 * li + 1), *shape)[0]
            params[f"b_{name}"] = _torch_conv_init(
                param_key(key, 2 * li + 2), *shape)[1]
        return {"params": params}

    def apply(self, variables, features: jax.Array,
              plans: Sequence[LayerPlan]) -> jax.Array:
        p = variables["params"]

        def leaky(x):
            return jnp.where(x >= 0, x, 0.01 * x)

        saved = {}
        x = features
        for li, (name, _, _, _) in enumerate(UNET_TOPOLOGY):
            x = apply_sparse_conv(
                x, plans[li], p[f"w_{name}"], p[f"b_{name}"]
            )
            if name != "out":
                x = leaky(x)
            if name in UNET_SKIPS:
                x = x + saved[UNET_SKIPS[name]]  # sparse_add, same sites
            if name.startswith("enc"):
                saved[name] = x
        return lower_factor_output(x, plans[-1])
