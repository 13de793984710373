"""Differentiable-parameter views of the scene (counterpart of
``raytracercore_tpu.diff.params``).

The material fields (emission, diffuse, specular, transmission colour,
IOR, shininess — the six per-primitive fields of Primitive.cs:96-133) are
the optimization targets.  In PyTorch's idiom they are a dict of leaf
tensors that a ``torch.optim`` optimizer updates in place;
:func:`with_material_params` splices them into a scene for one step.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..scene.types import SceneArrays

MATERIAL_FIELDS = ("emission", "diffuse", "specular", "refraction",
                   "refractive_index", "shininess")


def get_material_params(scene: SceneArrays) -> dict:
    """The scene's material fields as fresh leaf tensors that require
    grad (copies: updating them leaves ``scene`` as it is)."""
    return {f: getattr(scene.materials, f).detach().clone()
            .requires_grad_(True) for f in MATERIAL_FIELDS}


def with_material_params(scene: SceneArrays, params: dict) -> SceneArrays:
    """The scene with ``params`` spliced into its material table.  Packed
    geometry tables the scene already holds are kept
    (:meth:`SceneArrays.with_materials`)."""
    return scene.with_materials(
        dataclasses.replace(scene.materials, **params))


def material_params_from_numpy(params, device="cpu",
                               dtype=torch.float32) -> dict:
    """Leaf tensors that require grad from the JAX package's material
    params (a mapping of field → array, e.g. ``get_material_params`` of a
    JAX scene with numpy leaves), copied value for value."""
    return {f: torch.tensor(np.asarray(params[f]), dtype=dtype,
                            device=device).requires_grad_(True)
            for f in MATERIAL_FIELDS}
