"""Differentiable scene parameters vs fixed structure (port of
diff/params.py).

The float fields of a SceneArrays (sphere centers and radii, quad corner
and edge vectors, material albedo/fuzz/IOR/emission) are the parameters a
fit moves; the int and bool fields (material ids, kind codes, validity
masks) are discrete structure.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

# Differentiable scene-parameter fields (all f32).
FLOAT_FIELDS = (
    "sph_center",
    "sph_radius",
    "quad_corner",
    "quad_u",
    "quad_v",
    "mat_albedo",
    "mat_fuzz",
    "mat_ior",
    "mat_emit",
)

Params = Dict[str, torch.Tensor]


def scene_params(scene) -> Params:
    """The parameter dict of a scene (its float fields, not copied)."""
    return {f: getattr(scene, f) for f in FLOAT_FIELDS}


def apply_params(scene, params: Params):
    """The scene with `params` grafted over the template's floats."""
    return dataclasses.replace(scene, **params)


def params_from_numpy(arrays: Mapping[str, np.ndarray], device) -> Params:
    """Parameters on `device` from numpy arrays keyed by field name (the
    JAX package's `scene_params(scene)`, for example): every FLOAT_FIELDS
    key is required, every bit is kept, and a dtype other than float32
    raises."""
    missing = set(FLOAT_FIELDS) - set(arrays)
    if missing:
        raise KeyError(f"params lack fields {sorted(missing)}")
    out = {}
    for name in FLOAT_FIELDS:
        a = np.asarray(arrays[name])
        if a.dtype != np.float32:
            raise TypeError(f"{name}: expected float32, got {a.dtype}")
        out[name] = torch.from_numpy(np.array(a)).to(device)   # own copy
    return out
