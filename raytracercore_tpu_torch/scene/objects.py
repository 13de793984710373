"""Compound objects: the axis-aligned cube expanding to six mirrored quads.

Mirrors ``Raytracing/Objects/Cube.cs:9-124`` and
``Triangle.CreateRectangle`` (Primitives/Triangle.cs:13-20).  A cube side is a
single mirrored-quad triangle (the ``mirror`` flag makes the UV test accept
the whole parallelogram).  The single-box ``CubePrimitive`` path is dead code
in the reference (Objects/Cube.cs:92-94) and is intentionally not carried.
"""

from __future__ import annotations

from typing import List

import numpy as np

from .types import HostTriangle

# Side bit flags (Cube.cs:12-20)
X_POS, X_NEG, Y_POS, Y_NEG, Z_POS, Z_NEG = 1, 2, 4, 8, 16, 32
ALL_SIDES = X_POS | X_NEG | Y_POS | Y_NEG | Z_POS | Z_NEG
NO_SIDES = 0

IMPLICIT_INSTANCE = "implicit"  # ObjectConsts.ImplicitInstance (IObject.cs:8)

_SIDE_BY_AXIS = {
    "x": (X_POS, X_NEG),
    "y": (Y_POS, Y_NEG),
    "z": (Z_POS, Z_NEG),
}


def get_side(name: str) -> int:
    """Parse a side name: ``x``/``+x``/``-x`` etc. (Cube.GetSide,
    Cube.cs:22-61).  The implicit instance maps to no sides."""
    if name == IMPLICIT_INSTANCE:
        return 0
    if name == "all":
        return ALL_SIDES
    if len(name) == 2 and name[0] == "-" and name[1] in _SIDE_BY_AXIS:
        return _SIDE_BY_AXIS[name[1]][1]
    axis = ""
    if len(name) == 2 and name[0] == "+":
        axis = name[1]
    elif len(name) == 1:
        axis = name
    if axis in _SIDE_BY_AXIS:
        return _SIDE_BY_AXIS[axis][0]
    raise ValueError(f"Unknown Cube side name {name}.")


def create_rectangle(origin: np.ndarray, up: np.ndarray, normal: np.ndarray,
                     width: float, height: float) -> HostTriangle:
    """Triangle.CreateRectangle (Triangle.cs:13-20): a mirrored quad centered
    at ``origin`` spanning ``width`` along up×normal and ``height`` along up."""
    up = np.asarray(up, dtype=np.float64)
    up = up / np.linalg.norm(up)
    side = np.cross(up, normal)
    side = side / np.linalg.norm(side)
    v0 = origin + up * (-height / 2.0) + side * (-width / 2.0)
    v1 = v0 + side * width
    v2 = v0 + up * height
    return HostTriangle(v0=v0, v1=v1, v2=v2, mirror=True)


class Cube:
    """Six-sided box emitting one mirrored quad per requested side
    (Cube.GetChildren, Cube.cs:90-116)."""

    def __init__(self, position, size):
        self.position = np.asarray(position, dtype=np.float64)
        self.size = np.asarray(size, dtype=np.float64)

    def _rect(self, up, norm, dist, width, height) -> HostTriangle:
        norm = np.asarray(norm, dtype=np.float64)
        origin = self.position + norm * (dist / 2.0)
        return create_rectangle(origin, np.asarray(up, np.float64), norm,
                                width, height)

    def get_children(self, sides: int) -> List[HostTriangle]:
        sx, sy, sz = self.size
        out = []
        if sides & X_POS:
            out.append(self._rect((0, 0, 1), (1, 0, 0), sx, sy, sz))
        if sides & X_NEG:
            out.append(self._rect((0, 0, -1), (-1, 0, 0), sx, sy, sz))
        if sides & Y_POS:
            out.append(self._rect((0, 0, 1), (0, 1, 0), sy, sx, sz))
        if sides & Y_NEG:
            out.append(self._rect((0, 0, -1), (0, -1, 0), sy, sx, sz))
        if sides & Z_POS:
            out.append(self._rect((0, 1, 0), (0, 0, 1), sz, sx, sy))
        if sides & Z_NEG:
            out.append(self._rect((0, -1, 0), (0, 0, -1), sz, sx, sy))
        return out

    def get_children_named(self, instance: str) -> List[HostTriangle]:
        return self.get_children(get_side(instance))
