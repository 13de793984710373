"""Host-side 4x4 transform builders and the loader's matrix stack.

Mirrors ``RaytracerCore/Vectors/MatrixTransforms.cs:7-37`` and
``RaytracerCore/MatrixStack.cs:10-31``.  All host math is numpy float64 so the
baked scene matches the reference's double-precision loader; conversion to the
compute dtype happens only when the scene is frozen to device arrays.
"""

from __future__ import annotations

import numpy as np


def identity() -> np.ndarray:
    return np.eye(4, dtype=np.float64)


def translate(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[0, 3] = x
    m[1, 3] = y
    m[2, 3] = z
    return m


def scale(x: float, y: float, z: float) -> np.ndarray:
    m = identity()
    m[0, 0] = x
    m[1, 1] = y
    m[2, 2] = z
    return m


def rotate(angle_rad: float, axis: np.ndarray) -> np.ndarray:
    """Axis-angle rotation, Rodrigues form (MatrixTransforms.cs:25-37)."""
    x, y, z = (float(axis[0]), float(axis[1]), float(axis[2]))
    c = np.cos(angle_rad)
    s = np.sin(angle_rad)
    oc = 1.0 - c
    m = identity()
    m[:3, :3] = np.array(
        [
            [c + x * x * oc, x * y * oc - z * s, x * z * oc + y * s],
            [y * x * oc + z * s, c + y * y * oc, y * z * oc - x * s],
            [z * x * oc - y * s, z * y * oc + x * s, c + z * z * oc],
        ],
        dtype=np.float64,
    )
    return m


def transform_point(m: np.ndarray, p) -> np.ndarray:
    p = np.asarray(p, dtype=np.float64)
    return m[:3, :3] @ p + m[:3, 3]


def transform_dir(m: np.ndarray, d) -> np.ndarray:
    d = np.asarray(d, dtype=np.float64)
    return m[:3, :3] @ d


def transpose3x3(m: np.ndarray) -> np.ndarray:
    """Transpose of the rotation block with translation zeroed
    (Mat4x4D.Transpose3x3, Mat4x4D.cs:81) — used for normal matrices."""
    out = identity()
    out[:3, :3] = m[:3, :3].T
    return out


class MatrixStack:
    """Stack of 4x4 matrices seeded with identity (MatrixStack.cs:10-31).

    ``transform`` post-multiplies the top (stack.Peek() * m); ``inv_transform``
    pre-multiplies (m * stack.Peek()) — the loader maintains two stacks in
    lockstep so no matrix is ever inverted (SceneLoader.cs:274-297).
    """

    def __init__(self):
        self._stack = [identity()]

    def peek(self) -> np.ndarray:
        return self._stack[-1]

    def push(self) -> None:
        self._stack.append(self._stack[-1].copy())

    def pop(self) -> None:
        self._stack.pop()

    def transform(self, m: np.ndarray) -> None:
        self._stack[-1] = self._stack[-1] @ m

    def inv_transform(self, m: np.ndarray) -> None:
        self._stack[-1] = m @ self._stack[-1]
