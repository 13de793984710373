"""A configuration's scene, made once and handed to both sides.

``make(config)`` returns the benchmark's own inputs: the reference's
numpy tables and camera, and what the program is given (the scene text
itself, or the generated tables).  ``for_program`` turns them into the
program's objects through its public entry points; the program derives
its own tables from there.
"""

from __future__ import annotations

import dataclasses

from . import meshfield, spherefield
from .reference import scene_text


@dataclasses.dataclass
class SceneInputs:
    tables: dict      # numpy tables (rtbench.reference.tables.load)
    camera: dict      # the render camera's numbers
    text: str | None  # the scene text, for a text scene


def make(config: dict) -> SceneInputs:
    scene = config["scene"]
    width, height = config["size"]
    if scene["kind"] == "text":
        text = "\n".join(scene["text"])
        tables, cameras = scene_text.parse(text)
        if [tables["width"], tables["height"]] != [width, height] or \
                tables["recursion"] != config["recursion"]:
            raise ValueError(f"{config['name']}: the scene text's size and "
                             "recursion differ from the configuration's")
        return SceneInputs(tables, cameras[config.get("camera", 0)], text)
    if scene["kind"] == "icosphere_field":
        tables, camera = meshfield.make(
            scene["grid"], scene["subdiv"], scene["seed"],
            config["recursion"], width, height)
        return SceneInputs(tables, camera, None)
    if scene["kind"] == "sphere_field":
        tables, camera = spherefield.make(
            scene["grid"], scene["seed"], scene["ellipsoid"],
            config["recursion"], width, height)
        return SceneInputs(tables, camera, None)
    raise ValueError(f"unknown scene kind {scene['kind']!r}")


def for_program(inputs: SceneInputs, device):
    """``(scene, cameras)`` for the program's ``Renderer`` and train step:
    a parsed ``HostScene`` (``cameras`` None: it carries its own) or
    ``SceneArrays`` with their ``HostCamera`` list."""
    if inputs.text is not None:
        from raytracercore_tpu_torch.scene import loader

        return loader.parse(inputs.text), None
    from raytracercore_tpu_torch.scene.types import (HostCamera,
                                                     scene_arrays_from_numpy)

    c = inputs.camera
    cam = HostCamera(mode="frustum", position=c["position"],
                     look_at=c["look_at"], up=c["up"], fov_or_size=c["fov"])
    return scene_arrays_from_numpy(inputs.tables, device=device), [cam]
