from . import loader, meshgen, objects, transforms, types  # noqa: F401
from .loader import from_file, parse  # noqa: F401
from .types import (CameraRT, HostScene, SceneArrays, freeze_scene,  # noqa: F401
                    init_camera)
