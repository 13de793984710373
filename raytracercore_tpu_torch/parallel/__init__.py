from . import distributed, mesh, shard  # noqa: F401
from .distributed import gather_film, init_distributed  # noqa: F401
from .mesh import make_mesh, ray_slice  # noqa: F401
from .shard import (make_overlapped_train_step,  # noqa: F401
                    make_prims_sharded_render_pass, make_sharded_render_pass,
                    make_train_loop, make_train_step, pad_triangles_for_prims,
                    place_film, place_scene)
