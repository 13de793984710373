from . import builder, cuda_traverse, traverse  # noqa: F401
from .builder import (BVHArrays, build_bvh, build_triangle_bvh,  # noqa: F401
                      bvh_arrays_from_numpy)
from .traverse import count_node_hits, traverse_closest  # noqa: F401
