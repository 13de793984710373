from . import cuda_select, dispatch, kernel_body, torch_ref  # noqa: F401
from .cuda_select import closest_hit_fused  # noqa: F401
from .dispatch import HitRecord, closest_hit  # noqa: F401
