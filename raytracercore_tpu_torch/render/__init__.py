from . import camera, film, fused, integrator, renderer  # noqa: F401
from .film import Film  # noqa: F401
from .fused import trace_fused, trace_fused_reference  # noqa: F401
from .integrator import trace  # noqa: F401
from .renderer import Renderer, render_pass  # noqa: F401
