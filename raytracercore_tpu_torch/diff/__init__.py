from .params import (MATERIAL_FIELDS, get_material_params,  # noqa: F401
                     material_params_from_numpy, with_material_params)
