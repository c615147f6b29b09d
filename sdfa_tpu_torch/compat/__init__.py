from .from_flax import (flax_variables_from_model, init_params, load_flax_variables,
                        state_dict_from_flax)

__all__ = ["flax_variables_from_model", "init_params", "load_flax_variables",
           "state_dict_from_flax"]
