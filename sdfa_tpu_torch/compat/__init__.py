from .from_flax import (flax_variables_from_model, init_params, load_flax_variables,
                        state_dict_from_flax)
from .torch_ckpt import convert_state_dict, load_torch_checkpoint

__all__ = ["convert_state_dict", "flax_variables_from_model", "init_params",
           "load_flax_variables", "load_torch_checkpoint", "state_dict_from_flax"]
