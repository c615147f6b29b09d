from .from_flax import init_params, load_flax_variables, state_dict_from_flax

__all__ = ["init_params", "load_flax_variables", "state_dict_from_flax"]
