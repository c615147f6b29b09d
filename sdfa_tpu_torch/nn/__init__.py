from . import attention, functions, layers, recurrent, spec
from .spec import LayerStack, parse_specs

__all__ = ["attention", "functions", "layers", "recurrent", "spec", "LayerStack",
           "parse_specs"]
