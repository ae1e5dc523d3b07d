from .api import Model, build
from .config import ModelConfig
from .convert import params_from_jax
from .spec import PSpec, init_params, param_count

__all__ = ["Model", "build", "ModelConfig", "PSpec", "init_params",
           "param_count", "params_from_jax"]
