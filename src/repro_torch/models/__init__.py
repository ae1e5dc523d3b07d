from .api import Model, build
from .config import ModelConfig
from .convert import params_from_jax
from .spec import (PSpec, ShardingRules, init_params, make_sharder,
                   param_count, placements, pspec_tree, sds_tree,
                   sharding_tree)

__all__ = ["Model", "build", "ModelConfig", "PSpec", "ShardingRules",
           "init_params", "make_sharder", "param_count", "params_from_jax",
           "placements", "pspec_tree", "sds_tree", "sharding_tree"]
