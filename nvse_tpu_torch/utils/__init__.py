from .config import AttrDict, load_config
from .jax_params import cqtd_params_from_jax, disc_params_from_jax, params_from_jax
