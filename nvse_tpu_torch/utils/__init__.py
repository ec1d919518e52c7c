from .config import AttrDict, load_config
from .jax_params import params_from_jax
