from .convert import load_jax_variables
