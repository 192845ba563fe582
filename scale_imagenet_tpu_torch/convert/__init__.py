from .from_jax import jax_trees, state_dict_from_jax

__all__ = ["jax_trees", "state_dict_from_jax"]
