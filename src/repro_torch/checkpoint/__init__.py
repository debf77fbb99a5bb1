from repro_torch.checkpoint.io import load_pytree, save_pytree

__all__ = ["save_pytree", "load_pytree"]
