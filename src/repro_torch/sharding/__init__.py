from repro_torch.sharding.partition import (P, batch_axes, cache_pspecs, distribute_params,
                                            param_pspecs, to_placements)

__all__ = ["P", "param_pspecs", "cache_pspecs", "batch_axes", "to_placements",
           "distribute_params"]
