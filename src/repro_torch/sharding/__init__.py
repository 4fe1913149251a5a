"""Sharding strategies and layouts (counterpart of ``repro/sharding``)."""
from repro_torch.sharding.strategy import (STRATEGIES, Sharding, batch_pspec,
                                           cache_pspecs, data_axes,
                                           opt_rules_for, param_pspecs,
                                           param_shardings, placements,
                                           pspecs_for_tree, rules_for,
                                           spec_to_pspec)

__all__ = ["STRATEGIES", "Sharding", "batch_pspec", "cache_pspecs",
           "data_axes", "opt_rules_for", "param_pspecs", "param_shardings",
           "placements", "pspecs_for_tree", "rules_for", "spec_to_pspec"]
