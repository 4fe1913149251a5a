from repro_torch.configs.registry import ARCHS, get_config, reduced, list_archs

__all__ = ["ARCHS", "get_config", "reduced", "list_archs"]
