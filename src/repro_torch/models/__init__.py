from repro_torch.models.model import LM, build_groups, build_layer_specs

__all__ = ["LM", "build_groups", "build_layer_specs"]
