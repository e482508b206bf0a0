from .embedders import InstanceEmbedder, SemanticsEmbedder, per_class_area_map

__all__ = ["InstanceEmbedder", "SemanticsEmbedder", "per_class_area_map"]
