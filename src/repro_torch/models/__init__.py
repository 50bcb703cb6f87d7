from repro_torch.models.registry import MODEL_FAMILIES, build_model

__all__ = ["MODEL_FAMILIES", "build_model"]
