"""Model substrate on PyTorch (port of ``repro.models``): the dense, MoE,
VLM, hybrid, SSM and audio families."""

from repro_torch.models.model_zoo import Model, abstract_params, build_model

__all__ = ["Model", "abstract_params", "build_model"]
