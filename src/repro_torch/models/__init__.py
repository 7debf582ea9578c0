"""Model substrate on PyTorch (port of ``repro.models``): the dense
decoder-only family.  ``abstract_params`` (a JAX shape evaluation) has no
counterpart; ``ModelConfig.param_count()`` gives the size without
allocating."""

from repro_torch.models.model_zoo import Model, build_model

__all__ = ["Model", "build_model"]
