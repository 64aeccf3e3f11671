"""Model configurations (shapes only) of the architectures the repo
supports, as in ``repro/configs``: ``get_config(arch)`` and
``get_smoke_config(arch)`` from ``registry``."""
from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig, SSMConfig
from repro_torch.configs.registry import ARCHS, get_config, get_smoke_config

__all__ = ["ARCHS", "MLAConfig", "MoEConfig", "ModelConfig", "SSMConfig",
           "get_config", "get_smoke_config"]
