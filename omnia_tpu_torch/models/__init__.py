from omnia_tpu_torch.models.config import PRESETS, ModelConfig, get_config

__all__ = ["ModelConfig", "PRESETS", "get_config"]
