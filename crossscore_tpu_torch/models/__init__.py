from crossscore_tpu_torch.models.crossscore import CrossScoreConfig, CrossScoreNet
from crossscore_tpu_torch.models.dinov2 import VIT_PRESETS, ViTConfig

__all__ = ["CrossScoreConfig", "CrossScoreNet", "VIT_PRESETS", "ViTConfig"]
