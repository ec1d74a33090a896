from de_i2i_gan_torch.config.defaults import (
    DefectGanConfig, MAEConfig, TrainConfig, WGanConfig)

__all__ = ["DefectGanConfig", "MAEConfig", "TrainConfig", "WGanConfig"]
