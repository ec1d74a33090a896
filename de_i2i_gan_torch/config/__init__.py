from de_i2i_gan_torch.config.defaults import DefectGanConfig, TrainConfig

__all__ = ["DefectGanConfig", "TrainConfig"]
