"""DefectGAN (jason2714/de-i2i-gan, defectGAN) in plain float32 torch."""
