"""StarGAN v2 (clovaai/stargan-v2) with AdaIN, training, in plain float32
torch."""
