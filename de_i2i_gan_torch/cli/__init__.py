"""Command-line entry points (``python -m de_i2i_gan_torch.cli.<name>``)."""
