"""de-i2i-gan-torch: the PyTorch/CUDA port of ``de_i2i_gan_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module paths and class names so each counterpart is easy to find:

    config/defaults.py   DefectGanConfig, TrainConfig (jax-free copies)
    nn/layers.py         Conv2d, Dense, padding, upsample_nearest, avg_pool
    nn/normalization.py  instance_norm, AdaIN
    nn/blocks.py         ConvBlock, DeConvBlock, ResBlock, NormConvBlock,
                         NormResBlock
    ops/fused.py         modulated_instance_norm dispatch + plain version
    ops/cuda/            hand-written CUDA kernels (built at first use)
    models/              DefectGanGenerator, StyleExtractor
    train/steps.py       DefectGanSteps.generate (the serving path)
    train/jax_import.py  flax trees -> these modules, init_weights

Public entry points keep the JAX layout (NHWC images, (N, label_nc)
labels); inside, modules work in NCHW. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``.

This package imports torch and numpy only: never jax, flax, optax or any
module of ``de_i2i_gan_tpu``.
"""

__version__ = "0.1.0"
