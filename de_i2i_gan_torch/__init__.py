"""de-i2i-gan-torch: the PyTorch/CUDA port of ``de_i2i_gan_tpu``.

The JAX package beside this one is the reference; this package mirrors its
module paths and class names so each counterpart is easy to find:

    config/defaults.py   DefectGanConfig, TrainConfig (jax-free copies)
    nn/layers.py         Conv2d, Dense, padding, upsample_nearest, avg_pool
    nn/normalization.py  instance_norm, AdaIN
    nn/blocks.py         BatchNorm (eval, and train with bn_groups), ConvBlock,
                         DeConvBlock, ResBlock, NormConvBlock, NormResBlock
    ops/fused.py         modulated_instance_norm dispatch + plain versions
    ops/cuda/            hand-written CUDA kernels (built at first use)
    models/              DefectGanGenerator, StyleExtractor,
                         DefectGanDiscriminator
    losses/common.py     bce_logits, cce_logits, l1, l2, cal_loss
    utils/labels.py      normal_labels
    train/optim.py       lr schedules, optimizers, ema_update
    train/steps.py       DefectGanSteps: generate (serving), d_step, g_step,
                         super_step (training)
    train/jax_import.py  flax trees and optax states -> these modules,
                         init_weights
    train/checkpoint.py  save_checkpoint, load_checkpoint (strict or
                         filtered), iter.txt
    train/trainer.py     DefectGanTrainer: the epoch loop
    data/                datasets, loaders, device_prefetch, EmbeddingBank
    config/options.py    the DefectGAN train/test flags
    metrics/evaluator.py defectgan_generator_fn
    utils/               guards (NaNGuard), seed, png, diffaug, labels
    cli/                 train_defectgan, test_defectgan

Public entry points keep the JAX layout (NHWC images, (N, label_nc)
labels); inside, modules work in NCHW. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"`` (the CLIs: ``--gpu_ids -1``).

This package imports torch and numpy only: never jax, flax, optax or any
module of ``de_i2i_gan_tpu``.
"""

__version__ = "0.1.0"
