"""Evaluation: InceptionV3 and LPIPS nets, FID / IS / mFID math, the
DefectGAN and StarGAN v2 evaluation loops."""
