"""Plain float32 PyTorch references of the configurations the benchmark
runs, one folder a family. They import torch alone: nothing of the program
under test, and nothing of JAX."""
