"""The StarGAN v2 solver over two CPU ranks (gloo) against the port's one
process on the same global batch of 2: one ``train_step`` from a
continued Adam state (a fresh one with beta1 = 0 moves a weight by about
lr * sign(g)). The tolerances and the comparison are
``test_torch_parallel_steps.py``'s; the Adam moments (the gradients, beta1
= 0) are held per tensor in relative L2 (``MOMENT_REL_L2``). The pretrain
step and ``update_stats`` are in ``test_torch_parallel_sgv2_pretrain.py``.
"""
import torch

from tests.test_torch_parallel_steps import check_agree, two_ranks

torch.set_num_threads(1)


def test_starganv2_iteration_over_two_ranks(tmp_path):
    check_agree(*two_ranks("sgv2_train", tmp_path, continued=True),
                moments_l2=True)
