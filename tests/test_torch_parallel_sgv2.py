"""The StarGAN v2 solver over two CPU ranks (gloo) against the port's one
process on the same global batch of 2: one ``train_step`` from a
continued Adam state (a fresh one with beta1 = 0 moves a weight by about
lr * sign(g)). The comparison is ``test_torch_parallel_steps.py``'s; the
Adam moments (the gradients, beta1 = 0) are held per tensor in relative L2.
The iteration runs in float64 on both sides
(``torch_dp_workers.FLOAT64_KINDS``): in float32 its L1 terms' near-ties
take the other sign under the other batch split, and G's
``from_rgb.weight`` moment then differs by 1.2%. The pretrain step and
``update_stats`` are in ``test_torch_parallel_sgv2_pretrain.py``.
"""
import torch

from tests.test_torch_parallel_steps import check_agree, two_ranks

torch.set_num_threads(1)

# in float64 every moment agrees to 8e-8 of its norm, the losses' float32
# casts (bce_logits, l1), and to 1.5e-16 a sqrt(element) where a gradient
# is nought in exact arithmetic
MOMENT_REL_L2_F64, MOMENT_ATOL_F64 = 1e-6, 1e-14


def test_starganv2_iteration_over_two_ranks(tmp_path):
    check_agree(*two_ranks("sgv2_train", tmp_path, continued=True),
                moments_l2=(MOMENT_REL_L2_F64, MOMENT_ATOL_F64))
