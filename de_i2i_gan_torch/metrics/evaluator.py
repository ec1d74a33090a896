"""``defectgan_generator_fn``, counterpart of the JAX package's
``metrics/evaluator.py::defectgan_generator_fn``. The rest of that module
(``Evaluator``: FID, IS, LPIPS) waits for ROADMAP A.8."""
from __future__ import annotations

from typing import Callable, Optional

import torch


def defectgan_generator_fn(steps, cfg, generator: Optional[torch.Generator]
                           = None) -> Callable:
    """Translation closure over a ``DefectGanSteps``: background images +
    one-hot labels -> generated defects through the eval-mode forward, with
    SEAN's zero style embeddings (no reference embeds at eval time;
    defectgan_model.py:437-445 evaluates with the running SEAN stats the
    same way). The steps hold the weights, where the JAX closure takes a
    train state."""
    def fn(bg_imgs, labels):
        feat = None
        if cfg.style_norm_block_type == "sean":
            feat = torch.zeros((bg_imgs.shape[0], cfg.num_embeds,
                                cfg.embed_nc), device=steps.device)
        out, _ = steps.generate(bg_imgs, labels, feat, generator=generator)
        return out
    return fn
