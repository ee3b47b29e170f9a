"""Tree optimizers of the port (the JAX package's ``repro.optim``):

    opt = sgd(lr=0.01, momentum=0.9)
    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)
"""

from repro_torch.optim.optim import (
    Optimizer,
    SplitTree,
    adamw,
    apply_updates,
    chain,
    clip_by_global_norm,
    cosine_schedule,
    global_norm,
    sgd,
)

__all__ = ["Optimizer", "SplitTree", "sgd", "adamw", "clip_by_global_norm", "chain", "apply_updates",
           "global_norm", "cosine_schedule"]
