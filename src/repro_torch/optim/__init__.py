from repro_torch.optim.optimizers import adamw, apply_updates, sgd_momentum
from repro_torch.optim.schedule import constant_lr, step_decay, warmup_cosine

__all__ = ["sgd_momentum", "adamw", "apply_updates", "warmup_cosine",
           "step_decay", "constant_lr"]
