from repro_torch.train.state import TrainState
from repro_torch.train.step import TrainConfig, init_state, make_train_step

__all__ = ["TrainState", "TrainConfig", "init_state", "make_train_step"]
