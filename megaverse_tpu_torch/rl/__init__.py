from megaverse_tpu_torch.rl.learner import Learner, TrainConfig  # noqa: F401
