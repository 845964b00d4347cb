from megaverse_tpu_torch.models.actor_critic import ActorCritic, ConvEncoder  # noqa: F401
