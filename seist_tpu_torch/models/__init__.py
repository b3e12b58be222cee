"""Models of the port (registered by importing seist_tpu_torch.models.seist)."""
