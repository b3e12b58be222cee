"""Models of the port: the 21 names of the JAX package, registered by
``seist_tpu_torch.load_all()`` (SeisT's 15 and the six baseline families)."""
