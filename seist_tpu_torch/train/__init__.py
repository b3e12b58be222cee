"""Training: schedule, optimizers, the guarded train step and the run loop
(counterpart of ``seist_tpu/train/``)."""
