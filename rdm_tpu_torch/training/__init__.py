"""RDM training: optimizer, EMA, train state and step, checkpoints, the
trainer (counterpart of `rdm_tpu/training`)."""
