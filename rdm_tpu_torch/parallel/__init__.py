"""Process groups and the (data, db) device mesh over torch.distributed
(counterpart of `rdm_tpu/parallel`)."""
