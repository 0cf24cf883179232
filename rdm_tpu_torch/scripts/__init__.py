"""The port's command-line entry points (`python -m
rdm_tpu_torch.scripts.<name>`)."""
