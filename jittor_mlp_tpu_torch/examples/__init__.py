"""Runnable examples of the port (``python -m jittor_mlp_tpu_torch.examples.<name>``)."""
