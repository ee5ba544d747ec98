"""The harness of flingbot_tpu_torch's benchmark (see README.md)."""
