"""env layer of the PyTorch port (see flingbot_tpu_torch/__init__.py)."""
