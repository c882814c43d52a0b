"""Plain PyTorch references of the configurations, one file a configuration.

They import nothing of the program (``gm3d_tpu_torch``), nor ``jax`` nor the
JAX package, and run every product in fp32 with TF32 off unless a control
asks for TF32 (``set_precision``).
"""
