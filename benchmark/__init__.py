"""The benchmark of ``gm3d_tpu_torch`` on one NVIDIA H100: ``python3 benchmark/run.py``."""
