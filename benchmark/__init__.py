"""The benchmark of gaitlab_torch on one NVIDIA H100 (run.py)."""
