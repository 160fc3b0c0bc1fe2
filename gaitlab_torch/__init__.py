"""gaitlab_torch: the PyTorch / CUDA (Hopper) port of gaitlab.

The JAX package `gaitlab` stays beside it as the reference; this package
imports nothing of it, and nothing of JAX. Layout follows gaitlab/:

  device.py  default device (CUDA; the CPU only when asked for) and the
             float32 math context (TF32 off)
  core/      geometry
  body/      SMPL model, skeleton-format registry
  ops/       the hand-written CUDA kernels (csrc/*.cu) and their plain
             PyTorch versions
  nn/        HRNet backbone, PARE head, GRNet
  weights/   flax-variable and reference-checkpoint import
  pipeline/  video IO, crop, tracklet splitting, coordinates, runner
  cli/       demo (--tracking_path)
  config     typed config, yacs-YAML compatible
"""

__version__ = "0.1.0"
