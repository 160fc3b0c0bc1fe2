"""gaitlab_torch: the PyTorch / CUDA (Hopper) port of gaitlab.

The JAX package `gaitlab` stays beside it as the reference; this package
imports nothing of it, and nothing of JAX. Layout follows gaitlab/:

  device.py  default device (CUDA; the CPU only when asked for) and the
             float32 math context (TF32 off)
  core/      geometry, temporal filters (one-euro, median, gaussian)
  body/      SMPL model, skeleton-format registry
  ops/       the hand-written CUDA kernels (csrc/*.cu) and their plain
             PyTorch versions
  nn/        HRNet backbone, PARE head, GRNet, YOLOv3 (full and tiny)
  weights/   flax-variable and reference-checkpoint import
  pipeline/  video IO, crop, detection, SORT tracking and tracklet
             splitting, pose smoothing, coordinates, runner
  cli/       demo (from a video or precomputed tracklets)
  config     typed config, yacs-YAML compatible
"""

__version__ = "0.1.0"
