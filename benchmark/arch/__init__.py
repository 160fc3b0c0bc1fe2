"""One module per architecture, `arch/<arch>.py`, found by the "arch" of
a configuration (harness/spec.load_arch). It is everything the harness
needs from a model; the harness itself names none:

- `skeleton(cfg)`: the program's trunk on the meta device, whose modules
  give inputs.make_weights the names, shapes and roles of the weights;
- `calibrate(sd, cfg, frames, boxes, device)`: anything the random
  weights need from the traffic's frames before the build (BatchNorm
  statistics), in place in `sd`; nothing for an architecture without it;
- `build(cfg, sd, smpl, device, precision) -> (model, runner)`: the
  program's model and runner with the benchmark's weights and SMPL's
  tensors; the runner's `run_track` is what the window times;
- `trunk(runner)`: the module that the configuration's `stage_hooks` and
  `rows_module` name paths under, as the runner's forwards run it;
- `reference_track(sd, smpl, cfg, track, device) -> dict`: one track
  (inputs.Track) through the plain reference, from the benchmark's own
  weights: numpy "pose_rotmat" (N,24,3,3) and each output that
  harness/check.py compares ("verts", "joints3d", ...);
- `counts(cfg, sd)`: the step's frozen counts, with at least
  `forward_flops(real)` (step_mfu) and `b2(rows)` (b2_roofline; SMPL's
  counts are shared, counts/smpl.py)."""
