"""Per-layer metrics, one file each, named as in BENCHMARK.json. Each has
`read(ctx)` (ctx: harness.runner.Ctx) returning the value, or None where
the run gives it nothing to read: the harness then leaves the metric out
of the line. No reader returns 0 for a share of a roofline or a peak."""
