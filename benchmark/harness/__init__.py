"""The benchmark's machinery: the manifest and its files, the weights and
inputs made from the seed, the measured window, the trace and the check
against the reference."""
