"""A toy architecture for the harness's tests, laid out as a later
architecture adds itself: the module that arch/<arch>.py would be
(`arch`), its plain reference (`reference`) and its counts (`counts`).
Nothing under benchmark/ outside the tests names it; a test registers
`arch` as `benchmark.arch.toy` and gives spec.Cell its configuration."""
