"""Pure-JAX DSP operator library (the same code runs the CPU tests and the
GPU)."""
