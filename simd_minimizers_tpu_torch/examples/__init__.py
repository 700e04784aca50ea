"""Examples of the port, each runnable as `python -m simd_minimizers_tpu_torch.examples.<name>`."""
