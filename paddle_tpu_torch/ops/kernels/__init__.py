"""Hand-written Hopper kernels of the port, each beside its plain
PyTorch twin (`<name>_reference`). Sources: paddle_tpu_torch/csrc/;
built and loaded by _build.py."""
