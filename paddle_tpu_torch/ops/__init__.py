"""Ops of the port: the paged KV cache allocator (paged_attention.py),
the shared attention policy (attention_core.py) and the hand-written
CUDA kernels with their plain PyTorch twins (kernels/)."""
