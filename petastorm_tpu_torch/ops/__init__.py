"""Compute kernels: flash attention as hand-written CUDA for Hopper."""

from petastorm_tpu_torch.ops.flash_attention import flash_attention, full_attention

__all__ = ['flash_attention', 'full_attention']
