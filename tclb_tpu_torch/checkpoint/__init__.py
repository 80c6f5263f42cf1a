"""Checkpoint helpers of the PyTorch port (legacy ``.npz`` only so far)."""

from tclb_tpu_torch.checkpoint.writer import atomic_path, resolve_npz, with_suffix

__all__ = ["atomic_path", "resolve_npz", "with_suffix"]
