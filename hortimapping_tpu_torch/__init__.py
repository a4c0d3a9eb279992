"""PyTorch/CUDA port of `hortimapping_tpu`: fruit shape completion and pose
estimation on one NVIDIA H100.

The JAX package beside this one is the reference; module names mirror it so a
reader finds each counterpart under the same path. Entry points run on
`device="cuda"` by default and raise without a card unless the caller asks for
`device="cpu"`, where every hand-written kernel is replaced by its plain
PyTorch version (the only place the plain versions run).
"""

from hortimapping_tpu_torch.device import resolve_device

__all__ = ["resolve_device"]
