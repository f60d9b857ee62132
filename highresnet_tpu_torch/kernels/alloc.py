"""Output allocation for kernels that write every byte of their output.

With ``torch.use_deterministic_algorithms(True)`` (``runtime.setup_device``
turns it on for CUDA) ``torch.utils.deterministic.fill_uninitialized_memory``
defaults to True, and every ``torch.empty`` or ``empty_like`` launches a NaN
fill before returning. A kernel that then writes the whole tensor again
pays for each output byte twice.

``empty_output`` takes a storage straight from the caching allocator
(``torch.UntypedStorage``) and views it with ``Tensor.set_``, which is how
``torch._utils._rebuild_tensor`` builds a tensor on a storage. The only fill
left is the one over the 0-element placeholder, which launches nothing, so
the call also takes less host time than ``torch.empty`` and its fill launch
(``chip_smoke.py`` [fills] times both). The process-wide setting stays as
it is.

Use it only for an output that the kernel writes whole: any byte the kernel
leaves is whatever the allocator's block held before.
"""

from __future__ import annotations

import math

import torch


def empty_output(shape, dtype: torch.dtype, device) -> torch.Tensor:
    """A contiguous, uninitialised ``shape`` tensor of ``dtype`` on ``device``;
    ``shape`` is a tuple of ints or a ``torch.Size``."""
    storage = torch.UntypedStorage(math.prod(shape) * dtype.itemsize, device=device)
    return torch.empty(0, dtype=dtype, device=device).set_(storage, 0, shape)
