"""``kernels.alloc.empty_output``: a kernel's output without the deterministic
NaN fill that ``torch.empty`` launches under
``torch.use_deterministic_algorithms(True)``.

On the card the wrappers of K1-K4 allocate through it, and
``test_torch_cuda.py`` shows with the profiler that none launches a fill.
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from highresnet_tpu_torch.kernels.alloc import empty_output


@pytest.fixture
def deterministic():
    before = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    yield
    torch.use_deterministic_algorithms(before)


@pytest.mark.parametrize("shape, dtype", [
    ((4, 5), torch.float32),
    ((2, 3, 4, 5, 6), torch.bfloat16),
    ((7,), torch.float16),
    ((0, 3), torch.float32),
    ((2, 0, 8), torch.bfloat16),
])
def test_empty_output_shape_dtype_contiguity(shape, dtype, deterministic):
    out = empty_output(shape, dtype, "cpu")
    assert out.shape == shape and out.dtype == dtype and out.device.type == "cpu"
    assert out.is_contiguous() and out.storage_offset() == 0
    assert out.untyped_storage().nbytes() == out.numel() * out.element_size()
    out.fill_(1.0)  # writable, and the whole storage belongs to it
    assert bool((out == 1.0).all())


def _fills(fn):
    """Element counts of the ``aten::fill_`` calls that ``fn`` makes."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        fn()
    counts = []
    for e in prof.events():
        if e.name == "aten::fill_":
            size = e.input_shapes[0]
            n = 1
            for s in size:
                n *= s
            counts.append(n)
    return counts


def test_empty_output_records_no_fill_over_its_elements(deterministic):
    shape = (3, 4, 5)
    assert _fills(lambda: torch.empty(shape)) == [60]  # the deterministic NaN fill
    assert all(n == 0 for n in _fills(lambda: empty_output(shape, torch.float32, "cpu")))
    torch.use_deterministic_algorithms(False)
    assert _fills(lambda: torch.empty(shape)) == []


def test_empty_output_in_inference_mode_and_autograd_function(deterministic):
    class Copy(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return empty_output(x.shape, x.dtype, x.device).copy_(x)

        @staticmethod
        def backward(ctx, g):
            return g

    x = torch.arange(6.0).view(2, 3).requires_grad_()
    y = Copy.apply(x)
    assert torch.equal(y, x) and y.requires_grad
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.equal(g, torch.ones_like(x))
    with torch.inference_mode():
        z = empty_output((2, 3), torch.float32, "cpu").copy_(x)
    assert torch.equal(z, x.detach())
