"""How the fma wrapper hands each operand to the CUDA kernel ``fma_rn``.

``kernels/fma.py::_launch_operand`` turns an operand into the kernel's
``(pointer or None, value, stride)`` and the tensor to keep alive.  Nothing
is launched here, so the cases run on CPU tensors: a float by value, one
value by pointer with stride 0, a contiguous or 1-D strided view by pointer
and its own stride with no copy, and only a multi-dimensional
non-contiguous or partly broadcast operand copied out to full shape.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.fma import _launch_operand  # noqa: E402

BASE = torch.arange(48, dtype=torch.float64)
GRID = BASE.reshape(6, 8)

# name: (operand, broadcast shape, stride the kernel gets, passed in place)
CASES = {
    "float": (0.25, torch.Size([8]), 0, None),
    "zero_dim": (BASE[3], torch.Size([8]), 0, True),
    "expanded": (BASE[5:6].expand(8), torch.Size([8]), 0, True),
    "one_value_2d": (BASE[:1].reshape(1, 1), torch.Size([6, 8]), 0, True),
    "contiguous": (BASE[:8], torch.Size([8]), 1, True),
    "offset_8_bytes": (BASE[1:9], torch.Size([8]), 1, True),
    "stride_2": (BASE[2::2][:8], torch.Size([8]), 2, True),
    "stride_3": (BASE[1::3][:8], torch.Size([8]), 3, True),
    "slice_2d": (GRID[:, 1:5], torch.Size([6, 4]), 1, False),
    "column_broadcast": (GRID[:, :1], torch.Size([6, 8]), 1, False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_launch_operand_kind(name):
    x, shape, stride, in_place = CASES[name]
    (ptr, value, got_stride), keep = _launch_operand(x, shape)
    assert got_stride == stride
    if in_place is None:            # a float goes by value, nothing to keep
        assert ptr is None and value == x and keep is None
        return
    assert value == 0.0
    assert ptr == keep.data_ptr()
    assert (ptr == x.data_ptr()) == in_place
    if in_place:
        assert keep is x
    else:                           # copied out, contiguous, same values
        assert keep.shape == shape and keep.is_contiguous()
        assert torch.equal(keep, x.expand(shape))
