"""The plain reference: HighRes-net's forward, ShiftNet, the Lanczos warp,
the registered cPSNR loss and Adam, in float32 PyTorch operations.

It imports nothing of the program under test. Its parameters are named by
the state-dict keys the models publish (``encode.init_layer.0.weight``,
``layer1.0.weight``, ``fc1.weight``, ...), so the benchmark can hand the
same tensors to both sides.

``ops.Precision`` selects how every convolution and matrix product rounds
its operands: ``f32`` (TF32 off, the configurations' precision) or
``tf32`` (operands rounded to TF32's 10-bit mantissa, products summed in
float32), the control that must come out as not correct.
"""
