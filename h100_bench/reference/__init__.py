"""Plain PyTorch references of the benchmark's configurations.

Each module computes one published architecture from the same generated
inputs and weights the program is given, in float32 with TF32 off, and
imports nothing of the program. The arithmetic follows the published
models as the port's plain paths compute them (a frozen copy, simplified
to one batch of tiles at a time). `precision.lowered` rounds every
operand of a product one step below what a configuration states: that is
the control that the comparison has to reject.
"""
