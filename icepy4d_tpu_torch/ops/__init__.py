"""Tensor ops of the port: image ops, epipolar geometry, RANSAC, and the
wrappers of the hand-written kernels (`nms`, `attention`)."""
