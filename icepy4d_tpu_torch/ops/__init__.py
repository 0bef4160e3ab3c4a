"""Tensor ops of the port: image ops, geometry, rectification, dense
stereo, epipolar geometry, RANSAC, and the wrappers of the hand-written
kernels (`nms`, `attention`, `sweep`)."""
