"""Rasterizer operators: preprocess, pair budget, binning, compositing and its
backward, SSIM."""
