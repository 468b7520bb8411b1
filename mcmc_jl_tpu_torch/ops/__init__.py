"""Fused GLM-HMC kernels and drivers, FFT autocovariance."""
