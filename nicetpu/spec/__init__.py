"""Executable numpy spec of the `.nice` codec.

This package is the readable, host-side ground truth used to validate both the
C++ oracle and the JAX device kernels (golden-dump strategy, SURVEY §4).  The
tokenizer is vectorized numpy implementing exactly the math the device kernels
use; the decoder is a straightforward serial loop.
"""
