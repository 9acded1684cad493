"""Frozen `.nice` format spec: constants, Huffman code math, header layouts.

Everything in this package is host-side, pure, and shared by the numpy spec
codec, the C++ oracle bindings, and the JAX device kernels.
"""
